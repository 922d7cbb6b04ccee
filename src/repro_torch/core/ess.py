"""Effective sample size for weighted samples (paper Eq. 4); counterpart
of ``src/repro/core/ess.py``.

``n_eff = (sum w)^2 / sum(w^2)``. When ``n_eff / m`` falls below a
threshold the Sampler draws a fresh uniform-weight sample.

``1 <= n_eff <= len(w)`` holds for every vector with some positive mass,
also where ``sum w^2`` underflows float32: there the ratio is taken of
the weights rescaled by the largest one (the ratio is scale-free).
"""

from __future__ import annotations

import torch


def effective_sample_size(
    w: torch.Tensor, mask: torch.Tensor | None = None, dim: int | None = None
) -> torch.Tensor:
    """``(sum w)^2 / sum w^2`` of an un-normalized weight vector; 0 when
    all weights are 0. ``dim=None`` flattens (the reference's behaviour);
    an integer ``dim`` reduces along it only, one value per row.

    Where ``sum w^2`` is below 1e-30 (zero, subnormal, or small enough
    that the reference's ``max(s2, 1e-30)`` guard would bias the ratio)
    while some weight is nonzero, the ratio is computed from ``w / max|w|``
    instead; everywhere else the result is the plain formula's, bit for
    bit."""
    w = torch.as_tensor(w, dtype=torch.float32)
    if mask is not None:
        w = w * torch.as_tensor(mask, device=w.device).to(torch.float32)
    if dim is None:
        w = w.reshape(-1)
        dim = 0
    s1 = w.sum(dim=dim)
    s2 = (w * w).sum(dim=dim)
    out = torch.where(s2 > 0, (s1 * s1) / torch.clamp(s2, min=1e-30), torch.zeros_like(s1))
    if w.shape[dim] == 0:
        return out
    # no host sync: the rescaled ratio is computed everywhere and selected
    peak = w.abs().amax(dim=dim, keepdim=True)
    tiny = (s2 < 1e-30) & (peak.squeeze(dim) > 0)
    ws = w / torch.where(peak > 0, peak, torch.ones_like(peak))
    r1 = ws.sum(dim=dim)
    r2 = (ws * ws).sum(dim=dim)
    return torch.where(tiny, (r1 * r1) / torch.where(tiny, r2, torch.ones_like(r2)), out)


def expected_sample_fraction(w: torch.Tensor) -> torch.Tensor:
    """Expected fraction selected by selective sampling with acceptance
    probability proportional to ``w``: ``mean(w) / max(w)``."""
    w = torch.as_tensor(w, dtype=torch.float32).reshape(-1)
    if w.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=w.device)
    return w.mean() / torch.clamp(w.max(), min=1e-30)
