"""Effective sample size for weighted samples (paper Eq. 4); counterpart
of ``src/repro/core/ess.py``.

``n_eff = (sum w)^2 / sum(w^2)``. When ``n_eff / m`` falls below a
threshold the Sampler draws a fresh uniform-weight sample.
"""

from __future__ import annotations

import torch


def effective_sample_size(
    w: torch.Tensor, mask: torch.Tensor | None = None, dim: int | None = None
) -> torch.Tensor:
    """``(sum w)^2 / sum w^2`` of an un-normalized weight vector; 0 when
    all weights are 0. ``dim=None`` flattens (the reference's behaviour);
    an integer ``dim`` reduces along it only, one value per row."""
    w = torch.as_tensor(w, dtype=torch.float32)
    if mask is not None:
        w = w * torch.as_tensor(mask, device=w.device).to(torch.float32)
    if dim is None:
        w = w.reshape(-1)
        dim = 0
    s1 = w.sum(dim=dim)
    s2 = (w * w).sum(dim=dim)
    return torch.where(s2 > 0, (s1 * s1) / torch.clamp(s2, min=1e-30), torch.zeros_like(s1))


def expected_sample_fraction(w: torch.Tensor) -> torch.Tensor:
    """Expected fraction selected by selective sampling with acceptance
    probability proportional to ``w``: ``mean(w) / max(w)``."""
    w = torch.as_tensor(w, dtype=torch.float32).reshape(-1)
    if w.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=w.device)
    return w.mean() / torch.clamp(w.max(), min=1e-30)
