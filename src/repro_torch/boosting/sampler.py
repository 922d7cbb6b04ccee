"""The Sampler (paper §4.1): minimal-variance (systematic) resampling
with probability proportional to weight; counterpart of
``src/repro/boosting/sampler.py``.

The uniform offset ``u0`` is an argument rather than drawn inside, so a
caller (or a test) decides where the randomness comes from.
``rejection_sample`` is an ablation of the reference and is not ported.
"""

from __future__ import annotations

import torch


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last dim, the same bits on every run.

    On a CUDA tensor that is a single row, ``torch.cumsum`` takes a
    single-pass look-back scan whose float additions associate in a
    run-dependent order (on an H100, repeated scans of one long row
    gave different bits); a scan over the rows of a 2-D tensor does not.
    The engine's dense == sparse bit-exactness needs the same sample
    every run, so a lone row is scanned beside a zero row."""
    if x.numel() != x.shape[-1]:
        return torch.cumsum(x, dim=-1)
    row = x.reshape(1, -1)
    return torch.cumsum(torch.cat([row, torch.zeros_like(row)]), dim=-1)[0].reshape(x.shape)


def minimal_variance_sample(u0, w: torch.Tensor, m: int) -> torch.Tensor:
    """Systematic resampling: ``m`` int32 indices with inclusion counts
    ``floor(m p_i)`` or ``ceil(m p_i)``, ``p = w / sum(w)``; a single
    uniform offset ``u0`` in [0, 1) decides every pick. Takes a leading
    batch axis: ``w (..., n)`` with ``u0`` of shape ``(...)``."""
    w = torch.clamp(w.to(torch.float32), min=0.0)
    n = w.shape[-1]
    total = w.sum(dim=-1, keepdim=True)
    # degenerate all-zero weights: uniform
    p = torch.where(total > 0, w / torch.clamp(total, min=1e-30), 1.0 / n)
    cum = _cumsum_rows(p)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=w.device).unsqueeze(-1)
    points = (torch.arange(m, dtype=torch.float32, device=w.device) + u0) / m
    points = points.expand(*cum.shape[:-1], m).contiguous()
    idx = torch.searchsorted(cum, points, right=False)
    return torch.clamp(idx, 0, n - 1).to(torch.int32)
