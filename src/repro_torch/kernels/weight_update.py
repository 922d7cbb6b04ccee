"""Host-side preparation for kernel K4 (the fused incremental weight
update, paper §4.1 "Incremental Updates"); counterpart of
``src/repro/kernels/weight_update.py``.

A slice ``[t_lo, t_hi)`` of a strong rule is scattered once into the
``(d, B-1)`` candidate grid,

    A[j, t] = sum_{k in slice: feat_k = j, thr_k = t} alpha_k * sign_k
    c       = sum_{k in slice} alpha_k * sign_k

so that the slice's margin delta on a row is ``2 * sum_{j, t < xb[j]}
A[j, t] - c``: kernel K4 (:func:`repro_torch.kernels.ops.weight_update`)
evaluates it and the weight epilogue in one pass.
"""

from __future__ import annotations

import torch


def scatter_model_slice(model, t_lo, t_hi, num_bins: int, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter stump slots ``[t_lo, t_hi)`` of a ``StumpModel`` into
    ``(A (d, B-1), c ())`` for kernel K4. ``t_lo``/``t_hi`` are ints or
    0-d tensors.

    Deterministic and free of host syncs on the card: a one-hot
    contraction over the T slots summed with ``torch.sum`` (a fixed
    reduction order), not ``index_add_``/``index_put_``, whose float
    atomics would make ``A`` vary from run to run where stumps repeat a
    ``(feature, threshold)`` cell. Stumps outside the grid add nothing to
    ``A`` (the reference drops out-of-range scatter indices) but count
    in ``c``."""
    dev = model.alpha.device
    cuts = num_bins - 1
    slot = torch.arange(model.capacity, device=dev)
    live = (slot >= t_lo) & (slot < t_hi)
    coef = model.alpha * model.sign * live.to(torch.float32)
    feat, thr = model.feat.long(), model.thr.long()
    inside = (feat >= 0) & (feat < d) & (thr >= 0) & (thr < cuts)
    cell = torch.where(inside, feat * cuts + thr, -1)
    onehot = cell.unsqueeze(0) == torch.arange(d * cuts, device=dev).unsqueeze(1)  # (d*(B-1), T)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    a = torch.where(onehot, coef.unsqueeze(0), zero).sum(dim=1).reshape(d, cuts)
    return a, coef.sum()
