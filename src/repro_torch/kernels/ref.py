"""Plain PyTorch versions of the hand-written kernels (the contract).

Counterpart of ``src/repro/kernels/ref.py``. Each function computes the
same thing as its CUDA kernel with ordinary tensor operations; the
wrappers in :mod:`repro_torch.kernels.ops` call them for CPU tensors,
and ``chip_smoke.py`` holds each kernel against them on the card.
``round_step_ref`` and ``queue_ingest_ref`` are also the engine's
``round_step_impl="ref"`` path; ``margin_delta_oracle`` is the
stump-by-stump meaning of a model slice, which ``weight_update_ref``
over :func:`~repro_torch.kernels.weight_update.scatter_model_slice`
must reproduce.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

_I32_MAX = 2**31 - 1


def lexsort(keys: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """``jnp.lexsort``: indices that sort by ``keys[-1]`` first, then
    ``keys[-2]``, ... Built from successive STABLE sorts, least
    significant key first, so fully tied keys keep their column order."""
    idx = torch.argsort(keys[0], dim=dim, stable=True)
    for key in keys[1:]:
        order = torch.argsort(torch.gather(key, dim, idx), dim=dim, stable=True)
        idx = torch.gather(idx, dim, order)
    return idx


def edge_scan_ref(
    xb: torch.Tensor, wy: torch.Tensor, w: torch.Tensor, num_bins: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched (feature, bin) histogram of ``wy`` plus the stopping-rule
    scalars: ``xb (..., n, d)`` int32, ``wy``/``w`` ``(..., n)`` f32 ->
    ``hist (..., d, B)``, ``W = sum|w|``, ``V = sum w^2``, ``T = sum wy``.

    The one-hot select and sum of the kernel, written with tensors; bins
    outside ``[0, B)`` add nothing."""
    bins = torch.arange(num_bins, dtype=xb.dtype, device=xb.device)
    onehot = xb.unsqueeze(-1) == bins  # (..., n, d, B)
    zero = torch.zeros((), dtype=torch.float32, device=wy.device)
    hist = torch.where(onehot, wy[..., None, None].to(torch.float32), zero).sum(dim=-3)
    W = w.abs().sum(dim=-1)
    V = (w * w).sum(dim=-1)
    T = wy.sum(dim=-1)
    return hist, W, V, T


def weight_update_ref(
    xb: torch.Tensor,
    y: torch.Tensor,
    margin_l: torch.Tensor,
    margin_s: torch.Tensor,
    a: torch.Tensor,
    c,
    num_bins: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused margin + weight refresh: ``delta = 2 (P @ A) - c`` with
    ``P[i, (j, t)] = [xb[i, j] > t]`` over the ``B - 1`` cuts,
    ``margin' = margin_l + delta`` and
    ``w = exp(clip(-y (margin' - margin_s), -30, 30))``; ``xb (n, d)``
    int32, ``a (d, B-1)``, ``c`` a float or 0-d tensor. Returns
    ``(margin' (n,), w (n,))``. Bins at or above ``B - 1`` turn every cut
    on, bins at or below 0 none."""
    cuts = torch.arange(num_bins - 1, dtype=xb.dtype, device=xb.device)
    p = (xb.unsqueeze(-1) > cuts).to(torch.float32)  # (n, d, B-1)
    delta = 2.0 * torch.einsum("ndc,dc->n", p, a) - c
    m_new = margin_l + delta
    w = torch.exp(torch.clamp(-y * (m_new - margin_s), -30.0, 30.0))
    return m_new, w


def round_step_ref(
    q_cert: torch.Tensor,
    q_due: torch.Tensor,
    q_src: torch.Tensor,
    q_slot: torch.Tensor,
    certs0: torch.Tensor,
    alive: torch.Tensor,
    credit: torch.Tensor,
    speed_norm: torch.Tensor,
    r: int | torch.Tensor,
    *,
    eps: float,
):
    """Fused sparse delivery: argmin over the entries due this round
    (ties to the lowest source id, then slot), the eps-gated accept,
    arrival clearing and the laggard-credit update. Bool ``alive`` in,
    bool ``take``/``active`` out.

    Returns ``(q_cert', best_cert, best_src, best_slot, take, n_arr,
    credit', active)``."""
    inf = torch.tensor(float("inf"), dtype=q_cert.dtype, device=q_cert.device)
    big = torch.tensor(_I32_MAX, dtype=q_src.dtype, device=q_src.device)
    zero = torch.zeros((), dtype=q_src.dtype, device=q_src.device)
    arr = (q_due == r) & torch.isfinite(q_cert)
    arr_live = torch.where(arr & alive[:, None], q_cert, inf)
    best_cert = arr_live.amin(dim=1)
    finite = torch.isfinite(best_cert)
    hit = (arr_live == best_cert[:, None]) & finite[:, None]
    best_src = torch.where(hit, q_src, big).amin(dim=1)
    sel = hit & (q_src == best_src[:, None])
    best_slot = torch.where(sel, q_slot, big).amin(dim=1)
    best_src = torch.where(finite, best_src, zero)
    best_slot = torch.where(finite, best_slot, zero)
    take = finite & (best_cert < certs0 - eps)
    n_arr = arr.sum(dim=1, dtype=torch.int32)
    q_cert_new = torch.where(arr, inf, q_cert)
    credit2 = credit + speed_norm
    active = alive & (credit2 >= 1.0 - 1e-6)
    credit_new = torch.where(active, credit2 - 1.0, credit2)
    return q_cert_new, best_cert, best_src, best_slot, take, n_arr, credit_new, active


def queue_ingest_ref(
    q_cert: torch.Tensor,
    q_due: torch.Tensor,
    q_src: torch.Tensor,
    q_slot: torch.Tensor,
    c_cert: torch.Tensor,
    c_due: torch.Tensor,
    c_src: torch.Tensor,
    c_slot: torch.Tensor,
):
    """Merge the (W, m) candidate block into the (W, C) queues and keep
    the C smallest per row by (cert, src, due), stable: among fully
    tied keys the earlier column (a resident entry) survives.

    Returns ``(q_cert', q_due', q_src', q_slot')``."""
    m_cert = torch.cat([q_cert, c_cert], dim=1)
    m_due = torch.cat([q_due, c_due], dim=1)
    m_src = torch.cat([q_src, c_src], dim=1)
    m_slot = torch.cat([q_slot, c_slot], dim=1)
    keep = lexsort((m_due, m_src, m_cert), dim=-1)[:, : q_cert.shape[1]]
    return (
        torch.gather(m_cert, 1, keep),
        torch.gather(m_due, 1, keep),
        torch.gather(m_src, 1, keep),
        torch.gather(m_slot, 1, keep),
    )


def margin_delta_oracle(model, xb: torch.Tensor, t_lo: int, t_hi: int) -> torch.Tensor:
    """Stump-by-stump margin delta of slots ``[t_lo, t_hi)`` of a
    ``StumpModel`` on rows ``xb (n, d)``: the model's own semantics, which
    ``scatter_model_slice`` + kernel K4 must reproduce."""
    out = torch.zeros((xb.shape[0],), dtype=torch.float32, device=xb.device)
    for k in range(t_lo, t_hi):
        h = torch.where(xb[:, model.feat[k]] > model.thr[k], 1.0, -1.0) * model.sign[k]
        out = out + model.alpha[k] * h
    return out
