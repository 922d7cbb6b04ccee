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
    bool ``take``/``active`` out. A zero ``best_cert`` is -0.0 when any of
    the tied zeros is, as the reference's ``jnp.min`` gives it
    (``torch.amin`` keeps whichever zero it meets first).

    Returns ``(q_cert', best_cert, best_src, best_slot, take, n_arr,
    credit', active)``."""
    inf = torch.tensor(float("inf"), dtype=q_cert.dtype, device=q_cert.device)
    big = torch.tensor(_I32_MAX, dtype=q_src.dtype, device=q_src.device)
    zero = torch.zeros((), dtype=q_src.dtype, device=q_src.device)
    arr = (q_due == r) & torch.isfinite(q_cert)
    arr_live = torch.where(arr & alive[:, None], q_cert, inf)
    best_cert = arr_live.amin(dim=1)
    neg_zero = (best_cert == 0) & torch.signbit(arr_live).any(dim=1)
    best_cert = torch.where(neg_zero, -torch.zeros_like(best_cert), best_cert)
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


def round_step_key_select(q_cert, q_due, q_src, q_slot, alive, r):
    """``(best_cert, best_src, best_slot, n_arr)`` of :func:`round_step_ref`
    computed the way kernel K2 computes them: each live arriving entry's
    96-bit key (the first three words of :func:`queue_ingest_keys` over
    (cert, src, slot)), every other entry all ones; the row's least key
    decoded; the sign of a zero from any live arriving -0.0. A mirror of
    the kernel for the tests; no path runs it."""
    arr = (q_due == r) & torch.isfinite(q_cert)
    cand = arr & alive[:, None]
    key = queue_ingest_keys(q_cert, q_slot, q_src, torch.zeros_like(q_src))[..., :3]
    key = torch.where(cand[..., None], key, 0xFFFFFFFF)
    first = lexsort((key[..., 2], key[..., 1], key[..., 0]), dim=-1)[:, 0]
    best = key[torch.arange(key.shape[0], device=key.device), first]  # (W, 3)
    finite = best[:, 0] != 0xFFFFFFFF
    u = torch.where(best[:, 0] >= 0x80000000, best[:, 0] & 0x7FFFFFFF, best[:, 0] ^ 0xFFFFFFFF)
    neg = (cand & (q_cert.view(torch.int32) == -(2**31))).any(dim=1)
    u = torch.where(finite, torch.where((u == 0) & neg, 0x80000000, u), 0x7F800000)

    def int32(words):  # uint32 words held in int64 -> the int32 of the same bits
        return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)

    best_src = torch.where(finite, int32(best[:, 1] ^ 0x80000000), 0)
    best_slot = torch.where(finite, int32(best[:, 2] ^ 0x80000000), 0)
    return int32(u).view(torch.float32), best_src, best_slot, arr.sum(dim=1, dtype=torch.int32)


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


def queue_ingest_keys(
    cert: torch.Tensor, due: torch.Tensor, src: torch.Tensor, column: torch.Tensor
) -> torch.Tensor:
    """Kernel K3's 128-bit sort key of each entry, as its four uint32
    words (held in int64), most significant first: an order-preserving
    uint32 of ``cert`` with -0.0 folded to +0.0, ``src ^ 0x80000000``,
    ``due ^ 0x80000000`` and the column. Unsigned lexicographic order of
    the words is the order (cert, src, due, column) of
    :func:`queue_ingest_ref`. A mirror of the kernel for the tests; no path
    runs it."""
    u = cert.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    c_key = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    s_key = (src.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    d_key = (due.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    return torch.stack([c_key, s_key, d_key, column.to(torch.int64)], dim=-1)


def queue_ingest_rank_select(q_cert, q_due, q_src, q_slot, c_cert, c_due, c_src, c_slot):
    """:func:`queue_ingest_ref` computed the way kernel K3 computes it:
    each merged entry's rank is the number of keys
    (:func:`queue_ingest_keys`) below its own, and the entry of rank r is
    written to column r when r < C. A mirror of the kernel for the tests;
    no path runs it."""
    merged = [torch.cat(p, dim=1) for p in ((q_cert, c_cert), (q_due, c_due), (q_src, c_src), (q_slot, c_slot))]
    nw, n = merged[0].shape
    column = torch.arange(n, device=q_cert.device).expand(nw, n)
    key = queue_ingest_keys(merged[0], merged[1], merged[2], column)
    kj, kk = key.unsqueeze(2), key.unsqueeze(1)  # (W, j, 1, 4), (W, 1, k, 4)
    below = torch.zeros((nw, n, n), dtype=torch.bool, device=key.device)
    tied = torch.ones_like(below)
    for word in range(4):
        below = below | (tied & (kj[..., word] < kk[..., word]))
        tied = tied & (kj[..., word] == kk[..., word])
    rank = below.sum(dim=1)  # (W, k): a permutation of 0..n-1 per row
    at_rank = torch.empty_like(rank).scatter_(1, rank, column.contiguous())
    keep = at_rank[:, : q_cert.shape[1]]
    return tuple(torch.gather(a, 1, keep) for a in merged)


def margin_delta_oracle(model, xb: torch.Tensor, t_lo: int, t_hi: int) -> torch.Tensor:
    """Stump-by-stump margin delta of slots ``[t_lo, t_hi)`` of a
    ``StumpModel`` on rows ``xb (n, d)``: the model's own semantics, which
    ``scatter_model_slice`` + kernel K4 must reproduce."""
    out = torch.zeros((xb.shape[0],), dtype=torch.float32, device=xb.device)
    for k in range(t_lo, t_hi):
        h = torch.where(xb[:, model.feat[k]] > model.thr[k], 1.0, -1.0) * model.sign[k]
        out = out + model.alpha[k] * h
    return out
