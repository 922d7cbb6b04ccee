"""Wrappers of the hand-written CUDA kernels (K1 ``edge_scan``, K2
``round_deliver``, K3 ``queue_ingest``, K4 ``weight_update``).

Counterpart of ``src/repro/kernels/ops.py``. Each wrapper checks device,
dtype, shape and contiguity, allocates its outputs with ``torch.empty``
and then:

  * on CPU tensors calls the plain version in :mod:`.ref`;
  * on CUDA tensors launches its kernel on the current stream (building
    the library at first use) and raises if the launch is refused, and
    counts the launch in :data:`LAUNCHES`;
  * on any other device raises.

There is no fallback from a failed build or launch to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref

#: launches per kernel since the last :func:`reset_launches`; a wrapper
#: adds one where it launches its kernel and nowhere else
LAUNCHES = {"edge_scan": 0, "round_step": 0, "queue_ingest": 0, "weight_update": 0}

#: rows per K1 block tile (a 256-thread block walks them in row groups)
EDGE_SCAN_TILE_N = 256
#: K3 stages each row's C+m entries (16 B each) in shared memory
_QUEUE_INGEST_SMEM = 48 * 1024
#: rows per K4 block (one thread per row)
WEIGHT_UPDATE_TILE_N = 128
#: shared memory one block may use on an H100 (232 448 B, opted in above 48 KB)
_MAX_BLOCK_SMEM = 232_448


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _route(name: str, tensors: list[torch.Tensor]) -> bool:
    """True = launch the CUDA kernel, False = plain version on the CPU."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {dev}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def edge_scan(
    xb: torch.Tensor,
    wy: torch.Tensor,
    w: torch.Tensor,
    *,
    num_bins: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1, batched over a leading worker axis: ``xb (W, n, d)`` int32,
    ``wy``/``w (W, n)`` f32 -> ``(hist (W, d, B), W_ (W,), V (W,),
    T (W,))``, all f32. One launch covers every worker."""
    if xb.dim() != 3:
        raise ValueError(f"edge_scan: xb must be (W, n, d), got {tuple(xb.shape)}")
    nw, n, d = xb.shape
    _check("edge_scan xb", xb, torch.int32, (nw, n, d))
    _check("edge_scan wy", wy, torch.float32, (nw, n))
    _check("edge_scan w", w, torch.float32, (nw, n))
    if not 1 <= num_bins <= 32:
        raise ValueError(f"edge_scan: num_bins must be in [1, 32], got {num_bins}")
    if not _route("edge_scan", [xb, wy, w]):
        return ref.edge_scan_ref(xb, wy, w, num_bins)
    dev = xb.device
    hist = torch.empty((nw, d, num_bins), dtype=torch.float32, device=dev)
    scal = torch.empty((3, nw), dtype=torch.float32, device=dev)
    if nw == 0:
        return hist, scal[0], scal[1], scal[2]
    from repro_torch.kernels.build import load_library

    lib = load_library()
    tiles = max(1, -(-n // EDGE_SCAN_TILE_N))
    part_hist = torch.empty((nw, tiles, d, num_bins), dtype=torch.float32, device=dev)
    part_scal = torch.empty((nw, tiles, 3), dtype=torch.float32, device=dev)
    err = lib.edge_scan_launch(
        _ptr(xb), _ptr(wy), _ptr(w), _ptr(part_hist), _ptr(part_scal), _ptr(hist), _ptr(scal),
        nw, n, d, num_bins, EDGE_SCAN_TILE_N, _stream(dev),
    )
    _raise_on("edge_scan", err)
    LAUNCHES["edge_scan"] += 1
    return hist, scal[0], scal[1], scal[2]


def round_deliver(
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
    """K2: fused sparse delivery + eps-gated accept + laggard credit.
    Same contract as :func:`.ref.round_step_ref` (bool ``alive`` in,
    bool ``take``/``active`` out)."""
    nw, cap = q_cert.shape
    _check("round_deliver q_cert", q_cert, torch.float32, (nw, cap))
    for name, t in (("q_due", q_due), ("q_src", q_src), ("q_slot", q_slot)):
        _check(f"round_deliver {name}", t, torch.int32, (nw, cap))
    for name, t in (("certs0", certs0), ("credit", credit), ("speed_norm", speed_norm)):
        _check(f"round_deliver {name}", t, torch.float32, (nw,))
    _check("round_deliver alive", alive, torch.bool, (nw,))
    args = [q_cert, q_due, q_src, q_slot, certs0, alive, credit, speed_norm]
    if not _route("round_deliver", args):
        return ref.round_step_ref(*args, r, eps=eps)
    dev = q_cert.device
    r = int(r)
    q_cert_new = torch.empty_like(q_cert)
    best_cert = torch.empty((nw,), dtype=torch.float32, device=dev)
    best_src = torch.empty((nw,), dtype=torch.int32, device=dev)
    best_slot = torch.empty((nw,), dtype=torch.int32, device=dev)
    take = torch.empty((nw,), dtype=torch.bool, device=dev)
    n_arr = torch.empty((nw,), dtype=torch.int32, device=dev)
    credit_new = torch.empty((nw,), dtype=torch.float32, device=dev)
    active = torch.empty((nw,), dtype=torch.bool, device=dev)
    outs = (q_cert_new, best_cert, best_src, best_slot, take, n_arr, credit_new, active)
    if nw == 0:
        return outs
    from repro_torch.kernels.build import load_library

    err = load_library().round_step_launch(
        *[_ptr(t) for t in args], r, float(eps), *[_ptr(t) for t in outs], nw, cap, _stream(dev)
    )
    _raise_on("round_deliver", err)
    LAUNCHES["round_step"] += 1
    return outs


def queue_ingest(
    q_cert: torch.Tensor,
    q_due: torch.Tensor,
    q_src: torch.Tensor,
    q_slot: torch.Tensor,
    c_cert: torch.Tensor,
    c_due: torch.Tensor,
    c_src: torch.Tensor,
    c_slot: torch.Tensor,
):
    """K3: merge the ``(W, m)`` candidate block into the ``(W, C)``
    pending queues, worst-certificate-first. Same contract as
    :func:`.ref.queue_ingest_ref`; returns ``(cert', due', src', slot')``."""
    nw, cap = q_cert.shape
    m = c_cert.shape[1] if c_cert.dim() == 2 else -1
    _check("queue_ingest q_cert", q_cert, torch.float32, (nw, cap))
    _check("queue_ingest c_cert", c_cert, torch.float32, (nw, m))
    for name, t in (("q_due", q_due), ("q_src", q_src), ("q_slot", q_slot)):
        _check(f"queue_ingest {name}", t, torch.int32, (nw, cap))
    for name, t in (("c_due", c_due), ("c_src", c_src), ("c_slot", c_slot)):
        _check(f"queue_ingest {name}", t, torch.int32, (nw, m))
    args = [q_cert, q_due, q_src, q_slot, c_cert, c_due, c_src, c_slot]
    if not _route("queue_ingest", args):
        return ref.queue_ingest_ref(*args)
    row_bytes = (cap + m) * 16
    if row_bytes > _QUEUE_INGEST_SMEM:
        raise ValueError(f"queue_ingest: C + m = {cap + m} entries exceed one block's shared memory")
    dev = q_cert.device
    outs = (
        torch.empty_like(q_cert),
        torch.empty_like(q_due),
        torch.empty_like(q_src),
        torch.empty_like(q_slot),
    )
    if nw == 0 or cap == 0:
        return outs
    from repro_torch.kernels.build import load_library

    rows_per_block = max(1, min(8, _QUEUE_INGEST_SMEM // row_bytes))
    err = load_library().queue_ingest_launch(
        *[_ptr(t) for t in args], *[_ptr(t) for t in outs], nw, cap, m, rows_per_block,
        _stream(dev),
    )
    _raise_on("queue_ingest", err)
    LAUNCHES["queue_ingest"] += 1
    return outs


def weight_update(
    xb: torch.Tensor,
    y: torch.Tensor,
    margin_l: torch.Tensor,
    margin_s: torch.Tensor,
    a: torch.Tensor,
    c: float | torch.Tensor,
    *,
    num_bins: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: fused incremental margin + weight refresh. ``xb (n, d)`` int32,
    ``y``/``margin_l``/``margin_s (n,)`` f32, ``a (d, B-1)`` f32 and ``c``
    a float or a one-element f32 tensor (from
    :func:`~repro_torch.kernels.weight_update.scatter_model_slice`) ->
    ``(margin' (n,), w (n,))``. Same contract as
    :func:`.ref.weight_update_ref`. On the card ``c`` is read through a
    device pointer, never with ``.item()``."""
    if xb.dim() != 2:
        raise ValueError(f"weight_update: xb must be (n, d), got {tuple(xb.shape)}")
    n, d = xb.shape
    if not 1 <= num_bins <= 32:
        raise ValueError(f"weight_update: num_bins must be in [1, 32], got {num_bins}")
    _check("weight_update xb", xb, torch.int32, (n, d))
    for name, t in (("y", y), ("margin_l", margin_l), ("margin_s", margin_s)):
        _check(f"weight_update {name}", t, torch.float32, (n,))
    _check("weight_update a", a, torch.float32, (d, num_bins - 1))
    args = [xb, y, margin_l, margin_s, a]
    if isinstance(c, torch.Tensor):
        if c.dtype != torch.float32 or c.numel() != 1:
            raise TypeError(f"weight_update: c must be one float32 value, got {c.dtype} {tuple(c.shape)}")
        c = c.reshape(())
        args.append(c)
    if not _route("weight_update", args):
        return ref.weight_update_ref(xb, y, margin_l, margin_s, a, c, num_bins)
    dev = xb.device
    smem = d * num_bins * 8 + WEIGHT_UPDATE_TILE_N * (d | 1) * 4
    if smem > _MAX_BLOCK_SMEM:
        raise ValueError(f"weight_update: d={d}, B={num_bins} need {smem} B of shared memory per block")
    if not isinstance(c, torch.Tensor):
        c = torch.full((), float(c), dtype=torch.float32, device=dev)
    m_new = torch.empty((n,), dtype=torch.float32, device=dev)
    w = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return m_new, w
    from repro_torch.kernels.build import load_library

    err = load_library().weight_update_launch(
        *[_ptr(t) for t in (xb, y, margin_l, margin_s, a, c, m_new, w)], n, d, num_bins,
        WEIGHT_UPDATE_TILE_N, _stream(dev),
    )
    _raise_on("weight_update", err)
    LAUNCHES["weight_update"] += 1
    return m_new, w


__all__ = ["LAUNCHES", "edge_scan", "queue_ingest", "reset_launches", "round_deliver", "weight_update"]
