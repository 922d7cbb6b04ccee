"""Wrappers of the hand-written CUDA kernels (K1 ``edge_scan``, K2
``round_deliver``, K3 ``queue_ingest``, K4 ``weight_update``, K5
``adamw_step``, K6 ``attention_fwd``/``attention_bwd``), and
``edge_scan_sharded``, K1 over one rank's workers of a mesh.

Counterpart of ``src/repro/kernels/ops.py``. Each wrapper checks device,
dtype, shape and contiguity, allocates its outputs with ``torch.empty``
(K1 also keeps scratch per device and stream, reused across calls) and
then:

  * on CPU tensors calls the plain version in :mod:`.ref` (K5 and K6
    have none here and raise: ``optim.adamw.apply_updates_`` sends CPU
    leaves to its plain update, ``_update``, and ``models.attention``
    sends what K6 does not take to ``_sdpa``);
  * on CUDA tensors launches its kernel on the current stream (building
    the library at first use) and raises if the launch is refused, and
    counts the launch in :data:`LAUNCHES`;
  * on any other device raises.

There is no fallback from a failed build or launch to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import ref

#: launches per kernel since the last :func:`reset_launches`; a wrapper
#: adds one where it launches its kernel and nowhere else
LAUNCHES = {"edge_scan": 0, "round_step": 0, "queue_ingest": 0, "weight_update": 0, "adamw_step": 0,
            "attention_fwd": 0, "attention_bwd": 0}

#: K1 plan: aim for this many 256-thread blocks per SM ...
EDGE_SCAN_BLOCKS_PER_SM = 2
#: ... but give no row tile fewer rows than this ...
EDGE_SCAN_MIN_TILE_ROWS = 128
#: ... and let one block sum up to this many row tiles of a worker; more
#: take a second level of groups of about sqrt(tiles)
EDGE_SCAN_ONE_LEVEL_TILES = 16
#: K3 block size: whole rows of C+m threads, up to this many threads
_QUEUE_INGEST_THREADS = 256
#: K2: at most this many warps per block
ROUND_STEP_MAX_WARPS = 8
#: rows per K4 block (one thread per row)
WEIGHT_UPDATE_TILE_N = 128
#: leaves one K5 launch takes: their table travels as the kernel's
#: parameters, 4 KB (``kMaxLeaves`` in ``adamw_step.cu``)
ADAMW_MAX_LEAVES = 48
#: K5's parameter/grad and state dtypes (all four pairs are compiled)
_ADAMW_DTYPES = (torch.float32, torch.bfloat16)
#: K6's head widths (qk, v): the instances the library holds (grouped-query
#: attention at head 128; DeepSeek-V3's MLA expanded, 128 + 64 rotary)
ATTENTION_HEAD_DIMS = ((128, 128), (192, 128))
#: positions one entry of K6's tile bounds covers (``kQuantum`` in ``attention.cu``)
ATTENTION_BOUNDS_ROWS = 32
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


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def edge_scan_plan(nw: int, n: int, sms: int) -> tuple[int, int, int, int]:
    """K1's work split for ``nw`` workers of ``n`` rows: ``(tile_rows,
    tiles, group, fold)``. A worker's rows are cut into ``tiles`` row tiles
    of ``tile_rows`` rows (the last may be shorter), enough for about
    ``EDGE_SCAN_BLOCKS_PER_SM`` blocks per SM with a lone worker; the
    tiles' sums are added in tile order within each ``group`` of tiles,
    and with more than one group the groups' sums in group order. That
    split never depends on ``nw``, so a worker's sums are the same bits
    whichever batch it is scanned in (the sharded engine's ranks scan
    W_local workers, one device all W). ``nw`` sets only ``fold``, the
    tiles a block takes: 1 (a block a tile, summed across blocks by a
    ticket) until ``nw`` blocks a group fill the SMs, then the whole
    group, folded in tile order by one block with no first-level ticket.
    ``tiles == 1`` needs no scratch."""
    want = max(1, EDGE_SCAN_BLOCKS_PER_SM * sms)
    tiles = max(1, min(want, -(-n // EDGE_SCAN_MIN_TILE_ROWS)))
    tile_rows = max(1, -(-n // tiles))
    tiles = max(1, -(-n // tile_rows))
    group = tiles if tiles <= EDGE_SCAN_ONE_LEVEL_TILES else math.isqrt(tiles - 1) + 1
    fold = group if nw * -(-tiles // group) >= sms else 1
    return tile_rows, tiles, group, fold


#: K1's scratch per (device, stream): partial sums and zeroed ticket counters,
#: grown when a call needs more and otherwise reused (each launch leaves its
#: counters at zero)
_EDGE_SCAN_SCRATCH: dict = {}


def _edge_scan_scratch(dev: torch.device, stream: int, floats: int, counters: int):
    key = (dev, stream)
    part, cnt = _EDGE_SCAN_SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty((max(floats, 1),), dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros((max(counters, 1),), dtype=torch.int32, device=dev)
    _EDGE_SCAN_SCRATCH[key] = (part, cnt)
    return part, cnt


def queue_ingest_plan(nw: int, n: int, sms: int) -> tuple[int, int]:
    """K3's block shape for ``n = C + m`` entries per row:
    ``(rows_per_block, row_threads)``. Every entry gets a thread (at most
    1024 a row); small W runs one row per block, large W packs whole rows
    into blocks of up to ``_QUEUE_INGEST_THREADS`` threads."""
    row_threads = max(1, min(1024, n))
    rows = max(1, min(_QUEUE_INGEST_THREADS // row_threads, -(-nw // (2 * sms))))
    return rows, row_threads


def round_step_plan(nw: int, cap: int, sms: int, aligned: bool = True) -> tuple[int, int, int]:
    """K2's block shape: ``(vec, row_lanes, warps_per_block)``. A lane
    loads ``vec`` entries at a time, 4 (16-byte loads) where ``cap % 4 == 0``
    and the leaves are ``aligned`` to 16 bytes, else 1; a row gets the
    fewest lanes, a power of two up to 32, whose loads cover it in one
    pass (longer rows loop), so ``32 // row_lanes`` rows share a warp;
    blocks hold up to ``ROUND_STEP_MAX_WARPS`` warps, fewer where more
    warps a block would leave an SM without one."""
    vec = 4 if aligned and cap % 4 == 0 else 1
    loads = max(1, -(-cap // vec))
    row_lanes = min(32, 1 << (loads - 1).bit_length())
    warps = -(-max(nw, 1) // (32 // row_lanes))
    return vec, row_lanes, max(1, min(ROUND_STEP_MAX_WARPS, warps // sms))


def edge_scan(
    xb: torch.Tensor,
    wy: torch.Tensor,
    w: torch.Tensor,
    *,
    num_bins: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1, batched over a leading worker axis: ``xb (W, n, d)`` int32,
    ``wy``/``w (W, n)`` f32 -> ``(hist (W, d, B), W_ (W,), V (W,),
    T (W,))``, all f32; bins outside ``[0, B)`` add nothing. One launch
    covers every worker, split by :func:`edge_scan_plan`; the result is
    bitwise the same on every launch with the same inputs."""
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
    tile_rows, tiles, group, fold = edge_scan_plan(nw, n, _sm_count(dev))
    groups = -(-tiles // group)
    cells = d * num_bins + 3
    stream = _stream(dev)
    part1_n = nw * tiles * cells if tiles > 1 and fold == 1 else 0
    part2_n = nw * groups * cells if groups > 1 else 0
    part, cnt = _edge_scan_scratch(dev, stream, part1_n + part2_n, nw * (groups + 1))
    err = lib.edge_scan_launch(
        _ptr(xb), _ptr(wy), _ptr(w), _ptr(part), _ptr(part) + 4 * part1_n, _ptr(cnt), _ptr(hist),
        _ptr(scal), nw, n, d, num_bins, tile_rows, tiles, group, fold, stream,
    )
    _raise_on("edge_scan", err)
    LAUNCHES["edge_scan"] += 1
    return hist, scal[0], scal[1], scal[2]


def edge_scan_sharded(
    xb: torch.Tensor,
    wy: torch.Tensor,
    w: torch.Tensor,
    *,
    mesh,
    num_bins: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`edge_scan` sharded over a ``workers`` mesh of ranks
    (:func:`repro_torch.launch.mesh.make_worker_mesh`); counterpart of
    the reference's ``edge_scan_sharded``. Every rank passes the global
    ``(W, n, d)`` / ``(W, n)`` inputs, runs ONE K1 launch over its own
    ``W / n_dev`` workers' rows, and gets the global ``(W, d, B)``
    histograms and ``(W,)`` sums back, gathered (a copy of bits, rank 0's
    rows first). A wrapper, not a kernel: its launches are K1's."""
    from repro_torch.launch.mesh import all_gather_tree

    n_dev = mesh.shape["workers"]
    if xb.shape[0] % n_dev:
        raise ValueError(f"worker axis {xb.shape[0]} must divide over {n_dev} devices")
    wl = xb.shape[0] // n_dev
    rows = slice(mesh.rank * wl, (mesh.rank + 1) * wl)
    hist, w_, v, t = edge_scan(xb[rows], wy[rows], w[rows], num_bins=num_bins)
    g = all_gather_tree(mesh, (hist, w_, v, t))
    return g[0], g[1], g[2], g[3]


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
    bool ``take``/``active`` out), bit for bit, the sign of a zero
    ``best_cert`` included. One launch, shaped by :func:`round_step_plan`."""
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

    aligned = all(t.data_ptr() % 16 == 0 for t in (q_cert, q_due, q_src, q_slot, q_cert_new))
    vec, row_lanes, warps_per_block = round_step_plan(nw, cap, _sm_count(dev), aligned)
    err = load_library().round_step_launch(
        *[_ptr(t) for t in args], r, float(eps), *[_ptr(t) for t in outs], nw, cap, vec, row_lanes,
        warps_per_block, _stream(dev),
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
    if (cap + m) * 16 > _MAX_BLOCK_SMEM:
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

    rows_per_block, row_threads = queue_ingest_plan(nw, cap + m, _sm_count(dev))
    rows_per_block = min(rows_per_block, _MAX_BLOCK_SMEM // ((cap + m) * 16))
    err = load_library().queue_ingest_launch(
        *[_ptr(t) for t in args], *[_ptr(t) for t in outs], nw, cap, m, rows_per_block, row_threads,
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


def adamw_step_plan(n_leaves: int) -> list[tuple[int, int]]:
    """K5's launches for ``n_leaves`` leaves of one dtype pair: ``(start,
    end)`` runs of consecutive leaves, at most :data:`ADAMW_MAX_LEAVES` a
    launch."""
    m = ADAMW_MAX_LEAVES
    return [(i, min(i + m, n_leaves)) for i in range(0, n_leaves, m)]


def adamw_step(leaves: list, b1c: torch.Tensor, b2c: torch.Tensor, lr: float | torch.Tensor, cfg) -> None:
    """K5: one AdamW step over ``leaves``, a list of ``(p, g, mu, nu, p',
    mu', nu')`` tuples (the outputs may be the inputs: in place), written
    into the outputs. ``b1c``/``b2c`` are the one-element float32 bias
    corrections, ``lr`` a float or a one-element tensor, ``cfg`` an
    :class:`~repro_torch.optim.AdamWConfig` (``b1``, ``b2``, ``eps``,
    ``weight_decay``, ``state_dtype``). Params, grads and ``p'`` share a
    dtype, float32 or bfloat16; the moments are ``cfg``'s state dtype.
    Same contract as ``optim.adamw._update`` leaf by leaf, bit for bit.
    One launch takes up to :data:`ADAMW_MAX_LEAVES` leaves of one dtype
    pair (:func:`adamw_step_plan`); the scalars are read through device
    pointers, never with ``.item()``. CUDA leaves only: on any other
    device it raises."""
    sdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.state_dtype]
    scalars = [b1c, b2c] + ([lr] if isinstance(lr, torch.Tensor) else [])
    for name, t in zip(("b1c", "b2c", "lr"), scalars):
        if not t.is_floating_point() or t.numel() != 1:
            raise TypeError(f"adamw_step: {name} must be one float value, got {t.dtype} {tuple(t.shape)}")
    for leaf in leaves:
        if len(leaf) != 7:
            raise ValueError(f"adamw_step: a leaf is (p, g, mu, nu, p', mu', nu'), got {len(leaf)} tensors")
        p = leaf[0]
        if p.dtype not in _ADAMW_DTYPES:
            raise TypeError(f"adamw_step: params must be float32 or bfloat16, got {p.dtype}")
        dts = (p.dtype, p.dtype, sdt, sdt, p.dtype, sdt, sdt)
        for name, t, dt in zip(("p", "g", "mu", "nu", "p'", "mu'", "nu'"), leaf, dts):
            _check(f"adamw_step {name}", t, dt, tuple(p.shape))
    if not leaves:
        return
    if not _route("adamw_step", [t for leaf in leaves for t in leaf] + [b1c, b2c]):
        raise ValueError("adamw_step: no plain version on the CPU (optim.adamw._update is one)")
    dev = leaves[0][0].device
    if isinstance(lr, torch.Tensor) and lr.device.type != "cpu":  # a host value is read as eager ops read it
        if lr.device != dev:
            raise ValueError(f"adamw_step: lr on {lr.device}, leaves on {dev}")
        lr_t, lr_f = lr.reshape(()).to(torch.float32), 0.0
    else:
        lr_t, lr_f = None, float(lr)
    b1c, b2c = (t.reshape(()).to(torch.float32) for t in (b1c, b2c))
    from repro_torch.kernels.build import load_library

    lib = load_library()
    groups: dict = {}  # one launch sequence per param dtype (bf16 models keep some float32 leaves)
    for leaf in leaves:
        if leaf[0].numel():
            groups.setdefault(leaf[0].dtype, []).append(leaf)
    stream = _stream(dev)
    for pdt, group in groups.items():
        for lo, hi in adamw_step_plan(len(group)):
            rows = [v for leaf in group[lo:hi] for v in (*(_ptr(t) for t in leaf), leaf[0].numel())]
            table = (ctypes.c_longlong * len(rows))(*rows)
            err = lib.adamw_step_launch(
                table, hi - lo, int(pdt == torch.bfloat16), int(sdt == torch.bfloat16), _ptr(b1c), _ptr(b2c),
                None if lr_t is None else _ptr(lr_t), lr_f, cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
                cfg.weight_decay, stream,
            )
            _raise_on("adamw_step", err)
            LAUNCHES["adamw_step"] += 1


def attention_bounds_shape(b: int, s: int) -> tuple[int, int, int]:
    """K6's tile bounds for ``b`` rows of ``s`` positions: ``(b, tiles,
    2)`` int32, the smallest and largest position of each run of
    :data:`ATTENTION_BOUNDS_ROWS` positions (the last run may be shorter).
    The kernels skip a tile only where these show every pair masked."""
    return (b, -(-s // ATTENTION_BOUNDS_ROWS), 2)


def _attention_check(name: str, q, k, v, positions, window, more=lambda *dims: ()) -> tuple[int, ...]:
    """Raise on anything K6 does not take: q (b, s, H, d_qk), k (b, s, K,
    d_qk), v (b, s, K, d_v), bf16, the head widths one of
    :data:`ATTENTION_HEAD_DIMS`; positions (b, s) int32 with a contiguous
    sequence dimension (a batch stride of 0 is fine); window None or
    positive; every tensor on one CUDA device. ``more(b, s, H, K, d_qk,
    d_v)`` gives further ``(label, tensor, dtype, shape)`` to check.
    Returns ``(b, s, H, K, d_qk, d_v)``."""
    for label, t in [("q", q), ("k", k), ("v", v)]:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {label} must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {label} must be (b, s, heads, width), got {tuple(t.shape)}")
    b, s, H, d_qk = q.shape
    K, d_v = k.shape[2], v.shape[3]
    if tuple(k.shape) != (b, s, K, d_qk) or tuple(v.shape) != (b, s, K, d_v) or K == 0 or H % K:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} are not one GQA layer")
    if (d_qk, d_v) not in ATTENTION_HEAD_DIMS:
        raise ValueError(f"{name}: no instance for head widths ({d_qk}, {d_v}); built: {ATTENTION_HEAD_DIMS}")
    if positions.dtype != torch.int32:
        raise TypeError(f"{name}: positions must be int32, got {positions.dtype}")
    if tuple(positions.shape) != (b, s) or (s > 1 and positions.stride(1) != 1):
        raise ValueError(f"{name}: positions must be (b, s) = {(b, s)} with a contiguous sequence dimension, "
                         f"got {tuple(positions.shape)} strides {positions.stride()}")
    if window is not None and not 0 < window < 2**31:
        raise ValueError(f"{name}: window must be None or a positive int32, got {window}")
    more = list(more(b, s, H, K, d_qk, d_v))
    bf16 = [("q", q), ("k", k), ("v", v)] + [(lab, t) for lab, t, dt, _ in more if dt == torch.bfloat16]
    for label, t, dt, shape in more:
        _check(f"{name} {label}", t, dt, shape)
        if dt != torch.bfloat16 and not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t in bf16:  # the kernels read and write 16 bytes a thread
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} needs a contiguous last dimension, strides in multiples of 8 "
                             f"elements and a 16-byte aligned start; got strides {t.stride()}, start "
                             f"{t.data_ptr() % 16} mod 16")
    dev = q.device
    for t in [k, v, positions] + [t for _, t, _, _ in more]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only, got {dev} (models.attention._sdpa is the plain version)")
    return b, s, H, K, d_qk, d_v


def _attention_launch(fn: str, ptrs: list, tensors: list, b, s, H, K, window, d_qk, d_v, scale, dev) -> None:
    """One of K6's C entry points: ``ptrs`` the 12 tensors (or None) in
    ``attention.cu``'s order, ``tensors`` q, k, v, dO (or None) whose
    (batch, sequence, head) strides it reads, then the positions."""
    from repro_torch.kernels.build import load_library

    strides = [st for t in tensors[:4] for st in (t.stride()[:3] if t is not None else (0, 0, 0))]
    strides.append(tensors[4].stride(0))
    err = getattr(load_library(), fn)(
        (ctypes.c_void_p * 12)(*(None if t is None else _ptr(t) for t in ptrs)),
        (ctypes.c_longlong * 13)(*strides), b, s, H, K, window or 0, d_qk, d_v, scale, _stream(dev),
    )
    _raise_on(fn, err)


def attention_fwd(q, k, v, positions, window: int | None, scale: float):
    """K6's forward: causal GQA over the whole sequence, query head ``h``
    reading KV head ``h // (H // K)``, a key visible to a query where
    ``kpos <= qpos`` (and ``kpos > qpos - window`` with a window), the
    products scaled in float32 by ``scale``. Takes q (b, s, H, d_qk), k
    (b, s, K, d_qk), v (b, s, K, d_v) bf16 in any layout with a
    contiguous, 16-byte aligned head width, and positions (b, s) int32.
    Returns ``(o, lse, bounds)``: o (b, s, H, d_v) bf16, the log-sum-exp
    (b, H, s) float32 (+inf for a query that sees no key), and the tile
    bounds (:func:`attention_bounds_shape`) the backward reads again.
    CUDA tensors only; on anything else it raises (see
    :func:`_attention_check`)."""
    b, s, H, K, d_qk, d_v = _attention_check("attention_fwd", q, k, v, positions, window)
    dev = q.device
    o = torch.empty((b, s, H, d_v), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, H, s), dtype=torch.float32, device=dev)
    bounds = torch.empty(attention_bounds_shape(b, s), dtype=torch.int32, device=dev)
    if b * s:
        _attention_launch("attention_fwd_launch", [q, k, v, positions, bounds, o, lse] + [None] * 5,
                          [q, k, v, None, positions], b, s, H, K, window, d_qk, d_v, scale, dev)
        LAUNCHES["attention_fwd"] += 1
    return o, lse, bounds


def attention_bwd(q, k, v, positions, o, lse, bounds, do, window: int | None, scale: float):
    """K6's backward: ``(dq, dk, dv)`` in q/k/v's shapes, bf16, from the
    forward's inputs, its ``o``, ``lse`` and ``bounds``, and ``do`` (b, s,
    H, d_v) bf16 in any layout :func:`attention_fwd` takes for q. The
    gradients of a KV head sum its G query heads in a fixed order; no
    atomics, so a repeat gives the same bits. CUDA tensors only."""
    def more(b, s, H, K, d_qk, d_v):
        return [("do", do, torch.bfloat16, (b, s, H, d_v)), ("o", o, torch.bfloat16, (b, s, H, d_v)),
                ("lse", lse, torch.float32, (b, H, s)),
                ("bounds", bounds, torch.int32, attention_bounds_shape(b, s))]

    b, s, H, K, d_qk, d_v = _attention_check("attention_bwd", q, k, v, positions, window, more)
    if not o.is_contiguous():
        raise ValueError("attention_bwd: o must be contiguous (the forward's output)")
    dev = q.device
    dq = torch.empty((b, s, H, d_qk), dtype=torch.bfloat16, device=dev)
    dk = torch.empty((b, s, K, d_qk), dtype=torch.bfloat16, device=dev)
    dv = torch.empty((b, s, K, d_v), dtype=torch.bfloat16, device=dev)
    dsum = torch.empty((b, H, s), dtype=torch.float32, device=dev)
    if b * s:
        _attention_launch("attention_bwd_launch", [q, k, v, positions, bounds, o, lse, do, dq, dk, dv, dsum],
                          [q, k, v, do, positions], b, s, H, K, window, d_qk, d_v, scale, dev)
        LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


__all__ = [
    "ADAMW_MAX_LEAVES",
    "ATTENTION_BOUNDS_ROWS",
    "ATTENTION_HEAD_DIMS",
    "LAUNCHES",
    "adamw_step",
    "adamw_step_plan",
    "attention_bounds_shape",
    "attention_bwd",
    "attention_fwd",
    "edge_scan",
    "edge_scan_plan",
    "edge_scan_sharded",
    "queue_ingest",
    "queue_ingest_plan",
    "reset_launches",
    "round_deliver",
    "round_step_plan",
    "weight_update",
]
