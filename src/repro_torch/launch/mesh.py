"""Worker mesh for the sharded TMSN engine, on ``torch.distributed``;
counterpart of ``make_worker_mesh``, ``ici_round_seconds`` and
``dcn_round_seconds`` in ``src/repro/launch/mesh.py``.

One process (rank) per shard. A :class:`WorkerMesh` names the rank, the
world, the rank's device and the process group: a 1-D ``("workers",)``
mesh, or a two-tier ``("pod", "workers")`` mesh whose ``intra`` is the
mesh of the rank's own pod (a process subgroup; ``pod`` is the
slow axis, so rank ``i`` sits in pod ``i // (n / pods)``). The
collectives below are the ones the engine issues, over whichever of the
two meshes they are given, each a copy of bytes (never a summing
reduction of floats, so ``-0.0`` and every NaN payload survive):

  * :func:`all_gather_tree` — a pytree of tensors whose leaves lead with
    the rank's rows, packed into one byte buffer and gathered in one
    call, rank-major (the reference's tiled ``all_gather``);
  * :func:`broadcast_tree` — the same packing, from one rank to all;
  * :func:`all_reduce` — ``"any"``, ``"max"`` or ``"sum"`` of an integer;
  * :func:`all_gather_object` — picklable host objects.

The backend follows from the ranks' devices, never from a fallback
(:func:`backend_for`): ``nccl`` when every rank has a card of its own,
``gloo`` on the CPU or when ranks share a card (NCCL refuses two ranks
on one GPU). Under ``gloo`` with CUDA tensors the collectives stage
their byte buffer through host memory (:attr:`WorkerMesh.host_staged`):
a path chosen from the mesh, not a retry after an error.

:func:`spawn_world` starts a world of ranks with
``torch.multiprocessing`` (spawn), builds the CUDA kernels once before
it starts them, and returns what each rank's function returned.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from collections.abc import Callable
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map

#: NVLink 4 of one H100 SXM, per direction (450 GB/s each way, 900 GB/s
#: aggregate): NVIDIA's published figure, not measured here
NVLINK_BYTES_PER_S = 450e9

#: the network between H100 nodes: one NVIDIA ConnectX-7 port at
#: 400 Gb/s (the InfiniBand NDR adapter of a DGX H100 node, one per GPU),
#: NVIDIA's published figure, not measured here
DCN_BYTES_PER_S = 50e9


@dataclasses.dataclass(eq=False)
class WorkerMesh:
    """A mesh of ``size`` ranks, one shard each, as seen from ``rank``:
    1-D ``("workers",)`` when ``pods == 1``, else ``("pod", "workers")``
    with ``size / pods`` ranks a pod. ``group`` is the world's process
    group (the cross-pod tier's); ``intra`` is the 1-D mesh of this
    rank's pod over the pod's subgroup, rank numbered within the pod (the
    intra-pod tier's; the mesh itself with one pod).
    ``collective_seconds`` and ``collectives`` count the host time and
    the number of calls spent in this module's collectives on this mesh,
    not on ``intra``, which keeps its own."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any = None
    pods: int = 1
    collective_seconds: float = 0.0
    collectives: int = 0
    intra: Any = None

    def __post_init__(self) -> None:
        if self.intra is None:
            self.intra = self

    @property
    def axis_names(self) -> tuple:
        return ("workers",) if self.pods == 1 else ("pod", "workers")

    @property
    def shape(self) -> dict:
        if self.pods == 1:
            return {"workers": self.size}
        return {"pod": self.pods, "workers": self.size // self.pods}

    @property
    def pod(self) -> int:
        """The pod this rank sits in (0 with one pod)."""
        return self.rank // (self.size // self.pods)

    @property
    def host_staged(self) -> bool:
        """True when the collectives copy through host memory: ``gloo``
        ranks holding CUDA tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _tick(self, t0: float) -> None:
        self.collective_seconds += time.perf_counter() - t0
        self.collectives += 1


def backend_for(devices: list) -> str:
    """The backend a world of ranks on ``devices`` (one per rank) needs:
    ``nccl`` when every rank has a CUDA device of its own, ``gloo`` when
    any rank is on the CPU or two ranks share a card."""
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        return "gloo"
    idx = [d.index if d.index is not None else 0 for d in devs]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


def make_worker_mesh(
    num_devices: int | None = None,
    pods: int = 1,
    *,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> WorkerMesh:
    """The worker mesh of this ``torch.distributed`` world: 1-D
    ``("workers",)`` with ``pods=1``, two-tier ``("pod", "workers")``
    with ``pods > 1`` (``pods`` pods of ``num_devices / pods`` ranks,
    ``pod`` the slow axis, so the flat rank order is the 1-D mesh's).

    Needs an initialized world of exactly ``num_devices`` ranks (the
    world's size when None). ``device`` is this rank's device: the card
    by default, whose index must then be given when ranks share it or
    when the rank is not the card's own (``"cuda"`` alone means
    ``cuda:<rank>``); ``"cpu"`` runs the plain path. ``backend``, when
    given, must be the world's, and the world's must be the one
    :func:`backend_for` gives for the ranks' devices (one collective, at
    construction, gathers them). A pod mesh makes one process subgroup a
    pod with ``dist.new_group``: every rank of the world must call this
    function with the same ``pods``, since every rank creates every
    pod's group, in pod order. It may be called again in the same world,
    for example for a flat and a pod mesh over the same ranks."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_worker_mesh needs an initialized torch.distributed world "
            "(init_process_group with one rank per shard)"
        )
    world = dist.get_world_size()
    if num_devices is None:
        num_devices = world
    if num_devices < 1 or num_devices > world:
        raise ValueError(f"num_devices={num_devices} not in [1, {world}] visible devices")
    if num_devices != world:
        raise ValueError(f"num_devices={num_devices} must be the world size {world}: one rank per shard")
    if pods < 1:
        raise ValueError(f"pods={pods} must be >= 1")
    if num_devices % pods:
        raise ValueError(f"num_devices={num_devices} must divide into {pods} pods")
    rank = dist.get_rank()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index >= torch.cuda.device_count():
            raise ValueError(
                f"rank {rank} asked for {dev}, but {torch.cuda.device_count()} card(s) are visible; "
                "name the shared card (e.g. device='cuda:0') explicitly"
            )
        torch.cuda.set_device(dev)
    world_backend = str(dist.get_backend())
    if backend is not None and backend != world_backend:
        raise ValueError(f"backend={backend!r} but the world was initialized with {world_backend!r}")
    devices: list = [None] * world
    dist.all_gather_object(devices, str(dev))
    need = backend_for(devices)
    if need != world_backend:
        raise ValueError(
            f"ranks on {devices} need the {need!r} backend, the world has {world_backend!r} "
            "(nccl needs a card per rank; the CPU and shared cards need gloo)"
        )
    intra = None
    if pods > 1:
        wpp = world // pods
        # new_group is a collective of the whole world: every rank makes
        # every pod's group, in the same order, and keeps its own
        groups = [dist.new_group(list(range(p * wpp, (p + 1) * wpp))) for p in range(pods)]
        intra = WorkerMesh(rank=rank % wpp, size=wpp, device=dev, backend=world_backend,
                           group=groups[rank // wpp])
    return WorkerMesh(rank=rank, size=world, device=dev, backend=world_backend, group=dist.group.WORLD,
                      pods=pods, intra=intra)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _pack(tree: Any) -> tuple[torch.Tensor, list]:
    """Every leaf's bytes, in leaf order, as one uint8 buffer; and each
    leaf's (dtype, shape, byte count)."""
    leaves = tree_leaves(tree)
    meta, parts = [], []
    for a in leaves:
        if a.dim() == 0:
            raise ValueError("collective leaves need a leading axis")
        b = a.contiguous().reshape(-1).view(torch.uint8)
        meta.append((a.dtype, tuple(a.shape), b.numel()))
        parts.append(b)
    return torch.cat(parts), meta


def _unpack(rows: torch.Tensor, meta: list, tree: Any) -> Any:
    """Inverse of :func:`_pack` over ``rows (n_ranks, nbytes)``: each
    leaf's rank blocks concatenated along its leading axis."""
    n = rows.shape[0]
    out, off = [], 0
    for dtype, shape, nb in meta:
        part = rows[:, off : off + nb].contiguous()
        off += nb
        out.append(part.view(dtype).reshape((n * shape[0],) + shape[1:]))
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def _all_gather_bytes(mesh: WorkerMesh, buf: torch.Tensor) -> torch.Tensor:
    """``(size, nbytes)`` rows of every rank's buffer, on the buffer's device."""
    rows = torch.empty((mesh.size, buf.numel()), dtype=torch.uint8, device=buf.device)
    dist.all_gather(list(rows.unbind(0)), buf, group=mesh.group)
    return rows


def _all_gather_bytes_via_host(mesh: WorkerMesh, buf: torch.Tensor) -> torch.Tensor:
    """:func:`_all_gather_bytes` of a CUDA buffer under gloo: one copy to
    host memory, the gather there, one copy back to the rank's card."""
    return _all_gather_bytes(mesh, buf.cpu()).to(mesh.device)


def all_gather_tree(mesh: WorkerMesh, tree: Any) -> Any:
    """Gather a pytree over the mesh in one collective: a leaf of shape
    ``(n, ...)`` on each rank comes back ``(size * n, ...)``, rank 0's
    rows first. Every rank must pass leaves of the same shapes and
    dtypes. Bits are copied, never summed."""
    t0 = time.perf_counter()
    buf, meta = _pack(tree)
    gather = _all_gather_bytes_via_host if mesh.host_staged else _all_gather_bytes
    out = _unpack(gather(mesh, buf), meta, tree)
    mesh._tick(t0)
    return out


def broadcast_tree(mesh: WorkerMesh, tree: Any, src: int) -> Any:
    """Rank ``src``'s pytree on every rank (leaves of the same shapes and
    dtypes everywhere); bits are copied."""
    t0 = time.perf_counter()
    buf, meta = _pack(tree)
    if mesh.host_staged:
        host = buf.cpu()
        dist.broadcast(host, src=src, group=mesh.group)
        buf = host.to(mesh.device)
    else:
        dist.broadcast(buf, src=src, group=mesh.group)
    out = _unpack(buf.reshape(1, -1), meta, tree)
    mesh._tick(t0)
    return out


_OPS = {"any": dist.ReduceOp.MAX, "max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}


def all_reduce(mesh: WorkerMesh, value: int | bool, op: str) -> int:
    """``"any"`` (of a flag), ``"max"`` or ``"sum"`` of one integer over
    the mesh, as an int64; the flag travels as 0 or 1 (no bool tensors)."""
    if op not in _OPS:
        raise ValueError(f"all_reduce op must be one of {sorted(_OPS)}, got {op!r}")
    t0 = time.perf_counter()
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=_OPS[op], group=mesh.group)
    out = int(t.item())
    mesh._tick(t0)
    return int(out > 0) if op == "any" else out


def all_gather_object(mesh: WorkerMesh, obj: Any) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    t0 = time.perf_counter()
    out: list = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    mesh._tick(t0)
    return out


def ici_round_seconds(
    gossip_bytes_per_round: int,
    bandwidth: float = NVLINK_BYTES_PER_S,
    control_bytes_per_round: int = 0,
) -> float:
    """Lower-bound wire seconds one gossip round would spend on one link,
    from the engine's logical ``gossip_bytes_per_round`` (plus a
    separately reported control-plane share, 0 when the gossip figure
    already holds it, as ``SimResult.gossip_bytes_per_round`` does). The
    default rate is one H100's NVLink per direction
    (:data:`NVLINK_BYTES_PER_S`, published). A derived estimate, not a
    measurement."""
    return float(gossip_bytes_per_round + control_bytes_per_round) / float(bandwidth)


def dcn_round_seconds(
    dcn_bytes_per_round: int,
    bandwidth: float = DCN_BYTES_PER_S,
    control_bytes_per_round: int = 0,
) -> float:
    """Lower-bound wire seconds per round on the cross-pod tier, from the
    pod-mesh engine's amortized ``gossip_bytes_per_round_dcn`` (plus,
    optionally, a separately reported control-plane share): the formula
    of :func:`ici_round_seconds` at the inter-node rate
    (:data:`DCN_BYTES_PER_S`, published). A derived estimate, not a
    measurement."""
    return ici_round_seconds(dcn_bytes_per_round, bandwidth, control_bytes_per_round=control_bytes_per_round)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, devices: list, backend: str, workdir: str, args, pods: int) -> None:
    # one intra-op thread a rank: the ranks share the host's cores, and a
    # CPU rank then reduces in the order of a one-thread run
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'init')}", rank=rank, world_size=len(devices)
    )
    try:
        mesh = make_worker_mesh(len(devices), pods, device=devices[rank], backend=backend)
        out = fn(mesh, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_world(
    fn: Callable,
    devices: list,
    workdir: str | os.PathLike,
    args: tuple = (),
    pods: int = 1,
) -> list:
    """Run ``fn(mesh, *args)`` on ``len(devices)`` ranks, rank ``i`` on
    ``devices[i]`` (the same card named twice means two ranks share it),
    and return each rank's (picklable) result in rank order. ``mesh`` is
    :func:`make_worker_mesh`'s with ``pods`` pods.

    ``fn`` must be importable by the spawned children (a module-level
    function). ``workdir`` must be empty or new: it holds the file store
    of ``init_process_group`` and the results. With a CUDA device the
    kernels are built here, once, before any rank starts. Every rank runs
    one intra-op thread. A rank that raises makes this raise."""
    import torch.multiprocessing as mp

    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    if any(p.name == "init" or p.name.startswith("rank") for p in work.iterdir()):
        raise ValueError(f"spawn_world: {work} holds files of an earlier world")
    # an index-less "cuda" is rank i's own card, as in make_worker_mesh
    devs = [resolve_device(d) for d in devices]
    devices = [str(torch.device("cuda", i) if d.type == "cuda" and d.index is None else d)
               for i, d in enumerate(devs)]
    backend = backend_for(devices)
    if any(torch.device(d).type == "cuda" for d in devices):
        from repro_torch.kernels.build import build

        build()
    mp.spawn(_rank_main, args=(fn, devices, backend, str(work), args, pods), nprocs=len(devices), join=True)
    out = []
    for r in range(len(devices)):
        with open(work / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


__all__ = [
    "DCN_BYTES_PER_S",
    "NVLINK_BYTES_PER_S",
    "WorkerMesh",
    "all_gather_object",
    "all_gather_tree",
    "all_reduce",
    "backend_for",
    "broadcast_tree",
    "dcn_round_seconds",
    "ici_round_seconds",
    "make_worker_mesh",
    "spawn_world",
]
