"""Round-based TMSN engine on one device; counterpart of
``src/repro/core/engine.py``.

All W workers carry their state as stacked ``(W, ...)`` tensors and
advance one scheduling segment per round. Per-link latencies are integer
round delays. Messages in flight live either in the dense ``(W, W, D)``
certificate buffer (``inflight[dst, src, d]``, the exact oracle) or, with
``inflight_capacity = C > 0``, in bounded ``(W, C)`` pending queues;
model payloads are looked up in a ``(D, W)`` snapshot ring.

Round order (a message broadcast during round ``r`` reaches a receiver
before its round ``r + delay`` segment):

  1. deliver arrivals due this round and adopt the best accepted one —
     on the queues through kernel K2 (:func:`repro_torch.kernels.ops.round_deliver`),
     which also advances the laggard credit;
  2. shift the dense buffer (the queues instead clear delivered entries);
  3. run one segment per live, credit-covered worker; workers flagged
     for a resample spend their segment on it;
  4. broadcast certificates that strictly improved — under
     ``control_plane="sparse"`` only the top-``gossip_top_k`` improvers,
     merged into the queues by kernel K3 (:func:`repro_torch.kernels.ops.queue_ingest`);
  5. snapshot the broadcasters' models into the ring.

The port runs round by round in eager mode, with the data-dependent
branches of the reference (``lax.cond``) as Python ``if``s.
``round_step_impl="pallas"`` routes the sparse path through the port's
hand-written kernels (the value keeps the reference's name so one
``REPRO_ROUND_STEP_IMPL`` knob drives both packages); ``"ref"`` takes
their plain versions. Both are bit-identical.

Chaos and serving features, each off by default and each leaving the
clean round's ops as they are: a :class:`FaultPlan` (or
``REPRO_FAULT_PLAN``) drops, duplicates, corrupts and reorders pushed
messages by a stateless per-edge hash, so a faulted run is the
reference's faulted run bit for bit; ``spare_slots`` and a
:class:`MembershipPlan` add joins and leaves; :meth:`TMSNEngine.attach_publisher`
publishes the best model at the reference's chunk boundaries; and
``inflight_capacity="auto"`` sizes the queues from a warm-up probe.
:func:`make_engine` sends a multi-rank ``("workers",)`` or two-tier
``("pod", "workers")`` mesh to the sharded engine
(:mod:`repro_torch.core.engine_sharded`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.protocol import accepts, improves
from repro_torch.core.result import SimResult, TrafficCounters
from repro_torch.core.worker import (
    BatchedTMSNWorker,
    has_resample_hooks,
    resolve_payload_bytes,
    tree_map,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.tree import tree_leaves

#: multiplier on the warm-up probe's ``inflight_occupancy_peak`` when
#: ``inflight_capacity="auto"`` sizes the pending queues
AUTO_CAPACITY_HEADROOM = 2.0


def _env_int(name: str, default: int, special: tuple[str, ...] = ()) -> int | str:
    """Integer ``REPRO_*`` override: unset/empty/whitespace falls back
    to the default; a malformed value raises naming the variable.
    ``special`` whitelists non-integer sentinels that pass through."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    if raw.lower() in special:
        return raw.lower()
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"env override {name} must be an integer, got {raw!r}") from None


def _env_str(name: str, default: str) -> str:
    """String ``REPRO_*`` override; unset/empty/whitespace = default."""
    raw = os.environ.get(name, "").strip()
    return raw if raw else default


def _env_float(name: str, default: float) -> float:
    """Float ``REPRO_*`` override, same contract as :func:`_env_int`."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"env override {name} must be a float, got {raw!r}") from None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Adversarial message-fault schedule, applied to the push
    candidates of every round (see :func:`_inject_faults`).
    Probabilities are per directed edge per round; every mask comes from
    :func:`_fault_hash`, so a plan gives the reference's faults bit for
    bit. ``reorder_max`` needs the pending queues; the partition window
    drops cross-pod edges and is inert on one device."""

    drop_prob: float = 0.0
    duplicate_prob: float = 0.0
    reorder_max: int = 0
    corrupt_prob: float = 0.0
    seed: int = 0
    partition_start: int = -1
    partition_stop: int = -1

    @property
    def active(self) -> bool:
        return (
            self.drop_prob > 0.0
            or self.duplicate_prob > 0.0
            or self.reorder_max > 0
            or self.corrupt_prob > 0.0
            or (0 <= self.partition_start < self.partition_stop)
        )


@dataclasses.dataclass(frozen=True)
class MembershipPlan:
    """Elastic-membership schedule: ``(round, slot)`` joins into the
    spare slots ``[n_workers - spare_slots, n_workers)`` with 1-based
    rounds (a join at round 1 is a member from the start), and
    ``(round, worker)`` leaves, folded into ``fail_round`` by ``min``.
    A joiner's laggard credit restarts at 0 on its join round."""

    joins: tuple = ()
    leaves: tuple = ()


def _parse_fault_spec(spec: str) -> FaultPlan | None:
    """Parse a ``REPRO_FAULT_PLAN`` spec such as
    ``"drop=5,dup=2,corrupt=2,reorder=1,seed=9,part=8:16"`` (integer
    percent; ``part`` a ``start:stop`` round window). Empty, or all
    zero, means no plan. Malformed values raise naming the variable."""
    spec = spec.strip()
    if not spec:
        return None
    kw: dict[str, Any] = {}
    for field in spec.split(","):
        field = field.strip()
        if not field:
            continue
        key, sep, val = field.partition("=")
        key, val = key.strip().lower(), val.strip()
        if not sep:
            raise ValueError(f"env override REPRO_FAULT_PLAN: expected key=value, got {field!r}")
        try:
            if key in ("drop", "dup", "corrupt"):
                pct = int(val)
                if not 0 <= pct <= 100:
                    raise ValueError(
                        f"env override REPRO_FAULT_PLAN: field {key!r} is a "
                        f"percentage and must be in [0, 100], got {pct}"
                    )
                dest = {"drop": "drop_prob", "dup": "duplicate_prob", "corrupt": "corrupt_prob"}[key]
                kw[dest] = pct / 100.0
            elif key == "reorder":
                kw["reorder_max"] = int(val)
            elif key == "seed":
                kw["seed"] = int(val)
            elif key == "part":
                a, _, b = val.partition(":")
                kw["partition_start"] = int(a)
                kw["partition_stop"] = int(b)
            else:
                raise ValueError(
                    f"env override REPRO_FAULT_PLAN: unknown field {key!r} "
                    f"(known: drop, dup, corrupt, reorder, seed, part)"
                )
        except ValueError as e:
            if "REPRO_FAULT_PLAN" in str(e):
                raise
            raise ValueError(
                f"env override REPRO_FAULT_PLAN: field {key!r} must be an integer, got {val!r}"
            ) from None
    plan = FaultPlan(**kw)
    return plan if plan.active else None


_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, without an int64 overflow: the product is taken in two
    16-bit halves of ``x``."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fault_hash(r, dst: torch.Tensor, src: torch.Tensor, seed: int, salt: int) -> torch.Tensor:
    """Counter-based per-edge hash (murmur-style finalizer) over
    ``(round, dst gid, src gid, plan seed, salt)``: the reference's
    uint32 arithmetic in int64, masked to 32 bits after every step, so
    the values are the reference's. Stateless and elementwise."""
    dev = dst.device
    r = torch.as_tensor(r, device=dev).to(torch.int64) & _U32
    x = (
        _mul32(r, 0x9E3779B1)
        + _mul32(dst.to(torch.int64) & _U32, 0x85EBCA77)
        + _mul32(src.to(torch.int64) & _U32, 0xC2B2AE3D)
        + ((seed * 0x27D4EB2F + salt * 0x165667B1) & _U32)
    ) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _fault_unit(r, dst: torch.Tensor, src: torch.Tensor, seed: int, salt: int) -> torch.Tensor:
    """Uniform [0, 1] float32 per edge: the hash rounded to the nearest
    float32 (as XLA converts uint32), times 2**-32; it can equal 1.0."""
    return _fault_hash(r, dst, src, seed, salt).to(torch.float32) * np.float32(1.0 / 4294967296.0)


def _below(unit: torch.Tensor, prob: float) -> torch.Tensor:
    """``unit < float32(prob)``: the comparison the reference makes."""
    return unit < torch.tensor(np.float32(prob), device=unit.device)


def _inject_faults(
    plan: FaultPlan,
    pod_of,
    r,
    dst_gids: torch.Tensor,
    src_gids: torch.Tensor,
    cert: torch.Tensor,
    due,
    dst_cert: torch.Tensor,
    depth: int,
):
    """Apply a :class:`FaultPlan` to one round's push candidates.

    ``cert`` is (W_local, m) float32 with +inf marking invalid entries,
    ``src_gids`` (W_local, m) global source ids, ``dst_gids`` (W_local,)
    global destination ids, ``dst_cert`` (W_local,) the destinations'
    post-scan certificates, ``due`` (W_local, m) absolute delivery
    rounds or ``None`` on the dense buffer.

    Order, as in the reference: drop (and the pod partition) -> corrupt
    -> soundness check (reject a non-finite cert, or one not below the
    destination's: monotone destination certificates make it forever
    unacceptable) -> due jitter -> duplicate mask.

    Returns ``(cert, due, dup_mask, n_dropped, n_rejected)``."""
    valid0 = torch.isfinite(cert)
    dst2 = dst_gids.unsqueeze(1)
    seed = int(plan.seed)
    drop = torch.zeros(cert.shape, dtype=torch.bool, device=cert.device)
    if plan.drop_prob > 0.0:
        drop = _below(_fault_unit(r, dst2, src_gids, seed, 1), plan.drop_prob)
    if pod_of is not None and 0 <= plan.partition_start < plan.partition_stop:
        in_window = plan.partition_start <= int(r) < plan.partition_stop
        cross = pod_of[dst_gids.long()].unsqueeze(1) != pod_of[src_gids.long()]
        drop = drop | (cross & in_window)
    drop = drop & valid0
    n_dropped = drop.sum(dtype=torch.int32)

    live = valid0 & ~drop
    if plan.corrupt_prob > 0.0:
        cor = live & _below(_fault_unit(r, dst2, src_gids, seed, 2), plan.corrupt_prob)
        sel = _fault_hash(r, dst2, src_gids, seed, 3) % 3
        bad = torch.where(
            sel == 0,
            torch.tensor(float("nan"), device=cert.device),
            torch.where(sel == 1, torch.tensor(float("-inf"), device=cert.device),
                        cert + np.float32(1e6)),
        )
        cert = torch.where(cor, bad, cert)
    unsound = live & (~torch.isfinite(cert) | (cert >= dst_cert.unsqueeze(1)))
    n_rejected = unsound.sum(dtype=torch.int32)

    keep = live & ~unsound
    cert = torch.where(keep, cert, _inf(cert))
    if due is not None:
        if plan.reorder_max > 0:
            jit = (_fault_hash(r, dst2, src_gids, seed, 4) % (plan.reorder_max + 1)).to(torch.int32)
            due = torch.minimum(due + jit, _i32(int(r) + depth, due))
        due = torch.where(keep, due, _i32(-1, due))
    dup = torch.zeros(cert.shape, dtype=torch.bool, device=cert.device)
    if plan.duplicate_prob > 0.0:
        dup = keep & _below(_fault_unit(r, dst2, src_gids, seed, 5), plan.duplicate_prob)
    return cert, due, dup, n_dropped, n_rejected


def _duplicate_columns(dup: torch.Tensor, cert, src, due, slot):
    """Append the duplicated candidates as extra columns: an identical
    (cert, src, due, slot) entry where ``dup``, padding elsewhere."""
    return (
        torch.cat([cert, torch.where(dup, cert, _inf(cert))], dim=1),
        torch.cat([src, src], dim=1),
        torch.cat([due, torch.where(dup, due, _i32(-1, due))], dim=1),
        torch.cat([slot, slot], dim=1),
    )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every field of the reference's ``EngineConfig``, with the same
    defaults and ``REPRO_*`` overrides (see ``docs/config.md``)."""

    n_workers: int = 4
    eps: float = 0.0  # protocol gap; gates ACCEPTANCE only
    max_rounds: int = 1000
    #: per-link latency in rounds: an int or a (W, W) ``delay[src, dst]``
    #: array, clipped to >= 1
    delay_rounds: Any = 1
    #: per-worker speed (cost units per simulated second); drives the
    #: compute credit, normalized to the fastest worker. None = uniform
    speed: Any = None
    #: round at which each worker fail-stops (None = never)
    fail_round: Any = None
    target_certificate: float | None = None
    seed: int = 0
    record_history: bool = True
    #: rounds per jitted dispatch in the reference. The port runs eagerly
    #: round by round, so this is validated and cannot change results —
    #: the reference pins every chunk size bit-identical to 1.
    rounds_per_dispatch: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_ROUNDS_PER_DISPATCH", 8)
    )
    #: sharded-engine gossip policy ("dense" | "gated"); inert on one device
    gossip_mode: str = dataclasses.field(
        default_factory=lambda: _env_str("REPRO_GOSSIP_MODE", "dense")
    )
    #: candidates per device for gated gossip and the sparse control plane
    gossip_top_k: int = 1
    #: pod-mesh cross-pod cadence; inert without a pod mesh
    cross_pod_every_k: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_CROSS_POD_EVERY_K", 1)
    )
    cross_pod_top_k: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_CROSS_POD_TOP_K", 1)
    )
    #: 0 = dense (W, W, D) in-flight buffer (the exact oracle); C >= 1 =
    #: bounded (W, C) pending queues, evicting worst-certificate-first
    #: (bit-identical to dense while nothing is evicted); "auto" sizes C
    #: from a warm-up probe (peak occupancy x AUTO_CAPACITY_HEADROOM)
    inflight_capacity: Any = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_INFLIGHT_CAPACITY", 0, special=("auto",))
    )
    #: sparse delivery and ingest: "pallas" = the port's hand-written
    #: CUDA kernels (their plain versions on CPU tensors), "ref" = the
    #: plain versions everywhere
    round_step_impl: str = dataclasses.field(
        default_factory=lambda: _env_str("REPRO_ROUND_STEP_IMPL", "pallas")
    )
    #: "dense": every improver is offered to every destination; "sparse":
    #: only the top-``gossip_top_k`` improvers (bit-identical under
    #: uniform delay)
    control_plane: str = dataclasses.field(
        default_factory=lambda: _env_str("REPRO_CONTROL_PLANE", "dense")
    )
    #: trailing worker rows allocated as masked-out spares that a
    #: MembershipPlan join can activate mid-run
    spare_slots: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_SPARE_SLOTS", 0)
    )
    #: optional MembershipPlan (joins into spares, leaves)
    membership: Any = None
    #: REPRO_FAULT_PLAN spec, parsed by _parse_fault_spec; ``fault_plan``
    #: (a FaultPlan) wins over it
    fault_spec: str = dataclasses.field(
        default_factory=lambda: _env_str("REPRO_FAULT_PLAN", "")
    )
    fault_plan: Any = None
    #: publish cadence in rounds with a publisher attached (0 = off)
    #: and the improvement a new publish needs
    publish_every_k: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_PUBLISH_EVERY_K", 0)
    )
    publish_eps: float = dataclasses.field(
        default_factory=lambda: _env_float("REPRO_PUBLISH_EPS", 0.0)
    )
    #: worker mesh (repro_torch.launch.mesh.make_worker_mesh): make_engine
    #: shards a multi-rank ("workers",) or ("pod", "workers") mesh; None =
    #: one device
    mesh: Any = None


class PendingQueue(NamedTuple):
    """Bounded per-destination pending messages (``inflight_capacity > 0``).
    ``cert`` is +inf on empty slots; ``due`` is the ABSOLUTE delivery
    round, so a delivered entry only needs its cert cleared; ``slot`` is
    the snapshot-ring slot captured at push time."""

    cert: torch.Tensor  # (W, C) f32; +inf = empty
    src: torch.Tensor  # (W, C) i32 source worker id
    due: torch.Tensor  # (W, C) i32 absolute delivery round (-1 = empty)
    slot: torch.Tensor  # (W, C) i32 ring slot of the payload


def _empty_queue(w: int, capacity: int, device) -> PendingQueue:
    return PendingQueue(
        cert=torch.full((w, capacity), float("inf"), dtype=torch.float32, device=device),
        src=torch.zeros((w, capacity), dtype=torch.int32, device=device),
        due=torch.full((w, capacity), -1, dtype=torch.int32, device=device),
        slot=torch.zeros((w, capacity), dtype=torch.int32, device=device),
    )


def _inf(like: torch.Tensor) -> torch.Tensor:
    # a host-to-device copy from pageable memory: it waits for the card
    trace.count("host_syncs", 1, "engine.constant")
    return torch.tensor(float("inf"), dtype=torch.float32, device=like.device)


def _i32(x: int, like: torch.Tensor) -> torch.Tensor:
    trace.count("host_syncs", 1, "engine.constant")
    return torch.tensor(x, dtype=torch.int32, device=like.device)


def _queue_push(
    queue: PendingQueue,
    score: torch.Tensor,
    alive: torch.Tensor,
    local_gids: torch.Tensor,
    delay_rows: torch.Tensor,
    r: int,
    depth: int,
    dst_cert: torch.Tensor | None = None,
    fault: FaultPlan | None = None,
    pod_of=None,
):
    """Push this round's broadcast candidates into every destination's
    pending queue, evicting worst-certificate-first.

    ``score`` is (W,) over source ids: the candidate's certificate where
    that source broadcasts, +inf elsewhere. Only the best ``C + 1``
    candidates can enter a kept top-C, so the merge lexsorts
    ``(W, C + min(C+1, W))``; eviction keeps the smallest C by
    (cert, src, due), ties dropping the later column.

    Returns ``(queue, n_pushed, n_evicted, occ_pre_max, n_dropped,
    n_rejected)`` with LOGICAL counters: ``n_evicted == 0`` over a run
    certifies it bit-identical to the dense oracle. With ``fault`` set,
    :func:`_inject_faults` runs on the candidate block after the
    pre-filter, duplicates become extra columns, and the occupancy and
    eviction accounting counts what reached the merge. The fault
    counters are 0 without a plan."""
    w = score.shape[0]
    wl, cap = queue.cert.shape
    k = min(cap + 1, w)
    order = torch.argsort(score, stable=True)[:k].to(torch.int32)
    c_cert = score[order.long()]
    val = (
        torch.isfinite(c_cert).unsqueeze(0)
        & (order.unsqueeze(0) != local_gids.unsqueeze(1))
        & alive.unsqueeze(1)
    )
    cand_cert = torch.where(val, c_cert.unsqueeze(0), _inf(score))
    cand_src = order.unsqueeze(0).expand(wl, k)
    cand_due = torch.where(val, r + torch.gather(delay_rows, 1, cand_src.long()), _i32(-1, score))
    cand_slot = torch.where(val, _i32(r % depth, score), _i32(0, score))
    n_dropped = n_rejected = 0
    if fault is not None:
        cand_cert, cand_due, dup, n_dropped, n_rejected = _inject_faults(
            fault, pod_of, r, local_gids, cand_src, cand_cert, cand_due, dst_cert, depth
        )
        if fault.duplicate_prob > 0.0:
            cand_cert, cand_src, cand_due, cand_slot = _duplicate_columns(
                dup, cand_cert, cand_src, cand_due, cand_slot
            )

    m_cert = torch.cat([queue.cert, cand_cert], dim=1)
    m_src = torch.cat([queue.src, cand_src], dim=1)
    m_due = torch.cat([queue.due, cand_due], dim=1)
    m_slot = torch.cat([queue.slot, cand_slot], dim=1)
    keep = kref.lexsort((m_due, m_src, m_cert), dim=-1)[:, :cap]
    new = PendingQueue(
        cert=torch.gather(m_cert, 1, keep),
        src=torch.gather(m_src, 1, keep),
        due=torch.gather(m_due, 1, keep),
        slot=torch.gather(m_slot, 1, keep),
    )
    n_bcast = torch.isfinite(score).sum(dtype=torch.int32)
    self_b = torch.isfinite(score[local_gids.long()]).to(torch.int32)
    n_cand = torch.where(alive, n_bcast - self_b, _i32(0, score))
    # under faults, count what reached the merge: a dropped message is
    # not an eviction
    n_off = n_cand if fault is None else torch.isfinite(cand_cert).sum(dim=1, dtype=torch.int32)
    occ_pre = torch.isfinite(queue.cert).sum(dim=1, dtype=torch.int32) + n_off
    occ_after = torch.isfinite(new.cert).sum(dim=1, dtype=torch.int32)
    return (
        new,
        n_cand.sum(dtype=torch.int32),
        (occ_pre - occ_after).sum(dtype=torch.int32),
        occ_pre.max(),
        n_dropped,
        n_rejected,
    )


def _candidate_valid(
    cand_cert: torch.Tensor,
    cand_ids: torch.Tensor,
    alive: torch.Tensor,
    local_gids: torch.Tensor,
    w: int,
) -> torch.Tensor:
    """(W_local, m) validity of each sparse-control candidate at each
    destination: finite cert, in-range id (padding carries id >= W), not
    the destination itself, destination alive."""
    return (
        torch.isfinite(cand_cert).unsqueeze(0)
        & (cand_ids.unsqueeze(0) != local_gids.unsqueeze(1))
        & (cand_ids.unsqueeze(0) < w)
        & alive.unsqueeze(1)
    )


def _queue_push_candidates(
    queue: PendingQueue,
    cand_cert: torch.Tensor,
    cand_ids: torch.Tensor,
    alive: torch.Tensor,
    local_gids: torch.Tensor,
    delay_rows: torch.Tensor,
    r: int,
    depth: int,
    impl: str,
    dst_cert: torch.Tensor | None = None,
    fault: FaultPlan | None = None,
    pod_of=None,
):
    """Sparse-control ingest: merge an explicit candidate list — (m,)
    certificates and source ids, padded with id >= W / +inf — into the
    pending queues through kernel K3 (``impl="pallas"``) or its plain
    version (``"ref"``), under the same order as :func:`_queue_push`.
    A ``fault`` plan applies as in :func:`_queue_push`; its duplicates
    double K3's candidate block.

    Returns ``(queue, n_pushed, n_evicted, occ_pre_max, n_dropped,
    n_rejected)``."""
    w = delay_rows.shape[1]
    wl, m = delay_rows.shape[0], cand_ids.shape[0]
    ids_c = torch.clamp(cand_ids, 0, w - 1).to(torch.int32)
    val = _candidate_valid(cand_cert, cand_ids, alive, local_gids, w)
    c_cert = torch.where(val, cand_cert.unsqueeze(0), _inf(cand_cert))
    c_src = ids_c.unsqueeze(0).expand(wl, m)
    c_due = torch.where(val, r + torch.gather(delay_rows, 1, c_src.long()), _i32(-1, cand_cert))
    c_slot = torch.where(val, _i32(r % depth, cand_cert), _i32(0, cand_cert))
    n_dropped = n_rejected = 0
    if fault is not None:
        c_cert, c_due, dup, n_dropped, n_rejected = _inject_faults(
            fault, pod_of, r, local_gids, c_src, c_cert, c_due, dst_cert, depth
        )
        if fault.duplicate_prob > 0.0:
            c_cert, c_src, c_due, c_slot = _duplicate_columns(dup, c_cert, c_src, c_due, c_slot)
    ingest = kref.queue_ingest_ref if impl == "ref" else kops.queue_ingest
    q_cert, q_due, q_src, q_slot = ingest(
        queue.cert, queue.due, queue.src, queue.slot,
        c_cert.contiguous(), c_due.contiguous(), c_src.contiguous(), c_slot.contiguous(),
    )
    new = PendingQueue(cert=q_cert, src=q_src, due=q_due, slot=q_slot)
    n_cand = val.sum(dim=1, dtype=torch.int32)
    n_off = n_cand if fault is None else torch.isfinite(c_cert).sum(dim=1, dtype=torch.int32)
    occ_pre = torch.isfinite(queue.cert).sum(dim=1, dtype=torch.int32) + n_off
    occ_after = torch.isfinite(new.cert).sum(dim=1, dtype=torch.int32)
    return (
        new,
        n_cand.sum(dtype=torch.int32),
        (occ_pre - occ_after).sum(dtype=torch.int32),
        occ_pre.max(),
        n_dropped,
        n_rejected,
    )


def _dense_push_candidates(
    inflight: torch.Tensor,
    cand_cert: torch.Tensor,
    cand_ids: torch.Tensor,
    alive: torch.Tensor,
    local_gids: torch.Tensor,
    delay_rows: torch.Tensor,
    r: int = 0,
    dst_cert: torch.Tensor | None = None,
    fault: FaultPlan | None = None,
    pod_of=None,
):
    """Sparse-control push into the dense ``(W_local, W, D)`` buffer:
    write each valid candidate's certificate at ``[dst, src, delay-1]``.
    With a ``fault`` plan, dropped and rejected candidates are not
    written (a duplicate would write the same cell twice: a no-op).
    Returns ``(inflight, n_pushed, n_dropped, n_rejected)``."""
    w = delay_rows.shape[1]
    wl, m = delay_rows.shape[0], cand_ids.shape[0]
    ids_c = torch.clamp(cand_ids, 0, w - 1).long()
    val = _candidate_valid(cand_cert, cand_ids, alive, local_gids, w)
    src2 = ids_c.unsqueeze(0).expand(wl, m)
    cert2 = cand_cert.unsqueeze(0).expand(wl, m)
    n_dropped = n_rejected = 0
    if fault is not None:
        cert2, _, _, n_dropped, n_rejected = _inject_faults(
            fault, pod_of, r, local_gids, src2.to(torch.int32), torch.where(val, cert2, _inf(cert2)),
            None, dst_cert, 0,
        )
        val = val & torch.isfinite(cert2)
    d = torch.gather(delay_rows, 1, src2)
    rows = torch.arange(wl, device=inflight.device).unsqueeze(1).expand(wl, m)
    out = inflight.clone()
    out[rows[val], src2[val], (d[val] - 1).long()] = cert2[val]
    return out, val.sum(dtype=torch.int32), n_dropped, n_rejected


class EngineState(NamedTuple):
    worker: Any
    certs: torch.Tensor  # (W,) f32 post-round certificates
    alive: torch.Tensor  # (W,) bool
    credit: torch.Tensor  # (W,) f32 compute credit (laggard model)
    clock: torch.Tensor  # (W,) f32 per-worker simulated seconds
    #: dense: (W, W, D) f32 [dst, src, d] certs, +inf = empty;
    #: inflight_capacity > 0: a PendingQueue
    inflight: Any
    ring: Any  # model snapshots, leading (D, W)
    round: int
    sent: torch.Tensor  # () i32
    accepted: torch.Tensor  # () i32
    discarded: torch.Tensor  # () i32
    cost_total: torch.Tensor  # () f32
    #: (W,) bool: workers whose improvement waits for the next cross-pod
    #: flush (all False off the pod mesh)
    xpend: torch.Tensor
    sent_dcn: torch.Tensor  # () i32 pushes that crossed a pod boundary
    evicted: torch.Tensor  # () i32 capacity evictions (0 on the dense path)
    occ_peak: torch.Tensor  # () i32 peak pre-eviction queue occupancy
    dropped_inj: torch.Tensor  # () i32 messages dropped by FaultPlan injection
    corrupt_rej: torch.Tensor  # () i32 candidates rejected by the soundness check


#: EngineState's traffic counters, reduced over ranks at the end of a run
_COUNTERS = ("sent", "accepted", "discarded", "cost_total", "sent_dcn", "evicted", "occ_peak", "dropped_inj",
             "corrupt_rej")


class RoundInfo(NamedTuple):
    """Per-round summary fetched to the host for history and the stop."""

    certs: torch.Tensor  # (W,)
    changed: torch.Tensor  # (W,) bool — cert changed this round (fire or adopt)
    clock: torch.Tensor  # (W,)
    alive: torch.Tensor  # (W,)


class _Rows(NamedTuple):
    """Per-worker constants of the rows an engine advances: all W on one
    device, one rank's W_local on the sharded engine."""

    ids: torch.Tensor  # (R,) i32 global worker ids
    speed: torch.Tensor  # (R,)
    speed_norm: torch.Tensor  # (R,)
    fail_round: torch.Tensor  # (R,)
    join_round: torch.Tensor  # (R,) spare-activation round
    delay_t: torch.Tensor  # (R, W) [dst, src]


class _Advanced(NamedTuple):
    """A round's rows after delivery, adoption and the scan."""

    wstate: Any
    certs: torch.Tensor
    alive: torch.Tensor
    credit: torch.Tensor
    clock: torch.Tensor
    inflight: Any
    take: torch.Tensor
    improved: torch.Tensor
    n_taken: torch.Tensor
    n_arrivals: torch.Tensor
    cost: torch.Tensor


def _snap_ring(ring, models, slot: int, bcast: torch.Tensor, lo: int = 0):
    """Write the broadcasters' ``(m, ...)`` models into ring slot ``slot``
    at workers ``[lo, lo + m)`` (every worker by default); the other
    workers keep their (dead) old entry."""

    def snap(buf: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        out = buf.clone()
        hi = lo + m.shape[0]
        out[slot, lo:hi] = torch.where(bcast.reshape((-1,) + (1,) * (m.dim() - 1)), m, buf[slot, lo:hi])
        # the clone reads and writes the ring; the where reads the models
        # and the slot's rows and writes a temporary, which the assignment
        # reads and writes into the slot
        trace.count("engine.copy_bytes", (2 * buf.numel() + 5 * m.numel()) * buf.element_size(), "ring")
        return out

    return tree_map(snap, ring, models)


class TMSNEngine:
    """Round-based TMSN run over a batched worker, on one device.

    ``device`` is where the engine's own tensors live; it must be the
    worker's device. ``"cuda"`` by default; raises without a card unless
    ``"cpu"`` is given."""

    def __init__(
        self,
        worker: BatchedTMSNWorker,
        config: EngineConfig,
        device: str | torch.device = "cuda",
    ) -> None:
        self.worker = worker
        self.config = config
        self.device = resolve_device(device)
        w = config.n_workers

        if config.gossip_mode not in ("dense", "gated"):
            raise ValueError(f"gossip_mode must be 'dense' or 'gated', got {config.gossip_mode!r}")
        if config.gossip_top_k < 1:
            raise ValueError(f"gossip_top_k must be >= 1, got {config.gossip_top_k}")
        if config.rounds_per_dispatch < 1:
            raise ValueError(f"rounds_per_dispatch must be >= 1, got {config.rounds_per_dispatch}")
        if config.cross_pod_every_k < 1:
            raise ValueError(f"cross_pod_every_k must be >= 1, got {config.cross_pod_every_k}")
        if config.cross_pod_top_k < 1:
            raise ValueError(f"cross_pod_top_k must be >= 1, got {config.cross_pod_top_k}")
        if isinstance(config.inflight_capacity, str):
            if config.inflight_capacity != "auto":
                raise ValueError(
                    f"inflight_capacity must be an int >= 0 or 'auto', "
                    f"got {config.inflight_capacity!r}"
                )
        elif config.inflight_capacity < 0:
            raise ValueError(f"inflight_capacity must be >= 0, got {config.inflight_capacity}")
        if config.round_step_impl not in ("pallas", "ref"):
            raise ValueError(
                f"round_step_impl must be 'pallas' or 'ref', got {config.round_step_impl!r}"
            )
        if config.control_plane not in ("dense", "sparse"):
            raise ValueError(
                f"control_plane must be 'dense' or 'sparse', got {config.control_plane!r}"
            )
        if config.publish_every_k < 0:
            raise ValueError(f"publish_every_k must be >= 0, got {config.publish_every_k}")
        if not config.publish_eps >= 0.0:  # also rejects NaN
            raise ValueError(f"publish_eps must be >= 0, got {config.publish_eps}")
        #: serving publisher (see attach_publisher); None keeps run() free
        #: of the per-boundary certificate fetch
        self._publisher: Any = None
        self._published_cert = float("inf")
        self._next_publish_round = 0

        self._control_sparse = config.control_plane == "sparse"
        #: 0 = dense (W, W, D) buffer; C >= 1 = pending queues; None =
        #: "auto", resolved by a warm-up probe in run()
        self._capacity: int | None = (
            None if config.inflight_capacity == "auto" else int(config.inflight_capacity)
        )
        #: capacity the auto probe selected (0 when capacity is explicit)
        self._auto_selected = 0

        dev = self.device
        delay = np.asarray(config.delay_rounds)
        if delay.ndim == 0:
            delay = np.full((w, w), int(delay))
        if delay.shape != (w, w):
            raise ValueError(f"delay_rounds must be scalar or ({w},{w}), got {delay.shape}")
        delay = np.maximum(delay, 1)
        self._delay = torch.as_tensor(delay.astype(np.int32), device=dev)  # [src, dst]
        self._delay_t = self._delay.T.contiguous()  # [dst, src] rows
        self._depth = int(delay.max())

        speed = np.ones(w) if config.speed is None else np.asarray(config.speed, np.float64)
        if speed.shape != (w,):
            raise ValueError(f"speed must be ({w},), got {speed.shape}")
        self._speed = torch.as_tensor(speed.astype(np.float32), device=dev)
        self._speed_norm = torch.as_tensor((speed / speed.max()).astype(np.float32), device=dev)

        fail = (
            np.full(w, np.iinfo(np.int32).max)
            if config.fail_round is None
            else np.asarray(config.fail_round).copy()
        )
        if fail.shape != (w,):
            raise ValueError(f"fail_round must be ({w},), got {fail.shape}")

        # --- elastic membership: spares, joins, leaves
        spares = int(config.spare_slots)
        if not 0 <= spares < w:
            raise ValueError(f"spare_slots must be in [0, n_workers), got {spares} (n_workers={w})")
        never = np.iinfo(np.int32).max
        join_round = np.zeros(w, np.int64)
        if spares:
            join_round[w - spares :] = never  # a spare without a join stays masked
        plan = config.membership
        if plan is not None:
            if not isinstance(plan, MembershipPlan):
                raise ValueError(f"membership must be a MembershipPlan, got {type(plan).__name__}")
            seen_slots: set[int] = set()
            for k, slot in plan.joins:
                k, slot = int(k), int(slot)
                if k < 1:
                    raise ValueError(f"membership join rounds are 1-based, got {k}")
                if not w - spares <= slot < w:
                    raise ValueError(
                        f"membership join slot {slot} is not a spare "
                        f"(spare region is [{w - spares}, {w}), spare_slots={spares})"
                    )
                if slot in seen_slots:
                    raise ValueError(f"membership joins slot {slot} twice")
                seen_slots.add(slot)
                join_round[slot] = k - 1  # 1-based: k=1 is alive from round 0
            for k, leaver in plan.leaves:
                k, leaver = int(k), int(leaver)
                if k < 1:
                    raise ValueError(f"membership leave rounds must be >= 1, got {k}")
                if not 0 <= leaver < w:
                    raise ValueError(f"membership leave worker {leaver} out of range [0, {w})")
                fail[leaver] = min(int(fail[leaver]), k)
        self._join_round_np = join_round
        self._join_round = torch.as_tensor(join_round.astype(np.int32), device=dev)
        #: joins and spares change the round's alive/credit ops; without
        #: them the round keeps the clean path's ops
        self._has_joins = spares > 0 or (plan is not None and bool(plan.joins))
        self._fail_round = torch.as_tensor(fail.astype(np.int32), device=dev)

        # --- fault injection
        fplan = config.fault_plan
        if fplan is None:
            fplan = _parse_fault_spec(config.fault_spec)
        elif not isinstance(fplan, FaultPlan):
            raise ValueError(f"fault_plan must be a FaultPlan, got {type(fplan).__name__}")
        if fplan is not None:
            for fname in ("drop_prob", "duplicate_prob", "corrupt_prob"):
                p = getattr(fplan, fname)
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"FaultPlan.{fname} must be in [0, 1], got {p}")
            if fplan.reorder_max < 0:
                raise ValueError(f"FaultPlan.reorder_max must be >= 0, got {fplan.reorder_max}")
            if fplan.reorder_max > 0 and self._capacity == 0:
                raise ValueError(
                    "FaultPlan.reorder_max > 0 needs the pending-queue in-flight "
                    "state (inflight_capacity >= 1 or 'auto'): the dense (W, W, D) "
                    "buffer derives ring slots from the static delay matrix, so a "
                    "jittered delivery would fetch a wrong-generation payload"
                )
            if not fplan.active:
                fplan = None  # an all-zero plan is the clean run
        self._fault: FaultPlan | None = fplan
        #: (W,) pod of each global worker id, set by the sharded engine on a
        #: pod mesh; None otherwise, which makes the partition window inert
        self._pod_of = None

        self._has_resample = has_resample_hooks(worker)
        self._payload_bytes = resolve_payload_bytes(worker, w, config.seed)
        self._all_ids = torch.arange(w, dtype=torch.int32, device=dev)
        #: the rows this engine advances: every worker
        self._rows = _Rows(
            ids=self._all_ids, speed=self._speed, speed_norm=self._speed_norm, fail_round=self._fail_round,
            join_round=self._join_round, delay_t=self._delay_t,
        )

    def attach_publisher(self, slot: Any) -> None:
        """Register a snapshot publisher: anything with a
        ``publish(params, cert, round)`` method, canonically a
        :class:`repro_torch.launch.serving.AdoptionSlot`. At the first
        chunk boundary (a multiple of ``rounds_per_dispatch``, the last
        round, or a target stop) at or after every ``publish_every_k``-th
        round, :meth:`run` publishes a host copy of the best live
        worker's model (CPU tensors, its dtypes and bits kept) when its certificate improved by more than
        ``publish_eps`` since the last publish, and once more at the end."""
        if self.config.publish_every_k < 1:
            raise ValueError(
                "attach_publisher requires publish_every_k >= 1 "
                f"(got {self.config.publish_every_k}); set it in EngineConfig "
                "or via REPRO_PUBLISH_EVERY_K"
            )
        self._publisher = slot

    def _maybe_publish(self, state: EngineState, rounds: int, final: bool = False) -> None:
        """Publish the best-certificate model if due and improved."""
        if self._publisher is None:
            return
        if not final and rounds < self._next_publish_round:
            return
        k = int(self.config.publish_every_k)
        while self._next_publish_round <= rounds:
            self._next_publish_round += k
        certs, alive = self._global_certs_alive(state)
        trace.count("host_syncs", 2, "engine.publish")
        live = np.where(alive, certs, np.inf)
        best = int(np.argmin(live))
        best_cert = float(live[best])
        if not np.isfinite(best_cert):
            return
        if best_cert >= self._published_cert - float(self.config.publish_eps):
            return
        # a host copy as CPU tensors: every dtype (bfloat16 included) and every bit
        params = tree_map(lambda a: a.detach().to("cpu", copy=True), self._export_row(state, best))
        trace.count("host_syncs", len(tree_leaves(params)), "engine.publish")
        self._publisher.publish(params, cert=best_cert, round=rounds)
        self._published_cert = best_cert

    # ----- the hooks a sharded engine overrides: where rows live --------
    def _local_rows(self, tree: Any) -> Any:
        """This engine's rows of a ``(W, ...)`` pytree: all of them."""
        return tree

    def _global_certs_alive(self, state: EngineState) -> tuple[np.ndarray, np.ndarray]:
        """Every worker's certificate and alive flag, on the host."""
        return state.certs.cpu().numpy(), state.alive.cpu().numpy()

    def _export_row(self, state: EngineState, gid: int) -> Any:
        """Worker ``gid``'s exported model (one row of each leaf)."""
        return tree_map(lambda a: a[gid], self.worker.export_models(state.worker))

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` of any rank; one device is the only rank."""
        return flag

    def _merge_history(self, parts: list) -> list:
        """History tuples from ``(round, clock, gid, cert)`` array blocks,
        in (round, worker) order."""
        return [h for _, clock, gid, cert in parts
                for h in zip(clock.tolist(), gid.tolist(), cert.tolist())]

    def _final(self, state: EngineState) -> dict:
        """What run() reports, for every worker, on the host (models stay
        tensors): counters as scalars here, per-rank partials on a
        sharded engine; ``TrafficCounters.from_shards`` reduces both."""
        return dict(
            certs=state.certs.cpu().numpy(),
            clock=state.clock.cpu().numpy(),
            models=self.worker.export_models(state.worker),
            **{k: getattr(state, k).cpu().numpy() for k in _COUNTERS},
        )

    def _gossip_split(self) -> tuple[int, int]:
        """(ICI, DCN) cross-device bytes per round, the DCN leg amortized
        over ``cross_pod_every_k``; (0, 0) on one device."""
        return 0, 0

    def _control_split(self) -> tuple[int, int]:
        """(ICI, DCN) control-plane share of :meth:`_gossip_split` per
        round (certificates, flags, ids); (0, 0) on one device."""
        return 0, 0

    def _gossip_mode(self) -> str:
        """Mode label for SimResult: one device has no cross-device
        gossip, so the knob is reported as inert."""
        return "dense"

    def _resolve_auto_capacity(self) -> None:
        """Resolve ``inflight_capacity="auto"``: run a short warm-up
        probe at an explicit capacity, doubling it until nothing is
        evicted, then size the run's queues at the probe's peak
        occupancy times :data:`AUTO_CAPACITY_HEADROOM`. The probe is the
        same engine on the same device with every other knob kept."""
        cfg = self.config
        w = cfg.n_workers
        warmup = min(max(2 * self._depth + 2, 8), cfg.max_rounds)
        hard_max = w * self._depth  # every (src, pending-round) pair
        probe_cap = min(max(64, 2 * self._depth), hard_max)
        while True:
            probe_cfg = dataclasses.replace(
                cfg, inflight_capacity=int(probe_cap), max_rounds=warmup,
                target_certificate=None, record_history=False,
            )
            res = make_engine(self.worker, probe_cfg, self.device).run()
            if res.messages_evicted == 0 or probe_cap >= hard_max:
                break
            probe_cap = min(2 * probe_cap, hard_max)
        peak = max(int(res.inflight_occupancy_peak), 0)
        self._capacity = max(1, math.ceil(peak * AUTO_CAPACITY_HEADROOM))
        self._auto_selected = self._capacity

    # ------------------------------------------------------------------
    def _init_state(self) -> EngineState:
        cfg = self.config
        w, d, dev = cfg.n_workers, self._depth, self.device
        full = self.worker.init_batch(w, cfg.seed)
        models = self.worker.export_models(full)
        # the ring holds every worker's snapshots, on every rank
        ring = tree_map(lambda a: a.unsqueeze(0).expand((d,) + a.shape).clone(), models)
        # the worker's global init, cut to this engine's rows: per-row
        # identities (stream ids, feature masks) stay global
        wstate = self._local_rows(full)
        nr = self._rows.ids.shape[0]
        if self._capacity:
            inflight = _empty_queue(nr, self._capacity, dev)
        else:
            inflight = torch.full((nr, w, d), float("inf"), dtype=torch.float32, device=dev)
        zi = torch.zeros((), dtype=torch.int32, device=dev)
        if self._has_joins:
            alive0 = torch.as_tensor(self._local_rows(self._join_round_np) <= 0, device=dev)
        else:
            alive0 = torch.ones((nr,), dtype=torch.bool, device=dev)
        return EngineState(
            worker=wstate,
            certs=self.worker.certificates(wstate).to(torch.float32),
            alive=alive0,
            credit=torch.zeros((nr,), dtype=torch.float32, device=dev),
            clock=torch.zeros((nr,), dtype=torch.float32, device=dev),
            inflight=inflight,
            ring=ring,
            round=0,
            sent=zi,
            accepted=zi,
            discarded=zi,
            cost_total=torch.zeros((), dtype=torch.float32, device=dev),
            xpend=torch.zeros((nr,), dtype=torch.bool, device=dev),
            sent_dcn=zi,
            evicted=zi,
            occ_peak=zi,
            dropped_inj=zi,
            corrupt_rej=zi,
        )

    def _deliver_sparse(self, queue: PendingQueue, certs0, alive, credit, speed_norm, r: int):
        """Fused sparse delivery through kernel K2 (or its plain version
        under ``round_step_impl="ref"``): argmin over this round's due
        entries, eps-gated accept, arrival clearing, laggard credit.

        Returns ``(queue', best_cert, best_src, best_slot, take,
        n_arrivals, credit', active)``."""
        deliver = kref.round_step_ref if self.config.round_step_impl == "ref" else kops.round_deliver
        q_cert, best_cert, best_src, best_slot, take, n_arr, credit2, active = deliver(
            queue.cert, queue.due, queue.src, queue.slot, certs0, alive, credit,
            speed_norm, r, eps=float(self.config.eps),
        )
        return (
            queue._replace(cert=q_cert),
            best_cert,
            best_src,
            best_slot,
            take,
            n_arr.sum(dtype=torch.int32),
            credit2,
            active,
        )

    @staticmethod
    def _top_k_candidates(mask, certs, k: int):
        """Rows of the best k candidates under ``mask`` and a validity
        flag per row; stable, so ties pick the lowest worker row."""
        score = torch.where(mask, certs, _inf(certs))
        rows = torch.argsort(score, stable=True)[:k]
        return rows, torch.isfinite(score[rows])

    def _round_step(self, state: EngineState) -> tuple[EngineState, RoundInfo]:
        adv = self._advance(state)
        inflight, ring, pushed = self._gossip(state, adv)
        return self._next_state(state, adv, inflight, ring, pushed)

    def _advance(self, state: EngineState) -> _Advanced:
        """Steps 1-3 of a round on this engine's rows: deliver, adopt,
        credit, resample, scan. Shared by the sharded engine, whose rows
        are one rank's."""
        cfg, rows = self.config, self._rows
        w, depth, dev = cfg.n_workers, self._depth, self.device
        r = state.round
        with trace.span("engine.deliver"):
            if self._has_joins:
                # joins are sticky and compose with fail-stop; a joiner's
                # credit restarts at 0 on its join round (it accrued while
                # masked); its worker rows were never touched while masked
                alive = (state.alive | (r >= rows.join_round)) & (r < rows.fail_round)
                credit_in = torch.where(r == rows.join_round, 0.0, state.credit)
            else:
                alive = state.alive & (r < rows.fail_round)
                credit_in = state.credit
            certs0 = state.certs

            # --- 1.+2.(+3. credit) deliver arrivals due this round --------
            if self._capacity:
                (inflight, best_cert, best_src, sent_slot, take, n_arrivals, credit,
                 active) = self._deliver_sparse(state.inflight, certs0, alive, credit_in, rows.speed_norm, r)
            else:
                nr = rows.ids.shape[0]
                row_idx = torch.arange(nr, device=dev)
                arr = state.inflight[:, :, 0]  # (dst, src) certs
                arr_live = torch.where(alive.unsqueeze(1), arr, _inf(arr))
                best_src = torch.argmin(arr_live, dim=1)  # first minimum: lowest src on ties
                best_cert = arr_live[row_idx, best_src]
                take = accepts(certs0, best_cert, cfg.eps) & torch.isfinite(best_cert)
                n_arrivals = torch.isfinite(arr).sum(dtype=torch.int32)
                sent_slot = (r - rows.delay_t[row_idx, best_src]) % depth
                inflight = torch.cat(
                    [state.inflight[:, :, 1:], torch.full((nr, w, 1), float("inf"), device=dev)], dim=2
                )
                credit = credit_in + rows.speed_norm
                active = alive & (credit >= 1.0 - 1e-6)
                credit = torch.where(active, credit - 1.0, credit)
            n_taken = take.sum(dtype=torch.int32)

        wstate = state.worker
        zeros_w = torch.zeros(certs0.shape, dtype=torch.float32, device=dev)
        # rows with no taker skip the payload gather and the adoption
        # math (on a sharded engine this is rank-local and issues no
        # collective); the gathered payloads are dropped once adopted
        trace.count("host_syncs", 1, "engine.take_any")
        if bool(take.any()):
            slot_l, src_l = sent_slot.long(), best_src.long()

            def gather(a: torch.Tensor) -> torch.Tensor:
                out = a[slot_l, src_l]
                trace.count("engine.copy_bytes", 2 * out.numel() * out.element_size(), "gather")
                return out

            with trace.span("engine.gather"):
                in_models = tree_map(gather, state.ring)
            with trace.span("engine.adopt"):
                wstate, adopt_cost = self.worker.adopt_batch(wstate, in_models, best_cert, take)
            del in_models
        else:
            adopt_cost = zeros_w

        # --- 3. one segment per live, credit-covered worker ---------------
        resample_cost = zeros_w
        scan_mask = active
        if self._has_resample:
            need = self.worker.needs_resample(wstate) & active
            if bool(need.any()):
                wstate, resample_cost = self.worker.resample_round(wstate, need)
            scan_mask = active & ~need
        certs_pre = self.worker.certificates(wstate)
        with trace.span("engine.scan"):
            wstate, scan_cost, fired = self.worker.scan_round(wstate, scan_mask)
        certs = self.worker.certificates(wstate)

        cost = adopt_cost + resample_cost + scan_cost
        return _Advanced(
            wstate=wstate, certs=certs, alive=alive, credit=credit,
            clock=state.clock + cost / torch.clamp(rows.speed, min=1e-12), inflight=inflight, take=take,
            improved=fired & improves(certs_pre, certs, 0.0) & scan_mask, n_taken=n_taken,
            n_arrivals=n_arrivals, cost=cost,
        )

    def _gossip(self, state: EngineState, adv: _Advanced):
        """Steps 4-5 on one device: offer the strict improvements and
        snapshot the broadcasters' models into the ring. Returns
        ``(inflight, ring, counters)``, counters as :meth:`_push_broadcast`'s."""
        cfg, w, r = self.config, self.config.n_workers, state.round
        certs = adv.certs
        with trace.span("engine.gossip"):
            if self._control_sparse:
                # only the top-k improvers are offered; under uniform delay
                # the runner-ups could never have been accepted
                kc = min(int(cfg.gossip_top_k), w)
                rows, validk = self._top_k_candidates(adv.improved, certs, kc)
                cand_ids = torch.where(validk, rows.to(torch.int32), _i32(w, certs))
                cand_certs = torch.where(validk, certs[rows], _inf(certs))
                inflight, *pushed = self._push_candidates(adv.inflight, cand_certs, cand_ids, adv, r)
            else:
                inflight, *pushed = self._push_broadcast(adv.inflight, certs, adv.improved, adv, r)
        models = self.worker.export_models(adv.wstate)
        with trace.span("engine.ring"):
            ring = _snap_ring(state.ring, models, r % self._depth, adv.improved)
        return inflight, ring, pushed

    def _push_candidates(self, inflight, cand_certs, cand_ids, adv: _Advanced, r: int):
        """Sparse control: push an explicit ``(m,)`` candidate list (ids
        >= W pad it) into this engine's rows, through K3 on the queues.
        Returns ``(inflight, n_pushed, n_evicted, occ_pre_max, n_dropped,
        n_rejected)``."""
        rows = self._rows
        faults = dict(dst_cert=adv.certs, fault=self._fault, pod_of=self._pod_of)
        if self._capacity:
            return _queue_push_candidates(
                inflight, cand_certs, cand_ids, adv.alive, rows.ids, rows.delay_t, r, self._depth,
                self.config.round_step_impl, **faults,
            )
        inflight, n_pushed, n_dropped, n_rejected = _dense_push_candidates(
            inflight, cand_certs, cand_ids, adv.alive, rows.ids, rows.delay_t, r, **faults
        )
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return inflight, n_pushed, zero, zero, n_dropped, n_rejected

    def _push_broadcast(self, inflight, certs_all, bcast_all, adv: _Advanced, r: int):
        """Dense control: offer every broadcaster of the ``(W,)``
        ``certs_all``/``bcast_all`` to every live row but itself. Returns
        what :meth:`_push_candidates` returns."""
        rows, w, depth, dev = self._rows, self.config.n_workers, self._depth, self.device
        nr = rows.ids.shape[0]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        if self._capacity:
            return _queue_push(
                inflight, torch.where(bcast_all, certs_all, _inf(certs_all)), adv.alive, rows.ids,
                rows.delay_t, r, depth, dst_cert=adv.certs, fault=self._fault, pod_of=self._pod_of,
            )
        not_self = rows.ids.view(nr, 1) != self._all_ids.view(1, w)
        d_idx = torch.arange(depth, device=dev).view(1, 1, depth)
        due_d = d_idx == (rows.delay_t.unsqueeze(2) - 1)  # push_mask[dst, src, d]
        if self._fault is None:
            push_mask = bcast_all.view(1, w, 1) & adv.alive.view(nr, 1, 1) & not_self.unsqueeze(2) & due_d
            inflight = torch.where(push_mask, certs_all.view(1, w, 1), inflight)
            return inflight, push_mask.sum(dtype=torch.int32), zero, zero, 0, 0
        # faulted dense push: the push mask as a per-edge (dst, src)
        # certificate matrix, so single edges can be dropped, corrupted or
        # rejected; n_pushed counts the logical sends
        push2 = bcast_all.view(1, w) & adv.alive.view(nr, 1) & not_self
        cert_mat = torch.where(push2, certs_all.view(1, w), _inf(certs_all))
        src_mat = self._all_ids.view(1, w).expand(nr, w)
        cert_mat, _, _, n_dropped, n_rejected = _inject_faults(
            self._fault, self._pod_of, r, rows.ids, src_mat, cert_mat, None, adv.certs, depth
        )
        push_mask = torch.isfinite(cert_mat).unsqueeze(2) & due_d
        inflight = torch.where(push_mask, cert_mat.unsqueeze(2), inflight)
        return inflight, push2.sum(dtype=torch.int32), zero, zero, n_dropped, n_rejected

    @staticmethod
    def _merge_pushed(a: tuple, b: tuple) -> tuple:
        """Two pushes of one round as one ``pushed`` tuple of
        :meth:`_next_state`, ``(n_pushed, n_evicted, occ_pre_max,
        n_dropped, n_rejected)``: counts add, the occupancy peak is the
        larger."""
        return (a[0] + b[0], a[1] + b[1], torch.maximum(a[2], b[2]), a[3] + b[3], a[4] + b[4])

    def _next_state(self, state: EngineState, adv: _Advanced, inflight, ring, pushed):
        n_pushed, n_evicted, occ_pre_max, n_dropped, n_rejected = pushed
        new_state = EngineState(
            worker=adv.wstate,
            certs=adv.certs,
            alive=adv.alive,
            credit=adv.credit,
            clock=adv.clock,
            inflight=inflight,
            ring=ring,
            round=state.round + 1,
            sent=state.sent + n_pushed,
            accepted=state.accepted + adv.n_taken,
            discarded=state.discarded + (adv.n_arrivals - adv.n_taken),
            cost_total=state.cost_total + adv.cost.sum(),
            xpend=state.xpend,
            sent_dcn=state.sent_dcn,
            evicted=state.evicted + n_evicted,
            occ_peak=torch.maximum(state.occ_peak, occ_pre_max),
            dropped_inj=state.dropped_inj if self._fault is None else state.dropped_inj + n_dropped,
            corrupt_rej=state.corrupt_rej if self._fault is None else state.corrupt_rej + n_rejected,
        )
        info = RoundInfo(certs=adv.certs, changed=adv.take | adv.improved, clock=adv.clock, alive=adv.alive)
        return new_state, info

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.config
        if self._capacity is None:
            self._resolve_auto_capacity()
        # each run publishes from scratch: the first due boundary with a
        # finite best certificate publishes
        self._published_cert = float("inf")
        self._next_publish_round = max(int(cfg.publish_every_k), 1)
        with trace.span("engine.init"):
            state = self._init_state()
        gids = self._rows.ids.cpu().numpy()
        # history blocks (round, clock, gid, cert); round 0 is the start
        parts = [(0, np.zeros(len(gids), np.float32), gids, state.certs.cpu().numpy())]
        target = None if cfg.target_certificate is None else np.float32(cfg.target_certificate)
        # the reference's chunk boundaries, where it may publish
        rpd, max_rounds = int(cfg.rounds_per_dispatch), int(cfg.max_rounds)
        rounds = 0
        for _ in range(max_rounds):
            with trace.span("engine.round", round=rounds):
                state, info = self._round_step(state)
                rounds += 1
                stop = False
                if cfg.record_history or target is not None:
                    with trace.span("engine.history"):
                        certs_r = info.certs.cpu().numpy()
                        trace.count("host_syncs", 1, "engine.history")
                        if cfg.record_history:
                            ww = np.nonzero(info.changed.cpu().numpy())[0]
                            parts.append((rounds, info.clock.cpu().numpy()[ww], gids[ww], certs_r[ww]))
                            trace.count("host_syncs", 2, "engine.history")
                        if target is not None:
                            # f32 target, as in the reference's in-scan freeze comparison
                            alive_r = info.alive.cpu().numpy()
                            trace.count("host_syncs", 1, "engine.history")
                            stop = self._any_rank(bool(np.any((certs_r <= target) & alive_r)))
                if stop or rounds % rpd == 0 or rounds == max_rounds:
                    self._maybe_publish(state, rounds)
            if stop:
                break
        # final flush: an improvement after the last due boundary still
        # reaches the publisher before run() returns
        self._maybe_publish(state, rounds, final=True)

        history = self._merge_history(parts)
        fin = self._final(state)
        ictrl, dctrl = self._control_split()
        traffic = TrafficCounters.from_shards(
            sent=fin["sent"],
            accepted=fin["accepted"],
            discarded=fin["discarded"],
            payload_bytes=self._payload_bytes,
            sent_dcn=fin["sent_dcn"],
            evicted=fin["evicted"],
            control_bytes=(ictrl + dctrl) * rounds,
            dropped_injected=fin["dropped_inj"],
            corrupt_rejected=fin["corrupt_rej"],
        )
        # a join happened when its spare went live after round 0 and
        # before the run ended (a join at round 1 is a member from the start)
        jr = self._join_round_np
        workers_joined = int(np.sum((jr > 0) & (jr < rounds)))
        models = fin["models"]
        final_models = [tree_map(lambda a, i=i: a[i], models) for i in range(cfg.n_workers)]
        ici_bytes, dcn_bytes = self._gossip_split()
        return SimResult.from_traffic(
            traffic,
            history=history,
            final_certificates=[float(c) for c in fin["certs"]],
            final_models=final_models,
            sim_time=float(fin["clock"].max()),
            cost_units_total=float(np.sum(fin["cost_total"])),
            events_processed=rounds * cfg.n_workers,
            rounds=rounds,
            gossip_bytes_per_round=ici_bytes + dcn_bytes,
            gossip_bytes_per_round_ici=ici_bytes,
            gossip_bytes_per_round_dcn=dcn_bytes,
            gossip_mode=self._gossip_mode(),
            inflight_occupancy_peak=int(np.max(fin["occ_peak"])),
            control_bytes_per_round=ictrl + dctrl,
            control_plane=cfg.control_plane,
            inflight_capacity_selected=self._auto_selected,
            workers_joined=workers_joined,
        )


def quantize_latency(
    base_latency: float,
    jitter: float,
    round_dt: float,
    n_workers: int,
    seed: int = 0,
) -> np.ndarray:
    """Quantize a continuous per-link latency model to an integer (W, W)
    round-delay matrix: ``delay = max(1, round(lat/dt))``, jitter drawn
    once per link from U[0, jitter)."""
    rng = np.random.default_rng(seed)
    lat = base_latency + rng.uniform(0.0, max(jitter, 0.0), size=(n_workers, n_workers))
    dt = max(round_dt, 1e-12)
    return np.maximum(np.rint(lat / dt), 1).astype(np.int32)


def make_engine(
    worker: BatchedTMSNWorker, config: EngineConfig, device: str | torch.device | None = None
) -> TMSNEngine:
    """Build the engine for ``config.mesh``, as the reference does:
    ``None`` or a mesh of one rank gives the single-device
    :class:`TMSNEngine`, a multi-rank mesh with a ``workers`` axis the
    :class:`~repro_torch.core.engine_sharded.ShardedTMSNEngine`:
    single-tier on a ``("workers",)`` mesh, two-tier on a
    ``("pod", "workers")`` mesh. ``device`` defaults to the mesh's
    device, else ``"cuda"``."""
    mesh = config.mesh
    if mesh is None or mesh.size == 1:
        if device is None:
            device = getattr(mesh, "device", "cuda")
        return TMSNEngine(worker, config, device)
    if "workers" not in mesh.axis_names:
        raise ValueError(f"engine mesh needs a 'workers' axis, got {mesh.axis_names}")
    from repro_torch.core.engine_sharded import ShardedTMSNEngine

    return ShardedTMSNEngine(worker, config, device)
