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

Not ported yet (queue 1 item 9 of ROADMAP.md), and refused with
``NotImplementedError``: fault plans, elastic membership (spare slots,
membership plans), the serving publisher, ``inflight_capacity="auto"``
and multi-device meshes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, NamedTuple

import numpy as np
import torch

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

#: what the NotImplementedError of an unported feature names
_DEFERRED = "not ported yet: ROADMAP.md queue 1 item 9 (engine chaos, membership and publish)"


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
    """Adversarial message-fault schedule of the reference engine. The
    port parses and validates it (so ``REPRO_FAULT_PLAN`` behaves the
    same in both packages) but does not inject faults yet: an active
    plan raises ``NotImplementedError``."""

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
    """Elastic-membership schedule of the reference engine (1-based
    ``(round, slot)`` joins and ``(round, worker)`` leaves); accepted as
    a type here, refused by the engine until it is ported."""

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
    #: (bit-identical to dense while nothing is evicted); "auto" is not
    #: ported yet
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
    spare_slots: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_SPARE_SLOTS", 0)
    )
    membership: Any = None
    fault_spec: str = dataclasses.field(
        default_factory=lambda: _env_str("REPRO_FAULT_PLAN", "")
    )
    fault_plan: Any = None
    publish_every_k: int = dataclasses.field(
        default_factory=lambda: _env_int("REPRO_PUBLISH_EVERY_K", 0)
    )
    publish_eps: float = dataclasses.field(
        default_factory=lambda: _env_float("REPRO_PUBLISH_EPS", 0.0)
    )
    #: multi-device mesh; the port's engine is single-device for now
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
    return torch.tensor(float("inf"), dtype=torch.float32, device=like.device)


def _i32(x: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=like.device)


def _queue_push(
    queue: PendingQueue,
    score: torch.Tensor,
    alive: torch.Tensor,
    local_gids: torch.Tensor,
    delay_rows: torch.Tensor,
    r: int,
    depth: int,
):
    """Push this round's broadcast candidates into every destination's
    pending queue, evicting worst-certificate-first.

    ``score`` is (W,) over source ids: the candidate's certificate where
    that source broadcasts, +inf elsewhere. Only the best ``C + 1``
    candidates can enter a kept top-C, so the merge lexsorts
    ``(W, C + min(C+1, W))``; eviction keeps the smallest C by
    (cert, src, due), ties dropping the later column.

    Returns ``(queue, n_pushed, n_evicted, occ_pre_max)`` with LOGICAL
    counters: ``n_evicted == 0`` over a run certifies it bit-identical
    to the dense oracle."""
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
    occ_pre = torch.isfinite(queue.cert).sum(dim=1, dtype=torch.int32) + n_cand
    occ_after = torch.isfinite(new.cert).sum(dim=1, dtype=torch.int32)
    return (
        new,
        n_cand.sum(dtype=torch.int32),
        (occ_pre - occ_after).sum(dtype=torch.int32),
        occ_pre.max(),
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
):
    """Sparse-control ingest: merge an explicit candidate list — (m,)
    certificates and source ids, padded with id >= W / +inf — into the
    pending queues through kernel K3 (``impl="pallas"``) or its plain
    version (``"ref"``), under the same order as :func:`_queue_push`.

    Returns ``(queue, n_pushed, n_evicted, occ_pre_max)``."""
    w = delay_rows.shape[1]
    wl, m = delay_rows.shape[0], cand_ids.shape[0]
    ids_c = torch.clamp(cand_ids, 0, w - 1).to(torch.int32)
    val = _candidate_valid(cand_cert, cand_ids, alive, local_gids, w)
    c_cert = torch.where(val, cand_cert.unsqueeze(0), _inf(cand_cert)).contiguous()
    c_src = ids_c.unsqueeze(0).expand(wl, m).contiguous()
    c_due = torch.where(
        val, r + torch.gather(delay_rows, 1, c_src.long()), _i32(-1, cand_cert)
    ).contiguous()
    c_slot = torch.where(val, _i32(r % depth, cand_cert), _i32(0, cand_cert)).contiguous()
    ingest = kref.queue_ingest_ref if impl == "ref" else kops.queue_ingest
    q_cert, q_due, q_src, q_slot = ingest(
        queue.cert, queue.due, queue.src, queue.slot, c_cert, c_due, c_src, c_slot
    )
    new = PendingQueue(cert=q_cert, src=q_src, due=q_due, slot=q_slot)
    n_cand = val.sum(dim=1, dtype=torch.int32)
    occ_pre = torch.isfinite(queue.cert).sum(dim=1, dtype=torch.int32) + n_cand
    occ_after = torch.isfinite(new.cert).sum(dim=1, dtype=torch.int32)
    return (
        new,
        n_cand.sum(dtype=torch.int32),
        (occ_pre - occ_after).sum(dtype=torch.int32),
        occ_pre.max(),
    )


def _dense_push_candidates(
    inflight: torch.Tensor,
    cand_cert: torch.Tensor,
    cand_ids: torch.Tensor,
    alive: torch.Tensor,
    local_gids: torch.Tensor,
    delay_rows: torch.Tensor,
):
    """Sparse-control push into the dense ``(W_local, W, D)`` buffer:
    write each valid candidate's certificate at ``[dst, src, delay-1]``.
    Returns ``(inflight, n_pushed)``."""
    w = delay_rows.shape[1]
    wl, m = delay_rows.shape[0], cand_ids.shape[0]
    ids_c = torch.clamp(cand_ids, 0, w - 1).long()
    val = _candidate_valid(cand_cert, cand_ids, alive, local_gids, w)
    src2 = ids_c.unsqueeze(0).expand(wl, m)
    d = torch.gather(delay_rows, 1, src2)
    rows = torch.arange(wl, device=inflight.device).unsqueeze(1).expand(wl, m)
    out = inflight.clone()
    out[rows[val], src2[val], (d[val] - 1).long()] = cand_cert.unsqueeze(0).expand(wl, m)[val]
    return out, val.sum(dtype=torch.int32)


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
    evicted: torch.Tensor  # () i32 capacity evictions (0 on the dense path)
    occ_peak: torch.Tensor  # () i32 peak pre-eviction queue occupancy


class RoundInfo(NamedTuple):
    """Per-round summary fetched to the host for history and the stop."""

    certs: torch.Tensor  # (W,)
    changed: torch.Tensor  # (W,) bool — cert changed this round (fire or adopt)
    clock: torch.Tensor  # (W,)
    alive: torch.Tensor  # (W,)


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
        if not 0 <= int(config.spare_slots) < w:
            raise ValueError(
                f"spare_slots must be in [0, n_workers), got {config.spare_slots} (n_workers={w})"
            )
        fplan = config.fault_plan
        if fplan is None:
            fplan = _parse_fault_spec(config.fault_spec)
        elif not isinstance(fplan, FaultPlan):
            raise ValueError(f"fault_plan must be a FaultPlan, got {type(fplan).__name__}")

        # --- features of the reference engine this port does not carry yet
        if config.inflight_capacity == "auto":
            raise NotImplementedError(f"inflight_capacity='auto' is {_DEFERRED}")
        if int(config.spare_slots) > 0 or config.membership is not None:
            raise NotImplementedError(f"elastic membership (spare_slots, membership) is {_DEFERRED}")
        if fplan is not None and fplan.active:
            raise NotImplementedError(f"fault injection (fault_spec, fault_plan) is {_DEFERRED}")
        if config.mesh is not None and getattr(config.mesh, "size", 1) > 1:
            raise NotImplementedError(f"a multi-device mesh is {_DEFERRED}")

        self._control_sparse = config.control_plane == "sparse"
        self._capacity = int(config.inflight_capacity)

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
        self._fail_round = torch.as_tensor(fail.astype(np.int32), device=dev)

        self._has_resample = has_resample_hooks(worker)
        self._payload_bytes = resolve_payload_bytes(worker, w, config.seed)

    def attach_publisher(self, slot: Any) -> None:
        """The serving publisher of the reference engine."""
        raise NotImplementedError(f"attach_publisher is {_DEFERRED}")

    # ------------------------------------------------------------------
    def _init_state(self) -> EngineState:
        cfg = self.config
        w, d, dev = cfg.n_workers, self._depth, self.device
        wstate = self.worker.init_batch(w, cfg.seed)
        models = self.worker.export_models(wstate)
        if self._capacity:
            inflight = _empty_queue(w, self._capacity, dev)
        else:
            inflight = torch.full((w, w, d), float("inf"), dtype=torch.float32, device=dev)
        zi = torch.zeros((), dtype=torch.int32, device=dev)
        return EngineState(
            worker=wstate,
            certs=self.worker.certificates(wstate).to(torch.float32),
            alive=torch.ones((w,), dtype=torch.bool, device=dev),
            credit=torch.zeros((w,), dtype=torch.float32, device=dev),
            clock=torch.zeros((w,), dtype=torch.float32, device=dev),
            inflight=inflight,
            ring=tree_map(lambda a: a.unsqueeze(0).expand((d,) + a.shape).clone(), models),
            round=0,
            sent=zi,
            accepted=zi,
            discarded=zi,
            cost_total=torch.zeros((), dtype=torch.float32, device=dev),
            evicted=zi,
            occ_peak=zi,
        )

    def _deliver_sparse(self, queue: PendingQueue, certs0, alive, credit, r: int):
        """Fused sparse delivery through kernel K2 (or its plain version
        under ``round_step_impl="ref"``): argmin over this round's due
        entries, eps-gated accept, arrival clearing, laggard credit.

        Returns ``(queue', best_cert, best_src, best_slot, take,
        n_arrivals, credit', active)``."""
        deliver = kref.round_step_ref if self.config.round_step_impl == "ref" else kops.round_deliver
        q_cert, best_cert, best_src, best_slot, take, n_arr, credit2, active = deliver(
            queue.cert, queue.due, queue.src, queue.slot, certs0, alive, credit,
            self._speed_norm, r, eps=float(self.config.eps),
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
        cfg = self.config
        w, depth = cfg.n_workers, self._depth
        r = state.round
        dst_idx = torch.arange(w, device=self.device)
        alive = state.alive & (r < self._fail_round)
        certs0 = state.certs

        # --- 1.+2.(+3. credit) deliver arrivals due this round ------------
        if self._capacity:
            (inflight, best_cert, best_src, sent_slot, take, n_arrivals, credit,
             active) = self._deliver_sparse(state.inflight, certs0, alive, state.credit, r)
        else:
            arr = state.inflight[:, :, 0]  # (dst, src) certs
            arr_live = torch.where(alive.unsqueeze(1), arr, _inf(arr))
            best_src = torch.argmin(arr_live, dim=1)  # (W,)
            best_cert = arr_live[dst_idx, best_src]
            take = accepts(certs0, best_cert, cfg.eps) & torch.isfinite(best_cert)
            n_arrivals = torch.isfinite(arr).sum(dtype=torch.int32)
            sent_slot = (r - self._delay[best_src, dst_idx]) % depth
            inflight = torch.cat(
                [state.inflight[:, :, 1:], torch.full((w, w, 1), float("inf"), device=self.device)],
                dim=2,
            )
            credit = state.credit + self._speed_norm
            active = alive & (credit >= 1.0 - 1e-6)
            credit = torch.where(active, credit - 1.0, credit)
        n_taken = take.sum(dtype=torch.int32)

        slot_l, src_l = sent_slot.long(), best_src.long()
        in_models = tree_map(lambda a: a[slot_l, src_l], state.ring)
        wstate = state.worker
        zeros_w = torch.zeros((w,), dtype=torch.float32, device=self.device)
        if bool(take.any()):
            wstate, adopt_cost = self.worker.adopt_batch(wstate, in_models, best_cert, take)
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
        wstate, scan_cost, fired = self.worker.scan_round(wstate, scan_mask)
        certs = self.worker.certificates(wstate)

        cost = adopt_cost + resample_cost + scan_cost
        clock = state.clock + cost / torch.clamp(self._speed, min=1e-12)

        # --- 4. broadcast strict improvements -----------------------------
        improved = fired & improves(certs_pre, certs, 0.0) & scan_mask
        n_evicted = torch.zeros((), dtype=torch.int32, device=self.device)
        occ_pre_max = n_evicted
        gids = dst_idx.to(torch.int32)
        if self._control_sparse:
            # only the top-k improvers are offered; under uniform delay
            # the runner-ups could never have been accepted
            kc = min(int(cfg.gossip_top_k), w)
            rows, validk = self._top_k_candidates(improved, certs, kc)
            cand_ids = torch.where(validk, rows.to(torch.int32), _i32(w, certs))
            cand_certs = torch.where(validk, certs[rows], _inf(certs))
            if self._capacity:
                inflight, n_pushed, n_evicted, occ_pre_max = _queue_push_candidates(
                    inflight, cand_certs, cand_ids, alive, gids, self._delay_t, r, depth,
                    cfg.round_step_impl,
                )
            else:
                inflight, n_pushed = _dense_push_candidates(
                    inflight, cand_certs, cand_ids, alive, gids, self._delay_t
                )
        elif self._capacity:
            inflight, n_pushed, n_evicted, occ_pre_max = _queue_push(
                inflight, torch.where(improved, certs, _inf(certs)), alive, gids,
                self._delay_t, r, depth,
            )
        else:
            d_idx = torch.arange(depth, device=self.device).view(1, 1, depth)
            # push_mask[dst, src, d] — delay is indexed [src, dst]
            push_mask = (
                improved.view(1, w, 1)
                & alive.view(w, 1, 1)
                & (dst_idx.view(w, 1) != dst_idx.view(1, w)).unsqueeze(2)
                & (d_idx == (self._delay_t.unsqueeze(2) - 1))
            )
            inflight = torch.where(push_mask, certs.view(1, w, 1), inflight)
            n_pushed = push_mask.sum(dtype=torch.int32)

        # --- 5. snapshot the broadcasters' models into the ring -----------
        models = self.worker.export_models(wstate)
        slot = r % depth

        def snap(buf: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
            out = buf.clone()
            sel = improved.reshape((-1,) + (1,) * (m.dim() - 1))
            out[slot] = torch.where(sel, m, buf[slot])
            return out

        ring = tree_map(snap, state.ring, models)

        new_state = EngineState(
            worker=wstate,
            certs=certs,
            alive=alive,
            credit=credit,
            clock=clock,
            inflight=inflight,
            ring=ring,
            round=r + 1,
            sent=state.sent + n_pushed,
            accepted=state.accepted + n_taken,
            discarded=state.discarded + (n_arrivals - n_taken),
            cost_total=state.cost_total + cost.sum(),
            evicted=state.evicted + n_evicted,
            occ_peak=torch.maximum(state.occ_peak, occ_pre_max),
        )
        info = RoundInfo(certs=certs, changed=take | improved, clock=clock, alive=alive)
        return new_state, info

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.config
        state = self._init_state()
        certs0 = state.certs.cpu().numpy()
        history: list[tuple[float, int, float]] = [
            (0.0, i, float(certs0[i])) for i in range(cfg.n_workers)
        ]
        target = None if cfg.target_certificate is None else np.float32(cfg.target_certificate)
        rounds = 0
        for _ in range(int(cfg.max_rounds)):
            state, info = self._round_step(state)
            rounds += 1
            if not cfg.record_history and target is None:
                continue
            certs_r = info.certs.cpu().numpy()
            if cfg.record_history:
                changed = info.changed.cpu().numpy()
                clock_r = info.clock.cpu().numpy()
                ww = np.nonzero(changed)[0]
                history.extend(zip(clock_r[ww].tolist(), ww.tolist(), certs_r[ww].tolist()))
            # f32 target, as in the reference's in-scan freeze comparison
            if target is not None and np.any((certs_r <= target) & info.alive.cpu().numpy()):
                break

        certs = state.certs.cpu().numpy()
        models = self.worker.export_models(state.worker)
        traffic = TrafficCounters.from_shards(
            sent=int(state.sent),
            accepted=int(state.accepted),
            discarded=int(state.discarded),
            payload_bytes=self._payload_bytes,
            evicted=int(state.evicted),
        )
        final_models = [tree_map(lambda a, i=i: a[i], models) for i in range(cfg.n_workers)]
        return SimResult.from_traffic(
            traffic,
            history=history,
            final_certificates=[float(c) for c in certs],
            final_models=final_models,
            sim_time=float(state.clock.max()),
            cost_units_total=float(state.cost_total),
            events_processed=rounds * cfg.n_workers,
            rounds=rounds,
            gossip_mode="dense",
            inflight_occupancy_peak=int(state.occ_peak),
            control_plane=cfg.control_plane,
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
    worker: BatchedTMSNWorker, config: EngineConfig, device: str | torch.device = "cuda"
) -> TMSNEngine:
    """Build the engine for ``config``: the single-device
    :class:`TMSNEngine` (a multi-device mesh is not ported yet)."""
    return TMSNEngine(worker, config, device)
