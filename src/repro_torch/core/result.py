"""Run bookkeeping shared by the port's execution substrates; a copy of
``src/repro/core/result.py`` (numpy only), kept here so the port never
imports the JAX package.

Everything in this module lives on the HOST after a run.
:meth:`TrafficCounters.from_shards` reduces per-shard partial counters
(a sharded engine's) or plain scalars (the single-device engine's) to
global totals.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class TrafficCounters:
    """Message accounting shared by the simulator and the engine.

    The engine delivers at most one (the best) message per destination
    per round, so its ``accepted`` counts adoptions while the event
    simulator counts every individually-accepted RECV; the end states
    agree (adopting the min dominates adopting a chain of decreasing
    certificates) but the counters are substrate-level diagnostics, not
    protocol invariants.
    """

    sent: int = 0
    accepted: int = 0
    discarded: int = 0
    bytes_broadcast: int = 0
    #: interconnect-tier split of ``sent`` (pod-mesh engine): pushes
    #: that crossed a pod boundary (DCN); the intra-pod (ICI) half and
    #: the byte figures are derived properties below, so the split can
    #: never drift from the totals. Single-tier substrates report 0.
    sent_dcn: int = 0
    #: sparse-engine capacity evictions: candidates offered to a
    #: bounded pending queue but not retained (0 on the dense oracle
    #: and the event sim; 0 on a sparse run certifies it exact)
    evicted: int = 0
    #: payload size one push carries (kept so the derived byte split
    #: stays consistent with ``bytes_broadcast``)
    payload_bytes: int = 0
    #: cumulative CONTROL-plane bytes over the run (certificates /
    #: broadcast flags / candidate ids, as opposed to model payloads):
    #: the per-round ``control_bytes_per_round`` figure × rounds. 0 on
    #: the event sim and the single-device engine (no wire).
    control_bytes: int = 0
    #: messages removed in flight by FaultPlan injection — random
    #: per-edge drops plus partition-window drops (0 without a plan)
    dropped_injected: int = 0
    #: push candidates rejected by the eps-gate soundness check
    #: (non-finite or non-improving certificates; active only under a
    #: FaultPlan, so 0 on every clean run)
    corrupt_rejected: int = 0

    @property
    def sent_ici(self) -> int:
        return self.sent - self.sent_dcn

    @property
    def bytes_dcn(self) -> int:
        return self.sent_dcn * self.payload_bytes

    @classmethod
    def from_shards(
        cls,
        sent: Any,
        accepted: Any,
        discarded: Any,
        payload_bytes: int,
        sent_dcn: Any = 0,
        evicted: Any = 0,
        control_bytes: int = 0,
        dropped_injected: Any = 0,
        corrupt_rejected: Any = 0,
    ) -> "TrafficCounters":
        """Reduce per-shard partial counters into global totals.

        The sharded engine keeps one partial counter per device (summing
        inside the shard-mapped step would cost a ``psum`` per round);
        the single-device engine passes () scalars. ``np.sum`` handles
        both shapes, so this is the one place the reduction lives —
        including the per-tier ICI/DCN split of the pod-mesh engine
        (``sent`` is the all-tier total; ``sent_dcn`` the pod-crossing
        part; ICI is the difference).
        """
        total = int(np.sum(sent))
        return cls(
            sent=total,
            accepted=int(np.sum(accepted)),
            discarded=int(np.sum(discarded)),
            bytes_broadcast=total * payload_bytes,
            sent_dcn=int(np.sum(sent_dcn)),
            evicted=int(np.sum(evicted)),
            payload_bytes=payload_bytes,
            control_bytes=int(control_bytes),
            dropped_injected=int(np.sum(dropped_injected)),
            corrupt_rejected=int(np.sum(corrupt_rejected)),
        )


@dataclasses.dataclass
class SimResult:
    #: (sim_time, worker_id, certificate) at every local improvement/adopt
    history: list[tuple[float, int, float]]
    final_certificates: list[float]
    final_models: list[Any]
    sim_time: float
    messages_sent: int
    messages_accepted: int
    messages_discarded: int
    bytes_broadcast: int
    cost_units_total: float
    events_processed: int
    #: per-worker wall time spent blocked (always 0 for TMSN — kept so
    #: the BSP baseline harness can report the contrast)
    wait_time: list[float] = dataclasses.field(default_factory=list)
    #: (sim_time, best_certificate, best_model) checkpoints
    snapshots: list = dataclasses.field(default_factory=list)
    #: rounds executed (round-based engine only; 0 for the event sim)
    rounds: int = 0
    #: cross-device gossip exchange footprint per round in bytes —
    #: 0 for the event sim and the single-device engine; the sum of the
    #: ICI and (amortized) DCN tiers below for the sharded engines. For
    #: the single-tier engine the figure is per ``gossip_mode``:
    #:   dense: W · (payload + 4 + 1)            (every model, every round)
    #:   gated: W · 5 + n_dev · k · (payload + 4) (certs/flags densely,
    #:          payloads only for top-k improved candidates per device)
    gossip_bytes_per_round: int = 0
    #: per-tier split on the pod-mesh engine: the intra-pod all_gather
    #: footprint (every round, over the ``workers`` axis — ICI class
    #: links) vs the cross-pod candidate exchange (every
    #: ``cross_pod_every_k`` rounds over the ``pod`` axis — DCN class),
    #: the DCN figure amortized per round. Single-tier substrates
    #: report everything as ICI and 0 DCN.
    gossip_bytes_per_round_ici: int = 0
    gossip_bytes_per_round_dcn: int = 0
    #: pushes that crossed a pod boundary (0 off the pod-mesh engine)
    messages_sent_dcn: int = 0
    #: which gossip policy produced ``gossip_bytes_per_round``
    #: ("dense" | "gated"; single-device substrates report "dense")
    gossip_mode: str = "dense"
    #: sparse-engine capacity evictions over the whole run (0 on the
    #: dense oracle and the event sim). 0 on a sparse run is the
    #: run-level witness that bounded capacity changed nothing — the
    #: run is bit-identical to the dense oracle.
    messages_evicted: int = 0
    #: peak pre-eviction pending-queue occupancy any destination saw
    #: (sparse engine only; the measured capacity floor for an exact
    #: rerun of the same config). 0 on dense/event substrates.
    inflight_occupancy_peak: int = 0
    #: CONTROL-plane share of ``gossip_bytes_per_round`` — the
    #: certificate/flag/id bytes as opposed to model payload bytes:
    #:   dense control: W_tier · 5 per round (f32 cert + bool flag)
    #:   sparse control: n_dev · k · 12 (f32 cert + i32 id + i32 round)
    #: 0 off the sharded engines (no wire).
    control_bytes_per_round: int = 0
    #: which control-plane policy produced the figures above
    #: ("dense" | "sparse")
    control_plane: str = "dense"
    #: the capacity the ``inflight_capacity="auto"`` warm-up probe
    #: selected for this run (0 when capacity was explicit)
    inflight_capacity_selected: int = 0
    #: messages removed in flight by FaultPlan injection (random drops
    #: + partition-window drops; 0 on clean runs and the event sim)
    messages_dropped_injected: int = 0
    #: push candidates rejected by the eps-gate soundness check —
    #: non-finite or non-improving certificates, which a corrupt
    #: message must present to be dangerous (0 on clean runs)
    messages_corrupt_rejected: int = 0
    #: MembershipPlan joins that activated a spare strictly after round
    #: 0 and before the run ended (a join at round 1 is a from-the-start
    #: member and does not count — it is bit-identical to a plain run)
    workers_joined: int = 0

    def best_certificate_trace(self) -> list[tuple[float, float]]:
        """Monotone (time, best-cert-so-far) envelope across workers."""
        out: list[tuple[float, float]] = []
        best = float("inf")
        for t, _, c in sorted(self.history):
            if c < best:
                best = c
                out.append((t, best))
        return out

    @classmethod
    def from_traffic(
        cls,
        traffic: TrafficCounters,
        **kw: Any,
    ) -> "SimResult":
        return cls(
            messages_sent=traffic.sent,
            messages_accepted=traffic.accepted,
            messages_discarded=traffic.discarded,
            bytes_broadcast=traffic.bytes_broadcast,
            messages_sent_dcn=traffic.sent_dcn,
            messages_evicted=traffic.evicted,
            messages_dropped_injected=traffic.dropped_injected,
            messages_corrupt_rejected=traffic.corrupt_rejected,
            **kw,
        )
