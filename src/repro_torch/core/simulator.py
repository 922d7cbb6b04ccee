"""Event-driven discrete-event simulator for the TMSN protocol;
counterpart of ``src/repro/core/simulator.py``.

Fidelity level 1: the paper's protocol exactly — independent workers
with different speeds, fire-and-forget broadcast with per-link
latencies, interrupt-on-accept, laggards and fail-stop machines — with
simulated wall-clock time driven by a cost model (cost units / worker
speed). The learning inside each worker event is real (the port's
Sparrow worker, on the card by default); only time is simulated.

Interrupt granularity: a worker is scheduled in segments. An accepted
message takes effect at the end of the in-flight segment and discards
that segment's partial scan.

Host code throughout: the event queue, the protocol decisions
(:func:`~repro_torch.core.protocol.accepts` /
:func:`~repro_torch.core.protocol.improves`) and the bookkeeping are
Python. The latency jitter comes from ``random.Random(config.seed)``, the
reference's own generator, so both packages see the same jitter sequence.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from collections.abc import Callable, Sequence
from typing import Any

from repro_torch.core.protocol import accepts, improves
from repro_torch.core.result import SimResult, TrafficCounters
from repro_torch.core.worker import TMSNWorker

__all__ = [
    "TMSNWorker",  # re-exported; the worker protocols live in repro_torch.core.worker
    "WorkerSpec",
    "SimulatorConfig",
    "SimResult",  # re-exported; lives in repro_torch.core.result
    "TMSNSimulator",
    "run_bsp_baseline",
]


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Per-machine heterogeneity knobs."""

    speed: float = 1.0  # cost units per simulated second
    fail_at: float | None = None  # fail-stop time (None = never)


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    n_workers: int = 4
    eps: float = 0.0  # protocol gap; 0 = "any strict improvement"
    base_latency: float = 0.05  # seconds, per broadcast hop
    latency_jitter: float = 0.02  # uniform [0, jitter) extra per hop
    max_time: float = 1e9
    max_events: int = 2_000_000
    seed: int = 0
    #: stop as soon as any live worker's certificate <= target (None =
    #: run until max_time/max_events)
    target_certificate: float | None = None
    #: snapshot the current best model every N processed events (0 = off)
    snapshot_every: int = 0


_RESUME, _RECV = 0, 1


class TMSNSimulator:
    """Discrete-event TMSN run over a set of logical workers."""

    def __init__(
        self,
        worker: TMSNWorker,
        specs: Sequence[WorkerSpec],
        config: SimulatorConfig,
        latency_fn: Callable[[int, int, float], float] | None = None,
    ) -> None:
        if len(specs) != config.n_workers:
            raise ValueError(f"{len(specs)} specs for {config.n_workers} workers")
        self.worker = worker
        self.specs = list(specs)
        self.config = config
        self._latency_fn = latency_fn
        self._rng = random.Random(config.seed)

    def _latency(self, src: int, dst: int, now: float) -> float:
        if self._latency_fn is not None:
            return self._latency_fn(src, dst, now)
        return self.config.base_latency + self._rng.random() * self.config.latency_jitter

    def run(self) -> SimResult:
        cfg = self.config
        states = [self.worker.init_state(i, cfg.seed + 1000 * i) for i in range(cfg.n_workers)]
        certs = [float(self.worker.certificate(s)) for s in states]
        alive = [True] * cfg.n_workers

        heap: list[tuple[float, int, int, int, Any]] = []
        counter = 0
        for i in range(cfg.n_workers):
            heapq.heappush(heap, (0.0, counter, _RESUME, i, None))
            counter += 1

        history: list[tuple[float, int, float]] = [(0.0, i, certs[i]) for i in range(cfg.n_workers)]
        snapshots: list = []
        traffic = TrafficCounters()
        cost_total = 0.0
        events = 0
        now = 0.0

        def done() -> bool:
            if cfg.target_certificate is None:
                return False
            return any(certs[i] <= cfg.target_certificate for i in range(cfg.n_workers) if alive[i])

        while heap and events < cfg.max_events and now <= cfg.max_time and not done():
            now, _, kind, wid, payload = heapq.heappop(heap)
            events += 1
            if cfg.snapshot_every and events % cfg.snapshot_every == 0:
                b = min(range(cfg.n_workers), key=lambda i: certs[i])
                snapshots.append((now, certs[b], self.worker.export_model(states[b])))
            spec = self.specs[wid]
            if spec.fail_at is not None and now >= spec.fail_at:
                alive[wid] = False
            if not alive[wid]:
                continue

            if kind == _RECV:
                in_model, in_cert = payload
                if accepts(certs[wid], in_cert, cfg.eps):
                    states[wid] = self.worker.adopt(states[wid], in_model, in_cert)
                    certs[wid] = float(in_cert)
                    traffic.accepted += 1
                    history.append((now, wid, certs[wid]))
                else:
                    traffic.discarded += 1
                continue

            # _RESUME: one scheduling quantum of real computation
            old_cert = certs[wid]
            states[wid], cost, fired = self.worker.run_segment(states[wid])
            cost_total += cost
            t_end = now + cost / max(spec.speed, 1e-12)

            if fired:
                new_cert = float(self.worker.certificate(states[wid]))
                certs[wid] = new_cert
                history.append((t_end, wid, new_cert))
                # broadcast on ANY strict improvement; eps gates acceptance
                # only (gating broadcasts by eps deadlocks feature-partitioned
                # workers once per-fire deltas drop below eps)
                if improves(old_cert, new_cert, 0.0):
                    model = self.worker.export_model(states[wid])
                    nbytes = self.worker.payload_bytes(model)
                    for dst in range(cfg.n_workers):
                        if dst == wid or not alive[dst]:
                            continue
                        lat = self._latency(wid, dst, t_end)
                        heapq.heappush(heap, (t_end + lat, counter, _RECV, dst, (model, new_cert)))
                        counter += 1
                        traffic.sent += 1
                        traffic.bytes_broadcast += nbytes

            heapq.heappush(heap, (t_end, counter, _RESUME, wid, None))
            counter += 1

        return SimResult.from_traffic(
            traffic,
            history=history,
            final_certificates=certs,
            final_models=[self.worker.export_model(s) for s in states],
            sim_time=now,
            cost_units_total=cost_total,
            events_processed=events,
            snapshots=snapshots,
        )


def run_bsp_baseline(
    worker: TMSNWorker,
    specs: Sequence[WorkerSpec],
    config: SimulatorConfig,
    rounds: int,
) -> SimResult:
    """Bulk-synchronous contrast harness (the paper's §1 strawman).

    All workers run one segment per round; the round ends when the
    slowest live worker finishes (the barrier); then the best model is
    distributed to everyone. Wall-clock per round = max_i(cost_i /
    speed_i) + one broadcast latency: the laggard penalty TMSN removes.
    """
    states = [worker.init_state(i, config.seed + 1000 * i) for i in range(config.n_workers)]
    certs = [float(worker.certificate(s)) for s in states]
    alive = [True] * config.n_workers
    history = [(0.0, i, certs[i]) for i in range(config.n_workers)]
    now = 0.0
    cost_total = 0.0
    wait = [0.0] * config.n_workers
    sent = 0
    for _ in range(rounds):
        durations = []
        for i in range(config.n_workers):
            if alive[i] and specs[i].fail_at is not None and now >= specs[i].fail_at:
                alive[i] = False
            if not alive[i]:
                durations.append(0.0)
                continue
            states[i], cost, fired = worker.run_segment(states[i])
            cost_total += cost
            durations.append(cost / max(specs[i].speed, 1e-12))
            if fired:
                certs[i] = float(worker.certificate(states[i]))
        # a failed worker that never reports would stall the barrier until
        # a timeout; the charitable reading takes the live workers' max
        round_len = max(durations) if durations else 0.0
        for i in range(config.n_workers):
            if alive[i]:
                wait[i] += round_len - durations[i]
        now += round_len + config.base_latency
        best = min(range(config.n_workers), key=lambda i: certs[i])
        best_model = worker.export_model(states[best])
        for i in range(config.n_workers):
            if i != best and alive[i] and accepts(certs[i], certs[best], config.eps):
                states[i] = worker.adopt(states[i], best_model, certs[best])
                certs[i] = certs[best]
                sent += 1
        history.append((now, best, certs[best]))
        if config.target_certificate is not None and certs[best] <= config.target_certificate:
            break
    return SimResult(
        history=history,
        final_certificates=certs,
        final_models=[worker.export_model(s) for s in states],
        sim_time=now,
        messages_sent=sent,
        messages_accepted=sent,
        messages_discarded=0,
        bytes_broadcast=0,
        cost_units_total=cost_total,
        events_processed=rounds,
        wait_time=wait,
    )
