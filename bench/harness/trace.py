"""Spans at layer boundaries and the reading of the profiler's trace.

Spans are CUDA events recorded at the entry and exit of a call into the
program, read once the window has closed (host clock stand-ins on the
CPU, for the tests). The profiler's trace gives the device's busy time
as the union of its kernel, copy and fill intervals, the host syncs, the
device time by kernel and the longest idle gaps.
"""

from __future__ import annotations

import time
from collections import defaultdict

from harness.workers import Wrapped

#: CUDA runtime calls that block the host until the device is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


class _HostEvent:
    """A CUDA event's interface on the host clock (CPU tests)."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class Spans:
    """Named spans ``(tag, start event, end event)`` and marks, in the
    order they were opened; times in ms from the first event."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.items = []  # (kind, tag, start, end or None)

    def _event(self):
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
        else:
            ev = _HostEvent()
        ev.record()
        return ev

    def mark(self, tag: str) -> None:
        self.items.append(("mark", tag, self._event(), None))

    def open(self, tag: str) -> list:
        item = ["span", tag, self._event(), None]
        self.items.append(item)
        return item

    def close(self, item: list) -> None:
        item[3] = self._event()

    def read(self) -> list:
        """``[(kind, tag, start_ms, end_ms or None)]`` relative to the first
        event (synchronises once)."""
        if not self.items:
            return []
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        t0 = self.items[0][2]
        return [(k, tag, t0.elapsed_time(s), None if e is None else t0.elapsed_time(e))
                for k, tag, s, e in self.items]


#: marks that end a run of round periods: the profiler's start and stop
#: (a period never spans them)
BREAKS = ("profiler",)


def round_split(spans: list, start_tag: str, worker_tags: tuple) -> dict:
    """Per round, its period (between consecutive ``start_tag`` marks with
    no BREAKS mark between them) and the part of it spent in spans tagged
    ``worker_tags``. Returns ``{"periods_ms": [...], "worker_ms": [...]}``,
    one entry per period."""
    periods, inside = [], []
    cur, acc = None, 0.0
    for kind, tag, s, e in spans:
        if kind == "mark" and tag in BREAKS:
            cur, acc = None, 0.0
        elif kind == "mark" and tag == start_tag:
            if cur is not None:
                periods.append(s - cur)
                inside.append(acc)
            cur, acc = s, 0.0
        elif kind == "span" and tag in worker_tags and cur is not None and e is not None:
            acc += e - s
    return {"periods_ms": periods, "worker_ms": inside}


def union_busy(intervals: list) -> tuple[float, list]:
    """(busy time, gaps) of ``(start, end)`` intervals: the length of their
    union, and the gaps ``(gap_start, gap_end)`` between its pieces."""
    if not intervals:
        return 0.0, []
    ivals = sorted(intervals)
    busy, gaps = 0.0, []
    end = ivals[0][0]
    for s, f in ivals:
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    return busy, gaps


def _is_device(ev) -> bool:
    return str(ev.device_type).endswith("CUDA")


def read_profile(prof, window_s: float, top: int = 10) -> dict:
    """From a ``torch.profiler.profile`` over a traced window of
    ``window_s`` host seconds: the device's busy seconds (union of its
    intervals), host syncs, the operations with the most device time,
    and the longest idle gaps named by the host op running across them."""
    events = list(prof.events())
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if _is_device(e) and e.time_range.end > e.time_range.start]
    busy_us, gaps = union_busy([(s, f) for s, f, _ in dev])
    by_name = defaultdict(float)
    for s, f, name in dev:
        by_name[name] += (f - s) / 1e6
    syncs = sum(1 for e in events if not _is_device(e) and e.name in SYNC_CALLS)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if not _is_device(e) and e.time_range.end > e.time_range.start)
    named_gaps = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (g0 + g1)
        # the innermost (latest-starting) host op running at the gap's middle
        running = [h for h in host if h[0] <= mid <= h[1]]
        name = max(running)[2] if running else "host outside any profiled op"
        named_gaps.append([name, (g1 - g0) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "syncs": syncs,
        "breakdown": {"device_ops": [[k, v] for k, v in ops[:top]], "idle_gaps": named_gaps},
    }


class RoundProfiler(Wrapped):
    """Wraps a worker and traces the rounds ``[first, first + n)`` of the
    next run under the profiler, starting and stopping it at those
    rounds' scans (with a BREAKS mark in ``spans`` at each). The trace is
    read by :meth:`summary` once the window has closed; ``wall_s`` is the
    host time from the profiler's start to its stop."""

    def __init__(self, worker, first: int, n: int, cuda: bool, spans: Spans):
        super().__init__(worker)
        self.first, self.n, self.cuda, self.spans = first, n, cuda, spans
        self.count, self.prof, self.t = 0, None, []

    def scan_round(self, state, mask):
        if self.count == self.first:
            self._start()
        elif self.count == self.first + self.n:
            self.stop()
        self.count += 1
        return self.worker.scan_round(state, mask)

    def _sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.spans.mark("profiler")
        self.t = [time.perf_counter()]
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t.append(time.perf_counter())

    def stop(self):
        """Stops the trace (at the traced rounds' end, or the run's)."""
        if self.prof is None or len(self.t) > 2:
            return
        self._sync()
        self.t.append(time.perf_counter())
        self.prof.__exit__(None, None, None)
        self.t.append(time.perf_counter())
        self.spans.mark("profiler")
        self.rounds = min(self.count, self.first + self.n) - self.first

    @property
    def wall_s(self) -> float:
        return self.t[3] - self.t[0] if len(self.t) == 4 else 0.0

    def summary(self) -> dict | None:
        if self.prof is None:
            return None
        out = read_profile(self.prof, self.t[2] - self.t[1])
        out["rounds"], out["wall_s"] = self.rounds, self.wall_s
        return out
