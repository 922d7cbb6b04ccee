"""The program's spans and counters: off by default, free when off.

The engine (``core/engine.py``, ``core/engine_sharded.py``) and the SGD
worker (``core/sgd_worker.py``) open a span at each layer boundary and
count, where they happen, the host syncs they force and the bytes their
model copies move. Nothing is recorded until the tracer is turned on::

    from repro_torch import trace

    trace.enable()
    result = TMSNEngine(worker, config).run()
    got = trace.collect()  # {"spans": [...], "counters": {...}}
    trace.disable()

Off, :func:`span` returns one shared no-op context manager and
:func:`count` returns at once: no allocation, no CUDA call, no host sync.

On, a span keeps its name, its parent (the innermost span open when it
opened), the ``round``, ``worker`` and ``step`` it was given, its host
start and end (``time.perf_counter_ns``), and a start and end CUDA event
where a card is present (host stand-ins without one). While it is open it
holds a profiler range of its name, so a ``torch.profiler`` trace carries
every span on the device trace's own clock (a span that opened before the
profiler started has no range). The range is a
``_RecordFunctionFast``: a host event, not a user annotation, so the
profiler adds no interval of its own to the device's timeline for it.
Counters are host integers keyed by name and site (:func:`count`), or
device tensors (:func:`count_device`: the rows each held expert
computed), which accumulate on the card without a sync and are read once
by :func:`collect`. Everything stays in memory until :func:`collect`.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

__all__ = ["collect", "count", "count_device", "disable", "enable", "enabled", "span"]


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _HostEvent:
    """A CUDA event's interface on the host clock (no card)."""

    __slots__ = ("t",)

    def record(self) -> None:
        self.t = time.perf_counter_ns()

    def elapsed_time(self, other: "_HostEvent") -> float:
        return (other.t - self.t) / 1e6


class _State:
    def __init__(self) -> None:
        self.on = False
        self.cuda = False
        self.range = None  # the profiler range's class, bound by enable()
        self.spans: list[_Span] = []
        self.stack: list[_Span] = []
        self.counters: dict = defaultdict(int)
        self.device: dict = {}  # (name, site) -> accumulated tensor


_S = _State()


class _Span:
    __slots__ = ("name", "parent", "round", "worker", "step", "t0", "t1", "e0", "e1", "rf")

    def __init__(self, name: str, parent, round, worker, step) -> None:
        self.name, self.parent = name, parent
        self.round, self.worker, self.step = round, worker, step
        self.t1 = self.e1 = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True) if _S.cuda else _HostEvent()
        ev.record()
        return ev

    def __enter__(self):
        # the range records only under a running profiler, and cannot be
        # closed under a profiler that started after it opened
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = _S.range(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        self.e0 = self._event()
        _S.stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.e1 = self._event()
        self.t1 = time.perf_counter_ns()
        if self.rf is not None and torch._C._autograd._profiler_enabled():
            self.rf.__exit__(None, None, None)
        _S.stack.pop()
        return False


def enable() -> None:
    """Turn the tracer on: spans and counts are recorded from here on,
    with CUDA events where a card is present."""
    from torch._C._profiler import _RecordFunctionFast

    _S.range = _RecordFunctionFast
    _S.cuda = torch.cuda.is_available()
    _S.on = True


def disable() -> None:
    """Turn the tracer off; what was recorded stays until :func:`collect`."""
    _S.on = False


def span(name: str, *, round: int | None = None, worker: int | None = None, step: int | None = None):
    """A context manager that records one span of ``name`` while the
    tracer is on; the shared no-op one while it is off."""
    if not _S.on:
        return _OFF
    sp = _Span(name, _S.stack[-1] if _S.stack else None, round, worker, step)
    _S.spans.append(sp)
    return sp


def enabled() -> bool:
    """Whether the tracer is on: a caller computes a device counter's
    value only then."""
    return _S.on


def count(name: str, n: int, site: str = "") -> None:
    """Add ``n`` to counter ``name`` at ``site`` while the tracer is on."""
    if _S.on:
        _S.counters[(name, site)] += n


def count_device(name: str, value: torch.Tensor, site: str = "", reduce: str = "sum") -> None:
    """Fold the device tensor ``value`` into counter ``name`` at ``site``
    while the tracer is on, on the card (``reduce`` "sum" or "max",
    elementwise): no host sync; :func:`collect` reads it."""
    if not _S.on:
        return
    key = (name, site)
    value = value.detach()
    old = _S.device.get(key)
    if old is None:
        _S.device[key] = value.clone()
    elif reduce == "max":
        torch.maximum(old, value, out=old)
    else:
        old.add_(value)


def collect() -> dict:
    """What was recorded since the last collect, then cleared.

    Synchronises the card once. Returns ``{"spans": [...], "counters":
    {name: {site: n}}}`` (a device counter's ``n`` is its tensor's
    ``tolist()``); the spans in the order they opened, each a dict
    of ``name``, ``parent`` (index of the parent span or None),
    ``round``, ``worker``, ``step``, ``host_ms`` and ``device_ms`` (None
    for a span still open)."""
    spans, counters, device = _S.spans, _S.counters, _S.device
    _S.spans, _S.counters, _S.device = [], defaultdict(int), {}
    if (spans or device) and _S.cuda:
        torch.cuda.synchronize()
    index = {id(sp): i for i, sp in enumerate(spans)}
    out = []
    for sp in spans:
        done = sp.e1 is not None
        out.append({
            "name": sp.name,
            "parent": None if sp.parent is None else index.get(id(sp.parent)),
            "round": sp.round, "worker": sp.worker, "step": sp.step,
            "host_ms": (sp.t1 - sp.t0) / 1e6 if done else None,
            "device_ms": sp.e0.elapsed_time(sp.e1) if done else None,
        })
    by_name: dict = defaultdict(dict)
    for (name, site), n in counters.items():
        by_name[name][site] = n
    for (name, site), t in device.items():
        by_name[name][site] = t.tolist()
    return {"spans": out, "counters": dict(by_name)}
