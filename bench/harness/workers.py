"""Wrappers around the worker an engine is given: the benchmark's spans
and recorders sit at the engine/worker boundary, outside the program."""

from __future__ import annotations


class Wrapped:
    """Delegates every attribute to ``worker``; a subclass overrides the
    calls it observes. Only attributes the worker has are visible, so an
    engine's test for optional hooks sees the worker's own answer."""

    def __init__(self, worker):
        self.worker = worker

    def __getattr__(self, name):
        return getattr(self.worker, name)


class SpanWorker(Wrapped):
    """Marks ``scan_round``'s start and takes a span around each call
    named in ``calls`` that the worker has."""

    def __init__(self, worker, spans, calls: tuple):
        super().__init__(worker)
        self._spans, self._calls = spans, calls

    def __getattr__(self, name):
        fn = getattr(self.worker, name)
        if name not in self._calls:
            return fn
        spans = self._spans

        def timed(*args, **kw):
            if name == "scan_round":
                spans.mark("scan_round")
            item = spans.open(name)
            out = fn(*args, **kw)
            spans.close(item)
            return out

        return timed
