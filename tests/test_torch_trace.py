"""The program's tracer (``repro_torch.trace``) on the CPU: silent and
shared when off, the same bits when on, spans nested at the engine's and
the SGD worker's layer boundaries, counters that equal the arithmetic
from the ring's shapes, and profiler ranges that are plain host events.

The engine runs the tiny TMSN-SGD worker of tests/test_torch_sgd.py."""

import itertools
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core.engine import TMSNEngine
from repro_torch.tree import tree_leaves
from test_torch_sgd import K, ROUNDS, W, _engine_cfg, port_worker

ROUND_CHILDREN = ["engine.deliver", "engine.gather", "engine.adopt", "engine.scan", "engine.gossip",
                  "engine.ring", "engine.history"]


@pytest.fixture
def tracer():
    trace.disable()
    trace.collect()
    trace.enable()
    yield
    trace.disable()
    trace.collect()


def _run(**kw):
    return TMSNEngine(port_worker(reference_draws=False), _engine_cfg(**kw), device="cpu").run()


def _children(spans, i):
    return [s for s in spans if s["parent"] == i]


def test_off_records_nothing_and_shares_one_span():
    trace.disable()
    trace.collect()
    a, b = trace.span("engine.round", round=3), trace.span("sgd.adamw", step=1)
    assert a is b
    with a:
        trace.count("host_syncs", 1, "scan.mask")
    assert trace.collect() == {"spans": [], "counters": {}}
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 1000):
            with trace.span("sgd.forward", step=1):
                trace.count("engine.copy_bytes", 64, "ring")
        assert tracemalloc.get_traced_memory()[0] == before
    finally:
        tracemalloc.stop()


def test_tracing_changes_no_bit():
    off = _run()
    trace.enable()
    try:
        on = _run()
    finally:
        trace.disable()
        got = trace.collect()
    assert got["spans"]
    assert np.asarray(on.final_certificates, np.float32).view(np.int32).tolist() == \
        np.asarray(off.final_certificates, np.float32).view(np.int32).tolist()
    assert on.history == off.history and on.messages_accepted == off.messages_accepted > 0
    for a, b in zip(on.final_models, off.final_models):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_spans_nest_as_the_engine_and_the_worker(tracer):
    _run()
    spans = trace.collect()["spans"]
    assert all(s["host_ms"] >= 0 and s["device_ms"] >= 0 for s in spans)
    roots = [i for i, s in enumerate(spans) if s["parent"] is None]
    assert [spans[i]["name"] for i in roots] == ["engine.init"] + ["engine.round"] * ROUNDS
    assert [spans[i]["round"] for i in roots[1:]] == list(range(ROUNDS))
    takers = 0
    for i in roots[1:]:
        names = [s["name"] for s in _children(spans, i)]
        took = "engine.gather" in names
        takers += took
        assert names == [n for n in ROUND_CHILDREN if took or n not in ("engine.gather", "engine.adopt")]
        scan = next(j for j in range(i, len(spans)) if spans[j]["name"] == "engine.scan")
        segments = [j for j, s in enumerate(spans) if s["parent"] == scan]
        assert [(spans[j]["name"], spans[j]["worker"]) for j in segments] == \
            [("sgd.segment", w) for w in range(W)]
        for j in segments:
            steps = [(s["name"], s["step"]) for s in _children(spans, j)]
            assert steps == [(n, k) for k in range(K) for n in ("sgd.forward", "sgd.backward", "sgd.adamw")]
    assert takers > 0


@pytest.mark.parametrize("delay", [1, 2])
def test_counters_are_the_arithmetic_of_the_shapes(tracer, delay):
    res = _run(delay_rounds=delay)
    got = trace.collect()
    payload = sum(a.numel() * a.element_size() for a in tree_leaves(res.final_models[0]))
    takers = sum(s["name"] == "engine.gather" for s in got["spans"])
    # a round clones the (D, W) ring and writes one slot through a where and
    # its temporary; a round with a taker gathers W rows
    assert got["counters"]["engine.copy_bytes"] == {"ring": ROUNDS * (2 * delay + 5) * W * payload,
                                                    "gather": takers * 2 * W * payload}
    assert got["counters"]["host_syncs"] == {
        "scan.mask": ROUNDS, "scan.streams": ROUNDS, "scan.draws": ROUNDS, "engine.take_any": ROUNDS,
        "engine.history": 3 * ROUNDS, "engine.constant": ROUNDS}


def test_every_span_is_a_host_event_under_the_profiler(tracer):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(max_rounds=2)
    spans = trace.collect()["spans"]
    names = {s["name"] for s in spans}
    assert {"engine.round", "sgd.adamw", "engine.ring"} <= names
    events = [e for e in prof.events() if e.name in names]
    for name in names:
        mine = [e for e in events if e.name == name]
        assert len(mine) == sum(s["name"] == name for s in spans), name
    assert all(str(e.device_type).endswith("CPU") and not e.is_user_annotation for e in events)


def test_a_span_open_while_the_profiler_starts_or_stops(tracer):
    """A span opened before the profiler started closes without a range
    (the benchmark starts its profiler inside a round); one open when it
    stops closes as usual."""
    from torch.profiler import ProfilerActivity, profile

    with trace.span("engine.round"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("engine.scan"):
                torch.ones(2).sum()
    names = [e.name for e in prof.events()]
    assert "engine.scan" in names and "engine.round" not in names
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    with trace.span("engine.ring"):
        prof.__exit__(None, None, None)
    spans = trace.collect()["spans"]
    assert [s["name"] for s in spans] == ["engine.round", "engine.scan", "engine.ring"]
    assert all(s["host_ms"] is not None for s in spans)
