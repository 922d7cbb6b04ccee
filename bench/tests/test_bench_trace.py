"""The interval union, the per-round split and the metric readers on
made-up records."""

from types import SimpleNamespace

import pytest

from harness import core, peaks, trace


def test_union_of_overlapping_intervals_and_its_gaps():
    busy, gaps = trace.union_busy([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 11)])
    assert busy == pytest.approx(5.0)
    assert gaps == [(3, 5), (6, 10)]


def test_union_of_nothing_is_zero():
    assert trace.union_busy([]) == (0.0, [])


def test_round_split_never_spans_the_profiler_bounds():
    spans = [("mark", "scan_round", 0.5, None), ("mark", "profiler", 0.7, None),
             ("mark", "scan_round", 1.0, None), ("span", "scan_round", 1.0, 3.0),
             ("mark", "scan_round", 5.0, None), ("span", "adopt_batch", 5.5, 6.0),
             ("span", "scan_round", 6.0, 7.0),
             ("mark", "scan_round", 9.0, None),
             ("mark", "profiler", 20.0, None),
             ("mark", "scan_round", 30.0, None), ("span", "scan_round", 30.0, 31.0),
             ("mark", "scan_round", 32.0, None)]
    split = trace.round_split(spans, "scan_round", ("scan_round", "adopt_batch"))
    assert split["periods_ms"] == [4.0, 4.0, 2.0]
    assert split["worker_ms"] == [2.0, 1.5, 1.0]


REC = {"window_s": 2.0, "rounds": 100, "steps_per_round": 8, "step_flops": 1e12,
       "split": {"periods_ms": [10.0, 10.0], "worker_ms": [7.0, 6.0]},
       "forward_ms": [4.0, 6.0],
       "adopt_ms": 75.0, "rounds_spanned": 300,
       "trace": {"busy_s": 0.25, "window_s": 2.0, "syncs": 1000, "rounds": 200, "wall_s": 1.0}}


@pytest.mark.parametrize("name,value", [
    ("sgd.engine_ms", 3.5), ("sgd.adopt_ms", 0.25), ("sgd.forward_ms", 5.0), ("sgd.host_syncs", 5.0),
    ("sgd.device_idle", 87.5), ("sgd.step_mfu", 100 * 1e12 * 8 * 100 / 2.0 / peaks.BF16_FLOPS),
])
def test_readers_on_a_made_up_record(name, value):
    assert core.read_metric(name, REC) == pytest.approx(value)


@pytest.mark.parametrize("name", [m["name"] for m in core.load_manifest()["per_layer"]])
def test_a_reader_that_finds_nothing_returns_nothing(name):
    assert core.read_metric(name, {}) is None


def test_read_profile_takes_the_union_the_syncs_and_names_the_gaps():
    dev = lambda s, e, n: SimpleNamespace(device_type="DeviceType.CUDA", name=n,
                                          time_range=SimpleNamespace(start=s, end=e))
    host = lambda s, e, n: SimpleNamespace(device_type="DeviceType.CPU", name=n,
                                           time_range=SimpleNamespace(start=s, end=e))
    events = [dev(0, 100, "k1"), dev(50, 150, "k2"), dev(400, 500, "k1"), host(0, 1000, "aten::outer"),
              host(160, 390, "cudaStreamSynchronize")]
    got = trace.read_profile(SimpleNamespace(events=lambda: events), window_s=1e-3)
    assert got["busy_s"] == pytest.approx(250e-6)
    assert got["syncs"] == 1
    assert got["breakdown"]["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(250e-6)]]
    assert got["breakdown"]["device_ops"] == [["k1", pytest.approx(200e-6)], ["k2", pytest.approx(100e-6)]]


def test_result_line_is_json_with_the_checks_last_and_text_for_no_number():
    import json

    line = core.result_line(False, 3, 1, {"x": {"value": 1.5, "unit": "s"}}, {"platform": "gpu"},
                            [("a_gap", float("inf"), 1e-5), ("b_gap", 2e-7, 1e-5)])
    out = json.loads(line)
    assert list(out)[-1] == "checks"
    assert out["checks"] == {"a_gap": {"value": "inf", "limit": 1e-5},
                             "b_gap": {"value": 2e-7, "limit": 1e-5}}
