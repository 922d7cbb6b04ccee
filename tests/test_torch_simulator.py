"""The port's event-simulator path held against the JAX reference.

  * ``core/simulator.py::TMSNSimulator`` on the reference's own
    ``ToySimWorker`` (tests/test_engine.py) and its torch twin: history,
    final certificates and counters equal the reference's EXACTLY.
  * The port's simulator against the port's ``TMSNEngine``, mirroring
    tests/test_engine.py::TestEngineSimulatorEquivalence: exact.
  * ``boosting/sparrow.py::SparrowWorker`` against the reference's,
    segment by segment from the same state with the reference's draws
    injected: scan (fire decisions exactly, certificates and margins at
    rtol 1e-4 / atol 1e-5), a forced resample and ``adopt``.
  * The port's ``SparrowWorker`` against the port's
    ``BatchedSparrowWorker``, mirroring tests/test_engine.py::
    test_scan_segments_match_unbatched and test_resample_path_matches_unbatched.
  * A whole small simulator run and a ``run_bsp_baseline`` run against
    the reference: the same history keys, certificates allclose 1e-5.

The data is the reference's, handed to both packages as numpy arrays.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.boosting import SparrowConfig as JSparrowConfig  # noqa: E402
from repro.boosting import SparrowWorker as JSparrowWorker  # noqa: E402
from repro.boosting.scanner import ScannerConfig as JScannerConfig  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.data.splice import SpliceConfig, make_splice_like, train_test_split  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker as TBatched  # noqa: E402
from repro_torch.boosting.scanner import ScannerConfig as TScannerConfig  # noqa: E402
from repro_torch.boosting.sparrow import SparrowConfig as TSparrowConfig  # noqa: E402
from repro_torch.boosting.sparrow import SparrowWorker as TSparrowWorker  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_engine import ToySimWorker  # noqa: E402  (the reference's own toy)

CPU = "cpu"

#: every env-steerable engine knob, pinned
PINNED = dict(
    fault_spec="", rounds_per_dispatch=1, gossip_mode="dense", cross_pod_every_k=1,
    cross_pod_top_k=1, spare_slots=0, publish_every_k=0, publish_eps=0.0,
)


# ---------------------------------------------------------------------------
# toy workers
# ---------------------------------------------------------------------------


class TorchToySimWorker:
    """The torch twin of tests/test_engine.py::ToySimWorker: worker i
    fires every ``period[i]``-th segment, its own certificate after f
    fires is ``-dec[i] * f`` in float32, adoption takes the incoming one."""

    def __init__(self, period, dec):
        self.period = list(period)
        self.dec = torch.tensor(dec, dtype=torch.float32)

    def init_state(self, worker_id, seed):
        return {"wid": worker_id, "segs": 0, "fires": 0, "cert": 0.0, "from": -1}

    def run_segment(self, s):
        s = dict(s)
        s["segs"] += 1
        fired = s["segs"] % self.period[s["wid"]] == 0
        if fired:
            s["fires"] += 1
            own = float(-(self.dec[s["wid"]] * s["fires"]))
            s["cert"] = min(s["cert"], own)
        return s, 1.0, fired

    def certificate(self, s):
        return s["cert"]

    def export_model(self, s):
        return {"owner": s["wid"], "cert": s["cert"]}

    def adopt(self, s, model, certificate):
        s = dict(s)
        s["cert"] = float(certificate)
        s["from"] = int(model["owner"])
        return s

    def payload_bytes(self, model):
        return 8


class TorchToyBatchedWorker:
    """The torch twin of tests/test_engine.py::ToyBatchedWorker."""

    def __init__(self, period, dec):
        self.period = torch.tensor(period, dtype=torch.int32)
        self.dec = torch.tensor(dec, dtype=torch.float32)

    def init_batch(self, n_workers, seed):
        z = torch.zeros((n_workers,), dtype=torch.int32)
        return {"segs": z, "fires": z.clone(), "cert": torch.zeros((n_workers,)),
                "from": torch.full((n_workers,), -1, dtype=torch.int32)}

    def scan_round(self, state, mask):
        segs = state["segs"] + mask.to(torch.int32)
        fired = mask & (segs % self.period == 0)
        fires = state["fires"] + fired.to(torch.int32)
        cert = torch.where(fired, torch.minimum(state["cert"], -self.dec * fires), state["cert"])
        return dict(state, segs=segs, fires=fires, cert=cert), mask.to(torch.float32), fired

    def certificates(self, state):
        return state["cert"]

    def export_models(self, state):
        w = state["cert"].shape[0]
        return {"owner": torch.arange(w, dtype=torch.int32), "cert": state["cert"],
                "adopted_from": state["from"]}

    def adopt_batch(self, state, models, certs, take):
        new = dict(state)
        new["cert"] = torch.where(take, certs, state["cert"])
        new["from"] = torch.where(take, models["owner"], state["from"])
        return new, torch.zeros(state["cert"].shape)

    def payload_bytes(self):
        return 8


def _sims(period, dec, specs, **cfg):
    jres = jsim.TMSNSimulator(
        ToySimWorker(period, dec), [jsim.WorkerSpec(**s) for s in specs], jsim.SimulatorConfig(**cfg)
    ).run()
    tres = tsim.TMSNSimulator(
        TorchToySimWorker(period, dec), [tsim.WorkerSpec(**s) for s in specs], tsim.SimulatorConfig(**cfg)
    ).run()
    return jres, tres


TOY_CASES = {
    "zero_latency_target": (
        [1, 10**9, 10**9, 10**9], [0.1] * 4, [{}] * 4,
        dict(n_workers=4, base_latency=0.0, latency_jitter=0.0, target_certificate=-0.95, max_events=10_000),
    ),
    "jitter_laggard_failstop": (
        [1, 2, 3, 1, 5], [0.01, 0.03, 0.02, 0.015, 0.05],
        [{}, {"speed": 0.25}, {}, {"fail_at": 7.5}, {"speed": 0.5}],
        dict(n_workers=5, max_events=600, seed=3, snapshot_every=50),
    ),
    "eps_gate": (
        [1, 1, 2, 3], [0.01, 0.02, 0.05, 0.04], [{}] * 4,
        dict(n_workers=4, eps=0.03, max_events=400, seed=1, max_time=50.0),
    ),
}


@pytest.mark.parametrize("case", sorted(TOY_CASES))
def test_toy_simulator_matches_reference_exactly(case):
    period, dec, specs, cfg = TOY_CASES[case]
    jres, tres = _sims(period, dec, specs, **cfg)
    assert tres.history == jres.history
    assert tres.final_certificates == jres.final_certificates
    for f in ("messages_sent", "messages_accepted", "messages_discarded", "bytes_broadcast",
              "sim_time", "cost_units_total", "events_processed"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert [m["owner"] for m in tres.final_models] == [m["owner"] for m in jres.final_models]
    assert [(t, c) for t, c, _ in tres.snapshots] == [(t, c) for t, c, _ in jres.snapshots]
    assert tres.messages_accepted > 0


def test_toy_bsp_matches_reference_exactly():
    period, dec = [1, 2, 3, 4], [0.01, 0.03, 0.02, 0.05]
    specs = [{}, {"speed": 0.5}, {"fail_at": 4.0}, {}]
    cfg = dict(n_workers=4, eps=0.005)
    jres = jsim.run_bsp_baseline(ToySimWorker(period, dec), [jsim.WorkerSpec(**s) for s in specs],
                                 jsim.SimulatorConfig(**cfg), rounds=12)
    tres = tsim.run_bsp_baseline(TorchToySimWorker(period, dec), [tsim.WorkerSpec(**s) for s in specs],
                                 tsim.SimulatorConfig(**cfg), rounds=12)
    assert tres.history == jres.history
    assert tres.final_certificates == jres.final_certificates
    assert tres.wait_time == jres.wait_time
    assert (tres.messages_sent, tres.sim_time, tres.cost_units_total) == (
        jres.messages_sent, jres.sim_time, jres.cost_units_total)


class TestEngineSimulatorEquivalence:
    """Mirrors tests/test_engine.py::TestEngineSimulatorEquivalence on the
    port's own simulator and engine."""

    def test_single_sender_identical_final_certificates(self):
        w, period, dec, target = 4, [1, 10**9, 10**9, 10**9], [0.1] * 4, -0.95
        res_sim = tsim.TMSNSimulator(
            TorchToySimWorker(period, dec), [tsim.WorkerSpec(speed=1.0) for _ in range(w)],
            tsim.SimulatorConfig(n_workers=w, base_latency=0.0, latency_jitter=0.0,
                                 target_certificate=target, max_events=10_000, seed=0),
        ).run()
        res_eng = teng.TMSNEngine(
            TorchToyBatchedWorker(period, dec),
            teng.EngineConfig(n_workers=w, delay_rounds=1, target_certificate=target, max_rounds=500,
                              **PINNED),
            device=CPU,
        ).run()
        assert res_eng.final_certificates == res_sim.final_certificates
        np.testing.assert_allclose(res_sim.final_certificates, [-1.0, -0.9, -0.9, -0.9], atol=1e-6)
        assert res_eng.rounds == 10
        assert res_eng.messages_sent == res_sim.messages_sent == 30
        assert res_eng.messages_accepted == res_sim.messages_accepted == 27
        assert res_eng.messages_discarded == res_sim.messages_discarded == 0
        assert [int(m["adopted_from"]) for m in res_eng.final_models[1:]] == [0, 0, 0]
        assert [m["owner"] for m in res_sim.final_models] == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the unbatched Sparrow worker
# ---------------------------------------------------------------------------


def jax_uniforms(stream: int, draw: int) -> float:
    """The reference's j-th minimal-variance offset of a worker stream:
    ``k_0 = PRNGKey(stream)``, ``k_{j+1} = split(k_j)[0]``, offset
    ``uniform(split(k_j)[1])``."""
    k = jax.random.PRNGKey(stream)
    for _ in range(draw):
        k = jax.random.split(k)[0]
    return float(jax.random.uniform(jax.random.split(k)[1]))


@pytest.fixture(scope="module")
def small_data():
    xb, y, _ = make_splice_like(SpliceConfig(n=3000, d=16, num_bins=8, seed=3))
    return tuple(np.asarray(a) for a in train_test_split(xb, y))


def _cfgs(w, use_kernel=False, **kw):
    sc = dict(chunk_size=256, num_bins=8, gamma0=0.25, use_kernel=use_kernel)
    base = dict(sample_size=600, capacity=32, n_workers=w)
    base.update(kw)
    return (JSparrowConfig(scanner=JScannerConfig(**sc), **base),
            TSparrowConfig(scanner=TScannerConfig(**sc), **base))


def _pair(data, w, use_kernel=False, **kw):
    xtr, ytr = data[0], data[1]
    jcfg, tcfg = _cfgs(w, use_kernel, **kw)
    jw = JSparrowWorker(jnp.asarray(xtr), jnp.asarray(ytr), jcfg)
    txb, ty = convert.dataset_from_numpy(xtr, ytr, CPU)
    return jw, TSparrowWorker(txb, ty, tcfg, device=CPU, uniforms=jax_uniforms)


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def _assert_state_close(js, ts):
    for f in ("feat", "thr", "count", "sign"):
        np.testing.assert_array_equal(_np(getattr(ts.model, f)), np.asarray(getattr(js.model, f)), f)
    np.testing.assert_allclose(_np(ts.model.alpha), np.asarray(js.model.alpha), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.cert, float(js.cert), rtol=1e-4, atol=1e-5)
    for f in ("needs_resample", "fires", "resamples", "sample_model_count"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.draws == js.resamples + 1
    for f in ("xb", "y", "t_l"):
        np.testing.assert_array_equal(_np(getattr(ts.sample, f)), np.asarray(getattr(js.sample, f)), f)
    for f in ("margin_l", "margin_s"):
        np.testing.assert_allclose(_np(getattr(ts.sample, f)), np.asarray(getattr(js.sample, f)),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(ts.disk_margin), np.asarray(js.disk_margin), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_np(ts.disk_t), np.asarray(js.disk_t))
    np.testing.assert_array_equal(_np(ts.scanner.pos), np.asarray(js.scanner.pos))
    np.testing.assert_allclose(_np(ts.scanner.gamma), np.asarray(js.scanner.gamma), rtol=1e-6)
    np.testing.assert_allclose(_np(ts.scanner.hist), np.asarray(js.scanner.hist), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.pending_cost, js.pending_cost, rtol=1e-6)
    np.testing.assert_allclose(ts.scan_since_resample, js.scan_since_resample, rtol=1e-6)


def _resync(js, seed):
    return convert.sparrow_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), seed, CPU)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_route"])
def test_sparrow_worker_segment_by_segment(small_data, use_kernel):
    """From the same state each segment is held against the reference's:
    scans with fires, resamples forced by ``ess_threshold=0.9``, and
    adoption of the other worker's model. The port's state is re-made
    from the reference's after each segment, so no drift accumulates."""
    jw, tw = _pair(small_data, 2, use_kernel, ess_threshold=0.9)
    seeds = [0, 1000]
    js = [jw.init_state(i, s) for i, s in enumerate(seeds)]
    ts = [tw.init_state(i, s) for i, s in enumerate(seeds)]
    for i in range(2):
        _assert_state_close(js[i], ts[i])  # the same draw gives the same sample
    fired = resampled = adopted = 0
    for seg in range(24 if use_kernel else 40):
        for i in range(2):
            resampled += js[i].needs_resample
            js[i], jc, jf = jw.run_segment(js[i])
            ts[i], tc, tf = tw.run_segment(ts[i])
            assert tf == jf
            np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-3)
            _assert_state_close(js[i], ts[i])
            fired += jf
        lo, hi = sorted(range(2), key=lambda i: float(js[i].cert))
        if seg % 6 == 5 and float(js[lo].cert) < float(js[hi].cert):
            # the worse worker adopts the better one's model
            cert = float(js[lo].cert)
            js[hi] = jw.adopt(js[hi], js[lo].model, cert)
            ts[hi] = tw.adopt(ts[hi], ts[lo].model, cert)
            _assert_state_close(js[hi], ts[hi])
            adopted += 1
        ts = [_resync(js[i], seeds[i]) for i in range(2)]
    assert fired and resampled and adopted


def test_sparrow_worker_hooks_and_device(small_data):
    jw, tw = _pair(small_data, 2)
    js, ts = jw.init_state(1, 1000), tw.init_state(1, 1000)
    assert tw.payload_bytes(tw.export_model(ts)) == jw.payload_bytes(jw.export_model(js))
    assert tw.certificate(ts) == 0.0 and ts.stream == 1000 and ts.draws == 1
    np.testing.assert_array_equal(_np(tw.feature_mask(1)), np.asarray(jw.feature_mask(1)))
    if not torch.cuda.is_available():
        xtr, ytr = small_data[0], small_data[1]
        with pytest.raises(RuntimeError, match="cuda"):
            TSparrowWorker(torch.from_numpy(xtr.copy()), torch.from_numpy(ytr.copy()),
                           TSparrowConfig(sample_size=100))


# ---------------------------------------------------------------------------
# unbatched vs batched, inside the port
# ---------------------------------------------------------------------------


def _port_pair(data, w, **kw):
    xtr, ytr = data[0], data[1]
    _, tcfg = _cfgs(w, **kw)
    txb, ty = convert.dataset_from_numpy(xtr, ytr, CPU)
    return (TBatched(txb, ty, tcfg, device=CPU, uniforms=jax_uniforms),
            TSparrowWorker(txb, ty, tcfg, device=CPU, uniforms=jax_uniforms))


def test_scan_segments_match_batched(small_data):
    """40 scan segments, 3 workers: certificates, models and sample
    margins of the unbatched worker match the batched worker's rows."""
    w = 3
    bw, uw = _port_pair(small_data, w, ess_threshold=0.0)
    bstate = bw.init_batch(w, 0)
    ustates = [uw.init_state(i, 1000 * i) for i in range(w)]
    for i in range(w):
        assert torch.equal(bstate.sample.xb[i], ustates[i].sample.xb)
    mask = torch.ones((w,), dtype=torch.bool)
    for _ in range(40):
        bstate, _, _ = bw.scan_round(bstate, mask)
        ustates = [uw.run_segment(s)[0] for s in ustates]
    np.testing.assert_allclose(bstate.cert.numpy(), np.asarray([s.cert for s in ustates], np.float32),
                               rtol=1e-5, atol=1e-6)
    for i in range(w):
        assert int(bstate.model.count[i]) == int(ustates[i].model.count) > 0
        assert torch.equal(bstate.model.feat[i], ustates[i].model.feat)
        np.testing.assert_allclose(bstate.model.alpha[i].numpy(), ustates[i].model.alpha.numpy(), rtol=1e-5)
        np.testing.assert_allclose(bstate.sample.margin_l[i].numpy(), ustates[i].sample.margin_l.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_resample_path_matches_batched(small_data):
    """An aggressive ESS threshold forces resamples; the unbatched redraw
    matches the batched one (same stream, same systematic sampler)."""
    w = 2
    bw, uw = _port_pair(small_data, w, ess_threshold=0.9)
    bstate = bw.init_batch(w, 0)
    ustates = [uw.init_state(i, 1000 * i) for i in range(w)]
    mask = torch.ones((w,), dtype=torch.bool)
    for _ in range(80):
        need = bw.needs_resample(bstate)
        if bool(need.any()):
            bstate, _ = bw.resample_round(bstate, need)
            bstate, _, _ = bw.scan_round(bstate, mask & ~need)
        else:
            bstate, _, _ = bw.scan_round(bstate, mask)
        ustates = [uw.run_segment(s)[0] for s in ustates]
    assert int(bstate.resamples.sum()) >= 1
    assert bstate.resamples.tolist() == [s.resamples for s in ustates]
    np.testing.assert_allclose(bstate.cert.numpy(), np.asarray([s.cert for s in ustates], np.float32),
                               rtol=1e-4, atol=1e-5)
    for i in range(w):
        assert torch.equal(bstate.sample.xb[i], ustates[i].sample.xb)


# ---------------------------------------------------------------------------
# whole runs against the reference
# ---------------------------------------------------------------------------


def _assert_runs_close(jres, tres):
    assert [h[:2] for h in tres.history] == [h[:2] for h in jres.history]
    np.testing.assert_allclose([h[2] for h in tres.history], [h[2] for h in jres.history],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tres.final_certificates, jres.final_certificates, rtol=1e-5, atol=1e-6)
    for f in ("messages_sent", "messages_accepted", "messages_discarded", "events_processed"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.sim_time == pytest.approx(jres.sim_time, rel=1e-12)


def test_simulator_run_matches_reference(small_data):
    """Three Sparrow workers, one a 10x laggard, through both simulators:
    the same history keys, certificates allclose 1e-5."""
    jw, tw = _pair(small_data, 3, ess_threshold=0.5)
    specs = [{}, {}, {"speed": 0.1}]
    cfg = dict(n_workers=3, max_events=150, eps=0.0)
    jres = jsim.TMSNSimulator(jw, [jsim.WorkerSpec(**s) for s in specs], jsim.SimulatorConfig(**cfg)).run()
    tops.reset_launches()
    tres = tsim.TMSNSimulator(tw, [tsim.WorkerSpec(**s) for s in specs], tsim.SimulatorConfig(**cfg)).run()
    _assert_runs_close(jres, tres)
    assert tres.messages_accepted > 0
    assert tops.LAUNCHES["edge_scan"] == 0  # CPU tensors: plain versions, no launch


def test_bsp_baseline_matches_reference(small_data):
    jw, tw = _pair(small_data, 3, ess_threshold=0.5)
    specs = [{}, {}, {"speed": 0.1}]
    jres = jsim.run_bsp_baseline(jw, [jsim.WorkerSpec(**s) for s in specs], jsim.SimulatorConfig(n_workers=3),
                                 rounds=15)
    tres = tsim.run_bsp_baseline(tw, [tsim.WorkerSpec(**s) for s in specs], tsim.SimulatorConfig(n_workers=3),
                                 rounds=15)
    _assert_runs_close(jres, tres)
    np.testing.assert_allclose(tres.wait_time, jres.wait_time, rtol=1e-12)
    assert min(tres.final_certificates) < 0


def test_simulator_config_fields_match_reference():
    for jcls, tcls in ((jsim.SimulatorConfig, tsim.SimulatorConfig), (jsim.WorkerSpec, tsim.WorkerSpec)):
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())
    with pytest.raises(ValueError):
        tsim.TMSNSimulator(TorchToySimWorker([1], [0.1]), [tsim.WorkerSpec()],
                           tsim.SimulatorConfig(n_workers=2))
