"""The port's round engine held against the JAX reference engine.

  * A deterministic toy worker and its torch twin (after
    ``ShardableToyWorker`` in tests/test_sharded_engine.py): the port's
    ``TMSNEngine`` must match the reference's BIT FOR BIT in
    certificates, history, rounds and counters on the dense buffer, the
    sparse queues (sufficient capacity, and C=1), the sparse control
    plane, and a heterogeneous delay matrix with laggards and fail-stop.
  * Batched Sparrow: the port's own chain dense == sparse == sparse
    control is bit-exact; against the reference engine (the reference's
    draws injected) the history has the same (round, worker) entries and
    the certificates agree to 1e-5.
  * The whole slice — kernel route, sparse queues, sparse control — at
    one small size against the reference running its Pallas kernels.
  * Import hygiene, the ``REPRO_*`` knobs, the deferred mesh and the
    default device. The chaos, membership, publisher and auto-capacity
    features are held against the reference in tests/test_torch_chaos.py.

Every engine config pins its knobs (``fault_spec=""`` included) so the
CI matrix's env legs cannot flip them.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.boosting import BatchedSparrowWorker as JSparrow  # noqa: E402
from repro.boosting import SparrowConfig as JSparrowConfig  # noqa: E402
from repro.boosting.scanner import ScannerConfig as JScannerConfig  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data.splice import SpliceConfig, make_splice_like  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker as TSparrow  # noqa: E402
from repro_torch.boosting.scanner import ScannerConfig as TScannerConfig  # noqa: E402
from repro_torch.boosting.sparrow import SparrowConfig as TSparrowConfig  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"

#: every env-steerable knob, pinned
PINNED = dict(
    fault_spec="", rounds_per_dispatch=1, gossip_mode="dense", cross_pod_every_k=1,
    cross_pod_top_k=1, spare_slots=0, publish_every_k=0, publish_eps=0.0,
)


class JaxToyWorker:
    """Deterministic toy worker: worker i fires every ``period[i]``-th
    segment and its certificate drops to ``-dec[i] * fires``."""

    def __init__(self, period, dec):
        self._period = jnp.asarray(period, jnp.int32)
        self._dec = jnp.asarray(dec, jnp.float32)

    def init_batch(self, n_workers, seed):
        z = jnp.zeros((n_workers,), jnp.int32)
        return {"segs": z, "fires": z, "cert": jnp.zeros((n_workers,), jnp.float32),
                "from": jnp.full((n_workers,), -1, jnp.int32),
                "owner": jnp.arange(n_workers, dtype=jnp.int32), "period": self._period, "dec": self._dec}

    def scan_round(self, state, mask):
        segs = state["segs"] + mask.astype(jnp.int32)
        fired = mask & (segs % state["period"] == 0)
        fires = state["fires"] + fired.astype(jnp.int32)
        own = -state["dec"] * fires
        cert = jnp.where(fired, jnp.minimum(state["cert"], own), state["cert"])
        return dict(state, segs=segs, fires=fires, cert=cert), mask.astype(jnp.float32), fired

    def needs_resample(self, state):
        return jnp.zeros(state["cert"].shape, bool)

    def resample_round(self, state, do):
        return state, jnp.zeros(state["cert"].shape, jnp.float32)

    def certificates(self, state):
        return state["cert"]

    def export_models(self, state):
        return {"owner": state["owner"], "cert": state["cert"], "adopted_from": state["from"]}

    def adopt_batch(self, state, models, certs, take):
        new = dict(state)
        new["cert"] = jnp.where(take, certs, state["cert"])
        new["from"] = jnp.where(take, models["owner"], state["from"])
        return new, jnp.zeros(state["cert"].shape, jnp.float32)

    def payload_bytes(self):
        return 8


class TorchToyWorker:
    """The torch twin of :class:`JaxToyWorker`."""

    def __init__(self, period, dec):
        self._period = torch.tensor(period, dtype=torch.int32)
        self._dec = torch.tensor(dec, dtype=torch.float32)

    def init_batch(self, n_workers, seed):
        z = torch.zeros((n_workers,), dtype=torch.int32)
        return {"segs": z, "fires": z.clone(), "cert": torch.zeros((n_workers,)),
                "from": torch.full((n_workers,), -1, dtype=torch.int32),
                "owner": torch.arange(n_workers, dtype=torch.int32),
                "period": self._period.clone(), "dec": self._dec.clone()}

    def scan_round(self, state, mask):
        segs = state["segs"] + mask.to(torch.int32)
        fired = mask & (segs % state["period"] == 0)
        fires = state["fires"] + fired.to(torch.int32)
        own = -state["dec"] * fires
        cert = torch.where(fired, torch.minimum(state["cert"], own), state["cert"])
        return dict(state, segs=segs, fires=fires, cert=cert), mask.to(torch.float32), fired

    def needs_resample(self, state):
        return torch.zeros(state["cert"].shape, dtype=torch.bool)

    def resample_round(self, state, do):
        return state, torch.zeros(state["cert"].shape)

    def certificates(self, state):
        return state["cert"]

    def export_models(self, state):
        return {"owner": state["owner"], "cert": state["cert"], "adopted_from": state["from"]}

    def adopt_batch(self, state, models, certs, take):
        new = dict(state)
        new["cert"] = torch.where(take, certs, state["cert"])
        new["from"] = torch.where(take, models["owner"], state["from"])
        return new, torch.zeros(state["cert"].shape)

    def payload_bytes(self):
        return 8


def _toy_args(w):
    return [1, 2, 3, 10**9] * (w // 4), [0.01 * (i + 1) for i in range(w)]


def _run_both(w, **cfg):
    cfg = {**PINNED, **cfg}
    period, dec = _toy_args(w)
    jres = jeng.TMSNEngine(JaxToyWorker(period, dec), jeng.EngineConfig(n_workers=w, **cfg)).run()
    tcfg = teng.EngineConfig(n_workers=w, **cfg)
    tres = teng.TMSNEngine(TorchToyWorker(period, dec), tcfg, device=CPU).run()
    return jres, tres


def _assert_bit_exact(jres, tres):
    assert tres.final_certificates == jres.final_certificates
    assert tres.history == jres.history
    assert tres.rounds == jres.rounds
    for f in ("messages_sent", "messages_accepted", "messages_discarded", "messages_evicted",
              "inflight_occupancy_peak", "events_processed", "bytes_broadcast"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.sim_time == jres.sim_time
    assert tres.cost_units_total == jres.cost_units_total
    for a, b in zip(jres.final_models, tres.final_models):
        assert int(a["adopted_from"]) == int(b["adopted_from"])


HET_W = 8
HET = dict(
    delay_rounds=jeng.quantize_latency(0.05, 0.02, 0.01, HET_W, seed=0),
    speed=[1.0, 0.25] * (HET_W // 2),
    fail_round=[10**6] * (HET_W - 1) + [12],
    eps=0.005,
)


class TestToyEngineBitExact:
    """The port's engine vs the reference's, on identical toy workers."""

    def test_dense_inflight(self):
        _assert_bit_exact(*_run_both(8, max_rounds=30, inflight_capacity=0, control_plane="dense",
                                     round_step_impl="ref"))

    def test_dense_with_target_stops_on_the_crossing_round(self):
        jres, tres = _run_both(8, max_rounds=500, inflight_capacity=0, control_plane="dense",
                               round_step_impl="ref", target_certificate=-0.3)
        _assert_bit_exact(jres, tres)
        assert tres.rounds < 500

    @pytest.mark.parametrize("impl", ["ref", "pallas"])
    def test_sparse_sufficient_capacity(self, impl):
        jres, tres = _run_both(8, max_rounds=30, inflight_capacity=8, control_plane="dense",
                               round_step_impl=impl)
        _assert_bit_exact(jres, tres)
        assert tres.messages_evicted == 0 and tres.inflight_occupancy_peak > 0

    def test_sparse_capacity_one_uniform_delay(self):
        jres, tres = _run_both(8, max_rounds=30, inflight_capacity=1, control_plane="dense",
                               round_step_impl="ref")
        _assert_bit_exact(jres, tres)
        assert tres.messages_evicted > 0  # eviction really happened, and matched

    @pytest.mark.parametrize("cap", [0, 8])
    def test_sparse_control(self, cap):
        jres, tres = _run_both(8, max_rounds=30, inflight_capacity=cap, control_plane="sparse",
                               round_step_impl="ref", gossip_top_k=2)
        _assert_bit_exact(jres, tres)

    @pytest.mark.parametrize("cap", [0, 64])
    def test_heterogeneous_delay_laggards_failstop(self, cap):
        jres, tres = _run_both(HET_W, max_rounds=30, inflight_capacity=cap, control_plane="dense",
                               round_step_impl="ref", **HET)
        _assert_bit_exact(jres, tres)


def _eviction_lemma_both(scores):
    """``_queue_push`` at capacity 1 under uniform delay, the port's and
    the reference's on the same scores: the same queue bit for bit and
    the same counters, and every destination keeps the best certificate
    of the other workers (the lemma behind C >= 1 being exact at
    uniform delay)."""
    w = len(scores)
    sc = np.asarray(scores, np.float32)
    jq, *jc = jeng._queue_push(jeng._empty_queue(w, 1), jnp.asarray(sc), jnp.ones((w,), bool), jnp.arange(w),
                               jnp.ones((w, w), jnp.int32), jnp.int32(0), 8)
    tq, *tc = teng._queue_push(teng._empty_queue(w, 1, CPU), torch.from_numpy(sc.copy()),
                               torch.ones((w,), dtype=torch.bool), torch.arange(w, dtype=torch.int32),
                               torch.ones((w, w), dtype=torch.int32), 0, 8)
    for a, b in zip(jq, tq):
        assert np.array_equal(np.asarray(a).view(np.int32) if np.asarray(a).dtype == np.float32 else np.asarray(a),
                              b.numpy().view(np.int32) if b.dtype == torch.float32 else b.numpy())
    assert [int(x) for x in tc] == [int(x) for x in jc]
    kept = tq.cert[:, 0].numpy()
    for dst in range(w):
        assert kept[dst] == min(sc[src] for src in range(w) if src != dst)


def test_eviction_lemma_capacity_one_matches_reference():
    """tests/test_properties.py's eviction property, whose -0.01 bound is
    not a float32 (hypothesis draws no example there), with the float32
    bound, on the port against the reference."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=30)
    @hyp.given(st.lists(st.floats(min_value=-100.0, max_value=float(np.float32(-0.01)), width=32),
                        min_size=2, max_size=12))
    def prop(scores):
        _eviction_lemma_both(scores)

    prop()


@pytest.mark.parametrize("seed", range(6))
def test_eviction_lemma_capacity_one_seeded(seed):
    """The same check on seeded draws (ties and the float32 bound
    included), so it runs where hypothesis is not installed."""
    rng = np.random.default_rng(seed)
    w = int(rng.integers(2, 13))
    pool = np.float32([-100.0, np.float32(-0.01), -1.0, -0.5])
    sc = np.where(rng.random(w) < 0.3, rng.choice(pool, w), rng.uniform(-100.0, -0.01, w)).astype(np.float32)
    _eviction_lemma_both(sc.tolist())


class TestToyEngineChain:
    """The port's own chain on the toy worker: sparse == dense."""

    def _run(self, **cfg):
        period, dec = _toy_args(8)
        cfg = {**PINNED, "max_rounds": 30, "round_step_impl": "pallas", **cfg}
        return teng.TMSNEngine(TorchToyWorker(period, dec), teng.EngineConfig(n_workers=8, **cfg),
                               device=CPU).run()

    def test_sparse_control_equals_dense(self):
        dense = self._run(inflight_capacity=0, control_plane="dense")
        for cfg in (dict(inflight_capacity=8, control_plane="dense"),
                    dict(inflight_capacity=8, control_plane="sparse"),
                    dict(inflight_capacity=0, control_plane="sparse")):
            other = self._run(**cfg)
            assert other.final_certificates == dense.final_certificates, cfg
            assert other.history == dense.history, cfg

    def test_rounds_per_dispatch_changes_nothing(self):
        a = self._run(inflight_capacity=8, control_plane="sparse", rounds_per_dispatch=1)
        b = self._run(inflight_capacity=8, control_plane="sparse", rounds_per_dispatch=7)
        assert a.history == b.history and a.final_certificates == b.final_certificates


# ---------------------------------------------------------------------------
# batched Sparrow
# ---------------------------------------------------------------------------


def jax_uniforms(stream: int, draw: int) -> float:
    """The reference's j-th minimal-variance offset of a worker stream."""
    k = jax.random.PRNGKey(stream)
    for _ in range(draw):
        k = jax.random.split(k)[0]
    return float(jax.random.uniform(jax.random.split(k)[1]))


@pytest.fixture(scope="module")
def splice():
    xb, y, _ = make_splice_like(SpliceConfig(n=2400, d=16, num_bins=8, seed=3))
    return np.asarray(xb), np.asarray(y)


def _sparrow_pair(splice, use_kernel, w=4):
    xb, y = splice
    # a low target edge and a high ESS threshold: fires, adoptions and
    # resamples all happen within the few rounds these tests run
    sc = dict(chunk_size=128, num_bins=8, gamma0=0.05, use_kernel=use_kernel)
    base = dict(sample_size=400, capacity=32, n_workers=w, ess_threshold=0.95)
    jw = JSparrow(jnp.asarray(xb), jnp.asarray(y), JSparrowConfig(scanner=JScannerConfig(**sc), **base))
    txb, ty = convert.dataset_from_numpy(xb, y, CPU)
    tw = TSparrow(txb, ty, TSparrowConfig(scanner=TScannerConfig(**sc), **base), device=CPU,
                  uniforms=jax_uniforms)
    return jw, tw


def _assert_close_runs(jres, tres):
    assert [h[:2] for h in tres.history] == [h[:2] for h in jres.history]
    np.testing.assert_allclose([h[2] for h in tres.history], [h[2] for h in jres.history],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tres.final_certificates, jres.final_certificates, rtol=1e-5, atol=1e-6)
    assert tres.rounds == jres.rounds
    for f in ("messages_sent", "messages_accepted", "messages_discarded", "messages_evicted"):
        assert getattr(tres, f) == getattr(jres, f), f


def test_sparrow_engine_matches_reference(splice):
    """The port's engine on batched Sparrow vs the reference's (plain
    paths on both sides), 30 rounds with resamples and adoptions."""
    jw, tw = _sparrow_pair(splice, use_kernel=False)
    cfg = dict(PINNED, n_workers=4, max_rounds=30, inflight_capacity=0, control_plane="dense",
               round_step_impl="ref", rounds_per_dispatch=30)
    jres = jeng.TMSNEngine(jw, jeng.EngineConfig(**cfg)).run()
    tres = teng.TMSNEngine(tw, teng.EngineConfig(**cfg), device=CPU).run()
    _assert_close_runs(jres, tres)
    assert tres.messages_accepted > 0
    assert sum(int(m.count) for m in tres.final_models) > 0


def test_whole_slice_matches_reference(splice):
    """The slice's configuration — scanner on kernel K1, sparse queues
    with kernel K2, sparse control with kernel K3 — against the reference
    running its own Pallas kernels (interpret mode), at one small size."""
    jw, tw = _sparrow_pair(splice, use_kernel=True)
    cfg = dict(PINNED, n_workers=4, max_rounds=20, inflight_capacity=64, control_plane="sparse",
               round_step_impl="pallas", rounds_per_dispatch=20)
    jres = jeng.TMSNEngine(jw, jeng.EngineConfig(**cfg)).run()
    tops.reset_launches()
    tres = teng.TMSNEngine(tw, teng.EngineConfig(**cfg), device=CPU).run()
    _assert_close_runs(jres, tres)
    assert tres.messages_evicted == 0
    # on CPU tensors the wrappers take the plain versions: no launches
    assert tops.LAUNCHES == {"edge_scan": 0, "round_step": 0, "queue_ingest": 0, "weight_update": 0,
                             "adamw_step": 0, "attention_fwd": 0, "attention_bwd": 0}


def test_sparrow_chain_dense_sparse_control_bit_exact(splice):
    """The port's own chain on batched Sparrow: dense in-flight ==
    sparse queues == sparse control, bit for bit."""
    _, tw = _sparrow_pair(splice, use_kernel=True)
    runs = []
    for cap, plane in ((0, "dense"), (16, "dense"), (16, "sparse"), (0, "sparse")):
        cfg = dict(PINNED, n_workers=4, max_rounds=40, inflight_capacity=cap, control_plane=plane,
                   round_step_impl="pallas")
        runs.append(teng.TMSNEngine(tw, teng.EngineConfig(**cfg), device=CPU).run())
    for other in runs[1:]:
        assert other.final_certificates == runs[0].final_certificates
        assert other.history == runs[0].history
        assert other.messages_evicted == 0


# ---------------------------------------------------------------------------
# config, deferred features, device, imports
# ---------------------------------------------------------------------------


def test_engine_config_fields_and_defaults_match_reference(monkeypatch):
    for var in ("REPRO_ROUNDS_PER_DISPATCH", "REPRO_GOSSIP_MODE", "REPRO_CROSS_POD_EVERY_K",
                "REPRO_CROSS_POD_TOP_K", "REPRO_INFLIGHT_CAPACITY", "REPRO_ROUND_STEP_IMPL",
                "REPRO_CONTROL_PLANE", "REPRO_SPARE_SLOTS", "REPRO_FAULT_PLAN",
                "REPRO_PUBLISH_EVERY_K", "REPRO_PUBLISH_EPS"):
        monkeypatch.delenv(var, raising=False)
    jf = [(f.name) for f in dataclasses.fields(jeng.EngineConfig)]
    tf = [(f.name) for f in dataclasses.fields(teng.EngineConfig)]
    assert tf == jf
    assert dataclasses.asdict(teng.EngineConfig()) == dataclasses.asdict(jeng.EngineConfig())


def test_env_knobs_read_the_same(monkeypatch):
    """One CI matrix drives both packages: the same REPRO_* values give
    the same config, and the same malformed values the same errors."""
    monkeypatch.setenv("REPRO_INFLIGHT_CAPACITY", "64")
    monkeypatch.setenv("REPRO_CONTROL_PLANE", "sparse")
    monkeypatch.setenv("REPRO_PUBLISH_EPS", "0.25")
    assert dataclasses.asdict(teng.EngineConfig()) == dataclasses.asdict(jeng.EngineConfig())
    for var, bad in (("REPRO_INFLIGHT_CAPACITY", "many"), ("REPRO_PUBLISH_EPS", "x"),
                     ("REPRO_ROUNDS_PER_DISPATCH", "1.5")):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError) as je:
            jeng.EngineConfig()
        with pytest.raises(ValueError) as te:
            teng.EngineConfig()
        assert str(te.value) == str(je.value)
        monkeypatch.delenv(var)
    for spec in ("drop=5,seed=3", "drop=0", "bogus=1", "drop=101", "part=x:2", "drop"):
        try:
            want = jeng._parse_fault_spec(spec)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                teng._parse_fault_spec(spec)
        else:
            got = teng._parse_fault_spec(spec)
            assert (got is None) == (want is None)
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_invalid_configs_raise_like_reference():
    period, dec = _toy_args(4)
    for bad in (dict(gossip_mode="x"), dict(gossip_top_k=0), dict(rounds_per_dispatch=0),
                dict(inflight_capacity=-1), dict(inflight_capacity="big"), dict(round_step_impl="x"),
                dict(control_plane="x"), dict(publish_every_k=-1), dict(delay_rounds=np.ones((3, 3))),
                dict(speed=[1.0, 2.0]), dict(fail_round=[1, 2])):
        cfg = {**PINNED, **bad}
        with pytest.raises(ValueError):
            jeng.TMSNEngine(JaxToyWorker(period, dec), jeng.EngineConfig(n_workers=4, **cfg))
        with pytest.raises(ValueError):
            teng.TMSNEngine(TorchToyWorker(period, dec), teng.EngineConfig(n_workers=4, **cfg), device=CPU)


def test_publisher_and_mesh_deferred():
    """The publisher is ported (it needs publish_every_k >= 1, as in the
    reference). Nothing about meshes is deferred any more: both sharded
    engines are ported. As in the reference, ``TMSNEngine`` itself takes
    a config with a (pod, workers) mesh (the mesh is the factory's
    concern), a (workers, pod) axis order and a mesh with no ``workers``
    axis raise the reference's ValueErrors, text for text."""
    period, dec = _toy_args(4)
    eng = teng.TMSNEngine(TorchToyWorker(period, dec), teng.EngineConfig(n_workers=4, **PINNED), device=CPU)
    with pytest.raises(ValueError, match="publish_every_k >= 1"):
        eng.attach_publisher(object())

    class PodMesh:
        size, axis_names, shape = 4, ("pod", "workers"), {"pod": 2, "workers": 2}

    assert type(jeng.TMSNEngine(JaxToyWorker(period, dec),
                                jeng.EngineConfig(n_workers=4, mesh=PodMesh(), **PINNED))) is jeng.TMSNEngine
    eng = teng.TMSNEngine(TorchToyWorker(period, dec), teng.EngineConfig(n_workers=4, mesh=PodMesh(), **PINNED),
                          device=CPU)
    assert type(eng) is teng.TMSNEngine

    class BadPodOrder:
        size, axis_names = 4, ("workers", "pod")

    with pytest.raises(ValueError) as je:
        jeng.make_engine(JaxToyWorker(period, dec),
                         jeng.EngineConfig(n_workers=4, mesh=BadPodOrder(), **PINNED))
    with pytest.raises(ValueError) as te:
        teng.make_engine(TorchToyWorker(period, dec),
                         teng.EngineConfig(n_workers=4, mesh=BadPodOrder(), **PINNED), device=CPU)
    assert str(te.value) == str(je.value) == (
        "engine mesh must have axes ('workers',) or ('pod', 'workers'), got ('workers', 'pod')")

    class DataMesh:
        size, axis_names = 4, ("data",)

    with pytest.raises(ValueError) as je:
        jeng.make_engine(JaxToyWorker(period, dec), jeng.EngineConfig(n_workers=4, mesh=DataMesh(), **PINNED))
    with pytest.raises(ValueError) as te:
        teng.make_engine(TorchToyWorker(period, dec), teng.EngineConfig(n_workers=4, mesh=DataMesh(), **PINNED),
                         device=CPU)
    assert str(te.value) == str(je.value) == "engine mesh needs a 'workers' axis, got ('data',)"


def test_entry_points_default_to_cuda_and_raise_without_it(splice):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.data.splice import make_splice_like as t_make

    xb, y = splice
    with pytest.raises(RuntimeError, match="cuda"):
        t_make(SpliceConfig(n=100, d=4))
    with pytest.raises(RuntimeError, match="cuda"):
        TSparrow(torch.from_numpy(xb.copy()), torch.from_numpy(y.copy()), TSparrowConfig(sample_size=100))
    period, dec = _toy_args(4)
    with pytest.raises(RuntimeError, match="cuda"):
        teng.TMSNEngine(TorchToyWorker(period, dec), teng.EngineConfig(n_workers=4, **PINNED))


def test_port_imports_neither_jax_nor_the_reference():
    """Import every module of the port in a fresh interpreter: neither
    ``jax`` nor ``repro`` may load."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(REPO / "src" / "repro_torch").with_suffix("").parts)
        for p in (REPO / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) >= 15


def test_port_sources_never_mention_the_reference_imports():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import repro\.|from repro\.|import repro$|from repro import)", re.MULTILINE
    )
    files = list((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [str(p) for p in files if pattern.search(p.read_text())]
    assert not hits, hits
