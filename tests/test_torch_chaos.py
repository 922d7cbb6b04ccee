"""The port's chaos, membership, publisher and auto-capacity features
held against the JAX reference engine (``tests/test_chaos.py``,
``tests/test_serving.py::TestAdoptionSlot``).

  * The fault hash and unit element by element, ``_inject_faults`` on
    seeded blocks for every plan field, ``_parse_fault_spec`` and the
    validation errors, text for text.
  * Every single-device scenario of tests/test_chaos.py on the toy
    worker, the port's engine against the reference's BIT FOR BIT
    (certificates, history, rounds and every counter), on the dense
    buffer, the queues (C = 16), sparse control (``gossip_top_k = W``) on
    the queues and on the dense buffer; then the exact claims of
    tests/test_chaos.py on the port's own runs.
  * The publisher: the published (round, cert, params) sequences equal
    the reference's; the port's ``AdoptionSlot`` as the reference pins it.
  * Batched Sparrow under a composed plan with a join and a publisher,
    the reference's draws injected, to 1e-5.
  * The two fault properties of tests/test_properties.py, with
    strategy bounds float32 can represent, on the port and the reference.
  * The ``pod-mesh`` substrate of tests/test_chaos.py (the dense buffer
    on a world of 4 CPU ranks in 2 pods): the same exact claims, the
    partition window dropping cross-pod traffic, and a W = 16 partition
    run against the reference pod engine's figures.

Every config pins its env knobs (``fault_spec=""`` included).
"""

import dataclasses
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.serving import AdoptionSlot, Snapshot  # noqa: E402
from test_chaos import DEC, PERIOD, ROUNDS, W  # noqa: E402
from test_torch_engine import (  # noqa: E402
    PINNED,
    JaxToyWorker,
    TorchToyWorker,
    _assert_close_runs,
    _sparrow_pair,
)
from test_torch_sharded_reference import CHAOS_DEC, CHAOS_PERIOD, POD_FIGURES  # noqa: E402

CPU = "cpu"
#: the substrates of tests/test_chaos.py that need no mesh, plus sparse
#: control over the dense buffer (the faulted ``_dense_push_candidates``)
SUBSTRATES = {
    "dense": dict(inflight_capacity=0),
    "queues": dict(inflight_capacity=16),
    "sparse_control": dict(inflight_capacity=16, control_plane="sparse", gossip_top_k=W),
    "sparse_control_dense": dict(inflight_capacity=0, control_plane="sparse", gossip_top_k=W),
}
SPARES = dict(spare_slots=2)


def _plan(module, **kw):
    return module.FaultPlan(**kw)


def _membership(module, joins=(), leaves=()):
    return module.MembershipPlan(joins=joins, leaves=leaves)


def _fail_at_zero():
    fail = np.full(W, ROUNDS + 1, dtype=np.int64)
    fail[W - 2 :] = 0
    return fail


def _fail_in_warmup():
    fail = np.full(W, ROUNDS + 1, dtype=np.int64)
    fail[:2] = 3
    return fail


#: name -> config in terms of the engine module ``m`` (jeng or teng)
SCENARIOS = {}
for sub, kw in SUBSTRATES.items():
    SCENARIOS[f"plain-{sub}"] = lambda m, kw=kw: dict(kw)
    SCENARIOS[f"join_k1-{sub}"] = lambda m, kw=kw: dict(
        kw, spare_slots=1, membership=_membership(m, joins=((1, W - 1),)))
    SCENARIOS[f"drop-{sub}"] = lambda m, kw=kw: dict(kw, fault_plan=_plan(m, drop_prob=0.3, seed=7))
    SCENARIOS[f"dup-{sub}"] = lambda m, kw=kw: dict(kw, fault_plan=_plan(m, duplicate_prob=0.5, seed=5))
    SCENARIOS[f"corrupt-{sub}"] = lambda m, kw=kw: dict(kw, fault_plan=_plan(m, corrupt_prob=0.5, seed=3))
    if kw["inflight_capacity"]:
        SCENARIOS[f"reorder-{sub}"] = lambda m, kw=kw: dict(
            kw, fault_plan=_plan(m, reorder_max=2, seed=11))
SCENARIOS.update({
    "mid_run_join": lambda m: dict(SPARES, membership=_membership(m, joins=((6, 6), (10, 7)))),
    "spares_idle": lambda m: dict(SPARES),
    "failstop_at_zero": lambda m: dict(fail_round=_fail_at_zero()),
    "churn": lambda m: dict(SPARES, membership=_membership(m, joins=((6, 6), (12, 7)), leaves=((8, 0), (14, 6)))),
    "churn-queues": lambda m: dict(
        SPARES, inflight_capacity=16,
        membership=_membership(m, joins=((6, 6), (10, 7)), leaves=((12, 1),))),
    # laggards: a joiner's credit, accrued while masked, restarts at 0
    "churn-laggards": lambda m: dict(
        SPARES, inflight_capacity=16, speed=[1.0, 0.25] * (W // 2),
        membership=_membership(m, joins=((6, 6), (10, 7)), leaves=((12, 1),))),
    "partition": lambda m: dict(fault_plan=_plan(m, partition_start=4, partition_stop=12, seed=1)),
    "low_rate_corrupt": lambda m: dict(inflight_capacity=16, fault_plan=_plan(m, corrupt_prob=0.02, seed=14)),
    "composed": lambda m: dict(
        inflight_capacity=16, spare_slots=2,
        membership=_membership(m, joins=((6, 6), (10, 7)), leaves=((12, 0),)),
        fault_plan=_plan(m, drop_prob=0.1, duplicate_prob=0.1, corrupt_prob=0.1, seed=13)),
    "composed-sparse_control": lambda m: dict(
        SUBSTRATES["sparse_control"], spare_slots=2,
        membership=_membership(m, joins=((6, 6),), leaves=((12, 0),)),
        fault_plan=_plan(m, drop_prob=0.1, duplicate_prob=0.3, corrupt_prob=0.1, reorder_max=1, seed=13)),
    "auto_churn": lambda m: dict(
        inflight_capacity="auto", spare_slots=1,
        membership=_membership(m, joins=((4, W - 1),), leaves=((6, 0),))),
    "auto_failstop": lambda m: dict(inflight_capacity="auto", fail_round=_fail_in_warmup()),
    "spec": lambda m: dict(fault_spec="drop=30,seed=7"),
    "plan_beats_spec": lambda m: dict(fault_spec="drop=90,seed=1", fault_plan=_plan(m, drop_prob=0.3, seed=7)),
})

#: every counter a chaos run reports
COUNTERS = (
    "messages_sent", "messages_accepted", "messages_discarded", "messages_evicted",
    "inflight_occupancy_peak", "messages_dropped_injected", "messages_corrupt_rejected",
    "workers_joined", "inflight_capacity_selected", "events_processed", "bytes_broadcast",
)


def _config(module, **kw):
    base = dict(PINNED, rounds_per_dispatch=8, n_workers=W, max_rounds=ROUNDS, delay_rounds=1, seed=0,
                control_plane="dense", inflight_capacity=0)
    base.update(kw)
    # the reference runs its plain delivery; the port its kernel wrappers
    # (their plain versions on the CPU); both are bit-identical to "ref"
    base.setdefault("round_step_impl", "ref" if module is jeng else "pallas")
    return module.EngineConfig(**base)


def _engine(module, **kw):
    if module is jeng:
        return jeng.TMSNEngine(JaxToyWorker(PERIOD, DEC), _config(jeng, **kw))
    return teng.TMSNEngine(TorchToyWorker(PERIOD, DEC), _config(teng, **kw), device=CPU)


class _Runs:
    """Each scenario run once per package (the reference compiles each
    config once)."""

    def __init__(self):
        self._cache = {}

    def __call__(self, module, name):
        key = (module.__name__, name)
        if key not in self._cache:
            self._cache[key] = _engine(module, **SCENARIOS[name](module)).run()
        return self._cache[key]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _assert_same(a, b, tag=""):
    assert a.final_certificates == b.final_certificates, tag
    assert a.history == b.history, tag
    assert a.rounds == b.rounds, tag
    for f in COUNTERS:
        assert getattr(a, f) == getattr(b, f), (tag, f)
    assert a.sim_time == b.sim_time and a.cost_units_total == b.cost_units_total, tag


def _monotone_finite(res):
    last: dict = {}
    for _, wid, cert in res.history:
        assert np.isfinite(cert), wid
        assert cert <= last.get(wid, np.inf), wid
        last[wid] = cert
    assert all(np.isfinite(res.final_certificates))


# ---------------------------------------------------------------------------
# the fault hash, the injection, the spec and the validation
# ---------------------------------------------------------------------------

#: gids and rounds near 0, small, and near 2**31
GRID = np.array([0, 1, 2, 3, 7, 9, 255, 1000, 65_535, 65_536, 123_456_789, 2**30, 2**31 - 2, 2**31 - 1],
                np.int64)


@pytest.mark.parametrize("salt", [1, 2, 3, 4, 5])
def test_fault_hash_and_unit_match_reference(salt):
    """uint32 values and float32 bit patterns, element by element."""
    rng = np.random.default_rng(salt)
    more = rng.integers(0, 2**31, 50)
    vals = np.concatenate([GRID, more])
    d, s = vals[:, None], vals[None, :]
    for seed in (0, 5, 9, 2**31 - 1, 10**12 + 7):
        for r in (0, 1, 23, 65_537, 2**31 - 1):
            jh = np.asarray(jeng._fault_hash(jnp.int32(r), jnp.asarray(d, jnp.int32), jnp.asarray(s, jnp.int32),
                                             seed, salt)).astype(np.int64)
            th = teng._fault_hash(r, torch.as_tensor(d, dtype=torch.int32), torch.as_tensor(s, dtype=torch.int32),
                                  seed, salt).numpy()
            np.testing.assert_array_equal(th, jh)
            ju = np.asarray(jeng._fault_unit(jnp.int32(r), jnp.asarray(d, jnp.int32), jnp.asarray(s, jnp.int32),
                                             seed, salt))
            tu = teng._fault_unit(r, torch.as_tensor(d, dtype=torch.int32), torch.as_tensor(s, dtype=torch.int32),
                                  seed, salt).numpy()
            assert tu.dtype == np.float32
            np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))


def test_fault_unit_rounds_like_the_reference(monkeypatch):
    """The hash-to-float32 step on values that round: ties to even, and
    the top 128 values, which give a unit of exactly 1.0."""
    hashes = np.array([2**32 - 1, 2**32 - 128, 2**32 - 129, 2**31 + 128, 2**31 + 384, 2**24 + 1, 2**24 + 3,
                       16_777_217 * 3, 0, 1], np.int64)
    monkeypatch.setattr(jeng, "_fault_hash", lambda *a: jnp.asarray(hashes.astype(np.uint32)))
    monkeypatch.setattr(teng, "_fault_hash", lambda *a: torch.as_tensor(hashes))
    ju = np.asarray(jeng._fault_unit(0, None, None, 0, 1))
    tu = teng._fault_unit(0, None, None, 0, 1).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    assert tu[0] == 1.0


INJECT_PLANS = {
    "drop": dict(drop_prob=0.4, seed=3),
    "corrupt": dict(corrupt_prob=0.6, seed=4),
    "reorder": dict(reorder_max=3, seed=5),
    "dup": dict(duplicate_prob=0.5, seed=6),
    "partition": dict(partition_start=0, partition_stop=100, seed=1),
    "certain": dict(drop_prob=1.0, corrupt_prob=1.0, duplicate_prob=1.0, seed=2),
    "all": dict(drop_prob=0.2, corrupt_prob=0.3, duplicate_prob=0.4, reorder_max=2, seed=2**31 - 1),
}


@pytest.mark.parametrize("with_due", [False, True], ids=["dense", "due"])
@pytest.mark.parametrize("plan", list(INJECT_PLANS), ids=list(INJECT_PLANS))
def test_inject_faults_matches_reference(plan, with_due):
    rng = np.random.default_rng(len(plan) + with_due)
    wl, m, depth = 6, 9, 4
    for r in (0, 5, 2**31 - 9):
        cert = np.where(rng.random((wl, m)) < 0.7, -rng.random((wl, m)) * 2, np.inf).astype(np.float32)
        dst_cert = (-rng.random(wl)).astype(np.float32)
        dst = rng.permutation(16)[:wl].astype(np.int32)
        src = rng.integers(0, 16, (wl, m), dtype=np.int32)
        due = (r + rng.integers(1, depth + 1, (wl, m))).astype(np.int32) if with_due else None
        j = jeng._inject_faults(
            jeng.FaultPlan(**INJECT_PLANS[plan]), None, jnp.int32(r), jnp.asarray(dst), jnp.asarray(src),
            jnp.asarray(cert), None if due is None else jnp.asarray(due), jnp.asarray(dst_cert), depth,
        )
        t = teng._inject_faults(
            teng.FaultPlan(**INJECT_PLANS[plan]), None, r, torch.as_tensor(dst), torch.as_tensor(src),
            torch.as_tensor(cert), None if due is None else torch.as_tensor(due), torch.as_tensor(dst_cert), depth,
        )
        np.testing.assert_array_equal(t[0].numpy().view(np.int32), np.asarray(j[0]).view(np.int32))
        if due is None:
            assert t[1] is None and j[1] is None
        else:
            np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
        assert int(t[3]) == int(j[3]) and int(t[4]) == int(j[4])


@pytest.mark.parametrize(
    "spec",
    ["drop=5,dup=2,corrupt=2,reorder=1,seed=9,part=8:16", "", "  ", "drop=0", "seed=9", "drop=30,seed=7",
     "dup=100", " corrupt = 7 , seed = 3 ,", "drop", "bogus=1", "drop=101", "drop=-1", "dup=x", "part=x:2",
     "reorder=1.5"],
)
def test_parse_fault_spec_matches_reference(spec):
    try:
        want = jeng._parse_fault_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            teng._parse_fault_spec(spec)
        return
    got = teng._parse_fault_spec(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


BAD_CONFIGS = {
    "spares_negative": lambda m: dict(spare_slots=-1),
    "spares_all": lambda m: dict(spare_slots=W),
    "join_round_zero": lambda m: dict(spare_slots=1, membership=m.MembershipPlan(joins=((0, W - 1),))),
    "join_not_a_spare": lambda m: dict(spare_slots=1, membership=m.MembershipPlan(joins=((2, 0),))),
    "join_twice": lambda m: dict(spare_slots=2, membership=m.MembershipPlan(joins=((2, W - 1), (3, W - 1)))),
    "leave_round_zero": lambda m: dict(membership=m.MembershipPlan(leaves=((0, 1),))),
    "leave_out_of_range": lambda m: dict(membership=m.MembershipPlan(leaves=((2, W),))),
    "membership_type": lambda m: dict(membership=((1, 2),)),
    "fault_plan_type": lambda m: dict(fault_plan="drop=5"),
    "drop_above_one": lambda m: dict(fault_plan=m.FaultPlan(drop_prob=1.5)),
    "dup_negative": lambda m: dict(fault_plan=m.FaultPlan(duplicate_prob=-0.1)),
    "corrupt_nan": lambda m: dict(fault_plan=m.FaultPlan(corrupt_prob=float("nan"))),
    "reorder_negative": lambda m: dict(inflight_capacity=4, fault_plan=m.FaultPlan(reorder_max=-1)),
    "reorder_on_dense": lambda m: dict(inflight_capacity=0, fault_plan=m.FaultPlan(reorder_max=1, seed=1)),
    "reorder_spec_on_dense": lambda m: dict(inflight_capacity=0, fault_spec="reorder=2"),
}


@pytest.mark.parametrize("name", list(BAD_CONFIGS))
def test_validation_errors_match_reference(name):
    with pytest.raises(ValueError) as je:
        _engine(jeng, **BAD_CONFIGS[name](jeng))
    with pytest.raises(ValueError) as te:
        _engine(teng, **BAD_CONFIGS[name](teng))
    assert str(te.value) == str(je.value)


def test_only_a_mesh_is_deferred():
    """Every item-9 feature is accepted; an inactive plan is the clean
    run. No mesh is deferred any more: ``TMSNEngine`` takes a config with
    a (pod, workers) mesh as the reference's does (the pod-mesh substrate
    runs below, on a world of ranks); ``make_engine`` needs a real
    ``WorkerMesh`` for it; a mesh with no ``workers`` axis raises the
    reference's ValueError, text for text."""
    for kw in (dict(inflight_capacity="auto"), dict(spare_slots=1), dict(membership=teng.MembershipPlan()),
               dict(fault_spec="drop=5,seed=1"), dict(fault_plan=teng.FaultPlan(drop_prob=0.1)),
               dict(publish_every_k=3)):
        _engine(teng, **kw)
    assert _engine(teng, fault_plan=teng.FaultPlan(seed=4))._fault is None

    class PodMesh:
        size, axis_names, shape = 4, ("pod", "workers"), {"pod": 2, "workers": 2}

    assert type(_engine(jeng, mesh=PodMesh())) is jeng.TMSNEngine
    assert type(_engine(teng, mesh=PodMesh())) is teng.TMSNEngine
    with pytest.raises(ValueError, match="needs a repro_torch.launch.mesh.WorkerMesh, got PodMesh"):
        teng.make_engine(TorchToyWorker(PERIOD, DEC), _config(teng, mesh=PodMesh()), CPU)

    class DataMesh:
        size, axis_names = 2, ("data",)

    with pytest.raises(ValueError) as je:
        jeng.make_engine(JaxToyWorker(PERIOD, DEC), _config(jeng, mesh=DataMesh()))
    with pytest.raises(ValueError) as te:
        teng.make_engine(TorchToyWorker(PERIOD, DEC), _config(teng, mesh=DataMesh()), CPU)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# whole runs: the port's engine against the reference's, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_reference(runs, name):
    _assert_same(runs(teng, name), runs(jeng, name), name)


class TestClaimsOnThePort:
    """The exact claims of tests/test_chaos.py, on the port's runs."""

    @pytest.mark.parametrize("sub", list(SUBSTRATES))
    def test_join_at_round_one_is_masked_from_start(self, runs, sub):
        joined = runs(teng, f"join_k1-{sub}")
        _assert_same(joined, runs(teng, f"plain-{sub}"), sub)
        assert joined.workers_joined == 0

    @pytest.mark.parametrize("sub", [s for s, kw in SUBSTRATES.items() if kw["inflight_capacity"]] + ["dense"])
    def test_duplication_identical_to_clean(self, runs, sub):
        dup, clean = runs(teng, f"dup-{sub}"), runs(teng, f"plain-{sub}")
        assert (dup.final_certificates, dup.history) == (clean.final_certificates, clean.history)
        assert dup.messages_evicted == 0

    @pytest.mark.parametrize("sub", list(SUBSTRATES))
    def test_corruption_rejected_and_never_poisons(self, runs, sub):
        cor = runs(teng, f"corrupt-{sub}")
        assert cor.messages_corrupt_rejected > 0
        _monotone_finite(cor)
        assert min(cor.final_certificates) == min(runs(teng, f"plain-{sub}").final_certificates)
        assert cor.final_certificates == runs(teng, "corrupt-dense").final_certificates

    @pytest.mark.parametrize("sub", list(SUBSTRATES))
    def test_drop_same_on_every_substrate(self, runs, sub):
        drop = runs(teng, f"drop-{sub}")
        assert drop.messages_dropped_injected > 0
        _monotone_finite(drop)
        oracle = runs(teng, "drop-dense")
        assert (drop.final_certificates, drop.history) == (oracle.final_certificates, oracle.history)
        assert drop.messages_dropped_injected == oracle.messages_dropped_injected

    def test_membership(self, runs):
        mid = runs(teng, "mid_run_join")
        assert mid.workers_joined == 2 and any(e[1] in (6, 7) for e in mid.history if e[0] > 0)
        _monotone_finite(mid)
        idle = runs(teng, "spares_idle")
        masked = runs(teng, "failstop_at_zero")
        assert (idle.final_certificates, idle.history) == (masked.final_certificates, masked.history)
        assert all(e[1] < W - 2 for e in idle.history if e[0] > 0) and idle.workers_joined == 0
        churn = runs(teng, "churn")
        assert churn.workers_joined == 2 and churn.rounds == ROUNDS
        _monotone_finite(churn)

    def test_faults_without_exact_claims_complete(self, runs):
        part, clean = runs(teng, "partition"), runs(teng, "plain-dense")
        assert (part.final_certificates, part.history) == (clean.final_certificates, clean.history)
        assert part.messages_dropped_injected == 0
        low = runs(teng, "low_rate_corrupt")
        assert low.messages_corrupt_rejected > 0
        assert (low.final_certificates, low.history) == (runs(teng, "plain-queues").final_certificates,
                                                         runs(teng, "plain-queues").history)
        for name in ("reorder-queues", "reorder-sparse_control", "composed", "composed-sparse_control"):
            res = runs(teng, name)
            assert res.rounds == ROUNDS, name
            _monotone_finite(res)
        comp = runs(teng, "composed")
        assert comp.messages_dropped_injected > 0 and comp.messages_corrupt_rejected > 0
        assert comp.workers_joined == 2
        assert _engine(teng, **SCENARIOS["reorder-queues"](teng)).run().history == runs(teng, "reorder-queues").history

    @pytest.mark.parametrize("name,extra", [
        ("auto_churn", lambda m: dict(spare_slots=1, membership=_membership(m, joins=((4, W - 1),),
                                                                               leaves=((6, 0),)))),
        ("auto_failstop", lambda m: dict(fail_round=_fail_in_warmup())),
    ])
    def test_auto_capacity_equals_explicit(self, runs, name, extra):
        auto = runs(teng, name)
        assert auto.inflight_capacity_selected >= 1 and auto.messages_evicted == 0
        explicit = _engine(teng, inflight_capacity=auto.inflight_capacity_selected, **extra(teng)).run()
        assert (auto.final_certificates, auto.history) == (explicit.final_certificates, explicit.history)

    def test_spec_equals_plan_and_plan_wins(self, runs):
        for name in ("spec", "plan_beats_spec"):
            res = runs(teng, name)
            ref = runs(teng, "drop-dense")
            assert (res.final_certificates, res.history) == (ref.final_certificates, ref.history), name


# ---------------------------------------------------------------------------
# the publisher and the adoption slot
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.log = []

    def publish(self, params, cert, round):
        self.log.append((round, cert, params))


@pytest.mark.parametrize("target", [None, -7.0], ids=["flush", "target"])
@pytest.mark.parametrize("every_k", [1, 5])
@pytest.mark.parametrize("rpd", [1, 8])
def test_published_sequence_matches_reference(rpd, every_k, target):
    """(round, cert, params) in order, at publish_eps > 0, with a target
    stop or a final flush after a last partial chunk."""
    logs = []
    for module in (jeng, teng):
        eng = _engine(module, rounds_per_dispatch=rpd, publish_every_k=every_k, publish_eps=0.3,
                      max_rounds=21, target_certificate=target, inflight_capacity=16)
        rec = _Recorder()
        eng.attach_publisher(rec)
        res = eng.run()
        logs.append((rec.log, res))
    (jlog, jres), (tlog, tres) = logs
    assert tres.rounds == jres.rounds and tres.history == jres.history
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    assert len(tlog) >= 2
    for (_, _, tp), (_, _, jp) in zip(tlog, jlog):
        assert tp.keys() == jp.keys()
        for k in tp:
            # a host copy: CPU tensors of the reference's dtype and values
            assert isinstance(tp[k], torch.Tensor) and tp[k].device.type == "cpu"
            assert tp[k].numpy().dtype == np.asarray(jp[k]).dtype
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    rounds = [e[0] for e in tlog]
    assert all(r % rpd == 0 or r == tres.rounds for r in rounds)
    certs = [e[1] for e in tlog]
    assert all(b < a - 0.3 for a, b in zip(certs, certs[1:]))
    if target is not None:
        assert tres.rounds < 21 and rounds[-1] == tres.rounds


def test_publisher_snapshot_is_a_host_copy():
    """Later rounds and a second run cannot change a published snapshot,
    and each run publishes from scratch."""
    slot = AdoptionSlot()
    eng = _engine(teng, publish_every_k=4, inflight_capacity=16)
    eng.attach_publisher(slot)
    eng.run()
    first = slot.acquire()
    kept = {k: v.clone() for k, v in first.params.items()}
    n = slot.publishes
    eng.run()
    assert slot.publishes == 2 * n
    for k, v in kept.items():
        assert torch.equal(first.params[k], v)
    assert slot.acquire().cert == first.cert == min(eng.run().final_certificates)


class TestAdoptionSlot:
    """tests/test_serving.py::TestAdoptionSlot on the port's slot."""

    def test_empty_slot(self):
        slot = AdoptionSlot()
        assert slot.version == 0 and slot.acquire() is None
        assert np.isnan(slot.latest_cert)

    def test_publish_versions_monotone(self):
        slot = AdoptionSlot()
        assert slot.publish({"w": 1}, cert=2.0, round=3) == 1
        assert slot.publish({"w": 2}, cert=1.0, round=4) == 2
        snap = slot.acquire()
        assert snap == Snapshot(2, {"w": 2}, 1.0, 4)
        assert slot.latest_cert == 1.0 and slot.publishes == 2

    def test_no_torn_reads_under_concurrent_publishes(self):
        slot = AdoptionSlot()
        n_pub = 4000
        errors: list[str] = []
        stop = threading.Event()

        def writer():
            for v in range(1, n_pub + 1):
                slot.publish({"w": np.full(8, v, np.int64)}, cert=-float(v), round=v)
            stop.set()

        def reader():
            seen_any = False
            while not stop.is_set() or not seen_any:
                snap = slot.acquire()
                if snap is None:
                    continue
                seen_any = True
                if not (snap.params["w"] == snap.version).all():
                    errors.append(f"params {snap.params['w'][0]} != version {snap.version}")
                if snap.cert != -float(snap.version) or snap.round != snap.version:
                    errors.append(f"cert/round torn at v{snap.version}")

        threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:5]
        assert slot.version == n_pub


# ---------------------------------------------------------------------------
# batched Sparrow under a composed plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def splice():
    from repro.data.splice import SpliceConfig, make_splice_like

    xb, y, _ = make_splice_like(SpliceConfig(n=2400, d=16, num_bins=8, seed=3))
    return np.asarray(xb), np.asarray(y)


def test_sparrow_composed_chaos_matches_reference(splice):
    """Drop, dup, corrupt and reorder, one spare joining at round 5 and a
    publisher, on the slice's route (K1–K3 wrappers), against the
    reference running its own Pallas kernels (interpret mode)."""
    jw, tw = _sparrow_pair(splice, use_kernel=True)
    logs = []
    for module, worker in ((jeng, jw), (teng, tw)):
        cfg = module.EngineConfig(**dict(
            PINNED, n_workers=4, max_rounds=20, inflight_capacity=16, control_plane="sparse", gossip_top_k=4,
            round_step_impl="pallas", rounds_per_dispatch=8, spare_slots=1, publish_every_k=5,
            membership=module.MembershipPlan(joins=((5, 3),)),
            fault_plan=module.FaultPlan(drop_prob=0.1, duplicate_prob=0.3, corrupt_prob=0.2, reorder_max=1,
                                        seed=4),
        ))
        eng = module.TMSNEngine(worker, cfg) if module is jeng else module.TMSNEngine(worker, cfg, device=CPU)
        rec = _Recorder()
        eng.attach_publisher(rec)
        tops.reset_launches()
        logs.append((eng.run(), rec.log))
    (jres, jlog), (tres, tlog) = logs
    _assert_close_runs(jres, tres)
    for f in ("messages_dropped_injected", "messages_corrupt_rejected", "workers_joined",
              "inflight_occupancy_peak"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.workers_joined == 1 and tres.messages_dropped_injected > 0 and tres.messages_corrupt_rejected > 0
    assert [e[0] for e in tlog] == [e[0] for e in jlog] and tlog
    np.testing.assert_allclose([e[1] for e in tlog], [e[1] for e in jlog], rtol=1e-5, atol=1e-6)
    assert sum(tops.LAUNCHES.values()) == 0  # CPU tensors: the plain versions


# ---------------------------------------------------------------------------
# the fault properties of tests/test_properties.py, with valid bounds
# ---------------------------------------------------------------------------


def _f32(x):
    return float(np.float32(x))


def _both(periods, plan):
    """One property example on both engines, required to agree bit for bit."""
    w = len(periods)
    dec = [0.01 * (i % 7 + 1) for i in range(w)]
    out = []
    for module, worker in ((jeng, JaxToyWorker(periods, dec)), (teng, TorchToyWorker(periods, dec))):
        fault = None if plan is None else module.FaultPlan(**plan)
        cfg = module.EngineConfig(**dict(PINNED, n_workers=w, max_rounds=16, inflight_capacity=16, seed=0,
                                         control_plane="dense", round_step_impl="ref", fault_plan=fault))
        eng = module.TMSNEngine(worker, cfg) if module is jeng else module.TMSNEngine(worker, cfg, device=CPU)
        out.append(eng.run())
    _assert_same(out[1], out[0], plan)
    return out[1]


def test_cert_monotone_under_any_fault_schedule():
    """Per-worker certificates never rise and stay finite under any
    drop/duplicate/reorder/corrupt schedule (test_properties.py's
    invariant, with float32-representable bounds)."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=5)
    @hyp.given(
        st.lists(st.integers(min_value=1, max_value=5), min_size=8, max_size=8),
        st.floats(min_value=0.0, max_value=_f32(0.4), width=32),
        st.floats(min_value=0.0, max_value=_f32(0.4), width=32),
        st.floats(min_value=0.0, max_value=_f32(0.4), width=32),
        st.integers(min_value=0, max_value=2),
        st.integers(min_value=0, max_value=10_000),
    )
    def prop(periods, drop, dup, corrupt, reorder, seed):
        plan = dict(drop_prob=drop, duplicate_prob=dup, corrupt_prob=corrupt, reorder_max=reorder, seed=seed)
        res = _both(periods, plan)
        assert res.rounds == 16
        _monotone_finite(res)

    prop()


def test_soundness_gate_never_suppresses_legitimate_improvement():
    """A duplication-only plan is bit-identical to the clean run."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=5)
    @hyp.given(
        st.lists(st.integers(min_value=1, max_value=5), min_size=8, max_size=8),
        st.floats(min_value=_f32(0.05), max_value=_f32(0.6), width=32),
        st.integers(min_value=0, max_value=10_000),
    )
    def prop(periods, dup, seed):
        clean = _both(periods, None)
        faulted = _both(periods, dict(duplicate_prob=dup, seed=seed))
        assert faulted.final_certificates == clean.final_certificates
        assert faulted.history == clean.history
        assert faulted.messages_evicted == 0

    prop()


# ---------------------------------------------------------------------------
# the pod-mesh substrate (tests/test_chaos.py:77) on a world of 4 CPU ranks
# ---------------------------------------------------------------------------

#: the dense-substrate scenarios the pod-mesh substrate runs
POD_KINDS = ("plain", "join_k1", "drop", "dup", "corrupt")
POD_W16 = 16
#: the reference pod engine's figures for a [4, 12) partition at W = 16,
#: 30 rounds (tests/test_torch_sharded_reference.py holds the run against
#: the live reference): history entries, sent, sent_dcn, accepted, dropped
POD_PARTITION_W16 = (457, 708, 344, 399, 96)
#: the reference pod engine's (dropped, sent) for the drop scenario at
#: W = 8 on 4 devices in 2 pods, which tests/test_torch_sharded_reference.py
#: computes live (``pod_drop_w8``) and holds the port's run against
POD_DROP_W8 = (POD_FIGURES["pod_drop_w8"][6], POD_FIGURES["pod_drop_w8"][1])


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_world
    from test_torch_sharded_engine import run_on_mesh

    runs = {f"{kind}-pod": (PERIOD, DEC, _config(teng, **SCENARIOS[f"{kind}-dense"](teng)))
            for kind in POD_KINDS}
    runs["partition-pod"] = (PERIOD, DEC, _config(teng, **SCENARIOS["partition"](teng)))
    runs["partition-w16"] = ([1, 2] * (POD_W16 // 2), [0.01 * (i + 1) for i in range(POD_W16)], _config(
        teng, n_workers=POD_W16, max_rounds=30, rounds_per_dispatch=1,
        fault_plan=teng.FaultPlan(partition_start=4, partition_stop=12, seed=1)))
    res = spawn_world(run_on_mesh, [CPU] * 4, tmp_path_factory.mktemp("pod_world"), args=(runs,), pods=2)
    for r in res[1:]:
        for name in runs:
            _assert_same(r[name], res[0][name], name)
    return res[0]


def _same_run(a, b, tag):
    assert (a.final_certificates, a.history, a.rounds) == (b.final_certificates, b.history, b.rounds), tag


class TestPodMeshSubstrate:
    """tests/test_chaos.py's exact claims on its ``pod-mesh`` substrate."""

    def test_clean_pod_run_is_the_single_device_run(self, pod_runs, runs):
        _same_run(pod_runs["plain-pod"], runs(teng, "plain-dense"), "pod-mesh")
        assert pod_runs["plain-pod"].messages_sent_dcn > 0

    def test_join_at_round_one_is_masked_from_start(self, pod_runs):
        _same_run(pod_runs["join_k1-pod"], pod_runs["plain-pod"], "pod-mesh join")
        assert pod_runs["join_k1-pod"].workers_joined == 0

    def test_dense_buffer_absorbs_duplicates(self, pod_runs):
        _same_run(pod_runs["dup-pod"], pod_runs["plain-pod"], "pod-mesh dup")

    def test_corruption_rejected_and_never_poisons(self, pod_runs, runs):
        cor = pod_runs["corrupt-pod"]
        assert cor.messages_corrupt_rejected > 0
        _monotone_finite(cor)
        assert min(cor.final_certificates) == min(pod_runs["plain-pod"].final_certificates)
        assert cor.final_certificates == runs(teng, "corrupt-dense").final_certificates

    def test_drop_same_as_every_substrate(self, pod_runs, runs):
        """Certificates and history of the single-device drop run. The
        drop count equals the single device's only where a rank holds
        one worker (the reference's 8-device CI mesh); here a rank holds
        two and flushes one a round across pods, so fewer cross-pod
        pushes meet the hash: 88 dropped of 297 sent, against 90 of 301,
        as the reference's pod engine gives on 4 devices in 2 pods."""
        assert (CHAOS_PERIOD, CHAOS_DEC) == (PERIOD, DEC)  # the live reference run's toy is this one
        drop, oracle = pod_runs["drop-pod"], runs(teng, "drop-dense")
        _same_run(drop, oracle, "pod-mesh drop")
        assert (oracle.messages_dropped_injected, oracle.messages_sent) == (90, 301)
        assert (drop.messages_dropped_injected, drop.messages_sent) == POD_DROP_W8

    def test_partition_drops_cross_pod_traffic(self, pod_runs):
        res = pod_runs["partition-pod"]
        assert res.messages_dropped_injected > 0
        assert res.rounds == ROUNDS
        _monotone_finite(res)

    def test_partition_matches_the_reference_figures(self, pod_runs):
        res = pod_runs["partition-w16"]
        assert (len(res.history), res.messages_sent, res.messages_sent_dcn, res.messages_accepted,
                res.messages_dropped_injected) == POD_PARTITION_W16
        _monotone_finite(res)
