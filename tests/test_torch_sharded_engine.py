"""The port's sharded engine (``repro_torch.core.engine_sharded``) on
gloo worlds of 2 and 4 CPU ranks, held against the port's single-device
``TMSNEngine`` — the pins of tests/test_sharded_engine.py on a torch
twin of its ``ShardableToyWorker``:

  * dense gossip with the dense control plane gives the single-device
    run bit for bit: certificates, history, rounds, every counter, the
    simulated clock and each worker's adoption (single sender with a
    target and chunked dispatch, fail-stop, laggards, a link-delay
    matrix, uniform delay, pending queues at C = 16 and C = 1, fault
    plans, joins and leaves, auto capacity);
  * gated gossip and the sparse control plane give its certificates,
    history and adoptions bit for bit under uniform delay (they push
    different numbers of messages by design); sparse control at
    ``gossip_top_k >= W_local`` offers every improver and matches every
    counter;
  * the byte accounting of the reference's formulas, the publisher's
    sequence, the factory's dispatch and errors, ``edge_scan_sharded``
    and the collectives (bits kept, ``-0.0`` included);
  * batched Sparrow on the small_ref data, with kernels off and through
    the plain K1: certificates, history and models bit for bit;
  * the reference's ``TestShardedSGDWorker`` (tests/test_worker_contract.py):
    the TMSN-SGD worker on the flat mesh with dense gossip, gated gossip
    at ``gossip_top_k=1`` and the sparse in-flight state, and on the pod
    mesh at k = 1: certificates, history, adoptions and every worker's
    final parameters bit for bit the single device's, and certificates
    the oracle's (``oracle_run``);
  * the reference's ``TestPodMesh`` on a pod mesh of 2 pods built in the
    same world (``make_worker_mesh(n, pods=2)``: 2 pods of 2 ranks in the
    world of 4, 2 pods of 1 in the world of 2): at ``cross_pod_every_k=1``
    the flat engine's and the single device's certificates, history and
    adoptions, dense and gated, with fail-stop and laggards, at chunked
    dispatch 1 and 8, and on batched Sparrow; ``k = 8`` as a measured
    approximation; the tier byte formulas; the env defaults; the
    refusals of a bad axis order and bad knobs;
  * every rank returns the same result.

One world per size is started for the module (``spawn``, a file store in
``tmp_path``), every scenario runs inside it, and the parametrised tests
assert on the results. Neither the ranks nor this module import JAX;
tests/test_torch_sharded_reference.py holds the same engine to the
reference's sharded engine.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.engine_sharded import ShardedTMSNEngine  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

CPU = "cpu"
WORLDS = (2, 4)
#: every env-steerable knob, pinned
PINNED = dict(
    fault_spec="", rounds_per_dispatch=1, gossip_mode="dense", cross_pod_every_k=1, cross_pod_top_k=1,
    spare_slots=0, publish_every_k=0, publish_eps=0.0, control_plane="dense", inflight_capacity=0,
    round_step_impl="pallas",
)


class ShardableTorchToy:
    """Torch twin of tests/test_sharded_engine.py's ``ShardableToyWorker``:
    every per-worker constant (period, decrement, global id) lives in the
    state, so it shards with the worker axis."""

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


def _busy(w):
    """Every worker fires (period 1 or 2) with distinct decrements:
    several improvers per shard every round."""
    return [1, 2] * (w // 2), [0.01 * (i + 1) for i in range(w)]


def _lone(w):
    return [1] + [10**9] * (w - 1), [0.1] * w


def _delays(w):
    return teng.quantize_latency(0.05, 0.02, 0.05, w, seed=1)


_PLAN = dict(drop_prob=0.1, duplicate_prob=0.3, corrupt_prob=0.1, reorder_max=1, seed=13)

#: name -> (workload, W, config kwargs, what must match the single device)
#: "all": certificates, history, rounds, every counter, clock, adoptions;
#: "adoptions": certificates, history, rounds, accepted, adoptions
TOY = {
    "single_sender_target": (_lone, 16, dict(target_certificate=-0.95, max_rounds=500), "all"),
    "single_sender_target_rpd8": (_lone, 16, dict(target_certificate=-0.95, max_rounds=500,
                                                  rounds_per_dispatch=8), "all"),
    "fail_stop": (_lone, 8, dict(fail_round=[5] + [10**6] * 7, max_rounds=30), "all"),
    "laggards": (lambda w: ([1] * w, [0.1] * w), 8, dict(speed=[1.0] * 6 + [0.25, 0.5], max_rounds=40),
                 "all"),
    "delay_matrix": (lambda w: ([1, 2] * (w // 2), [0.05 * (i + 1) for i in range(w)]), 8,
                     dict(delay_rounds=_delays(8), max_rounds=25), "all"),
    "delay_matrix_queues": (lambda w: ([1, 2] * (w // 2), [0.05 * (i + 1) for i in range(w)]), 8,
                            dict(delay_rounds=_delays(8), max_rounds=25, inflight_capacity=16), "all"),
    "dense_uniform": (_busy, 16, dict(max_rounds=30), "all"),
    "dense_delay2": (_busy, 8, dict(max_rounds=30, delay_rounds=2), "all"),
    "gated_uniform": (_busy, 16, dict(max_rounds=30, gossip_mode="gated"), "adoptions"),
    "gated_failstop_laggards": (_busy, 16, dict(max_rounds=25, gossip_mode="gated",
                                                speed=[1.0] * 14 + [0.25, 0.5],
                                                fail_round=[5] + [10**6] * 15), "adoptions"),
    "gated_top3": (_busy, 16, dict(max_rounds=10, gossip_mode="gated", gossip_top_k=3), "adoptions"),
    "gated_top_w": (_busy, 16, dict(max_rounds=10, gossip_mode="gated", gossip_top_k=16), "all"),
    "gated_rpd8": (_busy, 16, dict(max_rounds=24, gossip_mode="gated", rounds_per_dispatch=8), "adoptions"),
    "queues": (_busy, 16, dict(max_rounds=30, inflight_capacity=16), "all"),
    "queues_c1": (_busy, 8, dict(max_rounds=30, inflight_capacity=1), "all"),
    "queues_ref_impl": (_busy, 16, dict(max_rounds=30, inflight_capacity=16, round_step_impl="ref"), "all"),
    "sparse_control_queues": (_busy, 16, dict(max_rounds=30, inflight_capacity=16, control_plane="sparse"),
                              "adoptions"),
    "sparse_control_dense": (_busy, 16, dict(max_rounds=30, control_plane="sparse"), "adoptions"),
    "sparse_control_gated": (_busy, 16, dict(max_rounds=30, inflight_capacity=8, control_plane="sparse",
                                             gossip_mode="gated"), "adoptions"),
    "sparse_control_top_w": (_busy, 16, dict(max_rounds=30, inflight_capacity=16, control_plane="sparse",
                                             gossip_top_k=16), "all"),
    "faults_queues": (_busy, 8, dict(max_rounds=24, inflight_capacity=16, fault=_PLAN), "all"),
    "faults_dense": (_busy, 8, dict(max_rounds=24, fault=dict(drop_prob=0.3, corrupt_prob=0.3, seed=7)),
                     "all"),
    "faults_sparse_control": (_busy, 8, dict(max_rounds=24, inflight_capacity=16, control_plane="sparse",
                                             gossip_top_k=8, fault=_PLAN), "all"),
    "churn": (_busy, 8, dict(max_rounds=24, inflight_capacity=16, spare_slots=2, speed=[1.0, 0.25] * 4,
                             membership=dict(joins=((6, 6), (10, 7)), leaves=((12, 1),))), "all"),
    "auto_capacity": (_busy, 8, dict(max_rounds=24, inflight_capacity="auto"), "all"),
    "publisher": (_busy, 8, dict(max_rounds=24, publish_every_k=5, rounds_per_dispatch=4), "all"),
}


def _config(w, mesh=None, **kw):
    kw = dict(kw)
    env = kw.pop("env", False)
    if "fault" in kw:
        kw["fault_plan"] = teng.FaultPlan(**kw.pop("fault"))
    if "membership" in kw:
        kw["membership"] = teng.MembershipPlan(**kw.pop("membership"))
    pinned = {k: v for k, v in PINNED.items() if not (env and k.startswith("cross_pod"))}
    return teng.EngineConfig(**{**pinned, "n_workers": w, "mesh": mesh, **kw})


class _Log:
    def __init__(self):
        self.log = []

    def publish(self, params, cert, round=0):
        self.log.append((round, cert, {k: np.asarray(v).tolist() for k, v in params.items()}))


def _summary(res, publisher=None):
    out = dict(
        certs=res.final_certificates, history=res.history, rounds=res.rounds, sim_time=res.sim_time,
        cost=res.cost_units_total, gossip_bytes=res.gossip_bytes_per_round,
        control_bytes=res.control_bytes_per_round, mode=res.gossip_mode,
        gossip_bytes_per_round_ici=res.gossip_bytes_per_round_ici,
        gossip_bytes_per_round_dcn=res.gossip_bytes_per_round_dcn, **{f: getattr(res, f) for f in COUNTERS},
    )
    if isinstance(res.final_models[0], dict):
        out["adopted_from"] = [int(m["adopted_from"]) for m in res.final_models]
    else:  # a StumpModel
        out["models"] = [tuple(np.asarray(a).tolist() for a in m) for m in res.final_models]
    if publisher is not None:
        out["published"] = publisher.log
    return out


COUNTERS = ("messages_sent", "messages_sent_dcn", "messages_accepted", "messages_discarded",
            "messages_evicted", "inflight_occupancy_peak", "messages_dropped_injected",
            "messages_corrupt_rejected", "workers_joined", "inflight_capacity_selected", "events_processed",
            "bytes_broadcast")


def _run_toy(name, mesh=None, table=None):
    workload, w, kw, _ = (table or TOY)[name]
    cfg = _config(w, mesh, **kw)
    worker = ShardableTorchToy(*workload(w))
    eng = teng.make_engine(worker, cfg, CPU) if mesh is None else teng.make_engine(worker, cfg)
    pub = None
    if cfg.publish_every_k:
        pub = _Log()
        eng.attach_publisher(pub)
    return _summary(eng.run(), pub)


# ---------------------------------------------------------------------------
# batched Sparrow on the small_ref data (chip_smoke.py's small_ref phase)
# ---------------------------------------------------------------------------

SPARROW_W = 8
SPARROW = {
    "sparrow_dense": dict(use_kernel=False, max_rounds=30),
    "sparrow_dense_k1": dict(use_kernel=True, max_rounds=30),
    "sparrow_gated_queues": dict(use_kernel=True, max_rounds=30, gossip_mode="gated", inflight_capacity=64),
    "sparrow_sparse_control": dict(use_kernel=True, max_rounds=30, inflight_capacity=64,
                                   control_plane="sparse"),
}


def _sparrow_worker(use_kernel):
    from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker
    from repro_torch.boosting.scanner import ScannerConfig
    from repro_torch.boosting.sparrow import SparrowConfig
    from repro_torch.data.splice import SpliceConfig, make_splice_like

    xb, y, _ = make_splice_like(SpliceConfig(n=6000, d=16, num_bins=8, seed=3), device=CPU)
    cfg = SparrowConfig(
        sample_size=800, capacity=32, n_workers=SPARROW_W, ess_threshold=0.5,
        scanner=ScannerConfig(chunk_size=256, num_bins=8, gamma0=0.25, use_kernel=use_kernel),
    )
    return BatchedSparrowWorker(xb, y, cfg, device=CPU)


# ---------------------------------------------------------------------------
# the reference's TestPodMesh (tests/test_sharded_engine.py:371-541)
# ---------------------------------------------------------------------------

POD_W = 32
PODS = 2
#: name -> (workload, W, config kwargs, the flat/single-device twin or None);
#: "*_flat" twins run on the world's 1-D mesh and on one device
POD = {
    "k1_dense": (_busy, POD_W, dict(max_rounds=30, gossip_mode="dense"), "k1_dense"),
    "k1_gated": (_busy, POD_W, dict(max_rounds=30, gossip_mode="gated"), "k1_gated"),
    "k1_failstop_laggards": (_busy, POD_W, dict(max_rounds=25, speed=[1.0] * (POD_W - 2) + [0.25, 0.5],
                                                fail_round=[5] + [10**6] * (POD_W - 1)),
                             "k1_failstop_laggards"),
    "k1_sparse_queues": (_busy, POD_W, dict(max_rounds=30, gossip_mode="gated", control_plane="sparse",
                                            inflight_capacity=16), "k1_dense"),
    "rpd1": (_busy, POD_W, dict(max_rounds=24, rounds_per_dispatch=1), None),
    "rpd8": (_busy, POD_W, dict(max_rounds=24, rounds_per_dispatch=8), None),
    "k8": (_busy, POD_W, dict(max_rounds=30, cross_pod_every_k=8), None),
    "bytes_dense": (_busy, POD_W, dict(max_rounds=10, cross_pod_every_k=4, cross_pod_top_k=2), None),
    "bytes_gated": (_busy, POD_W, dict(max_rounds=10, gossip_mode="gated", cross_pod_every_k=4,
                                       cross_pod_top_k=2), None),
    "env_defaults": (_busy, POD_W, dict(max_rounds=20, env=True), None),
}
POD_FLAT = {name: POD[name] for name in ("k1_dense", "k1_gated", "k1_failstop_laggards")}


def _run_sparrow(name, mesh=None):
    kw = dict(SPARROW[name])
    worker = _sparrow_worker(kw.pop("use_kernel"))
    cfg = _config(SPARROW_W, mesh, **kw)
    eng = teng.make_engine(worker, cfg, CPU) if mesh is None else teng.make_engine(worker, cfg)
    return _summary(eng.run())


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def run_on_mesh(mesh, runs):
    """``runs``: name -> (period, dec, EngineConfig without a mesh). Each
    through ``make_engine`` on ``mesh`` with the shardable toy; the
    results without their models. A rank function for other modules'
    worlds (tests/test_torch_chaos.py's pod mesh)."""
    out = {}
    for name, (period, dec, cfg) in runs.items():
        res = teng.make_engine(ShardableTorchToy(period, dec), dataclasses.replace(cfg, mesh=mesh)).run()
        out[name] = dataclasses.replace(res, final_models=[])
    return out


def _errors(mesh, pod_mesh):
    """The factory's and the engine's refusals on a real mesh, as text."""
    out = {}
    toy = ShardableTorchToy(*_busy(8))

    class NoWorkers:
        size, axis_names, device = mesh.size, ("data",), mesh.device

    class BadPodOrder:
        size, axis_names, device = mesh.size, ("workers", "pod"), mesh.device

    cases = {
        "no_workers_axis": lambda: teng.make_engine(toy, _config(8, NoWorkers())),
        "bad_pod_axis_order": lambda: teng.make_engine(toy, _config(8, BadPodOrder())),
        "pods_zero": lambda: tmesh.make_worker_mesh(mesh.size, pods=0, device=CPU),
        "pods_indivisible": lambda: tmesh.make_worker_mesh(mesh.size, pods=3, device=CPU),
        "bad_cross_pod_every_k": lambda: teng.make_engine(toy, _config(8, pod_mesh, cross_pod_every_k=0)),
        "bad_cross_pod_top_k": lambda: teng.make_engine(toy, _config(8, pod_mesh, cross_pod_top_k=0)),
        # the card by default; without one it raises before any collective
        "default_device": lambda: tmesh.make_worker_mesh(mesh.size),
        "world_size": lambda: tmesh.make_worker_mesh(mesh.size - 1, device=CPU),
        "indivisible": lambda: teng.make_engine(
            ShardableTorchToy(*_busy(mesh.size + 1)), _config(mesh.size + 1, mesh)),
        "bad_mode": lambda: teng.make_engine(toy, _config(8, mesh, gossip_mode="sparse")),
        "bad_device": lambda: ShardedTMSNEngine(toy, _config(8, mesh), device="meta"),
    }
    for k, fn in cases.items():
        try:
            fn()
            out[k] = None
        except Exception as e:  # the test asserts the type and the text
            out[k] = (type(e).__name__, str(e))
    out["engine_type"] = type(teng.make_engine(toy, _config(8, mesh))).__name__
    # a pod mesh builds the sharded engine, as the reference's make_engine does
    out["pod_mesh"] = type(teng.make_engine(toy, _config(8, pod_mesh))).__name__
    # pods=2 again in the same world: a second set of pod groups
    again = tmesh.make_worker_mesh(mesh.size, pods=2, device=CPU)
    out["pods_arg"] = (again.axis_names, again.shape, again.pod, again.intra.rank, again.intra.size)
    return out


def _collectives(mesh):
    r = mesh.rank
    tree = {
        "f": torch.tensor([-0.0, float("nan"), float(r), float("inf")]),
        "b": torch.tensor([True, r % 2 == 1]),
        "i": torch.arange(3, dtype=torch.int64).reshape(3, 1) + 10 * r,
    }
    g = tmesh.all_gather_tree(mesh, tree)
    b = tmesh.broadcast_tree(mesh, {"x": torch.full((2,), -0.0) if r == mesh.size - 1 else torch.ones(2)},
                             mesh.size - 1)
    rng = np.random.default_rng(5)
    xb = torch.from_numpy(rng.integers(0, 8, (2 * mesh.size, 300, 16), dtype=np.int32))
    w = torch.from_numpy(rng.random((2 * mesh.size, 300)).astype(np.float32))
    wy = w * torch.from_numpy(np.where(rng.random((2 * mesh.size, 300)) < 0.5, 1.0, -1.0).astype(np.float32))
    from repro_torch.kernels import ops as tops

    sharded = tops.edge_scan_sharded(xb, wy, w, mesh=mesh, num_bins=8)
    whole = tops.edge_scan(xb, wy, w, num_bins=8)
    return dict(
        f_bits=g["f"].view(torch.int32).tolist(), b=g["b"].tolist(), i=g["i"].reshape(-1).tolist(),
        bcast_bits=b["x"].view(torch.int32).tolist(),
        any0=tmesh.all_reduce(mesh, False, "any"), any1=tmesh.all_reduce(mesh, r == 1, "any"),
        max=tmesh.all_reduce(mesh, 3 * r, "max"), sum=tmesh.all_reduce(mesh, r + 1, "sum"),
        objects=tmesh.all_gather_object(mesh, ("rank", r)),
        edge_scan_equal=all(torch.equal(a, b) for a, b in zip(sharded, whole)),
        collectives=mesh.collectives, backend=mesh.backend, host_staged=mesh.host_staged,
        shape=mesh.shape, axis_names=mesh.axis_names,
    )


def _pod_collectives(pod_mesh):
    """One gather over the pod (tier 1) and one over the world (tier 2)."""
    r = pod_mesh.rank
    pod_mesh.collectives = pod_mesh.intra.collectives = 0
    intra = tmesh.all_gather_tree(pod_mesh.intra, {"r": torch.tensor([r])})
    world = tmesh.all_gather_tree(pod_mesh, {"r": torch.tensor([r])})
    return dict(intra=intra["r"].tolist(), world=world["r"].tolist(), tier1=pod_mesh.intra.collectives,
                tier2=pod_mesh.collectives)


# ---------------------------------------------------------------------------
# the reference's TestShardedSGDWorker (tests/test_worker_contract.py:400-470)
# ---------------------------------------------------------------------------

SGD_W = 8
#: name -> config kwargs; "sgd_pod" runs on the world's pod mesh
SGD = {
    "sgd_dense": dict(gossip_mode="dense"),
    "sgd_gated": dict(gossip_mode="gated", gossip_top_k=1),
    "sgd_sparse_inflight": dict(gossip_mode="dense", inflight_capacity=SGD_W),
    "sgd_pod": dict(gossip_mode="dense", cross_pod_every_k=1, cross_pod_top_k=1),
}


def _sgd_worker():
    """tests/test_worker_contract.py's ``_sgd_worker`` on the port."""
    from repro_torch.core.sgd_worker import lm_sgd_worker
    from repro_torch.core.tmsn_sgd import TMSNSGDConfig
    from repro_torch.models.config import ArchConfig
    from repro_torch.optim import AdamWConfig

    tiny = ArchConfig(name="tiny-contract", arch_type="llama", num_layers=1, d_model=16, num_heads=2,
                      num_kv_heads=2, d_ff=32, vocab=64, remat=False, compute_dtype="float32")
    return lm_sgd_worker(tiny, AdamWConfig(lr=1e-2), TMSNSGDConfig(local_steps=2, ema=0.8, width_coef=1.0),
                         batch_size=2, seq=8, device=CPU)


def _digest(params):
    """Every leaf's bytes, in one hash: equal digests are equal bits."""
    import hashlib

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _run_sgd(name, mesh=None):
    cfg = _config(SGD_W, mesh, max_rounds=8, **SGD[name])
    eng = teng.make_engine(_sgd_worker(), cfg, CPU) if mesh is None else teng.make_engine(_sgd_worker(), cfg)
    res = eng.run()
    return dict(certs=res.final_certificates, history=res.history, rounds=res.rounds,
                models=[_digest(m) for m in res.final_models],
                **{f: getattr(res, f) for f in COUNTERS})


def _rank_program(mesh):
    pod_mesh = tmesh.make_worker_mesh(mesh.size, pods=PODS, device=CPU)
    out = {"toy": {name: _run_toy(name, mesh) for name in TOY}}
    out["sparrow"] = {name: _run_sparrow(name, mesh) for name in SPARROW}
    out["pod"] = {name: _run_toy(name, pod_mesh, POD) for name in POD}
    out["pod_flat"] = {name: _run_toy(name, mesh, POD_FLAT) for name in POD_FLAT}
    out["pod_sparrow"] = _run_sparrow("sparrow_dense", pod_mesh)
    out["sgd"] = {name: _run_sgd(name, pod_mesh if name == "sgd_pod" else mesh) for name in SGD}
    out["pod_mesh"] = dict(axis_names=pod_mesh.axis_names, shape=pod_mesh.shape, pod=pod_mesh.pod,
                           **_pod_collectives(pod_mesh))
    out["errors"] = _errors(mesh, pod_mesh)
    out["collectives"] = _collectives(mesh)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: tmesh.spawn_world(_rank_program, [CPU] * n, tmp_path_factory.mktemp(f"world{n}"))
            for n in WORLDS}


@pytest.fixture(scope="module")
def single():
    """The single-device runs, at the ranks' one intra-op thread
    (``spawn_world``), so both sides reduce in the same order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from repro_torch.core.tmsn_sgd import oracle_run

        return {"toy": {name: _run_toy(name) for name in TOY},
                "sparrow": {name: _run_sparrow(name) for name in SPARROW},
                "pod_flat": {name: _run_toy(name, None, POD_FLAT) for name in POD_FLAT},
                "sgd": _run_sgd("sgd_dense"),
                "sgd_oracle": oracle_run(_sgd_worker(), SGD_W, 8, eps=0.0, seed=0).certs}
    finally:
        torch.set_num_threads(threads)


def _assert_match(got, want, level):
    for f in ("certs", "history", "rounds", "messages_accepted"):
        assert got[f] == want[f], f
    if "adopted_from" in want:
        assert got["adopted_from"] == want["adopted_from"]
    if level == "all":
        for f in (*COUNTERS, "sim_time", "cost", "published"):
            assert got.get(f) == want.get(f), f


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(TOY))
def test_toy_matches_single_device(worlds, single, n, name):
    _assert_match(worlds[n][0]["toy"][name], single["toy"][name], TOY[name][3])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(SPARROW))
def test_sparrow_matches_single_device(worlds, single, n, name):
    got, want = worlds[n][0]["sparrow"][name], single["sparrow"][name]
    for f in ("certs", "history", "rounds", "messages_accepted", "messages_evicted", "models"):
        assert got[f] == want[f], f
    if name.startswith("sparrow_dense"):
        assert got["messages_sent"] == want["messages_sent"]
        assert got["messages_discarded"] == want["messages_discarded"]
    assert min(got["certs"]) < 0.0  # it learned
    assert got["messages_accepted"] > 0


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(SGD))
def test_sgd_matches_single_device_and_oracle(worlds, single, n, name):
    """Every sharded leg of the reference's TestShardedSGDWorker, bit for
    bit: the single-device engine's certificates, history, adoptions and
    final parameters, and the oracle's certificates."""
    got, want = worlds[n][0]["sgd"][name], single["sgd"]
    for f in ("certs", "history", "rounds", "messages_accepted", "models"):
        assert got[f] == want[f], f
    assert np.asarray(got["certs"], np.float32).view(np.int32).tolist() == \
        single["sgd_oracle"].view(np.int32).tolist()
    assert got["messages_accepted"] > 0 and got["messages_evicted"] == 0
    if name in ("sgd_dense", "sgd_sparse_inflight"):
        assert got["messages_sent"] == want["messages_sent"]
    if name == "sgd_pod":
        assert 0 < got["messages_sent_dcn"] <= got["messages_sent"]


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_returns_the_same_result(worlds, n):
    res = worlds[n]
    for r in range(1, n):
        assert res[r]["toy"] == res[0]["toy"]
        assert res[r]["sparrow"] == res[0]["sparrow"]
        assert res[r]["pod"] == res[0]["pod"]
        assert res[r]["pod_sparrow"] == res[0]["pod_sparrow"]
        assert res[r]["sgd"] == res[0]["sgd"]


@pytest.mark.parametrize("n", WORLDS)
def test_gating_shrinks_traffic_but_not_the_run(worlds, single, n):
    toy = worlds[n][0]["toy"]
    assert 0 < toy["gated_uniform"]["messages_sent"] < toy["dense_uniform"]["messages_sent"]
    assert toy["gated_uniform"]["history"] == toy["dense_uniform"]["history"]
    assert toy["queues_c1"]["messages_evicted"] > 0  # eviction happened, and matched
    assert toy["auto_capacity"]["inflight_capacity_selected"] >= 1
    assert toy["faults_queues"]["messages_dropped_injected"] > 0
    assert toy["faults_queues"]["messages_corrupt_rejected"] > 0
    assert toy["churn"]["workers_joined"] == 2
    assert toy["publisher"]["published"]
    assert toy["single_sender_target_rpd8"]["rounds"] == toy["single_sender_target"]["rounds"] == 10


@pytest.mark.parametrize("n", WORLDS)
def test_byte_accounting(worlds, n):
    """The reference's formulas (engine_sharded.py:334-382, one pod) at
    W workers, n ranks, payload p = 8, k = 1."""
    toy, p = worlds[n][0]["toy"], 8
    w = 16
    assert toy["dense_uniform"]["gossip_bytes"] == w * (p + 4 + 1)
    assert toy["dense_uniform"]["control_bytes"] == w * 5
    assert toy["gated_uniform"]["gossip_bytes"] == w * 5 + n * (p + 4)
    assert toy["gated_top3"]["gossip_bytes"] == w * 5 + n * min(3, w // n) * (p + 4)
    assert toy["sparse_control_queues"]["control_bytes"] == n * 12
    assert toy["sparse_control_queues"]["gossip_bytes"] == n * 12 + w * p
    assert toy["sparse_control_gated"]["gossip_bytes"] == n * 12 + n * p
    assert toy["dense_uniform"]["mode"] == "dense" and toy["gated_uniform"]["mode"] == "gated"
    w8 = worlds[n][0]["toy"]["dense_delay2"]
    assert (w8["gossip_bytes"], w8["control_bytes"]) == (8 * (p + 5), 40)


def test_single_device_reports_no_wire(single):
    res = single["toy"]["gated_uniform"]
    assert (res["gossip_bytes"], res["control_bytes"], res["mode"]) == (0, 0, "dense")


@pytest.mark.parametrize("n", WORLDS)
def test_factory_and_refusals(worlds, n):
    err = worlds[n][0]["errors"]
    assert err["engine_type"] == "ShardedTMSNEngine"
    assert err["no_workers_axis"] == ("ValueError", "engine mesh needs a 'workers' axis, got ('data',)")
    # a pod mesh now builds the engine and a second pod mesh in the same
    # world builds; the reference's refusals, text for text
    assert err["pod_mesh"] == "ShardedTMSNEngine"
    assert err["pods_arg"] == (("pod", "workers"), {"pod": 2, "workers": n // 2}, 0, 0, n // 2)
    assert err["bad_pod_axis_order"] == (
        "ValueError", "engine mesh must have axes ('workers',) or ('pod', 'workers'), got ('workers', 'pod')")
    assert err["pods_zero"] == ("ValueError", "pods=0 must be >= 1")
    assert err["pods_indivisible"] == ("ValueError", f"num_devices={n} must divide into 3 pods")
    assert err["bad_cross_pod_every_k"] == ("ValueError", "cross_pod_every_k must be >= 1, got 0")
    assert err["bad_cross_pod_top_k"] == ("ValueError", "cross_pod_top_k must be >= 1, got 0")
    assert err["indivisible"][0] == "ValueError" and "must divide over" in err["indivisible"][1]
    assert err["bad_mode"][0] == "ValueError" and "gossip_mode" in err["bad_mode"][1]
    assert err["bad_device"][0] == "ValueError"
    if not torch.cuda.is_available():
        assert err["default_device"][0] == "RuntimeError" and "cuda" in err["default_device"][1]
    assert err["world_size"][0] == "ValueError" and "world size" in err["world_size"][1]


def test_factory_without_a_world():
    toy = ShardableTorchToy(*_busy(4))

    class OneRank:
        size, axis_names, device = 1, ("workers",), torch.device(CPU)

    assert type(teng.make_engine(toy, _config(4, None), CPU)) is teng.TMSNEngine
    assert type(teng.make_engine(toy, _config(4, OneRank()))) is teng.TMSNEngine
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        tmesh.make_worker_mesh(2, device=CPU)
    assert tmesh.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert tmesh.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert tmesh.backend_for(["cpu", "cpu"]) == "gloo"
    assert tmesh.ici_round_seconds(450, bandwidth=450e9) == 1e-9


@pytest.mark.parametrize("n", WORLDS)
def test_collectives_copy_bits(worlds, n):
    c = worlds[n][1]["collectives"]  # rank 1's view
    nan_bits = torch.tensor([float("nan")]).view(torch.int32).item()
    want_f = []
    for r in range(n):
        want_f += torch.tensor([-0.0, float(r), float("inf")]).view(torch.int32).tolist()
        want_f.insert(len(want_f) - 2, nan_bits)
    assert c["f_bits"] == want_f  # -0.0 and the NaN payload survive
    assert c["b"] == [v for r in range(n) for v in (True, r % 2 == 1)]
    assert c["i"] == [v + 10 * r for r in range(n) for v in range(3)]
    assert c["bcast_bits"] == torch.full((2,), -0.0).view(torch.int32).tolist()
    assert (c["any0"], c["any1"], c["max"], c["sum"]) == (0, 1, 3 * (n - 1), n * (n + 1) // 2)
    assert c["objects"] == [("rank", r) for r in range(n)]
    assert c["edge_scan_equal"]
    assert (c["backend"], c["host_staged"], c["shape"], c["axis_names"]) == (
        "gloo", False, {"workers": n}, ("workers",))


# ---------------------------------------------------------------------------
# the pod mesh (the reference's TestPodMesh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", [k for k, v in POD.items() if v[3]])
def test_pod_k1_identical_to_flat_and_single_device(worlds, single, n, name):
    """k = 1 under uniform delay: certificates, history, rounds, accepted
    and adoptions of the flat 1-D engine and of one device (dense, gated,
    sparse control on queues; fail-stop and laggards)."""
    got = worlds[n][0]["pod"][name]
    twin = POD[name][3]
    for want in (worlds[n][0]["pod_flat"][twin], single["pod_flat"][twin]):
        for f in ("certs", "history", "rounds", "messages_accepted", "adopted_from"):
            assert got[f] == want[f], f
    assert 0 < got["messages_sent_dcn"] < got["messages_sent"]


@pytest.mark.parametrize("n", WORLDS)
def test_pod_chunked_dispatch_identical(worlds, n):
    pod = worlds[n][0]["pod"]
    assert pod["rpd8"]["certs"] == pod["rpd1"]["certs"]
    assert pod["rpd8"]["history"] == pod["rpd1"]["history"]


def _monotone(res):
    last: dict = {}
    for _, wid, cert in res["history"]:
        assert np.isfinite(cert) and cert <= last.get(wid, np.inf), wid
        last[wid] = cert


@pytest.mark.parametrize("n", WORLDS)
def test_pod_k_gt_1_is_measured_approximation(worlds, n):
    """k > 1 trades DCN traffic for staleness: certificates stay sound and
    the amortized DCN bytes fall k-fold; end-state equality is not
    asserted (the divergence is reported, not assumed)."""
    k1, k8 = worlds[n][0]["pod"]["k1_dense"], worlds[n][0]["pod"]["k8"]
    assert k8["gossip_bytes_per_round_dcn"] * 8 == k1["gossip_bytes_per_round_dcn"]
    assert k8["gossip_bytes_per_round_ici"] == k1["gossip_bytes_per_round_ici"]
    assert 0 < k8["messages_sent_dcn"] < k1["messages_sent_dcn"]
    assert all(c <= 0.0 for c in k8["certs"])
    _monotone(k8)


@pytest.mark.parametrize("n", WORLDS)
def test_pod_traffic_tier_accounting(worlds, n):
    """The reference's tier formulas at W = 32, payload 8 B, dense
    control, cross_pod_every_k = 4, cross_pod_top_k = 2."""
    pod = worlds[n][0]["pod"]
    p, wpp, w_pod = 8, n // PODS, POD_W // PODS
    dense, gated = pod["bytes_dense"], pod["bytes_gated"]
    assert dense["gossip_bytes_per_round_ici"] == w_pod * (p + 4 + 1)
    assert dense["gossip_bytes_per_round_dcn"] == n * 2 * (p + 4 + 4) // 4
    assert dense["gossip_bytes"] == dense["gossip_bytes_per_round_ici"] + dense["gossip_bytes_per_round_dcn"]
    assert dense["control_bytes"] == w_pod * 5 + n * 2 * 8 // 4
    assert gated["gossip_bytes_per_round_ici"] == w_pod * 5 + wpp * 1 * (p + 4)
    assert dense["messages_sent"] > dense["messages_sent_dcn"] > 0


@pytest.mark.parametrize("n", WORLDS)
def test_pod_sparrow_k1_identical_to_flat(worlds, n):
    got, want = worlds[n][0]["pod_sparrow"], worlds[n][0]["sparrow"]["sparrow_dense"]
    for f in ("certs", "history", "rounds", "messages_accepted", "models"):
        assert got[f] == want[f], f
    assert got["messages_sent_dcn"] > 0 and min(got["certs"]) < 0.0


@pytest.mark.parametrize("n", WORLDS)
def test_pod_env_defaults_flow_into_the_engine(worlds, n):
    res = worlds[n][0]["pod"]["env_defaults"]
    assert res["gossip_bytes_per_round_dcn"] > 0
    assert all(c <= 0.0 for c in res["certs"])
    assert res["messages_sent"] >= res["messages_sent_dcn"] > 0


@pytest.mark.parametrize("n", WORLDS)
def test_pod_mesh_layout_and_tiers(worlds, n):
    """pod is the slow axis; tier 1 gathers the pod's ranks, tier 2 the
    world, each counted on its own mesh."""
    for r, res in enumerate(worlds[n]):
        m = res["pod_mesh"]
        wpp = n // PODS
        assert (m["axis_names"], m["shape"], m["pod"]) == (("pod", "workers"), {"pod": PODS, "workers": wpp},
                                                           r // wpp)
        assert m["intra"] == [(r // wpp) * wpp + i for i in range(wpp)]
        assert m["world"] == list(range(n))
        assert (m["tier1"], m["tier2"]) == (1, 1)
