"""The port's sharded engine at world 4 (gloo, CPU ranks) against the
reference's ``ShardedTMSNEngine`` on 4 forced host devices, on the 1-D
``("workers",)`` mesh and on the two-tier ``("pod", "workers")`` mesh
of 2 pods of 2 (``make_worker_mesh(4, pods=2)`` on both sides).

The reference runs in a subprocess (this file run as a script) that sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before it imports
JAX; the driver's test command forces no host devices, so the
reference's sharded engine cannot run in the pytest process itself. The
subprocess wraps the reference's workers in a subclass whose
``export_models`` returns numpy leaves when they are concrete (the
installed JAX refuses the ``a[i]`` the reference's ``run()`` applies to
sharded final models; inside the scan the leaves are tracers and pass
through unchanged), and also returns the reference's minimal-variance
draws, which the port's Sparrow ranks then use.

Held: certificates, history, rounds, every counter,
``gossip_bytes_per_round``, ``control_bytes_per_round``, ``gossip_mode``,
the simulated clock and each worker's adoption, EXACTLY on the toy
worker (dense, gated and sparse control, single sender with a target,
fail-stop, laggards, a delay matrix, C = 1 eviction, a fault plan);
on the pod mesh also ``messages_sent_dcn`` and the ICI/DCN byte split
(dense and gated gossip, sparse control, queues, auto capacity,
``cross_pod_every_k`` 4 and 8, a partition window); on batched Sparrow,
flat and pod, the same (round, worker) history and every counter
exactly, certificates to 1e-5 (the port's single-device Sparrow
tolerance).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
N_DEV = 4

#: name -> (workload, W, config kwargs); workloads: "busy" (every worker
#: fires, period 1 or 2), "lone" (worker 0 alone fires), "even" (every
#: worker fires every segment), "delay" (period 1 or 2, larger steps),
#: "chaos" (tests/test_chaos.py's W = 8 toy)
SCENARIOS = {
    "dense_delay2": ("busy", 8, dict(max_rounds=30, delay_rounds=2)),
    "gated": ("busy", 8, dict(max_rounds=30, gossip_mode="gated")),
    "gated_sparse_c8": ("busy", 8, dict(max_rounds=30, gossip_mode="gated", control_plane="sparse",
                                        inflight_capacity=8)),
    "single_sender_target": ("lone", 16, dict(target_certificate=-0.95, max_rounds=500,
                                              rounds_per_dispatch=8)),
    "fail_stop": ("lone", 8, dict(fail_round=[5] + [10**6] * 7, max_rounds=30)),
    "laggards": ("even", 8, dict(speed=[1.0] * 6 + [0.25, 0.5], max_rounds=40)),
    "delay_matrix": ("delay", 8, dict(delay_matrix=True, max_rounds=25)),
    "gated_uniform_w16": ("busy", 16, dict(max_rounds=30, gossip_mode="gated")),
    "sparse_control_queues_w16": ("busy", 16, dict(max_rounds=30, inflight_capacity=16,
                                                   control_plane="sparse")),
    "queues_c1": ("busy", 8, dict(max_rounds=30, inflight_capacity=1)),
    "faults_queues": ("busy", 8, dict(max_rounds=24, inflight_capacity=16,
                                      fault=dict(drop_prob=0.1, duplicate_prob=0.3, corrupt_prob=0.1,
                                                 reorder_max=1, seed=13))),
    # the flat anchor of the pod runs below
    "dense_uniform_w16": ("busy", 16, dict(max_rounds=30)),
}
PODS = 2
#: on make_worker_mesh(N_DEV, pods=PODS): W = 16, 30 rounds, k = 1 unless set
POD_SCENARIOS = {
    "pod_dense": ("busy", 16, dict(max_rounds=30)),
    "pod_gated": ("busy", 16, dict(max_rounds=30, gossip_mode="gated")),
    "pod_gated_sparse_c8": ("busy", 16, dict(max_rounds=30, gossip_mode="gated", control_plane="sparse",
                                             inflight_capacity=8)),
    "pod_queues_c16": ("busy", 16, dict(max_rounds=30, inflight_capacity=16)),
    "pod_auto": ("busy", 16, dict(max_rounds=30, gossip_mode="gated", control_plane="sparse",
                                  inflight_capacity="auto")),
    "pod_k4": ("busy", 16, dict(max_rounds=30, cross_pod_every_k=4)),
    "pod_sparse_c8_k8": ("busy", 16, dict(max_rounds=30, gossip_mode="gated", control_plane="sparse",
                                          inflight_capacity=8, cross_pod_every_k=8)),
    "pod_partition": ("busy", 16, dict(max_rounds=30,
                                       fault=dict(partition_start=4, partition_stop=12, seed=1))),
    # tests/test_torch_chaos.py's drop scenario on its pod-mesh substrate
    "pod_drop_w8": ("chaos", 8, dict(max_rounds=24, rounds_per_dispatch=8,
                                     fault=dict(drop_prob=0.3, seed=7))),
}
#: (history entries, sent, sent_dcn, accepted, ICI B/round, DCN B/round,
#: dropped) of the flat anchor and the pod runs, as the reference's pod
#: engine gives them
POD_FIGURES = {
    "dense_uniform_w16": (488, 705, 0, 435, 208, 0, 0),
    "pod_dense": (488, 633, 304, 435, 104, 64, 0),
    "pod_gated": (488, 549, 304, 435, 64, 64, 0),
    "pod_gated_sparse_c8": (488, 549, 304, 435, 40, 80, 0),
    "pod_queues_c16": (488, 633, 304, 435, 104, 64, 0),
    "pod_auto": (488, 549, 304, 435, 40, 80, 0),
    "pod_k4": (337, 478, 128, 281, 104, 16, 0),
    "pod_sparse_c8_k8": (337, 390, 96, 277, 40, 10, 0),
    "pod_partition": (457, 708, 344, 399, 104, 64, 96),
    "pod_drop_w8": (167, 297, 168, 123, 52, 64, 88),
}
#: tests/test_chaos.py's PERIOD and DEC at its W = 8
CHAOS_PERIOD = [1, 2, 3, 1, 2, 3, 1, 2]
CHAOS_DEC = [0.5, 0.9, 1.3, 0.7, 1.1, 0.6, 0.8, 1.0]
SPARROW_W = 8
SPARROW_ROUNDS = 20
SPARROW_DRAWS = SPARROW_ROUNDS + 2
#: every env-steerable knob, pinned
PINNED = dict(
    fault_spec="", rounds_per_dispatch=1, gossip_mode="dense", cross_pod_every_k=1, cross_pod_top_k=1,
    spare_slots=0, publish_every_k=0, publish_eps=0.0, control_plane="dense", inflight_capacity=0,
)


def _workload(kind, w):
    if kind == "busy":
        return [1, 2] * (w // 2), [0.01 * (i + 1) for i in range(w)]
    if kind == "lone":
        return [1] + [10**9] * (w - 1), [0.1] * w
    if kind == "even":
        return [1] * w, [0.1] * w
    if kind == "chaos":
        return CHAOS_PERIOD, CHAOS_DEC
    return [1, 2] * (w // 2), [0.05 * (i + 1) for i in range(w)]


def _config_kwargs(module, w, kw, round_step_impl):
    kw = dict(kw)
    if kw.pop("delay_matrix", False):
        kw["delay_rounds"] = module.quantize_latency(0.05, 0.02, 0.05, w, seed=1)
    if "fault" in kw:
        kw["fault_plan"] = module.FaultPlan(**kw.pop("fault"))
    return {**PINNED, "n_workers": w, "round_step_impl": round_step_impl, **kw}


def _summary(res, models):
    return dict(
        certs=[float(c) for c in res.final_certificates], history=res.history, rounds=res.rounds,
        sim_time=res.sim_time, cost=res.cost_units_total, gossip_bytes=res.gossip_bytes_per_round,
        control_bytes=res.control_bytes_per_round, mode=res.gossip_mode, ici=res.gossip_bytes_per_round_ici,
        dcn=res.gossip_bytes_per_round_dcn, **{f: getattr(res, f) for f in COUNTERS}, models=models,
    )


COUNTERS = ("messages_sent", "messages_sent_dcn", "messages_accepted", "messages_discarded",
            "messages_evicted", "inflight_occupancy_peak", "messages_dropped_injected", "messages_corrupt_rejected",
            "inflight_capacity_selected", "events_processed", "bytes_broadcast")


def _sparrow_setup():
    """The small splice set and configs of tests/test_torch_engine.py's
    ``_sparrow_pair``, at W = 8."""
    sc = dict(chunk_size=128, num_bins=8, gamma0=0.05, use_kernel=False)
    base = dict(sample_size=400, capacity=32, n_workers=SPARROW_W, ess_threshold=0.95)
    ecfg = dict(max_rounds=SPARROW_ROUNDS, seed=0)
    return sc, base, ecfg


# ---------------------------------------------------------------------------
# the reference side: this file run as a script, in its own interpreter
# ---------------------------------------------------------------------------


def _reference_main(out_path):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={N_DEV}").strip()
    import jax
    import jax.numpy as jnp

    from repro.boosting import BatchedSparrowWorker, SparrowConfig
    from repro.boosting.scanner import ScannerConfig
    from repro.core import engine as jeng
    from repro.core.engine_sharded import ShardedTMSNEngine
    from repro.data.splice import SpliceConfig, make_splice_like
    from repro.launch.mesh import make_worker_mesh
    from test_sharded_engine import ShardableToyWorker

    assert len(jax.devices()) == N_DEV, jax.devices()

    def host_leaves(tree):
        # concrete leaves to numpy (run() indexes final models row by
        # row); tracers, inside the scan, unchanged
        return jax.tree_util.tree_map(
            lambda a: a if isinstance(a, jax.core.Tracer) else np.asarray(a), tree)

    class HostToy(ShardableToyWorker):
        def export_models(self, state):
            return host_leaves(super().export_models(state))

    class HostSparrow(BatchedSparrowWorker):
        def export_models(self, state):
            return host_leaves(super().export_models(state))

    mesh, pod_mesh = make_worker_mesh(N_DEV), make_worker_mesh(N_DEV, pods=PODS)
    assert pod_mesh.axis_names == ("pod", "workers")
    out = {"toy": {}, "pod": {}, "sparrow": {}}
    for key, m, table in (("toy", mesh, SCENARIOS), ("pod", pod_mesh, POD_SCENARIOS)):
        for name, (kind, w, kw) in table.items():
            cfg = jeng.EngineConfig(mesh=m, **_config_kwargs(jeng, w, kw, "ref"))
            eng = jeng.make_engine(HostToy(*_workload(kind, w)), cfg)
            assert isinstance(eng, ShardedTMSNEngine)
            res = eng.run()
            out[key][name] = _summary(res, [int(m["adopted_from"]) for m in res.final_models])

    sc, base, ecfg = _sparrow_setup()
    xb, y, _ = make_splice_like(SpliceConfig(n=2400, d=16, num_bins=8, seed=3))
    worker = HostSparrow(jnp.asarray(xb), jnp.asarray(y), SparrowConfig(scanner=ScannerConfig(**sc), **base))
    for name, m in (("dense", mesh), ("pod", pod_mesh)):
        cfg = jeng.EngineConfig(mesh=m, **_config_kwargs(jeng, SPARROW_W, ecfg, "ref"))
        res = jeng.make_engine(worker, cfg).run()
        out["sparrow"][name] = _summary(res, [int(m.count) for m in res.final_models])
    # the reference's minimal-variance offsets: draw j of stream s is
    # uniform(split(k_j)[1]), k_0 = PRNGKey(s), k_{j+1} = split(k_j)[0]
    draws = {}
    for i in range(SPARROW_W):
        s = ecfg["seed"] + 1000 * i
        k, row = jax.random.PRNGKey(s), []
        for _ in range(SPARROW_DRAWS):
            row.append(float(jax.random.uniform(jax.random.split(k)[1])))
            k = jax.random.split(k)[0]
        draws[s] = row
    out["draws"] = draws
    out["splice"] = (np.asarray(xb), np.asarray(y))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# the port side: a gloo world of N_DEV CPU ranks
# ---------------------------------------------------------------------------


class TableUniforms:
    """Injected minimal-variance offsets: draw ``j`` of stream ``s``."""

    def __init__(self, table):
        self.table = table

    def __call__(self, stream, draw):
        return self.table[int(stream)][int(draw)]


def _port_program(mesh, draws, splice):
    import torch

    from repro_torch import convert
    from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker
    from repro_torch.boosting.scanner import ScannerConfig
    from repro_torch.boosting.sparrow import SparrowConfig
    from repro_torch.core import engine as teng
    from repro_torch.launch.mesh import make_worker_mesh
    from test_torch_sharded_engine import ShardableTorchToy

    # the pod mesh over the same ranks as the world's flat one
    pod_mesh = make_worker_mesh(N_DEV, pods=PODS, device="cpu")
    out = {"toy": {}, "pod": {}, "sparrow": {}}
    for key, m, table in (("toy", mesh, SCENARIOS), ("pod", pod_mesh, POD_SCENARIOS)):
        for name, (kind, w, kw) in table.items():
            cfg = teng.EngineConfig(mesh=m, **_config_kwargs(teng, w, kw, "pallas"))
            res = teng.make_engine(ShardableTorchToy(*_workload(kind, w)), cfg).run()
            out[key][name] = _summary(res, [int(m["adopted_from"]) for m in res.final_models])
    sc, base, ecfg = _sparrow_setup()
    txb, ty = convert.dataset_from_numpy(*splice, "cpu")
    worker = BatchedSparrowWorker(txb, ty, SparrowConfig(scanner=ScannerConfig(**sc), **base), device="cpu",
                                  uniforms=TableUniforms(draws))
    for name, m in (("dense", mesh), ("pod", pod_mesh)):
        cfg = teng.EngineConfig(mesh=m, **_config_kwargs(teng, SPARROW_W, ecfg, "pallas"))
        res = teng.make_engine(worker, cfg).run()
        out["sparrow"][name] = _summary(res, [int(m.count) for m in res.final_models])
    assert torch.get_num_threads() == 1
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference") / "reference.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    pytest.importorskip("torch")
    from repro_torch.launch.mesh import spawn_world

    res = spawn_world(_port_program, ["cpu"] * N_DEV, tmp_path_factory.mktemp("world"),
                      args=(reference["draws"], reference["splice"]))
    for r in res[1:]:
        assert r == res[0]  # every rank returns the same result
    return res[0]


EXACT = ("certs", "history", "rounds", "sim_time", "cost", "gossip_bytes", "control_bytes", "mode", "ici",
         "dcn", "models", *COUNTERS)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_toy_matches_reference_sharded_engine(reference, port, name):
    got, want = port["toy"][name], reference["toy"][name]
    for f in EXACT:
        assert got[f] == want[f], f


def test_byte_figures_of_the_three_configurations(reference, port):
    """dense gossip at delay 2, gated gossip, gated gossip with sparse
    control at C = 8: W = 8 on 4 ranks, payload 8 B, k = 1."""
    for name, want in (("dense_delay2", (104, 40)), ("gated", (88, 40)), ("gated_sparse_c8", (80, 48))):
        for side in (reference, port):
            assert (side["toy"][name]["gossip_bytes"], side["toy"][name]["control_bytes"]) == want, name


@pytest.mark.parametrize("name", list(POD_SCENARIOS))
def test_pod_matches_reference_pod_engine(reference, port, name):
    got, want = port["pod"][name], reference["pod"][name]
    for f in EXACT:
        assert got[f] == want[f], f


@pytest.mark.parametrize("name", list(POD_FIGURES))
def test_pod_figures(reference, port, name):
    """History length, sent, sent_dcn, accepted, the ICI/DCN bytes and the
    drops of each pod run and its flat anchor, on both sides; at k = 1
    the final certificates of every W = 16 run are the same."""
    _, w, kw = POD_SCENARIOS.get(name) or SCENARIOS[name]
    for side in (reference, port):
        res = side["pod"].get(name) or side["toy"][name]
        got = (len(res["history"]), res["messages_sent"], res["messages_sent_dcn"], res["messages_accepted"],
               res["ici"], res["dcn"], res["messages_dropped_injected"])
        assert got == POD_FIGURES[name]
        if w == 16 and kw.get("cross_pod_every_k", 1) == 1:
            assert res["certs"] == side["toy"]["dense_uniform_w16"]["certs"]
    assert port["pod"]["pod_auto"]["inflight_capacity_selected"] >= 1


def test_pod_k1_equals_flat(port):
    """The pod mesh at k = 1 gives the flat engine's certificates, history
    and adoptions (the reference's TestPodMesh pin) on the port."""
    flat = port["toy"]["dense_uniform_w16"]
    for name in ("pod_dense", "pod_gated", "pod_gated_sparse_c8", "pod_queues_c16", "pod_auto"):
        got = port["pod"][name]
        assert (got["certs"], got["history"], got["messages_accepted"], got["models"]) == (
            flat["certs"], flat["history"], flat["messages_accepted"], flat["models"]), name
        assert 0 < got["messages_sent_dcn"] < got["messages_sent"]


def _assert_sparrow_matches(got, want):
    assert [h[:2] for h in got["history"]] == [h[:2] for h in want["history"]]
    np.testing.assert_allclose([h[2] for h in got["history"]], [h[2] for h in want["history"]],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["certs"], want["certs"], rtol=1e-5, atol=1e-6)
    for f in ("rounds", "models", "gossip_bytes", "control_bytes", "mode", "ici", "dcn", *COUNTERS):
        assert got[f] == want[f], f
    assert got["messages_accepted"] > 0 and min(got["certs"]) < 0.0


def test_sparrow_matches_reference_sharded_engine(reference, port):
    _assert_sparrow_matches(port["sparrow"]["dense"], reference["sparrow"]["dense"])


def test_sparrow_pod_matches_reference_pod_engine(reference, port):
    """Batched Sparrow at W = 8 on the pod mesh (W_local = 2, W_pod = 4)."""
    got = port["sparrow"]["pod"]
    _assert_sparrow_matches(got, reference["sparrow"]["pod"])
    assert got["messages_sent_dcn"] > 0 and got["dcn"] > 0
    # k = 1: the flat run's history and adoptions
    assert got["history"] == port["sparrow"]["dense"]["history"]


if __name__ == "__main__":
    _reference_main(sys.argv[1])
