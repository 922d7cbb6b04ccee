"""The worker conformance harness of tests/test_worker_contract.py
(``TestWorkerContract``, ``TestAdoptAfterJoin``, ``TestOptionalHooks``,
``TestEngineOracleEquivalence``) on the port's two production workers,
batched Sparrow (every optional hook) and TMSN-SGD (none), on the CPU:
state and certificate shapes, masked rows bitwise unchanged at zero
cost, adoption the identity where ``take`` is False, monotone
certificates under a random protocol, a spare's rows untouched until it
joins, the optional-hook machinery, and the round engine bit for bit
equal to the dense delay-1 oracle (``repro_torch.core.tmsn_sgd.oracle_run``).
Elastic membership is exact only if masked rows stay bitwise untouched.
Imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker  # noqa: E402
from repro_torch.boosting.scanner import ScannerConfig  # noqa: E402
from repro_torch.boosting.sparrow import SparrowConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, MembershipPlan, TMSNEngine  # noqa: E402
from repro_torch.core.sgd_worker import lm_sgd_worker  # noqa: E402
from repro_torch.core.tmsn_sgd import TMSNSGDConfig, oracle_run  # noqa: E402
from repro_torch.core.worker import (  # noqa: E402
    BatchedTMSNWorker,
    export_payload_rows,
    has_resample_hooks,
    payload_bytes_from_export,
    resolve_payload_bytes,
    tree_leaves,
    tree_map,
)
from repro_torch.data.splice import SpliceConfig, make_splice_like, train_test_split  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

W = 4  # worker count every harness case uses
ROUNDS = 8
CPU = "cpu"


def np_uniforms(stream: int, draw: int) -> float:
    return float(np.float32(np.random.default_rng([stream, draw]).random()))


@pytest.fixture(scope="module")
def sparrow_worker():
    """The reference harness's Sparrow worker, sized for CI, with an ESS
    threshold that makes resamples happen within a few segments."""
    xb, y, _ = make_splice_like(SpliceConfig(n=4_000, d=12, num_bins=8, seed=3), device=CPU)
    xtr, ytr, _, _ = train_test_split(xb, y)
    cfg = SparrowConfig(
        sample_size=256, capacity=16, scanner=ScannerConfig(chunk_size=128, num_bins=8, gamma0=0.25),
        n_workers=W, ess_threshold=0.9,
    )
    return BatchedSparrowWorker(xtr, ytr, cfg, device=CPU, uniforms=np_uniforms)


#: tests/test_worker_contract.py:71's TINY_ARCH
TINY_ARCH = ArchConfig(name="tiny-contract", arch_type="llama", num_layers=1, d_model=16, num_heads=2,
                       num_kv_heads=2, d_ff=32, vocab=64, remat=False, compute_dtype="float32")


@pytest.fixture(scope="module")
def sgd_worker():
    """The reference harness's ``_sgd_worker``: TINY_ARCH, AdamW at lr
    1e-2, K = 2, ema 0.8, batch 2 x 8, the default token streams."""
    return lm_sgd_worker(TINY_ARCH, AdamWConfig(lr=1e-2),
                         TMSNSGDConfig(local_steps=2, ema=0.8, width_coef=1.0), batch_size=2, seq=8, device=CPU)


@pytest.fixture(params=["sparrow", "sgd"])
def worker(request, sparrow_worker, sgd_worker):
    return sparrow_worker if request.param == "sparrow" else sgd_worker


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_rows_equal(tree_a, tree_b, rows):
    """Bitwise (so -0.0 != +0.0 and NaN == NaN) on the given rows."""
    rows = torch.as_tensor(rows)
    for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
        assert torch.equal(_bits(a)[rows], _bits(b)[rows])


class TestWorkerContract:
    def test_state_and_certificate_shapes(self, worker):
        state = worker.init_batch(W, seed=0)
        for leaf in tree_leaves(state):
            assert leaf.shape[:1] == (W,), f"leaf {leaf.shape} lacks the (W,) axis"
        certs = worker.certificates(state)
        assert certs.shape == (W,) and certs.dtype == torch.float32
        for leaf in tree_leaves(worker.export_models(state)):
            assert leaf.shape[:1] == (W,)
        _, cost, fired = worker.scan_round(state, torch.ones((W,), dtype=torch.bool))
        assert cost.shape == (W,) and fired.shape == (W,)
        assert fired.dtype == torch.bool

    def test_masked_rows_unchanged_at_zero_cost(self, worker):
        state = worker.init_batch(W, seed=0)
        state, _, _ = worker.scan_round(state, torch.ones((W,), dtype=torch.bool))
        mask = torch.tensor([True, False, True, False])
        for _ in range(4):  # a few segments, so the masked rows fall behind
            new, cost, fired = worker.scan_round(state, mask)
            off = ~mask
            _assert_rows_equal(new, state, off)
            assert torch.equal(cost[off], torch.zeros(2)) and not fired[off].any()
            state = new

    def test_resample_touches_only_its_rows(self, sparrow_worker):
        """Rows not resampled, the per-worker draw count among them, come
        back bitwise unchanged at zero cost (Sparrow: the SGD worker has
        no resample hooks)."""
        worker = sparrow_worker
        state = worker.init_batch(W, seed=0)
        state, _, _ = worker.scan_round(state, torch.ones((W,), dtype=torch.bool))
        do = torch.tensor([False, True, False, True])
        new, cost = worker.resample_round(state, do)
        _assert_rows_equal(new, state, ~do)
        assert torch.equal(cost[~do], torch.zeros(2))
        assert torch.equal(new.draws, state.draws + do.to(torch.int32))

    def test_adopt_identity_where_take_false(self, worker):
        state = worker.init_batch(W, seed=0)
        state, _, _ = worker.scan_round(state, torch.ones((W,), dtype=torch.bool))
        donors = torch.tensor([1, 2, 3, 0])
        in_models = tree_map(lambda a: a[donors], worker.export_models(state))
        in_certs = worker.certificates(state)[donors] - 1.0
        new, cost = worker.adopt_batch(state, in_models, in_certs, torch.zeros((W,), dtype=torch.bool))
        _assert_rows_equal(new, state, torch.arange(W))
        assert torch.equal(cost, torch.zeros(W))

    def test_certificates_monotone_under_random_protocol(self, worker):
        rng = np.random.default_rng(7)
        state = worker.init_batch(W, seed=1)
        certs = worker.certificates(state).clone()
        for _ in range(8):
            mask = torch.as_tensor(rng.random(W) < 0.7)
            if has_resample_hooks(worker):
                need = worker.needs_resample(state) & mask
                if need.any():
                    state, _ = worker.resample_round(state, need)
                mask = mask & ~need
            state, _, _ = worker.scan_round(state, mask)
            after = worker.certificates(state)
            assert bool((after <= certs + 1e-7).all()), (after, certs)
            certs = after.clone()
            donors = torch.as_tensor(rng.permutation(W))
            in_models = tree_map(lambda a: a[donors], worker.export_models(state))
            in_certs = certs[donors]
            take = torch.as_tensor(rng.random(W) < 0.5) & (in_certs < certs)
            state, _ = worker.adopt_batch(state, in_models, in_certs, take)
            after = worker.certificates(state)
            assert bool((after <= certs + 1e-7).all()), (after, certs)
            certs = after.clone()


def _engine_cfg(**kw):
    base = dict(n_workers=W, eps=0.0, max_rounds=ROUNDS, delay_rounds=1, seed=0, fault_spec="",
                rounds_per_dispatch=1, inflight_capacity=0, control_plane="dense", publish_every_k=0,
                round_step_impl="pallas")
    base.update(kw)
    return EngineConfig(**base)


class TestAdoptAfterJoin:
    def test_adopt_into_fresh_spare_row_is_identity_elsewhere(self, worker):
        state = worker.init_batch(W, seed=0)
        init = state
        member_mask = torch.tensor([True] * (W - 1) + [False])
        for _ in range(3):
            state, _, _ = worker.scan_round(state, member_mask)
        _assert_rows_equal(state, init, [W - 1])  # the spare is as init_batch left it
        certs = worker.certificates(state)
        best = int(torch.argmin(certs[: W - 1]))
        donors = torch.full((W,), best, dtype=torch.int64)
        in_models = tree_map(lambda a: a[donors], worker.export_models(state))
        take = torch.tensor([False] * (W - 1) + [True])  # only the joiner
        new, cost = worker.adopt_batch(state, in_models, certs[donors], take)
        _assert_rows_equal(new, state, torch.arange(W - 1))
        assert torch.equal(cost[: W - 1], torch.zeros(W - 1))
        assert _bits(worker.certificates(new))[W - 1] == _bits(certs)[best]

    def test_spare_untouched_by_the_engine_until_it_joins(self, worker):
        """The engine's own rounds (delivery, scan, resample, adoption)
        leave a masked spare's worker rows bitwise as init_batch made them."""
        eng = TMSNEngine(worker, _engine_cfg(spare_slots=1, membership=MembershipPlan(joins=((6, W - 1),))),
                         device=CPU)
        state = eng._init_state()
        init = state.worker
        for _ in range(5):  # rounds 0..4: the spare joins at round index 5
            state, _ = eng._round_step(state)
            _assert_rows_equal(state.worker, init, [W - 1])
        assert not bool(state.alive[W - 1])
        state, _ = eng._round_step(state)
        assert bool(state.alive[W - 1])

    def test_engine_join_run(self, worker):
        res = TMSNEngine(
            worker, _engine_cfg(spare_slots=1, membership=MembershipPlan(joins=((2, W - 1),))), device=CPU
        ).run()
        assert res.workers_joined == 1 and res.rounds == ROUNDS
        per_worker: dict = {}
        for _, wid, cert in res.history:
            prev = per_worker.get(wid)
            assert prev is None or cert <= prev + 1e-7
            per_worker[wid] = cert
        assert any(wid == W - 1 and t > 0 for t, wid, _ in res.history)


class TestOptionalHooks:
    def test_resample_hook_detection(self, sparrow_worker, sgd_worker):
        assert has_resample_hooks(sparrow_worker)
        assert not has_resample_hooks(sgd_worker)
        # an engine built over a hook-less worker drops the branch
        assert TMSNEngine(sgd_worker, _engine_cfg(max_rounds=1), device=CPU)._has_resample is False
        assert TMSNEngine(sparrow_worker, _engine_cfg(max_rounds=1), device=CPU)._has_resample is True

    def test_sparrow_hand_payload_bytes_matches_derived(self, sparrow_worker):
        hand = sparrow_worker.payload_bytes()
        assert hand == payload_bytes_from_export(sparrow_worker, W, seed=0)
        assert resolve_payload_bytes(sparrow_worker, W, seed=0) == hand

    def test_sgd_payload_bytes_derived(self, sgd_worker):
        """No hook on the SGD worker: resolution falls through to the
        derived value — the per-worker params footprint."""
        derived = resolve_payload_bytes(sgd_worker, W, seed=0)
        state = sgd_worker.init_batch(W, seed=0)
        models = sgd_worker.export_models(state)
        params_bytes = sum(a[0].numel() * a.element_size() for a in tree_leaves(models))
        assert derived == params_bytes > 0

    def test_export_payload_rows_fallback(self, sparrow_worker, sgd_worker):
        rows = torch.tensor([2, 0])
        for w in (sparrow_worker, sgd_worker):
            state = w.init_batch(W, seed=0)
            got = export_payload_rows(w, state, rows)
            want = tree_map(lambda a: a[rows], w.export_models(state))
            assert all(torch.equal(g, x) for g, x in zip(tree_leaves(got), tree_leaves(want)))

    def test_protocol_default_bodies_inheritable(self):
        """A worker subclassing the protocol inherits working no-op
        resample hooks and the indexing payload-rows fallback."""

        class Minimal(BatchedTMSNWorker):
            def init_batch(self, n_workers, seed):
                return {"c": torch.zeros((n_workers,))}

            def scan_round(self, state, mask):
                return {"c": state["c"] - mask.float()}, mask.float(), mask

            def certificates(self, state):
                return state["c"]

            def export_models(self, state):
                return {"m": state["c"]}

            def adopt_batch(self, state, models, certs, take):
                return {"c": torch.where(take, certs, state["c"])}, torch.zeros_like(state["c"])

        w = Minimal()
        state = w.init_batch(3, 0)
        assert not w.needs_resample(state).any()
        same, cost = w.resample_round(state, torch.ones(3, dtype=torch.bool))
        assert torch.equal(same["c"], state["c"]) and not cost.any()
        assert export_payload_rows(w, state, torch.tensor([1]))["m"].shape == (1,)
        with pytest.raises(NotImplementedError):
            w.payload_bytes()
        assert resolve_payload_bytes(w, 3, seed=0) == 4


class TestEngineOracleEquivalence:
    def test_engine_matches_oracle(self, worker):
        """Uniform speed, delay 1, no failures: the round engine is bit for
        bit the worker-level synchronous oracle, for both production
        workers. (The reference's own pin fails for SGD by one ulp: XLA
        compiles its engine and its oracle into different programs. The
        port runs both eagerly, op for op.)"""
        orc = oracle_run(worker, W, ROUNDS, eps=0.0, seed=0)
        res = TMSNEngine(worker, _engine_cfg(), device=CPU).run()
        assert np.asarray(res.final_certificates, np.float32).view(np.int32).tolist() == \
            orc.certs.view(np.int32).tolist()
        assert np.all(np.diff(orc.history, axis=0) <= 0.0)

    def test_sgd_engine_history_monotone(self, sgd_worker):
        res = TMSNEngine(sgd_worker, _engine_cfg(), device=CPU).run()
        per_worker: dict = {}
        for _, wid, cert in res.history:
            prev = per_worker.get(wid)
            assert prev is None or cert <= prev
            per_worker[wid] = cert
        assert res.rounds == ROUNDS
        assert res.bytes_broadcast > 0  # derived payload_bytes flowed in
