"""The worker conformance harness of tests/test_worker_contract.py
(``TestWorkerContract``, ``TestAdoptAfterJoin``) on the port's batched
Sparrow worker, on the CPU: state and certificate shapes, masked rows
bitwise unchanged at zero cost, adoption the identity where ``take`` is
False, monotone certificates under a random protocol, and a spare's
rows untouched until it joins. Elastic membership is exact only if
masked rows stay bitwise untouched. The SGD half waits for the port's
SGD worker (ROADMAP.md queue 1 item 13). Imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker  # noqa: E402
from repro_torch.boosting.scanner import ScannerConfig  # noqa: E402
from repro_torch.boosting.sparrow import SparrowConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, MembershipPlan, TMSNEngine  # noqa: E402
from repro_torch.core.worker import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.splice import SpliceConfig, make_splice_like, train_test_split  # noqa: E402

W = 4  # worker count every harness case uses
ROUNDS = 8
CPU = "cpu"


def np_uniforms(stream: int, draw: int) -> float:
    return float(np.float32(np.random.default_rng([stream, draw]).random()))


@pytest.fixture(scope="module")
def worker():
    """The reference harness's Sparrow worker, sized for CI, with an ESS
    threshold that makes resamples happen within a few segments."""
    xb, y, _ = make_splice_like(SpliceConfig(n=4_000, d=12, num_bins=8, seed=3), device=CPU)
    xtr, ytr, _, _ = train_test_split(xb, y)
    cfg = SparrowConfig(
        sample_size=256, capacity=16, scanner=ScannerConfig(chunk_size=128, num_bins=8, gamma0=0.25),
        n_workers=W, ess_threshold=0.9,
    )
    return BatchedSparrowWorker(xtr, ytr, cfg, device=CPU, uniforms=np_uniforms)


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

    def test_resample_touches_only_its_rows(self, worker):
        """Rows not resampled, the per-worker draw count among them, come
        back bitwise unchanged at zero cost."""
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
            need = worker.needs_resample(state) & mask
            if need.any():
                state, _ = worker.resample_round(state, need)
            state, _, _ = worker.scan_round(state, mask & ~need)
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
