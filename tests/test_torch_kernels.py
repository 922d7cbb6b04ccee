"""The port's kernels (K1 edge_scan, K2 round_step, K3 queue_ingest, K4
weight_update with scatter_model_slice) held against the JAX reference.

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs its plain
PyTorch version; these tests hold that against the reference's Pallas
kernels (``repro.kernels.ops`` in interpret mode, as
``tests/test_kernels.py`` runs them) and against ``repro.kernels.ref``.
Tolerances: K1 sums floats in another order, so ``allclose`` at
rtol = atol = 1e-5 (the reference's own kernel tolerance); K2 and K3 are
comparison and permutation logic, so ``array_equal``; K4 at rtol 1e-4 /
atol 1e-5, the reference's own tolerance for it.

tests/test_torch_cuda.py holds the CUDA kernels themselves against
these plain versions on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.boosting import stumps as jst  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.weight_update import scatter_model_slice as j_scatter  # noqa: E402
from repro_torch.boosting.stumps import StumpModel as TStumpModel  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import scatter_model_slice as t_scatter  # noqa: E402

# the reference oracles, compiled once per shape instead of op by op
_round_step_ref = jax.jit(jref.round_step_ref, static_argnames="eps")
_queue_ingest_ref = jax.jit(jref.queue_ingest_ref)
_edge_scan_ref = jax.jit(jref.edge_scan_ref, static_argnames="num_bins")
_weight_update_ref = jax.jit(jref.weight_update_ref, static_argnames="num_bins")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _assert_equal(name, want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, name
    np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# K1 edge_scan
# ---------------------------------------------------------------------------


def _scan_inputs(seed, w, n, d, num_bins):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, num_bins, (w, n, d), dtype=np.int32)
    wt = (rng.random((w, n)) + 0.05).astype(np.float32)
    y = np.where(rng.random((w, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    return xb, (wt * y).astype(np.float32), wt


def _assert_scan_close(want, got):
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


class TestEdgeScan:
    """Mirrors tests/test_kernels.py::TestEdgeScanKernel."""

    @pytest.mark.parametrize("n", [1, 7, 513, 2048])
    @pytest.mark.parametrize("d,num_bins", [(4, 8), (16, 16), (33, 5)])
    def test_matches_reference(self, n, d, num_bins):
        """Against ``edge_scan_ref``, which the reference's own tests pin
        to its Pallas kernel."""
        xb, wy, w = _scan_inputs(n * 131 + d, 1, n, d, num_bins)
        got = tops.edge_scan(_t(xb), _t(wy), _t(w), num_bins=num_bins)
        _assert_scan_close(_edge_scan_ref(xb[0], wy[0], w[0], num_bins=num_bins), [g[0] for g in got])

    @pytest.mark.parametrize("tile_n", [64, 512])
    def test_matches_pallas_kernel(self, tile_n):
        """Against the Pallas kernel itself (interpret mode), with n not
        a multiple of its tile."""
        xb, wy, w = _scan_inputs(tile_n, 1, 1000, 12, 8)
        got = tops.edge_scan(_t(xb), _t(wy), _t(w), num_bins=8)
        kern = jops.edge_scan(xb[0], wy[0], w[0], num_bins=8, tile_n=tile_n, interpret=True)
        _assert_scan_close(kern, [g[0] for g in got])

    def test_batched_matches_reference_per_worker(self):
        """One batched (W, n, d) call == W reference launches (the
        batched-scanner contract, ``edge_scan_batched`` in the reference)."""
        xb, wy, w = _scan_inputs(9, 3, 300, 6, 8)
        got = tops.edge_scan(_t(xb), _t(wy), _t(w), num_bins=8)
        assert got[0].shape == (3, 6, 8)
        kern = jops.edge_scan_batched(xb, wy, w, num_bins=8, tile_n=128, interpret=True)
        _assert_scan_close(kern, got)
        for i in range(3):
            one = _edge_scan_ref(xb[i], wy[i], w[i], num_bins=8)
            _assert_scan_close(one, [g[i] for g in got])

    def test_zero_weight_rows_add_nothing(self):
        """Rows with w = wy = 0 — how the scanner masks rows past a full
        cycle — leave every output unchanged, like the reference's
        padded tile rows."""
        xb, wy, w = _scan_inputs(6, 2, 100, 4, 8)
        pad = np.random.default_rng(1).integers(0, 8, (2, 28, 4), dtype=np.int32)
        xb2 = np.concatenate([xb, pad], axis=1)
        wy2 = np.concatenate([wy, np.zeros((2, 28), np.float32)], axis=1)
        w2 = np.concatenate([w, np.zeros((2, 28), np.float32)], axis=1)
        base = tops.edge_scan(_t(xb), _t(wy), _t(w), num_bins=8)
        padded = tops.edge_scan(_t(xb2), _t(wy2), _t(w2), num_bins=8)
        # a longer sum may round in another order: same 1e-5 as above
        _assert_scan_close([a.numpy() for a in base], padded)
        _assert_scan_close(_edge_scan_ref(xb[0], wy[0], w[0], num_bins=8), [g[0] for g in padded])

    def test_rejects_bad_inputs(self):
        xb, wy, w = _scan_inputs(0, 1, 8, 4, 8)
        with pytest.raises(TypeError):
            tops.edge_scan(_t(xb).long(), _t(wy), _t(w), num_bins=8)
        with pytest.raises(ValueError):
            tops.edge_scan(_t(xb)[0], _t(wy)[0], _t(w)[0], num_bins=8)
        with pytest.raises(ValueError):
            tops.edge_scan(_t(xb), _t(wy), _t(w), num_bins=33)


# ---------------------------------------------------------------------------
# K2 round_step
# ---------------------------------------------------------------------------

_ROUND_NAMES = ["q_cert", "best_cert", "best_src", "best_slot", "take", "n_arr", "credit", "active"]


def _round_inputs(seed, w, cap, fill=0.6):
    rng = np.random.default_rng(seed)
    q_cert = np.where(
        rng.random((w, cap)) < fill, -rng.random((w, cap)) - 0.01, np.inf
    ).astype(np.float32)
    q_due = rng.integers(0, 4, (w, cap), dtype=np.int32)
    q_src = rng.integers(0, w, (w, cap), dtype=np.int32)
    q_slot = rng.integers(0, 3, (w, cap), dtype=np.int32)
    certs0 = (-rng.random(w)).astype(np.float32)
    alive = rng.random(w) < 0.8
    credit = rng.random(w).astype(np.float32)
    speed = np.linspace(0.2, 1.0, w).astype(np.float32)
    return q_cert, q_due, q_src, q_slot, certs0, alive, credit, speed


def _round_got(args, r, eps):
    return tops.round_deliver(*[_t(a) for a in args], r, eps=eps)


class TestRoundStep:
    """Mirrors tests/test_kernels.py::TestRoundStepKernel: bit-exact."""

    @pytest.mark.parametrize("w", [1, 7, 128, 200])
    @pytest.mark.parametrize("cap", [1, 5, 32])
    def test_matches_reference(self, w, cap):
        """Against ``round_step_ref``, which the reference's own tests
        pin bit-exact to its Pallas kernel."""
        args = _round_inputs(w * 37 + cap, w, cap)
        for r in (0, 2):
            got = _round_got(args, r, 0.01)
            ref = _round_step_ref(*args, jnp.int32(r), eps=0.01)
            for name, a, c in zip(_ROUND_NAMES, ref, got):
                _assert_equal(name, a, c)

    @pytest.mark.parametrize("tile_w", [8, 256])
    def test_matches_pallas_kernel_any_tile(self, tile_w):
        """Against the Pallas kernel itself (interpret mode): W=100 rows
        padded up to its tile, and the port equals it at every tile."""
        args = _round_inputs(3, 100, 4)
        got = _round_got(args, 1, 0.0)
        kern = jops.round_deliver(*args, jnp.int32(1), eps=0.0, tile_w=tile_w, interpret=True)
        for name, b, c in zip(_ROUND_NAMES, kern, got):
            _assert_equal(name, b, c)

    def test_empty_queue_delivers_nothing(self):
        w, cap = 9, 3
        args = (
            np.full((w, cap), np.inf, np.float32),
            np.full((w, cap), -1, np.int32),
            np.zeros((w, cap), np.int32),
            np.zeros((w, cap), np.int32),
            np.zeros(w, np.float32),
            np.ones(w, bool),
            np.zeros(w, np.float32),
            np.ones(w, np.float32),
        )
        got = _round_got(args, 0, 0.0)
        ref = _round_step_ref(*args, jnp.int32(0), eps=0.0)
        assert not bool(got[4].any())  # no take
        assert int(got[5].sum()) == 0  # no arrivals
        assert bool(got[7].all())  # every alive worker is credit-active
        for name, a, c in zip(_ROUND_NAMES, ref, got):
            _assert_equal(name, a, c)

    def test_credit_threshold_is_float32(self):
        """credit + speed landing exactly on float32(1 - 1e-6) is active:
        the reference compares in float32, not in double."""
        c = np.float32(1.0 - 1e-6)
        args = (
            np.full((1, 1), np.inf, np.float32), np.full((1, 1), -1, np.int32),
            np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
            np.zeros(1, np.float32), np.ones(1, bool),
            np.array([c], np.float32), np.zeros(1, np.float32),
        )
        got = _round_got(args, 0, 0.0)
        ref = _round_step_ref(*args, jnp.int32(0), eps=0.0)
        assert bool(got[7][0]) and bool(np.asarray(ref[7])[0])


# ---------------------------------------------------------------------------
# K3 queue_ingest
# ---------------------------------------------------------------------------


def _ingest_inputs(seed, w, cap, m, fill=0.6):
    rng = np.random.default_rng(seed)

    def certs(shape):
        return np.where(rng.random(shape) < fill, -rng.random(shape) - 0.01, np.inf).astype(np.float32)

    return (
        certs((w, cap)),
        rng.integers(0, 6, (w, cap), dtype=np.int32),
        rng.integers(0, w, (w, cap), dtype=np.int32),
        rng.integers(0, 3, (w, cap), dtype=np.int32),
        certs((w, m)),
        rng.integers(0, 6, (w, m), dtype=np.int32),
        rng.integers(0, w, (w, m), dtype=np.int32),
        rng.integers(0, 3, (w, m), dtype=np.int32),
    )


def _ingest_got(args):
    return tops.queue_ingest(*[_t(a) for a in args])


class TestQueueIngest:
    """Mirrors tests/test_kernels.py::TestQueueIngestKernel: bit-exact."""

    @pytest.mark.parametrize("w", [1, 7, 128, 200])
    @pytest.mark.parametrize("cap,m", [(1, 1), (4, 3), (8, 16), (32, 8)])
    def test_matches_reference(self, w, cap, m):
        """Against ``queue_ingest_ref``, which the reference's own tests
        pin bit-exact to its Pallas kernel."""
        args = _ingest_inputs(w * 31 + cap + m, w, cap, m)
        got = _ingest_got(args)
        ref = _queue_ingest_ref(*args)
        for name, a, c in zip(["cert", "due", "src", "slot"], ref, got):
            _assert_equal(name, a, c)

    def test_ties_keep_column_order(self):
        """Fully tied (cert, src, due) keys: the earlier column (a
        resident entry) survives, as the reference's stable lexsort."""
        w, cap, m = 5, 3, 4
        q = (np.full((w, cap), -1.0, np.float32), np.full((w, cap), 2, np.int32),
             np.full((w, cap), 1, np.int32), np.arange(w * cap, dtype=np.int32).reshape(w, cap))
        c = (np.full((w, m), -1.0, np.float32), np.full((w, m), 2, np.int32),
             np.full((w, m), 1, np.int32), 100 + np.arange(w * m, dtype=np.int32).reshape(w, m))
        got = _ingest_got(q + c)
        _assert_equal("slot", q[3], got[3])
        _assert_equal("slot", _queue_ingest_ref(*(q + c))[3], got[3])

    @pytest.mark.parametrize("tile_w", [8, 256])
    def test_matches_pallas_kernel_any_tile(self, tile_w):
        """Against the Pallas kernel itself (interpret mode), W=100 rows
        padded up to its tile."""
        args = _ingest_inputs(5, 100, 6, 8)
        got = _ingest_got(args)
        kern = jops.queue_ingest(*args, tile_w=tile_w, interpret=True)
        for name, b, c in zip(["cert", "due", "src", "slot"], kern, got):
            _assert_equal(name, b, c)

    def test_no_valid_candidates_is_a_noop(self):
        """An all-invalid (+inf) block leaves a full, sorted queue as is."""
        w, cap, m = 9, 4, 5
        q_cert, q_due, q_src, q_slot, *_ = _ingest_inputs(11, w, cap, m, fill=1.0)
        order = np.asarray(jnp.lexsort((q_due, q_src, q_cert), axis=-1))
        queue = [np.take_along_axis(a, order, axis=1) for a in (q_cert, q_due, q_src, q_slot)]
        empty = [
            np.full((w, m), np.inf, np.float32),
            np.zeros((w, m), np.int32),
            np.full((w, m), -1, np.int32),
            np.zeros((w, m), np.int32),
        ]
        got = tops.queue_ingest(*[_t(a) for a in queue + empty])
        for name, a, b in zip(["cert", "due", "src", "slot"], queue, got):
            _assert_equal(name, a, b)

    def test_worst_first_eviction_keeps_best(self):
        args = (
            np.array([[-1.0, -3.0]], np.float32), np.array([[4, 4]], np.int32),
            np.array([[2, 5]], np.int32), np.array([[0, 1]], np.int32),
            np.array([[-2.0, np.inf]], np.float32), np.array([[6, 0]], np.int32),
            np.array([[7, -1]], np.int32), np.array([[2, 0]], np.int32),
        )
        cert, due, src, slot = tops.queue_ingest(*[_t(a) for a in args])
        np.testing.assert_array_equal(cert.numpy(), [[-3.0, -2.0]])
        np.testing.assert_array_equal(src.numpy(), [[5, 7]])
        np.testing.assert_array_equal(due.numpy(), [[4, 6]])
        np.testing.assert_array_equal(slot.numpy(), [[1, 2]])


@pytest.mark.parametrize("w,n", [(3, 40), (16, 24)])
def test_lexsort_matches_jnp_lexsort(w, n):
    """The port's lexsort (successive stable sorts) == jnp.lexsort,
    including fully tied keys."""
    rng = np.random.default_rng(w * n)
    keys = tuple(rng.integers(0, 3, (w, n), dtype=np.int32) for _ in range(3))
    want = np.asarray(jnp.lexsort(keys, axis=-1))
    got = tref.lexsort(tuple(_t(k) for k in keys), dim=-1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_launch_counts_only_count_kernel_launches():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    tops.reset_launches()
    xb, wy, w = _scan_inputs(0, 2, 16, 4, 8)
    tops.edge_scan(_t(xb), _t(wy), _t(w), num_bins=8)
    args = _round_inputs(0, 4, 3)
    tops.round_deliver(*[_t(a) for a in args], 0, eps=0.0)
    tops.queue_ingest(*[_t(a) for a in _ingest_inputs(0, 4, 3, 2)])
    xb, y, ml, ms, a, c = _weight_inputs(0, 9, 4, 8)
    tops.weight_update(_t(xb), _t(y), _t(ml), _t(ms), _t(a), _t(c), num_bins=8)
    assert tops.LAUNCHES == {"edge_scan": 0, "round_step": 0, "queue_ingest": 0, "weight_update": 0}


# ---------------------------------------------------------------------------
# K4 weight_update and scatter_model_slice
# ---------------------------------------------------------------------------


def _weight_inputs(seed, n, d, num_bins, lo=0, hi=None):
    """Bins in ``[lo, hi)`` (``[0, B)`` by default), labels, margins and
    a random coefficient table with ``c = 0.3 * sum(A)``, as
    tests/test_kernels.py::TestWeightUpdateKernel draws them."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(lo, num_bins if hi is None else hi, (n, d), dtype=np.int32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    ml = (rng.standard_normal(n) * 0.5).astype(np.float32)
    ms = (rng.standard_normal(n) * 0.5).astype(np.float32)
    a = (rng.standard_normal((d, num_bins - 1)) * 0.1).astype(np.float32)
    return xb, y, ml, ms, a, np.float32(a.sum() * 0.3)


def _weight_close(want, got):
    for w_, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-5)


def _stump_models(seed, capacity, d, num_bins, count, repeat_cells=False):
    """The same ``count``-stump model in both packages; with
    ``repeat_cells`` every stump lands in one of 3 (feature, threshold)
    cells, so the scatter sums several coefficients per cell."""
    rng = np.random.default_rng(seed)
    live = np.arange(capacity) < count
    if repeat_cells:
        cells = rng.integers(0, 3, capacity)
        feat, thr = (cells % d).astype(np.int32), (cells % (num_bins - 1)).astype(np.int32)
    else:
        feat = rng.integers(0, d, capacity).astype(np.int32)
        thr = rng.integers(0, num_bins - 1, capacity).astype(np.int32)
    fields = (
        np.where(live, feat, 0).astype(np.int32),
        np.where(live, thr, 0).astype(np.int32),
        np.where(rng.random(capacity) < 0.5, 1.0, -1.0).astype(np.float32),
        np.where(live, rng.uniform(0.1, 1.0, capacity), 0.0).astype(np.float32),
        np.int32(count),
    )
    return jst.StumpModel(*(jnp.asarray(f) for f in fields)), TStumpModel(*(_t(f) for f in fields))


class TestWeightUpdate:
    """Mirrors tests/test_kernels.py::TestWeightUpdateKernel."""

    @pytest.mark.parametrize("n", [5, 512, 777])
    @pytest.mark.parametrize("d,num_bins", [(8, 8), (16, 32)])
    def test_matches_reference(self, n, d, num_bins):
        """Against ``weight_update_ref`` and the Pallas kernel itself
        (interpret mode), with n not a multiple of its tile."""
        xb, y, ml, ms, a, c = _weight_inputs(n + d, n, d, num_bins)
        got = tops.weight_update(_t(xb), _t(y), _t(ml), _t(ms), _t(a), _t(c), num_bins=num_bins)
        _weight_close(_weight_update_ref(xb, y, ml, ms, a, c, num_bins=num_bins), got)
        _weight_close(
            jops.weight_update(xb, y, ml, ms, a, c, num_bins=num_bins, tile_n=256, interpret=True), got
        )

    @pytest.mark.parametrize("repeat_cells", [False, True], ids=["distinct_cells", "repeated_cells"])
    def test_scatter_model_slice(self, repeat_cells):
        """``(A, c)`` equal the reference's on the same model, and K4 on
        the slice from zero margins is the stump-by-stump margin delta
        (the reference's ``margin_delta_oracle`` and the port's)."""
        d, num_bins, n, t_lo, t_hi = 6, 8, 64, 3, 10
        jm, tm = _stump_models(7, 16, d, num_bins, 10, repeat_cells)
        ja, jc = j_scatter(jm, t_lo, t_hi, num_bins, d)
        ta, tc = t_scatter(tm, t_lo, t_hi, num_bins, d)
        if repeat_cells:  # several coefficients per cell: summed in another order
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)
        # t_lo / t_hi as 0-d tensors: the same slice
        ta2, tc2 = t_scatter(tm, torch.tensor(t_lo), torch.tensor(t_hi), num_bins, d)
        assert torch.equal(ta, ta2) and torch.equal(tc, tc2)
        xb = np.random.default_rng(8).integers(0, num_bins, (n, d), dtype=np.int32)
        zeros = torch.zeros(n)
        m_new, _ = tops.weight_update(_t(xb), torch.ones(n), zeros, zeros, ta, tc, num_bins=num_bins)
        want = jref.margin_delta_oracle(jm, jnp.asarray(xb), t_lo, t_hi)
        np.testing.assert_allclose(m_new.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        ours = tref.margin_delta_oracle(tm, _t(xb), t_lo, t_hi)
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    def test_weight_clipping(self):
        """Extreme margins must not produce inf/nan; ``c`` as a float."""
        xb = torch.zeros((4, 2), dtype=torch.int32)
        y = torch.tensor([1.0, -1.0, 1.0, -1.0])
        ml = torch.tensor([100.0, -100.0, 0.0, 0.0])
        m_new, w = tops.weight_update(xb, y, ml, torch.zeros(4), torch.zeros((2, 7)), 0.0, num_bins=8)
        assert torch.isfinite(w).all()
        np.testing.assert_allclose(w.numpy(), np.exp([-30.0, -30.0, 0.0, 0.0]), rtol=1e-6)

    def test_out_of_range_bins(self):
        """Bins at or above B-1 turn every cut on, bins at or below 0
        none: the reference's semantics, on both sides of the range."""
        n, d, num_bins = 300, 8, 8
        xb, y, ml, ms, a, c = _weight_inputs(11, n, d, num_bins, lo=-3, hi=num_bins + 4)
        got = tops.weight_update(_t(xb), _t(y), _t(ml), _t(ms), _t(a), _t(c), num_bins=num_bins)
        _weight_close(_weight_update_ref(xb, y, ml, ms, a, c, num_bins=num_bins), got)
        clamped = np.clip(xb, 0, num_bins - 1)
        same = tops.weight_update(_t(clamped), _t(y), _t(ml), _t(ms), _t(a), _t(c), num_bins=num_bins)
        for g, s in zip(got, same):
            assert torch.equal(g, s)

    def test_rejects_bad_inputs(self):
        xb, y, ml, ms, a, c = (_t(v) for v in _weight_inputs(0, 10, 4, 8))
        with pytest.raises(TypeError):
            tops.weight_update(xb.float(), y, ml, ms, a, c, num_bins=8)
        with pytest.raises(TypeError):
            tops.weight_update(xb, y.double(), ml, ms, a, c, num_bins=8)
        with pytest.raises(TypeError):
            tops.weight_update(xb, y, ml, ms, a, torch.tensor([1, 2]), num_bins=8)
        with pytest.raises(ValueError):
            tops.weight_update(xb, y, ml, ms, a[:, :3], c, num_bins=8)
        with pytest.raises(ValueError):
            tops.weight_update(xb, y[:5], ml, ms, a, c, num_bins=8)
        with pytest.raises(ValueError):
            tops.weight_update(xb[0], y, ml, ms, a, c, num_bins=8)
        with pytest.raises(ValueError):
            tops.weight_update(xb, y, ml, ms, torch.zeros((4, 32)), c, num_bins=33)
