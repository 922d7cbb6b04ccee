"""The port's kernels (K1 edge_scan, K2 round_step, K3 queue_ingest, K4
weight_update with scatter_model_slice) held against the JAX reference;
K5 adamw_step's input checks and its split of the leaf table into
launches (K5 runs on the card only; its plain version is the port's AdamW
update, held to the reference in tests/test_torch_sgd.py).

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs its plain
PyTorch version; these tests hold that against the reference's Pallas
kernels (``repro.kernels.ops`` in interpret mode, as
``tests/test_kernels.py`` runs them) and against ``repro.kernels.ref``.
Tolerances: K1 sums floats in another order, so ``allclose`` at
rtol = atol = 1e-5 (the reference's own kernel tolerance); K2 and K3 are
comparison and permutation logic, so equal bit for bit (floats compared
as their int32 bit patterns, so -0.0 differs from +0.0); K4 at rtol 1e-4
/ atol 1e-5, the reference's own tolerance for it.

tests/test_torch_cuda.py holds the CUDA kernels themselves against
these plain versions on the card.
"""

import re
from pathlib import Path

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
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.adamw import _corrections  # noqa: E402

# the reference oracles, compiled once per shape instead of op by op
_round_step_ref = jax.jit(jref.round_step_ref, static_argnames="eps")
_queue_ingest_ref = jax.jit(jref.queue_ingest_ref)
_edge_scan_ref = jax.jit(jref.edge_scan_ref, static_argnames="num_bins")
_weight_update_ref = jax.jit(jref.weight_update_ref, static_argnames="num_bins")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bits(a):
    """Bit pattern of an array: ``assert_array_equal`` calls -0.0 and +0.0 equal."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_equal(name, want, got):
    """Same dtype and the same bits."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, name
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


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


#: rows of one destination, all due and alive, src descending, where the
#: minimum is a tie at zero with mixed signs
_SIGNED_ZERO_ROWS = [[0.0, -0.0], [-0.0, 0.0], [0.0, -0.0, 0.0, -0.0, -0.0]]


def _signed_zero_inputs(row):
    c = len(row)
    return (
        np.array([row], np.float32), np.zeros((1, c), np.int32),
        np.arange(c, 0, -1, dtype=np.int32)[None], np.arange(c, dtype=np.int32)[None],
        np.zeros(1, np.float32), np.ones(1, bool), np.zeros(1, np.float32), np.ones(1, np.float32),
    )


def _round_edge_inputs(seed, w, cap):
    """Certs from a pool with +-0.0, +-inf and NaN; due in {-1, 0, 1}; src
    and slot from tiny ranges (negative src too), so that tie chains in
    cert -> src -> slot are common; about a third of the rows dead."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -0.5, -0.25], np.float32)
    return (
        pool[rng.integers(0, len(pool), (w, cap))],
        rng.integers(-1, 2, (w, cap), dtype=np.int32),
        rng.integers(-1, 3, (w, cap), dtype=np.int32),
        rng.integers(0, 2, (w, cap), dtype=np.int32),
        pool[rng.integers(4, len(pool), w)],
        rng.random(w) < 0.7,
        rng.random(w).astype(np.float32),
        rng.random(w).astype(np.float32),
    )


def _tie_chain_inputs():
    """Row 0: cert ties, src decides; row 1: cert and src tie, slot
    decides; row 2: the same entries, dead; row 3: nothing due this round."""
    cert = np.array([[-1.0, -1.0, -1.0, -2.0]] * 4, np.float32)
    due = np.array([[0, 0, 0, 1]] * 3 + [[1, -1, 1, 1]], np.int32)
    src = np.array([[3, 1, 2, 0], [2, 2, 2, 0], [2, 2, 2, 0], [0, 0, 0, 0]], np.int32)
    slot = np.array([[0, 5, 2, 0], [7, 4, 6, 0], [7, 4, 6, 0], [0, 0, 0, 0]], np.int32)
    alive = np.array([True, True, False, True])
    return cert, due, src, slot, np.zeros(4, np.float32), alive, np.zeros(4, np.float32), np.ones(4, np.float32)


_ROUND_EDGE_CASES = {
    **{f"signed_zero_{i}": (lambda row=row: _signed_zero_inputs(row)) for i, row in enumerate(_SIGNED_ZERO_ROWS)},
    "tie_chain": _tie_chain_inputs,
    **{f"pool_w{w}_c{cap}": (lambda w=w, cap=cap: _round_edge_inputs(w * 101 + cap, w, cap))
       for w, cap in [(13, 1), (11, 3), (9, 100), (21, 64)]},
}


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

    @pytest.mark.parametrize("case", list(_ROUND_EDGE_CASES))
    def test_edge_cases_bitwise(self, case):
        """Signed-zero ties, +-inf and NaN certs, tie chains in cert ->
        src -> slot, due = -1, dead rows, C in {1, 3, 100}, W not a multiple
        of 8: the port's plain version, the JAX reference, the reference's
        Pallas kernel (interpret mode) and the mirror of K2's key method
        (``ref.round_step_key_select``) agree bit for bit."""
        args = _ROUND_EDGE_CASES[case]()
        for r in (0, 1):
            got = _round_got(args, r, 0.01)
            want = _round_step_ref(*args, jnp.int32(r), eps=0.01)
            kern = jops.round_deliver(*args, jnp.int32(r), eps=0.01, tile_w=8, interpret=True)
            for name, a, b, c in zip(_ROUND_NAMES, want, kern, got):
                _assert_equal(name, a, c)
                _assert_equal(name, b, c)
            t = [_t(a) for a in args]
            mirror = tref.round_step_key_select(t[0], t[1], t[2], t[3], t[5], r)
            for name, a, c in zip(("best_cert", "best_src", "best_slot", "n_arr"), mirror, got[1:4] + got[5:6]):
                _assert_equal(name, c.numpy(), a)

    def test_signed_zero_rows(self):
        """The rows where ``torch.amin`` kept the first zero: -0.0 wins
        whatever the order, as in the reference."""
        for row in _SIGNED_ZERO_ROWS:
            best = _round_got(_signed_zero_inputs(row), 0, 0.0)[1]
            assert best.numpy().view(np.uint32)[0] == 0x80000000, row

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


def _ingest_edge_inputs(seed, w, cap, m):
    """Certificates from a small pool with +-0.0 and +-inf, src and due
    from tiny ranges with due = -1 padding: duplicate (cert, src, due)
    entries are common."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, -1.0, -0.5, -0.25], np.float32)

    def leaves(k):
        return (
            pool[rng.integers(0, len(pool), (w, k))],
            rng.integers(-1, 2, (w, k), dtype=np.int32),
            rng.integers(-1, 3, (w, k), dtype=np.int32),
            rng.integers(0, 2, (w, k), dtype=np.int32),
        )

    return leaves(cap) + leaves(m)


class TestQueueIngestKey:
    """The plain mirror of K3's 128-bit key (``ref.queue_ingest_keys``)
    and of its rank-select (``ref.queue_ingest_rank_select``): the order
    the CUDA kernel computes, checked here on the CPU bit for bit."""

    @pytest.mark.parametrize("w,cap,m", [(40, 6, 5), (16, 1, 3), (8, 4, 12), (5, 64, 1)])
    def test_key_order_is_the_reference_order(self, w, cap, m):
        args = [_t(a) for a in _ingest_edge_inputs(w * cap + m, w, cap, m)]
        cert, due, src, slot = (torch.cat([args[i], args[i + 4]], dim=1) for i in range(4))
        column = torch.arange(cap + m).expand(w, cap + m)
        key = tref.queue_ingest_keys(cert, due, src, column)
        assert key.shape == (w, cap + m, 4) and int(key.min()) >= 0 and int(key.max()) < 2**32
        order = tref.lexsort(tuple(key[..., k] for k in (3, 2, 1, 0)), dim=-1)[:, :cap]
        want = tref.queue_ingest_ref(*args)
        for a, b in zip((cert, due, src, slot), want):
            np.testing.assert_array_equal(_bits(torch.gather(a, 1, order).numpy()), _bits(b.numpy()))

    @pytest.mark.parametrize("w,cap,m", [(40, 6, 5), (16, 1, 3), (8, 4, 12), (5, 64, 1)])
    def test_rank_select_matches_reference(self, w, cap, m):
        """Bitwise equal to the port's ``queue_ingest_ref`` and to the JAX
        reference, -0.0 kept as -0.0."""
        arrays = _ingest_edge_inputs(w + 7 * cap + m, w, cap, m)
        got = tref.queue_ingest_rank_select(*[_t(a) for a in arrays])
        port = tref.queue_ingest_ref(*[_t(a) for a in arrays])
        jax_ref = _queue_ingest_ref(*arrays)
        for a, b, c in zip(got, port, jax_ref):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(c))

    def test_key_words(self):
        """-0.0 and +0.0 share a key, -inf < negatives < 0 < +inf, and the
        int32 fields flip their sign bit."""
        cert = _t(np.array([-np.inf, -1.0, -0.0, 0.0, 1.0, np.inf], np.float32))
        zeros = torch.zeros(6, dtype=torch.int32)
        key = tref.queue_ingest_keys(cert, zeros - 1, zeros + 2, torch.arange(6))
        c = key[:, 0].tolist()
        assert c[2] == c[3] == 0x80000000 and c == sorted(c) and len(set(c)) == 5
        assert key[0, 1] == 0x80000002 and key[0, 2] == 0x7FFFFFFF and key[5, 3] == 5


class TestPlans:
    """How the wrappers split K1, K2 and K3 on the card (pure functions)."""

    @pytest.mark.parametrize("nw,n", [(10, 2048), (256, 2048), (1, 2048), (1, 180_000), (3, 7), (1, 0), (4096, 1)])
    @pytest.mark.parametrize("sms", [132, 1])
    def test_edge_scan_plan_covers_every_row(self, nw, n, sms):
        tile_rows, tiles, group, fold = tops.edge_scan_plan(nw, n, sms)
        assert tiles >= 1 and tile_rows >= 1 and 1 <= group <= tiles and fold in (1, group)
        assert (tiles - 1) * tile_rows < max(n, 1) <= tiles * tile_rows  # no empty tile
        groups = -(-tiles // group)
        assert group <= tops.EDGE_SCAN_ONE_LEVEL_TILES or groups <= group
        # the split is the lone worker's whatever W: W sets only the fold
        assert tops.edge_scan_plan(1, n, sms)[:3] == (tile_rows, tiles, group)
        if sms == 132 and n >= 2048:  # the main shapes come within a worker of the target
            target = tops.EDGE_SCAN_BLOCKS_PER_SM * sms
            blocks = nw * -(-tiles // fold)
            assert blocks > min(target - nw, -(-n // tops.EDGE_SCAN_MIN_TILE_ROWS) * nw - 1)

    @pytest.mark.parametrize("nw", [1, 10, 4096, 10240])
    @pytest.mark.parametrize("cap", [1, 64, 3500])
    def test_round_step_plan(self, nw, cap):
        """16-byte loads where C % 4 == 0; the fewest lanes a row that cover
        it in one pass (16 at C = 64: two rows a warp); W = 10240 puts
        blocks of 8 warps on every SM."""
        sms = 132
        vec, lanes, warps_per_block = tops.round_step_plan(nw, cap, sms)
        assert vec == (4 if cap % 4 == 0 else 1)
        assert lanes in (1, 2, 4, 8, 16, 32) and 1 <= warps_per_block <= tops.ROUND_STEP_MAX_WARPS
        assert lanes == 32 or (lanes * vec >= cap and (lanes // 2) * vec < cap) or lanes == 1
        rows_per_warp = 32 // lanes
        warps = -(-nw // rows_per_warp)
        blocks = -(-warps // warps_per_block)
        assert rows_per_warp == {1: 32, 64: 2, 3500: 1}[cap]
        assert blocks * warps_per_block * rows_per_warp >= nw > (blocks - 1) * warps_per_block * rows_per_warp
        if warps >= tops.ROUND_STEP_MAX_WARPS * sms:  # W = 10240: full blocks on every SM
            assert warps_per_block == tops.ROUND_STEP_MAX_WARPS and blocks >= sms
        else:  # smaller W: fewer warps a block, at least one block a SM where W allows
            assert blocks >= min(warps, sms)
        assert tops.round_step_plan(nw, cap, sms, aligned=False)[0] == 1

    @pytest.mark.parametrize("nw,n", [(10, 65), (4096, 65), (4096, 72), (3, 3520), (7, 2)])
    def test_queue_ingest_plan(self, nw, n):
        rows, row_threads = tops.queue_ingest_plan(nw, n, 132)
        assert row_threads == min(n, 1024) and rows * row_threads <= 1024  # a thread per entry
        if nw <= 132:
            assert rows == 1


@pytest.mark.parametrize("lead", [(), (3,)])
def test_edge_histogram_cpu_is_plain_and_matches_reference(lead):
    """On CPU tensors ``edge_histogram`` is the plain scatter-add (no
    launch) and equals the JAX package's histogram."""
    from repro_torch.boosting import stumps as tst

    rng = np.random.default_rng(len(lead))
    xb = rng.integers(0, 8, (*lead, 300, 12), dtype=np.int32)
    wy = (rng.random((*lead, 300)) - 0.5).astype(np.float32)
    tops.reset_launches()
    got = tst.edge_histogram(_t(xb), _t(wy), 8)
    assert tops.LAUNCHES["edge_scan"] == 0
    assert torch.equal(got, tst.edge_histogram_plain(_t(xb), _t(wy), 8))
    want = np.stack([np.asarray(jst.edge_histogram(jnp.asarray(x), jnp.asarray(v), 8))
                     for x, v in zip(xb.reshape(-1, 300, 12), wy.reshape(-1, 300))]).reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


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
    assert tops.LAUNCHES == {"edge_scan": 0, "round_step": 0, "queue_ingest": 0, "weight_update": 0,
                             "adamw_step": 0, "attention_fwd": 0, "attention_bwd": 0}


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


# ---------------------------------------------------------------------------
# K5 adamw_step: the wrapper's checks and its launch plan
# ---------------------------------------------------------------------------

_ADAMW_CFG = AdamWConfig(lr=1e-2)


def _adamw_scalars(step=3, lr=1e-2):
    b1c, b2c = _corrections(torch.tensor(step, dtype=torch.int32), _ADAMW_CFG)
    return b1c, b2c, lr


def _adamw_leaves(seed, shapes, pdt, sdt):
    """(p, g, mu, nu, p', mu', nu') per shape, the outputs distinct tensors."""
    rng = np.random.default_rng(seed)

    def draw(shape, dt, scale=1.0, positive=False):
        a = rng.normal(size=shape) * scale
        return torch.from_numpy((np.abs(a) if positive else a).astype(np.float32)).to(dt)

    return [(draw(s, pdt), draw(s, pdt, 1e-2), draw(s, sdt, 1e-2), draw(s, sdt, 1e-4, True),
             torch.empty(s, dtype=pdt), torch.empty(s, dtype=sdt), torch.empty(s, dtype=sdt)) for s in shapes]


@pytest.mark.parametrize("n", [0, 1, 13, 48, 49, 104])
def test_adamw_step_plan_splits_the_table_at_its_limit(n):
    """K5's launches cover the leaves once, in order, at most
    ``ADAMW_MAX_LEAVES`` a launch, in as few launches as that allows."""
    m = tops.ADAMW_MAX_LEAVES
    runs = tops.adamw_step_plan(n)
    assert [i for lo, hi in runs for i in range(lo, hi)] == list(range(n))
    assert all(1 <= hi - lo <= m for lo, hi in runs)
    assert len(runs) == -(-n // m)


def test_adamw_step_plan_limit_is_the_kernels_table():
    """The limit is the table ``adamw_step.cu`` compiles, and one launch
    holds a one-layer model's leaves."""
    src = (Path(tops.__file__).parent / "csrc" / "adamw_step.cu").read_text()
    assert int(re.search(r"constexpr int kMaxLeaves = (\d+);", src).group(1)) == tops.ADAMW_MAX_LEAVES
    assert tops.adamw_step_plan(13) == [(0, 13)]


def test_adamw_step_checks_its_inputs():
    """Leaves off the card (K5 has no plain version; ``apply_updates_``
    sends them to ``_update``), dtypes other than float32/bfloat16, a state
    dtype other than the config's, mismatched shapes, a non-contiguous
    leaf, a leaf that is not seven tensors and a correction of more than
    one value all raise, and nothing launches."""
    b1c, b2c, lr = _adamw_scalars()
    f32 = torch.float32

    def call(leaf, **kw):
        tops.adamw_step([leaf], kw.get("b1c", b1c), b2c, lr, _ADAMW_CFG)

    good = _adamw_leaves(2, [(4, 6)], f32, f32)[0]
    before = [t.clone() for t in good[4:]]
    tops.reset_launches()
    with pytest.raises(ValueError, match="no plain version"):
        call(good)
    assert tops.LAUNCHES["adamw_step"] == 0
    # the outputs are never written: the same bits (as int32: the empty
    # buffers may hold NaN patterns, which equal nothing as floats)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(good[4:], before))
    tops.adamw_step([], b1c, b2c, lr, _ADAMW_CFG)
    with pytest.raises(TypeError):
        call(tuple(t.half() for t in good))
    with pytest.raises(TypeError):
        call(good[:2] + (good[2].bfloat16(),) + good[3:])
    with pytest.raises(ValueError):
        call(good[:1] + (good[1][:3],) + good[2:])
    with pytest.raises(ValueError):
        call(good[:4] + (torch.empty((6, 4), dtype=f32).t(),) + good[5:])
    with pytest.raises(ValueError):
        call(good[:6])
    with pytest.raises(TypeError):
        call(good, b1c=torch.ones(2))


# ---------------------------------------------------------------------------
# K6 attention: the wrapper's checks, its tile bounds and its instances
# ---------------------------------------------------------------------------


def _k6_args(dt=torch.bfloat16, b=2, s=5, H=4, K=2, hd=128, dv=None):
    """q, k, v, positions, dO of one layer on the CPU, every tensor K6
    would take but for the device."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen).to(dt)
                   for shape in ((b, s, H, hd), (b, s, K, hd), (b, s, K, dv or hd), (b, s, H, dv or hd)))
    return q, k, v, torch.arange(s, dtype=torch.int32).expand(b, s), do


def _k6_misaligned(t):
    """t's values at a start 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    return buf.copy_(t)


#: (what is wrong, the change to (q, k, v, positions, dO, window), the
#: error it raises, the words of its message)
_K6_REFUSED = {
    "cpu_tensors": (lambda a: a, ValueError, "CUDA tensors only"),
    "float32": (lambda a: tuple(t.float() if t.is_floating_point() else t for t in a[:5]) + a[5:], TypeError,
                "bfloat16"),
    "float16_k": (lambda a: (a[0], a[1].half()) + a[2:], TypeError, "k must be bfloat16"),
    "head_64": (lambda a: _k6_args(hd=64) + a[5:], ValueError, "no instance for head widths"),
    "head_96_values": (lambda a: _k6_args(dv=96) + a[5:], ValueError, "no instance for head widths"),
    "head_192_values_192": (lambda a: _k6_args(hd=192) + a[5:], ValueError, "no instance for head widths"),
    "misaligned_start": (lambda a: (_k6_misaligned(a[0]),) + a[1:], ValueError, "16-byte aligned"),
    "strided_width": (lambda a: (a[0],) + (torch.empty(2, 5, 2, 256, dtype=torch.bfloat16)[..., ::2],) + a[2:],
                      ValueError, "contiguous last dimension"),
    "stride_not_8": (lambda a: (torch.empty(2, 5, 4, 132, dtype=torch.bfloat16)[..., :128],) + a[1:], ValueError,
                     "multiples of 8"),
    "positions_int64": (lambda a: a[:3] + (a[3].long(),) + a[4:], TypeError, "int32"),
    "positions_shape": (lambda a: a[:3] + (a[3][:1],) + a[4:], ValueError, "positions must be"),
    "window_zero": (lambda a: a[:5] + (0,), ValueError, "window"),
    "heads_not_grouped": (lambda a: (_k6_args(H=3)[0],) + a[1:3] + (a[3], _k6_args(H=3)[4]) + a[5:], ValueError,
                          "not one GQA layer"),
    "kv_lengths_differ": (lambda a: (a[0], a[1][:, :4]) + a[2:], ValueError, "not one GQA layer"),
}


@pytest.mark.parametrize("case", sorted(_K6_REFUSED))
@pytest.mark.parametrize("entry", ["attention_fwd", "attention_bwd"])
def test_attention_refuses_what_it_does_not_take(case, entry, monkeypatch):
    """K6's forward and backward raise, before any launch and without
    building the library, on CPU tensors (``_sdpa`` is the plain version:
    ``gqa_full`` routes them there), on dtypes other than bf16, on head
    widths it holds no instance of, on layouts it cannot read with 16-byte
    loads, on positions that are not (b, s) int32, on a window below 1
    and on shapes that are not one GQA layer."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "load_library", lambda: pytest.fail("the library was loaded"))
    change, err, words = _K6_REFUSED[case]
    q, k, v, pos, do, window = change(_k6_args() + (None,))
    b, s, H = q.shape[:3]
    tops.reset_launches()
    with pytest.raises(err, match=words):
        if entry == "attention_fwd":
            tops.attention_fwd(q, k, v, pos, window, 0.1)
        else:
            tops.attention_bwd(q, k, v, pos, torch.zeros_like(do), torch.zeros(b, H, s),
                               torch.zeros(tops.attention_bounds_shape(b, s), dtype=torch.int32), do, window, 0.1)
    assert tops.LAUNCHES["attention_fwd"] == tops.LAUNCHES["attention_bwd"] == 0


@pytest.mark.parametrize("what", ["o", "lse", "bounds", "do"])
def test_attention_bwd_checks_the_forwards_outputs(what):
    """The backward's own inputs (the forward's O, log-sum-exp and tile
    bounds, and dO) are checked for dtype and shape before the device."""
    q, k, v, pos, do = _k6_args()
    b, s, H = q.shape[:3]
    args = {"o": torch.zeros_like(do), "lse": torch.zeros(b, H, s),
            "bounds": torch.zeros(tops.attention_bounds_shape(b, s), dtype=torch.int32), "do": do}
    args[what] = args[what][..., :1]
    with pytest.raises(ValueError, match=f"attention_bwd {what}: expected shape"):
        tops.attention_bwd(q, k, v, pos, args["o"], args["lse"], args["bounds"], args["do"], None, 0.1)


@pytest.mark.parametrize("s,tiles", [(1, 1), (31, 1), (32, 1), (33, 2), (129, 5), (4096, 128)])
def test_attention_bounds_shape_covers_every_position(s, tiles):
    """One bounds entry (smallest, largest position) a run of
    ``ATTENTION_BOUNDS_ROWS`` positions, the last run possibly shorter."""
    assert tops.attention_bounds_shape(3, s) == (3, tiles, 2)
    assert (tiles - 1) * tops.ATTENTION_BOUNDS_ROWS < s <= tiles * tops.ATTENTION_BOUNDS_ROWS


def _c_int(expr: str, **names) -> int:
    """An integer constant expression of ``attention.cu`` (names, numbers,
    comparisons and one ``a ? b : c``) evaluated at ``names``."""
    m = re.fullmatch(r"(.+?)\s*\?\s*(.+?)\s*:\s*(.+)", expr.strip())
    if m:
        return _c_int(m.group(2) if _c_int(m.group(1), **names) else m.group(3), **names)
    assert re.fullmatch(r"[\w\s<>=!+\-*/()]+", expr), expr
    return int(eval(expr, {"__builtins__": {}}, names))


def test_attention_constants_are_the_kernels():
    """The bounds' rows are ``attention.cu``'s quantum; the tile shapes
    (``Tiles``) are one trait of the head widths, and at each pair the
    library holds every tile of the kernels is a whole number of quanta and
    every block is the launch bounds' block; the one table of instances
    (``with_instance``) holds exactly the head-width pairs the wrapper
    routes."""
    src = (Path(tops.__file__).parent / "csrc" / "attention.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"^constexpr int (k\w+) = (\d+);", src, re.M)}
    assert consts["kQuantum"] == tops.ATTENTION_BOUNDS_ROWS
    traits = re.findall(r"template <int DQK, int DV>\nstruct Tiles \{(.*?)\n\};", src, re.S)
    assert len(traits) == 1 and "struct Tiles<" not in src
    steps = dict(re.findall(r"static constexpr int (k\w+) = ([^;]+);", traits[0]))
    assert set(steps) == {"kFwdKeys", "kDqKeys", "kDkvRows"}, steps
    shapes = {m.group(1): (int(m.group(2)), int(m.group(3)))
              for m in re.finditer(r"using (\w+)Shape = Shape<(\d+), (\d+)>;", traits[0])}
    assert set(shapes) == {"Fwd", "Dq", "Dkv"}, shapes
    assert all(16 * w * mt % consts["kQuantum"] == 0 for w, mt in shapes.values()), shapes
    assert all(32 * w == consts["kThreads"] for w, _ in shapes.values()), shapes
    for d_qk, d_v in tops.ATTENTION_HEAD_DIMS:
        at = {k: _c_int(e, DQK=d_qk, DV=d_v) for k, e in steps.items()}
        assert all(n > 0 and n % consts["kQuantum"] == 0 for n in at.values()), (d_qk, d_v, at)
    table = re.search(r"cudaError_t with_instance\(.*?\n\}", src, re.S).group(0)
    held = {(int(a), int(b)) for a, b in re.findall(r"f\(Widths<(\d+), (\d+)>\(\)\)", table)}
    assert held == set(tops.ATTENTION_HEAD_DIMS)
    assert src.count("with_instance(d_qk, d_v,") == 2  # the forward's launcher and the backward's
    # deterministic: no atomic function and no PTX atomic or reduction
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", src)


@pytest.mark.parametrize("fault", ["none", "late_rows_zeroed", "one_row_off", "one_key_row_off"])
def test_k6_block_errors_see_a_row_gone_wrong(fault):
    """The card check's measure (``chip_smoke.k6_block_errors``) on a
    float32 ``_sdpa`` against itself: 0 when nothing changed, and above
    ``K6_TOL`` where the last 300 rows of O are lost, or one query's dq or
    one key's dk is 10 % off."""
    from test_torch_cuda import _smoke

    b, s, H, K = 1, 1000, 8, 2
    pos = _smoke.k6_positions("index", b, s, "cpu")
    q, k, v, do = _smoke.k6_inputs(b, s, H, K, "cpu")
    want = _smoke.k6_run(_smoke.k6_plain(pos, None), q, k, v, do, torch.float32)
    got = [w.clone() for w in want]
    if fault == "late_rows_zeroed":
        got[0][:, -300:] = 0
    elif fault == "one_row_off":
        got[1][:, 777, 3] *= 0.9
    elif fault == "one_key_row_off":
        got[2][:, 500, 1] *= 0.9
    err = _smoke.k6_block_errors(got, want)
    if fault == "none":
        assert err == [0.0] * 4
    else:
        assert max(err) > _smoke.K6_TOL, err
