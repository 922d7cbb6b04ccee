"""The port's core math held against the JAX reference: protocol rules
exactly, the stopping rule and the effective sample size at 1e-6.
Mirrors tests/test_core.py.

ESS is held to the reference's values over sane weights, and to the
invariant ``1 <= n_eff <= len(w)`` that the reference's
``TestESS::test_bounds`` states everywhere, including weights whose
squares underflow float32, where the reference itself breaks it
(ROADMAP.md queue 3) and the port rescales.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ess as jess  # noqa: E402
from repro.core import protocol as jprotocol  # noqa: E402
from repro.core import result as jresult  # noqa: E402
from repro.core import stopping as jstop  # noqa: E402
from repro_torch.core import ess as tess  # noqa: E402
from repro_torch.core import protocol as tprotocol  # noqa: E402
from repro_torch.core import result as tresult  # noqa: E402
from repro_torch.core import stopping as tstop  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _close(want, got):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


class TestESS:
    @pytest.mark.parametrize(
        "w",
        [
            np.ones(100, np.float32),
            np.concatenate([np.ones(10), np.zeros(90)]).astype(np.float32),
            np.array([0.5, 1.5, 2.0, 0.1], np.float32),
            np.array([0.5, 1.5, 2.0, 0.1], np.float32) * 37.0,
            np.zeros(5, np.float32),
        ],
        ids=["uniform", "k_of_n", "skewed", "scaled", "all_zero"],
    )
    def test_matches_reference(self, w):
        _close(jess.effective_sample_size(jnp.asarray(w)), tess.effective_sample_size(torch.from_numpy(w)))

    @pytest.mark.parametrize("seed", range(6))
    def test_bounds_over_sane_weights(self, seed):
        """1 <= n_eff <= n, and equal to the reference, for weights in
        [1e-3, 1e3] (no float32 underflow in w^2)."""
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 65))
        w = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), n)).astype(np.float32)
        got = float(tess.effective_sample_size(torch.from_numpy(w)))
        assert 1.0 - 1e-3 <= got <= n + 1e-3
        _close(jess.effective_sample_size(jnp.asarray(w)), got)

    @pytest.mark.parametrize(
        "w",
        [
            np.array([1e-20], np.float32),
            np.array([1e-20, 0.0, 3e-21, 1e-22, 0.0], np.float32),
            np.array([1e-16, 2e-16], np.float32),  # s2 normal but below the 1e-30 guard
        ],
        ids=["single", "mixed", "below_guard"],
    )
    def test_bounds_where_squares_underflow(self, w):
        """``1 <= n_eff <= n`` and the exact ratio (in float64) where
        ``sum w^2`` underflows or falls under the reference's guard."""
        got = float(tess.effective_sample_size(torch.from_numpy(w)))
        w64 = w.astype(np.float64)
        want = w64.sum() ** 2 / (w64 * w64).sum()
        assert 1.0 <= got <= len(w)
        assert got == pytest.approx(want, rel=1e-6)

    def test_rescale_leaves_other_rows_bit_identical(self):
        """Rows with sane weights keep the plain formula's bits; an
        underflowing row beside them is rescaled."""
        rng = np.random.default_rng(9)
        w = rng.random((3, 40)).astype(np.float32)
        w[1] = np.float32(1e-21) * rng.random(40).astype(np.float32)
        w[2, :30] = 0.0
        tw = torch.from_numpy(w)
        got = tess.effective_sample_size(tw, dim=-1)
        s1, s2 = tw.sum(dim=-1), (tw * tw).sum(dim=-1)
        plain = (s1 * s1) / torch.clamp(s2, min=1e-30)
        assert torch.equal(got[[0, 2]], plain[[0, 2]])
        assert 1.0 <= float(got[1]) <= 40
        flat = w[0].copy()
        assert torch.equal(tess.effective_sample_size(torch.from_numpy(flat)), plain[0])

    def test_mask_and_rows(self):
        w = np.random.default_rng(3).random((4, 50)).astype(np.float32)
        mask = np.random.default_rng(4).random((4, 50)) < 0.7
        _close(
            jess.effective_sample_size(jnp.asarray(w), jnp.asarray(mask)),
            tess.effective_sample_size(torch.from_numpy(w), torch.from_numpy(mask)),
        )
        rows = tess.effective_sample_size(torch.from_numpy(w), dim=-1)
        for i in range(4):
            _close(jess.effective_sample_size(jnp.asarray(w[i])), rows[i])

    def test_expected_sample_fraction(self):
        w = np.array([1.0, 1.0, 2.0], np.float32)
        want = jess.expected_sample_fraction(jnp.asarray(w))
        _close(want, tess.expected_sample_fraction(torch.from_numpy(w)))


class TestStoppingRule:
    def _params(self, **kw):
        return jstop.StoppingRuleParams(**kw), tstop.StoppingRuleParams(**kw)

    def test_threshold_matches_reference(self):
        rng = np.random.default_rng(0)
        V = np.concatenate([[0.0], rng.uniform(0, 1e4, 200)]).astype(np.float32)
        M = np.concatenate([[0.0], rng.uniform(-1e3, 1e3, 200)]).astype(np.float32)
        for delta in (1e-6, 1e-3):
            jp, tp = self._params(C=1.0, delta=delta)
            want = np.asarray(jstop.stopping_threshold(jnp.asarray(V), jnp.asarray(M), jp))
            got = tstop.stopping_threshold(torch.from_numpy(V), torch.from_numpy(M), tp).numpy()
            assert np.array_equal(np.isinf(want), np.isinf(got))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)

    @pytest.mark.parametrize(
        "m,W,V,gamma",
        [(2000.0, 2000.0, 2000.0, 0.1), (-2000.0, 2000.0, 2000.0, 0.1), (0.0, 1000.0, 1000.0, 0.0)],
        ids=["strong", "negated", "zero_edge"],
    )
    def test_fires_matches_reference(self, m, W, V, gamma):
        jp, tp = self._params()
        jf, js, jsc = jstop.stopping_rule_fires(jnp.asarray([m]), jnp.asarray(W), jnp.asarray(V), gamma, jp)
        tf, ts, tsc = tstop.stopping_rule_fires(
            torch.tensor([m]), torch.tensor(W), torch.tensor(V), gamma, tp
        )
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())
        _close(jsc, tsc)

    def test_batched_candidates_match_reference(self):
        """The scanner's shape: (W, d, B-1) edges against (W,) scalars."""
        rng = np.random.default_rng(1)
        m = rng.normal(0, 300, (3, 8, 7)).astype(np.float32)
        W = rng.uniform(500, 3000, 3).astype(np.float32)
        V = (W * rng.uniform(0.5, 2.0, 3)).astype(np.float32)
        g = np.array([0.25, 0.05, 0.01], np.float32)
        jp, tp = self._params()
        tf, ts, tsc = tstop.stopping_rule_fires(
            torch.from_numpy(m), torch.from_numpy(W).view(3, 1, 1),
            torch.from_numpy(V).view(3, 1, 1), torch.from_numpy(g).view(3, 1, 1), tp,
        )
        for i in range(3):
            jf, js, jsc = jstop.stopping_rule_fires(
                jnp.asarray(m[i]), jnp.asarray(W[i]), jnp.asarray(V[i]), jnp.asarray(g[i]), jp
            )
            assert np.array_equal(np.asarray(jf), tf[i].numpy())
            assert np.array_equal(np.asarray(js), ts[i].numpy())
            np.testing.assert_allclose(tsc[i].numpy(), np.asarray(jsc), rtol=1e-6, atol=1e-3)

    def test_soundness_monte_carlo(self):
        """Under the null the port's rule essentially never certifies an
        edge > gamma (the reference's test, on the port)."""
        rng = np.random.default_rng(0)
        _, tp = self._params(C=1.0, delta=1e-3)
        false_fires = 0
        for _ in range(200):
            x = rng.choice([-1.0, 1.0], size=4000)
            W = np.arange(1, 4001, dtype=np.float64)
            M = np.cumsum(x) - 2 * 0.05 * W
            thr = tstop.stopping_threshold(torch.tensor(W, dtype=torch.float32),
                                           torch.tensor(M, dtype=torch.float32), tp).numpy()
            false_fires += bool(np.any(M > thr))
        assert false_fires <= 10

    def test_hoeffding_matches_reference(self):
        jp, tp = self._params(C=1.0, delta=1e-6)
        V = np.array([0.0, 1.0, 1e6], np.float32)
        t = np.array([1.0, 10.0, 1e6], np.float32)
        want = np.asarray(jstop.hoeffding_threshold(jnp.asarray(V), jnp.asarray(t), jp))
        got = tstop.hoeffding_threshold(torch.from_numpy(V), torch.from_numpy(t), tp).numpy()
        assert np.isinf(got[0]) and np.isinf(want[0])
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)
        # the iterated-log rule is tighter at large t
        il = float(tstop.stopping_threshold(torch.tensor(1e6), torch.tensor(1000.0), tp))
        assert il < float(got[2])
        m = np.array([3000.0, -3000.0, 10.0], np.float32)
        jf, js = jstop.hoeffding_rule_fires(jnp.asarray(m), 1e6, 1e6, 1e6, 0.0, jp)
        tf, ts = tstop.hoeffding_rule_fires(torch.from_numpy(m), 1e6, 1e6, 1e6, 0.0, tp)
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())


class TestProtocol:
    @pytest.mark.parametrize(
        "old,new,eps", [(1.0, 0.8, 0.1), (1.0, 0.95, 0.1), (1.0, 1.2, 0.0), (0.5, 0.5, 0.0)]
    )
    def test_rules_match_reference_exactly(self, old, new, eps):
        assert tprotocol.improves(old, new, eps) == jprotocol.improves(old, new, eps)
        assert tprotocol.accepts(old, new, eps) == jprotocol.accepts(old, new, eps)

    def test_elementwise_on_tensors(self):
        rng = np.random.default_rng(2)
        a = rng.uniform(-1, 1, 500).astype(np.float32)
        b = rng.uniform(-1, 1, 500).astype(np.float32)
        for eps in (0.0, 0.05):
            want = np.asarray(jprotocol.accepts(jnp.asarray(a), jnp.asarray(b), eps))
            got = tprotocol.accepts(torch.from_numpy(a), torch.from_numpy(b), eps).numpy()
            assert np.array_equal(want, got)
            want = np.asarray(jprotocol.improves(jnp.asarray(a), jnp.asarray(b), eps))
            got = tprotocol.improves(torch.from_numpy(a), torch.from_numpy(b), eps).numpy()
            assert np.array_equal(want, got)

    def test_certificate_validates_confidence(self):
        with pytest.raises(ValueError):
            tprotocol.Certificate(0.1, confidence=1.5)
        msg = tprotocol.TMSNMessage(model=None, certificate=tprotocol.Certificate(0.1), sender=3)
        assert msg.sender == 3 and msg.certificate.value == 0.1


def test_traffic_counters_match_reference():
    kw = dict(sent=np.array([3, 4]), accepted=np.array([1, 1]), discarded=np.array([0, 2]),
              payload_bytes=8, sent_dcn=np.array([2, 1]), evicted=3)
    a = jresult.TrafficCounters.from_shards(**kw)
    b = tresult.TrafficCounters.from_shards(**kw)
    assert vars(a) == vars(b)
    assert (b.sent_ici, b.bytes_dcn) == (a.sent_ici, a.bytes_dcn)
