"""The port's boosting stack held against the JAX reference.

  * ``boosting/stumps.py``: histograms and margins allclose 1e-5,
    ``best_stump_exact`` feature/threshold/sign exactly;
  * ``boosting/sampler.py::minimal_variance_sample`` fed the reference's
    own uniform offset: the same indices;
  * ``boosting/scanner.py::scan_chunk``, chunk by chunk from a converted
    state: fire decisions exactly, histograms/W/V/margins at 1e-5;
  * ``boosting/batched_sparrow.py::BatchedSparrowWorker`` segment by
    segment (scan, resample with the reference's draws, adopt) from the
    reference's own ``init_batch`` state, on the kernel route and off it;
  * ``boosting/baselines.py``: exact greedy with feature/threshold/sign
    exactly and alpha and the loss trace at 1e-5, GOSS with the
    reference's rest-pool picks injected;
  * ``boosting/sampler.py::rejection_sample`` fed the reference's
    uniforms: the same picks.

Mirrors tests/test_boosting.py; the data is the reference's, handed to
both packages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.boosting import baselines as jbase  # noqa: E402
from repro.boosting import batched_sparrow as jbs  # noqa: E402
from repro.boosting import sampler as jsampler  # noqa: E402
from repro.boosting import scanner as jscan  # noqa: E402
from repro.boosting import sparrow as jsparrow  # noqa: E402
from repro.boosting import stumps as jst  # noqa: E402
from repro.configs import sparrow as jconfigs  # noqa: E402
from repro.data import splice as jsplice  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.boosting import baselines as tbase  # noqa: E402
from repro_torch.boosting import batched_sparrow as tbs  # noqa: E402
from repro_torch.boosting import sampler as tsampler  # noqa: E402
from repro_torch.boosting import scanner as tscan  # noqa: E402
from repro_torch.boosting import sparrow as tsparrow  # noqa: E402
from repro_torch.boosting import stumps as tst  # noqa: E402
from repro_torch.configs import sparrow as tconfigs  # noqa: E402
from repro_torch.data import splice as tsplice  # noqa: E402

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(want, got, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(kw or TOL))


def _equal(want, got):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def jax_uniforms(stream: int, draw: int) -> float:
    """The reference's j-th minimal-variance offset of a worker stream:
    ``k_0 = PRNGKey(stream)``, ``k_{j+1} = split(k_j)[0]``, offset
    ``uniform(split(k_j)[1])``."""
    k = jax.random.PRNGKey(stream)
    for _ in range(draw):
        k = jax.random.split(k)[0]
    return float(jax.random.uniform(jax.random.split(k)[1]))


@pytest.fixture(scope="module")
def data():
    xb, y, _ = jsplice.make_splice_like(jsplice.SpliceConfig(n=3000, d=16, num_bins=8, seed=3))
    return np.asarray(xb), np.asarray(y)


def _random_model(seed, capacity, d, num_bins, count, batch=None):
    """A reference StumpModel with ``count`` random stumps (per row)."""
    rng = np.random.default_rng(seed)
    shape = (capacity,) if batch is None else (batch, capacity)
    live = np.arange(capacity) < count
    cnt = np.int32(count) if batch is None else np.full(batch, count, np.int32)
    return jst.StumpModel(
        feat=jnp.asarray(np.where(live, rng.integers(0, d, shape), 0).astype(np.int32)),
        thr=jnp.asarray(np.where(live, rng.integers(0, num_bins - 1, shape), 0).astype(np.int32)),
        sign=jnp.asarray(np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)),
        alpha=jnp.asarray(np.where(live, rng.uniform(0.05, 0.5, shape), 0.0).astype(np.float32)),
        count=jnp.asarray(cnt),
    )


# ---------------------------------------------------------------------------
# stumps
# ---------------------------------------------------------------------------


class TestStumps:
    def test_histogram_and_edges(self, data):
        xb, y = data
        w = np.random.default_rng(0).random(len(y)).astype(np.float32)
        wy = w * y
        hist_j = jst.edge_histogram(jnp.asarray(xb), jnp.asarray(wy), 8)
        hist_t = tst.edge_histogram(_t(xb), _t(wy), 8)
        _close(hist_j, hist_t, rtol=1e-5, atol=1e-4)
        _close(jst.edges_from_histogram(hist_j), tst.edges_from_histogram(_t(np.asarray(hist_j))))
        # batched rows give each row's histogram
        rows_xb, rows_wy = np.stack([xb[:500], xb[500:1000]]), np.stack([wy[:500], wy[500:1000]])
        both = tst.edge_histogram(_t(rows_xb), _t(rows_wy), 8)
        _close(jst.edge_histogram(jnp.asarray(xb[500:1000]), jnp.asarray(wy[500:1000]), 8), both[1])

    def test_best_stump_exact(self, data):
        xb, y = data
        w = np.random.default_rng(1).random(len(y)).astype(np.float32)
        jf, jt, js, jg = jst.best_stump_exact(jnp.asarray(xb), jnp.asarray(y), jnp.asarray(w), 8)
        tf, tt, ts, tg = tst.best_stump_exact(_t(xb), _t(y), _t(w), 8)
        assert (int(tf), int(tt), float(ts)) == (int(jf), int(jt), float(js))
        _close(jg, tg)

    def test_margins(self, data):
        xb, _ = data
        model = _random_model(2, 32, 16, 8, 20)
        tmodel = convert.stump_model_from_numpy(jax.tree_util.tree_map(np.asarray, model), CPU)
        _close(jst.predict_margin(model, jnp.asarray(xb)), tst.predict_margin(tmodel, _t(xb)))
        t_from = np.random.default_rng(3).integers(0, 21, len(xb)).astype(np.int32)
        _close(
            jst.predict_margin_delta(model, jnp.asarray(xb), jnp.asarray(t_from)),
            tst.predict_margin_delta(tmodel, _t(xb), _t(t_from)),
        )

    def test_append_alpha_and_payload(self):
        jm = jst.empty_model(4)
        tm = tst.empty_model(4, device=CPU)
        for k in range(6):  # past capacity: a no-op
            a = float(jst.alpha_from_gamma(0.05 * (k + 1)))
            _close(jst.alpha_from_gamma(0.05 * (k + 1)), tst.alpha_from_gamma(0.05 * (k + 1)), rtol=1e-6)
            jm = jst.append_stump(jm, k, k + 1, -1.0, a)
            tm = tst.append_stump(tm, k, k + 1, -1.0, a)
        for f in tst.StumpModel._fields:
            _equal(getattr(jm, f), getattr(tm, f))
        assert tst.model_payload_bytes(tm) == jst.model_payload_bytes(jm)

    def test_append_batched_rows(self):
        jm = _random_model(4, 8, 16, 8, 3, batch=3)
        tm = convert.stump_model_from_numpy(jax.tree_util.tree_map(np.asarray, jm), CPU)
        feat, thr = np.array([1, 2, 3], np.int32), np.array([0, 4, 6], np.int32)
        sign, alpha = np.array([1.0, -1.0, 1.0], np.float32), np.array([0.1, 0.2, 0.3], np.float32)
        want = jax.vmap(jst.append_stump)(jm, feat, thr, sign, alpha)
        got = tst.append_stump(tm, _t(feat), _t(thr), _t(sign), _t(alpha))
        for f in tst.StumpModel._fields:
            _equal(getattr(want, f), getattr(got, f))

    def test_loss_error_and_binning(self, data):
        xb, y = data
        model = _random_model(5, 16, 16, 8, 10)
        tmodel = convert.stump_model_from_numpy(jax.tree_util.tree_map(np.asarray, model), CPU)
        _close(jst.exp_loss(model, jnp.asarray(xb), jnp.asarray(y)), tst.exp_loss(tmodel, _t(xb), _t(y)))
        _close(jst.error_rate(model, jnp.asarray(xb), jnp.asarray(y)), tst.error_rate(tmodel, _t(xb), _t(y)))
        x = np.random.default_rng(6).normal(size=(500, 5)).astype(np.float32)
        jb, jc = jst.bin_features(jnp.asarray(x), 8)
        tb, tc = tst.bin_features(_t(x), 8)
        _close(jc, tc)
        assert np.mean(np.asarray(jb) == tb.numpy()) > 0.99  # quantile cuts equal to 1e-5


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


class TestSampler:
    @pytest.mark.parametrize("seed,n,m", [(0, 1000, 400), (1, 3000, 3000), (2, 257, 1000), (3, 5000, 64)])
    def test_minimal_variance_same_indices(self, seed, n, m):
        """Fed the reference's own u0, the port picks the same indices
        (the reference's f32 cumsum and the port's associate differently;
        no pick has moved on these inputs)."""
        rng = np.random.default_rng(seed)
        w = np.exp(rng.normal(0, 2, n)).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        want = jsampler.minimal_variance_sample(key, jnp.asarray(w), m)
        u0 = float(jax.random.uniform(key))
        got = tsampler.minimal_variance_sample(u0, _t(w), m)
        assert got.dtype == torch.int32
        _equal(want, got)

    def test_degenerate_and_batched(self):
        w = np.zeros(50, np.float32)
        key = jax.random.PRNGKey(7)
        want = jsampler.minimal_variance_sample(key, jnp.asarray(w), 20)
        _equal(want, tsampler.minimal_variance_sample(float(jax.random.uniform(key)), _t(w), 20))
        ws = np.random.default_rng(8).random((3, 200)).astype(np.float32)
        u0 = np.array([0.1, 0.5, 0.9], np.float32)
        rows = tsampler.minimal_variance_sample(_t(u0), _t(ws), 100)
        for i in range(3):
            _equal(tsampler.minimal_variance_sample(float(u0[i]), _t(ws[i]), 100), rows[i])

    def test_draw_sample_and_ownership(self, data):
        xb, y = data
        model = _random_model(9, 8, 16, 8, 5)
        margin = np.random.default_rng(9).normal(0, 0.5, len(y)).astype(np.float32)
        key = jax.random.PRNGKey(11)
        want = jsparrow.draw_sample(key, jnp.asarray(xb), jnp.asarray(y), model, jnp.asarray(margin), 700)
        tmodel = convert.stump_model_from_numpy(jax.tree_util.tree_map(np.asarray, model), CPU)
        got = tsparrow.draw_sample(float(jax.random.uniform(key)), _t(xb), _t(y), tmodel, _t(margin), 700)
        for f in tscan.SampleState._fields:
            _equal(getattr(want, f), getattr(got, f))
        for d, w, r in [(16, 4, 1), (10, 3, 2), (5, 8, 3)]:
            _equal(jsparrow.feature_ownership_masks(d, w, r), tsparrow.feature_ownership_masks(d, w, r))


# ---------------------------------------------------------------------------
# scanner
# ---------------------------------------------------------------------------


def _scanner_cfgs(use_kernel, gamma0=0.25):
    base = dict(chunk_size=128, num_bins=8, gamma0=gamma0, use_kernel=use_kernel)
    return jscan.ScannerConfig(**base), tscan.ScannerConfig(**base)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_route"])
def test_scan_chunk_chunk_by_chunk(data, use_kernel):
    """Batched ``scan_chunk`` vs the reference's ``vmap(scan_chunk)``
    over 10 chunks (a full pass wraps at m = 600) from the same state."""
    xb, y = data
    w, m, d = 3, 600, 16
    jcfg, tcfg = _scanner_cfgs(use_kernel, gamma0=0.05)
    rng = np.random.default_rng(12)
    idx = rng.integers(0, len(y), (w, m))
    margin = rng.normal(0, 0.3, (w, m)).astype(np.float32)
    jsample = jscan.SampleState(
        xb=jnp.asarray(xb[idx]), y=jnp.asarray(y[idx]), margin_s=jnp.asarray(margin),
        margin_l=jnp.asarray(margin), t_l=jnp.full((w, m), 2, jnp.int32),
    )
    jmodel = _random_model(13, 32, d, 8, 6, batch=w)
    jscanner = jax.vmap(lambda _: jscan.init_scanner(d, jcfg))(jnp.arange(w))
    mask = jnp.asarray(jsparrow.feature_ownership_masks(d, w))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    tsample = convert.sample_from_numpy(host(jsample), CPU)
    tscanner = convert.scanner_from_numpy(host(jscanner), CPU)
    tmodel = convert.stump_model_from_numpy(host(jmodel), CPU)
    scan = jax.vmap(lambda s, sm, mo, fm: jscan.scan_chunk(s, sm, mo, fm, jcfg))
    fired_any = False
    for _ in range(10):
        jscanner, jsample, jinfo = scan(jscanner, jsample, jmodel, mask)
        tscanner, tsample, tinfo = tscan.scan_chunk(tscanner, tsample, tmodel, _t(np.asarray(mask)), tcfg)
        for f in ("fired", "feat", "thr", "sign", "full_pass", "stump_evals"):
            _equal(getattr(jinfo, f), getattr(tinfo, f))
        for f in ("gamma", "cert_gamma", "emp_gamma"):
            _close(getattr(jinfo, f), getattr(tinfo, f))
        for f in ("pos", "n_scanned", "budget_used"):
            _equal(getattr(jscanner, f), getattr(tscanner, f))
        _close(jscanner.hist, tscanner.hist, rtol=1e-5, atol=1e-4)
        _close(jscanner.W, tscanner.W)
        _close(jscanner.V, tscanner.V)
        _close(jsample.margin_l, tsample.margin_l)
        _equal(jsample.t_l, tsample.t_l)
        fired_any |= bool(np.any(np.asarray(jinfo.fired)))
        # carry on as the worker would: reset the fired rows on both sides
        jreset = jax.vmap(jscan.reset_after_fruitless_pass)(jscanner)
        jscanner = jbs._bwhere(jinfo.fired, jreset, jscanner)
        tscanner = tbs.masked_rows(tinfo.fired, tscan.reset_after_fruitless_pass(tscanner), tscanner)
    assert fired_any


def test_scanner_resets_match_reference():
    jcfg, tcfg = _scanner_cfgs(False)
    rng = np.random.default_rng(14)
    js = jscan.ScannerState(
        hist=jnp.asarray(rng.random((2, 4, 8)).astype(np.float32)), W=jnp.asarray([3.0, 4.0]),
        V=jnp.asarray([1.0, 2.0]), pos=jnp.asarray([5, 6], jnp.int32),
        n_scanned=jnp.asarray([7, 8], jnp.int32), budget_used=jnp.asarray([9, 10], jnp.int32),
        gamma=jnp.asarray([0.2, 0.01], jnp.float32),
    )
    ts = convert.scanner_from_numpy(jax.tree_util.tree_map(np.asarray, js), CPU)
    emp = np.array([0.3, 0.0001], np.float32)
    cases = [
        (jax.vmap(lambda s, e: jscan.reset_after_fire(s, True, jcfg, e))(js, jnp.asarray(emp)),
         tscan.reset_after_fire(ts, True, tcfg, _t(emp))),
        (jax.vmap(lambda s: jscan.reset_after_fire(s, False, jcfg))(js),
         tscan.reset_after_fire(ts, False, tcfg)),
        (jax.vmap(jscan.reset_after_fruitless_pass)(js), tscan.reset_after_fruitless_pass(ts)),
    ]
    for want, got in cases:
        for f in tscan.ScannerState._fields:
            _equal(getattr(want, f), getattr(got, f))


# ---------------------------------------------------------------------------
# batched Sparrow, segment by segment
# ---------------------------------------------------------------------------


def _workers(data, use_kernel, w=4, **kw):
    xb, y = data
    jcfg, tcfg = _scanner_cfgs(use_kernel)
    base = dict(sample_size=500, capacity=32, n_workers=w, ess_threshold=0.6, **kw)
    jspc = jsparrow.SparrowConfig(scanner=jcfg, **base)
    jw = jbs.BatchedSparrowWorker(jnp.asarray(xb), jnp.asarray(y), jspc)
    txb, ty = convert.dataset_from_numpy(xb, y, CPU)
    tw = tbs.BatchedSparrowWorker(txb, ty, tsparrow.SparrowConfig(scanner=tcfg, **base), device=CPU,
                                  uniforms=jax_uniforms)
    return jw, tw


def _assert_states_close(js, ts):
    jn = jax.tree_util.tree_map(np.asarray, js)
    for f in ("feat", "thr", "count"):
        _equal(getattr(jn.model, f), getattr(ts.model, f))
    _equal(jn.model.sign, ts.model.sign)
    _close(jn.model.alpha, ts.model.alpha)
    _close(jn.cert, ts.cert)
    for f in ("needs_resample", "fires", "resamples", "sample_model_count"):
        _equal(getattr(jn, f), getattr(ts, f))
    for f in ("xb", "y", "t_l"):
        _equal(getattr(jn.sample, f), getattr(ts.sample, f))
    _close(jn.sample.margin_l, ts.sample.margin_l)
    _close(jn.sample.margin_s, ts.sample.margin_s)
    _close(jn.disk_margin, ts.disk_margin)
    _equal(jn.disk_t, ts.disk_t)
    _close(jn.scanner.hist, ts.scanner.hist, rtol=1e-5, atol=1e-4)
    _equal(jn.scanner.pos, ts.scanner.pos)
    _close(jn.scanner.gamma, ts.scanner.gamma)
    _close(jn.scan_since_resample, ts.scan_since_resample)
    _equal(jn.resamples + 1, ts.draws)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_route"])
def test_batched_worker_segment_by_segment(data, use_kernel):
    """init_batch, then scan / resample / adopt rounds, each held against
    the reference's worker from the same state."""
    jw, tw = _workers(data, use_kernel)
    js = jw.init_batch(4, 0)
    ts = tw.init_batch(4, 0)
    _assert_states_close(js, ts)  # the same draws give the same samples
    ts = convert.batched_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), 0, CPU)
    # the reference's methods, compiled as its engine compiles them
    j_scan, j_resample, j_adopt = jax.jit(jw.scan_round), jax.jit(jw.resample_round), jax.jit(jw.adopt_batch)
    resampled = adopted = 0
    for r in range(14):
        mask = np.array([True, True, r % 2 == 0, True])
        need = np.asarray(jw.needs_resample(js)) & mask
        if r in (5, 10):  # besides the ESS trigger, resample two rows on demand
            need[[1, 3]] = True
        if need.any():
            js, jc = j_resample(js, jnp.asarray(need))
            ts, tc = tw.resample_round(ts, _t(need))
            _close(jc, tc, rtol=1e-5, atol=1e-3)
            resampled += int(need.sum())
            mask = mask & ~need
        js, jc, jf = j_scan(js, jnp.asarray(mask))
        ts, tc, tf = tw.scan_round(ts, _t(mask))
        _equal(jf, tf)
        _close(jc, tc, rtol=1e-5, atol=1e-3)
        _assert_states_close(js, ts)
        certs = np.asarray(js.cert)
        best = int(np.argmin(certs))
        take = certs > certs[best] + 1e-6
        if r % 3 == 2 and take.any():
            jmodels = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[best], a.shape), js.model)
            tmodels = tbs.tree_map(lambda a: a[best].expand(a.shape).clone(), ts.model)
            bc = np.full(4, certs[best], np.float32)
            js, jc = j_adopt(js, jmodels, jnp.asarray(bc), jnp.asarray(take))
            ts, tc = tw.adopt_batch(ts, tmodels, _t(bc), _t(take))
            _close(jc, tc, rtol=1e-5, atol=1e-3)
            _assert_states_close(js, ts)
            adopted += int(take.sum())
    assert resampled and adopted


def test_batched_worker_hooks(data):
    jw, tw = _workers(data, False)
    js = jw.init_batch(4, 0)
    ts = convert.batched_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), 0, CPU)
    assert tw.payload_bytes() == jw.payload_bytes()
    back = convert.to_numpy(ts)  # and back again: the same arrays
    for f in ("xb", "margin_l", "t_l"):
        _equal(getattr(js.sample, f), getattr(back.sample, f))
    _equal(js.model.feat, back.model.feat)
    rows = tw.export_payload_rows(ts, torch.tensor([2, 0]))
    _equal(np.asarray(jw.export_payload_rows(js, jnp.asarray([2, 0])).feat), rows.feat)
    _equal(jw.needs_resample(js), tw.needs_resample(ts))
    with pytest.raises(ValueError):
        tw.init_batch(3, 0)
    # a masked-out row comes back bitwise unchanged at zero cost
    new, cost, fired = tw.scan_round(ts, torch.tensor([True, False, True, False]))
    assert float(cost[1]) == 0.0 and not bool(fired[1])
    from repro_torch.core.worker import tree_leaves

    row1 = lambda st: tree_leaves(tbs.tree_map(lambda x: x[1], st))  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(row1(new), row1(ts)))
    assert not torch.equal(new.scanner.pos, ts.scanner.pos)  # the live rows did advance

def test_default_uniforms_are_reproducible(data):
    """Without injected draws the worker takes its offsets from one
    torch.Generator per stream: the same seed gives the same samples."""
    xb, y = data
    txb, ty = convert.dataset_from_numpy(xb, y, CPU)
    cfg = tsparrow.SparrowConfig(sample_size=300, capacity=8, n_workers=2,
                                 scanner=tscan.ScannerConfig(chunk_size=64, num_bins=8))
    a = tbs.BatchedSparrowWorker(txb, ty, cfg, device=CPU).init_batch(2, 5)
    b = tbs.BatchedSparrowWorker(txb, ty, cfg, device=CPU).init_batch(2, 5)
    assert torch.equal(a.sample.xb, b.sample.xb)
    assert not torch.equal(a.sample.xb[0], a.sample.xb[1])  # streams differ per worker
    assert a.stream.tolist() == [5, 1005]


# ---------------------------------------------------------------------------
# rejection sampling and the baselines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,m", [(3, 2, 400), (4, 50, 64), (5, 257, 33)])
def test_rejection_sample_same_picks(seed, n, m):
    """Fed the uniforms behind ``jax.random.categorical``'s Gumbel noise
    (mode "low": uniform on [tiny, 1)), the port picks the same indices;
    zero weights are never picked."""
    rng = np.random.default_rng(seed)
    w = rng.random(n).astype(np.float32) * 3.0
    w[rng.random(n) < 0.2] = 0.0
    w[0] = 1.0
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jsampler.rejection_sample(key, jnp.asarray(w), m))
    u = jax.random.uniform(key, (m, n), jnp.float32, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    got = tsampler.rejection_sample(_t(u), _t(w), m)
    assert got.dtype == torch.int32
    _equal(want, got)
    assert (w[got.numpy()] > 0).all()
    with pytest.raises(ValueError):
        tsampler.rejection_sample(_t(u)[:, :1], _t(w), m)


def test_rejection_sample_unbiased():
    """Mirrors tests/test_boosting.py::test_rejection_sample_unbiased."""
    g = torch.Generator().manual_seed(3)
    u = torch.rand((4000, 2), generator=g).clamp_min(torch.finfo(torch.float32).tiny)
    idx = tsampler.rejection_sample(u, torch.tensor([3.0, 1.0]), 4000)
    assert float((idx == 0).float().mean()) == pytest.approx(0.75, abs=0.03)


def jax_goss_picks(seed: int):
    """The reference's rest-pool picks as positions: round r draws with
    ``sub`` of ``key, sub = split(key)`` from ``PRNGKey(seed)``, and
    ``choice(sub, rest_pool, replace=False)`` is ``rest_pool`` indexed by
    ``choice(sub, len(rest_pool), replace=False)``."""
    keys = []

    def pick(r, pool, k):
        while len(keys) <= r:
            prev = keys[-1][0] if keys else jax.random.PRNGKey(seed)
            keys.append(jax.random.split(prev))
        return _t(jax.random.choice(keys[r][1], pool, (k,), replace=False))

    return pick


def _booster_data(data):
    xb, y = data
    txb, ty = convert.dataset_from_numpy(xb, y, CPU)
    ev_j = lambda m: float(jst.exp_loss(m, jnp.asarray(xb), jnp.asarray(y)))  # noqa: E731
    ev_t = lambda m: float(tst.exp_loss(m, txb, ty))  # noqa: E731
    return (jnp.asarray(xb), jnp.asarray(y), ev_j), (txb, ty, ev_t)


def _assert_traces_close(jtr, ttr):
    for f in ("feat", "thr", "count"):
        _equal(getattr(jtr.model, f), getattr(ttr.model, f))
    _equal(jtr.model.sign, ttr.model.sign)
    _close(jtr.model.alpha, ttr.model.alpha)
    assert ttr.rounds == jtr.rounds
    np.testing.assert_allclose(ttr.cost, jtr.cost, rtol=1e-12)
    _close(jtr.metric, ttr.metric)


def test_exact_greedy_matches_reference(data):
    (jx, jy, ev_j), (tx, ty, ev_t) = _booster_data(data)
    cfg = dict(num_rounds=12, num_bins=8, capacity=16, eval_every=3)
    jtr = jbase.train_exact_greedy(jx, jy, jbase.BoosterConfig(**cfg), eval_fn=ev_j)
    ttr = tbase.train_exact_greedy(tx, ty, tbase.BoosterConfig(**cfg), eval_fn=ev_t)
    _assert_traces_close(jtr, ttr)
    assert int(ttr.model.count) == 12 and ttr.metric[-1] < 1.0
    again = tbase.train_adaboost_reference(tx, ty, tbase.BoosterConfig(**cfg))
    assert torch.equal(again.model.feat, ttr.model.feat) and again.metric == []


def test_goss_matches_reference_with_its_picks(data):
    (jx, jy, ev_j), (tx, ty, ev_t) = _booster_data(data)
    cfg = dict(num_rounds=10, num_bins=8, capacity=16, eval_every=4, seed=5)
    jtr = jbase.train_goss(jx, jy, jbase.BoosterConfig(**cfg), eval_fn=ev_j)
    ttr = tbase.train_goss(tx, ty, tbase.BoosterConfig(**cfg), eval_fn=ev_t, pick=jax_goss_picks(5))
    _assert_traces_close(jtr, ttr)


def test_goss_default_picks_are_seeded(data):
    _, (tx, ty, ev_t) = _booster_data(data)
    cfg = tbase.BoosterConfig(num_rounds=6, num_bins=8, capacity=8, eval_every=5, seed=2)
    a, b = tbase.train_goss(tx, ty, cfg, eval_fn=ev_t), tbase.train_goss(tx, ty, cfg, eval_fn=ev_t)
    assert torch.equal(a.model.feat, b.model.feat) and a.metric == b.metric
    assert a.metric[-1] < 1.0
    for f in dataclasses.fields(jbase.BoosterConfig):
        assert getattr(jbase.BoosterConfig(), f.name) == getattr(tbase.BoosterConfig(), f.name)


# ---------------------------------------------------------------------------
# data and configs
# ---------------------------------------------------------------------------


def test_make_splice_like_and_split():
    cfg = tsplice.SpliceConfig(n=4000, d=16, num_bins=8, seed=1)
    xb, y, truth = tsplice.make_splice_like(cfg, device=CPU)
    assert xb.dtype == torch.int32 and xb.shape == (4000, 16)
    assert int(xb.min()) >= 0 and int(xb.max()) < 8
    assert y.dtype == torch.float32 and set(y.unique().tolist()) == {-1.0, 1.0}
    assert abs(float((y > 0).float().mean()) - 0.3) < 0.05
    assert truth.shape == (3, cfg.n_signal)
    again = tsplice.make_splice_like(cfg, device=CPU)
    assert torch.equal(xb, again[0]) and torch.equal(y, again[1])
    xtr, ytr, xte, yte = tsplice.train_test_split(xb, y)
    assert xte.shape[0] == 400 and xtr.shape[0] == 3600 and ytr.shape[0] == 3600


def test_configs_match_reference():
    assert dataclasses.asdict(tconfigs.DATA) == dataclasses.asdict(jconfigs.DATA)
    want, got = jconfigs.sparrow_config(), tconfigs.sparrow_config()
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert (a._asdict() == b._asdict()) if f.name == "scanner" else a == b, f.name
