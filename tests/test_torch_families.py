"""The port's decoder-only model families (``repro_torch.models.moe``,
``.ssm``, MLA in ``.attention``, the mixed stacks of ``.transformer`` and
``.model``) held against the JAX package's on the CPU.

Each test names the reference function or test it is held against. The
same seeded numpy inputs go through both packages: the reference's
parameters are made by its own ``init_*`` or drawn with numpy and
converted leaf for leaf (``repro_torch.convert.lm_params_from_numpy``).
Tolerances: single modules (``apply_moe``, ``ssd_full``, ``ssd_decode``,
MLA) at rtol / atol 1e-5; whole models (logits, caches, hidden states)
at rtol 1e-5 / atol 1e-5 of the output's largest magnitude
(``close_model``: tests/test_torch_models.py's ``close_stack`` rule with
the modules' atol — MLA, MoE and SSD stacks add float32 sums of their
own, which MKL and XLA's Eigen round differently) and gradients at rtol
1e-4 / atol 1e-5; the chunked SSD against its recurrence and the
teacher-forced decode against the full forward at the reference's own
5e-3 and 2e-2 (tests/test_models.py). Configs: ``reduced()`` of the five
decoder-only families (deepseek_v3_671b, grok1_314b, gemma3_12b,
mamba2_1p3b, zamba2_1p2b), float32; ``init_params`` on the meta device
at their FULL configs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtrans  # noqa: E402
from repro.models.config import layer_segments as jsegments  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import apply_updates as japply  # noqa: E402
from repro.optim import init_opt_state as jinit_opt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.tokens import synthetic_token_batch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttrans  # noqa: E402
from repro_torch.models.config import layer_segments  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_models import GRAD, close, port_cfg, t  # noqa: E402
from test_torch_sgd import leaf_pairs  # noqa: E402

CPU = "cpu"
MOD = dict(rtol=1e-5, atol=1e-5)
FAMILY_IDS = ["deepseek_v3_671b", "grok1_314b", "gemma3_12b", "mamba2_1p3b", "zamba2_1p2b"]
#: name -> the reference's reduced config (float32)
FAMILIES = {a: jconfigs.reduced(jconfigs.get_config(a)) for a in FAMILY_IDS}


def close_model(got, want):
    """Whole-model outputs: rtol 1e-5, atol 1e-5 of the largest magnitude."""
    want = np.asarray(want)
    close(got, want, dict(rtol=MOD["rtol"], atol=MOD["atol"] * max(1.0, float(np.max(np.abs(want))))))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_port(tree):
    return convert.lm_params_from_numpy(np_tree(tree), CPU)


def grad_at(tree, path):
    g = tree
    for k in path:
        g = g[k.key if hasattr(k, "key") else k.idx]
    return g


@pytest.fixture(scope="module", params=FAMILY_IDS)
def family(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    jcfg = FAMILIES[request.param]
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return request.param, jcfg, port_cfg(jcfg), jp, to_port(jp)


def _tokens(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s), dtype=np.int32)


# ---------------------------------------------------------------------------
# MoE (src/repro/models/moe.py; tests/test_models.py::TestMoE)
# ---------------------------------------------------------------------------

MOE_CASES = {
    "grok": FAMILIES["grok1_314b"],
    "deepseek_shared": FAMILIES["deepseek_v3_671b"],
    "drop": dataclasses.replace(FAMILIES["grok1_314b"], capacity_factor=0.01),
    "top3_of_6": dataclasses.replace(FAMILIES["deepseek_v3_671b"], num_experts=6, num_experts_per_tok=3),
}


def _moe_params(jcfg, seed=2):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return np_tree(p)


def _moe_x(jcfg, s, seed=3):
    return (np.random.default_rng(seed).normal(size=(2, s, jcfg.d_model)) * 0.5).astype(np.float32)


class TestMoE:
    @pytest.mark.parametrize("case", list(MOE_CASES))
    def test_apply_moe(self, case):
        """``apply_moe``'s output and aux at 1e-5 and its routing (the
        top-k indices) equal to the reference's."""
        jcfg = MOE_CASES[case]
        p = _moe_params(jcfg)
        x = _moe_x(jcfg, 32)
        out, aux = tmoe.apply_moe(to_port(p), t(x), port_cfg(jcfg))
        jout, jaux = jmoe.apply_moe(p, jnp.asarray(x), jcfg)
        close(out, jout, MOD)
        close(aux, jaux, MOD)
        xt = x.reshape(-1, jcfg.d_model)
        jprobs = jax.nn.softmax(jnp.asarray(xt) @ p["router"], axis=-1)
        probs = torch.softmax(t(xt) @ t(p["router"]), dim=-1)
        _, jtopi = jax.lax.top_k(jprobs, jcfg.num_experts_per_tok)
        _, topi = tmoe.route(probs, jcfg.num_experts_per_tok)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
        if case == "drop":  # every expert overflows: most slots dropped, no NaN
            C = tmoe.moe_capacity(port_cfg(jcfg), xt.shape[0])
            assert C == 8 and np.isfinite(out.numpy()).all()

    @pytest.mark.parametrize("case", ["deepseek_shared", "drop"])
    def test_gradients(self, case):
        """``jax.grad`` of ``sum(out**2) + aux`` (the reference's
        ``test_router_gradient_flows``) leaf for leaf, the router's
        gradient nonzero, and the input's."""
        jcfg = MOE_CASES[case]
        p = _moe_params(jcfg)
        x = _moe_x(jcfg, 16, seed=4)

        def f(pp, xx):
            out, aux = jmoe.apply_moe(pp, xx, jcfg)
            return jnp.sum(out ** 2) + aux

        jg, jgx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
        tp = tree_map(lambda a: a.clone().requires_grad_(True), to_port(p))
        tx = t(x).requires_grad_(True)
        out, aux = tmoe.apply_moe(tp, tx, port_cfg(jcfg))
        (torch.sum(out ** 2) + aux).backward()
        for path, want in jax.tree_util.tree_leaves_with_path(jg):
            close(grad_at(tp, path).grad, want, GRAD)
        close(tx.grad, jgx, GRAD)
        assert float(tp["router"].grad.abs().sum()) > 0.0

    def test_moe_capacity(self):
        """``moe_capacity`` against the reference's over token counts and
        configs (``test_capacity_rounding``)."""
        for jcfg in (jconfigs.get_config("deepseek_v3_671b"), jconfigs.get_config("grok1_314b"),
                     *MOE_CASES.values()):
            for n in (1, 4, 7, 64, 1024, 2048, 4096):
                assert tmoe.moe_capacity(port_cfg(jcfg), n) == jmoe.moe_capacity(jcfg, n)
        c = tmoe.moe_capacity(tconfigs.get_config("deepseek_v3_671b"), 1024)
        assert c % 8 == 0 and c >= 1024 * 8 * 1.25 / 256
        # the serve_deepseek phase's decode: 4 slots x top-8 never overflows
        assert tmoe.moe_capacity(tconfigs.get_config("deepseek_v3_671b"), 4) == 8

    def test_ties_put_the_lower_index_first(self):
        """``lax.top_k``'s order on exact ties, which ``torch.topk`` does
        not promise: the port's stable descending sort keeps it."""
        rng = np.random.default_rng(5)
        probs = rng.integers(0, 4, (64, 8)).astype(np.float32) / 4
        for k in (1, 2, 3, 8):
            vals, idx = tmoe.route(t(probs), k)
            jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))

    def test_init_shapes(self):
        jcfg = FAMILIES["deepseek_v3_671b"]
        want = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg, jnp.float32), jax.random.PRNGKey(0))
        got = tmoe.init_moe(None, port_cfg(jcfg), torch.float32, "meta", lead=(3,))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            assert tuple(grad_at(got, path).shape) == (3,) + leaf.shape


# ---------------------------------------------------------------------------
# SSD (src/repro/models/ssm.py; tests/test_models.py::TestSSD)
# ---------------------------------------------------------------------------

SSM_CFG = FAMILIES["mamba2_1p3b"]


@pytest.fixture(scope="module")
def ssm_params():
    p = np_tree(jssm.init_ssm(jax.random.PRNGKey(6), SSM_CFG, jnp.float32))
    # nonzero a_log, dt_bias and D so every term of the recurrence counts
    rng = np.random.default_rng(7)
    H = p["a_log"].shape[0]
    p["a_log"] = rng.normal(size=H).astype(np.float32) * 0.5
    p["dt_bias"] = rng.normal(size=H).astype(np.float32) * 0.5
    p["D"] = rng.normal(size=H).astype(np.float32)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32) * 0.1
    return p


def _ssm_x(s, b=2, seed=8):
    return (np.random.default_rng(seed).normal(size=(b, s, SSM_CFG.d_model)) * 0.1).astype(np.float32)


class TestSSD:
    @pytest.mark.parametrize("s", [32, 64, 96])
    def test_ssd_full_matches_reference(self, ssm_params, s):
        """``ssd_full``: one chunk and several (the inter-chunk loop
        against ``lax.scan``); out, final state and conv tail at 1e-5."""
        x = _ssm_x(s)
        out, (state, tail) = tssm.ssd_full(to_port(ssm_params), t(x), port_cfg(SSM_CFG))
        jout, (jstate, jtail) = jssm.ssd_full(ssm_params, jnp.asarray(x), SSM_CFG)
        for a, w in ((out, jout), (state, jstate), (tail, jtail)):
            close(a, w, MOD)

    def test_ssd_decode_matches_reference(self, ssm_params):
        rng = np.random.default_rng(9)
        d_inner, H, P, N = jssm.ssm_dims(SSM_CFG)
        x = _ssm_x(1, b=3)
        state = rng.normal(size=(3, H, N, P)).astype(np.float32)
        conv = rng.normal(size=(3, SSM_CFG.ssm_conv_width - 1, d_inner + 2 * N)).astype(np.float32)
        got = tssm.ssd_decode(to_port(ssm_params), t(x), t(state), t(conv), port_cfg(SSM_CFG))
        want = jssm.ssd_decode(ssm_params, jnp.asarray(x), jnp.asarray(state), jnp.asarray(conv), SSM_CFG)
        for a, w in zip(got, want):
            close(a, w, MOD)

    def test_ssd_reference_matches_reference(self, ssm_params):
        x = _ssm_x(12)
        close(tssm.ssd_reference(to_port(ssm_params), t(x), port_cfg(SSM_CFG)),
              jssm.ssd_reference(ssm_params, jnp.asarray(x), SSM_CFG), MOD)

    def test_chunked_matches_recurrence(self, ssm_params):
        """The port's chunked SSD against its own step-by-step oracle at
        the reference's 5e-3 (``test_chunked_matches_recurrence``)."""
        x = _ssm_x(64)
        cfg = port_cfg(SSM_CFG)
        y, _ = tssm.ssd_full(to_port(ssm_params), t(x), cfg)
        ref = tssm.ssd_reference(to_port(ssm_params), t(x), cfg)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=5e-3, atol=5e-3)

    def test_prefill_state_continues_decode(self, ssm_params):
        """The state ``ssd_full`` hands on continues the recurrence as the
        whole sequence run recurrently (``test_prefill_state_continues_decode``)."""
        cfg = port_cfg(SSM_CFG)
        p = to_port(ssm_params)
        x = t(_ssm_x(40, b=1, seed=10))
        _, (st, cv) = tssm.ssd_full(p, x[:, :32], cfg)
        outs = []
        for i in range(32, 40):
            o, st, cv = tssm.ssd_decode(p, x[:, i:i + 1], st, cv, cfg)
            outs.append(o)
        ref = tssm.ssd_reference(p, x, cfg)[:, 32:]
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(), rtol=5e-3, atol=5e-3)

    def test_gradients(self, ssm_params):
        x = _ssm_x(64, seed=11)
        jg = jax.grad(lambda pp: jnp.mean(jssm.ssd_full(pp, jnp.asarray(x), SSM_CFG)[0] ** 2))(ssm_params)
        tp = tree_map(lambda a: a.clone().requires_grad_(True), to_port(ssm_params))
        torch.mean(tssm.ssd_full(tp, t(x), port_cfg(SSM_CFG))[0] ** 2).backward()
        for path, want in jax.tree_util.tree_leaves_with_path(jg):
            close(grad_at(tp, path).grad, want, GRAD)


# ---------------------------------------------------------------------------
# MLA (src/repro/models/attention.py:135-238)
# ---------------------------------------------------------------------------

MLA_CFG = FAMILIES["deepseek_v3_671b"]


@pytest.fixture(scope="module", params=["q_lora", "no_q_lora"])
def mla(request):
    jcfg = MLA_CFG if request.param == "q_lora" else dataclasses.replace(MLA_CFG, q_lora_rank=0)
    p = np_tree(jattn.init_mla(jax.random.PRNGKey(12), jcfg, jnp.float32))
    rng = np.random.default_rng(13)
    for k in ("kv_norm", "q_norm"):  # nonzero norm scales
        if k in p:
            p[k] = rng.normal(size=p[k].shape).astype(np.float32) * 0.1
    return jcfg, p


class TestMLA:
    def test_mla_full(self, mla):
        jcfg, p = mla
        x = (np.random.default_rng(14).normal(size=(2, 9, jcfg.d_model)) * 0.5).astype(np.float32)
        pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
        out, (ckv, kr) = tattn.mla_full(to_port(p), t(x), t(pos), port_cfg(jcfg))
        jout, (jckv, jkr) = jattn.mla_full(p, jnp.asarray(x), jnp.asarray(pos), jcfg)
        for a, w in ((out, jout), (ckv, jckv), (kr, jkr)):
            close(a, w, MOD)

    @pytest.mark.parametrize("case", ["scalar", "per_row"])
    def test_mla_decode(self, mla, case):
        """scalar and per-row ``pos`` against the reference; in place
        against out of place bit for bit; a scalar is the per-row write
        with every row at it, bit for bit."""
        jcfg, p = mla
        rng = np.random.default_rng(15)
        b, S = 3, 10
        x = (rng.normal(size=(b, 1, jcfg.d_model)) * 0.5).astype(np.float32)
        ckv = rng.normal(size=(b, S, jcfg.kv_lora_rank)).astype(np.float32)
        kr = rng.normal(size=(b, S, jcfg.qk_rope_head_dim)).astype(np.float32)
        pos = {"scalar": np.int32(6), "per_row": np.asarray([0, 4, 9], np.int32)}[case]
        tp, cfg = to_port(p), port_cfg(jcfg)
        got = tattn.mla_decode(tp, t(x), t(ckv), t(kr), t(pos), cfg)
        want = jattn.mla_decode(p, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(pos), jcfg)
        for a, w in zip(got, want):
            close(a, w, MOD)
        bufs = (t(ckv), t(kr))
        ptrs = [a.data_ptr() for a in bufs]
        inp = tattn.mla_decode(tp, t(x), *bufs, t(pos), cfg, in_place=True)
        assert [a.data_ptr() for a in inp[1:]] == ptrs
        for a, w in zip(inp, got):
            assert torch.equal(a, w)
        if case == "scalar":
            vec = tattn.mla_decode(tp, t(x), t(ckv), t(kr), torch.full((b,), 6, dtype=torch.int32), cfg)
            assert all(torch.equal(a, w) for a, w in zip(vec, got))
            at_int = tattn.mla_decode(tp, t(x), t(ckv), t(kr), 6, cfg)
            assert all(torch.equal(a, w) for a, w in zip(at_int, got))


# ---------------------------------------------------------------------------
# the five architectures (model.py, transformer.py)
# ---------------------------------------------------------------------------


class TestFamilies:
    def test_configs_match_reference(self, family):
        name, jcfg, _, _, _ = family
        full = tconfigs.get_config(name)
        assert dataclasses.asdict(full) == dataclasses.asdict(jconfigs.get_config(name))
        assert dataclasses.asdict(tconfigs.reduced(full)) == dataclasses.asdict(jcfg)

    def test_init_cache_matches_reference(self, family):
        _, jcfg, cfg, _, _ = family
        for windowed in (False, True):
            got = tmodel.init_cache(dataclasses.replace(cfg, windowed_cache=windowed), 3, 64, device=CPU)
            want = jmodel.init_cache(dataclasses.replace(jcfg, windowed_cache=windowed), 3, 64)
            assert [(tuple(a.shape), str(a.dtype)[6:]) for a in tree_leaves(got)] == [
                (a.shape, str(a.dtype)) for a in jax.tree.leaves(want)]
            assert not any(a.any() for a in tree_leaves(got))

    def test_forward_stack(self, family):
        """Hidden states, the summed router aux and every cache entry."""
        _, jcfg, cfg, jp, tp = family
        x = (np.random.default_rng(16).normal(size=(2, 32, cfg.d_model))).astype(np.float32)
        pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
        got, aux, caches = ttrans.forward_stack(tp["decoder"], layer_segments(cfg), cfg, t(x), t(pos),
                                                shared_params=tp.get("shared_attn"), collect_cache=True)
        want, jaux, jcaches = jtrans.forward_stack(jp["decoder"], jsegments(jcfg), jcfg, x, jnp.asarray(pos),
                                                   shared_params=jp.get("shared_attn"), collect_cache=True)
        close_model(got, want)
        close(aux, jaux, MOD)
        assert (float(aux) > 0.0) == (jcfg.num_experts > 0)
        assert len(tree_leaves(caches)) == len(jax.tree.leaves(jcaches))
        for a, w in zip(tree_leaves(caches), jax.tree.leaves(jcaches)):
            close_model(a, w)

    def test_loss_and_grads(self, family):
        """``loss_fn`` with MTP (deepseek) and the router aux (the MoE
        families): every metric, and the gradients by path."""
        _, jcfg, cfg, jp, tp = family
        tokens = _tokens(cfg, s=32)
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(np.roll(tokens, -1, axis=1)),
              "mask": jnp.ones(tokens.shape, jnp.float32)}
        (jl, jm), jg = jax.value_and_grad(lambda q: jmodel.loss_fn(q, jcfg, jb), has_aux=True)(jp)
        leaves = tree_map(lambda a: a.clone().requires_grad_(True), tp)
        loss, metrics = tmodel.loss_fn(leaves, cfg, synthetic_token_batch(t(tokens)))
        loss.backward()
        assert metrics.keys() == jm.keys()
        assert ("mtp_loss" in metrics) == bool(jcfg.mtp_depth)
        for k in metrics:
            close(metrics[k], jm[k], MOD)
        for path, want in jax.tree_util.tree_leaves_with_path(jg):
            close(grad_at(leaves, path).grad, want, GRAD)
        assert len(tree_leaves(leaves)) == len(jax.tree.leaves(jg))

    def test_prefill_matches_reference(self, family):
        _, jcfg, cfg, jp, tp = family
        tokens = _tokens(cfg, s=32, seed=17)
        logits, caches = tmodel.prefill(tp, cfg, {"tokens": t(tokens)})
        jlogits, jcaches = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)})
        close_model(logits, jlogits)
        for a, w in zip(tree_leaves(caches), jax.tree.leaves(jcaches)):
            close_model(a, w)

    def test_decode_matches_reference(self, family):
        """From the reference's prefill caches, re-buffered: decode steps
        at scalar and at per-row ``pos`` (rows at their own depths)
        against the reference's ``decode_step``, in place against out of
        place bit for bit."""
        from repro.launch.serving import rebuffer_caches as jrebuffer

        _, jcfg, cfg, jp, tp = family
        tokens = _tokens(cfg, b=3, s=8, seed=18)
        _, jpre = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)})
        jc = jrebuffer(jcfg, jpre, 3, 16, 8, 0)
        jrow = jc
        c = to_port(jc)
        row = tree_map(torch.clone, c)
        pos_rows = np.array([8, 10, 9], np.int32)
        tok = tokens[:, -1:]
        for i in range(4):
            jl, jc = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(8 + i, jnp.int32))
            lg, c = tmodel.decode_step(tp, cfg, t(tok), c, 8 + i)
            close_model(lg, jl)
            jlr, jrow = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jrow, jnp.asarray(pos_rows + i))
            before = [a.data_ptr() for a in tree_leaves(row)]
            out_of_place = tmodel.decode_step(tp, cfg, t(tok), row, t(pos_rows + i))
            lr, row = tmodel.decode_step(tp, cfg, t(tok), row, t(pos_rows + i), in_place=True)
            assert [a.data_ptr() for a in tree_leaves(row)] == before
            assert torch.equal(lr, out_of_place[0])
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(row), tree_leaves(out_of_place[1])))
            close_model(lr, jlr)
            tok = np.asarray(jl[:, -1].argmax(-1))[:, None].astype(np.int32)
        for a, w in zip(tree_leaves(c), jax.tree.leaves(jc)):
            close_model(a, w)

    def test_decode_matches_full_forward(self, family):
        """Teacher-forced decode from an empty cache reproduces the full
        forward at every position, at the reference's 2e-2
        (``test_prefill_then_decode_matches_full_forward``), and the
        reference's own decode at ``close_model``."""
        _, jcfg, cfg, jp, tp = family
        b, s = 1, 8
        tokens = _tokens(cfg, b=b, s=s, seed=19)
        x = tmodel._embed(tp, cfg, t(tokens))
        x, _, _ = ttrans.forward_stack(tp["decoder"], layer_segments(cfg), cfg, x,
                                       tmodel._positions(t(tokens)),
                                       shared_params=tp.get("shared_attn"))
        full = tmodel._logits(tp, cfg, x)
        caches, jcaches = tmodel.init_cache(cfg, b, s, device=CPU), jmodel.init_cache(jcfg, b, s)
        for i in range(s):
            logits, caches = tmodel.decode_step(tp, cfg, t(tokens[:, i:i + 1]), caches, i)
            jlogits, jcaches = jmodel.decode_step(jp, jcfg, jnp.asarray(tokens[:, i:i + 1]), jcaches,
                                                  jnp.asarray(i, jnp.int32))
            close_model(logits, jlogits)
            np.testing.assert_allclose(logits[:, 0].numpy(), full[:, i].numpy(), rtol=2e-2, atol=2e-2)

    def test_train_step(self, family):
        """One AdamW step from the reference's gradients' counterparts:
        the updated parameters by path (the None of Zamba2's shared_attn
        positions carried through)."""
        _, jcfg, cfg, jp, tp = family
        tokens = _tokens(cfg, s=32, seed=20)
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(np.roll(tokens, -1, axis=1)),
              "mask": jnp.ones(tokens.shape, jnp.float32)}
        jg = jax.grad(lambda q: jmodel.loss_fn(q, jcfg, jb)[0])(jp)
        jnew, _ = japply(jp, jg, jinit_opt(jp, JAdamW(lr=1e-3)), JAdamW(lr=1e-3))
        opt = AdamWConfig(lr=1e-3)
        new, state = apply_updates(tp, to_port(jg), init_opt_state(tp, opt), opt)
        for g, w in leaf_pairs(new, jnew):
            close(g, w, GRAD)
        assert int(state["step"]) == 1

    def test_make_train_step(self, family):
        """``launch/steps.py::make_train_step`` (autograd + AdamW) against
        the reference's jitted step: the loss, the first moments ((1 - b1)
        x grad) at the gradients' tolerance, and the new parameters
        wherever the gradient is clear of that tolerance (a first AdamW
        step moves a weight by about lr x sign(grad), so where the grad is
        within it of zero the packages may step either way). At least 95 %
        of each leaf is clear: the lm_head's columns of unseen tokens and
        a routed expert fed few tokens have gradients near zero."""
        from repro.launch import steps as jsteps

        from repro_torch.launch import steps

        _, jcfg, cfg, jp, tp = family
        tokens = _tokens(cfg, s=16, seed=21)
        jopt, opt = JAdamW(lr=1e-3), AdamWConfig(lr=1e-3)
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(np.roll(tokens, -1, 1)),
              "mask": jnp.ones(tokens.shape, jnp.float32)}
        jnew, jstate, jm = jax.jit(jsteps.make_train_step(jcfg, jopt))(jp, jinit_opt(jp, jopt), jb)
        new, state, m = steps.make_train_step(cfg, opt)(tp, init_opt_state(tp, opt),
                                                        synthetic_token_batch(t(tokens)))
        close(m["loss"], jm["loss"], MOD)
        for g, w in leaf_pairs(state["mu"], jstate["mu"]):
            close(g, w, GRAD)
        for (g, w), (mu, _) in zip(leaf_pairs(new, jnew), leaf_pairs(jstate["mu"], jstate["mu"])):
            mu = np.asarray(mu)
            firm = (np.abs(mu) > (1 - jopt.b1) * GRAD["atol"]) | (mu == 0)
            assert firm.mean() > 0.95
            np.testing.assert_allclose(g.detach().numpy()[firm], np.asarray(w)[firm], **GRAD)


# ---------------------------------------------------------------------------
# full configs on the meta device (tests/test_models.py::TestConfigs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILY_IDS)
def test_meta_init_matches_eval_shape(arch):
    """``init_params`` on the meta device against ``jax.eval_shape`` at
    the FULL config, leaf for leaf, with None where the reference has it
    (Zamba2's shared_attn positions); nothing allocated."""
    jcfg = jconfigs.get_config(arch)
    want = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0))
    got = tmodel.init_params(tconfigs.get_config(arch), 0, device="meta")
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(tree_map(lambda a: 0, got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g = grad_at(got, path)
        assert g.device.type == "meta"
        assert tuple(g.shape) == leaf.shape and str(g.dtype)[6:] == str(leaf.dtype), path
    assert tmodel.param_count(got) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    if arch == "zamba2_1p2b":
        assert [p is None for p in got["decoder"][0]] == [False] * 6 + [True]


@pytest.mark.parametrize("arch", FAMILY_IDS)
def test_decode_specs_match_reference(arch):
    """``launch/steps.py::decode_specs`` at the FULL config and the
    decode_32k shape (meta tensors) against the reference's
    ShapeDtypeStructs: SSD state and conv tails, MLA latents, rings
    under ``windowed_cache``; nothing allocated."""
    from repro.launch import steps as jsteps

    from repro_torch.launch import steps

    for windowed in (False, True):
        jcfg = dataclasses.replace(jconfigs.get_config(arch), windowed_cache=windowed)
        jd, d = jsteps.decode_specs(jcfg, "decode_32k"), steps.decode_specs(port_cfg(jcfg), "decode_32k")
        assert jd.keys() == d.keys()
        for k in jd:
            got, want = tree_leaves(d[k]), jax.tree.leaves(jd[k])
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.device.type == "meta" and tuple(g.shape) == w.shape
                assert str(g.dtype)[6:] == str(w.dtype)
        cfg = port_cfg(jcfg)
        assert steps.shape_applicable(cfg, "long_500k") == jsteps.shape_applicable(jcfg, "long_500k")
        assert dataclasses.asdict(steps.opt_config_for(port_cfg(jcfg))) == dataclasses.asdict(
            jsteps.opt_config_for(jcfg))


#: the reference's ``test_full_param_counts_match_model_cards`` ranges, in billions
CARD_RANGES = {"yi_9b": (8.0, 10.0), "starcoder2_7b": (6.0, 8.5), "internlm2_20b": (17.0, 22.0),
               "deepseek_v3_671b": (600.0, 720.0), "grok1_314b": (280.0, 340.0), "gemma3_12b": (10.0, 14.0),
               "mamba2_1p3b": (1.0, 1.6), "zamba2_1p2b": (1.0, 1.6)}


@pytest.mark.parametrize("arch", list(CARD_RANGES))
def test_full_param_counts_match_model_cards(arch):
    lo, hi = CARD_RANGES[arch]
    total = tmodel.param_count(tmodel.init_params(tconfigs.get_config(arch), 0, device="meta")) / 1e9
    assert lo <= total <= hi, f"{arch}: {total:.2f}B not in [{lo},{hi}]"


def test_chip_phase_parameter_counts():
    """The chip run's models (chip_smoke.py): Mamba2-1.3B whole, DeepSeek-V3
    cut to 4 layers (3 dense + 1 MoE, MTP), Gemma3-12B cut to one 5:1 unit,
    Grok-1 cut to 1 layer, Zamba2-1.2B whole."""
    def count(arch, **kw):
        return tmodel.param_count(tmodel.init_params(
            dataclasses.replace(tconfigs.get_config(arch), **kw), 0, device="meta"))

    assert count("mamba2_1p3b") == 1_446_714_368
    assert count("deepseek_v3_671b", num_layers=4) == 15_162_481_664
    assert count("gemma3_12b", num_layers=6) == 3_358_114_560
    assert count("grok1_314b", num_layers=1) == 6_530_598_912
    assert count("zamba2_1p2b") == 1_170_473_856
    ds4 = dataclasses.replace(tconfigs.get_config("deepseek_v3_671b"), num_layers=4)
    experts = tmodel.init_params(ds4, 0, device="meta")["decoder"][1][0]["moe"]["gate"]
    assert experts.numel() == 3_758_096_384


# ---------------------------------------------------------------------------
# None as an empty subtree (repro_torch/tree.py, convert.py, optim)
# ---------------------------------------------------------------------------


def test_none_is_an_empty_subtree():
    """Zamba2's ``None`` positions: no leaf and no call in ``tree_map`` /
    ``tree_leaves`` (as ``jax.tree``), carried through ``convert`` and
    AdamW, which steps every other leaf as the reference does."""
    tree = {"a": torch.ones(2), "seg": [[{"w": torch.full((3,), 2.0)}, None]], "b": (None, torch.zeros(1))}
    calls = []
    out = tree_map(lambda x: calls.append(x) or x * 2, tree)
    assert len(calls) == 3 and out["seg"][0][1] is None and out["b"][0] is None
    assert len(tree_leaves(tree)) == len(jax.tree.leaves(tree)) == 3
    assert tree_map(lambda x, y: x + y, tree, tree)["seg"][0][1] is None
    np_in = {"a": np.ones(2, np.float32), "seg": [[{"w": np.full(3, 2.0, np.float32)}, None]]}
    conv = convert.lm_params_from_numpy(np_in, CPU)
    assert conv["seg"][0][1] is None and convert.to_numpy(conv)["seg"][0][1] is None
    grads = {"a": np.full(2, 0.5, np.float32), "seg": [[{"w": np.full(3, -1.0, np.float32)}, None]]}
    opt = AdamWConfig(lr=0.1)
    new, state = apply_updates(conv, convert.lm_params_from_numpy(grads, CPU), init_opt_state(conv, opt), opt)
    jnew, jstate = japply(np_in, grads, jinit_opt(np_in, JAdamW(lr=0.1)), JAdamW(lr=0.1))
    assert new["seg"][0][1] is None and state["mu"]["seg"][0][1] is None
    for g, w in leaf_pairs(new, jnew):
        close(g, w, MOD)


# ---------------------------------------------------------------------------
# a sliding window's ring filled from a prompt longer than the window
# ---------------------------------------------------------------------------


def test_windowed_ring_from_a_long_prompt():
    """Gemma3's local layers under ``windowed_cache``, with a 48-token
    prompt past the 32-token window: ``rebuffer_caches`` keeps the last
    32 positions at their ring slots (the reference's rebuffer needs the
    prompt within the window), and decode from the ring matches decode
    from the full-length cache at every step; a server on each cache
    (admission writes rings through ``_insert_row``) gives the same
    tokens."""
    from repro_torch.launch.serving import ContinuousServer, Request, ServingConfig, rebuffer_caches

    cfg = port_cfg(FAMILIES["gemma3_12b"])
    ring_cfg = dataclasses.replace(cfg, windowed_cache=True)
    params = tmodel.init_params(cfg, 0, CPU)
    tokens = t(_tokens(cfg, b=2, s=48, seed=22))
    _, pre = tmodel.prefill(params, cfg, {"tokens": tokens})
    full = rebuffer_caches(cfg, pre, 2, 60, 48, 0)
    ring = rebuffer_caches(ring_cfg, pre, 2, 60, 48, 0)
    assert [tuple(a.shape[2:3]) for a in tree_leaves(ring)] == [(32,), (32,), (60,), (60,)]
    # slot j of the ring holds position 16 + ((j - 16) mod 32), the latest p < 48 with p % 32 == j
    slots = [16 + (j - 16) % 32 for j in range(32)]
    assert torch.equal(tree_leaves(ring)[0][:, :, list(range(32))], tree_leaves(full)[0][:, :, slots])
    tok = tokens[:, -1:]
    for i in range(8):
        lf, full = tmodel.decode_step(params, cfg, tok, full, 48 + i)
        lr, ring = tmodel.decode_step(params, ring_cfg, tok, ring, 48 + i)
        close_model(lr, lf.numpy())
        tok = lf[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    ps = _tokens(cfg, b=5, s=40, seed=23)
    out = []
    for c in (cfg, ring_cfg):
        server = ContinuousServer(c, ServingConfig(slots=2, prompt_len=40, max_new=12), params, device=CPU)
        res, m = server.run([Request(rid=i, prompt=ps[i], max_new=4 + 2 * i) for i in range(5)])
        assert m["dropped_requests"] == 0
        out.append([r.tokens.tolist() for r in res])
    assert out[0] == out[1]
