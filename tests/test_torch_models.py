"""The port's dense LM stack (``repro_torch.models``, ``repro_torch.configs``)
held against the JAX package's (``repro.models``, ``repro.configs``) on
the CPU.

The reference's parameters, made by its ``init_params``, are converted
leaf for leaf (``repro_torch.convert.lm_params_from_numpy``); both
packages get the same tokens. Tolerances: rtol 1e-5 / atol 1e-6 for
forward values, rtol 1e-4 / atol 1e-5 for gradients. Configs: the
worker-contract harness's TINY_ARCH (tests/test_worker_contract.py:71),
``reduced(yi_9b)`` and ``reduced(starcoder2_7b)`` (GELU MLP), all with
float32 compute, and variants with a sliding window, a padded vocab and
tied embeddings. ``init_params`` on the meta device is held against
``jax.eval_shape`` at the FULL configs, so no memory is touched. The
reference's properties (tests/test_properties.py) are ported with
``pytest.importorskip("hypothesis")`` inside each test.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.tokens import synthetic_token_batch as jbatch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtrans  # noqa: E402
from repro.models.config import layer_segments as jsegments  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.tokens import synthetic_token_batch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttrans  # noqa: E402
from repro_torch.models.config import ArchConfig, encoder_segments, layer_segments, validate  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_worker_contract import TINY_ARCH  # noqa: E402


#: the port's own ArchConfig fields (DeepSeek-V3's router, drop-free
#: dispatch, one chip's share of the experts; Nemotron-H's grouped Mamba2,
#: relu^2 experts, attention without positions and layer pattern), absent
#: from the reference's
PORT_FIELDS = {"router_score", "routed_scaling_factor", "router_bias_rate", "moe_dispatch", "experts_held",
               "experts_offset", "ssm_heads", "ssm_groups", "expert_act", "rope", "layer_pattern"}


def config_fields(port, ref) -> tuple[dict, dict]:
    """``(port, reference)`` field dicts of two ArchConfigs over the
    reference's fields, after asserting that the port's own fields hold
    the defaults that give the reference's behaviour."""
    got, want = dataclasses.asdict(port), dataclasses.asdict(ref)
    own = {f.name: f.default for f in dataclasses.fields(port) if f.name not in want}
    assert set(own) == PORT_FIELDS and {k: got[k] for k in own} == own
    return {k: got[k] for k in want}, want

CPU = "cpu"
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def _f32(jcfg):
    return dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")


#: name -> the reference's config the test runs (float32 compute)
CONFIGS = {
    "tiny": TINY_ARCH,
    "yi_9b": jconfigs.reduced(jconfigs.get_config("yi_9b")),
    "starcoder2_7b": jconfigs.reduced(jconfigs.get_config("starcoder2_7b")),
    "yi_9b_window_padvocab": dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config("yi_9b")), local_ratio=1, sliding_window=5, vocab=500,
        vocab_pad_multiple=64),
    "tiny_tied_remat": dataclasses.replace(TINY_ARCH, tie_embeddings=True, remat=True, num_layers=3),
}


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def close_stack(got, want):
    """Whole-model outputs (the layer stack, logits, caches past the first
    layer): rtol 1e-5 and atol 1e-6 in units of the output's largest
    magnitude. Float32 dot products over d_model terms round differently
    in MKL and in XLA's Eigen, by about 1e-6 of the operands' scale."""
    want = np.asarray(want)
    close(got, want, dict(rtol=FWD["rtol"], atol=FWD["atol"] * max(1.0, float(np.max(np.abs(want))))))


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    jcfg = _f32(CONFIGS[request.param])
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    return request.param, jcfg, port_cfg(jcfg), jp, tp


def _tokens(cfg, b=2, s=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s), dtype=np.int32)


def _both_batches(cfg, tokens):
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(np.roll(tokens, -1, axis=1)),
          "mask": jnp.ones(tokens.shape, jnp.float32)}
    return jb, synthetic_token_batch(t(tokens))


# ---------------------------------------------------------------------------
# configs (src/repro/configs/__init__.py, models/config.py)
# ---------------------------------------------------------------------------


class TestConfigs:
    def test_registry_matches_reference(self):
        """Every reference architecture is ported (whisper and phi-3-vision
        too) and equals the reference's config, full and reduced."""
        assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
        assert set(tconfigs.PORTED_ARCH_IDS) == set(jconfigs.ARCH_IDS)
        for arch in tconfigs.PORTED_ARCH_IDS:
            got, want = config_fields(tconfigs.get_config(arch), jconfigs.get_config(arch))
            assert got == want
            got, want = config_fields(tconfigs.reduced(tconfigs.get_config(arch)),
                                      jconfigs.reduced(jconfigs.get_config(arch)))
            assert got == want
        got, want = config_fields(tconfigs.get_config("Yi-9B".lower()), jconfigs.get_config("yi-9b"))
        assert got == want
        assert sorted(tconfigs.all_configs()) == sorted(tconfigs.PORTED_ARCH_IDS)

    def test_unknown_arch(self):
        with pytest.raises(KeyError, match="unknown arch"):
            tconfigs.get_config("gpt5")

    @pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
    def test_segments_and_validate_match_reference(self, arch):
        """The config copy is framework-neutral: every reference config,
        full and reduced, gives the same segments."""
        for jcfg in (jconfigs.get_config(arch), jconfigs.reduced(jconfigs.get_config(arch))):
            cfg = port_cfg(jcfg)
            validate(cfg)
            assert layer_segments(cfg) == [(list(map(_spec, u)), r) for u, r in jsegments(jcfg)]
            assert (cfg.hd(), cfg.padded_vocab(), cfg.is_encdec(), cfg.expert_ff()) == (
                jcfg.hd(), jcfg.padded_vocab(), jcfg.is_encdec(), jcfg.expert_ff())
            assert len(encoder_segments(cfg)) == (1 if jcfg.is_encdec() else 0)


def _spec(s):
    from repro_torch.models.config import LayerSpec

    return LayerSpec(kind=s.kind, window=s.window, cross_attention=s.cross_attention)


class TestFullShapes:
    @pytest.mark.parametrize("arch", ["yi_9b", "starcoder2_7b", "internlm2_20b"])
    def test_meta_init_matches_eval_shape(self, arch):
        """``init_params`` on the meta device against
        ``jax.eval_shape(repro.models.init_params)`` at the FULL config,
        leaf for leaf: same tree, shapes and dtypes; nothing allocated."""
        jcfg = jconfigs.get_config(arch)
        want = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0))
        got = tmodel.init_params(tconfigs.get_config(arch), 0, device="meta")
        assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
            tree_map(lambda a: 0, got))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            g = got
            for k in path:
                g = g[k.key if hasattr(k, "key") else k.idx]
            assert g.device.type == "meta"
            assert tuple(g.shape) == leaf.shape and str(g.dtype).split(".")[-1] == str(leaf.dtype), path
        assert tmodel.param_count(got) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))

    def test_yi_9b_one_layer_count(self):
        """The chip run's model: Yi-9B at full width, depth cut to 1."""
        cfg = dataclasses.replace(tconfigs.get_config("yi_9b"), num_layers=1)
        params = tmodel.init_params(cfg, 0, device="meta")
        assert tmodel.param_count(params) == 697_315_328
        assert sum(a.numel() * a.element_size() for a in tree_leaves(params)) == 2_789_261_312

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default resolves")
        with pytest.raises(RuntimeError, match="cuda"):
            tmodel.init_params(port_cfg(TINY_ARCH))
        with pytest.raises(RuntimeError, match="cuda"):
            tmodel.init_cache(port_cfg(TINY_ARCH), 1, 4)

    def test_init_draws_from_the_generator(self):
        cfg = port_cfg(TINY_ARCH)
        a, b = tmodel.init_params(cfg, 3, CPU), tmodel.init_params(cfg, 3, CPU)
        c = tmodel.init_params(cfg, 4, CPU)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
        assert not torch.equal(a["embed"], c["embed"])
        assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.2)
        assert torch.equal(a["final_norm"], torch.zeros(cfg.d_model))


# ---------------------------------------------------------------------------
# layers (src/repro/models/layers.py)
# ---------------------------------------------------------------------------


class TestLayers:
    def test_rms_norm(self):
        rng = np.random.default_rng(0)
        x, s = rng.normal(size=(2, 5, 32)).astype(np.float32), rng.normal(size=(32,)).astype(np.float32)
        close(tlayers.rms_norm(t(x), t(s), 1e-5), jlayers.rms_norm(x, s, 1e-5), FWD)
        # the output keeps the input's dtype; the math is float32
        got = tlayers.rms_norm(t(x, torch.bfloat16), t(s))
        assert got.dtype == torch.bfloat16
        want = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16), s)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    @pytest.mark.parametrize("gated", [True, False])
    def test_apply_mlp(self, gated):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(2, 3, 16)).astype(np.float32)
        p = {"up": rng.normal(size=(16, 24)).astype(np.float32) * 0.3,
             "down": rng.normal(size=(24, 16)).astype(np.float32) * 0.3}
        if gated:
            p["gate"] = rng.normal(size=(16, 24)).astype(np.float32) * 0.3
        close(tlayers.apply_mlp({k: t(v) for k, v in p.items()}, t(x)), jlayers.apply_mlp(p, x), FWD)
        if gated:
            close(tlayers.swiglu(t(x), t(p["gate"]), t(p["up"]), t(p["down"])),
                  jlayers.swiglu(x, p["gate"], p["up"], p["down"]), FWD)

    @pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
    def test_rope(self, theta):
        rng = np.random.default_rng(2)
        pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
        cos, sin = tlayers.rope_freqs(t(pos), 16, theta)
        jcos, jsin = jlayers.rope_freqs(jnp.asarray(pos), 16, theta)
        close(cos, jcos, FWD)
        close(sin, jsin, FWD)
        assert cos.dtype == torch.float32
        x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
        close(tlayers.apply_rope(t(x), cos, sin), jlayers.apply_rope(x, jcos, jsin), FWD)

    def test_softmax_cross_entropy(self):
        rng = np.random.default_rng(3)
        logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
        labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
        mask = (rng.random((2, 5)) < 0.7).astype(np.float32)
        close(tlayers.softmax_cross_entropy(t(logits), t(labels), t(mask)),
              jlayers.softmax_cross_entropy(logits, labels, mask), FWD)
        zero = np.zeros((2, 5), np.float32)
        assert float(tlayers.softmax_cross_entropy(t(logits), t(labels), t(zero))) == 0.0


# ---------------------------------------------------------------------------
# attention (src/repro/models/attention.py, GQA)
# ---------------------------------------------------------------------------


def _gqa_params(cfg, seed=4):
    rng = np.random.default_rng(seed)
    hd = cfg.hd()
    shapes = {"wq": (cfg.d_model, cfg.num_heads * hd), "wk": (cfg.d_model, cfg.num_kv_heads * hd),
              "wv": (cfg.d_model, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, cfg.d_model)}
    return {k: (rng.normal(size=s) * s[0] ** -0.5).astype(np.float32) for k, s in shapes.items()}


#: 8 query heads over 2 KV heads: query head h reads KV head h // 4
GQA_CFG = dataclasses.replace(TINY_ARCH, d_model=32, num_heads=8, num_kv_heads=2, head_dim=8)


class TestAttention:
    @pytest.mark.parametrize("window", [None, 3])
    def test_gqa_full(self, window):
        p = _gqa_params(GQA_CFG)
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 9, 32)).astype(np.float32)
        pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
        out, (k, v) = tattn.gqa_full({n: t(a) for n, a in p.items()}, t(x), t(pos), port_cfg(GQA_CFG), window)
        jout, (jk, jv) = jattn.gqa_full(p, x, jnp.asarray(pos), GQA_CFG, window)
        for a, b in ((out, jout), (k, jk), (v, jv)):
            close(a, b, FWD)

    def test_grouping_is_repeat_interleave(self):
        """Query head h attends with KV head h // G: the same as expanding
        the KV heads with ``repeat_interleave`` (not ``repeat``)."""
        rng = np.random.default_rng(6)
        b, s, K, G, hd = 1, 5, 2, 4, 8
        q = torch.from_numpy(rng.normal(size=(b, s, K * G, hd)).astype(np.float32))
        k = torch.from_numpy(rng.normal(size=(b, s, K, hd)).astype(np.float32))
        v = torch.from_numpy(rng.normal(size=(b, s, K, hd)).astype(np.float32))
        mask = tattn._causal_window_mask(torch.arange(s)[None], torch.arange(s)[None], None)
        got = tattn._sdpa(q.reshape(b, s, K, G, hd), k, v, mask, hd ** -0.5).reshape(b, s, K * G, hd)
        ki, vi = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
        sc = torch.einsum("bqhd,bshd->bhqs", q, ki) * hd ** -0.5
        sc = torch.where(mask[:, None], sc, tattn.NEG_INF)
        want = torch.einsum("bhqs,bshd->bqhd", torch.softmax(sc, -1), vi)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("window", [None, 5])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("hd", [8, 128])
    def test_gqa_full_on_the_cpu_is_sdpa(self, hd, dtype, window):
        """On CPU tensors ``gqa_full`` runs ``_sdpa``, bit for bit the
        products and masked softmax it ran before K6, at every head width
        and dtype (K6's bf16 at 128 included: K6 runs on the card only),
        and the tracer counts each call at ``plain``."""
        from repro_torch import trace

        cfg = dataclasses.replace(TINY_ARCH, d_model=4 * hd, num_heads=4, num_kv_heads=2, head_dim=hd)
        cfg = port_cfg(cfg)
        params = {n: t(a, dtype) for n, a in _gqa_params(cfg).items()}
        x = t(np.random.default_rng(7).normal(size=(2, 11, 4 * hd)).astype(np.float32), dtype)
        pos = torch.arange(11, dtype=torch.int32).expand(2, 11)
        trace.disable()
        trace.collect()
        trace.enable()
        try:
            out, (k, v) = tattn.gqa_full(params, x, pos, cfg, window)
            counts = trace.collect()["counters"]
        finally:
            trace.disable()
        assert counts["attention_calls"] == {"plain": 1}
        q, k_want, v_want = tattn._gqa_qkv(params, x, pos, cfg)
        mask = tattn._causal_window_mask(pos, pos, window)
        want = tattn._sdpa(q.reshape(2, 11, 2, 2, hd), k_want, v_want, mask, hd ** -0.5).reshape(2, 11, 4 * hd)
        assert torch.equal(out, torch.matmul(want, params["wo"]))
        assert torch.equal(k, k_want) and torch.equal(v, v_want)

    def test_k6_is_never_taken_on_the_cpu(self):
        """``_k6_takes`` reads only its input: bf16 at head 128 on the CPU
        is not K6's; called anyway, K6's node raises before any launch."""
        from repro_torch.kernels import ops as tops

        q, k, v = (torch.zeros((1, 4, h, 128), dtype=torch.bfloat16) for h in (4, 2, 2))
        pos = torch.arange(4, dtype=torch.int32).expand(1, 4)
        assert not tattn._k6_takes(q, k, v)
        tops.reset_launches()
        with pytest.raises(ValueError, match="CUDA tensors only"):
            tattn._K6.apply(q, k, v, pos, None, 128 ** -0.5)
        assert tops.LAUNCHES["attention_fwd"] == 0

    @pytest.mark.parametrize("case", ["scalar", "per_row", "ring"])
    def test_gqa_decode(self, case):
        """scalar ``pos``, per-row ``pos`` (rows at different depths) and a
        ring buffer smaller than the position (writes at pos % S)."""
        cfg = GQA_CFG if case != "ring" else dataclasses.replace(GQA_CFG, sliding_window=4)
        window = 4 if case == "ring" else None
        p = _gqa_params(cfg)
        rng = np.random.default_rng(7)
        b, S = 3, 4 if case == "ring" else 10
        x = rng.normal(size=(b, 1, 32)).astype(np.float32)
        ck = rng.normal(size=(b, S, 2, 8)).astype(np.float32)
        cv = rng.normal(size=(b, S, 2, 8)).astype(np.float32)
        pos = {"scalar": np.int32(6), "per_row": np.asarray([0, 4, 9], np.int32),
               "ring": np.asarray([2, 5, 11], np.int32)}[case]
        got = tattn.gqa_decode({n: t(a) for n, a in p.items()}, t(x), t(ck), t(cv), t(pos), port_cfg(cfg),
                               window)
        want = jattn.gqa_decode(p, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos), cfg,
                                window)
        for a, w in zip(got, want):
            close(a, w, FWD)
        if case == "scalar":  # a scalar is the per-row write with every row at it, bit for bit
            vec = tattn.gqa_decode({n: t(a) for n, a in p.items()}, t(x), t(ck), t(cv),
                                   torch.full((b,), 6, dtype=torch.int32), port_cfg(cfg), window)
            for a, w in zip(got, vec):
                assert torch.equal(a, w)


# ---------------------------------------------------------------------------
# the model (src/repro/models/transformer.py, model.py)
# ---------------------------------------------------------------------------


class TestModel:
    def test_forward_stack(self, model):
        _, jcfg, cfg, jp, tp = model
        rng = np.random.default_rng(8)
        x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
        got, aux, caches = ttrans.forward_stack(tp["decoder"], layer_segments(cfg), cfg, t(x), t(pos),
                                                collect_cache=True)
        want, jaux, jcaches = jtrans.forward_stack(jp["decoder"], jsegments(jcfg), jcfg, x, jnp.asarray(pos),
                                                   collect_cache=True)
        close_stack(got, want)
        assert float(aux) == float(jaux) == 0.0
        for a, w in zip(tree_leaves(caches), jax.tree.leaves(jcaches)):
            close_stack(a, w)

    def test_loss_and_grads(self, model):
        _, jcfg, cfg, jp, tp = model
        tokens = _tokens(cfg)
        jb, tb = _both_batches(cfg, tokens)
        (jl, jm), jg = jax.value_and_grad(lambda q: jmodel.loss_fn(q, jcfg, jb), has_aux=True)(jp)
        leaves = tree_map(lambda a: a.clone().requires_grad_(True), tp)
        loss, metrics = tmodel.loss_fn(leaves, cfg, tb)
        loss.backward()
        close(loss, jl, FWD)
        for k in ("ce_loss", "aux_loss", "loss"):
            close(metrics[k], jm[k], FWD)
        for path, want in jax.tree_util.tree_leaves_with_path(jg):
            g = leaves
            for k in path:
                g = g[k.key if hasattr(k, "key") else k.idx]
            close(g.grad, want, GRAD)

    def test_remat_changes_no_bit(self, model):
        _, _, cfg, _, tp = model
        tb = synthetic_token_batch(t(_tokens(cfg)))
        grads = []
        for remat in (False, True):
            leaves = tree_map(lambda a: a.clone().requires_grad_(True), tp)
            loss, _ = tmodel.loss_fn(leaves, dataclasses.replace(cfg, remat=remat), tb)
            loss.backward()
            grads.append([loss.detach()] + [a.grad for a in tree_leaves(leaves)])
        assert all(torch.equal(a, b) for a, b in zip(*grads))

    def test_prefill_matches_reference(self, model):
        _, jcfg, cfg, jp, tp = model
        tokens = _tokens(cfg, s=9)
        logits, caches = tmodel.prefill(tp, cfg, {"tokens": t(tokens)})
        jlogits, jcaches = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)})
        close_stack(logits, jlogits)
        assert logits.shape == (2, 1, cfg.padded_vocab())
        for a, w in zip(tree_leaves(caches), jax.tree.leaves(jcaches)):
            close_stack(a, w)

    def test_decode_matches_reference_and_full_forward(self, model):
        """Teacher-forced decode from an empty cache, at scalar and at
        per-row ``pos``: each position's logits against the reference's
        decode_step and against the full forward (tests/test_models.py:112)."""
        _, jcfg, cfg, jp, tp = model
        b, s = 2, 8
        tokens = _tokens(cfg, b=b, s=s, seed=9)
        x = tmodel._embed(tp, cfg, t(tokens))
        pos = torch.arange(s, dtype=torch.int32).expand(b, s)
        x, _, _ = ttrans.forward_stack(tp["decoder"], layer_segments(cfg), cfg, x, pos)
        full = tmodel._logits(tp, cfg, x)
        caches = tmodel.init_cache(cfg, b, s, device=CPU)
        row_caches = caches
        jcaches = jmodel.init_cache(jcfg, b, s)
        for i in range(s):
            tok = t(tokens[:, i:i + 1])
            logits, caches = tmodel.decode_step(tp, cfg, tok, caches, i)
            row_logits, row_caches = tmodel.decode_step(tp, cfg, tok, row_caches,
                                                        torch.full((b,), i, dtype=torch.int32))
            jlogits, jcaches = jmodel.decode_step(jp, jcfg, jnp.asarray(tokens[:, i:i + 1]), jcaches,
                                                  jnp.asarray(i, jnp.int32))
            close_stack(logits, jlogits)
            assert torch.equal(logits, row_logits)
            close_stack(logits[:, 0], full[:, i].numpy())
        for a, w in zip(tree_leaves(caches), jax.tree.leaves(jcaches)):
            close_stack(a, w)

    def test_rows_at_different_depths(self, model):
        """Continuous batching: row 1 runs two positions behind row 0 (it
        repeats position 0 until row 0 reaches 2); each row's logits
        equal that row decoded alone."""
        _, _, cfg, _, tp = model
        n = 6
        tokens = torch.from_numpy(_tokens(cfg, b=2, s=n, seed=10))
        caches = tmodel.init_cache(cfg, 2, n, device=CPU)
        # each row alone, in a lockstep batch of the same shape holding it twice
        alone = [tmodel.init_cache(cfg, 2, n, device=CPU) for _ in range(2)]
        want = [[], []]
        for r in range(2):
            for i in range(n):
                logits, alone[r] = tmodel.decode_step(tp, cfg, tokens[[r, r], i:i + 1], alone[r], i)
                want[r].append(logits[:1])
        for j in range(n):
            pos = torch.tensor([j, max(j - 2, 0)], dtype=torch.int32)
            tok = tokens[torch.arange(2), pos.long()].reshape(2, 1)
            logits, caches = tmodel.decode_step(tp, cfg, tok, caches, pos)
            for r in range(2):
                close_stack(logits[r:r + 1], want[r][int(pos[r])].numpy())

    def test_init_cache_matches_reference(self, model):
        _, jcfg, cfg, _, _ = model
        for windowed in (False, True):
            got = tmodel.init_cache(dataclasses.replace(cfg, windowed_cache=windowed), 3, 16, device=CPU)
            want = jmodel.init_cache(dataclasses.replace(jcfg, windowed_cache=windowed), 3, 16)
            assert [tuple(a.shape) for a in tree_leaves(got)] == [a.shape for a in jax.tree.leaves(want)]
            assert all(a.dtype == torch.float32 and not a.any() for a in tree_leaves(got))

    def test_embed_and_logits(self, model):
        _, jcfg, cfg, jp, tp = model
        tokens = _tokens(cfg, s=5)
        close(tmodel._embed(tp, cfg, t(tokens)), jmodel._embed(jp, jcfg, jnp.asarray(tokens), {}), FWD)
        x = np.random.default_rng(11).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
        got = tmodel._logits(tp, cfg, t(x))
        close(got, jmodel._logits(jp, jcfg, x), FWD)
        if cfg.padded_vocab() != cfg.vocab:  # padded columns masked
            assert float(got[..., cfg.vocab:].max()) < -1e29


# ---------------------------------------------------------------------------
# the reference's properties (tests/test_properties.py)
# ---------------------------------------------------------------------------


def test_rope_preserves_norm():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=25)
    @hyp.given(st.integers(min_value=1, max_value=3), st.integers(min_value=1, max_value=16))
    def prop(b, s):
        x = torch.from_numpy(np.random.default_rng(b * 31 + s).normal(size=(b, s, 2, 8)).astype(np.float32))
        pos = torch.arange(s).expand(b, s)
        cos, sin = tlayers.rope_freqs(pos, 8, 10_000.0)
        y = tlayers.apply_rope(x, cos, sin)
        np.testing.assert_allclose(x.norm(dim=-1).numpy(), y.norm(dim=-1).numpy(), rtol=1e-4)

    prop()


def test_rope_relative_property():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=25)
    @hyp.given(st.integers(min_value=2, max_value=64))
    def prop(d2):
        d = d2 * 2
        rng = np.random.default_rng(d)
        q = torch.from_numpy(rng.normal(size=(1, 1, 1, d)).astype(np.float32))
        k = torch.from_numpy(rng.normal(size=(1, 1, 1, d)).astype(np.float32))

        def dot_at(i, j):
            ci, si = tlayers.rope_freqs(torch.tensor([[i]]), d, 10_000.0)
            cj, sj = tlayers.rope_freqs(torch.tensor([[j]]), d, 10_000.0)
            return float(torch.sum(tlayers.apply_rope(q, ci, si) * tlayers.apply_rope(k, cj, sj)))

        assert dot_at(5, 3) == pytest.approx(dot_at(9, 7), rel=1e-3, abs=1e-4)

    prop()


def test_rms_norm_scale_invariance():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=30)
    @hyp.given(st.floats(min_value=0.5, max_value=100.0))
    def prop(scale):
        x = torch.tensor([[1.0, -2.0, 3.0, 0.5]])
        g = torch.zeros((4,))
        np.testing.assert_allclose(tlayers.rms_norm(x, g).numpy(), tlayers.rms_norm(x * scale, g).numpy(),
                                   rtol=1e-2)

    prop()


def test_cross_entropy_bounds():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=30)
    @hyp.given(st.integers(min_value=1, max_value=5), st.integers(min_value=2, max_value=50))
    def prop(b, v):
        labels = torch.zeros((b, 3), dtype=torch.int32)
        ce = float(tlayers.softmax_cross_entropy(torch.zeros((b, 3, v)), labels, torch.ones((b, 3))))
        assert ce == pytest.approx(np.log(v), rel=1e-5)

    prop()


def test_ring_slot_positions():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(deadline=None, max_examples=50)
    @hyp.given(st.integers(min_value=0, max_value=10), st.integers(min_value=0, max_value=100_000))
    def prop(s_pow, pos):
        """The decode path's slot -> absolute-position map: each slot holds
        the largest p <= pos with p % S == slot, all within the last S."""
        size = 2 ** s_pow
        kpos = tattn.ring_positions(torch.tensor([pos], dtype=torch.int32), size)[0].numpy()
        assert (kpos <= pos).all()
        assert (kpos > pos - size).all()
        assert (kpos % size == np.arange(size)).all()

    prop()


def test_ring_slot_positions_seeded():
    """The property above on fixed draws (it runs without hypothesis),
    against the reference's formula."""
    rng = np.random.default_rng(12)
    for s_pow, pos in zip(rng.integers(0, 11, 20), rng.integers(0, 100_000, 20)):
        size = 2 ** int(s_pow)
        slot = np.arange(size)
        got = tattn.ring_positions(torch.tensor([int(pos)], dtype=torch.int32), size)[0].numpy()
        np.testing.assert_array_equal(got, pos - (pos - slot) % size)


def test_token_batch_matches_reference():
    """``synthetic_token_batch`` from given tokens: the reference's labels
    (shifted left, wrapping) and mask."""
    key = jax.random.PRNGKey(3)
    jb = jbatch(key, 3, 7, 50)
    got = synthetic_token_batch(t(jb["tokens"]))
    for k in ("tokens", "labels", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jb[k]))
        assert str(got[k].dtype).split(".")[-1] == str(jb[k].dtype)
