"""The port's enc-dec and VLM families (whisper's encoder and
cross-attention, phi-3-vision's spliced frontend: ``repro_torch.models``,
``repro_torch.data.tokens``, ``repro_torch.launch``) held against the JAX
package's on the CPU.

Each test names the reference function or test it is held against. The
reference's parameters, made by its own ``init_params``, are converted
leaf for leaf (``repro_torch.convert.lm_params_from_numpy``); both
packages get the same seeded numpy tokens and frontend embeddings.
Tolerances: single modules (``cross_kv``, ``cross_attend``, the splice) at
rtol / atol 1e-5; the encoder's output, the loss and every gradient at
tests/test_torch_models.py's ``close_stack``: rtol 1e-5 and atol 1e-6 of
the output's largest magnitude (float32 dot products round differently in
MKL and in XLA's Eigen); prefill and decode logits and caches at
tests/test_torch_families.py's ``close_model``, atol 1e-5 of the largest
magnitude (phi-3-vision's prefill logits differ by 2e-6 of it, after the
patch projection adds a product of its own); cache
re-buffering and the row insert bit for bit; the teacher-forced decode
against the full forward at the reference's own 2e-2
(tests/test_models.py). Configs: ``reduced()`` of whisper_large_v3 and
phi3_vision_4p2b, float32 (2 encoder and 2 decoder layers, 16 frontend
positions of 32 features); ``init_params`` on the meta device at their
FULL configs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.tokens import TokenPipeline, stream_frontend, stream_tokens  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.serving import (  # noqa: E402
    AdoptionSlot,
    ContinuousServer,
    Request,
    ServingConfig,
    _insert_row,
    rebuffer_caches,
)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.config import ArchConfig, layer_segments  # noqa: E402
from repro_torch.models.transformer import forward_stack  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


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
MOD = dict(rtol=1e-5, atol=1e-5)
ARCH_IDS = ["whisper_large_v3", "phi3_vision_4p2b"]
#: the reference's ``test_full_param_counts_match_model_cards`` ranges, in billions
CARD_RANGES = {"whisper_large_v3": (1.2, 2.0), "phi3_vision_4p2b": (3.5, 4.5)}
COUNTING = ("requests_completed", "dropped_requests", "decode_steps", "decode_tokens", "adoptions",
            "adoption_steps", "recompiles")


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def close_stack(got, want):
    """tests/test_torch_models.py's rule for whole-model outputs: rtol
    1e-5 and atol 1e-6 in units of the output's largest magnitude."""
    want = np.asarray(want)
    close(got, want, dict(rtol=1e-5, atol=1e-6 * max(1.0, float(np.max(np.abs(want))))))


def close_model(got, want):
    """tests/test_torch_families.py's rule for whole-model outputs: rtol
    1e-5, atol 1e-5 of the largest magnitude."""
    want = np.asarray(want)
    close(got, want, dict(rtol=1e-5, atol=1e-5 * max(1.0, float(np.max(np.abs(want))))))


def jconfigs():
    from repro import configs

    return configs


def jmodel():
    from repro.models import model

    return model


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_port(tree):
    return convert.lm_params_from_numpy(np_tree(tree), CPU)


def at_path(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def assert_bits_equal(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.fixture(scope="module", params=ARCH_IDS)
def family(request):
    """(name, reference cfg, port cfg, reference params, port params)."""
    jcfg = jconfigs().reduced(jconfigs().get_config(request.param))
    jp = jmodel().init_params(jcfg, jax.random.PRNGKey(0))
    return request.param, jcfg, port_cfg(jcfg), jp, to_port(jp)


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s), dtype=np.int32)


def _frontends(cfg, b=2, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.frontend_len, cfg.frontend_dim)) * 0.02).astype(np.float32)


def _batches(cfg, tokens, frontends):
    """The same batch for both packages: (reference's, port's)."""
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(np.roll(tokens, -1, axis=1)),
          "mask": jnp.ones(tokens.shape, jnp.float32), "frontend_embeds": jnp.asarray(frontends)}
    return jb, {k: t(v) for k, v in jb.items()}


# ---------------------------------------------------------------------------
# cross-attention (src/repro/models/attention.py:245-276)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_cross_kv_and_attend(kv_heads):
    """``init_cross``'s shapes, ``cross_kv`` and ``cross_attend`` (every
    decoder position sees every encoder position) against the reference's,
    at whisper's MHA and with query heads sharing a K/V head."""
    from repro.models import attention as jattn

    jcfg = dataclasses.replace(jconfigs().reduced(jconfigs().get_config("whisper_large_v3")),
                               num_kv_heads=kv_heads)
    cfg = port_cfg(jcfg)
    jp = np_tree(jattn.init_cross(jax.random.PRNGKey(3), jcfg, jnp.float32))
    shapes = {k: tuple(v.shape) for k, v in tattn.init_cross(torch.Generator().manual_seed(0), cfg,
                                                              torch.float32).items()}
    assert shapes == {k: v.shape for k, v in jp.items()}
    rng = np.random.default_rng(4)
    enc = (rng.normal(size=(2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    x = (rng.normal(size=(2, 5, cfg.d_model)) * 0.5).astype(np.float32)
    k, v = tattn.cross_kv(to_port(jp), t(enc), cfg)
    jk, jv = jattn.cross_kv(jp, jnp.asarray(enc), jcfg)
    assert tuple(k.shape) == (2, 16, kv_heads, cfg.hd())
    close(k, jk, MOD)
    close(v, jv, MOD)
    close(tattn.cross_attend(to_port(jp), t(x), k, v, cfg),
          jattn.cross_attend(jp, jnp.asarray(x), jk, jv, jcfg), MOD)


# ---------------------------------------------------------------------------
# the encoder and the frontend splice (src/repro/models/model.py:80-108)
# ---------------------------------------------------------------------------


def test_encode_matches_reference():
    """``_encode``: the frontend projection, the (causal, as the
    reference's) encoder stack and its final norm."""
    jcfg = jconfigs().reduced(jconfigs().get_config("whisper_large_v3"))
    jp = jmodel().init_params(jcfg, jax.random.PRNGKey(0))
    fe = _frontends(jcfg)
    got = tmodel._encode(to_port(jp), port_cfg(jcfg), {"frontend_embeds": t(fe)})
    want = jmodel()._encode(jp, jcfg, {"frontend_embeds": jnp.asarray(fe)})
    assert tuple(got.shape) == (2, jcfg.frontend_len, jcfg.d_model)
    close_stack(got, want)


@pytest.mark.parametrize("seq", [24, 8], ids=["patches_then_text", "prompt_shorter_than_patches"])
def test_embed_splice_matches_reference(seq):
    """``_embed``'s vision splice, both branches: ``f < s`` pads the
    projected patches with zeros, ``f >= s`` keeps the first ``s``; the
    positions past the patches keep their token embeddings, and a batch
    without ``frontend_embeds`` is not spliced."""
    jcfg = jconfigs().reduced(jconfigs().get_config("phi3_vision_4p2b"))
    cfg = port_cfg(jcfg)
    jp = jmodel().init_params(jcfg, jax.random.PRNGKey(0))
    tp = to_port(jp)
    tokens, fe = _tokens(cfg, s=seq), _frontends(cfg)
    got = tmodel._embed(tp, cfg, t(tokens), {"frontend_embeds": t(fe)})
    want = jmodel()._embed(jp, jcfg, jnp.asarray(tokens), {"frontend_embeds": jnp.asarray(fe)})
    close(got, want, MOD)
    plain = tmodel._embed(tp, cfg, t(tokens))
    assert torch.equal(got[:, cfg.frontend_len:], plain[:, cfg.frontend_len:])
    assert not torch.equal(got[:, :1], plain[:, :1])
    close(plain, jmodel()._embed(jp, jcfg, jnp.asarray(tokens), {}), MOD)


# ---------------------------------------------------------------------------
# whole models (tests/test_models.py on the two reduced configs)
# ---------------------------------------------------------------------------


def test_loss_and_gradients_match_reference(family):
    """``loss_fn`` and the gradient of every leaf (the encoder's, the
    cross-attention's and ``frontend_proj`` included)."""
    _, jcfg, cfg, jp, tp = family
    jb, tb = _batches(cfg, _tokens(cfg), _frontends(cfg))
    (jloss, jm), jg = jax.jit(jax.value_and_grad(lambda q: jmodel().loss_fn(q, jcfg, jb), has_aux=True))(jp)
    leaves = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    loss, metrics = tmodel.loss_fn(leaves, cfg, tb)
    loss.backward()
    assert metrics.keys() == jm.keys()
    close_stack(loss.detach(), jloss)
    paths = jax.tree_util.tree_leaves_with_path(jg)
    assert len(paths) == len(tree_leaves(leaves))
    for path, want in paths:
        close_stack(at_path(leaves, path).grad, want)
    assert any("cross" in str(p) or "frontend_proj" in str(p) for p, _ in paths)


def test_prefill_and_greedy_tokens_match_reference(family):
    """``prefill`` (logits and every cache entry, the cross K/V included),
    then 16 greedy tokens from caches re-buffered into max_len buffers,
    each step's logits against the reference's ``decode_step``."""
    from repro.launch.serving import rebuffer_caches as jrebuffer

    _, jcfg, cfg, jp, tp = family
    b, s, n = 2, 24, 16
    jb, tb = _batches(cfg, _tokens(cfg, b, s, seed=5), _frontends(cfg, b, seed=6))
    jlogits, jpre = jax.jit(lambda p, x: jmodel().prefill(p, jcfg, x))(jp, jb)
    logits, pre = tmodel.prefill(tp, cfg, tb)
    close_model(logits, jlogits)
    assert len(tree_leaves(pre)) == len(jax.tree.leaves(jpre)) == (4 if cfg.is_encdec() else 2)
    for g, w in zip(tree_leaves(pre), jax.tree.leaves(jpre)):
        close_model(g, w)
    enc_len = cfg.frontend_len if cfg.is_encdec() else 0
    jc = jrebuffer(jcfg, jpre, b, s + n, s, enc_len)
    c = rebuffer_caches(cfg, pre, b, s + n, s, enc_len)
    jdecode = jax.jit(lambda p, tok, cc, pos: jmodel().decode_step(p, jcfg, tok, cc, pos))
    jtok, tok = np.asarray(jlogits[:, -1].argmax(-1))[:, None], logits[:, -1].argmax(-1, keepdim=True)
    jout, out = [jtok], [tok]
    with torch.no_grad():
        for i in range(n - 1):
            jl, jc = jdecode(jp, jnp.asarray(jtok, jnp.int32), jc, jnp.asarray(s + i, jnp.int32))
            lg, c = tmodel.decode_step(tp, cfg, tok.to(torch.int32), c, s + i, in_place=True)
            close_model(lg, jl)
            jtok, tok = np.asarray(jl[:, -1].argmax(-1))[:, None], lg[:, -1].argmax(-1, keepdim=True)
            jout.append(jtok)
            out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), np.concatenate(jout, 1))


def test_teacher_forced_decode_matches_full_forward(family):
    """Port only (the reference holds neither model this way,
    tests/test_models.py:109-111): after a prefill of a prompt (the
    encoder included for whisper; longer than the 16 patches for
    phi-3-vision), decoding the rest of the sequence teacher-forced gives
    the full forward's logits at every position, at 2e-2."""
    _, _, cfg, _, tp = family
    b, s, p = 2, 28, 20
    tokens, fe = t(_tokens(cfg, b, s, seed=7)), t(_frontends(cfg, b, seed=8))
    batch = {"tokens": tokens, "frontend_embeds": fe}
    with torch.no_grad():
        enc = tmodel._encode(tp, cfg, batch) if cfg.is_encdec() else None
        x = tmodel._embed(tp, cfg, tokens, batch)
        x, _, _ = forward_stack(tp["decoder"], layer_segments(cfg), cfg, x, tmodel._positions(tokens),
                                enc_out=enc)
        full = tmodel._logits(tp, cfg, x)
        logits, pre = tmodel.prefill(tp, cfg, {"tokens": tokens[:, :p], "frontend_embeds": fe})
        caches = rebuffer_caches(cfg, pre, b, s, p, cfg.frontend_len if cfg.is_encdec() else 0)
        dec = [logits[:, 0]]
        for i in range(p, s - 1):
            lg, caches = tmodel.decode_step(tp, cfg, tokens[:, i:i + 1], caches, i, in_place=True)
            dec.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full[:, p - 1:s - 1].numpy(),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# shapes: caches, decode specs and the FULL configs on the meta device
# ---------------------------------------------------------------------------


def assert_shapes(got, want):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_and_decode_specs_match_eval_shape(arch):
    """``init_cache(..., enc_len)`` (the 4-tuple entries of cross layers)
    against ``jax.eval_shape`` of the reference's, and
    ``launch/steps.py::decode_specs`` at the FULL config and decode_32k
    (meta tensors) against its ShapeDtypeStructs."""
    from repro.launch import steps as jsteps

    jcfg = jconfigs().reduced(jconfigs().get_config(arch))
    enc_len = jcfg.frontend_len if jcfg.is_encdec() else 0
    want = jax.eval_shape(lambda: jmodel().init_cache(jcfg, 3, 20, enc_len=enc_len))
    got = tmodel.init_cache(port_cfg(jcfg), 3, 20, device=CPU, enc_len=enc_len)
    assert_shapes(got, want)
    assert len(got[0][0]) == (4 if jcfg.is_encdec() else 2)
    full = jconfigs().get_config(arch)
    jd, d = jsteps.decode_specs(full, "decode_32k"), steps.decode_specs(port_cfg(full), "decode_32k")
    assert jd.keys() == d.keys()
    for k in jd:
        assert_shapes(d[k], jd[k])
        assert all(a.device.type == "meta" for a in tree_leaves(d[k]))
    if full.is_encdec():
        assert tuple(d["caches"][0][0][2].shape) == (32, 128, 1500, 20, 64)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_init_matches_eval_shape(arch):
    """``init_params`` on the meta device against ``jax.eval_shape`` at
    the FULL config, leaf for leaf (encoder, enc_norm, frontend_proj, each
    decoder layer's ln_x and cross); nothing allocated."""
    jcfg = jconfigs().get_config(arch)
    want = jax.eval_shape(lambda k: jmodel().init_params(jcfg, k), jax.random.PRNGKey(0))
    got = tmodel.init_params(tconfigs.get_config(arch), 0, device="meta")
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(tree_map(lambda a: 0, got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g = at_path(got, path)
        assert g.device.type == "meta"
        assert tuple(g.shape) == leaf.shape and str(g.dtype)[6:] == str(leaf.dtype), path
    assert tmodel.param_count(got) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_param_counts_match_model_cards(arch):
    """The reference's model-card ranges (tests/test_models.py:59-60) and
    the chip run's exact counts: whisper's decoder and encoder apart."""
    lo, hi = CARD_RANGES[arch]
    params = tmodel.init_params(tconfigs.get_config(arch), 0, device="meta")
    total = tmodel.param_count(params)
    assert lo <= total / 1e9 <= hi
    if arch == "whisper_large_v3":
        assert total == 1_601_154_560
        assert tmodel.param_count(params["decoder"]) == 838_983_680
        assert tmodel.param_count(params["encoder"]) == 629_227_520
    else:
        assert total == 3_824_225_280


def test_registry_carries_both():
    """``get_config`` equals the reference's field for field (full and
    reduced), and no architecture of the reference is refused any more."""
    assert set(tconfigs.PORTED_ARCH_IDS) == set(jconfigs().ARCH_IDS)
    for arch, alias in (("whisper_large_v3", "whisper-large-v3"), ("phi3_vision_4p2b", "phi-3-vision-4.2b")):
        for cfg, jcfg in ((tconfigs.get_config(alias), jconfigs().get_config(arch)),
                          (tconfigs.reduced(tconfigs.get_config(arch)),
                           jconfigs().reduced(jconfigs().get_config(arch)))):
            got, want = config_fields(cfg, jcfg)
            assert got == want


# ---------------------------------------------------------------------------
# the token pipeline's frontend stream (src/repro/data/tokens.py:43-68)
# ---------------------------------------------------------------------------


def test_element_spec_matches():
    """tests/test_launch.py::TestPipeline::test_element_spec_matches on the
    port: every batch leaf has its spec's shape and dtype."""
    p = TokenPipeline(batch=2, seq=8, vocab=100, frontend_len=4, frontend_dim=8, device=CPU)
    spec = p.element_spec()
    batch = next(iter(p))
    assert spec.keys() == batch.keys() and "frontend_embeds" in spec
    for k, (shape, dtype) in spec.items():
        assert tuple(batch[k].shape) == shape and batch[k].dtype == dtype
    assert "frontend_embeds" not in TokenPipeline(2, 8, 100, device=CPU).element_spec()


def test_injected_draws_give_the_reference_frontends():
    """The reference pipeline's frontend draws injected as ``frontend=``
    give its ``frontend_embeds``, batch for batch, beside the port's own
    token stream (``stream_tokens``); the default frontend stream is a
    fixed draw per (stream, draw) at the reference's scale."""
    from repro.data.tokens import TokenPipeline as JPipeline

    it = iter(JPipeline(batch=2, seq=8, vocab=100, seed=3, frontend_len=4, frontend_dim=8))
    want = [next(it)["frontend_embeds"] for _ in range(3)]
    pipe = TokenPipeline(2, 8, 100, seed=3, device=CPU, frontend_len=4, frontend_dim=8,
                         frontend=lambda s, d: t(want[d]))
    for d, (w, got) in enumerate(zip(want, pipe)):
        assert got["frontend_embeds"].dtype == torch.float32
        np.testing.assert_array_equal(got["frontend_embeds"].numpy(), np.asarray(w))
        assert torch.equal(got["tokens"], stream_tokens(3, d, (2, 8), 100, CPU))
    a = stream_frontend(3, 0, (2, 4, 8), CPU)
    assert torch.equal(a, next(iter(TokenPipeline(2, 8, 100, seed=3, device=CPU, frontend_len=4,
                                                  frontend_dim=8)))["frontend_embeds"])
    assert not torch.equal(a, stream_frontend(3, 1, (2, 4, 8), CPU))
    assert a.dtype == torch.float32 and 0.01 < float(a.std()) < 0.03


def test_frontend_specs_present():
    """tests/test_launch.py::TestInputSpecs::test_frontend_specs_present."""
    spec = steps.batch_specs(tconfigs.get_config("whisper-large-v3"), "train_4k")
    assert tuple(spec["frontend_embeds"].shape) == (256, 1500, 128)
    assert spec["frontend_embeds"].device.type == "meta"


# ---------------------------------------------------------------------------
# serving: the static cross K/V, per-request frontends
# ---------------------------------------------------------------------------


def test_rebuffer_caches_bit_identical_to_reference(family):
    """From the reference's own prefill caches: the port's rebuffer
    equals the reference's bit for bit, the cross K/V copied whole."""
    from repro.launch import serving as jserving

    _, jcfg, cfg, jp, _ = family
    jb, _ = _batches(cfg, _tokens(cfg, 2, 8, seed=9), _frontends(cfg, 2, seed=10))
    _, jpre = jax.jit(lambda p, x: jmodel().prefill(p, jcfg, x))(jp, jb)
    enc_len = cfg.frontend_len if cfg.is_encdec() else 0
    want = jserving.rebuffer_caches(jcfg, jpre, 2, 20, 8, enc_len)
    got = rebuffer_caches(cfg, to_port(jpre), 2, 20, 8, enc_len)
    assert_bits_equal(got, to_port(want))
    if cfg.is_encdec():
        assert torch.equal(got[0][0][2], to_port(jpre)[0][0][2])


def test_insert_row_is_the_reference_update(family):
    """Random full buffers and a random batch-1 block shaped as a 5-token
    prefill's caches: the row's self-attention K/V a prefix, its cross
    K/V the whole row (reference ``_insert_row``, eager)."""
    from repro.launch import serving as jserving

    _, jcfg, cfg, jp, _ = family
    rng = np.random.default_rng(11)
    enc_len = cfg.frontend_len if cfg.is_encdec() else 0
    full = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                  jmodel().init_cache(jcfg, 3, 12, enc_len=enc_len))
    one = {"tokens": jnp.zeros((1, 5), jnp.int32),
           "frontend_embeds": jnp.zeros((1, cfg.frontend_len, cfg.frontend_dim), jnp.float32)}
    pre_shapes = jax.eval_shape(lambda p: jmodel().prefill(p, jcfg, one)[1], jp)
    pre = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), pre_shapes)
    want = jserving._insert_row(full, pre, jnp.asarray(2, jnp.int32))
    tfull = convert.lm_params_from_numpy(full, CPU)
    ptrs = [a.data_ptr() for a in tree_leaves(tfull)]
    got = _insert_row(tfull, convert.lm_params_from_numpy(pre, CPU), 2)
    assert [a.data_ptr() for a in tree_leaves(got)] == ptrs  # written in place
    assert_bits_equal(got, to_port(want))


def test_server_run_matches_reference(family):
    """Continuous admission of 7 staggered requests over 3 slots, each with
    its own frontend (one without: zeros), and one snapshot adopted at
    decode step 3, on the port's server and on the reference's: tokens,
    versions and every counting metric equal; the port's signatures after
    warmup are prefill 2, decode 1, insert 1 and stay so."""
    from repro.launch import serving as jserving

    _, jcfg, cfg, jp, tp = family
    kw = dict(slots=3, prompt_len=8, max_new=9, seed=3)
    jsrv = jserving.ContinuousServer(jcfg, jserving.ServingConfig(**kw), jp)
    srv = ContinuousServer(cfg, ServingConfig(**kw), tree_map(torch.clone, tp), device=CPU)
    jsrv.warmup()
    srv.warmup()
    assert srv.compile_counts() == {"prefill": 2, "decode": 1, "insert": 1}
    snap = jmodel().init_params(jcfg, jax.random.PRNGKey(1))
    ps, fes = _tokens(cfg, 7, 8, seed=12), list(_frontends(cfg, 7, seed=13))
    fes[4] = None
    out = []
    for server, slot_cls, req_cls, conv in ((jsrv, jserving.AdoptionSlot, jserving.Request, lambda p: p),
                                            (srv, AdoptionSlot, Request, to_port)):
        slot = slot_cls()

        def hook(_, step, slot=slot, conv=conv):
            if step == 3:
                slot.publish(conv(snap), cert=0.5, round=step)

        reqs = [req_cls(rid=i, prompt=ps[i], max_new=2 + (i * 3) % 8, frontend=fes[i]) for i in range(7)]
        out.append(server.run(reqs, slot=slot, step_hook=hook))
    (jres, jm), (res, m) = out
    assert [r.rid for r in res] == [r.rid for r in jres] == list(range(7))
    for r, jr in zip(res, jres):
        np.testing.assert_array_equal(r.tokens, jr.tokens)
        assert r.versions == jr.versions
    assert {k: m[k] for k in COUNTING} == {k: jm[k] for k in COUNTING}
    assert m["adoptions"] == 1 and m["recompiles"] == 0 and m["dropped_requests"] == 0
    assert len({r.versions for r in res}) > 1


def test_serve_matches_reference(family):
    """``serve()`` with the reference's params, prompts and frontend draws
    handed in (``src/repro/launch/serve.py:58-80``)."""
    from repro.launch import serve as jserve

    _, jcfg, cfg, _, _ = family
    want = jserve.serve(jcfg, 2, 8, 5)
    key = jax.random.PRNGKey(0)
    jprompts = jax.random.randint(jax.random.fold_in(key, 1), (2, 8), 0, jcfg.vocab, jnp.int32)
    jfe = jax.random.normal(jax.random.fold_in(key, 2), (2, jcfg.frontend_len, jcfg.frontend_dim)) * 0.02
    got = serve(cfg, 2, 8, 5, params=to_port(jmodel().init_params(jcfg, key)), prompts=np.asarray(jprompts),
                frontends=np.asarray(jfe), device=CPU)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert {k: got["metrics"][k] for k in COUNTING} == {k: want["metrics"][k] for k in COUNTING}


def test_frontend_changes_the_first_logits(family):
    """Two requests with the same prompt and different frontends get
    different prefill logits (the splice and the encoder are live), and a
    request's tokens beside other requests equal its tokens alone."""
    _, _, cfg, _, tp = family
    prompt, fe = _tokens(cfg, 1, 20, seed=14), _frontends(cfg, 2, seed=15)
    with torch.no_grad():
        a, _ = tmodel.prefill(tp, cfg, {"tokens": t(np.repeat(prompt, 2, 0)), "frontend_embeds": t(fe)})
    assert not torch.allclose(a[0], a[1], rtol=0, atol=1e-4)
    srv = ContinuousServer(cfg, ServingConfig(slots=2, prompt_len=20, max_new=6), tp, device=CPU)
    alone, _ = srv.run([Request(rid=0, prompt=prompt[0], max_new=6, frontend=fe[0])])
    pair, _ = srv.run([Request(rid=0, prompt=prompt[0], max_new=6, frontend=fe[0]),
                       Request(rid=1, prompt=prompt[0], max_new=6, frontend=fe[1])])
    np.testing.assert_array_equal(alone[0].tokens, pair[0].tokens)
