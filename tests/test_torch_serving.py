"""The port's serving tier (``repro_torch.launch.steps``, ``.serving``,
``.serve``) held against the JAX package's (``repro.launch``) on the CPU.

The reference's parameters are converted leaf for leaf
(``repro_torch.convert.lm_params_from_numpy``), its prompts handed in,
and, for sampling, its Gumbel draws injected: ``jax.random.categorical``
is ``argmax(gumbel(key) + logits / T)``, and its server folds the decode
step into its key, so the port's server gets
``noise(i) = jax.random.gumbel(fold_in(PRNGKey(seed), i), (slots, vocab))``.
Tokens, request versions, adoption steps and every counting metric must
be equal; logits, caches and parameters agree at tests/test_torch_models.py's
tolerances (``close_stack``: float32 dot products round differently in
MKL and XLA's Eigen). Rebuffering from the same prefill caches, the
in-place decode against the out-of-place one, row independence and the
bf16 publisher and conversion are held bit for bit. Configs: the
reference's serving ``_TINY`` (tests/test_serving.py), ``reduced(yi_9b)``,
and ``reduced()`` of mamba2_1p3b (SSD state and conv tails) and
deepseek_v3_671b (MLA latents, MoE), float32. Prefill row independence is
asserted on the dense ``_TINY`` only: an MoE's capacity couples a
prefill's rows, as in the reference.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import serving as jserving  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import init_opt_state as jinit_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.engine import EngineConfig, TMSNEngine  # noqa: E402
from repro_torch.core.sgd_worker import lm_sgd_worker  # noqa: E402
from repro_torch.core.tmsn_sgd import TMSNSGDConfig  # noqa: E402
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
from repro_torch.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_serving import _TINY  # noqa: E402
from test_torch_models import close_stack, config_fields  # noqa: E402
from test_torch_sgd import leaf_pairs  # noqa: E402

CPU = "cpu"
GRAD = dict(rtol=1e-4, atol=1e-5)

#: name -> the reference's config (float32)
ARCHS = {"tiny": _TINY, "yi_9b": jconfigs.reduced(jconfigs.get_config("yi_9b")),
         "mamba2_1p3b": jconfigs.reduced(jconfigs.get_config("mamba2_1p3b")),
         "deepseek_v3_671b": jconfigs.reduced(jconfigs.get_config("deepseek_v3_671b"))}


def port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_params(jparams):
    return convert.lm_params_from_numpy(np_tree(jparams), CPU)


def prompts(cfg, n, prompt_len=8, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (n, prompt_len)).astype(np.int32)


def ref_noise(seed, slots, vocab):
    """The reference server's Gumbel draw at decode step ``i``."""
    return lambda i: torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.fold_in(jax.random.PRNGKey(seed), i), (slots, vocab), jnp.float32)))


def t_batch(tokens):
    toks = torch.from_numpy(np.array(tokens, np.int32))
    return {"tokens": toks, "labels": toks, "mask": torch.ones(toks.shape, dtype=torch.float32)}


def j_batch(tokens):
    toks = jnp.asarray(tokens, jnp.int32)
    return {"tokens": toks, "labels": toks, "mask": jnp.ones(toks.shape, jnp.float32)}


def assert_bits_equal(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32 if g.element_size() == 4 else torch.int16),
                           w.view(torch.int32 if w.element_size() == 4 else torch.int16))


def _arch(name):
    """(name, reference cfg, port cfg, reference params, port params)."""
    jcfg = ARCHS[name]
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    return name, jcfg, port_cfg(jcfg), jp, port_params(jp)


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    return _arch(request.param)


@pytest.fixture(scope="module", params=["tiny", "yi_9b"])
def dense_arch(request):
    """The dense configs only: an AdamW step's sign check needs almost
    every gradient clear of the tolerance, which a reduced SSM's or MoE's
    are not (tests/test_torch_families.py holds their step)."""
    return _arch(request.param)


# ---------------------------------------------------------------------------
# cache re-buffering and the row insert
# ---------------------------------------------------------------------------


class TestRebufferCaches:
    def test_bit_identical_to_reference_and_numpy_and_decode(self, arch):
        """From the reference's own prefill caches: the port's rebuffer
        equals the reference's and a plain numpy prefix write bit for
        bit, and the decode trajectories from the two caches agree."""
        _, jcfg, cfg, jp, tp = arch
        batch, prompt_len, max_len = 2, 8, 16
        _, jpre = jax.jit(jsteps.make_prefill_step(jcfg))(jp, j_batch(prompts(cfg, batch)))
        want = jserving.rebuffer_caches(jcfg, jpre, batch, max_len, prompt_len, 0)
        pre = convert.lm_params_from_numpy(np_tree(jpre), CPU)
        got = rebuffer_caches(cfg, pre, batch, max_len, prompt_len, 0)
        assert_bits_equal(got, convert.lm_params_from_numpy(np_tree(want), CPU))
        for g, p in zip(tree_leaves(got), tree_leaves(np_tree(jpre))):
            # K/V and MLA latents: the prompt prefix; SSD state and conv tail: whole
            arr = np.zeros(tuple(g.shape), np.float32)
            arr[(slice(None), slice(None)) + tuple(slice(0, n) for n in p.shape[2:])] = p
            np.testing.assert_array_equal(g.numpy(), arr)
        # decode from the rebuffered caches, and from the numpy ones
        step = steps.make_serve_step(cfg)
        numpy_c = tree_map(lambda a: a.clone(), got)
        tok = torch.from_numpy(prompts(cfg, batch, 1, seed=3))
        tg, tw = tok, tok
        for i in range(4):
            tg, got = step(tp, tg, got, prompt_len + i)
            tw, numpy_c = step(tp, tw, numpy_c, prompt_len + i)
            assert torch.equal(tg, tw)

    def test_insert_row_is_the_reference_update(self, arch):
        """Random full buffers and a random batch-1 block shaped as a
        5-token prefill's caches (K/V and latents a prefix, SSD state and
        conv tail a whole row)."""
        _, jcfg, cfg, jp, _ = arch
        rng = np.random.default_rng(1)
        full = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                      jinit_cache(jcfg, 3, 12))
        one = {"tokens": jnp.zeros((1, 5), jnp.int32)}
        pre_shapes = jax.eval_shape(lambda p: jprefill(p, jcfg, one)[1], jp)
        pre = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), pre_shapes)
        # eager: a jit of the function would share the reference servers' cache counts
        want = jserving._insert_row(full, pre, jnp.asarray(2, jnp.int32))
        tfull = convert.lm_params_from_numpy(full, CPU)
        ptrs = [a.data_ptr() for a in tree_leaves(tfull)]
        got = _insert_row(tfull, convert.lm_params_from_numpy(pre, CPU), 2)
        assert [a.data_ptr() for a in tree_leaves(got)] == ptrs  # written in place
        assert_bits_equal(got, convert.lm_params_from_numpy(np_tree(want), CPU))


# ---------------------------------------------------------------------------
# the step factories and the input specs (src/repro/launch/steps.py)
# ---------------------------------------------------------------------------


class TestSteps:
    def test_prefill_step(self, arch):
        _, jcfg, cfg, jp, tp = arch
        toks = prompts(cfg, 2, 12, seed=5)
        jtok, jcaches = jax.jit(jsteps.make_prefill_step(jcfg))(jp, j_batch(toks))
        tok, caches = steps.make_prefill_step(cfg)(tp, t_batch(toks))
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        for (g, w) in zip(tree_leaves(caches), jax.tree.leaves(jcaches)):
            close_stack(g, w)
        jlogits, _ = jprefill(jp, jcfg, j_batch(toks))
        logits, _ = prefill(tp, cfg, t_batch(toks))
        close_stack(logits, jlogits)

    def _prefilled(self, jcfg, cfg, jp, b, prompt_len, max_len):
        toks = prompts(cfg, b, prompt_len, seed=6)
        jtok, jpre = jax.jit(jsteps.make_prefill_step(jcfg))(jp, j_batch(toks))
        jc = jserving.rebuffer_caches(jcfg, jpre, b, max_len, prompt_len, 0)
        return jtok, jc, torch.from_numpy(np.array(jtok)), convert.lm_params_from_numpy(np_tree(jc), CPU)

    def test_serve_step_scalar_pos(self, arch):
        _, jcfg, cfg, jp, tp = arch
        jtok, jc, tok, tc = self._prefilled(jcfg, cfg, jp, 2, 8, 16)
        jstep, step = jax.jit(jsteps.make_serve_step(jcfg)), steps.make_serve_step(cfg)
        for i in range(5):
            jtok, jc = jstep(jp, jtok, jc, jnp.asarray(8 + i, jnp.int32))
            tok, tc = step(tp, tok, tc, 8 + i)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        for g, w in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            close_stack(g, w)

    @pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
    def test_decode_step_per_row_pos(self, arch, greedy):
        """Rows at their own depths; sampling at T = 4 with the
        reference's Gumbel draws injected."""
        _, jcfg, cfg, jp, tp = arch
        jtok, jc, tok, tc = self._prefilled(jcfg, cfg, jp, 3, 8, 20)
        jstep = jax.jit(jsteps.make_decode_step(jcfg, greedy=greedy, temperature=4.0))
        step = steps.make_decode_step(cfg, greedy=greedy, temperature=4.0)
        pos = np.array([8, 10, 9], np.int32)
        for i in range(5):
            key = jax.random.fold_in(jax.random.PRNGKey(11), i)
            jtok, jc = jstep(jp, jtok, jc, jnp.asarray(pos), key)
            gumbel = None if greedy else torch.from_numpy(np.array(
                jax.random.gumbel(key, (3, cfg.padded_vocab()), jnp.float32)))
            tok, tc = step(tp, tok, tc, torch.from_numpy(pos), gumbel)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            pos = pos + 1
        for g, w in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            close_stack(g, w)

    def test_sampling_is_the_reference_categorical(self):
        """``argmax(gumbel(key) + l / T)`` picks what
        ``jax.random.categorical(key, l / T)`` picks, draw for draw."""
        logits = np.random.default_rng(2).normal(size=(64, 40)).astype(np.float32)
        for i in range(8):
            key = jax.random.PRNGKey(i)
            want = np.asarray(jax.random.categorical(key, jnp.asarray(logits) / 2.0, axis=-1))
            g = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape, jnp.float32)))
            got = torch.argmax(g + torch.from_numpy(logits) / 2.0, dim=-1)
            np.testing.assert_array_equal(got.numpy(), want)

    def test_train_step(self, dense_arch):
        _, jcfg, cfg, jp, tp = dense_arch
        toks = prompts(cfg, 2, 12, seed=7)
        jopt, opt = JAdamW(lr=1e-3), AdamWConfig(lr=1e-3)
        jb = dict(j_batch(toks), labels=jnp.asarray(np.roll(toks, -1, 1)))
        tb = dict(t_batch(toks), labels=torch.from_numpy(np.roll(toks, -1, 1)))
        jnew, jstate, jm = jax.jit(jsteps.make_train_step(jcfg, jopt))(jp, jinit_opt(jp, jopt), jb)
        new, state, m = steps.make_train_step(cfg, opt)(tp, init_opt_state(tp, opt), tb)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5)
        for g, w in leaf_pairs(state["mu"], jstate["mu"]):  # (1 - b1) * grad
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)
        # AdamW's first step moves a weight by about lr * sign(grad): where
        # the grad is within the grads' tolerance of zero (atol 1e-5) the
        # two packages may step either way; every other weight agrees
        for (g, w), (mu, _) in zip(leaf_pairs(new, jnew), leaf_pairs(jstate["mu"], jstate["mu"])):
            assert not g.requires_grad
            mu = np.asarray(mu)
            firm = (np.abs(mu) > (1 - jopt.b1) * GRAD["atol"]) | (mu == 0)  # 0: unused embedding rows
            assert firm.mean() > 0.99
            np.testing.assert_allclose(g.numpy()[firm], np.asarray(w)[firm], **GRAD)
        assert int(state["step"]) == int(jstate["step"]) == 1

    @pytest.mark.parametrize("shape", list(jsteps.INPUT_SHAPES))
    def test_specs_and_configs_match_reference(self, shape):
        """Meta tensors against the reference's ShapeDtypeStructs at
        Yi-9B's FULL config (nothing allocated)."""
        jcfg = jconfigs.get_config("yi_9b")
        cfg = port_cfg(jcfg)
        assert steps.INPUT_SHAPES == jsteps.INPUT_SHAPES
        assert steps.shape_applicable(cfg, shape) == jsteps.shape_applicable(jcfg, shape)
        want, got = jsteps.batch_specs(jcfg, shape), steps.batch_specs(cfg, shape)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape and str(got[k].dtype)[6:] == str(want[k].dtype)
        if jsteps.INPUT_SHAPES[shape][2] == "decode":
            jd, d = jsteps.decode_specs(jcfg, shape), steps.decode_specs(cfg, shape)
            assert jd.keys() == d.keys()
            for k in jd:
                for g, w in zip(tree_leaves(d[k]), jax.tree.leaves(jd[k])):
                    assert g.device.type == "meta"
                    assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
        got, want = config_fields(steps.dryrun_cfg(cfg), jsteps.dryrun_cfg(jcfg))
        assert got == want
        assert dataclasses.asdict(steps.opt_config_for(cfg)) == dataclasses.asdict(jsteps.opt_config_for(jcfg))


# ---------------------------------------------------------------------------
# in-place decode (the counterpart of the reference's donated caches)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "per_row_pos"])
def test_in_place_decode_equals_out_of_place(arch, per_row):
    _, _, cfg, _, tp = arch
    toks = prompts(cfg, 3, 8, seed=8)
    _, pre = prefill(tp, cfg, t_batch(toks))
    a = rebuffer_caches(cfg, pre, 3, 16, 8, 0)
    b = tree_map(lambda x: x.clone(), a)
    ptrs = [x.data_ptr() for x in tree_leaves(b)]
    tok = torch.from_numpy(toks[:, -1:])
    for i in range(6):
        pos = torch.full((3,), 8 + i, dtype=torch.int32) if per_row else 8 + i
        la, a = decode_step(tp, cfg, tok, a, pos)
        lb, b = decode_step(tp, cfg, tok, b, pos, in_place=True)
        assert torch.equal(la.view(torch.int32), lb.view(torch.int32))
        tok = la[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    assert [x.data_ptr() for x in tree_leaves(b)] == ptrs  # no cache was copied
    assert_bits_equal(b, a)


# ---------------------------------------------------------------------------
# the continuous server against the reference's
# ---------------------------------------------------------------------------


def _both_servers(jcfg, jp, tp, scfg_kw):
    jscfg = jserving.ServingConfig(**scfg_kw)
    scfg = ServingConfig(**scfg_kw)
    noise = None if scfg.greedy else ref_noise(scfg.seed, scfg.slots, port_cfg(jcfg).padded_vocab())
    return (jserving.ContinuousServer(jcfg, jscfg, jp),
            # a copy: the server adopts into the tensors it is given
            ContinuousServer(port_cfg(jcfg), scfg, tree_map(torch.clone, tp), device=CPU, noise=noise))


COUNTING = ("requests_completed", "dropped_requests", "decode_steps", "decode_tokens", "adoptions",
            "adoption_steps", "recompiles")


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_server_run_matches_reference(arch, greedy):
    """Continuous admission of 7 staggered requests over 3 slots and two
    snapshots adopted mid-stream (published from the step hook at steps
    2 and 5, the reference's params converted)."""
    _, jcfg, cfg, jp, tp = arch
    kw = dict(slots=3, prompt_len=8, max_new=10, greedy=greedy, temperature=4.0, seed=3)
    jsrv, srv = _both_servers(jcfg, jp, tp, kw)
    assert jsrv.warmup() > 0 and srv.warmup() > 0
    # the reference's insert count is its process's: every server jits
    # the one module-level _insert_row, so an earlier arch's entry shows
    assert srv.compile_counts() == {"prefill": 2, "decode": 1, "insert": 1}
    assert {k: jsrv.compile_counts()[k] for k in ("prefill", "decode")} == {"prefill": 2, "decode": 1}
    snaps = {2: jinit(jcfg, jax.random.PRNGKey(1)), 5: jinit(jcfg, jax.random.PRNGKey(2))}
    ps = prompts(cfg, 7, 8, seed=4)
    out = []
    for server, slot_cls, req_cls, conv in ((jsrv, jserving.AdoptionSlot, jserving.Request, lambda p: p),
                                            (srv, AdoptionSlot, Request, port_params)):
        slot = slot_cls()

        def hook(_, step, slot=slot, conv=conv):
            if step in snaps:
                slot.publish(conv(snaps[step]), cert=1.0 / step)

        out.append(server.run([req_cls(rid=i, prompt=ps[i], max_new=2 + (i * 3) % 9) for i in range(7)],
                              slot=slot, step_hook=hook))
    (jres, jm), (res, m) = out
    assert [r.rid for r in res] == [r.rid for r in jres] == list(range(7))
    for r, jr in zip(res, jres):
        np.testing.assert_array_equal(r.tokens, jr.tokens)
        assert r.tokens.dtype == np.int32 and r.versions == jr.versions
    assert {k: m[k] for k in COUNTING} == {k: jm[k] for k in COUNTING}
    assert m["adoptions"] == 2 and m["recompiles"] == 0 and m["dropped_requests"] == 0
    assert set(m) == set(jm)


@pytest.mark.parametrize("name", list(ARCHS))
def test_serve_matches_reference(name):
    """``serve()`` with the reference's params and prompts handed in."""
    jcfg = ARCHS[name]
    want = jserve.serve(jcfg, 2, 8, 6)
    key = jax.random.PRNGKey(0)
    jp = jinit(jcfg, key)
    jprompts = jax.random.randint(jax.random.fold_in(key, 1), (2, 8), 0, jcfg.vocab, jnp.int32)
    got = serve(port_cfg(jcfg), 2, 8, 6, params=port_params(jp), prompts=np.asarray(jprompts), device=CPU)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["adoptions"] == want["adoptions"] == 0
    assert {k: got["metrics"][k] for k in COUNTING} == {k: want["metrics"][k] for k in COUNTING}


# ---------------------------------------------------------------------------
# the loop's mechanics (tests/test_serving.py, on the port)
# ---------------------------------------------------------------------------

TINY = port_cfg(_TINY)


def _server(slots=2, max_new=6, params_seed=0, **kw):
    scfg = ServingConfig(slots=slots, prompt_len=8, max_new=max_new, seed=0, **kw)
    return ContinuousServer(TINY, scfg, init_params(TINY, params_seed, CPU), device=CPU)


def _reqs(n, max_new=6, seed=0):
    p = prompts(TINY, n, 8, seed)
    return [Request(rid=i, prompt=p[i], max_new=max_new) for i in range(n)]


class TestServeBitIdentity:
    """With no publisher, serve() generates EXACTLY the tokens of the
    legacy loop: batched prefill + rebuffer + scalar-``pos`` serve step."""

    @pytest.mark.parametrize("name", list(ARCHS))
    def test_no_publish_serve_matches_legacy(self, name):
        cfg = port_cfg(ARCHS[name])
        batch, prompt_len, gen = 2, 8, 6
        params = init_params(cfg, 0, CPU)
        toks = prompts(cfg, batch, prompt_len, seed=9)
        tok, pre = steps.make_prefill_step(cfg)(params, t_batch(toks))
        caches = rebuffer_caches(cfg, pre, batch, prompt_len + gen, prompt_len, 0)
        step, want = steps.make_serve_step(cfg), [tok]
        for i in range(gen - 1):
            tok, caches = step(params, tok, caches, prompt_len + i)
            want.append(tok)
        out = serve(cfg, batch, prompt_len, gen, params=params, prompts=toks, device=CPU)
        np.testing.assert_array_equal(out["generated"], torch.cat(want, 1).numpy())
        assert out["adoptions"] == 0 and out["metrics"]["dropped_requests"] == 0


class TestContinuousServer:
    def test_request_validation(self):
        server = _server()
        with pytest.raises(ValueError, match="max_new"):
            server.run([Request(rid=0, prompt=np.zeros(8, np.int32), max_new=99)])
        with pytest.raises(ValueError, match="prompt"):
            server.run([Request(rid=0, prompt=np.zeros(5, np.int32), max_new=2)])

    @pytest.mark.parametrize("kw, match", [
        (dict(slots=0), "slots"), (dict(prompt_len=0), "prompt_len"), (dict(max_new=0), "max_new"),
        (dict(adopt_every=0), "adopt_every"), (dict(greedy=False, temperature=0.0), "temperature"),
    ])
    def test_config_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            ServingConfig(**{**dict(slots=1, prompt_len=4, max_new=4), **kw})
        with pytest.raises(ValueError, match="temperature"):
            steps.make_decode_step(TINY, greedy=False, temperature=-1.0)

    def test_no_recompiles_after_warmup(self):
        """The signature-count pin: continuous admission (7 staggered
        requests over 2 slots) plus mid-run adoption adds ZERO new
        signatures after warmup()."""
        server = _server()
        assert server.run(_reqs(1))[1]["recompiles"] is None  # not warmed: nothing to compare
        server.warmup()
        counts = server.compile_counts()
        assert counts == {"prefill": 2, "decode": 1, "insert": 1}
        slot = AdoptionSlot()
        slot.publish(init_params(TINY, 1, CPU), cert=0.5)
        reqs = [Request(rid=i, prompt=p, max_new=2 + (i % 5)) for i, p in enumerate(prompts(TINY, 7, 8))]
        results, m = server.run(reqs, slot=slot)
        assert m["recompiles"] == 0 and server.compile_counts() == counts
        assert m["dropped_requests"] == 0 and len(results) == 7

    def test_adoption_is_a_data_swap(self):
        """Same layout: the snapshot's values are copied into the
        server's own tensors (no pointer changes, the snapshot is left
        alone); another dtype replaces them and counts a new signature."""
        server = _server()
        server.warmup()
        ptrs = [a.data_ptr() for a in tree_leaves(server.params)]
        snap = init_params(TINY, 1, CPU)
        kept = tree_map(torch.clone, snap)
        slot = AdoptionSlot()
        slot.publish(snap, cert=0.5)
        assert server.adopt(slot) and not server.adopt(slot)
        assert [a.data_ptr() for a in tree_leaves(server.params)] == ptrs
        assert_bits_equal(server.params, kept)
        assert_bits_equal(snap, kept)
        slot.publish(tree_map(lambda a: a.to(torch.bfloat16), snap), cert=0.25)
        _, m = server.run(_reqs(3), slot=slot)
        assert m["adoptions"] == 2 and m["recompiles"] >= 1
        assert tree_leaves(server.params)[0].dtype == torch.bfloat16

    def test_adoption_mid_stream(self):
        """Two snapshots published mid-run are both adopted; requests
        spanning an adoption record multiple versions; nothing drops;
        tokens change when the model changes."""
        server = _server(slots=2, max_new=10)
        server.warmup()
        slot = AdoptionSlot()
        snaps = {2: (init_params(TINY, 1, CPU), 1.0), 5: (init_params(TINY, 2, CPU), 0.5)}

        def hook(srv, step):
            if step in snaps:
                params, cert = snaps[step]
                slot.publish(params, cert=cert)

        results, m = server.run(_reqs(4, max_new=10), slot=slot, step_hook=hook)
        assert m["adoptions"] == 2 and m["dropped_requests"] == 0 and m["recompiles"] == 0
        assert m["adoption_steps"] == [2, 5]
        assert server.adopted_version == 2 and server.served_cert == 0.5
        assert any(r.versions == (0, 1, 2) for r in results)
        static, _ = _server(slots=2, max_new=10).run(_reqs(4, max_new=10))
        assert any(not np.array_equal(a.tokens, b.tokens) for a, b in zip(results, static))

    def test_max_new_one_retires_at_prefill(self):
        results, m = _server().run(_reqs(3, max_new=1))
        assert m["dropped_requests"] == 0 and m["decode_steps"] == 0
        assert all(len(r.tokens) == 1 for r in results)

    def test_results_sorted_and_complete(self):
        results, m = _server(slots=2).run(_reqs(5, max_new=3))
        assert [r.rid for r in results] == list(range(5))
        assert all(len(r.tokens) == 3 for r in results)
        assert m["requests_completed"] == 5

    def test_sampling_differs_from_greedy_and_is_seeded(self):
        a = serve(TINY, 2, 8, 8, greedy=True, device=CPU)
        b = serve(TINY, 2, 8, 8, greedy=False, temperature=4.0, device=CPU)
        c = serve(TINY, 2, 8, 8, greedy=False, temperature=4.0, device=CPU)
        assert not np.array_equal(a["generated"], b["generated"])
        np.testing.assert_array_equal(b["generated"], c["generated"])

    def test_row_independence_and_stale_row_admission(self):
        """A request's tokens do not depend on the other rows' prompts,
        and a request admitted into a retired row (its previous
        occupant's K/V beyond the prefix) decodes as one admitted into a
        row that holds zeros there: bit for bit, at fixed shapes."""
        p, q = prompts(TINY, 5, 8, seed=1), prompts(TINY, 5, 8, seed=2)
        base = [Request(rid=i, prompt=p[i], max_new=10) for i in range(4)]
        other = [Request(rid=0, prompt=p[0], max_new=10)] + [
            Request(rid=i, prompt=q[i], max_new=10) for i in range(1, 4)]
        a, _ = _server(slots=4, max_new=10).run(base)
        b, _ = _server(slots=4, max_new=10).run(other)
        np.testing.assert_array_equal(a[0].tokens, b[0].tokens)
        assert not np.array_equal(a[1].tokens, b[1].tokens)
        # request 4 goes into row 0: after 5 decode steps of request 0
        # (stale entries at 8..12), or at once (request 0 retires at prefill)
        late = Request(rid=4, prompt=p[4], max_new=8)
        stale, _ = _server(slots=4, max_new=10).run(
            [Request(rid=0, prompt=p[0], max_new=6)] + base[1:] + [late])
        fresh, _ = _server(slots=4, max_new=10).run(
            [Request(rid=0, prompt=p[0], max_new=1)] + base[1:] + [late])
        np.testing.assert_array_equal(stale[4].tokens, fresh[4].tokens)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default resolves")
        params = init_params(TINY, 0, CPU)
        with pytest.raises(RuntimeError, match="cuda"):
            ContinuousServer(TINY, ServingConfig(slots=1, prompt_len=4, max_new=2), params)
        with pytest.raises(RuntimeError, match="cuda"):
            serve(TINY, 1, 4, 2, params=params)


# ---------------------------------------------------------------------------
# the live train -> serve edge (examples/serve_live.py), and the bf16 repairs
# ---------------------------------------------------------------------------


class _RecordingSlot(AdoptionSlot):
    def __init__(self):
        super().__init__()
        self.certs = []

    def publish(self, params, cert, round=0):
        self.certs.append(float(cert))
        return super().publish(params, cert, round)


def test_live_edge_adopts_while_training():
    """TMSN-SGD trains in a thread and publishes every improvement; the
    server, warmed on fresh weights, serves from the same slot while it
    trains: adoptions, no drops, no new signature, and the served
    certificate is one the engine published."""
    slot = _RecordingSlot()
    worker = lm_sgd_worker(TINY, AdamWConfig(lr=1e-2), TMSNSGDConfig(local_steps=2, ema=0.8, width_coef=1.0),
                           batch_size=2, seq=16, device=CPU)
    engine = TMSNEngine(worker, EngineConfig(n_workers=4, eps=0.0, max_rounds=16, seed=0, record_history=False,
                                             publish_every_k=1, rounds_per_dispatch=1), device=CPU)
    engine.attach_publisher(slot)
    server = ContinuousServer(TINY, ServingConfig(slots=4, prompt_len=8, max_new=12, seed=0),
                              init_params(TINY, 7, CPU), device=CPU)
    server.warmup()
    trainer = threading.Thread(target=engine.run, name="tmsn-trainer")
    trainer.start()
    try:
        t0 = time.monotonic()
        while slot.version == 0 and time.monotonic() - t0 < 60:
            time.sleep(0.005)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, TINY.vocab, 8).astype(np.int32), max_new=4 + (i % 9))
                for i in range(24)]
        results, m = server.run(reqs, slot=slot, step_hook=lambda srv, step: time.sleep(0.01))
    finally:
        trainer.join(timeout=120)
    assert not trainer.is_alive()
    assert m["adoptions"] >= 1 and m["dropped_requests"] == 0 and m["recompiles"] == 0
    assert len(results) == 24 and server.served_cert in slot.certs
    assert all(b < a for a, b in zip(slot.certs, slot.certs[1:]))


def test_bf16_publisher_is_bit_for_bit():
    """A bf16 model publishes: the last snapshot is CPU tensors equal,
    as int16 views, to the best worker's params after the same number of
    rounds (a second, deterministic run stopped there)."""
    cfg = dataclasses.replace(TINY, param_dtype="bfloat16")

    def engine(rounds, **kw):
        worker = lm_sgd_worker(cfg, AdamWConfig(lr=1e-2), TMSNSGDConfig(local_steps=2), batch_size=2, seq=8,
                               device=CPU)
        return TMSNEngine(worker, EngineConfig(n_workers=3, eps=0.0, max_rounds=rounds, seed=0,
                                               rounds_per_dispatch=1, **kw), device=CPU)

    slot = AdoptionSlot()
    eng = engine(6, publish_every_k=1)
    eng.attach_publisher(slot)
    eng.run()
    snap = slot.acquire()
    assert snap is not None
    res = engine(snap.round).run()
    best = int(np.argmin(res.final_certificates))
    assert float(np.float32(res.final_certificates[best])) == snap.cert
    for got, want in zip(tree_leaves(snap.params), tree_leaves(res.final_models[best])):
        assert got.device.type == "cpu" and got.dtype == want.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_bf16_reference_params_convert_bit_for_bit():
    jcfg = jsteps.dryrun_cfg(_TINY)
    jp = np_tree(jinit(jcfg, jax.random.PRNGKey(0)))
    tp = convert.lm_params_from_numpy(jp, CPU)
    for g, w in leaf_pairs(tp, jp):
        assert g.dtype == torch.bfloat16 and w.dtype.name == "bfloat16"
        np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
    back = convert.to_numpy(tp)
    for g, w in leaf_pairs(back, jp):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.int16), w.view(np.int16))
