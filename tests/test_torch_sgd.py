"""The port's AdamW, schedule and TMSN-SGD worker (``repro_torch.optim``,
``repro_torch.core.sgd_worker``, ``repro_torch.core.tmsn_sgd``) held
against the JAX package's on the CPU, and the port's engine held to the
port's oracle.

  * ``apply_updates`` against ``repro.optim.apply_updates`` at float32
    and bfloat16 ``state_dtype`` over several steps; ``warmup_cosine``.
  * ``BatchedSGDWorker.scan_round`` and ``adopt_batch`` segment by
    segment against ``repro.core.sgd_worker``: the reference's state
    converted (``convert.sgd_state_from_numpy``), the reference's token
    draws injected (``tokens=``) and its initial parameters (``init=``).
    Certificates at rtol 1e-5; params and moments at rtol 1e-4 and atol
    1e-5; ``fired``, cost, steps and draw counters exact.
  * The port's ``TMSNEngine`` equals the port's ``oracle_run`` bit for bit
    on the dense buffer, the sparse queues and the sparse control plane
    (the invariant of tests/test_worker_contract.py's
    ``test_engine_matches_oracle[sgd]``); the port's oracle history equals
    the reference's ``oracle_run`` history at rtol 1e-5.
  * History monotone; the payload bytes derived from the export.

The worker-contract harness over the SGD worker is in
tests/test_torch_worker_contract.py; its sharded runs in
tests/test_torch_sharded_engine.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sgd_worker as jsgd  # noqa: E402
from repro.core import tmsn_sgd as jtmsn  # noqa: E402
from repro.data.tokens import synthetic_token_batch as jbatch  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import apply_updates as japply  # noqa: E402
from repro.optim import init_opt_state as jinit_opt  # noqa: E402
from repro.optim import warmup_cosine as jcosine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import sgd_worker as tsgd  # noqa: E402
from repro_torch.core import tmsn_sgd as ttmsn  # noqa: E402
from repro_torch.core.worker import payload_bytes_from_export, resolve_payload_bytes  # noqa: E402
from repro_torch.data.tokens import TokenPipeline, stream_tokens  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    apply_updates,
    apply_updates_,
    init_opt_state,
    warmup_cosine,
)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_worker_contract import TINY_ARCH  # noqa: E402

CPU = "cpu"
W = 4
ROUNDS = 8
K, BATCH, SEQ = 2, 2, 8
CERT = dict(rtol=1e-5, atol=0.0)
STATE = dict(rtol=1e-4, atol=1e-5)
PINNED = dict(fault_spec="", rounds_per_dispatch=1, gossip_mode="dense", cross_pod_every_k=1,
              cross_pod_top_k=1, spare_slots=0, publish_every_k=0, publish_eps=0.0, control_plane="dense", inflight_capacity=0,
              round_step_impl="pallas")
TINY = ArchConfig(**dataclasses.asdict(TINY_ARCH))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ref_tokens(seed: int, k_steps: int = K, batch: int = BATCH, seq: int = SEQ, vocab: int = TINY_ARCH.vocab):
    """The reference worker's draws as a port token source: stream ``i+1``
    is ``fold_in(PRNGKey(seed), i+1)``, split once per segment drawn; a
    segment's K batches come from the split of its sub-key."""

    def tokens(stream: int, draw: int) -> torch.Tensor:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
        for _ in range(draw):
            key, _ = jax.random.split(key)
        _, sub = jax.random.split(key)
        toks = jax.vmap(lambda k: jbatch(k, batch, seq, vocab)["tokens"])(jax.random.split(sub, k_steps))
        return torch.from_numpy(np.array(toks))

    return tokens


def ref_init(cfg):
    return lambda seed: convert.lm_params_from_numpy(np_tree(jinit(cfg, jax.random.PRNGKey(seed))), CPU)


def jax_worker(local_steps=K, ema=0.8, width_coef=1.0):
    """tests/test_worker_contract.py's ``_sgd_worker``."""
    return jsgd.lm_sgd_worker(TINY_ARCH, JAdamW(lr=1e-2), jtmsn.TMSNSGDConfig(
        local_steps=local_steps, ema=ema, width_coef=width_coef), batch_size=BATCH, seq=SEQ)


def port_worker(seed=0, local_steps=K, ema=0.8, width_coef=1.0, reference_draws=True):
    kw = dict(tokens=ref_tokens(seed, local_steps), init=ref_init(TINY_ARCH)) if reference_draws else {}
    return tsgd.lm_sgd_worker(TINY, AdamWConfig(lr=1e-2), ttmsn.TMSNSGDConfig(
        local_steps=local_steps, ema=ema, width_coef=width_coef), batch_size=BATCH, seq=SEQ, device=CPU, **kw)


def _engine_cfg(**kw):
    return teng.EngineConfig(**{**PINNED, "n_workers": W, "eps": 0.0, "max_rounds": ROUNDS, "delay_rounds": 1,
                                "seed": 0, **kw})


def leaf_pairs(got, want):
    """(port leaf, reference leaf) by tree path: the reference's dicts
    flatten in sorted key order, the port's in insertion order."""
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        yield g, w


def close_tree(got, want, tol):
    for g, w in leaf_pairs(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


# ---------------------------------------------------------------------------
# AdamW and the schedule (src/repro/optim)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(state_dtype):
    """Five steps from the same params and grads; weight decay on every
    leaf (a norm scale included), int32 step, bf16 moments rounded on
    every write."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "norm": rng.normal(size=(5,)).astype(np.float32),
              "stack": [{"b": rng.normal(size=(2, 3)).astype(np.float32)}]}
    jcfg, tcfg = JAdamW(lr=3e-3, state_dtype=state_dtype), AdamWConfig(lr=3e-3, state_dtype=state_dtype)
    jp, jo = params, jinit_opt(params, jcfg)
    tp = convert.lm_params_from_numpy(params, CPU)
    to = init_opt_state(tp, tcfg)
    assert to["step"].dtype == torch.int32 and to["mu"]["w"].dtype == getattr(torch, state_dtype)
    for i in range(5):
        grads = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        lr = None if i < 3 else 1e-3
        jp, jo = japply(jp, grads, jo, jcfg, lr=lr)
        tp, to = apply_updates(tp, convert.lm_params_from_numpy(grads, CPU), to, tcfg, lr=lr)
        close_tree(tp, jp, STATE)
        close_tree(to["mu"], jo["mu"], STATE)
        close_tree(to["nu"], jo["nu"], STATE)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        assert to["mu"]["w"].dtype == getattr(torch, state_dtype)
    if state_dtype == "bfloat16":  # the moments are bf16 values, bit for bit as the reference rounds them
        np.testing.assert_array_equal(to["nu"]["w"].float().numpy(), np.asarray(jo["nu"]["w"], np.float32))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("into", ["in_place", "out"])
def test_in_place_step_is_the_functional_step(state_dtype, into):
    """``apply_updates_`` (what the worker runs: the first step of a
    segment into the new state's rows, the rest in place) writes the bits
    ``apply_updates`` returns, step for step."""
    rng = np.random.default_rng(1)
    cfg = AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    params = {"a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
              "b": [{"c": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))}]}
    fp, fo = params, init_opt_state(params, cfg)
    ip, io = tree_map(torch.clone, params), init_opt_state(params, cfg)
    for _ in range(4):
        grads = tree_map(lambda a: torch.from_numpy(rng.normal(size=tuple(a.shape)).astype(np.float32)),
                         params)
        fp, fo = apply_updates(fp, grads, fo, cfg)
        if into == "out":
            src = tree_map(torch.clone, (ip, io))
            before = tree_map(torch.clone, src)
            apply_updates_(src[0], grads, src[1], cfg, out=(ip, io))
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(src), tree_leaves(before)))  # read only
        else:
            apply_updates_(ip, grads, io, cfg)
        for a, b in zip(tree_leaves((fp, fo)), tree_leaves((ip, io))):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_warmup_cosine_matches_reference():
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = warmup_cosine(step, 3e-4, warmup=10, total=100)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jcosine(step, 3e-4, 10, 100)), rtol=1e-6)
    assert float(warmup_cosine(torch.tensor(200), 1.0, 10, 100, floor=0.25)) == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# the worker, segment by segment (src/repro/core/sgd_worker.py)
# ---------------------------------------------------------------------------


def test_state_conversion_maps_keys_to_streams():
    jw = jax_worker()
    state = jw.init_batch(W, seed=0)
    state, _, _ = jw.scan_round(state, jnp.asarray([True, False, True, True]))
    got = convert.sgd_state_from_numpy(np_tree(state), K, CPU)
    assert got.stream.tolist() == [1, 2, 3, 4]
    assert got.draws.tolist() == [1, 0, 1, 1]
    assert got.opt["step"].dtype == torch.int32 and got.opt["step"].tolist() == [2, 0, 2, 2]
    back = convert.to_numpy(got)
    np.testing.assert_array_equal(back.cert, np.asarray(state.cert))
    np.testing.assert_array_equal(back.params["embed"], np.asarray(state.params["embed"]))
    # the token source the tests inject gives the reference worker's draws
    toks = ref_tokens(0)(3, 1)
    assert toks.shape == (K, BATCH, SEQ) and toks.dtype == torch.int32


def test_init_batch_matches_reference():
    jstate = jax_worker().init_batch(W, seed=0)
    tstate = port_worker().init_batch(W, seed=0)
    for g, w in leaf_pairs(tstate.params, jstate.params):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not any(a.any() for a in tree_leaves(tstate.opt))
    assert torch.isinf(tstate.cert).all() and torch.isinf(tstate.est).all()
    assert tstate.stream.tolist() == [1, 2, 3, 4] and tstate.draws.tolist() == [0] * W


def test_scan_and_adopt_match_reference_segment_by_segment():
    """Each segment starts both packages from the reference's state (the
    port's a conversion of it); masks and adoptions drawn at random."""
    jw, tw = jax_worker(), port_worker()
    rng = np.random.default_rng(3)
    jstate = jw.init_batch(W, seed=0)
    fired_any = adopted = 0
    for seg in range(6):
        mask = rng.random(W) < 0.75
        tstate = convert.sgd_state_from_numpy(np_tree(jstate), K, CPU)
        jnew, jcost, jfired = jw.scan_round(jstate, jnp.asarray(mask))
        tnew, tcost, tfired = tw.scan_round(tstate, torch.as_tensor(mask))
        np.testing.assert_allclose(tnew.cert.numpy(), np.asarray(jnew.cert), **CERT)
        np.testing.assert_allclose(tnew.est.numpy(), np.asarray(jnew.est), **CERT)
        close_tree(tnew.params, jnew.params, STATE)
        close_tree(tnew.opt["mu"], jnew.opt["mu"], STATE)
        close_tree(tnew.opt["nu"], jnew.opt["nu"], STATE)
        np.testing.assert_array_equal(tnew.opt["step"].numpy(), np.asarray(jnew.opt["step"]))
        np.testing.assert_array_equal(tfired.numpy(), np.asarray(jfired))
        np.testing.assert_array_equal(tcost.numpy(), np.asarray(jcost))
        np.testing.assert_array_equal(tnew.draws.numpy(), np.asarray(jnew.opt["step"]) // K)
        # masked-out rows bitwise unchanged, counters included
        off = torch.as_tensor(~mask)
        for a, b in zip(tree_leaves(tnew), tree_leaves(tstate)):
            assert torch.equal(a[off], b[off])
        fired_any += int(tfired.sum())
        # an accept-gated adoption from a random donor permutation
        donors = rng.permutation(W)
        certs = np.asarray(jnew.cert)
        take = (rng.random(W) < 0.6) & (certs[donors] < certs)
        jmodels = jax.tree_util.tree_map(lambda a: a[jnp.asarray(donors)], jnew.params)
        jad, jac = jw.adopt_batch(jnew, jmodels, jnp.asarray(certs[donors]), jnp.asarray(take))
        tsrc = convert.sgd_state_from_numpy(np_tree(jnew), K, CPU)
        tmodels = convert.lm_params_from_numpy(np_tree(jmodels), CPU)
        tad, tac = tw.adopt_batch(tsrc, tmodels, torch.from_numpy(certs[donors]), torch.as_tensor(take))
        for g, w in leaf_pairs(tad.params, jad.params):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(tad.cert.numpy(), np.asarray(jad.cert))
        np.testing.assert_array_equal(tad.est.numpy(), np.asarray(jad.est))
        assert not tac.any() and not np.asarray(jac).any()
        # adoption leaves the optimizer state and the stream alone
        for a, b in zip(tree_leaves((tad.opt, tad.stream, tad.draws)), tree_leaves((tsrc.opt, tsrc.stream,
                                                                                    tsrc.draws))):
            assert torch.equal(a, b)
        adopted += int(take.sum())
        jstate = jad
    assert fired_any > 0 and adopted > 0


def test_population_std_in_the_certificate():
    """The width is the population std (ddof 0) of the K step losses."""
    tw = port_worker(local_steps=3, ema=0.5, width_coef=2.0, reference_draws=False)
    state = tw.init_batch(2, seed=0)
    seen = []
    orig = tw._segment

    def spy(*a):
        out = orig(*a)
        seen.append(out.clone())
        return out

    tw._segment = spy
    new, _, _ = tw.scan_round(state, torch.ones(2, dtype=torch.bool))
    losses = torch.stack(seen)
    want = losses.mean(1) + 2.0 * torch.from_numpy(np.std(losses.numpy(), axis=1)) / np.sqrt(np.float32(3))
    torch.testing.assert_close(new.est, want.to(torch.float32), rtol=1e-6, atol=0.0)
    assert torch.equal(new.cert, new.est)  # the first observation is the estimate


def test_local_steps_validated():
    with pytest.raises(ValueError, match="local_steps"):
        port_worker(local_steps=0, reference_draws=False)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        tsgd.lm_sgd_worker(TINY, AdamWConfig(), ttmsn.TMSNSGDConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        TokenPipeline(2, 8, 64)
    with pytest.raises(RuntimeError, match="cuda"):
        tsgd.BatchedSGDWorker(lambda seed: {}, lambda p, b: (0.0, {}), lambda s, d: {}, AdamWConfig())


def test_token_streams_and_pipeline():
    a = stream_tokens(1, 0, (2, 3, 8), 64, CPU)
    assert torch.equal(a, stream_tokens(1, 0, (2, 3, 8), 64, CPU))
    assert not torch.equal(a, stream_tokens(2, 0, (2, 3, 8), 64, CPU))
    assert not torch.equal(a, stream_tokens(1, 1, (2, 3, 8), 64, CPU))
    assert a.dtype == torch.int32 and int(a.min()) >= 0 and int(a.max()) < 64
    pipe = TokenPipeline(2, 8, 64, seed=5, device=CPU)
    it = iter(pipe)
    b0, b1 = next(it), next(it)
    assert {k: tuple(v.shape) for k, v in b0.items()} == {k: s for k, (s, _) in pipe.element_spec().items()}
    assert {k: v.dtype for k, v in b0.items()} == {k: d for k, (_, d) in pipe.element_spec().items()}
    assert torch.equal(b0["tokens"], stream_tokens(5, 0, (2, 8), 64, CPU))
    assert torch.equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert torch.equal(next(iter(pipe))["tokens"], b0["tokens"])


# ---------------------------------------------------------------------------
# engine == oracle (src/repro/core/tmsn_sgd.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle():
    return ttmsn.oracle_run(port_worker(reference_draws=False), W, ROUNDS, eps=0.0, seed=0)


@pytest.mark.parametrize("kw", [dict(), dict(inflight_capacity=W), dict(inflight_capacity=2),
                                dict(inflight_capacity=W, control_plane="sparse"),
                                dict(inflight_capacity=W, round_step_impl="ref")],
                         ids=["dense", "sparse_queues", "sparse_queues_c2", "sparse_control",
                              "sparse_ref_impl"])
def test_engine_equals_oracle_bit_for_bit(oracle, kw):
    """Uniform speed, delay 1, no failures: the port's engine and the
    port's oracle run the worker's same ops in the same order, so every
    certificate and every round's certificates agree bit for bit."""
    res = teng.TMSNEngine(port_worker(reference_draws=False), _engine_cfg(**kw), device=CPU).run()
    np.testing.assert_array_equal(np.asarray(res.final_certificates, np.float32), oracle.certs)
    hist = np.full((ROUNDS + 1, W), np.nan, np.float32)
    for clock, wid, cert in res.history:  # every round costs each worker K units
        hist[int(round(clock / K)), wid] = cert
    last = hist[0]
    for r in range(1, ROUNDS + 1):  # the history records changes: carry the rest forward
        row = np.where(np.isnan(hist[r]), last, hist[r])
        np.testing.assert_array_equal(row, oracle.history[r - 1])
        last = row
    assert res.rounds == ROUNDS and res.messages_accepted > 0


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "zamba2_1p2b"])
def test_engine_equals_oracle_on_the_families(arch):
    """TMSN-SGD on reduced DeepSeek-V3 (MLA, MoE with its router aux,
    MTP) and Zamba2 (SSD, the shared attention block, whose ``None``
    positions ride through AdamW, the engine's stacked payload and
    adoption): the port's engine equals the port's oracle bit for bit,
    and some model was adopted."""
    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config(arch))

    def worker():
        return tsgd.lm_sgd_worker(cfg, AdamWConfig(lr=1e-2), ttmsn.TMSNSGDConfig(local_steps=K, ema=0.8,
                                  width_coef=1.0), batch_size=BATCH, seq=SEQ, device=CPU)

    w, rounds = 3, 3
    want = ttmsn.oracle_run(worker(), w, rounds, eps=0.0, seed=0)
    res = teng.TMSNEngine(worker(), _engine_cfg(n_workers=w, max_rounds=rounds), device=CPU).run()
    np.testing.assert_array_equal(np.asarray(res.final_certificates, np.float32), want.certs)
    assert res.rounds == rounds and res.messages_accepted > 0
    models = res.final_models[0]
    if arch == "zamba2_1p2b":
        assert models["decoder"][0][1] is None and "shared_attn" in models
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(models))


def test_oracle_history_matches_reference():
    """The port's oracle against the reference's ``oracle_run`` from the
    same initial parameters and the same draws, at rtol 1e-5."""
    want = jtmsn.oracle_run(jax_worker(), W, ROUNDS, eps=0.0, seed=0)
    got = ttmsn.oracle_run(port_worker(), W, ROUNDS, eps=0.0, seed=0)
    np.testing.assert_allclose(got.history, want.history, **CERT)
    np.testing.assert_allclose(got.certs, want.certs, **CERT)
    assert got.rounds == want.rounds == ROUNDS


def test_oracle_history_monotone_and_learns(oracle):
    assert np.all(np.isfinite(oracle.certs))
    assert np.all(np.diff(oracle.history, axis=0) <= 0.0)
    assert np.min(oracle.certs) < np.max(oracle.history[0])


def test_oracle_target_stops_early():
    full = ttmsn.oracle_run(port_worker(reference_draws=False), W, ROUNDS, seed=0)
    target = float(full.history[ROUNDS // 2].min())
    first = int(np.argmax(full.history.min(axis=1) <= np.float32(target)))
    assert first < ROUNDS - 1
    res = ttmsn.oracle_run(port_worker(reference_draws=False), W, ROUNDS, seed=0, target_certificate=target)
    assert res.rounds == first + 1
    np.testing.assert_array_equal(res.history, full.history[:first + 1])


def test_payload_bytes_derived():
    """No hook on the SGD worker: the engines derive the payload from the
    export — one worker's parameters."""
    tw = port_worker(reference_draws=False)
    assert not hasattr(tw, "payload_bytes")
    derived = resolve_payload_bytes(tw, W, seed=0)
    params = tw.export_models(tw.init_batch(W, seed=0))
    assert derived == payload_bytes_from_export(tw, W) == sum(
        a[0].numel() * a.element_size() for a in tree_leaves(params)) > 0
    res = teng.TMSNEngine(tw, _engine_cfg(max_rounds=2), device=CPU).run()
    assert res.bytes_broadcast == derived * res.messages_sent
