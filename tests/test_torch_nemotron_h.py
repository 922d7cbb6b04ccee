"""Nemotron-H's hybrid block (Nemotron 3 Nano) on the port's normal
training path, held on the CPU against the plain reference
``tests/plain/nemotron_h.py`` (plain PyTorch, float32, the published
block written out: Mamba-2 as the paper's chunked SSD checked against the
step-by-step recurrence, the router and a loop over the held relu^2
experts, GQA without positions; a byte-for-byte copy of the benchmark's
``bench/reference/nemotron3nano_l7.py``), on seeded weights at a small
size (d 64; Mamba-2 8 heads of 16 in 4 groups, state 16, chunk 8; E 16
with k 4, 4 held; 4 query heads over 2 KV heads of 16; the published
7-block pattern ``MEMEM*E``):

  * the port's grouped chunked scan against its own step-by-step
    recurrence (``ssd_reference``) and the reference's chunked form
    against the reference's recurrence, at 1e-5 of the output's scale
    (float32 sums over a chunk in another order);
  * the Mamba-2 mixer (grouped conv channels, the grouped gated norm) and
    the relu^2 MoE layer, outputs and every gradient, at 1e-5 of their
    scale (the reference sums in other orders); a gated norm over the
    whole of d_inner is far from it;
  * the 4 shares' parts, with the shared expert counted once, add up to
    the uncut layer;
  * the whole stack's loss at 1e-6 and gradients at 1e-5 of each leaf's
    scale; three AdamW steps with bfloat16 moments and the bias rule: the
    bias exactly, the parameters to three steps of a bfloat16 moment
    rounded the other way;
  * prefill, then decode through the caches (SSD state and conv tail with
    groups, GQA K/V, nothing for an MoE block), against the full
    forward's logits at 1e-5 of their scale;
  * the engine equals the oracle bit for bit on the hybrid model; the new
    fields at their defaults give Mamba2's and Zamba2's bits.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plain import nemotron_h as ref  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import sgd_worker as tsgd  # noqa: E402
from repro_torch.core import tmsn_sgd as ttmsn  # noqa: E402
from repro_torch.models import init_params, loss_fn, moe, ssm, state_step_, trained  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.config import ArchConfig, layer_segments  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_updates_, init_opt_state  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

CPU = "cpu"
ARCH = dict(name="tiny-nemotron-h", arch_type="hybrid", num_layers=7, layer_pattern="MEMEM*E", d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, moe_d_ff=32, vocab=256, rope=False,
            norm_eps=1e-5, mlp_gated=False, ssm_state=16, ssm_head_dim=16, ssm_heads=8, ssm_groups=4,
            ssm_conv_width=4, ssm_chunk=8, num_experts=16, num_experts_per_tok=4,
            num_shared_experts=2, expert_act="relu2", router_score="sigmoid", routed_scaling_factor=2.5,
            router_bias_rate=0.001, router_aux_coef=0.01, moe_dispatch="dropless", experts_held=4,
            experts_offset=0, param_dtype="float32", compute_dtype="float32", remat=False)
CFG = ArchConfig(**ARCH)
B, S = 2, 32


def _names(tree) -> dict:
    return {".".join(str(k) for k in path): a for path, a in tree_leaves_with_path(tree)}


def _params(cfg=CFG, seed=0):
    """The program's initial parameters, with every leaf the initialisation
    sets to a constant drawn at random (the selection bias, the SSM's
    decay, time step, skip and conv bias, the norms), so that each takes
    part in the comparison."""
    p = init_params(cfg, seed, device=CPU)
    g = torch.Generator().manual_seed(seed + 1)
    for name, a in _names(p).items():
        leaf = name.rsplit(".", 1)[-1]
        u = torch.rand(a.shape, generator=g)
        if leaf == "router_bias":
            a.copy_((u - 0.5) * 0.1)
        elif leaf == "a_log":
            a.copy_(torch.log(1.0 + 15.0 * u))
        elif leaf == "dt_bias":
            a.copy_(torch.log(torch.expm1(0.001 + 0.2 * u)))
        elif leaf in ("D", "conv_b") or "norm" in leaf or leaf.startswith("ln"):
            a.copy_(u - 0.5)
    return p


def _tokens(seed=3, b=B, s=S):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, ARCH["vocab"], (b, s), generator=g)
    return {"tokens": tok, "labels": tok.roll(-1, 1), "mask": torch.ones(b, s)}


def _x(seed=4, b=B, s=S):
    return torch.randn((b, s, ARCH["d_model"]), generator=torch.Generator().manual_seed(seed))


def _close(got, want, rel):
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= rel * max(scale, 1e-30), (gap, scale)


def _group(p, seg: int, group: str) -> tuple[dict, dict]:
    """Segment ``seg``'s (one layer) ``group`` leaves, unstacked: the
    program's dict and the reference's by name."""
    lp = tree_map(lambda a: a[0], p["decoder"][seg][0][group])
    return lp, _names(lp)


def test_plain_reference_is_the_benchmarks_copy():
    here = Path(__file__).resolve().parent
    assert (here / "plain" / "nemotron_h.py").read_bytes() == \
        (here.parent / "bench" / "reference" / "nemotron3nano_l7.py").read_bytes()


def test_pattern_builds_single_mixer_blocks_one_layer_a_segment():
    segs = layer_segments(CFG)
    assert [len(u) * r for u, r in segs] == [1] * 7
    assert "".join({"ssm": "M", "moe": "E", "attn": "*"}[u[0].kind] for u, _ in segs) == "MEMEM*E"
    p = init_params(CFG, 0, device="meta")
    assert [sorted(seg[0]) for seg in p["decoder"]] == [["ln1", "ssm"], ["ln1", "moe"]] * 2 + [
        ["ln1", "ssm"], ["attn", "ln1"], ["ln1", "moe"]]
    assert "gate" not in p["decoder"][1][0]["moe"] and "gate" not in p["decoder"][1][0]["moe"]["shared"]
    assert p["decoder"][0][0]["ssm"]["in_proj"].shape == (1, 64, 2 * 128 + 2 * 4 * 16 + 8)
    assert "shared_attn" not in p


def _ssd_inputs(seed=5, s=S):
    g = torch.Generator().manual_seed(seed)
    H, P, N, G = 8, 16, 16, 4
    xs = torch.randn((B, s, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, s, H), generator=g) - 1.0)
    Bm, Cm = torch.randn((B, s, G, N), generator=g), torch.randn((B, s, G, N), generator=g)
    params = {"a_log": torch.log(1.0 + 15.0 * torch.rand(H, generator=g)), "D": torch.rand(H, generator=g)}
    return xs, dt, Bm, Cm, params


def test_grouped_chunked_scan_is_the_recurrence():
    xs, dt, Bm, Cm, params = _ssd_inputs()
    y, state = ssm.ssd_scan(xs, dt, Bm, Cm, params, 8)
    A = -torch.exp(params["a_log"])
    for j in range(B):
        Bh, Ch = (t[j].repeat_interleave(2, dim=1) for t in (Bm, Cm))  # head h reads group h // 2
        want = ref.ssd_recurrent(xs[j], dt[j], A, Bh, Ch, params["D"])
        _close(y[j], want, 1e-5)
        _close(ref.ssd_chunked(xs[j], dt[j], A, Bh, Ch, params["D"], 8), want, 1e-5)
        # the final state, which prefill hands to decode
        S_t = torch.zeros((8, 16, 16))
        for t in range(S):
            upd = (dt[j, t, :, None] * Bh[t])[:, :, None] * xs[j, t][:, None]
            S_t = torch.exp(dt[j, t] * A)[:, None, None] * S_t + upd
        _close(state[j], S_t, 1e-5)


def test_port_ssd_full_is_its_decode_recurrence():
    p = _params()
    lp, _ = _group(p, 0, "ssm")
    x = _x()
    out, (state, tail) = ssm.ssd_full(lp, x, CFG)
    _close(out, ssm.ssd_reference(lp, x, CFG), 1e-5)
    assert tail.shape == (B, 3, ssm.conv_channels(CFG)) == (B, 3, 128 + 2 * 4 * 16)


def _grads(fn, leaves: dict, x, cot):
    ls = tree_map(lambda a: a.detach().clone().requires_grad_(True), leaves)
    xx = x.clone().requires_grad_(True)
    out = fn(ls, xx)
    (out * cot).sum().backward()
    return out.detach(), xx.grad, {k: v.grad for k, v in _names(ls).items()}


def test_mamba2_mixer_and_gradients_match_the_reference(monkeypatch):
    p = _params()
    lp, w = _group(p, 0, "ssm")
    x, cot = _x(), _x(9)
    out, gx, grads = _grads(lambda ls, xx: ssm.ssd_full(ls, xx, CFG)[0], lp, x, cot)
    rout, rgx, rgrads = _grads(lambda ls, xx: torch.stack([ref.mamba2(xx[j], ls, ARCH) for j in range(B)]),
                               w, x, cot)
    _close(out, rout, 1e-5)
    _close(gx, rgx, 1e-5)
    for k in rgrads:
        _close(grads[k], rgrads[k], 1e-5)
    # the norm over its 4 groups, not over all of d_inner
    norm = ssm._gated_norm
    monkeypatch.setattr(ssm, "_gated_norm",
                        lambda y, z, scale, cfg: norm(y, z, scale, dataclasses.replace(cfg, ssm_groups=1)))
    whole = ssm.ssd_full(lp, x, CFG)[0]
    assert float((whole - rout).abs().max()) > 1e-2 * float(rout.abs().max())


def test_relu2_moe_layer_and_gradients_match_the_reference():
    p = _params()
    lp, w = _group(p, 1, "moe")
    x, cot = _x(), _x(9)
    leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), lp)
    xx = x.clone().requires_grad_(True)
    out, aux, _ = moe.moe_layer(leaves, xx, CFG)
    ((out * cot).sum() + aux).backward()
    rl = {k: v.detach().clone().requires_grad_(not k.endswith("router_bias")) for k, v in w.items()}
    rx = x.clone().requires_grad_(True)
    outs, bal = [], 0.0
    for j in range(B):
        o, b, _, _ = ref.moe(rx[j], rl, ARCH)
        outs.append(o)
        bal = bal + b / B
    rout = torch.stack(outs)
    ((rout * cot).sum() + bal).backward()
    _close(out.detach(), rout.detach(), 1e-5)
    _close(aux.detach(), bal.detach(), 1e-6)
    _close(xx.grad, rx.grad, 1e-5)
    named = _names(leaves)
    assert named["router_bias"].grad is None
    for k, v in rl.items():
        if v.requires_grad:
            _close(named[k].grad, v.grad, 1e-5)


def test_four_shares_add_up_to_the_uncut_layer():
    """Shares at offsets 0, 4, 8, 12: each computes its 4 experts' part;
    the shared expert and the balance loss, which every share computes
    alike, count once."""
    full = dataclasses.replace(CFG, experts_held=0)
    p = _params(full)
    lp, w = _group(p, 1, "moe")
    x = _x()
    want = torch.stack([ref.moe(x[j], w, {**ARCH, "experts_held": 16})[0] for j in range(B)])
    shared = moe.apply_mlp(lp["shared"], x.reshape(B * S, -1), "relu2").reshape(x.shape)
    total, bals = shared.clone(), []
    for i in range(4):
        cfg = dataclasses.replace(CFG, experts_held=4, experts_offset=4 * i)
        part = {**lp, **{k: lp[k][4 * i:4 * i + 4] for k in ("up", "down")}}
        out, bal, _ = moe.moe_layer(part, x, cfg)
        total = total + (out - shared)
        bals.append(bal)
    _close(total, want, 1e-5)
    assert all(torch.equal(b, bals[0]) for b in bals)


def test_model_loss_and_gradients_match_the_reference():
    p = _params()
    batch = _tokens()
    leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), p)
    loss, metrics = loss_fn(leaves, CFG, batch)
    loss.backward()
    named = _names(leaves)
    wts = {k: v.detach().clone().requires_grad_(ref.trained(k)) for k, v in named.items()}
    value, loads = 0.0, 0
    for j in range(B):
        lj, ld, _ = ref.sequence_loss(wts, ARCH, batch["tokens"][j], batch["labels"][j])
        value = value + lj / B
        loads = loads + ld
    value.backward()
    _close(loss.detach(), value.detach(), 1e-6)
    assert torch.equal(metrics["expert_load"], loads) and loads.shape == (3, 16)
    for k, v in wts.items():
        if v.requires_grad:
            _close(named[k].grad, v.grad, 1e-5)


def test_three_steps_bias_exactly_and_parameters_close():
    """AdamW with bfloat16 moments and the bias rule, three steps on the
    program's path (loss, backward, ``apply_updates_``, ``state_step_``)
    and the reference's learner: the bias bit for bit; the parameters to
    3 lr 2^-7, three steps of a bfloat16 moment rounded the other way.
    AdamW at eps 1e-4: at 1e-8, g / (|g| + eps) turns a rounding
    difference in a gradient near zero into a whole step of lr."""
    opt = AdamWConfig(lr=1e-3, eps=1e-4, state_dtype="bfloat16")
    cfg = dataclasses.replace(CFG, router_bias_rate=0.01)
    p = _params(cfg)
    state = init_opt_state(p, opt, trained=trained)
    learner = ref.Learner({k: v.clone() for k, v in _names(p).items()}, {**ARCH, "router_bias_rate": 0.01},
                          dataclasses.asdict(opt))
    for step in range(3):
        batch = _tokens(seed=10 + step)
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), p)
        loss, aux = loss_fn(leaves, cfg, batch)
        loss.backward()
        grads = tree_map(lambda a: a.grad, leaves)
        with torch.no_grad():
            apply_updates_(p, grads, state, opt)
            state_step_(p, cfg, aux)
        learner.step(batch, update=True)
    got = _names(p)
    biases = {k: v for k, v in got.items() if k.endswith("router_bias")}
    assert len(biases) == 3 and all(torch.equal(v, learner.wts[k]) for k, v in biases.items())
    for k, v in got.items():
        assert float((v - learner.wts[k]).abs().max()) <= 3 * opt.lr * 2 ** -7, k


def test_prefill_then_decode_matches_the_full_forward():
    """A 16-token prompt, then 8 tokens decoded one at a time through the
    caches, teacher-forced: each step's logits against the full forward's
    at that position."""
    from repro_torch.launch.serving import rebuffer_caches

    p = _params()
    tok = _tokens(s=24)["tokens"]
    with torch.no_grad():
        x, _, _ = tmodel.forward_stack(p["decoder"], layer_segments(CFG), CFG, tmodel._embed(p, CFG, tok),
                                       tmodel._positions(tok))
        full = tmodel._logits(p, CFG, x)
        last, caches = tmodel.prefill(p, CFG, {"tokens": tok[:, :16]})
        _close(last[:, 0], full[:, 15], 1e-5)
        assert [len(e) for seg in caches for e in seg] == [2, 0, 2, 0, 2, 2, 0]
        caches = rebuffer_caches(CFG, caches, B, 24, 16, 0)
        for i in range(16, 24):
            logits, caches = tmodel.decode_step(p, CFG, tok[:, i:i + 1], caches, i)
            _close(logits[:, 0], full[:, i], 1e-5)


def test_engine_equals_oracle_on_the_hybrid_model():
    """TMSN-SGD through ``lm_sgd_worker`` (remat, AdamW on the trained
    leaves, the bias set after each step): the engine and the oracle bit
    for bit, and the bias moved and was adopted with the weights."""
    cfg = dataclasses.replace(CFG, remat=True, router_bias_rate=0.01)

    def worker():
        return tsgd.lm_sgd_worker(cfg, AdamWConfig(lr=1e-2), ttmsn.TMSNSGDConfig(local_steps=2, ema=0.8),
                                  batch_size=2, seq=16, device=CPU)

    w, rounds = 3, 3
    want = ttmsn.oracle_run(worker(), w, rounds, eps=0.0, seed=0)
    ecfg = teng.EngineConfig(n_workers=w, max_rounds=rounds, eps=0.0, delay_rounds=1, seed=0, fault_spec="",
                             rounds_per_dispatch=1, gossip_mode="dense", spare_slots=0, publish_every_k=0,
                             control_plane="dense", inflight_capacity=0, round_step_impl="pallas")
    res = teng.TMSNEngine(worker(), ecfg, device=CPU).run()
    np.testing.assert_array_equal(np.asarray(res.final_certificates, np.float32), want.certs)
    assert res.rounds == rounds and res.messages_accepted > 0
    assert bool((res.final_models[0]["decoder"][1][0]["moe"]["router_bias"] != 0).any())
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(res.final_models[0]))


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_1p2b"])
def test_new_fields_at_their_defaults_keep_the_bits(arch):
    """The reduced Mamba2 and Zamba2 with the new fields spelled out at
    the values their defaults stand for (heads from expand x d_model, one
    group of B and C, one norm group, SwiGLU experts, RoPE, Mamba2's stack
    as a pattern of "M"s): the same tree, loss, gradients and decode, bit
    for bit."""
    from repro_torch import configs
    from repro_torch.launch.serving import rebuffer_caches

    base = dataclasses.replace(configs.reduced(configs.get_config(arch)), remat=True)
    d_inner = base.ssm_expand * base.d_model
    spelled = dataclasses.replace(base, ssm_heads=d_inner // base.ssm_head_dim, ssm_groups=1,
                                  expert_act="swiglu", rope=True,
                                  layer_pattern="M" * base.num_layers if arch == "mamba2_1p3b" else "")
    assert layer_segments(spelled) == layer_segments(base)
    runs = []
    for cfg in (base, spelled):
        p = init_params(cfg, 0, device=CPU)
        batch = _tokens(s=64)
        batch["tokens"] = batch["tokens"] % cfg.vocab
        leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), p)
        loss, _ = loss_fn(leaves, cfg, batch)
        loss.backward()
        with torch.no_grad():
            logits, caches = tmodel.prefill(p, cfg, {"tokens": batch["tokens"][:, :32]})
            caches = rebuffer_caches(cfg, caches, B, 40, 32, 0)
            step, _ = tmodel.decode_step(p, cfg, batch["tokens"][:, 32:33], caches, 32)
        runs.append([loss.detach(), logits, step] + [a.grad for a in tree_leaves(leaves)])
    assert len(runs[0]) == len(runs[1]) and all(torch.equal(a, b) for a, b in zip(*runs))
