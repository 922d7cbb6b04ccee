"""DeepSeek-V3's block on the port's normal training path, held on the CPU
against the plain reference ``tests/plain/deepseek_v3.py`` (plain
PyTorch, float32, the published block written out: MLA in its expanded
form, the router as a loop over the held experts; a byte-for-byte copy
of the benchmark's ``bench/reference/moonlight_l5.py``), on seeded
weights at a small size (d 64, 4 heads, E 16 with k 4, 4 held):

  * the sigmoid router: the chosen sets exactly, the weights and the
    sequence-wise balance loss at 1e-6 (float32 products of other shapes
    round differently: 1 ulp at these magnitudes);
  * the MoE layer drop-free over one chip's share: its output and every
    gradient at 1e-5 of their scale (the reference sums each token's
    experts in another order); the 8 shares' parts, with the shared
    experts counted once, add up to the uncut layer; on a skewed batch
    the capacity dispatch drops choices and the drop-free one computes
    them all;
  * the whole model's loss at 1e-6 and gradients at 1e-5 of each leaf's
    scale; three AdamW steps with bfloat16 moments and the bias rule: the
    bias exactly, the parameters to three steps of a bfloat16 moment
    rounded the other way;
  * the bias leaf gets no moments and no decay; the engine equals the
    oracle bit for bit on a tiny sigmoid-routed MLA model; the new
    fields' defaults give today's routing and dispatch.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from plain import deepseek_v3 as ref  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import sgd_worker as tsgd  # noqa: E402
from repro_torch.core import tmsn_sgd as ttmsn  # noqa: E402
from repro_torch.models import init_params, loss_fn, moe, state_step_, trained  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_updates_, init_opt_state  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

CPU = "cpu"
ARCH = dict(name="tiny-dsv3", arch_type="moe", num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
            d_ff=128, moe_d_ff=32, vocab=256, attention="mla", q_lora_rank=0, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, num_experts=16, num_experts_per_tok=4,
            num_shared_experts=2, first_k_dense=1, router_score="sigmoid", routed_scaling_factor=2.446,
            router_bias_rate=0.001, router_aux_coef=0.01, moe_dispatch="dropless", experts_held=4,
            experts_offset=0, rope_theta=50000.0, norm_eps=1e-5, param_dtype="float32",
            compute_dtype="float32", remat=False)
CFG = ArchConfig(**ARCH)
B, S = 2, 16


def _names(tree) -> dict:
    return {".".join(str(k) for k in path): a for path, a in tree_leaves_with_path(tree)}


def _params(cfg=CFG, seed=0, bias_scale=0.05):
    """The program's initial parameters, with a random selection bias so
    that the bias takes part in the choice."""
    p = init_params(cfg, seed, device=CPU)
    g = torch.Generator().manual_seed(seed + 1)
    for name, a in _names(p).items():
        if name.endswith("router_bias"):
            a.copy_((torch.rand(a.shape, generator=g) - 0.5) * 2 * bias_scale)
    return p


def _tokens(seed=3, b=B, s=S):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, ARCH["vocab"], (b, s), generator=g)
    return {"tokens": tok, "labels": tok.roll(-1, 1), "mask": torch.ones(b, s)}


def _layer(p, r=0):
    """MoE layer ``r``'s leaves, unstacked: the program's dict and the
    reference's by name."""
    lp = tree_map(lambda a: a[r], p["decoder"][1][0]["moe"])
    return lp, {k: v for k, v in _names(lp).items()}


def _x(seed=4, b=B, s=S):
    return torch.randn((b, s, ARCH["d_model"]), generator=torch.Generator().manual_seed(seed))


def _close(got, want, rel):
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= rel * max(scale, 1e-30), (gap, scale)


def test_plain_reference_is_the_benchmarks_copy():
    here = Path(__file__).resolve().parent
    assert (here / "plain" / "deepseek_v3.py").read_bytes() == \
        (here.parent / "bench" / "reference" / "moonlight_l5.py").read_bytes()


def test_defaults_keep_the_reference_router_and_dispatch():
    cfg = ArchConfig(name="d", arch_type="moe", num_layers=2, d_model=8, num_heads=2, num_kv_heads=2, d_ff=16,
                     vocab=10, num_experts=4, num_experts_per_tok=2)
    assert (cfg.router_score, cfg.routed_scaling_factor, cfg.router_bias_rate, cfg.moe_dispatch,
            cfg.experts_held, cfg.experts_offset, cfg.n_held()) == ("softmax", 1.0, 0.0, "capacity", 0, 0, 4)
    assert "router_bias" not in init_params(cfg, 0, device="meta")["decoder"][0][0]["moe"]


def test_router_matches_the_reference():
    p = _params()
    lp, _ = _layer(p)
    x = _x().reshape(B * S, -1)
    topw, topi, aux, load = moe.router(lp, x, B, CFG)
    bal = 0.0
    for j in range(B):
        w, c, _ = ref.router(x[j * S:(j + 1) * S], lp["router"], lp["router_bias"], ARCH)
        assert torch.equal(torch.sort(topi[j * S:(j + 1) * S], -1).values, torch.sort(c, -1).values)
        _close(topw[j * S:(j + 1) * S], w, 1e-6)
        bal = bal + ref.moe(x[j * S:(j + 1) * S], _layer(p)[1], ARCH)[1]
    _close(aux, bal / B, 1e-6)
    assert torch.equal(load, torch.bincount(topi.reshape(-1), minlength=16))
    # the bias only chooses: the weights are the unbiased scores
    assert not torch.equal(topi, moe.route(torch.sigmoid(x @ lp["router"]), 4)[1])


def _layer_grads(cfg, lp, x, cot):
    leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), lp)
    xx = x.clone().requires_grad_(True)
    out, aux, _ = moe.moe_layer(leaves, xx, cfg)
    ((out * cot).sum() + aux).backward()
    return out.detach(), aux.detach(), xx.grad, {k: v.grad for k, v in _names(leaves).items()}


def _ref_layer_grads(arch, w, x, cot):
    leaves = {k: v.detach().clone().requires_grad_(not k.endswith("router_bias")) for k, v in w.items()}
    xx = x.clone().requires_grad_(True)
    outs, bal = [], 0.0
    for j in range(x.shape[0]):
        o, b, _, _ = ref.moe(xx[j], leaves, arch)
        outs.append(o)
        bal = bal + b / x.shape[0]
    out = torch.stack(outs)
    ((out * cot).sum() + bal).backward()
    return out.detach(), bal.detach(), xx.grad, {k: v.grad for k, v in leaves.items() if v.requires_grad}


def test_layer_output_and_gradients_match_the_reference():
    p = _params()
    lp, w = _layer(p)
    x, cot = _x(), _x(9)
    out, aux, gx, grads = _layer_grads(CFG, lp, x, cot)
    rout, rbal, rgx, rgrads = _ref_layer_grads(ARCH, w, x, cot)
    _close(out, rout, 1e-5)
    _close(aux, rbal, 1e-6)
    _close(gx, rgx, 1e-5)
    assert grads["router_bias"] is None and set(rgrads) == set(grads) - {"router_bias"}
    for k in rgrads:
        _close(grads[k], rgrads[k], 1e-5)


def test_eight_shares_add_up_to_the_uncut_layer():
    """Shares at offsets 0, E/8, ...: each computes its 2 experts' part;
    the shared experts and the balance loss, which every share computes
    alike, count once."""
    full = dataclasses.replace(CFG, experts_held=0)
    p = _params(full)
    lp, w = _layer(p)
    x = _x()
    want, want_bal, _, _ = _ref_layer_grads({**ARCH, "experts_held": 16}, w, x, torch.zeros_like(x))
    shared = moe.apply_mlp(lp["shared"], x.reshape(B * S, -1)).reshape(x.shape)
    total, bals = shared.clone(), []
    for i in range(8):
        cfg = dataclasses.replace(CFG, experts_held=2, experts_offset=2 * i)
        part = {**lp, **{k: lp[k][2 * i:2 * i + 2] for k in ("gate", "up", "down")}}
        out, bal, _ = moe.moe_layer(part, x, cfg)
        total = total + (out - shared)
        bals.append(bal)
    _close(total, want, 1e-5)
    assert all(torch.equal(b, bals[0]) for b in bals)
    _close(bals[0], want_bal, 1e-6)


def test_drop_free_computes_every_choice_where_capacity_drops():
    """A bias that sends every token to expert 1 on top of its others: the
    capacity dispatch (1.25 x the mean choices an expert) drops most of
    expert 1's choices, the drop-free one computes all of them."""
    full = dataclasses.replace(CFG, experts_held=0)
    p = _params(full, bias_scale=0.0)
    lp, w = _layer(p)
    lp["router_bias"][1] = 10.0
    w["router_bias"] = lp["router_bias"]
    x = _x()
    xt = x.reshape(B * S, -1)
    _, topi, _, _ = moe.router(lp, xt, B, full)
    assert bool((topi == 1).any(-1).all())
    cap = moe.moe_capacity(full, B * S)
    assert cap < B * S
    want = _ref_layer_grads({**ARCH, "experts_held": 16}, w, x, torch.zeros_like(x))[0]
    out, _, (load, offs) = moe.moe_layer(lp, x, full)
    _close(out, want, 1e-5)
    rows = torch.diff(offs[:16].long(), prepend=torch.zeros(1, dtype=torch.long))
    assert torch.equal(rows, load) and int(rows[1]) == B * S
    capped, _, _ = moe.moe_layer(lp, x, dataclasses.replace(full, moe_dispatch="capacity"))
    assert float((capped - want).abs().max()) > 1e-2 * float(want.abs().max())


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
    assert torch.equal(metrics["expert_load"], loads)
    for k, v in wts.items():
        if v.requires_grad:
            _close(named[k].grad, v.grad, 1e-5)


def test_three_steps_bias_exactly_and_parameters_close():
    """AdamW with bfloat16 moments and the bias rule, three steps on the
    program's path (loss, backward, ``apply_updates_``, ``state_step_``)
    and the reference's learner: the bias bit for bit; the parameters to
    3 lr 2^-7, three steps of a bfloat16 moment rounded the other way
    (their gradients differ in the last float32 bits). AdamW at eps 1e-4:
    at 1e-8, g / (|g| + eps) turns a rounding difference in a gradient
    near zero (an expert few tokens chose) into a whole step of lr."""
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
    assert biases and all(torch.equal(v, learner.wts[k]) for k, v in biases.items())
    assert any(bool((v != learner.wts[k].new_zeros(())).any()) for k, v in biases.items())
    for k, v in got.items():
        assert float((v - learner.wts[k]).abs().max()) <= 3 * opt.lr * 2 ** -7, k


def test_bias_gets_no_moments_and_no_decay():
    from repro_torch import trace

    opt = AdamWConfig(lr=1.0, weight_decay=0.5)
    p = _params()
    state = init_opt_state(p, opt, trained=trained)
    mu = _names(state["mu"])
    n_trained = sum(1 for k in _names(p) if not k.endswith("router_bias"))
    assert len(mu) == n_trained and not any(k.endswith("router_bias") for k in mu)
    before = {k: v.clone() for k, v in _names(p).items()}
    out = tree_map(torch.empty_like, (p, state))
    grads = tree_map(torch.ones_like, p)
    trace.disable()
    trace.collect()
    trace.enable()
    try:
        apply_updates_(p, grads, state, opt, out=out)
        apply_updates_(p, grads, state, opt)
        counts = trace.collect()["counters"]
    finally:
        trace.disable()
    for tree in (out[0], p):
        for k, v in _names(tree).items():
            assert torch.equal(v, before[k]) == k.endswith("router_bias"), k
    assert counts["adamw_leaves"] == {"plain": 2 * n_trained}


def test_engine_equals_oracle_on_a_sigmoid_routed_mla_model():
    """TMSN-SGD through ``lm_sgd_worker`` (AdamW on the trained leaves,
    the bias set after each step): the engine and the oracle bit for bit,
    and the bias moved and was adopted with the weights."""
    cfg = dataclasses.replace(CFG, remat=True, router_bias_rate=0.01)

    def worker():
        return tsgd.lm_sgd_worker(cfg, AdamWConfig(lr=1e-2), ttmsn.TMSNSGDConfig(local_steps=2, ema=0.8),
                                  batch_size=2, seq=8, device=CPU)

    w, rounds = 3, 3
    want = ttmsn.oracle_run(worker(), w, rounds, eps=0.0, seed=0)
    ecfg = teng.EngineConfig(n_workers=w, max_rounds=rounds, eps=0.0, delay_rounds=1, seed=0, fault_spec="",
                             rounds_per_dispatch=1, gossip_mode="dense", spare_slots=0, publish_every_k=0,
                             control_plane="dense", inflight_capacity=0, round_step_impl="pallas")
    res = teng.TMSNEngine(worker(), ecfg, device=CPU).run()
    np.testing.assert_array_equal(np.asarray(res.final_certificates, np.float32), want.certs)
    assert res.rounds == rounds and res.messages_accepted > 0
    bias = res.final_models[0]["decoder"][1][0]["moe"]["router_bias"]
    assert bool((bias != 0).any())
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(res.final_models[0]))
