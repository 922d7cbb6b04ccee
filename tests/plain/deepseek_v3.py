"""Plain reference of DeepSeek-V3's block (arXiv:2412.19437 §2, the
published modelling code; here at Moonlight-16B-A3B's widths) and of a
TMSN-SGD worker's first steps on it: the loss, its gradients by
autograd, AdamW with bfloat16 moments and the router's bias rule, in
float32 with TF32 off. Imports no JAX, nothing of ``repro`` or
``repro_torch`` and no kernel; its weights and tokens come from the
benchmark's own draw, as the program's do. ``tests/plain/deepseek_v3.py``
is the same file, for the port's CPU tests.

Weights are a dict by the program's leaf names (``decoder.<segment>.0.
<leaf>``, stacked over the segment's layers): the first
``first_k_dense`` layers are segment 0 (MLA + a SwiGLU MLP), the rest
segment 1 (MLA + the MoE), or segment 0 without dense layers.

The block:

- MLA in its expanded form: ``q = h Wq`` (no q-LoRA), split into a
  no-position part and a RoPE part per head; ``[c_kv, k_rope] = h
  W_kv_a``, ``c_kv`` RMS-normed; ``kv_b`` up-projects ``c_kv`` to each
  head's ``k_nope`` and ``v``; ``k_rope`` is one head shared by all;
  causal softmax over ``(q_nope . k_nope + q_rope . k_rope) / sqrt(nope +
  rope)``; ``o Wo``. The program computes the absorbed form (``q_nope``
  through ``kv_b``'s key half into the latent space, the latent read
  out through its value half): the same mathematics.
- The router: ``s = sigmoid(h W_r)``; the choice is the top-k of ``s +
  b`` (the lower index first on ties); the weights are the chosen ``s``
  over their sum (+ 1e-20) times ``routed_scaling_factor``; the
  sequence-wise balance loss ``alpha sum_i f_i P_i`` with ``f_i = E / (k
  T)`` times the sequence's choices of expert i (the chosen set, as the
  published ``seq_aux`` code counts it) and ``P_i`` the mean over the
  sequence of ``s_i / sum_j s_j``; the batch's balance loss is the mean
  over its sequences.
- One chip's share of the experts: only experts ``[experts_offset,
  experts_offset + experts_held)`` are held; each adds ``weight x
  SwiGLU_e(h)`` to the tokens that chose it (a loop over the held
  experts); choices of other experts add nothing. The shared experts add
  ``SwiGLU_shared(h)`` to every token.
- The bias rule after each step: ``b_i += gamma sign(mean load - load_i)``
  over all E experts, the load counting the step's choices.
- AdamW with bias-corrected moments stored in bfloat16 (rounded on every
  write) and decoupled decay, on every leaf but the bias.

Departures from the published block, each the same function class:
RoPE pairs the first and second halves of the 64 rope dimensions (split
half), where DeepSeek-V3's code pairs adjacent dimensions: a fixed
permutation of the rope columns of ``Wq`` and ``W_kv_a``. Each RMSNorm
scale is stored as ``w`` in ``1 + w``. The two shared experts are held as
one SwiGLU of twice the width, which gives the same sum.

``matmul`` is every product of the model; :class:`Fp8Matmul` rounds both
operands of each product, forward and backward, to float8 (e4m3) with a
per-tensor scale: the control, one precision below the configuration's
bfloat16 compute.
"""

from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def fp8_matmul(a, b):
    return Fp8Matmul.apply(a, b)


@contextlib.contextmanager
def exact_matmuls():
    """Float32 products with TF32 off, for the reference's steps."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, theta):
    """x (s, h, dim): split-half rotation at positions 0..s-1."""
    s, dim = x.shape[0], x.shape[-1]
    half = dim // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device).unsqueeze(1) * inv
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _swiglu(h, gate, up, down, matmul):
    return matmul(torch.nn.functional.silu(matmul(h, gate)) * matmul(h, up), down)


def mla(h, w: dict, arch: dict, matmul=torch.matmul):
    """One sequence's attention, h (s, d); ``w`` this layer's ``attn``
    leaves (``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b_k`` (H, nope, r),
    ``wkv_b_v`` (H, r, v), ``wo``)."""
    s = h.shape[0]
    H, nd, rd, vd, r = (arch["num_heads"], arch["qk_nope_head_dim"], arch["qk_rope_head_dim"],
                        arch["v_head_dim"], arch["kv_lora_rank"])
    q = matmul(h, w["wq"]).view(s, H, nd + rd)
    q_nope, q_rope = q[..., :nd], _rope(q[..., nd:], arch["rope_theta"])
    kv = matmul(h, w["wkv_a"])
    c_kv = _rms(kv[:, :r], w["kv_norm"], arch["norm_eps"])
    k_rope = _rope(kv[:, r:].view(s, 1, rd), arch["rope_theta"]).expand(s, H, rd)
    k_nope = matmul(c_kv, w["wkv_b_k"].permute(2, 0, 1).reshape(r, H * nd)).view(s, H, nd)
    v = matmul(c_kv, w["wkv_b_v"].permute(1, 0, 2).reshape(r, H * vd)).view(s, H, vd)
    qh = torch.cat([q_nope, q_rope], -1).transpose(0, 1)  # (H, s, nd + rd)
    kh = torch.cat([k_nope, k_rope], -1).permute(1, 2, 0)  # (H, nd + rd, s)
    scores = matmul(qh, kh) * (nd + rd) ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = matmul(probs, v.transpose(0, 1)).transpose(0, 1).reshape(s, H * vd)
    return matmul(o, w["wo"])


def router(h, w_router, bias, arch: dict, matmul=torch.matmul):
    """``(weights (s, k), choices (s, k), scores (s, E))`` for h (s, d)."""
    k = arch["num_experts_per_tok"]
    scores = torch.sigmoid(matmul(h, w_router))
    sel = scores + bias
    choices = torch.sort(sel.detach(), dim=-1, descending=True, stable=True).indices[:, :k]
    wts = torch.gather(scores, 1, choices)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20) * arch.get("routed_scaling_factor", 1.0)
    return wts, choices, scores


def moe(h, w: dict, arch: dict, matmul=torch.matmul):
    """One sequence's MoE, h (s, d); ``w`` this layer's ``moe`` leaves.
    Returns ``(out, balance loss, load (E,) int64, choices (s, k))``."""
    s = h.shape[0]
    E, k = arch["num_experts"], arch["num_experts_per_tok"]
    held, lo = arch.get("experts_held") or E, arch.get("experts_offset", 0)
    wts, choices, scores = router(h, w["router"], w["router_bias"], arch, matmul)
    out = torch.zeros_like(h)
    for e in range(held):
        hit = choices == lo + e  # (s, k)
        rows = hit.any(-1).nonzero().squeeze(-1)
        if rows.numel() == 0:
            continue
        weight = (wts * hit).sum(-1)[rows].unsqueeze(-1)
        y = _swiglu(h[rows], w["gate"][e], w["up"][e], w["down"][e], matmul)
        out = out.index_add(0, rows, weight * y)
    out = out + _swiglu(h, w["shared.gate"], w["shared.up"], w["shared.down"], matmul)
    load = torch.stack([(choices == e).sum() for e in range(E)])
    f = load.to(torch.float32) * (E / (k * s))
    share = (scores / scores.sum(-1, keepdim=True)).mean(0)
    bal = (f * share).sum() * arch["router_aux_coef"]
    return out, bal, load, choices


def _layer(wts: dict, arch: dict, i: int) -> tuple[str, int, bool]:
    """(leaf prefix, index in the stack, is MoE) of layer ``i``."""
    dense = arch.get("first_k_dense", 0)
    if i < dense:
        return "decoder.0.0.", i, False
    return f"decoder.{1 if dense else 0}.0.", i - dense, True


def _leaves(wts: dict, prefix: str, r: int) -> dict:
    return {name[len(prefix):]: v[r] for name, v in wts.items() if name.startswith(prefix)}


def sequence_loss(wts: dict, arch: dict, tok, labels, matmul=torch.matmul):
    """One sequence's loss (mean next-token cross-entropy plus the MoE
    layers' balance losses), its MoE layers' loads (layers, E) and their
    choices (a list of (s, k))."""
    x = wts["embed"][tok.long()]
    eps = arch["norm_eps"]
    loads, choices, bal = [], [], 0.0
    for i in range(arch["num_layers"]):
        prefix, r, is_moe = _layer(wts, arch, i)
        lw = _leaves(wts, prefix, r)
        x = x + mla(_rms(x, lw["ln1"], eps), {k[5:]: v for k, v in lw.items() if k.startswith("attn.")},
                    arch, matmul)
        h = _rms(x, lw["ln2"], eps)
        if is_moe:
            out, b, load, ch = moe(h, {k[4:]: v for k, v in lw.items() if k.startswith("moe.")}, arch, matmul)
            bal = bal + b
            loads.append(load)
            choices.append(ch)
        else:
            out = _swiglu(h, lw["mlp.gate"], lw["mlp.up"], lw["mlp.down"], matmul)
        x = x + out
    logits = matmul(_rms(x, wts["final_norm"], eps), wts["lm_head"])
    ce = torch.nn.functional.cross_entropy(logits, labels.long())
    return ce + bal, torch.stack(loads), choices


def trained(name: str) -> bool:
    """Every leaf but the routers' selection bias is trained."""
    return not name.endswith("router_bias")


def adamw_(wts: dict, grads: dict, state: dict, opt: dict) -> None:
    """One AdamW step in place on the trained leaves, moments rounded to
    ``opt["state_dtype"]`` on every write (bias-corrected, decoupled
    decay)."""
    sdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[opt.get("state_dtype", "float32")]
    state["t"] += 1
    step = torch.full((), state["t"], dtype=torch.float32)
    b1c = 1.0 - torch.pow(torch.full((), opt["b1"], dtype=torch.float32), step)
    b2c = 1.0 - torch.pow(torch.full((), opt["b2"], dtype=torch.float32), step)
    for name, p in wts.items():
        if not trained(name):
            continue
        g = grads[name]
        mu = state["mu"].setdefault(name, torch.zeros(p.shape, dtype=sdt, device=p.device))
        nu = state["nu"].setdefault(name, torch.zeros(p.shape, dtype=sdt, device=p.device))
        mu32 = opt["b1"] * mu.float() + (1 - opt["b1"]) * g
        nu32 = opt["b2"] * nu.float() + (1 - opt["b2"]) * g * g
        delta = (mu32 / b1c.to(p.device)) / (torch.sqrt(nu32 / b2c.to(p.device)) + opt["eps"])
        p.sub_(opt["lr"] * (delta + opt["weight_decay"] * p))
        mu.copy_(mu32)
        nu.copy_(nu32)


def bias_rule_(wts: dict, arch: dict, loads) -> None:
    """``b += gamma sign(mean load - load)`` on every MoE layer's bias, in
    place; ``loads`` (MoE layers, E) of the step."""
    rate = arch.get("router_bias_rate", 0.0)
    i = 0
    for layer in range(arch["num_layers"]):
        prefix, r, is_moe = _layer(wts, arch, layer)
        if not is_moe:
            continue
        lf = loads[i].to(torch.float32)
        wts[prefix + "moe.router_bias"][r].add_(torch.sign(lf.mean() - lf) * rate)
        i += 1


class Learner:
    """One worker's steps from ``wts`` (updated in place), one sequence of
    the batch at a time (the gradients summed over them): each step's
    loss, the first step's gradient norm by leaf, each step's routing
    and loads, AdamW's moments and the bias rule."""

    def __init__(self, wts: dict, arch: dict, opt: dict, matmul=torch.matmul):
        self.wts, self.arch, self.opt, self.matmul = wts, arch, opt, matmul
        self.state = {"t": 0, "mu": {}, "nu": {}}
        self.losses, self.grad_norms, self.choices = [], {}, []

    def step(self, batch: dict, update: bool) -> None:
        tok, labels = batch["tokens"], batch["labels"]
        b = tok.shape[0]
        names = [k for k in self.wts if trained(k)]
        grads = {k: torch.zeros_like(self.wts[k]) for k in names}
        total, loads, choices = 0.0, 0, []
        for j in range(b):
            leaves = {k: v.detach().requires_grad_(trained(k)) for k, v in self.wts.items()}
            value, load, ch = sequence_loss(leaves, self.arch, tok[j], labels[j], self.matmul)
            for k, g in zip(names, torch.autograd.grad(value / b, [leaves[k] for k in names])):
                grads[k] += g
            total += value.item() / b
            loads = loads + load
            choices.append(ch)
            del leaves, value
        self.losses.append(total)
        # (layers, b * s, k): the step's choices, token by token in batch order
        self.choices.append(torch.stack([torch.cat([c[i] for c in choices]) for i in range(len(choices[0]))]))
        if len(self.losses) == 1:
            self.grad_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads.items()}
        if update:
            with torch.no_grad():
                adamw_(self.wts, grads, self.state, self.opt)
                bias_rule_(self.wts, self.arch, loads)

    def adopt(self, wts: dict) -> None:
        """Take another worker's weights (the bias too); the moments stay
        this worker's."""
        with torch.no_grad():
            for k, v in wts.items():
                self.wts[k].copy_(v)

    def change_norms(self, start: dict) -> dict:
        return {k: float(torch.linalg.vector_norm((v - start[k]).double())) for k, v in self.wts.items()
                if trained(k)}

    def biases(self) -> dict:
        return {k: v.clone() for k, v in self.wts.items() if not trained(k)}


def certificate(losses: list, width_coef: float = 1.0) -> float:
    """A worker's certificate after its first segment: the mean of its K
    step losses plus ``width_coef`` times their population standard
    deviation over sqrt(K)."""
    k = len(losses)
    mean = sum(losses) / k
    std = math.sqrt(sum((x - mean) ** 2 for x in losses) / k)
    return mean + width_coef * std / math.sqrt(k)


def worst_leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between two norms by leaf, against the larger
    of that leaf's reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or keep(k)]
    med = sorted(ref[k] for k in names)[len(names) // 2]
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names)
