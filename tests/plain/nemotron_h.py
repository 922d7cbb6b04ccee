"""Plain reference of NVIDIA Nemotron 3 Nano's hybrid block (model type
``nemotron_h``: the published ``config.json`` of
NVIDIA-Nemotron-3-Nano-30B-A3B and the family paper, Nemotron-H,
arXiv:2504.03624) and of a TMSN-SGD worker's first steps on it: the
loss, its gradients by autograd, AdamW with bfloat16 moments and the
router's bias rule, in float32 with TF32 off. Imports no JAX, nothing of
``repro`` or ``repro_torch`` and no kernel; its weights and tokens come
from the benchmark's own draw, as the program's do.
``tests/plain/nemotron_h.py`` is the same file, for the port's CPU tests.

The stack is ``arch["layer_pattern"]``, one block a character, each
``x + mixer(RMSNorm(x))``: "M" Mamba-2, "E" the MoE, "*" attention.
Weights are a dict by the program's leaf names: a run of equal
characters is one segment, ``decoder.<segment>.0.<leaf>`` stacked over
the run's layers.

The blocks:

- Mamba-2 (arXiv:2405.21060): ``[z, xBC, dt] = h W_in``; a depthwise
  causal conv of width 4 with bias over ``xBC``, then SiLU; ``xBC`` splits
  into x (heads x head_dim), B and C (``groups`` x state each); head h
  reads group ``h // (heads / groups)``; ``dt = softplus(dt + dt_bias)``,
  ``A = -exp(A_log)``; the recurrence ``S_t = exp(dt_t A) S_{t-1} + dt_t
  B_t x_t^T``, ``y_t = C_t S_t + D x_t`` (:func:`ssd_recurrent`, step by
  step) is computed in chunks (:func:`ssd_chunked`: the Mamba-2 paper's
  minimal SSD, the within-chunk masked products and the chunk states
  passed on by one product over the chunks); the gated RMSNorm of ``y *
  silu(z)`` over each group's share of the channels; ``W_out``.
- The MoE: ``s = sigmoid(h W_r)``; the choice is the top-k of ``s + b``
  (the lower index first on ties); the weights are the chosen ``s`` over
  their sum (+ 1e-20) times ``routed_scaling_factor``; the sequence-wise
  balance loss ``alpha sum_i f_i P_i`` (``f_i = E / (k T)`` times the
  sequence's choices of expert i, ``P_i`` the mean of ``s_i / sum_j
  s_j``), the batch's the mean over its sequences. Experts are relu^2 and
  not gated, ``down(relu(up h)^2)``. One chip's share: only experts
  ``[experts_offset, experts_offset + experts_held)`` are held; each adds
  ``weight x expert_e(h)`` to the tokens that chose it (a loop over the
  held experts); choices of other experts add nothing. The shared expert
  adds ``down(relu(up h)^2)`` to every token.
- Attention: grouped-query, query head i reading key/value head ``i //
  (heads / kv_heads)``, causal softmax of ``q . k / sqrt(head_dim)``, no
  positional embedding (Nemotron-H's attention blocks take none); the
  queries computed in blocks so that the scores fit.
- The bias rule after each step: ``b_i += gamma sign(mean load - load_i)``
  over all E experts, the load counting the step's choices.
- AdamW with bias-corrected moments stored in bfloat16 (rounded on every
  write) and decoupled decay, on every leaf but the bias.

Departures from the published block, each the same function class: each
RMSNorm scale is stored as ``w`` in ``1 + w``; the shared expert of width
3 712 is held as 2 x 1 856 (``num_shared_experts`` 2 of ``moe_d_ff``),
the same width; the selection bias and the balance loss follow
DeepSeek-V3's rule (the published router has the bias; its training rate
and the balance factor are assumed).

``matmul`` is every product of the model; :class:`Fp8Matmul` rounds both
operands of each product, forward and backward, to float8 (e4m3) with a
per-tensor scale: the control, one precision below the configuration's
bfloat16 compute.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
#: query rows of attention's scores computed at a time
ATTN_BLOCK = 2048


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


def _relu2(u):
    return F.relu(u).pow(2)


def _mlp(h, up, down, matmul):
    return matmul(_relu2(matmul(h, up)), down)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


def ssd_recurrent(x, dt, A, B, C, D):
    """The recurrence step by step: x (s, H, P), dt (s, H), A (H,), B and C
    (s, H, N) (a head's own), D (H,) -> y (s, H, P)."""
    s, H, P = x.shape
    S = x.new_zeros((H, B.shape[-1], P))
    ys = []
    for t in range(s):
        S = torch.exp(dt[t] * A)[:, None, None] * S + (dt[t, :, None] * B[t])[:, :, None] * x[t][:, None, :]
        ys.append(torch.einsum("hn,hnp->hp", C[t], S) + D[:, None] * x[t])
    return torch.stack(ys)


def _segsum(a):
    """(..., T) -> (..., T, T): the sum of a over (j, i] at [i, j], -inf
    above the diagonal."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    x = x.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1), 0.0)
    out = torch.cumsum(x, dim=-2)
    return out.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=a.device).tril(0), -math.inf)


def ssd_chunked(x, dt, A, B, C, D, chunk: int, matmul=torch.matmul):
    """:func:`ssd_recurrent` in chunks of ``chunk`` positions (the Mamba-2
    paper's minimal SSD): the same arguments and result."""
    s, H, P = x.shape
    N, nc, Q = B.shape[-1], s // chunk, chunk
    X = (x * dt[..., None]).reshape(nc, Q, H, P).transpose(1, 2)  # (nc, H, Q, P)
    a = (dt * A).reshape(nc, Q, H).transpose(1, 2)  # (nc, H, Q)
    acum = torch.cumsum(a, dim=-1)
    Bc = B.reshape(nc, Q, H, N).transpose(1, 2)  # (nc, H, Q, N)
    Cc = C.reshape(nc, Q, H, N).transpose(1, 2)
    # within each chunk
    y_diag = matmul(matmul(Cc, Bc.transpose(-1, -2)) * torch.exp(_segsum(a)), X)
    # each chunk's own final state, then the states entering each chunk
    states = matmul((Bc * torch.exp(acum[..., -1:] - acum)[..., None]).transpose(-1, -2), X)  # (nc, H, N, P)
    states = torch.cat([states.new_zeros((1, H, N, P)), states])
    decay = torch.exp(_segsum(F.pad(acum[..., -1].transpose(0, 1), (1, 0))))  # (H, nc + 1, nc + 1)
    entering = matmul(decay, states.permute(1, 0, 2, 3).reshape(H, nc + 1, N * P))
    entering = entering.reshape(H, nc + 1, N, P)[:, :-1].transpose(0, 1)  # (nc, H, N, P)
    y_off = matmul(Cc, entering) * torch.exp(acum)[..., None]
    y = (y_diag + y_off).transpose(1, 2).reshape(s, H, P)
    return y + D[:, None] * x


def mamba2(h, w: dict, arch: dict, matmul=torch.matmul, scan=None):
    """One sequence's Mamba-2 mixer, h (s, d); ``w`` this layer's ``ssm``
    leaves. ``scan`` replaces :func:`ssd_chunked` (tests: the recurrence)."""
    s = h.shape[0]
    H, P, N, G = arch["ssm_heads"], arch["ssm_head_dim"], arch["ssm_state"], arch["ssm_groups"]
    di, k = H * P, arch["ssm_conv_width"]
    zxbcdt = matmul(h, w["in_proj"])
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * G * N], zxbcdt[:, 2 * di + 2 * G * N:]
    ch = xbc.shape[1]
    xbc = F.conv1d(xbc.t()[None], w["conv_w"].t()[:, None, :], w["conv_b"], padding=k - 1, groups=ch)
    xbc = F.silu(xbc[0, :, :s].t())
    x = xbc[:, :di].reshape(s, H, P)
    B = xbc[:, di:di + G * N].reshape(s, G, N).repeat_interleave(H // G, dim=1)
    C = xbc[:, di + G * N:].reshape(s, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt + w["dt_bias"])
    A = -torch.exp(w["a_log"])
    if scan is None:
        y = ssd_chunked(x, dt, A, B, C, w["D"], min(arch["ssm_chunk"], s), matmul)
    else:
        y = scan(x, dt, A, B, C, w["D"])
    g = (y.reshape(s, di) * F.silu(z)).reshape(s, G, -1)
    y = _rms(g, w["norm"].reshape(G, -1), arch["norm_eps"]).reshape(s, di)
    return matmul(y, w["out_proj"])


# ---------------------------------------------------------------------------
# attention and the MoE
# ---------------------------------------------------------------------------


def gqa(h, w: dict, arch: dict, matmul=torch.matmul):
    """One sequence's causal grouped-query attention with no positions, h
    (s, d); ``w`` this layer's ``attn`` leaves."""
    s = h.shape[0]
    Hq, K = arch["num_heads"], arch["num_kv_heads"]
    hd = arch.get("head_dim") or arch["d_model"] // Hq
    q = matmul(h, w["wq"]).reshape(s, Hq, hd).transpose(0, 1)  # (Hq, s, hd)
    k = matmul(h, w["wk"]).reshape(s, K, hd).transpose(0, 1).repeat_interleave(Hq // K, dim=0)
    v = matmul(h, w["wv"]).reshape(s, K, hd).transpose(0, 1).repeat_interleave(Hq // K, dim=0)
    outs = []
    for lo in range(0, s, ATTN_BLOCK):
        hi = min(s, lo + ATTN_BLOCK)
        scores = matmul(q[:, lo:hi], k[:, :hi].transpose(-1, -2)) * hd ** -0.5  # (Hq, hi - lo, hi)
        causal = torch.arange(hi, device=h.device)[None, :] <= torch.arange(lo, hi, device=h.device)[:, None]
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        outs.append(matmul(probs, v[:, :hi]))
    o = torch.cat(outs, dim=1).transpose(0, 1).reshape(s, Hq * hd)
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
        out = out.index_add(0, rows, weight * _mlp(h[rows], w["up"][e], w["down"][e], matmul))
    out = out + _mlp(h, w["shared.up"], w["shared.down"], matmul)
    load = torch.stack([(choices == e).sum() for e in range(E)])
    f = load.to(torch.float32) * (E / (k * s))
    share = (scores / scores.sum(-1, keepdim=True)).mean(0)
    bal = (f * share).sum() * arch["router_aux_coef"]
    return out, bal, load, choices


# ---------------------------------------------------------------------------
# the stack, the loss and a worker's steps
# ---------------------------------------------------------------------------


def blocks(arch: dict) -> list:
    """Per layer ``(character, leaf prefix, index in its segment)``."""
    out, seg, prev, r = [], -1, None, 0
    for ch in arch["layer_pattern"]:
        seg, r = (seg, r + 1) if ch == prev else (seg + 1, 0)
        out.append((ch, f"decoder.{seg}.0.", r))
        prev = ch
    return out


def _leaves(wts: dict, prefix: str, r: int, group: str) -> dict:
    p = prefix + group + "."
    return {name[len(p):]: v[r] for name, v in wts.items() if name.startswith(p)}


def sequence_loss(wts: dict, arch: dict, tok, labels, matmul=torch.matmul, scan=None):
    """One sequence's loss (mean next-token cross-entropy plus the MoE
    layers' balance losses), its MoE layers' loads (layers, E) and their
    choices (a list of (s, k))."""
    x = wts["embed"][tok.long()]
    eps = arch["norm_eps"]
    loads, choices, bal = [], [], 0.0
    for ch, prefix, r in blocks(arch):
        h = _rms(x, wts[prefix + "ln1"][r], eps)
        if ch == "M":
            x = x + mamba2(h, _leaves(wts, prefix, r, "ssm"), arch, matmul, scan)
        elif ch == "*":
            x = x + gqa(h, _leaves(wts, prefix, r, "attn"), arch, matmul)
        else:
            out, b, load, c = moe(h, _leaves(wts, prefix, r, "moe"), arch, matmul)
            x = x + out
            bal = bal + b
            loads.append(load)
            choices.append(c)
    logits = matmul(_rms(x, wts["final_norm"], eps), wts["lm_head"])
    ce = F.cross_entropy(logits, labels.long())
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
    moes = [(prefix, r) for ch, prefix, r in blocks(arch) if ch == "E"]
    for (prefix, r), load in zip(moes, loads):
        lf = load.to(torch.float32)
        wts[prefix + "moe.router_bias"][r].add_(torch.sign(lf.mean() - lf) * rate)


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
