"""Plain reference of a TMSN-SGD worker's first steps on a dense GQA
decoder (Yi-9B's layer, arXiv:2403.04652): the loss, its gradients by
autograd and AdamW, in float32 with TF32 off. Imports nothing of the
program; its weights and tokens come from the benchmark's own draw
(``harness/lm_inputs.py``), as the program's do.

The layer, as the Llama family writes it: RMSNorm with a ``1 + w`` scale,
grouped-query attention with split-half RoPE (query head ``k*G + g``
reads key/value head ``k``) over a causal softmax, a SwiGLU MLP, a final
RMSNorm, an untied head and the mean next-token cross-entropy.

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
        # products broadcast over leading axes: sum them back to b's shape
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def fp8_matmul(a, b):
    return Fp8Matmul.apply(a, b)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, theta):
    """x (b, s, h, hd): split-half rotation at positions 0..s-1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device).unsqueeze(1) * inv
    cos, sin = torch.cos(ang).float()[None, :, None, :], torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def loss(wts: dict, arch: dict, batch: dict, matmul=torch.matmul) -> torch.Tensor:
    tok, labels, mask = batch["tokens"].long(), batch["labels"].long(), batch["mask"].float()
    d, H, K = arch["d_model"], arch["num_heads"], arch["num_kv_heads"]
    hd = arch.get("head_dim") or d // H
    eps, theta = arch["norm_eps"], arch["rope_theta"]
    b, s = tok.shape
    x = wts["embed"][tok]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    p = "decoder.0.0."
    for i in range(arch["num_layers"]):
        h = _rms(x, wts[p + "ln1"][i], eps)
        q = _rope(matmul(h, wts[p + "attn.wq"][i]).view(b, s, H, hd), theta)
        k = _rope(matmul(h, wts[p + "attn.wk"][i]).view(b, s, K, hd), theta)
        v = matmul(h, wts[p + "attn.wv"][i]).view(b, s, K, hd)
        rep = lambda t: t.unsqueeze(3).expand(b, s, K, H // K, hd).reshape(b, s, H, hd).transpose(1, 2)
        qh = q.transpose(1, 2)
        scores = matmul(qh, rep(k).transpose(-1, -2)) * hd ** -0.5
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        o = matmul(probs, rep(v)).transpose(1, 2).reshape(b, s, H * hd)
        x = x + matmul(o, wts[p + "attn.wo"][i])
        h = _rms(x, wts[p + "ln2"][i], eps)
        gate = torch.nn.functional.silu(matmul(h, wts[p + "mlp.gate"][i]))
        x = x + matmul(gate * matmul(h, wts[p + "mlp.up"][i]), wts[p + "mlp.down"][i])
    logits = matmul(_rms(x, wts["final_norm"], eps), wts["lm_head"])
    nll = torch.nn.functional.cross_entropy(logits.reshape(b * s, -1), labels.reshape(-1), reduction="none")
    return (nll * mask.reshape(-1)).sum() / mask.sum().clamp(min=1.0)


def adamw_(wts: dict, grads: dict, state: dict, opt: dict) -> None:
    """One AdamW step in place (bias-corrected moments, decoupled decay)."""
    state["t"] += 1
    t = state["t"]
    for name, p in wts.items():
        g = grads[name]
        mu = state["mu"].setdefault(name, torch.zeros_like(p))
        nu = state["nu"].setdefault(name, torch.zeros_like(p))
        mu.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
        nu.mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
        mhat = mu / (1 - opt["b1"] ** t)
        nhat = nu / (1 - opt["b2"] ** t)
        p.sub_(opt["lr"] * (mhat / (nhat.sqrt() + opt["eps"]) + opt["weight_decay"] * p))


@contextlib.contextmanager
def exact_matmuls():
    """Float32 products with TF32 off, for the reference's steps."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


class Learner:
    """One worker's steps from ``wts`` (updated in place): each step's
    loss, the first step's gradient norm by leaf, AdamW's moments."""

    def __init__(self, wts: dict, arch: dict, opt: dict, matmul=torch.matmul):
        self.wts, self.arch, self.opt, self.matmul = wts, arch, opt, matmul
        self.state = {"t": 0, "mu": {}, "nu": {}}
        self.losses, self.grad_norms = [], {}

    def step(self, batch: dict, update: bool) -> None:
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.wts.items()}
        value = loss(leaves, self.arch, batch, self.matmul)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        self.losses.append(value.item())
        if len(self.losses) == 1:
            self.grad_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads.items()}
        if update:
            with torch.no_grad():
                adamw_(self.wts, grads, self.state, self.opt)

    def adopt(self, wts: dict) -> None:
        """Take another worker's weights; the moments stay this worker's."""
        with torch.no_grad():
            for k, v in wts.items():
                self.wts[k].copy_(v)

    def change_norms(self, start: dict) -> dict:
        return {k: float(torch.linalg.vector_norm((v - start[k]).double())) for k, v in self.wts.items()}


def certificate(losses: list, width_coef: float = 1.0) -> float:
    """A worker's certificate after its first segment: the mean of its K
    step losses plus ``width_coef`` times their population standard
    deviation over sqrt(K) (the estimator's first observation)."""
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
