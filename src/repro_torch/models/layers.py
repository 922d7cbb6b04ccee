"""Shared low-level layers: RMSNorm, SwiGLU / GELU MLP, RoPE, embeddings,
cross-entropy; counterpart of ``src/repro/models/layers.py``.

Each function takes the reference's ops in the reference's order and
dtypes: norms and RoPE angles in float32, weights cast to the
activations' dtype before a product. The ``init_*`` functions draw from
an explicit ``torch.Generator`` (the reference's ``jax.random`` draws are
not copied: tests convert the reference's parameters instead); on the
``meta`` device they only shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


#: elements of float32 draw held at a time: a leaf is drawn in pieces of
#: this size into its own dtype (DeepSeek-V3's stacked routed experts are
#: 3.76e9 elements, 15 GB as one float32 draw plus its ``* std`` copy)
DRAW_CHUNK = 2 ** 28


def _normal(shape, std: float, dtype, generator, device) -> torch.Tensor:
    """``N(0, 1) * std`` drawn in float32, then cast (the reference's
    ``(normal(key, shape) * std).astype(dtype)``), ``DRAW_CHUNK``
    elements at a time (a leaf of one piece gets a whole draw's values)."""
    dev = torch.device(device)
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    flat = out.view(-1)
    for start in range(0, flat.numel(), DRAW_CHUNK):
        m = min(DRAW_CHUNK, flat.numel() - start)
        flat[start:start + m] = torch.randn((m,), generator=generator, device=dev) * std
    return out


def init_rms_norm(d: int, dtype, device="cpu", lead: tuple = ()) -> torch.Tensor:
    return torch.zeros(lead + (d,), dtype=dtype, device=device)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, w_gate.to(x.dtype))
    u = torch.matmul(x, w_up.to(x.dtype))
    return torch.matmul(F.silu(g) * u, w_down.to(x.dtype))


def init_mlp(generator, d: int, f: int, dtype, gated: bool = True, device="cpu", lead: tuple = ()) -> dict:
    """``lead`` prepends stacking dims (the repeats of a segment)."""
    p = {
        "up": _normal(lead + (d, f), d ** -0.5, dtype, generator, device),
        "down": _normal(lead + (f, d), f ** -0.5, dtype, generator, device),
    }
    if gated:
        p["gate"] = _normal(lead + (d, f), d ** -0.5, dtype, generator, device)
    return p


def relu2(u: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (Nemotron-H's MLP and experts)."""
    return torch.square(F.relu(u))


def apply_mlp(params: dict, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    """SwiGLU where the params have a gate, else ``down(act(up x))`` with
    ``act`` "gelu" (tanh approximation) or "relu2"."""
    if "gate" in params:
        return swiglu(x, params["gate"], params["up"], params["down"])
    u = torch.matmul(x, params["up"].to(x.dtype))
    # jax.nn.gelu defaults to the tanh approximation
    h = relu2(u) if act == "relu2" else F.gelu(u, approximate="tanh")
    return torch.matmul(h, params["down"].to(x.dtype))


def rope_freqs(positions: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., dim//2), in float32."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    # theta is filled on the device: torch.tensor(theta, device=...) is a
    # host-to-device copy, which waits for the card
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions.unsqueeze(-1).to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., s, h, dim); cos/sin (..., s, dim//2) broadcast over heads.
    Split-half rotation (not interleaved)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos.unsqueeze(-2).to(x.dtype)
    s = sin.unsqueeze(-2).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def init_embedding(generator, vocab: int, d: int, dtype, device="cpu") -> torch.Tensor:
    return _normal((vocab, d), 0.02, dtype, generator, device)


def init_linear(generator, d_in: int, d_out: int, dtype, device="cpu", lead: tuple = ()) -> torch.Tensor:
    return _normal(lead + (d_in, d_out), d_in ** -0.5, dtype, generator, device)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss. logits (b,s,V) f32, labels (b,s) int, mask (b,s).
    The gold logit is a ``gather``, whose backward writes each address
    once (no accumulation order to vary on the card)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.unsqueeze(-1).to(torch.int64)).squeeze(-1)
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
