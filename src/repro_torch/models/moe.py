"""Mixture-of-Experts with capacity-based dispatch (DeepSeek-V3 / Grok-1
style: shared + routed experts, top-k softmax gate); counterpart of
``src/repro/models/moe.py``.

The reference's one-hot + cumsum slot scheme: slot ``i`` holds token
``i // k``'s choice ``i % k``; its position within its expert is an
integer cumsum, and slots past the capacity ``C`` are dropped (their
residual passes through). Kept slots land in a dense ``(E, C, d)``
buffer, the SwiGLU experts run as batched products over it, and the
results come back weighted by the renormalised gates.

No step adds floats in a data-dependent order, so the bits do not vary
run to run on the card: the top-k is a stable descending sort (the
reference's ``lax.top_k`` puts the lower index first on ties, which
``torch.topk`` does not promise); the scatter is an index assignment of
unique ``(expert, position)`` pairs (the dropped slots go to one spare
row that is cut off), not an accumulating add; the token gather is an
``expand`` (its backward sums over k in a fixed order) and the expert
gather reads a zero spare row for the dropped slots.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _normal, apply_mlp, init_linear, init_mlp


def init_moe(generator, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    E, d, f = cfg.num_experts, cfg.d_model, cfg.expert_ff()
    p = {
        "router": init_linear(generator, d, E, torch.float32, device, lead),  # router kept f32
        "gate": _normal(lead + (E, d, f), d ** -0.5, dtype, generator, device),
        "up": _normal(lead + (E, d, f), d ** -0.5, dtype, generator, device),
        "down": _normal(lead + (E, f, d), f ** -0.5, dtype, generator, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(generator, d, f * cfg.num_shared_experts, dtype, device=device, lead=lead)
    return p


def moe_capacity(cfg: ArchConfig, num_tokens: int) -> int:
    cap = int(num_tokens * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def route(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``probs`` (t, E): values and indices, largest first and
    the lower index first on ties (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def apply_moe(params: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (b,s,d), aux_loss ()). Router runs in f32."""
    b, s, d = x.shape
    t = b * s
    k = cfg.num_experts_per_tok
    E = cfg.num_experts
    C = moe_capacity(cfg, t)
    xt = x.reshape(t, d)

    logits = torch.matmul(xt.to(torch.float32), params["router"])
    probs = torch.softmax(logits, dim=-1)  # (t, E)
    topw, topi = route(probs, k)  # (t, k)
    topw = topw / torch.clamp(torch.sum(topw, dim=-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)  # mean router prob per expert
    fe = torch.mean(F.one_hot(topi[:, 0], E).to(torch.float32), dim=0)  # top-1 fraction
    aux = E * torch.sum(fe * me) * cfg.router_aux_coef

    # slot layout: slot i covers token i//k, choice i%k
    sid = topi.reshape(t * k)  # expert id per slot
    onehot = F.one_hot(sid, E).to(torch.int32)  # (t*k, E)
    pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1  # 0-based position within expert
    keep = (pos >= 0) & (pos < C)
    # a kept slot's row of the flat (E*C, d) buffer; every dropped slot
    # goes to the spare row E*C
    row = torch.where(keep, sid * C + pos, torch.full_like(pos, E * C))

    slot_x = xt.unsqueeze(1).expand(t, k, d).reshape(t * k, d) * keep.unsqueeze(1).to(xt.dtype)
    flat = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=x.device).index_put((row,), slot_x)
    # + 0.0: an assigned -0.0 reads +0.0, as the reference's 0 + x does
    buf = flat[: E * C].reshape(E, C, d) + 0.0

    # expert FFN (SwiGLU) as batched products over the experts
    g = torch.bmm(buf, params["gate"].to(buf.dtype))
    u = torch.bmm(buf, params["up"].to(buf.dtype))
    y = torch.bmm(F.silu(g) * u, params["down"].to(buf.dtype))

    y_flat = torch.cat([y.reshape(E * C, d), torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    out_slots = y_flat[row] * topw.reshape(t * k, 1).to(y.dtype)
    out = torch.sum(out_slots.reshape(t, k, d), dim=1)

    if "shared" in params:
        out = out + apply_mlp(params["shared"], xt)
    return out.reshape(b, s, d), aux
