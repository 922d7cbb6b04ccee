"""Mixture-of-Experts: shared + routed experts behind a top-k router;
counterpart of ``src/repro/models/moe.py``, plus DeepSeek-V3's router,
drop-free dispatch and one chip's share of the experts.

**Routers.** ``router_score="softmax"`` (the default, the reference's):
top-k of the softmax, the weights renormalised, a Switch-style balance
loss. ``"sigmoid"`` (DeepSeek-V3, arXiv:2412.19437 §2.1.2): scores
``s = sigmoid(x W_r)`` in float32; the choice is the top-k of ``s + b``,
where ``b`` (``router_bias``, a float32 leaf of the model) is used only
to choose and is stepped after each optimizer step by
:func:`router_bias_step_` from the step's loads (the auxiliary-loss-free
balance), never by gradient; the weights are the unbiased ``s`` of the
chosen experts over their sum (+ 1e-20), times ``routed_scaling_factor``;
and the sequence-wise balance loss ``alpha * sum_i f_i P_i`` a sequence,
averaged over the batch, where ``f_i`` counts the sequence's choices of
expert i (times E / (k T)) and ``P_i`` is the mean of ``s_i / sum_j s_j``.

**Capacity dispatch** (the default, the reference's one-hot + cumsum slot
scheme): slot ``i`` holds token ``i // k``'s choice ``i % k``; its position
within its expert is an integer cumsum, and slots past the capacity
``C`` are dropped (their residual passes through). Kept slots land in a
dense ``(E, C, d)`` buffer, the experts run as batched products over
it, and the results come back weighted by the gates.

**Experts** are SwiGLU (``expert_act="swiglu"``: gate, up, down) or
Nemotron-H's relu^2 (``"relu2"``: ``down(relu(up x)^2)``, two products
and no gate), the shared experts alike.

**Drop-free dispatch over the held experts** (``moe_dispatch="dropless"``;
``experts_held``/``experts_offset`` give the share). The router keeps all
``num_experts`` outputs; the layer holds experts ``[offset, offset + H)``
and computes their part of the output for every token-choice routed to
them, with no capacity. Token-choices routed elsewhere add nothing (the
absent chips' part is left out, not stood in for). The choices are sorted
by held expert (a stable integer sort; the others last), and the three
SwiGLU products run as grouped products over the sorted rows
(:func:`grouped_mm`), so their cost is proportional to the rows routed,
with no padding and no host sync. The row buffer has ``t*k + 1`` rows;
one more group of exactly one row, the first one past the held rows, runs
against a zero expert: its output is exactly zero, and every token-choice
not routed here reads that row. So the rows past the groups (which the
grouped products leave unwritten) are never read, forward or backward.

No step adds floats in a data-dependent order, so the bits do not vary
run to run on the card: the top-k is a stable descending sort (the
reference's ``lax.top_k`` puts the lower index first on ties, which
``torch.topk`` does not promise); the capacity scatter is an index
assignment of unique ``(expert, position)`` pairs (the dropped slots go to
one spare row that is cut off), not an accumulating add; the drop-free
gathers are ``index_select``s whose backward is a gather too
(:class:`_Dispatch`, :class:`_Combine`); a token's k outputs are summed
in a fixed order; counts are integer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _normal, apply_mlp, init_linear, init_mlp, relu2


def init_moe(generator, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    """The router over all ``num_experts``, the selection bias with the
    sigmoid router, and the held experts' weights (no gate for relu^2
    experts)."""
    E, H, d, f = cfg.num_experts, cfg.n_held(), cfg.d_model, cfg.expert_ff()
    gated = cfg.expert_act == "swiglu"
    p = {"router": init_linear(generator, d, E, torch.float32, device, lead)}  # router kept f32
    if cfg.router_score == "sigmoid":
        p["router_bias"] = torch.zeros(lead + (E,), dtype=torch.float32, device=device)
    if gated:
        p["gate"] = _normal(lead + (H, d, f), d ** -0.5, dtype, generator, device)
    p["up"] = _normal(lead + (H, d, f), d ** -0.5, dtype, generator, device)
    p["down"] = _normal(lead + (H, f, d), f ** -0.5, dtype, generator, device)
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(generator, d, f * cfg.num_shared_experts, dtype, gated=gated, device=device,
                               lead=lead)
    return p


def moe_capacity(cfg: ArchConfig, num_tokens: int) -> int:
    cap = int(num_tokens * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def route(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``probs`` (t, E): values and indices, largest first and
    the lower index first on ties (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def expert_counts(topi: torch.Tensor, rows: int, E: int) -> torch.Tensor:
    """(rows, E) int64: how often each expert was chosen in each of
    ``rows`` equal runs of tokens of ``topi`` (t, k) (integer adds)."""
    t, k = topi.shape
    run = torch.div(torch.arange(t * k, device=topi.device), t // rows * k, rounding_mode="floor")
    flat = torch.zeros((rows * E,), dtype=torch.int64, device=topi.device)
    flat.scatter_add_(0, run * E + topi.reshape(t * k), torch.ones_like(run))
    return flat.reshape(rows, E)


def router(params: dict, xt: torch.Tensor, n_seq: int, cfg: ArchConfig):
    """``(weights (t, k) f32, choices (t, k), balance loss (), load)`` for
    the tokens ``xt`` (t, d), ``n_seq`` sequences of equal length; the
    load (E,) int64 (the choices of each expert) with the sigmoid
    router, else None."""
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    logits = torch.matmul(xt.to(torch.float32), params["router"])
    if cfg.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + params["router_bias"].detach() if "router_bias" in params else scores
        _, topi = route(sel, k)
        topw = torch.gather(scores, 1, topi)
        topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-20)
        counts = expert_counts(topi, n_seq, E)  # (n_seq, E)
        s = xt.shape[0] // n_seq
        share = torch.mean((scores / torch.sum(scores, dim=-1, keepdim=True)).reshape(n_seq, s, E), dim=1)
        f = counts.to(torch.float32) * (E / (k * s))
        aux = torch.mean(torch.sum(f * share, dim=-1)) * cfg.router_aux_coef
        load = torch.sum(counts, dim=0)
    else:
        probs = torch.softmax(logits, dim=-1)  # (t, E)
        topw, topi = route(probs, k)  # (t, k)
        topw = topw / torch.clamp(torch.sum(topw, dim=-1, keepdim=True), min=1e-9)
        # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
        me = torch.mean(probs, dim=0)  # mean router prob per expert
        fe = torch.mean(F.one_hot(topi[:, 0], E).to(torch.float32), dim=0)  # top-1 fraction
        aux = E * torch.sum(fe * me) * cfg.router_aux_coef
        load = None
    if cfg.routed_scaling_factor != 1.0:
        topw = topw * cfg.routed_scaling_factor
    return topw, topi, aux, load


def experts_capacity(params: dict, xt: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """The reference's dispatch: every expert padded to the capacity, the
    overflow dropped. (t, d)."""
    t, d = xt.shape
    k = cfg.num_experts_per_tok
    E = cfg.num_experts
    C = moe_capacity(cfg, t)
    with trace.span("moe.dispatch"):
        # slot layout: slot i covers token i//k, choice i%k
        sid = topi.reshape(t * k)  # expert id per slot
        onehot = F.one_hot(sid, E).to(torch.int32)  # (t*k, E)
        pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1  # 0-based position within expert
        keep = (pos >= 0) & (pos < C)
        # a kept slot's row of the flat (E*C, d) buffer; every dropped slot
        # goes to the spare row E*C
        row = torch.where(keep, sid * C + pos, torch.full_like(pos, E * C))
        slot_x = xt.unsqueeze(1).expand(t, k, d).reshape(t * k, d) * keep.unsqueeze(1).to(xt.dtype)
        flat = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device).index_put((row,), slot_x)
        # + 0.0: an assigned -0.0 reads +0.0, as the reference's 0 + x does
        buf = flat[: E * C].reshape(E, C, d) + 0.0

    with trace.span("moe.experts"):
        # expert FFN as batched products over the experts
        u = torch.bmm(buf, params["up"].to(buf.dtype))
        h = F.silu(torch.bmm(buf, params["gate"].to(buf.dtype))) * u if "gate" in params else relu2(u)
        y = torch.bmm(h, params["down"].to(buf.dtype))

    with trace.span("moe.combine"):
        y_flat = torch.cat([y.reshape(E * C, d), torch.zeros((1, d), dtype=y.dtype, device=y.device)])
        out_slots = y_flat[row] * topw.reshape(t * k, 1).to(y.dtype)
        return torch.sum(out_slots.reshape(t, k, d), dim=1)


# ----------------------------------------------------------------------------
# drop-free dispatch over the held experts
# ----------------------------------------------------------------------------


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``[offs[g-1], offs[g])`` of ``x`` (R, K) times ``w[g]`` (G, K,
    N) for each group g; the rows past ``offs[-1]`` are left unwritten
    (their values are undefined). bfloat16 on the card:
    ``torch._grouped_mm`` (one launch, the groups' sizes read on the card,
    its backward grouped products too; bit for bit on repeats); anything
    else: a plain loop of products over the groups (the sizes read on
    the host)."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=offs)
    lo, parts = 0, []
    for g, hi in enumerate(offs.tolist()):
        parts.append(torch.matmul(x[lo:hi], w[g]))
        lo = hi
    return torch.cat(parts + [x.new_zeros((x.shape[0] - lo, w.shape[-1]))])


class _Dispatch(torch.autograd.Function):
    """Rows ``xt[token]`` in sorted order; the backward reads each
    token-choice's row (the zero expert's for a choice not held here) and
    sums a token's k rows in order: gathers, no accumulation."""

    @staticmethod
    def forward(ctx, xt, token_of_row, row_of_slot, k: int):
        ctx.save_for_backward(row_of_slot)
        ctx.k = k
        return xt.index_select(0, token_of_row)

    @staticmethod
    def backward(ctx, g):
        (row_of_slot,) = ctx.saved_tensors
        gs = g.index_select(0, row_of_slot)
        return gs.reshape(-1, ctx.k, gs.shape[-1]).sum(dim=1), None, None, None


class _Combine(torch.autograd.Function):
    """Each token-choice's output row (t*k, d); the backward hands each
    sorted row its token-choice's gradient (rows past the held ones, which
    feed nothing that is read, get some choice's)."""

    @staticmethod
    def forward(ctx, ys, row_of_slot, slot_of_row):
        ctx.save_for_backward(slot_of_row)
        return ys.index_select(0, row_of_slot)

    @staticmethod
    def backward(ctx, g):
        (slot_of_row,) = ctx.saved_tensors
        return g.index_select(0, slot_of_row), None, None


def _with_zero_expert(w: torch.Tensor, dtype) -> torch.Tensor:
    """``w`` (H, ...) cast to ``dtype``, with an (H+1)-th expert of zeros."""
    out = torch.zeros((w.shape[0] + 1,) + tuple(w.shape[1:]), dtype=dtype, device=w.device)
    out[:-1] = w
    return out


def dropless_plan(topi: torch.Tensor, cfg: ArchConfig):
    """The sorted rows of the token-choices ``topi`` (t, k): ``(offs
    (H+1,) int32 group ends, token_of_row (R,), row_of_slot (t*k,),
    slot_of_row (R,))`` with R = t*k + 1. Group h < H holds the choices
    of held expert h in slot order; group H is the one row at
    ``offs[H-1]``, the zero expert's."""
    t, k = topi.shape
    H, lo = cfg.n_held(), cfg.experts_offset
    n = t * k
    local = topi.reshape(n) - lo
    held = (local >= 0) & (local < H)
    extra = torch.full((1,), H, dtype=local.dtype, device=local.device)
    key = torch.cat([torch.where(held, local, H), extra])
    skey, order = torch.sort(key, stable=True)  # order: row -> slot (slot n is the extra row)
    ends = torch.searchsorted(skey, torch.arange(H, dtype=skey.dtype, device=skey.device), right=True)
    offs = torch.cat([ends, ends[-1:] + 1]).to(torch.int32)
    row = torch.empty_like(order).scatter_(0, order, torch.arange(n + 1, device=order.device))
    row_of_slot = torch.where(held, row[:n], ends[-1])
    inside = order < n
    token_of_row = torch.where(inside, torch.div(order, k, rounding_mode="floor"), 0)
    slot_of_row = torch.where(inside, order, 0)
    return offs, token_of_row, row_of_slot, slot_of_row


def experts_dropless(params: dict, xt: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor,
                     cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The held experts' part of the output for every token-choice routed
    to them: ``(out (t, d), group ends (H+1,) int32)``."""
    t, d = xt.shape
    k = cfg.num_experts_per_tok
    with trace.span("moe.dispatch"):
        offs, token_of_row, row_of_slot, slot_of_row = dropless_plan(topi, cfg)
        xs = _Dispatch.apply(xt, token_of_row, row_of_slot, k)
    with trace.span("moe.experts"):
        dt = xt.dtype
        u = grouped_mm(xs, _with_zero_expert(params["up"], dt), offs)
        if "gate" in params:
            h = F.silu(grouped_mm(xs, _with_zero_expert(params["gate"], dt), offs)) * u
        else:
            h = relu2(u)
        ys = grouped_mm(h, _with_zero_expert(params["down"], dt), offs)
    with trace.span("moe.combine"):
        y = _Combine.apply(ys, row_of_slot, slot_of_row) * topw.reshape(t * k, 1).to(dt)
        out = torch.sum(y.reshape(t, k, d), dim=1)
    return out, offs


def moe_layer(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """Returns ``(out (b,s,d), aux (), stats)``: the router's balance loss
    (f32), and for drop-free dispatch ``stats = (load (E,) or None, group
    ends (H+1,))``, else None. The router runs in f32."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    with trace.span("moe.route"):
        topw, topi, aux, load = router(params, xt, b, cfg)
    if cfg.moe_dispatch == "dropless":
        out, offs = experts_dropless(params, xt, topw, topi, cfg)
        stats = (load, offs)
    else:
        out, stats = experts_capacity(params, xt, topw, topi, cfg), None
    if "shared" in params:
        with trace.span("moe.shared"):
            out = out + apply_mlp(params["shared"], xt, cfg.expert_act)
    return out.reshape(b, s, d), aux, stats


def apply_moe(params: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (b,s,d), aux_loss ()). Router runs in f32."""
    out, aux, _ = moe_layer(params, x, cfg)
    return out, aux


def router_bias_step_(bias: torch.Tensor, load: torch.Tensor, rate: float) -> None:
    """DeepSeek-V3's auxiliary-loss-free balance, in place: ``b_i += rate
    * sign(mean load - load_i)`` over all E experts, from a step's loads
    (choices counted); ``bias`` and ``load`` (..., E)."""
    lf = load.to(torch.float32)
    bias.add_(torch.sign(torch.mean(lf, dim=-1, keepdim=True) - lf) * rate)
