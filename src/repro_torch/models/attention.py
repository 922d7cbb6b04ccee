"""Grouped-query attention (optionally sliding-window), MLA (DeepSeek-V3
multi-head latent attention, compressed KV cache), full-sequence and
single-token decode, and the enc-dec decoder's cross-attention;
counterpart of ``src/repro/models/attention.py``.

All shapes: x (b, s, d); caches are (b, S_max, K, hd) for GQA and
(b, S_max, kv_lora_rank), (b, S_max, qk_rope_head_dim) for MLA;
cross-attention's K/V are (b, enc_len, K, hd), computed once from the
encoder's output at prefill and read whole at every decode step. The decode-path
``pos`` write index is either a () scalar (batch decodes in lockstep)
or a (b,) vector (continuous batching: each row at its own depth). A
scalar is broadcast to (b,), so scalar-pos decode is the per-row write
with every row at the same position, bit for bit.

Attention is the reference's two products around a masked float32
softmax (``_sdpa``, and MLA's absorbed form ``_mla_attend``), so that the
port and the reference compute the same steps, everywhere but in two
places: ``gqa_full`` on CUDA bf16 tensors at a head width K6 is built for
(``kernels.ops.ATTENTION_HEAD_DIMS``: 128) runs K6
(``kernels/csrc/attention.cu``), the same function with the scores kept
on the SM, its backward a kernel too (:class:`_K6`); and ``mla_full`` on
CUDA bf16 tensors at MLA's widths K6 holds (192 = 128 + 64 rotary, values
128: DeepSeek-V3's) up-projects the latent to each head's key and value
and runs K6 on them. K6 keeps the products in float32 where ``_sdpa``
rounds the scores to bf16 before the scale. CPU tensors, other widths and
dtypes, decode and cross-attention keep the plain forms. The tracer
counts each call by route (``attention_calls`` for ``gqa_full``,
``mla_attend_calls`` for ``mla_full`` and ``mla_decode``; sites
``kernel`` and ``plain``).
"""

from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _normal, apply_rope, init_linear, init_rms_norm, rms_norm, rope_freqs

NEG_INF = -1e30


def _causal_window_mask(qpos: torch.Tensor, kpos: torch.Tensor, window: int | None) -> torch.Tensor:
    """(.., sq, sk) boolean mask: kpos <= qpos (& within window)."""
    m = kpos.unsqueeze(-2) <= qpos.unsqueeze(-1)
    if window is not None:
        m = m & (kpos.unsqueeze(-2) > qpos.unsqueeze(-1) - window)
    return m


def _sdpa(q, k, v, mask, scale):
    """q (b,sq,K,G,h), k/v (b,sk,K,h), mask (b,sq,sk) -> (b,sq,K,G,h).
    Query head ``k*G + g`` reads KV head ``k`` (the reshape's grouping)."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    scores = torch.where(mask[:, None, None, :, :], scores.to(torch.float32), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


class _K6(torch.autograd.Function):
    """K6 as one autograd node: q (b, s, H, hd), k/v (b, s, K, hd), bf16,
    on the card -> (b, s, H, hd); its backward is K6's backward kernels,
    from the forward's output, log-sum-exp and tile bounds."""

    @staticmethod
    def forward(ctx, q, k, v, positions, window, scale):
        o, lse, bounds = ops.attention_fwd(q, k, v, positions, window, scale)
        ctx.save_for_backward(q, k, v, positions, o, lse, bounds)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, positions, o, lse, bounds = ctx.saved_tensors
        dq, dk, dv = ops.attention_bwd(q, k, v, positions, o, lse, bounds, do.contiguous(), ctx.window, ctx.scale)
        return dq, dk, dv, None, None, None


def _k6_holds(tensors: tuple, d_qk: int, d_v: int) -> bool:
    """K6 runs on what it was built for, as its input shows: CUDA bf16
    tensors, at head widths (qk, v) it holds."""
    return (tensors[0].is_cuda and all(t.dtype == torch.bfloat16 for t in tensors)
            and (d_qk, d_v) in ops.ATTENTION_HEAD_DIMS)


def _k6_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """K6 takes ``gqa_full``'s q, k, v (:func:`_k6_holds`)."""
    return _k6_holds((q, k, v), q.shape[-1], v.shape[-1])


def init_gqa(generator, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    hd = cfg.hd()
    return {
        "wq": init_linear(generator, cfg.d_model, cfg.num_heads * hd, dtype, device, lead),
        "wk": init_linear(generator, cfg.d_model, cfg.num_kv_heads * hd, dtype, device, lead),
        "wv": init_linear(generator, cfg.d_model, cfg.num_kv_heads * hd, dtype, device, lead),
        "wo": init_linear(generator, cfg.num_heads * hd, cfg.d_model, dtype, device, lead),
    }


def _gqa_qkv(params, x, positions, cfg: ArchConfig):
    b, s, _ = x.shape
    hd = cfg.hd()
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = torch.matmul(x, params["wq"].to(x.dtype)).reshape(b, s, H, hd)
    k = torch.matmul(x, params["wk"].to(x.dtype)).reshape(b, s, K, hd)
    v = torch.matmul(x, params["wv"].to(x.dtype)).reshape(b, s, K, hd)
    if cfg.rope:  # Nemotron-H's attention takes no positions
        cos, sin = rope_freqs(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def gqa_full(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ArchConfig,
    window: int | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal attention. Returns (out, (k, v)) — k/v are
    returned so prefill can seed the cache."""
    b, s, _ = x.shape
    hd = cfg.hd()
    H, K = cfg.num_heads, cfg.num_kv_heads
    G = H // K
    q, k, v = _gqa_qkv(params, x, positions, cfg)
    if _k6_takes(q, k, v):
        trace.count("attention_calls", 1, "kernel")
        out = _K6.apply(q, k, v, positions, window, hd ** -0.5)
    else:
        trace.count("attention_calls", 1, "plain")
        mask = _causal_window_mask(positions, positions, window)
        out = _sdpa(q.reshape(b, s, K, G, hd), k, v, mask, hd ** -0.5)
    out = torch.matmul(out.reshape(b, s, H * hd), params["wo"].to(x.dtype))
    return out, (k, v)


def ring_positions(pos_b: torch.Tensor, size: int) -> torch.Tensor:
    """(b,) current positions -> (b, size) absolute position held by each
    ring slot: the largest p <= pos with p % size == slot (negative where
    the slot was never written)."""
    slot = torch.arange(size, dtype=torch.int32, device=pos_b.device)
    p = pos_b.unsqueeze(1)
    return p - torch.remainder(p - slot.unsqueeze(0), size)


def _pos_rows(pos, b: int, device) -> torch.Tensor:
    """A () or (b,) write position -> (b,) int32. A Python int is filled
    on the device (a host-to-device copy of it would wait for the card)."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    return pos.to(torch.int32).expand(b)


def gqa_decode(
    params: dict,
    x: torch.Tensor,  # (b, 1, d)
    cache_k: torch.Tensor,  # (b, S, K, hd)
    cache_v: torch.Tensor,
    pos,  # () or (b,) int32 — current write position(s)
    cfg: ArchConfig,
    window: int | None = None,
    in_place: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache. Returns (out, k', v'): by
    default new tensors (the inputs are not written); with ``in_place``
    the new entries are written into ``cache_k``/``cache_v`` themselves,
    which come back (the counterpart of a donated cache). The bits are
    the same either way."""
    b = x.shape[0]
    hd = cfg.hd()
    H, K = cfg.num_heads, cfg.num_kv_heads
    G = H // K
    pos_b = _pos_rows(pos, b, x.device)
    positions = pos_b.unsqueeze(1)
    q, k_new, v_new = _gqa_qkv(params, x, positions, cfg)
    S = cache_k.shape[1]
    # ring-buffer mode: a windowed layer whose cache is sized below the
    # decode horizon writes at pos % S; keys carry their absolute-pos
    # RoPE phases so the ring is transparent to attention
    write_pos = torch.remainder(pos_b, S).long()
    rows = torch.arange(b, device=x.device)
    if in_place:
        cache_k.index_put_((rows, write_pos), k_new[:, 0].to(cache_k.dtype))
        cache_v.index_put_((rows, write_pos), v_new[:, 0].to(cache_v.dtype))
    else:
        cache_k = cache_k.index_put((rows, write_pos), k_new[:, 0].to(cache_k.dtype))
        cache_v = cache_v.index_put((rows, write_pos), v_new[:, 0].to(cache_v.dtype))
    kpos = ring_positions(pos_b, S)
    mask = _causal_window_mask(positions, kpos, window) & (kpos.unsqueeze(1) >= 0)
    qg = q.reshape(b, 1, K, G, hd)
    out = _sdpa(qg, cache_k.to(x.dtype), cache_v.to(x.dtype), mask, hd ** -0.5)
    out = out.reshape(b, 1, H * hd)
    out = torch.matmul(out, params["wo"].to(x.dtype))
    return out, cache_k, cache_v


# ----------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank Q, compressed latent KV cache, rope/nope split
# ----------------------------------------------------------------------------


def init_mla(generator, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    H = cfg.num_heads
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    p = {
        "wkv_a": init_linear(generator, cfg.d_model, r + cfg.qk_rope_head_dim, dtype, device, lead),
        "kv_norm": init_rms_norm(r, dtype, device, lead),
        # absorbed projections, stored per head
        "wkv_b_k": _normal(lead + (H, cfg.qk_nope_head_dim, r), r ** -0.5, dtype, generator, device),
        "wkv_b_v": _normal(lead + (H, r, cfg.v_head_dim), r ** -0.5, dtype, generator, device),
        "wo": init_linear(generator, H * cfg.v_head_dim, cfg.d_model, dtype, device, lead),
    }
    if cfg.q_lora_rank:
        p["wq_a"] = init_linear(generator, cfg.d_model, cfg.q_lora_rank, dtype, device, lead)
        p["q_norm"] = init_rms_norm(cfg.q_lora_rank, dtype, device, lead)
        p["wq_b"] = init_linear(generator, cfg.q_lora_rank, H * qk_dim, dtype, device, lead)
    else:
        p["wq"] = init_linear(generator, cfg.d_model, H * qk_dim, dtype, device, lead)
    return p


def _mla_q(params, x, positions, cfg: ArchConfig):
    """The query's two parts (b, s, H, nope) and (b, s, H, rope), the
    second rotated."""
    b, s, _ = x.shape
    H = cfg.num_heads
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        ql = torch.matmul(x, params["wq_a"].to(x.dtype))
        ql = rms_norm(ql, params["q_norm"], cfg.norm_eps)
        q = torch.matmul(ql, params["wq_b"].to(x.dtype))
    else:
        q = torch.matmul(x, params["wq"].to(x.dtype))
    q = q.reshape(b, s, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    cos, sin = rope_freqs(positions, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def _mla_absorb(params, q_nope, dtype):
    """The key up-projection absorbed into the query: its latent (b, s, H, r)."""
    return torch.einsum("bshn,hnr->bshr", q_nope, params["wkv_b_k"].to(dtype))


def _mla_kv_latent(params, x, positions, cfg: ArchConfig):
    rd = cfg.qk_rope_head_dim
    kv = torch.matmul(x, params["wkv_a"].to(x.dtype))
    c_kv, k_rope = kv[..., : cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    c_kv = rms_norm(c_kv, params["kv_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(positions, rd, cfg.rope_theta)
    k_rope = apply_rope(k_rope.unsqueeze(-2), cos, sin).squeeze(-2)  # one shared head
    return c_kv, k_rope


def _mla_attend(params, q_lat, q_rope, c_kv, k_rope, mask, cfg: ArchConfig, dtype):
    with trace.span("mla.attend"):
        scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
        scores = torch.einsum("bqhr,bsr->bhqs", q_lat, c_kv) + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope)
        scores = torch.where(mask[:, None, :, :], scores.to(torch.float32) * scale, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        out_lat = torch.einsum("bhqs,bsr->bqhr", probs, c_kv)
    v = torch.einsum("bqhr,hrv->bqhv", out_lat, params["wkv_b_v"].to(dtype))
    b, s = v.shape[0], v.shape[1]
    out = v.reshape(b, s, cfg.num_heads * cfg.v_head_dim)
    return torch.matmul(out, params["wo"].to(dtype))


def _mla_k6_takes(q_nope: torch.Tensor, q_rope: torch.Tensor, c_kv: torch.Tensor, wkv_b_v: torch.Tensor) -> bool:
    """K6 takes MLA expanded (:func:`_k6_holds`): keys nope + rope wide,
    values as wide as ``wkv_b_v``'s up-projection."""
    return _k6_holds((q_nope, q_rope, c_kv), q_nope.shape[-1] + q_rope.shape[-1], wkv_b_v.shape[-1])


def _mla_attend_k6(params, q_nope, q_rope, c_kv, k_rope, positions, cfg: ArchConfig, dtype):
    """MLA expanded into H heads of plain attention through K6: the latent
    up-projected to each head's key without position, beside the one
    rotary key, and to its value, in ``dtype``; then K6 over q (b, s, H,
    nope + rope), k (b, s, H, nope + rope), v (b, s, H, v), and ``wo``."""
    b, s, H, nd = q_nope.shape
    r, vd = c_kv.shape[-1], cfg.v_head_dim
    k_nope = torch.matmul(c_kv, params["wkv_b_k"].to(dtype).permute(2, 0, 1).reshape(r, H * nd)).view(b, s, H, nd)
    v = torch.matmul(c_kv, params["wkv_b_v"].to(dtype).permute(1, 0, 2).reshape(r, H * vd)).view(b, s, H, vd)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.unsqueeze(2).expand(b, s, H, k_rope.shape[-1])], -1)
    with trace.span("mla.attend"):
        out = _K6.apply(q, k, v, positions, None, (nd + q_rope.shape[-1]) ** -0.5)
    return torch.matmul(out.reshape(b, s, H * vd), params["wo"].to(dtype))


def mla_full(params: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ArchConfig) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal MLA. Returns (out, (c_kv, k_rope)): the latent
    cache entries, so prefill can seed the cache. Where K6 takes the input
    (:func:`_mla_k6_takes`) it attends expanded through K6
    (:func:`_mla_attend_k6`), else absorbed (:func:`_mla_attend`)."""
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_kv, k_rope = _mla_kv_latent(params, x, positions, cfg)
    if _mla_k6_takes(q_nope, q_rope, c_kv, params["wkv_b_v"]):
        trace.count("mla_attend_calls", 1, "kernel")
        out = _mla_attend_k6(params, q_nope, q_rope, c_kv, k_rope, positions, cfg, x.dtype)
    else:
        trace.count("mla_attend_calls", 1, "plain")
        mask = _causal_window_mask(positions, positions, None)
        out = _mla_attend(params, _mla_absorb(params, q_nope, x.dtype), q_rope, c_kv, k_rope, mask, cfg, x.dtype)
    return out, (c_kv, k_rope)


def mla_decode(
    params: dict,
    x: torch.Tensor,  # (b, 1, d)
    cache_ckv: torch.Tensor,  # (b, S, kv_lora_rank)
    cache_krope: torch.Tensor,  # (b, S, qk_rope_head_dim)
    pos,  # () or (b,) int32
    cfg: ArchConfig,
    in_place: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against the latent cache. Returns (out, c_kv',
    k_rope'): new tensors by default, or with ``in_place`` the caches
    themselves with the new entries written in (the same bits)."""
    b = x.shape[0]
    pos_b = _pos_rows(pos, b, x.device)
    positions = pos_b.unsqueeze(1)
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    q_lat = _mla_absorb(params, q_nope, x.dtype)
    c_new, r_new = _mla_kv_latent(params, x, positions, cfg)
    rows = torch.arange(b, device=x.device)
    idx = (rows, pos_b.long())
    if in_place:
        cache_ckv.index_put_(idx, c_new[:, 0].to(cache_ckv.dtype))
        cache_krope.index_put_(idx, r_new[:, 0].to(cache_krope.dtype))
    else:
        cache_ckv = cache_ckv.index_put(idx, c_new[:, 0].to(cache_ckv.dtype))
        cache_krope = cache_krope.index_put(idx, r_new[:, 0].to(cache_krope.dtype))
    S = cache_ckv.shape[1]
    kpos = torch.arange(S, dtype=torch.int32, device=x.device).expand(b, S)
    mask = _causal_window_mask(positions, kpos, None)
    trace.count("mla_attend_calls", 1, "plain")
    out = _mla_attend(params, q_lat, q_rope, cache_ckv.to(x.dtype), cache_krope.to(x.dtype), mask, cfg,
                      x.dtype)
    return out, cache_ckv, cache_krope


# ----------------------------------------------------------------------------
# Cross-attention (enc-dec decoder layers)
# ----------------------------------------------------------------------------


def init_cross(generator, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    return init_gqa(generator, cfg, dtype, device, lead)


def cross_kv(params: dict, enc: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder side's K/V (b, enc_len, K, hd), once a request
    (prefill); no RoPE, as in the reference."""
    b, s, _ = enc.shape
    hd = cfg.hd()
    K = cfg.num_kv_heads
    k = torch.matmul(enc, params["wk"].to(enc.dtype)).reshape(b, s, K, hd)
    v = torch.matmul(enc, params["wv"].to(enc.dtype)).reshape(b, s, K, hd)
    return k, v


def cross_attend(params: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Every decoder position attends to every encoder position."""
    b, s, _ = x.shape
    hd = cfg.hd()
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = torch.matmul(x, params["wq"].to(x.dtype)).reshape(b, s, K, H // K, hd)
    mask = torch.ones((b, s, k.shape[1]), dtype=torch.bool, device=x.device)  # full visibility of the encoder
    out = _sdpa(q, k.to(x.dtype), v.to(x.dtype), mask, hd ** -0.5).reshape(b, s, H * hd)
    return torch.matmul(out, params["wo"].to(x.dtype))
