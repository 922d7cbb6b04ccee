"""Grouped-query attention (optionally sliding-window), full-sequence and
single-token decode; counterpart of the GQA half of
``src/repro/models/attention.py``. MLA and cross-attention wait for
ROADMAP.md queue 1, item 14.

All shapes: x (b, s, d); caches are (b, S_max, K, hd). The decode-path
``pos`` write index is either a () scalar (batch decodes in lockstep)
or a (b,) vector (continuous batching: each row at its own depth). A
scalar is broadcast to (b,), so scalar-pos decode is the per-row write
with every row at the same position, bit for bit.

Attention is the reference's two products around a masked float32
softmax (``_sdpa``), not a fused library kernel, so that the port and
the reference compute the same steps.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, init_linear, rope_freqs

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
    qg = q.reshape(b, s, K, G, hd)
    mask = _causal_window_mask(positions, positions, window)
    out = _sdpa(qg, k, v, mask, hd ** -0.5).reshape(b, s, H * hd)
    out = torch.matmul(out, params["wo"].to(x.dtype))
    return out, (k, v)


def ring_positions(pos_b: torch.Tensor, size: int) -> torch.Tensor:
    """(b,) current positions -> (b, size) absolute position held by each
    ring slot: the largest p <= pos with p % size == slot (negative where
    the slot was never written)."""
    slot = torch.arange(size, dtype=torch.int32, device=pos_b.device)
    p = pos_b.unsqueeze(1)
    return p - torch.remainder(p - slot.unsqueeze(0), size)


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
    # a Python int is filled on the device (a host-to-device copy of it
    # would wait for the card)
    pos_b = (torch.full((b,), pos, dtype=torch.int32, device=x.device) if isinstance(pos, int)
             else pos.to(torch.int32).expand(b))
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
