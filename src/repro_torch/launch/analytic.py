"""First-principles FLOP / byte models per (arch x input shape); a copy
of ``src/repro/launch/analytic.py`` (framework-neutral arithmetic) over
the port's own ``models.config`` and ``models.ssm.ssm_dims``, line for
line, so the two give the same floats.

Used for the compute and memory roofline terms. (XLA's cost_analysis
under-counts scanned programs — loop bodies are counted once — and its
"bytes accessed" metric is fusion-noise; collectives, by contrast, are
measured exactly from the HLO via trip-count weighting in the
reference's hlo_analysis.py; the port derives them from the sharding
plan, launch/dryrun.py. The analytic side is standard napkin-math roofline
practice: param traffic + dominant materialized intermediates.)

All results are GLOBAL (whole step, all chips); the dry-run divides by
chip count for per-device terms.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, LayerSpec, encoder_segments, layer_segments
from repro_torch.models.ssm import ssm_dims


@dataclasses.dataclass
class Counts:
    flops: float = 0.0  # forward flops, global
    act_bytes: float = 0.0  # materialized intermediates (fwd), global


def _attn_layer(cfg: ArchConfig, spec: LayerSpec, b: int, s: int, s_ctx: float, cb: int) -> Counts:
    d = cfg.d_model
    hd = cfg.hd()
    H, K = cfg.num_heads, max(cfg.num_kv_heads, 1)
    T = b * s
    if cfg.attention == "mla":
        r, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        nd, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
        proj = 2 * d * cfg.q_lora_rank + 2 * cfg.q_lora_rank * H * (nd + rd)
        proj += 2 * d * (r + rd) + 2 * H * nd * r + 2 * H * r * vd + 2 * H * vd * d
        attn = 2 * s_ctx * H * (r + rd) + 2 * s_ctx * H * r
        act = T * (H * (nd + rd) + r + rd + H * r + H * vd) * cb + b * H * s * s_ctx * 4
    else:
        proj = 2 * d * (2 * H * hd + 2 * K * hd)
        attn = 4 * s_ctx * H * hd
        act = T * (H + 2 * K) * hd * cb + b * H * s * s_ctx * 4  # qkv + f32 scores
    mlp_mats = 3 if cfg.mlp_gated else 2
    mlp = 2 * d * cfg.d_ff * mlp_mats
    act += T * cfg.d_ff * (2 if cfg.mlp_gated else 1) * cb + T * d * 4 * cb
    f = T * (proj + attn + mlp)
    if spec.cross_attention:
        f += T * (2 * d * H * hd * 2) + T * 2 * cfg.frontend_len * H * hd * 2
        act += b * H * s * cfg.frontend_len * 4
    return Counts(flops=f, act_bytes=act)


def _moe_layer(cfg: ArchConfig, spec: LayerSpec, b: int, s: int, s_ctx: float, cb: int) -> Counts:
    base = _attn_layer(cfg, LayerSpec(kind="attn"), b, s, s_ctx, cb)
    d = cfg.d_model
    fe = cfg.expert_ff()
    T = b * s
    k = cfg.num_experts_per_tok
    # subtract the dense MLP counted by _attn_layer, add router + experts
    mlp_mats = 3 if cfg.mlp_gated else 2
    base.flops -= T * 2 * d * cfg.d_ff * mlp_mats
    base.act_bytes -= T * cfg.d_ff * (2 if cfg.mlp_gated else 1) * cb
    cap_mult = cfg.capacity_factor
    base.flops += T * (2 * d * cfg.num_experts)  # router
    base.flops += T * k * cap_mult * 2 * d * fe * 3  # routed experts (padded capacity)
    base.flops += cfg.num_shared_experts * T * 2 * d * fe * 3
    base.act_bytes += T * k * cap_mult * (d + 2 * fe) * cb  # dispatch buf + hidden
    return base


def _ssm_layer(cfg: ArchConfig, b: int, s: int, cb: int) -> Counts:
    d = cfg.d_model
    di, H, P, N = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, s)
    T = b * s
    proj = 2 * d * (2 * di + 2 * N + H) + 2 * di * d
    ssd = 2 * Q * N + 2 * Q * H * P + 4 * H * N * P  # intra G, intra y, states x2
    f = T * (proj + ssd)
    # dominant intermediates: the (b, nc, Q, Q, H) decay/gate tensors (f32)
    nc = max(s // Q, 1)
    act = 3 * b * nc * Q * Q * H * 4 + T * (2 * di + 2 * N + H) * cb + T * di * cb
    return Counts(flops=f, act_bytes=act)


def _layer_counts(cfg: ArchConfig, spec: LayerSpec, b: int, s: int, s_ctx_full: float, cb: int) -> Counts:
    if spec.kind == "ssm":
        return _ssm_layer(cfg, b, s, cb)
    s_ctx = min(spec.window, s_ctx_full * 2) if spec.window else s_ctx_full
    if spec.kind == "moe":
        return _moe_layer(cfg, spec, b, s, s_ctx, cb)
    return _attn_layer(cfg, spec, b, s, s_ctx, cb)


def step_counts(cfg: ArchConfig, shape: tuple[int, int, str], n_params: int) -> dict:
    """Global FLOPs and bytes for one step of the given kind.

    Returns dict(flops, weight_bytes, act_bytes, cache_bytes).
    """
    seq, gb, kind = shape
    pb = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    cb = {"float32": 4, "bfloat16": 2}[cfg.compute_dtype]
    if kind == "decode":
        b, s = gb, 1
        s_ctx = float(seq)  # attend over the whole cache
    elif kind == "prefill":
        b, s = gb, seq
        s_ctx = seq / 2.0  # causal average
    else:
        b, s = gb, seq
        s_ctx = seq / 2.0

    total = Counts()
    for unit, reps in layer_segments(cfg):
        for spec in unit:
            lspec = LayerSpec(kind="attn") if spec.kind == "shared_attn" else spec
            c = _layer_counts(cfg, lspec, b, s, s_ctx, cb)
            total.flops += c.flops * reps
            total.act_bytes += c.act_bytes * reps
    for unit, reps in encoder_segments(cfg):
        fl = cfg.frontend_len
        c = _attn_layer(cfg, LayerSpec(kind="attn"), b, fl, fl / 2.0, cb)
        total.flops += c.flops * reps
        total.act_bytes += c.act_bytes * reps
    # embedding + logits
    total.flops += b * s * 2 * cfg.d_model * cfg.vocab
    total.act_bytes += b * s * cfg.vocab * 4
    if cfg.mtp_depth and kind == "train":
        total.flops += b * s * (2 * cfg.d_model * cfg.d_model + 2 * cfg.d_model * cfg.vocab)
        total.act_bytes += b * s * cfg.vocab * 4

    if kind == "train":
        # fwd + backward(2x) + remat recompute (1x fwd)
        mult = 4.0 if cfg.remat else 3.0
        flops = total.flops * mult
        act_traffic = total.act_bytes * 3.0  # write fwd, read bwd, recompute
        # params: read fwd + read bwd + optimizer read/write + moments
        ob = 2 if cfg.num_experts >= 8 and cfg.d_model >= 6000 else 4
        weight_bytes = n_params * (4 * pb + 4 * ob)
        cache_bytes = 0.0
    else:
        flops = total.flops
        act_traffic = total.act_bytes
        weight_bytes = n_params * pb
        cache_bytes = 0.0
        if kind == "decode":
            cache_bytes = _decode_cache_bytes(cfg, gb, seq, cb)
    return {
        "flops": flops,
        "weight_bytes": float(weight_bytes),
        "act_bytes": act_traffic,
        "cache_bytes": cache_bytes,
    }


def _decode_cache_bytes(cfg: ArchConfig, b: int, max_len: int, cb: int) -> float:
    """Bytes read from KV caches / SSM states for ONE decode step."""
    total = 0.0
    hd = cfg.hd()
    for unit, reps in layer_segments(cfg):
        for spec in unit:
            if spec.kind == "ssm":
                di, H, P, N = ssm_dims(cfg)
                total += reps * b * H * N * P * 4 * 2  # state read+write
                continue
            s_read = min(spec.window, max_len) if spec.window else max_len
            if cfg.attention == "mla":
                total += reps * b * s_read * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * cb
            else:
                total += reps * b * s_read * cfg.num_kv_heads * hd * 2 * cb
            if spec.cross_attention:
                total += reps * b * cfg.frontend_len * cfg.num_kv_heads * hd * 2 * cb
    return total
