"""Blocks and segment stacks of the decoder; counterpart of
``src/repro/models/transformer.py``.

A *segment* is a repeating unit of layers applied ``repeats`` times over
parameters stacked on a leading ``(repeats,)`` axis, as in the
reference; the port loops over the repeats where the reference scans
(``lax.scan``). ``cfg.remat`` maps to ``torch.utils.checkpoint`` around
each repeat of the unit (the reference's ``jax.checkpoint`` of the scan
body): the backward recomputes the same ops, so the bits do not change.

Layer kinds: GQA attention (sliding-window or full) and MLA, each with a
dense MLP or an MoE; Mamba2 SSD; ``shared_attn`` (Zamba2), which
applies the one un-stacked ``shared_params`` block and still gets a
cache slot of its own for each application; and Nemotron-H's
single-mixer blocks (``LayerSpec.mixer_only``), ``x + mixer(norm(x))``
with attention alone or the MoE alone (params ``ln1`` and ``attn`` or
``moe``; a MoE block's cache entry is empty). A unit position of kind
``shared_attn`` holds ``None`` in the stacked parameters. Caches are a
pair per layer: (k, v) for GQA, (c_kv, k_rope) for MLA, (state, conv)
for SSD; a decoder layer with cross-attention (enc-dec) appends the
encoder side's (k, v), computed once at prefill and read at every
decode step, so its entry is a 4-tuple.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.layers import apply_mlp, init_mlp, init_rms_norm, rms_norm
from repro_torch.models.moe import init_moe, moe_layer
from repro_torch.models.ssm import init_ssm, ssd_decode, ssd_full

#: how a ``shared_attn`` position applies the shared block
SHARED_SPEC = LayerSpec(kind="attn")


def _is_mla(spec: LayerSpec, cfg: ArchConfig) -> bool:
    return cfg.attention == "mla" and spec.kind in ("attn", "moe")


# ----------------------------------------------------------------------------
# per-layer init and apply
# ----------------------------------------------------------------------------


def init_layer(generator, spec: LayerSpec, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    """One layer's params; ``lead`` prepends the segment's repeats axis."""
    if spec.kind == "ssm":
        return {"ln1": init_rms_norm(cfg.d_model, dtype, device, lead),
                "ssm": init_ssm(generator, cfg, dtype, device, lead)}
    if spec.mixer_only and spec.kind == "moe":
        return {"ln1": init_rms_norm(cfg.d_model, dtype, device, lead),
                "moe": init_moe(generator, cfg, dtype, device, lead)}
    init_attn = attn.init_mla if _is_mla(spec, cfg) else attn.init_gqa
    p: dict[str, Any] = {
        "ln1": init_rms_norm(cfg.d_model, dtype, device, lead),
        "attn": init_attn(generator, cfg, dtype, device, lead),
    }
    if spec.cross_attention:
        p["ln_x"] = init_rms_norm(cfg.d_model, dtype, device, lead)
        p["cross"] = attn.init_cross(generator, cfg, dtype, device, lead)
    if spec.mixer_only:
        return p
    p["ln2"] = init_rms_norm(cfg.d_model, dtype, device, lead)
    if spec.kind == "moe":
        p["moe"] = init_moe(generator, cfg, dtype, device, lead)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, gated=cfg.mlp_gated, device=device,
                            lead=lead)
    return p


def init_shared_attn(generator, cfg: ArchConfig, dtype, device="cpu") -> dict:
    """Zamba2's single shared transformer block (not stacked)."""
    return init_layer(generator, SHARED_SPEC, cfg, dtype, device)


def _ffn(p: dict, spec: LayerSpec, cfg: ArchConfig, x: torch.Tensor):
    """The second half of a layer: (x', router aux, MoE stats); the aux
    is None without a router, the stats None but for drop-free dispatch
    (``moe.moe_layer``)."""
    h_in = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.kind == "moe":
        h, aux, stats = moe_layer(p["moe"], h_in, cfg)
        return x + h, aux, stats
    return x + apply_mlp(p["mlp"], h_in), None, None


def apply_layer_full(p: dict, spec: LayerSpec, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                     enc_out: torch.Tensor | None = None):
    """Returns (x', cache entry, aux, MoE stats); aux is None for a layer
    without a router, the stats None but for drop-free dispatch. A
    cross-attention layer attends to ``enc_out`` (the encoder's output)
    and appends its (k, v) to the entry."""
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "ssm":
        h, cache = ssd_full(p["ssm"], h_in, cfg)
        return x + h, cache, None, None
    if spec.mixer_only and spec.kind == "moe":
        h, aux, stats = moe_layer(p["moe"], h_in, cfg)
        return x + h, (), aux, stats
    if _is_mla(spec, cfg):
        h, cache = attn.mla_full(p["attn"], h_in, positions, cfg)
    else:
        h, cache = attn.gqa_full(p["attn"], h_in, positions, cfg, window=spec.window)
    x = x + h
    if spec.cross_attention:
        if enc_out is None:
            raise ValueError("a cross-attention layer needs the encoder's output")
        ck, cv = attn.cross_kv(p["cross"], enc_out, cfg)
        x = x + attn.cross_attend(p["cross"], rms_norm(x, p["ln_x"], cfg.norm_eps), ck, cv, cfg)
        cache = cache + (ck, cv)
    if spec.mixer_only:
        return x, cache, None, None
    x, aux, stats = _ffn(p, spec, cfg, x)
    return x, cache, aux, stats


def apply_layer_decode(p: dict, spec: LayerSpec, cfg: ArchConfig, x: torch.Tensor, cache: tuple, pos,
                       in_place: bool = False):
    """Returns (x', cache entry'). With ``in_place`` the entry's tensors
    are written (K/V and latents at their positions, SSD state and conv
    tail whole) and come back; by default new tensors (the same bits).
    A cross-attention layer's encoder K/V (``cache[2:]``) are read, never
    written, and come back as they are. A block of the MoE alone has an
    empty entry."""
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer_only and spec.kind == "moe":
        h, _, _ = moe_layer(p["moe"], h_in, cfg)
        return x + h, cache
    c0, c1 = cache[:2]
    if spec.kind == "ssm":
        h, state, conv = ssd_decode(p["ssm"], h_in, c0, c1, cfg)
        if in_place:
            c0.copy_(state)
            c1.copy_(conv)
            state, conv = c0, c1
        return x + h, (state, conv)
    if _is_mla(spec, cfg):
        h, c0, c1 = attn.mla_decode(p["attn"], h_in, c0, c1, pos, cfg, in_place=in_place)
    else:
        h, c0, c1 = attn.gqa_decode(p["attn"], h_in, c0, c1, pos, cfg, window=spec.window, in_place=in_place)
    x = x + h
    if spec.cross_attention:
        enc_k, enc_v = cache[2], cache[3]
        x = x + attn.cross_attend(p["cross"], rms_norm(x, p["ln_x"], cfg.norm_eps), enc_k, enc_v, cfg)
    if not spec.mixer_only:
        x, _, _ = _ffn(p, spec, cfg, x)
    return x, (c0, c1) + tuple(cache[2:])


# ----------------------------------------------------------------------------
# segment machinery
# ----------------------------------------------------------------------------


def init_segments(generator, segments: list[tuple[list[LayerSpec], int]], cfg: ArchConfig, dtype,
                  device="cpu") -> list[list[Any]]:
    """Per segment: a list over unit positions of param trees stacked
    over repeats (leading axis). ``shared_attn`` positions hold None
    (their weights live in params['shared_attn'])."""
    return [[None if spec.kind == "shared_attn"
             else init_layer(generator, spec, cfg, dtype, device, lead=(reps,)) for spec in unit]
            for unit, reps in segments]


def _unstack(tree: Any, reps: int) -> list:
    """A dict tree of ``(reps, ...)`` leaves -> ``reps`` trees of slices
    (``unbind``, whose backward stacks the slices' grads); None -> Nones."""
    if tree is None:
        return [None] * reps
    if isinstance(tree, dict):
        parts = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(reps)]
    return list(tree.unbind(0))


def _position(spec: LayerSpec, p: Any, shared_params: Any) -> tuple[LayerSpec, Any]:
    """The spec and params a unit position applies."""
    return (SHARED_SPEC, shared_params) if spec.kind == "shared_attn" else (spec, p)


def _unit_full(unit, cfg, layer_params, shared_params, x, positions, enc_out):
    """One repeat of a unit: (x', caches, aux summed over its routers in
    layer order, or None without a router, the drop-free MoE layers'
    stats in layer order)."""
    caches, aux, stats = [], None, []
    for spec, p in zip(unit, layer_params):
        spec, p = _position(spec, p, shared_params)
        x, cache, a, st = apply_layer_full(p, spec, cfg, x, positions, enc_out)
        if a is not None:
            aux = a if aux is None else aux + a
        if st is not None:
            stats.append(st)
        caches.append(cache)
    return x, tuple(caches), aux, tuple(stats)


def _stack_caches(per_rep: list) -> tuple:
    """Per repeat a tuple over unit positions of cache entries -> per unit
    position the entry (a pair, or a 4-tuple with cross K/V) stacked over
    repeats."""
    return tuple(tuple(torch.stack(parts) for parts in zip(*entries)) for entries in zip(*per_rep))


def forward_stack(
    params_segments: list,
    segments: list[tuple[list[LayerSpec], int]],
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    shared_params: dict | None = None,
    enc_out: torch.Tensor | None = None,
    collect_cache: bool = False,
    moe_stats: list | None = None,
):
    """Full-sequence pass over all segments. Returns (x, aux_total,
    caches): ``aux_total`` is the routers' auxiliary loss summed over the
    layers in order (a float32 zero without a router); ``caches`` per
    segment a tuple over unit positions of cache entries stacked over
    repeats, or None entries when ``collect_cache`` is False.
    Cross-attention layers attend to ``enc_out``. Each drop-free MoE
    layer's stats (load, group ends) are appended to ``moe_stats`` in
    layer order, once a pass (remat's recompute appends nothing)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for (unit, reps), seg_params in zip(segments, params_segments):
        per_pos = [_unstack(p, reps) for p in seg_params]
        seg_caches = []
        for r in range(reps):
            layer_params = [pp[r] for pp in per_pos]
            if cfg.remat and torch.is_grad_enabled():
                x, cache, aux, stats = checkpoint(_unit_full, unit, cfg, layer_params, shared_params, x,
                                                  positions, enc_out, use_reentrant=False)
            else:
                x, cache, aux, stats = _unit_full(unit, cfg, layer_params, shared_params, x, positions,
                                                  enc_out)
            if aux is not None:
                aux_total = aux_total + aux
            if moe_stats is not None:
                moe_stats.extend(stats)
            seg_caches.append(cache)
        caches.append(_stack_caches(seg_caches) if collect_cache else tuple(None for _ in unit))
    return x, aux_total, caches


def decode_stack(
    params_segments: list,
    segments: list[tuple[list[LayerSpec], int]],
    cfg: ArchConfig,
    x: torch.Tensor,
    caches: list,
    pos,
    shared_params: dict | None = None,
    in_place: bool = False,
):
    """One-token pass over all segments. By default the caches come back
    re-stacked as new tensors; with ``in_place`` each repeat's entry is
    written into its view of the stacked buffers and ``caches`` itself
    comes back (no copy of any cache; the same bits)."""
    new_caches = []
    for (unit, reps), seg_params, seg_cache in zip(segments, params_segments, caches):
        per_pos = [_unstack(p, reps) for p in seg_params]
        outs = [[None] * reps for _ in unit]
        for r in range(reps):
            for li, unit_spec in enumerate(unit):
                spec, p = _position(unit_spec, per_pos[li][r], shared_params)
                entry = tuple(c[r] for c in seg_cache[li])
                x, outs[li][r] = apply_layer_decode(p, spec, cfg, x, entry, pos, in_place=in_place)
        if in_place:
            new_caches.append(seg_cache)
            continue
        new_caches.append(tuple(tuple(torch.stack(parts) for parts in zip(*outs[li]))
                                for li in range(len(unit))))
    return x, new_caches
