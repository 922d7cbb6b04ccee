"""Blocks and segment stacks of the decoder; counterpart of
``src/repro/models/transformer.py``.

A *segment* is a repeating unit of layers applied ``repeats`` times over
parameters stacked on a leading ``(repeats,)`` axis, as in the
reference; the port loops over the repeats where the reference scans
(``lax.scan``). ``cfg.remat`` maps to ``torch.utils.checkpoint`` around
each repeat of the unit (the reference's ``jax.checkpoint`` of the scan
body): the backward recomputes the same ops, so the bits do not change.

Layer kinds: GQA attention (sliding-window or full) and MLA, each with a
dense MLP or an MoE; Mamba2 SSD; and ``shared_attn`` (Zamba2), which
applies the one un-stacked ``shared_params`` block and still gets a
cache slot of its own for each application. A unit position of kind
``shared_attn`` holds ``None`` in the stacked parameters. Caches are a
pair per layer: (k, v) for GQA, (c_kv, k_rope) for MLA, (state, conv)
for SSD. Cross-attention (enc-dec) raises until ROADMAP.md queue 1,
item 14b.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.layers import apply_mlp, init_mlp, init_rms_norm, rms_norm
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.ssm import init_ssm, ssd_decode, ssd_full

#: how a ``shared_attn`` position applies the shared block
SHARED_SPEC = LayerSpec(kind="attn")


def check_layer(spec: LayerSpec) -> None:
    """Raise for the layers the port does not carry yet."""
    if spec.cross_attention:
        raise NotImplementedError("layer cross_attention is not ported yet (ROADMAP item 14b)")


def _is_mla(spec: LayerSpec, cfg: ArchConfig) -> bool:
    return cfg.attention == "mla" and spec.kind in ("attn", "moe")


# ----------------------------------------------------------------------------
# per-layer init and apply
# ----------------------------------------------------------------------------


def init_layer(generator, spec: LayerSpec, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    """One layer's params; ``lead`` prepends the segment's repeats axis."""
    check_layer(spec)
    if spec.kind == "ssm":
        return {"ln1": init_rms_norm(cfg.d_model, dtype, device, lead),
                "ssm": init_ssm(generator, cfg, dtype, device, lead)}
    init_attn = attn.init_mla if _is_mla(spec, cfg) else attn.init_gqa
    p: dict[str, Any] = {
        "ln1": init_rms_norm(cfg.d_model, dtype, device, lead),
        "attn": init_attn(generator, cfg, dtype, device, lead),
        "ln2": init_rms_norm(cfg.d_model, dtype, device, lead),
    }
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
    """The second half of a layer: (x', router aux)."""
    h_in = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.kind == "moe":
        h, aux = apply_moe(p["moe"], h_in, cfg)
        return x + h, aux
    return x + apply_mlp(p["mlp"], h_in), None


def apply_layer_full(p: dict, spec: LayerSpec, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """Returns (x', cache entry, aux); aux is None for a layer without a
    router."""
    check_layer(spec)
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "ssm":
        h, cache = ssd_full(p["ssm"], h_in, cfg)
        return x + h, cache, None
    if _is_mla(spec, cfg):
        h, cache = attn.mla_full(p["attn"], h_in, positions, cfg)
    else:
        h, cache = attn.gqa_full(p["attn"], h_in, positions, cfg, window=spec.window)
    x, aux = _ffn(p, spec, cfg, x + h)
    return x, cache, aux


def apply_layer_decode(p: dict, spec: LayerSpec, cfg: ArchConfig, x: torch.Tensor, cache: tuple, pos,
                       in_place: bool = False):
    """Returns (x', cache entry'). With ``in_place`` the entry's tensors
    are written (K/V and latents at their positions, SSD state and conv
    tail whole) and come back; by default new tensors (the same bits)."""
    check_layer(spec)
    c0, c1 = cache
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
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
    x, _ = _ffn(p, spec, cfg, x + h)
    return x, (c0, c1)


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


def _unit_full(unit, cfg, layer_params, shared_params, x, positions):
    """One repeat of a unit: (x', caches, aux summed over its routers in
    layer order, or None without a router)."""
    caches, aux = [], None
    for spec, p in zip(unit, layer_params):
        spec, p = _position(spec, p, shared_params)
        x, cache, a = apply_layer_full(p, spec, cfg, x, positions)
        if a is not None:
            aux = a if aux is None else aux + a
        caches.append(cache)
    return x, tuple(caches), aux


def _stack_caches(per_rep: list, n_pos: int) -> tuple:
    """Per repeat a tuple over unit positions of cache pairs -> per unit
    position the pair stacked over repeats."""
    return tuple(tuple(torch.stack([c[li][j] for c in per_rep]) for j in range(2)) for li in range(n_pos))


def forward_stack(
    params_segments: list,
    segments: list[tuple[list[LayerSpec], int]],
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    shared_params: dict | None = None,
    collect_cache: bool = False,
):
    """Full-sequence pass over all segments. Returns (x, aux_total,
    caches): ``aux_total`` is the routers' auxiliary loss summed over the
    layers in order (a float32 zero without a router); ``caches`` per
    segment a tuple over unit positions of cache pairs stacked over
    repeats, or None entries when ``collect_cache`` is False."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for (unit, reps), seg_params in zip(segments, params_segments):
        per_pos = [_unstack(p, reps) for p in seg_params]
        seg_caches = []
        for r in range(reps):
            layer_params = [pp[r] for pp in per_pos]
            if cfg.remat and torch.is_grad_enabled():
                x, cache, aux = checkpoint(_unit_full, unit, cfg, layer_params, shared_params, x, positions,
                                           use_reentrant=False)
            else:
                x, cache, aux = _unit_full(unit, cfg, layer_params, shared_params, x, positions)
            if aux is not None:
                aux_total = aux_total + aux
            seg_caches.append(cache)
        caches.append(_stack_caches(seg_caches, len(unit)) if collect_cache else tuple(None for _ in unit))
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
                c0, c1 = seg_cache[li]
                x, outs[li][r] = apply_layer_decode(p, spec, cfg, x, (c0[r], c1[r]), pos, in_place=in_place)
        if in_place:
            new_caches.append(seg_cache)
            continue
        new_caches.append(tuple(tuple(torch.stack([c[j] for c in outs[li]]) for j in range(2))
                                for li in range(len(unit))))
    return x, new_caches
