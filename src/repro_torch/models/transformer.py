"""Blocks and segment stacks of the dense decoder; counterpart of
``src/repro/models/transformer.py``.

A *segment* is a repeating unit of layers applied ``repeats`` times over
parameters stacked on a leading ``(repeats,)`` axis, as in the
reference; the port loops over the repeats where the reference scans
(``lax.scan``). ``cfg.remat`` maps to ``torch.utils.checkpoint`` around
each repeat of the unit (the reference's ``jax.checkpoint`` of the scan
body): the backward recomputes the same ops, so the bits do not change.

Dense attention layers only: ``moe``, ``ssm``, ``shared_attn``,
cross-attention and MLA raise until ROADMAP.md queue 1, item 14.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models.layers import apply_mlp, init_mlp, init_rms_norm, rms_norm


def check_dense(spec: LayerSpec, cfg: ArchConfig) -> None:
    """Raise for every layer the port does not carry yet."""
    if spec.kind != "attn" or spec.cross_attention or cfg.attention != "gqa":
        what = "cross_attention" if spec.cross_attention else (
            spec.kind if spec.kind != "attn" else f"attention={cfg.attention!r}")
        raise NotImplementedError(
            f"layer {what} is not ported yet (ROADMAP item 14); the port has dense GQA layers"
        )


# ----------------------------------------------------------------------------
# per-layer init and apply
# ----------------------------------------------------------------------------


def init_layer(generator, spec: LayerSpec, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    """One layer's params; ``lead`` prepends the segment's repeats axis."""
    check_dense(spec, cfg)
    return {
        "ln1": init_rms_norm(cfg.d_model, dtype, device, lead),
        "attn": attn.init_gqa(generator, cfg, dtype, device, lead),
        "ln2": init_rms_norm(cfg.d_model, dtype, device, lead),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, gated=cfg.mlp_gated, device=device,
                        lead=lead),
    }


def apply_layer_full(p: dict, spec: LayerSpec, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """Returns (x', (k, v))."""
    check_dense(spec, cfg)
    h, cache = attn.gqa_full(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), positions, cfg,
                             window=spec.window)
    x = x + h
    return x + apply_mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps)), cache


def apply_layer_decode(p: dict, spec: LayerSpec, cfg: ArchConfig, x: torch.Tensor, cache: tuple, pos):
    check_dense(spec, cfg)
    ck, cv = cache
    h, ck, cv = attn.gqa_decode(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), ck, cv, pos, cfg,
                                window=spec.window)
    x = x + h
    return x + apply_mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps)), (ck, cv)


# ----------------------------------------------------------------------------
# segment machinery
# ----------------------------------------------------------------------------


def init_segments(generator, segments: list[tuple[list[LayerSpec], int]], cfg: ArchConfig, dtype,
                  device="cpu") -> list[list[Any]]:
    """Per segment: a list over unit positions of param trees stacked
    over repeats (leading axis)."""
    return [[init_layer(generator, spec, cfg, dtype, device, lead=(reps,)) for spec in unit]
            for unit, reps in segments]


def _unstack(tree: Any, reps: int) -> list:
    """A dict tree of ``(reps, ...)`` leaves -> ``reps`` trees of slices
    (``unbind``, whose backward stacks the slices' grads)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(reps)]
    return list(tree.unbind(0))


def _unit_full(unit, cfg, layer_params, x, positions):
    caches = []
    for spec, p in zip(unit, layer_params):
        x, cache = apply_layer_full(p, spec, cfg, x, positions)
        caches.append(cache)
    return x, tuple(caches)


def forward_stack(
    params_segments: list,
    segments: list[tuple[list[LayerSpec], int]],
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    collect_cache: bool = False,
):
    """Full-sequence pass over all segments. Returns (x, aux_total,
    caches): ``aux_total`` is the routers' auxiliary loss (a float32 zero:
    dense layers have none); ``caches`` per segment a tuple over unit
    positions of (k, v) stacked over repeats, or None entries when
    ``collect_cache`` is False."""
    caches = []
    for (unit, reps), seg_params in zip(segments, params_segments):
        per_pos = [_unstack(p, reps) for p in seg_params]
        seg_caches = []
        for r in range(reps):
            layer_params = [pp[r] for pp in per_pos]
            if cfg.remat and torch.is_grad_enabled():
                x, cache = checkpoint(_unit_full, unit, cfg, layer_params, x, positions, use_reentrant=False)
            else:
                x, cache = _unit_full(unit, cfg, layer_params, x, positions)
            seg_caches.append(cache)
        if collect_cache:
            caches.append(tuple(
                tuple(torch.stack([c[li][j] for c in seg_caches]) for j in range(2))
                for li in range(len(unit))
            ))
        else:
            caches.append(tuple(None for _ in unit))
    return x, torch.zeros((), dtype=torch.float32, device=x.device), caches


def decode_stack(
    params_segments: list,
    segments: list[tuple[list[LayerSpec], int]],
    cfg: ArchConfig,
    x: torch.Tensor,
    caches: list,
    pos,
):
    new_caches = []
    for (unit, reps), seg_params, seg_cache in zip(segments, params_segments, caches):
        per_pos = [_unstack(p, reps) for p in seg_params]
        outs = [[None] * reps for _ in unit]
        for r in range(reps):
            for li, spec in enumerate(unit):
                ck, cv = seg_cache[li]
                x, outs[li][r] = apply_layer_decode(per_pos[li][r], spec, cfg, x, (ck[r], cv[r]), pos)
        new_caches.append(tuple(
            tuple(torch.stack([c[j] for c in outs[li]]) for j in range(2)) for li in range(len(unit))
        ))
    return x, new_caches
