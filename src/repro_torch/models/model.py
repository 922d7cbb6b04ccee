"""Top-level model API: init_params / loss_fn / prefill / decode_step;
counterpart of ``src/repro/models/model.py`` for decoder-only dense
models.

The parameters are a plain dict whose tree mirrors the reference's,
``{"embed", "final_norm", "decoder": [[layer dict stacked over
repeats]], "lm_head"}`` (no ``lm_head`` with tied embeddings), so the
round engine carries it as a stacked ``(W, ...)`` pytree and
:mod:`repro_torch.convert` maps it leaf for leaf. Enc-dec models, modality
frontends and multi-token prediction raise until ROADMAP.md queue 1,
item 14.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves
from repro_torch.models.config import ArchConfig, layer_segments, validate
from repro_torch.models.layers import (
    init_embedding,
    init_linear,
    init_rms_norm,
    rms_norm,
    softmax_cross_entropy,
)
from repro_torch.models.transformer import check_dense, decode_stack, forward_stack, init_segments

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for every model feature the port does not carry yet."""
    for feature, on in (("frontend", cfg.frontend is not None), ("enc-dec", cfg.is_encdec()),
                        ("mtp_depth", bool(cfg.mtp_depth))):
        if on:
            raise NotImplementedError(f"{cfg.name}: {feature} is not ported yet (ROADMAP item 14)")
    for unit, _ in layer_segments(cfg):
        for spec in unit:
            check_dense(spec, cfg)


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator | int = 0, device="cuda") -> dict:
    """Random parameters at ``cfg.param_dtype``, drawn on ``device`` from
    ``generator`` (a ``torch.Generator`` on that device, or an int seed).
    ``device="meta"`` builds the shapes only and touches no memory."""
    validate(cfg)
    check_supported(cfg)
    dev = torch.device(device) if torch.device(device).type == "meta" else resolve_device(device)
    if isinstance(generator, int):
        seed = generator
        generator = None
        if dev.type != "meta":
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    params: dict[str, Any] = {
        "embed": init_embedding(generator, cfg.padded_vocab(), cfg.d_model, dtype, dev),
        "final_norm": init_rms_norm(cfg.d_model, dtype, dev),
        "decoder": init_segments(generator, layer_segments(cfg), cfg, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(generator, cfg.d_model, cfg.padded_vocab(), dtype, dev)
    return params


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# ----------------------------------------------------------------------------
# embedding / logits
# ----------------------------------------------------------------------------


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not advanced indexing: its CUDA backward sorts the
    # indices and sums each row in a fixed order, where indexing's
    # accumulating index_put_ would add with atomics (bits vary run to run)
    return F.embedding(tokens.to(torch.int64), params["embed"]).to(dtype_of(cfg.compute_dtype))


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head.to(x.dtype)).to(torch.float32)
    vp = cfg.padded_vocab()
    if vp != cfg.vocab:
        # mask padded columns so CE logsumexp and argmax are exact
        pad_mask = (torch.arange(vp, device=x.device) >= cfg.vocab).to(torch.float32) * -1e30
        logits = logits + pad_mask
    return logits


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


# ----------------------------------------------------------------------------
# training loss
# ----------------------------------------------------------------------------


def loss_fn(params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    x, aux, _ = forward_stack(params["decoder"], layer_segments(cfg), cfg, x, _positions(tokens))
    loss = softmax_cross_entropy(_logits(params, cfg, x), labels, mask)
    metrics = {"ce_loss": loss, "aux_loss": aux}
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# ----------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ----------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> list:
    """Zeroed decode caches matching the decode_stack layout: per
    segment, per unit position, (k, v) of shape (reps, batch, S, K, hd)
    in the compute dtype. A sliding-window layer gets a ring of its
    window's size under ``cfg.windowed_cache``."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    caches = []
    for unit, reps in layer_segments(cfg):
        seg = []
        for spec in unit:
            s_buf = max_len
            if cfg.windowed_cache and spec.window:
                s_buf = min(spec.window, max_len)
            shape = (reps, batch, s_buf, cfg.num_kv_heads, cfg.hd())
            seg.append((torch.zeros(shape, dtype=cdt, device=dev), torch.zeros(shape, dtype=cdt, device=dev)))
        caches.append(tuple(seg))
    return caches


def prefill(params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, list]:
    """Process the prompt; returns (last-position logits, prefill caches
    sized to the prompt — the serving layer re-buffers into max_len)."""
    tokens = batch["tokens"]
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    x, _, caches = forward_stack(params["decoder"], layer_segments(cfg), cfg, x, _positions(tokens),
                                 collect_cache=True)
    return _logits(params, cfg, x[:, -1:, :]), caches


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches: list, pos) -> tuple[torch.Tensor, list]:
    """One-token decode. token (b, 1) int; pos is the cache write index —
    a () int for lockstep batches, or a (b,) int tensor for continuous
    batching (each row at its own depth)."""
    x = _embed(params, cfg, token)
    x, caches = decode_stack(params["decoder"], layer_segments(cfg), cfg, x, caches, pos)
    return _logits(params, cfg, x), caches
