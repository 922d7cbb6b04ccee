"""Top-level model API: init_params / loss_fn / prefill / decode_step;
counterpart of ``src/repro/models/model.py`` for decoder-only models
(dense, MoE, SSM, hybrid, sliding-window; DeepSeek's MTP head).

The parameters are a plain dict whose tree mirrors the reference's,
``{"embed", "final_norm", "decoder": [[layer dict stacked over
repeats, or None at a shared_attn position]], "lm_head",
"shared_attn", "mtp_head"}`` (no ``lm_head`` with tied embeddings,
``shared_attn`` for hybrids only, ``mtp_head`` with ``mtp_depth``), so
the round engine carries it as a stacked ``(W, ...)`` pytree and
:mod:`repro_torch.convert` maps it leaf for leaf. Enc-dec models and
modality frontends raise until ROADMAP.md queue 1, item 14b.

MTP is the reference's simplified multi-token prediction: a projection
of the trunk's last hidden state predicts token t+2 through the shared
head, averaged into the loss at weight 0.3 (DeepSeek-V3's lambda).
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
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.transformer import (
    check_layer,
    decode_stack,
    forward_stack,
    init_segments,
    init_shared_attn,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for every model feature the port does not carry yet."""
    for feature, on in (("frontend", cfg.frontend is not None), ("enc-dec", cfg.is_encdec())):
        if on:
            raise NotImplementedError(f"{cfg.name}: {feature} is not ported yet (ROADMAP item 14b)")
    for unit, _ in layer_segments(cfg):
        for spec in unit:
            check_layer(spec)


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
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = init_shared_attn(generator, cfg, dtype, dev)
    if cfg.mtp_depth:
        params["mtp_head"] = init_linear(generator, cfg.d_model, cfg.d_model, dtype, dev)
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
    x, aux, _ = forward_stack(params["decoder"], layer_segments(cfg), cfg, x, _positions(tokens),
                              shared_params=params.get("shared_attn"))
    loss = softmax_cross_entropy(_logits(params, cfg, x), labels, mask)
    metrics = {"ce_loss": loss, "aux_loss": aux}
    if cfg.mtp_depth:
        # simplified multi-token prediction: predict t+2 from a projected
        # trunk state, at weight 0.3
        h2 = torch.matmul(x, params["mtp_head"].to(x.dtype))
        labels2 = torch.cat([labels[:, 1:], labels[:, :1]], dim=1)
        mask2 = torch.cat([mask[:, :-1], torch.zeros_like(mask[:, -1:])], dim=1)
        mtp = softmax_cross_entropy(_logits(params, cfg, h2), labels2, mask2)
        metrics["mtp_loss"] = mtp
        loss = loss + 0.3 * mtp
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# ----------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ----------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> list:
    """Zeroed decode caches matching the decode_stack layout: per
    segment, per unit position, a pair stacked over repeats: (k, v) of
    shape (reps, batch, S, K, hd) for GQA, (c_kv, k_rope) of shape
    (reps, batch, S, kv_lora_rank) and (reps, batch, S, qk_rope_head_dim)
    for MLA, both in the compute dtype; for SSD the float32 state (reps,
    batch, H, N, P) and the conv tail (reps, batch, conv_width - 1,
    conv channels) in the compute dtype. A sliding-window layer gets a
    ring of its window's size under ``cfg.windowed_cache``."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)

    def zeros(*shape, dtype=cdt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    caches = []
    for unit, reps in layer_segments(cfg):
        seg = []
        for spec in unit:
            if spec.kind == "ssm":
                d_inner, H, P, N = ssm_dims(cfg)
                seg.append((zeros(reps, batch, H, N, P, dtype=torch.float32),
                            zeros(reps, batch, cfg.ssm_conv_width - 1, d_inner + 2 * N)))
            elif cfg.attention == "mla":
                seg.append((zeros(reps, batch, max_len, cfg.kv_lora_rank),
                            zeros(reps, batch, max_len, cfg.qk_rope_head_dim)))
            else:
                s_buf = max_len
                if cfg.windowed_cache and spec.window:
                    s_buf = min(spec.window, max_len)
                seg.append((zeros(reps, batch, s_buf, cfg.num_kv_heads, cfg.hd()),
                            zeros(reps, batch, s_buf, cfg.num_kv_heads, cfg.hd())))
        caches.append(tuple(seg))
    return caches


def prefill(params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, list]:
    """Process the prompt; returns (last-position logits, prefill caches
    sized to the prompt — the serving layer re-buffers into max_len)."""
    tokens = batch["tokens"]
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    x, _, caches = forward_stack(params["decoder"], layer_segments(cfg), cfg, x, _positions(tokens),
                                 shared_params=params.get("shared_attn"), collect_cache=True)
    return _logits(params, cfg, x[:, -1:, :]), caches


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches: list, pos,
                in_place: bool = False) -> tuple[torch.Tensor, list]:
    """One-token decode. token (b, 1) int; pos is the cache write index —
    a () int for lockstep batches, or a (b,) int tensor for continuous
    batching (each row at its own depth). With ``in_place`` the caches
    are written where they lie and come back as given (the reference's
    server donates them); by default they come back as new tensors."""
    x = _embed(params, cfg, token)
    x, caches = decode_stack(params["decoder"], layer_segments(cfg), cfg, x, caches, pos,
                             shared_params=params.get("shared_attn"), in_place=in_place)
    return _logits(params, cfg, x), caches
