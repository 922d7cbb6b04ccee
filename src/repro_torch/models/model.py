"""Top-level model API: init_params / loss_fn / prefill / decode_step;
counterpart of ``src/repro/models/model.py`` for the whole zoo:
decoder-only models (dense, MoE, SSM, hybrid, sliding-window; DeepSeek's
MTP head), enc-dec (whisper: the encoder consumes stub frontend
embeddings, the decoder cross-attends) and VLM (phi-3-vision: stub patch
embeddings, projected, replace the first ``frontend_len`` positions'
token embeddings, so the global (b, s) shape does not change).

The parameters are a plain dict whose tree mirrors the reference's,
``{"embed", "final_norm", "decoder": [[layer dict stacked over
repeats, or None at a shared_attn position]], "lm_head",
"shared_attn", "encoder", "enc_norm", "frontend_proj", "mtp_head"}``
(no ``lm_head`` with tied embeddings, ``shared_attn`` for hybrids only,
``encoder`` and ``enc_norm`` for enc-dec, ``frontend_proj`` with a
frontend, ``mtp_head`` with ``mtp_depth``), so the round engine carries
it as a stacked ``(W, ...)`` pytree and :mod:`repro_torch.convert` maps
it leaf for leaf.

The encoder is causal, as the reference's is: it runs the decoder's
``gqa_full`` (``src/repro/models/model.py:104``), and the port keeps
that so that the two agree.

MTP is the reference's simplified multi-token prediction: a projection
of the trunk's last hidden state predicts token t+2 through the shared
head, averaged into the loss at weight 0.3 (DeepSeek-V3's lambda).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves
from repro_torch.models.config import ArchConfig, encoder_segments, layer_segments, validate
from repro_torch.models.layers import (
    init_embedding,
    init_linear,
    init_rms_norm,
    rms_norm,
    softmax_cross_entropy,
)
from repro_torch.models.moe import router_bias_step_
from repro_torch.models.ssm import conv_channels, ssm_dims
from repro_torch.models.transformer import (
    decode_stack,
    forward_stack,
    init_segments,
    init_shared_attn,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator | int = 0, device="cuda") -> dict:
    """Random parameters at ``cfg.param_dtype``, drawn on ``device`` from
    ``generator`` (a ``torch.Generator`` on that device, or an int seed).
    ``device="meta"`` builds the shapes only and touches no memory."""
    validate(cfg)
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
    if cfg.arch_type == "hybrid" and not cfg.layer_pattern:  # Zamba2's
        params["shared_attn"] = init_shared_attn(generator, cfg, dtype, dev)
    if cfg.is_encdec():
        params["encoder"] = init_segments(generator, encoder_segments(cfg), cfg, dtype, dev)
        params["enc_norm"] = init_rms_norm(cfg.d_model, dtype, dev)
    if cfg.frontend is not None:
        params["frontend_proj"] = init_linear(generator, cfg.frontend_dim, cfg.d_model, dtype, dev)
    if cfg.mtp_depth:
        params["mtp_head"] = init_linear(generator, cfg.d_model, cfg.d_model, dtype, dev)
    return params


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# ----------------------------------------------------------------------------
# embedding / frontend splicing / encoder / logits
# ----------------------------------------------------------------------------


def _frontend(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The stub frontend embeddings (b, frontend_len, frontend_dim),
    projected to (b, frontend_len, d_model) in the compute dtype."""
    cdt = dtype_of(cfg.compute_dtype)
    return torch.matmul(batch["frontend_embeds"].to(cdt), params["frontend_proj"].to(cdt))


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor, batch: dict | None = None) -> torch.Tensor:
    # F.embedding, not advanced indexing: its CUDA backward sorts the
    # indices and sums each row in a fixed order, where indexing's
    # accumulating index_put_ would add with atomics (bits vary run to run)
    x = F.embedding(tokens.to(torch.int64), params["embed"]).to(dtype_of(cfg.compute_dtype))
    if cfg.frontend == "vision" and batch is not None and "frontend_embeds" in batch:
        proj = _frontend(params, cfg, batch)
        b, s = tokens.shape
        f = proj.shape[1]
        if f < s:  # the patches, then zeros (masked out below)
            proj = torch.cat([proj, proj.new_zeros((b, s - f, cfg.d_model))], dim=1)
        else:  # a prompt shorter than the patches keeps the first s
            proj = proj[:, :s]
        is_patch = (torch.arange(s, device=x.device) < f)[None, :, None]
        x = torch.where(is_patch, proj, x)
    return x


def _encode(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Whisper-style encoder over the stub audio frame embeddings; causal,
    as the reference's (see the module doc)."""
    x = _frontend(params, cfg, batch)
    x, _, _ = forward_stack(params["encoder"], encoder_segments(cfg), cfg, x, _positions(x))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


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
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


# ----------------------------------------------------------------------------
# training loss
# ----------------------------------------------------------------------------


def loss_fn(params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """The mean next-token loss plus the routers' balance losses; its
    metrics, and with drop-free MoE layers and the sigmoid router
    ``expert_load`` (n_moe_layers, E) int64, each layer's choices of each
    expert, which :func:`state_step_` reads."""
    tokens, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
    x = _embed(params, cfg, tokens, batch)
    enc_out = _encode(params, cfg, batch) if cfg.is_encdec() else None
    stats = [] if cfg.num_experts and cfg.moe_dispatch == "dropless" else None
    x, aux, _ = forward_stack(params["decoder"], layer_segments(cfg), cfg, x, _positions(tokens),
                              shared_params=params.get("shared_attn"), enc_out=enc_out, moe_stats=stats)
    loss = softmax_cross_entropy(_logits(params, cfg, x), labels, mask)
    metrics = {"ce_loss": loss, "aux_loss": aux}
    if stats:
        loads = [load for load, _ in stats if load is not None]
        if loads:
            metrics["expert_load"] = torch.stack(loads)
        if trace.enabled():
            _count_rows(stats, cfg)
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


def _count_rows(stats: list, cfg: ArchConfig) -> None:
    """The tracer's device counters of the drop-free MoE layers (summed
    over layers and steps): ``moe.rows`` the token-choices each held
    expert computed, ``moe.rows_max`` the most one held expert computed in
    one layer, ``moe.dropped`` the choices routed to a held expert and not
    computed."""
    H, lo = cfg.n_held(), cfg.experts_offset
    ends = torch.stack([offs[:H] for _, offs in stats]).to(torch.int64)  # (layers, H)
    rows = torch.diff(ends, dim=1, prepend=torch.zeros_like(ends[:, :1]))
    trace.count_device("moe.rows", torch.sum(rows, dim=0))
    trace.count_device("moe.rows_max", torch.amax(rows), reduce="max")
    loads = [load for load, _ in stats if load is not None]
    if len(loads) == len(stats):
        routed = torch.sum(torch.stack(loads)[:, lo:lo + H])
        trace.count_device("moe.dropped", routed - torch.sum(ends[:, -1]))


def trained(path: tuple) -> bool:
    """Whether the leaf at ``path`` is trained by the optimizer: every one
    but the routers' selection bias, which is state that
    :func:`state_step_` sets (it gets no moments and no decay)."""
    return not path or str(path[-1]) != "router_bias"


def state_step_(params, cfg: ArchConfig, metrics: dict) -> None:
    """After an optimizer step, in place: each sigmoid router's selection
    bias from the step's loads (``metrics["expert_load"]`` of
    :func:`loss_fn`), at ``router_bias_rate``. Nothing without it."""
    if not cfg.router_bias_rate or "expert_load" not in metrics:
        return
    loads = metrics["expert_load"]
    with trace.span("moe.bias"):
        i = 0
        for (unit, reps), seg in zip(layer_segments(cfg), params["decoder"]):
            at = [j for j, spec in enumerate(unit) if spec.kind == "moe"]
            if not at:
                continue
            # forward_stack's order: repeat by repeat, unit position by position
            block = loads[i:i + reps * len(at)].reshape(reps, len(at), -1)
            for m, j in enumerate(at):
                router_bias_step_(seg[j]["moe"]["router_bias"], block[:, m], cfg.router_bias_rate)
            i += reps * len(at)


# ----------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ----------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda", enc_len: int = 0) -> list:
    """Zeroed decode caches matching the decode_stack layout: per
    segment, per unit position, a pair stacked over repeats: (k, v) of
    shape (reps, batch, S, K, hd) for GQA, (c_kv, k_rope) of shape
    (reps, batch, S, kv_lora_rank) and (reps, batch, S, qk_rope_head_dim)
    for MLA, both in the compute dtype; for SSD the float32 state (reps,
    batch, H, N, P) and the conv tail (reps, batch, conv_width - 1,
    conv channels) in the compute dtype; nothing (an empty entry) for a
    block of the MoE alone. A sliding-window layer gets a
    ring of its window's size under ``cfg.windowed_cache``. A
    cross-attention layer's entry adds the encoder side's (k, v) of
    shape (reps, batch, enc_len, K, hd)."""
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
                            zeros(reps, batch, cfg.ssm_conv_width - 1, conv_channels(cfg))))
            elif spec.mixer_only and spec.kind == "moe":
                seg.append(())
            elif cfg.attention == "mla":
                seg.append((zeros(reps, batch, max_len, cfg.kv_lora_rank),
                            zeros(reps, batch, max_len, cfg.qk_rope_head_dim)))
            else:
                s_buf = max_len
                if cfg.windowed_cache and spec.window:
                    s_buf = min(spec.window, max_len)
                entry = (zeros(reps, batch, s_buf, cfg.num_kv_heads, cfg.hd()),
                         zeros(reps, batch, s_buf, cfg.num_kv_heads, cfg.hd()))
                if spec.cross_attention:
                    entry += (zeros(reps, batch, enc_len, cfg.num_kv_heads, cfg.hd()),
                              zeros(reps, batch, enc_len, cfg.num_kv_heads, cfg.hd()))
                seg.append(entry)
        caches.append(tuple(seg))
    return caches


def prefill(params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, list]:
    """Process the prompt; returns (last-position logits, prefill caches
    sized to the prompt — the serving layer re-buffers into max_len)."""
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens, batch)
    enc_out = _encode(params, cfg, batch) if cfg.is_encdec() else None
    x, _, caches = forward_stack(params["decoder"], layer_segments(cfg), cfg, x, _positions(tokens),
                                 shared_params=params.get("shared_attn"), enc_out=enc_out,
                                 collect_cache=True)
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
