"""Step functions and input specs; counterpart of ``src/repro/launch/steps.py``.

The reference's ``jax.ShapeDtypeStruct`` stand-ins are tensors on the
``meta`` device here: shapes and dtypes, no memory. The step factories
return plain functions over the port's parameter trees; the reference
jits them, the port runs them eagerly (``torch.no_grad`` outside
training).

Sampling takes its randomness as an input, as everywhere in the port:
``jax.random.categorical(key, l / T)`` is ``argmax(gumbel(key) + l / T)``
(its ``replace=True`` branch), so the port's decode step takes the
``(b, padded_vocab)`` float32 Gumbel noise itself. A server draws it
(:class:`repro_torch.launch.serving.ContinuousServer`); a test can
inject the reference's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import decode_step, init_cache, loss_fn, prefill
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.tree import tree_leaves, tree_map

# The four assigned input shapes: name -> (seq_len, global_batch, kind)
INPUT_SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """Is this (arch, shape) pair runnable? (the long_500k skip rule)."""
    if shape_name == "long_500k" and not cfg.supports_long_decode:
        return False, (
            "pure full-attention decode at 524288 tokens is quadratic-"
            "history/linear-per-token with an unsharded 500k KV per layer; "
            "skipped per assignment (no sliding-window/SSM variant)"
        )
    return True, ""


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape_name: str) -> dict[str, torch.Tensor]:
    """Meta tensors for a training/prefill batch."""
    seq, gb, kind = INPUT_SHAPES[shape_name]
    spec = {
        "tokens": _meta((gb, seq), torch.int32),
        "labels": _meta((gb, seq), torch.int32),
        "mask": _meta((gb, seq), torch.float32),
    }
    if cfg.frontend is not None:
        spec["frontend_embeds"] = _meta((gb, cfg.frontend_len, cfg.frontend_dim), torch.float32)
    return spec


def decode_specs(cfg: ArchConfig, shape_name: str) -> dict[str, Any]:
    """Meta tensors for one decode step: token, caches, pos."""
    seq, gb, kind = INPUT_SHAPES[shape_name]
    assert kind == "decode"
    enc_len = cfg.frontend_len if cfg.is_encdec() else 0
    return {
        "token": _meta((gb, 1), torch.int32),
        "caches": init_cache(cfg, gb, seq, device="meta", enc_len=enc_len),
        "pos": _meta((), torch.int32),
    }


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradients by ``torch.autograd``, then the
    functional AdamW step (new trees; the inputs are not written)."""

    def train_step(params, opt_state, batch):
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, cfg, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        grads = tree_map(lambda _: next(grads), leaves)
        with torch.no_grad():
            params, opt_state = apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """``prefill_step(params, batch) -> (next_token (b, 1) int32, caches)``;
    ``batch["frontend_embeds"]`` feeds the encoder or the patch splice of
    a model with a frontend."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, caches = prefill(params, cfg, batch)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, caches

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """Legacy greedy decode step (params, token, caches, pos) — kept for
    the scalar-``pos`` lockstep loop the serving tests hold the server
    to. The caches come back as new tensors. The serving loop uses
    :func:`make_decode_step`."""

    @torch.no_grad()
    def serve_step(params, token, caches, pos):
        logits, caches = decode_step(params, cfg, token, caches, pos)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        return next_token, caches

    return serve_step


def make_decode_step(cfg: ArchConfig, greedy: bool = True, temperature: float = 1.0) -> Callable:
    """Decode-step factory with an explicit sampling policy.

    ``pos`` may be a () scalar (lockstep batch) or a (b,) per-slot
    vector (continuous batching: each row decodes at its own depth).
    The returned step takes ``(params, token, caches, pos, gumbel)``:
    greedy takes the argmax and ignores ``gumbel`` (``None`` will do);
    sampling takes ``argmax(gumbel + logits / temperature)`` over a
    ``(b, padded_vocab)`` float32 ``gumbel``, which is the reference's
    ``jax.random.categorical`` given that noise. The caches are written
    where they lie and come back as given: the reference's server
    donates them to this step."""
    if not greedy and not temperature > 0.0:
        raise ValueError(f"temperature must be > 0 for sampling, got {temperature}")

    @torch.no_grad()
    def step(params, token, caches, pos, gumbel):
        logits, caches = decode_step(params, cfg, token, caches, pos, in_place=True)
        last = logits[:, -1, :]
        if greedy:
            nxt = torch.argmax(last, dim=-1)
        else:
            nxt = torch.argmax(gumbel + last / temperature, dim=-1)
        return nxt[:, None].to(torch.int32), caches

    return step


def dryrun_cfg(cfg: ArchConfig) -> ArchConfig:
    """Numerics for the production lowering: bf16 params + bf16 compute
    (the reference's dry run; it also serves Yi-9B at full size here)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")


def opt_config_for(cfg: ArchConfig) -> AdamWConfig:
    # giants (many experts, wide): bf16 Adam moments
    big = cfg.num_experts >= 8 and cfg.d_model >= 6000
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")
