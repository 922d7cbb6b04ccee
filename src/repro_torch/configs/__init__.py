"""System configurations: the paper's Sparrow config and the registry of
model architectures; counterpart of ``src/repro/configs/__init__.py``.

``get_config(arch_id)`` / ``reduced(cfg)`` / ``all_configs()`` as in the
reference. The port carries every family of ``ARCH_IDS``: dense, MoE
with MLA and MTP, SSM, hybrid, sliding-window, enc-dec (whisper's
encoder and cross-attention) and VLM (phi-3-vision's spliced patches).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "yi_9b",
    "starcoder2_7b",
    "whisper_large_v3",
    "internlm2_20b",
    "zamba2_1p2b",
    "deepseek_v3_671b",
    "gemma3_12b",
    "mamba2_1p3b",
    "phi3_vision_4p2b",
    "grok1_314b",
]

#: the architectures whose every layer the port has: all of them
PORTED_ARCH_IDS = tuple(ARCH_IDS)

_ALIASES = {
    "yi-9b": "yi_9b",
    "starcoder2-7b": "starcoder2_7b",
    "whisper-large-v3": "whisper_large_v3",
    "internlm2-20b": "internlm2_20b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "gemma3-12b": "gemma3_12b",
    "mamba2-1.3b": "mamba2_1p3b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "grok-1-314b": "grok1_314b",
}


def get_config(arch_id: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    """Every ported architecture's config."""
    return {a: get_config(a) for a in PORTED_ARCH_IDS}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512,
    <=4 experts, tiny vocab — runs a CPU forward/train step."""
    kw: dict = dict(
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 0,
        d_ff=512,
        vocab=512,
        head_dim=64 if cfg.head_dim else None,
        frontend_len=min(cfg.frontend_len, 16),
        frontend_dim=min(cfg.frontend_dim, 32) if cfg.frontend_dim else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
    if cfg.num_experts:
        kw.update(
            num_experts=4,
            num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
            moe_d_ff=128,
            first_k_dense=min(cfg.first_k_dense, 1),
            num_shared_experts=min(cfg.num_shared_experts, 1),
        )
    if cfg.attention == "mla":
        kw.update(
            q_lora_rank=64, kv_lora_rank=64, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32,
        )
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.arch_type == "hybrid":
        kw.update(shared_attn_every=1, num_layers=2)
    if cfg.local_ratio:
        kw.update(local_ratio=1, sliding_window=32, num_layers=2)
    if cfg.is_encdec():
        kw.update(encoder_layers=2)
    return dataclasses.replace(cfg, **kw)
