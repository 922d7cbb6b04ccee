"""Grok-1 314B — MoE, 8 experts top-2 [hf:xai-org/grok-1]."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,              # dense path unused (all layers MoE)
    moe_d_ff=32768,
    vocab=131072,
    num_experts=8,
    num_experts_per_tok=2,
    citation="hf:xai-org/grok-1",
)
