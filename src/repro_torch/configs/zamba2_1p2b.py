"""Zamba2-1.2B — hybrid: Mamba2 backbone + ONE weight-shared attention
block applied every 6 SSM layers [arXiv:2411.15242]. 38 Mamba2 layers,
shared block is MHA (32 heads, kv=32), d_ff=8192."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,           # ssm layers; shared attn applications extra
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,
    supports_long_decode=True,   # SSM state is O(1); attn KV grows but
                                 # only in the handful of shared blocks
    citation="arXiv:2411.15242",
)
