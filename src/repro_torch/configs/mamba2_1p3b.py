"""Mamba2-1.3B — attention-free SSD (state-space duality)
[arXiv:2405.21060]. 48 layers, d_model=2048, state=128."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    supports_long_decode=True,
    citation="arXiv:2405.21060",
)
