"""StarCoder2-7B — dense GQA, RoPE [arXiv:2402.19173]."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    mlp_gated=False,
    rope_theta=1_000_000.0,
    citation="arXiv:2402.19173",
)
