"""InternLM2-20B — dense GQA [arXiv:2403.17297]."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    arch_type="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    rope_theta=1_000_000.0,
    citation="arXiv:2403.17297",
)
