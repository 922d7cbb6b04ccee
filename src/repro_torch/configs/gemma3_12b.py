"""Gemma3-12B — dense GQA with 5:1 local(sliding-window):global
attention, 128k context [hf:google/gemma-3-1b-pt family]."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    arch_type="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=256,
    sliding_window=1024,
    local_ratio=5,           # 5 local : 1 global
    rope_theta=1_000_000.0,
    supports_long_decode=True,   # local layers are windowed; global
                                 # layers decode one token vs cache (linear)
    citation="hf:google/gemma-3-1b-pt",
)
