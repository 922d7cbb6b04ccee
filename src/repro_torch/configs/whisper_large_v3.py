"""Whisper-large-v3 — enc-dec audio; conv/mel frontend is a STUB per the
assignment (frontend embeddings of the right shape feed the encoder)
[arXiv:2212.04356]. 32 encoder + 32 decoder layers, MHA (kv=20)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    arch_type="audio",
    num_layers=32,           # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    mlp_gated=False,
    frontend="audio",
    frontend_len=1500,       # 30s of audio -> 1500 frames post-conv
    frontend_dim=128,        # stub mel/conv feature dim
    citation="arXiv:2212.04356",
)
