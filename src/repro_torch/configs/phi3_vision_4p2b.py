"""Phi-3-vision-4.2B — phi3-mini LM backbone + CLIP vision frontend
(STUB per assignment: patch embeddings spliced into the first
frontend_len positions) [hf:microsoft/Phi-3-vision-128k-instruct]."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    frontend="vision",
    frontend_len=576,        # 24x24 CLIP patches
    frontend_dim=1024,       # CLIP-L feature dim
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
)
