"""Decoder-only LMs (dense, MoE with MLA and MTP, Mamba2 SSD, the Zamba2
hybrid, sliding-window stacks); counterpart of ``src/repro/models``.

Plain functions over a parameter dict: ``init_params(cfg, generator,
device)`` builds it, ``loss_fn`` / ``prefill`` / ``decode_step`` apply
it. Layer stacks loop over parameters stacked per segment, as the
reference scans them.
"""

from repro_torch.models.config import ArchConfig, LayerSpec, layer_segments
from repro_torch.models.model import (
    init_params,
    loss_fn,
    prefill,
    decode_step,
    init_cache,
    param_count,
)

__all__ = [
    "ArchConfig",
    "LayerSpec",
    "layer_segments",
    "init_params",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_cache",
    "param_count",
]
