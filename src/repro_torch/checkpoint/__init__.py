"""Checkpoints of the port's pytrees; counterpart of ``src/repro/checkpoint``."""

from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
