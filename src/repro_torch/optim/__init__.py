"""Optimizers and schedules; counterpart of ``src/repro/optim``."""

from repro_torch.optim.adamw import AdamWConfig, init_opt_state, apply_updates, apply_updates_
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "init_opt_state", "apply_updates", "apply_updates_", "warmup_cosine"]
