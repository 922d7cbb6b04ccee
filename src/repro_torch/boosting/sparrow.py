"""Sparrow worker configuration and shared setup (paper §4); the part of
``src/repro/boosting/sparrow.py`` the batched worker needs.

Each worker owns a subset of the features (feature-based
parallelization), keeps the full "disk" dataset as a shared read-only
reference, maintains an in-memory weighted sample of size ``m``, and
alternates between Scanning and Sampling.

Cost model (simulated seconds = cost units / worker speed):
    cost = examples_touched + STUMP_EVAL_COST * incremental_stump_evals

The unbatched ``SparrowWorker`` of the reference (the event simulator's
worker) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.boosting.sampler import minimal_variance_sample
from repro_torch.boosting.scanner import SampleState, ScannerConfig
from repro_torch.boosting.stumps import StumpModel
from repro_torch.device import resolve_device

STUMP_EVAL_COST = 0.1  # relative cost of one incremental stump eval vs one example read


def feature_ownership_masks(d: int, n_workers: int, redundancy: int = 1) -> np.ndarray:
    """(n_workers, d) bool ownership masks: feature j belongs to workers
    {j mod k, ..., j mod k + r - 1}."""
    k = n_workers
    r = max(1, min(redundancy, k))
    fmod = np.arange(d) % k
    masks = np.zeros((k, d), bool)
    for wid in range(k):
        for j in range(r):
            masks[wid] |= fmod == ((wid + j) % k)
    return masks


def draw_sample(
    u0,
    disk_xb: torch.Tensor,
    disk_y: torch.Tensor,
    model: StumpModel,
    disk_margin: torch.Tensor,
    sample_size: int,
) -> SampleState:
    """Draw a fresh in-memory sample of ONE worker from the disk set,
    with the uniform offset ``u0`` of its minimal-variance pick. Returns
    unbatched leaves ``(m, ...)``."""
    w = torch.exp(torch.clamp(-disk_y * disk_margin, -30.0, 30.0))
    idx = minimal_variance_sample(u0, w, sample_size).long()
    margin = disk_margin[idx]
    return SampleState(
        xb=disk_xb[idx],
        y=disk_y[idx],
        margin_s=margin,
        margin_l=margin,
        t_l=model.count.to(torch.int32).expand(sample_size).clone(),
    )


@dataclasses.dataclass(frozen=True)
class SparrowConfig:
    sample_size: int = 8192  # m — in-memory sample size
    capacity: int = 256  # strong-rule capacity T_max
    scanner: ScannerConfig = ScannerConfig()
    ess_threshold: float = 0.1  # resample when n_eff/m drops below this
    keep_gamma_on_fire: bool = True  # False = paper pseudocode (reset to gamma0)
    n_workers: int = 1  # for feature ownership
    #: kept for config parity with the reference, which does not read it
    #: either; the scanner's ``ScannerConfig.use_kernel`` picks the route
    use_kernel: bool = False
    #: each feature owned by r workers
    ownership_redundancy: int = 1
    #: scan-chunk cost is scaled by mem_read_cost; the Sampler's full
    #: pass is charged disk_read_cost per example
    mem_read_cost: float = 1.0
    disk_read_cost: float = 1.0
    #: run the Sampler overlapped with scanning: it only blocks for the
    #: part of the disk pass not covered by scan time since the last one
    parallel_sampler: bool = False


class SparrowWorkerBase:
    """Disk-set / config setup shared by the Sparrow workers: dtype
    coercion, device placement, sample-size validation and the
    feature-ownership table."""

    def __init__(
        self,
        disk_xb: torch.Tensor,
        disk_y: torch.Tensor,
        config: SparrowConfig,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.xb = torch.as_tensor(disk_xb).to(device=self.device, dtype=torch.int32).contiguous()
        self.y = torch.as_tensor(disk_y).to(device=self.device, dtype=torch.float32).contiguous()
        self.n, self.d = self.xb.shape
        self.config = config
        if config.sample_size > self.n:
            raise ValueError("sample_size exceeds dataset size")
        self._feat_masks = torch.as_tensor(
            feature_ownership_masks(self.d, config.n_workers, config.ownership_redundancy),
            device=self.device,
        )

    def feature_mask(self, worker_id: int) -> torch.Tensor:
        return self._feat_masks[worker_id]
