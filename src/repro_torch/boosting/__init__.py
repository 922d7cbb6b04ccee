"""Sparrow — TMSN applied to boosted decision stumps (paper §3-4) — plus
the baselines the paper compares against (XGBoost-like exact greedy,
LightGBM-like GOSS) and a synchronous AdaBoost reference; counterpart of
``src/repro/boosting``."""

from repro_torch.boosting.stumps import (
    StumpModel,
    empty_model,
    append_stump,
    predict_margin,
    predict_margin_delta,
    edge_histogram,
    edges_from_histogram,
    exp_loss,
    model_payload_bytes,
)
from repro_torch.boosting.scanner import ScannerConfig, ScannerState, init_scanner, scan_chunk
from repro_torch.boosting.sampler import minimal_variance_sample, rejection_sample
from repro_torch.boosting.sparrow import (
    SparrowConfig,
    SparrowWorker,
    SparrowState,
    draw_sample,
    feature_ownership_masks,
)
from repro_torch.boosting.batched_sparrow import BatchedSparrowState, BatchedSparrowWorker
from repro_torch.boosting.baselines import (
    BoosterConfig,
    train_exact_greedy,
    train_goss,
    train_adaboost_reference,
    BoostTrace,
)

__all__ = [
    "StumpModel",
    "empty_model",
    "append_stump",
    "predict_margin",
    "predict_margin_delta",
    "edge_histogram",
    "edges_from_histogram",
    "exp_loss",
    "model_payload_bytes",
    "ScannerConfig",
    "ScannerState",
    "init_scanner",
    "scan_chunk",
    "minimal_variance_sample",
    "rejection_sample",
    "SparrowConfig",
    "SparrowWorker",
    "SparrowState",
    "BatchedSparrowWorker",
    "BatchedSparrowState",
    "draw_sample",
    "feature_ownership_masks",
    "BoosterConfig",
    "train_exact_greedy",
    "train_goss",
    "train_adaboost_reference",
    "BoostTrace",
]
