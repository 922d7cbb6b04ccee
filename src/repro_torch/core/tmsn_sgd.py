"""TMSN-SGD: the shared config and the simulator-fidelity oracle;
counterpart of ``src/repro/core/tmsn_sgd.py``.

The engine-hosted worker lives in :mod:`repro_torch.core.sgd_worker`.
What remains here:

  * :class:`TMSNSGDConfig` — the worker's knobs (``local_steps`` K, the
    certificate's ``ema`` and ``width_coef``);
  * :func:`make_oracle_round` / :func:`oracle_run` — a dense, delay-1,
    uniform-speed synchronous exchange built on any batched worker's own
    methods, mirroring the engine's round order exactly (deliver ->
    adopt -> segment -> broadcast-on-strict-improvement). Under that
    config the engine's in-flight buffer holds at most one round of
    messages, so carrying last round's (certs, models) between
    iterations IS the buffer. The port runs both eagerly with the same
    ops in the same order, so its engine equals its oracle bit for bit.

The reference's legacy barrier round (``make_tmsn_round``,
``init_tmsn_state``, ``tmsn_batch_specs``) serves only its launch and
dry-run tooling and waits for ROADMAP.md queue 1, items 16 and 17.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.protocol import accepts, improves
from repro_torch.core.worker import has_resample_hooks, tree_map


@dataclasses.dataclass(frozen=True)
class TMSNSGDConfig:
    local_steps: int = 8  # K — AdamW steps per segment
    ema: float = 0.9  # certificate estimator's EMA weight
    width_coef: float = 1.0  # certificate confidence-width multiplier


def make_oracle_round(worker: Any, eps: float = 0.0) -> Callable:
    """Returns ``round(state, bcast_certs, bcast_models) -> (state,
    certs, bcast_certs, bcast_models)`` — one synchronous round of the
    dense, delay-1, uniform-speed, no-failure protocol over ``worker``
    (any :class:`repro_torch.core.worker.BatchedTMSNWorker`).

    ``bcast_certs`` (W,) carries last round's broadcast certificates
    (+inf where a worker did not fire) and ``bcast_models`` the matching
    export. Stage order and tie-breaks mirror ``TMSNEngine._advance``:

      1. deliver: per-destination argmin over sources (self excluded,
         ties to the LOWEST source id), accept iff the incoming
         certificate beats the local one by more than ``eps``;
      2. adopt_batch — called unconditionally: the contract requires
         identity (at zero cost) where ``take`` is False, which is what
         makes the engine's skip of an all-False take bit-equal to this;
      3. resample (only if the worker defines the optional hooks),
         then one segment for every worker;
      4. broadcast on STRICT improvement of the certificate.
    """
    use_resample = has_resample_hooks(worker)

    def round_fn(state: Any, bcast_certs: torch.Tensor, bcast_models: Any):
        w = bcast_certs.shape[0]
        dst = torch.arange(w, device=bcast_certs.device)
        # --- 1. deliver last round's broadcasts (delay 1) ---------------
        cand = torch.where(dst.unsqueeze(1) == dst.unsqueeze(0), float("inf"), bcast_certs.unsqueeze(0))
        best_src = torch.argmin(cand, dim=1)  # first minimum: lowest src on ties
        best_cert = cand[dst, best_src]
        take = accepts(worker.certificates(state), best_cert, eps) & torch.isfinite(best_cert)
        in_models = tree_map(lambda a: a[best_src], bcast_models)
        # --- 2. adopt ----------------------------------------------------
        state, _ = worker.adopt_batch(state, in_models, best_cert, take)
        del in_models
        # --- 3. one segment per worker (all active: uniform speed) -------
        scan_mask = torch.ones((w,), dtype=torch.bool, device=bcast_certs.device)
        if use_resample:
            need = worker.needs_resample(state)
            if bool(need.any()):
                state, _ = worker.resample_round(state, need)
            scan_mask = ~need
        certs_pre = worker.certificates(state)
        state, _, fired = worker.scan_round(state, scan_mask)
        certs = worker.certificates(state)
        # --- 4. broadcast strict improvements ----------------------------
        improved = fired & improves(certs_pre, certs, 0.0) & scan_mask
        bcast_certs = torch.where(improved, certs, float("inf"))
        # non-improved rows of the export are dead payload (+inf certs,
        # never selected): the full export is the engine's snapshot ring
        return state, certs, bcast_certs, worker.export_models(state)

    return round_fn


@dataclasses.dataclass
class OracleResult:
    state: Any  # final batched worker state
    certs: np.ndarray  # (W,) final certificates
    history: np.ndarray  # (rounds, W) post-round certificates
    rounds: int


def oracle_run(
    worker: Any,
    n_workers: int,
    max_rounds: int,
    eps: float = 0.0,
    seed: int = 0,
    target_certificate: float | None = None,
) -> OracleResult:
    """Run :func:`make_oracle_round` from ``worker.init_batch`` until
    ``max_rounds`` or any certificate crosses ``target_certificate``
    (float32 compare, matching the engine's stop)."""
    state = worker.init_batch(n_workers, seed)
    certs0 = worker.certificates(state)
    bcast_certs = torch.full((n_workers,), float("inf"), dtype=torch.float32, device=certs0.device)
    bcast_models = worker.export_models(state)
    round_fn = make_oracle_round(worker, eps)
    history = []
    rounds = 0
    for _ in range(max_rounds):
        state, certs, bcast_certs, bcast_models = round_fn(state, bcast_certs, bcast_models)
        history.append(certs.cpu().numpy())
        rounds += 1
        if target_certificate is not None and bool(np.any(history[-1] <= np.float32(target_certificate))):
            break
    final = worker.certificates(state).cpu().numpy()
    return OracleResult(state=state, certs=final, history=np.stack(history), rounds=rounds)
