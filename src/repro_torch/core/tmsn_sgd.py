"""TMSN-SGD: the shared config, the simulator-fidelity oracle and the
legacy barrier round; counterpart of ``src/repro/core/tmsn_sgd.py``.

The engine-hosted worker lives in :mod:`repro_torch.core.sgd_worker`.
What remains here:

  * :class:`TMSNSGDConfig` — the knobs both paths share (``local_steps``
    K, the certificate's ``ema`` and ``width_coef``); ``num_workers``,
    ``eps`` and ``unroll`` feed only the legacy round (the engines own W
    and the acceptance gate);
  * :func:`make_oracle_round` / :func:`oracle_run` — a dense, delay-1,
    uniform-speed synchronous exchange built on any batched worker's own
    methods, mirroring the engine's round order exactly (deliver ->
    adopt -> segment -> broadcast-on-strict-improvement). Under that
    config the engine's in-flight buffer holds at most one round of
    messages, so carrying last round's (certs, models) between
    iterations IS the buffer. The port runs both eagerly with the same
    ops in the same order, so its engine equals its oracle bit for bit;
  * the legacy barrier round (:func:`make_tmsn_round`,
    :func:`init_tmsn_state`, :func:`tmsn_batch_specs`) — every worker
    takes K AdamW steps, then all adopt the best certificate by more
    than eps at once. It serves the training launch
    (``launch/train.py --tmsn``) and the dry-run's cost of one round
    (``launch/dryrun.py --tmsn``): one parameter broadcast over the
    worker axis in place of K gradient all-reduces.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.protocol import accepts, improves
from repro_torch.core.worker import has_resample_hooks, tree_map
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, apply_updates_, init_opt_state
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class TMSNSGDConfig:
    local_steps: int = 8  # K — AdamW steps per segment
    ema: float = 0.9  # certificate estimator's EMA weight
    width_coef: float = 1.0  # certificate confidence-width multiplier
    num_workers: int = 16  # W of the legacy round (the engines own theirs)
    eps: float = 0.0  # the legacy round's protocol gap on the certificate
    # the reference unrolls the legacy round's K-step scan for its cost
    # analysis; the port's eager loop has nothing to unroll
    unroll: bool = False


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


# ---------------------------------------------------------------------------
# the legacy barrier round
# ---------------------------------------------------------------------------


def make_tmsn_round(cfg: ArchConfig, opt_cfg: AdamWConfig, tcfg: TMSNSGDConfig) -> Callable:
    """Returns ``round(params_w, opt_w, cert_w, batch_w) -> (params_w,
    opt_w, cert_w, mean_loss)``; every tree carries a leading W (worker)
    axis and ``batch_w``'s leaves are ``(W, K, local_batch, ...)``.

    Worker ``w`` takes K AdamW steps in order on ``batch_w[w, k]`` (the
    loss's gradients by autograd; the step written into the worker's rows
    of ``params_w`` and ``opt_w``, which come back updated in place, as the
    reference donates them). Then, with the K pre-step losses: certificate
    ``ema * cert + (1 - ema) * (mean + width_coef * std / sqrt(K))`` (the
    population std), the first minimum wins, and a worker adopts when the
    winner's certificate beats its own by more than ``eps``: its params
    and its whole optimizer state (``step`` too) become the winner's and
    its certificate the winner's."""

    def tmsn_round(params_w, opt_w, cert_w, batch_w):
        n_w = cert_w.shape[0]
        losses = []
        for w in range(n_w):
            params = tree_map(lambda a: a[w], params_w)
            opt = {"mu": tree_map(lambda a: a[w], opt_w["mu"]), "nu": tree_map(lambda a: a[w], opt_w["nu"]),
                   "step": opt_w["step"][w]}
            for k in range(tcfg.local_steps):
                batch = tree_map(lambda a: a[w, k], batch_w)
                leaves = tree_map(lambda a: a.detach().requires_grad_(True), params)
                with torch.enable_grad():
                    loss, _ = loss_fn(leaves, cfg, batch)
                    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
                grads = tree_map(lambda _: next(grads), leaves)
                with torch.no_grad():
                    apply_updates_(params, grads, opt, opt_cfg)
                losses.append(loss.detach())
        losses_w = torch.stack(losses).reshape(n_w, tcfg.local_steps)
        # certificate: loss EMA + concentration width over the K steps
        mean_w = torch.mean(losses_w, dim=1)
        k = torch.full((), tcfg.local_steps, dtype=torch.float32, device=cert_w.device)
        width = tcfg.width_coef * torch.std(losses_w, dim=1, correction=0) / torch.sqrt(k)
        cert_new = tcfg.ema * cert_w + (1.0 - tcfg.ema) * (mean_w + width)
        best = torch.argmin(cert_new)  # first minimum, as jnp.argmin
        best_cert = cert_new[best]
        adopt = best_cert < cert_new - tcfg.eps  # strict improvement by more than eps
        rows = torch.nonzero(adopt).flatten()
        if rows.numel():
            with torch.no_grad():
                for a in tree_leaves((params_w, opt_w)):
                    a[rows] = a[best].clone()
        cert_w = torch.where(adopt, best_cert, cert_new)
        return params_w, opt_w, cert_w, torch.mean(losses_w)

    return tmsn_round


def init_tmsn_state(
    cfg: ArchConfig, opt_cfg: AdamWConfig, tcfg: TMSNSGDConfig, generator: torch.Generator | int = 0,
    device="cuda", params: Any = None,
) -> tuple[Any, dict, torch.Tensor]:
    """``(params_w, opt_w, cert_w)`` with the leading W axis. Workers
    start from the SAME initial model (paper §2: all workers start from
    H_0), drawn from ``generator`` on ``device``, or ``params`` when given
    (say the reference's, converted); divergence comes from their
    independent batches. Certificates start at the finite sentinel 1e9
    (an inf would poison the EMA)."""
    if params is None:
        params = init_params(cfg, generator, device)
    opt = init_opt_state(params, opt_cfg)
    n_w = tcfg.num_workers
    stack = lambda a: a.unsqueeze(0).expand((n_w,) + tuple(a.shape)).clone()
    params_w = tree_map(stack, params)
    opt_w = tree_map(stack, opt)
    dev = tree_leaves(params)[0].device
    return params_w, opt_w, torch.full((n_w,), 1e9, dtype=torch.float32, device=dev)


def tmsn_batch_specs(cfg: ArchConfig, tcfg: TMSNSGDConfig, seq: int, global_batch: int) -> dict:
    """Meta tensors for one round's batches: (W, K, b_local, ...)."""
    n_w, k = tcfg.num_workers, tcfg.local_steps
    b_local = max(global_batch // n_w, 1)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    spec = {
        "tokens": meta((n_w, k, b_local, seq), torch.int32),
        "labels": meta((n_w, k, b_local, seq), torch.int32),
        "mask": meta((n_w, k, b_local, seq), torch.float32),
    }
    if cfg.frontend is not None:
        spec["frontend_embeds"] = meta((n_w, k, b_local, cfg.frontend_len, cfg.frontend_dim), torch.float32)
    return spec
