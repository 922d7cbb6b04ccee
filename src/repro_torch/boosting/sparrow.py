"""A Sparrow worker (paper §4) for the event simulator, and the
configuration and setup it shares with the batched worker; counterpart
of ``src/repro/boosting/sparrow.py``.

Each worker owns a subset of the features (feature-based
parallelization), keeps the full "disk" dataset as a shared read-only
reference, maintains an in-memory weighted sample of size ``m``, and
alternates between Scanning and Sampling.

Certificates: the log-potential bound ``L_t = sum_k 1/2 log(1 - 4 g_k^2)``
over the certified edges ``g_k`` of the stumps in the strong rule, a
sound high-probability upper bound on ``log Z(H_t)`` (§4.2).

Cost model (simulated seconds = cost units / worker speed):
    cost = examples_touched + STUMP_EVAL_COST * incremental_stump_evals
A fresh sampling pass touches all n disk examples and pays the
incremental weight refresh on them too.

Randomness: as in the batched worker, worker state carries its stream id
and the number of uniform offsets drawn so far; draw ``j`` of stream
``s`` comes from ``uniforms(s, j)`` (see
:mod:`repro_torch.boosting.batched_sparrow`).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.boosting.sampler import GeneratorUniforms, minimal_variance_sample
from repro_torch.boosting.scanner import (
    SampleState,
    ScannerConfig,
    ScannerState,
    init_scanner,
    reset_after_fire,
    reset_after_fruitless_pass,
    scan_chunk,
)
from repro_torch.boosting.stumps import (
    StumpModel,
    alpha_from_gamma,
    append_stump,
    empty_model,
    model_payload_bytes,
    predict_margin_delta,
)
from repro_torch.core.ess import effective_sample_size
from repro_torch.core.worker import tree_map
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


class SparrowState(NamedTuple):
    """One worker's state: tensors on the worker's device, bookkeeping as
    Python numbers."""

    worker_id: int
    model: StumpModel  # fields (T,), count ()
    cert: float  # log-potential bound (lower = better)
    scanner: ScannerState  # leaves without the worker axis
    sample: SampleState  # leaves (m, ...)
    # disk-side lazy weight bookkeeping
    disk_margin: torch.Tensor  # (n,) f32
    disk_t: torch.Tensor  # (n,) i32
    stream: int  # random stream id (the reference's key seed)
    draws: int  # uniform offsets drawn so far
    needs_resample: bool
    pending_cost: float  # cost incurred by adopt (charged on next segment)
    fires: int
    resamples: int
    sample_model_count: int  # stump count when the current sample was drawn
    scan_since_resample: float = 0.0  # for the parallel-sampler overlap model


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


def _row(tree, i: int):
    """Row ``i`` of a stacked pytree."""
    return tree_map(lambda a: a[i], tree)


def _batch1(tree):
    return tree_map(lambda a: a.unsqueeze(0), tree)


def _ess_fraction(sample: SampleState, m: int) -> float:
    w = torch.exp(torch.clamp(-sample.y * (sample.margin_l - sample.margin_s), -30.0, 30.0))
    return float(effective_sample_size(w)) / m


class SparrowWorker(SparrowWorkerBase):
    """Implements :class:`repro_torch.core.worker.TMSNWorker` for Sparrow:
    one logical machine per state, driven by
    :class:`repro_torch.core.simulator.TMSNSimulator`.

    Args:
        disk_xb, disk_y: the shared disk set, ``(n, d)`` bins and ``(n,)``
            labels; moved to ``device``.
        config: :class:`SparrowConfig`.
        device: ``"cuda"`` by default; raises without a card unless
            ``"cpu"`` is given.
        uniforms: ``uniforms(stream, draw) -> u0`` source of the
            minimal-variance offsets; :class:`GeneratorUniforms` if None.

    The chunk scan is the batched :func:`scan_chunk` with a worker axis of
    1, so with ``ScannerConfig.use_kernel`` each scan segment is one
    launch of kernel K1. The disk refresh of a resample stays on
    :func:`predict_margin_delta`, as in the reference.
    """

    def __init__(
        self,
        disk_xb: torch.Tensor,
        disk_y: torch.Tensor,
        config: SparrowConfig,
        device: str | torch.device = "cuda",
        uniforms: Callable[[int, int], object] | None = None,
    ) -> None:
        super().__init__(disk_xb, disk_y, config, device)
        self.uniforms = uniforms if uniforms is not None else GeneratorUniforms(self.device)

    # ----- protocol hooks -----------------------------------------------
    def init_state(self, worker_id: int, seed: int) -> SparrowState:
        cfg = self.config
        dev = self.device
        model = empty_model(cfg.capacity, device=dev)
        disk_margin = torch.zeros((self.n,), dtype=torch.float32, device=dev)
        sample = draw_sample(self.uniforms(seed, 0), self.xb, self.y, model, disk_margin, cfg.sample_size)
        return SparrowState(
            worker_id=worker_id,
            model=model,
            cert=0.0,  # log Z(H_0) = log 1
            scanner=_row(init_scanner(self.d, cfg.scanner, 1, device=dev), 0),
            sample=sample,
            disk_margin=disk_margin,
            disk_t=torch.zeros((self.n,), dtype=torch.int32, device=dev),
            stream=seed,
            draws=1,
            needs_resample=False,
            pending_cost=0.0,
            fires=0,
            resamples=0,
            sample_model_count=0,
        )

    def run_segment(self, state: SparrowState) -> tuple[SparrowState, float, bool]:
        cost = state.pending_cost
        state = state._replace(pending_cost=0.0)
        if state.needs_resample:
            state, c = self._resample(state)
            return state, cost + c, False
        state, c, fired = self._scan_one_chunk(state)
        return state, cost + c, fired

    def _resample(self, state: SparrowState) -> tuple[SparrowState, float]:
        cfg = self.config
        model = state.model
        # refresh the disk weights incrementally, then draw a fresh sample
        delta = predict_margin_delta(model, self.xb, state.disk_t)
        disk_margin = state.disk_margin + delta
        evals = float(torch.clamp(model.count - state.disk_t, max=model.capacity).sum())
        u0 = self.uniforms(state.stream, state.draws)
        sample = draw_sample(u0, self.xb, self.y, model, disk_margin, cfg.sample_size)
        cost = self.n * cfg.disk_read_cost + STUMP_EVAL_COST * evals
        if cfg.parallel_sampler:
            # only the part not covered by scanning since the last pass blocks
            cost = max(cost - state.scan_since_resample, 0.0)
        scanner = reset_after_fire(state.scanner, True, cfg.scanner)
        return state._replace(
            sample=sample,
            disk_margin=disk_margin,
            disk_t=model.count.expand(self.n).clone(),
            draws=state.draws + 1,
            needs_resample=False,
            scanner=scanner._replace(pos=torch.zeros_like(scanner.pos)),
            resamples=state.resamples + 1,
            sample_model_count=int(model.count),
            scan_since_resample=0.0,
        ), cost

    def _scan_one_chunk(self, state: SparrowState) -> tuple[SparrowState, float, bool]:
        cfg = self.config
        scanner, sample, info = scan_chunk(
            _batch1(state.scanner), _batch1(state.sample), _batch1(state.model),
            self.feature_mask(state.worker_id).unsqueeze(0), cfg.scanner,
        )
        scanner, sample, info = _row(scanner, 0), _row(sample, 0), _row(info, 0)
        fired, full_pass, stump_evals = (
            torch.stack([info.fired.float(), info.full_pass.float(), info.stump_evals]).tolist()
        )
        chunk = min(cfg.scanner.chunk_size, cfg.sample_size)
        cost = chunk * cfg.mem_read_cost + STUMP_EVAL_COST * stump_evals
        state = state._replace(
            scanner=scanner, sample=sample, scan_since_resample=state.scan_since_resample + cost
        )
        if fired:
            # alpha and certificate from the sound lower confidence bound
            # on the edge (>= the tested gamma; see scanner.scan_chunk)
            gamma = float(info.cert_gamma)
            alpha = alpha_from_gamma(info.cert_gamma)
            model = append_stump(state.model, info.feat, info.thr, info.sign, alpha)
            count = int(model.count)
            if count == int(state.model.count):
                # at capacity the strong rule cannot grow: no certificate claim
                return state, cost, False
            step = torch.log1p(torch.tensor(-4.0 * gamma**2, dtype=torch.float32))
            state = state._replace(
                model=model,
                cert=state.cert + 0.5 * float(step),
                scanner=reset_after_fire(scanner, cfg.keep_gamma_on_fire, cfg.scanner, info.emp_gamma),
                fires=state.fires + 1,
            )
            # ESS check (§3): a stale sample schedules a resample
            if _ess_fraction(state.sample, cfg.sample_size) < cfg.ess_threshold:
                state = state._replace(needs_resample=True)
        elif full_pass:
            # a full cycle without firing: halve gamma, clear the
            # accumulators and keep scanning; resample when the sample is
            # stale, or as a last resort when gamma hit its floor and the
            # model has advanced since sampling
            advanced = int(state.model.count) > state.sample_model_count
            exhausted = float(scanner.gamma) <= 2e-4 and advanced
            stale = _ess_fraction(state.sample, cfg.sample_size) < cfg.ess_threshold
            state = state._replace(
                scanner=reset_after_fruitless_pass(scanner), needs_resample=stale or exhausted
            )
        return state, cost, bool(fired)

    def certificate(self, state: SparrowState) -> float:
        return state.cert

    def export_model(self, state: SparrowState) -> StumpModel:
        return state.model

    def payload_bytes(self, model: StumpModel) -> int:
        return model_payload_bytes(model)

    @staticmethod
    def _common_prefix(a: StumpModel, b: StumpModel) -> int:
        """Length of the shared stump prefix (adopted models usually extend
        a common broadcast lineage, so this is long)."""
        n = min(int(a.count), int(b.count))
        if n == 0:
            return 0
        same = (
            (a.feat[:n] == b.feat[:n])
            & (a.thr[:n] == b.thr[:n])
            & (a.sign[:n] == b.sign[:n])
            & (a.alpha[:n] == b.alpha[:n])
        )
        return int(torch.cumprod(same.to(torch.int32), dim=0).sum())

    def adopt(self, state: SparrowState, model: StumpModel, certificate: float) -> SparrowState:
        """Interrupt + replace (H, L), with the incremental margin transfer
        across the shared prefix ``p``:

            margin_new = margin_old_full - delta_old(p..oc) + delta_new(p..nc)

        so the cost is m x (suffix lengths) stump evals, not m x count."""
        oc, nc = int(state.model.count), int(model.count)
        p = self._common_prefix(state.model, model)
        sample = state.sample
        xb = sample.xb
        m = xb.shape[0]
        # 1. bring margins current under the OLD model (lazy work due anyway)
        catchup = predict_margin_delta(state.model, xb, sample.t_l)
        evals = float(torch.clamp(state.model.count - sample.t_l, min=0).sum())
        full_old = sample.margin_l + catchup
        # 2. swap the divergent suffixes
        pfx = torch.full((m,), p, dtype=torch.int32, device=xb.device)
        m_new = full_old - predict_margin_delta(state.model, xb, pfx) + predict_margin_delta(model, xb, pfx)
        evals += float(m * ((oc - p) + (nc - p)))
        # keep margin_s, so scan weights stay importance-corrected
        sample = sample._replace(margin_l=m_new, t_l=torch.full_like(sample.t_l, nc))
        # the disk bookkeeping stays valid iff the divergence lies beyond
        # the last disk refresh (disk_t is uniform per resample)
        if p >= int(state.disk_t[0]):
            disk_margin, disk_t = state.disk_margin, state.disk_t
        else:
            disk_margin, disk_t = torch.zeros_like(state.disk_margin), torch.zeros_like(state.disk_t)
        return state._replace(
            model=model,
            cert=float(certificate),
            sample=sample,
            disk_margin=disk_margin,
            disk_t=disk_t,
            scanner=reset_after_fire(state.scanner, True, self.config.scanner),
            pending_cost=state.pending_cost + STUMP_EVAL_COST * evals * self.config.mem_read_cost,
        )
