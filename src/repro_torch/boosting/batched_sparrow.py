"""Batched Sparrow: W workers as stacked ``(W, ...)`` tensors; counterpart
of ``src/repro/boosting/batched_sparrow.py``.

The per-worker computation is the reference's scan / fire / resample /
adopt logic with every branch an elementwise select. The chunk scan runs
all W workers at once (:func:`~repro_torch.boosting.scanner.scan_chunk`
is batched), so with ``ScannerConfig.use_kernel`` one launch of kernel
K1 per round scans every worker's chunk.

Randomness: the reference carries ``jax.random`` keys in the state. The
port carries per worker its stream id (``seed + 1000*i``, the
reference's per-worker key seed) and the number of uniform offsets drawn
so far, and takes draw ``j`` of stream ``s`` from an injectable source
``uniforms(s, j) -> u0``. The default, :class:`GeneratorUniforms`, runs
one ``torch.Generator`` per stream on the worker's device; its numbers
differ from ``jax.random``'s, so the tests inject the reference's own
draws (draw ``j`` of stream ``s`` is ``jax.random.uniform(split(k_j)[1])``
with ``k_0 = PRNGKey(s)``, ``k_{j+1} = split(k_j)[0]``).

Resampling stays sequential over workers, as in the reference, so the
full disk pass never holds a ``(W, n, T)`` intermediate.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.boosting.sampler import GeneratorUniforms
from repro_torch.boosting.scanner import (
    SampleState,
    ScannerState,
    init_scanner,
    reset_after_fire,
    reset_after_fruitless_pass,
    scan_chunk,
)
from repro_torch.boosting.sparrow import (
    STUMP_EVAL_COST,
    SparrowConfig,
    SparrowWorkerBase,
    _row,
    draw_sample,
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
from repro_torch.core.worker import masked_rows, tree_map


class BatchedSparrowState(NamedTuple):
    """Stacked per-worker state; every leaf has a leading (W,) axis."""

    model: StumpModel  # fields (W, T), count (W,)
    cert: torch.Tensor  # (W,) f32
    scanner: ScannerState  # leaves (W, ...)
    sample: SampleState  # leaves (W, m, ...)
    disk_margin: torch.Tensor  # (W, n) f32
    disk_t: torch.Tensor  # (W, n) i32
    stream: torch.Tensor  # (W,) i64 random stream id of each worker
    draws: torch.Tensor  # (W,) i32 uniform offsets drawn so far
    needs_resample: torch.Tensor  # (W,) bool
    fires: torch.Tensor  # (W,) i32
    resamples: torch.Tensor  # (W,) i32
    sample_model_count: torch.Tensor  # (W,) i32
    scan_since_resample: torch.Tensor  # (W,) f32
    feat_mask: torch.Tensor  # (W, d) bool — feature ownership (constant)


def common_prefix_len(a: StumpModel, b: StumpModel) -> torch.Tensor:
    """Length of the shared stump prefix of two models, per row."""
    same = (a.feat == b.feat) & (a.thr == b.thr) & (a.sign == b.sign) & (a.alpha == b.alpha)
    slots = torch.arange(a.capacity, device=a.feat.device)
    same = same & (slots < torch.minimum(a.count, b.count).unsqueeze(-1))
    return torch.cumprod(same.to(torch.int32), dim=-1).sum(dim=-1).to(torch.int32)


class BatchedSparrowWorker(SparrowWorkerBase):
    """Implements :class:`repro_torch.core.worker.BatchedTMSNWorker` for
    Sparrow.

    Args:
        disk_xb, disk_y: the shared disk set, ``(n, d)`` bins and ``(n,)``
            labels; moved to ``device``.
        config: :class:`~repro_torch.boosting.sparrow.SparrowConfig`.
        device: ``"cuda"`` by default; raises without a card unless
            ``"cpu"`` is given.
        uniforms: ``uniforms(stream, draw) -> u0`` source of the
            minimal-variance offsets; :class:`GeneratorUniforms` if None.
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

    # ----- engine protocol hooks --------------------------------------
    def init_batch(self, n_workers: int, seed: int) -> BatchedSparrowState:
        cfg = self.config
        if n_workers != cfg.n_workers:
            raise ValueError(f"engine W={n_workers} != SparrowConfig.n_workers={cfg.n_workers}")
        dev = self.device
        streams = [seed + 1000 * i for i in range(n_workers)]
        model = empty_model(cfg.capacity, device=dev, batch=(n_workers,))
        disk_margin = torch.zeros((n_workers, self.n), dtype=torch.float32, device=dev)
        samples = [
            draw_sample(
                self.uniforms(streams[i], 0), self.xb, self.y, _row(model, i), disk_margin[i],
                cfg.sample_size,
            )
            for i in range(n_workers)
        ]
        zeros_i = torch.zeros((n_workers,), dtype=torch.int32, device=dev)
        return BatchedSparrowState(
            model=model,
            cert=torch.zeros((n_workers,), dtype=torch.float32, device=dev),
            scanner=init_scanner(self.d, cfg.scanner, n_workers, device=dev),
            sample=tree_map(lambda *xs: torch.stack(xs), *samples),
            disk_margin=disk_margin,
            disk_t=torch.zeros((n_workers, self.n), dtype=torch.int32, device=dev),
            stream=torch.tensor(streams, dtype=torch.int64, device=dev),
            draws=torch.ones((n_workers,), dtype=torch.int32, device=dev),
            needs_resample=torch.zeros((n_workers,), dtype=torch.bool, device=dev),
            fires=zeros_i,
            resamples=zeros_i.clone(),
            sample_model_count=zeros_i.clone(),
            scan_since_resample=torch.zeros((n_workers,), dtype=torch.float32, device=dev),
            feat_mask=self._feat_masks.clone(),
        )

    def certificates(self, state: BatchedSparrowState) -> torch.Tensor:
        return state.cert

    def export_models(self, state: BatchedSparrowState) -> StumpModel:
        return state.model

    def export_payload_rows(self, state: BatchedSparrowState, rows: torch.Tensor) -> StumpModel:
        return tree_map(lambda a: a[rows], state.model)

    def needs_resample(self, state: BatchedSparrowState) -> torch.Tensor:
        return state.needs_resample

    def payload_bytes(self) -> int:
        return model_payload_bytes(empty_model(self.config.capacity, device="cpu"))

    # ----- one scan segment for every masked worker -------------------
    def scan_round(
        self, state: BatchedSparrowState, mask: torch.Tensor
    ) -> tuple[BatchedSparrowState, torch.Tensor, torch.Tensor]:
        cfg = self.config
        m = cfg.sample_size
        scanner_s, sample_s, info = scan_chunk(
            state.scanner, state.sample, state.model, state.feat_mask, cfg.scanner
        )
        chunk = min(cfg.scanner.chunk_size, m)
        maskf = mask.to(torch.float32)
        cost = (chunk * cfg.mem_read_cost + STUMP_EVAL_COST * info.stump_evals) * maskf

        # --- fire: append the certified stump, advance the certificate ---
        gamma = info.cert_gamma
        alpha = alpha_from_gamma(gamma)
        model2 = append_stump(state.model, info.feat, info.thr, info.sign, alpha)
        grew = model2.count > state.model.count
        fired = info.fired & mask & grew  # at capacity: no growth, no certificate claim
        cert = torch.where(
            fired, state.cert + 0.5 * torch.log1p(-4.0 * torch.square(gamma)), state.cert
        )
        model = masked_rows(fired, model2, state.model)

        fire_scanner = reset_after_fire(scanner_s, cfg.keep_gamma_on_fire, cfg.scanner, info.emp_gamma)
        fruitless = (~info.fired) & info.full_pass & mask
        fruitless_scanner = reset_after_fruitless_pass(scanner_s)
        scanner = masked_rows(
            fired, fire_scanner, masked_rows(fruitless, fruitless_scanner, scanner_s)
        )

        # --- ESS staleness / gamma-exhaustion -> schedule resample ---
        wts = torch.exp(
            torch.clamp(-sample_s.y * (sample_s.margin_l - sample_s.margin_s), -30.0, 30.0)
        )
        ess = effective_sample_size(wts, dim=-1)
        stale = ess / m < cfg.ess_threshold
        advanced = state.model.count > state.sample_model_count
        exhausted = (scanner_s.gamma <= 2e-4) & advanced
        needs = torch.where(
            fired, stale, torch.where(fruitless, stale | exhausted, state.needs_resample)
        )

        new_state = state._replace(
            model=model,
            cert=cert,
            scanner=scanner,
            sample=sample_s,
            needs_resample=needs,
            fires=state.fires + fired.to(torch.int32),
            scan_since_resample=state.scan_since_resample + cost,
        )
        # masked-out workers come back untouched
        return masked_rows(mask, new_state, state), cost, fired

    # ----- resample segment (rare; sequential over workers) ------------
    def resample_round(
        self, state: BatchedSparrowState, do: torch.Tensor
    ) -> tuple[BatchedSparrowState, torch.Tensor]:
        cfg = self.config
        cost = torch.zeros(do.shape, dtype=torch.float32, device=do.device)
        rows = [i for i, flag in enumerate(do.tolist()) if flag]
        if not rows:
            return state, cost
        # copy-on-write: the rows that resample are written into fresh
        # copies, so the caller's state stays as it was
        st = tree_map(torch.clone, state)
        for i in rows:
            model = _row(st.model, i)
            disk_t = st.disk_t[i]
            delta = predict_margin_delta(model, self.xb, disk_t)
            evals = torch.clamp(model.count - disk_t, max=model.capacity).sum().to(torch.float32)
            disk_margin = st.disk_margin[i] + delta
            u0 = self.uniforms(int(st.stream[i]), int(st.draws[i]))
            sample = draw_sample(u0, self.xb, self.y, model, disk_margin, cfg.sample_size)
            c = self.n * cfg.disk_read_cost + STUMP_EVAL_COST * evals
            if cfg.parallel_sampler:
                c = torch.clamp(c - st.scan_since_resample[i], min=0.0)
            scanner = reset_after_fire(_row(st.scanner, i), True, cfg.scanner)
            for leaf, value in zip(st.sample, sample):
                leaf[i] = value
            for leaf, value in zip(st.scanner, scanner):
                leaf[i] = value
            st.scanner.pos[i] = 0
            st.disk_margin[i] = disk_margin
            st.disk_t[i] = model.count
            st.draws[i] += 1
            st.needs_resample[i] = False
            st.resamples[i] += 1
            st.sample_model_count[i] = model.count
            st.scan_since_resample[i] = 0.0
            cost[i] = c
        return st, cost

    # ----- adoption (interrupt + replace (H, L)) -----------------------
    def adopt_batch(
        self,
        state: BatchedSparrowState,
        models: StumpModel,
        certs: torch.Tensor,
        take: torch.Tensor,
    ) -> tuple[BatchedSparrowState, torch.Tensor]:
        """Incremental margin transfer across the shared stump prefix,
        for every row at once; rows without ``take`` come back as they
        were, at zero cost."""
        cfg = self.config
        m = cfg.sample_size
        old, sample = state.model, state.sample
        p = common_prefix_len(old, models)  # (W,)
        xb = sample.xb
        catchup = predict_margin_delta(old, xb, sample.t_l)
        evals = torch.clamp(old.count.unsqueeze(1) - sample.t_l, min=0).sum(dim=1).to(torch.float32)
        full_old = sample.margin_l + catchup
        pfx = p.unsqueeze(1).expand(-1, m)
        old_sfx = predict_margin_delta(old, xb, pfx)
        new_sfx = predict_margin_delta(models, xb, pfx)
        m_new = full_old - old_sfx + new_sfx
        evals = evals + (m * ((old.count - p) + (models.count - p))).to(torch.float32)
        adopted_sample = sample._replace(
            margin_l=m_new,
            t_l=models.count.unsqueeze(1).expand(-1, m).contiguous(),
        )
        keep_disk = (p >= state.disk_t[:, 0]).unsqueeze(1)
        cost = STUMP_EVAL_COST * evals * cfg.mem_read_cost
        adopted = state._replace(
            model=models,
            cert=certs.to(torch.float32),
            sample=adopted_sample,
            disk_margin=torch.where(keep_disk, state.disk_margin, torch.zeros_like(state.disk_margin)),
            disk_t=torch.where(keep_disk, state.disk_t, torch.zeros_like(state.disk_t)),
            scanner=reset_after_fire(state.scanner, True, cfg.scanner),
        )
        return masked_rows(take, adopted, state), cost * take.to(torch.float32)

