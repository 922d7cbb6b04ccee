"""TMSN-SGD as an engine worker: transformer + AdamW on the gossip
substrate; counterpart of ``src/repro/core/sgd_worker.py``.

:class:`BatchedSGDWorker` adapts any ``(init_fn, loss_fn, batch_fn,
AdamWConfig)`` quadruple to the
:class:`repro_torch.core.worker.BatchedTMSNWorker` contract, so the
round engine (single-device and sharded, dense and sparse in-flight
state) runs SGD learners unchanged: gradients never cross the wire,
only improved parameter snapshots do.

Mapping onto the paper's concepts, as in the reference:

  one segment        -> ``local_steps`` (K) AdamW steps on the worker's
                        own batch stream
  certificate L      -> running minimum of an EMA loss estimate plus a
                        concentration width (population std of the K
                        step losses / sqrt(K), times ``width_coef``):
                        ``est`` is the estimator, ``cert = min(cert,
                        est)`` the monotone envelope; ``fired`` is a
                        strict decrease of the envelope
  broadcast payload  -> the params pytree only; optimizer moments stay
                        local, and on adoption ``cert`` and ``est``
                        restart at the incoming certificate
  cost units         -> K per segment; adoption costs zero

Randomness is an input: where the reference carries a PRNG key per
worker, the state carries a stream id and the number of segments drawn
(worker ``i`` is stream ``i + 1``, the reference's ``fold_in`` index),
and ``batch_fn(stream, draw)`` returns that segment's K batches. A
masked-out worker's counters do not advance.

Gradients come from ``torch.autograd``; each worker's segment runs on
its own slice of the stacked state, so its bits do not depend on which
other workers share the batch (a sharded rank equals one device). The
new state's rows are written by the segments (``apply_updates_``, the
same bits as the functional step); masked-out workers skip the compute
and keep their rows bitwise, as the contract requires.

The worker omits every optional hook (no resample hooks, no
``payload_bytes``, no ``export_payload_rows``): engines derive the
payload bytes from the exported pytree.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tmsn_sgd import TMSNSGDConfig
from repro_torch.core.worker import masked_rows, tree_map
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig, apply_updates_, init_opt_state

__all__ = ["BatchedSGDState", "BatchedSGDWorker", "lm_sgd_worker"]


class BatchedSGDState(NamedTuple):
    """Stacked per-worker SGD state; every leaf has a leading (W,) axis
    (``opt``'s per-worker ``step`` scalar becomes a (W,) vector)."""

    params: Any  # model params, leaves (W, ...)
    opt: Any  # AdamW state {"mu", "nu", "step"}, leaves (W, ...)
    cert: torch.Tensor  # (W,) f32 — monotone envelope (running min of est)
    est: torch.Tensor  # (W,) f32 — raw EMA estimate (+inf before 1st segment)
    stream: torch.Tensor  # (W,) i64 batch-stream ids (worker i: i + 1)
    draws: torch.Tensor  # (W,) i32 segments drawn from the stream


class BatchedSGDWorker:
    """K local AdamW steps per segment under the worker contract.

    ``init_fn(seed) -> params`` builds one (unbatched) model on
    ``device``; ``loss_fn(params, batch) -> (loss, aux)`` is the per-step
    objective; ``batch_fn(stream, draw) -> batch`` returns one segment's
    batch pytree with leaves ``(K, batch, ...)``.
    """

    def __init__(
        self,
        init_fn: Callable[[int], Any],
        loss_fn: Callable[[Any, Any], tuple[torch.Tensor, Any]],
        batch_fn: Callable[[int, int], Any],
        opt_cfg: AdamWConfig,
        sgd_cfg: TMSNSGDConfig | None = None,
        device="cuda",
    ) -> None:
        self._init_fn = init_fn
        self._loss_fn = loss_fn
        self._batch_fn = batch_fn
        self._opt_cfg = opt_cfg
        self.cfg = TMSNSGDConfig() if sgd_cfg is None else sgd_cfg
        self.device = resolve_device(device)
        if self.cfg.local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {self.cfg.local_steps}")

    # ----- contract: required ------------------------------------------
    def init_batch(self, n_workers: int, seed: int) -> BatchedSGDState:
        params = self._init_fn(seed)
        # every worker starts from the SAME H_0 (paper §2); divergence
        # comes from the independent per-worker batch streams
        params = tree_map(lambda a: a.unsqueeze(0).expand((n_workers,) + a.shape).clone(), params)
        opt = init_opt_state(params, self._opt_cfg)
        opt["step"] = torch.zeros((n_workers,), dtype=torch.int32, device=self.device)
        inf = torch.full((n_workers,), float("inf"), dtype=torch.float32, device=self.device)
        return BatchedSGDState(
            params=params,
            opt=opt,
            cert=inf,
            est=inf.clone(),
            stream=torch.arange(1, n_workers + 1, dtype=torch.int64, device=self.device),
            draws=torch.zeros((n_workers,), dtype=torch.int32, device=self.device),
        )

    def certificates(self, state: BatchedSGDState) -> torch.Tensor:
        return state.cert

    def export_models(self, state: BatchedSGDState) -> Any:
        return state.params

    def _segment(self, src: tuple, dst: tuple, batches: Any) -> torch.Tensor:
        """K AdamW steps of one worker from its rows ``src = (params,
        opt)`` of the old state into its rows ``dst`` of the new one (the
        first step reads ``src``, the rest update ``dst`` in place);
        returns the K step losses."""
        losses = []
        for k in range(int(self.cfg.local_steps)):
            params, opt = src if k == 0 else dst
            batch = tree_map(lambda a, k=k: a[k], batches)
            leaves = tree_map(lambda a: a.detach().requires_grad_(True), params)
            with torch.enable_grad():
                loss, _aux = self._loss_fn(leaves, batch)
                loss.backward()
            grads = tree_map(lambda a: a.grad, leaves)
            del leaves
            apply_updates_(params, grads, opt, self._opt_cfg, out=dst)
            del grads
            losses.append(loss.detach())
        return torch.stack(losses)

    @torch.no_grad()
    def scan_round(
        self, state: BatchedSGDState, mask: torch.Tensor
    ) -> tuple[BatchedSGDState, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        k_steps = int(cfg.local_steps)
        w = state.cert.shape[0]
        active = mask.tolist()
        streams, draws = state.stream.tolist(), state.draws.tolist()
        # the new state's rows: an active worker's segment writes its own
        # (so one worker's AdamW temporaries are the only memory beyond
        # the two states), a masked-out worker's are copied bit for bit
        old = (state.params, state.opt)
        new = tree_map(torch.empty_like, old)
        losses = torch.zeros((w, k_steps), dtype=torch.float32, device=state.cert.device)
        for i in range(w):
            src, dst = (tree_map(lambda a, i=i: a[i], t) for t in (old, new))
            if active[i]:
                losses[i] = self._segment(src, dst, self._batch_fn(streams[i], draws[i]))
            else:
                tree_map(lambda d, s: d.copy_(s), dst, src)
        params, opt = new
        mean = torch.mean(losses, dim=1)
        width = cfg.width_coef * torch.std(losses, dim=1, correction=0) / torch.sqrt(
            torch.full((), k_steps, dtype=torch.float32, device=losses.device))
        sample = (mean + width).to(torch.float32)
        # EMA warm start: the first observation IS the estimate (an inf
        # sentinel would poison the average); afterwards the usual update
        est = torch.where(torch.isfinite(state.est), cfg.ema * state.est + (1.0 - cfg.ema) * sample, sample)
        cert = torch.minimum(state.cert, est)  # monotone envelope
        new = BatchedSGDState(params=params, opt=opt, cert=torch.where(mask, cert, state.cert),
                              est=torch.where(mask, est, state.est), stream=state.stream,
                              draws=state.draws + mask.to(torch.int32))
        cost = mask.to(torch.float32) * float(k_steps)
        fired = mask & (new.cert < state.cert)
        return new, cost, fired

    @torch.no_grad()
    def adopt_batch(
        self,
        state: BatchedSGDState,
        models: Any,
        certs: torch.Tensor,
        take: torch.Tensor,
    ) -> tuple[BatchedSGDState, torch.Tensor]:
        certs = certs.to(torch.float32)
        new = state._replace(
            params=masked_rows(take, models, state.params),
            # restart both the envelope and the estimator at the adopted
            # certificate — acceptance is eps-gated by the engine, so
            # this only ever lowers cert (monotonicity holds)
            cert=torch.where(take, certs, state.cert),
            est=torch.where(take, certs, state.est),
        )
        return new, torch.zeros_like(state.cert)


def lm_sgd_worker(
    arch_cfg: Any,
    opt_cfg: AdamWConfig,
    sgd_cfg: TMSNSGDConfig | None = None,
    batch_size: int = 4,
    seq: int = 64,
    device="cuda",
    tokens: Callable[[int, int], torch.Tensor] | None = None,
    init: Callable[[int], Any] | None = None,
) -> BatchedSGDWorker:
    """The concrete instantiation: a :mod:`repro_torch.models` transformer
    with AdamW on synthetic token streams, one independent stream per
    worker (the paper's per-machine data shards).

    ``tokens(stream, draw) -> (K, batch_size, seq)`` ints supplies a
    segment's tokens (default: :func:`repro_torch.data.tokens.stream_tokens`
    on ``device``); ``init(seed) -> params`` the initial model (default:
    :func:`repro_torch.models.init_params` on ``device``)."""
    from repro_torch.data.tokens import stream_tokens, synthetic_token_batch
    from repro_torch.models import init_params, loss_fn

    dev = resolve_device(device)
    sgd_cfg = TMSNSGDConfig() if sgd_cfg is None else sgd_cfg
    k = int(sgd_cfg.local_steps)
    if tokens is None:
        def tokens(stream: int, draw: int) -> torch.Tensor:
            return stream_tokens(stream, draw, (k, batch_size, seq), arch_cfg.vocab, dev)
    if init is None:
        def init(seed: int) -> Any:
            return init_params(arch_cfg, seed, dev)
    return BatchedSGDWorker(
        init_fn=init,
        loss_fn=lambda params, batch: loss_fn(params, arch_cfg, batch),
        batch_fn=lambda stream, draw: synthetic_token_batch(
            torch.as_tensor(tokens(stream, draw), device=dev)),
        opt_cfg=opt_cfg,
        sgd_cfg=sgd_cfg,
        device=dev,
    )
