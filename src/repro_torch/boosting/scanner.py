"""The Scanner (paper §4.1, Algorithm 2), batched over workers;
counterpart of ``src/repro/boosting/scanner.py``.

Reads each worker's in-memory sample cyclically in *chunks*. Per chunk:

  1. lazily refreshes example weights from each example's last-touched
     stump count ``t_l`` (the paper's ``UPDATEWEIGHT``);
  2. accumulates ``w*y`` into the (feature, bin) histogram and the
     stopping-rule scalars — through kernel K1
     (:func:`repro_torch.kernels.ops.edge_scan`) when
     ``ScannerConfig.use_kernel`` is set, one launch for all W workers;
  3. re-derives every candidate's edge mass and applies the
     iterated-logarithm stopping rule.

Every state here carries a leading ``(W,)`` worker axis: the reference's
``vmap(scan_chunk)`` is a batch dimension written out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.boosting.stumps import (
    StumpModel,
    edge_histogram,
    edges_from_histogram,
    predict_margin_delta,
)
from repro_torch.core.stopping import StoppingRuleParams, stopping_rule_fires


class ScannerConfig(NamedTuple):
    chunk_size: int = 2048
    num_bins: int = 32
    gamma0: float = 0.25
    #: scan budget per gamma level, as a multiple of the sample size m;
    #: exceeding it halves gamma (Algorithm 2: ``if m > M``)
    budget_mult: float = 4.0
    C: float = 1.0
    delta: float = 1e-6
    #: route the histogram through kernel K1 (the CUDA kernel on the
    #: card, its plain version on CPU tensors)
    use_kernel: bool = False
    #: gamma policy after a fire: "keep" stays at the collapsed level,
    #: "track" targets 0.75 x the fired rule's empirical edge next
    gamma_policy: str = "track"

    @property
    def rule_params(self) -> StoppingRuleParams:
        return StoppingRuleParams(C=self.C, delta=self.delta)


class ScannerState(NamedTuple):
    hist: torch.Tensor  # (W, d, B) f32 accumulated wy histogram
    W: torch.Tensor  # (W,) f32 total |w| scanned
    V: torch.Tensor  # (W,) f32 total w^2 scanned
    pos: torch.Tensor  # (W,) i32 cursor into the sample
    n_scanned: torch.Tensor  # (W,) i32 examples since last fire/reset
    budget_used: torch.Tensor  # (W,) i32 examples since gamma level start
    gamma: torch.Tensor  # (W,) f32 current target edge


class SampleState(NamedTuple):
    """The in-memory samples with lazy-weight bookkeeping."""

    xb: torch.Tensor  # (W, m, d) i32 binned features
    y: torch.Tensor  # (W, m) f32 labels +-1
    margin_s: torch.Tensor  # (W, m) f32 H(x) at sampling time
    margin_l: torch.Tensor  # (W, m) f32 latest computed margin
    t_l: torch.Tensor  # (W, m) i32 stump count at latest margin refresh


class FireInfo(NamedTuple):
    fired: torch.Tensor  # (W,) bool
    feat: torch.Tensor  # (W,) i32
    thr: torch.Tensor  # (W,) i32
    sign: torch.Tensor  # (W,) f32
    gamma: torch.Tensor  # (W,) f32 certified target edge at fire time
    cert_gamma: torch.Tensor  # (W,) f32 sound lower confidence bound on the edge
    emp_gamma: torch.Tensor  # (W,) f32 empirical edge of the fired rule
    full_pass: torch.Tensor  # (W,) bool — completed a cycle without firing
    stump_evals: torch.Tensor  # (W,) f32 — incremental-update work done


def init_scanner(
    num_features: int, config: ScannerConfig, n_workers: int, *, device
) -> ScannerState:
    zf = torch.zeros((n_workers,), dtype=torch.float32, device=device)
    zi = torch.zeros((n_workers,), dtype=torch.int32, device=device)
    return ScannerState(
        hist=torch.zeros((n_workers, num_features, config.num_bins), dtype=torch.float32, device=device),
        W=zf,
        V=zf.clone(),
        pos=zi,
        n_scanned=zi.clone(),
        budget_used=zi.clone(),
        gamma=torch.full((n_workers,), config.gamma0, dtype=torch.float32, device=device),
    )


def reset_after_fire(
    state: ScannerState,
    keep_gamma: bool,
    config: ScannerConfig,
    emp_gamma: torch.Tensor | None = None,
) -> ScannerState:
    """Clear accumulators after a weak rule is added (or adopted)."""
    if not keep_gamma:
        gamma = torch.full_like(state.gamma, config.gamma0)
    elif config.gamma_policy == "track" and emp_gamma is not None:
        gamma = torch.clamp(emp_gamma * 0.75, 1e-4, config.gamma0)
    else:
        gamma = state.gamma
    return ScannerState(
        hist=torch.zeros_like(state.hist),
        W=torch.zeros_like(state.W),
        V=torch.zeros_like(state.V),
        pos=state.pos,
        n_scanned=torch.zeros_like(state.n_scanned),
        budget_used=torch.zeros_like(state.budget_used),
        gamma=gamma,
    )


def reset_after_fruitless_pass(state: ScannerState) -> ScannerState:
    """A full cycle without firing: halve gamma and clear the
    accumulators (each scanner invocation sees each example at most
    once, or the martingale evidence double-counts)."""
    return ScannerState(
        hist=torch.zeros_like(state.hist),
        W=torch.zeros_like(state.W),
        V=torch.zeros_like(state.V),
        pos=state.pos,
        n_scanned=torch.zeros_like(state.n_scanned),
        budget_used=torch.zeros_like(state.budget_used),
        gamma=state.gamma * 0.5,
    )


def _scatter_rows(old: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, new: torch.Tensor):
    """``old`` with ``old[w, idx[w, k]] = new[w, k]`` where ``valid``; the
    invalid entries go to a spare column that is cut off, so a chunk
    longer than the sample can never overwrite a fresh value."""
    nw, m = old.shape
    padded = torch.cat([old, old.new_zeros((nw, 1))], dim=1)
    target = torch.where(valid, idx, m).long()
    return padded.scatter(1, target, new)[:, :m]


def scan_chunk(
    scanner: ScannerState,
    sample: SampleState,
    model: StumpModel,
    feat_mask: torch.Tensor,
    config: ScannerConfig,
) -> tuple[ScannerState, SampleState, FireInfo]:
    """Process one chunk of every worker's sample.

    Args:
        feat_mask: (W, d) bool — features each worker owns; candidates
            on un-owned features never fire.
    """
    nw, m = sample.y.shape
    dev = sample.y.device
    c = config.chunk_size
    rows = torch.arange(nw, device=dev).unsqueeze(1)
    offs = torch.arange(c, dtype=torch.int32, device=dev)
    # do not scan past a full cycle: mask examples beyond it
    remaining = torch.clamp(m - scanner.n_scanned, min=0)
    valid = offs.unsqueeze(0) < remaining.unsqueeze(1)  # (W, c)
    idx = (scanner.pos.unsqueeze(1) + offs.unsqueeze(0)) % m
    il = idx.long()

    xb_c = sample.xb[rows, il]  # (W, c, d)
    y_c = torch.gather(sample.y, 1, il)

    # --- lazy incremental weight refresh (UPDATEWEIGHT) ---
    t_from = torch.gather(sample.t_l, 1, il)
    delta = predict_margin_delta(model, xb_c, t_from)  # (W, c)
    margin_new = torch.gather(sample.margin_l, 1, il) + delta
    # scan weight = w_latest / w_sampled = exp(-y (H(x) - H_s(x)))
    logw = -y_c * (margin_new - torch.gather(sample.margin_s, 1, il))
    validf = valid.to(torch.float32)
    w = torch.exp(torch.clamp(logw, -30.0, 30.0)) * validf
    stump_evals = (
        (torch.clamp(model.count.unsqueeze(1) - t_from, max=model.capacity) * valid)
        .to(torch.float32)
        .sum(dim=1)
    )

    count = model.count.unsqueeze(1).expand(nw, c)
    sample = sample._replace(
        margin_l=_scatter_rows(sample.margin_l, idx, valid, margin_new),
        t_l=_scatter_rows(sample.t_l, idx, valid, count),
    )

    # --- accumulate histogram + scalars ---
    wy = w * y_c
    if config.use_kernel:
        from repro_torch.kernels import ops as kops

        h_k, W_k, V_k, _ = kops.edge_scan(xb_c, wy, w, num_bins=config.num_bins)
        hist = scanner.hist + h_k
        W = scanner.W + W_k
        V = scanner.V + V_k
    else:
        hist = scanner.hist + edge_histogram(xb_c, wy, config.num_bins)
        W = scanner.W + w.abs().sum(dim=1)
        V = scanner.V + (w * w).sum(dim=1)
    n_new = valid.sum(dim=1, dtype=torch.int32)
    n_scanned = scanner.n_scanned + n_new
    budget_used = scanner.budget_used + n_new

    # --- budget check: halve gamma when the level's budget is exhausted ---
    budget = int(config.budget_mult * m)
    over = budget_used > budget
    gamma = torch.where(over, scanner.gamma * 0.5, scanner.gamma)
    budget_used = torch.where(over, torch.zeros_like(budget_used), budget_used)

    # --- stopping rule over every candidate ---
    edges = edges_from_histogram(hist)  # (W, d, B-1)
    col = (nw, 1, 1)
    fires, signs, rule_score = stopping_rule_fires(
        edges, W.view(col), V.view(col), gamma.view(col), config.rule_params
    )
    fires = fires & feat_mask.unsqueeze(-1)
    # pick the strongest firing candidate: largest statistic - threshold
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    flat = torch.where(fires, rule_score, neg_inf).reshape(nw, -1)
    best = torch.argmax(flat, dim=1)
    fired = torch.isfinite(torch.gather(flat, 1, best.unsqueeze(1)).squeeze(1))
    nb = edges.shape[2]
    feat = (best // nb).to(torch.int32)
    thr = (best % nb).to(torch.int32)
    pick = best.unsqueeze(1)
    sign = torch.gather(signs.reshape(nw, -1), 1, pick).squeeze(1)
    edge = torch.gather(edges.reshape(nw, -1), 1, pick).squeeze(1)
    score = torch.gather(rule_score.reshape(nw, -1), 1, pick).squeeze(1)
    emp_gamma = edge.abs() / torch.clamp(2.0 * W, min=1e-9)
    # sound lower confidence bound on the fired rule's edge: the LIL
    # bound |m - mu W| <= thr holds uniformly in t, so
    # gamma_lb = (|m| - thr) / (2W); alpha is set from it
    M_best = edge.abs() - 2.0 * gamma * W
    thr_best = M_best - score  # threshold at fire time
    cert_gamma = (edge.abs() - thr_best) / torch.clamp(2.0 * W, min=1e-9)
    cert_gamma = torch.minimum(torch.maximum(cert_gamma, gamma), torch.full_like(gamma, 0.49))

    full_pass = (~fired) & (n_scanned >= m)

    new_scanner = ScannerState(
        hist=hist,
        W=W,
        V=V,
        pos=(scanner.pos + n_new) % m,
        n_scanned=n_scanned,
        budget_used=budget_used,
        gamma=gamma,
    )
    info = FireInfo(
        fired=fired,
        feat=feat,
        thr=thr,
        sign=sign,
        gamma=gamma,
        cert_gamma=cert_gamma,
        emp_gamma=emp_gamma,
        full_pass=full_pass,
        stump_evals=stump_evals,
    )
    return new_scanner, sample, info
