"""Baselines the paper compares against, on the same stump/histogram
substrate as Sparrow; counterpart of ``src/repro/boosting/baselines.py``.

* ``train_exact_greedy`` — XGBoost-style in-memory exact greedy: every
  boosting iteration scans the FULL training set, builds the (feature,
  bin) gradient histogram, and takes the best stump.
* ``train_goss`` — LightGBM-style Gradient-based One-Side Sampling:
  keep the top-``a`` fraction by |gradient| (the AdaBoost weight), pick a
  ``b`` fraction of the rest and up-weight it by ``(1-a)/b``; build the
  histogram on that subset only. Gradients are refreshed for all n
  examples each iteration.
* ``train_adaboost_reference`` — textbook synchronous AdaBoost with the
  empirically-optimal alpha; the correctness oracle.

All three share Sparrow's cost model (examples touched +
STUMP_EVAL_COST * incremental stump evals), so "simulated seconds" are
comparable across systems. They run on the device of their input
tensors.

GOSS's rest-pool pick (``jax.random.choice(..., replace=False)`` in the
reference) is an injectable draw ``pick(round, pool, k)`` returning ``k``
distinct positions in ``[0, pool)``; the default,
:class:`GeneratorPicks`, takes them from a ``torch.Generator`` on the
data's device seeded with ``BoosterConfig.seed``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.boosting.sparrow import STUMP_EVAL_COST
from repro_torch.boosting.stumps import (
    StumpModel,
    alpha_from_gamma,
    append_stump,
    best_stump_exact,
    empty_model,
)


@dataclasses.dataclass(frozen=True)
class BoosterConfig:
    num_rounds: int = 100
    num_bins: int = 32
    capacity: int = 256
    # GOSS fractions (LightGBM defaults: a=0.2, b=0.1)
    goss_top: float = 0.2
    goss_rest: float = 0.1
    seed: int = 0
    eval_every: int = 5


class BoostTrace(NamedTuple):
    """(cost, metric) checkpoints for the loss-vs-time figures."""

    cost: list  # cumulative cost units at each checkpoint
    rounds: list
    metric: list  # eval_fn(model) at each checkpoint
    model: StumpModel


EvalFn = Callable[[StumpModel], float]
#: ``pick(round, pool, k)`` -> ``k`` distinct int positions in ``[0, pool)``
PickFn = Callable[[int, int, int], torch.Tensor]


class GeneratorPicks:
    """Default GOSS rest-pool pick: the first ``k`` entries of a
    ``torch.randperm(pool)`` from one ``torch.Generator`` per run."""

    def __init__(self, seed: int, device: torch.device) -> None:
        self.device = device
        self._g = torch.Generator(device=device)
        self._g.manual_seed(seed)

    def __call__(self, round_: int, pool: int, k: int) -> torch.Tensor:
        return torch.randperm(pool, generator=self._g, device=self.device)[:k]


def _loop(
    xb: torch.Tensor,
    y: torch.Tensor,
    cfg: BoosterConfig,
    eval_fn: EvalFn | None,
    step_fn: Callable[[StumpModel, torch.Tensor, int], tuple[StumpModel, float]],
) -> BoostTrace:
    """Common driver: maintains margins incrementally, charges cost."""
    n = xb.shape[0]
    model = empty_model(cfg.capacity, device=xb.device)
    margin = torch.zeros((n,), dtype=torch.float32, device=xb.device)
    cost = 0.0
    costs, rounds, metrics = [], [], []
    for r in range(cfg.num_rounds):
        w = torch.exp(torch.clamp(-y * margin, -30.0, 30.0))
        prev_count = int(model.count)
        model, step_cost = step_fn(model, w, r)
        cost += step_cost
        if int(model.count) > prev_count:
            # incremental margin refresh: one new stump on all n examples
            k = prev_count
            h = torch.where(xb[:, model.feat[k]] > model.thr[k], 1.0, -1.0) * model.sign[k]
            margin = margin + model.alpha[k] * h
            cost += STUMP_EVAL_COST * n
        if eval_fn is not None and (r % cfg.eval_every == 0 or r == cfg.num_rounds - 1):
            costs.append(cost)
            rounds.append(r + 1)
            metrics.append(float(eval_fn(model)))
    return BoostTrace(cost=costs, rounds=rounds, metric=metrics, model=model)


def train_exact_greedy(
    xb: torch.Tensor, y: torch.Tensor, cfg: BoosterConfig, eval_fn: EvalFn | None = None
) -> BoostTrace:
    """XGBoost-like: full-scan exact greedy per round."""
    n = xb.shape[0]

    def step(model: StumpModel, w: torch.Tensor, r: int) -> tuple[StumpModel, float]:
        feat, thr, sign, gamma_hat = best_stump_exact(xb, y, w, cfg.num_bins)
        model = append_stump(model, feat, thr, sign, alpha_from_gamma(gamma_hat))
        return model, float(n)  # one full histogram pass

    return _loop(xb, y, cfg, eval_fn, step)


def train_goss(
    xb: torch.Tensor,
    y: torch.Tensor,
    cfg: BoosterConfig,
    eval_fn: EvalFn | None = None,
    pick: PickFn | None = None,
) -> BoostTrace:
    """LightGBM-like GOSS: histogram on the top-a + picked-b subset."""
    n = xb.shape[0]
    k_top = max(1, int(cfg.goss_top * n))
    k_rest = max(1, int(cfg.goss_rest * n))
    amplify = (1.0 - cfg.goss_top) / cfg.goss_rest
    if pick is None:
        pick = GeneratorPicks(cfg.seed, xb.device)

    def step(model: StumpModel, w: torch.Tensor, r: int) -> tuple[StumpModel, float]:
        order = torch.argsort(-w, stable=True)
        top = order[:k_top]
        rest_pool = order[k_top:]
        chosen = rest_pool[torch.as_tensor(pick(r, rest_pool.shape[0], k_rest), device=xb.device).long()]
        idx = torch.cat([top, chosen])
        w_sub = torch.cat([w[top], w[chosen] * amplify])
        feat, thr, sign, gamma_hat = best_stump_exact(xb[idx], y[idx], w_sub, cfg.num_bins)
        model = append_stump(model, feat, thr, sign, alpha_from_gamma(gamma_hat))
        # gradients refreshed for all n (cheap pass) + histogram on the subset
        return model, float(k_top + k_rest) + 0.2 * n

    return _loop(xb, y, cfg, eval_fn, step)


def train_adaboost_reference(
    xb: torch.Tensor, y: torch.Tensor, cfg: BoosterConfig, eval_fn: EvalFn | None = None
) -> BoostTrace:
    """Textbook AdaBoost (the correctness oracle; the same as exact greedy
    here, since both take the empirically best stump and optimal alpha)."""
    return train_exact_greedy(xb, y, cfg, eval_fn)
