"""Early-stopping rules for the Scanner (paper Thm 1 / Algorithm 2);
counterpart of ``src/repro/core/stopping.py``.

The scanner accumulates ``m[h] = sum w y h(x)``, ``W = sum |w|`` and
``V = sum w^2`` and fires on ``h`` as soon as

    |m[h] - 2*gamma*W| > C * sqrt( V * ( loglog(V/|M|) + log(1/delta) ) )

(the finite-time iterated-logarithm bound). Both sides are tested: a
large ``m - 2 gamma W`` certifies ``h``, a large ``-m - 2 gamma W``
certifies ``-h``. The Hoeffding variant with a union bound over
stopping times is kept for the tightness ablation.

All functions broadcast: ``V``, ``W`` and ``gamma`` may carry a leading
worker axis shaped to broadcast against ``m``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class StoppingRuleParams(NamedTuple):
    """Global parameters C and delta of Algorithm 2."""

    C: float = 1.0
    delta: float = 1e-6
    #: numerical floor inside log log; also M_0 in ``loglog(V/M_0)``
    m0: float = 1.0


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    dev = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def stopping_threshold(V, M, params: StoppingRuleParams) -> torch.Tensor:
    """RHS of the stopping rule: ``C * sqrt(V * (loglog(V/|M|) + log(1/delta)))``;
    +inf where ``V == 0`` (no evidence, no fire)."""
    V = _f32(V)
    M = _f32(M, V).abs()
    ratio = torch.clamp(V / torch.clamp(M, min=params.m0), min=math.e)
    loglog = torch.log(torch.log(ratio))
    # log(1/delta) in float32, as the reference computes it
    log_inv_delta = torch.log(_f32(1.0 / params.delta, V))
    inner = V * (torch.clamp(loglog, min=0.0) + log_inv_delta)
    thr = params.C * torch.sqrt(torch.clamp(inner, min=0.0))
    return torch.where(V > 0, thr, _f32(float("inf"), V))


def stopping_rule_fires(m, W, V, gamma, params: StoppingRuleParams):
    """Vectorized stopping rule over a batch of candidate weak rules.

    Returns ``(fires, signs, score)``: per-candidate fire flags, the sign
    (+1/-1) certifying ``h`` or ``-h``, and the firing margin (statistic
    minus threshold; larger = stronger evidence)."""
    gw = 2.0 * _f32(gamma, m) * W
    Mp = m - gw  # evidence that h has edge > gamma
    Mn = -m - gw  # evidence that -h has edge > gamma
    thr_p = stopping_threshold(V, Mp, params)
    thr_n = stopping_threshold(V, Mn, params)
    fires = (Mp > thr_p) | (Mn > thr_n)
    score_p = Mp - thr_p
    score_n = Mn - thr_n
    use_p = score_p >= score_n
    one = _f32(1.0, m)
    signs = torch.where(use_p, one, -one)
    score = torch.where(use_p, score_p, score_n)
    return fires, signs, score


def hoeffding_threshold(V, t, params: StoppingRuleParams) -> torch.Tensor:
    """Union-bound Hoeffding threshold at a fixed horizon ``t`` (the
    tightness ablation): ``sqrt(2 V log(2 t^2/delta))``."""
    V = _f32(V)
    t = torch.clamp(_f32(t, V), min=1.0)
    thr = torch.sqrt(2.0 * V * torch.log(2.0 * t * t / params.delta))
    return torch.where(V > 0, thr, _f32(float("inf"), V))


def hoeffding_rule_fires(m, W, V, t, gamma, params: StoppingRuleParams):
    """Hoeffding-with-union-bound variant of :func:`stopping_rule_fires`;
    returns ``(fires, signs)``."""
    gw = 2.0 * _f32(gamma, m) * W
    Mp = m - gw
    Mn = -m - gw
    thr = hoeffding_threshold(V, t, params)
    fires = (Mp > thr) | (Mn > thr)
    one = _f32(1.0, m)
    signs = torch.where(Mp >= Mn, one, -one)
    return fires, signs
