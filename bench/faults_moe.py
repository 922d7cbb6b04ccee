"""Faults of the MoE path planted underneath a run, for the output check's
own tests and for the readings that set the limits of the cells of
``systems/tmsn_sgd_moe.py``; importing this file adds them, with the
SGD faults of ``faults.py``, to ``faults.FAULTS`` under that system's
name. Each patches one function of the program and puts it back. The
benchmark's runs never import this file.

    python3 -c "import sys; sys.path.insert(0, 'bench'); import faults_moe, readings; \\
        sys.exit(readings.main(sys.argv[1:]))" --workload <cell> --seeds 1,2 --fault capacity_125
"""

from __future__ import annotations

import dataclasses

import faults
from faults import _patched


def _router_with(change):
    """``moe.router`` with ``change(params, xt, n_seq, cfg)`` returning the
    arguments it is called with."""
    from repro_torch.models import moe

    router = moe.router

    def patched(params, xt, n_seq, cfg):
        return router(*change(params, xt, n_seq, cfg))

    return _patched(moe, "router", patched)


def capacity_125():
    """Each held expert computes at most the reference's capacity (1.25
    times the mean choices an expert), the overflow in token order
    dropped, as the capacity dispatch does."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe

    dropless = moe.experts_dropless

    def experts(params, xt, topw, topi, cfg):
        t, k = topi.shape
        cap = moe.moe_capacity(cfg, t)
        sid = topi.reshape(t * k)
        onehot = F.one_hot(sid, cfg.num_experts).to(torch.int32)
        pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
        kept = torch.where(pos < cap, sid, torch.full_like(sid, -1)).reshape(t, k)
        return dropless(params, xt, topw, kept, cfg)

    return _patched(moe, "experts_dropless", experts)


def bias_out_of_choice():
    """The router chooses by the scores alone, the selection bias left out."""
    return _router_with(lambda params, xt, n_seq, cfg: (
        {k: v for k, v in params.items() if k != "router_bias"}, xt, n_seq, cfg))


def bias_not_updated():
    """The selection bias is never stepped."""
    from repro_torch.models import model

    return _patched(model, "router_bias_step_", lambda bias, load, rate: None)


def softmax_router():
    """Softmax scores in place of the sigmoid (the rest as published)."""
    import torch

    from repro_torch.models import moe

    router = moe.router

    def patched(params, xt, n_seq, cfg):
        sigmoid = torch.sigmoid
        torch.sigmoid = lambda x: torch.softmax(x, dim=-1)
        try:
            return router(params, xt, n_seq, cfg)
        finally:
            torch.sigmoid = sigmoid

    return _patched(moe, "router", patched)


def unscaled_weights():
    """The routed weights are not scaled by ``routed_scaling_factor``."""
    return _router_with(lambda params, xt, n_seq, cfg: (
        params, xt, n_seq, dataclasses.replace(cfg, routed_scaling_factor=1.0)))


def all_experts():
    """Every token-choice is computed here: a choice of an absent expert
    by held expert ``choice mod held`` (standing in for the absent chips)."""
    from repro_torch.models import moe

    dropless = moe.experts_dropless

    def experts(params, xt, topw, topi, cfg):
        H, lo = cfg.n_held(), cfg.experts_offset
        return dropless(params, xt, topw, lo + (topi - lo) % H, cfg)

    return _patched(moe, "experts_dropless", experts)


MOE_FAULTS = {"capacity_125": capacity_125, "bias_out_of_choice": bias_out_of_choice,
              "bias_not_updated": bias_not_updated, "softmax_router": softmax_router,
              "unscaled_weights": unscaled_weights, "all_experts": all_experts}

faults.FAULTS.setdefault("tmsn_sgd_moe", {**faults.FAULTS["tmsn_sgd"], **MOE_FAULTS})
