"""Functional AdamW with a configurable state dtype; counterpart of
``src/repro/optim/adamw.py``.

The reference's ops in its order: moments and the update in float32,
the step an int32 counter, bias corrections ``1 - b ** step`` in
float32, weight decay on every leaf (norms and embedding included). A
``state_dtype="bfloat16"`` rounds ``mu``/``nu`` on every write.
:func:`apply_updates_` is the same step, bit for bit, in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"  # or "bfloat16"


def _sdt(cfg: AdamWConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.state_dtype]


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    dt = _sdt(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    }


def _corrections(step: torch.Tensor, cfg: AdamWConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Bias corrections ``1 - b ** step`` in float32 (b filled on the
    device: a host-to-device copy would wait for the card)."""
    step32 = step.to(torch.float32)
    one = lambda b: torch.full((), b, dtype=torch.float32, device=step.device)
    return 1.0 - torch.pow(one(cfg.b1), step32), 1.0 - torch.pow(one(cfg.b2), step32)


def _update(p, g, mu, nu, b1c, b2c, lr, cfg: AdamWConfig, out=None):
    """One leaf's (p', mu', nu'): the reference's ops in its order. With
    ``out`` (three tensors), the results are written there: the last op
    of each writes straight into it when everything is float32, else the
    result is copied in; the bits are the same either way."""
    dt = _sdt(cfg)
    direct = out is not None and dt == torch.float32 and p.dtype == torch.float32
    g32 = g.to(torch.float32)
    mu32 = torch.add(cfg.b1 * mu.to(torch.float32), (1 - cfg.b1) * g32, out=out[1] if direct else None)
    nu32 = torch.add(cfg.b2 * nu.to(torch.float32), (1 - cfg.b2) * g32 * g32, out=out[2] if direct else None)
    mhat = mu32 / b1c
    nhat = nu32 / b2c
    p32 = p.to(torch.float32)
    delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p32
    new = (torch.sub(p32, lr * delta, out=out[0] if direct else None).to(p.dtype), mu32.to(dt), nu32.to(dt))
    if out is not None and not direct:
        for dst, src in zip(out, new):
            dst.copy_(src)
    return new


def apply_updates(
    params: Any, grads: Any, state: dict, cfg: AdamWConfig, lr: torch.Tensor | float | None = None
) -> tuple[Any, dict]:
    """One AdamW step; returns new ``(params, state)``. Leaves are matched
    by path (dict keys by name), as the reference's sorted flattening."""
    step = state["step"] + 1
    b1c, b2c = _corrections(step, cfg)
    lr = cfg.lr if lr is None else lr
    # each leaf of ``new`` is a (p, mu, nu) triple
    new = tree_map(lambda p, g, mu, nu: _update(p, g, mu, nu, b1c, b2c, lr, cfg),
                   params, grads, state["mu"], state["nu"])
    new_p, new_mu, new_nu = (tree_map(lambda _, o, i=i: o[i], params, new) for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}


def apply_updates_(
    params: Any, grads: Any, state: dict, cfg: AdamWConfig, lr: torch.Tensor | float | None = None,
    out: tuple[Any, dict] | None = None,
) -> None:
    """:func:`apply_updates` written into ``out = (params', state')``,
    trees of tensors shaped as the inputs (by default the inputs
    themselves: an update in place). The same ops give the same bits,
    and only one leaf's temporaries live at a time, where the functional
    step holds a second copy of the model and its moments."""
    out_p, out_state = (params, state) if out is None else out
    step = state["step"] + 1
    b1c, b2c = _corrections(step, cfg)
    lr = cfg.lr if lr is None else lr
    tree_map(lambda p, g, mu, nu, dp, dmu, dnu: _update(p, g, mu, nu, b1c, b2c, lr, cfg, out=(dp, dmu, dnu)),
             params, grads, state["mu"], state["nu"], out_p, out_state["mu"], out_state["nu"])
    out_state["step"].copy_(step)
