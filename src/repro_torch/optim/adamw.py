"""Functional AdamW with a configurable state dtype; counterpart of
``src/repro/optim/adamw.py``.

The reference's ops in its order: moments and the update in float32,
the step an int32 counter, bias corrections ``1 - b ** step`` in
float32, weight decay on every trained leaf (norms and embedding
included). A ``state_dtype="bfloat16"`` rounds ``mu``/``nu`` on every
write. A leaf that is state, not trained (``init_opt_state``'s
``trained`` says which; the model's ``trained``: the routers' selection
bias), has ``None`` for its moments: the step leaves it as it is (copied
into ``out``), neither stepped nor decayed.

:func:`apply_updates_` writes the step in place or into given trees;
:func:`apply_updates` allocates fresh trees and writes through it. Leaves
on the card take kernel K5 (:func:`repro_torch.kernels.ops.adamw_step`),
one launch for all of them; every other leaf takes :func:`_update`, the
plain version, op by op. Both give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import trace
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


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


def init_opt_state(params: Any, cfg: AdamWConfig, trained=None) -> dict:
    """Zero moments for every leaf, or with ``trained(path) -> bool`` for
    the trained leaves only (``None`` in the others' place)."""
    dt = _sdt(cfg)

    def zeros(path, p):
        if trained is not None and not trained(path):
            return None
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "mu": tree_map_with_path(zeros, params),
        "nu": tree_map_with_path(zeros, params),
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
    like = lambda a: torch.empty(a.shape, dtype=_sdt(cfg), device=a.device)
    new = (tree_map(torch.empty_like, params),
           {"mu": tree_map(like, state["mu"]), "nu": tree_map(like, state["nu"]),
            "step": torch.empty_like(state["step"])})
    apply_updates_(params, grads, state, cfg, lr, out=new)
    return new


def apply_updates_(
    params: Any, grads: Any, state: dict, cfg: AdamWConfig, lr: torch.Tensor | float | None = None,
    out: tuple[Any, dict] | None = None,
) -> None:
    """:func:`apply_updates` written into ``out = (params', state')``,
    trees of tensors shaped as the inputs (by default the inputs
    themselves: an update in place). Leaves on the card go to K5 in one
    launch (no temporaries); the others to :func:`_update` one at a time,
    so that only one leaf's temporaries live at once. Counts the leaves of
    each route (``adamw_leaves``, sites ``kernel`` and ``plain``). A leaf
    without moments (state, not trained) takes neither: it is copied into
    ``out`` as it is."""
    out_p, out_state = (params, state) if out is None else out
    step = state["step"] + 1
    b1c, b2c = _corrections(step, cfg)
    lr = cfg.lr if lr is None else lr
    leaves: list = []
    tree_map(lambda *leaf: leaves.append(leaf), params, grads, state["mu"], state["nu"],
             out_p, out_state["mu"], out_state["nu"])
    for p, _, mu, _, dst, _, _ in leaves:
        if mu is None and dst is not p:
            dst.copy_(p)
    leaves = [leaf for leaf in leaves if leaf[2] is not None]
    card = [leaf for leaf in leaves if leaf[0].is_cuda]
    plain = [leaf for leaf in leaves if not leaf[0].is_cuda]
    if card:
        ops.adamw_step(card, b1c, b2c, lr, cfg)
        trace.count("adamw_leaves", len(card), "kernel")
    for p, g, mu, nu, *dst in plain:
        _update(p, g, mu, nu, b1c, b2c, lr, cfg, out=dst)
    if plain:
        trace.count("adamw_leaves", len(plain), "plain")
    out_state["step"].copy_(step)
