"""The worker contracts; counterpart of ``src/repro/core/worker.py``.

Two fidelity levels, one vocabulary:

  * :class:`TMSNWorker` — the event simulator's worker
    (:mod:`repro_torch.core.simulator`): opaque state objects, one per
    logical machine, Python floats for certificates;
  * :class:`BatchedTMSNWorker` — the round engine's worker.

A :class:`BatchedTMSNWorker` keeps all W workers' state as a pytree of
tensors (``NamedTuple``, ``tuple``, ``list`` or ``dict`` nodes) with a
leading ``(W,)`` axis and advances every worker one segment per round.
Contract: masked-out workers come back bitwise unchanged with zero cost,
adoption is the identity where ``take`` is False, and certificates are
monotone non-increasing.
"""

from __future__ import annotations

from typing import Any, Protocol

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "TMSNWorker",
    "BatchedTMSNWorker",
    "masked_rows",
    "has_resample_hooks",
    "export_payload_rows",
    "payload_bytes_from_export",
    "resolve_payload_bytes",
    "tree_leaves",
    "tree_map",
]


class TMSNWorker(Protocol):
    """Duck-typed worker plugged into the event simulator. State objects
    are opaque to the simulator; certificates are floats (lower = better)."""

    def init_state(self, worker_id: int, seed: int) -> Any: ...

    def run_segment(self, state: Any) -> tuple[Any, float, bool]:
        """One scheduling quantum: ``(new_state, cost_units, fired)``, where
        ``cost_units`` is the simulated compute cost of the segment and
        ``fired`` says the worker found a better model in it."""
        ...

    def certificate(self, state: Any) -> float: ...

    def export_model(self, state: Any) -> Any: ...

    def adopt(self, state: Any, model: Any, certificate: float) -> Any:
        """Interrupt: replace (H, L) with the incoming pair."""
        ...

    def payload_bytes(self, model: Any) -> int: ...


class BatchedTMSNWorker(Protocol):
    """Duck-typed batched worker plugged into the round engine. Only
    the five required methods are mandatory; the optional ones carry
    defaults (the engine probes with ``getattr`` via the helpers below)."""

    # ----- required ----------------------------------------------------
    def init_batch(self, n_workers: int, seed: int) -> Any: ...

    def scan_round(self, state: Any, mask: torch.Tensor) -> tuple[Any, torch.Tensor, torch.Tensor]:
        """One segment for every worker where ``mask``; returns
        ``(new_state, cost (W,), fired (W,))``."""
        ...

    def certificates(self, state: Any) -> torch.Tensor: ...

    def export_models(self, state: Any) -> Any:
        """Stacked model pytree with a leading worker axis (the payload)."""
        ...

    def adopt_batch(
        self, state: Any, models: Any, certs: torch.Tensor, take: torch.Tensor
    ) -> tuple[Any, torch.Tensor]:
        """Adopt ``models[i]``/``certs[i]`` wherever ``take[i]``; the
        identity (zero cost) elsewhere."""
        ...

    # ----- optional: sampling-phase hooks (no-op defaults) -------------
    def needs_resample(self, state: Any) -> torch.Tensor:
        return torch.zeros_like(self.certificates(state), dtype=torch.bool)

    def resample_round(self, state: Any, do: torch.Tensor) -> tuple[Any, torch.Tensor]:
        return state, torch.zeros_like(self.certificates(state), dtype=torch.float32)

    # ----- optional: payload hooks (derived defaults) ------------------
    def export_payload_rows(self, state: Any, rows: torch.Tensor) -> Any:
        return tree_map(lambda a: a[rows], self.export_models(state))

    def payload_bytes(self) -> int:
        raise NotImplementedError  # engines derive via resolve_payload_bytes


def masked_rows(cond: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-worker select over a stacked pytree: the ``(W,)`` cond
    broadcasts over each leaf's trailing dims. Leaves that are the same
    tensor in both trees are passed through without a copy."""

    def pick(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a is b:
            return a
        return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)

    return tree_map(pick, new, old)


def has_resample_hooks(worker: Any) -> bool:
    """True when the worker implements BOTH sampling-phase hooks; the
    engine skips the resample step entirely otherwise."""
    return callable(getattr(worker, "needs_resample", None)) and callable(
        getattr(worker, "resample_round", None)
    )


def export_payload_rows(worker: Any, state: Any, rows: torch.Tensor) -> Any:
    """Candidate payloads for ``rows`` via the worker's optional hook,
    falling back to indexing the full exported stack."""
    hook = getattr(worker, "export_payload_rows", None)
    if hook is not None:
        return hook(state, rows)
    return tree_map(lambda a: a[rows], worker.export_models(state))


def payload_bytes_from_export(worker: Any, n_workers: int, seed: int = 0) -> int:
    """Per-worker payload bytes derived from the exported tensors
    (``numel * element_size`` summed over the leaves, divided by W)."""
    models = worker.export_models(worker.init_batch(n_workers, seed))
    total = sum(int(a.numel() * a.element_size()) for a in tree_leaves(models))
    return total // max(n_workers, 1)


def resolve_payload_bytes(worker: Any, n_workers: int, seed: int = 0) -> int:
    """The worker's own ``payload_bytes()`` when it defines one, else
    derived from the exported pytree."""
    hook = getattr(worker, "payload_bytes", None)
    if callable(hook) and getattr(hook, "__func__", hook) is not BatchedTMSNWorker.payload_bytes:
        return int(hook())
    return payload_bytes_from_export(worker, n_workers, seed)
