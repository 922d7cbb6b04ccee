"""The TMSN protocol proper (paper §2, §4.2); counterpart of
``src/repro/core/protocol.py``.

A *certificate* is a sound high-probability bound on the quality of a
model (lower is better). eps is the "gap":

  * ``improves(old, new, eps)`` — broadcast iff the new certificate
    beats the previous one by more than eps;
  * ``accepts(local, incoming, eps)`` — adopt iff the incoming
    certificate beats the local one by more than eps.

Both work elementwise on floats and tensors alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Generic, TypeVar

ModelT = TypeVar("ModelT")


@dataclasses.dataclass(frozen=True)
class Certificate:
    """A sound upper bound on the loss of a model. ``confidence`` is
    bookkeeping only; the protocol never branches on it."""

    value: float
    confidence: float = 1.0

    def __post_init__(self) -> None:
        if not (0.0 <= self.confidence <= 1.0):
            raise ValueError(f"confidence must be in [0,1], got {self.confidence}")


@dataclasses.dataclass(frozen=True)
class TMSNMessage(Generic[ModelT]):
    """The broadcast payload ``(H, L)``: a model and its certificate."""

    model: ModelT
    certificate: Certificate
    sender: int
    seq: int = 0  # sender-local sequence number, for tracing only
    payload_bytes: int = 0  # for the communication-cost accounting


def improves(old: Any, new: Any, eps: float) -> Any:
    """Does ``new`` improve on ``old`` by more than the gap? (broadcast test)"""
    return new < old - eps


def accepts(local: Any, incoming: Any, eps: float) -> Any:
    """Does an incoming certificate beat the local one by more than the
    gap? (accept/reject test)"""
    return incoming < local - eps
