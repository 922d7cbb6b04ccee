"""The train-to-serve hand-off; counterpart of the adoption slot in
``src/repro/launch/serving.py``.

:class:`AdoptionSlot` is where the engine publishes its best-certificate
snapshots (:meth:`repro_torch.core.engine.TMSNEngine.attach_publisher`).
It is double-buffered, write-then-flip: the writer fills the inactive
buffer and flips the version counter last, and a reader re-checks the
version after taking the buffer, so a reader can see a stale snapshot
(by at most the publish cadence) but never a torn one. Pure Python; the
continuous-batching server is not ported yet (ROADMAP.md queue 1 item 15).
"""

from __future__ import annotations

import threading
from typing import Any, NamedTuple


class Snapshot(NamedTuple):
    """One published model: the params pytree plus its provenance."""

    version: int  # publish counter, 1-based; monotonically increasing
    params: Any  # host-side params pytree
    cert: float  # the certificate the snapshot was published at
    round: int  # engine round the snapshot was exported at


class AdoptionSlot:
    """Double-buffered single-slot snapshot exchange (write-then-flip).
    Writers are serialized by a lock; readers never take it."""

    def __init__(self) -> None:
        self._buffers: list[tuple[Any, float, int] | None] = [None, None]
        self._version = 0  # 0 = nothing published yet
        self._write_lock = threading.Lock()
        self.publishes = 0

    @property
    def version(self) -> int:
        """Latest published version (a cheap staleness probe)."""
        return self._version

    @property
    def latest_cert(self) -> float:
        """Certificate of the freshest snapshot (nan before the first)."""
        snap = self.acquire()
        return float("nan") if snap is None else snap.cert

    def publish(self, params: Any, cert: float, round: int = 0) -> int:
        """Write-then-flip. Returns the new version."""
        with self._write_lock:
            v = self._version + 1
            # buffer v % 2 is inactive while version == v - 1: readers
            # are pointed at (v - 1) % 2
            self._buffers[v % 2] = (params, float(cert), int(round))
            self._version = v  # flip last: the publication point
            self.publishes += 1
            return v

    def acquire(self) -> Snapshot | None:
        """Latest snapshot, or None before the first publish. Never
        torn: the version is re-checked after the buffer read and the
        read retries if a flip raced it."""
        while True:
            v0 = self._version
            if v0 == 0:
                return None
            buf = self._buffers[v0 % 2]
            if self._version == v0:
                params, cert, rnd = buf
                return Snapshot(v0, params, cert, rnd)
