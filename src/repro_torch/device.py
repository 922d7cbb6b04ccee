"""Device selection for the port's entry points.

``BatchedSparrowWorker``, ``TMSNEngine`` and ``make_splice_like`` take
``device="cuda"`` by default. Without a card they raise instead of
carrying on quietly on the CPU; the CPU runs the plain PyTorch versions
of the kernels and is chosen only explicitly (``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
