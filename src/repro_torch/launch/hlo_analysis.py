"""Roofline accounting; counterpart of ``src/repro/launch/hlo_analysis.py``.

:func:`roofline` is the reference's, exactly. :func:`round_step_roofline`
keeps the reference's keys, but where the reference reads XLA's cost
analysis of its plain round step, the port counts what its own plain
version (``kernels/ref.py::round_step_ref``) reads and writes, op by op,
under a ``TorchDispatchMode`` over ``meta`` tensors (no data, no device),
and classifies the result against the H100's published peaks
(``launch/mesh.py``).

The reference's ``parse_collectives`` (and the dry-run's
``collective_bytes``) read collective sizes out of XLA's optimized HLO
text. A PyTorch program has no such text, so their job, a step's
collective bytes per device, moved to ``launch/dryrun.py``, which
derives them from the sharding plan.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.tree import tree_leaves


def roofline(flops: float, bytes_accessed: float, *, peak_flops: float, hbm_bw: float) -> dict:
    """Classic two-term roofline: arithmetic intensity vs the machine's
    ridge point, plus the projected per-invocation floor (the larger of
    the memory and compute terms)."""
    intensity = flops / max(bytes_accessed, 1.0)
    ridge = peak_flops / hbm_bw
    return {
        "flops": float(flops),
        "bytes_accessed": float(bytes_accessed),
        "arith_intensity_flops_per_byte": intensity,
        "ridge_point_flops_per_byte": ridge,
        "bound": "memory" if intensity < ridge else "compute",
        "projected_us": 1e6 * max(bytes_accessed / hbm_bw, flops / peak_flops),
    }


class OpCounter(TorchDispatchMode):
    """Counts, over every op dispatched inside it that is not a view, the
    bytes of its tensor inputs and outputs (each op reads its inputs and
    writes its outputs once: what an unfused, op-by-op execution moves)
    and one operation per element of its largest tensor."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            ts = [t for t in tree_leaves((list(args), dict(kwargs or {}), out)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ts)
            self.ops += max((t.numel() for t in ts), default=0)
            self.calls += 1
        return out


def round_step_roofline(w: int, capacity: int, *, eps: float = 0.0) -> dict:
    """Roofline accounting of the fused round step (kernel K2) at ``(W, C)``.

    ``operand_bytes`` is the floor the fused kernel must move (four
    ``(W, C)`` queue leaves in, the cert plane out, plus the per-worker
    vectors: ``(5C + 11) * W * 4``); ``fusion_overhead_x`` = counted
    bytes / ``operand_bytes`` says how far the op-by-op plain version
    sits above that floor, the gap the single-pass kernel closes."""
    from repro_torch.kernels.ref import round_step_ref
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    args = (meta((w, capacity), torch.float32), *(meta((w, capacity), torch.int32) for _ in range(3)),
            meta((w,), torch.float32), meta((w,), torch.bool), meta((w,), torch.float32),
            meta((w,), torch.float32), meta((), torch.int32))
    with OpCounter() as count:
        round_step_ref(*args, eps=eps)
    operand_bytes = float((5 * capacity + 11) * w * 4)
    out = roofline(float(count.ops), float(count.bytes), peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW)
    out["w"], out["capacity"] = w, capacity
    out["ops_dispatched"] = count.calls
    out["operand_bytes"] = operand_bytes
    out["fusion_overhead_x"] = count.bytes / max(operand_bytes, 1.0)
    return out
