"""The held experts' grouped products against the bf16 peak (%): their
FLOPs, 6 x rows x d x f a pass over the rows the program's ``moe.rows``
counter gives (four passes a step under remat: the forward, its
recompute and the backward's two; bench/counts/moe_mla.py), over the
kernel time of the grouped products in the device trace of the same
rounds, at 989 TFLOP/s. It counts the same work whatever implements the
products."""

from harness import peaks


def read(rec):
    prog = rec.get("program", {})
    flops, seconds = prog.get("expert_mm_flops"), prog.get("expert_mm_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / seconds / peaks.BF16_FLOPS
