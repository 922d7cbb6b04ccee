"""The whole step against the bf16 peak (%): model FLOPs a step (6 x
matmul parameters x tokens and attention's QK^T and PV, forward and
backward, no recompute; bench/counts/lm.py) over the window's time a step
(rounds traced under the profiler left out)."""

from harness import peaks


def read(rec):
    rounds, seconds = rec.get("rounds", 0), rec.get("window_s", 0.0)
    if rounds <= 0 or seconds <= 0:
        return None
    return 100.0 * rec["step_flops"] * rec["steps_per_round"] * rounds / seconds / peaks.BF16_FLOPS
