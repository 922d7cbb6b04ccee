"""The MoE router a step (ms): device ms of the program's ``moe.route``
spans (scores, the biased top-k, weights, balance loss) over the traced
rounds' worker steps, remat's recompute included."""


def read(rec):
    ms = rec.get("program", {}).get("span_ms_per_step", {}).get("moe.route")
    return ms or None
