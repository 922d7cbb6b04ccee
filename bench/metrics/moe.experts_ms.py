"""The held experts a step (ms): device ms of the program's
``moe.experts`` spans (the three grouped SwiGLU products and the
activation over the sorted rows; forward and remat's recompute, the
backward is outside every span) over the traced rounds' worker steps."""


def read(rec):
    ms = rec.get("program", {}).get("span_ms_per_step", {}).get("moe.experts")
    return ms or None
