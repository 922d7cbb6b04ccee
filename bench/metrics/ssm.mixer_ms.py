"""The Mamba-2 mixer a step (ms): device ms of the program's
``ssm.mixer`` spans (in_proj through out_proj: the projections, the
conv, the chunked scan and the gated norm; forward and remat's
recompute) over the traced rounds' worker steps."""


def read(rec):
    ms = rec.get("program", {}).get("span_ms_per_step", {}).get("ssm.mixer")
    return ms or None
