"""Mamba-2's chunked scan a step (ms): device ms of the program's
``ssm.scan`` spans (from dt, B, C and x to y before the gated norm: the
within-chunk products, the chunk states, the loop over the chunks and
the read-out; forward and remat's recompute, the backward is outside
every span) over the traced rounds' worker steps."""


def read(rec):
    ms = rec.get("program", {}).get("span_ms_per_step", {}).get("ssm.scan")
    return ms or None
