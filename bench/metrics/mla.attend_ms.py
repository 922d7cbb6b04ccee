"""MLA's attention a step (ms): device ms of the program's ``mla.attend``
spans (the latent scores, the masked float32 softmax and the weighted
sum of latents; forward and remat's recompute) over the traced rounds'
worker steps."""


def read(rec):
    ms = rec.get("program", {}).get("span_ms_per_step", {}).get("mla.attend")
    return ms or None
