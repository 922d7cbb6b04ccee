"""The loss forward a step (ms): CUDA-event spans around the program's
loss_fn as the worker calls it, mean over the window."""


def read(rec):
    fwd = rec.get("forward_ms")
    if not fwd:
        return None
    return sum(fwd) / len(fwd)
