"""Faults planted underneath a run, for the output check's own tests and
for the readings that set its limits (``bench/readings.py``). Each is a
context manager that patches one attribute of the program and puts it
back. The benchmark's runs never import this file."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name: str, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def sgd_exchange_left_out():
    """Workers ignore the models delivered to them: no adoption."""
    import torch

    from repro_torch.core.sgd_worker import BatchedSGDWorker

    def adopt_batch(self, state, models, certs, take):
        return state, torch.zeros_like(state.cert)

    return _patched(BatchedSGDWorker, "adopt_batch", adopt_batch)


def sgd_state_unchanged():
    """The optimizer step writes the parameters and moments back as
    they were."""
    from repro_torch.core import sgd_worker

    def apply_updates_(params, grads, state, cfg, lr=None, out=None):
        out_p, out_s = (params, state) if out is None else out
        for dst, src in ((out_p, params), (out_s["mu"], state["mu"]), (out_s["nu"], state["nu"])):
            _copy_tree(dst, src)
        out_s["step"].copy_(state["step"] + 1)

    return _patched(sgd_worker, "apply_updates_", apply_updates_)


def _copy_tree(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _copy_tree(a, b)
    elif dst is not None and dst is not src:
        dst.copy_(src)


def sgd_half_batch():
    """The loss is the mean over the first half of the batch's rows."""
    import repro_torch.models as models

    fn = models.loss_fn

    def loss_fn(params, cfg, batch):
        half = {k: v[: max(v.shape[0] // 2, 1)] for k, v in batch.items()}
        return fn(params, cfg, half)

    return _patched(models, "loss_fn", loss_fn)


def sgd_answer_altered():
    """The step's loss comes out 1 % too large."""
    import repro_torch.models as models

    fn = models.loss_fn

    def loss_fn(params, cfg, batch):
        loss, aux = fn(params, cfg, batch)
        return loss * 1.01, aux

    return _patched(models, "loss_fn", loss_fn)


FAULTS = {
    "tmsn_sgd": {"state_unchanged": sgd_state_unchanged, "half_batch": sgd_half_batch,
                 "exchange_left_out": sgd_exchange_left_out, "answer_altered": sgd_answer_altered},
}
