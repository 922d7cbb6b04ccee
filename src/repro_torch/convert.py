"""Carry state between the JAX reference package and the port.

The reference's pytrees arrive as numpy arrays (``jax.tree_util.tree_map(
np.asarray, state)`` keeps their NamedTuple types) and are read by
attribute name only, so this module imports nothing of the reference.
Each ``*_from_numpy`` builds the port's type on ``device`` (Sparrow's
states, and the LM stack's parameters, AdamW state and SGD worker
state); :func:`to_numpy`
turns any of the port's pytrees back into numpy arrays. A test can then
start both packages from the same ``init_batch`` state and compare them
step by step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.boosting.batched_sparrow import BatchedSparrowState
from repro_torch.boosting.scanner import SampleState, ScannerState
from repro_torch.boosting.sparrow import SparrowState
from repro_torch.boosting.stumps import StumpModel
from repro_torch.core.sgd_worker import BatchedSGDState
from repro_torch.core.worker import tree_map


def tensor(a: Any, device) -> torch.Tensor:
    """numpy array (or scalar) -> tensor on ``device``, same dtype. A
    bfloat16 array (ml_dtypes' type, which torch cannot read) goes
    through a 16-bit integer view: the same bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _numpy(a: torch.Tensor) -> np.ndarray:
    a = a.detach().cpu()
    if a.dtype != torch.bfloat16:
        return a.numpy()
    # numpy knows bfloat16 only once ml_dtypes is loaded (jax loads it);
    # the port never imports it
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError as e:
        raise TypeError("a bfloat16 tensor needs numpy's bfloat16 type (import ml_dtypes first)") from e
    return a.view(torch.int16).numpy().view(bf16)


def to_numpy(tree: Any) -> Any:
    """Any pytree of the port's tensors -> the same pytree of numpy arrays
    (bfloat16 leaves bit for bit, as :func:`tensor` takes them)."""
    return tree_map(_numpy, tree)


def stump_model_from_numpy(model: Any, device) -> StumpModel:
    return StumpModel(*(tensor(getattr(model, f), device) for f in StumpModel._fields))


def sample_from_numpy(sample: Any, device) -> SampleState:
    return SampleState(*(tensor(getattr(sample, f), device) for f in SampleState._fields))


def scanner_from_numpy(scanner: Any, device) -> ScannerState:
    return ScannerState(*(tensor(getattr(scanner, f), device) for f in ScannerState._fields))


def dataset_from_numpy(xb: Any, y: Any, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        tensor(np.asarray(xb, np.int32), device),
        tensor(np.asarray(y, np.float32), device),
    )


def batched_state_from_numpy(state: Any, seed: int, device) -> BatchedSparrowState:
    """The reference's ``BatchedSparrowState`` -> the port's.

    The reference's ``key`` leaf is replaced by the port's random-stream
    bookkeeping: worker ``i`` draws from stream ``seed + 1000*i`` (the
    seed of its reference key), and it has drawn ``resamples + 1`` offsets
    (one at ``init_batch``, one per resample — each splits the key once)."""
    resamples = np.asarray(state.resamples)
    w = resamples.shape[0]
    return BatchedSparrowState(
        model=stump_model_from_numpy(state.model, device),
        cert=tensor(state.cert, device),
        scanner=scanner_from_numpy(state.scanner, device),
        sample=sample_from_numpy(state.sample, device),
        disk_margin=tensor(state.disk_margin, device),
        disk_t=tensor(state.disk_t, device),
        stream=tensor(seed + 1000 * np.arange(w, dtype=np.int64), device),
        draws=tensor((resamples + 1).astype(np.int32), device),
        needs_resample=tensor(state.needs_resample, device),
        fires=tensor(state.fires, device),
        resamples=tensor(resamples, device),
        sample_model_count=tensor(state.sample_model_count, device),
        scan_since_resample=tensor(state.scan_since_resample, device),
        feat_mask=tensor(state.feat_mask, device),
    )


def sparrow_state_from_numpy(state: Any, seed: int, device) -> SparrowState:
    """The reference's unbatched ``SparrowState`` -> the port's.

    As in :func:`batched_state_from_numpy`, the reference's ``key`` is
    replaced by the stream ``seed`` it was made from (the simulator seeds
    worker ``i`` with ``config.seed + 1000*i``) and the ``resamples + 1``
    offsets drawn so far. Bookkeeping leaves become Python numbers."""
    return SparrowState(
        worker_id=int(state.worker_id),
        model=stump_model_from_numpy(state.model, device),
        cert=float(state.cert),
        scanner=scanner_from_numpy(state.scanner, device),
        sample=sample_from_numpy(state.sample, device),
        disk_margin=tensor(state.disk_margin, device),
        disk_t=tensor(state.disk_t, device),
        stream=int(seed),
        draws=int(state.resamples) + 1,
        needs_resample=bool(state.needs_resample),
        pending_cost=float(state.pending_cost),
        fires=int(state.fires),
        resamples=int(state.resamples),
        sample_model_count=int(state.sample_model_count),
        scan_since_resample=float(state.scan_since_resample),
    )


def lm_params_from_numpy(params: Any, device) -> Any:
    """The reference's LM parameter tree (dicts and lists of numpy
    arrays, as ``jax.tree_util.tree_map(np.asarray, params)`` leaves it)
    -> the same tree of tensors on ``device``, leaf for leaf. ``None``
    (an empty subtree, as Zamba2's ``shared_attn`` positions) stays None."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(lm_params_from_numpy(v, device) for v in params)
    return tensor(params, device)


def opt_state_from_numpy(opt: Any, device) -> dict:
    """The reference's AdamW state ``{"mu", "nu", "step"}`` -> the port's."""
    return {"mu": lm_params_from_numpy(opt["mu"], device), "nu": lm_params_from_numpy(opt["nu"], device),
            "step": tensor(np.asarray(opt["step"], np.int32), device)}


def sgd_state_from_numpy(state: Any, local_steps: int, device) -> BatchedSGDState:
    """The reference's ``BatchedSGDState`` -> the port's.

    The reference's per-worker ``key`` is replaced by the port's stream
    bookkeeping: worker ``i`` is stream ``i + 1`` (the reference's
    ``fold_in`` index), and it has drawn one batch block per segment it
    ran, ``opt.step // local_steps`` (adoption leaves ``opt`` alone)."""
    step = np.asarray(state.opt["step"], np.int32)
    w = step.shape[0]
    return BatchedSGDState(
        params=lm_params_from_numpy(state.params, device),
        opt=opt_state_from_numpy(state.opt, device),
        cert=tensor(np.asarray(state.cert, np.float32), device),
        est=tensor(np.asarray(state.est, np.float32), device),
        stream=tensor(np.arange(1, w + 1, dtype=np.int64), device),
        draws=tensor(step // int(local_steps), device),
    )
