"""Minimal npz checkpointing of the port's pytrees; counterpart of
``src/repro/checkpoint/ckpt.py``, file for file.

A leaf is stored under the reference's path key: dict keys and list or
tuple indices joined by ``/``, a NamedTuple field as ``.field``; ``None``
is an empty subtree and stores nothing. A bfloat16 leaf is written as
the reference writes it, a 2-byte void array (``|V2``) of the same bits,
since numpy has no bfloat16 of its own. So a checkpoint the JAX package
writes loads here, and one written here has the reference's keys,
dtypes and bytes.

Loading reads a ``|V2`` array into a bfloat16 leaf through a 16-bit
integer view (the reference cannot load its own bfloat16 leaves: numpy
has no cast from a void array). Every loaded leaf goes to its template
leaf's device and dtype.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path, tree_map_with_path


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
    return leaf.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 bits
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.to(device=like.device, dtype=like.dtype)


def save_checkpoint(path: str, tree: Any) -> None:
    arrays = {_path_str(p): _to_numpy(v) for p, v in tree_leaves_with_path(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (a pytree of tensors whose
    shapes, dtypes and devices the loaded leaves take). Raises
    ``KeyError`` for a key the file lacks and ``ValueError`` for a shape
    that differs, as the reference does."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:

        def load(p: tuple, v: torch.Tensor) -> torch.Tensor:
            key = _path_str(p)
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {tuple(v.shape)}")
            return _from_numpy(arr, v)

        return tree_map_with_path(load, like)
