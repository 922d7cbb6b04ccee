"""Sharding policy: parameter, batch and cache specs; counterpart of
``src/repro/launch/sharding.py``, rule for rule.

Scheme: tensor parallelism over ``model`` (attention heads, FFN hidden,
experts), FSDP-style parameter sharding over ``data``; the ``pod`` axis
is pure data parallelism (parameters replicated across pods). MoE expert
weights shard the expert dim over ``model`` (expert parallelism) and the
d_model dim over ``data``. Rules are name and rank based and tolerate the
extra leading stack axis of a segment (an extra leading ``None``).

A spec is a :class:`P`, with the reference's ``PartitionSpec`` elements
for each tensor dim: ``None`` (not sharded), a mesh axis name, or a
tuple of names (one dim sharded over several axes, major first). The
rules read the port's parameter and cache trees, which
``init_params``/``init_cache`` build on the ``meta`` device with the
reference's layout. :func:`fit_sharding_tree` turns each spec into
DTensor placements over a mesh: ``Shard(dim)`` on every mesh axis the
spec names for ``dim``, ``Replicate()`` on the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.models.config import ArchConfig
from repro_torch.tree import DictKey, tree_map, tree_map_with_path

FSDP = "data"
TP = "model"


class P:
    """A partition spec: one element per leading tensor dim (the dims
    past the last are not sharded). A leaf of the port's pytrees, unlike
    a tuple; it iterates, indexes and compares as the tuple of its
    elements. A tuple of one axis name is that name, as in JAX."""

    __slots__ = ("parts",)

    def __init__(self, *parts: Any) -> None:
        self.parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other: object) -> bool:
        if isinstance(other, P):
            return self.parts == other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"P{self.parts!r}"


def _base_rule(names: list[str], cfg: ArchConfig) -> tuple | None:
    """Spec elements for the UNSTACKED leaf."""
    leaf = names[-1]
    in_moe = "moe" in names
    in_ssm = "ssm" in names

    if "shared_attn" in names:
        # zamba2's weight-shared block is applied every few layers; FSDP
        # on it would gather it at every application: TP only
        if leaf in ("wq", "wk", "wv", "gate", "up"):
            return (None, TP)
        if leaf in ("wo", "down"):
            return (TP, None)
        return None

    if leaf == "embed":
        return (TP, FSDP)
    if leaf == "lm_head":
        # no FSDP on the head: a contraction dim over `data` would
        # all-reduce (b, s, V) activations; TP on vocab only
        return (None, TP)
    if leaf in ("frontend_proj", "mtp_head"):
        return (None, TP)
    if leaf == "router":
        return (None, None)
    if in_moe and leaf in ("gate", "up"):
        # expert parallelism when E divides the 16-way TP axis; else the
        # expert FFN dim (grok-1 has E = 8)
        if cfg.num_experts % 16 == 0:
            return (TP, FSDP, None)  # (E, d, f)
        return (None, FSDP, TP)
    if in_moe and leaf == "down":
        if cfg.num_experts % 16 == 0:
            return (TP, None, FSDP)  # (E, f, d)
        return (None, TP, FSDP)
    if leaf in ("gate", "up"):
        return (FSDP, TP)
    if leaf == "down":
        return (TP, FSDP)
    if leaf in ("wq", "wk", "wv", "wq_b"):
        return (FSDP, TP) if leaf != "wq_b" else (None, TP)
    if leaf == "wo":
        return (TP, FSDP)
    if leaf in ("wq_a", "wkv_a"):
        return (FSDP, None)
    if leaf in ("wkv_b_k", "wkv_b_v"):
        return (TP, None, None)
    if in_ssm and leaf == "in_proj":
        return (FSDP, TP)
    if in_ssm and leaf == "out_proj":
        return (TP, FSDP)
    if in_ssm and leaf in ("conv_w",):
        return (None, TP)
    if in_ssm and leaf in ("conv_b", "norm"):
        return (TP,)
    # norms, biases, scalars per head (a_log, dt_bias, D), kv_norm, q_norm
    return None  # replicate


def _axes(part: Any) -> tuple:
    return part if isinstance(part, tuple) else (part,)


def fit_spec(spec: P, shape: tuple[int, ...], axis_sizes: dict[str, int]) -> P:
    """Drop sharding axes that don't evenly divide the dimension (a
    shard must be exact). E.g. vocab = 50280 can't shard 16-way ->
    replicated; kv_heads = 4 over a 16-way axis -> local."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        size = 1
        for a in _axes(part):
            size *= axis_sizes[a]
        out.append(part if dim % size == 0 else None)
    return P(*out)


def shard_divisor(spec: P, axis_sizes: dict[str, int]) -> int:
    """How many ways a leaf with ``spec`` is split: the product of the
    sizes of every axis the spec names (its bytes on one device are its
    bytes over this)."""
    n = 1
    for part in spec:
        if part is not None:
            for a in _axes(part):
                n *= axis_sizes[a]
    return n


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's fitted spec over ``mesh`` and its DTensor placements, one
    per mesh axis (``torch.distributed.tensor.distribute_tensor(t, mesh,
    placements)`` lays the leaf out)."""

    mesh: Any
    spec: P
    placements: tuple


def placements(spec: P, names: tuple) -> tuple:
    """DTensor placements over a mesh with axes ``names`` for ``spec``:
    ``Shard(dim)`` on every axis the spec names for ``dim``,
    ``Replicate()`` on the others. A dim sharded over a tuple of axes
    splits major first (JAX's order), which DTensor gives only when the
    tuple lists them in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        idx = [names.index(a) for a in _axes(part)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {part} are not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def fit_sharding_tree(mesh, spec_tree, shape_tree):
    """A :class:`NamedSharding` tree with per-leaf divisibility fixes;
    ``mesh`` is a ``DeviceMesh`` or a production mesh description."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)

    def one(spec: P, leaf) -> NamedSharding:
        fitted = fit_spec(spec, tuple(leaf.shape), sizes)
        return NamedSharding(mesh, fitted, placements(fitted, names))

    return tree_map(one, spec_tree, shape_tree)


def _names(path) -> list[str]:
    return [str(p.key) for p in path if isinstance(p, DictKey)]


def _serve_rule(rule: tuple | None, names: list[str]) -> tuple | None:
    """Serving keeps weights resident: no FSDP over ``data`` for 2-D
    weights (a gather a token would dominate decode). 3-D expert weights
    stay 2-D sharded (E replicated or over model, d over data, f over
    model) so giants still fit."""
    if rule is None:
        return None
    if len(rule) == 3 and "moe" in names:
        return (None, FSDP, TP)
    return tuple(None if r == FSDP else r for r in rule)


def param_pspecs(params_shapes, cfg: ArchConfig, mode: str = "train"):
    """Spec pytree matching a params (shape) pytree.

    mode: "train" (FSDP + TP) or "serve" (TP-resident; see _serve_rule).
    """

    def spec_for(path, leaf):
        names = _names(path)
        rule = _base_rule(names, cfg)
        if mode == "serve":
            rule = _serve_rule(rule, names)
        if rule is None:
            return P()
        rank = len(leaf.shape)
        pad = rank - len(rule)
        if pad < 0:  # e.g. reduced configs; replicate rather than crash
            return P()
        return P(*((None,) * pad + tuple(rule)))

    return tree_map_with_path(spec_for, params_shapes)


def opt_pspecs(params_pspecs):
    """Optimizer state mirrors the params sharding; step is replicated."""
    return {"mu": params_pspecs, "nu": params_pspecs, "step": P()}


def batch_pspecs(batch_shapes, dp: tuple[str, ...], shard_batch: bool = True):
    lead = dp if shard_batch else None
    return tree_map(lambda leaf: P(*((lead,) + (None,) * (len(leaf.shape) - 1))), batch_shapes)


def cache_pspecs(cache_shapes, cfg: ArchConfig, dp: tuple[str, ...], long_context: bool):
    """Decode-cache specs, keyed on rank and ``shape[2]``, over the port's
    cache layout (``init_cache``), which is the reference's leaf for leaf.

    Normal decode: batch over the data axes, everything else local.
    Long context (batch 1): the cache *sequence* dim over ``model``
    (a flash-decoding split). SSM states shard heads over ``model``.
    """

    def spec_for(leaf):
        shape = leaf.shape
        rank = len(shape)
        if rank == 5:  # (reps, b, S, K, hd) kv OR (reps, b, H, N, P) ssm state
            if shape[2] >= 4096:  # kv caches: shape[2] is max_len
                return P(None, None if long_context else dp, TP, None, None)
            return P(None, dp if not long_context else None, TP, None, None)
        if rank == 4:  # (reps, b, S, r) mla latent or (reps, b, k-1, ch) conv
            if shape[2] >= 4096:
                return P(None, None if long_context else dp, TP, None)
            return P(None, dp if not long_context else None, None, TP)
        return P()

    return tree_map(spec_for, cache_shapes)
