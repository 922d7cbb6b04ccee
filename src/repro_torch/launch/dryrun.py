"""The multi-pod dry-run; counterpart of ``src/repro/launch/dryrun.py``.

For every (architecture x input shape x production mesh) it builds the
step's arguments on the ``meta`` device (shapes and dtypes, no memory,
no device and no world: the mesh is ``launch/mesh.py``'s description),
fits the sharding rules (``launch/sharding.py``) to them, and writes one
JSON record with the reference's keys:

  * ``memory.argument_size_in_bytes`` — the bytes one device holds of
    the step's arguments (params, optimizer state, batch or caches):
    each leaf's bytes over the product of the axes its fitted spec names;
    ``fits_hbm`` says whether that is within one H100's 80 GB;
  * ``analytic`` (``launch/analytic.py``), whose flops and bytes are also
    ``hlo_flops`` / ``hlo_bytes``, as in the reference; ``model_flops``,
    ``useful_ratio``, ``params_b``;
  * ``collective_bytes`` — per device and step, by collective kind,
    DERIVED from the sharding plan, never measured (the reference parses
    XLA's optimized HLO; a PyTorch program has none):
      - FSDP: every parameter leaf whose spec names ``data`` is
        all-gathered (output: the leaf gathered over ``data``) in each
        pass that reads it — forward and backward, and the forward's
        recompute under ``remat`` — and its gradient reduce-scattered
        (output: the local shard); a training leaf not sharded over
        ``data`` has its gradient all-reduced over ``data``, and over
        ``pod`` on the multi-pod mesh (output: the local shard);
      - TP: the row-parallel outputs all-reduced over ``model`` in each
        pass: two a transformer layer (attention and MLP), one an SSD
        layer, one for the vocab-sharded embedding, each the device's
        tokens x d_model in the compute dtype;
      - expert parallelism (experts over ``model``): two all-to-alls an
        MoE layer and pass (dispatch, combine), tokens x top-k x the
        capacity factor x d_model;
      - a TMSN-SGD round (``--tmsn``): K local steps of the above over
        the worker's group, then the winner's params and moments sent to
        every worker, counted as the masked all-reduce over the worker
        axis that carries it (output: the local shard);
  * ``terms`` and ``dominant`` — the roofline terms (seconds per device)
    against the H100's published peaks (``launch/mesh.py``): compute at
    989 TFLOP/s bf16, memory at 3.35 TB/s, collectives at 450 GB/s (one
    direction of NVLink).

Records go to the directory the caller names (``--out``), by default
``build/dryrun`` under the checkout.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all [--multipod] [--tmsn]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path
from typing import Any

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.tmsn_sgd import TMSNSGDConfig, tmsn_batch_specs
from repro_torch.launch.analytic import step_counts
from repro_torch.launch.mesh import (
    HBM_BW,
    HBM_BYTES,
    NVLINK_BYTES_PER_S,
    PEAK_FLOPS_BF16,
    axis_sizes,
    data_axes,
    make_production_mesh,
)
from repro_torch.launch.sharding import (
    P,
    batch_pspecs,
    cache_pspecs,
    fit_sharding_tree,
    opt_pspecs,
    param_pspecs,
    shard_divisor,
)
from repro_torch.launch.steps import (
    INPUT_SHAPES,
    batch_specs,
    decode_specs,
    dryrun_cfg,
    opt_config_for,
    shape_applicable,
)
from repro_torch.models import init_params
from repro_torch.models.config import ArchConfig, encoder_segments, layer_segments
from repro_torch.optim import init_opt_state
from repro_torch.tree import DictKey, tree_leaves, tree_leaves_with_path, tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def active_param_fraction(cfg: ArchConfig) -> float:
    """Fraction of parameters active per token (MoE top-k)."""
    if not cfg.num_experts:
        return 1.0
    flat = tree_leaves_with_path(init_params(cfg, 0, device="meta"))
    tot = sum(x.numel() for _, x in flat)
    expert = sum(
        x.numel()
        for kp, x in flat
        if any(isinstance(p, DictKey) and p.key == "moe" for p in kp) and str(kp[-1].key) in ("gate", "up", "down")
    )
    frac_active = cfg.num_experts_per_tok / cfg.num_experts
    return (tot - expert + expert * frac_active) / tot


@dataclasses.dataclass
class Case:
    """One step on the production mesh: its arguments as meta tensors and
    their :class:`NamedSharding` trees (the first argument is always the
    params), the token leaf and its sharding; ``steps`` AdamW steps a
    call (K for a TMSN round)."""

    kind: str  # "train" | "prefill" | "decode" | "tmsn"
    args: tuple
    shardings: tuple
    tokens: torch.Tensor
    tokens_sharding: Any
    steps: int = 1


def build_case(cfg: ArchConfig, shape_name: str, mesh) -> Case:
    seq, gb, kind = INPUT_SHAPES[shape_name]
    dp = data_axes(mesh)
    params_shapes = init_params(cfg, 0, device="meta")
    p_specs = param_pspecs(params_shapes, cfg, mode="train" if kind == "train" else "serve")
    p_sh = fit_sharding_tree(mesh, p_specs, params_shapes)

    if kind == "train":
        opt_cfg = opt_config_for(cfg)
        opt_shapes = init_opt_state(params_shapes, opt_cfg)
        o_sh = fit_sharding_tree(mesh, opt_pspecs(p_specs), opt_shapes)
        b_shapes = batch_specs(cfg, shape_name)
        b_sh = fit_sharding_tree(mesh, batch_pspecs(b_shapes, dp), b_shapes)
        return Case(kind, (params_shapes, opt_shapes, b_shapes), (p_sh, o_sh, b_sh), b_shapes["tokens"],
                    b_sh["tokens"])

    if kind == "prefill":
        b_shapes = batch_specs(cfg, shape_name)
        b_sh = fit_sharding_tree(mesh, batch_pspecs(b_shapes, dp), b_shapes)
        return Case(kind, (params_shapes, b_shapes), (p_sh, b_sh), b_shapes["tokens"], b_sh["tokens"])

    # decode
    d = decode_specs(cfg, shape_name)
    long_ctx = gb == 1
    c_sh = fit_sharding_tree(mesh, cache_pspecs(d["caches"], cfg, dp, long_context=long_ctx), d["caches"])
    tok_sh = fit_sharding_tree(mesh, P(dp, None) if not long_ctx else P(None, None), d["token"])
    pos_sh = fit_sharding_tree(mesh, P(), d["pos"])
    return Case(kind, (params_shapes, d["token"], d["caches"], d["pos"]), (p_sh, tok_sh, c_sh, pos_sh), d["token"],
                tok_sh)


def build_tmsn_case(cfg: ArchConfig, shape_name: str, mesh) -> Case:
    """One TMSN-SGD round: the worker axis is ``pod`` on the multi-pod
    mesh and ``data`` on one pod, where it consumes the FSDP axis (params
    sharded over ``model`` only within a worker)."""
    seq, gb, kind = INPUT_SHAPES[shape_name]
    assert kind == "train"
    sizes = axis_sizes(mesh)
    multi = "pod" in sizes
    w_axis = "pod" if multi else "data"
    tcfg = TMSNSGDConfig(num_workers=sizes[w_axis], local_steps=4, unroll=cfg.scan_unroll)
    opt_cfg = opt_config_for(cfg)
    n_w = tcfg.num_workers

    params_shapes = init_params(cfg, 0, device="meta")

    def lift(spec: P) -> P:
        parts = tuple(spec)
        if not multi:
            parts = tuple(None if p == "data" else p for p in parts)
        return P(w_axis, *parts)

    pw_specs = tree_map(lift, param_pspecs(params_shapes, cfg))
    ow_specs = {"mu": pw_specs, "nu": pw_specs, "step": P(w_axis)}
    b_shapes = tmsn_batch_specs(cfg, tcfg, seq, gb)
    b_specs = tree_map(lambda s: P(w_axis, *((None,) * (len(s.shape) - 1))), b_shapes)
    pw_shapes = tree_map(lambda s: _meta((n_w,) + tuple(s.shape), s.dtype), params_shapes)
    sdt = torch.bfloat16 if opt_cfg.state_dtype == "bfloat16" else torch.float32
    ow_shapes = {"mu": tree_map(lambda s: _meta(tuple(s.shape), sdt), pw_shapes),
                 "nu": tree_map(lambda s: _meta(tuple(s.shape), sdt), pw_shapes),
                 "step": _meta((n_w,), torch.int32)}
    cert_shape = _meta((n_w,), torch.float32)
    b_sh = fit_sharding_tree(mesh, b_specs, b_shapes)
    shardings = (fit_sharding_tree(mesh, pw_specs, pw_shapes), fit_sharding_tree(mesh, ow_specs, ow_shapes),
                 fit_sharding_tree(mesh, P(w_axis), cert_shape), b_sh)
    return Case("tmsn", (pw_shapes, ow_shapes, cert_shape, b_shapes), shardings, b_shapes["tokens"],
                b_sh["tokens"], steps=tcfg.local_steps)


def argument_bytes(case: Case, mesh) -> int:
    """Bytes one device holds of the step's arguments."""
    sizes = axis_sizes(mesh)
    return sum(_nbytes(t) // shard_divisor(sh.spec, sizes)
               for t, sh in zip(tree_leaves(case.args), tree_leaves(case.shardings)))


def _names_axis(spec: P, axis: str) -> bool:
    return any(p == axis or (isinstance(p, tuple) and axis in p) for p in spec)


def collective_bytes(cfg: ArchConfig, case: Case, mesh) -> dict[str, float]:
    """Per-device collective bytes of one call of the case's step, by
    kind, derived from the sharding plan (see the module doc)."""
    sizes = axis_sizes(mesh)
    data, model, pod = sizes.get("data", 1), sizes.get("model", 1), sizes.get("pod", 1)
    train = case.kind in ("train", "tmsn")
    passes = (3 if cfg.remat else 2) if train else 1
    k = case.steps
    out = dict.fromkeys(COLLECTIVES, 0.0)
    params, p_sh = case.args[0], case.shardings[0]
    for leaf, sh in zip(tree_leaves(params), tree_leaves(p_sh)):
        local = _nbytes(leaf) / shard_divisor(sh.spec, sizes)
        if _names_axis(sh.spec, "data") and data > 1:
            out["all-gather"] += k * passes * local * data
            if train:
                out["reduce-scatter"] += k * local
        elif case.kind == "train" and data > 1:
            out["all-reduce"] += local
        if case.kind == "train" and pod > 1:
            out["all-reduce"] += local
    if case.kind == "tmsn":  # the winner's params and moments to every worker
        out["all-reduce"] += sum(_nbytes(t) / shard_divisor(sh.spec, sizes)
                                 for t, sh in zip(tree_leaves(case.args[:2]), tree_leaves(case.shardings[:2])))
    if model > 1:
        cb = {"float32": 4, "bfloat16": 2}[cfg.compute_dtype]
        # tokens a device runs per step: its shard of the token leaf
        tokens = case.tokens.numel() / shard_divisor(case.tokens_sharding.spec, sizes) / k
        seq = case.tokens.shape[-1]
        act = tokens * cfg.d_model * cb
        n_reduce, n_moe = 1, 0  # the vocab-sharded embedding
        for unit, reps in layer_segments(cfg):
            for spec in unit:
                n_reduce += reps * (1 if spec.kind == "ssm" else 2)
                n_moe += reps * (spec.kind == "moe")
        enc_reduce = sum(2 * reps * len(unit) for unit, reps in encoder_segments(cfg))
        enc_act = tokens / seq * cfg.frontend_len * cfg.d_model * cb
        out["all-reduce"] += k * passes * (n_reduce * act + enc_reduce * enc_act)
        if cfg.num_experts % 16 == 0 and cfg.num_experts % model == 0 and n_moe:
            out["all-to-all"] += (k * passes * n_moe * 2 * tokens * cfg.num_experts_per_tok * cfg.capacity_factor
                                  * cfg.d_model * cb)
    return out


OPT_KNOBS_DOC = """--opt applies the optimized configuration:
  * act_dp: the layer stack's activations keep the batch dim sharded,
  * vocab_pad_multiple=256: pad embed/lm_head so the vocab dim shards
    over the 16-way model axis (exact-CE masking on padded columns),
  * windowed_cache: ring caches of a window's size for sliding layers,
  * ssm_chunk=64 (SSM archs): 4x smaller SSD decay-mask temporaries."""


def optimize_cfg(cfg: ArchConfig, mesh) -> ArchConfig:
    kw: dict = dict(act_dp=data_axes(mesh), vocab_pad_multiple=256, windowed_cache=True)
    if cfg.ssm_state:
        kw["ssm_chunk"] = 64
    return dataclasses.replace(cfg, **kw)


def run_one(arch: str, shape_name: str, multi_pod: bool, tmsn: bool = False, opt: bool = False) -> dict:
    cfg = dryrun_cfg(get_config(arch))
    mesh = make_production_mesh(multi_pod=multi_pod)
    if opt:
        cfg = optimize_cfg(cfg, mesh)
    n_chips = mesh.size
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "chips": n_chips,
        "tmsn": tmsn,
        "opt": opt,
    }
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    try:
        t0 = time.perf_counter()
        case = build_tmsn_case(cfg, shape_name, mesh) if tmsn else build_case(cfg, shape_name, mesh)
        rec["build_s"] = round(time.perf_counter() - t0, 3)
        arg_bytes = argument_bytes(case, mesh)
        rec["memory"] = {"argument_size_in_bytes": arg_bytes}
        rec["fits_hbm"] = arg_bytes <= HBM_BYTES
        coll = collective_bytes(cfg, case, mesh)
        rec["collective_bytes"] = coll
        rec["collective_bytes_note"] = "derived from the sharding plan, not measured"
        total_coll = float(sum(coll.values()))

        n_params_total = sum(x.numel() for x in tree_leaves(init_params(cfg, 0, device="meta")))
        ana = step_counts(cfg, INPUT_SHAPES[shape_name], n_params_total)
        if tmsn:
            ana = {k: v * case.steps for k, v in ana.items()}  # one round = K local steps
        rec["analytic"] = ana
        flops = ana["flops"]
        bytes_accessed = ana["weight_bytes"] + ana["act_bytes"] + ana["cache_bytes"]
        rec["hlo_flops"] = flops
        rec["hlo_bytes"] = bytes_accessed

        rec["terms"] = {
            "compute_s": flops / n_chips / PEAK_FLOPS_BF16,
            "memory_s": bytes_accessed / n_chips / HBM_BW,
            "collective_s": total_coll / NVLINK_BYTES_PER_S,
        }
        rec["dominant"] = max(rec["terms"], key=rec["terms"].get)

        seq, gb, kind = INPUT_SHAPES[shape_name]
        n_active = n_params_total * active_param_fraction(cfg)
        tokens = gb * seq if kind != "decode" else gb
        model_flops = (6 if kind == "train" else 2) * n_active * tokens
        rec["model_flops"] = model_flops
        rec["useful_ratio"] = model_flops / max(flops, 1.0)
        rec["params_b"] = n_params_total / 1e9
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — one case's failure is its record's, the sweep goes on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def record_tag(rec: dict) -> str:
    return (f"{rec['arch']}_{rec['shape']}_{rec['mesh']}" + ("_tmsn" if rec["tmsn"] else "")
            + ("_opt" if rec["opt"] else ""))


def main() -> None:
    ap = argparse.ArgumentParser(epilog=OPT_KNOBS_DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--tmsn", action="store_true", help="one TMSN-SGD round (train shapes)")
    ap.add_argument("--opt", action="store_true", help="apply the optimized config")
    ap.add_argument("--out", default=None, help=f"records directory (default {RESULTS_DIR})")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    out_dir = args.out or str(RESULTS_DIR)
    os.makedirs(out_dir, exist_ok=True)

    for arch in archs:
        for shape in shapes:
            if args.tmsn and INPUT_SHAPES[shape][2] != "train":
                continue
            rec = run_one(arch, shape, args.multipod, tmsn=args.tmsn, opt=args.opt)
            tag = record_tag(rec)
            with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            extra = rec.get("reason", rec.get("error", ""))[:90]
            terms = rec.get("terms")
            tstr = (f"c={terms['compute_s']:.3e} m={terms['memory_s']:.3e} x={terms['collective_s']:.3e} "
                    f"dom={rec['dominant']} arg_gb={rec['memory']['argument_size_in_bytes'] / 1e9:.2f}"
                    if terms else "")
            print(f"[{rec['status']:5s}] {tag:55s} {tstr} {extra}", flush=True)


if __name__ == "__main__":
    main()
