"""Cells of TMSN-SGD on Nemotron-H's hybrid block (single-mixer blocks in
a layer pattern: grouped Mamba-2, the MoE with a sigmoid router, a
selection bias, relu^2 experts and drop-free dispatch over one chip's
share of the experts, GQA without positions): W workers, each a whole
model with its AdamW state, gossiping improved models on ``TMSNEngine``.

The run, the probe, the Zipf token ids and the check are
``systems/tmsn_sgd_moe.py``'s (the ``sgd.*`` and ``moe.*`` gaps against
the reference, ``reference/<config>.py``), run by a second instance of
that module whose leaf layout, weight draw, FLOP count
(``counts/nemotron_h.py``) and record of the program's tracer are this
model's: :func:`layout`, :func:`make_weights`, :func:`step_flops` and
:func:`program_record` below take the place of its own.

With ``--trace 1`` the program's tracer is on for the profiled rounds:
its spans (``ssm.mixer``, ``ssm.scan``, ``moe.*``) and counters (the
rows each held expert computed, ``ssm_calls``, ``attention_calls``) are
read once the profiler has stopped.
"""

from __future__ import annotations

import math
from pathlib import Path

from counts import nemotron_h
from harness import core
from harness.core import seed_of

#: the program's spans whose device ms a step the per-layer metrics read
SPANS = ("ssm.mixer", "ssm.scan", "moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared",
         "moe.bias")
#: the tracer's counters the record keeps
COUNTERS = ("moe.", "ssm_calls", "attention_calls")
#: Mamba-2's initialisation: A = -U(1, 16), dt = exp U(log 0.001, log 0.1)
#: floored at 1e-4 (Nemotron-H's ``time_step_min``, ``_max`` and
#: ``_floor``; the configuration file states them and a test holds them equal)
A_RANGE, DT_RANGE, DT_FLOOR = (1.0, 16.0), (0.001, 0.1), 1e-4


def _runs(pattern: str) -> list:
    """``(character, layers)`` a run of equal characters: the program's
    segments, in order."""
    out = []
    for ch in pattern:
        if out and out[-1][0] == ch:
            out[-1] = (ch, out[-1][1] + 1)
        else:
            out.append((ch, 1))
    return out


def layout(arch: dict, std: float = 0.02) -> list:
    """``(name, shape, std)`` of every leaf of the program's tree for this
    stack, in its order, each segment stacked over its run of layers.
    Weights are drawn at ``std`` (Nemotron-H's initializer range); a
    norm's scale is ``w`` in ``1 + w`` (zeros); the selection bias and the
    conv's bias start at zeros; the conv's taps at PyTorch's default for a
    depthwise ``Conv1d`` of width k (uniform of bound k^-1/2: std (3 k)^-1/2),
    which Mamba-2 keeps; ``A_log``, ``dt_bias`` and ``D`` as Mamba-2
    initialises them (the std a tag :func:`make_weights` reads)."""
    d, V = arch["d_model"], arch["vocab"]
    H, P, N, G = arch["ssm_heads"], arch["ssm_head_dim"], arch["ssm_state"], arch["ssm_groups"]
    di, k, ch = H * P, arch["ssm_conv_width"], H * P + 2 * G * N
    Hq, K, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    E, f = arch["num_experts"], arch["moe_d_ff"]
    held, fs = arch.get("experts_held") or E, f * arch["num_shared_experts"]
    out = [("embed", (V, d), std), ("final_norm", (d,), 0.0)]
    for seg, (c, n) in enumerate(_runs(arch["layer_pattern"])):
        p = f"decoder.{seg}.0."
        out.append((p + "ln1", (n, d), 0.0))
        if c == "M":
            out += [(p + "ssm.in_proj", (n, d, di + ch + H), std),
                    (p + "ssm.conv_w", (n, k, ch), (3 * k) ** -0.5),
                    (p + "ssm.conv_b", (n, ch), 0.0),
                    (p + "ssm.a_log", (n, H), "a_log"),
                    (p + "ssm.dt_bias", (n, H), "dt_bias"),
                    (p + "ssm.D", (n, H), "one"),
                    (p + "ssm.norm", (n, di), 0.0),
                    (p + "ssm.out_proj", (n, di, d), std)]
        elif c == "E":
            out += [(p + "moe.router", (n, d, E), std),
                    (p + "moe.router_bias", (n, E), 0.0),
                    (p + "moe.up", (n, held, d, f), std),
                    (p + "moe.down", (n, held, f, d), std),
                    (p + "moe.shared.up", (n, d, fs), std),
                    (p + "moe.shared.down", (n, fs, d), std)]
        else:
            out += [(p + "attn.wq", (n, d, Hq * hd), std),
                    (p + "attn.wk", (n, d, K * hd), std),
                    (p + "attn.wv", (n, d, K * hd), std),
                    (p + "attn.wo", (n, Hq * hd, d), std)]
    return out + [("lm_head", (d, V), std)]


def make_weights(arch: dict, seed: int, device) -> dict:
    """Float32 weights by name: one normal draw on ``device`` from a
    generator seeded by ``seed``, cut into the drawn leaves in
    :func:`layout`'s order and scaled in place (zeros where the std is
    0); then Mamba-2's ``A_log = log U(A_RANGE)`` and ``dt_bias``, the
    inverse softplus of ``dt = exp U(log DT_RANGE)`` floored at
    ``DT_FLOOR``, from a uniform draw of a second generator, and ``D =
    1``."""
    import torch

    leaves = layout(arch)
    drawn = [(n, s, std) for n, s, std in leaves if isinstance(std, float) and std]
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 1))
    flat = torch.randn((sum(math.prod(s) for _, s, _ in drawn),), generator=g, device=device,
                       dtype=torch.float32)
    u = torch.Generator(device=device)
    u.manual_seed(seed_of(seed, 3))
    out, off = {}, 0
    for name, shape, std in leaves:
        if std == "a_log":
            lo, hi = A_RANGE
            out[name] = torch.log(lo + (hi - lo) * torch.rand(shape, generator=u, device=device))
        elif std == "dt_bias":
            lo, hi = (math.log(t) for t in DT_RANGE)
            dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=u, device=device)).clamp(min=DT_FLOOR)
            out[name] = dt + torch.log(-torch.expm1(-dt))
        elif std == "one":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif not std:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
    return out


def step_flops(cfg: dict, traffic: dict) -> float:
    a = cfg["arch"]
    return nemotron_h.train_step_flops(
        pattern=a["layer_pattern"], d_model=a["d_model"], ssm_heads=a["ssm_heads"],
        ssm_head_dim=a["ssm_head_dim"], ssm_state=a["ssm_state"], ssm_groups=a["ssm_groups"],
        ssm_chunk=a["ssm_chunk"], num_heads=a["num_heads"], num_kv_heads=a["num_kv_heads"],
        head_dim=a["head_dim"], moe_d_ff=a["moe_d_ff"], num_experts=a["num_experts"],
        num_experts_per_tok=a["num_experts_per_tok"], num_shared_experts=a["num_shared_experts"],
        experts_held=a.get("experts_held") or a["num_experts"], vocab=a["vocab"], batch=traffic["batch"],
        seq=traffic["seq"])


def program_record(program: dict | None, steps: int, arch: dict, prof) -> dict:
    """From the tracer's record of the traced rounds (``steps`` worker
    steps): device ms a step by span name, the counters, and the held
    experts' grouped products' FLOPs (two products, four passes under
    remat: the forward, its recompute and the backward's two) against
    their kernel time in the profile (``tmsn_sgd_moe``'s reading)."""
    if not program or steps <= 0:
        return {}
    ms = {n: 0.0 for n in SPANS}
    for sp in program["spans"]:
        if sp["name"] in ms and sp["device_ms"] is not None:
            ms[sp["name"]] += sp["device_ms"]
    counters = program["counters"]
    rows = counters.get("moe.rows", {}).get("")
    out = {"span_ms_per_step": {n: v / steps for n, v in ms.items()}, "steps": steps,
           "counters": {k: v for k, v in counters.items() if k.startswith(COUNTERS)}}
    if rows:
        out["expert_mm_flops"] = nemotron_h.expert_mm_flops(sum(rows), arch["d_model"], arch["moe_d_ff"], 4)
        out["expert_mm_s"] = _base._grouped_mm_seconds(prof)
    return out


#: ``systems/tmsn_sgd_moe.py`` once more, with this model's pieces in its place
_base = core.load_file_module(Path(__file__).with_name("tmsn_sgd_moe.py"),
                              "bench_system_tmsn_sgd_hybrid_base")
_base.layout, _base.make_weights, _base.step_flops, _base.program_record = (
    layout, make_weights, step_flops, program_record)


def run(ctx) -> dict:
    """One run of the cell (``tmsn_sgd_moe.run``)."""
    return _base.run(ctx)
