"""Cells of TMSN-SGD on DeepSeek-V3's block (MLA, a leading dense layer,
MoE layers with a sigmoid router, a selection bias and drop-free
dispatch over one chip's share of the experts): W workers, each a whole
model with its AdamW state, gossiping improved models on ``TMSNEngine``.

The run is ``systems/tmsn_sgd.py``'s (set-up through ``warm_rounds``
recorded, then one ``TMSNEngine.run()`` of the same worker as the
window, the check after the program's state is freed), with this
model's own leaf layout and weight draw, Zipf-distributed token ids, its
FLOP count (``counts/moe_mla.py``) and its reference
(``reference/moonlight_l5.py``). The worker is built as the program
builds one for its models: AdamW on the trained leaves only, and the
routers' selection bias set after each step from the step's loads.

The check adds three numbers to the SGD ones: ``moe.route_mismatch``,
the share of step 3's token-choices (after two bias updates) that the
program routed to another expert than the reference; ``moe.rows_gap``,
the rows each held expert computed at step 3 against the choices the
program's router made of it, which the published layer computes each
exactly once (drops and rows computed for absent experts show here);
``moe.router_recheck``, the share of step 3's choices that differ from
the published router's (``ref.router``: the top-k of the sigmoid scores
plus the bias) recomputed in float32 from the program's own router
inputs, weights and bias, which holds the router's rule where bfloat16
activations blur the comparison with the reference's choices; and
``moe.bias_gap``, the mean gap between the program's and the
reference's bias after 3 steps over the layers' experts, in units of
the bias rate (3 where the bias is never stepped, 2 / (layers x E) for
each expert whose load fell on the other side of the mean once).

With ``--trace 1`` the program's tracer is on for the profiled rounds:
its spans (``moe.*``, ``mla.attend``) and its device counters (the rows
each held expert computed) are read once the profiler has stopped.
"""

from __future__ import annotations

import gc
import math
import time

from counts import moe_mla
from harness import lm_inputs
from harness import trace as tr
from harness.core import seed_of
from harness.workers import SpanWorker
from systems.tmsn_sgd import LossProbe, SGDRecorder, _round_entries, delivery

#: the program's spans whose device ms a step the per-layer metrics read
SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared", "moe.bias", "mla.attend")


def layout(arch: dict, std: float = 0.006) -> list:
    """``(name, shape, std)`` of every leaf of the program's tree for this
    block, in its order: the first ``first_k_dense`` layers stacked as
    segment 0 (MLA + SwiGLU MLP), the others as the next (MLA + MoE over
    the held experts). Every weight is drawn at ``std`` (DeepSeek-V3's
    0.006, arXiv:2412.19437 §4.2); a norm's scale is ``w`` in ``1 + w``
    (zeros); the selection bias starts at zeros."""
    d, H, V, L = arch["d_model"], arch["num_heads"], arch["vocab"], arch["num_layers"]
    nd, rd = arch["qk_nope_head_dim"], arch["qk_rope_head_dim"]
    vd, r = arch["v_head_dim"], arch["kv_lora_rank"]
    E, f, F = arch["num_experts"], arch["moe_d_ff"], arch["d_ff"]
    held = arch.get("experts_held") or E
    fs = f * arch["num_shared_experts"]
    dense = arch["first_k_dense"]

    def attn(p, n):
        return [(p + "ln1", (n, d), 0.0),
                (p + "attn.wkv_a", (n, d, r + rd), std),
                (p + "attn.kv_norm", (n, r), 0.0),
                (p + "attn.wkv_b_k", (n, H, nd, r), std),
                (p + "attn.wkv_b_v", (n, H, r, vd), std),
                (p + "attn.wo", (n, H * vd, d), std),
                (p + "attn.wq", (n, d, H * (nd + rd)), std),
                (p + "ln2", (n, d), 0.0)]

    out = [("embed", (V, d), std), ("final_norm", (d,), 0.0)]
    if dense:
        p = "decoder.0.0."
        out += attn(p, dense) + [(p + "mlp.up", (dense, d, F), std), (p + "mlp.down", (dense, F, d), std),
                                 (p + "mlp.gate", (dense, d, F), std)]
    p, n = f"decoder.{1 if dense else 0}.0.", L - dense
    out += attn(p, n) + [
        (p + "moe.router", (n, d, E), std),
        (p + "moe.router_bias", (n, E), 0.0),
        (p + "moe.gate", (n, held, d, f), std),
        (p + "moe.up", (n, held, d, f), std),
        (p + "moe.down", (n, held, f, d), std),
        (p + "moe.shared.up", (n, d, fs), std),
        (p + "moe.shared.down", (n, fs, d), std),
        (p + "moe.shared.gate", (n, d, fs), std),
    ]
    return out + [("lm_head", (d, V), std)]


def make_weights(arch: dict, seed: int, device) -> dict:
    """Float32 weights by name: one normal draw on ``device`` from a
    generator seeded by ``seed``, cut into the drawn leaves in
    :func:`layout`'s order and scaled in place (zeros where the std is 0)."""
    import torch

    leaves = layout(arch)
    total = sum(math.prod(s) for _, s, std in leaves if std)
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 1))
    flat = torch.randn((total,), generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std in leaves:
        if not std:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    return out


def zipf_tokens(seed: int, stream: int, draw: int, shape: tuple, vocab: int, s: float, device):
    """int32 ids in [0, vocab) with P(id) proportional to (id + 1)^-s (id
    = rank), for draw ``draw`` of worker stream ``stream``: inverse CDF
    of uniforms from one generator seeded by the triple."""
    import torch

    rank = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(rank.pow(-s), 0)
    cdf = cdf / cdf[-1]
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 2, stream, draw))
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1).to(torch.int32)


class MoEProbe(LossProbe):
    """``LossProbe`` (losses, the first gradient's norms, the change at
    step 4) plus, while recording, the program's choices at step 3 and the
    rows its held experts computed (its router's and its experts' returns,
    caught in the forward; the recompute is not), the published router's
    choices recomputed in float32 by the reference (``ref.router``) from
    the program's own router inputs, weights and bias at step 3, and the
    selection bias at step 4's forward, per worker."""

    def __init__(self, loss_fn, n_workers: int, local_steps: int, reference=None, arch: dict | None = None):
        super().__init__(loss_fn, n_workers, local_steps)
        self.ref, self.arch = reference, arch
        self.choices, self.recheck, self.rows, self.bias = {}, {}, {}, {}

    def __call__(self, params, batch):
        if not self.recording:
            return super().__call__(params, batch)
        from repro_torch.models import moe

        rnd, worker = divmod(self.calls // self.K, self.W)
        step = rnd * self.K + self.calls % self.K + 1
        if step == 4:
            self.bias[worker] = {n: v.detach().clone() for n, v in lm_inputs.flatten(params).items()
                                 if n.endswith("router_bias")}
        if step != 3:
            return super().__call__(params, batch)
        import torch

        caught, again, ends, route, experts = [], [], [], moe.router, moe.experts_dropless
        ref = self.ref

        def router(params, xt, n_seq, cfg):
            out = route(params, xt, n_seq, cfg)
            caught.append(out[1].detach().clone())
            with torch.no_grad(), ref.exact_matmuls():
                again.append(ref.router(xt.detach().to(torch.float32), params["router"].detach(),
                                        params["router_bias"].detach(), self.arch)[1])
            return out

        def dropless(*args, **kw):
            out = experts(*args, **kw)
            ends.append(out[1][:-1].detach().clone())
            return out

        moe.router, moe.experts_dropless = router, dropless
        try:
            out = super().__call__(params, batch)
        finally:
            moe.router, moe.experts_dropless = route, experts
        self.choices[worker], self.recheck[worker] = caught, again
        self.rows[worker] = [torch.diff(e.to(torch.int64), prepend=e.new_zeros(1).to(torch.int64))
                             for e in ends]
        return out


class TracedRounds(tr.RoundProfiler):
    """The harness's profiler over the traced rounds, with the program's
    tracer on over the same rounds; the tracer's record is collected once
    the profiler has stopped (its one sync falls outside the trace)."""

    program = None

    def _start(self):
        from repro_torch import trace

        super()._start()
        trace.enable()

    def stop(self):
        from repro_torch import trace

        if self.prof is None or len(self.t) > 2:
            return
        trace.disable()
        super().stop()
        self.program = trace.collect()


def build(ctx):
    """The program's worker around a probe on its loss, and the engine's
    configuration for a run's length, every knob pinned."""
    import torch

    from repro_torch.core import TMSNSGDConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.sgd_worker import BatchedSGDWorker
    from repro_torch.models import init_params, loss_fn, state_step_, trained
    from repro_torch.models.config import ArchConfig
    from repro_torch.optim import AdamWConfig

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    arch = ArchConfig(**cfg["arch"])
    want = {n: tuple(s) for n, s, _ in layout(cfg["arch"])}
    have = {n: tuple(t.shape) for n, t in lm_inputs.flatten(init_params(arch, 0, device="meta")).items()}
    if want != have or list(want) != list(have):
        raise RuntimeError(f"the program's parameter tree {have} is not the benchmark's layout {want}")
    K, b, s = traffic["local_steps"], traffic["batch"], traffic["seq"]
    probe = MoEProbe(lambda params, batch: loss_fn(params, arch, batch), cfg["n_workers"], K,
                     reference=ctx.reference, arch=cfg["arch"])

    def init_fn(_seed):
        return lm_inputs.to_tree(make_weights(cfg["arch"], ctx.seed, dev))

    def batch_fn(stream, draw):
        return lm_inputs.lm_batch(tokens(ctx, stream, draw, dev))

    worker = BatchedSGDWorker(
        init_fn=init_fn, loss_fn=probe, batch_fn=batch_fn, opt_cfg=AdamWConfig(**cfg["optimizer"]),
        sgd_cfg=TMSNSGDConfig(local_steps=K, ema=cfg["sgd"]["ema"], width_coef=cfg["sgd"]["width_coef"]),
        device=dev, trained=trained, state_step=lambda params, aux: state_step_(params, arch, aux))

    def engine_config(rounds: int):
        return EngineConfig(n_workers=cfg["n_workers"], max_rounds=rounds, target_certificate=None, seed=0,
                            delay_rounds=traffic["delay_rounds"], record_history=True, **cfg["engine"])

    return worker, engine_config, probe


def tokens(ctx, stream: int, draw: int, dev):
    """One segment's token ids (K, batch, seq) of worker stream ``stream``."""
    tr_, a = ctx.traffic, ctx.cfg["arch"]
    return zipf_tokens(ctx.seed, stream, draw, (tr_["local_steps"], tr_["batch"], tr_["seq"]), a["vocab"],
                       tr_["zipf_s"], dev)


def step_flops(cfg: dict, traffic: dict) -> float:
    a = cfg["arch"]
    keys = ("d_model", "num_heads", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "kv_lora_rank",
            "d_ff",
            "moe_d_ff", "num_experts", "num_experts_per_tok", "num_shared_experts", "experts_held",
            "first_k_dense", "num_layers", "vocab")
    return moe_mla.train_step_flops(**{k: a[k] for k in keys}, batch=traffic["batch"], seq=traffic["seq"])


def program_record(program: dict | None, steps: int, arch: dict, prof) -> dict:
    """From the tracer's record of the traced rounds (``steps`` worker
    steps): device ms a step by span name, the device counters, and the
    grouped products' FLOPs (four passes under remat: the forward, its
    recompute and the backward's two) against their kernel time in the
    profile (the card: kernels of ``aten::_grouped_mm``; the CPU, which
    has none: host time of the ``moe.experts`` ranges)."""
    if not program or steps <= 0:
        return {}
    ms = {n: 0.0 for n in SPANS}
    for sp in program["spans"]:
        if sp["name"] in ms and sp["device_ms"] is not None:
            ms[sp["name"]] += sp["device_ms"]
    counters = program["counters"]
    rows = counters.get("moe.rows", {}).get("")
    out = {"span_ms_per_step": {n: v / steps for n, v in ms.items()}, "steps": steps,
           "counters": {k: v for k, v in counters.items() if k.startswith("moe.")}}
    if rows:
        out["expert_mm_flops"] = moe_mla.expert_mm_flops(sum(rows), arch["d_model"], arch["moe_d_ff"], 4)
        out["expert_mm_s"] = _grouped_mm_seconds(prof)
    return out


def _grouped_mm_seconds(prof) -> float:
    """Device seconds of the grouped products' kernels in the profile (host
    seconds of the ``moe.experts`` ranges where no device is traced)."""
    events = list(prof.events())
    dev = 0.0
    for ev in events:
        if ev.name == "aten::_grouped_mm" and not str(ev.device_type).endswith("CUDA"):
            dev += getattr(ev, "self_device_time_total", 0.0) or 0.0
    if dev > 0:
        return dev / 1e6
    host = sum(ev.time_range.end - ev.time_range.start for ev in events
               if ev.name == "moe.experts" and not str(ev.device_type).endswith("CUDA"))
    return host / 1e6


def run(ctx) -> dict:
    import torch

    from repro_torch.core.engine import TMSNEngine

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    worker, engine_config, probe = build(ctx)
    W, K = cfg["n_workers"], traffic["local_steps"]
    warm = int(traffic["warm_rounds"])

    # ---- set-up: the first rounds, recorded
    probe.start = make_weights(cfg["arch"], ctx.seed, dev)
    probe.recording = True
    recorder = SGDRecorder(worker)
    first = TMSNEngine(recorder, engine_config(warm), device=dev).run()
    sync()
    t_end = time.perf_counter()
    probe.recording, probe.start = False, None
    ends = [*recorder.starts[1:], t_end]
    round_s = min(e - s for s, e in zip(recorder.starts[1:], ends[1:]))
    setup_s = time.perf_counter() - ctx.t_start
    n_rounds = max(warm, math.ceil(ctx.seconds / round_s))

    # ---- the window: one run of the same worker
    spans = tr.Spans(cuda) if ctx.trace else None
    timed, profiler = worker, None
    if spans is not None:
        probe.spans = spans
        timed = SpanWorker(worker, spans, ("scan_round", "adopt_batch"))
        n = traffic["traced_rounds"]
        n_rounds = max(n_rounds, n + 3)
        profiler = TracedRounds(timed, first=n_rounds - n, n=n, cuda=cuda, spans=spans)
        timed = profiler
    t0 = time.perf_counter()
    res = TMSNEngine(timed, engine_config(n_rounds), device=dev).run()
    sync()
    window_s = time.perf_counter() - t0
    if profiler is not None:
        profiler.stop()
    tokens_done = n_rounds * W * K * traffic["batch"] * traffic["seq"]
    res_rounds = res.rounds
    failed = sum(1 for c in res.final_certificates if not math.isfinite(c)) + int(res.rounds != n_rounds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    repeat_bad = int(_round_entries(res.history, K) != _round_entries(first.history, K))

    rec = {"window_s": window_s, "rounds": res.rounds, "steps_per_round": W * K,
           "step_flops": step_flops(cfg, traffic)}
    notes = {}
    if profiler is not None:
        rec["window_s"] -= profiler.wall_s
        rec["rounds"] -= profiler.rounds
        read = spans.read()
        rec["split"] = tr.round_split(read, "scan_round", ("scan_round", "adopt_batch"))
        rec["forward_ms"] = [e - s for k, tag, s, e in read if tag == "forward" and e is not None]
        rec["adopt_ms"] = sum(e - s for k, tag, s, e in read if tag == "adopt_batch" and e is not None)
        rec["rounds_spanned"] = res_rounds
        rec["trace"] = profiler.summary()
        rec["program"] = program_record(profiler.program, profiler.rounds * W * K, cfg["arch"], profiler.prof)
        notes["moe"] = _rows_notes(rec["program"])

    # ---- free the program's state, then the output check
    got = {"losses": {w: [float(x) for x in v] for w, v in probe.losses.items()},
           "grads": {w: {n: float(x) for n, x in v.items()} for w, v in probe.grad_norms.items()},
           "change": {w: {n: float(x) for n, x in v.items()} for w, v in probe.change_norms.items()},
           "choices": probe.choices, "recheck": probe.recheck, "rows": probe.rows, "bias": probe.bias}
    scans = [tuple(x.tolist() for x in scan) for scan in recorder.scans]
    del res, first, worker, timed, recorder, probe, profiler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, check_notes = check(ctx, got, scans, repeat_bad)
    notes.update(check_notes)
    notes["check_s"] = time.perf_counter() - t_check
    return {"setup_s": setup_s, "e2e": {"tokens_per_s": tokens_done / window_s}, "attempted": n_rounds,
            "failed": failed, "memory_peak_bytes": peak, "rec": rec, "checks": checks,
            "notes": {"rounds": n_rounds, "window_s": window_s, "round_s_at_setup": round_s, **notes}}


def _rows_notes(program: dict) -> dict:
    """The held experts' rows over the traced rounds: each expert's, the
    largest over the mean, the most in one layer and step, the dropped."""
    c = program.get("counters", {})
    rows = c.get("moe.rows", {}).get("")
    if not rows:
        return {}
    mean = sum(rows) / len(rows)
    return {"rows": rows, "rows_max_over_mean": max(rows) / mean if mean else None,
            "rows_max": c.get("moe.rows_max", {}).get(""), "dropped": c.get("moe.dropped", {}).get("")}


def reference_runs(ctx, src: list, matmul=None) -> list:
    """The reference's first max(3, K) steps of every worker from the
    benchmark's weights and that worker's token stream, AdamW and the
    bias rule on the first three; at round 2's start worker ``w`` takes
    worker ``src[w]``'s weights and bias (its moments stay its own). With
    ``matmul`` every product is computed by it (the control). Returns per
    worker the losses, the first gradient's norms by leaf, the change
    after three steps by leaf, the first certificate, step 3's choices,
    the rows each held expert computed then, and the bias after three
    steps."""
    import torch

    cfg, traffic, ref = ctx.cfg, ctx.traffic, ctx.reference
    K, W = traffic["local_steps"], cfg["n_workers"]
    n = max(3, K)
    if n > 2 * K:
        raise ValueError(f"the reference follows one adoption: {n} steps span more than two rounds of {K}")
    dev = torch.device(ctx.device)
    start = make_weights(cfg["arch"], ctx.seed, dev)
    kw = {} if matmul is None else {"matmul": matmul}
    learners = [ref.Learner({k: v.clone() for k, v in start.items()}, cfg["arch"], cfg["optimizer"], **kw)
                for _ in range(W)]

    def steps(lo: int, hi: int) -> None:
        for w, lr in enumerate(learners):
            tok = tokens(ctx, w + 1, lo // K, dev)
            for t in range(lo, hi):
                lr.step(lm_inputs.lm_batch(tok[t % K]), update=t < 3)

    with ref.exact_matmuls():
        steps(0, min(K, n))
        if n > K:
            taken = {w: {k: v.clone() for k, v in learners[s].wts.items()}
                     for w, s in enumerate(src) if s != w}
            for w, wts in taken.items():
                learners[w].adopt(wts)
            del taken
            steps(K, n)
    a = cfg["arch"]
    held, lo = a.get("experts_held") or a["num_experts"], a.get("experts_offset", 0)
    return [{"losses": lr.losses, "grad_norms": lr.grad_norms, "change_norms": lr.change_norms(start),
             "cert1": ref.certificate(lr.losses[:K], width_coef=cfg["sgd"]["width_coef"]),
             "choices": lr.choices[2], "recheck": lr.choices[2], "bias": lr.biases(),
             "rows": [torch.stack([(c == lo + e).sum() for e in range(held)]) for c in lr.choices[2]]}
            for lr in learners]


def route_mismatch(got: list, want, n_experts: int) -> float:
    """The share of token-choices routed to an expert that the other side
    did not choose for that token: ``got`` the program's choices by MoE
    layer (t, k), ``want`` the reference's (layers, t, k)."""
    import torch

    if len(got) != len(want) or any(tuple(g.shape) != tuple(w.shape) for g, w in zip(got, want)):
        return math.inf
    miss, total = 0, 0
    for g, w in zip(got, want):
        a = torch.zeros(g.shape[0], n_experts, dtype=torch.bool, device=g.device).scatter_(1, g.long(), True)
        b = torch.zeros_like(a).scatter_(1, w.to(g.device).long(), True)
        miss += int((a & ~b).sum())
        total += g.numel()
    return miss / total if total else math.inf


def rows_gap(rows: list, want, held: int, offset: int) -> float:
    """The rows each held expert computed (``rows`` by MoE layer, (held,))
    against the choices of it in ``want`` (by MoE layer, (t, k)): the sum
    of the gaps over the choices'."""
    import torch

    if len(rows) != len(want):
        return math.inf
    gap, total = 0, 0
    for r, w in zip(rows, want):
        ref = torch.stack([(w == offset + e).sum() for e in range(held)]).to(r.device)
        gap += int((r - ref).abs().sum())
        total += int(ref.sum())
    return gap / max(total, 1)


def gaps(ctx, got: list, refs: list) -> dict:
    """Each compared number, the worst over the workers."""
    ref, out = ctx.reference, {}
    a = ctx.cfg["arch"]
    for g, r in zip(got, refs):
        n = len(r["losses"])
        med = sorted(r["grad_norms"].values())[len(r["grad_norms"]) // 2]
        moved = lambda name, r=r: r["grad_norms"][name] >= 1e-3 * med
        bias_gap = (sum(float((g["bias"][k].to(v.device) - v).abs().sum()) for k, v in r["bias"].items())
                    / sum(v.numel() for v in r["bias"].values())) if g["bias"] else math.inf
        one = {"sgd.loss_gap": max(abs(x - y) / abs(y) for x, y in zip(g["losses"][:n], r["losses"])),
               "sgd.grad_gap": ref.worst_leaf_gap(g["grad_norms"], r["grad_norms"]),
               "sgd.change_gap": ref.worst_leaf_gap(g["change_norms"], r["change_norms"], keep=moved),
               "sgd.cert_gap": abs(g["cert1"] - r["cert1"]) / abs(r["cert1"]),
               "moe.route_mismatch": route_mismatch(g["choices"], r["choices"], a["num_experts"]),
               "moe.router_recheck": route_mismatch(g["choices"], g["recheck"], a["num_experts"]),
               "moe.rows_gap": rows_gap(g["rows"], g["choices"], a.get("experts_held") or a["num_experts"],
                                        a.get("experts_offset", 0)),
               "moe.bias_gap": bias_gap / a["router_bias_rate"]}
        out = {k: max(out.get(k, v), v) for k, v in one.items()}
    return out


def check(ctx, got: dict, scans: list, repeat_bad: int) -> tuple[list, dict]:
    """The reference's readings on every worker's first steps of set-up,
    the worst over the workers, each with its limit; and the protocol
    (``systems/tmsn_sgd.py``'s check). Under ``control`` the control's
    readings take the program's place in the checks, and the program's
    go to the notes."""
    lim, W, eps = ctx.limits, ctx.cfg["n_workers"], ctx.cfg["engine"]["eps"]
    _, post1, fired1 = scans[0]
    src = delivery(post1, fired1, eps)
    refs = reference_runs(ctx, src)
    mine = [{"losses": got["losses"][w], "grad_norms": got["grads"][w], "change_norms": got["change"][w],
             "cert1": post1[w], "choices": got["choices"].get(w, []), "recheck": got["recheck"].get(w, []),
             "rows": got["rows"].get(w, []),
             "bias": got["bias"].get(w, {})}
            for w in range(W)]
    readings = gaps(ctx, mine, refs)
    bad = repeat_bad + int(len(scans) < 2)
    if len(scans) > 1:
        bad += sum(int(scans[1][0][w] != post1[s]) for w, s in enumerate(src))
    readings["sgd.protocol_mismatches"] = bad
    notes = {"adopted_from": src, "losses": [g["losses"][:len(r["losses"])] for g, r in zip(mine, refs)],
             "ref_losses": [r["losses"] for r in refs]}
    if getattr(ctx, "control", False):
        notes["program_checks"] = readings
        control = reference_runs(ctx, src, matmul=ctx.reference.fp8_matmul)
        readings = {**gaps(ctx, control, refs), "sgd.protocol_mismatches": 0}
    return [(k, v, lim[k]) for k, v in readings.items()], notes
