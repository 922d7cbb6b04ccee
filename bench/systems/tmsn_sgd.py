"""Cells of TMSN-SGD: W language-model workers, each a whole model with
its AdamW state, gossiping improved models on ``TMSNEngine``.

Set-up draws the weights from ``--seed`` on the device (one draw, cut
into leaves), builds one ``BatchedSGDWorker`` around the program's loss
and the benchmark's token streams, and drives it through its first
rounds (``warm_rounds``) by ``TMSNEngine.run()``: every shape of the
window is then warm, and a probe on the loss and a recorder on the
worker keep what the output check reads (each step's loss, the first
step's gradient as the optimizer gets it, the change of the parameters
after three steps, the certificates and the adoptions). The window is
one ``TMSNEngine.run()`` of the same worker, long enough for
``--seconds`` at set-up's round time; its first round repeats set-up's
bit for bit, which the check holds.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

from counts import lm as counts_lm
from harness import lm_inputs
from harness import trace as tr
from harness.workers import SpanWorker, Wrapped


class LossProbe:
    """The worker's ``loss_fn``: the program's loss, with a span around
    each forward, and while ``recording`` the step losses, the first
    step's gradient norms by leaf (hooks on the leaves the step
    differentiates) and each leaf's distance from the start at the
    fourth step's forward, per worker."""

    def __init__(self, loss_fn, n_workers: int, local_steps: int):
        self.fn, self.W, self.K = loss_fn, n_workers, local_steps
        self.spans, self.recording, self.start, self.calls = None, False, None, 0
        self.losses, self.grad_norms, self.change_norms = {}, {}, {}

    def __call__(self, params, batch):
        if self.recording:
            i = self.calls
            self.calls += 1
            rnd, worker = divmod(i // self.K, self.W)
            step = rnd * self.K + i % self.K + 1
            named = lm_inputs.flatten(params)
            if step == 1:
                norms = self.grad_norms.setdefault(worker, {})
                for name, leaf in named.items():
                    leaf.register_hook(lambda g, name=name: norms.__setitem__(name, _norm(g)))
            if step == 4:
                self.change_norms[worker] = {n: _norm(v.detach() - self.start[n]) for n, v in named.items()}
        item = self.spans.open("forward") if self.spans is not None else None
        loss, aux = self.fn(params, batch)
        if item is not None:
            self.spans.close(item)
        if self.recording:
            self.losses.setdefault(worker, []).append(loss.detach().clone())
        return loss, aux


def _norm(t):
    import torch

    return torch.linalg.vector_norm(t.detach(), dtype=torch.float64)


class SGDRecorder(Wrapped):
    """Each round's certificates before and after the scan, the fired
    flags, and the host time at each scan's start."""

    def __init__(self, worker):
        super().__init__(worker)
        self.scans, self.starts = [], []

    def scan_round(self, state, mask):
        self.starts.append(time.perf_counter())
        pre = state.cert.clone()
        new, cost, fired = self.worker.scan_round(state, mask)
        self.scans.append((pre, new.cert.clone(), fired.clone()))
        return new, cost, fired


def build(ctx):
    """The program's worker around a probe on its loss, and the engine's
    configuration for a run's length, every knob pinned."""
    import torch

    from repro_torch.core import TMSNSGDConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.sgd_worker import BatchedSGDWorker
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.config import ArchConfig
    from repro_torch.optim import AdamWConfig

    cfg, traffic, dev = ctx.cfg, ctx.traffic, torch.device(ctx.device)
    arch = ArchConfig(**cfg["arch"])
    want = {n: tuple(s) for n, s, _ in lm_inputs.layout(cfg["arch"])}
    have = {n: tuple(t.shape) for n, t in lm_inputs.flatten(init_params(arch, 0, device="meta")).items()}
    if want != have:
        raise RuntimeError(f"the program's parameter tree {have} is not the benchmark's layout {want}")
    K, b, s = traffic["local_steps"], traffic["batch"], traffic["seq"]
    probe = LossProbe(lambda params, batch: loss_fn(params, arch, batch), cfg["n_workers"], K)

    def init_fn(_seed):
        return lm_inputs.to_tree(lm_inputs.make_weights(cfg["arch"], ctx.seed, dev))

    def batch_fn(stream, draw):
        tok = lm_inputs.tokens(ctx.seed, stream, draw, (K, b, s), cfg["arch"]["vocab"], dev)
        return lm_inputs.lm_batch(tok)

    worker = BatchedSGDWorker(
        init_fn=init_fn, loss_fn=probe, batch_fn=batch_fn, opt_cfg=AdamWConfig(**cfg["optimizer"]),
        sgd_cfg=TMSNSGDConfig(local_steps=K, ema=cfg["sgd"]["ema"], width_coef=cfg["sgd"]["width_coef"]),
        device=dev)

    def engine_config(rounds: int):
        return EngineConfig(n_workers=cfg["n_workers"], max_rounds=rounds, target_certificate=None, seed=0,
                            delay_rounds=traffic["delay_rounds"], record_history=True, **cfg["engine"])

    return worker, engine_config, probe


def step_flops(cfg: dict, traffic: dict) -> float:
    a = cfg["arch"]
    return counts_lm.train_step_flops(
        d_model=a["d_model"], num_heads=a["num_heads"], num_kv_heads=a["num_kv_heads"],
        head_dim=a.get("head_dim") or a["d_model"] // a["num_heads"], d_ff=a["d_ff"], vocab=a["vocab"],
        num_layers=a["num_layers"], batch=traffic["batch"], seq=traffic["seq"])


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
    probe.start = lm_inputs.make_weights(cfg["arch"], ctx.seed, dev)
    probe.recording = True
    recorder = SGDRecorder(worker)
    first = TMSNEngine(recorder, engine_config(warm), device=dev).run()
    sync()
    t_end = time.perf_counter()
    probe.recording, probe.start = False, None
    # the quickest warm round after the first, adoption included, sets
    # the window's length
    ends = [*recorder.starts[1:], t_end]
    round_s = min(e - s for s, e in zip(recorder.starts[1:], ends[1:]))
    setup_s = time.perf_counter() - ctx.t_start
    n_rounds = max(warm, math.ceil(ctx.seconds / round_s))

    # ---- the window: one run of the same worker
    spans = tr.Spans(cuda) if ctx.trace else None
    timed = worker
    profiler = None
    if spans is not None:
        probe.spans = spans
        timed = SpanWorker(worker, spans, ("scan_round", "adopt_batch"))
        # the window's last rounds are traced: the profiler leaves no round after it
        n = traffic["traced_rounds"]
        n_rounds = max(n_rounds, n + 3)
        profiler = tr.RoundProfiler(timed, first=n_rounds - n, n=n, cuda=cuda, spans=spans)
        timed = profiler
    t0 = time.perf_counter()
    res = TMSNEngine(timed, engine_config(n_rounds), device=dev).run()
    sync()
    window_s = time.perf_counter() - t0
    if profiler is not None:
        profiler.stop()
    tokens = n_rounds * W * K * traffic["batch"] * traffic["seq"]
    res_rounds = res.rounds
    failed = sum(1 for c in res.final_certificates if not math.isfinite(c)) + int(res.rounds != n_rounds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    repeat_bad = int(_round_entries(res.history, K) != _round_entries(first.history, K))

    rec = {"window_s": window_s, "rounds": res.rounds, "steps_per_round": W * K,
           "step_flops": step_flops(cfg, traffic)}
    if profiler is not None:
        # the whole-step metric reads the untraced rounds and their time
        rec["window_s"] -= profiler.wall_s
        rec["rounds"] -= profiler.rounds
    if spans is not None:
        read = spans.read()
        rec["split"] = tr.round_split(read, "scan_round", ("scan_round", "adopt_batch"))
        rec["forward_ms"] = [e - s for k, tag, s, e in read if tag == "forward" and e is not None]
        rec["adopt_ms"] = sum(e - s for k, tag, s, e in read if tag == "adopt_batch" and e is not None)
        rec["rounds_spanned"] = res_rounds
        rec["trace"] = profiler.summary()

    # ---- free the program's state, then the output check
    losses = {w: [float(x) for x in v] for w, v in probe.losses.items()}
    grads = {w: {n: float(x) for n, x in v.items()} for w, v in probe.grad_norms.items()}
    change = {w: {n: float(x) for n, x in v.items()} for w, v in probe.change_norms.items()}
    scans = [tuple(x.tolist() for x in scan) for scan in recorder.scans]
    del res, first, worker, timed, recorder, probe, profiler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, notes = check(ctx, losses, grads, change, scans, repeat_bad)
    notes["check_s"] = time.perf_counter() - t_check
    return {"setup_s": setup_s, "e2e": {"tokens_per_s": tokens / window_s}, "attempted": n_rounds,
            "failed": failed, "memory_peak_bytes": peak, "rec": rec, "checks": checks,
            "notes": {"rounds": n_rounds, "window_s": window_s, "round_s_at_setup": round_s, **notes}}


def _round_entries(history, k: int) -> list:
    """The history's entries of round 1 (cost clock k), as exact floats."""
    return sorted((int(w), float(c)) for clock, w, c in history if float(clock) == float(k))


def delivery(certs: list, fired: list, eps: float) -> list:
    """The source of each worker's model at the next round's start, with
    delay one round: the best certificate another worker fired, where it
    beats the worker's own by more than eps; else the worker itself."""
    out = []
    for w, own in enumerate(certs):
        best, src = min(((c, v) for v, c in enumerate(certs) if v != w and fired[v]), default=(math.inf, w))
        out.append(src if best < own - eps else w)
    return out


def reference_runs(ctx, src: list, matmul=None) -> list:
    """The reference's first max(3, K) steps of every worker from the
    benchmark's weights and that worker's token stream, AdamW on the
    first three; at round 2's start worker ``w`` takes worker
    ``src[w]``'s weights (its moments stay its own). With ``matmul``
    every product is computed by it (the control). Returns per worker
    the losses, the first gradient's norms by leaf, the change after
    three steps by leaf and the first certificate."""
    import torch

    cfg, traffic, ref = ctx.cfg, ctx.traffic, ctx.reference
    K, W = traffic["local_steps"], cfg["n_workers"]
    n = max(3, K)
    if n > 2 * K:
        raise ValueError(f"the reference follows one adoption: {n} steps span more than two rounds of {K}")
    dev = torch.device(ctx.device)
    start = lm_inputs.make_weights(cfg["arch"], ctx.seed, dev)
    kw = {} if matmul is None else {"matmul": matmul}
    learners = [ref.Learner({k: v.clone() for k, v in start.items()}, cfg["arch"], cfg["optimizer"], **kw)
                for _ in range(W)]

    def steps(lo: int, hi: int) -> None:
        for w, lr in enumerate(learners):
            tok = lm_inputs.tokens(ctx.seed, w + 1, lo // K, (K, traffic["batch"], traffic["seq"]),
                                   cfg["arch"]["vocab"], dev)
            for t in range(lo, hi):
                lr.step(lm_inputs.lm_batch(tok[t % K]), update=t < 3)

    with ref.exact_matmuls():
        steps(0, min(K, n))
        if n > K:
            taken = {w: {k: v.clone() for k, v in learners[s].wts.items()} for w, s in enumerate(src) if s != w}
            for w, wts in taken.items():
                learners[w].adopt(wts)
            del taken
            steps(K, n)
    return [{"losses": lr.losses, "grad_norms": lr.grad_norms, "change_norms": lr.change_norms(start),
             "cert1": ref.certificate(lr.losses[:K], width_coef=cfg["sgd"]["width_coef"])} for lr in learners]


def gaps(ctx, got: list, refs: list) -> dict:
    """Each compared number, the worst over the workers: ``got`` (per
    worker: losses, grad_norms, change_norms, cert1) against the
    reference's ``refs``."""
    ref, out = ctx.reference, {}
    for g, r in zip(got, refs):
        n = len(r["losses"])
        med = statistics.median(r["grad_norms"].values())
        moved = lambda name, r=r: r["grad_norms"][name] >= 1e-3 * med
        one = {"sgd.loss_gap": max(abs(a - b) / abs(b) for a, b in zip(g["losses"][:n], r["losses"])),
               "sgd.grad_gap": ref.worst_leaf_gap(g["grad_norms"], r["grad_norms"]),
               "sgd.change_gap": ref.worst_leaf_gap(g["change_norms"], r["change_norms"], keep=moved),
               "sgd.cert_gap": abs(g["cert1"] - r["cert1"]) / abs(r["cert1"])}
        out = {k: max(out.get(k, v), v) for k, v in one.items()}
    return out


def check(ctx, losses, grads, change, scans, repeat_bad: int) -> tuple[list, dict]:
    """The reference's readings on every worker's first steps of set-up,
    the worst over the workers, each with its limit
    (``bench/limits/<cell>.json``); and the protocol: round 2 starts from
    round 1's certificates after delivery with delay one and the
    eps-gated accept, bit for bit. The reference adopts as the program
    did: its certificates, held to the reference's by ``sgd.cert_gap``,
    decide. Under ``control`` the control's readings take the program's
    place in the checks, and the program's go to the notes."""
    lim, W, eps = ctx.limits, ctx.cfg["n_workers"], ctx.cfg["engine"]["eps"]
    _, post1, fired1 = scans[0]
    src = delivery(post1, fired1, eps)
    refs = reference_runs(ctx, src)
    got = [{"losses": losses[w], "grad_norms": grads[w], "change_norms": change[w], "cert1": post1[w]}
           for w in range(W)]
    readings = gaps(ctx, got, refs)
    bad = repeat_bad + int(len(scans) < 2)
    if len(scans) > 1:
        bad += sum(int(scans[1][0][w] != post1[s]) for w, s in enumerate(src))
    readings["sgd.protocol_mismatches"] = bad
    notes = {"adopted_from": src, "losses": [g["losses"][:len(r["losses"])] for g, r in zip(got, refs)],
             "ref_losses": [r["losses"] for r in refs]}
    if getattr(ctx, "control", False):
        notes["program_checks"] = readings
        readings = {**gaps(ctx, reference_runs(ctx, src, matmul=ctx.reference.fp8_matmul), refs),
                    "sgd.protocol_mismatches": 0}
    return [(k, v, lim[k]) for k, v in readings.items()], notes
