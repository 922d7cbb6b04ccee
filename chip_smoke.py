#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and hold every
kernel on it against its plain PyTorch version.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints ``phase <name> ...``; any failure exits nonzero):

  device     the card, its name and power limit (nvidia-smi);
  build      nvcc builds the kernel library from ``src/repro_torch/kernels/csrc``;
  kernels    K1 edge_scan, K2 round_step, K3 queue_ingest against their
             plain versions at the main path's shapes and at large W, and
             K4 weight_update (A, c from scatter_model_slice of a random
             256-stump model) at a full disk refresh (n=180 000, d=64, B=8)
             and two ragged shapes, with times (CUDA events, median of 25
             samples of 20 calls);
  small_ref  a small run of the whole slice on the card (kernels) against
             the same run on the CPU (plain versions);
  main       the paper's configuration (configs/sparrow.py: n=200 000,
             d=64, B=8, W=10, m=18 000, T=256, chunk 2048) through
             TMSNEngine for 200 rounds with K1, K2 and K3 on; every kernel
             must launch at least once per round;
  profile    device time by kernel over 20 rounds of the same run, and
             the device's idle share against the main run's wall time;
  exact      the same run on the dense in-flight buffer and dense control
             plane must give bit-identical certificates and history;
  k4_model   K4 over the training split on the best model of main, the
             whole rule and its second half: the margins must match
             predict_margin and margin_delta_oracle;
  sim_small_ref  a small TMSNSimulator run over the unbatched SparrowWorker
             (kernel K1 on) on the card against the same run on the CPU;
  sim_main   the event simulator at the paper's configuration (W=10,
             worker 9 at speed 0.1) for SIM_EVENTS events, one K1 launch
             per scan segment;
  baselines  exact greedy and GOSS (25 rounds each) on the training split,
             and the bulk-synchronous baseline for 20 rounds.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the rest of
the repository beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and
#: non-tensor float32 rate; the bound of a kernel is the larger of its
#: bytes over the first and its operations over the second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

ROUNDS = 200
SEED = 0
#: events of the sim_main phase (chosen so that it ends within about a minute)
SIM_EVENTS = 2000
ENGINE_KERNELS = ("edge_scan", "round_step", "queue_ingest")


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    # ---------------------------------------------------------------- device
    if not torch.cuda.is_available():
        print("phase device FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops, ref, scatter_model_slice

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"phase device kind={kind} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(smi)

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    path, compile_s = build.build()
    build.load_library()
    log(f"phase build ok seconds={time.perf_counter() - t0:.2f} nvcc_seconds={compile_s:.2f} lib={path.name}")

    # --------------------------------------------------------------- kernels
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def time_ms(fn, reps: int = 20, samples: int = 25) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(samples):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / reps)
        return statistics.median(out)

    def device_ms(fn, reps: int = 20):
        """Device time per call from the profiler's kernel records: the
        sum over every kernel the call launches, without host overhead."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages())
        return total_us / reps / 1e3 if total_us > 0 else None

    def cold_ms(fn, samples: int = 25) -> float:
        """Time of one call with the 50 MB L2 flushed before it, as a
        caller that touches the data once (a full disk refresh) sees it."""
        flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
        fn()
        out = []
        for _ in range(samples):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    records = {}

    def record(name, source, replaces, err, main_shape, ms, plain_ms, bnd, library_ms, dev_ms):
        rec = records.setdefault(name, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0,
        })
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if main_shape:  # the main path's shape sets the times
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                       library_ms=library_ms, device_ms=dev_ms)

    # K1 edge_scan
    for nw, n, d, nb in [(10, 2048, 64, 8), (256, 2048, 64, 8)]:
        xb = torch.randint(0, nb, (nw, n, d), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand((nw, n), generator=g, device=dev) + 0.05
        y = torch.where(torch.rand((nw, n), generator=g, device=dev) < 0.5, 1.0, -1.0)
        wy = w * y
        got = ops.edge_scan(xb, wy, w, num_bins=nb)
        again = ops.edge_scan(xb, wy, w, num_bins=nb)
        plain = ref.edge_scan_ref(xb, wy, w, nb)
        torch.cuda.synchronize()
        det = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
        close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-5) for a, b in zip(got, plain))
        if not (det and close):
            raise AssertionError(f"K1 W={nw}: deterministic={det} allclose(1e-5)={close} err={err}")
        flat = (
            (torch.arange(nw, device=dev).view(nw, 1, 1) * d + torch.arange(d, device=dev).view(1, 1, d))
            * nb + xb.long()
        ).reshape(-1)
        src = wy.unsqueeze(-1).expand(nw, n, d).reshape(-1).contiguous()
        buf = torch.zeros(nw * d * nb, device=dev)
        ms = time_ms(lambda: ops.edge_scan(xb, wy, w, num_bins=nb))
        plain_ms = time_ms(lambda: ref.edge_scan_ref(xb, wy, w, nb))
        lib_ms = time_ms(lambda: buf.index_add_(0, flat, src))
        dev_ms = device_ms(lambda: ops.edge_scan(xb, wy, w, num_bins=nb))
        nbytes = xb.numel() * 4 + 2 * nw * n * 4 + nw * d * nb * 4 + 3 * nw * 4
        bnd = bound(nbytes, nw * n * d * nb + 3 * nw * n)
        log(f"phase kernels K1 edge_scan W={nw} n={n} d={d} B={nb} deterministic={det} "
            f"max_abs_err={err:.3g} ms={ms:.5f} device_ms={dev_ms} plain_ms={plain_ms:.5f} "
            f"index_add_ms={lib_ms:.5f} bound_ms={bnd[0]:.5f} ({bnd[1]})")
        record("edge_scan", "src/repro_torch/kernels/csrc/edge_scan.cu",
               "src/repro/kernels/edge_scan.py:60", err, nw == 10, ms, plain_ms, bnd, lib_ms, dev_ms)

    # K2 round_step and K3 queue_ingest
    for nw in (10, 4096):
        cap = 64
        fill = torch.rand((nw, cap), generator=g, device=dev) < 0.6
        qc = torch.where(fill, -torch.rand((nw, cap), generator=g, device=dev) - 0.01, float("inf"))
        qd = torch.randint(0, 4, (nw, cap), generator=g, device=dev, dtype=torch.int32)
        qs = torch.randint(0, nw, (nw, cap), generator=g, device=dev, dtype=torch.int32)
        ql = torch.randint(0, 3, (nw, cap), generator=g, device=dev, dtype=torch.int32)
        c0 = -torch.rand((nw,), generator=g, device=dev)
        al = torch.rand((nw,), generator=g, device=dev) < 0.8
        cr = torch.rand((nw,), generator=g, device=dev)
        sp = torch.linspace(0.2, 1.0, nw, device=dev)
        args = (qc, qd, qs, ql, c0, al, cr, sp)
        for r in (0, 2):
            got = ops.round_deliver(*args, r, eps=0.01)
            plain = ref.round_step_ref(*args, r, eps=0.01)
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise AssertionError(f"K2 W={nw} r={r}: differs from round_step_ref")
        ms = time_ms(lambda: ops.round_deliver(*args, 2, eps=0.01))
        plain_ms = time_ms(lambda: ref.round_step_ref(*args, 2, eps=0.01))
        dev_ms = device_ms(lambda: ops.round_deliver(*args, 2, eps=0.01))
        nbytes = nw * cap * 20 + nw * 13 + nw * 22
        bnd = bound(nbytes, nw * cap * 10)
        log(f"phase kernels K2 round_step W={nw} C={cap} equal=True ms={ms:.5f} device_ms={dev_ms} "
            f"plain_ms={plain_ms:.5f} bound_ms={bnd[0]:.6f} ({bnd[1]})")
        record("round_step", "src/repro_torch/kernels/csrc/round_step.cu",
               "src/repro/kernels/round_step.py:217", 0.0, nw == 10, ms, plain_ms, bnd, None, dev_ms)
        for m in (1, 8):
            cfill = torch.rand((nw, m), generator=g, device=dev) < 0.6
            cc = torch.where(cfill, -torch.rand((nw, m), generator=g, device=dev) - 0.01, float("inf"))
            cd = torch.randint(0, 6, (nw, m), generator=g, device=dev, dtype=torch.int32)
            cs = torch.randint(0, nw, (nw, m), generator=g, device=dev, dtype=torch.int32)
            cl = torch.randint(0, 3, (nw, m), generator=g, device=dev, dtype=torch.int32)
            iargs = (qc, qd, qs, ql, cc, cd, cs, cl)
            got = ops.queue_ingest(*iargs)
            plain = ref.queue_ingest_ref(*iargs)
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise AssertionError(f"K3 W={nw} m={m}: differs from queue_ingest_ref")
            ms = time_ms(lambda: ops.queue_ingest(*iargs))
            plain_ms = time_ms(lambda: ref.queue_ingest_ref(*iargs))
            dev_ms = device_ms(lambda: ops.queue_ingest(*iargs))
            nbytes = nw * (cap + m) * 16 + nw * cap * 16
            bnd = bound(nbytes, nw * (cap + m) ** 2 * 4)
            log(f"phase kernels K3 queue_ingest W={nw} C={cap} m={m} equal=True ms={ms:.5f} "
                f"device_ms={dev_ms} plain_ms={plain_ms:.5f} bound_ms={bnd[0]:.6f} ({bnd[1]})")
            record("queue_ingest", "src/repro_torch/kernels/csrc/queue_ingest.cu",
                   "src/repro/kernels/round_step.py:155", 0.0, (nw, m) == (10, 1), ms, plain_ms,
                   bnd, None, dev_ms)

    # K4 weight_update, with (A, c) from scatter_model_slice
    from repro_torch.boosting.stumps import StumpModel

    for n, d, nb in [(180_000, 64, 8), (777, 16, 32), (5, 8, 8)]:
        xb = torch.randint(0, nb, (n, d), generator=g, device=dev, dtype=torch.int32)
        y = torch.where(torch.rand((n,), generator=g, device=dev) < 0.5, 1.0, -1.0)
        ml = torch.randn((n,), generator=g, device=dev) * 0.5
        ms_ = torch.randn((n,), generator=g, device=dev) * 0.5
        t = 256
        model = StumpModel(
            feat=torch.randint(0, d, (t,), generator=g, device=dev, dtype=torch.int32),
            thr=torch.randint(0, nb - 1, (t,), generator=g, device=dev, dtype=torch.int32),
            sign=torch.where(torch.rand((t,), generator=g, device=dev) < 0.5, 1.0, -1.0),
            alpha=torch.rand((t,), generator=g, device=dev) * 0.29 + 0.01,
            count=torch.tensor(t, dtype=torch.int32, device=dev),
        )
        a, c = scatter_model_slice(model, 0, t, nb, d)
        a2, c2 = scatter_model_slice(model, torch.tensor(0, device=dev), torch.tensor(t, device=dev), nb, d)
        got = ops.weight_update(xb, y, ml, ms_, a, c, num_bins=nb)
        again = ops.weight_update(xb, y, ml, ms_, a, c, num_bins=nb)
        plain = ref.weight_update_ref(xb, y, ml, ms_, a, c, nb)
        torch.cuda.synchronize()
        det = torch.equal(a, a2) and torch.equal(c, c2) and all(torch.equal(u, v) for u, v in zip(got, again))
        close = all(torch.allclose(u, v, rtol=1e-4, atol=1e-5) for u, v in zip(got, plain))
        err = float((got[0] - plain[0]).abs().max())
        w_rel = float(((got[1] - plain[1]).abs() / plain[1].abs()).max())
        if not (det and close):
            raise AssertionError(f"K4 n={n} d={d} B={nb}: deterministic={det} allclose(1e-4, 1e-5)={close} "
                                 f"margin err={err} w rel err={w_rel}")
        if n == 180_000:
            ms = time_ms(lambda: ops.weight_update(xb, y, ml, ms_, a, c, num_bins=nb))
            cold = cold_ms(lambda: ops.weight_update(xb, y, ml, ms_, a, c, num_bins=nb))
            plain_ms = time_ms(lambda: ref.weight_update_ref(xb, y, ml, ms_, a, c, nb), reps=5, samples=9)
            dev_ms = device_ms(lambda: ops.weight_update(xb, y, ml, ms_, a, c, num_bins=nb))
            nbytes = xb.numel() * 4 + 3 * n * 4 + 2 * n * 4 + a.numel() * 4 + 4
            bnd = bound(nbytes, 2 * n * d * (nb - 1))
            records["weight_update"] = {
                "name": "weight_update", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/weight_update.cu",
                "replaces": "src/repro/kernels/weight_update.py:56", "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None, "device_ms": dev_ms, "cold_ms": cold, "max_rel_err_w": w_rel,
            }
            log(f"phase kernels K4 weight_update n={n} d={d} B={nb} deterministic={det} "
                f"max_abs_err={err:.3g} w_max_rel_err={w_rel:.3g} ms={ms:.5f} cold_ms={cold:.5f} "
                f"device_ms={dev_ms} plain_ms={plain_ms:.5f} bound_ms={bnd[0]:.5f} ({bnd[1]})")
        else:
            rec = records["weight_update"]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err_w"] = max(rec["max_rel_err_w"], w_rel)
            log(f"phase kernels K4 weight_update n={n} d={d} B={nb} deterministic={det} "
                f"max_abs_err={err:.3g} w_max_rel_err={w_rel:.3g}")
        del xb, y, ml, ms_, got, again, plain
    log("phase kernels ok")

    # ------------------------------------------------------------- small_ref
    import numpy as np

    from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker
    from repro_torch.boosting.scanner import ScannerConfig
    from repro_torch.boosting.sparrow import SparrowConfig
    from repro_torch.boosting.stumps import error_rate
    from repro_torch.configs.sparrow import DATA, sparrow_config
    from repro_torch.core.engine import EngineConfig, TMSNEngine
    from repro_torch.data.splice import SpliceConfig, make_splice_like, train_test_split

    def engine_config(w: int, rounds: int, sparse: bool) -> EngineConfig:
        return EngineConfig(
            n_workers=w, max_rounds=rounds, target_certificate=None, seed=SEED, delay_rounds=1,
            inflight_capacity=64 if sparse else 0, control_plane="sparse" if sparse else "dense",
            round_step_impl="pallas", fault_spec="", rounds_per_dispatch=1, gossip_mode="dense",
            spare_slots=0, publish_every_k=0,
        )

    def np_uniforms(stream: int, draw: int) -> float:
        # device-independent offsets, so both devices resample alike
        return float(np.float32(np.random.default_rng([stream, draw]).random()))

    sxb, sy, _ = make_splice_like(SpliceConfig(n=6000, d=16, num_bins=8, seed=3), device="cpu")
    scfg = SparrowConfig(
        sample_size=800, capacity=32, n_workers=4, ess_threshold=0.5,
        scanner=ScannerConfig(chunk_size=256, num_bins=8, gamma0=0.25, use_kernel=True),
    )
    runs = {}
    for name in ("cpu", "cuda"):
        wk = BatchedSparrowWorker(sxb, sy, scfg, device=name, uniforms=np_uniforms)
        runs[name] = TMSNEngine(wk, engine_config(4, 40, True), device=name).run()
    a, b = runs["cpu"], runs["cuda"]
    same_keys = [h[:2] for h in a.history] == [h[:2] for h in b.history]
    cert_err = max(abs(x[2] - y[2]) for x, y in zip(a.history, b.history))
    if not (same_keys and np.allclose(a.final_certificates, b.final_certificates, rtol=1e-5, atol=1e-6)):
        raise AssertionError(f"small_ref: card run differs from the CPU run "
                             f"(same history keys={same_keys}, max cert err={cert_err:.3g})")
    log(f"phase small_ref ok rounds={b.rounds} history={len(b.history)} max_cert_err={cert_err:.3g} "
        f"best={min(b.final_certificates):.6f}")

    # ------------------------------------------------------------------ main
    xb, y, _ = make_splice_like(DATA, device="cuda")
    xtr, ytr, xte, yte = train_test_split(xb, y)
    base = sparrow_config()
    cfg = dataclasses.replace(base, scanner=base.scanner._replace(use_kernel=True))
    worker = BatchedSparrowWorker(xtr, ytr, cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = TMSNEngine(worker, engine_config(cfg.n_workers, ROUNDS, True), device="cuda").run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    best = int(np.argmin(res.final_certificates))
    err = float(error_rate(res.final_models[best], xte, yte))
    minority = float(torch.minimum((yte > 0).float().mean(), (yte < 0).float().mean()))
    log(f"phase main rounds={res.rounds} wall_s={wall:.3f} rounds_per_s={res.rounds / wall:.2f} "
        f"best_cert={res.final_certificates[best]:.6f} stumps={int(res.final_models[best].count)} "
        f"test_error={err:.4f} minority_rate={minority:.4f} max_memory_allocated={peak} "
        f"sent={res.messages_sent} accepted={res.messages_accepted} evicted={res.messages_evicted} "
        f"occupancy_peak={res.inflight_occupancy_peak} launches={json.dumps(launches)}")
    certs = np.asarray(res.final_certificates)
    if res.rounds != ROUNDS or not np.all(np.isfinite(certs)) or not certs.min() < 0:
        raise AssertionError(f"main: rounds={res.rounds}, certificates {certs}")
    for wid in range(cfg.n_workers):
        trace = [h[2] for h in res.history if h[1] == wid]
        if any(b > a for a, b in zip(trace, trace[1:])):
            raise AssertionError(f"main: certificate of worker {wid} rose")
    if not err < minority:
        raise AssertionError(f"main: test error {err} not below the minority rate {minority}")
    if res.messages_evicted != 0:
        raise AssertionError("main: the pending queues evicted messages at C=64")
    for name in ENGINE_KERNELS:
        if launches[name] < res.rounds:
            raise AssertionError(f"main: {name} launched {launches[name]} times in {res.rounds} rounds")
        records[name]["launches"] = launches[name]

    # --------------------------------------------------------------- profile
    # where a round's time goes: device time by kernel over a short run
    # (init_batch included), against the unprofiled main run's wall time
    from torch.profiler import ProfilerActivity, profile

    prof_rounds = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        TMSNEngine(worker, engine_config(cfg.n_workers, prof_rounds, True), device="cuda").run()
        torch.cuda.synchronize()
    # device-side records only: a CPU op's row repeats its kernels' time
    by_kernel = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
        key=lambda k: -k[1],
    )
    busy_ms = sum(k[1] for k in by_kernel) / 1e3 / prof_rounds
    wall_ms = wall / res.rounds * 1e3
    top = [{"kernel": k[0][:60], "ms_per_round": round(k[1] / 1e3 / prof_rounds, 5), "calls": k[2]}
           for k in by_kernel[:8]]
    log(f"phase profile device_ms_per_round={busy_ms:.4f} wall_ms_per_round={wall_ms:.4f} "
        f"device_idle_share={1 - busy_ms / wall_ms:.4f} top={json.dumps(top)}")

    # ----------------------------------------------------------------- exact
    t0 = time.perf_counter()
    dense = TMSNEngine(worker, engine_config(cfg.n_workers, ROUNDS, False), device="cuda").run()
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    if dense.final_certificates != res.final_certificates or dense.history != res.history:
        diff = next((i for i, (a, b) in enumerate(zip(res.history, dense.history)) if a != b), None)
        where = "length" if diff is None else f"entry {diff}: {res.history[diff]} vs {dense.history[diff]}"
        raise AssertionError(f"exact: the dense in-flight/control run differs from the sparse run at {where}")
    log(f"phase exact ok dense==sparse certificates and history ({len(res.history)} entries, "
        f"{dense.rounds} rounds) dense_wall_s={dense_wall:.3f}")

    # -------------------------------------------------------------- k4_model
    # K4 on the model main trained: from zero margins, margin' is the
    # model's margin (whole rule) and the margin delta of its second half
    from repro_torch.boosting.stumps import exp_loss, predict_margin

    model = res.final_models[best]
    count = int(model.count)
    n_tr, d = xtr.shape
    nb = DATA.num_bins
    ones = torch.ones((n_tr,), device=dev)
    zeros = torch.zeros((n_tr,), device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    full_a, full_c = scatter_model_slice(model, 0, count, nb, d)
    m_full, _ = ops.weight_update(xtr, ones, zeros, zeros, full_a, full_c, num_bins=nb)
    half_a, half_c = scatter_model_slice(model, count // 2, count, nb, d)
    m_half, _ = ops.weight_update(xtr, ones, zeros, zeros, half_a, half_c, num_bins=nb)
    torch.cuda.synchronize()
    k4_launches = ops.LAUNCHES["weight_update"]
    want_full = predict_margin(model, xtr)
    want_half = ref.margin_delta_oracle(model, xtr, count // 2, count)
    err_full = float((m_full - want_full).abs().max())
    err_half = float((m_half - want_half).abs().max())
    # both references sum up to 256 float32 terms of up to ~0.5 in sequence
    ok = (torch.allclose(m_full, want_full, rtol=1e-4, atol=1e-4)
          and torch.allclose(m_half, want_half, rtol=1e-4, atol=1e-4))
    log(f"phase k4_model stumps={count} rows={n_tr} launches={k4_launches} max_abs_err_full={err_full:.3g} "
        f"max_abs_err_half={err_half:.3g} "
        f"margin_range=[{float(want_full.min()):.4f}, {float(want_full.max()):.4f}]")
    if not ok or k4_launches < 1:
        raise AssertionError(f"k4_model: K4 margins differ from the model's (full {err_full}, "
                             f"half {err_half}) or K4 launched {k4_launches} times")
    records["weight_update"]["launches"] = k4_launches

    # --------------------------------------------------------- sim_small_ref
    from repro_torch.boosting.sparrow import SparrowWorker
    from repro_torch.core.simulator import SimulatorConfig, TMSNSimulator, WorkerSpec, run_bsp_baseline

    sims = {}
    small_specs = [WorkerSpec(), WorkerSpec(), WorkerSpec(), WorkerSpec(speed=0.1)]
    for name in ("cpu", "cuda"):
        wk = SparrowWorker(sxb, sy, scfg, device=name, uniforms=np_uniforms)
        sims[name] = TMSNSimulator(
            wk, small_specs, SimulatorConfig(n_workers=4, eps=0.0, seed=SEED, max_events=300)
        ).run()
    a, b = sims["cpu"], sims["cuda"]
    same_keys = [h[:2] for h in a.history] == [h[:2] for h in b.history]
    cert_err = max(abs(x[2] - y[2]) for x, y in zip(a.history, b.history))
    if not (same_keys and np.allclose(a.final_certificates, b.final_certificates, rtol=1e-5, atol=1e-6)):
        raise AssertionError(f"sim_small_ref: card run differs from the CPU run "
                             f"(same history keys={same_keys}, max cert err={cert_err:.3g})")
    log(f"phase sim_small_ref ok events={b.events_processed} history={len(b.history)} "
        f"accepted={b.messages_accepted} max_cert_err={cert_err:.3g} best={min(b.final_certificates):.6f}")

    # -------------------------------------------------------------- sim_main
    class CountingSparrow(SparrowWorker):
        """Counts scan segments (one K1 launch each) and resamples."""

        scans = 0
        resamples = 0

        def _scan_one_chunk(self, state):
            self.scans += 1
            return super()._scan_one_chunk(state)

        def _resample(self, state):
            self.resamples += 1
            return super()._resample(state)

    sim_worker = CountingSparrow(xtr, ytr, cfg, device="cuda")
    specs = [WorkerSpec()] * (cfg.n_workers - 1) + [WorkerSpec(speed=0.1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    sres = TMSNSimulator(
        sim_worker, specs, SimulatorConfig(n_workers=cfg.n_workers, eps=0.0, seed=SEED, max_events=SIM_EVENTS)
    ).run()
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    sim_launches = dict(ops.LAUNCHES)
    sim_peak = torch.cuda.max_memory_allocated()
    sbest = int(np.argmin(sres.final_certificates))
    serr = float(error_rate(sres.final_models[sbest], xte, yte))
    sloss = float(exp_loss(sres.final_models[sbest], xte, yte))
    log(f"phase sim_main max_events={SIM_EVENTS} events={sres.events_processed} wall_s={sim_wall:.3f} "
        f"events_per_s={sres.events_processed / sim_wall:.2f} scans={sim_worker.scans} "
        f"resamples={sim_worker.resamples} sent={sres.messages_sent} accepted={sres.messages_accepted} "
        f"sim_time={sres.sim_time:.6g} cost_units={sres.cost_units_total:.6g} "
        f"best_cert={sres.final_certificates[sbest]:.6f} stumps={int(sres.final_models[sbest].count)} "
        f"test_exp_loss={sloss:.4f} test_error={serr:.4f} minority_rate={minority:.4f} "
        f"max_memory_allocated={sim_peak} launches={json.dumps(sim_launches)}")
    scerts = np.asarray(sres.final_certificates)
    if not np.all(np.isfinite(scerts)) or not scerts.min() < 0:
        raise AssertionError(f"sim_main: certificates {scerts}")
    for wid in range(cfg.n_workers):
        trace = [h[2] for h in sres.history if h[1] == wid]
        if any(b > a for a, b in zip(trace, trace[1:])):
            raise AssertionError(f"sim_main: certificate of worker {wid} rose")
    if not serr < minority:
        raise AssertionError(f"sim_main: test error {serr} not below the minority rate {minority}")
    if sim_launches["edge_scan"] != sim_worker.scans or sim_worker.scans == 0:
        raise AssertionError(
            f"sim_main: {sim_launches['edge_scan']} K1 launches for {sim_worker.scans} scans")
    records["edge_scan"]["launches_sim_main"] = sim_launches["edge_scan"]

    # ------------------------------------------------------------- baselines
    from repro_torch.boosting.baselines import BoosterConfig, train_exact_greedy, train_goss

    bcfg = BoosterConfig(num_rounds=25, num_bins=nb, eval_every=24)
    for name, fn in (("exact_greedy", train_exact_greedy), ("goss", train_goss)):
        t0 = time.perf_counter()
        tr = fn(xtr, ytr, bcfg, eval_fn=lambda m: float(exp_loss(m, xte, yte)))
        torch.cuda.synchronize()
        bwall = time.perf_counter() - t0
        berr = float(error_rate(tr.model, xte, yte))
        log(f"phase baselines {name} rounds={bcfg.num_rounds} wall_s={bwall:.3f} "
            f"cost_units={tr.cost[-1]:.6g} test_exp_loss={tr.metric[-1]:.4f} test_error={berr:.4f}")
        if not (tr.metric[-1] < 1.0 and berr < minority):
            raise AssertionError(f"baselines: {name} test loss {tr.metric[-1]}, error {berr}")
    t0 = time.perf_counter()
    bsp = run_bsp_baseline(sim_worker, specs, SimulatorConfig(n_workers=cfg.n_workers, eps=0.0, seed=SEED),
                           rounds=20)
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    bbest = int(np.argmin(bsp.final_certificates))
    bloss = float(exp_loss(bsp.final_models[bbest], xte, yte))
    berr = float(error_rate(bsp.final_models[bbest], xte, yte))
    log(f"phase baselines bsp rounds=20 wall_s={bwall:.3f} sim_time={bsp.sim_time:.6g} "
        f"cost_units={bsp.cost_units_total:.6g} wait_s={sum(bsp.wait_time):.6g} "
        f"best_cert={bsp.final_certificates[bbest]:.6f} test_exp_loss={bloss:.4f} test_error={berr:.4f}")
    if not (bloss < 1.0 and berr < minority):
        raise AssertionError(f"baselines: bsp test loss {bloss}, error {berr}")

    log(json.dumps({"kernels": [records[k] for k in (*ENGINE_KERNELS, "weight_update")]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
