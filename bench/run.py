#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch port (``repro_torch``)
once, on the card, and print its result as the last line of standard
output.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are looked up by name in
``BENCHMARK.json``; the cell's system (``bench/systems/<system>.py``)
sets up, measures for ``--seconds`` and records what the output check
reads; the check (``bench/reference/<config>.py``, limits in
``bench/limits/<cell>.json``) runs once the window has closed. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``bench/metrics/<name>.py``), the
device's busy time and the breakdown. Each number compared is printed
beside its limit as the last lines of standard error, and under
``checks``, the line's last key.

Exits nonzero with no result when the card or the cell's chips are
missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "bench_cache"
# every compiler cache the process may touch, at fixed paths in the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host side of a run is one Python thread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core  # noqa: E402


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START, overrides: dict | None = None,
             control: bool = False) -> tuple[str, list]:
    """One run of ``workload``; returns ``(result line, checks)``.
    ``overrides`` (tests only) replaces keys of the configuration and
    the traffic; ``control`` puts the control in the program's place in
    the checks, so that ``correct`` judges it, and the program's
    readings in the notes (``bench/readings.py`` and the card's tests;
    the benchmark's runs never compute it)."""
    import torch

    torch.set_num_threads(1)
    man = core.load_manifest()
    cell, centry, cfg, traffic = core.cell_files(man, workload)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise core.BenchError("torch.cuda.is_available() is False: no card")
        if torch.cuda.device_count() < cell["chips"]:
            raise core.BenchError(f"{torch.cuda.device_count()} cards, the cell asks for {cell['chips']}")
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    ctx = SimpleNamespace(cell=workload, cfg=cfg, traffic=traffic, seed=int(seed), seconds=float(seconds),
                          trace=bool(trace), device=device, t_start=t_start,
                          reference=core.reference_module(centry["name"]), limits=limits, control=control)
    out = core.system_module(cfg).run(ctx)

    metrics = {}
    if not trace:
        values = {"setup_s": out["setup_s"], **out["e2e"]}
        for m in core.end_to_end_for(man, workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in core.per_layer_for(man, workload):
            v = core.read_metric(m["name"], out["rec"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
               "memory_peak_bytes": out["memory_peak_bytes"], "power_limit": core.power_limit_w()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    breakdown = None
    tr = out["rec"].get("trace") if trace else None
    if tr:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        breakdown = tr["breakdown"]
    checks = out["checks"]
    correct = all(isinstance(v, (int, float)) and not math.isnan(v) and v <= lim for _, v, lim in checks)
    notes = {**out.get("notes", {}), "host_loop_ms": core.host_loop_ms()}
    # last, once everything the run loads (the readers too) is loaded
    loaded = core.forbidden_loaded()
    if loaded:
        raise core.BenchError(f"modules of JAX or the JAX package were loaded: {loaded}")
    line = core.result_line(correct, out["attempted"], out["failed"], metrics, dev, checks, breakdown, notes)
    return line, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except core.BenchError as e:
        print(f"bench: {e}", file=sys.stderr, flush=True)
        return 2
    print(line, flush=True)
    core.print_checks(checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
