#!/usr/bin/env python3
"""The readings the output check's limits are set from: the program's
and the control's, for many seeds in one process, optionally with a
fault planted underneath (``bench/faults.py``). Not run by the
benchmark's own runs.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 [--fault NAME] [--seconds 1]

Without ``--fault`` each run puts the control in the program's place,
so that the run's own ``correct`` judges it, and keeps the program's
readings beside it. Prints one JSON line a seed (each compared number:
the program's, and the control's) and a last line with the largest of
each over the seeds; exits 1 where a control came out correct.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import run  # noqa: F401  (puts src/ and bench/ on the path, fixes the cache directories)

from harness import core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from faults import FAULTS

    man = core.load_manifest()
    _, _, cfg, _ = core.cell_files(man, args.workload)
    worst: dict = {}
    controls_correct: list = []
    for seed in (int(s) for s in args.seeds.split(",")):
        plant = FAULTS[cfg["system"]][args.fault]() if args.fault else contextlib.nullcontext()
        t0 = time.perf_counter()
        with plant:
            line, _ = run.run_cell(args.workload, seed, args.seconds, False, device=args.device,
                                   t_start=t0, control=args.fault is None)
        out = json.loads(line)
        checked = {k: float(v["value"]) for k, v in out["checks"].items()}
        program = checked if args.fault else out["notes"]["program_checks"]
        row = {"seed": seed, "correct": out["correct"], "fault": args.fault, "program": program,
               "program_within_limits": all(program[k] <= v["limit"] for k, v in out["checks"].items()),
               "control": None if args.fault else checked, "seconds": time.perf_counter() - t0,
               "kind": out["device"]["kind"], "power_limit": out["device"].get("power_limit")}
        if args.fault is None and out["correct"]:
            controls_correct.append(seed)
        print("readings " + json.dumps(row), flush=True)
        for side in ("program", "control"):
            for k, v in (row[side] or {}).items():
                worst.setdefault(side, {})[k] = max(worst.get(side, {}).get(k, v), v)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print("readings_max " + json.dumps({"workload": args.workload, "fault": args.fault, **worst}), flush=True)
    if controls_correct:
        print(f"readings: the control came out correct on seeds {controls_correct}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
