"""What every cell shares: the manifest, the files found by name, the
JAX guard, the device record and the result line.

Nothing here imports torch at module level: the manifest checks and the
CPU tests import this module on machines without a card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
#: top-level module names that may not be loaded in a measuring process
#: (compared whole: ``repro_torch`` is the port and passes)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def seed_of(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers (any size): the same
    parts give the same seed on every machine."""
    h = hashlib.sha256(",".join(str(int(p)) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


class BenchError(RuntimeError):
    """A run that cannot produce a result line (exit nonzero, no result)."""


def load_manifest(path: Path = MANIFEST) -> dict:
    if not path.is_file():
        raise BenchError(f"no manifest at {path}")
    return json.loads(path.read_text())


def manifest_errors(man: dict) -> list[str]:
    """The format rules of ``BENCHMARK.json`` that can be checked without a run."""
    errs = []
    top = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(man) != top:
        errs.append(f"top-level keys {sorted(man)} != {sorted(top)}")
    configs = {c["name"]: c for c in man.get("configs", [])}
    cells = {w["name"]: w for w in man.get("workloads", [])}
    e2e = {m["name"]: m for m in man.get("end_to_end", [])}
    names = [*configs, *cells, *e2e, *(m["name"] for m in man.get("per_layer", []))]
    for n in names:
        if not NAME_RE.match(n):
            errs.append(f"name {n!r} outside the allowed characters")
    if len(set(names)) != len(names):
        errs.append("duplicate names")
    if not 1 <= int(man.get("run_seconds", 0)) <= 51:
        errs.append("run_seconds outside 1..51")
    for c in configs.values():
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            errs.append(f"config {c['name']}: keys {sorted(c)}")
        if not (ROOT / c["file"]).is_file():
            errs.append(f"config {c['name']}: no file {c['file']}")
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                errs.append(f"config {c['name']}: reduced key {k!r}")
    pairs = set()
    for w in cells.values():
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            errs.append(f"cell {w['name']}: keys {sorted(w)}")
        if w["config"] not in configs:
            errs.append(f"cell {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            errs.append(f"cell {w['name']}: chips {w['chips']}")
        if (w["config"], w["traffic"]) in pairs:
            errs.append(f"cell {w['name']}: config and traffic repeat")
        pairs.add((w["config"], w["traffic"]))
        if not (BENCH / "traffic" / f"{w['traffic']}.json").is_file():
            errs.append(f"cell {w['name']}: no traffic file for {w['traffic']}")
        if len(w["why"]) > 200 or "\n" in w["why"]:
            errs.append(f"cell {w['name']}: why longer than a line of 200")
    if "setup_s" not in e2e:
        errs.append("no setup_s")
    for m in [*man.get("end_to_end", []), *man.get("per_layer", [])]:
        if not UNIT_RE.match(m.get("unit", "")):
            errs.append(f"metric {m['name']}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            errs.append(f"metric {m['name']}: better {m.get('better')!r}")
        if m.get("source") not in SOURCES:
            errs.append(f"metric {m['name']}: source {m.get('source')!r}")
        for c in m.get("workloads", []):
            if c not in cells:
                errs.append(f"metric {m['name']}: unknown cell {c}")
    for m in man.get("end_to_end", []):
        if m["source"] not in ("host_clock", "device_trace"):
            errs.append(f"metric {m['name']}: an end-to-end metric from {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            errs.append(f"metric {m['name']}: bound {m['bound']}")
    for m in man.get("per_layer", []):
        if m["moves"] not in e2e:
            errs.append(f"metric {m['name']}: moves unknown {m['moves']}")
            continue
        for c in m.get("workloads", list(cells)):
            if c not in e2e_cells(man, m["moves"]):
                errs.append(f"metric {m['name']}: cell {c} does not report {m['moves']}")
        if not (BENCH / "metrics" / f"{m['name']}.py").is_file():
            errs.append(f"metric {m['name']}: no reader file")
    for name in cells:
        reported = [m for m in man.get("end_to_end", []) if name in e2e_cells(man, m["name"])]
        if len(reported) < 2:
            errs.append(f"cell {name}: reports {len(reported)} end-to-end metrics")
        if not per_layer_for(man, name):
            errs.append(f"cell {name}: no per-layer metric")
    if len(json.dumps(man)) > 64 * 1024:
        errs.append("manifest over 64 KiB")
    return errs


def e2e_cells(man: dict, metric: str) -> list[str]:
    """The cells that report end-to-end ``metric``."""
    m = next(x for x in man["end_to_end"] if x["name"] == metric)
    return m.get("workloads", [w["name"] for w in man["workloads"]])


def end_to_end_for(man: dict, cell: str) -> list[dict]:
    return [m for m in man["end_to_end"] if cell in e2e_cells(man, m["name"])]


def per_layer_for(man: dict, cell: str) -> list[dict]:
    out = []
    for m in man["per_layer"]:
        cells = m.get("workloads", e2e_cells(man, m["moves"]))
        if cell in cells:
            out.append(m)
    return out


def cell_files(man: dict, cell: str) -> tuple[dict, dict, dict, dict]:
    """``(cell entry, config entry, config file, traffic file)``."""
    w = next((x for x in man["workloads"] if x["name"] == cell), None)
    if w is None:
        raise BenchError(f"no workload {cell!r} in the manifest")
    c = next(x for x in man["configs"] if x["name"] == w["config"])
    cfg = json.loads((ROOT / c["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    return w, c, cfg, traffic


def load_file_module(path: Path, name: str):
    """Import one file of the benchmark by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_module(cfg: dict):
    return load_file_module(BENCH / "systems" / f"{cfg['system']}.py", f"bench_system_{cfg['system']}")


def reference_module(config_name: str):
    return load_file_module(BENCH / "reference" / f"{config_name}.py", f"bench_reference_{config_name}")


def read_metric(name: str, rec: dict):
    """The per-layer metric ``name`` from the trace record, or None
    where its reader finds nothing to read."""
    mod = load_file_module(BENCH / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))
    value = mod.read(rec)
    if value is None:
        return None
    value = float(value)
    return value if math.isfinite(value) else None


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def host_loop_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the host's speed at the
    run's end, beside the times it measured (noted, never compared)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def power_limit_w() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown: dict | None = None, notes: dict | None = None) -> str:
    """The last line of standard output; ``checks`` (name, number,
    limit) comes last, where a reader of the line looks for it."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if notes:
        out["notes"] = notes
    # a reading that is no finite number (a fault's) is written as text, so
    # that the line stays JSON
    out["checks"] = {name: {"value": value if math.isfinite(value) else str(value), "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)


def print_checks(checks: list) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for name, value, limit in checks:
        print(f"check {name} value={value!r} limit={limit!r} ok={value <= limit}", file=sys.stderr,
              flush=True)
