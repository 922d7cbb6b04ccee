#!/usr/bin/env python3
"""Where a hand-written kernel's device time goes, stage by stage, on the
card: builds copies of ``src/repro_torch/kernels/csrc/edge_scan.cu`` (K1),
``round_step.cu`` (K2) and ``queue_ingest.cu`` (K3) with one stage cut
out, and times each copy
through the normal wrapper (``kernels/ops.py``) with the profiler's device
records. Only the ``full`` copy computes the right result; the others
exist to be timed. Run from the repository root on a machine with a card
and ``nvcc``:

    python3 tools/kernel_stage_ablation.py

Prints one ``ablation`` line per kernel and shape, each stage's copy with
its device ms per call, beside the card's name and power limit. The copies
are built under ``build/ablation/`` (``.gitignore`` lists ``build/``).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: K1 copies: which stage each one cuts
K1_CUTS = {
    "full": [],
    "no_ticket": [("  if (tiles == 1) return;\n", "  return;\n")],
    "no_rows": [("    if (rl < R && fq < Q) {", "    if (false) {")],
    "no_rows_no_ticket": [("  if (tiles == 1) return;\n", "  return;\n"),
                          ("    if (rl < R && fq < Q) {", "    if (false) {")],
    "no_lane_sum": [("    for (int c = tid; c < pass_cells; c += kThreads) {",
                     "    for (int c = tid; c < 0; c += kThreads) {")],
    "empty": [("  const int tile0 = blockIdx.x * fold;",
               "  if (n >= 0) return;\n  const int tile0 = blockIdx.x * fold;")],
}
#: K2 copies
K2_CUTS = {
    "full": [],
    "no_reduction": [("  for (int o = L >> 1; o > 0; o >>= 1) {", "  for (int o = 0; o > 0; o >>= 1) {")],
    "no_queue_loads": [("    if (ok) {\n      Vec<VEC>::load(q_cert", "    if (false) {\n      Vec<VEC>::load(q_cert")],
    "empty": [("  const int L = 1 << lanes_log2;", "  if (W >= 0) return;\n  const int L = 1 << lanes_log2;")],
}
#: K3 copies
K3_CUTS = {
    "full": [],
    "no_rank": [("    for (int j = 0; j < n; ++j) rank +=", "    for (int j = 0; j < 0; ++j) rank +=")],
    "empty": [("  extern __shared__ ulonglong2 keys[];",
               "  extern __shared__ ulonglong2 keys[];\n  if (W >= 0) return;")],
}


def build_copies(build, source: str, cuts: dict, entry: str) -> dict:
    text = (build.CSRC / source).read_text()
    out = ROOT / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in cuts.items():
        copy = text
        for old, new in edits:
            if old not in copy:
                raise RuntimeError(f"{source}: the {name} cut no longer matches the source")
            copy = copy.replace(old, new)
        cu = out / f"{Path(source).stem}_{name}.cu"
        cu.write_text(copy)
        cmd = [build.find_nvcc(), *build.FLAGS, "-shared", "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy of {source}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{Path(source).stem}_{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_stage_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, ops, ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    def device_ms(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()) / reps / 1e3

    def timed(libs: dict, fn) -> str:
        row = []
        for name, lib in libs.items():
            saved = build.load_library
            build.load_library = lambda lib=lib: lib  # the wrappers import it at each call
            try:
                row.append(f"{name}={device_ms(fn):.5f}")
            finally:
                build.load_library = saved
        return " ".join(row)

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k1 = build_copies(build, "edge_scan.cu", K1_CUTS, "edge_scan_launch")
    for nw, n in [(10, 2048), (256, 2048), (1, 2048), (1, 180_000)]:
        xb = torch.randint(0, 8, (nw, n, 64), generator=g, device=dev, dtype=torch.int32)
        w = torch.randint(1, 65, (nw, n), generator=g, device=dev).float() / 64
        wy = w * torch.where(torch.rand((nw, n), generator=g, device=dev) < 0.5, 1.0, -1.0)
        saved = build.load_library
        build.load_library = lambda: k1["full"]
        try:
            got = ops.edge_scan(xb, wy, w, num_bins=8)
        finally:
            build.load_library = saved
        ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-5) for a, b in zip(got, ref.edge_scan_ref(xb, wy, w, 8)))
        print(f"ablation K1 W={nw} n={n} d=64 B=8 plan={ops.edge_scan_plan(nw, n, sms)} full_allclose={ok} "
              f"device_ms {timed(k1, lambda: ops.edge_scan(xb, wy, w, num_bins=8))}", flush=True)
    k2 = build_copies(build, "round_step.cu", K2_CUTS, "round_step_launch")
    for nw in (10, 4096, 10240):
        fill = torch.rand((nw, 64), generator=g, device=dev) < 0.6
        args = (torch.where(fill, -torch.rand((nw, 64), generator=g, device=dev) - 0.01, float("inf")),
                torch.randint(0, 4, (nw, 64), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, nw, (nw, 64), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, 3, (nw, 64), generator=g, device=dev, dtype=torch.int32),
                -torch.rand((nw,), generator=g, device=dev), torch.rand((nw,), generator=g, device=dev) < 0.8,
                torch.rand((nw,), generator=g, device=dev), torch.linspace(0.2, 1.0, nw, device=dev))
        saved = build.load_library
        build.load_library = lambda: k2["full"]
        try:
            got = ops.round_deliver(*args, 2, eps=0.01)
        finally:
            build.load_library = saved
        ok = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                             b.view(torch.int32) if b.dtype == torch.float32 else b)
                 for a, b in zip(got, ref.round_step_ref(*args, 2, eps=0.01)))
        print(f"ablation K2 W={nw} C=64 plan={ops.round_step_plan(nw, 64, sms)} full_bitwise_equal={ok} "
              f"device_ms {timed(k2, lambda: ops.round_deliver(*args, 2, eps=0.01))}", flush=True)
    k3 = build_copies(build, "queue_ingest.cu", K3_CUTS, "queue_ingest_launch")
    for nw, m in [(10, 1), (4096, 1), (4096, 8)]:
        def leaves(k):
            fill = torch.rand((nw, k), generator=g, device=dev) < 0.6
            return (torch.where(fill, -torch.rand((nw, k), generator=g, device=dev) - 0.01, float("inf")),
                    torch.randint(0, 6, (nw, k), generator=g, device=dev, dtype=torch.int32),
                    torch.randint(0, nw, (nw, k), generator=g, device=dev, dtype=torch.int32),
                    torch.randint(0, 3, (nw, k), generator=g, device=dev, dtype=torch.int32))

        args = leaves(64) + leaves(m)
        print(f"ablation K3 W={nw} C=64 m={m} plan={ops.queue_ingest_plan(nw, 64 + m, sms)} "
              f"device_ms {timed(k3, lambda: ops.queue_ingest(*args))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
