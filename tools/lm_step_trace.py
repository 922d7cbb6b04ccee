#!/usr/bin/env python3
"""Where a TMSN-SGD step's time goes on the card, at Yi-9B's full width
(depth cut to one layer, as chip_smoke.py's lm_sgd phase runs it).

Run from the repository root on a machine with a CUDA card:

    python3 tools/lm_step_trace.py [--trace-dir DIR]

Prints, one ``lm_trace`` line each:

  * the first and the next two calls of a step's parts on one worker's
    model (token draw, forward, backward, the in-place AdamW step), host
    clock around a sync: the first call carries one-time costs;
  * two engine rounds (W = 2, K = 2, batch 2 x 256) under the profiler:
    host syncs (``cudaStreamSynchronize``) a round, the device's busy
    time (the union of its kernel, copy and fill intervals) against the
    traced span, the largest idle gaps, and the top kernels by device time.

With ``--trace-dir`` the round trace is also written there as a Chrome
trace. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def busy_and_gaps(events: list) -> tuple[float, float, list]:
    """(busy us, span us, gaps) over device intervals ``(start, end)``."""
    ivals = sorted(events)
    busy, gaps = 0.0, []
    end = ivals[0][0]
    for s, f in ivals:
        if s > end:
            gaps.append(s - end)
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    return busy, end - ivals[0][0], sorted(gaps, reverse=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lm_trace FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import TMSNEngine, TMSNSGDConfig, lm_sgd_worker
    from repro_torch.core.engine import EngineConfig
    from repro_torch.data.tokens import stream_tokens, synthetic_token_batch
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig, apply_updates_, init_opt_state
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("yi_9b"), num_layers=1)
    opt_cfg = AdamWConfig(lr=3e-4)
    worker = lm_sgd_worker(cfg, opt_cfg, TMSNSGDConfig(local_steps=2), batch_size=2, seq=256, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    params = tree_map(lambda a: a[0].clone(), worker.init_batch(1, 0).params)
    parts: dict = {k: [] for k in ("tokens", "forward", "backward", "adamw")}
    for rep in range(3):
        batch, ms = timed(lambda: synthetic_token_batch(stream_tokens(1, rep, (2, 256), cfg.vocab, "cuda")))
        parts["tokens"].append(ms)
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), params)
        loss, ms = timed(lambda: loss_fn(leaves, cfg, batch)[0])
        parts["forward"].append(ms)
        _, ms = timed(loss.backward)
        parts["backward"].append(ms)
        grads = tree_map(lambda a: a.grad, leaves)
        opt = init_opt_state(params, opt_cfg)
        stepped = tree_map(torch.clone, params)
        _, ms = timed(lambda: apply_updates_(stepped, grads, opt, opt_cfg))
        parts["adamw"].append(ms)
        del leaves, grads, opt, stepped, loss
    print("lm_trace first_and_next_calls_ms " + json.dumps({k: [round(v, 3) for v in vs] for k, vs in parts.items()}),
          flush=True)
    del params

    ecfg = EngineConfig(n_workers=2, max_rounds=3, seed=0, delay_rounds=1, eps=0.0, inflight_capacity=0,
                        control_plane="dense", round_step_impl="pallas", fault_spec="", rounds_per_dispatch=1,
                        gossip_mode="dense", spare_slots=0, publish_every_k=0)
    eng = TMSNEngine(worker, ecfg, device="cuda")
    state = eng._init_state()
    state, _ = eng._round_step(state)  # the first round's one-time costs stay out of the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = eng._round_step(state)
        torch.cuda.synchronize()
    syncs = sum(e.count for e in prof.key_averages() if e.key == "cudaStreamSynchronize")
    if args.trace_dir is not None:
        args.trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace_dir / "lm_rounds.json"))
    dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if str(e.device_type).endswith("CUDA") and e.time_range.end > e.time_range.start]
    busy, span, gaps = busy_and_gaps(dev)
    by_kernel = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
                       key=lambda k: -k[1])
    print(f"lm_trace rounds=2 host_syncs_per_round={syncs / 2:.1f} device_busy_ms_per_round={busy / 2e3:.3f} "
          f"traced_span_ms_per_round={span / 2e3:.3f} idle_share_in_trace={1 - busy / span:.4f} "
          f"largest_gaps_ms={[round(g / 1e3, 3) for g in gaps[:5]]} "
          f"top={json.dumps([(k[:60], round(t / 2e3, 3)) for k, t in by_kernel[:6]])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
