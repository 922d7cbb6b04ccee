#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and hold every
kernel on it against its plain PyTorch version.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints ``phase <name> ...``; any failure exits nonzero):

  device     the card, its name and power limit (nvidia-smi);
  build      nvcc builds the kernel library from ``src/repro_torch/kernels/csrc``;
  kernels    the launch floor (a one-element fill); K1 edge_scan, K2
             round_step, K3 queue_ingest against their plain versions at the
             main path's shapes, at the sharded and pod ranks' (W=5, K3 with
             m=2 and 4), the pod phase's single device (W=20) and at large W
             (K1 at W=256, folding each group of tiles in a block; K2 at
             W=10, 4096 and 10240,
             bit for bit and on a second launch), K1 also at W=1 (n=2048 and
             n=180 000), K2 also on edge cases (+-0.0 ties, +-inf, NaN, ties
             in cert and src, due=-1, dead rows, C=1, C % 4 != 0, C=3500,
             ragged W, leaves off a 16-byte boundary, the signed-zero rows),
             K3 also on edge cases (+-0.0, +-inf, duplicates,
             due=-1, C+m > 64, C=1, m > C), K2 on rows with identical due
             entries and dues beyond r and K3 on candidate blocks of
             duplicate pairs (what fault injection gives them); K4 weight_update (A, c from
             scatter_model_slice of a random 256-stump model) at a full
             disk refresh (n=180 000, d=64, B=8) and two ragged shapes;
             times by CUDA events (median of 25 samples of 20 calls) and by
             the profiler's device records, K1's beside index_add_'s; K1's
             repeat check: K1_REPEATS launches at each of K1_REPEAT_SHAPES,
             bit for bit the first launch's outputs, the ticket counters
             kept between launches zero after each, in this process and in
             K1_REPEAT_PROCESSES fresh ones (``chip_smoke.py --k1-repeat N``),
             then compute-sanitizer's racecheck where the machine has it
             (its result recorded, not held); K5 adamw_step at Yi-9B's
             one-layer leaf shapes (12 leaves, 697 315 328 parameters, one
             launch) bit for bit the plain AdamW update for each pair of
             float32/bfloat16 params and moments and on a second launch,
             and at float32 its device and CUDA-event ms beside the bytes
             bound, the plain update's and torch._fused_adamw_'s (a
             yardstick; ``chip_smoke.py --k5`` runs the build and K5 alone);
             K6 attention (forward and backward) against ``_sdpa`` in
             float32 from the same bf16 inputs at K6_CASES (head 128:
             Yi-9B's heads at 4096 with one and two sequences, ragged
             lengths, a window, positions not the index) and K6_MLA_CASES
             (keys 192, values 128: MLA expanded at Moonlight's 16 heads,
             at ``sgd_zipf_4k``'s shape among them, and DeepSeek-V3's 128),
             block by block to K6_TOL, with the bf16 ``_sdpa``'s errors
             beside it, bit for bit on a repeat, and at ``sgd_long``'s and
             ``sgd_zipf_4k``'s shapes its device ms by kernel (held within
             K6_DEVICE_VS_EVENTS of its CUDA-event ms) against the causal
             FLOP bound, with the plain ``_sdpa``'s and
             ``scaled_dot_product_attention``'s ms (a yardstick;
             ``chip_smoke.py --k6`` runs the build and K6 alone);
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
  chaos      the main configuration under the engine's chaos features,
             each run against main's result: a clean rerun (the baseline
             for the faulted runs' overhead), a spare joining at round 1
             and duplication (both bit-identical to main), auto capacity
             (bit-identical), corruption (rejected, monotone, repeats bit
             for bit), churn with drops and reorder (kernels bit-identical
             to their plain versions on the card) and a publisher (rounds at
             chunk boundaries, falling certificates, the last snapshot the
             best model); then clean, dup and corrupt runs of 60 rounds in
             three turns for the faulted round's cost; K1-K3 launches go
             into the record as launches_chaos;
  chaos_small_ref  a composed fault plan with a join and a publisher at the
             small_ref size, on the card (kernels) against the CPU (plain);
  sharded    the sharded engine (core/engine_sharded.py), ranks started by
             launch/mesh.py::spawn_world: sharded_main, the main
             configuration on 2 gloo ranks sharing the card (W_local=5),
             dense and gated gossip, each equal to main in certificates,
             history, accepted and evicted; sharded_nccl1, ShardedTMSNEngine
             on one NCCL rank, equal to main in every counter; sharded_w4096,
             a toy at W=4096 on 4 gloo ranks (K2 and K3 over 1024 rows a
             rank), equal to the single-device run on the card. Per rank:
             wall and collective host ms per round, K1-K3 launches, bytes per
             round against the reference's formula; launches_sharded in the
             kernels line sums every rank;
  pod        the sharded engine on the two-tier (pod, workers) mesh: one
             world of 4 gloo ranks sharing the card in 2 pods of 2
             (spawn_world(..., pods=2)). pod_main, the main configuration at
             W=20 (W_local=5, W_pod=10; only W and the depth differ from
             main), cross_pod_every_k = cross_pod_top_k = 1, dense and gated
             gossip, each equal to a single-device W=20 run on the card in
             certificates, history, accepted and evicted; pod_k8, the same at
             cross_pod_every_k=8 (its divergence from pod_main reported, its
             DCN bytes 1/8 of pod_main's, ICI bytes the same, certificates
             monotone); pod_partition, pod_main dense under a partition
             window of rounds [50, 120) (messages dropped, monotone). Per
             rank: wall and collective host ms per round, collectives per
             round by tier, K1-K3 launches (K3 twice a round at k=1: tier 1
             and the flush), ICI and DCN bytes per round against the
             reference's formulas, and the wire seconds derived from them;
             launches_pod in the kernels line sums every rank;
  k4_model   K4 over the training split on the best model of main, the
             whole rule and its second half: the margins must match
             predict_margin and margin_delta_oracle;
  sim_small_ref  a small TMSNSimulator run over the unbatched SparrowWorker
             (kernel K1 on) on the card against the same run on the CPU;
  sim_main   the event simulator at the paper's configuration (W=10,
             worker 9 at speed 0.1) for SIM_EVENTS events, one K1 launch
             per scan segment;
  baselines  exact greedy and GOSS (25 rounds each, histograms through K1)
             on the training split, each twice with bitwise-equal models
             and test losses, and the bulk-synchronous baseline for 20
             rounds. K1's launch count in the kernels line sums main,
             sim_main and baselines;
  lm_small_ref  the dense LM stack on reduced(yi_9b) in float32, built on
             the CPU from a seed and copied to the card: loss, grads, one
             AdamW step, prefill and 4 decode steps against the CPU at rtol
             1e-4 / atol 1e-5; then TMSN-SGD (W=4, K=2, 8 rounds) through
             TMSNEngine against oracle_run on the card, bit for bit
             (certificates, history and per-leaf param checksums);
  lm_sgd     TMSN-SGD at Yi-9B's full width (d_model 4096, 32 heads, 4 KV
             heads, d_ff 11008, vocab 64 000; depth cut to LM_LAYERS = 1,
             params float32, compute bfloat16, remat), W=2, K=2, batch 2 x
             256, AdamW lr 3e-4, dense in-flight state, delay 1, eps 0, 6
             rounds: certificates finite and monotone, fires and broadcasts,
             the payload 4 bytes a parameter; a second run of 2 rounds and
             oracle_run over 3 bit for bit the run; ms per round (CUDA
             events at each segment's start), tokens/s, achieved TFLOP/s
             (6 x matmul params x tokens), ms of a forward+backward and of
             an AdamW step, the device idle share and top kernels over 2
             profiled rounds, peak memory; the run's K5 launches, one
             a worker step, and K6's, two forwards (remat) and one backward
             a layer a worker step (held; K5's ``launches`` and K6's
             ``launches_fwd`` and ``launches_bwd`` in the kernels line);
             then the best model serves: a
             2 x 128 prefill and 16 cached decode steps at scalar and at
             per-row pos (bit for bit alike), each position's logits within
             LM_BF16_TOL of the full forward through ``_sdpa``, the decode's
             own attention steps; the full forward through K6, which the
             prefill runs, no farther from the float32 forward than the
             one through ``_sdpa``. No TPU kernel lies on this
             path; K5 and K6 are the port's own;
  serve_small_ref  the continuous-batching server (launch/serving.py) on
             reduced(yi_9b) in float32, built on the CPU from a seed: a run
             with continuous admission (10 requests over 4 slots) and one
             adoption on the card against the same run on the CPU, tokens,
             versions and counting metrics equal; prefill and 4 in-place
             decode steps' logits at rtol 1e-4 / atol 1e-5;
  serve      the server on Yi-9B at full width AND depth (48 layers, bf16
             params and compute: launch/steps.py::dryrun_cfg, 8 829 407 232
             parameters) on one card: a no-publish serve() (batch 8, prompt
             1024, 32 tokens) equal token for token to the legacy loop
             (batched prefill, rebuffer_caches, the scalar-pos serve step);
             a server of 8 slots x (1024 + 128) whose signature counts after
             warmup are prefill 2, decode 1, insert 1; row independence (a
             request's tokens beside other prompts, and admitted into a
             retired row against a row of zeros, bit for bit); 24 requests
             (max_new 16 + 16 (i % 8)) without adoption, then with two
             snapshots (inits from seeds 1 and 2, in host memory) published
             at decode steps 20 and 60: 2 adoptions, none dropped, no new
             signature, the parameters written in place, tokens changed.
             Prints every run() metric, the memory_reserved growth after
             warmup, batched and single-row prefill ms (CUDA events), and 20
             profiled decode steps' wall and device ms, idle share and bytes
             bound (parameters and the K/V read once);
  serve_live TMSN-SGD at lm_sgd's shape (LIVE_ROUNDS rounds, publisher at
             every improvement) in a thread, and a 4-slot server of the same
             model shape on the same card serving LIVE_REQUESTS requests from
             the adoption slot, paced as examples/serve_live.py paces it: at
             least one adoption, none dropped, no new signature, the served
             certificate one that was published, peak memory below
             LIVE_PEAK_LIMIT. The serving phases launch none of K1-K4
             (launches_serve in the kernels line);
  families_small_ref  reduced() of each decoder-only family (deepseek_v3_671b:
             MLA, MoE with a shared expert, MTP; grok1_314b: top-2 MoE;
             gemma3_12b: 1 local : 1 global; mamba2_1p3b: SSD; zamba2_1p2b:
             SSD and the shared attention block) in float32, built on the CPU
             from a seed: loss, every gradient, prefill logits and 16 greedy
             tokens on the card twice, the same bits (the MoE scatter and the
             SSD cumsum), and against the CPU (tokens equal, values within
             rtol 1e-4 / atol 1e-5 of each output's scale); a 16-step
             teacher-forced decode against the full forward at 2e-2;
  serve_mamba2  the server on Mamba2-1.3B at full width AND depth (48 SSD
             layers, d_model 2048, state 128; bf16 params and compute,
             1 446 714 368 parameters), 8 slots x (1024 + 128): the serve
             phase's load of 24 requests without adoption and then with two
             snapshots published at steps 20 and 60; every run() metric,
             batched and single-row prefill ms, 20 profiled decode steps' wall
             and device ms against the bytes bound (weights read once, the
             SSD state and conv tails read and written once);
  serve_deepseek  DeepSeek-V3 at full width, depth cut 61 -> 4 (first_k_dense
             = 3 dense MLA layers, 1 MoE layer of 256 routed experts top-8 and
             a shared expert, MTP; bf16, 15 162 481 664 parameters), 4 slots
             x (512 + 64), 12 requests (max_new 16 + 16 (i % 4)): run()
             metrics, prefill ms, the decode step against its bytes bound
             (every expert's weights read once a step); then one loss with
             its gradients on 1 x 256 tokens (bf16 gradients beside the
             params); its MLA prefill and loss run K6's 192/128 instance
             (launches_serve_deepseek in the kernels line);
  families_full  a 2 x 2048 prefill and 32 greedy decode steps through
             serve() for Gemma3-12B at full width, depth cut 48 -> 6 (one 5:1
             unit), Zamba2-1.2B whole and Grok-1 at full width, depth cut
             64 -> 1; bf16. Gemma3's ring caches (windowed_cache, the prompt
             longer than the 1024 window) against full ones: in bf16,
             teacher-forced logits within LM_BF16_TOL of each row's scale and
             the free-running tokens reported; in float32 compute, the same tokens. The family
             phases launch none of K1-K4 (launches_families in the kernels
             line, serve_deepseek's apart);
  encdec_small_ref  reduced() of whisper_large_v3 (encoder, cross-attention)
             and phi3_vision_4p2b (patch splice) in float32, built on the
             CPU from a seed: loss, every gradient, prefill logits and 16
             greedy tokens on the card against the CPU (tokens equal, values
             within rtol 1e-4 / atol 1e-5 of each output's scale); a
             ContinuousServer run (10 requests over 4 slots, each with its
             own frontend, one adoption) card against CPU: tokens, versions
             and counting metrics equal;
  serve_whisper  whisper-large-v3 whole (32 encoder + 32 decoder layers, bf16,
             1 601 154 560 parameters), 8 slots x (64 + 384) = 448, whisper's
             decoder context; each request its own 1500 x 128 frontend drawn
             from a seed (x 0.02): signatures after warmup prefill 2, decode
             1, insert 1; row independence with frontends (a request beside
             other requests, and admitted into a retired row, against a row
             of zeros, bit for bit); one prompt with two frontends gives two
             different first logits; 24 requests (max_new 32 + 32 (i % 8))
             without adoption, then with one snapshot published at decode
             step 20: none dropped, no new signature; every run() metric,
             batched and single-row prefill ms (the encoder included), 20
             profiled decode steps against the bytes bound (decoder and head
             weights, the cross K/V and the self K/V read once), peak memory;
  serve_phi3v  phi-3-vision-4.2B whole (32 layers, bf16, 3 824 225 280
             parameters), 8 slots x (1024 + 128), 576 patches and 448 text
             positions a prompt, each request its own 576 x 1024 patch
             embeddings; serve_whisper's checks, with max_new 16 + 16 (i % 8).
             The enc-dec phases launch none of K1-K4 (launches_encdec in the
             kernels line);
  train      launch/train.py on Yi-9B at full width, float32 params and
             bf16 compute (its get_config): train_sync with depth cut to
             TRAIN_LAYERS = 4 (1 216 385 024 parameters), batch 8 x 128,
             10 steps, losses finite and falling, ms a step, tokens/s,
             peak memory; then train_tmsn, W = 4, K = 4 at 1 layer, 3
             rounds: certificates finite and monotone, ms a round;
  ckpt       the train phase's params (4.87 GB) through save_checkpoint to
             an npz under build/ckpt_smoke (free disk checked first) and
             load_checkpoint into a fresh tree on the card, bit for bit;
             seconds and GB/s each way, the process's peak host RSS; the
             file deleted;
  sharded_sgd  TMSN-SGD at lm_sgd's shape on ShardedTMSNEngine, 2 gloo
             ranks sharing the card (one worker each, their collectives
             staged through host memory), 3 rounds, against TMSNEngine on
             one device: certificates, history and every final model's
             per-leaf checksums bit for bit; wall and collective host ms
             per rank, ms per gather of the 2 x 2.79 GB of models;
  dryrun     launch/dryrun.py's run_one for every arch and shape on both
             production meshes and the TMSN round of the train shapes
             (meta device): counts by status, 0 errors, and the records
             whose arguments do not fit one card's 80 GB. The launch
             phases launch none of K1-K4; K5 launches once an AdamW step
             in train and sharded_sgd, K6 once a forward and once a
             backward of each bf16 attention layer of head 128
             (launches_train, launches_ckpt, launches_sharded_sgd,
             launches_dryrun in the kernels line; K6's as
             launches_<phase>_fwd and launches_<phase>_bwd).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the rest of
the repository beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal
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
#: workers of the pod phase: W_local = 5 on each of its 4 ranks
POD_W = 20
POD_RANKS, PODS = 4, 2
#: events of the sim_main phase (chosen so that it ends within about a minute)
SIM_EVENTS = 2000
ENGINE_KERNELS = ("edge_scan", "round_step", "queue_ingest")


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: K1's repeat check: (W, n) shapes, each launched K1_REPEATS times on the
#: same inputs (one-level ticket at W = 10 and 20, the folded launch with no
#: ticket at W = 256, the two-level ticket at W = 1, n = 180 000), in this
#: process and in K1_REPEAT_PROCESSES fresh ones
K1_REPEAT_SHAPES = ((10, 2048), (20, 2048), (256, 2048), (1, 180_000))
K1_REPEATS, K1_REPEAT_PROCESSES = 200, 3


def k1_repeat(launches: int) -> dict:
    """Launch K1 ``launches`` times at each of K1_REPEAT_SHAPES (d = 64,
    B = 8) on the same inputs: every launch's outputs must equal the first
    launch's bit for bit, and the ticket counters kept between launches
    (``ops._EDGE_SCAN_SCRATCH``) must read zero after each. Returns, per
    shape, the launches, mismatches and nonzero counter reads."""
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    out = {}
    for nw, n in K1_REPEAT_SHAPES:
        xb = torch.randint(0, 8, (nw, n, 64), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand((nw, n), generator=g, device=dev) + 0.05
        wy = w * torch.where(torch.rand((nw, n), generator=g, device=dev) < 0.5, 1.0, -1.0)
        first = [a.view(torch.int32).clone() for a in ops.edge_scan(xb, wy, w, num_bins=8)]
        counters = ops._EDGE_SCAN_SCRATCH[(dev, ops._stream(dev))][1]
        mismatches = nonzero = 0
        for _ in range(launches):
            got = ops.edge_scan(xb, wy, w, num_bins=8)
            mismatches += not all(torch.equal(a.view(torch.int32), b) for a, b in zip(got, first))
            nonzero += int(counters.count_nonzero()) != 0
        out[f"W{nw}_n{n}"] = {"launches": launches, "mismatches": mismatches, "counters_nonzero": nonzero,
                              "plan": list(ops.edge_scan_plan(nw, n, torch.cuda.get_device_properties(dev)
                                                              .multi_processor_count))}
        del xb, w, wy, first, got
    return out


def engine_config(w: int, rounds: int, sparse: bool):
    """The main path's engine configuration: every knob pinned."""
    from repro_torch.core.engine import EngineConfig

    return EngineConfig(
        n_workers=w, max_rounds=rounds, target_certificate=None, seed=SEED, delay_rounds=1,
        inflight_capacity=64 if sparse else 0, control_plane="sparse" if sparse else "dense",
        round_step_impl="pallas", fault_spec="", rounds_per_dispatch=1, gossip_mode="dense",
        spare_slots=0, publish_every_k=0,
    )


def run_rank(eng, mesh) -> dict:
    """One timed engine run on one rank of a mesh, with this rank's kernel
    launches and the host time its collectives took (a sync before and
    after, so the wall holds the device work)."""
    import torch

    from repro_torch.kernels import ops

    # the pod's subgroup (tier 1) and the world (tier 2) keep their own
    # counts; a 1-D mesh is its own pod
    tiers = (mesh,) if mesh.intra is mesh else (mesh.intra, mesh)
    torch.cuda.synchronize(mesh.device)
    ops.reset_launches()
    for t in tiers:
        t.collective_seconds, t.collectives = 0.0, 0
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t0
    return dict(
        engine=type(eng).__name__, rank=mesh.rank, backend=mesh.backend, host_staged=mesh.host_staged,
        final_certificates=res.final_certificates, history=res.history, rounds=res.rounds,
        messages_sent=res.messages_sent, messages_accepted=res.messages_accepted,
        messages_discarded=res.messages_discarded, messages_evicted=res.messages_evicted,
        inflight_occupancy_peak=res.inflight_occupancy_peak, gossip_bytes=res.gossip_bytes_per_round,
        control_bytes=res.control_bytes_per_round, gossip_mode=res.gossip_mode,
        payload_bytes=eng._payload_bytes, wall_s=wall, collective_s=sum(t.collective_seconds for t in tiers),
        collectives=sum(t.collectives for t in tiers), tier_collective_s=[t.collective_seconds for t in tiers],
        tier_collectives=[t.collectives for t in tiers], messages_sent_dcn=res.messages_sent_dcn,
        messages_dropped_injected=res.messages_dropped_injected, ici_bytes=res.gossip_bytes_per_round_ici,
        dcn_bytes=res.gossip_bytes_per_round_dcn, launches=dict(ops.LAUNCHES),
    )


def sharded_sparrow_rank(mesh, rounds: int, modes: tuple, direct: bool) -> dict:
    """One rank of the ``sharded`` phase: the main configuration (data,
    worker and engine config as ``main`` builds them) through the sharded
    engine, once per gossip mode. ``direct`` builds ``ShardedTMSNEngine``
    itself (``make_engine`` sends a one-rank mesh to ``TMSNEngine``)."""
    from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker
    from repro_torch.configs.sparrow import DATA, sparrow_config
    from repro_torch.core.engine import make_engine
    from repro_torch.core.engine_sharded import ShardedTMSNEngine
    from repro_torch.data.splice import make_splice_like, train_test_split

    xb, y, _ = make_splice_like(DATA, device=mesh.device)
    xtr, ytr, _, _ = train_test_split(xb, y)
    base = sparrow_config()
    cfg = dataclasses.replace(base, scanner=base.scanner._replace(use_kernel=True))
    worker = BatchedSparrowWorker(xtr, ytr, cfg, device=mesh.device)
    out = {}
    for mode in modes:
        ecfg = dataclasses.replace(engine_config(cfg.n_workers, rounds, True), gossip_mode=mode, mesh=mesh)
        eng = ShardedTMSNEngine(worker, ecfg) if direct else make_engine(worker, ecfg)
        out[mode] = run_rank(eng, mesh)
    return out


class ShardToy:
    """A shardable toy worker on any device (every per-worker constant in
    the state): worker i fires every ``1 + i % 3``-th segment and its
    certificate drops to ``-dec[i] * fires``."""

    def __init__(self, w: int, device):
        import torch

        i = torch.arange(w, device=device)
        self._period = (1 + i % 3).to(torch.int32)
        self._dec = (1e-3 * (1 + (i * 7919) % 1000)).to(torch.float32)

    def init_batch(self, n_workers, seed):
        import torch

        dev = self._period.device
        z = torch.zeros((n_workers,), dtype=torch.int32, device=dev)
        return {"segs": z, "fires": z.clone(), "cert": torch.zeros((n_workers,), device=dev),
                "from": torch.full((n_workers,), -1, dtype=torch.int32, device=dev),
                "owner": torch.arange(n_workers, dtype=torch.int32, device=dev),
                "period": self._period.clone(), "dec": self._dec.clone()}

    def scan_round(self, state, mask):
        import torch

        segs = state["segs"] + mask.to(torch.int32)
        fired = mask & (segs % state["period"] == 0)
        fires = state["fires"] + fired.to(torch.int32)
        cert = torch.where(fired, torch.minimum(state["cert"], -state["dec"] * fires), state["cert"])
        return dict(state, segs=segs, fires=fires, cert=cert), mask.to(torch.float32), fired

    def certificates(self, state):
        return state["cert"]

    def export_models(self, state):
        return {"owner": state["owner"], "cert": state["cert"], "adopted_from": state["from"]}

    def adopt_batch(self, state, models, certs, take):
        import torch

        new = dict(state, cert=torch.where(take, certs, state["cert"]))
        new["from"] = torch.where(take, models["owner"], state["from"])
        return new, torch.zeros_like(state["cert"])

    def payload_bytes(self):
        return 8


def sharded_toy_rank(mesh, w: int, rounds: int) -> dict:
    """One rank of ``sharded_w4096``: the toy at W workers on sparse
    queues (C=64) and the sparse control plane."""
    from repro_torch.core.engine import make_engine

    ecfg = dataclasses.replace(engine_config(w, rounds, True), mesh=mesh)
    return run_rank(make_engine(ShardToy(w, mesh.device), ecfg), mesh)


def pod_runs() -> dict:
    """The pod phase's runs: tag -> engine config changes from
    ``engine_config(POD_W, ROUNDS, True)`` with k = 1."""
    from repro_torch.core.engine import FaultPlan

    return {
        "pod_main dense": dict(gossip_mode="dense"),
        "pod_main gated": dict(gossip_mode="gated"),
        "pod_k8": dict(gossip_mode="dense", cross_pod_every_k=8),
        "pod_partition": dict(gossip_mode="dense",
                              fault_plan=FaultPlan(partition_start=50, partition_stop=120, seed=1)),
    }


def pod_worker(device):
    """The main configuration's data and worker at W = POD_W, kernels on."""
    from repro_torch.boosting.batched_sparrow import BatchedSparrowWorker
    from repro_torch.configs.sparrow import DATA, sparrow_config
    from repro_torch.data.splice import make_splice_like, train_test_split

    xb, y, _ = make_splice_like(DATA, device=device)
    xtr, ytr, _, _ = train_test_split(xb, y)
    base = sparrow_config(POD_W)
    cfg = dataclasses.replace(base, scanner=base.scanner._replace(use_kernel=True))
    return BatchedSparrowWorker(xtr, ytr, cfg, device=device)


def pod_rank(mesh) -> dict:
    """One rank of the ``pod`` phase: every run of :func:`pod_runs` on the
    (pod, workers) mesh, through ``make_engine``."""
    from repro_torch.core.engine import make_engine

    worker = pod_worker(mesh.device)
    out = {}
    for tag, kw in pod_runs().items():
        ecfg = dataclasses.replace(engine_config(POD_W, ROUNDS, True), mesh=mesh, cross_pod_every_k=1,
                                   cross_pod_top_k=1)
        out[tag] = run_rank(make_engine(worker, dataclasses.replace(ecfg, **kw)), mesh)
    return out


# ---------------------------------------------------------------------------
# the LM stack and TMSN-SGD (phases lm_small_ref and lm_sgd)
# ---------------------------------------------------------------------------

#: lm_sgd: Yi-9B at full width, depth cut to LM_LAYERS (the only cut);
#: W workers, K AdamW steps a segment, batch x seq tokens a step
LM_ARCH, LM_LAYERS = "yi_9b", 1
LM_W, LM_K, LM_BATCH, LM_SEQ, LM_ROUNDS = 2, 2, 2, 256, 6
#: serving: a prompt of LM_PROMPT tokens a row, LM_DECODE decoded tokens
LM_PROMPT, LM_DECODE = 128, 16
#: published dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12
#: cached decode against the full forward in bf16: |decode - full| <=
#: LM_BF16_TOL * (1 + |full|), four steps of bf16's 2^-7 spacing
LM_BF16_TOL = 2.0 ** -5


def checksum(params):
    """Per leaf and worker, the sum of the float32 bits read as int32, in
    int64: an integer sum is exact in any order, so equal bits give equal
    sums on the card, and one changed bit changes a sum."""
    import torch

    from repro_torch.tree import tree_leaves

    return torch.stack([torch.sum(a.view(torch.int32).reshape(a.shape[0], -1), dim=1, dtype=torch.int64)
                        for a in tree_leaves(params)])


class RoundClock:
    """A batched worker that records a CUDA event as each ``scan_round``
    starts and the checksum of the params it returns: the round period
    and the bits of every round, the engine untouched."""

    def __init__(self, worker):
        self.worker, self.events, self.sums = worker, [], []

    def __getattr__(self, name):
        return getattr(self.worker, name)

    def scan_round(self, state, mask):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        out = self.worker.scan_round(state, mask)
        self.sums.append(checksum(out[0].params))
        return out

    def periods_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]

    def sums_np(self):
        import numpy as np

        return np.stack([s.cpu().numpy() for s in self.sums])


def history_rows(res, w: int, k: int):
    """(rounds, W) certificates after each round from a run's change
    history: every round costs each worker ``k`` units, so an entry's
    clock names its round; unchanged workers carry their value."""
    import numpy as np

    rows = np.full((res.rounds + 1, w), np.nan, np.float32)
    for clock, wid, cert in res.history:
        rows[int(round(clock / k)), wid] = cert
    for r in range(1, res.rounds + 1):
        rows[r] = np.where(np.isnan(rows[r]), rows[r - 1], rows[r])
    return rows[1:]


def bits(a):
    import numpy as np

    return np.ascontiguousarray(a, np.float32).view(np.int32)


def event_ms(fn, reps: int = 3) -> float:
    """Mean CUDA-event ms of ``fn`` over ``reps`` calls, after one warm call."""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def lm_small_ref_phase() -> None:
    """reduced(yi_9b) in float32, built on the CPU from a seed and copied
    to the card: loss, grads, one AdamW step (from the same grads),
    prefill and 4 decode steps card against CPU at rtol 1e-4 / atol 1e-5;
    then TMSN-SGD on the card, TMSNEngine against oracle_run bit for bit."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import TMSNEngine, TMSNSGDConfig, lm_sgd_worker, oracle_run
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.models import decode_step, init_cache, init_params, loss_fn, prefill
    from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg = reduced(get_config(LM_ARCH))
    opt_cfg = AdamWConfig(lr=1e-3)
    params_cpu = init_params(cfg, SEED, "cpu")
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab, (2, 64), dtype=np.int32)
    prompt, steps = tokens[:, :16], tokens[:, 16:20]
    out, cpu_grads = {}, None
    for name in ("cpu", "cuda"):
        params = tree_map(lambda a: a.to(name), params_cpu)
        leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
        loss, _ = loss_fn(leaves, cfg, synthetic_token_batch(torch.from_numpy(tokens).to(name)))
        loss.backward()
        grads = tree_map(lambda a: a.grad, leaves)
        cpu_grads = grads if cpu_grads is None else cpu_grads
        # the AdamW step on the same inputs on both devices: the CPU's grads
        # (its first step moves each weight by about lr * sign(g), so a grad
        # within rounding of zero could flip it)
        same_grads = tree_map(lambda a: a.to(name), cpu_grads)
        new_p, new_opt = apply_updates(params, same_grads, init_opt_state(params, opt_cfg), opt_cfg)
        with torch.no_grad():
            logits, pc = prefill(params, cfg, {"tokens": torch.from_numpy(prompt).to(name)})
            caches = init_cache(cfg, 2, 20, device=name)
            for (k, v), (pk, pv) in zip(caches[0], pc[0]):
                k[:, :, :16], v[:, :, :16] = pk, pv
            dec = []
            for i in range(4):
                tok = torch.from_numpy(steps[:, i:i + 1]).to(name)
                lg, caches = decode_step(params, cfg, tok, caches, 16 + i)
                dec.append(lg)
        named = {"loss": [loss.detach()], "grads": tree_leaves(grads), "adamw_params": tree_leaves(new_p),
                 "adamw_state": tree_leaves(new_opt), "prefill_logits": [logits],
                 "prefill_caches": tree_leaves(pc), "decode_logits": dec}
        out[name] = [(f"{k}[{i}]", a) for k, v in named.items() for i, a in enumerate(v)]
    err, bad = {}, []
    for (key, a), (_, b) in zip(out["cpu"], out["cuda"]):
        b = b.cpu()
        group = key.split("[")[0]
        err[group] = max(err.get(group, 0.0), float((b.float() - a.float()).abs().max()))
        if not torch.allclose(b, a, rtol=1e-4, atol=1e-5):
            worst = int(((b - a).abs() - 1e-4 * a.abs()).argmax())
            bad.append(f"{key} {tuple(a.shape)}: card {b.flatten()[worst].item()!r} "
                       f"cpu {a.flatten()[worst].item()!r}")
    log(f"phase lm_small_ref card_vs_cpu tensors={len(out['cuda'])} max_abs_err={json.dumps(err)} "
        f"loss={out['cuda'][0][1].item():.6f}")
    if bad:
        raise AssertionError("lm_small_ref: card differs from the CPU beyond rtol 1e-4 / atol 1e-5: "
                             + "; ".join(bad))

    worker = lm_sgd_worker(cfg, opt_cfg, TMSNSGDConfig(local_steps=2), batch_size=2, seq=32, device="cuda")
    eng_clock, orc_clock = RoundClock(worker), RoundClock(worker)
    res = TMSNEngine(eng_clock, engine_config(4, 8, False), device="cuda").run()
    orc = oracle_run(orc_clock, 4, 8, eps=0.0, seed=SEED)
    rows = history_rows(res, 4, 2)
    same = (np.array_equal(bits(rows), bits(orc.history))
            and np.array_equal(bits(res.final_certificates), bits(orc.certs))
            and np.array_equal(eng_clock.sums_np(), orc_clock.sums_np()))
    if not same:
        raise AssertionError(f"lm_small_ref: engine {rows.tolist()} != oracle {orc.history.tolist()}")
    if not (np.all(np.isfinite(rows)) and np.all(np.diff(rows, axis=0) <= 0) and res.messages_accepted > 0):
        raise AssertionError(f"lm_small_ref: certificates {rows.tolist()}, accepted {res.messages_accepted}")
    log(f"phase lm_small_ref ok engine==oracle bitwise rounds={res.rounds} certificates, history and param "
        f"checksums; accepted={res.messages_accepted} best={min(res.final_certificates):.6f} "
        f"seconds={time.perf_counter() - t0:.3f}")


def lm_sgd_phase() -> dict:
    """TMSN-SGD at Yi-9B's full width on the card (see the module doc).
    Returns the K5 and K6 launches of the main run."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import TMSNEngine, TMSNSGDConfig, lm_sgd_worker, oracle_run
    from repro_torch.data.tokens import stream_tokens, synthetic_token_batch
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import decode_step, init_cache, init_params, loss_fn, param_count, prefill
    from repro_torch.models.config import layer_segments
    from repro_torch.models.model import _embed, _logits, _positions
    from repro_torch.models.transformer import forward_stack
    from repro_torch.optim import AdamWConfig, apply_updates_, init_opt_state
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    shapes = init_params(cfg, SEED, device="meta")
    n_params = param_count(shapes)
    # every parameter but the embedding table (a gather) and the norm scales
    norms = shapes["final_norm"].numel() + sum(lay["ln1"].numel() + lay["ln2"].numel()
                                               for seg in shapes["decoder"] for lay in seg)
    n_matmul = n_params - shapes["embed"].numel() - norms
    opt_cfg = AdamWConfig(lr=3e-4)
    worker = lm_sgd_worker(cfg, opt_cfg, TMSNSGDConfig(local_steps=LM_K), batch_size=LM_BATCH, seq=LM_SEQ,
                           device="cuda")
    tokens_per_round = LM_W * LM_K * LM_BATCH * LM_SEQ
    flop_per_round = 6 * n_matmul * tokens_per_round

    # ---- the run: LM_ROUNDS rounds through TMSNEngine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock_a = RoundClock(worker)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = TMSNEngine(clock_a, engine_config(LM_W, LM_ROUNDS, False), device="cuda").run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # every worker steps in every round: each step is one K5 launch, and
    # each attention layer launches K6's forward twice (the forward and
    # remat's recompute) and its backward once
    run_launches = {k: ops.LAUNCHES[k] for k in ("adamw_step", "attention_fwd", "attention_bwd")}
    steps = LM_W * LM_K * LM_ROUNDS
    want = {"adamw_step": steps, "attention_fwd": 2 * cfg.num_layers * steps,
            "attention_bwd": cfg.num_layers * steps}
    if not cfg.remat or run_launches != want:
        raise AssertionError(f"lm_sgd: launches {run_launches}, not {want} ({LM_W} workers x {LM_K} steps x "
                             f"{LM_ROUNDS} rounds, {cfg.num_layers} layers, remat {cfg.remat})")
    peak_run = torch.cuda.max_memory_allocated()
    rows_a, sums_a = history_rows(res, LM_W, LM_K), clock_a.sums_np()
    periods = clock_a.periods_ms()
    round_ms = statistics.median(periods)
    fires = sum(1 for h in res.history if h[0] > 0)
    payload = res.bytes_broadcast // max(res.messages_sent, 1)
    log(f"phase lm_sgd run arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} params={n_params} "
        f"matmul_params={n_matmul} W={LM_W} K={LM_K} batch={LM_BATCH} seq={LM_SEQ} rounds={res.rounds} "
        f"wall_s={wall:.3f} ms_per_round={round_ms:.3f} round_periods_ms={[round(p, 3) for p in periods]} "
        f"tokens_per_s={tokens_per_round / (round_ms / 1e3):.1f} "
        f"tokens_per_s_wall={tokens_per_round * res.rounds / wall:.1f} "
        f"achieved_tflops={flop_per_round / (round_ms / 1e3) / 1e12:.2f} "
        f"bf16_peak_share={flop_per_round / (round_ms / 1e3) / BF16_OPS_PER_S:.4f} "
        f"sent={res.messages_sent} accepted={res.messages_accepted} history_changes={fires} "
        f"payload_bytes={payload} certificates={rows_a.tolist()} max_memory_allocated={peak_run} "
        f"launches={json.dumps(run_launches)}")
    if res.rounds != LM_ROUNDS or not np.all(np.isfinite(rows_a)) or np.any(np.diff(rows_a, axis=0) > 0):
        raise AssertionError(f"lm_sgd: certificates not finite and monotone: {rows_a.tolist()}")
    if fires < 1 or res.messages_sent < 1:
        raise AssertionError(f"lm_sgd: {fires} fires, {res.messages_sent} broadcasts")
    if payload != 4 * n_params:
        raise AssertionError(f"lm_sgd: payload {payload} B, not 4 x {n_params}")
    best = int(np.argmin(res.final_certificates))
    served = tree_map(lambda a: a.clone(), res.final_models[best])
    del res, clock_a
    gc.collect()

    # ---- a second run of the first 2 rounds, and the oracle over 3
    torch.cuda.reset_peak_memory_stats()
    clock_b = RoundClock(worker)
    again = TMSNEngine(clock_b, engine_config(LM_W, 2, False), device="cuda").run()
    rows_b, sums_b = history_rows(again, LM_W, LM_K), clock_b.sums_np()
    del again, clock_b
    gc.collect()
    if not (np.array_equal(bits(rows_b), bits(rows_a[:2])) and np.array_equal(sums_b, sums_a[:2])):
        raise AssertionError(f"lm_sgd: two runs differ: {rows_b.tolist()} vs {rows_a[:2].tolist()}")
    clock_o = RoundClock(worker)
    orc = oracle_run(clock_o, LM_W, 3, eps=0.0, seed=SEED)
    rows_o, sums_o = orc.history, clock_o.sums_np()
    del orc, clock_o
    gc.collect()
    if not (np.array_equal(bits(rows_o), bits(rows_a[:3])) and np.array_equal(sums_o, sums_a[:3])):
        raise AssertionError(f"lm_sgd: engine {rows_a[:3].tolist()} != oracle {rows_o.tolist()}")
    log("phase lm_sgd bitwise: a second 2-round run == the run, oracle_run == the engine over 3 rounds "
        f"(certificates, history and per-leaf param checksums) "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")

    # ---- one step's parts on the best model: forward + backward, AdamW
    batch = synthetic_token_batch(stream_tokens(1, 10**6, (LM_BATCH, LM_SEQ), cfg.vocab, "cuda"))

    def fwd_bwd():
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), served)
        loss, _ = loss_fn(leaves, cfg, batch)
        loss.backward()
        return tree_map(lambda a: a.grad, leaves)

    fb_ms = event_ms(fwd_bwd)
    grads = fwd_bwd()
    # the worker's in-place step, on a copy of the model
    stepped, opt = tree_map(torch.clone, served), init_opt_state(served, opt_cfg)
    adamw_ms = event_ms(lambda: apply_updates_(stepped, grads, opt, opt_cfg))
    del grads, opt, stepped
    gc.collect()
    # AdamW's least bytes: p, g, mu, nu read once, p, mu, nu written once
    adamw_bound_ms = 28 * n_params / HBM_BYTES_PER_S * 1e3
    log(f"phase lm_sgd step fwd_bwd_ms={fb_ms:.3f} adamw_ms={adamw_ms:.3f} step_ms={fb_ms + adamw_ms:.3f} "
        f"steps_per_round={LM_W * LM_K} round_ms={round_ms:.3f} "
        f"fwd_bwd_tflops={6 * n_matmul * LM_BATCH * LM_SEQ / (fb_ms / 1e3) / 1e12:.2f} "
        f"fwd_bwd_bound_ms={6 * n_matmul * LM_BATCH * LM_SEQ / BF16_OPS_PER_S * 1e3:.3f} "
        f"adamw_bound_ms={adamw_bound_ms:.3f} (28 B a parameter at {HBM_BYTES_PER_S:.3g} B/s)")

    # ---- where a round's device time goes: 2 rounds under the profiler
    eng = TMSNEngine(worker, engine_config(LM_W, 2, False), device="cuda")
    state = eng._init_state()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = eng._round_step(state)
        torch.cuda.synchronize()
    del state, eng
    gc.collect()
    by_kernel = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
        key=lambda k: -k[1],
    )
    busy_ms = sum(k[1] for k in by_kernel) / 1e3 / 2
    top = [{"kernel": k[0][:70], "ms_per_round": round(k[1] / 1e3 / 2, 4), "calls": k[2]}
           for k in by_kernel[:5]]
    log(f"phase lm_sgd profile device_ms_per_round={busy_ms:.3f} wall_ms_per_round={round_ms:.3f} "
        f"device_idle_share={1 - busy_ms / round_ms:.4f} top5={json.dumps(top)}")

    # ---- serve the best model: prefill, then cached decode
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, LM_PROMPT), dtype=np.int32)).to("cuda")
    total = LM_PROMPT + LM_DECODE
    with torch.no_grad():
        prefill_ms = event_ms(lambda: prefill(served, cfg, {"tokens": prompt}))
        logits, pc = prefill(served, cfg, {"tokens": prompt})

        def decode(per_row: bool, feed=None):
            caches = init_cache(cfg, 2, total, device="cuda")
            for seg, pseg in zip(caches, pc):
                for (k, v), (pk, pv) in zip(seg, pseg):
                    k[:, :, :LM_PROMPT], v[:, :, :LM_PROMPT] = pk, pv
            tok, outs, toks = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32), [], []
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for i in range(LM_DECODE):
                if feed is not None:
                    tok = feed[:, i:i + 1]
                toks.append(tok)
                pos = LM_PROMPT + i
                out, caches = decode_step(served, cfg, tok, caches,
                                          torch.full((2,), pos, dtype=torch.int32, device="cuda") if per_row
                                          else pos)
                outs.append(out[:, 0])
                tok = out[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            b.record()
            torch.cuda.synchronize()
            return torch.stack(outs, 1), torch.cat(toks, 1), a.elapsed_time(b) / LM_DECODE

        decode(False)  # warm: the decode shapes' first launches
        dec, gen, decode_ms = decode(False)
        dec_row, _, decode_row_ms = decode(True, feed=gen)
        full_tokens = torch.cat([prompt, gen], 1)

        def full_logits(c=cfg):
            x = _embed(served, c, full_tokens)
            x, _, _ = forward_stack(served["decoder"], layer_segments(c), c, x, _positions(full_tokens))
            return _logits(served, c, x)[:, LM_PROMPT:]

        full_k6 = full_logits()  # gqa_full runs K6 here (bf16, head 128)
        # The decode bound is of the cache's bookkeeping, so its reference
        # takes the decode's attention steps (_sdpa, the scores rounded to
        # bf16). Two roundings of attention differ by more than it allows,
        # and gqa_full routes bf16 CUDA tensors at head 128 to K6 with no
        # option, so this one forward sets the route aside.
        k6_takes = attn._k6_takes
        attn._k6_takes = lambda *a: False
        try:
            full = full_logits()
        finally:
            attn._k6_takes = k6_takes
        # The prefill's K6 forward is held to the float32 forward (float32
        # inputs take _sdpa by their dtype): no farther from it than the
        # bf16 _sdpa forward, by the largest and by the mean distance.
        full_f32 = full_logits(dataclasses.replace(cfg, compute_dtype="float32"))
    dist = {name: ((x.float() - full_f32).abs().max().item(), (x.float() - full_f32).abs().mean().item())
            for name, x in (("k6", full_k6), ("sdpa", full))}
    err = (dec - full).abs()
    bound_ok = bool((err <= LM_BF16_TOL * (1 + full.abs())).all())
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    log(f"phase lm_sgd serve prompt={2}x{LM_PROMPT} decoded={LM_DECODE} prefill_ms={prefill_ms:.3f} "
        f"decode_ms_per_token={decode_ms:.3f} decode_ms_per_token_per_row_pos={decode_row_ms:.3f} "
        f"max_abs_err_vs_full={float(err.max()):.4g} max_abs_logit={float(full.abs().max()):.4g} "
        f"tolerance={LM_BF16_TOL}*(1+|full|) argmax_agreement={agree:.4f} "
        f"k6_full_max_abs_err_vs_full={float((full_k6 - full).abs().max()):.4g} "
        f"k6_full_argmax_agreement={float((full_k6.argmax(-1) == full.argmax(-1)).float().mean()):.4f} "
        f"vs_float32_forward_max_mean={json.dumps(dist)} "
        f"per_row_pos==scalar={torch.equal(dec, dec_row)} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if not torch.equal(dec, dec_row):
        raise AssertionError("lm_sgd: per-row pos decode differs from scalar pos decode")
    if not (bound_ok and torch.isfinite(dec).all()):
        raise AssertionError(f"lm_sgd: cached decode differs from the full forward by {float(err.max()):.4g}")
    if not all(a <= b for a, b in zip(dist["k6"], dist["sdpa"])):
        raise AssertionError(f"lm_sgd: K6's forward is farther from the float32 forward than _sdpa's: {dist}")
    log(f"phase lm_sgd ok seconds={time.perf_counter() - t_phase:.3f}")
    return run_launches


# ---------------------------------------------------------------------------
# the serving tier (phases serve_small_ref, serve and serve_live)
# ---------------------------------------------------------------------------

#: serve: Yi-9B at full width and depth, bf16 (the reference's dryrun_cfg);
#: the server's shape, its load and the steps at which snapshots publish
SERVE_SLOTS, SERVE_PROMPT, SERVE_MAX_NEW = 8, 1024, 128
SERVE_REQUESTS, SERVE_GEN, SERVE_ADOPT_AT = 24, 32, (20, 60)
#: decode steps under the profiler for the device idle share
SERVE_PROFILED_STEPS = 20
#: serve_live: the engine's rounds, the example's pace (s a decode step)
#: and request stream, and the memory the phase must stay below
LIVE_ROUNDS, LIVE_PACE_S, LIVE_REQUESTS, LIVE_PEAK_LIMIT = 16, 0.05, 48, 60e9


def _tokens_of(results) -> list:
    return [r.tokens.tolist() for r in results]


def serve_small_ref_phase() -> None:
    """reduced(yi_9b) in float32, built on the CPU from a seed: a
    ContinuousServer run with admission and one adoption on the card
    against the same run on the CPU (every request's tokens and versions,
    the counting metrics), and the prefill and 4 in-place decode steps'
    logits at rtol 1e-4 / atol 1e-5."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig, rebuffer_caches
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = reduced(get_config(LM_ARCH))
    params_cpu, snap_cpu = init_params(cfg, SEED, "cpu"), init_params(cfg, SEED + 1, "cpu")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (10, 16), dtype=np.int32)
    scfg = ServingConfig(slots=4, prompt_len=16, max_new=8, seed=SEED)
    counting = ("requests_completed", "dropped_requests", "decode_steps", "decode_tokens", "adoptions",
                "adoption_steps", "recompiles")
    out = {}
    for name in ("cpu", "cuda"):
        server = ContinuousServer(cfg, scfg, tree_map(lambda a: a.to(name, copy=True), params_cpu), device=name)
        server.warmup()
        slot = AdoptionSlot()

        def hook(_, step, slot=slot):
            if step == 3:
                slot.publish(snap_cpu, cert=1.0, round=3)

        reqs = [Request(rid=i, prompt=prompts[i], max_new=2 + i % 7) for i in range(10)]
        results, m = server.run(reqs, slot=slot, step_hook=hook)
        params = tree_map(lambda a: a.to(name), params_cpu)
        with torch.no_grad():
            tokens = torch.from_numpy(prompts[:2]).to(name)
            logits, pre = prefill(params, cfg, {"tokens": tokens})
            caches = rebuffer_caches(cfg, pre, 2, 24, 16, 0)
            dec = []
            for i in range(4):
                pos = torch.full((2,), 16 + i, dtype=torch.int32, device=name)
                lg, caches = decode_step(params, cfg, torch.from_numpy(prompts[2:4, i:i + 1]).to(name), caches,
                                         pos, in_place=True)
                dec.append(lg)
        out[name] = (results, m, [logits] + dec)
    (cres, cm, clog), (gres, gm, glog) = out["cpu"], out["cuda"]
    err = max(float((g.cpu() - c).abs().max()) for g, c in zip(glog, clog))
    log(f"phase serve_small_ref requests={len(gres)} decode_steps={gm['decode_steps']} adoptions={gm['adoptions']} "
        f"adoption_steps={gm['adoption_steps']} recompiles={gm['recompiles']} dropped={gm['dropped_requests']} "
        f"tokens_equal={_tokens_of(gres) == _tokens_of(cres)} logits_max_abs_err={err:.3g}")
    if _tokens_of(gres) != _tokens_of(cres) or [r.versions for r in gres] != [r.versions for r in cres]:
        raise AssertionError(f"serve_small_ref: card tokens {_tokens_of(gres)} != cpu {_tokens_of(cres)}")
    if {k: gm[k] for k in counting} != {k: cm[k] for k in counting}:
        raise AssertionError(f"serve_small_ref: card metrics {gm} != cpu {cm}")
    if not (gm["adoptions"] == 1 and gm["recompiles"] == 0 and gm["dropped_requests"] == 0):
        raise AssertionError(f"serve_small_ref: {gm}")
    bad = [i for i, (g, c) in enumerate(zip(glog, clog)) if not torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-5)]
    if bad:
        raise AssertionError(f"serve_small_ref: logits of steps {bad} differ beyond rtol 1e-4 / atol 1e-5")
    log(f"phase serve_small_ref ok seconds={time.perf_counter() - t0:.3f}")


def serve_phase() -> None:
    """The continuous-batching server on Yi-9B at full width and depth in
    bf16 (see the module doc)."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig, rebuffer_caches
    from repro_torch.launch.steps import dryrun_cfg, make_prefill_step, make_serve_step
    from repro_torch.models import init_params, param_count
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = dryrun_cfg(get_config(LM_ARCH))
    B, P = SERVE_SLOTS, SERVE_PROMPT
    kv_token_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.hd() * 2  # K and V, bf16
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (SERVE_REQUESTS + B, P), dtype=np.int32)

    def batch(rows):
        toks = torch.from_numpy(prompts[rows]).to("cuda")
        return {"tokens": toks, "labels": toks, "mask": torch.ones(toks.shape, device="cuda")}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # two snapshots to adopt: inits from seeds 1 and 2, drawn on the card
    # and copied to host memory (pageable, as the engine's publisher copies)
    t0 = time.perf_counter()
    snaps = {}
    for cert, (step, seed) in zip((2.0, 1.0), zip(SERVE_ADOPT_AT, (SEED + 1, SEED + 2))):
        p = init_params(cfg, seed, "cuda")
        snaps[step] = (tree_map(lambda a: a.to("cpu"), p), cert)
        del p
    torch.cuda.empty_cache()
    snap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    n_params = param_count(params)
    param_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    log(f"phase serve model arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} params={n_params} "
        f"param_bytes={param_bytes} dtype={cfg.param_dtype}/{cfg.compute_dtype} init_s={time.perf_counter() - t0:.3f} "
        f"snapshots_to_host_s={snap_s:.3f} kv_bytes_per_token={kv_token_bytes}")

    # ---- a no-publish serve() against the legacy scalar-pos loop
    out = serve(cfg, B, P, SERVE_GEN, params=params, prompts=prompts[:B], device="cuda")
    tok, pre = make_prefill_step(cfg)(params, batch(slice(0, B)))
    caches = rebuffer_caches(cfg, pre, B, P + SERVE_GEN, P, 0)
    del pre
    step, legacy = make_serve_step(cfg), [tok]
    for i in range(SERVE_GEN - 1):
        tok, caches = step(params, tok, caches, P + i)
        legacy.append(tok)
    legacy = torch.cat(legacy, 1).cpu().numpy()
    del caches, tok
    gc.collect()
    same = np.array_equal(out["generated"], legacy)
    log(f"phase serve serve_vs_legacy batch={B} prompt={P} gen={SERVE_GEN} equal={same} "
        f"compile_s={out['compile_s']:.3f} prefill_s={out['prefill_s']:.4f} decode_s={out['decode_s']:.4f} "
        f"tok_per_s={out['tok_per_s']:.1f}")
    if not same:
        raise AssertionError("serve: serve() differs from the legacy scalar-pos loop")
    del out

    # ---- the server at (SERVE_SLOTS, SERVE_PROMPT + SERVE_MAX_NEW)
    scfg = ServingConfig(slots=B, prompt_len=P, max_new=SERVE_MAX_NEW, seed=SEED)
    server = ContinuousServer(cfg, scfg, params, device="cuda")
    warm_s = server.warmup()
    counts = server.compile_counts()
    torch.cuda.synchronize()
    reserved_warm = torch.cuda.memory_reserved()
    log(f"phase serve warmup_s={warm_s:.3f} compile_counts={json.dumps(counts)} "
        f"memory_reserved={reserved_warm} max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if counts != {"prefill": 2, "decode": 1, "insert": 1}:
        raise AssertionError(f"serve: signatures after warmup {counts}")

    def reqs(rows, max_new):
        return [Request(rid=i, prompt=prompts[r], max_new=m) for i, (r, m) in enumerate(zip(rows, max_new))]

    # row independence: row 0's request beside other prompts; a request
    # admitted into a retired row (stale K/V beyond its prefix) and into
    # a row that holds zeros there
    g = SERVE_GEN
    t0 = time.perf_counter()
    a, _ = server.run(reqs(range(B), [g] * B))
    b, _ = server.run(reqs([0] + list(range(B, 2 * B - 1)), [g] * B))
    late = 2 * B - 1
    stale, _ = server.run(reqs(list(range(B)) + [late], [24] + [2 * g] * (B - 1) + [g]))
    fresh, _ = server.run(reqs(list(range(B)) + [late], [1] + [2 * g] * (B - 1) + [g]))
    rows_ok = np.array_equal(a[0].tokens, b[0].tokens) and not np.array_equal(a[1].tokens, b[1].tokens)
    stale_ok = np.array_equal(stale[B].tokens, fresh[B].tokens)
    log(f"phase serve row_independence row0_equal={rows_ok} stale_row_admission_equal={stale_ok} "
        f"seconds={time.perf_counter() - t0:.3f}")
    if not (rows_ok and stale_ok):
        raise AssertionError(f"serve: row independence {rows_ok}, stale-row admission {stale_ok}")

    # ---- the load: without adoption, then with two adoptions mid-run
    load_rows = list(range(SERVE_REQUESTS))
    load_new = [16 + 16 * (i % 8) for i in range(SERVE_REQUESTS)]
    base, base_m = server.run(reqs(load_rows, load_new))
    ptrs = [x.data_ptr() for x in tree_leaves(server.params)]
    slot = AdoptionSlot()

    def hook(_, step):
        if step in snaps:
            slot.publish(snaps[step][0], cert=snaps[step][1], round=step)

    results, m = server.run(reqs(load_rows, load_new), slot=slot, step_hook=hook)
    torch.cuda.synchronize()
    reserved_end = torch.cuda.memory_reserved()
    swapped = [x.data_ptr() for x in tree_leaves(server.params)] == ptrs
    changed = sum(not np.array_equal(x.tokens, y.tokens) for x, y in zip(results, base))
    keys = ("requests_completed", "dropped_requests", "req_per_s", "latency_p50_s", "latency_p99_s",
            "decode_steps", "decode_tokens", "prefill_s", "decode_s", "decode_tok_per_s", "step_p50_ms",
            "step_p99_ms", "adoptions", "adoption_steps", "adoption_blip_p99_ms", "steady_step_p99_ms",
            "recompiles", "wall_s")
    log(f"phase serve load_no_adoption {json.dumps({k: base_m[k] for k in keys})}")
    log(f"phase serve load_adoption {json.dumps({k: m[k] for k in keys})} requests_changed={changed} "
        f"params_swapped_in_place={swapped} memory_reserved_growth={reserved_end - reserved_warm}")
    if not (m["adoptions"] == 2 and m["dropped_requests"] == 0 and m["recompiles"] == 0 and swapped):
        raise AssertionError(f"serve: adoptions {m['adoptions']}, dropped {m['dropped_requests']}, "
                             f"recompiles {m['recompiles']}, in place {swapped}")
    if changed == 0 or base_m["recompiles"] != 0:
        raise AssertionError(f"serve: {changed} requests changed under adoption")
    del snaps, slot, results, base
    gc.collect()

    # ---- prefill times (batched and single-row) and a profiled decode window
    prefill_fn = server._prefill_fn
    with torch.no_grad():
        bb, b1 = batch(slice(0, B)), batch(slice(0, 1))
        prefill_ms = event_ms(lambda: prefill_fn(server.params, bb))
        prefill1_ms = event_ms(lambda: prefill_fn(server.params, b1))
        tok, pre = prefill_fn(server.params, bb)
        caches = rebuffer_caches(cfg, pre, B, P + SERVE_MAX_NEW, P, 0)
        del pre
        decode = server._decode_fn
        pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
        tok, caches = decode(server.params, tok, caches, pos, None)
        tok.cpu()

        def window(first: int) -> float:
            """SERVE_PROFILED_STEPS decode steps from position ``first``,
            each ending in the server's host sync; wall ms a step."""
            nonlocal tok, caches
            t0 = time.perf_counter()
            for i in range(SERVE_PROFILED_STEPS):
                pos = torch.full((B,), first + i, dtype=torch.int32, device="cuda")
                tok, caches = decode(server.params, tok, caches, pos, None)
                tok.cpu()
            return (time.perf_counter() - t0) * 1e3 / SERVE_PROFILED_STEPS

        # the wall without the profiler (its own host cost would count as
        # idle), then the same work under it for the device time
        wall_ms = window(P + 1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prof_wall_ms = window(P + 1 + SERVE_PROFILED_STEPS)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3 / SERVE_PROFILED_STEPS
    device_ops = sum(e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA")) / SERVE_PROFILED_STEPS
    # a decode step's least bytes: every parameter read once and this
    # window's K/V (positions 0..pos of every row, every layer) read once
    kv_read = sum(B * (P + 2 + SERVE_PROFILED_STEPS + i) * kv_token_bytes
                  for i in range(SERVE_PROFILED_STEPS)) / SERVE_PROFILED_STEPS
    bound_ms = (param_bytes + kv_read) / HBM_BYTES_PER_S * 1e3
    # products of a prefill: every weight but the embedding and the head at
    # every position, the head at the last, and attention's two (full P x P)
    vd = cfg.padded_vocab() * cfg.d_model
    prefill_flop = (2 * (n_params - 2 * vd) * B * P + 2 * vd * B
                    + 4 * B * P * P * cfg.num_heads * cfg.hd() * cfg.num_layers)
    log(f"phase serve prefill_ms batched={prefill_ms:.3f} ({B}x{P}; {prefill_flop / 1e12:.1f} TFLOP of products, "
        f"{prefill_flop / (prefill_ms / 1e3) / 1e12:.1f} TFLOP/s) single_row={prefill1_ms:.3f}")
    log(f"phase serve decode_profile steps={SERVE_PROFILED_STEPS} wall_ms_per_step={wall_ms:.3f} "
        f"wall_ms_per_step_profiled={prof_wall_ms:.3f} device_ms_per_step={busy:.3f} "
        f"device_idle_share={1 - busy / wall_ms:.4f} "
        f"device_ops_per_step={device_ops:.0f} bytes_bound_ms={bound_ms:.3f} "
        f"(params {param_bytes} B + K/V {kv_read:.0f} B at {HBM_BYTES_PER_S:.3g} B/s) "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    del caches, tok, server, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase serve ok seconds={time.perf_counter() - t_phase:.3f}")


def serve_live_phase() -> None:
    """TMSN-SGD trains Yi-9B at full width (1 layer, f32 params) in a
    thread and publishes every improvement; a server on the same card
    serves the same model shape from the slot, paced as
    examples/serve_live.py paces it."""
    import gc
    import threading

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import TMSNEngine, TMSNSGDConfig, lm_sgd_worker
    from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig

    class RecordingSlot(AdoptionSlot):
        def __init__(self):
            super().__init__()
            self.certs = []

        def publish(self, params, cert, round=0):
            self.certs.append(float(cert))
            return super().publish(params, cert, round)

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    worker = lm_sgd_worker(cfg, AdamWConfig(lr=3e-4), TMSNSGDConfig(local_steps=LM_K), batch_size=LM_BATCH,
                           seq=LM_SEQ, device="cuda")
    engine = TMSNEngine(worker, dataclasses.replace(engine_config(LM_W, LIVE_ROUNDS, False), publish_every_k=1),
                        device="cuda")
    slot = RecordingSlot()
    engine.attach_publisher(slot)
    server = ContinuousServer(cfg, ServingConfig(slots=4, prompt_len=8, max_new=12, seed=SEED),
                              init_params(cfg, 7, "cuda"), device="cuda")
    warm_s = server.warmup()
    failed = []

    def train():
        try:
            engine.run()
        except Exception as e:  # noqa: BLE001 — raised below, in the main thread
            failed.append(e)

    trainer = threading.Thread(target=train, name="tmsn-trainer")
    trainer.start()
    try:
        t0 = time.perf_counter()
        while slot.version == 0 and not failed and time.perf_counter() - t0 < 300:
            time.sleep(0.01)
        first_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32), max_new=4 + i % 9)
                for i in range(LIVE_REQUESTS)]
        results, m = server.run(reqs, slot=slot, step_hook=lambda srv, step: time.sleep(LIVE_PACE_S))
    finally:
        trainer.join(timeout=600)
    if failed or trainer.is_alive():
        raise AssertionError(f"serve_live: the trainer failed ({failed}) or hung")
    peak = torch.cuda.max_memory_allocated()
    multi = sum(1 for r in results if len(r.versions) > 1)
    log(f"phase serve_live rounds={LIVE_ROUNDS} publishes={slot.publishes} published_certs={slot.certs} "
        f"first_publish_s={first_s:.3f} warmup_s={warm_s:.3f} requests={m['requests_completed']} "
        f"dropped={m['dropped_requests']} adoptions={m['adoptions']} adoption_steps={m['adoption_steps']} "
        f"recompiles={m['recompiles']} served_cert={server.served_cert} multi_version_requests={multi} "
        f"step_p50_ms={m['step_p50_ms']:.3f} adoption_blip_p99_ms={m['adoption_blip_p99_ms']:.3f} "
        f"stale_cert_gap_mean={m['stale_cert_gap_mean']:.6g} max_memory_allocated={peak}")
    if not (m["adoptions"] >= 1 and m["dropped_requests"] == 0 and m["recompiles"] == 0):
        raise AssertionError(f"serve_live: {m}")
    if server.served_cert not in slot.certs or peak >= LIVE_PEAK_LIMIT:
        raise AssertionError(f"serve_live: served cert {server.served_cert} not published {slot.certs}, "
                             f"or peak {peak} B over {LIVE_PEAK_LIMIT:.3g}")
    del engine, worker, server, slot
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase serve_live ok seconds={time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# the decoder-only families (phases families_small_ref, serve_mamba2,
# serve_deepseek and families_full)
# ---------------------------------------------------------------------------

FAMILY_IDS = ("deepseek_v3_671b", "grok1_314b", "gemma3_12b", "mamba2_1p3b", "zamba2_1p2b")
#: families_small_ref: a 2 x FAM_PROMPT batch, FAM_DECODE greedy tokens
FAM_PROMPT, FAM_DECODE = 32, 16
#: serve_mamba2: Mamba2-1.3B whole, the serve phase's server shape and load
MAMBA_SLOTS, MAMBA_PROMPT, MAMBA_MAX_NEW, MAMBA_REQUESTS, MAMBA_ADOPT_AT = 8, 1024, 128, 24, (20, 60)
#: serve_deepseek: DeepSeek-V3 at full width, depth cut to DS_LAYERS
#: (first_k_dense = 3 stays: 3 dense MLA layers, 1 MoE layer, and MTP)
DS_LAYERS, DS_SLOTS, DS_PROMPT, DS_MAX_NEW, DS_REQUESTS = 4, 4, 512, 64, 12
#: families_full: (arch, depth, or None for the whole stack), a prompt of
#: FULL_PROMPT tokens for each of FULL_BATCH rows and FULL_GEN tokens
FULL_MODELS = (("gemma3_12b", 6), ("zamba2_1p2b", None), ("grok1_314b", 1))
FULL_BATCH, FULL_PROMPT, FULL_GEN = 2, 2048, 33
#: decode steps under the profiler in serve_mamba2 and serve_deepseek
FAM_PROFILED_STEPS = 20
RUN_METRICS = ("requests_completed", "dropped_requests", "req_per_s", "latency_p50_s", "latency_p99_s",
               "decode_steps", "decode_tokens", "prefill_s", "decode_s", "decode_tok_per_s", "step_p50_ms",
               "step_p99_ms", "adoptions", "adoption_steps", "adoption_blip_p99_ms", "steady_step_p99_ms",
               "stale_cert_gap_mean", "stale_cert_gap_max", "recompiles", "wall_s")


def _family_pass(cfg, params, tokens, steps: int, extra: dict | None = None):
    """Loss and every gradient of one batch, prefill logits and ``steps``
    greedy tokens (re-buffered caches, in-place decode): (values, tokens).
    ``extra`` adds to the batch (a frontend model's ``frontend_embeds``)."""
    import torch

    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.launch.serving import rebuffer_caches
    from repro_torch.models import decode_step, loss_fn, prefill
    from repro_torch.tree import tree_leaves, tree_map

    extra = extra or {}
    leaves = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    loss, _ = loss_fn(leaves, cfg, {**synthetic_token_batch(tokens), **extra})
    loss.backward()
    grads = [a.grad for a in tree_leaves(leaves)]
    b, s = tokens.shape
    with torch.no_grad():
        logits, pre = prefill(params, cfg, {"tokens": tokens, **extra})
        caches = rebuffer_caches(cfg, pre, b, s + steps, s, cfg.frontend_len if cfg.is_encdec() else 0)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out = [tok]
        for i in range(steps - 1):
            lg, caches = decode_step(params, cfg, tok, caches, s + i, in_place=True)
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out.append(tok)
    return [loss.detach(), logits] + grads, torch.cat(out, 1)


def families_small_ref_phase() -> None:
    """reduced() of each decoder-only family in float32, built on the CPU
    from a seed: loss, gradients, prefill logits and 16 greedy tokens on
    the card twice (the same bits) and against the CPU (tokens equal,
    values within rtol 1e-4 / atol 1e-5 of each output's scale); a
    16-step teacher-forced decode against the full forward on the card at
    the reference's 2e-2."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.models.config import layer_segments
    from repro_torch.models.model import _embed, _logits, _positions
    from repro_torch.models.transformer import forward_stack
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    for arch in FAMILY_IDS:
        cfg = reduced(get_config(arch))
        params = init_params(cfg, SEED, "cpu")
        tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab, (2, FAM_PROMPT))
                                  .astype(np.int32))
        cpu_vals, cpu_toks = _family_pass(cfg, params, tokens, FAM_DECODE)
        gpu = tree_map(lambda a: a.to("cuda"), params)
        a_vals, a_toks = _family_pass(cfg, gpu, tokens.to("cuda"), FAM_DECODE)
        b_vals, b_toks = _family_pass(cfg, gpu, tokens.to("cuda"), FAM_DECODE)
        torch.cuda.synchronize()
        repeat = all(torch.equal(x, y) for x, y in zip(a_vals, b_vals)) and torch.equal(a_toks, b_toks)
        errs = [float((g.cpu() - c).abs().max()) for g, c in zip(a_vals, cpu_vals)]
        close = all(torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-5 * max(1.0, float(c.abs().max())))
                    for g, c in zip(a_vals, cpu_vals))
        same_toks = torch.equal(a_toks.cpu(), cpu_toks)
        with torch.no_grad():
            toks = tokens[:1, :FAM_DECODE].to("cuda")
            x, _, _ = forward_stack(gpu["decoder"], layer_segments(cfg), cfg, _embed(gpu, cfg, toks),
                                    _positions(toks), shared_params=gpu.get("shared_attn"))
            full = _logits(gpu, cfg, x)
            caches = init_cache(cfg, 1, FAM_DECODE, device="cuda")
            dec = []
            for i in range(FAM_DECODE):
                lg, caches = decode_step(gpu, cfg, toks[:, i:i + 1], caches, i)
                dec.append(lg[:, 0])
            dec = torch.stack(dec, 1)
        tf_err = float((dec - full).abs().max())
        tf_ok = bool(torch.allclose(dec, full, rtol=2e-2, atol=2e-2))
        log(f"phase families_small_ref arch={arch} leaves={len(a_vals) - 2} card_repeats_bitwise={repeat} "
            f"tokens_equal_cpu={same_toks} loss_err={errs[0]:.3g} logits_err={errs[1]:.3g} "
            f"grads_max_abs_err={max(errs[2:]):.3g} teacher_forced_max_abs_err={tf_err:.3g} "
            f"tokens={a_toks[0].tolist()}")
        if not (repeat and same_toks and close and tf_ok):
            raise AssertionError(f"families_small_ref {arch}: repeat {repeat}, tokens {same_toks}, "
                                 f"card vs cpu within tolerance {close}, teacher-forced {tf_ok}")
    log(f"phase families_small_ref ok seconds={time.perf_counter() - t0:.3f}")


def _decode_profile(server, cfg, batch, max_len: int, steps: int, profile_from: int):
    """From a batched prefill of ``batch`` (its tokens, and a frontend
    model's embeddings): ``steps`` decode steps of the server's own decode
    step, each ending in the server's host sync, timed without the
    profiler and then again under it, which records the device's kernels
    only (the host's op records add nothing to the device time and took
    the profiler 15-25 s more to process at ~2 800 ops a step). Returns
    (wall ms a step, device ms a step, device ops a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serving import rebuffer_caches

    B, P = batch["tokens"].shape
    with torch.no_grad():
        tok, pre = server._prefill_fn(server.params, batch)
        caches = rebuffer_caches(cfg, pre, B, max_len, P, server.enc_len)
        del pre
        decode = server._decode_fn

        def window(first: int) -> float:
            nonlocal tok, caches
            t0 = time.perf_counter()
            for i in range(steps):
                pos = torch.full((B,), first + i, dtype=torch.int32, device="cuda")
                tok, caches = decode(server.params, tok, caches, pos, None)
                tok.cpu()
            return (time.perf_counter() - t0) * 1e3 / steps

        window(P)  # warm
        wall_ms = window(P + steps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            window(P + 2 * steps)
    del caches, tok
    cuda = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in cuda) / 1e3 / steps
    return wall_ms, busy, sum(e.count for e in cuda) / steps


def _weights_read(cfg, params) -> int:
    """Bytes of the parameters one decode step reads: all but the
    embedding table (a gather of one row a slot), the MTP head (loss only)
    and what only a prefill reads (the encoder, its norm and the frontend
    projection)."""
    from repro_torch.tree import tree_leaves

    skip = {id(a) for k in ("embed", "mtp_head", "encoder", "enc_norm", "frontend_proj") if k in params
            for a in tree_leaves(params[k])}
    return sum(a.numel() * a.element_size() for a in tree_leaves(params) if id(a) not in skip)


def serve_mamba2_phase() -> None:
    """The continuous-batching server on Mamba2-1.3B at full width and
    depth in bf16 (see the module doc)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig
    from repro_torch.launch.steps import dryrun_cfg
    from repro_torch.models import init_params, param_count
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = dryrun_cfg(get_config("mamba2_1p3b"))
    B, P = MAMBA_SLOTS, MAMBA_PROMPT
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (MAMBA_REQUESTS, P), dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    snaps = {}
    for cert, (step, seed) in zip((2.0, 1.0), zip(MAMBA_ADOPT_AT, (SEED + 1, SEED + 2))):
        p = init_params(cfg, seed, "cuda")
        snaps[step] = (tree_map(lambda a: a.to("cpu"), p), cert)
        del p
    torch.cuda.empty_cache()
    snap_s = time.perf_counter() - t0
    params = init_params(cfg, SEED, "cuda")
    n_params = param_count(params)
    param_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    d_inner, H, Pd, N = ssm_dims(cfg)
    state_bytes = cfg.num_layers * B * (H * N * Pd * 4 + (cfg.ssm_conv_width - 1) * (d_inner + 2 * N) * 2)
    log(f"phase serve_mamba2 model arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"ssm_state={cfg.ssm_state} params={n_params} param_bytes={param_bytes} "
        f"dtype={cfg.param_dtype}/{cfg.compute_dtype} decode_state_bytes={state_bytes} "
        f"snapshots_to_host_s={snap_s:.3f}")
    if n_params != 1_446_714_368:
        raise AssertionError(f"serve_mamba2: {n_params} parameters")

    scfg = ServingConfig(slots=B, prompt_len=P, max_new=MAMBA_MAX_NEW, seed=SEED)
    server = ContinuousServer(cfg, scfg, params, device="cuda")
    warm_s = server.warmup()
    counts = server.compile_counts()
    if counts != {"prefill": 2, "decode": 1, "insert": 1}:
        raise AssertionError(f"serve_mamba2: signatures after warmup {counts}")
    load_new = [16 + 16 * (i % 8) for i in range(MAMBA_REQUESTS)]
    reqs = [Request(rid=i, prompt=prompts[i], max_new=load_new[i]) for i in range(MAMBA_REQUESTS)]
    base, base_m = server.run(reqs)
    slot = AdoptionSlot()

    def hook(_, step):
        if step in snaps:
            slot.publish(snaps[step][0], cert=snaps[step][1], round=step)

    ptrs = [x.data_ptr() for x in tree_leaves(server.params)]
    results, m = server.run(reqs, slot=slot, step_hook=hook)
    swapped = [x.data_ptr() for x in tree_leaves(server.params)] == ptrs
    changed = sum(not np.array_equal(x.tokens, y.tokens) for x, y in zip(results, base))
    log(f"phase serve_mamba2 warmup_s={warm_s:.3f} compile_counts={json.dumps(counts)}")
    log(f"phase serve_mamba2 load_no_adoption {json.dumps({k: base_m[k] for k in RUN_METRICS})}")
    log(f"phase serve_mamba2 load_adoption {json.dumps({k: m[k] for k in RUN_METRICS})} "
        f"requests_changed={changed} params_swapped_in_place={swapped}")
    for name, mm, want in (("no_adoption", base_m, 0), ("adoption", m, 2)):
        if not (mm["dropped_requests"] == 0 and mm["recompiles"] == 0 and mm["adoptions"] == want
                and mm["requests_completed"] == MAMBA_REQUESTS):
            raise AssertionError(f"serve_mamba2 {name}: {mm}")
    if not swapped or changed == 0:
        raise AssertionError(f"serve_mamba2: adoption in place {swapped}, {changed} requests changed")
    del snaps, slot, results, base
    gc.collect()

    toks = torch.from_numpy(prompts[:B]).to("cuda")
    with torch.no_grad():
        prefill_ms = event_ms(lambda: server._prefill_fn(server.params, {"tokens": toks}))
        prefill1_ms = event_ms(lambda: server._prefill_fn(server.params, {"tokens": toks[:1]}))
    wall_ms, busy, ops_step = _decode_profile(server, cfg, {"tokens": toks}, P + MAMBA_MAX_NEW,
                                              FAM_PROFILED_STEPS, P)
    # a decode step's least bytes: the weights it reads once, and the SSD
    # state and conv tails read once and written once
    read = _weights_read(cfg, server.params)
    bound_ms = (read + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"phase serve_mamba2 prefill_ms batched={prefill_ms:.3f} ({B}x{P}) single_row={prefill1_ms:.3f}")
    log(f"phase serve_mamba2 decode_profile steps={FAM_PROFILED_STEPS} wall_ms_per_step={wall_ms:.3f} "
        f"device_ms_per_step={busy:.3f} device_idle_share={1 - busy / wall_ms:.4f} "
        f"device_ops_per_step={ops_step:.0f} bytes_bound_ms={bound_ms:.3f} (weights {read} B + state "
        f"{state_bytes} B read and written at {HBM_BYTES_PER_S:.3g} B/s) "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    del server, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase serve_mamba2 ok seconds={time.perf_counter() - t_phase:.3f}")


def serve_deepseek_phase() -> None:
    """The server on DeepSeek-V3 at full width, depth cut to DS_LAYERS, in
    bf16; then one loss with its gradients (see the module doc)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.launch.serving import ContinuousServer, Request, ServingConfig
    from repro_torch.launch.steps import dryrun_cfg
    from repro_torch.models import init_params, loss_fn, param_count
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(dryrun_cfg(get_config("deepseek_v3_671b")), num_layers=DS_LAYERS)
    B, P = DS_SLOTS, DS_PROMPT
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (DS_REQUESTS, P), dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    n_params = param_count(params)
    param_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    log(f"phase serve_deepseek model arch={cfg.name} layers={cfg.num_layers} (first_k_dense="
        f"{cfg.first_k_dense}) d_model={cfg.d_model} experts={cfg.num_experts} "
        f"top_k={cfg.num_experts_per_tok} "
        f"mtp_depth={cfg.mtp_depth} params={n_params} param_bytes={param_bytes} "
        f"dtype={cfg.param_dtype}/{cfg.compute_dtype} init_s={time.perf_counter() - t0:.3f} "
        f"init_max_memory_allocated={init_peak}")
    if n_params != 15_162_481_664:
        raise AssertionError(f"serve_deepseek: {n_params} parameters")

    scfg = ServingConfig(slots=B, prompt_len=P, max_new=DS_MAX_NEW, seed=SEED)
    server = ContinuousServer(cfg, scfg, params, device="cuda")
    warm_s = server.warmup()
    counts = server.compile_counts()
    reqs = [Request(rid=i, prompt=prompts[i], max_new=16 + 16 * (i % 4)) for i in range(DS_REQUESTS)]
    results, m = server.run(reqs)
    log(f"phase serve_deepseek warmup_s={warm_s:.3f} compile_counts={json.dumps(counts)}")
    log(f"phase serve_deepseek load {json.dumps({k: m[k] for k in RUN_METRICS})}")
    if counts != {"prefill": 2, "decode": 1, "insert": 1}:
        raise AssertionError(f"serve_deepseek: signatures after warmup {counts}")
    if not (m["dropped_requests"] == 0 and m["recompiles"] == 0 and m["requests_completed"] == DS_REQUESTS):
        raise AssertionError(f"serve_deepseek: {m}")
    if not all(len(r.tokens) == 16 + 16 * (r.rid % 4) for r in results):
        raise AssertionError("serve_deepseek: a request's token count")

    toks = torch.from_numpy(prompts[:B]).to("cuda")
    with torch.no_grad():
        prefill_ms = event_ms(lambda: server._prefill_fn(server.params, {"tokens": toks}))
        prefill1_ms = event_ms(lambda: server._prefill_fn(server.params, {"tokens": toks[:1]}))
    wall_ms, busy, ops_step = _decode_profile(server, cfg, {"tokens": toks}, P + DS_MAX_NEW,
                                              FAM_PROFILED_STEPS, P)
    read = _weights_read(cfg, server.params)
    latent_token_bytes = cfg.num_layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    cache_read = B * (P + 2 * FAM_PROFILED_STEPS + FAM_PROFILED_STEPS // 2) * latent_token_bytes
    bound_ms = (read + cache_read) / HBM_BYTES_PER_S * 1e3
    log(f"phase serve_deepseek prefill_ms batched={prefill_ms:.3f} ({B}x{P}) single_row={prefill1_ms:.3f}")
    log(f"phase serve_deepseek decode_profile steps={FAM_PROFILED_STEPS} wall_ms_per_step={wall_ms:.3f} "
        f"device_ms_per_step={busy:.3f} device_idle_share={1 - busy / wall_ms:.4f} "
        f"device_ops_per_step={ops_step:.0f} bytes_bound_ms={bound_ms:.3f} (weights {read} B, all 256 "
        f"experts, + latents {cache_read} B at {HBM_BYTES_PER_S:.3g} B/s) "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    del server
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one loss with its gradients (bf16 grads beside the bf16 params)
    torch.cuda.reset_peak_memory_stats()
    batch = synthetic_token_batch(torch.from_numpy(prompts[:1, :256]).to("cuda"))
    leaves = tree_map(lambda a: a.detach().requires_grad_(True), params)
    t0 = time.perf_counter()
    loss, metrics = loss_fn(leaves, cfg, batch)
    loss.backward()
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grads_finite = all(bool(torch.isfinite(a.grad).all()) for a in tree_leaves(leaves))
    router = float(leaves["decoder"][1][0]["moe"]["router"].grad.abs().sum())
    loss = loss.detach()
    log(f"phase serve_deepseek loss_and_grads tokens={tuple(batch['tokens'].shape)} loss={float(loss):.6f} "
        f"metrics={json.dumps({k: float(v) for k, v in metrics.items()})} grads_finite={grads_finite} "
        f"router_grad_abs_sum={router:.6g} seconds={grad_s:.3f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if not (grads_finite and router > 0.0 and np.isfinite(float(loss)) and "mtp_loss" in metrics):
        raise AssertionError(f"serve_deepseek: loss {float(loss)}, grads finite {grads_finite}, "
                             f"router {router}")
    del leaves, loss, metrics, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase serve_deepseek ok seconds={time.perf_counter() - t_phase:.3f}")


def _ring_checks(cfg, params, prompts, full_tokens) -> None:
    """Gemma3's local layers on ring caches (``windowed_cache``) against
    full-length caches, the prompt longer than the window: (1) bf16,
    teacher-forced on the full-cache run's tokens, every step's logits
    within LM_BF16_TOL * (1 + the row's largest |logit|) (six layers of
    bf16 hidden states rounded in another order move a small logit by
    steps of the large ones' spacing); the ring's free-running tokens are
    reported beside the full cache's (bf16 sums over keys in another order
    round differently, and a near-tie can flip a greedy choice); (2) float32
    compute (the same bf16 weights), free-running: the same tokens."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.launch.serving import rebuffer_caches
    from repro_torch.models import decode_step, prefill

    ring_cfg = dataclasses.replace(cfg, windowed_cache=True)
    B, P = prompts.shape
    toks = torch.from_numpy(prompts).to("cuda")
    gen = torch.from_numpy(full_tokens).to("cuda")
    logits = []
    with torch.no_grad():
        for c in (cfg, ring_cfg):
            lg, pre = prefill(params, c, {"tokens": toks})
            caches = rebuffer_caches(c, pre, B, P + FULL_GEN, P, 0)
            del pre
            steps = [lg[:, -1]]
            for i in range(FULL_GEN - 1):
                lg, caches = decode_step(params, c, gen[:, i:i + 1], caches, P + i, in_place=True)
                steps.append(lg[:, -1])
            logits.append(torch.stack(steps, 1))
            del caches
    full, ring = logits
    err = (ring - full).abs()
    tf_ok = bool((err <= LM_BF16_TOL * (1 + full.abs().amax(-1, keepdim=True))).all())
    ring_out = serve(ring_cfg, B, P, FULL_GEN, params=params, prompts=prompts, device="cuda")
    agree = (ring_out["generated"] == full_tokens).all(axis=0)
    lead = int(np.argmin(agree)) if not agree.all() else FULL_GEN
    top2 = torch.topk(full[:, min(lead, FULL_GEN - 1)], 2, dim=-1).values
    log(f"phase families_full arch={cfg.name} ring_bf16 teacher_forced_max_abs_err={float(err.max()):.4g} "
        f"max_abs_logit={float(full.abs().max()):.4g} within_tolerance={tf_ok} "
        f"free_running_tokens_equal={bool(agree.all())} leading_steps_equal={lead} "
        f"full_cache_top2_margin_there={(top2[:, 0] - top2[:, 1]).tolist()} "
        f"ring_step_p50_ms={ring_out['metrics']['step_p50_ms']:.3f} "
        f"ring_tokens={ring_out['generated'][0].tolist()}")
    if not tf_ok:
        raise AssertionError(f"families_full {cfg.name}: ring logits differ by {float(err.max()):.4g}")
    gens = []
    for c in (cfg, ring_cfg):
        c32 = dataclasses.replace(c, compute_dtype="float32")
        gens.append(serve(c32, B, P, FULL_GEN, params=params, prompts=prompts, device="cuda")["generated"])
    same = np.array_equal(gens[0], gens[1])
    log(f"phase families_full arch={cfg.name} ring_float32_compute tokens_equal={same} "
        f"window={cfg.sliding_window} prompt={P} tokens={gens[0][0].tolist()}")
    if not same:
        raise AssertionError(f"families_full {cfg.name}: float32 ring tokens differ from the full cache's")


def families_full_phase() -> None:
    """A prefill of FULL_BATCH x FULL_PROMPT and FULL_GEN - 1 greedy decode
    steps through serve() for Gemma3-12B (one 5:1 unit; ring caches
    checked against full ones, _ring_checks), Zamba2-1.2B whole and Grok-1
    (one layer), bf16 params and compute at full width."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import dryrun_cfg
    from repro_torch.models import init_params, param_count

    t_phase = time.perf_counter()
    for arch, depth in FULL_MODELS:
        cfg = dryrun_cfg(get_config(arch))
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, SEED, "cuda")
        n_params = param_count(params)
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (FULL_BATCH, FULL_PROMPT),
                                                       dtype=np.int32)
        out = serve(cfg, FULL_BATCH, FULL_PROMPT, FULL_GEN, params=params, prompts=prompts, device="cuda")
        m = out["metrics"]
        log(f"phase families_full arch={arch} layers={cfg.num_layers} params={n_params} batch={FULL_BATCH} "
            f"prompt={FULL_PROMPT} gen={FULL_GEN} compile_s={out['compile_s']:.3f} "
            f"prefill_s={out['prefill_s']:.4f} decode_s={out['decode_s']:.4f} tok_per_s={out['tok_per_s']:.1f} "
            f"step_p50_ms={m['step_p50_ms']:.3f} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()} tokens={out['generated'][0].tolist()}")
        if not (m["dropped_requests"] == 0 and m["recompiles"] == 0
                and out["generated"].shape == (FULL_BATCH, FULL_GEN)):
            raise AssertionError(f"families_full {arch}: {m}")
        if cfg.sliding_window:
            _ring_checks(cfg, params, prompts, out["generated"])
        del params, out
        gc.collect()
    torch.cuda.empty_cache()
    log(f"phase families_full ok seconds={time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# the enc-dec and VLM families (phases encdec_small_ref, serve_whisper and
# serve_phi3v)
# ---------------------------------------------------------------------------

ENCDEC_IDS = ("whisper_large_v3", "phi3_vision_4p2b")
#: serve_whisper: whisper-large-v3 whole (32 encoder + 32 decoder layers),
#: slots x (prompt + max_new) = 8 x 448, whisper's decoder context
WHISPER_SLOTS, WHISPER_PROMPT, WHISPER_MAX_NEW = 8, 64, 384
#: serve_phi3v: phi-3-vision-4.2B whole, 8 x (1024 + 128): 576 patches
#: and 448 text positions make up the prompt
PHI3V_SLOTS, PHI3V_PROMPT, PHI3V_MAX_NEW = 8, 1024, 128
#: both: the load's request count and the decode step a snapshot publishes at
ENCDEC_REQUESTS, ENCDEC_ADOPT_AT = 24, 20


def encdec_small_ref_phase() -> None:
    """reduced() of whisper (encoder, cross-attention) and phi-3-vision
    (patch splice) in float32, built on the CPU from a seed: loss, every
    gradient, prefill logits and 16 greedy tokens on the card against the
    CPU (tokens equal, values within rtol 1e-4 / atol 1e-5 of each
    output's scale); then a ContinuousServer run with continuous admission
    (10 requests over 4 slots, each with its own frontend) and one
    adoption, card against CPU: tokens, versions and counting metrics
    equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    counting = ("requests_completed", "dropped_requests", "decode_steps", "decode_tokens", "adoptions",
                "adoption_steps", "recompiles")
    for arch in ENCDEC_IDS:
        cfg = reduced(get_config(arch))
        params, snap = init_params(cfg, SEED, "cpu"), init_params(cfg, SEED + 1, "cpu")
        rng = np.random.default_rng(SEED)
        fshape = (cfg.frontend_len, cfg.frontend_dim)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, FAM_PROMPT), dtype=np.int32))
        fe = torch.from_numpy(rng.standard_normal((2, *fshape), dtype=np.float32) * 0.02)
        cpu_vals, cpu_toks = _family_pass(cfg, params, tokens, FAM_DECODE, {"frontend_embeds": fe})
        gpu = tree_map(lambda a: a.to("cuda"), params)
        vals, toks = _family_pass(cfg, gpu, tokens.to("cuda"), FAM_DECODE, {"frontend_embeds": fe.to("cuda")})
        torch.cuda.synchronize()
        errs = [float((g.cpu() - c).abs().max()) for g, c in zip(vals, cpu_vals)]
        close = all(torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-5 * max(1.0, float(c.abs().max())))
                    for g, c in zip(vals, cpu_vals))
        same_toks = torch.equal(toks.cpu(), cpu_toks)
        prompts = rng.integers(0, cfg.vocab, (10, 24), dtype=np.int32)
        fes = rng.standard_normal((10, *fshape), dtype=np.float32) * 0.02
        scfg = ServingConfig(slots=4, prompt_len=24, max_new=8, seed=SEED)
        runs = {}
        for name in ("cpu", "cuda"):
            own = tree_map(lambda a: a.to(name, copy=True), params)
            server = ContinuousServer(cfg, scfg, own, device=name)
            server.warmup()
            slot = AdoptionSlot()

            def hook(_, step, slot=slot):
                if step == 3:
                    slot.publish(snap, cert=1.0, round=3)

            reqs = [Request(rid=i, prompt=prompts[i], max_new=2 + i % 7, frontend=fes[i]) for i in range(10)]
            runs[name] = server.run(reqs, slot=slot, step_hook=hook)
        (cres, cm), (gres, gm) = runs["cpu"], runs["cuda"]
        server_same = (_tokens_of(gres) == _tokens_of(cres)
                       and [r.versions for r in gres] == [r.versions for r in cres]
                       and {k: gm[k] for k in counting} == {k: cm[k] for k in counting})
        log(f"phase encdec_small_ref arch={arch} leaves={len(vals) - 2} tokens_equal_cpu={same_toks} "
            f"loss_err={errs[0]:.3g} logits_err={errs[1]:.3g} grads_max_abs_err={max(errs[2:]):.3g} "
            f"within_tolerance={close} server_equal_cpu={server_same} server_adoptions={gm['adoptions']} "
            f"server_decode_steps={gm['decode_steps']} tokens={toks[0].tolist()}")
        if not (close and same_toks and server_same and gm["adoptions"] == 1 and gm["dropped_requests"] == 0):
            raise AssertionError(f"encdec_small_ref {arch}: within tolerance {close}, tokens {same_toks}, "
                                 f"server {server_same}, {gm}")
    log(f"phase encdec_small_ref ok seconds={time.perf_counter() - t0:.3f}")


def _serve_frontend_model(phase: str, arch: str, B: int, P: int, max_new: int, load_new: list,
                          n_params_want: int) -> None:
    """One model with a frontend at full width and depth in bf16 through
    ContinuousServer (B slots x (P + max_new)), each request with its own
    stub frontend drawn from a seed (x 0.02): the signatures after warmup,
    row independence with frontends, the frontend changing the first
    logits, the load without and then with one adoption, prefill and
    decode times against the decode step's bytes bound, peak memory."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig
    from repro_torch.launch.steps import dryrun_cfg
    from repro_torch.models import init_params, param_count, prefill
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = dryrun_cfg(get_config(arch))
    n_rows = ENCDEC_REQUESTS + B
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (n_rows, P), dtype=np.int32)
    frontends = rng.standard_normal((n_rows, cfg.frontend_len, cfg.frontend_dim), dtype=np.float32) * 0.02
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = init_params(cfg, SEED + 1, "cuda")
    snap = tree_map(lambda a: a.to("cpu"), p)
    del p
    torch.cuda.empty_cache()
    snap_s = time.perf_counter() - t0
    params = init_params(cfg, SEED, "cuda")
    n_params = param_count(params)
    param_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    kv_token_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.hd() * 2  # self K and V, bf16
    cross_bytes = B * cfg.frontend_len * kv_token_bytes if cfg.is_encdec() else 0
    log(f"phase {phase} model arch={cfg.name} layers={cfg.num_layers} encoder_layers={cfg.encoder_layers} "
        f"d_model={cfg.d_model} heads={cfg.num_heads} "
        f"frontend={cfg.frontend}x({cfg.frontend_len},{cfg.frontend_dim}) params={n_params} "
        f"param_bytes={param_bytes} dtype={cfg.param_dtype}/{cfg.compute_dtype} slots={B} prompt={P} "
        f"max_new={max_new} cross_kv_bytes={cross_bytes} snapshot_to_host_s={snap_s:.3f}")
    if n_params != n_params_want:
        raise AssertionError(f"{phase}: {n_params} parameters")

    def batch(rows):
        toks = torch.from_numpy(prompts[rows]).to("cuda")
        return {"tokens": toks, "frontend_embeds": torch.from_numpy(frontends[rows]).to("cuda")}

    def reqs(rows, news):
        return [Request(rid=i, prompt=prompts[r], max_new=m, frontend=frontends[r])
                for i, (r, m) in enumerate(zip(rows, news))]

    server = ContinuousServer(cfg, ServingConfig(slots=B, prompt_len=P, max_new=max_new, seed=SEED), params,
                              device="cuda")
    warm_s = server.warmup()
    counts = server.compile_counts()
    log(f"phase {phase} warmup_s={warm_s:.3f} compile_counts={json.dumps(counts)}")
    if counts != {"prefill": 2, "decode": 1, "insert": 1}:
        raise AssertionError(f"{phase}: signatures after warmup {counts}")

    # row independence with frontends: row 0's request beside other
    # requests; a request admitted into a retired row (stale self K/V
    # beyond its prefix, the last occupant's cross K/V) and into a row
    # that holds zeros there
    g, late = 32, 2 * B - 1
    t0 = time.perf_counter()
    a, _ = server.run(reqs(range(B), [g] * B))
    b, _ = server.run(reqs([0] + list(range(B, late)), [g] * B))
    stale, _ = server.run(reqs(list(range(B)) + [late], [24] + [2 * g] * (B - 1) + [g]))
    fresh, _ = server.run(reqs(list(range(B)) + [late], [1] + [2 * g] * (B - 1) + [g]))
    rows_ok = np.array_equal(a[0].tokens, b[0].tokens) and not np.array_equal(a[1].tokens, b[1].tokens)
    stale_ok = np.array_equal(stale[B].tokens, fresh[B].tokens)
    # the frontend is live: one prompt, two frontends, two first logits
    two = batch([0, 1])
    two["tokens"] = two["tokens"][:1].expand(2, P).contiguous()
    with torch.no_grad():
        first = prefill(server.params, cfg, two)[0][:, -1]
    frontend_diff = float((first[0] - first[1]).abs().max())
    log(f"phase {phase} row_independence row0_equal={rows_ok} stale_row_admission_equal={stale_ok} "
        f"same_prompt_two_frontends_first_logits_max_abs_diff={frontend_diff:.4g} "
        f"seconds={time.perf_counter() - t0:.3f}")
    if not (rows_ok and stale_ok and frontend_diff > 0.0):
        raise AssertionError(f"{phase}: row independence {rows_ok}, stale-row admission {stale_ok}, "
                             f"frontend changes the logits by {frontend_diff}")
    del a, b, stale, fresh, first

    # the load: without adoption, then with one snapshot published mid-run
    rows = list(range(ENCDEC_REQUESTS))
    base, base_m = server.run(reqs(rows, load_new))
    slot = AdoptionSlot()

    def hook(_, step):
        if step == ENCDEC_ADOPT_AT:
            slot.publish(snap, cert=1.0, round=step)

    ptrs = [x.data_ptr() for x in tree_leaves(server.params)]
    results, m = server.run(reqs(rows, load_new), slot=slot, step_hook=hook)
    swapped = [x.data_ptr() for x in tree_leaves(server.params)] == ptrs
    changed = sum(not np.array_equal(x.tokens, y.tokens) for x, y in zip(results, base))
    log(f"phase {phase} load_no_adoption {json.dumps({k: base_m[k] for k in RUN_METRICS})}")
    log(f"phase {phase} load_adoption {json.dumps({k: m[k] for k in RUN_METRICS})} "
        f"requests_changed={changed} params_swapped_in_place={swapped}")
    for name, mm, want in (("no_adoption", base_m, 0), ("adoption", m, 1)):
        if not (mm["dropped_requests"] == 0 and mm["recompiles"] == 0 and mm["adoptions"] == want
                and mm["requests_completed"] == ENCDEC_REQUESTS):
            raise AssertionError(f"{phase} {name}: {mm}")
    if not (swapped and changed > 0 and all(len(r.tokens) == n for r, n in zip(base, load_new))):
        raise AssertionError(f"{phase}: adoption in place {swapped}, {changed} requests changed")
    del snap, slot, results, base
    gc.collect()

    # prefill times (the encoder included) and a profiled decode window
    bb, b1 = batch(slice(0, B)), batch(slice(0, 1))
    with torch.no_grad():
        prefill_ms = event_ms(lambda: server._prefill_fn(server.params, bb))
        prefill1_ms = event_ms(lambda: server._prefill_fn(server.params, b1))
    steps = FAM_PROFILED_STEPS
    wall_ms, busy, ops_step = _decode_profile(server, cfg, bb, P + max_new, steps, P)
    # a decode step's least bytes: the weights it reads once, the cross K/V
    # read once, and the self K/V of the timed window's positions read once
    read = _weights_read(cfg, server.params)
    self_kv = sum(B * (P + steps + i + 1) * kv_token_bytes for i in range(steps)) / steps
    bound_ms = (read + cross_bytes + self_kv) / HBM_BYTES_PER_S * 1e3
    log(f"phase {phase} prefill_ms batched={prefill_ms:.3f} ({B}x{P}, frontends {B}x{cfg.frontend_len}) "
        f"single_row={prefill1_ms:.3f}")
    log(f"phase {phase} decode_profile steps={steps} wall_ms_per_step={wall_ms:.3f} "
        f"device_ms_per_step={busy:.3f} device_idle_share={1 - busy / wall_ms:.4f} "
        f"device_ops_per_step={ops_step:.0f} bytes_bound_ms={bound_ms:.3f} (weights {read} B + cross K/V "
        f"{cross_bytes} B + self K/V {self_kv:.0f} B at {HBM_BYTES_PER_S:.3g} B/s) "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    del server, params, bb, b1
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase {phase} ok seconds={time.perf_counter() - t_phase:.3f}")


def serve_whisper_phase() -> None:
    _serve_frontend_model("serve_whisper", "whisper_large_v3", WHISPER_SLOTS, WHISPER_PROMPT, WHISPER_MAX_NEW,
                          [32 + 32 * (i % 8) for i in range(ENCDEC_REQUESTS)], 1_601_154_560)


def serve_phi3v_phase() -> None:
    _serve_frontend_model("serve_phi3v", "phi3_vision_4p2b", PHI3V_SLOTS, PHI3V_PROMPT, PHI3V_MAX_NEW,
                          [16 + 16 * (i % 8) for i in range(ENCDEC_REQUESTS)], 3_824_225_280)


# ---------------------------------------------------------------------------
# the launch tooling (phases train, ckpt, sharded_sgd and dryrun)
# ---------------------------------------------------------------------------

#: train: Yi-9B at full width in float32 params (the training launch's
#: get_config), depth cut to TRAIN_LAYERS; the CLI's batch and seq
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 10, 8, 128
#: train_tmsn: the CLI's W and K at lm_sgd's depth, TMSN_ROUNDS rounds
TMSN_W, TMSN_K, TMSN_ROUNDS = 4, 4, 3
#: sharded_sgd: lm_sgd's shape on SHARDED_SGD_RANKS gloo ranks sharing the card
SHARDED_SGD_RANKS, SHARDED_SGD_ROUNDS = 2, 3


def _train_args(**kw):
    import argparse

    base = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=3e-4, seed=SEED, ckpt=None,
                workers=TMSN_W, local_steps=TMSN_K, eps=0.0, device="cuda")
    return argparse.Namespace(**{**base, **kw})


def _matmul_params(shapes) -> int:
    """Every parameter but the embedding table (a gather) and the norm scales."""
    from repro_torch.models import param_count

    norms = shapes["final_norm"].numel() + sum(lay["ln1"].numel() + lay["ln2"].numel()
                                               for seg in shapes["decoder"] for lay in seg)
    return param_count(shapes) - shapes["embed"].numel() - norms


def train_phase():
    """train_sync on Yi-9B (TRAIN_LAYERS layers, float32 params) for
    TRAIN_STEPS steps: losses finite and falling, ms a step, tokens/s;
    then train_tmsn (W = TMSN_W, K = TMSN_K) at 1 layer for TMSN_ROUNDS
    rounds: certificates finite and monotone, ms a round. Returns the
    synchronous run's params (the ckpt phase saves them)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_sync, train_tmsn
    from repro_torch.models import init_params, param_count

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=TRAIN_LAYERS)
    shapes = init_params(cfg, SEED, device="meta")
    n_params, n_matmul = param_count(shapes), _matmul_params(shapes)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_sync(cfg, _train_args())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses, step_s = res["losses"], res["step_seconds"]
    step_ms = statistics.median(step_s[1:]) * 1e3
    flop = 6 * n_matmul * tokens
    log(f"phase train sync arch={cfg.name} layers={cfg.num_layers} params={n_params} matmul_params={n_matmul} "
        f"param_dtype={cfg.param_dtype} compute_dtype={cfg.compute_dtype} batch={TRAIN_BATCH} seq={TRAIN_SEQ} "
        f"steps={TRAIN_STEPS} wall_s={wall:.3f} first_step_ms={step_s[0] * 1e3:.3f} ms_per_step={step_ms:.3f} "
        f"step_ms={[round(s * 1e3, 3) for s in step_s]} tokens_per_s={tokens / (step_ms / 1e3):.1f} "
        f"achieved_tflops={flop / (step_ms / 1e3) / 1e12:.2f} "
        f"bf16_peak_share={flop / (step_ms / 1e3) / BF16_OPS_PER_S:.4f} losses={[round(x, 4) for x in losses]} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train: losses not finite and falling: {losses}")
    params = res["params"]
    del res
    gc.collect()

    tcfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tres = train_tmsn(tcfg, _train_args(steps=TMSN_ROUNDS * TMSN_K))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist, round_s = tres["history"], tres["round_seconds"]
    round_ms = statistics.median(round_s[1:]) * 1e3
    n1 = param_count(init_params(tcfg, SEED, device="meta"))
    log(f"phase train tmsn arch={tcfg.name} layers={tcfg.num_layers} params_per_worker={n1} W={TMSN_W} "
        f"K={TMSN_K} batch={TRAIN_BATCH} seq={TRAIN_SEQ} rounds={len(round_s)} wall_s={wall:.3f} "
        f"first_round_ms={round_s[0] * 1e3:.3f} ms_per_round={round_ms:.3f} "
        f"round_ms={[round(s * 1e3, 3) for s in round_s]} "
        f"tokens_per_s={TMSN_W * TMSN_K * tokens / (round_ms / 1e3):.1f} mean_losses={tres['losses']} "
        f"certificates={hist.tolist()} max_memory_allocated={torch.cuda.max_memory_allocated()}")
    # tests/test_launch.py::test_round_improves_and_certs_monotone's bound
    if not (np.all(np.isfinite(hist)) and np.all(hist[1:] <= hist[:-1] + 1e-2)):
        raise AssertionError(f"train: TMSN certificates not finite and monotone: {hist.tolist()}")
    del tres
    gc.collect()
    log(f"phase train ok seconds={time.perf_counter() - t_phase:.3f}")
    return params


def ckpt_phase(params) -> None:
    """The train phase's params to an npz and back into a fresh tree on
    the card, bit for bit; seconds and GB/s each way; the file deleted."""
    import resource

    import torch

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    nbytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    folder = ROOT / "build" / "ckpt_smoke"
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / "train.npz"
    free = shutil.disk_usage(folder).free
    log(f"phase ckpt disk free_bytes={free} need_bytes={nbytes} folder={folder.relative_to(ROOT)}")
    if free < 1.2 * nbytes:
        raise AssertionError(f"ckpt: {free} bytes free under {folder}, the checkpoint needs {nbytes}")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(str(path), params)
        save_s = time.perf_counter() - t0
        size = path.stat().st_size
        like = tree_map(torch.empty_like, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_checkpoint(str(path), like)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        path.unlink(missing_ok=True)
    leaves = tree_leaves(loaded)
    same = len(leaves) == len(tree_leaves(params)) and all(
        b.device == a.device and b.dtype == a.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(tree_leaves(params), leaves))
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"phase ckpt leaves={len(leaves)} tensor_bytes={nbytes} file_bytes={size} save_s={save_s:.3f} "
        f"save_gb_per_s={nbytes / save_s / 1e9:.3f} load_s={load_s:.3f} load_gb_per_s={nbytes / load_s / 1e9:.3f} "
        f"bitwise={same} process_peak_rss_bytes={rss} file_deleted={not path.exists()}")
    if not same:
        raise AssertionError("ckpt: the loaded params differ from the saved ones")
    log(f"phase ckpt ok seconds={time.perf_counter() - t_phase:.3f}")


def _sgd_worker(device):
    """lm_sgd's worker: Yi-9B at full width, LM_LAYERS layers, K = LM_K,
    batch LM_BATCH x LM_SEQ."""
    from repro_torch.configs import get_config
    from repro_torch.core import TMSNSGDConfig, lm_sgd_worker
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    return lm_sgd_worker(cfg, AdamWConfig(lr=3e-4), TMSNSGDConfig(local_steps=LM_K), batch_size=LM_BATCH,
                         seq=LM_SEQ, device=device)


def _sgd_result(res, wall: float) -> dict:
    import numpy as np

    from repro_torch.tree import tree_map

    return dict(certs=np.asarray(res.final_certificates, np.float32), history=res.history, rounds=res.rounds,
                sums=[checksum(tree_map(lambda a: a.unsqueeze(0), m)).cpu().numpy() for m in res.final_models],
                wall_s=wall,
                sent=res.messages_sent, accepted=res.messages_accepted)


def sharded_sgd_rank(mesh) -> dict:
    """One rank of ``sharded_sgd``: ShardedTMSNEngine over the SGD worker,
    W = SHARDED_SGD_RANKS (one worker a rank), dense gossip, delay 1."""
    import torch

    from repro_torch.core.engine_sharded import ShardedTMSNEngine
    from repro_torch.kernels import ops

    ecfg = dataclasses.replace(engine_config(SHARDED_SGD_RANKS, SHARDED_SGD_ROUNDS, False), mesh=mesh)
    eng = ShardedTMSNEngine(_sgd_worker(mesh.device), ecfg)
    torch.cuda.synchronize(mesh.device)
    ops.reset_launches()
    mesh.collective_seconds, mesh.collectives = 0.0, 0
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize(mesh.device)
    out = _sgd_result(res, time.perf_counter() - t0)
    out.update(rank=mesh.rank, backend=mesh.backend, host_staged=mesh.host_staged, payload_bytes=eng._payload_bytes,
               collective_s=mesh.collective_seconds, collectives=mesh.collectives, launches=dict(ops.LAUNCHES),
               peak=torch.cuda.max_memory_allocated(mesh.device))
    return out


def sharded_sgd_phase() -> dict:
    """TMSN-SGD at lm_sgd's shape on SHARDED_SGD_RANKS gloo ranks sharing
    the card (their collectives staged through host memory) against the
    single-device engine: certificates, history and every final model's
    per-leaf checksums bit for bit. Returns the ranks' kernel launches."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import TMSNEngine
    from repro_torch.launch.mesh import spawn_world

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    single = TMSNEngine(_sgd_worker("cuda"), engine_config(SHARDED_SGD_RANKS, SHARDED_SGD_ROUNDS, False),
                        device="cuda").run()
    torch.cuda.synchronize()
    one = _sgd_result(single, time.perf_counter() - t0)
    one_peak = torch.cuda.max_memory_allocated()
    del single
    gc.collect()
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    # two ranks of ~34 GB each share the card: their allocators map
    # segments that grow in place rather than leave reserved gaps
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            t0 = time.perf_counter()
            ranks = spawn_world(sharded_sgd_rank, ["cuda:0"] * SHARDED_SGD_RANKS, Path(work) / "world")
            spawn_s = time.perf_counter() - t0
    finally:
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    n = SHARDED_SGD_ROUNDS
    for r in ranks:
        same = (np.array_equal(bits(r["certs"]), bits(one["certs"])) and r["history"] == one["history"]
                and all(np.array_equal(a, b) for a, b in zip(r["sums"], one["sums"]))
                and len(r["sums"]) == len(one["sums"]))
        # the collectives: one gather of every worker's model a round and one
        # at the end (each SHARDED_SGD_RANKS x the payload), and the
        # history's object gather (a few kB)
        log(f"phase sharded_sgd rank={r['rank']} backend={r['backend']} host_staged={r['host_staged']} "
            f"rounds={r['rounds']} wall_ms_per_round={r['wall_s'] / n * 1e3:.3f} (the engine's init included) "
            f"collective_ms={r['collective_s'] * 1e3:.3f} collectives={r['collectives']} "
            f"ms_per_model_gather={r['collective_s'] / (n + 1) * 1e3:.3f} "
            f"payload_bytes={r['payload_bytes']} gathered_bytes_per_round={SHARDED_SGD_RANKS * r['payload_bytes']} "
            f"sent={r['sent']} accepted={r['accepted']} max_memory_allocated={r['peak']} "
            f"launches={json.dumps(r['launches'])} equal_single_device={same}")
        if not same:
            raise AssertionError(f"sharded_sgd: rank {r['rank']} differs from one device: certificates "
                                 f"{r['certs'].tolist()} vs {one['certs'].tolist()}")
    log(f"phase sharded_sgd single_device wall_ms_per_round={one['wall_s'] / n * 1e3:.3f} "
        f"max_memory_allocated={one_peak} certificates={one['certs'].tolist()} accepted={one['accepted']} "
        f"world_seconds={spawn_s:.3f}")
    if not (np.all(np.isfinite(one["certs"])) and one["sent"] > 0):
        raise AssertionError(f"sharded_sgd: certificates {one['certs'].tolist()}, {one['sent']} broadcasts")
    log(f"phase sharded_sgd ok ranks={SHARDED_SGD_RANKS} bitwise==single device (certificates, history, "
        f"per-leaf model checksums) seconds={time.perf_counter() - t_phase:.3f}")
    launches: dict = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def dryrun_phase() -> None:
    """launch/dryrun.py's run_one for every arch and shape on both
    production meshes, and the TMSN round for the train shapes: counts by
    status (no error allowed) and the records whose arguments do not fit
    one card's 80 GB."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.steps import INPUT_SHAPES

    t0 = time.perf_counter()
    counts, no_fit, errors = {"ok": 0, "skip": 0, "error": 0}, [], []
    for multi in (False, True):
        for arch in ARCH_IDS:
            for shape, (_, _, kind) in INPUT_SHAPES.items():
                for tmsn in ((False, True) if kind == "train" else (False,)):
                    rec = run_one(arch, shape, multi, tmsn=tmsn)
                    counts[rec["status"]] += 1
                    if rec["status"] == "error":
                        errors.append(f"{arch} {shape} {rec['mesh']} tmsn={tmsn}: {rec['error']}")
                    elif rec["status"] == "ok" and not rec["fits_hbm"]:
                        no_fit.append(f"{arch}/{shape}/{rec['mesh']}{'/tmsn' if tmsn else ''}="
                                      f"{rec['memory']['argument_size_in_bytes']}")
    log(f"phase dryrun records={sum(counts.values())} ok={counts['ok']} skip={counts['skip']} "
        f"error={counts['error']} seconds={time.perf_counter() - t0:.3f}")
    log(f"phase dryrun does_not_fit_80GB argument_bytes={json.dumps(no_fit)}")
    if errors:
        raise AssertionError("dryrun: " + "; ".join(errors))


# ---------------------------------------------------------------------------
# K5 adamw_step (in the kernels phase; ``chip_smoke.py --k5`` runs it alone)
# ---------------------------------------------------------------------------

#: leaf dtype pairs (params and grads, moments) K5 is checked at; the first
#: is the benchmark's, and sets the times
K5_PAIRS = (("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16"),
            ("bfloat16", "bfloat16"))


def k5_check(time_ms, device_ms) -> dict:
    """K5 at Yi-9B's one-layer leaf shapes (LM_ARCH, 1 layer: 697 315 328
    parameters in 12 leaves), one launch a step: bit for bit
    ``optim.adamw._update`` for every pair of K5_PAIRS and on a second
    launch; at the first pair, device ms (the mean of the profiler's
    records of K5's kernel, with their count),
    CUDA-event ms of the in-place step, the bytes bound, the plain
    version's times and ``torch._fused_adamw_``'s (a yardstick only: the
    port never calls it; its update is another formula). Returns the
    kernels line's record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import _corrections, _update
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=1)
    shapes = [tuple(a.shape) for a in tree_leaves(init_params(cfg, SEED, device="meta"))]
    n = sum(int(torch.Size(s).numel()) for s in shapes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rec = {"name": "adamw_step", "route": "cuda", "source": "src/repro_torch/kernels/csrc/adamw_step.cu",
           "replaces": "none (the reference's update is plain jnp, fused by XLA)", "launches": None,
           "max_abs_err": 0.0, "params": n, "leaves": len(shapes)}
    for pdt, sdt in K5_PAIRS:
        opt_cfg = AdamWConfig(lr=3e-4, state_dtype=sdt)
        pt, st = getattr(torch, pdt), getattr(torch, sdt)
        leaves = []
        for s in shapes:
            v = [torch.randn(s, generator=gen, device=dev) * k for k in (1.0, 1e-2, 1e-2, 1e-4)]
            leaves.append((v[0].to(pt), v[1].to(pt), v[2].to(st), v[3].abs().to(st)))
            del v
        step = torch.full((), 7, dtype=torch.int32, device=dev)
        b1c, b2c = _corrections(step, opt_cfg)
        outs = [(torch.empty_like(p), torch.empty_like(mu), torch.empty_like(nu)) for p, _, mu, nu in leaves]
        table = [(*leaf, *out) for leaf, out in zip(leaves, outs)]
        same = True
        for _ in range(2):
            ops.reset_launches()
            ops.adamw_step(table, b1c, b2c, opt_cfg.lr, opt_cfg)
            torch.cuda.synchronize()
            if ops.LAUNCHES["adamw_step"] != 1:
                raise AssertionError(f"K5 {pdt}/{sdt}: {ops.LAUNCHES['adamw_step']} launches for one step")
            for (p, g, mu, nu), got in zip(leaves, outs):
                want = _update(p, g, mu, nu, b1c, b2c, opt_cfg.lr, opt_cfg)
                same = same and all(torch.equal(a, b) for a, b in zip(got, want))
                del want
        del outs, table
        if not same:
            raise AssertionError(f"K5 {pdt}/{sdt}: not the plain update's bits")
        line = (f"phase kernels K5 adamw_step params={pdt} state={sdt} leaves={len(shapes)} n={n} "
                "bitwise_equal=True")
        if (pdt, sdt) == K5_PAIRS[0]:
            # the in-place step, as the SGD worker runs it from its second step
            inplace = [(p, g, mu, nu, p, mu, nu) for p, g, mu, nu in leaves]
            ms = time_ms(lambda: ops.adamw_step(inplace, b1c, b2c, opt_cfg.lr, opt_cfg), reps=5, samples=9)
            # K5's own kernel records, their mean and their count: a record
            # the profiler drops leaves the others' times as they are
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    ops.adamw_step(inplace, b1c, b2c, opt_cfg.lr, opt_cfg)
                torch.cuda.synchronize()
            k5_recs = [e for e in prof.key_averages() if "adamw_step_kernel" in e.key]
            n_recs = sum(e.count for e in k5_recs)
            dev_ms = sum(e.self_device_time_total for e in k5_recs) / n_recs / 1e3 if n_recs else None
            del prof

            def plain():
                for p, g, mu, nu in leaves:
                    _update(p, g, mu, nu, b1c, b2c, opt_cfg.lr, opt_cfg, out=(p, mu, nu))

            plain_ms = time_ms(plain, reps=2, samples=5)
            plain_dev_ms = device_ms(plain, reps=2)
            ps, gs, ms_, ns = (list(x) for x in zip(*leaves))
            steps = [torch.full((), 7.0, device=dev) for _ in leaves]

            def fused():
                torch._fused_adamw_(ps, gs, ms_, ns, [], steps, lr=opt_cfg.lr, beta1=opt_cfg.b1,
                                    beta2=opt_cfg.b2, weight_decay=opt_cfg.weight_decay, eps=opt_cfg.eps,
                                    amsgrad=False, maximize=False)

            lib_ms = time_ms(fused, reps=5, samples=9)
            lib_dev_ms = device_ms(fused, reps=5)
            bnd = bound(28 * n, 20 * n)
            rec.update(ms=ms, device_ms=dev_ms, device_records=f"{n_recs} of 5", plain_ms=plain_ms,
                       plain_device_ms=plain_dev_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms, library_device_ms=lib_dev_ms,
                       roofline_share=bnd[0] / dev_ms if dev_ms else None)
            line += (f" ms={ms:.5f} device_ms={dev_ms} device_records={n_recs}/5 plain_ms={plain_ms:.5f} "
                     f"plain_device_ms={plain_dev_ms} fused_adamw_ms={lib_ms:.5f} "
                     f"fused_adamw_device_ms={lib_dev_ms} "
                     f"bound_ms={bnd[0]:.5f} ({bnd[1]}) share_of_bound={rec['roofline_share']}")
        log(line)
        del leaves
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# K6 attention (in the kernels phase; ``chip_smoke.py --k6`` runs it alone)
# ---------------------------------------------------------------------------

#: K6's checks: (b, s, H, K, window, positions). Yi-9B's heads at its
#: context with one sequence, ragged lengths, a window, positions that are
#: not the index: shifted by a different offset in each row, and each
#: repeated twice (so a query sees the key after it); last, the main
#: path's own shape (``yi9b_l1.sgd_long``: two sequences of 4096)
K6_CASES = (
    (1, 4096, 32, 4, None, "index"),
    (2, 1, 8, 2, None, "index"),
    (2, 100, 8, 2, None, "index"),
    (1, 129, 8, 2, None, "index"),
    (2, 1000, 8, 2, None, "index"),
    (2, 1000, 8, 2, 100, "index"),
    (2, 300, 8, 2, None, "offset"),
    (2, 300, 8, 2, 64, "repeated"),
    (2, 4096, 32, 4, None, "index"),
)
#: K6 timed at ``yi9b_l1.sgd_long``'s attention: (b, s, H, K), head 128
K6_TIMED = (2, 4096, 32, 4)
#: K6's (192, 128) instance, MLA expanded (DeepSeek-V3's and Moonlight's
#: keys of 128 + 64 rotary, values of 128; a KV head a query head):
#: Moonlight's 16 heads at one sequence of 4096 and at
#: ``moonlight_l5.sgd_zipf_4k``'s four, a short odd length, positions that
#: are not the index, and DeepSeek-V3's 128 heads at ``serve_deepseek``'s
#: prompt of 512
K6_MLA_CASES = (
    (1, 4096, 16, 16, None, "index"),
    (4, 4096, 16, 16, None, "index"),
    (2, 129, 16, 16, None, "index"),
    (2, 300, 16, 16, None, "offset"),
    (2, 512, 128, 128, None, "index"),
)
#: the (192, 128) cases run twice for the bit-for-bit repeat in the card tests
K6_MLA_REPEATED = (K6_MLA_CASES[1], K6_MLA_CASES[3], K6_MLA_CASES[4])
#: ... timed at ``moonlight_l5.sgd_zipf_4k``'s attention: (b, s, H, K)
K6_MLA_TIMED = (4, 4096, 16, 16)
#: K6's instances: (qk, v) head widths, its checks, the shape it is timed at
K6_INSTANCES = (((128, 128), K6_CASES, K6_TIMED), ((192, 128), K6_MLA_CASES, K6_MLA_TIMED))
#: largest block error (k6_block_errors) K6 may read against the float32
#: ``_sdpa``, for O, dq, dk and dv. K6 rounds O, dQ, dK and dV to bf16 (half
#: a bf16 step, 2^-9 of the value), and P and dS to bf16 where they enter
#: the tensor cores; the float32 reference rounds nothing. The bf16
#: ``_sdpa`` the port ran before rounds the scores before the scale as well
#: and reads above this bound (PERF.md §6)
K6_TOL = 1e-2
#: positions a block of k6_block_errors holds: rows this near each other
#: have values of one size (a query's O averages about as many values as
#: its neighbours'), so a row lost or garbled anywhere reads as large as
#: the block's largest value
K6_BLOCK = 64
#: a block whose reference is below this everywhere is held against it
#: instead: the inputs are unit normals, so such blocks are the gradients
#: the reference has at exactly 0 (a sequence of one position: softmax's
#: backward cancels), where K6's D = rowsum(dO * O) and dP = dO V^T are one
#: sum in two orders and cancel to ~1e-6, not to 0
K6_FLOOR = 1e-3
#: K6's device ms (the profiler's records) may differ from its CUDA-event
#: ms by this share at most: its kernels run back to back, so only the
#: launch gaps of a millisecond-long call lie between the two; more means
#: the profiler lost or mixed records, and the device reading is refused
K6_DEVICE_VS_EVENTS = 0.1


def k6_positions(kind: str, b: int, s: int, dev):
    import torch

    ar = torch.arange(s, dtype=torch.int32, device=dev)
    if kind == "index":
        return ar.expand(b, s)  # as models.model._positions makes them
    if kind == "offset":
        return ar + 37 + 11 * torch.arange(b, dtype=torch.int32, device=dev)[:, None]
    return (ar // 2).expand(b, s).contiguous()


def k6_inputs(b, s, H, K, dev, seed=SEED, hd=128, dv=None):
    """q, k, v and dO: unit normals rounded to bf16, drawn from ``seed``;
    q and k ``hd`` wide, v and dO ``dv`` (``hd`` where None)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dv = dv or hd
    return [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            for shape in ((b, s, H, hd), (b, s, K, hd), (b, s, K, dv), (b, s, H, dv))]


def k6_run(fn, q, k, v, do, dtype):
    """fn(q, k, v) -> (b, s, H, hd) and its gradients, on copies of q, k, v
    in ``dtype``: [o, dq, dk, dv]."""
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
    o = fn(*leaves)
    o.backward(do.to(o.dtype))
    return [o.detach()] + [t.grad for t in leaves]


def k6_plain(pos, window):
    """models.attention._sdpa as gqa_full calls it, on (b, s, H, hd) q."""
    from repro_torch.models.attention import _causal_window_mask, _sdpa

    mask = _causal_window_mask(pos, pos, window)

    def fn(q, k, v):
        b, s, H, hd = q.shape
        K = k.shape[2]
        return _sdpa(q.reshape(b, s, K, H // K, hd), k, v, mask, hd ** -0.5).reshape(b, s, H, v.shape[-1])

    return fn


def k6_kernel(pos, window):
    """K6 through its autograd node, as gqa_full calls it."""
    from repro_torch.models.attention import _K6

    return lambda q, k, v: _K6.apply(q, k, v, pos, window, q.shape[-1] ** -0.5)


def k6_block_errors(got, want) -> list:
    """For o, dq, dk, dv: the largest, over blocks of K6_BLOCK positions at
    one head of one sequence, of max |got - want| over max(max |want|,
    K6_FLOOR) in the block. Not one row alone: a query's dq cancels
    wherever its few keys' dP happen to agree, and there any rounding of O
    (whose D it subtracts) is large next to the row but not next to its
    neighbours. Not the whole tensor: late rows of a long sequence are
    small (an average over thousands of values), and a tolerance of the
    largest magnitude would let them be lost."""
    out = []
    for a, w in zip(got, want):
        err = 0.0
        for ab, wb in zip(a.float().split(K6_BLOCK, 1), w.float().split(K6_BLOCK, 1)):
            gap = (ab - wb).abs().amax(dim=(1, 3))
            err = max(err, float((gap / wb.abs().amax(dim=(1, 3)).clamp_min(K6_FLOOR)).max()))
        out.append(err)
    return out


def k6_check(time_ms) -> dict:
    """K6 against ``_sdpa`` computed in float32 from the same bf16 inputs,
    at every case of each instance (K6_INSTANCES): forward and dq, dk, dv by
    block error (k6_block_errors, held to K6_TOL), and the bf16 ``_sdpa``'s
    own errors beside it; the forward and the backward repeat bit for bit.
    Each instance timed at its shape (k6_times); the 128/128 instance's
    times are the record's own, the 192/128 instance's its ``mla`` entry.
    Returns the kernels line's record."""
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    rec = {"name": "attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/attention.cu",
           "replaces": "none (the reference's attention is plain jnp, fused by XLA)", "launches_fwd": None,
           "launches_bwd": None, "tolerance": K6_TOL, "max_block_err": {}, "plain_bf16_block_err": {}}
    worst, worst_plain = [0.0] * 4, [0.0] * 4
    for (hd, dv), cases, _ in K6_INSTANCES:
        for b, s, H, K, window, kind in cases:
            case = (b, s, H, K, hd, dv, window, kind)
            pos = k6_positions(kind, b, s, dev)
            q, k, v, do = k6_inputs(b, s, H, K, dev, hd=hd, dv=dv)
            want = k6_run(k6_plain(pos, window), q, k, v, do, torch.float32)
            perr = k6_block_errors(k6_run(k6_plain(pos, window), q, k, v, do, torch.bfloat16), want)
            runs = []
            for _ in range(2):
                ops.reset_launches()
                runs.append(k6_run(k6_kernel(pos, window), q, k, v, do, torch.bfloat16))
                torch.cuda.synchronize()
                if (ops.LAUNCHES["attention_fwd"], ops.LAUNCHES["attention_bwd"]) != (1, 1):
                    raise AssertionError(f"K6 {case}: launches {ops.LAUNCHES}")
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            err = k6_block_errors(runs[0], want)
            worst = [max(x, y) for x, y in zip(worst, err)]
            worst_plain = [max(x, y) for x, y in zip(worst_plain, perr)]
            log(f"phase kernels K6 attention b={b} s={s} H={H} K={K} hd={hd} dv={dv} window={window} "
                f"positions={kind} repeat_bitwise={same} block_err_o_dq_dk_dv={['%.3e' % e for e in err]} "
                f"plain_bf16_block_err={['%.3e' % e for e in perr]} tolerance={K6_TOL}")
            if not same:
                raise AssertionError(f"K6 {case}: a repeat gave other bits")
            if not all(e <= K6_TOL for e in err):
                raise AssertionError(f"K6 {case}: block err {err} above {K6_TOL}")
            del q, k, v, do, want, runs
            torch.cuda.empty_cache()
    rec["max_block_err"] = dict(zip(("o", "dq", "dk", "dv"), worst))
    rec["plain_bf16_block_err"] = dict(zip(("o", "dq", "dk", "dv"), worst_plain))
    for (hd, dv), _, shape in K6_INSTANCES:
        times = k6_times(time_ms, *shape, hd, dv)
        if (hd, dv) == (128, 128):
            rec.update(times)
        else:
            rec["mla"] = times
    return rec


def k6_times(time_ms, b, s, H, K, hd, dv) -> dict:
    """K6 at (b, s, H, K) and head widths (hd, dv): device ms (the sum over
    K6's kernels of the mean of the profiler's records of each, with their
    count), CUDA-event ms (the two held within K6_DEVICE_VS_EVENTS of each
    other), the bound at BF16_OPS_PER_S on causal FLOPs (forward 2 (hd +
    dv) a visible pair, backward 2 (3 hd + 2 dv): S again, dP, dV, dK, dQ),
    the plain ``_sdpa``'s ms and ``scaled_dot_product_attention``'s (a
    yardstick only: the port never calls it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models.attention import _K6

    dev = torch.device("cuda")
    scale = hd ** -0.5
    pos = k6_positions("index", b, s, dev)
    q, k, v, do = k6_inputs(b, s, H, K, dev, hd=hd, dv=dv)
    o, lse, bounds = ops.attention_fwd(q, k, v, pos, None, scale)

    def fwd():
        ops.attention_fwd(q, k, v, pos, None, scale)

    def bwd():
        ops.attention_bwd(q, k, v, pos, o, lse, bounds, do, None, scale)

    def k6_device_ms(fn, calls=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per = {}  # kernel -> [records, device ms a record]
        for e in prof.key_averages():
            m = re.search(r"attention_\w+_kernel", e.key)
            if m and e.count:
                per[m.group(0)] = [e.count, e.self_device_time_total / e.count / 1e3]
        # each kernel runs once a call: the sum of their means stands when
        # the profiler drops records, as it does late in the whole smoke
        return (sum(ms for _, ms in per.values()) if per else None), per

    pairs = b * H * s * (s + 1) / 2
    bound_fwd = pairs * 2 * (hd + dv) / BF16_OPS_PER_S * 1e3
    bound_bwd = pairs * 2 * (3 * hd + 2 * dv) / BF16_OPS_PER_S * 1e3
    fwd_dev, fwd_recs = k6_device_ms(fwd)
    bwd_dev, bwd_recs = k6_device_ms(bwd)
    fwd_ms = time_ms(fwd, reps=5, samples=9)
    bwd_ms = time_ms(bwd, reps=5, samples=9)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd_k6():
        _K6.apply(*leaves, pos, None, scale).backward(do)

    fb_ms = time_ms(fwd_bwd_k6, reps=3, samples=7)
    plain_fn = k6_plain(pos, None)
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: plain_fn(q, k, v), reps=2, samples=5)

    def fwd_bwd_plain():
        plain_fn(*leaves).backward(do)

    plain_fb_ms = time_ms(fwd_bwd_plain, reps=1, samples=5)
    torch.cuda.empty_cache()
    G = H // K
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_(True) for t in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        lib_fwd_ms = time_ms(lambda: sdpa(lq, lk, lv, is_causal=True, scale=scale), reps=5, samples=9)
    do_t = do.transpose(1, 2)
    lib_fb_ms = time_ms(lambda: sdpa(lq, lk, lv, is_causal=True, scale=scale).backward(do_t), reps=3, samples=7)
    rec = dict(shape={"b": b, "s": s, "H": H, "K": K, "hd": hd, "dv": dv}, fwd_device_ms=fwd_dev,
               fwd_device_records=fwd_recs, bwd_device_ms=bwd_dev, bwd_device_records=bwd_recs, fwd_ms=fwd_ms,
               bwd_ms=bwd_ms, fwd_bwd_ms=fb_ms, bound_fwd_ms=bound_fwd, bound_bwd_ms=bound_bwd,
               bound_by="operations", fwd_share_of_bound=bound_fwd / fwd_dev if fwd_dev else None,
               bwd_share_of_bound=bound_bwd / bwd_dev if bwd_dev else None,
               plain_fwd_ms=plain_fwd_ms, plain_fwd_bwd_ms=plain_fb_ms, library_fwd_ms=lib_fwd_ms,
               library_fwd_bwd_ms=lib_fb_ms,
               device_over_events={"fwd": fwd_dev / fwd_ms if fwd_dev else None,
                                   "bwd": bwd_dev / bwd_ms if bwd_dev else None})
    log(f"phase kernels K6 attention timed hd={hd} dv={dv} " + json.dumps(rec))
    for part, ratio in rec["device_over_events"].items():
        if ratio is None or abs(ratio - 1) > K6_DEVICE_VS_EVENTS:
            raise AssertionError(f"K6 ({hd}, {dv}) {part}: device ms over events ms {ratio}, not within "
                                 f"{K6_DEVICE_VS_EVENTS:.0%} of 1")
    del q, k, v, do, o, lse, bounds, leaves, lq, lk, lv
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    import torch

    # ---------------------------------------------------------------- device
    if not torch.cuda.is_available():
        print("phase device FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--k1-repeat"]:  # one fresh process of K1's repeat check
        print(json.dumps(k1_repeat(int(sys.argv[2]))), flush=True)
        return 0
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
    for line in (path.parent / build.PTXAS_LOG).read_text().splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line or "entry function" in line:
            log(f"phase build ptxas {line.strip()}")

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
    if sys.argv[1:2] == ["--k5"]:  # K5 alone: its checks and times, the kernels line its record
        log(json.dumps({"kernels": [k5_check(time_ms, device_ms)]}))
        return 0
    if sys.argv[1:2] == ["--k6"]:  # K6 alone: its checks and times, the kernels line its record
        log(json.dumps({"kernels": [k6_check(time_ms)]}))
        return 0

    # the launch floor: device time of the smallest kernel PyTorch launches
    one = torch.empty((1,), device=dev)
    floor_dev = device_ms(lambda: one.fill_(1.0))
    floor_ms = time_ms(lambda: one.fill_(1.0))
    log(f"phase kernels launch_floor fill_1_element device_ms={floor_dev} ms={floor_ms:.5f}")

    def record(name, source, replaces, err, main_shape, ms, plain_ms, bnd, library_ms, dev_ms):
        rec = records.setdefault(name, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0,
        })
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if main_shape:  # the main path's shape sets the times
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                       library_ms=library_ms, device_ms=dev_ms)

    # K1 edge_scan: the engine (W=10), one rank of the sharded and pod
    # engines (W=5), the pod phase's single device (W=20), large W, the
    # event simulator's scan segments (W=1) and exact greedy over the
    # training split (W=1, n=180 000)
    for nw, n, d, nb in [(10, 2048, 64, 8), (5, 2048, 64, 8), (20, 2048, 64, 8), (256, 2048, 64, 8),
                         (1, 2048, 64, 8), (1, 180_000, 64, 8)]:
        xb = torch.randint(0, nb, (nw, n, d), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand((nw, n), generator=g, device=dev) + 0.05
        y = torch.where(torch.rand((nw, n), generator=g, device=dev) < 0.5, 1.0, -1.0)
        if n >= 100_000:
            # how far each version's float32 sums of these weights are from
            # exact (float64) ones; then weights in multiples of 1/64, whose
            # float32 sums are exact in any order, for the 1e-5 check below
            exact = (torch.where(xb.unsqueeze(-1) == torch.arange(nb, device=dev, dtype=torch.int32),
                                 (w * y).double()[..., None, None], 0.0).sum(dim=-3),
                     w.double().abs().sum(-1), (w.double() ** 2).sum(-1), (w * y).double().sum(-1))
            f32 = [ops.edge_scan(xb, w * y, w, num_bins=nb), ref.edge_scan_ref(xb, w * y, w, nb)]
            rel = [max(float(((a.double() - b) / b.abs().clamp(min=1.0)).abs().max()) for a, b in zip(out, exact))
                   for out in f32]
            log(f"phase kernels K1 edge_scan W={nw} n={n} float32 weights: max error relative to the float64 "
                f"sums kernel={rel[0]:.3g} plain={rel[1]:.3g}")
            del exact, f32
            w = torch.randint(1, 65, (nw, n), generator=g, device=dev).float() / 64
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
        lib_dev_ms = device_ms(lambda: buf.index_add_(0, flat, src))
        dev_ms = device_ms(lambda: ops.edge_scan(xb, wy, w, num_bins=nb))
        nbytes = xb.numel() * 4 + 2 * nw * n * 4 + nw * d * nb * 4 + 3 * nw * 4
        bnd = bound(nbytes, nw * n * d * nb + 3 * nw * n)
        plan = ops.edge_scan_plan(nw, n, torch.cuda.get_device_properties(dev).multi_processor_count)
        log(f"phase kernels K1 edge_scan W={nw} n={n} d={d} B={nb} plan(tile_rows,tiles,group,fold)={plan} "
            f"deterministic={det} max_abs_err={err:.3g} ms={ms:.5f} device_ms={dev_ms} "
            f"plain_ms={plain_ms:.5f} index_add_ms={lib_ms:.5f} index_add_device_ms={lib_dev_ms} "
            f"bound_ms={bnd[0]:.5f} ({bnd[1]})")
        record("edge_scan", "src/repro_torch/kernels/csrc/edge_scan.cu",
               "src/repro/kernels/edge_scan.py:60", err, nw == 10, ms, plain_ms, bnd, lib_ms, dev_ms)
        if nw == 10:
            records["edge_scan"]["library_device_ms"] = lib_dev_ms
        del xb, w, y, wy, flat, src, buf, got, again, plain

    # K1's repeat check (its ticket counters live between launches): here,
    # then in fresh processes, then under compute-sanitizer's racecheck
    # where the machine has it (recorded, whichever way it ends)
    t0 = time.perf_counter()
    repeats = {"this_process": k1_repeat(K1_REPEATS)}
    for i in range(K1_REPEAT_PROCESSES):
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--k1-repeat", str(K1_REPEATS)],
                              capture_output=True, text=True, timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(f"K1 repeat process {i} exited {proc.returncode}: {proc.stderr[-2000:]}")
        repeats[f"fresh_process_{i}"] = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"phase kernels K1 repeat {json.dumps(repeats)} seconds={time.perf_counter() - t0:.3f}")
    bad = {k: v for k, v in repeats.items()
           if any(s["mismatches"] or s["counters_nonzero"] for s in v.values())}
    if bad:
        raise AssertionError(f"K1 repeat: launches differ or counters left set: {bad}")
    sanitizer = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if Path(sanitizer).is_file():
        cmd = [sanitizer, "--tool", "racecheck", sys.executable, str(ROOT / "chip_smoke.py"),
               "--k1-repeat", "2"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                                start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=120)
            tail = " | ".join(text.strip().splitlines()[-3:])
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            tail = "timed out after 120 s"
        log(f"phase kernels K1 racecheck tool={sanitizer} rc={proc.returncode} last_lines={tail!r}")
    else:
        log("phase kernels K1 racecheck tool=absent (no compute-sanitizer on this machine)")

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def queue_leaves(nw, cap):
        fill = torch.rand((nw, cap), generator=g, device=dev) < 0.6
        return (torch.where(fill, -torch.rand((nw, cap), generator=g, device=dev) - 0.01, float("inf")),
                torch.randint(0, 4, (nw, cap), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, nw, (nw, cap), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, 3, (nw, cap), generator=g, device=dev, dtype=torch.int32))

    def round_equal(args, r):
        """K2 bitwise equal to its plain version and to its own second launch."""
        got = ops.round_deliver(*args, r, eps=0.01)
        again = ops.round_deliver(*args, r, eps=0.01)
        plain = ref.round_step_ref(*args, r, eps=0.01)
        return all(torch.equal(bits(a), bits(b)) and torch.equal(bits(a), bits(c))
                   for a, b, c in zip(got, again, plain))

    # K2 round_step: the engine (W=10), one rank of the sharded and pod
    # engines (W=5, and W=1024 of the sharded toy), the pod phase's single
    # device (W=20) and the large-W queues (W=4096, 10240)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nw in (10, 5, 20, 1024, 4096, 10240):
        cap = 64
        args = queue_leaves(nw, cap) + (
            -torch.rand((nw,), generator=g, device=dev), torch.rand((nw,), generator=g, device=dev) < 0.8,
            torch.rand((nw,), generator=g, device=dev), torch.linspace(0.2, 1.0, nw, device=dev))
        for r in (0, 2):
            if not round_equal(args, r):
                raise AssertionError(f"K2 W={nw} r={r}: differs from round_step_ref or from its second launch")
        ms = time_ms(lambda: ops.round_deliver(*args, 2, eps=0.01))
        plain_ms = time_ms(lambda: ref.round_step_ref(*args, 2, eps=0.01))
        dev_ms = device_ms(lambda: ops.round_deliver(*args, 2, eps=0.01))
        nbytes = nw * cap * 20 + nw * 13 + nw * 22
        bnd = bound(nbytes, nw * cap * 10)
        log(f"phase kernels K2 round_step W={nw} C={cap} plan(vec,row_lanes,warps_per_block)="
            f"{ops.round_step_plan(nw, cap, sms)} bitwise_equal=True repeat=True ms={ms:.5f} "
            f"device_ms={dev_ms} plain_ms={plain_ms:.5f} bound_ms={bnd[0]:.6f} ({bnd[1]})")
        record("round_step", "src/repro_torch/kernels/csrc/round_step.cu",
               "src/repro/kernels/round_step.py:217", 0.0, nw == 10, ms, plain_ms, bnd, None, dev_ms)
        del args

    # K2 edge cases: +-0.0 ties in one row, +-inf and NaN certs, ties in cert
    # and src, due = -1, dead destinations, C = 1, C % 4 != 0, C = 3500, W not
    # a multiple of the rows a block holds, queue leaves off a 16-byte boundary
    k2_pool = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), -1.0, -0.5, -0.25],
                           device=dev)

    def round_edge(nw, cap):
        return (k2_pool[torch.randint(0, len(k2_pool), (nw, cap), generator=g, device=dev)],
                torch.randint(-1, 2, (nw, cap), generator=g, device=dev, dtype=torch.int32),
                torch.randint(-1, 3, (nw, cap), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, 2, (nw, cap), generator=g, device=dev, dtype=torch.int32),
                k2_pool[torch.randint(4, len(k2_pool), (nw,), generator=g, device=dev)],
                torch.rand((nw,), generator=g, device=dev) < 0.7,
                torch.rand((nw,), generator=g, device=dev), torch.rand((nw,), generator=g, device=dev))

    def off_boundary(t):
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    k2_cases = 0
    for nw, cap in [(10, 64), (37, 64), (4099, 64), (33, 1), (9, 3), (6, 5), (5, 100), (3, 3500), (1, 2)]:
        args = round_edge(nw, cap)
        for shifted in (False, True):
            if shifted:
                args = tuple(off_boundary(a) for a in args[:4]) + args[4:]
            for r in (0, 1):
                if not round_equal(args, r):
                    raise AssertionError(f"K2 edge case W={nw} C={cap} r={r} off_boundary={shifted}: differs "
                                         "from round_step_ref or from its second launch")
                k2_cases += 1
    for row in ([0.0, -0.0], [-0.0, 0.0], [0.0, -0.0, 0.0, -0.0, -0.0]):
        c = len(row)
        args = (torch.tensor([row], device=dev), torch.zeros((1, c), dtype=torch.int32, device=dev),
                torch.arange(c, 0, -1, dtype=torch.int32, device=dev)[None],
                torch.arange(c, dtype=torch.int32, device=dev)[None], torch.zeros(1, device=dev),
                torch.ones(1, dtype=torch.bool, device=dev), torch.zeros(1, device=dev), torch.ones(1, device=dev))
        if not round_equal(args, 0) or int(bits(ops.round_deliver(*args, 0, eps=0.01)[1])[0]) != -(2**31):
            raise AssertionError(f"K2 signed-zero row {row}: best_cert is not -0.0 or differs from round_step_ref")
        k2_cases += 1
    # fault injection's inputs: identical due entries (duplicates) and dues
    # beyond r (reorder); the copies must be cleared together
    for nw, cap in [(10, 64), (37, 64), (9, 3), (3, 3500)]:
        qc, _, qs, ql = queue_leaves(nw, cap)
        late = torch.rand((nw, cap), generator=g, device=dev) < 0.5
        qd = torch.where(late, 2 + torch.randint(1, 3, (nw, cap), generator=g, device=dev), 2).to(torch.int32)
        half = cap // 2
        for t in (qc, qd, qs, ql):
            t[:, half : 2 * half] = t[:, :half]
        args = (qc, qd, qs, ql, -torch.rand((nw,), generator=g, device=dev),
                torch.rand((nw,), generator=g, device=dev) < 0.8, torch.rand((nw,), generator=g, device=dev),
                torch.rand((nw,), generator=g, device=dev))
        cleared = ops.round_deliver(*args, 2, eps=0.01)[0]
        if not (round_equal(args, 2) and round_equal(args, 3)
                and torch.equal(bits(cleared[:, :half]), bits(cleared[:, half : 2 * half]))):
            raise AssertionError(f"K2 duplicate entries / late dues W={nw} C={cap}: differs from round_step_ref "
                                 "or clears one copy only")
        k2_cases += 2
    log(f"phase kernels K2 round_step edge_cases={k2_cases} bitwise_equal=True repeat=True")

    # K3 queue_ingest: the engine (W=10), one rank of the sharded engine
    # (W=5 with a candidate from each of 2 ranks; W=1024 from 4), one rank
    # of the pod engine (W=5: tier 1 from the pod's 2 ranks, the flush
    # from all 4), the pod phase's single device (W=20) and W=4096
    for nw, cands in ((10, (1, 8)), (5, (2, 4)), (20, (1,)), (1024, (4,)), (4096, (1, 8))):
        cap = 64
        qc, qd, qs, ql = queue_leaves(nw, cap)
        for m in cands:
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

    # K3 edge cases: C+m > 64, C = 1, m > C, +-0.0 and +-inf certificates,
    # duplicate (cert, src, due) entries, due = -1 padding, all-+inf queues
    pool = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), -1.0, -0.5, -0.25], device=dev)

    def edge_leaves(nw, k):
        return (pool[torch.randint(0, len(pool), (nw, k), generator=g, device=dev)],
                torch.randint(-1, 2, (nw, k), generator=g, device=dev, dtype=torch.int32),
                torch.randint(-1, 3, (nw, k), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, 2, (nw, k), generator=g, device=dev, dtype=torch.int32))

    k3_cases = 0
    for nw, cap, m in [(10, 64, 1), (4096, 64, 8), (5, 100, 40), (9, 1, 3), (6, 4, 12), (3, 3500, 20)]:
        for all_inf in (False, True):
            iargs = edge_leaves(nw, cap) + edge_leaves(nw, m)
            if all_inf:
                iargs = (torch.full_like(iargs[0], float("inf")),) + iargs[1:]
            got = ops.queue_ingest(*iargs)
            plain = ref.queue_ingest_ref(*iargs)
            if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, plain)):
                raise AssertionError(f"K3 edge case W={nw} C={cap} m={m} all_inf={all_inf}: "
                                     "differs from queue_ingest_ref")
            k3_cases += 1
    # fault injection's duplicates: the candidate block as pairs of
    # identical columns (padding where no duplicate was drawn)
    for nw, cap, m in [(10, 64, 1), (10, 64, 10), (33, 16, 8), (5, 3, 9)]:
        for base_leaves in (queue_leaves, edge_leaves):
            qc, qd, qs, ql = base_leaves(nw, cap)
            cc, cd, cs, cl = edge_leaves(nw, m) if base_leaves is edge_leaves else (
                torch.where(torch.rand((nw, m), generator=g, device=dev) < 0.6,
                            -torch.rand((nw, m), generator=g, device=dev) - 0.01, float("inf")),
                torch.randint(0, 6, (nw, m), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, nw, (nw, m), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, 3, (nw, m), generator=g, device=dev, dtype=torch.int32))
            dup = torch.rand((nw, m), generator=g, device=dev) < 0.7
            iargs = (qc, qd, qs, ql, torch.cat([cc, torch.where(dup, cc, float("inf"))], 1),
                     torch.cat([cd, torch.where(dup, cd, -1)], 1), torch.cat([cs, cs], 1), torch.cat([cl, cl], 1))
            got = ops.queue_ingest(*iargs)
            plain = ref.queue_ingest_ref(*iargs)
            if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, plain)):
                raise AssertionError(f"K3 duplicate-pair block W={nw} C={cap} m={2 * m}: differs from queue_ingest_ref")
            k3_cases += 1
    log(f"phase kernels K3 queue_ingest edge_cases={k3_cases} equal=True")

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
    records["adamw_step"] = k5_check(time_ms, device_ms)
    records["attention"] = k6_check(time_ms)
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
    records["edge_scan"]["launches_main"] = launches["edge_scan"]

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

    # ----------------------------------------------------------------- chaos
    # the engine's chaos, membership, auto-capacity and publish features at
    # the main configuration, each run against main's result
    from repro_torch.core.engine import FaultPlan, MembershipPlan
    from repro_torch.launch.serving import AdoptionSlot

    class RecordingSlot(AdoptionSlot):
        """The port's adoption slot, keeping (round, cert) of every publish."""

        def __init__(self):
            super().__init__()
            self.log = []

        def publish(self, params, cert, round=0):
            self.log.append((round, cert))
            return super().publish(params, cert, round)

    chaos_launches = dict.fromkeys(ENGINE_KERNELS, 0)

    def chaos_run(tag, slot=None, **kw):
        ecfg = dataclasses.replace(engine_config(cfg.n_workers, ROUNDS, True), **kw)
        eng = TMSNEngine(worker, ecfg, device="cuda")
        if slot is not None:
            eng.attach_publisher(slot)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        run_wall = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        for k in ENGINE_KERNELS:
            chaos_launches[k] += got[k]
        log(f"phase chaos {tag} rounds={out.rounds} wall_s={run_wall:.3f} "
            f"ms_per_round={run_wall / max(out.rounds, 1) * 1e3:.4f} sent={out.messages_sent} "
            f"accepted={out.messages_accepted} discarded={out.messages_discarded} evicted={out.messages_evicted} "
            f"dropped={out.messages_dropped_injected} rejected={out.messages_corrupt_rejected} "
            f"occupancy_peak={out.inflight_occupancy_peak} capacity_selected={out.inflight_capacity_selected} "
            f"joined={out.workers_joined} publishes={0 if slot is None else slot.publishes} "
            f"best_cert={min(out.final_certificates):.6f} launches={json.dumps(got)}")
        return out, run_wall, got

    def same_as_main(tag, out):
        if out.final_certificates != res.final_certificates or out.history != res.history:
            raise AssertionError(f"chaos {tag}: certificates or history differ from main")

    def monotone_finite(tag, out, negative=False):
        certs_ = np.asarray(out.final_certificates)
        if out.rounds != ROUNDS or not np.all(np.isfinite(certs_)) or (negative and not np.all(certs_ < 0)):
            raise AssertionError(f"chaos {tag}: rounds={out.rounds}, certificates {certs_}")
        for wid in range(cfg.n_workers):
            trace = [h[2] for h in out.history if h[1] == wid]
            if not all(np.isfinite(trace)) or any(b > a for a, b in zip(trace, trace[1:])):
                raise AssertionError(f"chaos {tag}: certificate of worker {wid} rose or is not finite")

    def kernels_launched(tag, got, rounds_run):
        for k in ("round_step", "queue_ingest"):
            if got[k] < rounds_run:
                raise AssertionError(f"chaos {tag}: {k} launched {got[k]} times in {rounds_run} rounds")

    t_chaos = time.perf_counter()
    clean, clean_wall, got = chaos_run("clean")
    same_as_main("clean", clean)
    kernels_launched("clean", got, ROUNDS)

    joined, _, got = chaos_run("join_k1", spare_slots=1, membership=MembershipPlan(joins=((1, cfg.n_workers - 1),)))
    same_as_main("join_k1", joined)
    kernels_launched("join_k1", got, ROUNDS)
    if joined.workers_joined != 0:
        raise AssertionError(f"chaos join_k1: workers_joined={joined.workers_joined}, want 0")

    dup, dup_wall, got = chaos_run("dup", fault_plan=FaultPlan(duplicate_prob=0.5, seed=5))
    same_as_main("dup", dup)
    kernels_launched("dup", got, ROUNDS)
    if dup.messages_evicted != 0:
        raise AssertionError(f"chaos dup: {dup.messages_evicted} messages evicted")

    auto, _, got = chaos_run("auto", inflight_capacity="auto")
    same_as_main("auto", auto)
    kernels_launched("auto", got, ROUNDS)
    if auto.inflight_capacity_selected < 1 or auto.messages_evicted != 0:
        raise AssertionError(f"chaos auto: capacity {auto.inflight_capacity_selected}, "
                             f"{auto.messages_evicted} evicted")

    corrupt_runs = []
    for tag in ("corrupt", "corrupt_again"):
        out, run_wall, got = chaos_run(tag, fault_plan=FaultPlan(corrupt_prob=0.5, seed=3))
        kernels_launched(tag, got, ROUNDS)
        monotone_finite(tag, out, negative=True)
        corrupt_runs.append((out, run_wall))
    (cor, cor_wall), (cor2, _) = corrupt_runs
    if cor.messages_corrupt_rejected <= 0:
        raise AssertionError("chaos corrupt: no certificate was rejected")
    if (cor.final_certificates, cor.history, cor.messages_corrupt_rejected, cor.messages_accepted) != (
            cor2.final_certificates, cor2.history, cor2.messages_corrupt_rejected, cor2.messages_accepted):
        raise AssertionError("chaos corrupt: a second run differs")

    churn_kw = dict(
        spare_slots=2,
        membership=MembershipPlan(joins=((50, cfg.n_workers - 2), (120, cfg.n_workers - 1)), leaves=((100, 3),)),
        fault_plan=FaultPlan(drop_prob=0.05, reorder_max=2, seed=9),
    )
    churn, churn_wall, got = chaos_run("churn", **churn_kw)
    kernels_launched("churn", got, ROUNDS)
    monotone_finite("churn", churn)
    if churn.workers_joined != 2 or churn.messages_dropped_injected <= 0:
        raise AssertionError(f"chaos churn: joined={churn.workers_joined}, dropped={churn.messages_dropped_injected}")
    churn_plain, _, got = chaos_run("churn_plain", round_step_impl="ref", **churn_kw)
    if got["round_step"] or got["queue_ingest"]:
        raise AssertionError(f"chaos churn_plain: K2/K3 launched under round_step_impl='ref': {got}")
    for f in ("final_certificates", "history", "rounds", "messages_sent", "messages_accepted", "messages_discarded",
              "messages_evicted", "messages_dropped_injected", "inflight_occupancy_peak", "workers_joined"):
        if getattr(churn, f) != getattr(churn_plain, f):
            raise AssertionError(f"chaos churn: {f} differs between K2/K3 and their plain versions")

    slot = RecordingSlot()
    pub, _, got = chaos_run("publish", slot=slot, publish_every_k=20, rounds_per_dispatch=8)
    same_as_main("publish", pub)
    kernels_launched("publish", got, ROUNDS)
    pub_rounds = [e[0] for e in slot.log]
    pub_certs = [e[1] for e in slot.log]
    snap = slot.acquire()
    if not slot.log or any(r_ % 8 and r_ != pub.rounds for r_ in pub_rounds):
        raise AssertionError(f"chaos publish: published rounds {pub_rounds}")
    if any(b >= a for a, b in zip(pub_certs, pub_certs[1:])) or snap.cert != min(pub.final_certificates):
        raise AssertionError(f"chaos publish: certificates {pub_certs}, final best {min(pub.final_certificates)}")
    snap_model = StumpModel(*(torch.as_tensor(a, device=dev) for a in snap.params))
    snap_err = float(error_rate(snap_model, xte, yte))
    if snap_err != err:
        raise AssertionError(f"chaos publish: the snapshot's test error {snap_err} is not main's {err}")
    # a faulted round's cost over a clean one: clean and faulted runs in
    # turns (host time varies by 15 % between identical runs), medians of
    # ms per round
    pair_rounds = 60
    pair_plans = {"clean": None, "dup": FaultPlan(duplicate_prob=0.5, seed=5),
                  "corrupt": FaultPlan(corrupt_prob=0.5, seed=3)}
    per_round = {k: [] for k in pair_plans}
    for _ in range(3):
        for k, plan in pair_plans.items():
            _, run_wall, _ = chaos_run(f"turns_{k}", max_rounds=pair_rounds, fault_plan=plan)
            per_round[k].append(run_wall / pair_rounds * 1e3)
    med = {k: statistics.median(v) for k, v in per_round.items()}
    spread = {k: round(max(v) - min(v), 4) for k, v in per_round.items()}
    chaos_s = time.perf_counter() - t_chaos
    overhead = {k: round(v / clean_wall, 4) for k, v in (("dup", dup_wall), ("corrupt", cor_wall),
                                                         ("churn", churn_wall))}
    log(f"phase chaos overhead rounds={pair_rounds} turns=3 median_ms_per_round="
        f"{json.dumps({k: round(v, 4) for k, v in med.items()})} spread_ms={json.dumps(spread)} "
        f"median_over_clean={json.dumps({k: round(med[k] / med['clean'], 4) for k in ('dup', 'corrupt')})}")
    log(f"phase chaos ok seconds={chaos_s:.3f} publishes={slot.publishes} published_rounds={pub_rounds} "
        f"snapshot_test_error={snap_err:.4f} wall_over_clean={json.dumps(overhead)} "
        f"launches={json.dumps(chaos_launches)}")
    for k in ENGINE_KERNELS:
        records[k]["launches_main"] = records[k]["launches"]
        records[k]["launches_chaos"] = chaos_launches[k]
        records[k]["launches"] += chaos_launches[k]

    # ------------------------------------------------------- chaos_small_ref
    small_plan = dict(
        n_workers=4, max_rounds=40, target_certificate=None, seed=SEED, delay_rounds=1, inflight_capacity=16,
        control_plane="sparse", gossip_top_k=4, round_step_impl="pallas", fault_spec="", rounds_per_dispatch=8,
        gossip_mode="dense", spare_slots=1, membership=MembershipPlan(joins=((10, 3),)), publish_every_k=5,
        fault_plan=FaultPlan(drop_prob=0.1, duplicate_prob=0.3, corrupt_prob=0.2, reorder_max=1, seed=4),
    )
    small = {}
    for name in ("cpu", "cuda"):
        wk = BatchedSparrowWorker(sxb, sy, scfg, device=name, uniforms=np_uniforms)
        rec = RecordingSlot()
        eng = TMSNEngine(wk, EngineConfig(**small_plan), device=name)
        eng.attach_publisher(rec)
        ops.reset_launches()
        small[name] = (eng.run(), rec.log, dict(ops.LAUNCHES))
    (a, alog, _), (b, blog, blaunch) = small["cpu"], small["cuda"]
    same_keys = [h[:2] for h in a.history] == [h[:2] for h in b.history]
    cert_err = max(abs(x[2] - y[2]) for x, y in zip(a.history, b.history))
    counters = ("messages_dropped_injected", "messages_corrupt_rejected", "workers_joined", "messages_evicted",
                "messages_sent", "inflight_occupancy_peak")
    if not (same_keys and np.allclose(a.final_certificates, b.final_certificates, rtol=1e-5, atol=1e-6)
            and all(getattr(a, f) == getattr(b, f) for f in counters)
            and [e[0] for e in alog] == [e[0] for e in blog] and blog):
        raise AssertionError(f"chaos_small_ref: card run differs from the CPU run (same history keys={same_keys}, "
                             f"max cert err={cert_err:.3g}, counters cpu={[getattr(a, f) for f in counters]} "
                             f"card={[getattr(b, f) for f in counters]}, published {alog} vs {blog})")
    if blaunch["round_step"] < b.rounds or blaunch["queue_ingest"] < b.rounds:
        raise AssertionError(f"chaos_small_ref: K2/K3 launches {blaunch} in {b.rounds} rounds")
    log(f"phase chaos_small_ref ok rounds={b.rounds} history={len(b.history)} max_cert_err={cert_err:.3g} "
        f"dropped={b.messages_dropped_injected} rejected={b.messages_corrupt_rejected} joined={b.workers_joined} "
        f"publishes={len(blog)} published_rounds={[e[0] for e in blog]}")

    # --------------------------------------------------------------- sharded
    # the sharded engine (core/engine_sharded.py): the main configuration on
    # two gloo ranks sharing the card (collectives staged through host
    # memory), once with dense and once with gated gossip; on a one-rank
    # NCCL world; and a toy at W=4096 on four ranks (K2, K3 at 1024 rows)
    import tempfile

    from repro_torch.launch.mesh import spawn_world

    def world_dir(tag):
        (ROOT / "build").mkdir(exist_ok=True)
        return tempfile.mkdtemp(prefix=f"world_{tag}_", dir=ROOT / "build")

    def held(tag, got, want, fields):
        for f in fields:
            if got[f] != getattr(want, f):
                raise AssertionError(f"sharded {tag}: {f} differs from the single-device run")

    adopt_fields = ("final_certificates", "history", "rounds", "messages_accepted", "messages_evicted")
    rank_fields = adopt_fields + ("messages_sent", "messages_discarded", "inflight_occupancy_peak",
                                  "gossip_bytes", "control_bytes", "gossip_mode")
    sharded_launches = dict.fromkeys(ENGINE_KERNELS, 0)

    def rank_line(tag, out, kernels, formula):
        for k in kernels:
            if out["launches"][k] < out["rounds"]:
                raise AssertionError(f"sharded {tag} rank {out['rank']}: {k} launched {out['launches'][k]} "
                                     f"times in {out['rounds']} rounds")
        for k in ENGINE_KERNELS:
            sharded_launches[k] += out["launches"][k]
        if (out["gossip_bytes"], out["control_bytes"]) != formula:
            raise AssertionError(f"sharded {tag}: bytes per round {out['gossip_bytes']}, "
                                 f"{out['control_bytes']}; the reference's formula gives {formula}")
        log(f"phase sharded {tag} rank={out['rank']} engine={out['engine']} backend={out['backend']} "
            f"host_staged={out['host_staged']} rounds={out['rounds']} wall_s={out['wall_s']:.3f} "
            f"wall_ms_per_round={out['wall_s'] / out['rounds'] * 1e3:.4f} "
            f"collective_ms_per_round={out['collective_s'] / out['rounds'] * 1e3:.4f} "
            f"collectives={out['collectives']} sent={out['messages_sent']} "
            f"accepted={out['messages_accepted']} "
            f"discarded={out['messages_discarded']} evicted={out['messages_evicted']} "
            f"occupancy_peak={out['inflight_occupancy_peak']} gossip_bytes_per_round={out['gossip_bytes']} "
            f"control_bytes_per_round={out['control_bytes']} formula={list(formula)} "
            f"launches={json.dumps(out['launches'])}")

    t_sh = time.perf_counter()
    n_dev, k_top = 2, 1
    ranks = spawn_world(sharded_sparrow_rank, ["cuda:0"] * n_dev, world_dir("main"),
                        args=(ROUNDS, ("dense", "gated"), False))
    for mode in ("dense", "gated"):
        p = ranks[0][mode]["payload_bytes"]
        ctrl = n_dev * k_top * 12
        formula = (ctrl + (cfg.n_workers * p if mode == "dense" else n_dev * k_top * p), ctrl)
        for rr in ranks:
            out = rr[mode]
            if (out["engine"], out["backend"], out["host_staged"], out["gossip_mode"]) != (
                    "ShardedTMSNEngine", "gloo", True, mode):
                raise AssertionError(f"sharded sharded_main: {out['engine']} on {out['backend']}, "
                                     f"mode {out['gossip_mode']}")
            held(f"sharded_main {mode}", out, res, adopt_fields)
            if any(out[f] != ranks[0][mode][f] for f in rank_fields):
                raise AssertionError(f"sharded sharded_main {mode}: rank {out['rank']} differs from rank 0")
            rank_line(f"sharded_main mode={mode}", out, ENGINE_KERNELS, formula)
        log(f"phase sharded sharded_main mode={mode} == main: certificates, history, accepted, evicted; "
            f"sent {ranks[0][mode]['messages_sent']} (main {res.messages_sent}), discarded "
            f"{ranks[0][mode]['messages_discarded']} (main {res.messages_discarded}): {n_dev} ranks offer "
            f"{n_dev * k_top} candidates a round where one device offers {k_top}")

    nccl = spawn_world(sharded_sparrow_rank, ["cuda:0"], world_dir("nccl1"), args=(ROUNDS, ("dense",), True))
    out = nccl[0]["dense"]
    if (out["engine"], out["backend"], out["host_staged"]) != ("ShardedTMSNEngine", "nccl", False):
        raise AssertionError(f"sharded sharded_nccl1: {out['engine']} on {out['backend']}")
    held("sharded_nccl1", out, res, adopt_fields + ("messages_sent", "messages_discarded",
                                                    "inflight_occupancy_peak"))
    p = out["payload_bytes"]
    rank_line("sharded_nccl1", out, ENGINE_KERNELS, (k_top * 12 + cfg.n_workers * p, k_top * 12))

    wt, rounds_t, n_t = 4096, 100, 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = TMSNEngine(ShardToy(wt, dev), engine_config(wt, rounds_t, True), device="cuda").run()
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    toy = spawn_world(sharded_toy_rank, ["cuda:0"] * n_t, world_dir("w4096"), args=(wt, rounds_t))
    for out in toy:
        held("sharded_w4096", out, single, adopt_fields)
        if any(out[f] != toy[0][f] for f in rank_fields):
            raise AssertionError(f"sharded sharded_w4096: rank {out['rank']} differs from rank 0")
        rank_line("sharded_w4096", out, ("round_step", "queue_ingest"), (n_t * 12 + wt * 8, n_t * 12))
    log(f"phase sharded sharded_w4096 == single device: certificates, history, accepted, evicted "
        f"(best {min(single.final_certificates):.6f}, {len(single.history)} history entries); single-device "
        f"wall_ms_per_round={single_wall / rounds_t * 1e3:.4f} sent {toy[0]['messages_sent']} "
        f"(single {single.messages_sent}) discarded {toy[0]['messages_discarded']} "
        f"(single {single.messages_discarded})")
    log(f"phase sharded ok seconds={time.perf_counter() - t_sh:.3f} launches={json.dumps(sharded_launches)}")
    for k in ENGINE_KERNELS:
        records[k]["launches_sharded"] = sharded_launches[k]
        records[k]["launches"] += sharded_launches[k]

    # ------------------------------------------------------------------- pod
    # the two-tier (pod, workers) mesh: 4 gloo ranks sharing the card in 2
    # pods of 2, every run in one world, against one device at W = POD_W
    from repro_torch.launch.mesh import dcn_round_seconds, ici_round_seconds

    t_pod = time.perf_counter()
    pod_single_worker = pod_worker("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pod_single = TMSNEngine(pod_single_worker, engine_config(POD_W, ROUNDS, True), device="cuda").run()
    torch.cuda.synchronize()
    pod_single_wall = time.perf_counter() - t0
    del pod_single_worker
    log(f"phase pod single_device W={POD_W} rounds={pod_single.rounds} wall_ms_per_round="
        f"{pod_single_wall / pod_single.rounds * 1e3:.4f} best_cert={min(pod_single.final_certificates):.6f} "
        f"history={len(pod_single.history)} sent={pod_single.messages_sent} "
        f"accepted={pod_single.messages_accepted} evicted={pod_single.messages_evicted}")
    pod_ranks = spawn_world(pod_rank, ["cuda:0"] * POD_RANKS, world_dir("pod"), pods=PODS)
    pod_launches = dict.fromkeys(ENGINE_KERNELS, 0)
    wpp, w_pod = POD_RANKS // PODS, POD_W // PODS
    pod_fields = rank_fields + ("messages_sent_dcn", "messages_dropped_injected", "ici_bytes", "dcn_bytes")

    def pod_formula(out, every_k):
        """(ICI, DCN, control) bytes per round by the reference's formulas
        under sparse control, k = 1 candidate a rank on each tier."""
        p = out["payload_bytes"]
        ici = wpp * 12 + (w_pod * p if out["gossip_mode"] == "dense" else wpp * p)
        dcn = (POD_RANKS * p) // every_k + (POD_RANKS * 12) // every_k
        return ici, dcn, wpp * 12 + (POD_RANKS * 12) // every_k

    def monotone(tag, out):
        certs = np.asarray(out["final_certificates"])
        if out["rounds"] != ROUNDS or not np.all(np.isfinite(certs)):
            raise AssertionError(f"pod {tag}: rounds={out['rounds']}, certificates {certs}")
        for wid in range(POD_W):
            trace = [h[2] for h in out["history"] if h[1] == wid]
            if any(b > a for a, b in zip(trace, trace[1:])) or not np.all(np.isfinite(trace)):
                raise AssertionError(f"pod {tag}: certificate of worker {wid} rose or is not finite")

    for tag, kw in pod_runs().items():
        every_k = kw.get("cross_pod_every_k", 1)
        first = pod_ranks[0][tag]
        for rr in pod_ranks:
            out = rr[tag]
            if (out["engine"], out["backend"], out["host_staged"], out["gossip_mode"]) != (
                    "ShardedTMSNEngine", "gloo", True, kw["gossip_mode"]):
                raise AssertionError(f"pod {tag}: {out['engine']} on {out['backend']}, mode {out['gossip_mode']}")
            if any(out[f] != first[f] for f in pod_fields):
                raise AssertionError(f"pod {tag}: rank {out['rank']} differs from rank 0")
            for k in ENGINE_KERNELS:
                if out["launches"][k] < out["rounds"]:
                    raise AssertionError(f"pod {tag} rank {out['rank']}: {k} launched {out['launches'][k]} "
                                         f"times in {out['rounds']} rounds")
                pod_launches[k] += out["launches"][k]
            formula = pod_formula(out, every_k)
            if (out["ici_bytes"], out["dcn_bytes"], out["control_bytes"]) != formula:
                raise AssertionError(f"pod {tag}: ICI/DCN/control bytes per round {out['ici_bytes']}, "
                                     f"{out['dcn_bytes']}, {out['control_bytes']}; the reference's formulas "
                                     f"give {formula}")
            n = out["rounds"]
            log(f"phase pod {tag} rank={out['rank']} pod={out['rank'] // wpp} rounds={n} wall_s={out['wall_s']:.3f} "
                f"wall_ms_per_round={out['wall_s'] / n * 1e3:.4f} "
                f"collective_ms_per_round={out['collective_s'] / n * 1e3:.4f} "
                f"collective_ms_per_round_tier1={out['tier_collective_s'][0] / n * 1e3:.4f} "
                f"collective_ms_per_round_tier2={out['tier_collective_s'][1] / n * 1e3:.4f} "
                f"collectives_per_round_tier1={out['tier_collectives'][0] / n:.3f} "
                f"collectives_per_round_tier2={out['tier_collectives'][1] / n:.3f} "
                f"sent={out['messages_sent']} sent_dcn={out['messages_sent_dcn']} "
                f"accepted={out['messages_accepted']} discarded={out['messages_discarded']} "
                f"evicted={out['messages_evicted']} dropped={out['messages_dropped_injected']} "
                f"ici_bytes_per_round={out['ici_bytes']} dcn_bytes_per_round={out['dcn_bytes']} "
                f"control_bytes_per_round={out['control_bytes']} formula={list(formula)} "
                f"derived_ici_round_s={ici_round_seconds(out['ici_bytes']):.4g} "
                f"derived_dcn_round_s={dcn_round_seconds(out['dcn_bytes']):.4g} "
                f"launches={json.dumps(out['launches'])}")
        if tag.startswith("pod_main"):
            for f in adopt_fields:
                if first[f] != getattr(pod_single, f):
                    raise AssertionError(f"pod {tag}: {f} differs from the single-device W={POD_W} run")
            if not 0 < first["messages_sent_dcn"] < first["messages_sent"]:
                raise AssertionError(f"pod {tag}: sent_dcn {first['messages_sent_dcn']} of {first['messages_sent']}")
            log(f"phase pod {tag} == single device W={POD_W}: certificates, history ({len(first['history'])} "
                f"entries), accepted ({first['messages_accepted']}), evicted ({first['messages_evicted']}); sent "
                f"{first['messages_sent']} (single {pod_single.messages_sent}), sent_dcn {first['messages_sent_dcn']}")
        else:
            monotone(tag, first)
    k1, k8, part = (pod_ranks[0][t] for t in ("pod_main dense", "pod_k8", "pod_partition"))
    if k8["dcn_bytes"] * 8 != k1["dcn_bytes"] or k8["ici_bytes"] != k1["ici_bytes"]:
        raise AssertionError(f"pod pod_k8: DCN bytes {k8['dcn_bytes']} (k=1: {k1['dcn_bytes']}), "
                             f"ICI bytes {k8['ici_bytes']} (k=1: {k1['ici_bytes']})")
    log(f"phase pod pod_k8 divergence from pod_main: history {len(k8['history'])} vs {len(k1['history'])}, "
        f"best_cert {min(k8['final_certificates']):.6f} vs {min(k1['final_certificates']):.6f}, "
        f"sent_dcn {k8['messages_sent_dcn']} vs {k1['messages_sent_dcn']}, accepted {k8['messages_accepted']} vs "
        f"{k1['messages_accepted']}; dcn_bytes_per_round {k8['dcn_bytes']} = {k1['dcn_bytes']} / 8")
    if not part["messages_dropped_injected"] > 0:
        raise AssertionError("pod pod_partition: no message dropped in the partition window")
    log(f"phase pod pod_partition dropped={part['messages_dropped_injected']} history={len(part['history'])} "
        f"best_cert={min(part['final_certificates']):.6f} (pod_main {min(k1['final_certificates']):.6f})")
    log(f"phase pod ok seconds={time.perf_counter() - t_pod:.3f} launches={json.dumps(pod_launches)}")
    for k in ENGINE_KERNELS:
        records[k]["launches_pod"] = pod_launches[k]
        records[k]["launches"] += pod_launches[k]

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

    # exact greedy and GOSS histogram through K1 (W=1): each runs twice and
    # must give the same model and test losses bit for bit
    bcfg = BoosterConfig(num_rounds=25, num_bins=nb, eval_every=24)
    torch.cuda.synchronize()
    ops.reset_launches()
    for name, fn in (("exact_greedy", train_exact_greedy), ("goss", train_goss)):
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            tr = fn(xtr, ytr, bcfg, eval_fn=lambda m: float(exp_loss(m, xte, yte)))
            torch.cuda.synchronize()
            runs.append((tr, time.perf_counter() - t0))
        (tr, bwall), (tr2, bwall2) = runs
        same = tr.metric == tr2.metric and all(torch.equal(a, b) for a, b in zip(tr.model, tr2.model))
        berr = float(error_rate(tr.model, xte, yte))
        log(f"phase baselines {name} rounds={bcfg.num_rounds} wall_s={bwall:.3f} wall_s_again={bwall2:.3f} "
            f"cost_units={tr.cost[-1]:.6g} test_exp_loss={tr.metric[-1]!r} test_error={berr:.4f} "
            f"bitwise_repeat={same}")
        if not same:
            raise AssertionError(f"baselines: {name} differs between two runs: losses {tr.metric} vs {tr2.metric}")
        if not (tr.metric[-1] < 1.0 and berr < minority):
            raise AssertionError(f"baselines: {name} test loss {tr.metric[-1]}, error {berr}")
    torch.cuda.synchronize()
    base_launches = dict(ops.LAUNCHES)
    log(f"phase baselines launches={json.dumps(base_launches)}")
    if base_launches["edge_scan"] < 4 * bcfg.num_rounds:
        raise AssertionError(f"baselines: {base_launches['edge_scan']} K1 launches in 4 x {bcfg.num_rounds} rounds")
    records["edge_scan"]["launches_baselines"] = base_launches["edge_scan"]
    records["edge_scan"]["launches"] += sim_launches["edge_scan"] + base_launches["edge_scan"]
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

    def note_launches(name: str, launches: dict) -> None:
        """K1-K6 launches of the phase (or phases) just run, as plain ints:
        ``launches_<name>`` in each record, K6's forward and backward as
        ``launches_<name>_fwd`` and ``launches_<name>_bwd``."""
        for k, rec in records.items():
            if k == "attention":
                rec[f"launches_{name}_fwd"] = launches["attention_fwd"]
                rec[f"launches_{name}_bwd"] = launches["attention_bwd"]
            else:
                rec[f"launches_{name}"] = launches[k]
        log(f"phase {name} launches={json.dumps(launches)}")

    # ---------------------------------------------------------- lm_small_ref
    ops.reset_launches()
    lm_small_ref_phase()
    note_launches("lm_small_ref", dict(ops.LAUNCHES))

    # ---------------------------------------------------------------- lm_sgd
    lm_run = lm_sgd_phase()
    records["adamw_step"]["launches"] = lm_run["adamw_step"]
    records["attention"].update(launches_fwd=lm_run["attention_fwd"], launches_bwd=lm_run["attention_bwd"])

    # ------------------------------------------------------- serve_small_ref
    ops.reset_launches()
    serve_small_ref_phase()
    # ----------------------------------------------------------------- serve
    serve_phase()
    # ------------------------------------------------------------ serve_live
    serve_live_phase()
    note_launches("serve", dict(ops.LAUNCHES))

    # ------------------------------------------------------ the families
    # serve_deepseek's launches apart: its MLA at full width is the one
    # path of the smoke on K6's 192/128 instance, the other phases' K6
    # calls are 128/128's
    ops.reset_launches()
    families_small_ref_phase()
    serve_mamba2_phase()
    families = dict(ops.LAUNCHES)
    ops.reset_launches()
    serve_deepseek_phase()
    note_launches("serve_deepseek", dict(ops.LAUNCHES))
    ops.reset_launches()
    families_full_phase()
    note_launches("families", {k: n + families[k] for k, n in ops.LAUNCHES.items()})

    # ------------------------------------------------ the enc-dec and VLM families
    ops.reset_launches()
    encdec_small_ref_phase()
    serve_whisper_phase()
    serve_phi3v_phase()
    note_launches("encdec", dict(ops.LAUNCHES))

    # ------------------------------------------------------- the launch tooling
    ops.reset_launches()
    trained = train_phase()
    note_launches("train", dict(ops.LAUNCHES))
    ops.reset_launches()
    ckpt_phase(trained)
    del trained
    note_launches("ckpt", dict(ops.LAUNCHES))
    ops.reset_launches()
    ranks = sharded_sgd_phase()
    note_launches("sharded_sgd", {k: n + ranks.get(k, 0) for k, n in ops.LAUNCHES.items()})
    ops.reset_launches()
    dryrun_phase()
    note_launches("dryrun", dict(ops.LAUNCHES))

    log(json.dumps({"kernels": [records[k] for k in (*ENGINE_KERNELS, "weight_update", "adamw_step", "attention")]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
