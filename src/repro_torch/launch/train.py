"""The training entry point; counterpart of ``src/repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --steps 50 \
      --reduced --batch 8 --seq 128 [--tmsn --workers 4] [--ckpt PATH] [--device cpu]

``--tmsn`` trains with the TMSN-SGD strategy (the paper's protocol as the
distribution strategy: the legacy barrier round of
``core/tmsn_sgd.py``) instead of synchronous steps. The card is the
default device; ``--device cpu`` runs the plain PyTorch path.

Both loops take an optional iterable of batches (by default the port's
``TokenPipeline`` of ``--seed``) and optional initial params (by default
drawn from ``--seed``): randomness is an input, so a test can feed the
reference's draws.
"""

from __future__ import annotations

import argparse
import time
from collections.abc import Iterable
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core.tmsn_sgd import TMSNSGDConfig, init_tmsn_state, make_tmsn_round
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, init_opt_state


def _pipeline(cfg: ArchConfig, args) -> TokenPipeline:
    return TokenPipeline(
        batch=args.batch, seq=args.seq, vocab=cfg.vocab, seed=args.seed, device=args.device,
        frontend_len=cfg.frontend_len if cfg.frontend else 0,
        frontend_dim=cfg.frontend_dim if cfg.frontend else 0,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_sync(cfg: ArchConfig, args, batches: Iterable | None = None, params: Any = None) -> dict:
    """``args.steps`` AdamW steps (``launch/steps.py::make_train_step``);
    returns the losses, the final params and each step's wall seconds
    (the loss read back to the host ends each step)."""
    dev = resolve_device(args.device)
    if params is None:
        params = init_params(cfg, args.seed, dev)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    losses, step_s = [], []
    _sync(dev)
    t0 = time.time()
    for step, batch in zip(range(args.steps), _pipeline(cfg, args) if batches is None else batches):
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        if step % max(args.steps // 10, 1) == 0:
            print(f"step {step:5d} loss {loss:.4f} ({time.time()-t0:.1f}s)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, params)
        print(f"saved checkpoint -> {args.ckpt}")
    return {"losses": losses, "params": params, "step_seconds": step_s}


def train_tmsn(cfg: ArchConfig, args, batches: Iterable | None = None, params: Any = None) -> dict:
    """``max(args.steps // K, 1)`` legacy TMSN-SGD rounds of
    ``args.workers`` workers; round ``r`` takes the next W * K batches,
    batch ``i`` to worker ``i // K`` as its step ``i % K``. Returns the
    rounds' mean losses, the final and per-round certificates, the final
    stacked params and each round's wall seconds."""
    dev = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=args.lr)
    tcfg = TMSNSGDConfig(num_workers=args.workers, local_steps=args.local_steps, eps=args.eps)
    params_w, opt_w, cert_w = init_tmsn_state(cfg, opt_cfg, tcfg, args.seed, dev, params=params)
    round_fn = make_tmsn_round(cfg, opt_cfg, tcfg)
    it = iter(_pipeline(cfg, args) if batches is None else batches)
    n_w, k = tcfg.num_workers, tcfg.local_steps
    losses, history, round_s = [], [], []
    rounds = max(args.steps // k, 1)
    _sync(dev)
    t0 = time.time()
    for r in range(rounds):
        t_round = time.perf_counter()
        # W * K batches stacked to (W, K, b, s)
        bs = [next(it) for _ in range(n_w * k)]
        batch_w = {key: torch.stack([b[key] for b in bs]).reshape((n_w, k) + tuple(bs[0][key].shape))
                   for key in bs[0]}
        params_w, opt_w, cert_w, loss = round_fn(params_w, opt_w, cert_w, batch_w)
        certs = cert_w.cpu().numpy()
        round_s.append(time.perf_counter() - t_round)
        losses.append(float(loss))
        history.append(certs)
        print(f"round {r:4d} mean-loss {losses[-1]:.4f} certs [{certs.min():.4f},{certs.max():.4f}] "
              f"({time.time()-t0:.1f}s)", flush=True)
    return {"losses": losses, "certs": history[-1], "history": np.stack(history), "params_w": params_w,
            "round_seconds": round_s}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", help="smoke-size variant (CPU)")
    ap.add_argument("--ckpt", default=None, help="save the synchronous run's params to this npz")
    ap.add_argument("--tmsn", action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--eps", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"training {cfg.name} ({'reduced' if args.reduced else 'FULL'}) "
          f"{'TMSN-SGD' if args.tmsn else 'sync-DP'} on {args.device}")
    if args.tmsn:
        train_tmsn(cfg, args)
    else:
        train_sync(cfg, args)


if __name__ == "__main__":
    main()
