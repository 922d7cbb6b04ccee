"""Batched serving entry point on the continuous-batching loop of
:mod:`repro_torch.launch.serving`; counterpart of
``src/repro/launch/serve.py``.

One batched prefill, caches re-buffered into max_len decode buffers,
then per-slot decode, with the sampling policy wired (``greedy`` argmax
vs seeded temperature sampling) and timing that says what it measures:
every entry point runs once in an explicit warm-up reported as
``compile_s``, so ``prefill_s`` and ``decode_s`` are steady-state
numbers, and ``tok_per_s`` counts exactly the ``batch * (gen - 1)``
decode-step tokens it divides by (the prefill-produced first token is
reported separately).

With no adoption slot the loop serves the given params throughout and
is bit-identical to the legacy scalar-``pos`` serve loop (pinned in
tests/test_torch_serving.py). Pass ``slot=`` to serve a live, improving
ensemble. Runs on the card unless ``--device cpu`` is asked for:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --reduced \\
      --batch 2 --prompt-len 16 --gen 16

Every family serves (``--arch mamba2-1.3b``, ``deepseek-v3-671b``,
``gemma3-12b``, ``zamba2-1.2b``, ``grok-1-314b``, ``whisper-large-v3``,
``phi-3-vision-4.2b``). A model with a frontend gets one stub embedding
block per request, as the reference's ``serve`` draws them: float32
``N(0, 1) * 0.02`` of shape (frontend_len, frontend_dim).
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np
import torch

from repro_torch.configs import PORTED_ARCH_IDS, get_config, reduced
from repro_torch.data.tokens import stream_frontend, stream_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.serving import AdoptionSlot, ContinuousServer, Request, ServingConfig
from repro_torch.models import init_params


def serve(
    cfg,
    batch: int,
    prompt_len: int,
    gen: int,
    seed: int = 0,
    greedy: bool = True,
    temperature: float = 1.0,
    slot: AdoptionSlot | None = None,
    params: Any = None,
    prompts: Any = None,
    frontends: Any = None,
    device: str | torch.device = "cuda",
):
    """Generate ``gen`` tokens (the prefill token + ``gen - 1`` decode
    steps) for ``batch`` prompts. ``params`` default to
    ``init_params(cfg, seed)``, ``prompts`` ((batch, prompt_len) ints)
    to draw 1 of token stream ``seed`` and, for a model with a frontend,
    ``frontends`` ((batch, frontend_len, frontend_dim) floats) to draw 2
    of its frontend stream; a caller can hand in its own (the tests hand
    in the reference's draws). Returns generated tokens plus
    compile/prefill/decode timings, each measuring only what its name
    says."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed, dev)
    if prompts is None:
        prompts = stream_tokens(seed, 1, (batch, prompt_len), cfg.vocab, dev)
    prompts_h = np.asarray(prompts.cpu() if isinstance(prompts, torch.Tensor) else prompts, np.int32)
    fes = [None] * batch
    if cfg.frontend is not None:
        if frontends is None:
            frontends = stream_frontend(seed, 2, (batch, cfg.frontend_len, cfg.frontend_dim), dev)
        fes = list(np.asarray(frontends.cpu() if isinstance(frontends, torch.Tensor) else frontends,
                              np.float32))

    scfg = ServingConfig(
        slots=batch,
        prompt_len=prompt_len,
        max_new=gen,
        greedy=greedy,
        temperature=temperature,
        seed=seed,
    )
    server = ContinuousServer(cfg, scfg, params, device=dev)
    compile_s = server.warmup()
    requests = [Request(rid=i, prompt=prompts_h[i], max_new=gen, frontend=fes[i]) for i in range(batch)]
    results, metrics = server.run(requests, slot=slot)
    gen_tokens = np.stack([r.tokens for r in results])  # (batch, gen), rid order
    return {
        "generated": gen_tokens,
        "compile_s": compile_s,
        "prefill_s": metrics["prefill_s"],
        "decode_s": metrics["decode_s"],
        # decode-only throughput over decode-only time: the prefill
        # token is in `generated` but not in either factor
        "tok_per_s": metrics["decode_tok_per_s"],
        "adoptions": metrics["adoptions"],
        "metrics": metrics,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"a ported architecture, one of {', '.join(PORTED_ARCH_IDS)} (or its dashed alias, "
                    "e.g. mamba2-1.3b)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sample", action="store_true", help="temperature sampling")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    out = serve(
        cfg,
        args.batch,
        args.prompt_len,
        args.gen,
        greedy=not args.sample,
        temperature=args.temperature,
        device=args.device,
    )
    print(
        f"compile {out['compile_s']:.2f}s prefill {out['prefill_s']:.2f}s "
        f"decode {out['decode_s']:.2f}s {out['tok_per_s']:.1f} tok/s"
    )
    print("sample tokens:", out["generated"][0][:16])


if __name__ == "__main__":
    main()
