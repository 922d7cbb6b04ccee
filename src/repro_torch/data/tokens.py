"""Synthetic token batches for the LM stack; counterpart of
``src/repro/data/tokens.py``.

Randomness is an input, as everywhere in the port: a batch is built from
given tokens (``synthetic_token_batch``), and the default token source
draws from a ``torch.Generator`` seeded by ``(stream, draw)``
(``stream_tokens``), so a test can inject the reference's ``jax.random``
draws instead.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch.device import resolve_device


def synthetic_token_batch(tokens: torch.Tensor) -> dict[str, torch.Tensor]:
    """One LM batch from ``tokens`` (..., seq): next-token labels (the
    tokens shifted left, wrapping) and an all-ones float32 mask."""
    tokens = tokens.to(torch.int32)
    labels = torch.cat([tokens[..., 1:], tokens[..., :1]], dim=-1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    return {"tokens": tokens, "labels": labels, "mask": mask}


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: every bit of ``x`` reaches the low 32 bits
    (the CPU generator keeps only those of its seed)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_tokens(stream: int, draw: int, shape: tuple, vocab: int, device) -> torch.Tensor:
    """Uniform int32 tokens in [0, vocab) for draw ``draw`` of stream
    ``stream``, from a generator on ``device`` seeded by the pair: every
    (stream, draw) is one fixed draw, whatever came before it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix64(((int(stream) & 0xFFFFFFFF) << 32) | (int(draw) & 0xFFFFFFFF)))
    return torch.randint(0, vocab, shape, generator=gen, device=device, dtype=torch.int64).to(torch.int32)


@dataclasses.dataclass
class TokenPipeline:
    """Infinite batch iterator with a fixed lineage: batch ``i`` is draw
    ``i`` of stream ``seed``. The interface (``__iter__`` of dict
    batches, ``element_spec``) is what a trainer depends on. Batches live
    on ``device``, the card unless the caller asks for the CPU. (The
    reference's modality-frontend embeddings come with the frontend
    models, ROADMAP.md queue 1, item 14b.)"""

    batch: int
    seq: int
    vocab: int
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self) -> None:
        self._device = resolve_device(self.device)

    def element_spec(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """name -> (shape, dtype) of one batch."""
        shape = (self.batch, self.seq)
        return {"tokens": (shape, torch.int32), "labels": (shape, torch.int32), "mask": (shape, torch.float32)}

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        draw = 0
        while True:
            yield synthetic_token_batch(stream_tokens(self.seed, draw, (self.batch, self.seq), self.vocab,
                                                      self._device))
            draw += 1
