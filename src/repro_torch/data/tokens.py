"""Synthetic token batches for the LM stack, with the stub modality
frontend's embeddings (audio frames, vision patches); counterpart of
``src/repro/data/tokens.py``.

Randomness is an input, as everywhere in the port: a batch is built from
given tokens (``synthetic_token_batch``), and the default token and
frontend sources draw from a ``torch.Generator`` seeded by
``(stream, draw)`` (``stream_tokens``, ``stream_frontend``), so a test can
inject the reference's ``jax.random`` draws instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

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


def _pair_seed(stream: int, draw: int) -> int:
    return _mix64(((int(stream) & 0xFFFFFFFF) << 32) | (int(draw) & 0xFFFFFFFF))


def stream_tokens(stream: int, draw: int, shape: tuple, vocab: int, device) -> torch.Tensor:
    """Uniform int32 tokens in [0, vocab) for draw ``draw`` of stream
    ``stream``, from a generator on ``device`` seeded by the pair: every
    (stream, draw) is one fixed draw, whatever came before it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_pair_seed(stream, draw))
    return torch.randint(0, vocab, shape, generator=gen, device=device, dtype=torch.int64).to(torch.int32)


def stream_frontend(stream: int, draw: int, shape: tuple, device) -> torch.Tensor:
    """Stub frontend embeddings for draw ``draw`` of stream ``stream``:
    float32 ``N(0, 1) * 0.02`` (the reference's scale), from a generator
    seeded by the pair apart from :func:`stream_tokens`' seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix64(_pair_seed(stream, draw)))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02


@dataclasses.dataclass
class TokenPipeline:
    """Infinite batch iterator with a fixed lineage: batch ``i`` is draw
    ``i`` of stream ``seed``. The interface (``__iter__`` of dict
    batches, ``element_spec``) is what a trainer depends on. Batches live
    on ``device``, the card unless the caller asks for the CPU.

    With ``frontend_len`` set, a batch also holds ``frontend_embeds``,
    (batch, frontend_len, frontend_dim) float32 stub embeddings (audio
    frames or vision patches); ``frontend(stream, draw)`` replaces their
    default draw (:func:`stream_frontend`)."""

    batch: int
    seq: int
    vocab: int
    seed: int = 0
    device: str = "cuda"
    frontend_len: int = 0
    frontend_dim: int = 0
    frontend: Callable[[int, int], torch.Tensor] | None = None

    def __post_init__(self) -> None:
        self._device = resolve_device(self.device)

    def element_spec(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """name -> (shape, dtype) of one batch."""
        shape = (self.batch, self.seq)
        spec = {"tokens": (shape, torch.int32), "labels": (shape, torch.int32),
                "mask": (shape, torch.float32)}
        if self.frontend_len:
            spec["frontend_embeds"] = ((self.batch, self.frontend_len, self.frontend_dim), torch.float32)
        return spec

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        draw = 0
        while True:
            b = synthetic_token_batch(stream_tokens(self.seed, draw, (self.batch, self.seq), self.vocab,
                                                    self._device))
            if self.frontend_len:
                shape = (self.batch, self.frontend_len, self.frontend_dim)
                fe = (stream_frontend(self.seed, draw, shape, self._device) if self.frontend is None
                      else self.frontend(self.seed, draw).to(self._device, torch.float32))
                b["frontend_embeds"] = fe
            yield b
            draw += 1
