"""The Sampler (paper §4.1): selective sampling with probability
proportional to weight; counterpart of ``src/repro/boosting/sampler.py``.

The paper uses *minimal variance sampling* (systematic resampling);
rejection-style sampling is kept for the ablation. Both take their
uniforms as arguments rather than drawing them inside, so a caller (or a
test) decides where the randomness comes from; :class:`GeneratorUniforms`
is the workers' default source of minimal-variance offsets.
"""

from __future__ import annotations

import torch


class GeneratorUniforms:
    """Default source of the Sparrow workers' uniform offsets: one
    ``torch.Generator`` per stream on ``device``, seeded with the stream
    id; draw ``j`` is the ``j``-th ``torch.rand(())`` of that generator
    (cached, so any order of requests gives the same numbers)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._streams: dict[int, tuple[torch.Generator, list[torch.Tensor]]] = {}

    def __call__(self, stream: int, draw: int) -> torch.Tensor:
        if stream not in self._streams:
            g = torch.Generator(device=self.device)
            g.manual_seed(stream)
            self._streams[stream] = (g, [])
        g, drawn = self._streams[stream]
        while len(drawn) <= draw:
            drawn.append(torch.rand((), generator=g, device=self.device))
        return drawn[draw]


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last dim, the same bits on every run.

    On a CUDA tensor that is a single row, ``torch.cumsum`` takes a
    single-pass look-back scan whose float additions associate in a
    run-dependent order (on an H100, repeated scans of one long row
    gave different bits); a scan over the rows of a 2-D tensor does not.
    The engine's dense == sparse bit-exactness needs the same sample
    every run, so a lone row is scanned beside a zero row."""
    if x.numel() != x.shape[-1]:
        return torch.cumsum(x, dim=-1)
    row = x.reshape(1, -1)
    return torch.cumsum(torch.cat([row, torch.zeros_like(row)]), dim=-1)[0].reshape(x.shape)


def minimal_variance_sample(u0, w: torch.Tensor, m: int) -> torch.Tensor:
    """Systematic resampling: ``m`` int32 indices with inclusion counts
    ``floor(m p_i)`` or ``ceil(m p_i)``, ``p = w / sum(w)``; a single
    uniform offset ``u0`` in [0, 1) decides every pick. Takes a leading
    batch axis: ``w (..., n)`` with ``u0`` of shape ``(...)``."""
    w = torch.clamp(w.to(torch.float32), min=0.0)
    n = w.shape[-1]
    total = w.sum(dim=-1, keepdim=True)
    # degenerate all-zero weights: uniform
    p = torch.where(total > 0, w / torch.clamp(total, min=1e-30), 1.0 / n)
    cum = _cumsum_rows(p)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=w.device).unsqueeze(-1)
    points = (torch.arange(m, dtype=torch.float32, device=w.device) + u0) / m
    points = points.expand(*cum.shape[:-1], m).contiguous()
    idx = torch.searchsorted(cum, points, right=False)
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def rejection_sample(u: torch.Tensor, w: torch.Tensor, m: int) -> torch.Tensor:
    """Weighted sampling with replacement, the "best known" alternative
    the paper mentions (higher variance in inclusion counts than
    :func:`minimal_variance_sample`): ``m`` int32 indices, index ``i``
    drawn with probability ``w_i / sum(w)``.

    Gumbel-max over ``log(max(w, 1e-30))``, as ``jax.random.categorical``
    does: ``u`` is an ``(m, n)`` tensor of uniforms in ``(0, 1)``, one row
    per pick."""
    w = torch.clamp(w.to(torch.float32), min=0.0)
    if tuple(u.shape) != (m, w.shape[-1]):
        raise ValueError(f"rejection_sample: u must be (m, n) = {(m, w.shape[-1])}, got {tuple(u.shape)}")
    logits = torch.log(torch.clamp(w, min=1e-30))
    gumbel = -torch.log(-torch.log(u.to(device=w.device, dtype=torch.float32)))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)
