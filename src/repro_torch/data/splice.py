"""Synthetic stand-in for the human acceptor splice-site task (paper §5);
counterpart of ``src/repro/data/splice.py``.

Categorical "position x nucleotide" features, a sparse ground-truth
stump ensemble, class imbalance and label noise — the compute profile
of the paper's task, not its data. Generated by a ``torch.Generator`` on
the chosen device: the numbers differ from the reference's
``jax.random`` stream for the same seed, so tests that compare the two
packages hand the reference's data to both.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SpliceConfig:
    n: int = 200_000
    d: int = 64  # feature count (motif positions)
    num_bins: int = 8  # categorical arity (k-mer alphabet)
    n_signal: int = 12  # features that actually carry signal
    pos_fraction: float = 0.3  # class balance
    label_noise: float = 0.05
    seed: int = 0


def make_splice_like(
    cfg: SpliceConfig, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(xb (n, d) int32 bins, y (n,) float32 +-1, truth (3, n_signal))``
    on ``device`` (``"cuda"`` by default; raises without a card unless
    ``"cpu"`` is given)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg.seed)
    xb = torch.randint(0, cfg.num_bins, (cfg.n, cfg.d), generator=g, device=dev, dtype=torch.int32)
    sig_feats = torch.randperm(cfg.d, generator=g, device=dev)[: cfg.n_signal]
    sig_thr = torch.randint(0, cfg.num_bins - 1, (cfg.n_signal,), generator=g, device=dev)
    coin = torch.rand((cfg.n_signal,), generator=g, device=dev) < 0.5
    sig_sgn = torch.where(coin, 1.0, -1.0)
    weights = torch.linspace(2.0, 0.5, cfg.n_signal, device=dev)  # few strong + weak tail

    votes = torch.where(xb[:, sig_feats] > sig_thr, 1.0, -1.0) * sig_sgn
    score = votes @ weights
    # bias to hit the target positive fraction
    bias = torch.quantile(score, 1.0 - cfg.pos_fraction)
    y = torch.where(score > bias, 1.0, -1.0)
    flip = torch.rand((cfg.n,), generator=g, device=dev) < cfg.label_noise
    y = torch.where(flip, -y, y).to(torch.float32)
    truth = torch.stack([sig_feats.to(torch.float32), sig_thr.to(torch.float32), sig_sgn])
    return xb, y, truth


def train_test_split(
    xb: torch.Tensor, y: torch.Tensor, test_fraction: float = 0.1, seed: int = 1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random split on the data's own device."""
    n = xb.shape[0]
    g = torch.Generator(device=xb.device)
    g.manual_seed(seed)
    perm = torch.randperm(n, generator=g, device=xb.device)
    n_test = int(n * test_fraction)
    te, tr = perm[:n_test], perm[n_test:]
    return xb[tr], y[tr], xb[te], y[te]
