"""Decision stumps over pre-binned features, and the strong rule;
counterpart of ``src/repro/boosting/stumps.py``.

A weak rule is ``h_{j,t,s}(x) = s * (2*[bin(x_j) > t] - 1)``; the strong
rule ``H(x) = sum_k alpha_k h_k(x)`` is stored as fixed-capacity tensors.
Every function here also takes a leading worker axis: a model with
``feat (W, T)`` and ``count (W,)`` goes with rows ``xb (W, n, d)``.

One ``(features x bins)`` weighted histogram gives the edges of every
candidate stump at once; kernel K1 (:func:`repro_torch.kernels.ops.edge_scan`)
computes it on the card, :func:`edge_histogram` is the plain scatter-add.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StumpModel(NamedTuple):
    """Fixed-capacity strong rule (the broadcast payload)."""

    feat: torch.Tensor  # (..., T) int32 — feature index per stump
    thr: torch.Tensor  # (..., T) int32 — bin threshold per stump
    sign: torch.Tensor  # (..., T) float32 — +1/-1
    alpha: torch.Tensor  # (..., T) float32 — stump weight
    count: torch.Tensor  # (...) int32 — number of live stumps

    @property
    def capacity(self) -> int:
        return self.feat.shape[-1]


def empty_model(capacity: int, *, device: torch.device | str, batch: tuple = ()) -> StumpModel:
    shape = tuple(batch) + (capacity,)
    return StumpModel(
        feat=torch.zeros(shape, dtype=torch.int32, device=device),
        thr=torch.zeros(shape, dtype=torch.int32, device=device),
        sign=torch.ones(shape, dtype=torch.float32, device=device),
        alpha=torch.zeros(shape, dtype=torch.float32, device=device),
        count=torch.zeros(tuple(batch), dtype=torch.int32, device=device),
    )


def append_stump(model: StumpModel, feat, thr, sign, alpha) -> StumpModel:
    """Append one weak rule per model row (no-op where at capacity)."""
    cap = model.capacity
    k = torch.clamp(model.count, max=cap - 1).long().unsqueeze(-1)
    ok = (model.count < cap).unsqueeze(-1)

    def upd(a: torch.Tensor, v) -> torch.Tensor:
        v = torch.as_tensor(v, dtype=a.dtype, device=a.device).reshape(k.shape)
        return a.scatter(-1, k, torch.where(ok, v, torch.gather(a, -1, k)))

    return StumpModel(
        feat=upd(model.feat, feat),
        thr=upd(model.thr, thr),
        sign=upd(model.sign, sign),
        alpha=upd(model.alpha, alpha),
        count=model.count + ok.squeeze(-1).to(torch.int32),
    )


def alpha_from_gamma(gamma) -> torch.Tensor:
    """AdaBoost weight for a certified edge:
    ``alpha = 1/2 log((1/2 + gamma) / (1/2 - gamma))``."""
    g = torch.clamp(torch.as_tensor(gamma, dtype=torch.float32), -0.49, 0.49)
    return 0.5 * torch.log((0.5 + g) / (0.5 - g))


def _stump_preds(model: StumpModel, xb: torch.Tensor) -> torch.Tensor:
    """``(..., n, T)`` predictions of every stored stump on rows ``xb (..., n, d)``."""
    t = model.capacity
    idx = model.feat.long().unsqueeze(-2).expand(*xb.shape[:-1], t)
    gathered = torch.gather(xb, -1, idx)
    one = torch.ones((), dtype=torch.float32, device=xb.device)
    return torch.where(gathered > model.thr.unsqueeze(-2), one, -one) * model.sign.unsqueeze(-2)


def _slots(model: StumpModel) -> torch.Tensor:
    return torch.arange(model.capacity, device=model.feat.device)


def predict_margin(model: StumpModel, xb: torch.Tensor) -> torch.Tensor:
    """Full strong-rule margin ``H(x)`` for binned rows ``xb``."""
    preds = _stump_preds(model, xb)
    live = (_slots(model) < model.count.unsqueeze(-1)).to(torch.float32)
    return torch.matmul(preds, (model.alpha * live).unsqueeze(-1)).squeeze(-1)


def predict_margin_delta(model: StumpModel, xb: torch.Tensor, t_from: torch.Tensor) -> torch.Tensor:
    """Incremental margin ``H_t(x) - H_{t_from}(x)`` per row; ``t_from``
    is per row ``(..., n)``, the stump count at the row's last refresh."""
    preds = _stump_preds(model, xb)  # (..., n, T)
    slot = _slots(model)
    count = model.count.reshape(model.count.shape + (1, 1))
    live = (slot >= t_from.unsqueeze(-1)) & (slot < count)
    return (preds * model.alpha.unsqueeze(-2) * live.to(torch.float32)).sum(dim=-1)


def exp_loss(model: StumpModel, xb: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Average exponential-loss potential ``Z_S(H)``."""
    return torch.exp(-y * predict_margin(model, xb)).mean(dim=-1)


def error_rate(model: StumpModel, xb: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    margin = predict_margin(model, xb)
    pred = torch.where(margin >= 0, 1.0, -1.0)
    return (pred != y).to(torch.float32).mean(dim=-1)


def model_payload_bytes(model: StumpModel) -> int:
    """Broadcast payload size of a strong rule (for comm accounting)."""
    return sum(int(x.numel() * x.element_size()) for x in model)


def edge_histogram(xb: torch.Tensor, wy: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Scatter-add ``wy`` into per-(feature, bin) cells:
    ``hist[..., j, b] = sum_{i: xb[..., i, j] = b} wy[..., i]``, float32
    ``(..., d, B)``. Bins must lie in ``[0, B)``."""
    *lead, n, d = xb.shape
    rows = 1
    for s in lead:
        rows *= s
    xb2 = xb.reshape(rows, n, d).long()
    cell = (
        torch.arange(rows, device=xb.device).view(rows, 1, 1) * (d * num_bins)
        + torch.arange(d, device=xb.device).view(1, 1, d) * num_bins
        + xb2
    )
    src = wy.reshape(rows, n, 1).to(torch.float32).expand(rows, n, d)
    hist = torch.zeros(rows * d * num_bins, dtype=torch.float32, device=xb.device)
    hist.index_add_(0, cell.reshape(-1), src.reshape(-1))
    return hist.reshape(*lead, d, num_bins)


def edges_from_histogram(hist: torch.Tensor) -> torch.Tensor:
    """Per-candidate signed edge mass ``m[j, t] = 2 G_j(t) - T`` with
    ``G_j(t) = sum_{b > t} hist[j, b]``; ``(..., d, B-1)``."""
    total = hist.sum(dim=-1, keepdim=True)
    rev_cum = torch.flip(torch.cumsum(torch.flip(hist, (-1,)), dim=-1), (-1,))
    return 2.0 * rev_cum[..., 1:] - total


def best_stump_exact(xb: torch.Tensor, y: torch.Tensor, w: torch.Tensor, num_bins: int):
    """Exact greedy best stump over the full weighted set (one model):
    ``(feat, thr, sign, gamma_hat)``."""
    hist = edge_histogram(xb, w * y, num_bins)
    m = edges_from_histogram(hist)  # (d, B-1)
    W = w.abs().sum()
    idx = torch.argmax(m.abs().reshape(-1))
    feat = idx // m.shape[1]
    thr = idx % m.shape[1]
    raw = m[feat, thr]
    sign = torch.where(raw >= 0, 1.0, -1.0)
    gamma_hat = raw.abs() / torch.clamp(W, min=1e-30) / 2.0
    return feat.to(torch.int32), thr.to(torch.int32), sign, gamma_hat


def bin_features(x: torch.Tensor, num_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantile-bin raw float features into int32 bins: ``(bins (n, d),
    cut_points (d, B-1))``."""
    qs = torch.linspace(0.0, 1.0, num_bins + 1, dtype=x.dtype, device=x.device)[1:-1]
    cuts = torch.quantile(x, qs, dim=0).T  # (d, B-1)
    bins = (x.unsqueeze(-1) > cuts.unsqueeze(0)).sum(dim=2).to(torch.int32)
    return bins, cuts
