"""Mamba2 (SSD — state-space duality, arXiv:2405.21060); counterpart of
``src/repro/models/ssm.py``.

Training and prefill: the chunked SSD algorithm — within-chunk
"attention" term (a masked C@B^T product) plus an inter-chunk recurrence,
which the reference carries by ``lax.scan`` and the port by a loop over
the chunks in chunk order. Decode: the O(1) recurrent state update. Both
share one discretization, so they agree (tested against the step-by-step
``ssd_reference``).

Recurrence (per head; state h in R^{N x P}):
    h_t = exp(-exp(a_log) * dt_t) * h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D * x_t
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _normal, init_linear, rms_norm


def ssm_dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    return d_inner, H, P, cfg.ssm_state


def init_ssm(generator, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    d_inner, H, P, N = ssm_dims(cfg)
    conv_ch = d_inner + 2 * N  # conv over [x, B, C]
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "in_proj": init_linear(generator, cfg.d_model, 2 * d_inner + 2 * N + H, dtype, device, lead),
        "conv_w": _normal(lead + (cfg.ssm_conv_width, conv_ch), 0.2, dtype, generator, device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros(lead + (H,), dtype=torch.float32, device=device),  # A = -exp(a_log) = -1
        "dt_bias": torch.zeros(lead + (H,), dtype=torch.float32, device=device),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=device),
        "norm": torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        "out_proj": init_linear(generator, d_inner, cfg.d_model, dtype, device, lead),
    }


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    d_inner, H, P, N = ssm_dims(cfg)
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner: 2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt


def _causal_conv_full(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (b, s, ch) with taps (k, ch)."""
    k = w.shape[0]
    s = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_full(params: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence Mamba2 block. Returns (out, (state, conv_tail)) so
    prefill can seed the decode cache."""
    bsz, s, _ = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, s)
    if s % Q:
        raise ValueError(f"seq {s} must divide into SSD chunks of {Q}")
    nc = s // Q
    f32 = torch.float32

    proj = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xBC, dt_raw = _split_proj(proj, cfg)
    xBC = _causal_conv_full(xBC, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype))
    xs = xBC[..., :d_inner].reshape(bsz, s, H, P)
    B = xBC[..., d_inner: d_inner + N]  # (b, s, N) single group
    C = xBC[..., d_inner + N:]

    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"])  # (b,s,H)
    a = -torch.exp(params["a_log"])  # (H,)
    log_da = dt * a  # log decay, (b,s,H) (negative)

    # chunk views
    xs_c = xs.reshape(bsz, nc, Q, H, P)
    B_c = B.reshape(bsz, nc, Q, N).to(f32)
    C_c = C.reshape(bsz, nc, Q, N).to(f32)
    dt_c = dt.reshape(bsz, nc, Q, H)
    ld_c = log_da.reshape(bsz, nc, Q, H)
    cum = torch.cumsum(ld_c, dim=2)  # l_i per chunk

    # intra-chunk (the "duality" product): M_ij = exp(l_i - l_j), i >= j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,Q,Q,H)
    ii = torch.arange(Q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    M = torch.where(causal, torch.exp(diff), 0.0)
    G = torch.einsum("bcqn,bcsn->bcqs", C_c, B_c)  # (b,nc,Q,Q)
    W = G[..., None] * M  # (b,nc,Q,Q,H)
    xdt = xs_c.to(f32) * dt_c[..., None]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", W, xdt)

    # chunk-final states: S_c = sum_j exp(l_Q - l_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b,nc,Q,H)
    S_c = torch.einsum("bcqh,bcqn,bcqhp->bchnp", decay_to_end, B_c, xdt)
    # (the reference's act_dp sharding constraint on S_c is a no-op here:
    # the port runs one device)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b,nc,H)

    # inter-chunk recurrence in chunk order: the state BEFORE each chunk
    state = torch.zeros((bsz, H, N, P), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_c[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,nc,H,N,P)

    # inter-chunk: y_i += C_i . (exp(l_i) * S_prev)
    decay_in = torch.exp(cum)  # (b,nc,Q,H)
    y_inter = torch.einsum("bcqn,bchnp,bcqh->bcqhp", C_c, prev_states, decay_in)

    y = (y_intra + y_inter).reshape(bsz, s, H, P)
    y = y + xs.to(f32) * params["D"][None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))

    conv_tail = xBC_tail(x, params, cfg)
    return out, (state, conv_tail)


def xBC_tail(x: torch.Tensor, params: dict, cfg: ArchConfig) -> torch.Tensor:
    """Last (conv_width-1) pre-conv channels — the decode conv state."""
    k = cfg.ssm_conv_width
    proj = torch.matmul(x[:, -(k - 1):, :], params["in_proj"].to(x.dtype))
    _, xBC, _ = _split_proj(proj, cfg)
    return xBC  # (b, k-1, conv_ch)


def ssd_decode(
    params: dict,
    x: torch.Tensor,  # (b, 1, d)
    state: torch.Tensor,  # (b, H, N, P) f32
    conv_state: torch.Tensor,  # (b, k-1, conv_ch)
    cfg: ArchConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step. Returns (out, state', conv_state'), new
    tensors (the inputs are not written)."""
    bsz = x.shape[0]
    d_inner, H, P, N = ssm_dims(cfg)
    f32 = torch.float32
    proj = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xBC_new, dt_raw = _split_proj(proj, cfg)

    # causal conv over the rolling window [conv_state, new]
    window = torch.cat([conv_state.to(x.dtype), xBC_new], dim=1)  # (b, k, ch)
    w = params["conv_w"].to(x.dtype)
    conv = torch.sum(window * w, dim=1) + params["conv_b"].to(x.dtype)
    xBC = F.silu(conv)  # (b, ch)
    xs = xBC[:, :d_inner].reshape(bsz, H, P).to(f32)
    B = xBC[:, d_inner: d_inner + N].to(f32)
    C = xBC[:, d_inner + N:].to(f32)

    dt = F.softplus(dt_raw[:, 0, :].to(f32) + params["dt_bias"])  # (b,H)
    da = torch.exp(dt * -torch.exp(params["a_log"]))  # (b,H)
    state = state * da[:, :, None, None] + torch.einsum("bh,bn,bhp->bhnp", dt, B, xs)
    y = torch.einsum("bn,bhnp->bhp", C, state) + xs * params["D"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))
    return out, state, window[:, 1:, :]


def ssd_reference(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Step-by-step recurrence oracle (slow; tests only)."""
    bsz, s, _ = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    k = cfg.ssm_conv_width
    state = torch.zeros((bsz, H, N, P), dtype=torch.float32, device=x.device)
    conv_state = torch.zeros((bsz, k - 1, d_inner + 2 * N), dtype=x.dtype, device=x.device)
    outs = []
    for i in range(s):
        o, state, conv_state = ssd_decode(params, x[:, i: i + 1, :], state, conv_state, cfg)
        outs.append(o)
    return torch.cat(outs, dim=1)
