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

B and C come in ``ssm_groups`` groups, head h reading group h // (H /
G), and the gated norm is taken over each group's share of the channels
(Nemotron-H's Mamba2: 8 groups); one group is the reference's layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _normal, init_linear, rms_norm


def ssm_dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, state)."""
    d_inner = cfg.ssm_d_inner()
    P = cfg.ssm_head_dim
    H = d_inner // P
    return d_inner, H, P, cfg.ssm_state


def conv_channels(cfg: ArchConfig) -> int:
    """The causal conv's channels: x, then B's and C's groups."""
    d_inner, _, _, N = ssm_dims(cfg)
    return d_inner + 2 * cfg.ssm_groups * N


def init_ssm(generator, cfg: ArchConfig, dtype, device="cpu", lead: tuple = ()) -> dict:
    d_inner, H, P, N = ssm_dims(cfg)
    conv_ch = conv_channels(cfg)  # conv over [x, B, C]
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "in_proj": init_linear(generator, cfg.d_model, d_inner + conv_ch + H, dtype, device, lead),
        "conv_w": _normal(lead + (cfg.ssm_conv_width, conv_ch), 0.2, dtype, generator, device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros(lead + (H,), dtype=torch.float32, device=device),  # A = -exp(a_log) = -1
        "dt_bias": torch.zeros(lead + (H,), dtype=torch.float32, device=device),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=device),
        "norm": torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        "out_proj": init_linear(generator, d_inner, cfg.d_model, dtype, device, lead),
    }


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    d_inner = cfg.ssm_d_inner()
    end = d_inner + conv_channels(cfg)
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:end]
    dt = proj[..., end:]
    return z, xBC, dt


def _split_xBC(xBC: torch.Tensor, cfg: ArchConfig):
    """x (..., d_inner), B and C (..., groups, state)."""
    d_inner, _, _, N = ssm_dims(cfg)
    G = cfg.ssm_groups
    lead = xBC.shape[:-1]
    B = xBC[..., d_inner: d_inner + G * N].reshape(lead + (G, N))
    C = xBC[..., d_inner + G * N:].reshape(lead + (G, N))
    return xBC[..., :d_inner], B, C


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """RMSNorm of y * silu(z) over each of ``ssm_groups`` groups of
    channels (Mamba2's ``RMSNormGated(group_size=d_inner / groups)``)."""
    g = y * F.silu(z)
    n = cfg.ssm_groups
    if n == 1:
        return rms_norm(g, scale, cfg.norm_eps)
    shape = g.shape
    parts = g.reshape(shape[:-1] + (n, shape[-1] // n))
    return rms_norm(parts, scale.reshape(n, -1), cfg.norm_eps).reshape(shape)


def _causal_conv_full(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (b, s, ch) with taps (k, ch)."""
    k = w.shape[0]
    s = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_scan(xs: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor, params: dict,
             Q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD from x (b, s, H, P), dt (b, s, H) float32 and B, C
    (b, s, G, N) to y (b, s, H, P) float32 (the D skip added) and the
    final state (b, H, N, P). Head h reads group h // (H / G)."""
    bsz, s, H, P = xs.shape
    G, N = B.shape[-2:]
    J = H // G
    nc = s // Q
    f32 = torch.float32
    a = -torch.exp(params["a_log"])  # (H,)
    log_da = dt * a  # log decay, (b,s,H) (negative)

    # chunk views; heads split (G, J) where they meet a group
    xs_c = xs.reshape(bsz, nc, Q, H, P)
    B_c = B.reshape(bsz, nc, Q, G, N).to(f32)
    C_c = C.reshape(bsz, nc, Q, G, N).to(f32)
    dt_c = dt.reshape(bsz, nc, Q, H)
    ld_c = log_da.reshape(bsz, nc, Q, H)
    cum = torch.cumsum(ld_c, dim=2)  # l_i per chunk

    # intra-chunk (the "duality" product): M_ij = exp(l_i - l_j), i >= j;
    # above the diagonal the exponent is masked before exp (it grows with
    # the distance, and an inf there would make the backward NaN)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,Q,Q,H)
    ii = torch.arange(Q, device=xs.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    M = torch.exp(torch.where(causal, diff, -torch.inf))
    CB = torch.einsum("bcqgn,bcsgn->bcqsg", C_c, B_c)  # (b,nc,Q,Q,G)
    W = (CB[..., None] * M.reshape(bsz, nc, Q, Q, G, J)).reshape(bsz, nc, Q, Q, H)
    xdt = xs_c.to(f32) * dt_c[..., None]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", W, xdt)

    # chunk-final states: S_c = sum_j exp(l_Q - l_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b,nc,Q,H)
    S_c = torch.einsum("bcqgj,bcqgn,bcqgjp->bcgjnp", decay_to_end.reshape(bsz, nc, Q, G, J), B_c,
                       xdt.reshape(bsz, nc, Q, G, J, P)).reshape(bsz, nc, H, N, P)
    # (the reference's act_dp sharding constraint on S_c is a no-op here:
    # the port runs one device)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b,nc,H)

    # inter-chunk recurrence in chunk order: the state BEFORE each chunk.
    # The chunks are taken by unbind, whose backward stacks their
    # gradients once: indexing S_c[:, c] would cost each chunk's backward
    # a zeroed (b, nc, H, N, P) tensor and an add of it (the same sums)
    state = torch.zeros((bsz, H, N, P), dtype=f32, device=xs.device)
    prev = []
    for decay, S in zip(chunk_decay.unbind(1), S_c.unbind(1)):
        prev.append(state)
        state = state * decay[:, :, None, None] + S
    prev_states = torch.stack(prev, dim=1)  # (b,nc,H,N,P)

    # inter-chunk: y_i += C_i . (exp(l_i) * S_prev)
    decay_in = torch.exp(cum)  # (b,nc,Q,H)
    y_inter = torch.einsum("bcqgn,bcgjnp,bcqgj->bcqgjp", C_c, prev_states.reshape(bsz, nc, G, J, N, P),
                           decay_in.reshape(bsz, nc, Q, G, J)).reshape(bsz, nc, Q, H, P)

    y = (y_intra + y_inter).reshape(bsz, s, H, P)
    y = y + xs.to(f32) * params["D"][None, None, :, None]
    return y, state


def ssd_full(params: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence Mamba2 block. Returns (out, (state, conv_tail)) so
    prefill can seed the decode cache. Spans ``ssm.mixer`` (in_proj
    through out_proj) and, inside it, ``ssm.scan`` (:func:`ssd_scan`)."""
    bsz, s, _ = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, s)
    if s % Q:
        raise ValueError(f"seq {s} must divide into SSD chunks of {Q}")
    trace.count("ssm_calls", 1, "full")
    with trace.span("ssm.mixer"):
        proj = torch.matmul(x, params["in_proj"].to(x.dtype))
        z, xBC, dt_raw = _split_proj(proj, cfg)
        xBC = _causal_conv_full(xBC, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype))
        xs, B, C = _split_xBC(xBC, cfg)
        dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])  # (b,s,H)
        with trace.span("ssm.scan"):
            y, state = ssd_scan(xs.reshape(bsz, s, H, P), dt, B, C, params, Q)
        y = y.reshape(bsz, s, d_inner).to(x.dtype)
        y = _gated_norm(y, z, params["norm"], cfg)
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
    G = cfg.ssm_groups
    J = H // G
    f32 = torch.float32
    trace.count("ssm_calls", 1, "decode")
    proj = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xBC_new, dt_raw = _split_proj(proj, cfg)

    # causal conv over the rolling window [conv_state, new]
    window = torch.cat([conv_state.to(x.dtype), xBC_new], dim=1)  # (b, k, ch)
    w = params["conv_w"].to(x.dtype)
    conv = torch.sum(window * w, dim=1) + params["conv_b"].to(x.dtype)
    xs, B, C = _split_xBC(F.silu(conv), cfg)  # (b, d_inner), (b, G, N)
    xs = xs.reshape(bsz, G, J, P).to(f32)
    B, C = B.to(f32), C.to(f32)

    dt = F.softplus(dt_raw[:, 0, :].to(f32) + params["dt_bias"])  # (b,H)
    da = torch.exp(dt * -torch.exp(params["a_log"]))  # (b,H)
    upd = torch.einsum("bgj,bgn,bgjp->bgjnp", dt.reshape(bsz, G, J), B, xs).reshape(bsz, H, N, P)
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bgn,bgjnp->bgjp", C, state.reshape(bsz, G, J, N, P)).reshape(bsz, H, P)
    y = y + xs.reshape(bsz, H, P) * params["D"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["norm"], cfg)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))
    return out, state, window[:, 1:, :]


def ssd_reference(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Step-by-step recurrence oracle (slow; tests only)."""
    bsz, s, _ = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    k = cfg.ssm_conv_width
    state = torch.zeros((bsz, H, N, P), dtype=torch.float32, device=x.device)
    conv_state = torch.zeros((bsz, k - 1, conv_channels(cfg)), dtype=x.dtype, device=x.device)
    outs = []
    for i in range(s):
        o, state, conv_state = ssd_decode(params, x[:, i: i + 1, :], state, conv_state, cfg)
        outs.append(o)
    return torch.cat(outs, dim=1)
