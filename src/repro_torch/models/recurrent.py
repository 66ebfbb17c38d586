"""RG-LRU, the recurrent mixer of recurrentgemma (Griffin).

The port of the RG-LRU part of ``repro.models.recurrent``.  Its diagonal
recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t) runs on
``core.primitives.linear_recurrence(layout=Batched())`` -- the AFFINE scan
in the (B, T, C) channel layout, kernel K6 on the card.  The state ``h``
stays float32 in the decode cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import primitives as forge
from repro_torch.core.layout import Batched
from repro_torch.models import layers as L

_RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (width cfg.conv_width), with decode state
# ---------------------------------------------------------------------------


def init_conv1d(gen, width, channels, dtype=torch.float32):
    return {"kernel": L.normal(gen, (width, channels), 0.02, dtype),
            "bias": torch.zeros((channels,), dtype=dtype, device=gen.device)}


def causal_conv1d(params, x):
    """x: (B, T, C); causal depthwise conv."""
    w = params["kernel"].to(x.dtype)      # (W, C)
    W, T = w.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pads[:, i:i + T, :] * w[i] for i in range(W))
    return out + params["bias"].to(x.dtype)


def conv1d_step(params, x_t, state):
    """x_t: (B, 1, C); state: (B, W-1, C) holding the previous inputs."""
    w = params["kernel"].to(x_t.dtype)
    window = torch.cat([state, x_t], dim=1)              # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window, w)[:, None, :] \
        + params["bias"].to(x_t.dtype)
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Block-diagonal linear (the RG-LRU gates)
# ---------------------------------------------------------------------------


def init_blockdiag(gen, heads, width, dtype=torch.float32):
    per = width // heads
    return L.normal(gen, (heads, per, per), 1.0 / math.sqrt(per), dtype)


def blockdiag_apply(w, x):
    """x: (..., width) -> (..., width) with block-diagonal w: (H, p, p)."""
    H, p, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (H, p))
    out = torch.einsum("...hp,hpq->...hq", xs, w.to(x.dtype))
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin recurrent block)
# ---------------------------------------------------------------------------


def init_rglru_block(gen, cfg, dtype=torch.float32):
    d = cfg.d_model
    w = cfg.rnn_width or d
    # Lambda init so that a = exp(-8 softplus(L) r) starts in [0.9, 0.999].
    lam = torch.rand((w,), generator=gen, device=gen.device,
                     dtype=torch.float32)
    a_init = 0.9 + 0.09 * lam
    lam_param = torch.log(torch.expm1(-torch.log(a_init) / _RGLRU_C))
    return {
        "wx": L.dense_init(gen, (d, w), 0, dtype),
        "wy": L.dense_init(gen, (d, w), 0, dtype),
        "wo": L.dense_init(gen, (w, d), 0, dtype),
        "conv": init_conv1d(gen, cfg.conv_width, w, dtype),
        "gate_a": init_blockdiag(gen, cfg.n_heads, w, dtype),
        "gate_x": init_blockdiag(gen, cfg.n_heads, w, dtype),
        "bias_a": torch.zeros((w,), dtype=torch.float32, device=gen.device),
        "bias_x": torch.zeros((w,), dtype=torch.float32, device=gen.device),
        "lam": lam_param,
    }


def _rglru_gates(params, u):
    """u: (B, T, w) post-conv input -> (a, input gate, multiplier)."""
    r = torch.sigmoid(blockdiag_apply(params["gate_a"], u).float()
                      + params["bias_a"])
    i = torch.sigmoid(blockdiag_apply(params["gate_x"], u).float()
                      + params["bias_x"])
    log_a = -_RGLRU_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, i, mult


def rglru_forward(params, cfg, x, *, return_cache=False):
    """x: (B, T, D) -> (y, cache|None).  The scan primitive carries h."""
    dtype = x.dtype
    u_pre = x @ params["wx"].to(dtype)
    gate_branch = x @ params["wy"].to(dtype)
    u = causal_conv1d(params["conv"], u_pre)
    a, i, mult = _rglru_gates(params, u)
    b = mult * i * u.float()
    h = forge.linear_recurrence(a, b, layout=Batched())   # (B, T, w) f32
    h = h.to(dtype)
    y = (h * F.gelu(gate_branch, approximate="tanh")) @ params["wo"].to(dtype)
    cache = None
    if return_cache:
        # The state snapshot is the activation-dtype h, widened back to f32.
        cache = {"h": h[:, -1].float(), "conv": _conv_tail(cfg, u_pre)}
    return y, cache


def _conv_tail(cfg, u_pre):
    """The last ``conv_width - 1`` inputs, zero-padded on the left."""
    W = cfg.conv_width
    T = u_pre.shape[1]
    tail = u_pre[:, max(T - (W - 1), 0):]
    if tail.shape[1] < W - 1:
        tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
    return tail


def init_rglru_cache(cfg, batch, dtype, device):
    w = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(params, cfg, x, cache):
    """x: (B, 1, D) one-step decode; O(1) state update."""
    dtype = x.dtype
    u_pre = x @ params["wx"].to(dtype)
    gate_branch = x @ params["wy"].to(dtype)
    u, conv_state = conv1d_step(params["conv"], u_pre, cache["conv"])
    a, i, mult = _rglru_gates(params, u)
    b = mult * i * u.float()
    h = a[:, 0] * cache["h"] + b[:, 0]                   # (B, w)
    y = (h[:, None].to(dtype) * F.gelu(gate_branch, approximate="tanh")) \
        @ params["wo"].to(dtype)
    return y, {"h": h, "conv": conv_state}
