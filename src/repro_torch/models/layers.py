"""Shared model layers: initialisers, norms, rotary, MLP, embeddings.

The port of ``repro.models.layers`` for the slice.  Parameters are plain
dicts of tensors; apply functions are plain functions on tensors that keep
the reference's layouts and its rounding points:

* ``rmsnorm`` computes in float32 with the gemma ``(1 + scale)`` form;
* ``embed`` rounds ``sqrt(d)`` to the activation dtype before it multiplies;
* ``unembed`` multiplies in the activation dtype, then casts to float32;
* the gelu of geglu is the tanh approximation (``jax.nn.gelu``'s default);
  swiglu's gate is ``silu``, and relu2 squares the relu in the activation
  dtype;
* ``softmax_cross_entropy`` is training's loss, with the z-loss.

Initialisers draw from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """float32 normal draws scaled by ``std``, then cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(gen, shape, in_axis=0, dtype=torch.float32, scale=1.0):
    axes = (in_axis,) if isinstance(in_axis, int) else in_axis
    fan_in = math.prod(shape[a] for a in axes)
    return normal(gen, shape, scale / math.sqrt(fan_in), dtype)


def embed_init(gen, shape, dtype=torch.float32):
    return normal(gen, shape, 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d, device):
    """Norm scales stay float32 whatever the weights' dtype."""
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # Gemma-style (1 + scale) parameterization, zero-init.
    return (x * (1.0 + params["scale"].float())).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    # A Python scalar, not a tensor: a host tensor moved to the card here
    # would be a blocking copy in every attention layer of every step.
    freqs = torch.exp(-math.log(theta) * (
        2 * torch.arange(half, dtype=torch.float32, device=x.device) / hd))
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated: swiglu, geglu; ungated: gelu, relu, relu2)
# ---------------------------------------------------------------------------


def init_mlp(gen, d, ff, activation, dtype=torch.float32):
    p = {"w_in": dense_init(gen, (d, ff), 0, dtype),
         "w_out": dense_init(gen, (ff, d), 0, dtype)}
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (d, ff), 0, dtype)
    return p


def _act(name, x):
    if name == "swiglu":
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "relu2":
        r = F.relu(x)
        return r * r              # squared in the activation dtype
    raise ValueError(name)


def mlp(params, x, activation):
    """x: (B, S, D) -> (B, S, D)."""
    dtype = x.dtype
    h = x @ params["w_in"].to(dtype)
    if "w_gate" in params:
        h = _act(activation, x @ params["w_gate"].to(dtype)) * h
    else:
        h = _act(activation, h)
    return h @ params["w_out"].to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(gen, vocab, d, tie, dtype=torch.float32):
    p = {"embedding": embed_init(gen, (vocab, d), dtype)}
    if not tie:
        p["unembed"] = dense_init(gen, (d, vocab), 0, dtype)
    return p


def embed(params, tokens, scale=False, dtype=torch.bfloat16):
    x = params["embedding"][tokens].to(dtype)
    if scale:
        # sqrt(d) rounds to the activation dtype first, as the reference.
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=dtype)
    return x


def softmax_cross_entropy(logits, labels, z_loss: float = 0.0):
    """Mean token cross-entropy in float32, plus ``z_loss`` times the
    squared log-partition; labels < 0 are masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    mask = (labels >= 0).float()
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def unembed(params, x, softcap=0.0):
    table = params.get("unembed")
    if table is None:
        table = params["embedding"].T
    logits = (x @ table.to(x.dtype)).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
