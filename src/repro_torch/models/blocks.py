"""Layer blocks: residual wiring for the kinds of the slice.

The port of ``repro.models.blocks`` for ``attn_local`` (sliding-window GQA +
MLP) and ``rglru`` (Griffin recurrent + MLP), with pre-norm residuals.

``block_forward(params, kind, cfg, x, positions, mode=...)`` returns
``(x, cache)`` where ``mode`` is "train" | "prefill" | "decode".
"""
from __future__ import annotations

from typing import Any

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

_KINDS = ("attn_local", "rglru")


def _check_kind(kind, cfg):
    if kind not in _KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not in this port yet (have {_KINDS})")
    if cfg.post_norm:
        raise NotImplementedError("post-block norms are not in this port yet")


def init_block(gen, kind, cfg, dtype):
    _check_kind(kind, cfg)
    p: dict[str, Any] = {"norm1": L.init_rmsnorm(cfg.d_model, gen.device)}
    if kind == "attn_local":
        p["attn"] = A.init_gqa(gen, cfg, dtype)
    else:
        p["mixer"] = R.init_rglru_block(gen, cfg, dtype)
    p["norm2"] = L.init_rmsnorm(cfg.d_model, gen.device)
    p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype)
    return p


def _mixer_apply(params, kind, cfg, x, positions, *, mode, cache, pos,
                 cache_len):
    """Dispatch the sequence mixer.  Returns (y, new_cache)."""
    if kind == "attn_local":
        if mode == "decode":
            return A.gqa_decode(params["attn"], cfg, x, cache, pos,
                                is_local=True)
        return A.gqa_forward(
            params["attn"], cfg, x, positions, is_local=True,
            return_cache_len=cache_len if mode == "prefill" else 0)
    if mode == "decode":
        return R.rglru_decode(params["mixer"], cfg, x, cache)
    return R.rglru_forward(params["mixer"], cfg, x,
                           return_cache=mode == "prefill")


def block_forward(params, kind, cfg, x, positions, *, mode="train",
                  cache=None, pos=None, cache_len=0):
    """Returns (x, new_cache)."""
    _check_kind(kind, cfg)
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    h, new_cache = _mixer_apply(params, kind, cfg, h, positions, mode=mode,
                                cache=cache, pos=pos, cache_len=cache_len)
    x = x + h
    h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + L.mlp(params["mlp"], h, cfg.activation), new_cache


def init_block_cache(kind, cfg, batch, cache_len, dtype, device):
    """Zero decode cache for one block (the serving engine's slots)."""
    _check_kind(kind, cfg)
    if kind == "attn_local":
        return A.init_gqa_cache(cfg, batch, cache_len, dtype, device)
    return R.init_rglru_cache(cfg, batch, dtype, device)
