"""Layer blocks: residual wiring for the kinds of the port.

The port of ``repro.models.blocks`` for ``attn_global`` / ``attn_local``
(GQA + MLP; ``gqa_dense`` is ``attn_global``'s alias) and ``rglru``
(Griffin recurrent + MLP): pre-norm residuals with optional gemma-style
post-norms (``cfg.post_norm``).

``block_forward(params, kind, cfg, x, mode=...)`` returns
``(x, cache)`` where ``mode`` is "train" | "prefill" | "decode".
"""
from __future__ import annotations

from typing import Any

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

_ATTN_KINDS = ("attn_global", "attn_local", "gqa_dense")
_KINDS = _ATTN_KINDS + ("rglru",)


def _check_kind(kind):
    if kind not in _KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not in this port yet (have {_KINDS})")


def init_block(gen, kind, cfg, dtype):
    _check_kind(kind)
    p: dict[str, Any] = {"norm1": L.init_rmsnorm(cfg.d_model, gen.device)}
    if cfg.post_norm:
        p["post_norm1"] = L.init_rmsnorm(cfg.d_model, gen.device)
    if kind in _ATTN_KINDS:
        p["attn"] = A.init_gqa(gen, cfg, dtype)
    else:
        p["mixer"] = R.init_rglru_block(gen, cfg, dtype)
    p["norm2"] = L.init_rmsnorm(cfg.d_model, gen.device)
    if cfg.post_norm:
        p["post_norm2"] = L.init_rmsnorm(cfg.d_model, gen.device)
    p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype)
    return p


def _mixer_apply(params, kind, cfg, x, *, mode, cache, pos, cache_len):
    """Dispatch the sequence mixer.  Returns (y, new_cache)."""
    if kind in _ATTN_KINDS:
        is_local = kind == "attn_local"
        if mode == "decode":
            return A.gqa_decode(params["attn"], cfg, x, cache, pos,
                                is_local=is_local)
        return A.gqa_forward(
            params["attn"], cfg, x, is_local=is_local,
            return_cache_len=cache_len if mode == "prefill" else 0)
    if mode == "decode":
        return R.rglru_decode(params["mixer"], cfg, x, cache)
    return R.rglru_forward(params["mixer"], cfg, x,
                           return_cache=mode == "prefill")


def block_forward(params, kind, cfg, x, *, mode="train",
                  cache=None, pos=None, cache_len=0):
    """Returns (x, new_cache)."""
    _check_kind(kind)
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    h, new_cache = _mixer_apply(params, kind, cfg, h, mode=mode,
                                cache=cache, pos=pos, cache_len=cache_len)
    if cfg.post_norm:
        h = L.rmsnorm(params["post_norm1"], h, cfg.norm_eps)
    x = x + h
    h = L.mlp(params["mlp"], L.rmsnorm(params["norm2"], x, cfg.norm_eps),
              cfg.activation)
    if cfg.post_norm:
        h = L.rmsnorm(params["post_norm2"], h, cfg.norm_eps)
    return x + h, new_cache


def init_block_cache(kind, cfg, batch, cache_len, dtype, device):
    """Zero decode cache for one block (the serving engine's slots)."""
    _check_kind(kind)
    if kind in _ATTN_KINDS:
        return A.init_gqa_cache(cfg, batch, cache_len, kind == "attn_local",
                                dtype, device)
    return R.init_rglru_cache(cfg, batch, dtype, device)
