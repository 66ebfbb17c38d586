"""Layer blocks: residual wiring for the kinds of the port.

The port of ``repro.models.blocks`` for ``attn_global`` / ``attn_local``
(GQA + MLP; ``gqa_dense`` is ``attn_global``'s alias), ``gqa_moe`` (GQA +
MoE), ``mla_dense`` / ``mla_moe`` (MLA + MLP or MoE, deepseek-v3; their
cache is the latent ``ckv`` and ``krope``), ``rglru`` (Griffin recurrent +
MLP) and ``mlstm`` / ``slstm`` (xLSTM: the mixer alone, which carries its
own projections): pre-norm residuals with optional gemma-style post-norms
(``cfg.post_norm``).

``block_forward(params, kind, cfg, x, mode=...)`` returns
``(x, cache)`` where ``mode`` is "train" | "prefill" | "decode"; an MoE
block's auxiliary losses are dropped (the serving path reads none).
"""
from __future__ import annotations

from typing import Any

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R

_ATTN_KINDS = ("attn_global", "attn_local", "gqa_dense", "gqa_moe")
_MLA_KINDS = ("mla_dense", "mla_moe")
_KINDS = _ATTN_KINDS + _MLA_KINDS + ("rglru", "mlstm", "slstm")


def _has_mlp(kind):
    return kind not in ("mlstm", "slstm")


def _is_moe(kind):
    return kind.endswith("_moe")


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
    elif kind in _MLA_KINDS:
        p["attn"] = A.init_mla(gen, cfg, dtype)
    elif kind == "rglru":
        p["mixer"] = R.init_rglru_block(gen, cfg, dtype)
    elif kind == "mlstm":
        p["mixer"] = R.init_mlstm_block(gen, cfg, dtype)
    else:
        p["mixer"] = R.init_slstm_block(gen, cfg, dtype)
    if _has_mlp(kind):
        p["norm2"] = L.init_rmsnorm(cfg.d_model, gen.device)
        if cfg.post_norm:
            p["post_norm2"] = L.init_rmsnorm(cfg.d_model, gen.device)
        if _is_moe(kind):
            p["moe"] = M.init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                  cfg.activation, dtype)
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
    if kind in _MLA_KINDS:
        if mode == "decode":
            return A.mla_decode(params["attn"], cfg, x, cache, pos)
        return A.mla_forward(
            params["attn"], cfg, x,
            return_cache_len=cache_len if mode == "prefill" else 0)
    forward, decode = {
        "rglru": (R.rglru_forward, R.rglru_decode),
        "mlstm": (R.mlstm_forward, R.mlstm_decode),
        "slstm": (R.slstm_forward, R.slstm_decode)}[kind]
    if mode == "decode":
        return decode(params["mixer"], cfg, x, cache)
    return forward(params["mixer"], cfg, x, return_cache=mode == "prefill")


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
    if not _has_mlp(kind):
        return x, new_cache
    h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    if _is_moe(kind):
        h, _ = M.moe_forward(params["moe"], cfg, h)
    else:
        h = L.mlp(params["mlp"], h, cfg.activation)
    if cfg.post_norm:
        h = L.rmsnorm(params["post_norm2"], h, cfg.norm_eps)
    return x + h, new_cache


def init_block_cache(kind, cfg, batch, cache_len, dtype, device):
    """Zero decode cache for one block (the serving engine's slots)."""
    _check_kind(kind)
    if kind in _ATTN_KINDS:
        return A.init_gqa_cache(cfg, batch, cache_len, kind == "attn_local",
                                dtype, device)
    if kind in _MLA_KINDS:
        return A.init_mla_cache(cfg, batch, cache_len, dtype, device)
    if kind == "rglru":
        return R.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return R.init_mlstm_cache(cfg, batch, dtype, device)
    return R.init_slstm_cache(cfg, batch, device)
