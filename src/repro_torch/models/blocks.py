"""Layer blocks: residual wiring for every layer kind.

The port of ``repro.models.blocks``: ``attn_global`` / ``attn_local``
(GQA + MLP; ``gqa_dense`` is ``attn_global``'s alias), ``gqa_moe`` (GQA +
MoE), ``enc_attn`` (bidirectional GQA + MLP, the encoder's), ``dec_attn``
(causal self attention, then cross attention over the encoder's output,
then the MLP; its cache is ``{"self": ..., "cross": ...}``), ``mla_dense``
/ ``mla_moe`` (MLA + MLP or MoE, deepseek-v3; their cache is the latent
``ckv`` and ``krope``), ``rglru`` (Griffin recurrent + MLP) and ``mlstm``
/ ``slstm`` (xLSTM: the mixer alone, which carries its own projections):
pre-norm residuals with optional gemma-style post-norms
(``cfg.post_norm``).

``block_forward(params, kind, cfg, x, mode=...)`` returns
``(x, cache, aux)`` where ``mode`` is "train" | "prefill" | "decode" and
``aux`` is an MoE block's auxiliary losses (``lb_loss``, ``router_z``),
:data:`ZERO_AUX` for any other block: Python zeros, so that a block
without them launches nothing for them.
"""
from __future__ import annotations

from typing import Any

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R

ZERO_AUX = {"lb_loss": 0.0, "router_z": 0.0}

_ATTN_KINDS = ("attn_global", "attn_local", "gqa_dense", "gqa_moe",
               "enc_attn")
_MLA_KINDS = ("mla_dense", "mla_moe")
_KINDS = _ATTN_KINDS + _MLA_KINDS + ("dec_attn", "rglru", "mlstm", "slstm")


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
    elif kind == "dec_attn":
        p["attn"] = A.init_gqa(gen, cfg, dtype)
        p["cross"] = A.init_cross(gen, cfg, dtype)
        p["norm_cross"] = L.init_rmsnorm(cfg.d_model, gen.device)
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


def _mixer_apply(params, kind, cfg, x, *, mode, cache, pos, cache_len,
                 valid_len=None):
    """Dispatch the sequence mixer.  Returns (y, new_cache).

    ``valid_len``: (prefill) valid leading length of ``x`` under prompt
    bucketing -- attention layers snapshot their caches at it; recurrent
    layers freeze or neutralize their state past it.  Causality already
    keeps right pads out of every valid position's output.  MLA takes none:
    its cache is written at [0, S) and decode masks slots past ``pos``, so
    pad entries are overwritten before they are ever read."""
    if kind in _ATTN_KINDS:
        is_local = kind == "attn_local"
        if mode == "decode":
            return A.gqa_decode(params["attn"], cfg, x, cache, pos,
                                is_local=is_local)
        return A.gqa_forward(
            params["attn"], cfg, x, is_local=is_local,
            causal=kind != "enc_attn",
            return_cache_len=cache_len if mode == "prefill" else 0,
            valid_len=valid_len)
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
    return forward(params["mixer"], cfg, x, return_cache=mode == "prefill",
                   valid_len=valid_len)


def _dec_attn(params, cfg, x, *, mode, cache, pos, cache_len, enc_out,
              valid_len=None):
    """The decoder's self attention (``attn_global``) and its residual, then
    cross attention over ``enc_out`` in prefill and train, over the cross
    cache in decode, which hands that cache back unchanged.  Returns (x,
    new_cache)."""
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    h, new_self = _mixer_apply(
        params, "attn_global", cfg, h, mode=mode,
        cache=cache["self"] if mode == "decode" else None, pos=pos,
        cache_len=cache_len, valid_len=valid_len)
    x = x + h
    hc = L.rmsnorm(params["norm_cross"], x, cfg.norm_eps)
    if mode == "decode":
        hc = A.cross_decode(params["cross"], cfg, hc, cache["cross"])
        new_cross = cache["cross"]
    else:
        hc = A.cross_forward(params["cross"], cfg, hc, enc_out)
        new_cross = (A.cross_build_cache(params["cross"], cfg, enc_out)
                     if mode == "prefill" else None)
    new_cache = ({"self": new_self, "cross": new_cross}
                 if mode != "train" else None)
    return x + hc, new_cache


def block_forward(params, kind, cfg, x, *, mode="train",
                  cache=None, pos=None, cache_len=0, enc_out=None,
                  valid_len=None):
    """Returns (x, new_cache, aux).  ``enc_out``: the encoder's output,
    which a ``dec_attn`` block's cross attention reads in prefill and
    train; ``valid_len``: prefill's valid leading length
    (``_mixer_apply``)."""
    _check_kind(kind)
    if kind == "dec_attn":
        x, new_cache = _dec_attn(params, cfg, x, mode=mode, cache=cache,
                                 pos=pos, cache_len=cache_len,
                                 enc_out=enc_out, valid_len=valid_len)
    else:
        h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
        h, new_cache = _mixer_apply(params, kind, cfg, h, mode=mode,
                                    cache=cache, pos=pos,
                                    cache_len=cache_len,
                                    valid_len=valid_len)
        if cfg.post_norm:
            h = L.rmsnorm(params["post_norm1"], h, cfg.norm_eps)
        x = x + h
    aux = ZERO_AUX
    if not _has_mlp(kind):
        return x, new_cache, aux
    h = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    if _is_moe(kind):
        h, aux = M.moe_forward(params["moe"], cfg, h)
    else:
        h = L.mlp(params["mlp"], h, cfg.activation)
    if cfg.post_norm:
        h = L.rmsnorm(params["post_norm2"], h, cfg.norm_eps)
    return x + h, new_cache, aux


def init_block_cache(kind, cfg, batch, cache_len, dtype, device):
    """Zero decode cache for one block (the serving engine's slots)."""
    _check_kind(kind)
    if kind in _ATTN_KINDS:
        return A.init_gqa_cache(cfg, batch, cache_len, kind == "attn_local",
                                dtype, device)
    if kind == "dec_attn":
        # The cross entry is ``cache_len`` long, as the reference's: a
        # stand-in of the tree's structure; prefill builds the real one
        # over the source length (``cross_build_cache``).
        return {"self": A.init_gqa_cache(cfg, batch, cache_len, False, dtype,
                                         device),
                "cross": A.init_gqa_cache(cfg, batch, cache_len, False,
                                          dtype, device)}
    if kind in _MLA_KINDS:
        return A.init_mla_cache(cfg, batch, cache_len, dtype, device)
    if kind == "rglru":
        return R.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return R.init_mlstm_cache(cfg, batch, dtype, device)
    return R.init_slstm_cache(cfg, batch, device)
