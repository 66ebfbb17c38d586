"""The causal LM: parameters, prefill and one-token decode.

The port of ``repro.models.lm`` for the slice.  The layer stack is
``prefix + unit * n_units + suffix`` (configs); where the reference stacks
the ``units`` parameters on a leading axis and runs them with ``lax.scan``,
the port keeps a list of per-unit tuples and runs a Python loop.  Caches
mirror the same layout: ``{"prefix": [...], "units": [(...), ...],
"suffix": [...]}``, every leaf leading with the batch (slot) axis.

* ``init_params(cfg, seed=..., device=...)`` -> params
* ``prefill(params, cfg, tokens, cache_len=..., vision_embeds=None)``
  -> (last_logits, caches)
* ``decode_step(params, cfg, caches, tokens, pos)`` -> (logits, caches)
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.devices import resolve_device
from repro_torch.models import blocks as BK
from repro_torch.models import layers as L

Pytree = Any


def _dec_spec(cfg):
    return (tuple(cfg.prefix), tuple(cfg.unit), cfg.n_units, tuple(cfg.suffix))


def _init_stack(gen, spec, cfg, dtype):
    prefix, unit, n_units, suffix = spec
    return {
        "prefix": tuple(BK.init_block(gen, k, cfg, dtype) for k in prefix),
        "units": [tuple(BK.init_block(gen, k, cfg, dtype) for k in unit)
                  for _ in range(n_units)],
        "suffix": tuple(BK.init_block(gen, k, cfg, dtype) for k in suffix),
    }


def _run_stack(params, spec, cfg, h, *, mode, caches=None,
               pos=None, cache_len=0):
    """Returns (h, new_caches); new_caches is None in train mode."""
    prefix, unit, n_units, suffix = spec
    new = {"prefix": [], "units": [], "suffix": []}

    def run(p, kind, c):
        return BK.block_forward(p, kind, cfg, h, mode=mode,
                                cache=c, pos=pos, cache_len=cache_len)

    def cache_of(part, i, j=None):
        if mode != "decode":
            return None
        c = caches[part][i]
        return c if j is None else c[j]

    for i, kind in enumerate(prefix):
        h, nc = run(params["prefix"][i], kind, cache_of("prefix", i))
        new["prefix"].append(nc)
    for u in range(n_units):
        ncs = []
        for j, kind in enumerate(unit):
            h, nc = run(params["units"][u][j], kind, cache_of("units", u, j))
            ncs.append(nc)
        new["units"].append(tuple(ncs))
    for i, kind in enumerate(suffix):
        h, nc = run(params["suffix"][i], kind, cache_of("suffix", i))
        new["suffix"].append(nc)
    return h, (new if mode != "train" else None)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> Pytree:
    """Random parameters drawn on ``device`` (default: the CUDA device) from
    a ``torch.Generator`` seeded with ``seed``.  Weights take ``dtype``;
    norm scales, the RG-LRU's ``lam``/``bias_a``/``bias_x``, the mLSTM's
    gate projections and biases (``w_igate``, ``w_fgate``, ``b_igate``,
    ``b_fgate``), the sLSTM's gate ``bias`` and the MoE's ``router`` and
    ``router_bias`` stay float32, as in the reference.  With
    ``cfg.mtp_depth`` the tree holds the multi-token-prediction head
    (``mtp``: ``proj``, one ``mla_dense`` or ``attn_global`` block, three
    norms) as the reference's does; serving never runs it (its loss is
    training's)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not in this port yet")
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    d = cfg.d_model
    params = {
        "embed": L.init_embed(gen, cfg.vocab_size, d, cfg.tie_embeddings,
                              dtype),
        "decoder": _init_stack(gen, _dec_spec(cfg), cfg, dtype),
        "final_norm": L.init_rmsnorm(d, gen.device),
    }
    if cfg.mtp_depth:
        kind = "mla_dense" if cfg.use_mla else "attn_global"
        params["mtp"] = {
            "proj": L.dense_init(gen, (2 * d, d), 0, dtype),
            "block": BK.init_block(gen, kind, cfg, dtype),
            "norm_h": L.init_rmsnorm(d, gen.device),
            "norm_e": L.init_rmsnorm(d, gen.device),
            "final_norm": L.init_rmsnorm(d, gen.device),
        }
    return params


def count_params(params: Pytree) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg, tokens, vision_embeds=None):
    """The token embeddings, behind ``vision_embeds`` (B, P, D) in the
    activation dtype where the config takes prefix embeddings (a VLM's
    patch embeddings), so that the sequence's positions, from 0, run over
    prefix and tokens."""
    dtype = cfg.activation_dtype
    h = L.embed(params["embed"], tokens, cfg.embed_scale, dtype)
    if cfg.num_prefix_embeds and vision_embeds is not None:
        h = torch.cat([vision_embeds.to(dtype), h], dim=1)
    return h


def prefill(params, cfg, tokens, *, cache_len, vision_embeds=None):
    """Full-sequence forward over exact-length ``tokens`` (B, S), behind
    the prefix ``vision_embeds`` where given, building decode caches.  The
    logits are the last token's.  Returns (last_logits (B, vocab) float32,
    caches)."""
    h = _embed_inputs(params, cfg, tokens, vision_embeds)
    h, caches = _run_stack(params["decoder"], _dec_spec(cfg), cfg, h,
                           mode="prefill", cache_len=cache_len)
    h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    logits = L.unembed(params["embed"], h, cfg.final_softcap)
    return logits[:, 0], caches


def init_caches(cfg, batch, cache_len, dtype, device):
    """Zeroed decode caches for ``batch`` slots: attention caches (local
    rings, full-length global caches) and conv tails in ``dtype``,
    recurrent states (the RG-LRU's h, the mLSTM's C, n and m, the sLSTM's
    c, n, h and m) in float32."""
    prefix, unit, n_units, suffix = _dec_spec(cfg)

    def one(kind):
        return BK.init_block_cache(kind, cfg, batch, cache_len, dtype, device)

    return {"prefix": [one(k) for k in prefix],
            "units": [tuple(one(k) for k in unit) for _ in range(n_units)],
            "suffix": [one(k) for k in suffix]}


def decode_step(params, cfg, caches, tokens, pos):
    """One-token decode.  tokens: (B, 1) int; pos: (B,) per-slot positions
    (continuous batching: each row advances through its own cache slot).
    Returns (logits (B, vocab) float32, new_caches)."""
    h = L.embed(params["embed"], tokens, cfg.embed_scale,
                cfg.activation_dtype)
    h, new_caches = _run_stack(params["decoder"], _dec_spec(cfg), cfg, h,
                               mode="decode", caches=caches, pos=pos)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = L.unembed(params["embed"], h, cfg.final_softcap)
    return logits[:, 0], new_caches
