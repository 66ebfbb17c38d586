"""Attention of the port: GQA, global and sliding-window, prefill and
decode.

The port of the GQA parts of ``repro.models.attention``, qk-norm
included.  Prefill attention on the cuda backend is kernel K10
(``kernels/flash_attention.py``: the reference's ``flash_attention_pallas``
as a hand-written CUDA kernel, in the models' layout); on the torch
backend it is ``blockwise_attention``, the reference models' own XLA core
(the online softmax over KV blocks, the flash pattern), which the CPU
tests hold against the reference.  Decode attention is plain tensor code
(``decode_attention``), as in the reference.
Global layers keep a ``cache_len`` cache written at [0, S); local layers a
ring of ``min(cache_len, local_window)`` slots.

Layouts are the reference's: q (B, S, K, G, hd), k and v (B, T, K, hd).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import intrinsics as ki
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.models import layers as L

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Blockwise (flash) attention core
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, *, qpos, causal=True, window=0,
                        softcap=0.0, kv_block=512, kv_len=None):
    """q: (B,S,K,G,hd); k,v: (B,T,K,hd).  Returns (B,S,K,G,hd).

    ``qpos``: (S,) absolute positions of queries.  ``window``>0 limits keys to
    (qpos - kpos) < window.  ``kv_len``: actual valid key count (<= T).
    Scores and the softmax state are float32; probabilities round to v's
    dtype before the value product, as in the reference.

    The last block is the ragged tail [start, T): every key is read once at
    its own position.  (The reference slices a full ``kv_block`` there,
    which its dynamic slice clamps back to [T - kv_block, T) while the mask
    still labels the keys from ``start`` on.)
    """
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    kv_block = min(kv_block, T)
    scale = 1.0 / math.sqrt(hd)
    kv_len = T if kv_len is None else kv_len

    qf = (q.float() * scale).to(q.dtype).float()
    m = torch.full((B, S, K, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, K, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for start in range(0, T, kv_block):
        ks = k[:, start:start + kv_block].float()
        vs = v[:, start:start + kv_block]
        s = torch.einsum("bskgd,btkd->bskgt", qf, ks)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = start + torch.arange(ks.shape[1], device=q.device)
        mask = kpos[None, :] < kv_len
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window:
            mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bskgt,btkd->bskgd", p.to(v.dtype).float(),
                          vs.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, key_valid, softcap=0.0):
    """Single-step attention over a fixed cache.

    q: (B,1,K,G,hd); caches: (B,L,K,hd); key_valid: (L,) or (B,L) bool.
    """
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bskgd,btkd->bskgt", q.float() * scale, k_cache.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if key_valid.ndim == 1:
        mask = key_valid[None, None, None, None, :]
    else:
        mask = key_valid[:, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def init_gqa(gen, cfg, dtype=torch.float32):
    """The projections; with ``cfg.qk_norm`` (gemma3) an rmsnorm of q and
    of k over ``head_dim``, whose scales stay float32 as every norm's."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, (d, H, hd), 0, dtype),
        "wk": L.dense_init(gen, (d, K, hd), 0, dtype),
        "wv": L.dense_init(gen, (d, K, hd), 0, dtype),
        "wo": L.dense_init(gen, (H, hd, d), (0, 1), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, gen.device)
        p["k_norm"] = L.init_rmsnorm(hd, gen.device)
    return p


def _project_qkv(params, cfg, x, positions, dtype, is_local):
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    if cfg.qk_norm:
        # After the projection, before rope; prefill and decode both.
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    theta = (cfg.rope_theta_global
             if (not is_local and cfg.rope_theta_global) else cfg.rope_theta)
    q = L.rope(q, positions, theta)
    k = L.rope(k, positions, theta)
    return q.reshape(q.shape[0], q.shape[1], K, H // K, hd), k, v


def gqa_forward(params, cfg, x, *, is_local, causal=True,
                return_cache_len=0):
    """Full-sequence forward of a sequence that starts at position 0 (K10
    counts query and key positions from 0, so both routes take them from
    here).  Returns (y, cache|None)."""
    dtype = x.dtype
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, dtype, is_local)
    window = cfg.local_window if is_local else 0
    if ki.current_backend(q) == "cuda":
        out = flash_k.flash_attention_gqa(q, k, v, causal=causal,
                                          window=window,
                                          softcap=cfg.attn_softcap)
    else:
        out = blockwise_attention(q, k, v, qpos=positions, causal=causal,
                                  window=window, softcap=cfg.attn_softcap)
    out = out.reshape(B, S, cfg.n_heads, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))
    cache = None
    if return_cache_len:
        cache = _build_cache(k, v, return_cache_len, is_local, cfg)
    return y, cache


def _build_cache(k, v, cache_len, is_local, cfg):
    """Build a decode cache from prefill K/V.  Local: a ring where position
    t sits in slot t % W and the ring holds the last W positions.  Global:
    ``cache_len`` slots, positions [0, S) written in place."""
    B, S, K, hd = k.shape
    if not is_local and cache_len < S:
        raise ValueError(f"global-attention cache_len={cache_len} < prefill "
                         f"length {S}")
    W = min(cache_len, cfg.local_window) if is_local else cache_len
    t0 = max(S - W, 0)
    slots = (t0 + torch.arange(S - t0, device=k.device)) % W
    kc = torch.zeros((B, W, K, hd), dtype=k.dtype, device=k.device)
    vc = torch.zeros((B, W, K, hd), dtype=v.dtype, device=v.device)
    kc[:, slots] = k[:, t0:]
    vc[:, slots] = v[:, t0:]
    return {"k": kc, "v": vc}


def init_gqa_cache(cfg, batch, cache_len, is_local, dtype, device):
    """Zeroed cache: a local ring of ``min(cache_len, local_window)`` slots,
    or ``cache_len`` slots for a global layer."""
    K, hd = cfg.n_kv_heads, cfg.head_dim
    Lc = min(cache_len, cfg.local_window) if is_local else cache_len
    return {"k": torch.zeros((batch, Lc, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, Lc, K, hd), dtype=dtype, device=device)}


def gqa_decode(params, cfg, x, cache, pos, *, is_local):
    """One-token decode.  x: (B,1,D); pos: (B,) per-slot positions
    (continuous batching: every row sits at its own depth in its own cache
    slot).  Returns (y, cache): this step's k and v are written into slot
    ``pos % L`` of ``cache``'s own tensors in place, as the reference's
    ``.at[bidx, slot].set`` is under jit (the engine owns the cache; a copy
    of every layer's cache a step would only cost memory and bandwidth),
    and the same tensors come back."""
    if pos.ndim != 1:
        raise ValueError(f"gqa_decode takes a (B,) position vector, got "
                         f"shape {tuple(pos.shape)}")
    dtype = x.dtype
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    positions = pos.to(torch.int32)[:, None]
    q, k, v = _project_qkv(params, cfg, x, positions, dtype, is_local)
    Lc = cache["k"].shape[1]
    slot = pos % Lc
    slot_idx = torch.arange(Lc, device=x.device)
    qpos = pos[:, None]
    if is_local:
        # Slot s holds absolute position pos - ((pos - s) mod Lc); valid if
        # >= 0.
        key_valid = (qpos - torch.remainder(qpos - slot_idx, Lc)) >= 0
    else:
        key_valid = slot_idx <= qpos
    bidx = torch.arange(B, device=x.device)
    kc, vc = cache["k"], cache["v"]
    kc[bidx, slot] = k[:, 0].to(kc.dtype)
    vc[bidx, slot] = v[:, 0].to(vc.dtype)
    out = decode_attention(q, kc, vc, key_valid=key_valid,
                           softcap=cfg.attn_softcap)
    out = out.reshape(B, 1, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))
    return y, cache
