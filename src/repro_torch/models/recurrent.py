"""Recurrent mixers: RG-LRU (recurrentgemma) and mLSTM / sLSTM (xLSTM).

The port of ``repro.models.recurrent``:

* RG-LRU's diagonal recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)
  runs on ``core.primitives.linear_recurrence(layout=Batched())`` -- the
  AFFINE scan in the (B, T, C) channel layout, kernel K6 on the card.
* mLSTM's stabilizer m_t = max(log f_t + m_{t-1}, log i_t) runs on
  ``core.primitives.scan`` with the non-commutative MAXPLUS_AFFINE operator
  (K6 on the card; its long-T path from 128 steps on).  With m known the
  matrix memory is processed chunkwise: the chunk states follow a diagonal
  recurrence along the chunk axis with a scalar decay per head, one
  ``linear_recurrence`` over the flattened (H, dh, dh) state (K6's
  channel-tile route); the outputs inside a chunk are masked decay
  attention, vectorized over chunks up to a footprint cutoff.
* sLSTM's gates read h_{t-1}: no associative operator carries it, so it
  runs as a loop over time, as the reference's ``lax.scan``.

Recurrent states stay float32 in the decode caches; conv tails take the
activation dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import operators as alg
from repro_torch.core import primitives as forge
from repro_torch.core.layout import Batched
from repro_torch.models import layers as L

_RGLRU_C = 8.0

# Elements of the (B, NC, L, L, H) intra-chunk attention tensor above which
# the mLSTM computes chunk outputs one chunk at a time instead of
# vectorizing over all chunks, so long prompts keep a one-chunk peak.
_MLSTM_INTRA_PARALLEL_MAX_ELEMS = 1 << 24


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
# Block-diagonal linear (the RG-LRU gates; the xLSTM's projections)
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


def rglru_forward(params, cfg, x, *, return_cache=False, valid_len=None):
    """x: (B, T, D) -> (y, cache|None).  The scan primitive carries h.

    ``valid_len`` (a Python int): valid leading length of ``x`` under
    prompt bucketing.  The recurrence runs over the whole padded sequence
    (outputs at valid positions depend only on earlier ones) and the cache
    snapshots the state and the conv tail at ``valid_len``."""
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
        last = -1 if valid_len is None else int(valid_len) - 1
        cache = {"h": h[:, last].float(),
                 "conv": _conv_tail(cfg, u_pre, valid_len)}
    return y, cache


def _conv_tail(cfg, u_pre, valid_len=None):
    """The last ``conv_width - 1`` inputs ending at ``valid_len`` (or the
    end), zero-padded on the left."""
    W = cfg.conv_width
    if valid_len is not None:
        u_pre = u_pre[:, :int(valid_len)]
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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): chunkwise matrix-memory recurrence with exact stabilizer
# ---------------------------------------------------------------------------


def init_mlstm_block(gen, cfg, dtype=torch.float32):
    """The gate projections and biases stay float32 whatever ``dtype``;
    the forget gates start open (bias 3.0)."""
    d = cfg.d_model
    inner = 2 * d
    H = cfg.n_heads
    f32 = torch.float32
    return {
        "w_up": L.dense_init(gen, (d, inner), 0, dtype),
        "w_gate": L.dense_init(gen, (d, inner), 0, dtype),
        "conv": init_conv1d(gen, cfg.conv_width, inner, dtype),
        "wq": init_blockdiag(gen, H, inner, dtype),
        "wk": init_blockdiag(gen, H, inner, dtype),
        "wv": init_blockdiag(gen, H, inner, dtype),
        "w_igate": L.dense_init(gen, (d, H), 0, f32),
        "w_fgate": L.dense_init(gen, (d, H), 0, f32),
        "b_igate": torch.zeros((H,), dtype=f32, device=gen.device),
        "b_fgate": torch.full((H,), 3.0, dtype=f32, device=gen.device),
        "w_down": L.dense_init(gen, (inner, d), 0, dtype),
        "skip_scale": torch.zeros((inner,), dtype=dtype, device=gen.device),
    }


def _mlstm_stabilizer(lf, li):
    """m_t = max(lf_t + m_{t-1}, li_t) from m_0 = 0 via the MAXPLUS_AFFINE
    scan.  lf, li: (B, T, H) float32 -> m: (B, T, H)."""
    A, Bm = forge.scan(alg.MAXPLUS_AFFINE, (lf.contiguous(), li.contiguous()),
                       axis=1)
    return torch.maximum(A, Bm)


def _chunk_out(q, k, v, li, G, m, Cs, ns):
    """Outputs of N chunks from their start states.  q, k, v: (B, N, L, H,
    dh); li, G, m: (B, N, L, H); Cs: (B, N, H, dh, dh); ns: (B, N, H, dh).

    As the reference: the masked decay attention and k, v round to bf16 and
    their products accumulate in float32 (bf16 products are exact in
    float32), whatever the model's dtype."""
    Lc = q.shape[2]
    bf16 = torch.bfloat16
    qf = q.float()
    logw = G[:, :, :, None, :] - G[:, :, None, :, :] + li[:, :, None, :, :]
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=q.device).tril()
    qk = torch.einsum("bnlhd,bnshd->bnlsh", qf, k.float())
    attn = torch.where(tri[:, :, None], torch.exp(logw) * qk,
                       0.0).to(bf16).float()
    h_intra = torch.einsum("bnlsh,bnshd->bnlhd", attn, v.to(bf16).float())
    decay_t = torch.exp(G)
    h_inter = torch.einsum("bnlhd,bnhde->bnlhe", qf, Cs) * decay_t[..., None]
    n_intra = torch.einsum("bnlsh,bnshd->bnlhd", attn, k.to(bf16).float())
    qn_intra = torch.einsum("bnlhd,bnlhd->bnlh", qf, n_intra)
    qn_inter = torch.einsum("bnlhd,bnhd->bnlh", qf, ns) * decay_t
    num = h_intra + h_inter
    qn = qn_intra + qn_inter
    denom = torch.maximum(qn.abs(), torch.exp(-m))
    return num / denom[..., None]


def _mlstm_chunk_scan(q, k, v, lf, li, m, state_dtype=torch.float32):
    """Chunkwise mLSTM from a zero state.  q, k, v: (B, NC, L, H, dh);
    lf, li, m: (B, NC, L, H).  Returns h: (B, NC, L, H, dh) float32 and the
    final (C, n) in ``state_dtype``.

    The inter-chunk recurrence S_c = exp(G_L,c) S_{c-1} + U_c has a scalar
    decay per head, so it is one ``linear_recurrence`` along the chunk axis
    over the flattened (H, dh, dh) state, in ``state_dtype``."""
    Bb, NC, Lc, H, dh = q.shape
    # q in float32, as the reference's product with a float64 numpy scalar
    # promotes it.
    q = q.float() * (1.0 / math.sqrt(dh))

    # Stabilized gates given the global m: f'_t = exp(lf_t + m_{t-1} - m_t),
    # i'_t = exp(li_t - m_t).
    m_prev = F.pad(m.reshape(Bb, NC * Lc, H)[:, :-1],
                   (0, 0, 1, 0)).reshape(Bb, NC, Lc, H)
    lf_p = lf + m_prev - m
    li_p = li - m
    G = torch.cumsum(lf_p, dim=2)        # intra-chunk cumulative log decay

    # Per-chunk state contributions U_c = sum_s w_s k_s v_s^T and u_c =
    # sum_s w_s k_s, w_s = exp(G_L - G_s + li'_s): k scaled by w, then one
    # batched product contracting the chunk's steps (never k (x) v first).
    gl = G[:, :, -1:, :]                               # (B, NC, 1, H)
    wst = torch.exp(gl - G + li_p)                     # (B, NC, L, H)
    kw = k.float() * wst[..., None]                    # (B, NC, L, H, dh)
    U = torch.matmul(kw.permute(0, 1, 3, 4, 2),
                     v.float().permute(0, 1, 3, 2, 4))  # (B, NC, H, dh, dh)
    un = kw.sum(dim=2)                                 # (B, NC, H, dh)
    eg = torch.exp(gl[:, :, 0])                        # (B, NC, H)

    def chunk_states(contrib, chan):
        # K6 takes contiguous leaves: the decay is broadcast over each
        # head's block of channels and materialized.
        a_full = eg[..., None].expand(Bb, NC, H, chan).reshape(
            Bb, NC, H * chan).to(state_dtype)
        S = forge.linear_recurrence(
            a_full, contrib.reshape(Bb, NC, H * chan).to(state_dtype),
            layout=Batched())
        # Chunk-START states: shifted right by one, the zero state first.
        start = F.pad(S[:, :-1], (0, 0, 1, 0))
        return S, start.reshape(Bb, NC, H, chan).float()

    SC, Cs = chunk_states(U, dh * dh)
    del U
    Sn, ns = chunk_states(un, dh)
    Cs = Cs.reshape(Bb, NC, H, dh, dh)

    args = (q, k, v, li_p, G, m, Cs, ns)
    if Bb * NC * Lc * Lc * H <= _MLSTM_INTRA_PARALLEL_MAX_ELEMS:
        h = _chunk_out(*args)
    else:
        h = torch.cat([_chunk_out(*(t[:, c:c + 1] for t in args))
                       for c in range(NC)], dim=1)
    # Copies, not views: a view of the last chunk would keep all NC chunks'
    # states alive in the cache (554 MB a layer at full width, T = 2,100).
    Cf = SC[:, -1].reshape(Bb, H, dh, dh).to(state_dtype, copy=True)
    nf = Sn[:, -1].reshape(Bb, H, dh).to(state_dtype, copy=True)
    return h, (Cf, nf)


def mlstm_forward(params, cfg, x, *, return_cache=False, valid_len=None):
    """x: (B, T, D) -> (y, cache|None).  A prompt pads to a chunk multiple
    with neutral gates (i' = 0: no state update; f' = 1: no decay), so the
    cache for T tokens is exact and pad outputs are sliced off.

    ``valid_len`` (a Python int, prompt bucketing) takes the same neutral
    gates from ``valid_len`` on: the (C, n) state after the whole padded
    scan (K6 at the padded length) is the state after ``valid_len`` steps,
    and the cached stabilizer and conv tail are read at ``valid_len``."""
    dtype = x.dtype
    B, T_in, D = x.shape
    H = cfg.n_heads
    inner = 2 * D
    dh = inner // H
    Lc = min(cfg.mlstm_chunk, T_in)
    T = -(-T_in // Lc) * Lc
    pad = T - T_in
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    NC = T // Lc

    u = x @ params["w_up"].to(dtype)
    z = x @ params["w_gate"].to(dtype)
    c = F.silu(causal_conv1d(params["conv"], u))
    q = blockdiag_apply(params["wq"], c)
    k = blockdiag_apply(params["wk"], c)
    v = blockdiag_apply(params["wv"], u)

    xf = x.float()
    li = xf @ params["w_igate"].float() + params["b_igate"]
    lf = F.logsigmoid(xf @ params["w_fgate"].float() + params["b_fgate"])
    eff_len = T_in if valid_len is None else int(valid_len)
    if pad or valid_len is not None:
        live = (torch.arange(T, device=x.device) < eff_len)[None, :, None]
        li = torch.where(live, li, -1e30)
        lf = torch.where(live, lf, 0.0)
    m = _mlstm_stabilizer(lf, li)

    def split(t, trailing):
        return t.reshape((B, NC, Lc) + trailing)

    h, (Cf, nf) = _mlstm_chunk_scan(
        split(q, (H, dh)), split(k, (H, dh)), split(v, (H, dh)),
        split(lf, (H,)), split(li, (H,)), split(m, (H,)),
        state_dtype=getattr(torch, cfg.mlstm_state_dtype))
    h = h.reshape(B, T, inner).to(dtype)
    h = h + params["skip_scale"].to(dtype) * c
    y = (h * F.silu(z)) @ params["w_down"].to(dtype)
    if pad:
        y = y[:, :T_in]
    cache = None
    if return_cache:
        cache = {"C": Cf, "n": nf, "m": m[:, eff_len - 1].clone(),
                 "conv": _conv_tail(cfg, u[:, :T_in], valid_len).clone()}
    return y, cache


def init_mlstm_cache(cfg, batch, dtype, device):
    inner = 2 * cfg.d_model
    H = cfg.n_heads
    dh = inner // H

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"C": f32(batch, H, dh, dh), "n": f32(batch, H, dh),
            "m": f32(batch, H),
            "conv": torch.zeros((batch, cfg.conv_width - 1, inner),
                                dtype=dtype, device=device)}


def mlstm_decode(params, cfg, x, cache):
    """One-step mLSTM: an O(dh^2) state update into new float32 C, n and
    m, no sequence dimension."""
    dtype = x.dtype
    B, _, D = x.shape
    H = cfg.n_heads
    inner = 2 * D
    dh = inner // H
    u = x @ params["w_up"].to(dtype)
    z = x @ params["w_gate"].to(dtype)
    c, conv_state = conv1d_step(params["conv"], u, cache["conv"])
    c = F.silu(c)
    q = blockdiag_apply(params["wq"], c).reshape(B, H, dh).float() \
        / math.sqrt(dh)
    k = blockdiag_apply(params["wk"], c).reshape(B, H, dh)
    v = blockdiag_apply(params["wv"], u).reshape(B, H, dh)
    xf = x[:, 0].float()
    li = xf @ params["w_igate"].float() + params["b_igate"]
    lf = F.logsigmoid(xf @ params["w_fgate"].float() + params["b_fgate"])
    m_new = torch.maximum(lf + cache["m"], li)
    fp = torch.exp(lf + cache["m"] - m_new)
    ip = torch.exp(li - m_new)
    kf, vf = k.float(), v.float()
    C_new = fp[..., None, None] * cache["C"] + ip[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n_new = fp[..., None] * cache["n"] + ip[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    qn = torch.einsum("bhd,bhd->bh", q, n_new)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    h = (num / denom[..., None]).reshape(B, 1, inner).to(dtype)
    h = h + params["skip_scale"].to(dtype) * c
    y = (h * F.silu(z)) @ params["w_down"].to(dtype)
    return y, {"C": C_new, "n": n_new, "m": m_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar-memory cell with recurrent gate inputs
# ---------------------------------------------------------------------------


def init_slstm_block(gen, cfg, dtype=torch.float32):
    """The gate bias stays float32 whatever ``dtype``."""
    d = cfg.d_model
    ff = int(d * 4 / 3 / 64) * 64 or 64
    return {
        "w_in": L.dense_init(gen, (d, 4, d), 0, dtype),       # z, i, f, o
        # One block-diagonal recurrent matrix per gate (h_{t-1} -> gate).
        "r": torch.stack([init_blockdiag(gen, cfg.n_heads, d, dtype)
                          for _ in range(4)]),
        "bias": torch.zeros((4, d), dtype=torch.float32, device=gen.device),
        "w_out": L.dense_init(gen, (d, d), 0, dtype),
        "ffn": L.init_mlp(gen, d, ff, "gelu", dtype),
    }


def _slstm_cell(params, xg, carry):
    """One timestep.  xg: (B, 4, D) float32 pre-activations from the input;
    carry: the float32 c, n, h, m.  The four gates' block-diagonal
    recurrent products are one batched product over the 4 H blocks of
    ``r`` (4, H, p, p) as they lie, h broadcast over the gates: each output
    the reference's dot over p in the same dtype."""
    c, n, h, m = carry["c"], carry["n"], carry["h"], carry["m"]
    r = params["r"]
    B, D = h.shape
    G, H, p, _ = r.shape
    hd = h.to(r.dtype).reshape(B, H, p).transpose(0, 1)         # (H, B, p)
    rec = torch.matmul(hd, r).permute(2, 0, 1, 3)               # (B, 4, H, p)
    g = xg + rec.reshape(B, G, D).float() + params["bias"]
    zt = torch.tanh(g[:, 0])
    li = g[:, 1]
    lf = F.logsigmoid(g[:, 2])
    ot = torch.sigmoid(g[:, 3])
    lfm = lf + m
    m_new = torch.maximum(lfm, li)
    ip = torch.exp(li - m_new)
    fp = torch.exp(lfm - m_new)
    c_new = fp * c + ip * zt
    n_new = fp * n + ip
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_inputs(params, x):
    """x: (B, T, D) -> the gates' input pre-activations (B, T, 4, D) in
    float32 (the product rounds to x's dtype first, as the reference's)."""
    B, T, D = x.shape
    w = params["w_in"].to(x.dtype).reshape(D, 4 * D)
    return (x @ w).reshape(B, T, 4, D).float()


def slstm_forward(params, cfg, x, *, return_cache=False, valid_len=None):
    """x: (B, T, D) -> (y, cache|None); the cell runs once per step.

    ``valid_len`` (a Python int, prompt bucketing): the carry is frozen
    from ``valid_len`` on, so the cache is the state after ``valid_len``
    steps.  A frozen step's output is the frozen carry's h, as the
    reference's masked scan gives, so the cell does not run there."""
    dtype = x.dtype
    T = x.shape[1]
    steps = T if valid_len is None else min(int(valid_len), T)
    xg = _slstm_inputs(params, x)
    carry = init_slstm_cache(cfg, x.shape[0], x.device)
    hs = []
    # The loop's host time is a profiler range of its own ("slstm loop").
    with torch.profiler.record_function("slstm loop"):
        for t in range(steps):
            carry = _slstm_cell(params, xg[:, t], carry)
            hs.append(carry["h"])
    hs += [carry["h"]] * (T - steps)
    h = torch.stack(hs, dim=1).to(dtype)                       # (B, T, D)
    y = h @ params["w_out"].to(dtype)
    y = y + L.mlp(params["ffn"], y, "gelu")
    return y, (carry if return_cache else None)


def init_slstm_cache(cfg, batch, device):
    return {key: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=device) for key in ("c", "n", "h", "m")}


def slstm_decode(params, cfg, x, cache):
    dtype = x.dtype
    new = _slstm_cell(params, _slstm_inputs(params, x)[:, 0], cache)
    y = new["h"][:, None].to(dtype) @ params["w_out"].to(dtype)
    y = y + L.mlp(params["ffn"], y, "gelu")
    return y, new
