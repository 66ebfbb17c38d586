"""Mixture-of-Experts with deterministic capacity-based dispatch.

The port of ``repro.models.moe`` (its single-device path; the sharded
expert-parallel branch comes with the distributed layer).  Sort-based
dispatch: token->expert assignments are sorted by expert id (stably), each
assignment takes a position within its expert's capacity-``C`` buffer, the
expert MLPs run as batched products over the ``(E, C, D)`` dispatch buffer,
and assignments past ``C`` are dropped.  Routers: ``softmax`` top-k
(GShard/Mixtral) and ``sigmoid`` (DeepSeek-V3, aux-loss-free, with a
per-expert selection bias).

The router runs in float32 whatever the activation dtype, as the
reference's.  The top-k is a stable descending sort of each token's E
scores, cut at k: ties go to the lower expert id, as ``lax.top_k``'s do.
A token's k weighted expert outputs are summed in the activation dtype in
ascending expert id, the order of the reference's scatter-add over the
stably sorted assignments, one rounding an add; the port never adds them
with atomics, so a prefill repeats to the bit on the card.  Nothing here
reads a value back to the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def init_moe(gen, cfg, dtype=torch.float32):
    """Router and its bias in float32 whatever ``dtype``; E experts' w_in,
    w_out (and w_gate for a gated activation) stacked on a leading axis;
    the shared experts as one MLP ``n_shared_experts`` times as wide."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": L.dense_init(gen, (d, E), 0, torch.float32),
        "router_bias": torch.zeros((E,), dtype=torch.float32,
                                   device=gen.device),
        "w_in": L.dense_init(gen, (E, d, ff), 1, dtype),
        "w_out": L.dense_init(gen, (E, ff, d), 1, dtype),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = L.dense_init(gen, (E, d, ff), 1, dtype)
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, d, ff * cfg.n_shared_experts,
                                 cfg.activation, dtype)
    return p


def _capacity(cfg, T):
    """Slots an expert keeps for ``T`` tokens: ``T k cf / E`` rounded up to
    a multiple of 8, at least 8."""
    C = math.ceil(T * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((C + 7) // 8) * 8)


def route(params, cfg, xf):
    """The router over tokens ``xf`` (T, D).  Returns (logits (T, E) f32,
    probs (T, E), gates (T, k), idx (T, k) int64): the selected experts in
    descending order of their selection score, ties to the lower id."""
    k = cfg.moe_top_k
    logits = xf.float() @ params["router"].float()
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + params["router_bias"][None, :]
        idx = torch.sort(sel, dim=1, descending=True, stable=True)[1][:, :k]
        gates = torch.gather(scores, 1, idx)
        probs = scores / torch.clamp(scores.sum(1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.sort(probs, dim=1, descending=True, stable=True)
        gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def _experts(params, cfg, xbuf):
    """The expert MLPs over the dispatch buffer (E, C, D)."""
    dtype = xbuf.dtype
    h = torch.bmm(xbuf, params["w_in"].to(dtype))
    if "w_gate" in params:
        g = torch.bmm(xbuf, params["w_gate"].to(dtype))
        act = F.silu(g) if cfg.activation == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, params["w_out"].to(dtype))


def dispatch(idx, n_experts, capacity):
    """The capacity dispatch of the assignments ``idx`` (T, k): sorted by
    expert id (stably), each takes the next free slot of its expert's
    ``capacity`` ones, and those past it are dropped.  Returns (pos, keep,
    counts): each assignment's slot and whether it is kept, (T k,) in
    (token, choice) order, and each expert's count of assignments."""
    flat_e = idx.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=idx.device) \
        - starts[flat_e[order]]
    return pos, pos < capacity, counts


def moe_forward(params, cfg, x):
    """x: (B, S, D) -> (y, aux) with aux = {'lb_loss', 'router_z'}."""
    dtype = x.dtype
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xf = x.reshape(T, D)
    logits, probs, gates, idx = route(params, cfg, xf)
    C = _capacity(cfg, T)
    pos, keep, counts = dispatch(idx, E, C)

    # Load-balance aux (Switch): E * sum_e frac_tokens_e * mean_prob_e.
    lb_loss = E * torch.sum(counts.float() / (T * k) * probs.mean(0))
    router_z = torch.logsumexp(logits, dim=-1).square().mean()

    # Each assignment's row of the (E C, D) buffer; a dropped one writes to
    # a row past the buffer's end, which is cut off.
    row = torch.where(keep, idx.reshape(-1) * C + pos, E * C)
    xbuf = torch.zeros((E * C + 1, D), dtype=dtype, device=x.device)
    xbuf[row] = xf.repeat_interleave(k, dim=0)
    y = _experts(params, cfg, xbuf[:E * C].view(E, C, D)).reshape(E * C, D)

    # ---- combine: each token's k contributions in ascending expert id ----
    by_expert = torch.argsort(idx, dim=1)                   # (T, k)
    row = torch.gather(row.view(T, k), 1, by_expert)
    keep = torch.gather(keep.view(T, k), 1, by_expert)
    wgt = (torch.gather(gates, 1, by_expert) * keep).to(dtype)
    contrib = y[torch.clamp(row, max=E * C - 1)].view(T, k, D) * wgt[..., None]
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    out = out.view(B, S, D)
    if cfg.n_shared_experts:
        out = out + L.mlp(params["shared"], x, cfg.activation)
    return out, {"lb_loss": lb_loss, "router_z": router_z}
