"""The causal LM and the encoder-decoder: parameters, the training
forward, prefill and one-token decode.

The port of ``repro.models.lm``.  The layer stack is
``prefix + unit * n_units + suffix`` (configs); where the reference stacks
the ``units`` parameters on a leading axis and runs them with ``lax.scan``,
the port keeps a list of per-unit tuples and runs a Python loop.  Caches
mirror the same layout: ``{"prefix": [...], "units": [(...), ...],
"suffix": [...]}``, every leaf leading with the batch (slot) axis.  An
encoder-decoder (``cfg.is_encdec``) has an encoder stack of
``n_enc_layers`` bidirectional ``enc_attn`` blocks, run once a prefill
over ``src_embeds``, whose normed output every decoder ``dec_attn`` block
attends over.

* ``init_params(cfg, seed=..., device=...)`` -> params
* ``forward_train(params, cfg, batch, remat=...)`` -> (loss, metrics), the
  loss a tensor that ``torch.autograd`` differentiates; ``remat`` ("full",
  "dots" or "none") recomputes each unit of the stack in the backward as
  the reference's ``jax.checkpoint`` of its unit body does, changing no
  result
* ``prefill(params, cfg, tokens, cache_len=..., src_embeds=None,
  vision_embeds=None, valid_len=None)`` -> (last_logits, caches)
* ``decode_step(params, cfg, caches, tokens, pos)`` -> (logits, caches)
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as ckpt

from repro_torch.core import intrinsics as ki
from repro_torch.devices import resolve_device
from repro_torch.models import blocks as BK
from repro_torch.models import layers as L

Pytree = Any


def _dec_spec(cfg):
    return (tuple(cfg.prefix), tuple(cfg.unit), cfg.n_units, tuple(cfg.suffix))


def _enc_spec(cfg):
    return ((), ("enc_attn",), cfg.n_enc_layers, ())


def _init_stack(gen, spec, cfg, dtype):
    prefix, unit, n_units, suffix = spec
    return {
        "prefix": tuple(BK.init_block(gen, k, cfg, dtype) for k in prefix),
        "units": [tuple(BK.init_block(gen, k, cfg, dtype) for k in unit)
                  for _ in range(n_units)],
        "suffix": tuple(BK.init_block(gen, k, cfg, dtype) for k in suffix),
    }


def _acc(a, b):
    return {k: a[k] + b[k] for k in a}


# Matrix products whose outputs remat="dots" keeps (aten's forms of
# ``@`` and ``einsum``); everything else is recomputed.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat):
    """``fn`` recomputed in the backward: "full" keeps none of its
    activations (``torch.utils.checkpoint``, non-reentrant), "dots" keeps
    the matrix products' outputs and recomputes the rest, "none" is
    ``fn``.  The recomputation runs under the forward's ``use_backend``
    scope, which the backward's thread does not see."""
    if remat == "none":
        return fn
    backend = ki.scoped_backend()

    def pinned(*args):
        if backend is None:
            return fn(*args)
        with ki.use_backend(backend):
            return fn(*args)

    if remat == "full":
        return functools.partial(ckpt.checkpoint, pinned,
                                 use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, pinned, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be 'full', 'dots' or 'none', got "
                     f"{remat!r}")


def _run_stack(params, spec, cfg, h, *, mode, caches=None,
               pos=None, cache_len=0, enc_out=None, valid_len=None,
               remat="none"):
    """Returns (h, new_caches, aux); new_caches is None in train mode, aux
    the blocks' MoE losses summed from ``BK.ZERO_AUX``.  ``valid_len``:
    prefill's valid leading length (prompt bucketing); ``remat``: in train
    mode, how each unit is recomputed in the backward (``_remat``)."""
    prefix, unit, n_units, suffix = spec
    new = {"prefix": [], "units": [], "suffix": []}
    aux = dict(BK.ZERO_AUX)

    def run(p, kind, x, c):
        return BK.block_forward(p, kind, cfg, x, mode=mode, cache=c,
                                pos=pos, cache_len=cache_len,
                                enc_out=enc_out, valid_len=valid_len)

    def cache_of(part, i, j=None):
        if mode != "decode":
            return None
        c = caches[part][i]
        return c if j is None else c[j]

    def unit_body(up, x):
        # One unit in train mode: its output and its own aux.
        ax = dict(BK.ZERO_AUX)
        for j, kind in enumerate(unit):
            x, _, a = run(up[j], kind, x, None)
            ax = _acc(ax, a)
        return x, ax["lb_loss"], ax["router_z"]

    for i, kind in enumerate(prefix):
        h, nc, ax = run(params["prefix"][i], kind, h, cache_of("prefix", i))
        aux = _acc(aux, ax)
        new["prefix"].append(nc)
    for u in range(n_units):
        if mode == "train":
            h, lb, rz = _remat(unit_body, remat)(params["units"][u], h)
            aux = _acc(aux, {"lb_loss": lb, "router_z": rz})
            continue
        ncs = []
        for j, kind in enumerate(unit):
            h, nc, ax = run(params["units"][u][j], kind, h,
                            cache_of("units", u, j))
            aux = _acc(aux, ax)
            ncs.append(nc)
        new["units"].append(tuple(ncs))
    for i, kind in enumerate(suffix):
        h, nc, ax = run(params["suffix"][i], kind, h, cache_of("suffix", i))
        aux = _acc(aux, ax)
        new["suffix"].append(nc)
    return h, (new if mode != "train" else None), aux


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
    training's).  An encoder-decoder's tree adds the ``encoder`` stack and
    its ``enc_norm``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    d = cfg.d_model
    params = {
        "embed": L.init_embed(gen, cfg.vocab_size, d, cfg.tie_embeddings,
                              dtype),
        "decoder": _init_stack(gen, _dec_spec(cfg), cfg, dtype),
        "final_norm": L.init_rmsnorm(d, gen.device),
    }
    if cfg.is_encdec:
        params["encoder"] = _init_stack(gen, _enc_spec(cfg), cfg, dtype)
        params["enc_norm"] = L.init_rmsnorm(d, gen.device)
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


def _encode(params, cfg, src_embeds, remat="none"):
    """The encoder over ``src_embeds`` (B, T, d_model), in the activation
    dtype, positions from 0, without caches; then ``enc_norm``."""
    h = src_embeds.to(cfg.activation_dtype)
    h, _, _ = _run_stack(params["encoder"], _enc_spec(cfg), cfg, h,
                         mode="train", remat=remat)
    return L.rmsnorm(params["enc_norm"], h, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def forward_train(params, cfg, batch, *, remat="full", z_loss=1e-4,
                  lb_coef=0.01, mtp_coef=0.3):
    """The training loss of ``batch`` (``tokens`` and ``labels`` (B, S),
    labels < 0 masked; an encoder-decoder's ``src_embeds``, a VLM's
    ``vision_embeds``): the cross entropy with ``z_loss``, plus an MoE
    config's ``lb_coef`` lb_loss and 1e-4 router_z, plus deepseek-v3's
    ``mtp_coef`` multi-token-prediction loss.  Returns (loss, metrics):
    ``ce_loss``, ``lb_loss``, ``router_z``, ``mtp_loss`` where the config
    has the head, and ``loss``, float32 0-d tensors.  The encoder and each
    unit of the decoder are recomputed in the backward as ``remat`` says
    (``_remat``)."""
    tokens, labels = batch["tokens"], batch["labels"]
    enc_out = (_encode(params, cfg, batch["src_embeds"], remat)
               if cfg.is_encdec else None)
    h = _embed_inputs(params, cfg, tokens, batch.get("vision_embeds"))
    n_prefix = h.shape[1] - tokens.shape[1]
    h, _, aux = _run_stack(params["decoder"], _dec_spec(cfg), cfg, h,
                           mode="train", enc_out=enc_out, remat=remat)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if n_prefix:
        h = h[:, n_prefix:]
    logits = L.unembed(params["embed"], h, cfg.final_softcap)
    loss = L.softmax_cross_entropy(logits, labels, z_loss=z_loss)
    del logits
    aux = {k: torch.as_tensor(v, dtype=torch.float32, device=loss.device)
           for k, v in aux.items()}
    total = loss
    metrics = {"ce_loss": loss, **aux}
    if cfg.n_experts:
        total = total + lb_coef * aux["lb_loss"] + 1e-4 * aux["router_z"]
    if cfg.mtp_depth:
        mtp_loss = _mtp_loss(params, cfg, h, tokens, labels)
        total = total + mtp_coef * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    metrics["loss"] = total
    return total, metrics


def _mtp_loss(params, cfg, h, tokens, labels):
    """DeepSeek-V3's multi-token prediction at depth 1: h_t with the
    embedding of token t + 1, through one extra causal block, predicts
    token t + 2."""
    dtype = cfg.activation_dtype
    mp = params["mtp"]
    h_in = L.rmsnorm(mp["norm_h"], h[:, :-1], cfg.norm_eps)
    e_next = L.embed(params["embed"], tokens[:, 1:], cfg.embed_scale, dtype)
    e_next = L.rmsnorm(mp["norm_e"], e_next, cfg.norm_eps)
    hm = torch.cat([h_in, e_next], dim=-1)
    hm = torch.einsum("bsd,de->bse", hm, mp["proj"].to(dtype))
    kind = "mla_dense" if cfg.use_mla else "attn_global"
    hm, _, _ = BK.block_forward(mp["block"], kind, cfg, hm, mode="train")
    hm = L.rmsnorm(mp["final_norm"], hm, cfg.norm_eps)
    logits = L.unembed(params["embed"], hm, cfg.final_softcap)
    return L.softmax_cross_entropy(logits, labels[:, 1:])


def prefill(params, cfg, tokens, *, cache_len, src_embeds=None,
            vision_embeds=None, valid_len=None):
    """Full-sequence forward over ``tokens`` (B, S), behind the prefix
    ``vision_embeds`` where given, building decode caches.  An
    encoder-decoder first encodes ``src_embeds`` (B, T, d_model); its
    decoder's caches hold the self attention's k and v and the cross
    attention's over the T frames.

    ``valid_len`` (a Python int): the number of valid leading *token*
    positions when ``tokens`` is right-padded to a bucket length.  The
    caches and the logits are then those of a ``valid_len``-token prefill
    (causality keeps the pads out of every valid position; the cache
    snapshots and the logit read move to ``valid_len``, after the prefix).
    None: every position is valid, and the logits are the last token's.
    Returns (last_logits (B, vocab) float32, caches)."""
    enc_out = _encode(params, cfg, src_embeds) if cfg.is_encdec else None
    h = _embed_inputs(params, cfg, tokens, vision_embeds)
    n_prefix = h.shape[1] - tokens.shape[1]
    vl = None if valid_len is None else int(valid_len) + n_prefix
    h, caches, _ = _run_stack(params["decoder"], _dec_spec(cfg), cfg, h,
                              mode="prefill", cache_len=cache_len,
                              enc_out=enc_out, valid_len=vl)
    h_last = h[:, -1:] if vl is None else h[:, vl - 1:vl]
    h = L.rmsnorm(params["final_norm"], h_last, cfg.norm_eps)
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
    (continuous batching: each row advances through its own cache slot),
    or one position for every row of an aligned batch (a Python int or a
    0-d tensor: the padded path).  An encoder-decoder's cross caches come
    from its prefill.  Returns (logits (B, vocab) float32, new_caches)."""
    h = L.embed(params["embed"], tokens, cfg.embed_scale,
                cfg.activation_dtype)
    h, new_caches, _ = _run_stack(params["decoder"], _dec_spec(cfg), cfg,
                                  h, mode="decode", caches=caches, pos=pos)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = L.unembed(params["embed"], h, cfg.final_softcap)
    return logits[:, 0], new_caches
