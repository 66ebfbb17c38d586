"""Deterministic beam search on the slot cache and the sort primitives.

The port of ``repro.serving.strategies.beam``.  A slot holds ``width``
beams: the cache tree is allocated at ``batch_size * width`` rows and slot
``b``'s beams live at rows ``b*width .. (b+1)*width - 1`` -- admission
broadcasts the batch-1 prefill ``width`` ways into those rows through the
ordinary slot scatter, and the per-round beam reorder is one gather over
the slot axis (:func:`repro_torch.serving.cache.gather_slots`, in place, a
leaf at a time).

Each round scores every ``beam x vocab`` continuation and ranks the
``width * V`` candidates per slot with ONE ``sort_pairs`` under
``Segmented(offsets=...)`` -- the slots are equal-width contiguous segments
of the flat candidate stream (the stable LSD radix sort over f32 keys, so
the -inf of dead beams orders deterministically; kernels K2, K4 and K6 on
the card).  The top ``2*width`` candidates are kept: each source beam has
at most one EOS continuation, so at least ``width`` non-EOS candidates
survive.  EOS candidates move to the per-slot finished store (merged with
the incumbents by a second segmented ``sort_pairs`` over the ``3*width``
pool); non-EOS candidates become the next beams, their rank among non-EOS
candidates a batched exclusive ``scan`` over the non-EOS flags (K7s).

Ties are the reference's: ascending stable sort read backwards, so equal
scores prefer the *higher* candidate id; the final answer prefers finished
over continuing hypotheses at equal score.  Beam search maximizes a score:
``bind`` refuses ``temperature > 0``.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import operators as alg
from repro_torch.core import primitives as forge
from repro_torch.core.layout import Batched, Flat, Segmented
from repro_torch.serving import cache as CA
from repro_torch.serving.strategies.base import DecodeStrategy

NEG_INF = float("-inf")


def _sort_rows(keys, values):
    """Per-row stable ascending ``sort_pairs`` of a (B, N) batch, as one
    segmented sort over the flat ``B * N`` stream (equal-width contiguous
    segments)."""
    B, N = keys.shape
    seg = Segmented(offsets=torch.arange(
        B + 1, dtype=torch.int32, device=keys.device) * N)
    sk, sv = forge.sort_pairs(keys.reshape(B * N).contiguous(),
                              values.reshape(B * N).contiguous(), layout=seg)
    return sk.reshape(B, N), sv.reshape(B, N)


def _take(x, idx):
    """``take_along_axis`` on axis 1, the index broadcast over x's trailing
    axes."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.ndim - idx.ndim))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


class BeamSearch(DecodeStrategy):
    """Beam search over the continuous-batching engine (``width`` beams per
    slot).  A request finishes when its finished store dominates the best
    continuation, or at the length cap; the answer is the highest-scoring
    hypothesis (finished preferred on ties), its score ``seq_logprob``.

    ``length_penalty`` is the GNMT alpha: hypotheses are ranked by
    ``logprob / lp(|y|)`` with ``lp(n) = ((5 + n) / 6) ** alpha``.  Live
    beams carry raw cumulative log-probabilities; the divide happens where
    lengths differ -- at finished-pool insertion, in the stop rule, and when
    live continuations enter the final answer pool.  ``alpha=0`` skips the
    penalty code entirely."""

    name = "beam"

    def __init__(self, width: int = 4, length_penalty: float = 0.0):
        if width < 1:
            raise ValueError(f"beam width must be >= 1, got {width}")
        if length_penalty < 0:
            raise ValueError(
                f"length_penalty must be >= 0, got {length_penalty}")
        self.width = width
        self.length_penalty = float(length_penalty)

    def _lp(self, length):
        """GNMT length penalty ``((5 + |y|) / 6) ** alpha`` in float32."""
        return ((5.0 + length.to(torch.float32)) / 6.0) \
            ** self.length_penalty

    def bind(self, eng):
        if eng.temperature > 0:
            raise ValueError(
                "beam search is deterministic: construct the Engine with "
                f"temperature=0 (got temperature={eng.temperature})")

    def init_state(self, eng) -> dict:
        B, W, T = eng.batch_size, self.width, eng.max_new_cap
        dev = eng.device

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return {
            "caches": eng._cache_zeros(B * W),
            "scores": full((B, W), NEG_INF, torch.float32),
            "btok": full((B, W), 0, torch.int32),
            "hyp": full((B, W, T), 0, torch.int32),
            "fin_scores": full((B, W), NEG_INF, torch.float32),
            "fin_toks": full((B, W, T), 0, torch.int32),
            "fin_lens": full((B, W), 0, torch.int32),
            "pos": full((B,), 0, torch.int32),
            "emitted": full((B,), 0, torch.int32),
            "active": full((B,), False, torch.bool),
            "max_new": full((B,), 0, torch.int32),
            "eos": full((B,), -1, torch.int32),
        }

    def admit(self, eng, state, caches1, logits1, extras, *, slot, seed,
              max_new, eos, pos0):
        W, T = self.width, eng.max_new_cap
        # The batch-1 prefill into rows slot*W .. slot*W+W-1, broadcast
        # (``expand``: no copy of the prefilled cache).
        st = dict(state)
        st["caches"] = CA.scatter_slot(
            state["caches"],
            pytree.tree_map(lambda l: l.expand((W,) + l.shape[1:]),
                            caches1), slot * W)

        # The top-W first tokens of the prompt's distribution seed the W
        # beams.
        logp = torch.log_softmax(logits1.float(), dim=-1)[0]
        vals, idx = forge.top_k(logp.contiguous(), W, layout=Flat())
        idx = idx.to(torch.int32)
        is_eos = idx == eos
        cont = torch.where(is_eos, NEG_INF, vals)
        st["scores"][slot] = cont
        st["btok"][slot] = idx
        hyp0 = torch.zeros((W, T), dtype=torch.int32, device=eng.device)
        hyp0[:, 0] = idx
        st["hyp"][slot] = hyp0
        # lp(1) == 1.0 exactly: admission-round EOS scores need no divide.
        fin = torch.where(is_eos, vals, NEG_INF)
        st["fin_scores"][slot] = fin
        st["fin_toks"][slot] = hyp0
        st["fin_lens"][slot] = is_eos.to(torch.int32)
        st["pos"][slot] = pos0
        st["emitted"][slot] = 1
        st["max_new"][slot] = max_new
        st["eos"][slot] = eos
        max_cont = cont.max()
        stop = (max_cont == NEG_INF) | (fin.min() >= max_cont)
        st["active"][slot] = (max_new > 1) & ~stop
        return st

    def step(self, eng, params, sparams, st):
        B, W, T = eng.batch_size, self.width, eng.max_new_cap
        dev = eng.device
        was_active = st["active"]
        bidx = torch.arange(B, dtype=torch.int32, device=dev)

        # Decode every beam row; score all beam x vocab continuations.
        pos_rows = st["pos"].repeat_interleave(W)
        rows_active = was_active.repeat_interleave(W)
        saved = CA.ring_rows(st["caches"], pos_rows)
        logits, caches2 = eng._decode(
            params, st["caches"], st["btok"].reshape(B * W, 1), pos_rows)
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        cand = (st["scores"][:, :, None] + logp.reshape(B, W, V)
                ).reshape(B, W * V)

        # ONE segmented sort ranks each slot's W*V candidates; the last 2W
        # columns, read backwards, are the top 2W descending (ties: the
        # higher candidate id).
        ids = torch.arange(W * V, dtype=torch.int32, device=dev)[None, :] \
            .expand(B, W * V)
        skeys, sids = _sort_rows(cand, ids)
        top_s = skeys[:, -2 * W:].flip(1)                    # (B, 2W) desc
        top_i = sids[:, -2 * W:].flip(1)
        c_src = torch.div(top_i, V, rounding_mode="floor")
        c_tok = top_i % V
        c_eos = c_tok == st["eos"][:, None]

        # Continuing beams: the first W non-EOS candidates, each one's rank
        # among them the batched exclusive scan over the non-EOS flags.
        rank = forge.scan(alg.ADD, (~c_eos).to(torch.int32).contiguous(),
                          inclusive=False, layout=Batched())
        keep = ~c_eos & (rank < W)
        dest = torch.where(keep, rank, W).long()            # W: spill column

        def place(vals, fill, dtype):
            buf = torch.full((B, W + 1), fill, dtype=dtype, device=dev)
            return buf.scatter(1, dest, torch.where(
                keep, vals, torch.full_like(vals, fill)).to(dtype))[:, :W]

        new_scores = place(top_s, NEG_INF, torch.float32)
        new_btok = place(c_tok, 0, torch.int32)
        new_src = place(c_src, 0, torch.int32)

        # Beam reorder: each surviving beam inherits the advanced cache of
        # the beam it extends -- a gather over the slot axis, identity on
        # inactive slots.
        ident = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        src_rows = torch.where(was_active[:, None],
                               bidx[:, None] * W + new_src,
                               bidx[:, None] * W + ident).reshape(B * W)
        caches3 = CA.gather_slots(caches2, src_rows)

        # Hypothesis buffers follow the same reorder and append.
        hyp_g = _take(st["hyp"], new_src)
        at_t = (torch.arange(T, dtype=torch.int32, device=dev)[None, None, :]
                == st["emitted"][:, None, None])
        new_hyp = torch.where(at_t, new_btok[:, :, None], hyp_g)

        # Finished store: merge incumbents (pool ids 0..W-1) with this
        # round's EOS candidates (ids W..3W-1, non-EOS masked to -inf) and
        # keep the top W -- the round's second segmented sort.
        cand_hyp = torch.where(at_t, c_tok[:, :, None],
                               _take(st["hyp"], c_src))
        fin_cand = top_s
        if self.length_penalty:
            # An EOS candidate finishes at emitted + 1 tokens; incumbents
            # are stored normalized already.
            fin_cand = top_s / self._lp(st["emitted"] + 1)[:, None]
        pool_s = torch.cat(
            [st["fin_scores"], torch.where(c_eos, fin_cand, NEG_INF)], dim=1)
        pool_ids = torch.arange(3 * W, dtype=torch.int32,
                                device=dev)[None, :].expand(B, 3 * W)
        pkeys, pids = _sort_rows(pool_s, pool_ids)
        fin_sel = pids[:, -W:].flip(1)                       # (B, W) desc
        fin_scores2 = pkeys[:, -W:].flip(1)
        pool_toks = torch.cat([st["fin_toks"], cand_hyp], dim=1)
        pool_lens = torch.cat(
            [st["fin_lens"], (st["emitted"] + 1)[:, None].expand(B, 2 * W)],
            dim=1)
        fin_toks2 = _take(pool_toks, fin_sel)
        fin_lens2 = _take(pool_lens, fin_sel)

        emitted2 = st["emitted"] + 1
        max_cont = new_scores[:, 0]                          # desc order
        min_fin = fin_scores2[:, -1]
        max_cont_n = max_cont
        if self.length_penalty:
            # The stored finished scores are normalized: normalize the best
            # continuation at its current length to compare like with like.
            max_cont_n = max_cont / self._lp(emitted2)
        stop = (min_fin >= max_cont_n) | (max_cont == NEG_INF)
        active2 = was_active & (emitted2 < st["max_new"]) & ~stop

        # Commit only on active slots: the step decodes dead rows too, but
        # their state stays frozen for the drain (the decode's in-place
        # cache writes on those rows are rolled back, one slot a row).
        def commit(nw, old):
            m = was_active.reshape((B,) + (1,) * (nw.ndim - 1))
            return torch.where(m, nw, old)

        new = dict(st)
        new["caches"] = CA.commit_rows(rows_active, caches3, st["caches"],
                                       saved, pos_rows)
        new["scores"] = commit(new_scores, st["scores"])
        new["btok"] = commit(new_btok, st["btok"])
        new["hyp"] = commit(new_hyp, st["hyp"])
        new["fin_scores"] = commit(fin_scores2, st["fin_scores"])
        new["fin_toks"] = commit(fin_toks2, st["fin_toks"])
        new["fin_lens"] = commit(fin_lens2, st["fin_lens"])
        new["pos"] = st["pos"] + was_active
        new["emitted"] = commit(emitted2, st["emitted"])
        new["active"] = active2
        return new

    def outputs(self, eng, state):
        B, W = eng.batch_size, self.width
        # Answer pool: finished hypotheses first (argmax's first maximum
        # prefers finished at equal score), then live continuations (the
        # length-cap fallback).
        live_s = state["scores"]
        if self.length_penalty:
            live_s = live_s / self._lp(state["emitted"])[:, None]
        all_s = torch.cat([state["fin_scores"], live_s], dim=1)
        all_t = torch.cat([state["fin_toks"], state["hyp"]], dim=1)
        all_l = torch.cat([state["fin_lens"],
                           state["emitted"][:, None].expand(B, W)], dim=1)
        best = torch.argmax(all_s, dim=1)[:, None]
        return {"out": _take(all_t, best)[:, 0],
                "emitted": _take(all_l, best)[:, 0],
                "seq_logprob": _take(all_s, best)[:, 0]}

    def poison(self, eng, caches, slot):
        for w in range(self.width):
            caches = CA.poison_slot(caches, slot * self.width + w)
        return caches
