"""Draft-and-verify speculative decoding with an exact-match acceptance rule.

The port of ``repro.serving.strategies.speculative``.  One loop iteration
(a *round*) runs ``k + 1`` substeps.  At substep ``s`` both models decode
the same input token ``x_s`` (``x_0`` = the slot's current token, ``x_{s+1}``
= the draft's proposal ``d_s``):

* the **target** samples its authoritative token ``t_s`` with the engine's
  *untagged* counter key at token index ``emitted + s`` -- the key vanilla
  decoding uses for that token, so the accepted stream is vanilla's at the
  same seeds (a proposal is accepted iff it *equals* the target's token);
* the **draft** samples its proposal ``d_s`` from the
  :data:`~repro_torch.serving.sampling.DRAFT_STREAM`-tagged key at the same
  index, so draft randomness never touches the verify stream.

Acceptance is resolved after the substeps as a batched exclusive ``scan``
over the per-step failure flags (kernel K7s on the card): token ``t_i`` is
valid iff every earlier step matched and no earlier valid token was EOS.
Each round emits between 1 and ``k + 1`` tokens per active slot.

**Cache rollback.**  Each substep keeps a row's cache writes only where its
acceptance chain is still alive.  The port's decode writes every attention
cache in place (one slot a row and leaf, ``pos % L``), so the write cannot
be undone by selecting between an old and a new tree as the reference
does: before each substep the rows it will overwrite are saved
(:func:`~repro_torch.serving.cache.ring_rows`, one slot a row a leaf) and
put back on the rows whose chain broke
(:func:`~repro_torch.serving.cache.commit_rows`); recurrent states, which
come back as new tensors, are selected per row.  A row whose chain broke
still decodes the later substeps, reading its old cache with the current
substep's key written in for the step; its tokens are never emitted
(``prefix_ok`` is false for them) and its writes are rolled back.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import operators as alg
from repro_torch.core import primitives as forge
from repro_torch.core.layout import Batched
from repro_torch.models import lm
from repro_torch.serving import cache as CA
from repro_torch.serving import sampling as SP
from repro_torch.serving.strategies.base import DecodeStrategy, vanilla_admit


class Speculative(DecodeStrategy):
    """Draft-and-verify speculative decoding (``k`` proposals per round).

    ``draft_cfg`` / ``draft_params`` are a model sharing the target's
    vocabulary; its caches ride the same slot machinery in a second tree.
    Output streams equal ``Vanilla``'s at the same seeds: speculation only
    changes how many target decodes a stream costs, never its tokens.
    """

    name = "speculative"

    def __init__(self, draft_cfg, draft_params, *, k: int = 4):
        if k < 1:
            raise ValueError(f"speculative k must be >= 1, got {k}")
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.k = k

    def bind(self, eng):
        if self.draft_cfg.vocab_size != eng.cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {self.draft_cfg.vocab_size} != target "
                f"vocab_size {eng.cfg.vocab_size}: draft proposals must be "
                "target token ids")
        if self.draft_cfg.is_encdec:
            raise ValueError("draft model must be decoder-only")
        if self.draft_cfg.num_prefix_embeds or eng.cfg.num_prefix_embeds:
            raise ValueError(
                "speculative decoding requires num_prefix_embeds == 0 on "
                "both models (position bookkeeping is shared)")
        # On the engine's device; a tensor already there (a draft sharing
        # the target's weights) is the same tensor, not a copy.
        self._params = pytree.tree_map(lambda t: t.to(eng.device),
                                       self.draft_params)

    def loop_params(self, eng):
        return self._params

    def _dft_decode(self, params, caches, toks, pos):
        return lm.decode_step(params, self.draft_cfg, caches, toks, pos)

    def host_prefill(self, eng, toks, valid_len):
        _, dft_caches1 = lm.prefill(self._params, self.draft_cfg, toks,
                                    cache_len=eng.cache_len,
                                    valid_len=valid_len)
        return dft_caches1

    def stats(self, eng, state) -> dict:
        prop = int(state["tot_prop"])
        acc = int(state["tot_acc"])
        return {
            "spec_rounds": int(state["tot_rounds"]),
            "spec_proposed": prop,
            "spec_accepted": acc,
            "spec_acceptance_rate": acc / max(prop, 1),
        }

    def init_state(self, eng) -> dict:
        st = eng._base_state()
        B = eng.batch_size
        st["dft_caches"] = lm.init_caches(
            self.draft_cfg, B, eng.cache_len,
            self.draft_cfg.activation_dtype, eng.device)
        # Per-slot round accounting (reset at admission, drained into the
        # record's meta) and engine-lifetime totals (read once in stats()).
        for key in ("acc", "prop", "rounds"):
            st[key] = torch.zeros((B,), dtype=torch.int32, device=eng.device)
        for key in ("tot_acc", "tot_prop", "tot_rounds"):
            st[key] = torch.zeros((), dtype=torch.int32, device=eng.device)
        return st

    def admit(self, eng, state, caches1, logits1, extras, *, slot, seed,
              max_new, eos, pos0):
        st = vanilla_admit(eng, state, caches1, logits1, slot=slot,
                           seed=seed, max_new=max_new, eos=eos, pos0=pos0)
        st["dft_caches"] = CA.scatter_slot(state["dft_caches"], extras, slot)
        for key in ("acc", "prop", "rounds"):
            st[key][slot] = 0
        return st

    def step(self, eng, params, sparams, st):
        B, S, T = eng.batch_size, self.k + 1, eng.max_new_cap
        dev = eng.device
        was_active = st["active"]
        e0 = st["emitted"]
        dkey = SP.stream_key(eng._base_key, SP.DRAFT_STREAM)

        tgt_c, dft_c = st["caches"], st["dft_caches"]
        x, pos = st["tok"], st["pos"]
        accepting = torch.ones((B,), dtype=torch.bool, device=dev)
        ts, lps, ms = [], [], []
        for s in range(S):
            saved_t, saved_d = CA.ring_rows(tgt_c, pos), CA.ring_rows(dft_c,
                                                                      pos)
            logits_t, tgt_c2 = eng._decode(params, tgt_c, x[:, None], pos)
            logits_d, dft_c2 = self._dft_decode(sparams, dft_c, x[:, None],
                                                pos)
            t = eng._sample(eng._base_key, logits_t, st["seeds"], e0 + s)
            lp = SP.chosen_logprobs(logits_t, t)
            d = eng._sample(dkey, logits_d, st["seeds"], e0 + s)
            # Keep the step's cache writes only where the acceptance chain
            # is still alive -- this IS the rollback.
            commit = accepting & was_active
            tgt_c = CA.commit_rows(commit, tgt_c2, tgt_c, saved_t, pos)
            dft_c = CA.commit_rows(commit, dft_c2, dft_c, saved_d, pos)
            x, pos = d, pos + commit
            accepting = accepting & (t == d)
            ts.append(t)
            lps.append(lp)
            ms.append(t == d)
        ts, lps, ms = (torch.stack(v, dim=1) for v in (ts, lps, ms))

        # Validity: t_i is authoritative iff every earlier step matched and
        # no earlier valid token was EOS -- the batched exclusive scan over
        # the failure flags.  t_0 is always valid: its prefix holds none.
        fail = (~(ms & (ts != st["eos"][:, None]))).to(torch.int32)
        prefix_ok = forge.scan(alg.ADD, fail, inclusive=False,
                               layout=Batched()) == 0
        idx = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        rem = (st["max_new"] - e0)[:, None]
        emit = prefix_ok & (idx < rem) & was_active[:, None]
        n_emit = emit.sum(dim=1).to(torch.int32)

        # Ragged append into the (B, T) output buffers: a where over a
        # gather, never a scatter with duplicate indices.
        rel = torch.arange(T, dtype=torch.int32, device=dev)[None, :] \
            - e0[:, None]
        take = (rel >= 0) & (rel < n_emit[:, None])
        src = torch.clamp(rel, 0, S - 1).long()
        out = torch.where(take, torch.gather(ts, 1, src), st["out"])
        logps = torch.where(take, torch.gather(lps, 1, src), st["logps"])

        emitted = e0 + n_emit
        hit_eos = (emit & (ts == st["eos"][:, None])).any(dim=1)
        hit_cap = emitted >= st["max_new"]
        last = torch.gather(
            ts, 1, torch.clamp(n_emit - 1, 0, S - 1).long()[:, None])[:, 0]

        accepted = torch.where(was_active, n_emit - 1, 0).to(torch.int32)
        act = was_active.to(torch.int32)
        new = dict(st)
        new["caches"] = tgt_c
        new["dft_caches"] = dft_c
        new["tok"] = torch.where(was_active, last, st["tok"])
        new["pos"] = pos
        new["emitted"] = emitted
        new["active"] = was_active & ~hit_eos & ~hit_cap
        new["out"] = out
        new["logps"] = logps
        new["acc"] = st["acc"] + accepted
        new["prop"] = st["prop"] + self.k * act
        new["rounds"] = st["rounds"] + act
        new["tot_acc"] = st["tot_acc"] + accepted.sum()
        new["tot_prop"] = st["tot_prop"] + self.k * act.sum()
        new["tot_rounds"] = st["tot_rounds"] + act.sum()
        return new

    def outputs(self, eng, state):
        return {
            "out": state["out"], "emitted": state["emitted"],
            "seq_logprob": SP.masked_seq_logprobs(
                state["logps"], state["emitted"]),
            "meta": {"spec_accepted": state["acc"],
                     "spec_proposed": state["prop"],
                     "spec_rounds": state["rounds"]},
        }
