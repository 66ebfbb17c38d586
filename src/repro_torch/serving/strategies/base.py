"""The decoding-strategy interface and the default greedy strategy.

The port of ``DecodeStrategy``, ``vanilla_admit`` and ``Vanilla`` from
``repro.serving.strategies.base``; speculative decoding, beam search and
constrained sampling (this package's other modules) implement the same
interface.  A strategy owns the policy-shaped part
of the engine's state: what happens at admission, what one decode-loop
iteration does (token choice, EOS, log-prob bookkeeping) and how finished
slots render at drain.  The engine keeps the scheduler, prefill admission,
the loop condition and stats.

The reference traces these hooks into jitted device programs; here they run
eagerly on the device's tensors and may update the engine's state tensors
in place (the state belongs to the engine, and no hook reads a tensor after
replacing it).  They never read a value back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.serving import cache as CA
from repro_torch.serving import sampling as SP


class DecodeStrategy:
    """Pluggable decoding policy for the continuous-batching engine."""

    name = "?"

    def bind(self, eng) -> None:
        """Validate the engine config and set up strategy-owned resources."""

    def loop_params(self, eng):
        """Extra parameters handed to ``step`` (none for vanilla)."""
        return ()

    def host_prefill(self, eng, toks, valid_len):
        """Extra prefill work at admission (the draft model's prefill),
        handed to ``admit`` as ``extras``; ``toks`` (1, L) is the prompt
        as prefilled, right-padded to ``valid_len`` where that is not
        None."""
        return ()

    def stats(self, eng, state) -> dict:
        """Strategy-specific entries merged into ``engine.last_stats``."""
        return {}

    def init_state(self, eng) -> dict:
        """The full device-resident state dict.  Required keys the engine
        reads: ``active`` (B,) bool, ``emitted`` and ``max_new`` (B,) int32,
        ``caches``."""
        return eng._base_state()

    def admit(self, eng, state, caches1, logits1, extras, *, slot, seed,
              max_new, eos, pos0) -> dict:
        raise NotImplementedError

    def step(self, eng, params, sparams, st) -> dict:
        """One decode-loop iteration.  Must keep ``active`` honest: the
        engine's loop condition and drain both read it."""
        raise NotImplementedError

    def outputs(self, eng, state) -> dict:
        """Render finished state for drain: ``{"out": (B, T) int32,
        "emitted": (B,) int32, "seq_logprob": (B,) float32}`` plus an
        optional ``"meta"`` dict of per-slot (B,) tensors copied onto each
        completed record's ``meta``."""
        raise NotImplementedError

    def poison(self, eng, caches, slot):
        """Poison a freed slot's cache state (``poison_on_evict``)."""
        return CA.poison_slot(caches, slot)


def vanilla_admit(eng, state, caches1, logits1, *, slot, seed, max_new, eos,
                  pos0):
    """Scatter a prefilled request into ``slot`` and choose its first token
    (token index 0 of its key stream), on the device; the token never visits
    the host."""
    seeds = torch.tensor([seed], dtype=torch.int32, device=eng.device)
    tok1 = eng._sample(eng._base_key, logits1, seeds,
                       torch.zeros_like(seeds))[0]
    lp1 = SP.chosen_logprobs(logits1, tok1[None])[0]
    st = dict(state)
    st["caches"] = CA.scatter_slot(state["caches"], caches1, slot)
    st["tok"][slot] = tok1
    st["pos"][slot] = pos0
    st["emitted"][slot] = 1
    st["active"][slot] = (tok1 != eos) & (max_new > 1)
    st["out"][slot] = 0
    st["out"][slot, 0] = tok1
    st["logps"][slot] = 0.0
    st["logps"][slot, 0] = lp1
    st["seeds"][slot] = seed
    st["max_new"][slot] = max_new
    st["eos"][slot] = eos
    return st


class Vanilla(DecodeStrategy):
    """Greedy / top-k / top-p sampling -- the engine's default policy: one
    decode and one token per loop iteration, per-slot EOS/length-cap
    masking, log-prob accumulation into the (B, T) buffer."""

    name = "vanilla"

    def admit(self, eng, state, caches1, logits1, extras, *, slot, seed,
              max_new, eos, pos0):
        return vanilla_admit(eng, state, caches1, logits1, slot=slot,
                             seed=seed, max_new=max_new, eos=eos, pos0=pos0)

    def _adjust_logits(self, eng, st, logits):
        """Hook: transform the step's logits before the token choice
        (identity here; constrained sampling masks the vocabulary)."""
        return logits

    def _post_step(self, eng, st, new, nxt, was_active):
        """Hook: extend the committed state after the vanilla bookkeeping
        (identity here; constrained sampling advances its DFA state)."""
        return new

    def step(self, eng, params, sparams, st):
        bidx = torch.arange(eng.batch_size, device=eng.device)
        was_active = st["active"]
        logits, caches = eng._decode(
            params, st["caches"], st["tok"][:, None], st["pos"])
        logits = self._adjust_logits(eng, st, logits)
        nxt = eng._sample(eng._base_key, logits, st["seeds"], st["emitted"])
        lp = SP.chosen_logprobs(logits, nxt)
        widx = torch.clamp(st["emitted"], max=eng.max_new_cap - 1).long()
        out, logps = st["out"], st["logps"]
        out[bidx, widx] = torch.where(was_active, nxt, out[bidx, widx])
        logps[bidx, widx] = torch.where(was_active, lp, logps[bidx, widx])
        emitted = st["emitted"] + was_active
        hit_eos = was_active & (nxt == st["eos"])
        hit_cap = emitted >= st["max_new"]
        new = dict(st)
        new["caches"] = caches
        new["tok"] = torch.where(was_active, nxt, st["tok"])
        new["pos"] = st["pos"] + was_active
        new["emitted"] = emitted
        new["active"] = was_active & ~hit_eos & ~hit_cap
        return self._post_step(eng, st, new, nxt, was_active)

    def outputs(self, eng, state):
        return {"out": state["out"], "emitted": state["emitted"],
                "seq_logprob": SP.masked_seq_logprobs(
                    state["logps"], state["emitted"])}
