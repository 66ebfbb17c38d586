"""Grammar-constrained sampling: a token-level DFA masks the vocabulary.

The port of ``repro.serving.strategies.constrained``.  The grammar is
compiled (offline, by the caller) to a token-level DFA over two dense
tables:

* ``allowed``: (n_states, V) bool -- which tokens may be emitted from each
  state;
* ``transitions``: (n_states, V) int32 -- the state reached after emitting
  each token.

Each slot carries its DFA state; every step gathers its state's ``allowed``
row and masks the logits to ``-inf`` outside it *before* the ordinary
sampler runs, so the masked logits flow through the same top-k and nucleus
path as vanilla sampling: a logits transform, not a sampler fork.  The
first token is constrained too: admission masks the prefill logits with the
start state's row.  ``seq_logprob`` is the sequence's log-probability under
the masked (renormalized) distribution, the one that was sampled from.

The tables are validated on the host at construction: every state must
allow at least one token, and transitions must stay in range.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.strategies.base import Vanilla, vanilla_admit


class Constrained(Vanilla):
    """DFA-constrained sampling on the vanilla state layout (the DFA state
    is one more (B,) int32 in the state)."""

    name = "constrained"

    def __init__(self, allowed, transitions, *, start_state: int = 0):
        allowed = np.asarray(allowed, bool)
        transitions = np.asarray(transitions, np.int32)
        if allowed.ndim != 2 or transitions.shape != allowed.shape:
            raise ValueError(
                f"allowed {allowed.shape} and transitions "
                f"{transitions.shape} must both be (n_states, vocab)")
        n_states = allowed.shape[0]
        dead = np.where(~allowed.any(axis=1))[0]
        if dead.size:
            raise ValueError(
                f"DFA states {dead.tolist()} allow no token: every state "
                "must keep at least one continuation or sampling would "
                "pick an argmax over an all-masked vocabulary")
        if transitions.min() < 0 or transitions.max() >= n_states:
            raise ValueError(
                f"transitions must map into [0, {n_states}); got range "
                f"[{transitions.min()}, {transitions.max()}]")
        if not 0 <= start_state < n_states:
            raise ValueError(
                f"start_state {start_state} outside [0, {n_states})")
        self.start_state = start_state
        self._allowed = torch.from_numpy(allowed)
        self._trans = torch.from_numpy(transitions)

    def bind(self, eng):
        if self._allowed.shape[1] != eng.cfg.vocab_size:
            raise ValueError(
                f"DFA tables cover a vocab of {self._allowed.shape[1]} but "
                f"the model's vocab_size is {eng.cfg.vocab_size}")
        self._allowed = self._allowed.to(eng.device)
        self._trans = self._trans.to(eng.device)

    def init_state(self, eng) -> dict:
        st = eng._base_state()
        st["cstate"] = torch.full((eng.batch_size,), self.start_state,
                                  dtype=torch.int32, device=eng.device)
        return st

    def admit(self, eng, state, caches1, logits1, extras, *, slot, seed,
              max_new, eos, pos0):
        logits1 = torch.where(self._allowed[self.start_state][None, :],
                              logits1, float("-inf"))
        st = vanilla_admit(eng, state, caches1, logits1, slot=slot,
                           seed=seed, max_new=max_new, eos=eos, pos0=pos0)
        st["cstate"][slot] = self._trans[self.start_state,
                                         st["tok"][slot].long()]
        return st

    def _adjust_logits(self, eng, st, logits):
        return torch.where(self._allowed[st["cstate"].long()], logits,
                           float("-inf"))

    def _post_step(self, eng, st, new, nxt, was_active):
        new["cstate"] = torch.where(
            was_active, self._trans[st["cstate"].long(), nxt.long()],
            st["cstate"])
        return new
