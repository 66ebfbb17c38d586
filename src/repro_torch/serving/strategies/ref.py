"""Host-side reference decoders for the strategies.

The port of ``repro.serving.strategies.ref``: slow, obviously-correct
oracles the engine's strategies are held against.  Each drives the
*engine's own* prefill and decode (a batch-1 prefill, as the engine's
admission runs it, then a plain Python loop with numpy control flow), so
the model's numbers are shared and only the decoding policy differs:

* :func:`reference_beam` -- NMT-style beam search with explicit hypothesis
  lists and the device's tie rules (stable ascending sort read backwards:
  equal scores prefer the higher candidate id; finished beats continuing
  at equal score);
* :func:`reference_constrained` -- DFA-masked sampling with the engine's
  own counter-key sampler.

Where the reference decodes one hypothesis at a time at batch 1, these
decode every live hypothesis of a step together in a cache of as many rows
as the strategy's own (``batch_size * width`` for beam search,
``batch_size`` for constrained sampling; rows past the hypotheses hold a
copy of the prompt's cache).  Decode rows are independent, so the results
are the same function; but on the card a product's rounding may depend on
its batch size, and at the engine's row count the oracle's logits are the
engine's to the bit.  Scores are summed in float32, as on the device.

Speculative decoding needs no oracle of its own: its acceptance rule is
lossless, so its reference is the vanilla engine itself.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.serving import cache as CA


def _prefill1(eng, prompt):
    """Batch-1 exact-length prefill of ``prompt`` through the engine."""
    toks = torch.tensor([list(prompt)], dtype=torch.int64, device=eng.device)
    logits, caches = eng._prefill(eng.params, eng._make_batch(toks))
    return logits, caches, len(prompt) + eng.cfg.num_prefix_embeds


def _rows(caches1, rows: int):
    """``rows`` copies of a batch-1 cache tree: the oracle's own cache."""
    return pytree.tree_map(
        lambda l: l.expand((rows,) + l.shape[1:]).clone(), caches1)


def _decode_rows(eng, caches, toks, pos):
    """One decode step of the first ``len(toks)`` rows of ``caches`` (the
    rest decode token 0 at their position 0 and are never read); returns
    their float32 logits (n, V) on the device.  ``caches`` advances in
    place."""
    rows = pytree.tree_leaves(caches)[0].shape[0]
    n = len(toks)
    t = torch.zeros((rows, 1), dtype=torch.int64, device=eng.device)
    p = torch.zeros((rows,), dtype=torch.int32, device=eng.device)
    t[:n, 0] = torch.tensor(toks, dtype=torch.int64)
    p[:n] = torch.tensor(pos, dtype=torch.int32)
    logits, _ = eng._decode(eng.params, caches, t, p)
    return logits[:n].float()


def reference_beam(eng, prompt, *, width, max_new, eos_id=-1,
                   length_penalty=0.0):
    """NMT-style beam search oracle; returns (tokens, score).

    Each round scores every beam x vocab continuation, keeps the top
    ``2*width`` (ties: higher candidate id), routes EOS continuations into
    the finished pool (top ``width`` kept, ties: later pool entry) and
    extends with the first ``width`` non-EOS candidates.  Stops when the
    worst finished hypothesis dominates the best continuation, or at
    ``max_new``; the answer is the best of finished and continuing,
    finished preferred on ties.  ``length_penalty``: the device strategy's
    GNMT alpha, divided in where it divides.
    """
    f32 = np.float32

    def lp(n):
        return f32((5.0 + n) / 6.0) ** f32(length_penalty)

    logits1, cache1, pos0 = _prefill1(eng, prompt)
    logp = torch.log_softmax(logits1.float(), dim=-1)[0].cpu().numpy()
    order = np.argsort(-logp, kind="stable")[:width]  # desc, low id on ties
    beams = []          # [tokens, score, pos]; beam i is row i of `tree`
    finished = []       # (tokens tuple, score); index order = pool id order
    for tok in order:
        if tok == eos_id:
            # lp(1) == 1, matching the device's unnormalized admit round.
            finished.append(((int(tok),), logp[tok]))
        else:
            beams.append(([int(tok)], logp[tok], pos0))
    finished = sorted(finished, key=lambda h: h[1], reverse=True)[:width]
    tree = _rows(cache1, eng.batch_size * width)

    while beams and len(beams[0][0]) < max_new:
        best_cont = max(b[1] for b in beams)
        if best_cont == -np.inf:
            break
        cur_len = len(beams[0][0])
        if len(finished) == width and \
                min(h[1] for h in finished) >= best_cont / lp(cur_len):
            break
        logits = _decode_rows(eng, tree, [b[0][-1] for b in beams],
                              [b[2] for b in beams])
        lpv = torch.log_softmax(logits, dim=-1).cpu().numpy()   # (n, V)
        V = lpv.shape[1]
        scores = (np.asarray([b[1] for b in beams], f32)[:, None]
                  + lpv).reshape(-1)                     # id = w * V + v
        ids = np.arange(scores.shape[0])
        # Ascending by (score, id), read backwards: the device's rule.
        top = np.lexsort((ids, scores))[-2 * width:][::-1]
        # EOS candidates -> finished pool (incumbents get lower pool ids;
        # ties prefer the higher pool id, this round's entry).
        pool = [(s, i, toks) for i, (toks, s) in enumerate(finished)]
        base = len(pool)
        new_hyps, src_rows = [], []
        for j, c in enumerate(top):
            src, tok, score = int(c) // V, int(c) % V, scores[c]
            if tok == eos_id:
                pool.append((score / lp(len(beams[src][0]) + 1), base + j,
                             tuple(beams[src][0]) + (tok,)))
            elif len(new_hyps) < width:
                new_hyps.append((beams[src][0] + [tok], score,
                                 beams[src][2] + 1))
                src_rows.append(src)
        pool.sort(key=lambda p: (p[0], p[1]))
        finished = [(toks, s) for s, _, toks in pool[-width:][::-1]]
        beams = new_hyps
        if not beams:
            break
        # Each new beam's row takes the advanced cache of the beam it
        # extends.
        rows = pytree.tree_leaves(tree)[0].shape[0]
        CA.gather_slots(tree, torch.tensor(
            src_rows + list(range(len(src_rows), rows)), device=eng.device))

    # Final answer: finished first (wins ties), then continuations.
    candidates = [(s, 0, toks) for toks, s in finished]
    candidates += [(s / lp(len(toks)), 1, tuple(toks))
                   for toks, s, _ in beams]
    if not candidates:
        return [], float("-inf")
    best = max(candidates, key=lambda c: (c[0], -c[1]))
    return list(best[2]), float(best[0])


def reference_constrained(eng, prompt, seed, *, allowed, transitions,
                          max_new, eos_id=-1, start_state=0):
    """DFA-constrained decode oracle; returns (tokens, states_visited).

    Incremental decode with the engine's counter-key sampler (its own
    temperature / top-k / top-p), logits masked to -inf outside the
    current DFA state's allowed row -- the quantity the device strategy
    samples from.
    """
    allowed = torch.as_tensor(np.asarray(allowed, bool), device=eng.device)
    transitions = np.asarray(transitions, np.int32)
    seeds = torch.tensor([seed], dtype=torch.int32, device=eng.device)

    def sample(logits, state, j):
        masked = torch.where(allowed[state], logits, float("-inf"))
        tok = eng._sample(eng._base_key, masked[None, :], seeds,
                          torch.tensor([j], dtype=torch.int32,
                                       device=eng.device))
        return int(tok[0])

    logits1, cache1, pos0 = _prefill1(eng, prompt)
    caches = _rows(cache1, eng.batch_size)
    state = start_state
    tok = sample(logits1[0], state, 0)
    tokens, states = [tok], [state]
    state = int(transitions[state, tok])
    pos = pos0
    while len(tokens) < max_new and tokens[-1] != eos_id:
        logits = _decode_rows(eng, caches, [tokens[-1]], [pos])[0]
        tok = sample(logits, state, len(tokens))
        tokens.append(tok)
        states.append(state)
        state = int(transitions[state, tok])
        pos += 1
    return tokens, states
