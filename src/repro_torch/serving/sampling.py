"""Counter-based sampling for the serving engine.

The port of ``repro.serving.sampling``.  The key for request ``r``'s
``j``-th token is ``fold_in(fold_in(base, seed_r), j)`` -- a pure function
of (engine seed, request seed, token index), independent of batch
composition and admission order.  The keys are the reference's: an integer
threefry-2x32 in torch (:func:`threefry2x32`) with JAX's counter layout for
``jax_threefry_partitionable=True``, so the same seeds draw the same bits,
and the same Gumbel noise to float32 rounding of ``log``.

``sample_tokens`` routes temperature > 0 sampling through the primitives:
``top_k(layout=Segmented(offsets=...))`` over the flat ``(B V,)`` logit
stream (the radix sort: kernels K2, K4 and K6 on the card) and a
``scan(layout=Batched())`` nucleus cutoff over the ``(B, k)`` candidates
(K7s).  ``masked_seq_logprobs`` rides ``mapreduce(layout=Batched())`` with
the masked-select map (K7m).
"""
from __future__ import annotations

import torch

from repro_torch.core import operators as alg
from repro_torch.core import primitives as forge
from repro_torch.core.layout import Batched, Segmented

# ---------------------------------------------------------------------------
# Threefry-2x32 on int64 tensors holding uint32 words.  A key is a (..., 2)
# int64 tensor of two words.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) of key words (k1, k2) on the
    count words (x1, x2); all uint32 words in int64 tensors, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words
    ``(0, seed mod 2^32)``."""
    hi = 0 if seed < 0 else (seed >> 32) & _M32
    return torch.tensor([hi, seed & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash ``data`` (uint32, a tensor broadcast
    against the key's batch shape, or an int) into ``key``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                        data)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element of a ``(n,)`` draw for every key of
    ``key``'s batch shape: ``(..., n)`` int64 words, JAX's partitionable
    layout (the counter of element i is the 64-bit i as two words)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32,
                        i & _M32)
    return a ^ b


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``: the top
    23 random bits become the mantissa of a float in [1, 2), less 1."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (its default "low" mode):
    ``-log(-log(u))`` with ``u`` uniform over [tiny, 1)."""
    u = uniform(key, n, minval=torch.finfo(torch.float32).tiny, maxval=1.0)
    return -torch.log(-torch.log(u))


# Per-stream tags folded into the engine's base key (:func:`stream_key`),
# the reference's values.  The verify / vanilla stream uses the *untagged*
# base key: exact-match speculative verification samples the target's token
# with it, which is why its stream is vanilla's at the same seeds.
DRAFT_STREAM = 0x5D1A_F7  # draft-proposal stream of speculative decoding


def stream_key(base_key: torch.Tensor, tag: int) -> torch.Tensor:
    """Derive a decoding-strategy stream key: ``fold_in(base, tag)``; the
    request and step folds on top of it are :func:`request_step_keys`'."""
    return fold_in(base_key, tag)


def request_step_keys(base_key: torch.Tensor, seeds: torch.Tensor,
                      steps: torch.Tensor) -> torch.Tensor:
    """(B, 2) per-row keys: fold_in(fold_in(base, seed_b), step_b)."""
    return fold_in(fold_in(base_key, seeds), steps)


# ---------------------------------------------------------------------------
# Token choice and log-probabilities
# ---------------------------------------------------------------------------


def chosen_logprobs(logits, tok):
    """log p of each batch row's chosen token under this step's logits."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tok.long()[:, None])[:, 0]


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    # A float32 operand of the tensor's shape, so that division and
    # comparison round in float32 exactly as the reference's weak-typed
    # scalars do (a Python scalar divisor may become a reciprocal multiply).
    return torch.full_like(like, v, dtype=torch.float32)


def sample_tokens(base_key, logits, seeds, steps, *, temperature, top_k,
                  top_p, top_p_candidates):
    """Sample one token per batch row.  Returns (B,) int32.

    Greedy when ``temperature <= 0`` (first maximum on ties, as
    ``jnp.argmax``); otherwise per-row Gumbel-argmax with counter-based
    keys, filtered through the segmented top-k / batched nucleus-cutoff
    primitives when configured.

    **Nucleus semantics** (the reference's, pinned by its tests): the top-p
    cutoff is measured on the softmax *renormalized over the k retained
    candidates* (``top_k``, or ``top_p_candidates`` when only top-p is
    set), not on the full-vocab distribution.  The first (highest)
    candidate always survives -- its exclusive prefix mass is 0 < top_p --
    and every candidate survives iff the renormalized exclusive prefix
    stays below ``top_p``, however little full-vocab mass the k candidates
    carry.
    """
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    keys = request_step_keys(base_key, seeds, steps)
    B, V = logits.shape
    if top_k or top_p < 1.0:
        k = min(top_k if top_k else top_p_candidates, V)
        flat = logits.float().reshape(-1)
        offsets = torch.arange(B + 1, dtype=torch.int32,
                               device=logits.device) * V
        vals, idx = forge.top_k(flat, k, layout=Segmented(offsets=offsets))
        scaled = vals / _f32(temperature, vals)          # (B, k) descending
        # Keep the shortest prefix whose mass reaches top_p; the (B, k)
        # candidate grid is one batched-scan launch for every request.
        e = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        cum = forge.scan(alg.ADD, probs, inclusive=False, layout=Batched())
        filtered = torch.where(cum < _f32(top_p, cum), scaled,
                               _f32(-float("inf"), scaled))
        choice = torch.argmax(filtered + gumbel(keys, k), dim=-1)
        return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
    x = logits.float()
    return torch.argmax(x / _f32(temperature, x) + gumbel(keys, V),
                        dim=-1).to(torch.int32)


def masked_seq_logprobs(logps, emitted):
    """Per-slot sequence scores over the ragged (slots, steps) buffer: one
    masked ``mapreduce(layout=Batched())`` launch, identity at masked
    steps."""
    T = logps.shape[1]
    mask = (torch.arange(T, dtype=torch.int32, device=logps.device)[None, :]
            < emitted[:, None]).to(torch.int32)
    return forge.mapreduce(alg.masked_select(0.0), alg.ADD, (logps, mask),
                           layout=Batched())
