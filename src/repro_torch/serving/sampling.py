"""Token choice and log-probabilities for the serving engine.

The port of the greedy part of ``repro.serving.sampling``: greedy
``sample_tokens``, ``chosen_logprobs`` and ``masked_seq_logprobs``, the last
on ``mapreduce(layout=Batched())`` with the masked-select map (kernel K7m on
the card).  Temperature sampling (the reference's counter-based threefry
keys, segmented top-k and batched nucleus scan) comes with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import operators as alg
from repro_torch.core import primitives as forge
from repro_torch.core.layout import Batched


def chosen_logprobs(logits, tok):
    """log p of each batch row's chosen token under this step's logits."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tok.long()[:, None])[:, 0]


def sample_tokens(logits):
    """Greedy choice, one token per batch row: (B,) int32 (first maximum
    on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def masked_seq_logprobs(logps, emitted):
    """Per-slot sequence scores over the ragged (slots, steps) buffer: one
    masked ``mapreduce(layout=Batched())`` launch, identity at masked
    steps."""
    T = logps.shape[1]
    mask = (torch.arange(T, dtype=torch.int32, device=logps.device)[None, :]
            < emitted[:, None]).to(torch.int32)
    return forge.mapreduce(alg.masked_select(0.0), alg.ADD, (logps, mask),
                           layout=Batched())
