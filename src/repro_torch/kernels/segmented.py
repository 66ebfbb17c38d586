"""Segment bookkeeping shared by the segmented compositions.

The glue half of ``repro.kernels.segmented``: converting between the two
segment descriptors of :class:`~repro_torch.core.layout.Segmented`.  The
flag-segmented scan kernel (the reference's K8) belongs to a later slice;
nothing on the sampling path reaches it.
"""
from __future__ import annotations

import torch

from repro_torch.core import operators as alg


def offsets_to_flags(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """CSR offsets -> flag array.  Empty segments leave no flag behind."""
    flags = torch.zeros((n,), dtype=torch.int32, device=offsets.device)
    if n == 0:
        return flags
    starts = offsets[:-1].long()
    flags[starts[starts < n]] = 1          # starts at n (empty tails) drop
    flags[0] = 1
    return flags


def flags_to_segment_ids(flags: torch.Tensor, scan) -> torch.Tensor:
    """0-based contiguous segment id per element (element 0 starts seg 0).

    ``scan`` is the caller's resolved ``scan@flat`` implementation: the ids
    are an inclusive ADD scan of the flags (kernel K2 on the card), where
    the reference takes ``jnp.cumsum``."""
    if flags.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=flags.device)
    f = flags.to(torch.int32).clone()
    f[0] = 1
    return scan(alg.ADD, f) - 1
