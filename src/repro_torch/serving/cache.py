"""Slot-indexed decode cache: the address layer of continuous batching.

The port of the slice's part of ``repro.serving.cache``.  The engine keeps
ONE cache tree for the whole batch (``lm.init_caches``) and treats its batch
axis as an array of slots: a request owns a slot from admission to eviction.

* :func:`scatter_slot` writes a freshly prefilled single-request cache into
  one slot of the live tree;
* :func:`compact_ragged` drains ragged per-slot output buffers into one flat
  stream + CSR offsets, with the +scan of lengths on
  ``core.primitives.scan`` (kernel K2 on the card).

Every cache leaf leads with the slot axis (the port keeps ``units`` as a
list of per-unit tuples, not stacked on a layer axis).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import operators as alg
from repro_torch.core import primitives as forge
from repro_torch.core.layout import Flat


def scatter_slot(live, single, slot: int):
    """Write a batch=1 cache tree ``single`` into ``slot`` of ``live``.

    Updates ``live``'s leaves in place (the engine owns the tree; a copy of
    every leaf per admission would only cost memory) and returns it.
    """
    def write(lv, sg):
        lv[slot:slot + 1] = sg.to(lv.dtype)
        return lv

    return pytree.tree_map(write, live, single)


def compact_ragged(buf, counts):
    """Drain ragged per-slot rows into (flat stream, CSR offsets).

    ``buf``: (B, T) per-slot buffers; ``counts``: (B,) valid prefix lengths.
    Returns ``(flat, offsets)`` with ``flat[offsets[b]:offsets[b+1]] ==
    buf[b, :counts[b]]`` -- the exclusive +scan of counts gives the segment
    starts, then a gather.  The flat extent is read back to the host once.
    """
    B, T = buf.shape
    counts = counts.to(torch.int32).contiguous()
    incl = forge.scan(alg.ADD, counts, layout=Flat())        # (B,) inclusive
    starts = incl - counts                                   # exclusive form
    total = int(incl[-1]) if B else 0
    offsets = torch.cat([starts, incl[-1:] if B else starts.new_zeros(1)])
    k = torch.arange(total, dtype=torch.int32, device=buf.device)
    seg = torch.searchsorted(incl, k, right=True)
    col = (k - starts[seg]).long()
    return buf[seg, col], offsets
