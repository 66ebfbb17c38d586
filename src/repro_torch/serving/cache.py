"""Slot-indexed decode cache: the address layer of continuous batching.

The port of ``repro.serving.cache``.  The engine keeps ONE cache tree for
the whole batch (``lm.init_caches``) and treats its batch axis as an array
of slots: a request owns a slot from admission to eviction, and every
layer's state for that request -- KV rings, recurrent states, conv tails --
lives at that slot index.

* :func:`scatter_slot` writes a freshly prefilled cache into one slot (or
  a run of slots) of the live tree;
* :func:`select_slots` keeps one tree's slots where a mask holds and
  another's elsewhere; :func:`ring_rows` / :func:`commit_rows` keep or roll
  back one decode step per slot where that step wrote the live tree in
  place (speculative decoding's rollback, beam search's frozen slots);
* :func:`gather_slots` reindexes the slot axis (beam search's reorder);
* :func:`poison_slot` overwrites a freed slot with a sentinel
  (``poison_on_evict``: a stale read turns into NaN logits);
* :func:`ring_slot` / :func:`slot_position` are the ring-buffer address map
  ``attention.gqa_decode`` uses;
* :func:`quantize_kv_tree` turns every attention KV leaf into a ``KVQuant``
  (``quantize_kv=``);
* :class:`SlotLedger` tracks ragged per-slot lengths on the host as CSR
  offsets;
* :func:`compact_ragged` drains ragged per-slot output buffers into one flat
  stream + CSR offsets, with the +scan of lengths on
  ``core.primitives.scan`` (kernel K2 on the card).

Every cache leaf leads with the slot axis (the port keeps ``units`` as a
list of per-unit tuples, not stacked on a layer axis), so where the
reference selects along axis 1 under ``units`` the port uses axis 0
everywhere.  The helpers that take the live tree write it in place, one
leaf at a time (the engine owns the tree; a copy of every leaf would only
cost memory), and return it.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import operators as alg
from repro_torch.core import primitives as forge
from repro_torch.core.layout import Flat

# The cache entries a decode step writes in place at slot ``pos % L`` of
# their sequence axis (axis 1): GQA's k and v (dense or ``KVQuant``) and
# MLA's latent ``ckv`` and ``krope``.  Every other leaf (recurrent states,
# conv tails) comes back from a step as a new tensor.
RING_KEYS = ("k", "v", "ckv", "krope")


def scatter_slot(live, single, slot: int):
    """Write a cache tree ``single`` of ``n`` rows into slots ``[slot, slot
    + n)`` of ``live``, in place; returns ``live``.  A leaf of one row
    broadcast to ``n`` rows (``expand``) fills them all without a copy."""
    def write(lv, sg):
        lv[slot:slot + sg.shape[0]] = sg.to(lv.dtype)
        return lv

    return pytree.tree_map(write, live, single)


def _row_mask(mask, leaf):
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.ndim - 1))


def select_slots(mask, new, old):
    """Per-slot select between two cache trees: leaf ``l`` takes ``new``'s
    slot where ``mask`` ((B,) bool) holds, ``old``'s otherwise.  Returns a
    new tree.  A leaf that a decode step wrote in place is the same tensor
    in ``new`` and ``old``, which this cannot roll back: :func:`commit_rows`
    does."""
    return pytree.tree_map(
        lambda nw, od: torch.where(_row_mask(mask, nw), nw, od), new, old)


def _ring_paths(tree, inside=False):
    """Leaves of ``tree`` in ``tree_leaves`` order, each with whether it
    lies under a :data:`RING_KEYS` entry."""
    if isinstance(tree, dict):             # insertion order, as torch's
        return [x for key, v in tree.items() for x in
                _ring_paths(v, inside or key in RING_KEYS)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _ring_paths(v, inside)]
    if isinstance(tree, alg.KVQuant):
        return [(tree.values, inside), (tree.scales, inside)]
    return [(tree, inside)]


def _ring_index(leaf, pos):
    bidx = torch.arange(leaf.shape[0], device=leaf.device)
    return bidx, (pos % leaf.shape[1]).long()


def ring_rows(tree, pos):
    """The rows a decode step at ``pos`` ((B,) positions) will overwrite in
    place: for each leaf under :data:`RING_KEYS`, a copy of slot ``pos %
    L`` of every row; None for every other leaf.  Hand it to
    :func:`commit_rows` after the step."""
    out = []
    for leaf, ring in _ring_paths(tree):
        if ring:
            out.append(leaf[_ring_index(leaf, pos)].clone())
        else:
            out.append(None)
    return out


def commit_rows(mask, new, old, saved, pos):
    """Keep one decode step only where ``mask`` ((B,) bool) holds.

    ``old`` is the tree before the step, ``new`` the step's result and
    ``saved`` :func:`ring_rows` of ``old`` at the step's ``pos``.  A leaf
    the step wrote in place (the same tensor in both trees) gets its saved
    slot back on the rows outside ``mask``, one slot a row; any other leaf
    is selected per row as :func:`select_slots` does.  Returns the
    committed tree."""
    new_leaves, spec = pytree.tree_flatten(new)
    old_leaves = pytree.tree_leaves(old)
    out = []
    for nw, od, sv in zip(new_leaves, old_leaves, saved):
        if sv is None:
            out.append(torch.where(_row_mask(mask, nw), nw, od))
            continue
        if nw is not od:
            raise ValueError("commit_rows: a ring leaf came back as a new "
                             "tensor; its step did not write it in place")
        idx = _ring_index(od, pos)
        od[idx] = torch.where(_row_mask(mask, sv), od[idx], sv)
        out.append(od)
    return pytree.tree_unflatten(out, spec)


def gather_slots(live, rows):
    """Reindex the slot axis in place: slot ``i`` becomes slot ``rows[i]``
    of ``live`` (``rows``: (B,) integer; identity rows leave a slot alone).
    Beam search's reorder: each surviving beam inherits the cache of the
    beam it extends.  One leaf at a time, so the transient is one leaf."""
    rows = rows.long()

    def take(leaf):
        leaf.copy_(leaf.index_select(0, rows))
        return leaf

    return pytree.tree_map(take, live)


def poison_slot(live, slot: int, value=float("nan")):
    """Overwrite every leaf of ``slot``'s state with ``value`` in place.

    Freed-slot hygiene check: if any later compute reads a freed slot's
    state, a NaN poison turns the silent stale read into a loud one.
    Integer leaves (quantized codes) get -1 (255 in an unsigned leaf, as
    the reference's fill)."""
    def poison(leaf):
        leaf[slot] = value if leaf.is_floating_point() else -1
        return leaf

    return pytree.tree_map(poison, live)


def ring_slot(pos, window: int):
    """Ring-buffer slot of absolute position ``pos`` in a ``window`` cache
    (``pos`` an int or a tensor)."""
    return pos % window


def slot_position(slot_idx, pos, window: int):
    """Absolute position currently held by ring slot ``slot_idx`` when the
    writer is at ``pos`` (negative: slot not yet written)."""
    return pos - (pos - slot_idx) % window


def quantize_kv_tree(caches, mode: str):
    """Replace every attention KV leaf with a ``KVQuant`` (values, scales)
    node: the ``"k"``/``"v"`` dict entries of rank >= 4 ((slot, pos,
    kv_head, head_dim)).  MLA latents, recurrent states and conv tails stay
    dense.  ``KVQuant`` is a pytree node whose leaves share the dense
    leaf's leading axes, so the slot helpers above work on the quantized
    tree unchanged."""
    def walk(node):
        if isinstance(node, dict):
            return {
                key: (alg.quantize_kv(val, mode)
                      if key in ("k", "v") and getattr(val, "ndim", 0) >= 4
                      else walk(val))
                for key, val in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(caches)


class SlotError(IndexError):
    """A slot index outside ``[0, num_slots)`` reached the ledger.

    Raised instead of letting numpy's negative-index wraparound silently
    redirect the update into another live slot's length accounting."""


class SlotLedger:
    """Host-side ragged length accounting for the live slots.

    One integer length per slot (tokens resident in the slot's cache);
    rendered on demand as the CSR ``offsets`` descriptor that the
    ``Segmented(offsets=...)`` layout consumes.  Pure host bookkeeping.
    """

    def __init__(self, num_slots: int, cache_len: int):
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.lengths = np.zeros(num_slots, np.int64)

    def _check_slot(self, slot: int) -> int:
        slot = int(slot)
        if not 0 <= slot < self.num_slots:
            raise SlotError(
                f"slot {slot} outside [0, {self.num_slots}): negative or "
                "out-of-range slots would wrap into another slot's ledger "
                "entry")
        return slot

    def occupy(self, slot: int, length: int):
        slot = self._check_slot(slot)
        if not 0 <= length <= self.cache_len:
            raise ValueError(
                f"slot {slot}: length {length} outside [0, {self.cache_len}]")
        self.lengths[slot] = length

    def advance(self, slot: int, by: int = 1):
        slot = self._check_slot(slot)
        self.lengths[slot] = min(self.lengths[slot] + by, self.cache_len)

    def free(self, slot: int):
        slot = self._check_slot(slot)
        self.lengths[slot] = 0

    def offsets(self) -> torch.Tensor:
        """CSR offsets (num_slots + 1,) int32 -- the Segmented descriptor
        (a host tensor)."""
        return torch.from_numpy(
            np.concatenate([[0], np.cumsum(self.lengths)]).astype(np.int32))

    def segment_of(self, slot: int) -> tuple[int, int]:
        """[start, end) of ``slot``'s segment in the flat CSR stream."""
        slot = self._check_slot(slot)
        start = int(self.lengths[:slot].sum())
        return start, start + int(self.lengths[slot])


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
