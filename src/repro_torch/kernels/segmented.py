"""Segmented scan kernel K8, its plain version, and the segment bookkeeping
of the segmented compositions.

* :func:`segmented_scan_1d_cuda` -- the flag-array segmented scan of flat
  ``(n,)`` leaves, inclusive or exclusive, under :func:`segmented` ``(op)``
  for any operator with a device form, commutative or not
  (``csrc/segmented.cuh``; replaces
  ``repro/kernels/segmented.py::segmented_scan_1d_pallas``).  Plain
  version: :func:`segmented_scan_1d_plain`, the log-step scan of the lifted
  operator.
* The glue of ``repro.kernels.segmented`` as plain tensor code: converting
  between the two segment descriptors of
  :class:`~repro_torch.core.layout.Segmented`
  (:func:`offsets_to_flags`, :func:`flags_to_segment_ids`) and picking each
  segment's reduction out of an inclusive segmented scan
  (:func:`gather_segment_lasts`).

Given CPU tensors the wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts the kernel's launches
(three CUDA launches per call above one tile).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import operators as alg
from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Pytree = Any


def segmented_scan_1d_plain(op, xs: Pytree, flags: torch.Tensor, *,
                            inclusive: bool = True) -> Pytree:
    """Plain version of K8: the reference scan of the lifted operator over
    (flags, values), then, when exclusive, the shift by one element with the
    identity at every segment start."""
    return ref.ref_segmented_scan(op, xs, flags, inclusive=inclusive)


def segmented_scan_1d_cuda(op, xs: Pytree, flags: torch.Tensor, *,
                           inclusive: bool = True,
                           nitem: int | None = None) -> Pytree:
    """K8: segmented scan of flat ``(n,)`` leaves, n >= 1; ``flags[i] != 0``
    starts a segment (element 0 always does).  ``nitem``: the tuning
    policy's ``nitem_scan``, the items a thread of a tile scans (None: 8)."""
    leaves, spec = pytree.tree_flatten(xs)
    if not leaves[0].is_cuda:
        return segmented_scan_1d_plain(op, xs, flags, inclusive=inclusive)
    what = "scan@segmented (cuda)"
    flags = flags.to(torch.int32).contiguous()
    unit = _lib.unit("segscan", what, alg.segmented(op),
                     [torch.int32] + [l.dtype for l in leaves], knob=nitem)
    n = leaves[0].shape[0]
    if any(l.shape != (n,) for l in leaves) or flags.shape != (n,) or n == 0:
        raise ValueError(f"{what}: takes non-empty (n,) leaves and (n,) "
                         f"flags, got {[tuple(l.shape) for l in leaves]} and "
                         f"{tuple(flags.shape)}")
    _lib.require_cuda(what, flags, *leaves)
    lib = _lib.load(unit)
    outs = [torch.empty_like(l) for l in leaves]
    tiles = -(-n // lib.rt_tile())
    scratch = _lib.scratch(tiles, 1 + len(leaves), leaves[0]) if tiles > 1 \
        else None
    _lib.check(lib.rt_segscan(
        _lib.leaf_ptrs([flags, *leaves]), _lib.leaf_ptrs([None, *outs]), n,
        int(inclusive), _lib.ptr(scratch), _lib.stream_ptr(leaves[0])), what)
    segmented_scan_1d_cuda.launches += 1
    return pytree.tree_unflatten(outs, spec)


segmented_scan_1d_cuda.launches = 0


# ---------------------------------------------------------------------------
# Segment bookkeeping shared by the segmented compositions (plain tensors).
# ---------------------------------------------------------------------------


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


def gather_segment_lasts(op, incl: Pytree, scan, *,
                         offsets: torch.Tensor | None = None,
                         flags: torch.Tensor | None = None,
                         num_segments: int | None = None) -> Pytree:
    """Pick each segment's last inclusive-scan element; identity for empties.

    ``incl`` is the segmented *inclusive* scan of the mapped values; its
    element at the last index of segment ``s`` is that segment's reduction.
    ``scan`` is the resolved ``scan@flat`` implementation the flag variant
    numbers its segments with.
    """
    leaves = pytree.tree_leaves(incl)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    if offsets is not None:
        offsets = offsets.long()
        last = offsets[1:] - 1
        empty = offsets[1:] == offsets[:-1]
    else:
        seg_ids = flags_to_segment_ids(flags, scan).long()
        # Each segment's last position (scatter-max of the positions);
        # segments past the flag count keep -1 and take the identity.
        last = torch.full((num_segments,), -1, dtype=torch.long, device=dev)
        keep = seg_ids < num_segments
        last.scatter_reduce_(0, seg_ids[keep],
                             torch.arange(n, device=dev)[keep], "amax")
        empty = last < 0
    idx = last.clamp(0, n - 1)
    picked = pytree.tree_map(lambda l: l[idx], incl)
    ident = op.identity(picked)
    return pytree.tree_map(lambda p, i: torch.where(empty, i, p), picked,
                           ident)
