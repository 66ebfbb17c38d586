"""Scan kernels K2 (flat) and K6 (channel), each with its plain version.

* :func:`scan_1d_cuda` -- prefix scan of flat ``(n,)`` leaves under any
  operator with a device form, commutative or not (``csrc/scan.cuh``; replaces
  ``repro/kernels/scan.py::scan_1d_pallas``).  Plain version:
  :func:`scan_1d_plain`.
* :func:`scan_channel_cuda` -- scan along axis 1 of ``(B, T, C)`` leaves,
  independent per (b, c), forward or reverse (``csrc/scan.cuh``;
  replaces ``scan_channel_pallas``).  It carries ``linear_recurrence`` on
  the serial route (one thread per channel) and the radix sort's rank scan
  on the long-T path (T spread over blocks; see :func:`uses_long_t`).
  Plain version: :func:`scan_channel_plain`, the same serial walk over T.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel or raises.  ``launches`` on each wrapper counts the calls
that launched its kernel (K2 above one tile issues three CUDA launches per
call: reduce, scan of the totals, rescan); K6 counts its long-T path apart,
in ``long_t_launches``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Pytree = Any


def _check_leaves(what, leaves, ndim):
    shape = leaves[0].shape
    if any(l.shape != shape or l.ndim != ndim for l in leaves):
        raise ValueError(f"{what}: leaves must share one rank-{ndim} shape, "
                         f"got {[tuple(l.shape) for l in leaves]}")
    _lib.require_cuda(what, *leaves)


def scan_unit(what, op, leaves) -> _lib.Unit:
    """The generated unit of K2, K7s and K6 for ``op`` over ``leaves``."""
    return _lib.unit("scan", what, op, [l.dtype for l in leaves])


# ---------------------------------------------------------------------------
# K2: flat scan
# ---------------------------------------------------------------------------


def scan_1d_plain(op, xs: Pytree, *, inclusive: bool = True) -> Pytree:
    """Plain version of K2: the log-step reference scan of (n,) leaves."""
    return ref.ref_scan(op, xs, axis=0, inclusive=inclusive)


def scan_1d_cuda(op, xs: Pytree, *, inclusive: bool = True) -> Pytree:
    """K2: inclusive/exclusive scan over flat ``(n,)`` leaves, n >= 1."""
    leaves, spec = pytree.tree_flatten(xs)
    if not leaves[0].is_cuda:
        return scan_1d_plain(op, xs, inclusive=inclusive)
    what = "scan@flat (cuda)"
    unit = scan_unit(what, op, leaves)
    _check_leaves(what, leaves, 1)
    lib = _lib.load(unit)
    n = leaves[0].shape[0]
    outs = [torch.empty_like(l) for l in leaves]
    tiles = -(-n // lib.rt_tile())
    scratch = _lib.scratch(tiles, len(leaves), leaves[0]) if tiles > 1 \
        else None
    _lib.check(lib.rt_scan_rows(
        _lib.leaf_ptrs(leaves), _lib.leaf_ptrs(outs), 1, n, int(inclusive),
        _lib.ptr(scratch), _lib.stream_ptr(leaves[0])), what)
    scan_1d_cuda.launches += 1
    return pytree.tree_unflatten(outs, spec)


scan_1d_cuda.launches = 0


# ---------------------------------------------------------------------------
# K6: channel scan along axis 1 of (B, T, C)
# ---------------------------------------------------------------------------

# The long-T path takes over when the serial route's B * C threads are too
# few to fill the card.  At B * C <= 1024 the serial route runs at most 8
# blocks of 128 threads (8 of 132 SMs), each thread waiting out T load
# latencies; the radix sort's rank scans (256 and 4 channels, T = B V) are
# far below it.  The RG-LRU's recurrence, at B * C >= 2560, stays above it
# on the serial route, which keeps AFFINE bit-equal to the plain version
# (the long path reassociates float combines at chunk boundaries).  Below
# LONG_T_MIN_STEPS (two chunks of the long path) there is little to spread.
LONG_T_MAX_CHANNELS = 1024
LONG_T_MIN_STEPS = 128


def uses_long_t(B: int, T: int, C: int) -> bool:
    """Whether K6 takes the long-T path for a (B, T, C) scan."""
    return B * C <= LONG_T_MAX_CHANNELS and T >= LONG_T_MIN_STEPS


def scan_channel_plain(op, xs: Pytree, *, inclusive: bool = True,
                       reverse: bool = False) -> Pytree:
    """Plain version of K6: the kernel's serial walk over T, vectorized
    over (B, C), with the same combine order (carry on the left)."""
    leaves, spec = pytree.tree_flatten(xs)
    T = leaves[0].shape[1]
    outs = [torch.empty_like(l) for l in leaves]
    acc = op.identity(pytree.tree_map(lambda l: l[:, 0], xs))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        x_t = pytree.tree_map(lambda l: l[:, t], xs)
        if inclusive:
            acc = op.combine(acc, x_t)
        for o, v in zip(outs, pytree.tree_leaves(acc)):
            o[:, t] = v
        if not inclusive:
            acc = op.combine(acc, x_t)
    return pytree.tree_unflatten(outs, spec)


def scan_channel_cuda(op, xs: Pytree, *, inclusive: bool = True,
                      reverse: bool = False) -> Pytree:
    """K6: scan along axis 1 of ``(B, T, C)`` leaves, independent per
    (b, c); ``reverse`` walks T from the end.  :func:`uses_long_t` picks
    the route from the shape."""
    leaves, spec = pytree.tree_flatten(xs)
    if not leaves[0].is_cuda:
        return scan_channel_plain(op, xs, inclusive=inclusive, reverse=reverse)
    what = "scan along T of (B, T, C) (cuda)"
    unit = scan_unit(what, op, leaves)
    _check_leaves(what, leaves, 3)
    B, T, C = leaves[0].shape
    if B > 65535:
        raise ValueError(f"{what}: B = {B} exceeds the grid's 65535 rows")
    lib = _lib.load(unit)
    long_t = uses_long_t(B, T, C)
    outs = [torch.empty_like(l) for l in leaves]
    chunks = -(-T // lib.rt_scan_channel_chunk())
    scratch = _lib.scratch(B * C * chunks, len(leaves), leaves[0]) \
        if long_t else None
    _lib.check(lib.rt_scan_channel(
        _lib.leaf_ptrs(leaves), _lib.leaf_ptrs(outs), B, T, C, int(inclusive),
        int(reverse), _lib.ptr(scratch), _lib.stream_ptr(leaves[0])), what)
    if long_t:
        scan_channel_cuda.long_t_launches += 1
    else:
        scan_channel_cuda.launches += 1
    return pytree.tree_unflatten(outs, spec)


# Launches of the serial route and of the long-T path, counted apart.
scan_channel_cuda.launches = 0
scan_channel_cuda.long_t_launches = 0
