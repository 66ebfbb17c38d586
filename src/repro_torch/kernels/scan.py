"""Scan kernels K2 (flat) and K6 (channel), each with its plain version.

* :func:`scan_1d_cuda` -- prefix scan of flat ``(n,)`` leaves under any
  operator with a device form, commutative or not (``csrc/scan.cuh``,
  ``csrc/lookback.cuh``; replaces ``repro/kernels/scan.py::scan_1d_pallas``).
  One launch a call: one tile (n <= ``plan.limit``), or the single-pass
  decoupled lookback, whose ticket and tile statuses live in the stream's
  workspace (``_lib.workspace``).  Plain version: :func:`scan_1d_plain`.
* :func:`scan_channel_cuda` -- scan along axis 1 of ``(B, T, C)`` leaves,
  independent per (b, c), forward or reverse (``csrc/scan.cuh``; replaces
  ``scan_channel_pallas``).  It carries ``linear_recurrence`` on the
  channel-tile route (a block per b and 16 channels, T walked in chunks
  with a carry) and the radix sort's rank scan on the long-T path (T
  spread over blocks; see :func:`uses_long_t`).  Plain version:
  :func:`scan_channel_plain`, a serial walk over T.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel or raises.  ``launches`` on each wrapper counts the calls
that launched its kernel; K6 counts its long-T path apart, in
``long_t_launches``, and each route's reverse launches (the gradients of
``linear_recurrence`` and of the mLSTM's stabilizer) again in
``reverse_launches`` and ``long_t_reverse_launches``.  ``nitem`` is the
tuning policy's ``nitem_scan`` (None: the kernels' default of 8): the
items a thread of a tile scans, K6's steps a thread a chunk and its long-T
chunk's 8 ``nitem`` steps, each value a unit of its own
(``kernels/_lib.py: KNOB_FAMILIES``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Pytree = Any


def _leaves(what, xs, ndim):
    """The leaves of ``xs``, checked: non-empty, one rank-``ndim`` shape,
    contiguous on one CUDA device."""
    leaves = (xs,) if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)
    shape = leaves[0].shape
    if len(shape) != ndim or 0 in shape or len(leaves) > 1 and any(
            l.shape != shape for l in leaves):
        raise ValueError(f"{what}: leaves must share one non-empty rank-"
                         f"{ndim} shape, got {[tuple(l.shape) for l in leaves]}")
    _lib.require_cuda(what, *leaves)
    return leaves


def scan_unit(what, op, leaves, nitem=None) -> _lib.Unit:
    """The generated unit of K2, K7s and K6 for ``op`` over ``leaves``."""
    return _lib.unit("scan", what, op, [l.dtype for l in leaves], knob=nitem)


# ---------------------------------------------------------------------------
# K2: flat scan
# ---------------------------------------------------------------------------


def scan_1d_plain(op, xs: Pytree, *, inclusive: bool = True) -> Pytree:
    """Plain version of K2: the log-step reference scan of (n,) leaves."""
    return ref.ref_scan(op, xs, axis=0, inclusive=inclusive)


def scan_1d_cuda(op, xs: Pytree, *, inclusive: bool = True,
                 nitem: int | None = None) -> Pytree:
    """K2: inclusive/exclusive scan over flat ``(n,)`` leaves, n >= 1."""
    x = xs if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)[0]
    if not x.is_cuda:
        return scan_1d_plain(op, xs, inclusive=inclusive)
    what = "scan@flat (cuda)"
    leaves = _leaves(what, xs, 1)
    plan = _lib.plan("scan", what, op, xs, knob=nitem)
    lib = plan.lib or plan.load()
    n = x.shape[0]
    outs = [torch.empty_like(l) for l in leaves]
    stream = _lib.stream_ptr(x)
    ptrs = _lib.ptrs((*leaves, *outs))
    if n <= plan.limit:
        rc = lib.rt_scan_tile(*ptrs, 1, n, int(inclusive), stream)
    else:
        # At most one status a limit's elements: the lookback's tiles are
        # no smaller.  A status: two flag words and two values.
        tiles = -(-n // plan.limit)
        w = _lib.workspace(x, stream, 1, 2 * tiles * plan.elem_bytes,
                           2 * tiles)
        rc = lib.rt_scan_lookback(
            *ptrs, n, int(inclusive), w.counters.data_ptr(),
            w.flags.data_ptr(), w.partials.data_ptr(), w.next_epoch(), stream)
    _lib.check(rc, what)
    scan_1d_cuda.launches += 1
    return plan.outputs(outs)


scan_1d_cuda.launches = 0


# ---------------------------------------------------------------------------
# K6: channel scan along axis 1 of (B, T, C)
# ---------------------------------------------------------------------------

# The long-T path takes over when few channels meet a long T.  At B * C <=
# 1024 the channel-tile route runs at most 64 blocks (of 132 SMs), each
# walking all of T; the radix sort's rank scans (256 and 4 channels, T =
# B V) are far below it.  The RG-LRU's recurrence, at B * C >= 2560, stays
# above it on the channel-tile route.  Below LONG_T_MIN_STEPS (two chunks
# of the long path) there is little to spread.
LONG_T_MAX_CHANNELS = 1024
LONG_T_MIN_STEPS = 128


def uses_long_t(B: int, T: int, C: int) -> bool:
    """Whether K6 takes the long-T path for a (B, T, C) scan."""
    return B * C <= LONG_T_MAX_CHANNELS and T >= LONG_T_MIN_STEPS


def _kept(keep, leaves):
    """``keep`` checked against ``leaves``: one flag per leaf, None for
    all of them."""
    if keep is None:
        return (True,) * len(leaves)
    if len(keep) != len(leaves) or not any(keep):
        raise ValueError(f"keep: one flag per leaf and at least one set, "
                         f"got {keep} for {len(leaves)} leaves")
    return tuple(bool(k) for k in keep)


def scan_channel_plain(op, xs: Pytree, *, inclusive: bool = True,
                       reverse: bool = False, keep=None) -> Pytree:
    """Plain version of K6: the serial walk over T, vectorized over (B, C),
    the carry on the left.  A leaf that ``keep`` drops comes back None."""
    leaves, spec = pytree.tree_flatten(xs)
    keep = _kept(keep, leaves)
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
    return pytree.tree_unflatten(
        [o if k else None for o, k in zip(outs, keep)], spec)


def scan_channel_cuda(op, xs: Pytree, *, inclusive: bool = True,
                      reverse: bool = False, keep=None,
                      nitem: int | None = None) -> Pytree:
    """K6: scan along axis 1 of ``(B, T, C)`` leaves, independent per
    (b, c); ``reverse`` walks T from the end.  :func:`uses_long_t` picks
    the route from the shape.  ``keep``: one flag per leaf (default all);
    a dropped leaf is not written (its output pointer is null, which the
    element's store skips) and comes back None -- ``linear_recurrence``
    without ``h0`` reads only the B leaf, and the A leaf would be a
    quarter of the bytes."""
    x = xs if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)[0]
    if not x.is_cuda:
        return scan_channel_plain(op, xs, inclusive=inclusive, reverse=reverse,
                                  keep=keep)
    what = "scan along T of (B, T, C) (cuda)"
    leaves = _leaves(what, xs, 3)
    keep = _kept(keep, leaves)
    plan = _lib.plan("scan", what, op, xs, knob=nitem)
    B, T, C = x.shape
    if B > 65535:
        raise ValueError(f"{what}: B = {B} exceeds the grid's 65535 rows")
    lib = plan.lib or plan.load()
    long_t = uses_long_t(B, T, C)
    outs = [torch.empty_like(l) if k else None for l, k in zip(leaves, keep)]
    scratch = _lib.scratch(B * C * -(-T // lib.rt_scan_channel_chunk()),
                           len(leaves), x) if long_t else None
    _lib.check(lib.rt_scan_channel(
        *[_lib.ptr(t) for t in (*leaves, *outs)], B, T, C, int(inclusive),
        int(reverse), _lib.ptr(scratch), _lib.stream_ptr(x)), what)
    if long_t:
        scan_channel_cuda.long_t_launches += 1
        scan_channel_cuda.long_t_reverse_launches += int(reverse)
    else:
        scan_channel_cuda.launches += 1
        scan_channel_cuda.reverse_launches += int(reverse)
    return plan.outputs(outs)


# Launches of the channel-tile route and of the long-T path, counted apart;
# each one's reverse ones again among its own.
scan_channel_cuda.launches = 0
scan_channel_cuda.long_t_launches = 0
scan_channel_cuda.reverse_launches = 0
scan_channel_cuda.long_t_reverse_launches = 0
