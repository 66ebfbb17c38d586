"""Scan kernels K2 (flat) and K6 (channel), each with its plain version.

* :func:`scan_1d_cuda` -- prefix scan of flat ``(n,)`` leaves under any
  device operator, commutative or not (``csrc/scan_flat.cu``; replaces
  ``repro/kernels/scan.py::scan_1d_pallas``).  Plain version:
  :func:`scan_1d_plain`.
* :func:`scan_channel_cuda` -- scan along axis 1 of ``(B, T, C)`` leaves,
  independent per (b, c), forward or reverse (``csrc/scan_channel.cu``;
  replaces ``scan_channel_pallas``).  It carries ``linear_recurrence``.
  Plain version: :func:`scan_channel_plain`, the same serial walk over T.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel or raises.  ``launches`` on each wrapper counts the calls
that launched its kernel (K2 above one tile issues three CUDA launches per
call: reduce, scan of the totals, rescan).
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
    op_code, dt_code = _lib.op_codes(what, op, leaves)
    _check_leaves(what, leaves, 1)
    n = leaves[0].shape[0]
    lib = _lib.library("scan_flat.cu")
    outs = [torch.empty_like(l) for l in leaves]
    tiles = -(-n // lib.rt_scan_flat_tile())
    scratch = torch.empty(4 * len(leaves) * tiles if tiles > 1 else 0,
                          dtype=torch.uint8, device=leaves[0].device)
    x1, y1 = (leaves[1], outs[1]) if len(leaves) == 2 else (None, None)
    _lib.check(lib.rt_scan_flat(
        op_code, dt_code, leaves[0].data_ptr(), _lib.ptr(x1),
        outs[0].data_ptr(), _lib.ptr(y1), n, int(inclusive),
        scratch.data_ptr() if tiles > 1 else None,
        _lib.stream_ptr(leaves[0])), what)
    scan_1d_cuda.launches += 1
    return pytree.tree_unflatten(outs, spec)


scan_1d_cuda.launches = 0


# ---------------------------------------------------------------------------
# K6: channel scan along axis 1 of (B, T, C)
# ---------------------------------------------------------------------------


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
    (b, c); ``reverse`` walks T from the end."""
    leaves, spec = pytree.tree_flatten(xs)
    if not leaves[0].is_cuda:
        return scan_channel_plain(op, xs, inclusive=inclusive, reverse=reverse)
    what = "scan along T of (B, T, C) (cuda)"
    op_code, dt_code = _lib.op_codes(what, op, leaves)
    _check_leaves(what, leaves, 3)
    B, T, C = leaves[0].shape
    if B > 65535:
        raise ValueError(f"{what}: B = {B} exceeds the grid's 65535 rows")
    lib = _lib.library("scan_channel.cu")
    outs = [torch.empty_like(l) for l in leaves]
    x1, y1 = (leaves[1], outs[1]) if len(leaves) == 2 else (None, None)
    _lib.check(lib.rt_scan_channel(
        op_code, dt_code, leaves[0].data_ptr(), _lib.ptr(x1),
        outs[0].data_ptr(), _lib.ptr(y1), B, T, C, int(inclusive),
        int(reverse), _lib.stream_ptr(leaves[0])), what)
    scan_channel_cuda.launches += 1
    return pytree.tree_unflatten(outs, spec)


scan_channel_cuda.launches = 0
