"""Batched kernels K7s (scan) and K7m (mapreduce), each with its plain
version (``csrc/batched.cu``).

* :func:`batched_scan_cuda` -- per-row prefix scan of ``(B, n)`` leaves
  under any device operator, AFFINE included (replaces
  ``repro/kernels/batched.py::batched_scan_pallas``).  Plain version:
  :func:`batched_scan_plain`, the row-by-row reference scan.
* :func:`batched_mapreduce_cuda` -- per-row commutative op-reduce of
  ``f(x)`` over ``(B, n)`` leaves -> ``(B,)``, one launch for the whole
  batch (replaces ``batched_mapreduce_pallas``).  ``f`` is a
  :class:`~repro_torch.core.operators.DeviceMap`, run inside the kernel.
  Plain version: :func:`batched_mapreduce_plain`.

Given CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts each kernel's launches
(K7s above one tile per row issues three CUDA launches per call).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.mapreduce import map_operands

Pytree = Any


def batched_scan_plain(op, xs: Pytree, *, inclusive: bool = True) -> Pytree:
    """Plain version of K7s: the reference scan of each row."""
    return ref.ref_batched_scan(op, xs, inclusive=inclusive)


def batched_scan_cuda(op, xs: Pytree, *, inclusive: bool = True) -> Pytree:
    """K7s: inclusive/exclusive scan along axis 1 of ``(B, n)`` leaves,
    independent per row, B, n >= 1."""
    leaves, spec = pytree.tree_flatten(xs)
    if not leaves[0].is_cuda:
        return batched_scan_plain(op, xs, inclusive=inclusive)
    what = "scan@batched (cuda)"
    op_code, dt_code = _lib.op_codes(what, op, leaves)
    shape = leaves[0].shape
    if any(l.shape != shape for l in leaves) or len(shape) != 2 \
            or 0 in shape:
        raise ValueError(f"{what}: takes non-empty (B, n) leaves of one "
                         f"shape, got {[tuple(l.shape) for l in leaves]}")
    _lib.require_cuda(what, *leaves)
    B, n = shape
    if B > 65535:
        raise ValueError(f"{what}: B = {B} exceeds the grid's 65535 rows")
    lib = _lib.library("batched.cu")
    outs = [torch.empty_like(l) for l in leaves]
    tiles = -(-n // lib.rt_scan_batched_tile())
    scratch = _lib.scratch(B * tiles, len(leaves), leaves[0]) if tiles > 1 \
        else None
    x1, y1 = (leaves[1], outs[1]) if len(leaves) == 2 else (None, None)
    _lib.check(lib.rt_scan_batched(
        op_code, dt_code, leaves[0].data_ptr(), _lib.ptr(x1),
        outs[0].data_ptr(), _lib.ptr(y1), B, n, int(inclusive),
        _lib.ptr(scratch), _lib.stream_ptr(leaves[0])), what)
    batched_scan_cuda.launches += 1
    return pytree.tree_unflatten(outs, spec)


batched_scan_cuda.launches = 0


def batched_mapreduce_plain(f, op, xs: Pytree) -> Pytree:
    """Plain version of K7m: ``f`` then an ordered pairwise fold per row."""
    return ref.ref_fold(op, f(xs), axis=1)


def batched_mapreduce_cuda(f, op, xs: Pytree) -> Pytree:
    """K7m: per-row op-reduce of ``f(x)`` over ``(B, n)`` leaves, B, n >= 1."""
    if not pytree.tree_leaves(xs)[0].is_cuda:
        return batched_mapreduce_plain(f, op, xs)
    what = "mapreduce@batched (cuda)"
    if not op.commutative:
        raise NotImplementedError(
            f"{what}: the kernel folds rows in no fixed order, so it takes "
            f"commutative operators only, got {op.name!r}")
    code, values, mask = map_operands(what, f, xs)
    op_code, dt_code = _lib.op_codes(what, op, [values])
    operands = [values] + ([mask] if mask is not None else [])
    if values.ndim != 2 or 0 in values.shape:
        raise ValueError(f"{what}: takes non-empty (B, n) leaves, got "
                         f"{tuple(values.shape)}")
    _lib.require_cuda(what, *operands)
    B, n = values.shape
    lib = _lib.library("batched.cu")
    out = torch.empty((B,), dtype=values.dtype, device=values.device)
    _lib.check(lib.rt_mapreduce_batched(
        op_code, dt_code, code, values.data_ptr(), _lib.ptr(mask),
        float(f.fill), B, n, out.data_ptr(), _lib.stream_ptr(values)), what)
    batched_mapreduce_cuda.launches += 1
    return out


batched_mapreduce_cuda.launches = 0
