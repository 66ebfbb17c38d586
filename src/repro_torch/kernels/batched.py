"""Batched kernels K7s (scan), K7m (mapreduce), K7's GEMVs and K9's batched
forms, each with its plain version (``csrc/scan.cuh``,
``csrc/mapreduce.cuh``, ``csrc/matvec.cuh``).

* :func:`batched_scan_cuda` -- per-row prefix scan of ``(B, n)`` leaves
  under any operator with a device form, AFFINE included (replaces
  ``repro/kernels/batched.py::batched_scan_pallas``).  Plain version:
  :func:`batched_scan_plain`, the row-by-row reference scan.
* :func:`batched_mapreduce_cuda` -- per-row commutative op-reduce of
  ``f(x)`` over ``(B, n)`` leaves -> ``(B,)``, one launch for the whole
  batch (replaces ``batched_mapreduce_pallas``).  ``f`` is a
  :class:`~repro_torch.core.operators.DeviceMap`, run inside the kernel.
  Plain version: :func:`batched_mapreduce_plain`.  It refuses operators
  that do not commute; the registry reroutes those through K7s.
* :func:`batched_matvec_cuda` / :func:`batched_vecmat_cuda` -- K7's GEMVs,
  ``y[b, j] = op_i f(x[b, i], A[b, i, j])`` and ``z[b, i] = op_j f(A[b, i,
  j], x[b, j])`` over ``(B, n, p)`` matrices, one launch for the whole
  batch (``matvec.launch``); rows (columns) fold in
  order, so any operator with a device form runs (replaces
  ``batched_matvec_pallas`` / ``batched_vecmat_pallas``).  Plain versions:
  :func:`batched_matvec_plain` / :func:`batched_vecmat_plain`.
* :func:`batched_matvec_quantized_cuda` /
  :func:`batched_vecmat_quantized_cuda` -- K9 over a ``(B, n, p)``
  :class:`~repro_torch.core.operators.Quantized` matrix (replaces
  ``batched_matvec_quantized_pallas`` / ``batched_vecmat_quantized_pallas``).
  Plain versions: dequantize, then the batched plain fold.

Given CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts each wrapper's calls
that launched its kernel (K7s above one tile per row issues three CUDA
launches per call).
K7s's rows of at most one tile (the sampling path's (4, 64) nucleus scan)
take its single-tile form: one launch, one allocation (the output), the
pointers as scalar arguments, counted again in ``single_tile_launches``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _lib
from repro_torch.kernels import matvec as matvec_k
from repro_torch.kernels import ref

Pytree = Any


def batched_scan_plain(op, xs: Pytree, *, inclusive: bool = True) -> Pytree:
    """Plain version of K7s: the reference scan of each row."""
    return ref.ref_batched_scan(op, xs, inclusive=inclusive)


def batched_scan_cuda(op, xs: Pytree, *, inclusive: bool = True) -> Pytree:
    """K7s: inclusive/exclusive scan along axis 1 of ``(B, n)`` leaves,
    independent per row, B, n >= 1."""
    leaves = (xs,) if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)
    x = leaves[0]
    if not x.is_cuda:
        return batched_scan_plain(op, xs, inclusive=inclusive)
    what = "scan@batched (cuda)"
    plan = _lib.plan("scan", what, op, xs)
    shape = x.shape
    if len(shape) != 2 or 0 in shape or len(leaves) > 1 and any(
            l.shape != shape for l in leaves):
        raise ValueError(f"{what}: takes non-empty (B, n) leaves of one "
                         f"shape, got {[tuple(l.shape) for l in leaves]}")
    _lib.require_cuda(what, *leaves)
    B, n = shape
    if B > 65535:
        raise ValueError(f"{what}: B = {B} exceeds the grid's 65535 rows")
    lib = plan.lib or plan.load()
    outs = [torch.empty_like(l) for l in leaves]
    if n <= plan.limit:
        _lib.check(lib.rt_scan_tile(
            *_lib.ptrs((*leaves, *outs)), B, n, int(inclusive),
            _lib.stream_ptr(x)), what)
        batched_scan_cuda.single_tile_launches += 1
    else:
        scratch = _lib.scratch(B * -(-n // plan.limit), len(leaves), x)
        _lib.check(lib.rt_scan_rows(
            _lib.leaf_ptrs(leaves), _lib.leaf_ptrs(outs), B, n,
            int(inclusive), scratch.data_ptr(), _lib.stream_ptr(x)), what)
    batched_scan_cuda.launches += 1
    return plan.outputs(outs)


batched_scan_cuda.launches = 0
batched_scan_cuda.single_tile_launches = 0


def batched_mapreduce_plain(f, op, xs: Pytree) -> Pytree:
    """Plain version of K7m: ``f`` then an ordered pairwise fold per row."""
    return ref.ref_fold(op, f(xs), axis=1)


def batched_mapreduce_cuda(f, op, xs: Pytree) -> Pytree:
    """K7m: per-row op-reduce of ``f(x)`` over ``(B, n)`` leaves, B, n >= 1."""
    leaves = pytree.tree_leaves(xs)
    if not leaves[0].is_cuda:
        return batched_mapreduce_plain(f, op, xs)
    what = "mapreduce@batched (cuda)"
    if not op.commutative:
        raise NotImplementedError(
            f"{what}: the kernel folds rows in no fixed order, so it takes "
            f"commutative operators only, got {op.name!r}")
    unit, out_dtypes, out_spec = _lib.map_unit("mapreduce", what, f, op, xs)
    shape = leaves[0].shape
    if any(l.shape != shape for l in leaves) or len(shape) != 2 \
            or 0 in shape:
        raise ValueError(f"{what}: takes non-empty (B, n) leaves of one "
                         f"shape, got {[tuple(l.shape) for l in leaves]}")
    _lib.require_cuda(what, *leaves)
    lib = _lib.load(unit)
    B, n = shape
    outs = [torch.empty((B,), dtype=d, device=leaves[0].device)
            for d in out_dtypes]
    _lib.check(lib.rt_mapreduce_rows(
        _lib.leaf_ptrs(leaves), B, n, _lib.leaf_ptrs(outs),
        _lib.stream_ptr(leaves[0])), what)
    batched_mapreduce_cuda.launches += 1
    return pytree.tree_unflatten(outs, out_spec)


batched_mapreduce_cuda.launches = 0


def batched_matvec_plain(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """Plain version of K7's matvec: ``f`` on every element, then an
    ordered pairwise fold down each batch's columns."""
    return ref.ref_fold(op, f(x[:, :, None], A), axis=1)


def batched_vecmat_plain(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """Plain version of K7's vecmat: an ordered pairwise fold along each
    batch's rows."""
    return ref.ref_fold(op, f(A, x[:, None, :]), axis=2)


def batched_matvec_cuda(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """K7 matvec: ``(B, n, p)`` x ``(B, n)`` -> ``(B, p)``, B, n, p >= 1."""
    if not A.is_cuda:
        return batched_matvec_plain(f, op, A, x)
    out = matvec_k.launch(matvec_k.MATVEC, "matvec@batched (cuda)", f, op,
                          A, x, batched=True)
    batched_matvec_cuda.launches += 1
    return out


def batched_vecmat_cuda(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """K7 vecmat: ``(B, n, p)`` x ``(B, p)`` -> ``(B, n)``, B, n, p >= 1."""
    if not A.is_cuda:
        return batched_vecmat_plain(f, op, A, x)
    out = matvec_k.launch(matvec_k.VECMAT, "vecmat@batched (cuda)", f, op,
                          A, x, batched=True)
    batched_vecmat_cuda.launches += 1
    return out


def batched_matvec_quantized_plain(f, op, q, x: torch.Tensor) -> Pytree:
    """Plain version of K9's batched matvec: dequantize, then fold."""
    return batched_matvec_plain(f, op, q.dequantize(), x)


def batched_vecmat_quantized_plain(f, op, q, x: torch.Tensor) -> Pytree:
    """Plain version of K9's batched vecmat: dequantize, then fold."""
    return batched_vecmat_plain(f, op, q.dequantize(), x)


def batched_matvec_quantized_cuda(f, op, q, x: torch.Tensor) -> Pytree:
    """K9 batched matvec over a ``(B, n, p)`` Quantized matrix and float32
    ``(B, n)`` vectors -> ``(B, p)``."""
    what = "matvec@batched quantized (cuda)"
    matvec_k.require_quantized(what, q)
    if not q.values.is_cuda:
        return batched_matvec_quantized_plain(f, op, q, x)
    out = matvec_k.launch(matvec_k.MATVEC, what, f, op, q, x, batched=True)
    batched_matvec_quantized_cuda.launches += 1
    return out


def batched_vecmat_quantized_cuda(f, op, q, x: torch.Tensor) -> Pytree:
    """K9 batched vecmat over a ``(B, n, p)`` Quantized matrix and float32
    ``(B, p)`` vectors -> ``(B, n)``."""
    what = "vecmat@batched quantized (cuda)"
    matvec_k.require_quantized(what, q)
    if not q.values.is_cuda:
        return batched_vecmat_quantized_plain(f, op, q, x)
    out = matvec_k.launch(matvec_k.VECMAT, what, f, op, q, x, batched=True)
    batched_vecmat_quantized_cuda.launches += 1
    return out


batched_matvec_cuda.launches = 0
batched_vecmat_cuda.launches = 0
batched_matvec_quantized_cuda.launches = 0
batched_vecmat_quantized_cuda.launches = 0
