"""Semiring matvec / vecmat kernels K4 and K5, and their plain versions
(``csrc/matvec.cuh``).

* :func:`matvec_cuda` -- K4, ``y[j] = op_i f(x[i], A[i, j])`` over a
  row-major ``(n, p)`` matrix (replaces
  ``repro/kernels/matvec.py::matvec_pallas``).  Plain version:
  :func:`matvec_plain`.
* :func:`vecmat_cuda` -- K4, ``z[i] = op_j f(A[i, j], x[j])`` (replaces
  ``vecmat_pallas``).  Plain version: :func:`vecmat_plain`.
* :func:`matvec_packed_cuda` -- K5, the tall-narrow matvec for ``p <= 64``
  and commutative ``op`` (replaces ``matvec_packed_pallas``).  Plain
  version: :func:`matvec_packed_plain`.  :func:`uses_packed` is the route
  choice of ``matvec@flat``, as the reference's ``ops.py`` makes it.

``f`` is a :class:`~repro_torch.core.operators.DeviceMap` of the (vector,
matrix) elements in the reference's order (``TIMES`` for the ordinary
GEMV, ``PLUS`` for the tropical and log semirings); with ``x=None`` it is
instead a unary map of the matrix element alone -- the ``mapreduce(axis=0 /
1)`` forms.  K4 keeps row (column) order for operators that do not commute.

Given CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts each wrapper's calls
that launched the kernel (one or two CUDA launches: the partials, and their
fold when the reduction axis was split over blocks).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Pytree = Any

MATVEC, VECMAT, PACKED = 0, 1, 2      # the forms of csrc/matvec.cuh

# The reference's tall-narrow route (ops.py ``_matvec_pallas``): p <= 64
# columns, n >= 4 * 128 rows and a commutative operator go to K5.
PACKED_MAX_COLS = 64
PACKED_MIN_ROWS = 512


def uses_packed(n: int, p: int, op) -> bool:
    """Whether ``matvec@flat`` takes K5 for an ``(n, p)`` matrix."""
    return (p <= PACKED_MAX_COLS and n >= PACKED_MIN_ROWS
            and getattr(op, "commutative", False))


def matvec_plain(f, op, A: torch.Tensor, x: torch.Tensor | None) -> Pytree:
    """Plain version of K4 matvec: ``f`` on every element, then an ordered
    pairwise fold down each column."""
    if x is None:
        return ref.ref_matvec(lambda _x, a: f(a), op, A, A[:, 0])
    return ref.ref_matvec(f, op, A, x)


def vecmat_plain(f, op, A: torch.Tensor, x: torch.Tensor | None) -> Pytree:
    """Plain version of K4 vecmat: an ordered pairwise fold along each
    row."""
    if x is None:
        return ref.ref_vecmat(lambda a, _x: f(a), op, A, A[0])
    return ref.ref_vecmat(f, op, A, x)


def _launch(form, what, f, op, A, x):
    if A.ndim != 2 or 0 in A.shape:
        raise ValueError(f"{what}: takes a non-empty (n, p) matrix, got "
                         f"{tuple(A.shape)}")
    n, p = A.shape
    if x is not None and (x.dtype != A.dtype or x.shape != (
            (p,) if form == VECMAT else (n,))):
        raise ValueError(f"{what}: x must be a vector of A's dtype along "
                         f"the reduced axis, got {x.dtype} {tuple(x.shape)}")
    if x is None:
        likes = (A,)
    else:
        likes = (A, x) if form == VECMAT else (x, A)
    unit, out_dtypes, out_spec = _lib.map_unit("matvec", what, f, op, *likes)
    _lib.require_cuda(what, *likes)
    lib = _lib.load(unit)
    chunks = lib.rt_matvec_chunks(form, n, p)
    m = n if form == VECMAT else p
    outs = [torch.empty((m,), dtype=d, device=A.device) for d in out_dtypes]
    partials = _lib.scratch(chunks * m, len(out_dtypes), A) if chunks > 1 \
        else None
    _lib.check(lib.rt_matvec(
        form, A.data_ptr(), _lib.ptr(x), n, p, _lib.ptr(partials),
        _lib.leaf_ptrs(outs), _lib.stream_ptr(A)), what)
    return pytree.tree_unflatten(outs, out_spec)


def matvec_cuda(f, op, A: torch.Tensor, x: torch.Tensor | None) -> Pytree:
    """K4 matvec: ``y[j] = op_i f(x[i], A[i, j])`` -> ``(p,)``."""
    if not A.is_cuda:
        return matvec_plain(f, op, A, x)
    out = _launch(MATVEC, "matvec@flat (cuda)", f, op, A, x)
    matvec_cuda.launches += 1
    return out


def vecmat_cuda(f, op, A: torch.Tensor, x: torch.Tensor | None) -> Pytree:
    """K4 vecmat: ``z[i] = op_j f(A[i, j], x[j])`` -> ``(n,)``."""
    if not A.is_cuda:
        return vecmat_plain(f, op, A, x)
    out = _launch(VECMAT, "vecmat@flat (cuda)", f, op, A, x)
    vecmat_cuda.launches += 1
    return out


def matvec_packed_plain(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """Plain version of K5: the same function as K4's matvec, an ordered
    pairwise fold down each column."""
    return ref.ref_matvec(f, op, A, x)


def matvec_packed_cuda(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """K5: ``y[j] = op_i f(x[i], A[i, j])`` -> ``(p,)`` for ``p <= 64``,
    commutative ``op`` only."""
    if not A.is_cuda:
        return matvec_packed_plain(f, op, A, x)
    what = "matvec@flat packed (cuda)"
    if not getattr(op, "commutative", False):
        raise ValueError(
            f"{what}: the packed kernel interleaves row groups, so it takes "
            f"commutative operators only, got {op.name!r}; matvec_cuda keeps "
            f"row order")
    if A.ndim == 2 and A.shape[1] > PACKED_MAX_COLS:
        raise ValueError(f"{what}: takes at most {PACKED_MAX_COLS} columns, "
                         f"got {A.shape[1]}")
    out = _launch(PACKED, what, f, op, A, x)
    matvec_packed_cuda.launches += 1
    return out


matvec_cuda.launches = 0
vecmat_cuda.launches = 0
matvec_packed_cuda.launches = 0
