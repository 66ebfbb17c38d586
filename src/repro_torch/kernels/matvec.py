"""Semiring matvec / vecmat kernel K4 and its plain versions.

* :func:`matvec_cuda` -- ``y[j] = op_i f(x[i], A[i, j])`` over a row-major
  ``(n, p)`` matrix (``csrc/matvec.cu``; replaces
  ``repro/kernels/matvec.py::matvec_pallas``).  Plain version:
  :func:`matvec_plain`.
* :func:`vecmat_cuda` -- ``z[i] = op_j f(A[i, j], x[j])`` (replaces
  ``vecmat_pallas``).  Plain version: :func:`vecmat_plain`.

``f`` takes the (vector, matrix) elements in the reference's order; with
``x=None`` it is instead a unary map of the matrix element alone -- the
``mapreduce(axis=0 / 1)`` forms.  The kernel runs ``f = TIMES`` (the
product) with a vector and ``f = IDENTITY`` without one; ``op`` is
ADD/MUL/MAX/MIN over int32 or float32.

Given CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts each wrapper's calls
that launched the kernel (one or two CUDA launches: the partials, and their
fold when the reduction axis was split over blocks).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import operators as alg
from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Pytree = Any


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


def _launch(entry, what, f, op, A, x, out_len, x_len):
    want = alg.IDENTITY if x is None else alg.TIMES
    if _lib.map_code(what, f) != _lib.MAP_CODES[want.name]:
        raise NotImplementedError(
            f"{what}: the kernel runs f = {want.name} "
            f"{'without' if x is None else 'with'} a vector, got {f.name!r}")
    code = _lib.MAP_CODES[want.name]
    operands = [A] + ([] if x is None else [x])
    op_code, dt_code = _lib.op_codes(what, op, operands[:1])
    if A.ndim != 2 or 0 in A.shape:
        raise ValueError(f"{what}: takes a non-empty (n, p) matrix, got "
                         f"{tuple(A.shape)}")
    if len(operands) == 2 and (x.dtype != A.dtype or x.shape != (x_len,)):
        raise ValueError(f"{what}: x must be a vector of A's dtype along "
                         f"the reduced axis, got {x.dtype} {tuple(x.shape)}")
    _lib.require_cuda(what, *operands)
    n, p = A.shape
    lib = _lib.library("matvec.cu")
    chunks = (lib.rt_matvec_chunks if entry == "rt_matvec"
              else lib.rt_vecmat_chunks)(n, p)
    out = torch.empty((out_len,), dtype=A.dtype, device=A.device)
    partials = torch.empty((chunks * out_len,), dtype=A.dtype,
                           device=A.device) if chunks > 1 else None
    _lib.check(getattr(lib, entry)(
        op_code, dt_code, code, A.data_ptr(),
        _lib.ptr(operands[1]) if len(operands) == 2 else None, n, p,
        _lib.ptr(partials), out.data_ptr(), _lib.stream_ptr(A)), what)
    return out


def matvec_cuda(f, op, A: torch.Tensor, x: torch.Tensor | None) -> Pytree:
    """K4 matvec: ``y[j] = op_i f(x[i], A[i, j])`` -> ``(p,)``."""
    if not A.is_cuda:
        return matvec_plain(f, op, A, x)
    out = _launch("rt_matvec", "matvec@flat (cuda)", f, op, A, x,
                  A.shape[1], A.shape[0])
    matvec_cuda.launches += 1
    return out


def vecmat_cuda(f, op, A: torch.Tensor, x: torch.Tensor | None) -> Pytree:
    """K4 vecmat: ``z[i] = op_j f(A[i, j], x[j])`` -> ``(n,)``."""
    if not A.is_cuda:
        return vecmat_plain(f, op, A, x)
    out = _launch("rt_vecmat", "vecmat@flat (cuda)", f, op, A, x,
                  A.shape[0], A.shape[1])
    vecmat_cuda.launches += 1
    return out


matvec_cuda.launches = 0
vecmat_cuda.launches = 0
