"""Semiring matvec / vecmat kernels K4, K5 and K9 (flat), and their plain
versions (``csrc/matvec.cuh``).

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
* :func:`matvec_quantized_cuda` / :func:`vecmat_quantized_cuda` -- K9, the
  same forms over a :class:`~repro_torch.core.operators.Quantized` matrix:
  int8 or fp8 codes decoded in registers, times their block's scale, f32
  accumulation (replaces ``matvec_quantized_pallas`` /
  ``vecmat_quantized_pallas``).  Plain versions:
  :func:`matvec_quantized_plain` / :func:`vecmat_quantized_plain`, which
  dequantize, then fold in order, like the reference's ``_matvec_xla``.

:func:`launch` is the launcher of every form, flat and batched, dense and
quantized; ``kernels/batched.py`` builds K7's GEMVs and K9's batched forms
on it.

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

from repro_torch.core import operators as alg
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


def launch(form, what, f, op, A, x, *, batched: bool = False) -> Pytree:
    """One call of ``csrc/matvec.cuh``'s ``form`` over a dense tensor or a
    :class:`~repro_torch.core.operators.Quantized` ``A`` of shape ``(n, p)``
    (``batched``: ``(B, n, p)``, with ``B`` vectors ``x``), non-empty."""
    quant = isinstance(A, alg.Quantized)
    shape = tuple(A.shape)
    if len(shape) != (3 if batched else 2) or 0 in shape:
        raise ValueError(f"{what}: takes a non-empty "
                         f"{'(B, n, p)' if batched else '(n, p)'} matrix, "
                         f"got {shape}")
    B, n, p = shape if batched else (1, *shape)
    lead = shape[:1] if batched else ()
    if x is not None and (x.dtype != A.dtype or tuple(x.shape) != lead + (
            (p,) if form == VECMAT else (n,))):
        raise ValueError(f"{what}: x must be a vector of A's dtype along "
                         f"the reduced axis, got {x.dtype} {tuple(x.shape)}")
    tensors = [A.values, A.scales] if quant else [A]
    if quant:
        codes = alg.QUANT_DEVICE[A.mode][0]
        nb = -(-n // A.block)
        if A.values.dtype != codes or A.scales.dtype != torch.float32 or \
                tuple(A.scales.shape) != lead + (nb, p):
            raise ValueError(
                f"{what}: a {A.mode} operand holds {codes} codes and float32 "
                f"scales of shape {lead + (nb, p)}, got "
                f"{A.values.dtype} and {A.scales.dtype} "
                f"{tuple(A.scales.shape)}")
        if p % 4 == 0 and (A.values.data_ptr() % 4 or
                           A.scales.data_ptr() % 16):
            # The kernel loads four codes and four scales at a time.
            A = alg.Quantized(A.values.clone(), A.scales.clone(), A.block,
                              A.mode)
            tensors = [A.values, A.scales]
        mat = torch.empty(0, dtype=torch.float32)   # the map sees f32
    else:
        mat = A
    if x is None:
        likes = (mat,)
    else:
        likes = (mat, x) if form == VECMAT else (x, mat)
        tensors.append(x)
    unit, out_dtypes, out_spec = _lib.map_unit(
        "qmatvec" if quant else "matvec", what, f, op, *likes,
        quant=A.mode if quant else None)
    _lib.require_cuda(what, *tensors)
    lib = _lib.load(unit)
    chunks = lib.rt_matvec_chunks(form, B, n, p)
    out_shape = lead + ((n,) if form == VECMAT else (p,))
    dev = tensors[0].device
    outs = [torch.empty(out_shape, dtype=d, device=dev) for d in out_dtypes]
    partials = _lib.scratch(chunks * B * out_shape[-1], len(out_dtypes),
                            tensors[0]) if chunks > 1 else None
    stream = _lib.stream_ptr(tensors[0])
    if quant:
        err = lib.rt_qmatvec(
            form, A.values.data_ptr(), A.scales.data_ptr(), A.block,
            _lib.ptr(x), B, n, p, _lib.ptr(partials), _lib.leaf_ptrs(outs),
            stream)
    else:
        err = lib.rt_matvec(
            form, A.data_ptr(), _lib.ptr(x), B, n, p, _lib.ptr(partials),
            _lib.leaf_ptrs(outs), stream)
    _lib.check(err, what)
    return pytree.tree_unflatten(outs, out_spec)


def matvec_cuda(f, op, A: torch.Tensor, x: torch.Tensor | None) -> Pytree:
    """K4 matvec: ``y[j] = op_i f(x[i], A[i, j])`` -> ``(p,)``."""
    if not A.is_cuda:
        return matvec_plain(f, op, A, x)
    out = launch(MATVEC, "matvec@flat (cuda)", f, op, A, x)
    matvec_cuda.launches += 1
    return out


def vecmat_cuda(f, op, A: torch.Tensor, x: torch.Tensor | None) -> Pytree:
    """K4 vecmat: ``z[i] = op_j f(A[i, j], x[j])`` -> ``(n,)``."""
    if not A.is_cuda:
        return vecmat_plain(f, op, A, x)
    out = launch(VECMAT, "vecmat@flat (cuda)", f, op, A, x)
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
    out = launch(PACKED, what, f, op, A, x)
    matvec_packed_cuda.launches += 1
    return out


def require_quantized(what: str, q) -> None:
    if not isinstance(q, alg.Quantized):
        raise TypeError(f"{what}: takes a Quantized matrix operand, got "
                        f"{type(q).__name__}")


def matvec_quantized_plain(f, op, q, x: torch.Tensor) -> Pytree:
    """Plain version of K9 matvec: dequantize, then K4's plain fold."""
    return matvec_plain(f, op, q.dequantize(), x)


def vecmat_quantized_plain(f, op, q, x: torch.Tensor) -> Pytree:
    """Plain version of K9 vecmat: dequantize, then K4's plain fold."""
    return vecmat_plain(f, op, q.dequantize(), x)


def matvec_quantized_cuda(f, op, q, x: torch.Tensor) -> Pytree:
    """K9 matvec: ``y[j] = op_i f(x[i], deq(q)[i, j])`` -> ``(p,)``; ``x``
    float32."""
    what = "matvec@flat quantized (cuda)"
    require_quantized(what, q)
    if not q.values.is_cuda:
        return matvec_quantized_plain(f, op, q, x)
    out = launch(MATVEC, what, f, op, q, x)
    matvec_quantized_cuda.launches += 1
    return out


def vecmat_quantized_cuda(f, op, q, x: torch.Tensor) -> Pytree:
    """K9 vecmat: ``z[i] = op_j f(deq(q)[i, j], x[j])`` -> ``(n,)``; ``x``
    float32."""
    what = "vecmat@flat quantized (cuda)"
    require_quantized(what, q)
    if not q.values.is_cuda:
        return vecmat_quantized_plain(f, op, q, x)
    out = launch(VECMAT, what, f, op, q, x)
    vecmat_quantized_cuda.launches += 1
    return out


matvec_cuda.launches = 0
vecmat_cuda.launches = 0
matvec_packed_cuda.launches = 0
matvec_quantized_cuda.launches = 0
vecmat_quantized_cuda.launches = 0
