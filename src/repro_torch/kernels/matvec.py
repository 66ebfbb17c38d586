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
on it.  Every call is one CUDA launch.  The host plans it:
:func:`geometry` picks the kind of launch (``COLUMNS`` for a matvec,
``ROWS`` or, over at most 64 dense columns, ``TALL`` for a vecmat,
``PACKED`` for K5), the load width (16-byte loads of 4-byte leaves where
``A`` is 16-byte aligned, else one element a load) and the chunks of the
reduction axis; a chunked launch keeps its partials and tickets in the
stream's workspace (``_lib.workspace``), and its last block folds them.
:func:`resolve` keeps each call's launch (its ``_lib.plan`` -- the unit,
the output's dtypes and the loaded library -- and its geometry), so a call
allocates once (its outputs) and makes one ctypes call.

``f`` is a :class:`~repro_torch.core.operators.DeviceMap` of the (vector,
matrix) elements in the reference's order (``TIMES`` for the ordinary
GEMV, ``PLUS`` for the tropical and log semirings); with ``x=None`` it is
instead a unary map of the matrix element alone -- the ``mapreduce(axis=0 /
1)`` forms.  K4 keeps row (column) order for operators that do not commute.

Given CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts each wrapper's calls
that launched the kernel; ``form_launches`` counts every launch of this
module by kind and load width (``"columns/4"``, ``"tall/1"``, ...).
"""
from __future__ import annotations

import ctypes
import math
from typing import Any

import torch

from repro_torch.core import operators as alg
from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Pytree = Any

MATVEC, VECMAT, PACKED = 0, 1, 2      # what a wrapper asks launch() for
# The kinds of launch of csrc/matvec.cuh (its enum Kind).
COLUMNS, ROWS, PACKED_STREAM, TALL = 0, 1, 2, 3
KIND_NAMES = ("columns", "rows", "packed", "tall")

# The reference's tall-narrow route (ops.py ``_matvec_pallas``): p <= 64
# columns, n >= 4 * 128 rows and a commutative operator go to K5.
PACKED_MAX_COLS = 64
PACKED_MIN_ROWS = 512

THREADS = 256                 # a block (csrc/matvec.cuh: THREADS)
# COLUMNS cuts the rows until this many threads a multiprocessor (half of
# Hopper's resident ones) walk them; ROWS and PACKED cut the reduction axis
# until the grid has this many blocks a multiprocessor.
THREADS_PER_SM = 1024
BLOCKS_PER_SM = 4
MIN_STEPS = 8                 # reduction steps a thread takes, at least
MAX_GRID_Y = 65535
TALL_BYTES = 16384            # TALL's shared tile (csrc/matvec.cuh)
WIDE = 4                      # elements per 16-byte load of 4-byte leaves


def uses_packed(n: int, p: int, op) -> bool:
    """Whether ``matvec@flat`` takes K5 for an ``(n, p)`` matrix."""
    return (p <= PACKED_MAX_COLS and n >= PACKED_MIN_ROWS
            and getattr(op, "commutative", False))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def launch_kind(form: int, p: int) -> int:
    """The kind of launch of a dense ``form`` over ``p`` columns: COLUMNS
    for a matvec, PACKED_STREAM for K5, TALL for a vecmat over at most 64
    columns, ROWS for a wider one."""
    if form == MATVEC:
        return COLUMNS
    if form == PACKED:
        return PACKED_STREAM
    return TALL if p <= PACKED_MAX_COLS else ROWS


def load_width(kind: int, p: int, wide: bool, aligned: bool) -> int:
    """Elements per load: WIDE (16 bytes) where the plan allows it
    (``wide``: 4-byte leaves, an output element of at most 16 bytes), A
    is 16-byte ``aligned`` and, for COLUMNS and ROWS, whose loads start at
    every row, p % 4 == 0; else one."""
    return WIDE if wide and aligned and (
        p % 4 == 0 or kind in (PACKED_STREAM, TALL)) else 1


def geometry(kind: int, B: int, n: int, p: int, vec: int, *, sms: int,
             itemsize: int = 4, quantized: bool = False) -> tuple[int, ...]:
    """The launch of one ``kind`` over ``B`` matrices of ``(n, p)``
    elements of ``itemsize`` bytes, ``vec`` of them a load, on a card of
    ``sms`` multiprocessors: the nine longs of ``csrc/matvec.cuh``'s
    ``Geometry`` -- (kind, vec, width, B, n, p, tiles, chunks, per_chunk).
    The targets scale with the card: TARGET_THREADS = THREADS_PER_SM sms
    threads, TARGET_BLOCKS = BLOCKS_PER_SM sms blocks.

    * COLUMNS (matvec): ``width`` column threads by 256 / width row groups
      a block; the rows split until about TARGET_THREADS threads walk them,
      at least MIN_STEPS rows each, so few rows (n = 10) take one group and
      one chunk: each thread walks all n rows of its columns.
    * ROWS (vecmat, p > 64 or a quantized matrix): ``width`` lanes a row,
      enough for MIN_STEPS loads a lane, up to the whole block; a
      ``quantized`` row (a code word and a scale vector a load) takes one
      warp unless its rows would fill fewer than TARGET_BLOCKS blocks that
      way.  The columns split into chunks while the grid has fewer than
      TARGET_BLOCKS blocks.
    * PACKED (K5): ``width`` threads read the flat stream, a step of width
      vec elements a multiple of p and vec; chunks of whole steps.
    * TALL (vecmat over p <= 64 dense columns): ``width`` rows a block, a
      multiple of 4, R p elements within TALL_BYTES; ``tiles`` over all
      B n rows, one chunk.
    """
    target_threads, target_blocks = THREADS_PER_SM * sms, BLOCKS_PER_SM * sms
    per = 0
    if kind == COLUMNS:
        cols = _cdiv(p, vec)
        split = min(max(1, _cdiv(target_threads, B * cols)),
                    max(1, n // MIN_STEPS))
        groups, chunks = (_pow2_ceil(split), 1) if split <= 8 else \
            (8, min(_cdiv(split, 8), MAX_GRID_Y))
        width = THREADS // groups
        tiles = _cdiv(cols, width)
        per = _cdiv(n, chunks)
        chunks = _cdiv(n, per)
    elif kind == ROWS:
        steps = _cdiv(p, vec)
        width = min(THREADS, _pow2_floor(steps // MIN_STEPS))
        if quantized and B * _cdiv(n, THREADS // 32) >= target_blocks:
            width = min(width, 32)
        tiles = _cdiv(n, THREADS // width)
        chunks = min(max(1, _cdiv(target_blocks, B * tiles)),
                     max(1, steps // (MIN_STEPS * width)), MAX_GRID_Y)
        step = width * vec
        per = _cdiv(_cdiv(p, chunks), step) * step
        chunks = _cdiv(p, per)
    elif kind == PACKED_STREAM:
        lcm = math.lcm(vec, p)
        S = THREADS * vec // lcm * lcm
        width, tiles, total = S // vec, 1, n * p
        chunks = min(target_blocks, max(1, total // (MIN_STEPS * S)),
                     MAX_GRID_Y)
        per = _cdiv(_cdiv(total, chunks), S) * S
        chunks = _cdiv(total, per)
    elif kind == TALL:
        width = min(THREADS, TALL_BYTES // (itemsize * p)) // 4 * 4
        tiles, chunks = _cdiv(B * n, width), 1
    else:
        raise ValueError(f"no launch kind {kind}")
    return (kind, vec, width, B, n, p, tiles, chunks, per)


_GEO_ARRAY = ctypes.c_long * 9


def sms(device: int) -> int:
    """The streaming multiprocessors of CUDA ``device``, asked once."""
    found = _SMS.get(device)
    if found is None:
        found = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return found


_SMS: dict[int, int] = {}


form_launches: dict[str, int] = {}
_F32 = torch.empty(0)         # a quantized operand's element, as the map sees it


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
    call = resolve(form, what, f, op, A, x, batched)
    plan = call.plan
    lib = plan.lib or plan.load()
    M = A if call.quant is None else A.values
    outs = [torch.empty_like(call.template)] if call.template is not None \
        else _lib.outputs(M, plan.out_dtypes, call.out_shape)
    stream = _lib.stream_ptr(M)
    counters = partials = None
    if call.partial_bytes:
        w = _lib.workspace(M, stream, call.grid_x, call.partial_bytes)
        counters, partials = w.counters.data_ptr(), w.partials.data_ptr()
    if call.quant is None:
        ins = (A.data_ptr(),) if x is None else (
            (A.data_ptr(), x.data_ptr()) if form == VECMAT
            else (x.data_ptr(), A.data_ptr()))
        rc = lib.rt_gemv(*ins, *[o.data_ptr() for o in outs], call.geo_ptr,
                         counters, partials, stream)
    else:
        if call.realign:
            # The kernel loads four codes and four scales at a time.
            A = alg.Quantized(A.values.clone(), A.scales.clone(), A.block,
                              A.mode)
        rc = lib.rt_qmatvec(call.geo_ptr, A.values.data_ptr(),
                            A.scales.data_ptr(), A.block, _lib.ptr(x),
                            counters, partials, _lib.leaf_ptrs(outs), stream)
    _lib.check(rc, what)
    form_launches[call.name] = form_launches.get(call.name, 0) + 1
    return plan.outputs(outs)


class _Call:
    """A launch of one (form, operator, map, operand dtypes or quantization,
    shape, alignment, device), resolved once: its plan, geometry (and the
    address of the ctypes array C reads it from), the vector's dtype and
    shape, a one-element template of the output's shape (``empty_like`` of
    it is the cheapest allocation torch offers) and the workspace it
    needs."""

    __slots__ = ("plan", "quant", "realign", "geo", "geo_array", "geo_ptr",
                 "grid_x", "name", "x_dtype", "x_shape", "out_shape",
                 "template", "partial_bytes")


_CALLS: dict[tuple, _Call] = {}
MAX_CALLS = 4096              # resolved launches kept; then forgotten


def resolve(form, what, f, op, A, x, batched: bool = False) -> _Call:
    """The resolved launch of :func:`launch`'s call, found by its key and
    on a miss checked and built (:func:`_make_call`); then ``x`` and the
    operands checked as every call checks them.  Raises before anything is
    kept for a call that does not check."""
    if isinstance(A, alg.Quantized):
        M = A.values
        key = (form, id(op), id(f), A.mode, A.block, M.dtype, A.scales.dtype,
               M.shape, A.scales.shape, x is None, M.data_ptr() % 4 == 0 and
               A.scales.data_ptr() % 16 == 0, batched, M.get_device())
    else:
        M = A
        key = (form, id(op), id(f), A.dtype, A.shape, x is None,
               A.data_ptr() % 16 == 0, batched, A.get_device())
    call = _CALLS.get(key)
    if call is None:
        call = _make_call(key, form, what, f, op, A, x, batched)
    elif x is not None and (x.dtype != call.x_dtype or
                            x.shape != call.x_shape):
        _check_vector(what, call, x)
    if call.quant is not None:
        _lib.require_cuda(what, M, A.scales, *(() if x is None else (x,)))
    elif not M.is_contiguous() or x is not None and (
            not x.is_contiguous() or not x.is_cuda or
            x.get_device() != key[-1]):
        # raises, naming the fault
        _lib.require_cuda(what, M, *(() if x is None else (x,)))
    return call


def _check_vector(what: str, call: _Call, x: torch.Tensor) -> None:
    if x.dtype != call.x_dtype or x.shape != call.x_shape:
        dtype = "A's dtype" if call.quant is None else "float32"
        raise ValueError(f"{what}: x must be a vector of {dtype} along the "
                         f"reduced axis, {tuple(call.x_shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")


def _make_call(key, form, what, f, op, A, x, batched) -> _Call:
    quant = A.mode if isinstance(A, alg.Quantized) else None
    M = A if quant is None else A.values
    shape = M.shape
    if len(shape) != (3 if batched else 2) or 0 in shape:
        raise ValueError(f"{what}: takes a non-empty "
                         f"{'(B, n, p)' if batched else '(n, p)'} matrix, "
                         f"got {tuple(shape)}")
    B, n, p = shape if batched else (1, *shape)
    c = _Call()
    c.quant = quant
    c.x_dtype = A.dtype if quant is None else torch.float32
    c.x_shape = shape[:-2] + ((p,) if form == VECMAT else (n,))
    if x is not None:
        _check_vector(what, c, x)
    aligned = key[-3]
    if quant is None:
        _lib.require_cuda(what, A, *(() if x is None else (x,)))
        c.plan = _lib.plan("matvec", what, op, (A,) if x is None else (
            (A, x) if form == VECMAT else (x, A)), f, spread=True)
        elem_bytes = c.plan.elem_bytes
        kind = launch_kind(form, p)
        vec = load_width(kind, p, A.element_size() == 4 and elem_bytes <= 16,
                         aligned)
        c.realign = False
    else:
        codes = alg.QUANT_DEVICE[quant][0]
        scales = shape[:-2] + (_cdiv(n, A.block), p)
        if M.dtype != codes or A.scales.dtype != torch.float32 or \
                A.scales.shape != scales:
            raise ValueError(
                f"{what}: a {quant} operand holds {codes} codes and float32 "
                f"scales of shape {scales}, got {M.dtype} and "
                f"{A.scales.dtype} {tuple(A.scales.shape)}")
        _lib.require_cuda(what, M, A.scales, *(() if x is None else (x,)))
        c.plan = _lib.plan("qmatvec", what, op, (_F32,) if x is None else (
            (_F32, x) if form == VECMAT else (x, _F32)), f, spread=True,
            quant=quant)
        elem_bytes = c.plan.elem_bytes
        kind = COLUMNS if form == MATVEC else ROWS
        vec = WIDE if p % 4 == 0 else 1
        c.realign = vec == WIDE and not aligned
    c.geo = geometry(kind, B, n, p, vec, sms=sms(M.get_device()),
                     itemsize=M.element_size(), quantized=quant is not None)
    c.geo_array = _GEO_ARRAY(*c.geo)
    c.geo_ptr = ctypes.addressof(c.geo_array)
    c.grid_x = c.geo[6] if kind == TALL else B * c.geo[6]
    c.name = f"{KIND_NAMES[kind]}/{vec}"
    outs = n if form == VECMAT else p
    c.out_shape = shape[:-2] + (outs,)
    c.template = M.new_empty(1, dtype=c.plan.out_dtypes[0]).expand(
        c.out_shape) if len(c.plan.out_dtypes) == 1 else None
    c.partial_bytes = c.geo[7] * B * outs * elem_bytes if c.geo[7] > 1 else 0
    if len(_CALLS) >= MAX_CALLS:
        _CALLS.clear()
    _CALLS[key] = c
    return c


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
