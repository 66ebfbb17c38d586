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
  The host plans the launch (:func:`rows_width`, :func:`rows_geometry`):
  LANES for short rows (4-32 lanes a row, folded by shuffles), BLOCK (a
  block a row) where B fills the card, SPLIT (rows cut into chunks whose
  partials the last block of a row folds in chunk order) where it does
  not; 16-byte loads where the leaves allow them.  Plain version:
  :func:`batched_mapreduce_plain`.  It refuses operators that do not
  commute; the registry reroutes those through K7s.
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
launches per call); ``form_launches`` counts K7m's launches by kind and
load width (``"lanes/4"``, ``"split/1"``, ...).
K7s's rows of at most one tile (the sampling path's (4, 64) nucleus scan)
take its single-tile form: one launch, one allocation (the output), the
pointers as scalar arguments, counted again in ``single_tile_launches``.

``nitem`` is a tuning policy's item count (None: 8): K7s's ``nitem_scan``,
the items a thread of a tile scans (a unit of its own), and K7m's
``nitem_reduce``, a split chunk's loads a thread, at least 4 ``nitem``
(SPLIT_LOADS at 8; host-side, the unit stays the default's).  K7's GEMVs
take ``rows``, the policy's ``matvec_rows`` / ``vecmat_rows``
(``matvec.geometry``).
"""
from __future__ import annotations

import ctypes
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


def batched_scan_cuda(op, xs: Pytree, *, inclusive: bool = True,
                      nitem: int | None = None) -> Pytree:
    """K7s: inclusive/exclusive scan along axis 1 of ``(B, n)`` leaves,
    independent per row, B, n >= 1."""
    leaves = (xs,) if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)
    x = leaves[0]
    if not x.is_cuda:
        return batched_scan_plain(op, xs, inclusive=inclusive)
    what = "scan@batched (cuda)"
    plan = _lib.plan("scan", what, op, xs, knob=nitem)
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


# K7m's kinds of launch (csrc/mapreduce.cuh: RowsKind) and its host plan.
LANES, BLOCK, SPLIT = 0, 1, 2
ROWS_KIND_NAMES = ("lanes", "block", "split")
ROWS_THREADS = 256            # a block (csrc/mapreduce.cuh: THREADS)
LANE_LOADS = 4                # loads a lane takes before a row takes more lanes
LANES_MAX = 32                # lanes a row, at most, under LANES
LANES_ROW_MAX = 512           # LANES takes rows of at most this many loads
# A split row's chunks hold SPLIT_LOADS loads a thread or more, and a row is
# cut into SPLIT_MIN chunks or none: below either a chunk's ticket and the
# fold cost more than the chunk saves (chip_smoke.py's k7m_sweep on the
# H100; its table and the rows where the rule is off the best are in
# PERF.md).
SPLIT_LOADS = 32
SPLIT_MIN = 4
MAX_GRID_X = 2**31 - 1


def rows_width(n: int, leaf_bytes, addresses) -> int:
    """Elements a load of a K7m row: the widest of 16, 8, 4, 2, 1 whose
    load of the widest leaf holds at most 16 bytes, that divides n (so
    every row starts aligned) and at whose load size every leaf's
    ``addresses`` is aligned.  A misaligned or odd-length leaf takes a
    narrower load; nothing is copied."""
    w = 16 // max(leaf_bytes)
    while w > 1 and (n % w or any(a % (w * b)
                                  for a, b in zip(addresses, leaf_bytes))):
        w //= 2
    return w


def rows_geometry(B: int, n: int, vec: int, *, sms: int,
                  split_loads: int = SPLIT_LOADS) -> tuple[int, ...]:
    """K7m's launch over ``B`` rows of ``n`` elements, ``vec`` a load, on a
    card of ``sms`` multiprocessors: the seven longs of ``csrc/
    mapreduce.cuh``'s ``RowsGeometry`` -- (kind, vec, lanes, B, n, chunks,
    per_chunk), per_chunk in loads.

    * LANES, a row of at most LANES_ROW_MAX loads: a power of two of 4 to
      32 lanes a row, LANE_LOADS loads a lane or more.
    * BLOCK, a longer row: a block a row, where B alone fills the card or
      the rows are too short to cut.
    * SPLIT: rows cut into chunks, a block each, until the grid has
      ``matvec.BLOCKS_PER_SM`` blocks a multiprocessor (the GEMVs'
      target), each thread ``split_loads`` (SPLIT_LOADS) loads of its
      chunk or more, and SPLIT_MIN chunks a row or more.
    """
    loads = n // vec
    if loads <= LANES_ROW_MAX:
        lanes = min(LANES_MAX, max(4, 1 << (max(1, loads // LANE_LOADS)
                                            .bit_length() - 1)))
        return (LANES, vec, lanes, B, n, 1, loads)
    chunks = min(max(1, -(-matvec_k.BLOCKS_PER_SM * sms // B)),
                 max(1, loads // (ROWS_THREADS * split_loads)),
                 matvec_k.MAX_GRID_Y)
    per = -(-loads // chunks)
    chunks = -(-loads // per)
    if chunks < SPLIT_MIN:
        chunks, per = 1, loads
    return (SPLIT if chunks > 1 else BLOCK, vec, ROWS_THREADS, B, n, chunks,
            per)


class _RowsCall:
    """A K7m launch of one (plan, shape, leaf alignment, device), resolved
    once: its geometry (and the address of the ctypes array C reads it
    from), its name for the counters, a one-element template of a
    single-leaf output, and the workspace it needs."""

    __slots__ = ("geo", "geo_array", "geo_ptr", "name", "template",
                 "partial_bytes")


_ROWS_CALLS: dict[tuple, _RowsCall] = {}
_GEO_ARRAY = ctypes.c_long * 7
form_launches: dict[str, int] = {}


def _rows_call(key, plan, leaves) -> _RowsCall:
    x = leaves[0]
    B, n = x.shape
    vec = rows_width(n, [l.element_size() for l in leaves],
                     [l.data_ptr() for l in leaves])
    c = _RowsCall()
    c.geo = rows_geometry(B, n, vec, sms=matvec_k.sms(x.get_device()),
                          split_loads=key[-1])
    c.geo_array = _GEO_ARRAY(*c.geo)
    c.geo_ptr = ctypes.addressof(c.geo_array)
    c.name = f"{ROWS_KIND_NAMES[c.geo[0]]}/{vec}"
    c.template = x.new_empty(1, dtype=plan.out_dtypes[0]).expand(B) \
        if len(plan.out_dtypes) == 1 else None
    c.partial_bytes = B * c.geo[5] * plan.elem_bytes if c.geo[5] > 1 else 0
    if len(_ROWS_CALLS) >= matvec_k.MAX_CALLS:
        _ROWS_CALLS.clear()
    _ROWS_CALLS[key] = c
    return c


def batched_mapreduce_cuda(f, op, xs: Pytree, *,
                           nitem: int | None = None) -> Pytree:
    """K7m: per-row op-reduce of ``f(x)`` over ``(B, n)`` leaves, B, n >= 1:
    one launch of the kind the host plans (:func:`rows_geometry`), one
    allocation (the outputs)."""
    leaves = (xs,) if isinstance(xs, torch.Tensor) else xs if \
        _lib._sig(xs) is not None else pytree.tree_leaves(xs)
    x = leaves[0]
    if not x.is_cuda:
        return batched_mapreduce_plain(f, op, xs)
    what = "mapreduce@batched (cuda)"
    if not op.commutative:
        raise NotImplementedError(
            f"{what}: the kernel folds a row's elements across threads, so "
            f"it takes commutative operators only, got {op.name!r}")
    plan = _lib.plan("mapreduce", what, op, xs, f)
    shape = x.shape
    if len(shape) != 2 or 0 in shape or any(l.shape != shape
                                            for l in leaves[1:]):
        raise ValueError(f"{what}: takes non-empty (B, n) leaves of one "
                         f"shape, got {[tuple(l.shape) for l in leaves]}")
    if shape[0] > MAX_GRID_X:
        raise ValueError(f"{what}: B = {shape[0]} exceeds the grid's "
                         f"{MAX_GRID_X} rows")
    _lib.require_cuda(what, *leaves)
    key = (plan, shape, tuple(l.data_ptr() % 16 for l in leaves),
           x.get_device(), SPLIT_LOADS if nitem is None else 4 * nitem)
    call = _ROWS_CALLS.get(key) or _rows_call(key, plan, leaves)
    lib = plan.lib or plan.load()
    outs = [torch.empty_like(call.template)] if call.template is not None \
        else _lib.outputs(x, plan.out_dtypes, shape[:1])
    stream = _lib.stream_ptr(x)
    counters = partials = None
    if call.partial_bytes:
        w = _lib.workspace(x, stream, shape[0], call.partial_bytes)
        counters, partials = w.counters.data_ptr(), w.partials.data_ptr()
    _lib.check(lib.rt_mapreduce_rows(*_lib.ptrs(leaves), *_lib.ptrs(outs),
                                     call.geo_ptr, counters, partials,
                                     stream), what)
    batched_mapreduce_cuda.launches += 1
    form_launches[call.name] = form_launches.get(call.name, 0) + 1
    return plan.outputs(outs)


batched_mapreduce_cuda.launches = 0


def batched_matvec_plain(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """Plain version of K7's matvec: ``f`` on every element, then an
    ordered pairwise fold down each batch's columns."""
    return ref.ref_fold(op, f(x[:, :, None], A), axis=1)


def batched_vecmat_plain(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """Plain version of K7's vecmat: an ordered pairwise fold along each
    batch's rows."""
    return ref.ref_fold(op, f(A, x[:, None, :]), axis=2)


def batched_matvec_cuda(f, op, A: torch.Tensor, x: torch.Tensor, *,
                        rows: int | None = None) -> Pytree:
    """K7 matvec: ``(B, n, p)`` x ``(B, n)`` -> ``(B, p)``, B, n, p >= 1."""
    if not A.is_cuda:
        return batched_matvec_plain(f, op, A, x)
    out = matvec_k.launch(matvec_k.MATVEC, "matvec@batched (cuda)", f, op,
                          A, x, batched=True, rows=rows)
    batched_matvec_cuda.launches += 1
    return out


def batched_vecmat_cuda(f, op, A: torch.Tensor, x: torch.Tensor, *,
                        rows: int | None = None) -> Pytree:
    """K7 vecmat: ``(B, n, p)`` x ``(B, p)`` -> ``(B, n)``, B, n, p >= 1."""
    if not A.is_cuda:
        return batched_vecmat_plain(f, op, A, x)
    out = matvec_k.launch(matvec_k.VECMAT, "vecmat@batched (cuda)", f, op,
                          A, x, batched=True, rows=rows)
    batched_vecmat_cuda.launches += 1
    return out


def batched_matvec_quantized_plain(f, op, q, x: torch.Tensor) -> Pytree:
    """Plain version of K9's batched matvec: dequantize, then fold."""
    return batched_matvec_plain(f, op, q.dequantize(), x)


def batched_vecmat_quantized_plain(f, op, q, x: torch.Tensor) -> Pytree:
    """Plain version of K9's batched vecmat: dequantize, then fold."""
    return batched_vecmat_plain(f, op, q.dequantize(), x)


def batched_matvec_quantized_cuda(f, op, q, x: torch.Tensor, *,
                                  rows: int | None = None) -> Pytree:
    """K9 batched matvec over a ``(B, n, p)`` Quantized matrix and float32
    ``(B, n)`` vectors -> ``(B, p)``."""
    what = "matvec@batched quantized (cuda)"
    matvec_k.require_quantized(what, q)
    if not q.values.is_cuda:
        return batched_matvec_quantized_plain(f, op, q, x)
    out = matvec_k.launch(matvec_k.MATVEC, what, f, op, q, x, batched=True,
                          rows=rows)
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
