"""Backend registration for every route of the slice.

The port of ``repro/kernels/ops.py``: ``IMPLS`` maps each route key
(``"scan@flat"``) to its per-backend implementations, and the module checks
at import that the table covers exactly the routes of the registry in
``core.intrinsics``.

* ``torch`` -- plain PyTorch, mirroring the reference's ``xla`` rows
  (``_scan_xla``, ``_mapreduce_xla``, ``_batched_mapreduce_xla``,
  ``_linrec_xla``); it runs on any device.
* ``cuda`` -- the hand-written kernels: K1 (``kernels/copy.py``), K2 and K6
  (``kernels/scan.py``), K3 (``kernels/mapreduce.py``), K7s, K7m, K7's
  GEMVs and K9's batched forms (``kernels/batched.py``), K4, K5 and K9's
  flat forms (``kernels/matvec.py``) and K8 (``kernels/segmented.py``),
  generated for whatever operator and map carry a device form.  A
  ``Quantized`` matrix operand takes K9 on every matvec / vecmat route,
  before the K5 route choice, as in the reference.  The shape handling around them (flips, axis moves, segment
  descriptors, the map of a segmented mapreduce) is plain tensor code here.

The radix-sort family (``kernels/sort.py``) is one composition registered
for both backends: its scan and mapreduce steps dispatch to the backend of
its own row, so ``cuda`` runs the kernels and ``torch`` the plain versions.

Validation, zero-extent guards and the reroute of non-commutative batched
mapreduces through ``scan@batched`` live in the registry's dispatch, so
these functions only see well-formed, non-empty problems through the public
API.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import intrinsics as ki
from repro_torch.core import operators as alg
from repro_torch.kernels import batched as batched_k
from repro_torch.kernels import copy as copy_k
from repro_torch.kernels import mapreduce as mapreduce_k
from repro_torch.kernels import matvec as matvec_k
from repro_torch.kernels import ref
from repro_torch.kernels import scan as scan_k
from repro_torch.kernels import segmented as seg_k
from repro_torch.kernels import sort as sort_k

Pytree = Any

# Standard algebra over one plain tensor: the torch rows take the library
# reduction, as the reference's xla rows take jnp's.
_DIRECT = {
    "add": lambda v, dim: v.sum(dim=dim, dtype=v.dtype),
    "mul": lambda v, dim: v.prod(dim=dim, dtype=v.dtype),
    "max": lambda v, dim: v.amax() if dim is None else v.amax(dim=dim),
    "min": lambda v, dim: v.amin() if dim is None else v.amin(dim=dim),
}


# ---------------------------------------------------------------------------
# copy@flat
# ---------------------------------------------------------------------------


def _copy_torch(x, *, nitem=None):
    return ref.ref_copy(x)


def _copy_cuda(x, *, nitem=None):
    return copy_k.copy_cuda(x.contiguous(), nitem=nitem)


# ---------------------------------------------------------------------------
# scan@flat
# ---------------------------------------------------------------------------


def _scan_torch(op, xs, *, axis=0, inclusive=True, reverse=False):
    return ref.ref_scan(op, xs, axis=axis, inclusive=inclusive,
                        reverse=reverse)


def _scan_cuda(op, xs, *, axis=0, inclusive=True, reverse=False):
    leaves, spec = pytree.tree_flatten(xs)
    ndim = leaves[0].ndim
    if ndim == 1:
        if reverse:
            xs = pytree.tree_map(lambda l: torch.flip(l, (0,)), xs)
        out = scan_k.scan_1d_cuda(op, xs, inclusive=inclusive)
        if reverse:
            out = pytree.tree_map(lambda l: torch.flip(l, (0,)), out)
        return out
    if ndim == 3 and axis == 1:
        return scan_k.scan_channel_cuda(op, xs, inclusive=inclusive,
                                        reverse=reverse)
    # Any other rank or axis: move the scan axis to 1 and flatten the rest
    # into channels, (lead, T, rest), then restore.
    moved = [l.movedim(axis, 1) for l in leaves]
    xs3 = [m.reshape(m.shape[0], m.shape[1], -1).contiguous() for m in moved]
    out = scan_k.scan_channel_cuda(op, pytree.tree_unflatten(xs3, spec),
                                   inclusive=inclusive, reverse=reverse)
    outs = [o.reshape(m.shape).movedim(1, axis)
            for o, m in zip(pytree.tree_leaves(out), moved)]
    return pytree.tree_unflatten(outs, spec)


# ---------------------------------------------------------------------------
# scan@segmented / mapreduce@segmented (ragged workloads)
# ---------------------------------------------------------------------------


def _segment_flags(xs, flags, offsets):
    """Normalize either segment descriptor to an int32 flag array (the
    dispatch layer has already checked that exactly one is present)."""
    n = pytree.tree_leaves(xs)[0].shape[0]
    if offsets is not None:
        return seg_k.offsets_to_flags(offsets, n)
    return flags.to(torch.int32)


def _segmented_scan_torch(op, xs, *, flags=None, offsets=None,
                          inclusive=True):
    return ref.ref_segmented_scan(op, xs, _segment_flags(xs, flags, offsets),
                                  inclusive=inclusive)


def _segmented_scan_cuda(op, xs, *, flags=None, offsets=None,
                         inclusive=True):
    xs = pytree.tree_map(lambda l: l.contiguous(), xs)
    return seg_k.segmented_scan_1d_cuda(
        op, xs, _segment_flags(xs, flags, offsets), inclusive=inclusive)


def _segmented_mapreduce(scan_seg, scan_flat, f, op, xs, flags, offsets,
                         num_segments):
    """One output per segment: the inclusive segmented scan of ``f(xs)``,
    then each segment's last element (identity for empty segments).  The
    map runs as plain tensor code, as the reference leaves it to XLA."""
    fl = _segment_flags(xs, flags, offsets)
    vals = pytree.tree_map(lambda l: l.contiguous(), f(xs))
    incl = scan_seg(op, vals, fl, inclusive=True)
    return seg_k.gather_segment_lasts(
        op, incl, scan_flat, offsets=offsets,
        flags=None if offsets is not None else fl, num_segments=num_segments)


def _segmented_mapreduce_torch(f, op, xs, *, flags=None, offsets=None,
                               num_segments=None):
    return _segmented_mapreduce(ref.ref_segmented_scan, _scan_torch, f, op,
                                xs, flags, offsets, num_segments)


def _segmented_mapreduce_cuda(f, op, xs, *, flags=None, offsets=None,
                              num_segments=None):
    return _segmented_mapreduce(seg_k.segmented_scan_1d_cuda, _scan_cuda, f,
                                op, xs, flags, offsets, num_segments)


# ---------------------------------------------------------------------------
# mapreduce@flat / mapreduce@batched
# ---------------------------------------------------------------------------


def _mapreduce_torch(f, op, xs, *, axis=None):
    vals = f(xs)
    if op.name in _DIRECT and isinstance(vals, torch.Tensor):
        return _DIRECT[op.name](vals, axis)
    return ref.ref_mapreduce(f, op, xs, axis=axis)


def _mapreduce_cuda(f, op, xs, *, axis=None):
    if axis is None:
        if isinstance(xs, torch.Tensor):     # the serving path's flags
            flat = xs if xs.dim() == 1 else xs.reshape(-1)
        else:
            flat = pytree.tree_map(lambda l: l.reshape(-1), xs)
        return mapreduce_k.mapreduce_1d_cuda(f, op, flat)
    if isinstance(xs, torch.Tensor) and xs.ndim == 2 and -2 <= axis < 2:
        # The reference's route (paper section V-A): a 2-D reduction over
        # rows is a matvec, over columns a vecmat, with f on the matrix
        # element and no vector.
        reduce = matvec_k.matvec_cuda if axis % 2 == 0 else \
            matvec_k.vecmat_cuda
        return reduce(f, op, xs.contiguous(), None)
    raise NotImplementedError(
        "mapreduce: the cuda path supports axis=None or 2D")


# ---------------------------------------------------------------------------
# scan@batched: per-row scan along axis 1 of (B, n) leaves
# ---------------------------------------------------------------------------


def _batched_scan_torch(op, xs, *, inclusive=True, reverse=False):
    return ref.ref_scan(op, xs, axis=1, inclusive=inclusive, reverse=reverse)


def _batched_scan_cuda(op, xs, *, inclusive=True, reverse=False):
    if not reverse and isinstance(xs, torch.Tensor):   # the nucleus scan
        return batched_k.batched_scan_cuda(op, xs.contiguous(),
                                           inclusive=inclusive)
    flip = (lambda l: torch.flip(l, (1,))) if reverse else \
        (lambda l: l.contiguous())
    out = batched_k.batched_scan_cuda(op, pytree.tree_map(flip, xs),
                                      inclusive=inclusive)
    return pytree.tree_map(flip, out) if reverse else out


# ---------------------------------------------------------------------------
# matvec / vecmat at Flat and Batched layout (generalized semiring forms),
# over a dense or a Quantized matrix
# ---------------------------------------------------------------------------


def _quantized(A) -> bool:
    return isinstance(A, alg.Quantized)


def _matvec_torch(f, op, A, x):
    if _quantized(A):
        return matvec_k.matvec_quantized_plain(f, op, A, x)
    return matvec_k.matvec_plain(f, op, A, x)


def _vecmat_torch(f, op, A, x):
    if _quantized(A):
        return matvec_k.vecmat_quantized_plain(f, op, A, x)
    return matvec_k.vecmat_plain(f, op, A, x)


def _matvec_cuda(f, op, A, x):
    if _quantized(A):
        return matvec_k.matvec_quantized_cuda(f, op, A.contiguous(),
                                              x.contiguous())
    n, p = A.shape
    if matvec_k.uses_packed(n, p, op):
        # Tall-narrow: K5 reads the matrix as one flat stream instead of
        # giving each column a thread (the reference's ops.py route).
        return matvec_k.matvec_packed_cuda(f, op, A.contiguous(),
                                           x.contiguous())
    return matvec_k.matvec_cuda(f, op, A.contiguous(), x.contiguous())


def _vecmat_cuda(f, op, A, x):
    if _quantized(A):
        return matvec_k.vecmat_quantized_cuda(f, op, A.contiguous(),
                                              x.contiguous())
    return matvec_k.vecmat_cuda(f, op, A.contiguous(), x.contiguous())


def _batched_matvec_torch(f, op, A, x):
    if _quantized(A):
        return batched_k.batched_matvec_quantized_plain(f, op, A, x)
    return batched_k.batched_matvec_plain(f, op, A, x)


def _batched_vecmat_torch(f, op, A, x):
    if _quantized(A):
        return batched_k.batched_vecmat_quantized_plain(f, op, A, x)
    return batched_k.batched_vecmat_plain(f, op, A, x)


def _batched_matvec_cuda(f, op, A, x):
    A, x = A.contiguous(), x.contiguous()
    if _quantized(A):
        return batched_k.batched_matvec_quantized_cuda(f, op, A, x)
    return batched_k.batched_matvec_cuda(f, op, A, x)


def _batched_vecmat_cuda(f, op, A, x):
    A, x = A.contiguous(), x.contiguous()
    if _quantized(A):
        return batched_k.batched_vecmat_quantized_cuda(f, op, A, x)
    return batched_k.batched_vecmat_cuda(f, op, A, x)


def _batched_mapreduce_torch(f, op, xs):
    vals = f(xs)
    if op.name in _DIRECT and isinstance(vals, torch.Tensor):
        return _DIRECT[op.name](vals, 1)
    return ref.ref_fold(op, vals, axis=1)


# ---------------------------------------------------------------------------
# linear_recurrence  h_t = a_t * h_{t-1} + b_t  on (B, T, C)
#
# The (B, T, C) channel scan is batch-native, so the same implementations
# serve the flat and batched routes.
# ---------------------------------------------------------------------------


def _linrec_torch(a, b, h0=None, *, reverse=False):
    return ref.ref_linear_recurrence(a, b, h0=h0, axis=1, reverse=reverse)


def _linrec_cuda(a, b, h0=None, *, reverse=False):
    # Without h0 the A leaf (the running product of a) is not read, so K6
    # does not write it.
    A, B = scan_k.scan_channel_cuda(alg.AFFINE, (a, b), inclusive=True,
                                    reverse=reverse,
                                    keep=(h0 is not None, True))
    if h0 is None:
        return B
    return A * h0[:, None, :] + B


def _per_backend(fn):
    # The sort compositions take the backend their scan/mapreduce steps
    # dispatch to; each registered row pins it.
    return {b: functools.partial(fn, backend=b) for b in ("torch", "cuda")}


IMPLS: dict[str, dict[str, Any]] = {
    "copy@flat": {"torch": _copy_torch, "cuda": _copy_cuda},
    "scan@flat": {"torch": _scan_torch, "cuda": _scan_cuda},
    "scan@batched": {"torch": _batched_scan_torch,
                     "cuda": _batched_scan_cuda},
    "mapreduce@flat": {"torch": _mapreduce_torch, "cuda": _mapreduce_cuda},
    "mapreduce@batched": {"torch": _batched_mapreduce_torch,
                          "cuda": batched_k.batched_mapreduce_cuda},
    "scan@segmented": {"torch": _segmented_scan_torch,
                       "cuda": _segmented_scan_cuda},
    "mapreduce@segmented": {"torch": _segmented_mapreduce_torch,
                            "cuda": _segmented_mapreduce_cuda},
    "matvec@flat": {"torch": _matvec_torch, "cuda": _matvec_cuda},
    "vecmat@flat": {"torch": _vecmat_torch, "cuda": _vecmat_cuda},
    "matvec@batched": {"torch": _batched_matvec_torch,
                       "cuda": _batched_matvec_cuda},
    "vecmat@batched": {"torch": _batched_vecmat_torch,
                       "cuda": _batched_vecmat_cuda},
    "sort@flat": _per_backend(sort_k.sort_radix),
    "sort@segmented": _per_backend(sort_k.segmented_sort_radix),
    "sort_pairs@flat": _per_backend(sort_k.sort_pairs_radix),
    "sort_pairs@segmented": _per_backend(sort_k.segmented_sort_pairs_radix),
    "argsort@flat": _per_backend(sort_k.argsort_radix),
    "argsort@segmented": _per_backend(sort_k.segmented_argsort_radix),
    "top_k@flat": _per_backend(sort_k.top_k_radix),
    "top_k@segmented": _per_backend(sort_k.segmented_top_k_radix),
    "linear_recurrence@flat": {"torch": _linrec_torch, "cuda": _linrec_cuda},
    "linear_recurrence@batched": {"torch": _linrec_torch,
                                  "cuda": _linrec_cuda},
}

# The table and the registry must enumerate exactly the same routes, and
# every route must keep its plain torch row.  Raised (not assert) so the
# check survives python -O.
if set(IMPLS) != ki.route_keys():
    raise RuntimeError(
        "kernels/ops.py IMPLS out of sync with the PrimitiveDef registry: "
        f"missing={sorted(ki.route_keys() - set(IMPLS))} "
        f"extra={sorted(set(IMPLS) - ki.route_keys())}")
for _key, _impls in IMPLS.items():
    if "torch" not in _impls:
        raise RuntimeError(f"{_key}: every route needs a torch row")
    for _backend, _fn in _impls.items():
        ki.register_impl(_key, _backend)(_fn)
