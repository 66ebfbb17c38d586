"""The public primitives of the port: ``copy``, ``scan``, ``mapreduce``,
``matvec``/``vecmat`` (+ the semiring bundles ``semiring_matvec`` /
``semiring_vecmat``), ``linear_recurrence`` and the radix-sort family
(``sort``, ``sort_pairs``, ``argsort``, ``top_k``), each polymorphic over
``layout=``.

The port of ``repro.core.primitives``.  Every call goes through the route
registry in ``core.intrinsics``; implementations register per backend from
``kernels/ops.py``.  No function here names a backend.

    from repro_torch.core import primitives as forge
    from repro_torch.core import operators as alg
    from repro_torch.core.layout import Batched

    y = forge.scan(alg.ADD, x)                                 # prefix sum
    q = forge.scan(alg.QUATERNION_MUL, (w, i, j, k))           # any operator
    s = forge.scan(alg.ADD, vals, layout=Segmented(offsets=offs))
    d = forge.semiring_matvec(alg.TROPICAL_MIN_PLUS, W, dist)  # shortest paths
    y = forge.matvec(alg.TIMES, alg.ADD, alg.quantize(W, mode="int8"), x)
    z = forge.vecmat(alg.TIMES, alg.ADD, A, v, layout=Batched())  # (B, n)
    m = forge.mapreduce(alg.IDENTITY, alg.MAX, flags)          # any-set
    h = forge.linear_recurrence(a, b, layout=Batched())        # (B, T, C)
    v, i = forge.top_k(logits.reshape(-1), 40,
                       layout=Segmented(offsets=offsets))      # (S, 40)

The pre-layout names (``segmented_scan``, ``batched_mapreduce``, ...) remain
as deprecation shims that forward to the polymorphic surface; each warns
once per process.  ``REPRO_AUTOTUNE=1`` in the environment turns on the
autotuner (``core/tuning.py``) when this module is imported.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable

import torch

from repro_torch.core import intrinsics as ki
from repro_torch.core import operators as alg
from repro_torch.core import tuning as _tuning
from repro_torch.core.layout import (  # noqa: F401  (re-exported)
    FLAT, Batched, Flat, Layout, Segmented)
from repro_torch.kernels import ops as _ops  # noqa: F401  (registers backends)

_tuning.maybe_enable_from_env()  # REPRO_AUTOTUNE=1 turns on autotuned dispatch

Pytree = Any


def copy(x: torch.Tensor, *, nitem: int | None = None,
         layout: Layout | None = None,
         backend: str | None = None) -> torch.Tensor:
    """Bandwidth-ceiling copy (paper Fig. 1).  ``nitem`` is the kernel's
    16-byte vectors per thread (1, 2, 4, 8 or 16 on the card; default 8)."""
    return ki.dispatch("copy", layout, backend, (x,), {"nitem": nitem})


def scan(op: alg.AssocOp, xs: Pytree, *, axis: int = 0,
         inclusive: bool = True, reverse: bool = False,
         layout: Layout | None = None,
         backend: str | None = None) -> Pytree:
    """Prefix scan with any associative ``op`` (``op`` need not commute).

    * ``Flat()`` (default): one scan along ``axis`` of the leaves, which
      share one shape.
    * ``Batched()``: per-row scan along axis 1 of ``(B, n)`` leaves -- one
      launch for all rows.
    * ``Segmented(flags=... | offsets=...)``: per-segment scan over the flat
      ``(n,)`` stream; the scan restarts at every boundary (exclusive: the
      identity at every segment start).

    The ``cuda`` routes run any ``op`` that carries a device form
    (:class:`~alg.DeviceOp`) over leaves of f32, f64, int32 or uint8.
    """
    return ki.dispatch("scan", layout, backend, (op, xs),
                       {"axis": axis, "inclusive": inclusive,
                        "reverse": reverse})


def mapreduce(f: Callable, op: alg.AssocOp, xs: Pytree, *, axis=None,
              layout: Layout | None = None,
              backend: str | None = None) -> Pytree:
    """``op``-reduction of ``f(x)``.

    * ``Flat()``: reduce everything (or one axis of a 2-D array).  ``op``
      must be commutative.
    * ``Batched()``: per-row reduction of ``(B, n)`` leaves -> ``(B,)``.
      Length-0 rows yield ``op``'s identity.  An ``op`` that does not
      commute reroutes through the order-preserving ``scan@batched`` (K7s
      on the card) and takes each row's last element.
    * ``Segmented(...)``: one output element per segment; the flag variant
      needs ``Segmented(num_segments=...)``; empty segments yield identity.
      Order-preserving (segmented scan + gather), so ``op`` need not be
      commutative.

    The ``cuda`` Flat and Batched routes run ``f`` inside the kernel and
    need it to be a :class:`~alg.DeviceMap` with a device form; the
    Segmented route applies ``f`` as tensor code, then scans on the card.
    """
    return ki.dispatch("mapreduce", layout, backend, (f, op, xs),
                       {"axis": axis})


def matvec(f: Callable, op: alg.AssocOp, A, x: torch.Tensor,
           *, layout: Layout | None = None,
           backend: str | None = None) -> Pytree:
    """y[j] = op_i f(x[i], A[i, j]).

    * ``Flat()`` (default): ``A`` is ``(n, p)``, ``x`` is ``(n,)``.
    * ``Batched()``: ``y[b, j] = op_i f(x[b, i], A[b, i, j])`` over a
      ``(B, n, p)`` matrix and ``(B, n)`` vectors -> ``(B, p)``, one launch
      for the batch.  ``B == 0`` or ``n == 0`` yields ``op``'s identity.

    ``A`` may be a :class:`~alg.Quantized` matrix (:func:`~alg.quantize`:
    int8, fp8_e4m3 or fp8_e5m2 codes with one f32 scale per ``block`` rows
    per column) at either layout: ``f`` then sees the dequantized f32
    element, and ``x`` is float32.  The ``cuda`` route decodes the codes in
    the kernel (K9); the ``torch`` route dequantizes first.

    The ``cuda`` route runs any :class:`~alg.DeviceMap` ``f`` and operator
    with device forms (the ordinary GEMV is ``TIMES`` with ``ADD``), in row
    order for an operator that does not commute; a dense flat tall-narrow
    matrix (``p <= 64``, ``n >= 512``) under a commutative ``op`` takes the
    packed kernel."""
    return ki.dispatch("matvec", layout, backend, (f, op, A, x), {})


def vecmat(f: Callable, op: alg.AssocOp, A, x: torch.Tensor,
           *, layout: Layout | None = None,
           backend: str | None = None) -> Pytree:
    """z[i] = op_j f(A[i, j], x[j]) -- the row-wise mirror of
    :func:`matvec`, over ``(n, p)`` / ``(p,)``; ``Batched()``: ``(B, n,
    p)`` / ``(B, p)`` -> ``(B, n)``.  ``A`` may be :class:`~alg.Quantized`
    at either layout, as for :func:`matvec`."""
    return ki.dispatch("vecmat", layout, backend, (f, op, A, x), {})


def semiring_matvec(semiring: alg.Semiring, A, x: torch.Tensor, *,
                    layout: Layout | None = None,
                    backend: str | None = None) -> Pytree:
    """Semiring-bundled :func:`matvec` (paper section V-C), at either
    layout, over a dense or a :class:`~alg.Quantized` ``A``."""
    return matvec(semiring.f, semiring.op, A, x, layout=layout,
                  backend=backend)


def semiring_vecmat(semiring: alg.Semiring, A, x: torch.Tensor, *,
                    layout: Layout | None = None,
                    backend: str | None = None) -> Pytree:
    """Semiring-bundled :func:`vecmat` (paper section V-C), at either
    layout, over a dense or a :class:`~alg.Quantized` ``A``."""
    return vecmat(semiring.f, semiring.op, A, x, layout=layout,
                  backend=backend)


def linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                      h0: torch.Tensor | None = None, *,
                      reverse: bool = False, layout: Layout | None = None,
                      backend: str | None = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (B, T, C) inputs.

    The model-facing specialization of ``scan`` with the AFFINE operator;
    ``Flat()`` and ``Batched()`` share implementations.  ``h0`` is an
    optional per-row ``(B, C)`` initial state.
    """
    return ki.dispatch("linear_recurrence", layout, backend, (a, b),
                       {"h0": h0, "reverse": reverse})


def sort(keys: torch.Tensor, *, descending: bool = False,
         key_bits: int | None = None, layout: Layout | None = None,
         backend: str | None = None) -> torch.Tensor:
    """Stable LSD radix sort, composed from mapreduce + exclusive scan +
    scatter (kernels/sort.py).

    Keys may be u8/u16/u32, i8/i16/i32, f32/bf16/f16.  The total order is
    numeric with ``-0.0 == +0.0`` and all NaNs equal, sorting after ``+inf``
    (ascending); float outputs are canonicalized accordingly.  ``key_bits``
    (unsigned keys only) caps the significant bits so small-range keys pay
    proportionally fewer passes.  Under ``Segmented(...)`` every contiguous
    segment sorts independently, in place in the flat layout.
    """
    return ki.dispatch("sort", layout, backend, (keys,),
                       {"descending": descending, "key_bits": key_bits})


def sort_pairs(keys: torch.Tensor, values: Pytree, *,
               descending: bool = False, key_bits: int | None = None,
               layout: Layout | None = None,
               backend: str | None = None) -> tuple[torch.Tensor, Pytree]:
    """Stable key sort carrying an arbitrary pytree payload (leaves of
    leading extent ``n``) through the same permutation."""
    return ki.dispatch("sort_pairs", layout, backend, (keys, values),
                       {"descending": descending, "key_bits": key_bits})


def argsort(keys: torch.Tensor, *, descending: bool = False,
            key_bits: int | None = None, layout: Layout | None = None,
            backend: str | None = None) -> torch.Tensor:
    """The stable sorting permutation (int32) of ``keys``.  Under
    ``Segmented(...)``, position ``i`` holds the *offset inside its
    segment* of the element sorted into slot ``i``."""
    return ki.dispatch("argsort", layout, backend, (keys,),
                       {"descending": descending, "key_bits": key_bits})


def top_k(keys: torch.Tensor, k: int, *, largest: bool = True,
          key_bits: int | None = None, layout: Layout | None = None,
          backend: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` extreme elements, extreme-first and
    tie-stable.  NaNs rank above ``+inf``, so with ``largest=True`` they
    surface first.  Under ``Segmented(...)`` the result is per-segment
    ``(S, k)`` values and within-segment indices; slots past a segment's
    length are filled with the reduction identity and index ``-1`` (the
    flag variant needs ``Segmented(num_segments=...)``)."""
    return ki.dispatch("top_k", layout, backend, (keys, k),
                       {"largest": largest, "key_bits": key_bits})


# ---------------------------------------------------------------------------
# Deprecation shims: the pre-layout names.  Each forwards verbatim to the
# polymorphic surface and warns once per process.
# ---------------------------------------------------------------------------

_WARNED: set[str] = set()


def _warn_deprecated(name: str, replacement: str) -> None:
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"forge.{name} is deprecated; use {replacement}",
        DeprecationWarning, stacklevel=3)


def batched_scan(op: alg.AssocOp, xs: Pytree, *, inclusive: bool = True,
                 reverse: bool = False, backend: str | None = None) -> Pytree:
    """Deprecated: use ``scan(op, xs, layout=Batched())``."""
    _warn_deprecated("batched_scan", "scan(op, xs, layout=Batched())")
    return scan(op, xs, inclusive=inclusive, reverse=reverse,
                layout=Batched(), backend=backend)


def batched_mapreduce(f: Callable, op: alg.AssocOp, xs: Pytree, *,
                      backend: str | None = None) -> Pytree:
    """Deprecated: use ``mapreduce(f, op, xs, layout=Batched())``."""
    _warn_deprecated("batched_mapreduce",
                     "mapreduce(f, op, xs, layout=Batched())")
    return mapreduce(f, op, xs, layout=Batched(), backend=backend)


def batched_matvec(f: Callable, op: alg.AssocOp, A, x: torch.Tensor, *,
                   backend: str | None = None) -> Pytree:
    """Deprecated: use ``matvec(f, op, A, x, layout=Batched())``."""
    _warn_deprecated("batched_matvec",
                     "matvec(f, op, A, x, layout=Batched())")
    return matvec(f, op, A, x, layout=Batched(), backend=backend)


def batched_vecmat(f: Callable, op: alg.AssocOp, A, x: torch.Tensor, *,
                   backend: str | None = None) -> Pytree:
    """Deprecated: use ``vecmat(f, op, A, x, layout=Batched())``."""
    _warn_deprecated("batched_vecmat",
                     "vecmat(f, op, A, x, layout=Batched())")
    return vecmat(f, op, A, x, layout=Batched(), backend=backend)


def batched_semiring_matvec(semiring: alg.Semiring, A, x: torch.Tensor, *,
                            backend: str | None = None) -> Pytree:
    """Deprecated: use ``semiring_matvec(..., layout=Batched())``."""
    _warn_deprecated("batched_semiring_matvec",
                     "semiring_matvec(semiring, A, x, layout=Batched())")
    return semiring_matvec(semiring, A, x, layout=Batched(), backend=backend)


def batched_semiring_vecmat(semiring: alg.Semiring, A, x: torch.Tensor, *,
                            backend: str | None = None) -> Pytree:
    """Deprecated: use ``semiring_vecmat(..., layout=Batched())``."""
    _warn_deprecated("batched_semiring_vecmat",
                     "semiring_vecmat(semiring, A, x, layout=Batched())")
    return semiring_vecmat(semiring, A, x, layout=Batched(), backend=backend)


def batched_linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                              h0: torch.Tensor | None = None, *,
                              reverse: bool = False,
                              backend: str | None = None) -> torch.Tensor:
    """Deprecated: use ``linear_recurrence(a, b, h0, layout=Batched())``."""
    _warn_deprecated("batched_linear_recurrence",
                     "linear_recurrence(a, b, h0, layout=Batched())")
    return linear_recurrence(a, b, h0, reverse=reverse, layout=Batched(),
                             backend=backend)


def segmented_scan(op: alg.AssocOp, xs: Pytree, *,
                   flags: torch.Tensor | None = None,
                   offsets: torch.Tensor | None = None,
                   inclusive: bool = True,
                   backend: str | None = None) -> Pytree:
    """Deprecated: use ``scan(op, xs, layout=Segmented(...))``."""
    _warn_deprecated("segmented_scan",
                     "scan(op, xs, layout=Segmented(flags=... | offsets=...))")
    return scan(op, xs, inclusive=inclusive,
                layout=Segmented(flags=flags, offsets=offsets),
                backend=backend)


def segmented_mapreduce(f: Callable, op: alg.AssocOp, xs: Pytree, *,
                        flags: torch.Tensor | None = None,
                        offsets: torch.Tensor | None = None,
                        num_segments: int | None = None,
                        backend: str | None = None) -> Pytree:
    """Deprecated: use ``mapreduce(f, op, xs, layout=Segmented(...))``."""
    _warn_deprecated("segmented_mapreduce",
                     "mapreduce(f, op, xs, layout=Segmented(...))")
    return mapreduce(f, op, xs,
                     layout=Segmented(flags=flags, offsets=offsets,
                                      num_segments=num_segments),
                     backend=backend)


def segmented_sort(keys: torch.Tensor, *, flags: torch.Tensor | None = None,
                   offsets: torch.Tensor | None = None,
                   descending: bool = False, key_bits: int | None = None,
                   backend: str | None = None) -> torch.Tensor:
    """Deprecated: use ``sort(keys, layout=Segmented(...))``."""
    _warn_deprecated("segmented_sort", "sort(keys, layout=Segmented(...))")
    return sort(keys, descending=descending, key_bits=key_bits,
                layout=Segmented(flags=flags, offsets=offsets),
                backend=backend)


def segmented_sort_pairs(keys: torch.Tensor, values: Pytree, *,
                         flags: torch.Tensor | None = None,
                         offsets: torch.Tensor | None = None,
                         descending: bool = False,
                         key_bits: int | None = None,
                         backend: str | None = None
                         ) -> tuple[torch.Tensor, Pytree]:
    """Deprecated: use ``sort_pairs(keys, values, layout=Segmented(...))``."""
    _warn_deprecated("segmented_sort_pairs",
                     "sort_pairs(keys, values, layout=Segmented(...))")
    return sort_pairs(keys, values, descending=descending, key_bits=key_bits,
                      layout=Segmented(flags=flags, offsets=offsets),
                      backend=backend)


def segmented_argsort(keys: torch.Tensor, *,
                      flags: torch.Tensor | None = None,
                      offsets: torch.Tensor | None = None,
                      descending: bool = False, key_bits: int | None = None,
                      backend: str | None = None) -> torch.Tensor:
    """Deprecated: use ``argsort(keys, layout=Segmented(...))``."""
    _warn_deprecated("segmented_argsort",
                     "argsort(keys, layout=Segmented(...))")
    return argsort(keys, descending=descending, key_bits=key_bits,
                   layout=Segmented(flags=flags, offsets=offsets),
                   backend=backend)


def segmented_top_k(keys: torch.Tensor, k: int, *,
                    flags: torch.Tensor | None = None,
                    offsets: torch.Tensor | None = None,
                    num_segments: int | None = None, largest: bool = True,
                    key_bits: int | None = None,
                    backend: str | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Deprecated: use ``top_k(keys, k, layout=Segmented(...))``."""
    _warn_deprecated("segmented_top_k",
                     "top_k(keys, k, layout=Segmented(...))")
    return top_k(keys, k, largest=largest, key_bits=key_bits,
                 layout=Segmented(flags=flags, offsets=offsets,
                                  num_segments=num_segments),
                 backend=backend)
