"""The public primitives of the slice: ``scan``, ``mapreduce`` and
``linear_recurrence``, each polymorphic over ``layout=``.

The port of ``repro.core.primitives``.  Every call goes through the route
registry in ``core.intrinsics``; implementations register per backend from
``kernels/ops.py``.  No function here names a backend.

    from repro_torch.core import primitives as forge
    from repro_torch.core import operators as alg
    from repro_torch.core.layout import Batched

    y = forge.scan(alg.ADD, x)                                 # prefix sum
    m = forge.mapreduce(alg.IDENTITY, alg.MAX, flags)          # any-set
    h = forge.linear_recurrence(a, b, layout=Batched())        # (B, T, C)
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import intrinsics as ki
from repro_torch.core import operators as alg
from repro_torch.core.layout import (  # noqa: F401  (re-exported)
    FLAT, Batched, Flat, Layout)
from repro_torch.kernels import ops as _ops  # noqa: F401  (registers backends)

Pytree = Any


def scan(op: alg.AssocOp, xs: Pytree, *, axis: int = 0,
         inclusive: bool = True, reverse: bool = False,
         layout: Layout | None = None,
         backend: str | None = None) -> Pytree:
    """Prefix scan with any associative ``op`` (``op`` need not commute).

    ``Flat()`` (the only layout of this slice): one scan along ``axis`` of
    the leaves, which share one shape.
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
      Length-0 rows yield ``op``'s identity.

    The ``cuda`` routes need ``f`` to be a :class:`~alg.DeviceMap`.
    """
    return ki.dispatch("mapreduce", layout, backend, (f, op, xs),
                       {"axis": axis})


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
