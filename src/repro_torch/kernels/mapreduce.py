"""Mapreduce kernel K3 (flat) and its plain version.

:func:`mapreduce_1d_cuda` -- commutative op-reduce of ``f(x)`` over flat
``(n,)`` leaves in one launch (``csrc/mapreduce.cuh``; replaces
``repro/kernels/mapreduce.py::mapreduce_1d_pallas``).  ``f`` is a
:class:`~repro_torch.core.operators.DeviceMap` over the leaves of ``x``; it
runs inside the kernel and may change the type (UnitFloat8 decodes uint8 to
f32), and the accumulator carries the mapped type.  Plain version:
:func:`mapreduce_1d_plain`.

Two forms: up to one block's extent (the plan's ``limit``, 2,048), the
small form -- one block, one launch, one allocation (the output), the
pointers as scalar arguments; above it, the multi-block form with its
partials and the atomic ticket cleared by a memset.  The serving path's
all-done predicate, at n = the engine's slots, always takes the small form.

``nitem`` is the tuning policy's ``nitem_reduce`` (None: 8): the items a
thread takes before the grid grows, and the small form's extent, 256
``nitem``; each value is a unit of its own.

Given CPU tensors the wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts the kernel's launches,
``small_launches`` those of the small form among them.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Pytree = Any


def mapreduce_1d_plain(f, op, xs: Pytree) -> Pytree:
    """Plain version of K3: ``f`` then an ordered pairwise fold."""
    return ref.ref_mapreduce(f, op, xs)


def mapreduce_1d_cuda(f, op, xs: Pytree, *,
                      nitem: int | None = None) -> Pytree:
    """K3: op-reduce of ``f(x)`` over flat ``(n,)`` leaves -> 0-dim
    tensors."""
    leaves = (xs,) if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)
    x = leaves[0]
    if not x.is_cuda:
        return mapreduce_1d_plain(f, op, xs)
    what = "mapreduce@flat (cuda)"
    if not op.commutative:
        raise ValueError(f"{what}: requires a commutative operator, got "
                         f"{op.name!r}")
    plan = _lib.plan("mapreduce", what, op, xs, f, knob=nitem)
    shape = x.shape
    if len(shape) != 1 or shape[0] == 0 or len(leaves) > 1 and any(
            l.shape != shape for l in leaves):
        raise ValueError(f"{what}: takes non-empty (n,) leaves of one shape, "
                         f"got {[tuple(l.shape) for l in leaves]}")
    _lib.require_cuda(what, *leaves)
    lib = plan.lib or plan.load()
    n = shape[0]
    outs = [x.new_empty((), dtype=d) for d in plan.out_dtypes]
    if n <= plan.limit:
        _lib.check(lib.rt_mapreduce_small(
            *_lib.ptrs((*leaves, *outs)), n, _lib.stream_ptr(x)), what)
        mapreduce_1d_cuda.small_launches += 1
    else:
        partials = _lib.scratch(lib.rt_mapreduce_flat_grid(n),
                                len(outs), x)
        ticket = x.new_empty(1, dtype=torch.int32)
        _lib.check(lib.rt_mapreduce_flat(
            _lib.leaf_ptrs(leaves), n, partials.data_ptr(),
            ticket.data_ptr(), _lib.leaf_ptrs(outs), _lib.stream_ptr(x)),
            what)
    mapreduce_1d_cuda.launches += 1
    return plan.outputs(outs)


mapreduce_1d_cuda.launches = 0
mapreduce_1d_cuda.small_launches = 0
