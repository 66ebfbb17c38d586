"""Mapreduce kernel K3 (flat) and its plain version.

:func:`mapreduce_1d_cuda` -- commutative op-reduce of ``f(x)`` over flat
``(n,)`` leaves in one launch (``csrc/mapreduce.cuh``; replaces
``repro/kernels/mapreduce.py::mapreduce_1d_pallas``).  ``f`` is a
:class:`~repro_torch.core.operators.DeviceMap` over the leaves of ``x``; it
runs inside the kernel and may change the type (UnitFloat8 decodes uint8 to
f32), and the accumulator carries the mapped type.  Plain version:
:func:`mapreduce_1d_plain`.

Given CPU tensors the wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts the kernel's launches.
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


def mapreduce_1d_cuda(f, op, xs: Pytree) -> Pytree:
    """K3: op-reduce of ``f(x)`` over flat ``(n,)`` leaves -> 0-dim
    tensors."""
    leaves = pytree.tree_leaves(xs)
    if not leaves[0].is_cuda:
        return mapreduce_1d_plain(f, op, xs)
    what = "mapreduce@flat (cuda)"
    if not op.commutative:
        raise ValueError(f"{what}: requires a commutative operator, got "
                         f"{op.name!r}")
    unit, out_dtypes, out_spec = _lib.map_unit("mapreduce", what, f, op, xs)
    shape = leaves[0].shape
    if any(l.shape != shape for l in leaves) or len(shape) != 1 \
            or shape[0] == 0:
        raise ValueError(f"{what}: takes non-empty (n,) leaves of one shape, "
                         f"got {[tuple(l.shape) for l in leaves]}")
    _lib.require_cuda(what, *leaves)
    lib = _lib.load(unit)
    n = shape[0]
    dev = leaves[0].device
    partials = _lib.scratch(lib.rt_mapreduce_flat_grid(n), len(out_dtypes),
                            leaves[0])
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    outs = [torch.empty((), dtype=d, device=dev) for d in out_dtypes]
    _lib.check(lib.rt_mapreduce_flat(
        _lib.leaf_ptrs(leaves), n, partials.data_ptr(), ticket.data_ptr(),
        _lib.leaf_ptrs(outs), _lib.stream_ptr(leaves[0])), what)
    mapreduce_1d_cuda.launches += 1
    return pytree.tree_unflatten(outs, out_spec)


mapreduce_1d_cuda.launches = 0
