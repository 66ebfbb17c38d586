"""Mapreduce kernel K3 (flat) and its plain version.

:func:`mapreduce_1d_cuda` -- commutative op-reduce of ``f(x)`` over flat
``(n,)`` leaves in one launch (``csrc/mapreduce.cu``; replaces
``repro/kernels/mapreduce.py::mapreduce_1d_pallas``).  ``f`` is a
:class:`~repro_torch.core.operators.DeviceMap`: the identity over one leaf,
or the masked select over a ``(values, int32 mask)`` pair.  The accumulator
carries the mapped dtype.  Plain version: :func:`mapreduce_1d_plain`.

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


def map_operands(what, f, xs):
    """(map code, values, mask or None) for a DeviceMap over ``xs``."""
    code = _lib.map_code(what, f)
    if f.name == "masked_select":
        values, mask = xs
        if mask.dtype != torch.int32 or mask.shape != values.shape:
            raise ValueError(f"{what}: the masked map takes an int32 mask of "
                             f"the values' shape, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        return code, values, mask
    if not isinstance(xs, torch.Tensor):
        raise NotImplementedError(
            f"{what}: the identity map on the card takes one tensor, got "
            f"{len(pytree.tree_leaves(xs))} leaves")
    return code, xs, None


def mapreduce_1d_plain(f, op, xs: Pytree) -> Pytree:
    """Plain version of K3: ``f`` then an ordered pairwise fold."""
    return ref.ref_mapreduce(f, op, xs)


def mapreduce_1d_cuda(f, op, xs: Pytree) -> Pytree:
    """K3: op-reduce of ``f(x)`` over flat ``(n,)`` leaves -> 0-dim tensor."""
    if not pytree.tree_leaves(xs)[0].is_cuda:
        return mapreduce_1d_plain(f, op, xs)
    what = "mapreduce@flat (cuda)"
    if not op.commutative:
        raise ValueError(f"{what}: requires a commutative operator, got "
                         f"{op.name!r}")
    code, values, mask = map_operands(what, f, xs)
    op_code, dt_code = _lib.op_codes(what, op, [values])
    operands = [values] + ([mask] if mask is not None else [])
    if values.ndim != 1 or values.shape[0] == 0:
        raise ValueError(f"{what}: takes non-empty (n,) leaves, got "
                         f"{tuple(values.shape)}")
    _lib.require_cuda(what, *operands)
    n = values.shape[0]
    lib = _lib.library("mapreduce.cu")
    partials = torch.empty(lib.rt_mapreduce_flat_grid(n), dtype=values.dtype,
                           device=values.device)
    ticket = torch.empty(1, dtype=torch.int32, device=values.device)
    out = torch.empty((), dtype=values.dtype, device=values.device)
    _lib.check(lib.rt_mapreduce_flat(
        op_code, dt_code, code, values.data_ptr(), _lib.ptr(mask),
        float(f.fill), n, partials.data_ptr(), ticket.data_ptr(),
        out.data_ptr(), _lib.stream_ptr(values)), what)
    mapreduce_1d_cuda.launches += 1
    return out


mapreduce_1d_cuda.launches = 0
