"""Batched mapreduce kernel K7m and its plain version.

:func:`batched_mapreduce_cuda` -- per-row commutative op-reduce of ``f(x)``
over ``(B, n)`` leaves -> ``(B,)``, one launch for the whole batch
(``csrc/batched.cu``; replaces
``repro/kernels/batched.py::batched_mapreduce_pallas``).  ``f`` is a
:class:`~repro_torch.core.operators.DeviceMap`, run inside the kernel.
Plain version: :func:`batched_mapreduce_plain`.

Given CPU tensors the wrapper runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import _lib
from repro_torch.kernels import ref
from repro_torch.kernels.mapreduce import map_operands

Pytree = Any


def batched_mapreduce_plain(f, op, xs: Pytree) -> Pytree:
    """Plain version of K7m: ``f`` then an ordered pairwise fold per row."""
    return ref.ref_fold(op, f(xs), axis=1)


def batched_mapreduce_cuda(f, op, xs: Pytree) -> Pytree:
    """K7m: per-row op-reduce of ``f(x)`` over ``(B, n)`` leaves, B, n >= 1."""
    if not pytree.tree_leaves(xs)[0].is_cuda:
        return batched_mapreduce_plain(f, op, xs)
    what = "mapreduce@batched (cuda)"
    if not op.commutative:
        raise NotImplementedError(
            f"{what}: the kernel folds rows in no fixed order, so it takes "
            f"commutative operators only, got {op.name!r}")
    code, values, mask = map_operands(what, f, xs)
    op_code, dt_code = _lib.op_codes(what, op, [values])
    operands = [values] + ([mask] if mask is not None else [])
    if values.ndim != 2 or 0 in values.shape:
        raise ValueError(f"{what}: takes non-empty (B, n) leaves, got "
                         f"{tuple(values.shape)}")
    _lib.require_cuda(what, *operands)
    B, n = values.shape
    lib = _lib.library("batched.cu")
    out = torch.empty((B,), dtype=values.dtype, device=values.device)
    _lib.check(lib.rt_mapreduce_batched(
        op_code, dt_code, code, values.data_ptr(), _lib.ptr(mask),
        float(f.fill), B, n, out.data_ptr(), _lib.stream_ptr(values)), what)
    batched_mapreduce_cuda.launches += 1
    return out


batched_mapreduce_cuda.launches = 0
