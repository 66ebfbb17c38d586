"""Copy kernel K1 and its plain version.

:func:`copy_cuda` -- ``y = x`` over a contiguous tensor of any dtype, copied
as bytes with 16-byte vector loads and stores, ``nitem`` vectors per thread
(``csrc/copy.cuh``; replaces ``repro/kernels/copy.py::copy_pallas``): the
bandwidth ceiling of the paper's Fig. 1.  ``nitem`` is the reference's
items-per-thread knob (``nitem_copy``, default 8), one of 1, 2, 4, 8 and 16
on the card.  Plain version: :func:`copy_plain`.

Given a CPU tensor the wrapper runs the plain version; given a CUDA tensor
it launches the kernel or raises.  ``launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref

NITEM_DEFAULT = 8
NITEMS = (1, 2, 4, 8, 16)


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1."""
    return ref.ref_copy(x)


def copy_cuda(x: torch.Tensor, *, nitem: int | None = None) -> torch.Tensor:
    """K1: a copy of ``x`` (n >= 1 elements)."""
    if not x.is_cuda:
        return copy_plain(x)
    what = "copy@flat (cuda)"
    nitem = NITEM_DEFAULT if nitem is None else nitem
    if nitem not in NITEMS:
        raise ValueError(f"{what}: nitem must be one of {NITEMS}, got "
                         f"{nitem!r}")
    _lib.require_cuda(what, x)
    lib = _lib.load(_lib.unit("copy", what))
    y = torch.empty_like(x)
    _lib.check(lib.rt_copy(x.data_ptr(), y.data_ptr(),
                           x.numel() * x.element_size(), nitem,
                           _lib.stream_ptr(x)), what)
    copy_cuda.launches += 1
    return y


copy_cuda.launches = 0
