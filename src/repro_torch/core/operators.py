"""Associative operators and device maps over tensors and tuples of tensors.

The PyTorch counterpart of ``repro.core.operators`` for the slice the
serving path needs: :class:`AssocOp` with ``ADD``, ``MUL``, ``MAX``, ``MIN``
and the non-commutative ``AFFINE``, plus the map descriptors a kernel can run
(:data:`IDENTITY` and :func:`masked_select`).

An element type is a pytree of tensors (``torch.utils._pytree``); ``combine``
is associative and elementwise over the leaves, ``identity(like)`` builds the
identity element shaped like ``like``.  ``device_op`` names the functor of
``csrc/common.cuh`` that runs the operator inside a CUDA kernel; ``None``
means the operator has none, and the ``cuda`` routes refuse it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

Pytree = Any


def _min_value(dtype: torch.dtype):
    if dtype.is_floating_point:
        return -float("inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def _max_value(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


@dataclasses.dataclass(frozen=True)
class AssocOp:
    """An associative binary operator over pytree elements."""

    name: str
    combine: Callable[[Pytree, Pytree], Pytree]
    identity: Callable[[Pytree], Pytree]  # (pytree of shape/dtype likes) -> pytree
    commutative: bool = False
    device_op: str | None = None          # functor in csrc/common.cuh, or None

    def __call__(self, a: Pytree, b: Pytree) -> Pytree:
        return self.combine(a, b)

    def __repr__(self):
        return f"AssocOp({self.name})"


def _elementwise_identity(fill_fn):
    def identity(like):
        return pytree.tree_map(
            lambda l: torch.full_like(l, fill_fn(l.dtype)), like)

    return identity


def _leafwise(fn):
    return lambda a, b: pytree.tree_map(fn, a, b)


ADD = AssocOp("add", _leafwise(torch.add),
              _elementwise_identity(lambda dt: 0), True, "add")
MUL = AssocOp("mul", _leafwise(torch.mul),
              _elementwise_identity(lambda dt: 1), True, "mul")
MAX = AssocOp("max", _leafwise(torch.maximum),
              _elementwise_identity(_min_value), True, "max")
MIN = AssocOp("min", _leafwise(torch.minimum),
              _elementwise_identity(_max_value), True, "min")


# Affine composition, the operator behind diagonal linear recurrences
# h_t = a_t * h_{t-1} + b_t.  Elements are pairs (a, b) representing
# x -> a*x + b, composed left to right: (g1 . g2)(x) = g2(g1(x)).
# NON-commutative.


def _affine_combine(p, q):
    (a1, b1), (a2, b2) = p, q
    return (pytree.tree_map(torch.mul, a2, a1),
            pytree.tree_map(lambda a2_, b1_, b2_: a2_ * b1_ + b2_, a2, b1, b2))


def _affine_identity(like):
    a_like, b_like = like
    return (pytree.tree_map(lambda l: torch.ones_like(l), a_like),
            pytree.tree_map(lambda l: torch.zeros_like(l), b_like))


AFFINE = AssocOp("affine", _affine_combine, _affine_identity, False, "affine")


@dataclasses.dataclass(frozen=True)
class DeviceMap:
    """A map ``f`` of mapreduce that a CUDA kernel can run.

    ``name`` selects the kernel's map (``MapCode`` in ``csrc/common.cuh``);
    ``fn`` is the same map as a Python callable, which the plain versions
    call.  ``fill`` is the masked select's value where the mask is 0.
    """

    name: str
    fn: Callable[[Pytree], Pytree]
    fill: float = 0.0

    def __call__(self, xs: Pytree) -> Pytree:
        return self.fn(xs)


IDENTITY = DeviceMap("identity", lambda x: x)


def masked_select(fill: float = 0.0) -> DeviceMap:
    """``where(mask != 0, values, fill)`` over a ``(values, mask)`` pair."""

    def fn(t):
        values, mask = t
        return torch.where(mask != 0, values,
                           torch.full((), fill, dtype=values.dtype,
                                      device=values.device))

    return DeviceMap("masked_select", fn, fill)
