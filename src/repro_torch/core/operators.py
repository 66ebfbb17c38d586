"""Associative operators and device maps over tensors and tuples of tensors.

The PyTorch counterpart of ``repro.core.operators`` for the slices the
serving path needs: :class:`AssocOp` with ``ADD``, ``MUL``, ``MAX``, ``MIN``
and the non-commutative ``AFFINE``; the map descriptors a kernel can run
(:data:`IDENTITY`, :func:`masked_select` and the matvec product
:data:`TIMES`); and the radix sort's order-preserving key transforms
(:func:`key_to_radix_bits` / :func:`radix_bits_to_key`).

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
    """A map ``f`` of mapreduce or matvec that a CUDA kernel can run.

    ``name`` selects the kernel's map (``MapCode`` in ``csrc/common.cuh``);
    ``fn`` is the same map as a Python callable, which the plain versions
    call.  ``fill`` is the masked select's value where the mask is 0.
    """

    name: str
    fn: Callable[..., Pytree]
    fill: float = 0.0

    def __call__(self, *args: Pytree) -> Pytree:
        return self.fn(*args)


IDENTITY = DeviceMap("identity", lambda x: x)

# The product of matvec / vecmat: f(x, a) = x * a (ordinary GEMV with ADD).
TIMES = DeviceMap("times", lambda u, v: u * v)


def masked_select(fill: float = 0.0) -> DeviceMap:
    """``where(mask != 0, values, fill)`` over a ``(values, mask)`` pair."""

    def fn(t):
        values, mask = t
        return torch.where(mask != 0, values,
                           torch.full((), fill, dtype=values.dtype,
                                      device=values.device))

    return DeviceMap("masked_select", fn, fill)


# --------------------------------------------------------------------------
# Radix-sortable key transforms (the port of the reference's pinned order).
#
# Keys map onto same-width unsigned bits, held in int64 tensors (torch has
# no unsigned 32-bit arithmetic to rely on), so that a < b iff
# bits(a) < bits(b).  Signed ints flip the sign bit.  Floats: -0.0 and +0.0
# compare equal, and every NaN maps to the all-ones-mantissa positive NaN,
# so all NaNs compare equal and sort after +inf (np.sort's order); then the
# sign-magnitude fix-up: negative values are bitwise complemented,
# non-negative values get the sign bit set.
# --------------------------------------------------------------------------

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)
_SIGNED = (torch.int8, torch.int16, torch.int32)
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_SIGNED_FOR_WIDTH = {8: torch.int8, 16: torch.int16, 32: torch.int32}


def radix_key_bits(dtype: torch.dtype) -> int:
    """Total significant bits in the sortable-transformed key."""
    if dtype not in _UNSIGNED + _SIGNED + _FLOATS:
        raise TypeError(f"radix sort: unsupported key dtype "
                        f"{str(dtype).removeprefix('torch.')}")
    return dtype.itemsize * 8


def _unsigned_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """The two's-complement bits of a signed tensor, as int64 in
    [0, 2^width)."""
    return x.to(torch.int64) & ((1 << width) - 1)


def _signed_from_bits(bits: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`_unsigned_bits`: the signed int of that width."""
    half = 1 << (width - 1)
    return torch.where(bits >= half, bits - (1 << width), bits).to(
        _SIGNED_FOR_WIDTH[width])


def key_to_radix_bits(keys: torch.Tensor) -> torch.Tensor:
    """Map keys onto unsigned bits (int64); ``a < b`` iff
    ``bits(a) < bits(b)`` under the pinned total order above."""
    width = radix_key_bits(keys.dtype)
    mask, sign = (1 << width) - 1, 1 << (width - 1)
    if keys.dtype in _UNSIGNED:
        return keys.to(torch.int64)
    if keys.dtype in _SIGNED:
        return _unsigned_bits(keys, width) ^ sign
    # Floats: canonicalize -0.0 and NaN, then sign-magnitude fix-up.
    keys = torch.where(keys == 0, torch.zeros_like(keys), keys)
    bits = _unsigned_bits(keys.view(_SIGNED_FOR_WIDTH[width]), width)
    bits = torch.where(torch.isnan(keys), torch.full_like(bits, sign - 1),
                       bits)
    return torch.where((bits & sign) != 0, ~bits & mask, bits | sign)


def radix_bits_to_key(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`key_to_radix_bits` (up to the documented float
    canonicalizations: ``-0.0`` comes back as ``+0.0`` and NaNs as the
    canonical quiet NaN)."""
    width = radix_key_bits(dtype)
    mask, sign = (1 << width) - 1, 1 << (width - 1)
    if dtype in _UNSIGNED:
        return bits.to(dtype)
    if dtype in _SIGNED:
        return _signed_from_bits(bits ^ sign, width)
    raw = torch.where((bits & sign) != 0, bits ^ sign, ~bits & mask)
    return _signed_from_bits(raw, width).view(dtype)
