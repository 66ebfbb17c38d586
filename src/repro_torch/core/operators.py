"""Associative operators, device maps and semirings over tensors and tuples
of tensors.

The PyTorch counterpart of ``repro.core.operators``: :class:`AssocOp` and
every operator of the reference's ``STD_OPS`` (``ADD``, ``MUL``, ``MAX``,
``MIN``, ``LOGSUMEXP``, ``AFFINE``, ``MAXPLUS_AFFINE``, ``SOFTMAX_MERGE``,
``QUATERNION_MUL``, ``MAT2_MUL``), the :func:`segmented` lift, the maps a
kernel can run (:class:`DeviceMap`: :data:`IDENTITY`, :func:`masked_select`,
:data:`TIMES`, :data:`PLUS`, :data:`unitfloat8_decode`), the
:class:`Semiring` bundles of ``STD_SEMIRINGS``, the blockwise int8 / fp8
codecs of :class:`Quantized` matrix operands and :class:`KVQuant` cache
vectors, and the radix sort's order-preserving key transforms.

An element type is a pytree of tensors (``torch.utils._pytree``); ``combine``
is associative and elementwise over the leaves, ``identity(like)`` builds the
identity element shaped like ``like``.

**Device forms.**  Each operator and map also carries its own CUDA form: a
short C++ fragment (:class:`DeviceOp`, or the map's ``device`` body).  At the
first use of an (operator, map, leaf dtypes) combination on a CUDA tensor,
``kernels/_lib.py`` generates the element struct and the functor from these
fragments, compiles them into the kernel templates of ``csrc/*.cuh`` and
loads the result.  An operator or map whose form is ``None`` -- any plain
Python callable -- has none, and the ``cuda`` routes refuse it.  A user's
own operator gets a device form the same way the ones below do::

    XOR = AssocOp("xor", lambda a, b: a ^ b, lambda l: torch.zeros_like(l),
                  True, DeviceOp(identity="r.v# = 0;",
                                 combine="r.v# = a.v# ^ b.v#;"))
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

Pytree = Any

# Leaf dtypes a device element may hold, with their C++ types.
DEVICE_CTYPES = {torch.float32: "float", torch.float64: "double",
                 torch.int32: "int", torch.uint8: "unsigned char",
                 torch.int8: "signed char"}
MAX_DEVICE_LEAVES = 5


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


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


# --------------------------------------------------------------------------
# Device forms
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    """The CUDA form of an :class:`AssocOp`: the bodies of one functor.

    The build wraps them as ``struct Op { using E = <element>;
    static E identity(); static E combine(const E& a, const E& b); }``,
    where the element ``E`` has leaves ``v0, v1, ...`` of types
    ``E::T0, E::T1, ...``; helpers for every leaf type are in
    ``csrc/common.cuh`` (``rt::add``, ``rt::max``, ``rt::mul_rn``, ...).

    * ``leaves=None`` (a leafwise operator): each body is one statement for
      leaf ``#``, repeated for every leaf with ``#`` replaced by its index,
      into a result ``r`` -- e.g. ``"r.v# = rt::add(a.v#, b.v#);"``.
    * ``leaves=k``: each body is a whole function body returning an ``E``,
      for elements of exactly ``k`` leaves of one dtype.

    ``floats_only`` restricts the leaves to floating point.
    """

    identity: str
    combine: str
    leaves: int | None = None
    floats_only: bool = False

    def check(self, what: str, name: str, dtypes) -> None:
        if self.leaves is not None and len(dtypes) != self.leaves:
            raise NotImplementedError(
                f"{what}: the device form of operator {name!r} takes "
                f"{self.leaves} leaves, got {len(dtypes)}")
        if self.leaves is not None and len(set(dtypes)) != 1:
            raise NotImplementedError(
                f"{what}: the device form of operator {name!r} takes leaves "
                f"of one dtype, got {[_dtype_name(d) for d in dtypes]}")
        for dt in dtypes:
            if self.floats_only and not dt.is_floating_point:
                raise NotImplementedError(
                    f"{what}: operator {name!r} has no device form over "
                    f"{_dtype_name(dt)} leaves")

    def emit(self, gen, name: str, dtypes, commutative: bool) -> str:
        elem = gen.elem(dtypes)
        if self.leaves is None:
            def body(stmt):
                lines = "".join(f"    {stmt.replace('#', str(k))}\n"
                                for k in range(len(dtypes)))
                return f"    E r;\n{lines}    return r;\n"
            ident, comb = body(self.identity), body(self.combine)
        else:
            ident, comb = self.identity, self.combine
        return (f"struct {name} {{\n  using E = {elem};\n"
                f"  static constexpr bool COMMUTATIVE = "
                f"{'true' if commutative else 'false'};\n"
                f"  __device__ static E identity() {{\n{ident}\n  }}\n"
                f"  __device__ static E combine(const E& a, const E& b) {{\n"
                f"{comb}\n  }}\n}};\n")


@dataclasses.dataclass(frozen=True)
class SegmentedDeviceOp:
    """The CUDA form of :func:`segmented` ``(inner)``, generated from the
    inner operator's own form: the element is ``(int32 flag, inner
    leaves...)``."""

    inner: "AssocOp"

    def check(self, what: str, name: str, dtypes) -> None:
        if len(dtypes) < 2 or dtypes[0] != torch.int32:
            raise NotImplementedError(
                f"{what}: operator {name!r} takes an int32 flag leaf and "
                f"value leaves, got {[_dtype_name(d) for d in dtypes]}")
        if self.inner.device is None:
            raise NotImplementedError(
                f"{what}: operator {self.inner.name!r} has no device functor "
                f"for the cuda backend")
        self.inner.device.check(what, self.inner.name, dtypes[1:])

    def emit(self, gen, name: str, dtypes, commutative: bool) -> str:
        inner = gen.op(self.inner, dtypes[1:])
        elem, ielem = gen.elem(dtypes), gen.elem(dtypes[1:])
        k = range(len(dtypes) - 1)
        split = "".join(f"    x.v{j} = a.v{j + 1}; y.v{j} = b.v{j + 1};\n"
                        for j in k)
        pick = "".join(f"    r.v{j + 1} = s ? y.v{j} : m.v{j};\n" for j in k)
        ident = "".join(f"    r.v{j + 1} = i.v{j};\n" for j in k)
        return (f"struct {name} {{\n  using E = {elem};\n"
                f"  static constexpr bool COMMUTATIVE = false;\n"
                f"  __device__ static E identity() {{\n"
                f"    const {ielem} i = {inner}::identity();\n"
                f"    E r;\n    r.v0 = 0;\n{ident}    return r;\n  }}\n"
                f"  __device__ static E combine(const E& a, const E& b) {{\n"
                f"    {ielem} x, y;\n{split}"
                f"    const {ielem} m = {inner}::combine(x, y);\n"
                f"    const bool s = b.v0 != 0;\n"
                f"    E r;\n    r.v0 = a.v0 > b.v0 ? a.v0 : b.v0;\n"
                f"{pick}    return r;\n  }}\n}};\n")


@dataclasses.dataclass(frozen=True)
class AssocOp:
    """An associative binary operator over pytree elements, with its CUDA
    form (``device``; None: the ``cuda`` routes refuse the operator)."""

    name: str
    combine: Callable[[Pytree, Pytree], Pytree]
    identity: Callable[[Pytree], Pytree]  # (pytree of shape/dtype likes) -> pytree
    commutative: bool = False
    device: DeviceOp | SegmentedDeviceOp | None = None

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


def _leafwise_device(fn: str, identity: str, floats_only: bool = False):
    return DeviceOp(identity=f"r.v# = {identity};",
                    combine=f"r.v# = {fn}(a.v#, b.v#);",
                    floats_only=floats_only)


# --------------------------------------------------------------------------
# Standard scalar/elementwise operators.  On the card integer ADD and MUL
# wrap like torch's int32 arithmetic, and float MAX and MIN propagate NaN
# like torch.maximum / torch.minimum.
# --------------------------------------------------------------------------

ADD = AssocOp("add", _leafwise(torch.add),
              _elementwise_identity(lambda dt: 0), True,
              _leafwise_device("rt::add", "E::T#(0)"))
MUL = AssocOp("mul", _leafwise(torch.mul),
              _elementwise_identity(lambda dt: 1), True,
              _leafwise_device("rt::mul", "E::T#(1)"))
MAX = AssocOp("max", _leafwise(torch.maximum),
              _elementwise_identity(_min_value), True,
              _leafwise_device("rt::max", "rt::Lim<E::T#>::lowest()"))
MIN = AssocOp("min", _leafwise(torch.minimum),
              _elementwise_identity(_max_value), True,
              _leafwise_device("rt::min", "rt::Lim<E::T#>::highest()"))
# logaddexp(-inf, -inf) is -inf, as jnp.logaddexp gives (csrc/common.cuh).
LOGSUMEXP = AssocOp("logsumexp", _leafwise(torch.logaddexp),
                    _elementwise_identity(lambda dt: -float("inf")), True,
                    _leafwise_device("rt::logaddexp",
                                     "rt::Lim<E::T#>::lowest()",
                                     floats_only=True))

# Tropical semiring reducers (the paper's shortest-path use case).
TROPICAL_MIN = MIN   # (min, +) semiring: reduce with min, map with +
TROPICAL_MAX = MAX   # (max, +) semiring


# Affine composition, the operator behind diagonal linear recurrences
# h_t = a_t * h_{t-1} + b_t.  Elements are pairs (a, b) representing
# x -> a*x + b, composed left to right: (g1 . g2)(x) = g2(g1(x)).
# NON-commutative.  The device form rounds every product and sum on its own
# (no fused multiply-add), as torch does, so a kernel that combines in the
# plain version's order gives its bits.


def _affine_combine(p, q):
    (a1, b1), (a2, b2) = p, q
    return (pytree.tree_map(torch.mul, a2, a1),
            pytree.tree_map(lambda a2_, b1_, b2_: a2_ * b1_ + b2_, a2, b1, b2))


def _affine_identity(like):
    a_like, b_like = like
    return (pytree.tree_map(lambda l: torch.ones_like(l), a_like),
            pytree.tree_map(lambda l: torch.zeros_like(l), b_like))


AFFINE = AssocOp("affine", _affine_combine, _affine_identity, False,
                 DeviceOp(
                     identity="E r; r.v0 = E::T0(1); r.v1 = E::T1(0); "
                              "return r;",
                     combine="E r; r.v0 = rt::mul_rn(b.v0, a.v0); "
                             "r.v1 = rt::add_rn(rt::mul_rn(b.v0, a.v1), b.v1);"
                             " return r;",
                     leaves=2))


# Max-plus affine: elements (a, b) represent m -> max(m + a, b), the AFFINE
# operator over the (max, +) semiring (xLSTM's stabilizer).  NON-commutative.
# Its device form is float only: over wrapping integers the identity's
# lowest value plus a shift overflows, and the operator is not associative.


def _maxplus_affine_combine(p, q):
    (a1, b1), (a2, b2) = p, q
    return (pytree.tree_map(torch.add, a1, a2),
            pytree.tree_map(lambda b1_, a2_, b2_: torch.maximum(b1_ + a2_, b2_),
                            b1, a2, b2))


def _maxplus_affine_identity(like):
    a_like, b_like = like
    return (pytree.tree_map(lambda l: torch.zeros_like(l), a_like),
            pytree.tree_map(lambda l: torch.full_like(l, _min_value(l.dtype)),
                            b_like))


MAXPLUS_AFFINE = AssocOp(
    "maxplus_affine", _maxplus_affine_combine, _maxplus_affine_identity,
    False,
    DeviceOp(identity="E r; r.v0 = E::T0(0); r.v1 = rt::Lim<E::T1>::lowest();"
                      " return r;",
             combine="E r; r.v0 = rt::add(a.v0, b.v0); "
                     "r.v1 = rt::max(rt::add(a.v1, b.v0), b.v1); return r;",
             leaves=2, floats_only=True))


# Softmax-merge: combining partial attention results (m, l, o) where m is the
# running max of logits, l the sum of exp(logit - m), o the weighted values.
# Associative and commutative (distributed flash-decoding).


def _softmax_merge(p, q):
    (m1, l1, o1), (m2, l2, o2) = p, q
    m = torch.maximum(m1, m2)
    # Guard exp(-inf - -inf): where both sides are empty keep weights at 0.
    w1 = torch.where(torch.isneginf(m1), 0.0, torch.exp(m1 - m)).to(l1.dtype)
    w2 = torch.where(torch.isneginf(m2), 0.0, torch.exp(m2 - m)).to(l2.dtype)
    l = l1 * w1 + l2 * w2
    if o1.ndim == l1.ndim + 1:
        o = o1 * w1[..., None] + o2 * w2[..., None]
    else:
        o = o1 * w1 + o2 * w2
    return (m, l, o)


def _softmax_identity(like):
    m_like, l_like, o_like = like
    return (pytree.tree_map(lambda l: torch.full_like(l, -float("inf")),
                            m_like),
            pytree.tree_map(torch.zeros_like, l_like),
            pytree.tree_map(torch.zeros_like, o_like))


SOFTMAX_MERGE = AssocOp(
    "softmax_merge", _softmax_merge, _softmax_identity, True,
    DeviceOp(identity="E r; r.v0 = rt::Lim<E::T0>::lowest(); r.v1 = 0; "
                      "r.v2 = 0; return r;",
             combine="const E::T0 m = rt::max(a.v0, b.v0);\n"
                     "    const E::T0 w1 = rt::is_neg_inf(a.v0) ? E::T0(0) : "
                     "rt::exp(a.v0 - m);\n"
                     "    const E::T0 w2 = rt::is_neg_inf(b.v0) ? E::T0(0) : "
                     "rt::exp(b.v0 - m);\n"
                     "    E r; r.v0 = m; r.v1 = a.v1 * w1 + b.v1 * w2;\n"
                     "    r.v2 = a.v2 * w1 + b.v2 * w2; return r;",
             leaves=3, floats_only=True))


# Quaternion multiplication: the paper's canonical non-commutative composite
# type (a 4-field struct).  Elements are tuples (w, x, y, z) of tensors.


def _quat_mul(p, q):
    w1, x1, y1, z1 = p
    w2, x2, y2, z2 = q
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def _quat_identity(like):
    w, x, y, z = like
    return (torch.ones_like(w), torch.zeros_like(x), torch.zeros_like(y),
            torch.zeros_like(z))


QUATERNION_MUL = AssocOp(
    "quaternion_mul", _quat_mul, _quat_identity, False,
    DeviceOp(identity="E r; r.v0 = 1; r.v1 = 0; r.v2 = 0; r.v3 = 0; "
                      "return r;",
             combine="E r;\n"
                     "    r.v0 = a.v0 * b.v0 - a.v1 * b.v1 - a.v2 * b.v2 - "
                     "a.v3 * b.v3;\n"
                     "    r.v1 = a.v0 * b.v1 + a.v1 * b.v0 + a.v2 * b.v3 - "
                     "a.v3 * b.v2;\n"
                     "    r.v2 = a.v0 * b.v2 - a.v1 * b.v3 + a.v2 * b.v0 + "
                     "a.v3 * b.v1;\n"
                     "    r.v3 = a.v0 * b.v3 + a.v1 * b.v2 - a.v2 * b.v1 + "
                     "a.v3 * b.v0;\n    return r;",
             leaves=4, floats_only=True))


# 2x2 matrix product under the flattened (m00, m01, m10, m11) form, row-vector
# convention (state @ M): compose left to right as p then q.


def _mat2_mul(p, q):
    a00, a01, a10, a11 = p
    b00, b01, b10, b11 = q
    return (
        a00 * b00 + a01 * b10,
        a00 * b01 + a01 * b11,
        a10 * b00 + a11 * b10,
        a10 * b01 + a11 * b11,
    )


def _mat2_identity(like):
    m00, m01, m10, m11 = like
    return (torch.ones_like(m00), torch.zeros_like(m01),
            torch.zeros_like(m10), torch.ones_like(m11))


MAT2_MUL = AssocOp(
    "mat2_mul", _mat2_mul, _mat2_identity, False,
    DeviceOp(identity="E r; r.v0 = 1; r.v1 = 0; r.v2 = 0; r.v3 = 1; "
                      "return r;",
             combine="E r;\n"
                     "    r.v0 = a.v0 * b.v0 + a.v1 * b.v2;\n"
                     "    r.v1 = a.v0 * b.v1 + a.v1 * b.v3;\n"
                     "    r.v2 = a.v2 * b.v0 + a.v3 * b.v2;\n"
                     "    r.v3 = a.v2 * b.v1 + a.v3 * b.v3;\n    return r;",
             leaves=4, floats_only=True))


# --------------------------------------------------------------------------
# Segmented lift: any AssocOp becomes an operator over (flag, value) pairs
# that resets at segment boundaries (Blelloch's segmented-scan construction).
# A nonzero flag marks the first element of a segment.  Never commutative.
# --------------------------------------------------------------------------


@functools.cache
def segmented(op: AssocOp) -> AssocOp:
    """Lift ``op`` to the segment-resetting operator over (flag, value).

    combine((f1, v1), (f2, v2)) = (max(f1, f2), v2 if f2 else op(v1, v2)).
    Identity is (0, identity of op).  The device form is generated from
    ``op``'s own, so ``segmented(QUATERNION_MUL)`` runs on the card too.
    """

    def combine(p, q):
        f1, v1 = p
        f2, v2 = q
        started = f2 != 0
        merged = op(v1, v2)
        v = pytree.tree_map(lambda m, r: torch.where(started, r, m), merged,
                            v2)
        return (torch.maximum(f1, f2), v)

    def identity(like):
        f_like, v_like = like
        return (pytree.tree_map(torch.zeros_like, f_like), op.identity(v_like))

    return AssocOp(f"segmented[{op.name}]", combine, identity, False,
                   SegmentedDeviceOp(op))


# --------------------------------------------------------------------------
# Maps a kernel can run
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceMap:
    """A map ``f`` of mapreduce or matvec, with its CUDA form.

    ``fn`` is the map as a Python callable, which the plain versions call;
    the dtypes it returns (on empty tensors) fix the kernel's output
    element.  ``device`` is the C++ body of ``static Out apply(const In& x)``:
    ``In`` holds the input leaves (for matvec's ``f(x, a)``: ``x.v0`` the
    vector element, ``x.v1`` the matrix element; vecmat's ``f(a, x)`` the
    other way round), ``Out`` the output's.  ``device=None``: the ``cuda``
    routes refuse the map.
    """

    name: str
    fn: Callable[..., Pytree]
    device: str | None = None

    def __call__(self, *args: Pytree) -> Pytree:
        return self.fn(*args)

    def __repr__(self):
        return f"DeviceMap({self.name})"


def _c_literal(v: float) -> str:
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return float(v).hex()


IDENTITY = DeviceMap("identity", lambda x: x, "return x;")

# The products of matvec / vecmat: f(x, a) = x * a (ordinary GEMV with ADD)
# and f(x, a) = x + a (the tropical and log semirings).  Each rounds on its
# own, so it never fuses into the reduction's add.
TIMES = DeviceMap("times", lambda u, v: u * v,
                  "Out r; r.v0 = rt::mul_rn(x.v0, x.v1); return r;")
PLUS = DeviceMap("plus", lambda u, v: u + v,
                 "Out r; r.v0 = rt::add_rn(x.v0, x.v1); return r;")


@functools.cache
def masked_select(fill: float = 0.0) -> DeviceMap:
    """``where(mask != 0, values, fill)`` over a ``(values, mask)`` pair."""

    def fn(t):
        values, mask = t
        return torch.where(mask != 0, values,
                           torch.full((), fill, dtype=values.dtype,
                                      device=values.device))

    return DeviceMap(
        "masked_select", fn,
        f"Out r; r.v0 = x.v1 != 0 ? x.v0 : static_cast<Out::T0>("
        f"{_c_literal(fill)}); return r;")


# --------------------------------------------------------------------------
# Semirings: (map f, reduce op) pairs for generalized matvec / mapreduce.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Semiring:
    """Generalized (f, op): y = op_i f(x_i, a_i).  ``f`` may change the
    element type."""

    name: str
    f: Callable[[Any, Any], Pytree]
    op: AssocOp


ARITHMETIC = Semiring("arithmetic", f=TIMES, op=ADD)
TROPICAL_MIN_PLUS = Semiring("tropical_min_plus", f=PLUS, op=MIN)
TROPICAL_MAX_PLUS = Semiring("tropical_max_plus", f=PLUS, op=MAX)
LOG_SEMIRING = Semiring("log", f=PLUS, op=LOGSUMEXP)


# --------------------------------------------------------------------------
# UnitFloat8: the paper's custom 8-bit type -- values in [-1, 1] encoded as
# 256 evenly spaced uint8 levels, promoted to f32 before accumulation.
# --------------------------------------------------------------------------

_UF8_STEP = 2.0 / 255.0


def unitfloat8_encode(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, -1.0, 1.0)
    return torch.round((x + 1.0) * (255.0 / 2.0)).to(torch.uint8)


# The device form rounds the product and the difference apart, as the
# tensor code does, so both decode bit for bit alike.
unitfloat8_decode = DeviceMap(
    "unitfloat8_decode",
    lambda u: u.to(torch.float32) * _UF8_STEP - 1.0,
    f"Out r; r.v0 = __fsub_rn(__fmul_rn(static_cast<float>(x.v0), "
    f"{_c_literal(float(torch.tensor(_UF8_STEP, dtype=torch.float32)))}f), "
    f"1.0f); return r;")


# --------------------------------------------------------------------------
# Quantized: blockwise-scaled (values, scales) matrices -- the "arbitrary
# types" stress test on the decode GEMV.  A matrix is stored as int8 codes
# (mode "int8") or fp8 bit patterns in uint8 (the emulated e4m3 / e5m2
# modes) plus one f32 scale per ``block`` rows per column; the matvec and
# vecmat kernels decode in registers and accumulate in f32.  Everything
# here is bit-exact with the reference's codec on the same input: codes,
# scales and dequantized values (torch.round rounds half to even, as
# jnp.round does; powers of two are built from f32 bits).
# --------------------------------------------------------------------------

# mode -> (exponent bits, mantissa bits, exponent bias, max finite value).
# e4m3 follows the "fn" convention (448 max); e5m2 keeps 57344.  Every code
# decodes as finite (e4m3 0x7F is 480, where the hardware's conversion
# gives NaN); the encoder saturates at the max finite value, so it never
# emits the codes on which the two differ.
FP8_FORMATS = {"fp8_e4m3": (4, 3, 7, 448.0), "fp8_e5m2": (5, 2, 15, 57344.0)}
QUANT_MODES = ("int8",) + tuple(FP8_FORMATS)


def fp8_decode(u: torch.Tensor, mode: str) -> torch.Tensor:
    """uint8 bit patterns -> f32 (sign / exponent / mantissa field decode,
    integer operations and exact f32 products only)."""
    _, man, bias, _ = FP8_FORMATS[mode]
    b = u.to(torch.int32)
    sign = torch.where(b >= 128, -1.0, 1.0).to(torch.float32)
    exp = (b >> man) & ((1 << (7 - man)) - 1)
    frac = (b & ((1 << man) - 1)).to(torch.float32) * (1.0 / (1 << man))
    # 2**(exp-bias) built as f32 bits: exact, as the reference builds it.
    pow2 = ((exp - bias + 127) << 23).to(torch.int32).view(torch.float32)
    normal = pow2 * (1.0 + frac)
    subnormal = (2.0 ** (1 - bias)) * frac
    return sign * torch.where(exp > 0, normal, subnormal)


def fp8_encode(x: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 -> uint8 bit patterns, round-to-nearest onto the fp8 grid,
    saturating at the format's max finite value (no inf / nan codes)."""
    _, man, bias, fmax = FP8_FORMATS[mode]
    sign = torch.where(x < 0, 0x80, 0).to(torch.uint8)
    a = torch.minimum(x.to(torch.float32).abs(),
                      torch.tensor(fmax, dtype=torch.float32))
    mant, e = torch.frexp(a)               # a == mant * 2**e, mant in [.5, 1)
    E = e - 1 + bias                       # tentative biased exponent
    # Normal path: field = round((1.f - 1) * 2^man), carrying into E.
    nf = torch.round((mant * 2.0 - 1.0) * (1 << man)).to(torch.int32)
    E = torch.where(nf >= (1 << man), E + 1, E)
    nf = torch.where(nf >= (1 << man), 0, nf)
    # Subnormal path (E <= 0): field = round(a / 2^(1-bias) * 2^man); a
    # field of 2^man is exactly the smallest normal.
    sf = torch.round(a * (2.0 ** (bias - 1 + man))).to(torch.int32)
    bits = torch.where(
        E <= 0,
        torch.where(sf < (1 << man), sf, 1 << man),
        (torch.clamp(E, max=(1 << (7 - man)) - 1) << man) | nf)
    maxcode = _fp8_max_code(mode)
    bits = torch.where(a >= fmax, maxcode, torch.clamp(bits, max=maxcode))
    bits = torch.where(a == 0.0, 0, bits)
    return bits.to(torch.uint8) | sign


@functools.cache
def _fp8_max_code(mode: str) -> int:
    """Bit pattern of the largest finite value, found by decoding the
    positive codes in host float arithmetic (every grid value is exact in
    double)."""
    _, man, bias, fmax = FP8_FORMATS[mode]
    for code in range(127, -1, -1):
        exp = code >> man
        frac = (code & ((1 << man) - 1)) / (1 << man)
        v = ((2.0 ** (exp - bias)) * (1.0 + frac) if exp > 0
             else (2.0 ** (1 - bias)) * frac)
        if v == fmax:
            return code
    raise AssertionError(f"fmax {fmax} not on the {mode} grid")


def _fp8_device(mode: str) -> str:
    """The C++ decode of one fp8 code ``c`` (unsigned char) to float: the
    sign, exponent and mantissa fields moved to float32's positions, times
    2^(127 - bias), which rebiases the exponent exactly (a subnormal code
    lands on a float32 denormal, and a power of two scales it exactly).
    The same bits as :func:`fp8_decode`, every code finite, in three
    integer operations and one product."""
    _, man, bias, _ = FP8_FORMATS[mode]
    return (f"const unsigned b = c;\n"
            f"    return __fmul_rn(__int_as_float(static_cast<int>("
            f"((b & 0x80u) << 24) | ((b & 0x7Fu) << {23 - man}))), "
            f"{_c_literal(2.0 ** (127 - bias))}f);")


# mode -> (code dtype, C++ body of ``static float apply(Code c)``): the
# device decode the quantized matvec / vecmat kernels run per element.
# int8 avoids the integer-to-float conversion unit: 2^23 + (c + 128) is a
# float32 whose low byte is c ^ 0x80, and subtracting 2^23 + 128 leaves c
# exactly.
QUANT_DEVICE = {
    "int8": (torch.int8,
             "return __fsub_rn(__int_as_float(0x4B000000 | "
             "(static_cast<unsigned char>(c) ^ 0x80)), 8388736.0f);"),
    **{m: (torch.uint8, _fp8_device(m)) for m in FP8_FORMATS},
}


def _check_mode(mode: str) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(f"mode {mode!r} not in {QUANT_MODES}")


def _encode(scaled: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "int8":
        return torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return fp8_encode(scaled, mode)


def _decode(values: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "int8":
        return values.to(torch.float32)
    return fp8_decode(values, mode)


def _qmax(mode: str) -> float:
    return 127.0 if mode == "int8" else FP8_FORMATS[mode][3]


@dataclasses.dataclass
class Quantized:
    """Blockwise-quantized matrix operand: ``values`` holds int8 codes (mode
    ``"int8"``) or uint8 fp8 bit patterns, ``scales`` one f32 per ``block``
    rows per column -- shape ``(ceil(n/block), p)`` for an ``(n, p)``
    matrix, ``(B, ceil(n/block), p)`` batched: the same rank as ``values``,
    so the registry's rank checks, which see the pytree leaves ``(values,
    scales)``, pass untouched.

    ``dequantize()`` is the semantics every kernel matches: ``decode(values)
    * scales``, the scales repeated ``block``-wise along the row axis.
    ``error_bound()`` is the per-element bound on the dequantization error.
    """

    values: torch.Tensor
    scales: torch.Tensor
    block: int = 64
    mode: str = "int8"

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self) -> torch.dtype:
        # The compute dtype: the kernels dequantize to f32 before the map.
        return torch.float32

    @property
    def qtag(self) -> str:
        """Dtype tag of the operand, distinct from the plain dtypes'."""
        return f"{self.mode}q{self.block}"

    def contiguous(self) -> "Quantized":
        return Quantized(self.values.contiguous(), self.scales.contiguous(),
                         self.block, self.mode)

    def _expanded_scales(self) -> torch.Tensor:
        return self.scales.repeat_interleave(self.block, dim=-2)[
            ..., : self.values.shape[-2], :]

    def decoded(self) -> torch.Tensor:
        """values -> f32 on the quantization grid (scales not applied)."""
        return _decode(self.values, self.mode)

    def dequantize(self) -> torch.Tensor:
        return self.decoded() * self._expanded_scales()

    def error_bound(self) -> torch.Tensor:
        """Per-element bound on |original - dequantize()| for a matrix made
        by :func:`quantize`: half a quantization step.  int8 steps are
        uniform (the scale); fp8 steps are relative for normals plus the
        subnormal absolute step, both times the block scale."""
        s = self._expanded_scales()
        if self.mode == "int8":
            return 0.5 * s
        _, man, bias, _ = FP8_FORMATS[self.mode]
        rel = self.decoded().abs() * (2.0 ** -man)
        sub_step = 2.0 ** (1 - bias - man)
        return (0.5 * rel + 0.5 * sub_step) * s


def quantize(A: torch.Tensor, *, mode: str = "int8",
             block: int = 64) -> Quantized:
    """Blockwise-quantize ``A`` along its row (reduction) axis.

    Each ``(block, 1)`` column strip gets the scale ``absmax / QMAX``;
    encoding rounds to the nearest code, so the error is at most half a
    step (:meth:`Quantized.error_bound`).  Takes ``(n, p)`` and batched
    ``(B, n, p)`` operands.
    """
    _check_mode(mode)
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    A = torch.as_tensor(A).to(torch.float32)
    n, p = A.shape[-2], A.shape[-1]
    lead = tuple(A.shape[:-2])
    nb = -(-n // block) if n else 0
    Ap = torch.nn.functional.pad(A, (0, 0, 0, nb * block - n))
    absmax = Ap.reshape(lead + (nb, block, p)).abs().amax(dim=-2)
    scales = torch.clamp(absmax, min=torch.finfo(torch.float32).tiny) \
        / _qmax(mode)
    scaled = (Ap / scales.repeat_interleave(block, dim=-2))[..., :n, :]
    return Quantized(_encode(scaled, mode), scales, block=block, mode=mode)


@dataclasses.dataclass
class KVQuant:
    """Per-vector quantized KV-cache leaf: ``values`` holds int8 codes or
    uint8 fp8 bit patterns with the cached vector on the last axis,
    ``scales`` one f32 per vector (the same shape with a trailing 1), so a
    slot update addresses values and scales with the same indices."""

    values: torch.Tensor
    scales: torch.Tensor
    mode: str = "int8"

    @property
    def shape(self):
        return self.values.shape

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (_decode(self.values, self.mode) * self.scales).to(dtype)


def quantize_kv(x: torch.Tensor, mode: str = "int8") -> KVQuant:
    """Quantize cache vectors along the last axis, one scale per vector."""
    _check_mode(mode)
    a = torch.as_tensor(x).to(torch.float32)
    absmax = a.abs().amax(dim=-1, keepdim=True)
    scales = torch.clamp(absmax, min=torch.finfo(torch.float32).tiny) \
        / _qmax(mode)
    return KVQuant(_encode(a / scales, mode), scales, mode=mode)


# Both are pytree nodes with leaves (values, scales) and the static fields
# as context, as the reference registers them.
pytree.register_pytree_node(
    Quantized, lambda q: ((q.values, q.scales), (q.block, q.mode)),
    lambda leaves, ctx: Quantized(*leaves, *ctx),
    serialized_type_name="repro_torch.core.operators.Quantized")
pytree.register_pytree_node(
    KVQuant, lambda q: ((q.values, q.scales), (q.mode,)),
    lambda leaves, ctx: KVQuant(*leaves, *ctx),
    serialized_type_name="repro_torch.core.operators.KVQuant")


STD_OPS = {
    op.name: op
    for op in [ADD, MUL, MAX, MIN, LOGSUMEXP, AFFINE, MAXPLUS_AFFINE,
               SOFTMAX_MERGE, QUATERNION_MUL, MAT2_MUL]
}

STD_SEMIRINGS = {
    s.name: s for s in [ARITHMETIC, TROPICAL_MIN_PLUS, TROPICAL_MAX_PLUS,
                        LOG_SEMIRING]
}


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
