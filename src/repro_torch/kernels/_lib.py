"""Generate, build and load the hand-written CUDA kernels of ``csrc/``.

The kernel bodies are templates in ``csrc/*.cuh`` over an element type, a
functor ``Op`` and, for mapreduce and matvec, a map ``Map``; K10's
``flash`` family takes no operator, only an element type, a q/k head dim,
a value head dim and the body the wrapper runs for that type.
A kernel wrapper asks for a :class:`Unit`: one translation unit for one
family of kernels (``FAMILIES``) and one (operator, map, leaf dtypes)
combination.  The
unit is generated here from the operator's and the map's own device forms
(``core/operators.py``): it includes the family's header, defines the element
structs (per-leaf loads, stores and warp shuffles), the functor and the map,
and ``extern "C"`` entry points.  There is no closed table of operators:
whatever carries a device form runs.

Nothing is built or loaded at import.  The first call of a wrapper on a CUDA
tensor for a new combination compiles its unit with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``, in
``repro_torch/_build/``, under a name that hashes the generated source, the
headers and the flags; an unchanged combination is reused.  :func:`build`
compiles many units in parallel (one ``nvcc`` process each, all started
together), so a caller that knows its path can build it up front.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import operators as alg

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-diag-suppress", "177")    # unused members of the elements

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)     # one pointer per leaf


@dataclasses.dataclass(frozen=True)
class LeafEntry:
    """A C entry that takes one pointer per leaf as a scalar argument
    (the input element's leaves, then the output's), then ``params``: the
    small forms' entries, whose host call a ctypes array per leaf list
    would outweigh.  ``call`` runs with them gathered into the
    ``rt::Leaves`` ``x`` and ``y``."""

    params: str
    argtypes: list      # ctypes of ``params``
    call: str


@dataclasses.dataclass(frozen=True)
class Family:
    """One kernel header and the C entry points a unit of it exports.  The
    entries name the unit's generated ``Op`` and ``Map``.  ``limit`` names
    the entry of no argument whose answer a :class:`Plan` asks once: the
    largest extent of the family's small form."""

    header: str
    entries: str
    signatures: dict    # C name -> (restype, argtypes)
    leaf_entries: dict = dataclasses.field(default_factory=dict)
    limit: str | None = None


_ST = "static_cast<cudaStream_t>(stream)"
FAMILIES = {
    # K2 (one tile: rt_scan_tile; above: the lookback), K7s (rows = B) and
    # K6 (the channel-tile route and the long-T path).
    "scan": Family("scan.cuh", f"""
int rt_tile() {{ return rt::tile::Tile<Op::E>::SIZE; }}
long rt_lookback_tile() {{ return rt::lookback::Lookback<Op::E>::SIZE; }}
int rt_scan_rows(void* const* x, void* const* y, long rows, long n,
                 int inclusive, void* scratch, void* stream) {{
  return rt::scan::rows<Op>(rt::leaves(x), rt::leaves(y), rows, n,
                            inclusive != 0, scratch, {_ST});
}}
int rt_scan_channel_chunk() {{ return rt::scan::CHUNK; }}""", {
        "rt_tile": (_I, []),
        "rt_lookback_tile": (_L, []),
        "rt_scan_rows": (_I, [_PP, _PP, _L, _L, _I, _P, _P]),
        "rt_scan_channel_chunk": (_I, []),
    }, {
        # K2 and K7s, rows of n <= one tile.
        "rt_scan_tile": LeafEntry(
            "long rows, long n, int inclusive, void* stream", [_L, _L, _I, _P],
            f"rt::scan::single_tile<Op>(x, y, rows, n, inclusive != 0, {_ST})"),
        # K2 above one tile, its statuses in the stream's workspace.
        "rt_scan_lookback": LeafEntry(
            "long n, int inclusive, void* counters, void* flags, "
            "void* values, unsigned epoch, void* stream",
            [_L, _I, _P, _P, _P, ctypes.c_uint, _P],
            "rt::lookback::scan<Op>(x, y, n, inclusive != 0, counters, flags, "
            f"values, epoch, {_ST})"),
        # K6.
        "rt_scan_channel": LeafEntry(
            "long B, long T, long C, int inclusive, int reverse, "
            "void* scratch, void* stream", [_L, _L, _L, _I, _I, _P, _P],
            "rt::scan::channel<Op>(x, y, B, T, C, inclusive != 0, "
            f"reverse != 0, scratch, {_ST})"),
    }, "rt_tile"),
    # K8 over a segmented lift.
    "segscan": Family("segmented.cuh", f"""
int rt_tile() {{ return rt::tile::Tile<Op::E>::SIZE; }}
int rt_segscan(void* const* x, void* const* y, long n, int inclusive,
               void* scratch, void* stream) {{
  return rt::segmented::scan<Op>(rt::leaves(x), rt::leaves(y), n,
                                 inclusive != 0, scratch, {_ST});
}}""", {
        "rt_tile": (_I, []),
        "rt_segscan": (_I, [_PP, _PP, _L, _I, _P, _P]),
    }),
    # K3 (flat: the small form and the multi-block one) and K7m (rows of
    # (B, n): one entry for every kind of launch).
    "mapreduce": Family("mapreduce.cuh", f"""
long rt_mapreduce_small_max() {{ return rt::mapreduce::SMALL; }}
long rt_mapreduce_flat_grid(long n) {{ return rt::mapreduce::grid_for(n); }}
int rt_mapreduce_flat(void* const* x, long n, void* partials, void* ticket,
                      void* const* out, void* stream) {{
  return rt::mapreduce::flat<Map, Op>(rt::leaves(x), n, partials, ticket,
                                      rt::leaves(out), {_ST});
}}
""", {
        "rt_mapreduce_small_max": (_L, []),
        "rt_mapreduce_flat_grid": (_L, [_L]),
        "rt_mapreduce_flat": (_I, [_PP, _L, _P, _P, _PP, _P]),
    }, {
        "rt_mapreduce_small": LeafEntry(
            "long n, void* stream", [_L, _P],
            f"rt::mapreduce::small<Map, Op>(x, n, y, {_ST})"),
        # K7m: every launch kind, its geometry planned by the host
        # (kernels/batched.py: rows_geometry); counters and partials are
        # the stream's workspace.
        "rt_mapreduce_rows": LeafEntry(
            "const void* geo, void* counters, void* partials, void* stream",
            [_P, _P, _P, _P],
            "rt::mapreduce::rows<Map, Op>(x, y, geo, counters, partials, "
            f"{_ST})"),
    }, "rt_mapreduce_small_max"),
    # K4, K5 and K7 over B dense (n, p) matrices (B = 1: flat): one entry for
    # every kind of launch, its geometry planned by the host
    # (kernels/matvec.py: geometry); the input leaves are the map's, in its
    # order ((x, A) for a matvec, (A, x) for a vecmat, A alone without a
    # vector).
    "matvec": Family("matvec.cuh", "", {}, {
        "rt_gemv": LeafEntry(
            "const void* geo, void* counters, void* partials, void* stream",
            [_P, _P, _P, _P],
            "rt::matvec::run_dense<Map, Op>(x, y, geo, counters, partials, "
            f"{_ST})"),
    }),
    # K9: the same forms over B quantized matrices, codes decoded by the
    # generated Dec.
    "qmatvec": Family("matvec.cuh", f"""
int rt_qmatvec(const void* geo, const void* q, const void* s, long block,
               const void* x, void* counters, void* partials,
               void* const* out, void* stream) {{
  return rt::matvec::run_quantized<Map, Op, Dec>(
      geo, q, s, block, x, counters, partials, rt::leaves(out), {_ST});
}}""", {
        "rt_qmatvec": (_I, [_P, _P, _P, _L, _P, _P, _P, _PP, _P]),
    }),
    # K10, one unit per (element type, head_dim, v_head_dim): the
    # generated part defines Elem, HD, DV and the Body its element type
    # runs (for the tensor cores with the unit's wgmma instructions); a
    # body that reads another element type does not compile, and a call
    # whose value head dim is not the unit's is refused.
    "flash": Family("flash_attention.cuh", f"""
static_assert(std::is_same<Body::Elem, Elem>::value,
              "the body reads the unit's element type");
int rt_flash_rows() {{ return Body::BQ; }}
int rt_flash(const void* q, const void* k, const void* v, void* out, long B,
             long S, long T, long H, long KH, long dv, int causal,
             long window, float softcap, float scale, float empty_l,
             void* stream) {{
  if (dv != DV) return cudaErrorInvalidValue;
  return rt::flash::run<Body, HD, DV>(q, k, v, out, B, S, T, H, KH, causal,
                                      window, softcap, scale, empty_l, {_ST});
}}""", {
        "rt_flash_rows": (_I, []),
        "rt_flash": (_I, [_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _L, _F,
                          _F, _F, _P]),
    }),
    # K1.
    "copy": Family("copy.cuh", f"""
int rt_copy(const void* x, void* y, long nbytes, int nitem, void* stream) {{
  return rt::copy::run(x, y, nbytes, nitem, {_ST});
}}""", {
        "rt_copy": (_I, [_P, _P, _L, _I, _P]),
    }),
}

_LEAF_TAGS = {torch.float32: "f32", torch.float64: "f64", torch.int32: "i32",
              torch.uint8: "u8", torch.int8: "i8"}


@dataclasses.dataclass(frozen=True)
class Unit:
    """One generated translation unit: ``family``'s kernels for one
    combination.  ``label`` says which, for logs."""

    family: str
    label: str
    source: str
    leaves: tuple = (0, 0)   # input and output leaves of the leaf entries

    @functools.cached_property
    def digest(self) -> str:
        h = hashlib.sha256(_headers_digest().encode())
        h.update(self.source.encode())
        return h.hexdigest()[:16]

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"{self.family}-{self.digest}.so"


@functools.cache
def _headers_digest() -> str:
    """The hash of the flags and every kernel header, read once."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


class _Gen:
    """Collects the element structs and functors of one unit."""

    def __init__(self):
        self.parts: list[str] = []
        self.elems: set[str] = set()
        self.ops = 0

    def elem(self, dtypes) -> str:
        name = "E_" + "_".join(_LEAF_TAGS[d] for d in dtypes)
        if name in self.elems:
            return name
        self.elems.add(name)
        k = range(len(dtypes))
        types = "".join(f"  using T{i} = {alg.DEVICE_CTYPES[d]};\n"
                        for i, d in enumerate(dtypes))
        self.parts.append(
            f"struct {name} {{\n{types}"
            f"  static constexpr int LEAVES = {len(dtypes)};\n"
            f"  static constexpr int WIDEST = "
            f"{max(d.itemsize for d in dtypes)};\n"
            f"  static constexpr int BYTES[LEAVES] = "
            f"{{{', '.join(str(d.itemsize) for d in dtypes)}}};\n"
            + "".join(f"  T{i} v{i};\n" for i in k)
            + f"  __device__ static {name} load(const rt::Leaves& p, long i) {{\n"
            f"    {name} e;\n"
            + "".join(f"    e.v{i} = static_cast<const T{i}*>(p.p[{i}])[i];\n"
                      for i in k)
            + "    return e;\n  }\n"
            "  template <int W>\n"
            f"  __device__ static void load_vec(const rt::Leaves& p, long i, "
            f"{name} (&e)[W]) {{\n"
            + "".join(f"    {{\n      const auto w = rt::load_leaf<T{i}, W>"
                      f"(p.p[{i}], i);\n#pragma unroll\n"
                      f"      for (int u = 0; u < W; ++u) e[u].v{i} = w.v[u];"
                      f"\n    }}\n" for i in k)
            + "  }\n"
            "  __device__ void store(const rt::Leaves& p, long i) const {\n"
            + "".join(f"    if (p.p[{i}]) static_cast<T{i}*>(p.p[{i}])[i] = "
                      f"v{i};\n" for i in k)
            + "  }\n"
            f"  __device__ static {name} shfl_up({name} v, int d) {{\n"
            + "".join(f"    v.v{i} = rt::shfl_up_leaf(v.v{i}, d);\n" for i in k)
            + "    return v;\n  }\n"
            f"  __device__ static {name} shfl_down({name} v, int d, int w) {{\n"
            + "".join(f"    v.v{i} = rt::shfl_down_leaf(v.v{i}, d, w);\n"
                      for i in k)
            + "    return v;\n  }\n"
            f"  __device__ static {name} shfl_xor({name} v, int m) {{\n"
            + "".join(f"    v.v{i} = rt::shfl_xor_leaf(v.v{i}, m);\n"
                      for i in k)
            + "    return v;\n  }\n};\n")
        return name

    def op(self, op: alg.AssocOp, dtypes) -> str:
        name = f"Op{self.ops}"
        self.ops += 1
        text = op.device.emit(self, name, dtypes, op.commutative)
        self.parts.append(f"// {op.name}\n{text}")
        return name


def _names(dtypes) -> list[str]:
    return [str(d).removeprefix("torch.") for d in dtypes]


def _check_dtypes(what: str, op: alg.AssocOp, dtypes) -> None:
    if not 1 <= len(dtypes) <= alg.MAX_DEVICE_LEAVES:
        raise NotImplementedError(
            f"{what}: the cuda kernels take elements of 1 to "
            f"{alg.MAX_DEVICE_LEAVES} leaves, got {len(dtypes)}")
    for d in dtypes:
        if d not in alg.DEVICE_CTYPES:
            raise NotImplementedError(
                f"{what}: operator {op.name!r} has no "
                f"{str(d).removeprefix('torch.')} form on the cuda kernels "
                f"(leaves: {', '.join(_names(alg.DEVICE_CTYPES))})")


def map_out(what: str, f, *likes) -> tuple[list, object]:
    """(leaf dtypes, tree spec) of ``f``'s output on inputs of the dtypes of
    ``likes`` -- the map run on empty CPU tensors.  Raises for a map with no
    device form."""
    if not isinstance(f, alg.DeviceMap) or f.device is None:
        raise NotImplementedError(
            f"{what}: map {f!r} has no device form; the cuda backend runs "
            f"DeviceMaps with a device body (core/operators.py: IDENTITY, "
            f"TIMES, PLUS, masked_select, unitfloat8_decode, or your own)")
    empty = pytree.tree_map(lambda l: torch.empty(0, dtype=l.dtype), likes)
    leaves, spec = pytree.tree_flatten(f(*empty))
    return [l.dtype for l in leaves], spec


def map_unit(family: str, what: str, f, op: alg.AssocOp, *likes,
             quant: str | None = None):
    """(unit, output dtypes, output tree spec) of ``op`` over the map ``f``
    of ``likes`` (pytrees of tensors); ``quant`` names the quantization
    mode of a ``qmatvec`` unit.

    A wrapper asks on every call, and flattening pytrees costs more host
    time than the kernel takes at the serving path's (B,) shapes, so the
    answer is kept per (family, map, operator, leaf dtypes) where every
    ``like`` is a tensor or a flat tuple of tensors."""
    def sig(like):
        if isinstance(like, torch.Tensor):
            return like.dtype
        if type(like) is tuple and all(isinstance(l, torch.Tensor)
                                       for l in like):
            return tuple(l.dtype for l in like)
        return None

    sigs = tuple(sig(like) for like in likes)
    key = (family, f, op, sigs, quant) if isinstance(f, alg.DeviceMap) \
        and None not in sigs else None
    found = _MAP_UNITS.get(key) if key else None
    if found is None:
        out_dtypes, out_spec = map_out(what, f, *likes)
        found = (unit(family, what, op, out_dtypes, f=f, in_dtypes=[
            l.dtype for l in pytree.tree_leaves(likes)], quant=quant),
            out_dtypes, out_spec)
        if key:
            _MAP_UNITS[key] = found
    return found


_MAP_UNITS: dict[tuple, tuple] = {}


class Plan:
    """One family's launch for one (operator, map, leaf dtypes), resolved
    once (:func:`plan`): the unit, the output element's dtypes, tree spec
    and size in bytes and, from the first launch on, the loaded library
    and its ``limit``.  It holds ``op`` and ``f``, so their ids, which key
    it, cannot be reused while it lives."""

    __slots__ = ("unit", "op", "f", "out_dtypes", "out_spec", "bare_out",
                 "elem_bytes", "lib", "limit")

    def __init__(self, unit: Unit, op, f, out_dtypes, out_spec):
        self.unit, self.op, self.f = unit, op, f
        self.out_dtypes, self.out_spec = out_dtypes, out_spec
        self.bare_out = out_spec.is_leaf()     # one tensor, no unflatten
        self.elem_bytes = element_bytes(out_dtypes)
        self.lib: ctypes.CDLL | None = None
        self.limit = 0

    def load(self) -> ctypes.CDLL:
        """The unit's library, built and loaded at the first call, which
        also asks the family's limit once."""
        if self.lib is None:
            lib = load(self.unit)
            limit = FAMILIES[self.unit.family].limit
            self.limit = getattr(lib, limit)() if limit else 0
            self.lib = lib
        return self.lib

    def outputs(self, outs: list):
        return outs[0] if self.bare_out else pytree.tree_unflatten(
            outs, self.out_spec)


def plan(family: str, what: str, op: alg.AssocOp, xs, f=None, *,
         spread: bool = False, quant: str | None = None) -> Plan:
    """The launch plan of ``family`` for ``op`` over the leaves of ``xs``
    (and, for mapreduce and the GEMVs, the map ``f``); the output element
    is ``f``'s, or ``xs``'s own without a map.  ``spread``: ``xs`` is the
    tuple of ``f``'s arguments (a GEMV's vector and matrix likes) rather
    than its one argument; ``quant`` names a ``qmatvec`` unit's
    quantization mode.

    Kept per (family, id(op), id(f), leaf dtypes, spread, quant) where
    ``xs`` is a tensor or a flat tuple of tensors, so a call neither walks
    a pytree nor hashes the frozen operator dataclasses.  A miss resolves
    the unit by equality (:func:`map_unit`, :func:`unit`): an equal but
    distinct operator finds the same unit and builds nothing new.  Raises
    as they do, before anything is built."""
    key = (family, id(op), id(f), xs.dtype if isinstance(xs, torch.Tensor)
           else _sig(xs), spread, quant)
    found = _PLANS.get(key)
    return found if found is not None else _make_plan(key, family, what, op,
                                                      xs, f)


def _sig(xs):
    """The leaf dtypes of a flat tuple of tensors; None for another pytree,
    whose plan is made anew on every call."""
    if type(xs) is tuple and all(isinstance(l, torch.Tensor) for l in xs):
        return tuple(l.dtype for l in xs)
    return None


def _make_plan(key, family, what, op, xs, f) -> Plan:
    spread, quant = key[-2:]
    if f is not None:
        u, out_dtypes, out_spec = map_unit(family, what, f, op,
                                           *(xs if spread else (xs,)),
                                           quant=quant)
    else:
        leaves, out_spec = pytree.tree_flatten(xs)
        out_dtypes = [l.dtype for l in leaves]
        u = unit(family, what, op, out_dtypes)
    found = Plan(u, op, f, out_dtypes, out_spec)
    if key[3] is not None:
        _PLANS[key] = found
    return found


_PLANS: dict[tuple, Plan] = {}


def unit(family: str, what: str, op: alg.AssocOp | None = None,
         dtypes=(), f: alg.DeviceMap | None = None, in_dtypes=(),
         quant: str | None = None, head_dim: int | None = None,
         body: str | None = None, v_head_dim: int | None = None) -> Unit:
    """The unit of ``family`` for ``op`` over elements of leaf ``dtypes``
    (and, for mapreduce / matvec, the map ``f`` from leaves ``in_dtypes``
    to ``dtypes``; for qmatvec, the decode of quantization mode ``quant``,
    ``core/operators.py``'s ``QUANT_DEVICE``; for flash, no operator, one
    element dtype of ``FLASH_CTYPES``, a ``head_dim`` of
    ``FLASH_HEAD_DIMS``, a ``v_head_dim`` of them up to ``head_dim``
    (None: ``head_dim``) and the kernel ``body`` of ``FLASH_BODIES`` that
    the caller picked for the dtype).

    Raises NotImplementedError, naming the route, for an operator or map
    without a device form and for leaf structures or dtypes the device form
    does not take -- before anything is built: the cuda routes never fall
    back to the plain version.  A wrapper asks on every call, so the units
    are kept per combination.
    """
    if head_dim is not None and v_head_dim is None:
        v_head_dim = head_dim
    key = (family, op, tuple(dtypes), f, tuple(in_dtypes), quant, head_dim,
           v_head_dim, body)
    found = _UNITS.get(key)
    if found is None:
        found = _UNITS[key] = _make_unit(family, what, op, dtypes, f,
                                         in_dtypes, quant, head_dim,
                                         v_head_dim, body)
    return found


_UNITS: dict[tuple, Unit] = {}
FLASH_CTYPES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
FLASH_HEAD_DIMS = tuple(range(16, 257, 16))
FLASH_BODIES = ("CudaCores", "TensorCores")


def _wgmma(v_head_dim: int) -> str:
    """The tensor-core body's two wgmma forms for a value head of
    ``v_head_dim``, whose operand lists (one register per accumulator
    element) the header cannot spell: S = Q K^T at m64n64k16 from shared
    memory (any q/k head_dim, 16 columns a step), and O += P V at
    m64n{N}k16 over the value row padded to whole 64-wide boxes, P from
    registers, V transposed."""
    n = -(-v_head_dim // 64) * 64

    def outs(count):
        return ", ".join(f'"+f"(d[{i}])' for i in range(count))

    def regs(first, count):
        return ", ".join(f"%{first + i}" for i in range(count))

    return (
        "struct Wgmma {\n"
        f"  static constexpr int N = {n};\n"
        "  __device__ static void qk(float (&d)[32], uint64_t a, uint64_t b,\n"
        "                            int accumulate) {\n"
        '    asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n"\n'
        '        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "\n'
        f'        "{{{regs(0, 32)}}}, %32, %33, p, 1, 1, 0, 0;\\n}}\\n"\n'
        f"        : {outs(32)}\n"
        '        : "l"(a), "l"(b), "r"(accumulate));\n'
        "  }\n"
        f"  __device__ static void pv(float (&d)[{n // 2}], "
        "const uint32_t (&a)[4],\n"
        "                            uint64_t b) {\n"
        f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n // 2 + 5}, 0;'
        '\\n"\n'
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
        f'        "{{{regs(0, n // 2)}}}, {{{regs(n // 2, 4)}}}, %{n // 2 + 4}, '
        'p, 1, 1, 1;\\n}\\n"\n'
        f"        : {outs(n // 2)}\n"
        '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), '
        '"r"(1));\n'
        "  }\n"
        "};\n")


def _make_unit(family, what, op, dtypes, f, in_dtypes, quant,
               head_dim, v_head_dim, body) -> Unit:
    gen = _Gen()
    label = family
    if (head_dim is None) != (family != "flash") or \
            (v_head_dim is not None and head_dim is None):
        raise ValueError(f"{what}: a flash unit, and only one, takes a "
                         f"head_dim, got {head_dim!r} for {family}")
    if head_dim is not None:
        dtypes = list(dtypes)
        if len(dtypes) != 1 or dtypes[0] not in FLASH_CTYPES:
            raise NotImplementedError(
                f"{what}: the cuda kernel takes "
                f"{' or '.join(_names(FLASH_CTYPES))} q, k and v, got "
                f"{', '.join(_names(dtypes))}")
        if head_dim not in FLASH_HEAD_DIMS:
            raise NotImplementedError(
                f"{what}: the cuda kernel takes head_dim 16 to 256 in steps "
                f"of 16, got {head_dim}")
        if v_head_dim not in FLASH_HEAD_DIMS or v_head_dim > head_dim:
            raise NotImplementedError(
                f"{what}: the cuda kernel takes a value head dim of 16 to "
                f"head_dim {head_dim} in steps of 16, got {v_head_dim}")
        if body not in FLASH_BODIES:
            raise ValueError(f"{what}: a flash unit's body is one of "
                             f"{FLASH_BODIES}, got {body!r}")
        gen.parts.append(f"using Elem = {FLASH_CTYPES[dtypes[0]]};\n"
                         f"constexpr int HD = {head_dim};\n"
                         f"constexpr int DV = {v_head_dim};\n")
        # A body's value head dim defaults to HD.
        dv = "" if v_head_dim == head_dim else ", DV"
        if body == "TensorCores":
            gen.parts.append(_wgmma(v_head_dim))
            gen.parts.append(
                f"using Body = rt::flash::TensorCores<HD, Wgmma{dv}>;\n")
        else:
            gen.parts.append(f"using Body = rt::flash::CudaCores<HD{dv}>;\n")
        label = f"flash {_names(dtypes)[0]} head_dim {head_dim}" + (
            f" v_head_dim {v_head_dim}" if dv else "")
    if op is not None:
        if op.device is None:
            raise NotImplementedError(
                f"{what}: operator {op.name!r} has no device functor for the "
                f"cuda backend")
        dtypes = list(dtypes)
        _check_dtypes(what, op, dtypes)
        if f is not None:
            _check_dtypes(what, op, list(in_dtypes))
        op.device.check(what, op.name, dtypes)
        gen.parts.append(f"using Op = {gen.op(op, dtypes)};\n")
        label = f"{family} {op.name} {' '.join(_names(dtypes))}"
    if f is not None:
        In, Out = gen.elem(list(in_dtypes)), gen.elem(dtypes)
        gen.parts.append(
            f"// {f.name}\nstruct Map {{\n  using In = {In};\n"
            f"  using Out = {Out};\n"
            f"  __device__ static Out apply(const In& x) {{\n    {f.device}\n"
            f"  }}\n}};\n")
        label = (f"{family} {f.name}({' '.join(_names(in_dtypes))}) "
                 f"{op.name} {' '.join(_names(dtypes))}")
    if (quant is None) != (family != "qmatvec"):
        raise ValueError(f"{what}: a qmatvec unit, and only one, takes a "
                         f"quantization mode, got {quant!r} for {family}")
    if quant is not None:
        code, body = alg.QUANT_DEVICE[quant]
        gen.parts.append(
            f"// {quant} decode\nstruct Dec {{\n"
            f"  using Code = {alg.DEVICE_CTYPES[code]};\n"
            f"  __device__ static float apply(Code c) {{\n    {body}\n  }}\n"
            f"}};\n")
        label = f"{label} {quant}"
    fam = FAMILIES[family]
    leaves = (len(in_dtypes) if f is not None else len(dtypes), len(dtypes))
    entries = fam.entries + "".join(
        _leaf_entry(name, e, *leaves) for name, e in fam.leaf_entries.items())
    source = (f"// Generated by repro_torch/kernels/_lib.py: {label}\n"
              f'#include "{fam.header}"\n\nnamespace {{\n\n'
              + "\n".join(gen.parts)
              + f'\n}}  // namespace\n\nextern "C" {{\n{entries}\n\n'
              f'}}  // extern "C"\n')
    return Unit(family, label, source, leaves if fam.leaf_entries else (0, 0))


def _leaf_entry(name: str, e: LeafEntry, k_in: int, k_out: int) -> str:
    xs = [f"x{i}" for i in range(k_in)]
    ys = [f"y{i}" for i in range(k_out)]
    params = ", ".join(f"void* {p}" for p in xs + ys)
    return (f"\nint {name}({params}, {e.params}) {{\n"
            f"  const rt::Leaves x{{{{{', '.join(xs)}}}}};\n"
            f"  const rt::Leaves y{{{{{', '.join(ys)}}}}};\n"
            f"  return {e.call};\n}}")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "repro_torch CUDA kernels need nvcc (CUDA toolkit) to build; "
            "none found on PATH or at /usr/local/cuda/bin/nvcc")
    return found


def build(units) -> dict[str, Path]:
    """Build every unit whose library is missing; returns digest -> library.

    The units compile in parallel, one nvcc process each.  A failed compile
    raises with nvcc's output; the generated source goes to ``<lib>.cu`` and
    the compiler's register and spill report (``-Xptxas -v``) to
    ``<lib>.log`` beside each library.
    """
    by_digest = {u.digest: u for u in units}
    todo = {d: u for d, u in by_digest.items() if not u.path.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for d, u in todo.items():
            src = u.path.with_suffix(".cu")
            src.write_text(u.source)
            tmp = u.path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            procs[d] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failures = []
        for d, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            u = todo[d]
            u.path.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failures.append(f"--- nvcc {u.label} (exit "
                                f"{proc.returncode})\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, u.path)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failures))
    return {d: u.path for d, u in by_digest.items()}


_LOADED: dict[str, ctypes.CDLL] = {}


def load(u: Unit) -> ctypes.CDLL:
    """The loaded library of ``u`` (built first if needed)."""
    lib = _LOADED.get(u.digest)
    if lib is None:
        lib = ctypes.CDLL(str(build([u])[u.digest]))
        fam = FAMILIES[u.family]
        pointers = [_P] * sum(u.leaves)
        for name, (restype, argtypes) in (*fam.signatures.items(), *(
                (name, (_I, pointers + e.argtypes))
                for name, e in fam.leaf_entries.items())):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LOADED[u.digest] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA kernel launch failed with cudaError_t {code}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the C functions take it.

    The private call returns what ``torch.cuda.current_stream(t.device)
    .cuda_stream`` does, without building a Stream object: 0.10 against
    7.28 us a call on the H100's host (PERF.md, the host stages), more
    than the 2 us for which the port takes a private API over a public
    one."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Check device and contiguity before a pointer reaches C."""
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or (t is not first and t.device != first.device):
            raise ValueError(f"{what}: all operands must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def ptrs(tensors) -> list[int]:
    """One pointer per leaf, for a :class:`LeafEntry`'s scalar arguments."""
    return [t.data_ptr() for t in tensors]


_LEAF_ARRAY = ctypes.c_void_p * alg.MAX_DEVICE_LEAVES


def leaf_ptrs(tensors) -> ctypes.Array:
    """The C ``void* const*`` of up to five leaves (None leaves and the
    slots past the last stay null)."""
    return _LEAF_ARRAY(*[ptr(t) for t in tensors])


def scratch(elements: int, leaves: int, like: torch.Tensor) -> torch.Tensor:
    """Scratch for ``elements`` kernel elements of ``leaves`` leaves, on
    ``like``'s device: 8 bytes a leaf covers every element struct."""
    return torch.empty(8 * leaves * elements, dtype=torch.uint8,
                       device=like.device)


def element_bytes(dtypes) -> int:
    """sizeof of the generated element struct of leaves ``dtypes``: each
    leaf at its natural alignment, the whole padded to the largest."""
    off, align = 0, 1
    for d in dtypes:
        size = d.itemsize
        off = -(-off // size) * size + size
        align = max(align, size)
    return -(-off // align) * align


def outputs(like: torch.Tensor, dtypes, shape) -> list[torch.Tensor]:
    """The output leaves of ``dtypes`` and ``shape`` on ``like``'s device,
    in one allocation: one tensor, or views of one byte buffer, each leaf
    at a 16-byte boundary."""
    if len(dtypes) == 1:
        return [like.new_empty(shape, dtype=dtypes[0])]
    count = math.prod(shape)
    sizes = [count * d.itemsize for d in dtypes]
    offs = [0]
    for s in sizes[:-1]:
        offs.append(offs[-1] + -(-s // 16) * 16)
    buf = like.new_empty(offs[-1] + sizes[-1], dtype=torch.uint8)
    return [buf[o:o + s].view(d).view(shape)
            for o, s, d in zip(offs, sizes, dtypes)]


# A lookback flag holds epoch << 2 | state (csrc/lookback.cuh: EPOCH_MAX).
EPOCH_MAX = (1 << 30) - 1


class Workspace:
    """One stream's memory for the launches whose blocks meet through it,
    grown on demand and never shared with another stream, whose launches
    could overlap.  Launches on one stream run one after another, so the
    GEMVs (kernels/matvec.py) and K2's lookback share it:

    * ``counters`` -- int32 words, 0 at rest: a launch takes words from 0
      (a chunked GEMV one a grid-x block, the lookback its ticket) and its
      last block sets them back to 0;
    * ``partials`` -- bytes a launch writes before it reads them (a chunked
      GEMV's partials, the lookback's tile values);
    * ``flags`` -- the lookback's int32 tile flags, tagged with ``epoch``,
      the epoch of the stream's last lookback launch (:meth:`next_epoch`).
    """

    __slots__ = ("counters", "partials", "flags", "epoch")

    def __init__(self):
        self.counters = self.partials = self.flags = None
        self.epoch = 0

    def next_epoch(self) -> int:
        """The epoch of the next lookback launch on this stream: 1, 2, ...,
        EPOCH_MAX, then 1 again over flags zeroed anew, so no flag of an
        earlier launch reads as this one's."""
        if self.epoch == EPOCH_MAX:
            self.flags.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


_WORKSPACES: dict[tuple[int, int], Workspace] = {}


def workspace(like: torch.Tensor, stream: int, counters: int,
              partial_bytes: int, flags: int = 0) -> Workspace:
    """The workspace of ``stream`` on ``like``'s device, with at least
    ``counters`` zero words, ``partial_bytes`` bytes of partials and
    ``flags`` lookback flags."""
    key = (like.get_device(), stream)
    w = _WORKSPACES.get(key)
    if w is None:
        w = _WORKSPACES[key] = Workspace()
    if w.counters is None or w.counters.numel() < counters:
        # Zeroed once, on this stream, before any launch that uses it.
        w.counters = like.new_zeros(max(counters, 1024), dtype=torch.int32)
    if w.partials is None or w.partials.numel() < partial_bytes:
        w.partials = like.new_empty(max(partial_bytes, 1 << 20),
                                    dtype=torch.uint8)
    if flags and (w.flags is None or w.flags.numel() < flags):
        # Zero reads as unset under every epoch.
        w.flags = like.new_zeros(max(flags, 1024), dtype=torch.int32)
    return w
