"""The route registry, backend dispatch and tuning policies (the registry
half of ``repro.core.intrinsics``).

One declarative table says which (primitive, layout) routes exist, how each
validates its arguments, what it does at zero extent and which policy knobs
its autotuner races; implementations register per backend from
``kernels/ops.py``.  Two backends exist:

* ``torch`` -- the plain PyTorch versions, always available, on any device;
* ``cuda``  -- the hand-written kernels under ``csrc/``.  On a CUDA tensor a
  ``cuda`` route launches its kernel or raises; it never swaps in the plain
  version.

With no explicit ``backend=``, no :func:`use_backend` scope and no
(deprecated) :func:`force_backend` pin, the backend follows the operands:
``cuda`` for tensors on a CUDA device, ``torch`` otherwise.  The TPU tiling
helpers of the reference do not port: their work moves inside the kernels.
The tuning policies do (:class:`TuningPolicy`): each tunable ``cuda``
implementation takes ``policy=`` and maps one field onto one launch knob of
its kernel; ``core/tuning.py``'s autotuner races a route's ladder
(:class:`TuneRecipe`) through the hook :func:`resolve_impl` consults.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import warnings
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import layout as lay
from repro_torch.core import operators as alg


# --------------------------------------------------------------------------
# Tuning policies (the reference's A40 <: Ampere <: AbstractArch analogue).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuningPolicy:
    """Per-card launch knobs of the port's kernels, with the reference's
    field names.  The defaults are the launch every kernel made before the
    knobs existed, so a policy with no overrides changes nothing.  What each
    field means here (on the TPU a field sized a Pallas grid step; on the
    card it sizes a thread's or a block's share of the work):

    * ``nitem_copy`` -- K1's 16-byte vectors a thread (``kernels/copy.py``:
      1, 2, 4, 8 or 16).
    * ``nitem_scan`` -- the items a thread of a scan tile scans
      (``csrc/tile_scan.cuh``: ``Tile<E, N>``, at most 8 N and 128 bytes of
      them): K2 (its lookback's tile, ``Lookback<E, N>``, takes up to 4 N
      items of 128 bytes), K7s, K8; K6's steps a thread a chunk
      (``csrc/scan.cuh``: ``Run<E, N>``) and its long-T chunk of 8 N steps;
      the radix sort's rank and offset scans.  A compile-time constant: each
      value is a unit of its own.
    * ``nitem_reduce`` -- K3's items a thread before its grid grows (and its
      small form's extent, 256 N; ``csrc/mapreduce.cuh``: ``Flat<N>``, a
      unit of its own); K7m's split chunk, at least 4 N loads a thread
      (host-side, ``kernels/batched.py: rows_geometry``).
    * ``matvec_rows`` -- K7's matvec (COLUMNS): row groups a block at most,
      twice as many over a quantized matrix (``kernels/matvec.py:
      geometry``).
    * ``vecmat_rows`` -- K7's dense vecmat over more than 64 columns
      (ROWS): the loads a lane takes at least, so fewer give a row more
      lanes and a block fewer rows; TALL's and STRIPS's rows follow their
      shared tile and quantization block instead.
    * ``sort_digit_bits`` -- the radix sort's digit width, 2^bits buckets a
      pass (``kernels/sort.py``).
    * ``matvec_cols``, ``vecmat_cols``, ``tall_threshold``,
      ``vmem_budget_bytes``, ``gpu_threads``, ``gpu_vec_bytes`` -- Pallas
      block shapes of the reference; no port kernel reads them.
    * ``overlap_chunks`` -- the ``@sharded`` routes' slabs, read by the
      distributed layer when it ports.

    The chip table registers ``generic`` (no card) and the GPU family
    (``gpu_generic`` <: ``gpu_a100`` <: ``gpu_h100``; ``gpu_mi300``): the
    port's values, today's launch on each, measured on the H100 only.  The
    reference's TPU entries (``tpu_v5e``, ``tpu_v5p``) and interpret entries
    (``interpret``, ``gpu_interpret``) have no port backend and are not
    registered.
    """

    name: str = "generic"
    nitem_copy: int = 8
    nitem_scan: int = 8
    nitem_reduce: int = 8
    matvec_rows: int = 8
    matvec_cols: int = 2
    vecmat_rows: int = 8
    vecmat_cols: int = 8
    tall_threshold: float = 64.0
    vmem_budget_bytes: int = 64 * 1024 * 1024
    sort_digit_bits: int = 8
    gpu_threads: int = 256
    gpu_vec_bytes: int = 16
    overlap_chunks: int = 4


_TUNING_REGISTRY: dict[str, TuningPolicy] = {}
_TUNING_PARENTS: dict[str, str] = {}


def register_tuning(name: str, policy: TuningPolicy, parent: str = "generic"):
    _TUNING_REGISTRY[name] = policy
    _TUNING_PARENTS[name] = parent


register_tuning("generic", TuningPolicy())
register_tuning("gpu_generic", TuningPolicy(name="gpu_generic"))
register_tuning("gpu_a100", TuningPolicy(name="gpu_a100"),
                parent="gpu_generic")
register_tuning("gpu_h100", TuningPolicy(name="gpu_h100"), parent="gpu_a100")
register_tuning("gpu_mi300", TuningPolicy(name="gpu_mi300"),
                parent="gpu_generic")


def resolve_tuning(name: str | None = None) -> TuningPolicy:
    """The policy registered as ``name`` (None: :func:`detect_chip`'s), or
    that of its nearest registered parent."""
    if name is None:
        name = detect_chip()
    while name not in _TUNING_REGISTRY:
        name = _TUNING_PARENTS.get(name, "generic")
    return _TUNING_REGISTRY[name]


@functools.cache
def detect_chip() -> str:
    """The chip-table name of the current CUDA card, from
    ``torch.cuda.get_device_name()`` ("NVIDIA H100 80GB HBM3" gives
    ``gpu_h100``); ``generic`` with no card.  Asked once a process."""
    if not torch.cuda.is_available():
        return "generic"
    kind = torch.cuda.get_device_name().lower()
    for tag, name in (("h100", "gpu_h100"), ("h200", "gpu_h100"),
                      ("a100", "gpu_a100"), ("mi300", "gpu_mi300"),
                      ("mi250", "gpu_mi300")):
        if tag in kind:
            return name
    return "gpu_generic"


def default_policy_name(backend: str | None) -> str | None:
    """The tuning-policy name a backend's kernels resolve when no policy is
    passed, shared by the compositions and the autotuner hook so that both
    start from the same base policy: None (the detected card's) for both
    backends -- the ``torch`` rows read no knob, but the radix sort's digit
    width is a policy field on either."""
    return None


# --------------------------------------------------------------------------
# Backend registry: a thread-local scoped override (use_backend) and
# registry-driven capability queries (available_backends / supports).
# --------------------------------------------------------------------------

_IMPL_REGISTRY: dict[tuple[str, str], Callable] = {}
_FORCED_BACKEND: str | None = None           # legacy force_backend() shim
_FORCE_BACKEND_WARNED = False
_SUB_BACKEND_WARNED = False
# Optional autotuner hook (installed by core.tuning, to avoid a layering
# cycle): called as hook(primitive, backend, impl); it may return a wrapped
# impl that injects a benchmarked TuningPolicy, or None to pass through.
_TUNER_HOOK: Callable[[str, str, Callable], Callable | None] | None = None


class _BackendScope(threading.local):
    """Per-thread stack of use_backend() overrides (innermost wins)."""

    def __init__(self):
        self.stack: list[str] = []


_BACKEND_SCOPE = _BackendScope()


def set_tuner_hook(hook: Callable | None):
    """Install (or clear) the autotune wrapper consulted by resolve_impl."""
    global _TUNER_HOOK
    _TUNER_HOOK = hook


def register_impl(primitive: str, backend: str):
    def deco(fn):
        _IMPL_REGISTRY[(primitive, backend)] = fn
        return fn

    return deco


def _known_backends() -> set[str]:
    # Registration happens when kernels/ops.py imports; pull it in lazily so
    # the query API works without making this layer import the kernels.
    if not _IMPL_REGISTRY:
        from repro_torch.kernels import ops as _ops  # noqa: F401
    return {b for (_, b) in _IMPL_REGISTRY}


def available_backends() -> tuple[str, ...]:
    """All backend names with at least one registered implementation."""
    return tuple(sorted(_known_backends()))


def supports(route: str, backend: str) -> bool:
    """Whether ``route`` (e.g. ``"scan@flat"``) has a ``backend``
    implementation.  Unknown route or backend names raise ValueError."""
    if route not in route_keys():
        raise ValueError(
            f"unknown route {route!r} (routes: {sorted(route_keys())})")
    if backend not in _known_backends():
        raise ValueError(
            f"unknown backend {backend!r} "
            f"(available: {', '.join(available_backends())})")
    return (route, backend) in _IMPL_REGISTRY


@contextlib.contextmanager
def use_backend(backend: str):
    """Scoped backend override: ``with use_backend("torch"): ...``.

    Thread-safe (each thread keeps its own stack; innermost scope wins) and
    validated up front.  An explicit ``backend=`` argument on a primitive
    call still takes precedence over the scope.
    """
    if backend not in _known_backends():
        raise ValueError(
            f"unknown backend {backend!r} "
            f"(available: {', '.join(available_backends())})")
    _BACKEND_SCOPE.stack.append(backend)
    try:
        yield backend
    finally:
        _BACKEND_SCOPE.stack.pop()


def force_backend(backend: str | None):
    """Deprecated: process-global backend pin.  Use :func:`use_backend`.

    Kept as a warn-once shim with unchanged behavior (a global default that
    scoped overrides and explicit ``backend=`` arguments still beat).
    """
    global _FORCED_BACKEND, _FORCE_BACKEND_WARNED
    if not _FORCE_BACKEND_WARNED:
        warnings.warn(
            "force_backend() is deprecated; use the scoped "
            "repro_torch.core.intrinsics.use_backend(...) context manager "
            "instead", DeprecationWarning, stacklevel=2)
        _FORCE_BACKEND_WARNED = True
    _FORCED_BACKEND = backend


def sub_backend_alias(fn):
    """Deprecated-alias shim: the composition entry points (the radix
    sorts) used to spell their backend parameter ``sub_backend=``.  The
    alias still works -- warn once per process, like :func:`force_backend`
    -- and forwards to ``backend=``; passing both spellings is an error."""

    @functools.wraps(fn)
    def wrapper(*args, sub_backend=None, **kwargs):
        global _SUB_BACKEND_WARNED
        if sub_backend is not None:
            if "backend" in kwargs:
                raise TypeError(
                    f"{fn.__name__}: got both backend= and its deprecated "
                    "alias sub_backend=; pass backend= only")
            if not _SUB_BACKEND_WARNED:
                warnings.warn(
                    "the sub_backend= keyword is deprecated; compositions "
                    "now take the same backend= spelling as every other "
                    "primitive", DeprecationWarning, stacklevel=2)
                _SUB_BACKEND_WARNED = True
            kwargs["backend"] = sub_backend
        return fn(*args, **kwargs)

    return wrapper


def _leaves(data) -> list:
    """``data``'s leaves; a bare tensor is its own, with no pytree walk."""
    return [data] if isinstance(data, torch.Tensor) else \
        pytree.tree_leaves(data)


def scoped_backend() -> str | None:
    """The innermost use_backend() scope of this thread, or None.  The
    autograd engine runs a CUDA backward on threads of its own, which see
    no scope: code that computes again in the backward (``lm._remat``)
    pins the forward's with this."""
    return _BACKEND_SCOPE.stack[-1] if _BACKEND_SCOPE.stack else None


def current_backend(data=None) -> str:
    """The backend dispatch uses when no explicit ``backend=`` is passed:
    the innermost use_backend() scope, else the (deprecated) forced
    global, else ``cuda`` when ``data``'s leaves lie on a CUDA device,
    else ``torch``."""
    return _backend_of(_leaves(data))


def _backend_of(leaves: list) -> str:
    if _BACKEND_SCOPE.stack:
        return _BACKEND_SCOPE.stack[-1]
    if _FORCED_BACKEND is not None:
        return _FORCED_BACKEND
    if leaves and isinstance(leaves[0], torch.Tensor) and leaves[0].is_cuda:
        return "cuda"
    return "torch"


def resolve_impl(primitive: str, backend: str | None = None,
                 data=None) -> Callable:
    backend = backend or current_backend(data)
    impl = _IMPL_REGISTRY.get((primitive, backend))
    if impl is None:
        if backend not in _known_backends():
            raise ValueError(
                f"{primitive}: unknown backend {backend!r} "
                f"(available: {', '.join(available_backends())})")
        # Unlike the reference (which falls back to xla here), a known
        # backend without this route raises: a missing kernel must not be
        # hidden behind the plain version.
        raise NotImplementedError(
            f"{primitive}: no {backend!r} implementation")
    if _TUNER_HOOK is not None:
        wrapped = _TUNER_HOOK(primitive, backend, impl)
        if wrapped is not None:
            return wrapped
    return impl


# --------------------------------------------------------------------------
# The declarative primitive registry.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuneRecipe:
    """How to build a tuning cache key + which policy knobs to race.

    ``dims`` selects the generic key extractor in ``core.tuning``:

    * ``"flat"``   -- ``n`` = total element count over the data's leaves;
    * ``"row"``    -- ``(B, n)`` leaves: per-row extent + batch bucket;
    * ``"trail2"`` -- ``(B, d1, d2)`` leading leaf: the two trailing dims
      bucket *separately* (``"8192x128"``) because the launch branches on
      the aspect ratio, plus the batch bucket.
    """

    ladder: tuple  # TuningPolicy field-override dicts to race
    # Argument indices default to the enclosing RouteDef's data_arg/op_arg
    # (resolved in core.tuning) -- override only when the key should read a
    # different operand than dispatch validates.
    data_arg: int | None = None
    op_arg: int | None = None      # positional index of the AssocOp, or
    op_label: str | None = None    # a fixed label when the op is implicit
    dims: str = "flat"


@dataclasses.dataclass(frozen=True)
class RouteDef:
    """One (primitive, layout) row of the registry.

    ``args`` indices refer to the positional call convention of the public
    entry point (and of the registered implementations, which share it).
    """

    primitive: str
    layout: str
    data_arg: int = 0
    op_arg: int | None = None
    # ((arg index, required leaf rank), ...) -- checked on every leaf.
    arg_ranks: tuple = ()
    # ((kwarg name, required value), ...) -- kwargs the layout pins; they are
    # validated then stripped before the implementation call.
    fixed_kwargs: tuple = ()
    commutative_only: bool = False
    # Registered key to reroute non-commutative ops through (mapreduce ->
    # order-preserving scan of the mapped values, take-last).
    noncomm_route: str | None = None
    # Name of a shared zero-extent guard in _ZERO_GUARDS (None: the
    # implementation/composition handles zero extents itself).
    zero_extent: str | None = None
    needs_descriptor: bool = False    # Segmented: exactly one of flags/offsets
    needs_num_segments: bool = False  # Segmented flag variant: static extent
    tuning: TuneRecipe | None = None
    notes: str = ""

    @property
    def key(self) -> str:
        return f"{self.primitive}@{self.layout}"


@dataclasses.dataclass(frozen=True)
class PrimitiveDef:
    """A public primitive and its layout routes."""

    name: str
    routes: dict  # layout kind -> RouteDef
    doc: str = ""


PRIMITIVE_DEFS: dict[str, PrimitiveDef] = {}


def define_primitive(name: str, *routes: RouteDef, doc: str = ""):
    PRIMITIVE_DEFS[name] = PrimitiveDef(
        name=name, routes={r.layout: r for r in routes}, doc=doc)


def iter_routes():
    """Every RouteDef in the registry, in definition order."""
    for pdef in PRIMITIVE_DEFS.values():
        yield from pdef.routes.values()


def route_keys() -> set[str]:
    return {r.key for r in iter_routes()}


def get_route(primitive: str, kind: str) -> RouteDef:
    pdef = PRIMITIVE_DEFS.get(primitive)
    if pdef is None:
        raise NotImplementedError(f"unknown primitive {primitive!r}")
    route = pdef.routes.get(kind)
    if route is None:
        raise ValueError(
            f"{primitive}: unsupported layout {kind!r} "
            f"(supported: {sorted(pdef.routes)})")
    return route


# -- shared zero-extent guards (single implementations, wired by name) ------


def _zg_passthrough(route, args, kwargs, leaves):
    """Any zero extent in the data: the input already is the output."""
    if 0 in leaves[0].shape:
        return True, args[route.data_arg]
    return False, None


def _zg_batched_reduce_identity(route, args, kwargs, leaves):
    """(B, 0) rows / B == 0: reducing zero elements yields identity rows."""
    f, op, xs = args[0], args[1], args[2]
    B, n = leaves[0].shape
    if B and n:
        return False, None
    one = f(pytree.tree_map(lambda l: l[:1, :0], xs))   # mapped dtypes only
    return True, op.identity(pytree.tree_map(
        lambda l: torch.empty((B,), dtype=l.dtype, device=l.device), one))


def _zg_segmented_reduce_identity(route, args, kwargs, leaves):
    """Zero-length stream: every declared segment reduces to identity."""
    f, op, xs = args[0], args[1], args[2]
    if leaves[0].shape[0] != 0:
        return False, None
    offsets = kwargs.get("offsets")
    ns = (kwargs.get("num_segments") if offsets is None
          else offsets.shape[0] - 1)
    vals = f(xs)                                        # mapped dtypes only
    return True, op.identity(pytree.tree_map(
        lambda l: torch.empty((ns,) + tuple(l.shape[1:]), dtype=l.dtype,
                              device=l.device), vals))


def _zg_batched_mv_identity(route, args, kwargs, leaves):
    """(B, n, p) with any zero extent: identity rows of the output extent."""
    f, op, A, x = args[0], args[1], args[2], args[3]
    B, n, p = A.shape
    if B and n and p:
        return False, None

    def like(dtype):
        return torch.empty((1, 1), dtype=dtype, device=x.device)
    if route.primitive == "matvec":       # y[b, j]: extent p, f(x, a)
        out_extent, one = p, f(like(x.dtype), like(A.dtype))
    else:                                 # z[b, i]: extent n, f(a, x)
        out_extent, one = n, f(like(A.dtype), like(x.dtype))
    return True, op.identity(pytree.tree_map(
        lambda l: torch.empty((B, out_extent), dtype=l.dtype,
                              device=x.device), one))


_ZERO_GUARDS = {
    "passthrough": _zg_passthrough,
    "batched_reduce_identity": _zg_batched_reduce_identity,
    "segmented_reduce_identity": _zg_segmented_reduce_identity,
    "batched_mv_identity": _zg_batched_mv_identity,
}


# -- the dispatch pipeline --------------------------------------------------


def _validate(route: RouteDef, layout, args, kwargs, leaves):
    where = route.key
    for name, required in route.fixed_kwargs:
        if name in kwargs:
            got = kwargs.pop(name)
            if got is not required and got != required:
                raise ValueError(
                    f"{where}: {name}= is pinned by the "
                    f"{layout.describe()} layout -- leave it at its "
                    f"default ({required!r}); got {got!r}"
                    + (f". {route.notes}" if route.notes else ""))
    if route.needs_descriptor:
        lay.validate_descriptor(layout.flags, layout.offsets, where=where)
        if (route.needs_num_segments and layout.offsets is None
                and layout.num_segments is None):
            raise ValueError(
                f"{where}: the flags descriptor needs Segmented("
                f"num_segments=...) -- the output extent is static")
    for idx, rank in route.arg_ranks:
        for leaf in leaves if idx == route.data_arg else \
                _leaves(args[idx]):
            if leaf.ndim != rank:
                raise ValueError(
                    f"{where}: argument {idx} expects rank-{rank} leaves "
                    f"for the {layout.describe()} layout, got shape "
                    f"{tuple(leaf.shape)}")
    if route.op_arg is not None and route.commutative_only:
        op = args[route.op_arg]
        if not getattr(op, "commutative", False):
            raise ValueError(
                f"{where}: requires a commutative operator, got "
                f"{getattr(op, 'name', op)!r} (non-commutative ops take "
                f"the order-preserving scan routes)")


def dispatch(primitive: str, layout, backend: str | None,
             args: tuple, kwargs: dict):
    """Resolve and call one (primitive, layout, backend) route: validation,
    layout-descriptor injection, zero-extent guard, non-commutative reroute,
    then the backend's implementation.  The data's leaves are walked once,
    here, and serve every step."""
    layout = lay.as_layout(layout)
    route = get_route(primitive, layout.kind)
    leaves = _leaves(args[route.data_arg])
    kwargs = dict(kwargs)
    _validate(route, layout, args, kwargs, leaves)
    if route.needs_descriptor:
        kwargs["flags"] = layout.flags
        kwargs["offsets"] = layout.offsets
        if route.needs_num_segments:
            kwargs["num_segments"] = layout.num_segments
    if route.zero_extent is not None:
        handled, result = _ZERO_GUARDS[route.zero_extent](route, args, kwargs,
                                                          leaves)
        if handled:
            return result
    backend = backend or _backend_of(leaves)
    _check_grad(route, backend, args, kwargs, leaves)
    if route.noncomm_route is not None and not getattr(
            args[route.op_arg], "commutative", False):
        # Order-preserving reroute: scan the mapped values with the same
        # layout, take each problem's last element.  On the cuda backend
        # that is K7s; K7m, which folds in no fixed order, is never asked.
        f, op, xs = args[0], args[1], args[2]
        vals = f(xs)
        incl = resolve_impl(route.noncomm_route, backend, vals)(
            op, vals, inclusive=True)
        return pytree.tree_map(lambda l: l[:, -1], incl)
    impl = resolve_impl(route.key, backend)
    return impl(*args, **kwargs)


def _maxplus_affine_form(args, kwargs, leaves) -> bool:
    """The mLSTM stabilizer's form: an inclusive forward scan under
    MAXPLUS_AFFINE along axis 1 of 3-D leaves."""
    return (args[0] is alg.MAXPLUS_AFFINE and kwargs.get("axis") == 1
            and kwargs.get("inclusive", True)
            and not kwargs.get("reverse", False)
            and all(l.ndim == 3 for l in leaves))


# The routes whose cuda implementation carries its gradient (an
# ``autograd.Function`` of kernels/ops.py: ``LinearRecurrence``,
# ``MaxplusAffineScan``), each with the test of the calls it carries it
# for (None: every call).
GRAD_ROUTES = {"linear_recurrence@flat": None,
               "linear_recurrence@batched": None,
               "scan@flat": _maxplus_affine_form}


def _requires_grad(arg) -> bool:
    if isinstance(arg, torch.Tensor):
        return arg.requires_grad
    if type(arg) in pytree.SUPPORTED_NODES:
        return any(isinstance(t, torch.Tensor) and t.requires_grad
                   for t in pytree.tree_leaves(arg))
    return False


def _check_grad(route: RouteDef, backend: str, args: tuple, kwargs: dict,
                leaves: list) -> None:
    """A cuda route launches through ctypes, so its output has no
    ``grad_fn``: with grad mode on and an input that requires grad it would
    silently cut the graph.  Such a call raises, naming the route, unless
    the route carries its gradient for it (``GRAD_ROUTES``)."""
    if backend != "cuda" or not torch.is_grad_enabled():
        return
    if route.key in GRAD_ROUTES:
        form = GRAD_ROUTES[route.key]
        if form is None or form(args, kwargs, leaves):
            return
    if any(_requires_grad(a) for a in args):
        raise RuntimeError(
            f"{route.key} (cuda): the kernel has no gradient, and an input "
            f"requires one; call it under torch.no_grad(), or on the torch "
            f"backend (use_backend('torch')) to differentiate through it")


# -- the table itself -------------------------------------------------------

# The reference's ladders, every route that is not sharded; the sharded
# routes' overlap_chunks ladders come with the distributed layer.
_NITEM_SCAN = tuple({"nitem_scan": v} for v in (4, 8, 16, 32))
_NITEM_REDUCE = tuple({"nitem_reduce": v} for v in (4, 8, 16))
_NITEM_COPY = tuple({"nitem_copy": v} for v in (4, 8, 16))
# Radix sort races digit width x block policy: wider digits mean fewer
# scatter passes but a larger per-pass rank scan, and the rank scan's own
# block size (nitem_scan) interacts with the digit count.
_SORT_LADDER = tuple({"sort_digit_bits": d, "nitem_scan": m}
                     for d in (2, 4, 8) for m in (8, 16))
_MATVEC_ROWS = tuple({"matvec_rows": v} for v in (4, 8, 16))
_VECMAT_ROWS = tuple({"vecmat_rows": v} for v in (4, 8, 16))
# K6's channel-tile route cannot take 32 steps a thread of the AFFINE f32
# pair its recurrence scans: two register sets of 32 pairs are 128 of a
# thread's registers, so Run<E, N> caps a run at 128 bytes, and 32 would
# launch what 16 launches.  The port's ladder leaves it out.
_NITEM_LINREC = tuple(c for c in _NITEM_SCAN if c["nitem_scan"] != 32)

_SORT_TUNE = TuneRecipe(_SORT_LADDER, op_label="keys")

define_primitive(
    "copy",
    RouteDef("copy", "flat", zero_extent="passthrough",
             tuning=TuneRecipe(_NITEM_COPY, op_label="copy")),
    doc="bandwidth-ceiling tiled copy")

define_primitive(
    "scan",
    RouteDef("scan", "flat", data_arg=1, op_arg=0, zero_extent="passthrough",
             tuning=TuneRecipe(_NITEM_SCAN)),
    RouteDef("scan", "batched", data_arg=1, op_arg=0, arg_ranks=((1, 2),),
             fixed_kwargs=(("axis", 0),), zero_extent="passthrough",
             tuning=TuneRecipe(_NITEM_SCAN, dims="row"),
             notes="per-row scan along axis 1 of (B, n) leaves"),
    RouteDef("scan", "segmented", data_arg=1, op_arg=0, arg_ranks=((1, 1),),
             fixed_kwargs=(("axis", 0), ("reverse", False)),
             needs_descriptor=True, zero_extent="passthrough",
             tuning=TuneRecipe(_NITEM_SCAN),
             notes="restarts at every segment boundary"),
    doc="prefix scan with any associative operator")

define_primitive(
    "mapreduce",
    RouteDef("mapreduce", "flat", data_arg=2, op_arg=1,
             commutative_only=True,
             tuning=TuneRecipe(_NITEM_REDUCE)),
    RouteDef("mapreduce", "batched", data_arg=2, op_arg=1,
             arg_ranks=((2, 2),), fixed_kwargs=(("axis", None),),
             noncomm_route="scan@batched",
             zero_extent="batched_reduce_identity",
             # Non-commutative ops never reach this tuner: dispatch reroutes
             # them to scan@batched, whose own ladder races nitem_scan.
             tuning=TuneRecipe(_NITEM_REDUCE, dims="row"),
             notes="non-commutative ops reroute via scan@batched"),
    RouteDef("mapreduce", "segmented", data_arg=2, op_arg=1,
             arg_ranks=((2, 1),), fixed_kwargs=(("axis", None),),
             needs_descriptor=True, needs_num_segments=True,
             zero_extent="segmented_reduce_identity",
             tuning=TuneRecipe(_NITEM_SCAN),
             notes="one output element per segment; empties yield identity; "
                   "order-preserving (segmented scan + gather), so "
                   "non-commutative ops are valid"),
    doc="op-reduction of f(x)")

define_primitive(
    "matvec",
    RouteDef("matvec", "flat", data_arg=2, op_arg=1,
             arg_ranks=((2, 2), (3, 1))),
    RouteDef("matvec", "batched", data_arg=2, op_arg=1,
             arg_ranks=((2, 3), (3, 2)), zero_extent="batched_mv_identity",
             tuning=TuneRecipe(_MATVEC_ROWS, dims="trail2")),
    doc="y[j] = op_i f(x[i], A[i, j]) (generalized semiring matvec)")

define_primitive(
    "vecmat",
    RouteDef("vecmat", "flat", data_arg=2, op_arg=1,
             arg_ranks=((2, 2), (3, 1))),
    RouteDef("vecmat", "batched", data_arg=2, op_arg=1,
             arg_ranks=((2, 3), (3, 2)), zero_extent="batched_mv_identity",
             tuning=TuneRecipe(_VECMAT_ROWS, dims="trail2")),
    doc="z[i] = op_j f(A[i, j], x[j]) (generalized semiring vecmat)")

define_primitive(
    "linear_recurrence",
    RouteDef("linear_recurrence", "flat", arg_ranks=((0, 3), (1, 3))),
    RouteDef("linear_recurrence", "batched", arg_ranks=((0, 3), (1, 3)),
             tuning=TuneRecipe(_NITEM_LINREC, op_label="affine",
                               dims="trail2"),
             notes="the recurrent models' prefill route; tuner keys carry "
                   "a batch bucket"),
    doc="h_t = a_t * h_{t-1} + b_t along axis 1 of (B, T, C)")

for _sort_prim, _sort_notes in (
        ("sort", "stable LSD radix; zero extents short-circuit in the "
                 "shared composition (kernels/sort.py)"),
        ("sort_pairs", "payload pytree rides the same permutation"),
        ("argsort", "segmented variant returns within-segment offsets"),
        ("top_k", "extreme-first; segmented fills short segments with "
                  "identity and index -1")):
    define_primitive(
        _sort_prim,
        RouteDef(_sort_prim, "flat", arg_ranks=((0, 1),),
                 tuning=_SORT_TUNE),
        RouteDef(_sort_prim, "segmented", arg_ranks=((0, 1),),
                 needs_descriptor=True,
                 needs_num_segments=(_sort_prim == "top_k"),
                 tuning=_SORT_TUNE, notes=_sort_notes),
        doc=f"radix-sort family: {_sort_prim}")
