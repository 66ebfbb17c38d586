"""The route registry and backend dispatch (the registry half of
``repro.core.intrinsics``).

One declarative table says which (primitive, layout) routes exist, how each
validates its arguments and what it does at zero extent; implementations
register per backend from ``kernels/ops.py``.  Two backends exist:

* ``torch`` -- the plain PyTorch versions, always available, on any device;
* ``cuda``  -- the hand-written kernels under ``csrc/``.  On a CUDA tensor a
  ``cuda`` route launches its kernel or raises; it never swaps in the plain
  version.

With no explicit ``backend=`` and no :func:`use_backend` scope, the backend
follows the operands: ``cuda`` for tensors on a CUDA device, ``torch``
otherwise.  The TPU tiling helpers and tuning policies of the reference do
not port: their work moves inside the kernels.  The one policy value the
compositions read is :data:`SORT_DIGIT_BITS`, the radix sort's digit width.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import layout as lay

# The radix sort's digit width (bits per scatter pass): the reference's
# ``gpu_h100`` tuning value.  Wider digits mean fewer passes but a wider
# one-hot matrix per pass (2^bits buckets); kernels/sort.py reads it.
SORT_DIGIT_BITS = 8


# --------------------------------------------------------------------------
# Backend registry: a thread-local scoped override (use_backend) and
# registry-driven capability queries (available_backends / supports).
# --------------------------------------------------------------------------

_IMPL_REGISTRY: dict[tuple[str, str], Callable] = {}


class _BackendScope(threading.local):
    """Per-thread stack of use_backend() overrides (innermost wins)."""

    def __init__(self):
        self.stack: list[str] = []


_BACKEND_SCOPE = _BackendScope()


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
    the innermost use_backend() scope, else ``cuda`` when ``data``'s leaves
    lie on a CUDA device, else ``torch``."""
    return _backend_of(_leaves(data))


def _backend_of(leaves: list) -> str:
    if _BACKEND_SCOPE.stack:
        return _BACKEND_SCOPE.stack[-1]
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
    return impl


# --------------------------------------------------------------------------
# The declarative primitive registry.
# --------------------------------------------------------------------------


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
    _check_grad(route, backend, args)
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


# The routes whose cuda implementation carries its gradient (an
# ``autograd.Function``: kernels/ops.py's ``LinearRecurrence``).
GRAD_ROUTES = frozenset({"linear_recurrence@flat",
                         "linear_recurrence@batched"})


def _requires_grad(arg) -> bool:
    if isinstance(arg, torch.Tensor):
        return arg.requires_grad
    if type(arg) in pytree.SUPPORTED_NODES:
        return any(isinstance(t, torch.Tensor) and t.requires_grad
                   for t in pytree.tree_leaves(arg))
    return False


def _check_grad(route: RouteDef, backend: str, args: tuple) -> None:
    """A cuda route launches through ctypes, so its output has no
    ``grad_fn``: with grad mode on and an input that requires grad it would
    silently cut the graph.  Such a call raises, naming the route, unless
    the route carries its gradient (``GRAD_ROUTES``)."""
    if backend != "cuda" or route.key in GRAD_ROUTES or \
            not torch.is_grad_enabled():
        return
    if any(_requires_grad(a) for a in args):
        raise RuntimeError(
            f"{route.key} (cuda): the kernel has no gradient, and an input "
            f"requires one; call it under torch.no_grad(), or on the torch "
            f"backend (use_backend('torch')) to differentiate through it")


# -- the table itself -------------------------------------------------------

define_primitive(
    "copy",
    RouteDef("copy", "flat", zero_extent="passthrough"),
    doc="bandwidth-ceiling tiled copy")

define_primitive(
    "scan",
    RouteDef("scan", "flat", data_arg=1, op_arg=0, zero_extent="passthrough"),
    RouteDef("scan", "batched", data_arg=1, op_arg=0, arg_ranks=((1, 2),),
             fixed_kwargs=(("axis", 0),), zero_extent="passthrough",
             notes="per-row scan along axis 1 of (B, n) leaves"),
    RouteDef("scan", "segmented", data_arg=1, op_arg=0, arg_ranks=((1, 1),),
             fixed_kwargs=(("axis", 0), ("reverse", False)),
             needs_descriptor=True, zero_extent="passthrough",
             notes="restarts at every segment boundary"),
    doc="prefix scan with any associative operator")

define_primitive(
    "mapreduce",
    RouteDef("mapreduce", "flat", data_arg=2, op_arg=1,
             commutative_only=True),
    RouteDef("mapreduce", "batched", data_arg=2, op_arg=1,
             arg_ranks=((2, 2),), fixed_kwargs=(("axis", None),),
             noncomm_route="scan@batched",
             zero_extent="batched_reduce_identity",
             notes="non-commutative ops reroute via scan@batched"),
    RouteDef("mapreduce", "segmented", data_arg=2, op_arg=1,
             arg_ranks=((2, 1),), fixed_kwargs=(("axis", None),),
             needs_descriptor=True, needs_num_segments=True,
             zero_extent="segmented_reduce_identity",
             notes="one output element per segment; empties yield identity; "
                   "order-preserving (segmented scan + gather), so "
                   "non-commutative ops are valid"),
    doc="op-reduction of f(x)")

define_primitive(
    "matvec",
    RouteDef("matvec", "flat", data_arg=2, op_arg=1,
             arg_ranks=((2, 2), (3, 1))),
    RouteDef("matvec", "batched", data_arg=2, op_arg=1,
             arg_ranks=((2, 3), (3, 2)), zero_extent="batched_mv_identity"),
    doc="y[j] = op_i f(x[i], A[i, j]) (generalized semiring matvec)")

define_primitive(
    "vecmat",
    RouteDef("vecmat", "flat", data_arg=2, op_arg=1,
             arg_ranks=((2, 2), (3, 1))),
    RouteDef("vecmat", "batched", data_arg=2, op_arg=1,
             arg_ranks=((2, 3), (3, 2)), zero_extent="batched_mv_identity"),
    doc="z[i] = op_j f(A[i, j], x[j]) (generalized semiring vecmat)")

define_primitive(
    "linear_recurrence",
    RouteDef("linear_recurrence", "flat", arg_ranks=((0, 3), (1, 3))),
    RouteDef("linear_recurrence", "batched", arg_ranks=((0, 3), (1, 3)),
             notes="the recurrent models' prefill route"),
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
        RouteDef(_sort_prim, "flat", arg_ranks=((0, 1),)),
        RouteDef(_sort_prim, "segmented", arg_ranks=((0, 1),),
                 needs_descriptor=True,
                 needs_num_segments=(_sort_prim == "top_k"),
                 notes=_sort_notes),
        doc=f"radix-sort family: {_sort_prim}")
