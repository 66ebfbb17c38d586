"""The PyTorch port's primitives and kernel modules against the JAX package
(the batched scan and mapreduce, K7s and K7m: ``test_torch_batched_scan.py``).

Inputs come from numpy with a seed (``conftest.make_operand``); the same
arrays go through the JAX function -- its Pallas kernel in interpret mode,
``backend="pallas-interpret"`` -- and through the port's counterpart.  On
the CPU the port's kernel wrappers run their plain versions, so these tests
hold the plain versions (the oracles the card's kernels are held against
in ``chip_smoke.py``) and the route layer to the reference.

Tolerances: integer scans, reductions and matvecs, copies and sorts are
bit-exact; float32 results differ only by reassociation (the reference scans
tiles with log-step combines, the port's plain versions fold in other
orders) and are held at rtol = atol = 1e-5 (the batched scan of probability
rows, whose prefixes stay below 1, at atol = 1e-6).  The AFFINE matvec folds
products of up to 700 factors near 1: rtol = 1e-4.  Quickstart's sequence
ends in 1,000-term sums, 100,000-term UnitFloat8 sums and 128-step
recurrences: rtol = 1e-4, atol = 1e-3.
"""
import ctypes
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import make_operand  # noqa: E402
from repro.core import operators as j_alg  # noqa: E402
from repro.core import primitives as j_forge  # noqa: E402
from repro.core.layout import Batched as JBatched  # noqa: E402
from repro_torch.core import intrinsics as t_ki  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.core.layout import Batched as TBatched  # noqa: E402
from repro_torch.core.layout import Segmented as TSegmented  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import batched as batched_k  # noqa: E402
from repro_torch.kernels import copy as copy_k  # noqa: E402
from repro_torch.kernels import mapreduce as mapreduce_k  # noqa: E402
from repro_torch.kernels import matvec as matvec_k  # noqa: E402
from repro_torch.kernels import scan as scan_k  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

PI = "pallas-interpret"
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


# ---------------------------------------------------------------------------
# K2: flat scan (ADD over int32), exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 8, 1030])
@pytest.mark.parametrize("inclusive", [True, False])
def test_k2_scan_add_int32_matches_pallas(n, inclusive):
    x = make_operand("add", np.random.default_rng(n), (n,), jnp.int32)
    want = j_forge.scan(j_alg.ADD, x, inclusive=inclusive, backend=PI)
    xt = _t(x)
    plain = scan_k.scan_1d_plain(t_alg.ADD, xt, inclusive=inclusive)
    routed = t_forge.scan(t_alg.ADD, xt, inclusive=inclusive)
    wrapped = scan_k.scan_1d_cuda(t_alg.ADD, xt, inclusive=inclusive)
    for got in (plain, routed, wrapped):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_k2_scan_reverse_matches_pallas():
    x = make_operand("add", np.random.default_rng(3), (77,), jnp.int32)
    for inclusive in (True, False):
        want = j_forge.scan(j_alg.ADD, x, inclusive=inclusive, reverse=True,
                            backend=PI)
        for backend in ("torch", "cuda"):
            got = t_forge.scan(t_alg.ADD, _t(x), inclusive=inclusive,
                               reverse=True, backend=backend)
            np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_k2_scan_affine_pair_matches_pallas():
    """The non-commutative pair operator through the flat scan."""
    a, b = make_operand("affine", np.random.default_rng(5), (300,))
    wa, wb = j_forge.scan(j_alg.AFFINE, (a, b), backend=PI)
    ga, gb = scan_k.scan_1d_plain(t_alg.AFFINE, (_t(a), _t(b)))
    np.testing.assert_allclose(_np(ga), np.asarray(wa), **F32_TOL)
    np.testing.assert_allclose(_np(gb), np.asarray(wb), **F32_TOL)


# ---------------------------------------------------------------------------
# K3: flat mapreduce (MAX over int32), exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 8, 300])
def test_k3_mapreduce_max_int32_matches_pallas(n):
    x = make_operand("max", np.random.default_rng(n), (n,), jnp.int32)
    want = j_forge.mapreduce(lambda v: v, j_alg.MAX, x, backend=PI)
    xt = _t(x)
    for got in (mapreduce_k.mapreduce_1d_plain(t_alg.IDENTITY, t_alg.MAX, xt),
                mapreduce_k.mapreduce_1d_cuda(t_alg.IDENTITY, t_alg.MAX, xt),
                t_forge.mapreduce(t_alg.IDENTITY, t_alg.MAX, xt)):
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want)


def test_k3_masked_add_f32_matches_pallas():
    rng = np.random.default_rng(11)
    v = make_operand("add", rng, (513,))
    m = jnp.asarray(rng.integers(0, 2, (513,)), jnp.int32)
    want = j_forge.mapreduce(lambda t: jnp.where(t[1] != 0, t[0], 0.0),
                             j_alg.ADD, (v, m), backend=PI)
    got = t_forge.mapreduce(t_alg.masked_select(0.0), t_alg.ADD,
                            (_t(v), _t(m)), backend="cuda")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# K6: channel scan / linear recurrence (AFFINE over f32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 61, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_k6_linear_recurrence_matches_pallas(T, reverse):
    a, b = make_operand("affine", np.random.default_rng(T), (2, T, 130))
    want = j_forge.linear_recurrence(a, b, reverse=reverse,
                                     layout=JBatched(), backend=PI)
    at, bt = _t(a), _t(b)
    for backend in ("torch", "cuda"):
        got = t_forge.linear_recurrence(at, bt, reverse=reverse,
                                        layout=TBatched(), backend=backend)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("T", [1, 61, 256])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("inclusive", [True, False])
def test_k6_channel_scan_plain_matches_pallas(T, reverse, inclusive):
    a, b = make_operand("affine", np.random.default_rng(7 + T), (2, T, 20))
    wa, wb = j_forge.scan(j_alg.AFFINE, (a, b), axis=1, inclusive=inclusive,
                          reverse=reverse, backend=PI)
    ga, gb = scan_k.scan_channel_plain(t_alg.AFFINE, (_t(a), _t(b)),
                                       inclusive=inclusive, reverse=reverse)
    np.testing.assert_allclose(_np(ga), np.asarray(wa), **F32_TOL)
    np.testing.assert_allclose(_np(gb), np.asarray(wb), **F32_TOL)


def test_linear_recurrence_h0_matches_reference():
    a, b = make_operand("affine", np.random.default_rng(2), (2, 33, 8))
    h0 = make_operand("add", np.random.default_rng(9), (2, 8))
    want = j_forge.linear_recurrence(a, b, h0, layout=JBatched(), backend=PI)
    for backend in ("torch", "cuda"):
        got = t_forge.linear_recurrence(_t(a), _t(b), _t(h0),
                                        layout=TBatched(), backend=backend)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# K4: semiring matvec / vecmat, and the mapreduce axis forms that ride them
# ---------------------------------------------------------------------------

INT_OPS = ["add", "max", "min", "mul"]


@pytest.mark.parametrize("op_name", INT_OPS)
@pytest.mark.parametrize("n,p", [(37, 130), (300, 70), (5, 3)])
def test_k4_matvec_vecmat_int32_match_pallas(op_name, n, p):
    rng = np.random.default_rng(n * p)
    A = jnp.asarray(rng.integers(-9, 10, (n, p)), jnp.int32)
    xv = jnp.asarray(rng.integers(-9, 10, (n,)), jnp.int32)
    xz = jnp.asarray(rng.integers(-9, 10, (p,)), jnp.int32)
    jop, top = getattr(j_alg, op_name.upper()), getattr(t_alg, op_name.upper())
    want_mv = j_forge.matvec(lambda x, a: x * a, jop, A, xv, backend=PI)
    want_vm = j_forge.vecmat(lambda a, x: a * x, jop, A, xz, backend=PI)
    At = _t(A)
    for got in (t_forge.matvec(t_alg.TIMES, top, At, _t(xv)),
                matvec_k.matvec_cuda(t_alg.TIMES, top, At, _t(xv))):
        assert got.shape == (p,) and got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want_mv))
    for got in (t_forge.vecmat(t_alg.TIMES, top, At, _t(xz)),
                matvec_k.vecmat_cuda(t_alg.TIMES, top, At, _t(xz))):
        assert got.shape == (n,) and got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want_vm))


def test_k4_matvec_vecmat_f32_add_match_pallas():
    rng = np.random.default_rng(4)
    A = make_operand("add", rng, (200, 96))
    xv, xz = make_operand("add", rng, (200,)), make_operand("add", rng, (96,))
    want_mv = j_forge.matvec(lambda x, a: x * a, j_alg.ADD, A, xv, backend=PI)
    want_vm = j_forge.vecmat(lambda a, x: a * x, j_alg.ADD, A, xz, backend=PI)
    for backend in ("torch", "cuda"):
        np.testing.assert_allclose(
            _np(t_forge.matvec(t_alg.TIMES, t_alg.ADD, _t(A), _t(xv),
                               backend=backend)),
            np.asarray(want_mv), rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(
            _np(t_forge.vecmat(t_alg.TIMES, t_alg.ADD, _t(A), _t(xz),
                               backend=backend)),
            np.asarray(want_vm), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("op_name", ["add", "max"])
def test_k4_mapreduce_axis_forms_match_pallas(axis, op_name):
    """mapreduce over one axis of a 2-D array rides matvec (axis 0) or
    vecmat (axis 1) -- the radix sort's digit histogram is the first."""
    rng = np.random.default_rng(8)
    onehot = jnp.asarray(rng.integers(0, 2, (150, 16)), jnp.int32)
    jop, top = getattr(j_alg, op_name.upper()), getattr(t_alg, op_name.upper())
    want = j_forge.mapreduce(lambda v: v, jop, onehot, axis=axis, backend=PI)
    for backend in ("torch", "cuda"):
        got = t_forge.mapreduce(t_alg.IDENTITY, top, _t(onehot), axis=axis,
                                backend=backend)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# K6's long-T path: the route choice, and the rank scan's plain version
# ---------------------------------------------------------------------------


def test_k6_long_t_threshold_keeps_the_recurrence_on_the_channel_tile_route():
    # RG-LRU prefill and decode (C = 2560) take the channel-tile route ...
    for B, T in ((1, 17), (1, 1024), (1, 2100), (4, 1), (1, 1 << 20),
                 (8, 2048)):
        assert not scan_k.uses_long_t(B, T, 2560)
    # ... the radix sort's rank scans (1, B V, 2^d) take the long-T path.
    for C in (256, 16, 4):
        assert scan_k.uses_long_t(1, 1_024_000, C)
    assert not scan_k.uses_long_t(1, scan_k.LONG_T_MIN_STEPS - 1, 256)


@pytest.mark.parametrize("C", [4, 16])
def test_k6_rank_scan_plain_matches_pallas(C):
    """The sort's rank scan: exclusive int32 ADD along T of a one-hot
    (1, T, C) matrix, bit-exact."""
    rng = np.random.default_rng(C)
    digit = rng.integers(0, C, 300)
    onehot = jnp.asarray(digit[None, :, None] == np.arange(C)[None, None],
                         jnp.int32)
    want = j_forge.scan(j_alg.ADD, onehot, axis=1, inclusive=False,
                        backend=PI)
    got = scan_k.scan_channel_cuda(t_alg.ADD, _t(onehot), inclusive=False)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# Routes: validation texts and zero-extent guards, as the reference's
# ---------------------------------------------------------------------------


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


VALIDATION_CASES = {
    "mapreduce@flat non-commutative": (
        lambda: j_forge.mapreduce(lambda v: v, j_alg.AFFINE,
                                  (jnp.ones(8), jnp.ones(8)), backend="xla"),
        lambda: t_forge.mapreduce(t_alg.IDENTITY, t_alg.AFFINE,
                                  (torch.ones(8), torch.ones(8)))),
    "mapreduce@batched rank": (
        lambda: j_forge.mapreduce(lambda v: v, j_alg.ADD, jnp.zeros((2, 3, 4)),
                                  layout=JBatched(), backend="xla"),
        lambda: t_forge.mapreduce(t_alg.IDENTITY, t_alg.ADD,
                                  torch.zeros(2, 3, 4), layout=TBatched())),
    "linear_recurrence@batched rank": (
        lambda: j_forge.linear_recurrence(jnp.zeros((4, 4)), jnp.zeros((4, 4)),
                                          layout=JBatched(), backend="xla"),
        lambda: t_forge.linear_recurrence(torch.zeros(4, 4), torch.zeros(4, 4),
                                          layout=TBatched())),
    "scan@batched rank": (
        lambda: j_forge.scan(j_alg.ADD, jnp.zeros(4), layout=JBatched(),
                             backend="xla"),
        lambda: t_forge.scan(t_alg.ADD, torch.zeros(4), layout=TBatched())),
    "scan@batched axis": (
        lambda: j_forge.scan(j_alg.ADD, jnp.zeros((2, 4)), axis=1,
                             layout=JBatched(), backend="xla"),
        lambda: t_forge.scan(t_alg.ADD, torch.zeros(2, 4), axis=1,
                             layout=TBatched())),
    "matvec@flat rank": (
        lambda: j_forge.matvec(lambda x, a: x * a, j_alg.ADD, jnp.zeros(4),
                               jnp.zeros(4), backend="xla"),
        lambda: t_forge.matvec(t_alg.TIMES, t_alg.ADD, torch.zeros(4),
                               torch.zeros(4))),
    "vecmat@flat rank": (
        lambda: j_forge.vecmat(lambda a, x: a * x, j_alg.ADD,
                               jnp.zeros((4, 4)), jnp.zeros((4, 4)),
                               backend="xla"),
        lambda: t_forge.vecmat(t_alg.TIMES, t_alg.ADD, torch.zeros(4, 4),
                               torch.zeros(4, 4))),
    "sort@flat rank": (
        lambda: j_forge.sort(jnp.zeros((2, 4)), backend="xla"),
        lambda: t_forge.sort(torch.zeros(2, 4))),
    "linear_recurrence@flat rank": (
        lambda: j_forge.linear_recurrence(jnp.zeros((2, 4, 4)), jnp.zeros(4),
                                          backend="xla"),
        lambda: t_forge.linear_recurrence(torch.zeros(2, 4, 4),
                                          torch.zeros(4))),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validation_texts_match_reference(case):
    ref_call, port_call = VALIDATION_CASES[case]
    assert _message(port_call) == _message(ref_call)


def test_pinned_kwarg_text_matches_reference_up_to_notes():
    ref = _message(lambda: j_forge.mapreduce(
        lambda v: v, j_alg.ADD, jnp.zeros((2, 4)), axis=1, layout=JBatched(),
        backend="xla"))
    port = _message(lambda: t_forge.mapreduce(
        t_alg.IDENTITY, t_alg.ADD, torch.zeros(2, 4), axis=1,
        layout=TBatched()))
    head = "mapreduce@batched: axis= is pinned by the Batched() layout"
    assert ref.startswith(head) and port.startswith(head)
    assert ref.split(". ")[0] == port.split(". ")[0]


def test_unsupported_layout_and_unknown_backend():
    from repro_torch.core.layout import Segmented as TSegmented
    offs = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(ValueError,
                       match=r"matvec: unsupported layout 'segmented'"):
        t_forge.matvec(t_alg.TIMES, t_alg.ADD, torch.zeros(4, 4),
                       torch.zeros(4), layout=TSegmented(offsets=offs))
    with pytest.raises(ValueError, match=r"scan@flat: unknown backend 'tpu'"):
        t_forge.scan(t_alg.ADD, torch.zeros(4), backend="tpu")
    with pytest.raises(ValueError, match="unknown backend"):
        with t_ki.use_backend("tpu"):
            pass
    assert t_ki.available_backends() == ("cuda", "torch")
    assert all(t_ki.supports(r, b) for r in t_ki.route_keys()
               for b in ("cuda", "torch"))


def test_flat_scan_zero_extent_passthrough():
    x = torch.zeros(0, dtype=torch.int32)
    want = j_forge.scan(j_alg.ADD, jnp.zeros((0,), jnp.int32), backend="xla")
    got = t_forge.scan(t_alg.ADD, x, backend="cuda")
    assert got is x and got.shape == want.shape


# ---------------------------------------------------------------------------
# No fallback: what no kernel runs raises on the cuda route
# ---------------------------------------------------------------------------


def test_ops_without_device_functor_raise():
    no_functor = t_alg.AssocOp("logsumexp", lambda a, b: a, lambda l: l, True)
    with pytest.raises(NotImplementedError,
                       match="scan@flat.*'logsumexp' has no device functor"):
        _lib.unit("scan", "scan@flat", no_functor, [torch.float32])
    with pytest.raises(NotImplementedError, match="has no int64 form"):
        _lib.unit("scan", "scan@flat", t_alg.ADD, [torch.int64])
    with pytest.raises(NotImplementedError, match="takes 2 leaves"):
        _lib.unit("scan", "scan@flat", t_alg.AFFINE, [torch.float32])
    with pytest.raises(NotImplementedError, match="map .* has no device form"):
        _lib.map_out("mapreduce@flat", lambda v: v, torch.zeros(4))


def test_cpu_tensors_take_the_plain_version_without_launching():
    counts = {w: w.launches for w in (scan_k.scan_1d_cuda,
                                      mapreduce_k.mapreduce_1d_cuda)}
    x = torch.arange(6, dtype=torch.int32)
    t_forge.scan(t_alg.ADD, x, backend="cuda")
    t_forge.mapreduce(t_alg.IDENTITY, t_alg.MAX, x, backend="cuda")
    assert {w: w.launches for w in counts} == counts


def test_kernel_sources_are_listed_and_annotated():
    """Every kernel header is built by a family, and names the TPU kernel
    it replaces and what bounds it."""
    headers = {p.name for p in _lib.CSRC.glob("*.cuh")}
    built = {fam.header for fam in _lib.FAMILIES.values()}
    assert built <= headers
    assert headers - built == {"common.cuh", "tile_scan.cuh", "lookback.cuh"}
    assert "matvec.cuh" in built
    for name in built | {"lookback.cuh"}:
        text = (_lib.CSRC / name).read_text()
        assert "eplaces: src/repro/kernels/" in text
        assert "Bound on this card:" in text


# ---------------------------------------------------------------------------
# The host path: launch plans, the small forms' entries, one dispatch walk
# ---------------------------------------------------------------------------


def test_launch_plan_finds_an_equal_operator_s_unit():
    """A plan is kept per operator identity; a distinct but equal operator
    gets its own plan over the same unit, another operator another unit."""
    x = torch.zeros(4, dtype=torch.int32)
    what = "mapreduce@flat (cuda)"
    plan = _lib.plan("mapreduce", what, t_alg.MAX, x, t_alg.IDENTITY)
    assert _lib.plan("mapreduce", what, t_alg.MAX, x, t_alg.IDENTITY) is plan
    twin = dataclasses.replace(t_alg.MAX)
    assert twin == t_alg.MAX and twin is not t_alg.MAX
    other = _lib.plan("mapreduce", what, twin, x, t_alg.IDENTITY)
    assert other is not plan and other.unit is plan.unit
    low = _lib.plan("mapreduce", what, t_alg.MIN, x, t_alg.IDENTITY)
    assert low is not plan and low.unit.digest != plan.unit.digest
    assert plan.out_dtypes == [torch.int32] and plan.bare_out
    scan = _lib.plan("scan", "scan@batched (cuda)", t_alg.AFFINE,
                     (torch.zeros(2, 3), torch.zeros(2, 3)))
    assert scan.unit is scan_k.scan_unit("x", t_alg.AFFINE,
                                         [torch.zeros(1)] * 2)
    assert not scan.bare_out and scan.lib is None   # nothing built on a CPU


def test_launch_plan_keeps_its_operator_alive():
    """The plan's key holds the operator's id; the plan holds the operator,
    so the id cannot pass to another object."""
    op = dataclasses.replace(t_alg.ADD)
    alive = weakref.ref(op)
    plan = _lib.plan("scan", "scan@batched (cuda)", op,
                     torch.zeros(2, 3, dtype=torch.int32))
    del op
    gc.collect()
    assert alive() is plan.op


@pytest.mark.parametrize("family,op,f,dtypes,signature", [
    ("mapreduce", "MAX", "IDENTITY", [torch.int32],
     "int rt_mapreduce_small(void* x0, void* y0, long n, void* stream)"),
    ("mapreduce", "ADD", "masked", [torch.float32, torch.int32],
     "int rt_mapreduce_small(void* x0, void* x1, void* y0, long n, "),
    ("scan", "ADD", None, [torch.float32],
     "int rt_scan_tile(void* x0, void* y0, long rows, long n, int inclusive"),
    ("scan", "AFFINE", None, [torch.float32] * 2,
     "int rt_scan_tile(void* x0, void* x1, void* y0, void* y1, long rows, "),
])
def test_generated_units_hold_the_small_entries(family, op, f, dtypes,
                                                signature):
    """The small forms' entries take one pointer per leaf as a scalar
    argument; each family's limit is an entry of the unit."""
    op = getattr(t_alg, op)
    likes = tuple(torch.empty(0, dtype=d) for d in dtypes)
    if f is None:
        unit = _lib.unit(family, "x", op, dtypes)
    else:
        f = t_alg.masked_select(0.0) if f == "masked" else t_alg.IDENTITY
        unit = _lib.map_unit(family, "x", f, op,
                             likes if len(likes) > 1 else likes[0])[0]
    fam = _lib.FAMILIES[family]
    assert signature in unit.source
    assert f" {fam.limit}(" in unit.source
    for entry in (*fam.signatures, *fam.leaf_entries):
        assert f" {entry}(" in unit.source
    assert unit.leaves == (len(dtypes), 1 if f is not None else len(dtypes))
    call = "rt::mapreduce::small<Map, Op>(x, n, y" if family == "mapreduce" \
        else "rt::scan::single_tile<Op>(x, y, rows, n"
    assert call in unit.source


DISPATCH_ERRORS = [
    (lambda: t_forge.mapreduce(t_alg.IDENTITY, t_alg.ADD,
                               (torch.zeros(2, 4), torch.zeros(4)),
                               layout=TBatched()),
     ValueError, r"^mapreduce@batched: argument 2 expects rank-2 leaves for "
                 r"the Batched\(\) layout, got shape \(4,\)$"),
    (lambda: t_forge.scan(t_alg.AFFINE, (torch.zeros(2, 4), torch.zeros(4)),
                          layout=TBatched()),
     ValueError, r"^scan@batched: argument 1 expects rank-2 leaves"),
    (lambda: t_forge.scan(t_alg.ADD, torch.zeros(2, 4), axis=1,
                          layout=TBatched(), backend="cuda"),
     ValueError, r"^scan@batched: axis= is pinned by the Batched\(\) layout"),
    (lambda: t_forge.mapreduce(t_alg.IDENTITY, t_alg.AFFINE,
                               (torch.ones(8), torch.ones(8)),
                               backend="cuda"),
     ValueError, r"^mapreduce@flat: requires a commutative operator, got "
                 r"'affine'"),
    (lambda: t_forge.mapreduce(t_alg.IDENTITY, t_alg.ADD, torch.ones(8),
                               layout=TSegmented(
                                   flags=torch.zeros(8, dtype=torch.int32))),
     ValueError, r"^mapreduce@segmented: the flags descriptor needs "
                 r"Segmented\(num_segments=...\)"),
    (lambda: t_forge.scan(t_alg.ADD, torch.zeros(4), backend="tpu"),
     ValueError, r"^scan@flat: unknown backend 'tpu'"),
    (lambda: t_forge.scan(t_alg.ADD, torch.zeros(4), layout="flat"),
     TypeError, r"^layout= must be a Layout descriptor"),
]


@pytest.mark.parametrize("case", range(len(DISPATCH_ERRORS)))
def test_dispatch_raises_each_validation_error(case):
    """The dispatch walks the data's leaves once; every check still sees
    every leaf and raises as before, on bare tensors and pytrees alike."""
    call, kind, pattern = DISPATCH_ERRORS[case]
    with pytest.raises(kind, match=pattern):
        call()


def test_dispatch_guards_and_backend_see_pytree_leaves():
    """The zero-extent guard and the backend choice read the one walk."""
    xs = (torch.zeros(0, 5), torch.zeros(0, 5))
    assert t_forge.scan(t_alg.AFFINE, xs, layout=TBatched()) is xs
    got = t_forge.mapreduce(t_alg.IDENTITY, t_alg.MAX,
                            torch.zeros(3, 0, dtype=torch.int32),
                            layout=TBatched())
    assert torch.equal(got, torch.full((3,), torch.iinfo(torch.int32).min,
                                       dtype=torch.int32))
    v = torch.arange(6.0)
    assert float(t_forge.mapreduce(t_alg.masked_select(0.0), t_alg.ADD,
                                   (v, (v > 2).int()))) == 12.0
    assert t_ki.current_backend((v, v)) == "torch"
    assert t_ki.resolve_impl("scan@flat", data=(v,)) is \
        t_ki.resolve_impl("scan@flat", "torch")


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(-100, 100, (5000,), generator=gen, device=cuda_device,
                      dtype=torch.int32)
    assert torch.equal(scan_k.scan_1d_cuda(t_alg.ADD, x),
                       scan_k.scan_1d_plain(t_alg.ADD, x))
    assert int(mapreduce_k.mapreduce_1d_cuda(t_alg.IDENTITY, t_alg.MAX, x)) \
        == int(x.max())
    # K6 reassociates as the reference does: f32 AFFINE within 1e-5 of
    # max|h| of a float64 walk.
    a = torch.rand(2, 50, 300, generator=gen, device=cuda_device)
    b = torch.randn(2, 50, 300, generator=gen, device=cuda_device)
    want = scan_k.scan_channel_plain(t_alg.AFFINE, (a.double(), b.double()))
    scale = float(want[1].abs().max())
    for got, w in zip(scan_k.scan_channel_cuda(t_alg.AFFINE, (a, b)), want):
        assert float((got.double() - w).abs().max()) <= 1e-5 * scale
    v = b[0, :4, :70].contiguous()
    m = (torch.rand(4, 70, generator=gen, device=cuda_device) > 0.5).int()
    masked = t_alg.masked_select(0.0)
    torch.testing.assert_close(
        batched_k.batched_mapreduce_cuda(masked, t_alg.ADD, (v, m)),
        batched_k.batched_mapreduce_plain(masked, t_alg.ADD, (v, m)),
        rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_k3_small_form_matches_plain_version_on_the_card(cuda_device):
    """K3 on both sides of its small form's limit (one block's 2,048
    elements): int32 MAX bit-exact, f32 masked ADD within 1e-5 of sum |v|;
    the counter says which form ran."""
    k3 = mapreduce_k.mapreduce_1d_cuda
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for n in (1, 4, 2047, 2048, 2049):
        x = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                          device=cuda_device, dtype=torch.int32)
        small = k3.small_launches
        got = k3(t_alg.IDENTITY, t_alg.MAX, x)
        assert (k3.small_launches > small) == (n <= 2048)
        assert got.shape == () and int(got) == int(x.max())
        v = torch.randn(n, generator=gen, device=cuda_device)
        m = (torch.rand(n, generator=gen, device=cuda_device) > 0.5).int()
        masked = t_alg.masked_select(0.0)
        got = k3(masked, t_alg.ADD, (v, m))
        want = mapreduce_k.mapreduce_1d_plain(masked, t_alg.ADD, (v, m))
        assert abs(float(got) - float(want)) <= 1e-5 * float(v.abs().sum())


@pytest.mark.cuda
def test_sampling_kernels_match_plain_versions_on_the_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    digit = torch.randint(0, 256, (50_000,), generator=gen,
                          device=cuda_device)
    onehot = (digit[:, None] == torch.arange(256, device=cuda_device)).int()
    assert torch.equal(matvec_k.matvec_cuda(t_alg.IDENTITY, t_alg.ADD,
                                            onehot, None), onehot.sum(0).int())
    assert torch.equal(matvec_k.vecmat_cuda(t_alg.IDENTITY, t_alg.ADD,
                                            onehot, None), onehot.sum(1).int())
    assert scan_k.uses_long_t(1, 50_000, 256)
    rank = scan_k.scan_channel_cuda(t_alg.ADD, onehot[None], inclusive=False)
    assert torch.equal(rank, (onehot.cumsum(0) - onehot).int()[None])
    probs = torch.softmax(torch.randn(4, 3000, generator=gen,
                                      device=cuda_device), dim=1)
    torch.testing.assert_close(
        batched_k.batched_scan_cuda(t_alg.ADD, probs, inclusive=False),
        batched_k.batched_scan_plain(t_alg.ADD, probs, inclusive=False),
        rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The primitive library's own path: copy, the K5 route, quickstart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int32, jnp.uint8])
def test_k1_copy_matches_pallas(dtype):
    x = jnp.asarray(np.random.default_rng(2).integers(0, 200, 1000), dtype)
    want = j_forge.copy(x, backend=PI)
    xt = _t(x)
    for got in (t_forge.copy(xt), t_forge.copy(xt, nitem=4, backend="cuda"),
                copy_k.copy_cuda(xt), copy_k.copy_plain(xt)):
        assert got.dtype == xt.dtype and got.data_ptr() != xt.data_ptr()
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    empty = torch.zeros(0)
    assert t_forge.copy(empty, backend="cuda") is empty


def test_k5_route_choice_follows_the_reference():
    """p <= 64, n >= 512 and a commutative op take K5 (ops.py:374)."""
    assert matvec_k.uses_packed(512, 64, t_alg.ADD)
    assert matvec_k.uses_packed(10**6, 10, t_alg.MIN)
    assert not matvec_k.uses_packed(512, 65, t_alg.ADD)
    assert not matvec_k.uses_packed(511, 64, t_alg.ADD)
    assert not matvec_k.uses_packed(512, 64, t_alg.AFFINE)


# ---------------------------------------------------------------------------
# The GEMV host plan (kernels/matvec.py): the kind and width of each launch,
# its geometry, the one allocation, the plan and the stream's workspace
# ---------------------------------------------------------------------------

MV = matvec_k
H100_SMS = 132                # the multiprocessors of an H100 SXM


@pytest.mark.parametrize("form,p,wide,aligned,want", [
    (MV.MATVEC, 10**6, True, True, (MV.COLUMNS, 4)),
    (MV.MATVEC, 10**6 + 2, True, True, (MV.COLUMNS, 1)),    # p % 4
    (MV.MATVEC, 4096, True, False, (MV.COLUMNS, 1)),        # misaligned A
    (MV.MATVEC, 4096, False, True, (MV.COLUMNS, 1)),        # f64, wide E
    (MV.VECMAT, 65, True, True, (MV.ROWS, 1)),
    (MV.VECMAT, 1000, True, True, (MV.ROWS, 4)),
    (MV.VECMAT, 64, True, True, (MV.TALL, 4)),
    (MV.VECMAT, 10, True, True, (MV.TALL, 4)),              # stream: any p
    (MV.VECMAT, 10, True, False, (MV.TALL, 1)),
    (MV.PACKED, 10, True, True, (MV.PACKED_STREAM, 4)),
    (MV.PACKED, 33, True, False, (MV.PACKED_STREAM, 1)),
])
def test_gemv_kind_and_load_width(form, p, wide, aligned, want):
    """Which launch a shape takes: a matvec COLUMNS, K5 its flat stream, a
    vecmat TALL up to 64 columns and ROWS above; 16-byte loads where the
    plan allows them and A is 16-byte aligned, with p % 4 == 0 where loads
    start at every row."""
    kind = MV.launch_kind(form, p)
    assert (kind, MV.load_width(kind, p, wide, aligned)) == want


@pytest.mark.parametrize("kind,B,n,p,vec,want", [
    # The short matvec: one row group, one chunk, a thread walks all rows.
    (MV.COLUMNS, 1, 10, 10**6, 4, dict(width=256, chunks=1)),
    (MV.COLUMNS, 1, 1000, 10**4, 4, dict(width=32, chunks=7)),
    (MV.COLUMNS, 1, 10**4, 10**3, 4, dict(width=32, chunks=68)),
    (MV.ROWS, 1, 10**3, 10**4, 4, dict(width=256, chunks=1)),  # block a row
    (MV.ROWS, 1, 10**4, 10**3, 4, dict(width=16, chunks=1)),
    (MV.ROWS, 1, 10, 10**6, 4, dict(width=256, chunks=52)),
    (MV.ROWS, 40, 2048, 256, 4, dict(width=16, chunks=1)),  # short rows
    (MV.TALL, 1, 10**6, 10, 4, dict(width=256, tiles=3907, chunks=1)),
    (MV.TALL, 3, 5, 64, 4, dict(width=64, tiles=1)),
    (MV.PACKED_STREAM, 1, 10**6, 10, 4, dict(width=255, chunks=516)),
    (MV.PACKED_STREAM, 1, 600, 1, 4, dict(width=256, chunks=1)),
])
def test_gemv_geometry_at_the_paper_s_shapes(kind, B, n, p, vec, want):
    """The planned launches of the paper's Table V/VI shapes and the
    model's: few rows take one pass, few outputs chunk the reduction."""
    geo = dict(zip(("kind", "vec", "width", "B", "n", "p", "tiles", "chunks",
                    "per_chunk"), MV.geometry(kind, B, n, p, vec,
                                              sms=H100_SMS)))
    assert {k: geo[k] for k in want} == want


@pytest.mark.parametrize("seed", range(4))
def test_gemv_geometry_covers_the_reduction_within_the_grid(seed):
    """At random shapes every kind's chunks cover the reduction axis once,
    within the grid's limits and the kernels' shared memory."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        B = int(rng.choice([1, 1, 3, 40]))
        n, p = (int(v) for v in 10 ** rng.uniform(0, 6, 2))
        vec = int(rng.choice([1, 4]))
        itemsize = int(rng.choice([1, 4, 8]))
        sms = int(rng.choice([H100_SMS, 114, 1]))
        for kind in (MV.COLUMNS, MV.ROWS, MV.PACKED_STREAM, MV.TALL):
            if kind in (MV.COLUMNS, MV.ROWS) and p % vec or \
                    kind in (MV.PACKED_STREAM, MV.TALL) and p > 64 or \
                    kind == MV.PACKED_STREAM and B > 1:
                continue
            _, v, width, _, _, _, tiles, chunks, per, _ = MV.geometry(
                kind, B, n, p, vec, sms=sms, itemsize=itemsize)
            assert v == vec and 1 <= width <= MV.THREADS and tiles >= 1
            assert 1 <= chunks <= MV.MAX_GRID_Y
            if kind == MV.COLUMNS:
                assert width & (width - 1) == 0
                assert tiles * width * vec >= p
                assert (chunks - 1) * per < n <= chunks * per
                assert chunks == 1 or width * vec <= MV.THREADS
            elif kind == MV.ROWS:
                assert width & (width - 1) == 0 and per % (width * vec) == 0
                assert tiles * (MV.THREADS // width) >= n
                assert (chunks - 1) * per < p <= chunks * per
            elif kind == MV.PACKED_STREAM:
                S = width * vec
                assert S % p == 0 and S % vec == 0 and per % S == 0
                assert (chunks - 1) * per < n * p <= chunks * per
            else:
                assert width % 4 == 0 and chunks == 1
                assert width * p * itemsize <= MV.TALL_BYTES
                assert tiles * width >= B * n


def test_gemv_outputs_share_one_allocation():
    """A call allocates its outputs once: one tensor for one leaf; views of
    one byte buffer, each leaf at a 16-byte boundary, for several."""
    like = torch.zeros(3)
    (one,) = _lib.outputs(like, [torch.int32], (5,))
    assert one.shape == (5,) and one.dtype == torch.int32
    outs = _lib.outputs(like, [torch.float32, torch.int8, torch.float64], (7,))
    assert [o.dtype for o in outs] == [torch.float32, torch.int8,
                                       torch.float64]
    assert all(o.shape == (7,) and o.is_contiguous() for o in outs)
    base = outs[0].untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() == base for o in outs)
    assert all((o.data_ptr() - base) % 16 == 0 for o in outs)
    ends = sorted((o.data_ptr(), o.data_ptr() + o.nbytes) for o in outs)
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))   # disjoint
    assert _lib.element_bytes([torch.float32]) == 4
    assert _lib.element_bytes([torch.float64, torch.int32]) == 16
    assert _lib.element_bytes([torch.int8, torch.float32, torch.int8]) == 12


def test_gemv_plan_is_reused_across_calls_and_not_across_dtypes():
    """A GEMV's plan is ``_lib.plan``'s, kept per (family, operator, map,
    the dtype of each of the map's arguments, quantization mode): the same
    call finds it again; another dtype, arity or mode gets its own."""
    what = "matvec@flat (cuda)"
    f32 = torch.zeros(4, 4)

    def gemv(f, op, likes, quant=None, family="matvec"):
        return _lib.plan(family, what, op, likes, f, spread=True, quant=quant)

    plan = gemv(t_alg.TIMES, t_alg.ADD, (f32, f32))
    assert gemv(t_alg.TIMES, t_alg.ADD, (f32, f32)) is plan
    assert plan.out_dtypes == [torch.float32] and plan.lib is None
    f64 = f32.double()
    other = gemv(t_alg.TIMES, t_alg.ADD, (f64, f64))
    assert other is not plan and other.unit.digest != plan.unit.digest
    assert other.out_dtypes == [torch.float64]
    ints = torch.zeros(4, 4, dtype=torch.int32)
    axis = gemv(t_alg.IDENTITY, t_alg.ADD, (ints,))
    assert axis is not plan and axis.unit.leaves == (1, 1)
    pair = gemv(PAIR, t_alg.AFFINE, (f32, f32))
    assert pair.out_dtypes == [torch.float32] * 2
    assert "int rt_gemv(void* x0, void* x1, void* y0, void* y1, " \
        "const void* geo" in pair.unit.source
    int8 = gemv(t_alg.TIMES, t_alg.ADD, (f32, f32), "int8", "qmatvec")
    assert int8 is not plan and gemv(t_alg.TIMES, t_alg.ADD, (f32, f32),
                                     "int8", "qmatvec") is int8
    assert gemv(t_alg.TIMES, t_alg.ADD, (f32, f32), "fp8_e4m3",
                "qmatvec") is not int8


def test_gemv_call_checks_the_vector_before_keeping_anything():
    """A call whose vector has the wrong dtype or length raises before a
    launch or a plan is kept, so it leaves nothing behind for the calls
    after it: the next valid call's plan reads vector and matrix of its own
    dtype."""
    what = "matvec@flat (cuda)"
    A = torch.zeros(6, 5)
    calls, plans = dict(MV._CALLS), dict(_lib._PLANS)
    for x in (torch.zeros(6, dtype=torch.float64), torch.zeros(5)):
        with pytest.raises(ValueError, match="x must be a vector of A's "
                                             "dtype along the reduced axis"):
            MV.resolve(MV.MATVEC, what, t_alg.TIMES, t_alg.ADD, A, x)
    with pytest.raises(ValueError, match="x must be a vector of float32"):
        MV.resolve(MV.VECMAT, what, t_alg.TIMES, t_alg.ADD,
                   t_alg.quantize(torch.ones(8, 4), block=4),
                   torch.zeros(4, dtype=torch.float64))
    assert MV._CALLS == calls and _lib._PLANS == plans
    # A valid call on CPU tensors is refused too, before anything is kept.
    with pytest.raises(ValueError, match="one CUDA device"):
        MV.resolve(MV.MATVEC, what, t_alg.TIMES, t_alg.ADD, A, torch.zeros(6))
    assert MV._CALLS == calls and _lib._PLANS == plans
    plan = _lib.plan("matvec", what, t_alg.ADD, (torch.zeros(6), A),
                     t_alg.TIMES, spread=True)
    assert plan.unit is _lib.unit("matvec", what, t_alg.ADD, [torch.float32],
                                  f=t_alg.TIMES,
                                  in_dtypes=[torch.float32] * 2)


def test_gemv_workspace_is_kept_per_stream_and_grows():
    """A stream's workspace -- the counters (zeroed once) and partials of
    a chunked GEMV, and K2's lookback flags -- is the stream's own: found
    again, grown when a launch needs more, never shared with another
    stream.  The flags carry an epoch a launch: zero is unset under every
    epoch, and when the epoch wraps the flags are zeroed anew."""
    like = torch.zeros(1)
    _lib._WORKSPACES.clear()
    w = _lib.workspace(like, 7, 10, 100)
    assert int(w.counters.count_nonzero()) == 0 and w.flags is None
    assert w.counters.numel() >= 10 and w.partials.numel() >= 100
    counters, partials = w.counters, w.partials
    assert _lib.workspace(like, 7, 5, 50) is w and w.counters is counters \
        and w.partials is partials
    grown = _lib.workspace(like, 7, 5000, 5 << 20)
    assert grown is w and w.counters.numel() >= 5000 and \
        w.partials.numel() >= 5 << 20
    assert _lib.workspace(like, 8, 10, 100) is not w
    # K2's lookback asks the same workspace for its flags.
    assert _lib.workspace(like, 7, 1, 64, 3000) is w
    assert w.flags.numel() >= 3000 and int(w.flags.count_nonzero()) == 0
    assert [w.next_epoch() for _ in range(3)] == [1, 2, 3]
    w.flags.fill_(5)
    w.epoch = _lib.EPOCH_MAX
    assert w.next_epoch() == 1 and int(w.flags.count_nonzero()) == 0
    _lib._WORKSPACES.clear()


# ---------------------------------------------------------------------------
# K2's and K6's host path, driven on the CPU: tensors that say they are on
# the card, and a stand-in library that records each entry it is called at
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return t.as_subclass(_OnCard)


class _Entries:
    """A loaded unit's stand-in: the limits the wrappers ask, and a record
    of every launch entry called, by name and arguments."""

    def __init__(self):
        self.calls, self.loaded = [], []

    def rt_tile(self):
        return 2048

    def rt_scan_channel_chunk(self):
        return 64

    def rt_mapreduce_small_max(self):
        return 2048

    def __getattr__(self, name):
        if not name.startswith("rt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def card_entries(monkeypatch):
    lib = _Entries()
    monkeypatch.setattr(_lib, "load", lambda u: lib.loaded.append(u) or lib)
    monkeypatch.setattr(_lib, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(_lib, "_PLANS", {})
    monkeypatch.setattr(_lib, "_WORKSPACES", {})
    for w, attr in ((scan_k.scan_1d_cuda, "launches"),
                    (scan_k.scan_channel_cuda, "launches"),
                    (scan_k.scan_channel_cuda, "long_t_launches")):
        monkeypatch.setattr(w, attr, 0)
    return lib


def test_k2_plan_is_reused_across_calls_and_not_across_dtypes(card_entries):
    """K2 keeps one plan per (operator, leaf dtypes): a second call loads
    nothing and looks nothing up, another dtype gets its own.  Every call is
    one entry call: the single tile up to the plan's limit, the lookback
    above it, with its ticket, flags and values in the stream's workspace
    (the GEMVs' too) and a new epoch each launch."""
    lib = card_entries
    x = _on_card(torch.arange(2048, dtype=torch.int32))
    for _ in range(2):
        scan_k.scan_1d_cuda(t_alg.ADD, x)
    (plan,) = _lib._PLANS.values()
    assert plan.limit == 2048 and len(lib.loaded) == 1
    scan_k.scan_1d_cuda(t_alg.ADD, x.float())
    assert len(_lib._PLANS) == 2 and len(lib.loaded) == 2
    big = _on_card(torch.arange(10**6 + 3, dtype=torch.int32))
    for _ in range(2):
        scan_k.scan_1d_cuda(t_alg.ADD, big, inclusive=False)
    assert [c[0] for c in lib.calls] == ["rt_scan_tile"] * 3 + \
        ["rt_scan_lookback"] * 2
    assert scan_k.scan_1d_cuda.launches == 5 and len(lib.loaded) == 2
    w = _lib.workspace(big, 7, 1, 0)
    for epoch, (_, args) in enumerate(lib.calls[3:], 1):
        assert args[2:] == (10**6 + 3, 0, w.counters.data_ptr(),
                            w.flags.data_ptr(), w.partials.data_ptr(), epoch,
                            7)
    tiles = -(-(10**6 + 3) // 2048)
    assert w.flags.numel() >= 2 * tiles and w.partials.numel() >= 2 * 4 * tiles


def test_k2_call_with_mismatched_leaves_raises_before_anything_is_kept(
        card_entries):
    """A call whose leaves do not share one non-empty (n,) shape raises
    before a plan, a workspace, an epoch or a launch is kept; a valid call
    afterwards runs as if it were the first."""
    lib = card_entries
    a = _on_card(torch.ones(5000))
    for b in (_on_card(torch.ones(4999)), _on_card(torch.ones(5000, 1)),
              _on_card(torch.ones(0))):
        with pytest.raises(ValueError, match="one non-empty rank-1 shape"):
            scan_k.scan_1d_cuda(t_alg.AFFINE, (a, b) if b.numel() else b)
    assert _lib._PLANS == {} and _lib._WORKSPACES == {} and lib.calls == []
    assert scan_k.scan_1d_cuda.launches == 0
    ga, gb = scan_k.scan_1d_cuda(t_alg.AFFINE, (a, _on_card(torch.ones(5000))))
    assert ga.shape == gb.shape == (5000,) and ga.dtype == torch.float32
    (name, args), = lib.calls
    assert name == "rt_scan_lookback" and args[-2] == 1


@pytest.mark.parametrize("shape,long_t", [
    ((1, 17, 2560), False), ((1, 1024, 2560), False), ((1, 2100, 2560), False),
    ((8, 2048, 2560), False), ((2, 61, 130), False),
    ((1, 5_000, 256), True), ((1, 5_000, 4), True)])
def test_k6_route_at_the_recurrence_s_and_the_sort_s_shapes(card_entries,
                                                            shape, long_t):
    """The RG-LRU's scans take the channel-tile route (no scratch, counted
    in ``launches``); the radix sort's rank scans the long-T path (scratch
    of B C cdiv(T, 64) elements, counted apart)."""
    x = _on_card(torch.zeros(shape, dtype=torch.int32))
    scan_k.scan_channel_cuda(t_alg.ADD, x, inclusive=False)
    (name, args), = card_entries.calls
    B, T, C = shape
    assert name == "rt_scan_channel" and args[2:7] == (B, T, C, 0, 0)
    assert (args[7] is not None) == long_t
    k6 = scan_k.scan_channel_cuda
    assert (k6.launches, k6.long_t_launches) == ((0, 1) if long_t else (1, 0))


@pytest.mark.parametrize("with_h0", [False, True])
def test_k6_linear_recurrence_writes_the_a_leaf_only_when_h0_reads_it(
        card_entries, with_h0):
    """linear_recurrence on the card without h0 reads only the B leaf of
    K6's AFFINE scan, so the A leaf's output pointer is null (the element's
    store skips it) and no A tensor is allocated; with h0 both are
    written.  The plain version drops the same leaf and keeps B's values."""
    a = _on_card(torch.full((1, 33, 4096), 0.5))
    b = _on_card(torch.ones(1, 33, 4096))
    h0 = _on_card(torch.zeros(1, 4096)) if with_h0 else None
    h = t_forge.linear_recurrence(a, b, h0, layout=TBatched(),
                                  backend="cuda")
    (name, args), = card_entries.calls
    assert name == "rt_scan_channel" and args[4:9] == (1, 33, 4096, 1, 0)
    assert args[:2] == (a.data_ptr(), b.data_ptr())
    assert (args[2] is not None) == with_h0 and args[3] is not None
    assert h.shape == (1, 33, 4096)
    full = scan_k.scan_channel_plain(t_alg.AFFINE, (a[:, :5, :7],
                                                    b[:, :5, :7]))
    dropped = scan_k.scan_channel_plain(t_alg.AFFINE, (a[:, :5, :7],
                                                       b[:, :5, :7]),
                                        keep=(False, True))
    assert dropped[0] is None
    torch.testing.assert_close(dropped[1], full[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="one flag per leaf"):
        scan_k.scan_channel_cuda(t_alg.AFFINE, (a, b), keep=(False, False))


# ---------------------------------------------------------------------------
# K9's host plan: the STRIPS and quantized COLUMNS launches, and the load
# width of a quantized operand, aligned or not
# ---------------------------------------------------------------------------


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("p,codes,scales,want", [
    (256000, 0, 0, 16), (4096, 0, 0, 16), (16, 0, 0, 16),
    (256000, 4, 0, 4), (256000, 8, 0, 4), (4100, 0, 0, 4), (8, 0, 0, 4),
    (256000, 1, 0, 1), (256000, 15, 0, 1), (256000, 0, 4, 1),
    (256000, 4, 4, 1), (31, 0, 0, 1), (1, 0, 0, 1)])
def test_quantized_kind_and_load_width(p, codes, scales, want):
    """A quantized matvec takes COLUMNS and a vecmat STRIPS (never ROWS);
    16 codes a load where codes and scales are 16-byte aligned and p % 16
    == 0, 4 where the codes are 4-byte and the scales 16-byte aligned and
    p % 4 == 0, else one: a misaligned operand takes a narrower load."""
    assert MV.launch_kind(MV.MATVEC, p, quantized=True) == MV.COLUMNS
    assert MV.launch_kind(MV.VECMAT, p, quantized=True) == MV.STRIPS
    assert MV.quant_width(p, 4096 + codes, 8192 + scales) == want


def _strips_cover(geo, block):
    """Every (batch, row, column) of a STRIPS launch falls in exactly one
    block's strip and one warp's run; no strip leaves its quantization
    block (a block's batch is blockIdx.x // tiles, so no block spans two
    batches); the grid fits."""
    kind, vec, width, B, n, p, tiles, chunks, per, stream = geo
    assert stream == 0
    assert kind == MV.STRIPS and 1 <= width <= MV.STRIP_MAX
    spq = _cdiv(min(block, n), width)
    assert tiles == _cdiv(n, block) * spq and B * tiles < 2**31
    rows = []
    for tile in range(tiles):
        k, s = divmod(tile, spq)
        r0 = k * block + s * width
        r1 = min(r0 + width, (k + 1) * block, n)
        if r0 < r1:
            assert r0 // block == (r1 - 1) // block
            rows.append((r0, r1))
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert 1 <= chunks <= MV.MAX_GRID_Y and per % (32 * vec) == 0
    runs = []
    for c in range(chunks):
        c0, c1 = c * per, min(c * per + per, p)
        assert c0 < c1
        step = _cdiv(_cdiv(c1 - c0, 32 * vec), MV.WARPS) * 32 * vec
        runs += [(c0 + w * step, min(c0 + (w + 1) * step, c1))
                 for w in range(MV.WARPS) if c0 + w * step < c1]
    assert runs[0][0] == 0 and runs[-1][1] == p
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))


@pytest.mark.parametrize("B,n,p,block,want", [
    (1, 2560, 256000, 64, dict(width=64, tiles=40, chunks=13)),  # unembed
    (8, 4096, 4096, 64, dict(width=64, tiles=64, chunks=1)),
    (1, 64, 100000, 64, dict(width=64, tiles=1, chunks=25)),
    (3, 65, 31, 16, dict(width=16, tiles=5, chunks=1)),
    (1, 300, 160, 512, dict(width=128, tiles=3, chunks=1)),
])
def test_strips_geometry_at_the_model_s_shapes(B, n, p, block, want):
    """K9's vecmat: a strip of one quantization block's rows a block, 16
    codes a load; the unembed's columns cut into chunks of whole warp steps
    until the grid fills the card."""
    vec = MV.quant_width(p, 0, 0)
    geo = MV.geometry(MV.STRIPS, B, n, p, vec, sms=H100_SMS, block=block)
    got = dict(zip(("kind", "vec", "width", "B", "n", "p", "tiles",
                    "chunks", "per_chunk"), geo))
    assert {k: got[k] for k in want} == want
    _strips_cover(geo, block)
    # Each block loads the scales of its chunk's columns once (one lane a
    # column segment a step): B tiles p floats in all, which is B nb p --
    # 41 MB at the unembed, not the B n p of a scale read per row.
    nb = _cdiv(n, block)
    scale_bytes = 4 * B * got["tiles"] * p
    assert scale_bytes == 4 * B * nb * p * _cdiv(min(block, n), got["width"])
    if block <= MV.STRIP_MAX:
        assert scale_bytes == 4 * B * nb * p


@pytest.mark.parametrize("B,n,p,want", [
    (1, 2560, 256000, dict(width=32, tiles=500, chunks=1)),
    (8, 4096, 4096, dict(width=16, tiles=16, chunks=2, per_chunk=2048)),
])
def test_quantized_columns_geometry_at_the_model_s_shapes(B, n, p, want):
    """K9's matvec: 16 codes a thread a row, about half the dense form's
    threads, and a row group's run starting at a quantization block."""
    geo = dict(zip(("kind", "vec", "width", "B", "n", "p", "tiles",
                    "chunks", "per_chunk"),
                   MV.geometry(MV.COLUMNS, B, n, p, 16, sms=H100_SMS,
                               block=64)))
    assert {k: geo[k] for k in want} == want


@pytest.mark.parametrize("seed", range(2))
def test_quantized_geometry_covers_the_matrix_within_the_grid(seed):
    """At random shapes, blocks and load widths: STRIPS covers every
    (batch, row, column) once inside one quantization block, and COLUMNS
    every column and row once, each row group's run starting at a
    quantization block where the rows are chunked."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        B = int(rng.choice([1, 2, 3, 8]))
        n, p = (int(v) for v in 10 ** rng.uniform(0, 5, 2))
        block = int(rng.choice([1, 16, 32, 64, 100, 128, 4096]))
        sms = int(rng.choice([H100_SMS, 114, 1]))
        vec = int(rng.choice([w for w in (1, 4, 16) if p % w == 0]))
        _strips_cover(MV.geometry(MV.STRIPS, B, n, p, vec, sms=sms,
                                  block=block), block)
        _, v, width, _, _, _, tiles, chunks, per, _ = MV.geometry(
            MV.COLUMNS, B, n, p, vec, sms=sms, block=block)
        groups = MV.THREADS // width
        assert width & (width - 1) == 0 and tiles * width * vec >= p
        assert 1 <= chunks <= MV.MAX_GRID_Y
        assert (chunks - 1) * per < n <= chunks * per
        assert chunks == 1 or per % (groups * block) == 0


@pytest.mark.parametrize("form", ["matvec", "vecmat"])
@pytest.mark.parametrize("codes,scales,vec", [(0, 0, 16), (1, 0, 1),
                                              (4, 0, 4), (15, 0, 1),
                                              (0, 1, 1)])
def test_misaligned_quantized_operand_takes_a_narrower_load_not_a_copy(
        card_entries, monkeypatch, form, codes, scales, vec):
    """A quantized operand whose codes lie 1-15 bytes or whose scales lie 4
    bytes off their alignment reaches the kernel as it is -- its own codes
    and scales pointers, no copy -- with the narrower load width its
    alignment allows, counted under its kind and width."""
    monkeypatch.setattr(MV, "sms", lambda device: H100_SMS)
    monkeypatch.setattr(MV, "_CALLS", {})
    monkeypatch.setattr(MV, "form_launches", {})
    n, p, block = 100, 64, 32
    q = t_alg.quantize(torch.randn(n, p, generator=torch.Generator()
                                   .manual_seed(codes)), block=block)
    vbuf = torch.zeros(n * p + 16, dtype=torch.int8)
    sbuf = torch.zeros(q.scales.numel() + 4)
    values = vbuf[codes:codes + n * p].view(n, p)
    scales_ = sbuf[scales:scales + q.scales.numel()].view(q.scales.shape)
    values.copy_(q.values)
    scales_.copy_(q.scales)
    assert vbuf.data_ptr() % 16 == 0 and sbuf.data_ptr() % 16 == 0
    op = t_alg.Quantized(_on_card(values), _on_card(scales_), block, "int8")
    x = _on_card(torch.ones(n if form == "matvec" else p))
    wrapper = MV.matvec_quantized_cuda if form == "matvec" else \
        MV.vecmat_quantized_cuda
    before = wrapper.launches
    wrapper(t_alg.TIMES, t_alg.ADD, op, x)
    (name, args), = card_entries.calls
    assert name == "rt_qmatvec" and wrapper.launches == before + 1
    assert args[1] == values.data_ptr() and args[2] == scales_.data_ptr()
    geo = tuple((ctypes.c_long * 10).from_address(args[0]))
    kind = "columns" if form == "matvec" else "strips"
    assert geo[:2] == ((MV.COLUMNS if form == "matvec" else MV.STRIPS), vec)
    assert MV.form_launches == {f"{kind}/{vec}": 1}


@pytest.mark.parametrize("form,n,stream", [
    ("vecmat", 100, 0), ("vecmat", 300, 1), ("matvec", 300, 0)])
def test_gemv_loads_of_a_matrix_larger_than_l2_evict_first(
        card_entries, monkeypatch, form, n, stream):
    """A dense vecmat's matrix larger than L2 (here a 1 MB one) is read
    from memory on every call, so its 16-byte ROWS loads evict first (the
    geometry's tenth long); a smaller one stays for the next call, and a
    matvec's COLUMNS loads never evict first.  The entry reads the ten
    longs the host planned."""
    monkeypatch.setattr(MV, "sms", lambda device: H100_SMS)
    monkeypatch.setattr(MV, "_CALLS", {})
    monkeypatch.setitem(MV._L2, -1, 1 << 20)
    A = _on_card(torch.zeros(n, 1000))
    if form == "matvec":
        MV.matvec_cuda(t_alg.TIMES, t_alg.ADD, A, _on_card(torch.zeros(n)))
    else:
        MV.vecmat_cuda(t_alg.TIMES, t_alg.ADD, A, _on_card(torch.zeros(1000)))
    (name, args), = card_entries.calls
    geo = tuple((ctypes.c_long * 10).from_address(args[3]))
    kind = MV.COLUMNS if form == "matvec" else MV.ROWS
    assert name == "rt_gemv" and geo[9] == stream
    assert geo == MV.geometry(kind, 1, n, 1000, 4, sms=H100_SMS,
                              stream=bool(stream))


# ---------------------------------------------------------------------------
# K7m's host plan: the launch kind, the load width by alignment, the chunks
# ---------------------------------------------------------------------------

BK = batched_k


@pytest.mark.parametrize("B,n,vec,sms,want", [
    # The served scores: a block a row, too short to cut.
    (4, 4096, 4, H100_SMS, (BK.BLOCK, 256, 1)),
    (64, 16384, 4, H100_SMS, (BK.BLOCK, 256, 1)),      # the reference bench
    (64, 1 << 16, 4, H100_SMS, (BK.BLOCK, 256, 1)),    # two chunks: too few
    (64, 1 << 17, 4, H100_SMS, (BK.SPLIT, 256, 4)),
    (8, 1 << 20, 4, H100_SMS, (BK.SPLIT, 256, 32)),    # 32 loads a thread
    (8, 1 << 24, 4, H100_SMS, (BK.SPLIT, 256, 66)),    # few long rows
    (1 << 18, 256, 4, H100_SMS, (BK.LANES, 16, 1)),    # many short rows
    (4096, 65536, 4, H100_SMS, (BK.BLOCK, 256, 1)),    # B fills the card
    (16384, 16384, 16, H100_SMS, (BK.BLOCK, 256, 1)),  # UnitFloat8 codes
    (200, 24576, 4, H100_SMS, (BK.BLOCK, 256, 1)),     # rows too short
    (2, 4 * (5 * 8192 + 3), 4, H100_SMS, (BK.SPLIT, 256, 5)),
    (8, 1 << 24, 4, 114, (BK.SPLIT, 256, 57)),         # another card
    (8, 64, 4, H100_SMS, (BK.LANES, 4, 1)),
    (1, 1, 1, H100_SMS, (BK.LANES, 4, 1)),
    (3, 257, 1, H100_SMS, (BK.LANES, 32, 1)),
    (5, 512, 1, H100_SMS, (BK.LANES, 32, 1)),
    (5, 513, 1, H100_SMS, (BK.BLOCK, 256, 1)),
])
def test_k7m_launch_kind_and_chunks(B, n, vec, sms, want):
    """Which launch a (B, n) takes: LANES for rows of at most 512 loads
    (4-32 lanes, four loads a lane or more), a block a row above, its rows
    cut into chunks while the grid has fewer than four blocks a
    multiprocessor and each thread keeps 32 loads of its chunk -- into four
    chunks or more, or none."""
    kind, v, lanes, gB, gn, chunks, per = BK.rows_geometry(B, n, vec, sms=sms)
    assert (kind, lanes, chunks) == want and (v, gB, gn) == (vec, B, n)
    assert (chunks - 1) * per < n // vec <= chunks * per


@pytest.mark.parametrize("n,leaf_bytes,offsets,want", [
    (4096, [4, 4], [0, 0], 4),          # the served pair: 16-byte loads
    (4096, [4, 4], [4, 0], 1),          # values 4 bytes off: one a load
    (4096, [4, 4], [0, 8], 2),          # the mask 8 bytes off
    (4098, [4], [0], 2),                # n % 4 == 2
    (257, [4], [0], 1),                 # odd n
    (1, [4], [0], 1),
    (16384, [1], [0], 16),              # UnitFloat8: 16 codes a load
    (16384, [1], [4], 4),
    (16388, [1], [0], 4),
    (4096, [8], [0], 2),                # f64: two a load
    (4096, [4, 1], [0, 4], 4),          # f32 beside 1-byte flags
])
def test_k7m_load_width_by_alignment(n, leaf_bytes, offsets, want):
    """Elements a load: 16 bytes of the widest leaf where n and every
    leaf's alignment allow it, else the widest narrower load that fits --
    a misaligned or odd-length leaf is read as it lies, never copied."""
    assert BK.rows_width(n, leaf_bytes, [4096 + o for o in offsets]) == want


@pytest.mark.parametrize("seed", range(2))
def test_k7m_geometry_covers_each_row_within_the_grid(seed):
    """At random shapes every kind covers each row's loads once, in
    chunks within the grid's limits, and only a row cut in two or more
    chunks is SPLIT."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        B = int(10 ** rng.uniform(0, 6))
        vec = int(rng.choice([1, 2, 4, 16]))
        n = vec * max(1, int(10 ** rng.uniform(0, 7)) // vec)
        sms = int(rng.choice([H100_SMS, 114, 1]))
        kind, _, lanes, _, _, chunks, per = BK.rows_geometry(B, n, vec,
                                                             sms=sms)
        loads = n // vec
        assert (chunks - 1) * per < loads <= chunks * per
        assert 1 <= chunks <= MV.MAX_GRID_Y
        if kind == BK.LANES:
            assert loads <= BK.LANES_ROW_MAX and chunks == 1
            assert lanes in (4, 8, 16, 32)
        else:
            assert lanes == BK.ROWS_THREADS and loads > BK.LANES_ROW_MAX
            assert (kind == BK.SPLIT) == (chunks > 1)
            assert chunks == 1 or per >= BK.ROWS_THREADS * BK.SPLIT_LOADS
            assert chunks == 1 or chunks >= BK.SPLIT_MIN


@pytest.fixture
def k7m_calls(card_entries, monkeypatch):
    monkeypatch.setattr(MV, "sms", lambda device: H100_SMS)
    monkeypatch.setattr(BK, "_ROWS_CALLS", {})
    monkeypatch.setattr(BK, "form_launches", {})
    monkeypatch.setattr(BK.batched_mapreduce_cuda, "launches", 0)
    return card_entries


def _geo(address):
    return tuple((ctypes.c_long * 7).from_address(address))


def test_k7m_served_call_is_one_entry_through_a_plan(k7m_calls):
    """The engine's (4, 4096) masked scores: one entry call, its leaves'
    and output's pointers as scalars, the plan and launch found again on
    the second call (one library loaded, one launch kept), no workspace."""
    lib = k7m_calls
    v = _on_card(torch.zeros(4, 4096))
    m = _on_card(torch.ones(4, 4096, dtype=torch.int32))
    masked = t_alg.masked_select(0.0)
    outs = [BK.batched_mapreduce_cuda(masked, t_alg.ADD, (v, m))
            for _ in range(2)]
    assert [c[0] for c in lib.calls] == ["rt_mapreduce_rows"] * 2
    assert len(lib.loaded) == 1 and len(BK._ROWS_CALLS) == 1
    for (_, args), out in zip(lib.calls, outs):
        assert out.shape == (4,) and out.dtype == torch.float32
        assert args[:3] == (v.data_ptr(), m.data_ptr(), out.data_ptr())
        assert _geo(args[3]) == BK.rows_geometry(4, 4096, 4, sms=H100_SMS)
        assert args[4:] == (None, None, 7)
    assert BK.form_launches == {"block/4": 2}
    assert BK.batched_mapreduce_cuda.launches == 2 and _lib._WORKSPACES == {}


def test_k7m_split_call_takes_the_stream_s_workspace(k7m_calls):
    """A SPLIT launch gets a zero counter a row and B chunks partials of
    the output element from the stream's workspace."""
    lib = k7m_calls
    x = _on_card(torch.zeros(2, 1 << 18, dtype=torch.int32))
    BK.batched_mapreduce_cuda(t_alg.IDENTITY, t_alg.ADD, x)
    (name, args), = lib.calls
    geo = _geo(args[2])
    assert geo[0] == BK.SPLIT and geo[5] == 8
    w = _lib.workspace(x, 7, 1, 0)
    assert args[3:] == (w.counters.data_ptr(), w.partials.data_ptr(), 7)
    assert int(w.counters[:2].count_nonzero()) == 0
    assert w.partials.numel() >= 2 * 8 * 4
    assert BK.form_launches == {"split/4": 1}


@pytest.mark.parametrize("offset,vec", [(0, 4), (1, 1), (2, 2), (3, 1)])
def test_k7m_misaligned_leaf_takes_a_narrower_load_not_a_copy(
        k7m_calls, offset, vec):
    """A leaf 4, 8 or 12 bytes past its 16-byte boundary reaches the kernel
    as it lies -- its own pointer, no copy -- with the narrower load its
    alignment allows, counted under its kind and width."""
    buf = torch.zeros(3 * 4096 + 4)
    assert buf.data_ptr() % 16 == 0
    x = _on_card(buf[offset:offset + 3 * 4096].view(3, 4096))
    BK.batched_mapreduce_cuda(t_alg.IDENTITY, t_alg.MAX, x)
    (name, args), = k7m_calls.calls
    geo = _geo(args[2])
    assert args[0] == x.data_ptr() and geo[1] == vec
    assert geo == BK.rows_geometry(3, 4096, vec, sms=H100_SMS)
    assert BK.form_launches == {f"{BK.ROWS_KIND_NAMES[geo[0]]}/{vec}": 1}


PAIR = t_alg.DeviceMap("pair", lambda u, v: (u, v), "return x;")


@pytest.mark.parametrize("n,p", [(511, 64), (512, 64), (512, 65), (700, 10)])
def test_k5_and_k4_matvec_match_pallas(n, p):
    """Both sides of the route choice, bit-exact over int32 ADD, and a
    non-commutative fold (AFFINE over (x_i, A_ij) pairs) that must keep
    row order on K4."""
    rng = np.random.default_rng(n + p)
    A = jnp.asarray(rng.integers(-9, 10, (n, p)), jnp.int32)
    xv = jnp.asarray(rng.integers(-9, 10, (n,)), jnp.int32)
    # Both reference routes jitted, compiled once rather than op by op:
    # int32 terms round nothing, and AFFINE is held within a tolerance.
    want = jax.jit(lambda a, v: j_forge.matvec(
        lambda x, e: x * e, j_alg.ADD, a, v, backend=PI))(A, xv)
    for got in (t_forge.matvec(t_alg.TIMES, t_alg.ADD, _t(A), _t(xv),
                               backend="cuda"),
                matvec_k.matvec_packed_cuda(t_alg.TIMES, t_alg.ADD, _t(A),
                                            _t(xv))):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    Af = jnp.asarray(rng.uniform(0.9, 1.1, (n, p)), jnp.float32)
    xf = jnp.asarray(rng.uniform(-0.1, 0.1, (n,)), jnp.float32)
    wa, wb = jax.jit(lambda a, v: j_forge.matvec(
        lambda x, e: (x, e), j_alg.AFFINE, a, v, backend="xla"))(Af, xf)
    for backend in ("torch", "cuda"):
        ga, gb = t_forge.matvec(PAIR, t_alg.AFFINE, _t(Af), _t(xf),
                                backend=backend)
        np.testing.assert_allclose(_np(ga), np.asarray(wa), rtol=1e-4)
        np.testing.assert_allclose(_np(gb), np.asarray(wb), rtol=1e-4,
                                   atol=1e-4)


def _quickstart(forge, alg, Segmented, Batched, arr, masked, backend):
    """examples/quickstart.py sections 1-8 on numpy inputs, through either
    package (``arr`` makes the package's array from numpy; ``masked`` is the
    package's masked-select map)."""
    rng = np.random.default_rng(0)
    out = {}
    x = arr(rng.normal(size=1000).astype(np.float32))
    out["1 scan add"] = forge.scan(alg.ADD, x, backend=backend)
    out["1 scan max excl"] = forge.scan(alg.MAX, x, inclusive=False,
                                        backend=backend)
    q = tuple(arr((rng.normal(size=256) * 0.1 + (1.0 if i == 0 else 0.0))
                  .astype(np.float32)) for i in range(4))
    out["2 quaternion scan"] = forge.scan(alg.QUATERNION_MUL, q,
                                          backend=backend)
    u8 = arr(rng.integers(0, 256, 100_000).astype(np.uint8))
    out["3 unitfloat8 sum"] = forge.mapreduce(alg.unitfloat8_decode, alg.ADD,
                                              u8, backend=backend)
    W = np.where(rng.uniform(size=(64, 64)) < 0.2,
                 rng.uniform(0, 10, (64, 64)), np.inf).astype(np.float32)
    W[np.arange(64), np.arange(64)] = 0.0
    dist = np.full(64, np.inf, np.float32)
    dist[0] = 0.0
    dist = arr(dist)
    for _ in range(4):
        dist = forge.semiring_matvec(alg.TROPICAL_MIN_PLUS, arr(W), dist,
                                     backend=backend)
    out["4 tropical"] = dist
    logits = rng.normal(size=(32, 32)).astype(np.float32)
    logA = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    lp = rng.normal(size=32).astype(np.float32)
    logp = lp - np.log(np.exp(lp).sum())
    out["5 log vecmat"] = forge.semiring_vecmat(alg.LOG_SEMIRING, arr(logA),
                                                arr(logp), backend=backend)
    vals = arr(np.arange(10, dtype=np.float32))
    offs = arr(np.asarray([0, 3, 8, 10], np.int32))
    out["6 segmented scan"] = forge.scan(
        alg.ADD, vals, layout=Segmented(offsets=offs), backend=backend)
    out["6 segmented sums"] = forge.mapreduce(
        lambda v: v, alg.ADD, vals, layout=Segmented(offsets=offs),
        backend=backend)
    a = arr(rng.uniform(0.9, 0.99, (2, 128, 256)).astype(np.float32))
    b = arr(rng.normal(size=(2, 128, 256)).astype(np.float32))
    out["7 linear recurrence"] = forge.linear_recurrence(a, b,
                                                         backend=backend)
    pl = rng.normal(size=(4, 8)).astype(np.float32)
    probs = np.exp(pl) / np.exp(pl).sum(1, keepdims=True)
    out["7b batched excl"] = forge.scan(alg.ADD, arr(probs), inclusive=False,
                                        layout=Batched(), backend=backend)
    lens = np.asarray([8, 3, 5, 1])
    msk = (np.arange(8)[None] < lens[:, None]).astype(np.int32)
    out["7b masked sums"] = forge.mapreduce(masked, alg.ADD,
                                            (arr(probs), arr(msk)),
                                            layout=Batched(), backend=backend)
    expert = arr(rng.integers(0, 4, 24).astype(np.uint32))
    tok = arr(np.arange(24, dtype=np.int32))
    out["8 sort_pairs"] = forge.sort_pairs(expert, tok, key_bits=2,
                                           backend=backend)
    lg = arr(rng.normal(size=10).astype(np.float32))
    out["8 segmented top_k"] = forge.top_k(lg, 2,
                                           layout=Segmented(offsets=offs),
                                           backend=backend)
    return out


def test_quickstart_sequence_matches_reference():
    from repro.core.layout import Segmented as JSegmented
    from repro_torch.core.layout import Segmented as TSegmented
    # The reference's sequence as one jitted program: the same calls on the
    # same inputs, compiled once (seconds) instead of op by op (a minute).
    want = jax.jit(lambda: _quickstart(
        j_forge, j_alg, JSegmented, JBatched, jnp.asarray,
        lambda t: jnp.where(t[1] != 0, t[0], 0.0), "xla"))()
    for backend in ("torch", "cuda"):
        got = _quickstart(t_forge, t_alg, TSegmented, TBatched,
                          lambda a: torch.from_numpy(np.array(a)),
                          t_alg.masked_select(0.0), backend)
        assert got.keys() == want.keys()
        for key in want:
            g = torch.utils._pytree.tree_leaves(got[key])
            w = jax.tree.leaves(want[key])
            assert len(g) == len(w), key
            for gl, wl in zip(g, w):
                a, b = _np(gl), np.asarray(wl)
                assert a.shape == b.shape, key
                if a.dtype.kind in "iu":
                    np.testing.assert_array_equal(a, b, err_msg=key)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3,
                                               err_msg=key)
