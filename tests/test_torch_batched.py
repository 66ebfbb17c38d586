"""The port's batched GEMVs (K7) against the reference -- the matvec /
vecmat rows of ``tests/test_conformance.py``'s matrix -- and its quantized
GEMVs (K9) on CPU tensors (K9's conformance legs:
``test_torch_quantized_gemv.py``; under max-plus and min-plus:
``test_torch_batched_quantized.py``).  The conformance GEMVs run from
``test_torch_batched_gemv.py`` and the integer ones from
``test_torch_batched_gemv_int32.py``: files of at most 12 tests, which
``--dist loadfile`` queues behind the larger files.

Inputs come from numpy with a seed; the same arrays go through the JAX
routes (``backend="pallas-interpret"``, the Pallas kernel bodies, and
``"xla"``) and through the port's ``torch`` and ``cuda`` routes (on the CPU
the cuda wrappers run their plain versions; the card's kernels are held
against those in ``chip_smoke.py`` and the ``cuda``-marked test below).

Tolerances: MIN over PLUS, MAX over PLUS and integer-valued data are
bit-exact (every order of the fold gives the same bits, and a quantized
operand's dequantized elements are the reference's); float ADD is held
within 1e-5 of sum |x| |a| per output (another summation order).
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import intrinsics as j_ki  # noqa: E402
from repro.core import operators as j_alg  # noqa: E402
from repro.core import primitives as j_forge  # noqa: E402
from repro.core.layout import Batched as JBatched  # noqa: E402
from repro_torch.core import intrinsics as t_ki  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.core.layout import Batched as TBatched  # noqa: E402
from repro_torch.kernels import batched as batched_k  # noqa: E402
from repro_torch.kernels import matvec as matvec_k  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

REF_BACKENDS = ["pallas-interpret", "xla"]
PORT_BACKENDS = ["torch", "cuda"]

# tests/test_conformance.py's matrix: operator names per batched route.
CONFORMANCE_MATRIX = {
    "scan@batched": ["add", "max", "mat2_mul"],
    "mapreduce@batched": ["add", "logsumexp", "quaternion_mul"],
    "matvec@batched": ["add", "min", "mat2_mul"],
    "vecmat@batched": ["add", "min", "mat2_mul"],
    "linear_recurrence@batched": ["affine"],
}


def _seed(*parts):
    return zlib.crc32("|".join(str(p) for p in parts).encode())


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_matrix_enumerates_batched_registry():
    """Both registries have exactly the matrix's @batched routes."""
    port = {k for k in t_ki.route_keys() if k.endswith("@batched")}
    ref = {k for k in j_ki.route_keys() if k.endswith("@batched")}
    assert port == ref == set(CONFORMANCE_MATRIX)


# ---------------------------------------------------------------------------
# K7: batched matvec / vecmat over add, min, mat2_mul
# ---------------------------------------------------------------------------

# Shear terms: each (row, col) term is [[1, x a], [0, 1]], composed in order
# by MAT2_MUL (an operator that does not commute).
SHEAR = t_alg.DeviceMap(
    "shear", lambda x, a: (1.0 + 0 * a, x * a, 0 * a, 1.0 + 0 * a),
    "Out r; r.v0 = __fadd_rn(1.0f, __fmul_rn(0.0f, x.v1)); "
    "r.v1 = rt::mul_rn(x.v0, x.v1); r.v2 = __fmul_rn(0.0f, x.v1); "
    "r.v3 = r.v0; return r;")
SHEAR_VM = t_alg.DeviceMap(
    "shear_vm", lambda a, x: (1.0 + 0 * a, a * x, 0 * a, 1.0 + 0 * a),
    "Out r; r.v0 = __fadd_rn(1.0f, __fmul_rn(0.0f, x.v0)); "
    "r.v1 = rt::mul_rn(x.v0, x.v1); r.v2 = __fmul_rn(0.0f, x.v0); "
    "r.v3 = r.v0; return r;")

# name -> (reference f matvec, f vecmat, op; port f matvec, f vecmat, op)
MV_CASES = {
    "add": ((lambda x, a: x * a, lambda a, x: a * x, j_alg.ADD),
            (t_alg.TIMES, t_alg.TIMES, t_alg.ADD)),
    "min": ((lambda x, a: x + a, lambda a, x: a + x, j_alg.MIN),
            (t_alg.PLUS, t_alg.PLUS, t_alg.MIN)),
    "mat2_mul": ((lambda x, a: (1.0 + 0 * a, x * a, 0 * a, 1.0 + 0 * a),
                  lambda a, x: (1.0 + 0 * a, a * x, 0 * a, 1.0 + 0 * a),
                  j_alg.MAT2_MUL),
                 (SHEAR, SHEAR_VM, t_alg.MAT2_MUL)),
}


def _mv_shapes():
    """(B, n, p): zero extents, tiny, the reference's row tile +-1."""
    pol = j_ki.resolve_tuning("interpret")
    rn = pol.matvec_rows * j_ki.min_tile(jnp.float32)[0]
    return [(0, 4, 3), (2, 0, 3), (3, 4, 0), (1, 1, 1), (3, rn - 1, 5),
            (2, rn, 2), (2, rn + 1, 7), (1, 40, 130)]


def _assert_close(got, want, scale, exact, err):
    """Leafwise: bit-exact, or within 1e-5 x ``scale`` per output."""
    gl, wl = pytree.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), err
    for g, w in zip(gl, wl):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, err
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=err)
        else:
            gap = np.abs(g.astype(np.float64) - w.astype(np.float64))
            assert (gap <= 1e-5 * scale + 1e-7).all(), (err, gap.max())


def _route(form, f, op, A, x, layout, backend):
    fn = t_forge.matvec if form == "matvec" else t_forge.vecmat
    return fn(f, op, A, x, layout=layout, backend=backend)


def _ref_route(form, f, op, A, x, layout, backend, jit=False):
    """The reference's route; with ``jit``, compiled as one program instead
    of op by op (its xla route compiles dozens of small ops eagerly), for
    the tests held to a tolerance: XLA may fuse a multiply-add and move a
    bit."""
    fn = j_forge.matvec if form == "matvec" else j_forge.vecmat
    if not jit:
        return fn(f, op, A, x, layout=layout, backend=backend)
    return jax.jit(lambda a, v: fn(f, op, a, v, layout=layout,
                                   backend=backend))(A, x)


def _ref_routes(form, f, op, A, x, layout):
    """Every reference route of REF_BACKENDS, compiled as one program (for
    the tests held to a tolerance, as ``_ref_route(jit=True)``), by
    backend."""
    fn = j_forge.matvec if form == "matvec" else j_forge.vecmat
    outs = jax.jit(lambda a, v: tuple(
        fn(f, op, a, v, layout=layout, backend=b) for b in REF_BACKENDS))(
            A, x)
    return dict(zip(REF_BACKENDS, outs))


def test_batched_zero_extents_are_identity_rows_without_launching():
    counts = (batched_k.batched_matvec_cuda.launches,
              batched_k.batched_vecmat_cuda.launches)
    for B, n, p in [(0, 4, 3), (2, 0, 3), (2, 4, 0)]:
        for form, xlen in (("matvec", n), ("vecmat", p)):
            for jop, top in ((j_alg.MIN, t_alg.MIN), (j_alg.ADD, t_alg.ADD)):
                want = _ref_route(form, lambda u, v: u * v, jop,
                                  jnp.zeros((B, n, p)), jnp.zeros((B, xlen)),
                                  JBatched(), "xla")
                got = _route(form, t_alg.TIMES, top, torch.zeros(B, n, p),
                             torch.zeros(B, xlen), TBatched(), "cuda")
                _assert_close(got, want, None, True, f"{form} {B}x{n}x{p}")
    assert counts == (batched_k.batched_matvec_cuda.launches,
                      batched_k.batched_vecmat_cuda.launches)


# ---------------------------------------------------------------------------
# K9 on CPU tensors (the conformance legs: test_torch_quantized_gemv.py;
# over other algebras: test_torch_batched_quantized.py)
# ---------------------------------------------------------------------------

QUANT_MODES = ["int8", "fp8_e4m3", "fp8_e5m2"]
Q_BLOCK = 32


def test_quantized_wrappers_take_plain_versions_on_the_cpu():
    counts = {w: w.launches for w in (
        matvec_k.matvec_quantized_cuda, matvec_k.vecmat_quantized_cuda,
        batched_k.batched_matvec_quantized_cuda,
        batched_k.batched_vecmat_quantized_cuda)}
    A = torch.randn(2, 33, 5, generator=torch.Generator().manual_seed(0))
    q = t_alg.quantize(A, mode="int8", block=32)
    q0 = t_alg.quantize(A[0], mode="int8", block=32)
    x, z = torch.ones(2, 33), torch.ones(2, 5)
    for got, want in (
            (matvec_k.matvec_quantized_cuda(t_alg.TIMES, t_alg.ADD, q0, x[0]),
             matvec_k.matvec_plain(t_alg.TIMES, t_alg.ADD, q0.dequantize(),
                                   x[0])),
            (matvec_k.vecmat_quantized_cuda(t_alg.TIMES, t_alg.ADD, q0, z[0]),
             matvec_k.vecmat_plain(t_alg.TIMES, t_alg.ADD, q0.dequantize(),
                                   z[0])),
            (batched_k.batched_matvec_quantized_cuda(t_alg.TIMES, t_alg.ADD,
                                                     q, x),
             batched_k.batched_matvec_plain(t_alg.TIMES, t_alg.ADD,
                                            q.dequantize(), x)),
            (batched_k.batched_vecmat_quantized_cuda(t_alg.TIMES, t_alg.ADD,
                                                     q, z),
             batched_k.batched_vecmat_plain(t_alg.TIMES, t_alg.ADD,
                                            q.dequantize(), z))):
        assert torch.equal(got, want)
    assert {w: w.launches for w in counts} == counts
    with pytest.raises(TypeError, match="takes a Quantized matrix"):
        matvec_k.matvec_quantized_cuda(t_alg.TIMES, t_alg.ADD, A[0], x[0])


# ---------------------------------------------------------------------------
# Validation texts of the new routes, as the reference's
# ---------------------------------------------------------------------------


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


VALIDATION_CASES = {
    "matvec@batched flat operands": (
        lambda: j_forge.matvec(lambda x, a: x * a, j_alg.ADD,
                               jnp.zeros((4, 5)), jnp.zeros(4),
                               layout=JBatched(), backend="xla"),
        lambda: t_forge.matvec(t_alg.TIMES, t_alg.ADD, torch.zeros(4, 5),
                               torch.zeros(4), layout=TBatched())),
    "vecmat@batched flat operands": (
        lambda: j_forge.vecmat(lambda a, x: a * x, j_alg.ADD,
                               jnp.zeros((4, 5)), jnp.zeros(4),
                               layout=JBatched(), backend="xla"),
        lambda: t_forge.vecmat(t_alg.TIMES, t_alg.ADD, torch.zeros(4, 5),
                               torch.zeros(4), layout=TBatched())),
    "matvec@batched rank-1 vectors": (
        lambda: j_forge.matvec(lambda x, a: x * a, j_alg.ADD,
                               jnp.zeros((2, 4, 5)), jnp.zeros(4),
                               layout=JBatched(), backend="xla"),
        lambda: t_forge.matvec(t_alg.TIMES, t_alg.ADD, torch.zeros(2, 4, 5),
                               torch.zeros(4), layout=TBatched())),
    "matvec@flat batched operands": (
        lambda: j_forge.matvec(lambda x, a: x * a, j_alg.ADD,
                               jnp.zeros((2, 4, 5)), jnp.zeros((2, 4)),
                               backend="xla"),
        lambda: t_forge.matvec(t_alg.TIMES, t_alg.ADD, torch.zeros(2, 4, 5),
                               torch.zeros(2, 4))),
    "matvec@batched flat quantized operand": (
        lambda: j_forge.matvec(lambda x, a: x * a, j_alg.ADD,
                               j_alg.quantize(jnp.ones((4, 5)), block=2),
                               jnp.zeros(4), layout=JBatched(),
                               backend="xla"),
        lambda: t_forge.matvec(t_alg.TIMES, t_alg.ADD,
                               t_alg.quantize(torch.ones(4, 5), block=2),
                               torch.zeros(4), layout=TBatched())),
    "vecmat@batched unknown backend": (
        lambda: j_forge.vecmat(lambda a, x: a * x, j_alg.ADD,
                               jnp.ones((2, 4, 5)), jnp.ones((2, 5)),
                               layout=JBatched(), backend="tirton"),
        lambda: t_forge.vecmat(t_alg.TIMES, t_alg.ADD, torch.ones(2, 4, 5),
                               torch.ones(2, 5), layout=TBatched(),
                               backend="tirton")),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validation_texts_match_reference(case):
    ref_call, port_call = VALIDATION_CASES[case]
    got, want = _message(port_call), _message(ref_call)
    if "unknown backend" in case:     # the backend lists differ by package
        got, want = got.split(" (available")[0], want.split(" (available")[0]
    assert got == want


# ---------------------------------------------------------------------------
# On the card: each new kernel against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k7_k9_kernels_match_plain_versions_on_the_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    A = torch.randn(3, 65, 33, generator=gen, device=cuda_device)
    x = torch.randn(3, 65, generator=gen, device=cuda_device)
    z = torch.randn(3, 33, generator=gen, device=cuda_device)
    assert torch.equal(
        batched_k.batched_matvec_cuda(t_alg.PLUS, t_alg.MIN, A, x),
        batched_k.batched_matvec_plain(t_alg.PLUS, t_alg.MIN, A, x))
    assert torch.equal(
        batched_k.batched_vecmat_cuda(t_alg.PLUS, t_alg.MIN, A, z),
        batched_k.batched_vecmat_plain(t_alg.PLUS, t_alg.MIN, A, z))
    for mode in QUANT_MODES:
        q = t_alg.quantize(A, mode=mode, block=16)
        assert torch.equal(
            batched_k.batched_matvec_quantized_cuda(t_alg.PLUS, t_alg.MIN,
                                                    q, x),
            batched_k.batched_matvec_quantized_plain(t_alg.PLUS, t_alg.MIN,
                                                     q, x))
        q0 = t_alg.quantize(A[0], mode=mode, block=16)
        torch.testing.assert_close(
            matvec_k.vecmat_quantized_cuda(t_alg.TIMES, t_alg.ADD, q0, z[0]),
            matvec_k.vecmat_quantized_plain(t_alg.TIMES, t_alg.ADD, q0, z[0]),
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k7s_single_tile_form_matches_plain_version_on_the_card(cuda_device):
    """K7s on both sides of one tile (2,048 elements a row for 4- and
    8-byte elements): int32 ADD bit-exact, AFFINE within 1e-6 of the
    output's size; the counter says which form ran."""
    k7s = batched_k.batched_scan_cuda
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for n in (1, 64, 2047, 2048, 2049):
        x = torch.randint(-100, 100, (3, n), generator=gen,
                          device=cuda_device, dtype=torch.int32)
        single = k7s.single_tile_launches
        for inclusive in (True, False):
            assert torch.equal(
                k7s(t_alg.ADD, x, inclusive=inclusive),
                batched_k.batched_scan_plain(t_alg.ADD, x,
                                             inclusive=inclusive))
        assert (k7s.single_tile_launches - single) == (2 if n <= 2048 else 0)
        a = torch.empty(3, n, device=cuda_device).uniform_(0.9, 1.0,
                                                           generator=gen)
        b = torch.empty(3, n, device=cuda_device).uniform_(-1, 1,
                                                           generator=gen)
        got = k7s(t_alg.AFFINE, (a, b))
        want = batched_k.batched_scan_plain(t_alg.AFFINE, (a, b))
        scale = max(float(want[1].abs().max()), 1.0)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-6 * scale
