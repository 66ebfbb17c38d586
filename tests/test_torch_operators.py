"""The port's operator algebra and its device forms against the JAX package.

Every operator of ``STD_OPS``, the ``segmented()`` lift, the four semirings
of ``STD_SEMIRINGS`` and the UnitFloat8 codec go through the reference
(``repro.core.operators``) and the port (``repro_torch.core.operators``) on
the same numpy inputs (``conftest.make_operand``).  The port's operators
are also held to the laws of ``tests/test_properties.py``.  Then the
generator of ``kernels/_lib.py``: every operator, semiring and
``segmented(QUATERNION_MUL)`` gets a translation unit that names its functor
and entry points, and an operator with no device form is refused before
anything is built.

Tolerances: combines of one step agree to rtol = atol = 1e-6 (float32 in
both packages; only library exp/log rounding differs); identities, the
segmented reset, the codec and integer results are bit-exact; the law checks
keep the reference suite's 1e-5 for associativity.  Semiring products over
(37, 20) matrices fold in another order: rtol = atol = 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import make_operand  # noqa: E402
from repro.core import operators as j_alg  # noqa: E402
from repro.core import primitives as j_forge  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import scan as scan_k  # noqa: E402

OP_NAMES = sorted(j_alg.STD_OPS)
SEEDS = [1, 32, 63]
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(tree):
    return jax.tree.map(lambda l: torch.from_numpy(np.array(l)), tree)


def _leaves_np(tree):
    # jax.tree treats torch tensors as leaves, so one walk serves both.
    return [l.numpy() if isinstance(l, torch.Tensor) else np.asarray(l)
            for l in jax.tree.leaves(tree)]


def _close(got, want, **tol):
    g, w = _leaves_np(got), _leaves_np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        if tol:
            np.testing.assert_allclose(a, b, **tol)
        else:
            np.testing.assert_array_equal(a, b)


def _operands(op_name, seed, k=2, shape=(16,)):
    rng = np.random.default_rng(seed)
    return [make_operand(op_name, rng, shape) for _ in range(k)]


# ---------------------------------------------------------------------------
# The algebra against the reference
# ---------------------------------------------------------------------------


def test_std_ops_and_semirings_have_the_reference_names():
    assert set(t_alg.STD_OPS) == set(j_alg.STD_OPS)
    assert set(t_alg.STD_SEMIRINGS) == set(j_alg.STD_SEMIRINGS)
    for name, op in t_alg.STD_OPS.items():
        assert op.commutative == j_alg.STD_OPS[name].commutative, name
        assert op.device is not None, f"{name} has no device form"
    for name, s in t_alg.STD_SEMIRINGS.items():
        assert s.op.name == j_alg.STD_SEMIRINGS[name].op.name
        assert s.f.device is not None, f"{name}'s map has no device form"


@pytest.mark.parametrize("op_name", OP_NAMES)
def test_combine_and_identity_match_reference(op_name):
    x, y = _operands(op_name, 7)
    jop, top = j_alg.STD_OPS[op_name], t_alg.STD_OPS[op_name]
    _close(top(_t(x), _t(y)), jop(x, y), **TOL)
    _close(top.identity(_t(x)), jop.identity(x))


@pytest.mark.parametrize("op_name", OP_NAMES)
@pytest.mark.parametrize("seed", SEEDS)
def test_associativity(op_name, seed):
    op = t_alg.STD_OPS[op_name]
    x, y, z = (_t(v) for v in _operands(op_name, seed, 3, (4,)))
    _close(op(op(x, y), z), op(x, op(y, z)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op_name", OP_NAMES)
@pytest.mark.parametrize("seed", SEEDS)
def test_identity_exact(op_name, seed):
    op = t_alg.STD_OPS[op_name]
    (x,) = (_t(v) for v in _operands(op_name, seed, 1, (4,)))
    ident = op.identity(x)
    for got in (op(ident, x), op(x, ident)):
        _close(got, x)


@pytest.mark.parametrize("op_name", OP_NAMES)
def test_commutativity_claims_hold(op_name):
    op = t_alg.STD_OPS[op_name]
    pairs = [(_t(a), _t(b)) for a, b in
             (_operands(op_name, s, 2, (4,)) for s in range(8))]
    differs = [any(not torch.allclose(u, v) for u, v in zip(
        torch.utils._pytree.tree_leaves(op(a, b)),
        torch.utils._pytree.tree_leaves(op(b, a)))) for a, b in pairs]
    assert not any(differs) if op.commutative else any(differs)


def test_logsumexp_of_two_empty_sides_is_neg_inf():
    ninf = torch.tensor([-np.inf, -np.inf, 1.0])
    got = t_alg.LOGSUMEXP(ninf, torch.tensor([-np.inf, 2.0, -np.inf]))
    want = j_alg.LOGSUMEXP(jnp.asarray([-np.inf, -np.inf, 1.0]),
                           jnp.asarray([-np.inf, 2.0, -np.inf]))
    _close(got, want)


@pytest.mark.parametrize("op_name", ["add", "quaternion_mul"])
@pytest.mark.parametrize("seed", SEEDS)
def test_segmented_lift_matches_reference(op_name, seed):
    rng = np.random.default_rng(seed)
    x, y, z = ((jnp.asarray(rng.integers(0, 2, (6,)), jnp.int32),
                make_operand(op_name, rng, (6,))) for _ in range(3))
    jseg = j_alg.segmented(j_alg.STD_OPS[op_name])
    tseg = t_alg.segmented(t_alg.STD_OPS[op_name])
    assert tseg.name == jseg.name and not tseg.commutative
    _close(tseg(_t(x), _t(y)), jseg(x, y), **TOL)
    _close(tseg.identity(_t(x)), jseg.identity(x))
    tx, ty, tz = _t(x), _t(y), _t(z)
    _close(tseg(tseg(tx, ty), tz), tseg(tx, tseg(ty, tz)), rtol=1e-5,
           atol=1e-5)
    flagged = (torch.ones_like(ty[0]), ty[1])
    f_out, v_out = tseg(tx, flagged)
    _close(v_out, ty[1])
    assert bool((f_out == 1).all())


@pytest.mark.parametrize("name", sorted(j_alg.STD_SEMIRINGS))
def test_semirings_match_reference(name):
    rng = np.random.default_rng(len(name))
    A = rng.uniform(-3, 3, (37, 20)).astype(np.float32)
    xv = rng.uniform(-3, 3, 37).astype(np.float32)
    xz = rng.uniform(-3, 3, 20).astype(np.float32)
    js, ts = j_alg.STD_SEMIRINGS[name], t_alg.STD_SEMIRINGS[name]
    _close(ts.f(torch.from_numpy(xv[:, None]), torch.from_numpy(A)),
           js.f(xv[:, None], A))
    want_mv = j_forge.semiring_matvec(js, A, xv, backend="xla")
    want_vm = j_forge.semiring_vecmat(js, A, xz, backend="xla")
    for backend in ("torch", "cuda"):
        got_mv = t_forge.semiring_matvec(ts, torch.from_numpy(A),
                                         torch.from_numpy(xv),
                                         backend=backend)
        got_vm = t_forge.semiring_vecmat(ts, torch.from_numpy(A),
                                         torch.from_numpy(xz),
                                         backend=backend)
        _close(got_mv, want_mv, rtol=1e-5, atol=1e-5)
        _close(got_vm, want_vm, rtol=1e-5, atol=1e-5)


def test_unitfloat8_codec_is_bit_exact():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-1.3, 1.3, 4096),
                        np.linspace(-1, 1, 511),
                        [-2.0, -1.0, 0.0, 1.0, 2.0]]).astype(np.float32)
    codes = t_alg.unitfloat8_encode(torch.from_numpy(x))
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(j_alg.unitfloat8_encode(x)))
    every = np.arange(256, dtype=np.uint8)
    got = t_alg.unitfloat8_decode(torch.from_numpy(every))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.asarray(j_alg.unitfloat8_decode(every)).view(np.uint32))


# ---------------------------------------------------------------------------
# The generator of device functors
# ---------------------------------------------------------------------------

_LEAVES = {"affine": 2, "maxplus_affine": 2, "softmax_merge": 3,
           "quaternion_mul": 4, "mat2_mul": 4}


@pytest.mark.parametrize("op_name", OP_NAMES)
def test_generator_emits_a_unit_per_operator(op_name):
    op = t_alg.STD_OPS[op_name]
    dtypes = [torch.float32] * _LEAVES.get(op_name, 1)
    unit = _lib.unit("scan", "scan@flat", op, dtypes)
    assert unit.family == "scan" and op_name in unit.label
    src = unit.source
    assert f"// {op_name}\nstruct Op0 {{" in src and "using Op = Op0;" in src
    assert "COMMUTATIVE = " + ("true" if op.commutative else "false") in src
    assert '#include "scan.cuh"' in src and 'extern "C"' in src
    for entry in _lib.FAMILIES["scan"].signatures:
        assert f" {entry}(" in src
    # One combination, one library: the name hashes source, headers, flags.
    assert unit.path.name == f"scan-{unit.digest}.so"
    assert _lib.unit("scan", "scan@flat", op, dtypes).digest == unit.digest
    if op_name in ("add", "max"):
        other = _lib.unit("scan", "scan@flat", op, [torch.float64])
        assert other.digest != unit.digest and "E_f64" in other.source


@pytest.mark.parametrize("name", sorted(t_alg.STD_SEMIRINGS))
def test_generator_emits_a_unit_per_semiring(name):
    s = t_alg.STD_SEMIRINGS[name]
    f32 = torch.empty(0)
    out, _ = _lib.map_out("matvec@flat", s.f, f32, f32)
    unit = _lib.unit("matvec", "matvec@flat", s.op, out, f=s.f,
                     in_dtypes=[torch.float32] * 2)
    src = unit.source
    assert f"// {s.f.name}\nstruct Map {{" in src
    assert "using In = E_f32_f32;" in src and "using Out = E_f32;" in src
    assert f"// {s.op.name}\nstruct Op0" in src
    for entry in _lib.FAMILIES["matvec"].signatures:
        assert f" {entry}(" in src


def test_generator_lifts_quaternion_segments_from_the_inner_form():
    seg = t_alg.segmented(t_alg.QUATERNION_MUL)
    unit = _lib.unit("segscan", "scan@segmented", seg,
                     [torch.int32] + [torch.float32] * 4)
    src = unit.source
    assert "struct E_i32_f32_f32_f32_f32" in src
    assert "// quaternion_mul\nstruct Op1" in src
    assert "// segmented[quaternion_mul]\nstruct Op0" in src
    assert "const E_f32_f32_f32_f32 m = Op1::combine(x, y);" in src
    assert "using Op = Op0;" in src and " rt_segscan(" in src
    # The inner operator's struct precedes the lift that calls it.
    assert src.index("struct Op1") < src.index("struct Op0")


def test_map_changes_the_element_type():
    out, _ = _lib.map_out("mapreduce@flat", t_alg.unitfloat8_decode,
                          torch.empty(0, dtype=torch.uint8))
    assert out == [torch.float32]
    unit = _lib.unit("mapreduce", "mapreduce@flat", t_alg.ADD, out,
                     f=t_alg.unitfloat8_decode, in_dtypes=[torch.uint8])
    assert "using In = E_u8;" in unit.source
    assert "using Out = E_f32;" in unit.source
    assert "__fmul_rn" in unit.source


def test_no_device_form_is_refused_before_anything_is_built(monkeypatch):
    def no_build(units):
        raise AssertionError("a refused operator reached the build")

    monkeypatch.setattr(_lib, "build", no_build)
    plain = t_alg.AssocOp("plain_max", lambda a, b: torch.maximum(a, b),
                          lambda l: torch.full_like(l, -np.inf), True)
    for make in (lambda: scan_k.scan_unit("scan@flat (cuda)", plain,
                                          [torch.zeros(4)]),
                 lambda: _lib.unit("segscan", "scan@segmented (cuda)",
                                   t_alg.segmented(plain),
                                   [torch.int32, torch.float32])):
        with pytest.raises(NotImplementedError,
                           match=r"\(cuda\).*'plain_max' has no device"):
            make()
    with pytest.raises(NotImplementedError, match="has no device form"):
        _lib.map_out("mapreduce@flat (cuda)", lambda v: v, torch.zeros(4))
    with pytest.raises(NotImplementedError, match="no device form over int32"):
        _lib.unit("scan", "scan@flat", t_alg.LOGSUMEXP, [torch.int32])
    with pytest.raises(NotImplementedError, match="1 to 5 leaves"):
        _lib.unit("scan", "scan@flat", t_alg.ADD, [torch.float32] * 6)


def test_user_operator_with_a_device_form():
    """The module docstring's recipe: a user's operator carries its own
    fragment and goes through the same generator."""
    xor = t_alg.AssocOp(
        "xor", lambda a, b: a ^ b, lambda l: torch.zeros_like(l), True,
        t_alg.DeviceOp(identity="r.v# = 0;", combine="r.v# = a.v# ^ b.v#;"))
    unit = _lib.unit("mapreduce", "mapreduce@flat", xor, [torch.int32],
                     f=t_alg.IDENTITY, in_dtypes=[torch.int32])
    assert "r.v0 = a.v0 ^ b.v0;" in unit.source
    x = torch.arange(1, 9, dtype=torch.int32)
    assert int(t_forge.mapreduce(t_alg.IDENTITY, xor, x, backend="cuda")) \
        == 8


# ---------------------------------------------------------------------------
# On the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op_name", OP_NAMES)
def test_every_std_op_scans_on_the_card(cuda_device, op_name):
    op = t_alg.STD_OPS[op_name]
    x = _t(_operands(op_name, 5, 1, (5000,))[0])
    x = torch.utils._pytree.tree_map(lambda l: l.to(cuda_device), x)
    got = scan_k.scan_1d_cuda(op, x)
    want = scan_k.scan_1d_plain(op, x)
    _close(torch.utils._pytree.tree_map(lambda l: l.cpu(), got),
           torch.utils._pytree.tree_map(lambda l: l.cpu(), want),
           rtol=1e-4, atol=1e-4)
