"""The port's Segmented layout -- ``scan@segmented`` and
``mapreduce@segmented`` on kernel K8 -- against the JAX package.

The same numpy inputs go through the reference (``backend="xla"``, and the
Pallas kernel in interpret mode for one operator at n = 2,100) and through
the port's ``torch`` route and its ``cuda`` route (on CPU tensors the K8
wrapper runs its plain version).  Segments are given as CSR offsets and as
flags; the offsets are always valid (the reference does not check them when
traced) and include empty segments, one segment over the whole stream, and
segment edges at 2,047, 2,048 and 2,049 -- one tile of K8 for 4-byte values
is 2,048 elements, as is one interpret block of the reference.

Tolerances: integer ADD and float MAX are bit-exact; float32 ADD of values
up to 100 folds in another order over runs of up to 2,100 elements: rtol =
1e-5, atol = 1e-2 (partial sums reach 1e3, where one float32 ulp is 6e-5);
the non-commutative QUATERNION_MUL runs on unit quaternions (rotations, so
products of up to 2,100 factors stay of size 1) and its rounding grows at
most linearly with the run (2,100 x 6e-8): rtol = 0, atol = 2e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import make_operand  # noqa: E402
from repro.core import operators as j_alg  # noqa: E402
from repro.core import primitives as j_forge  # noqa: E402
from repro.core.layout import Segmented as JSegmented  # noqa: E402
from repro.kernels import segmented as j_seg  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.core.layout import Segmented as TSegmented  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import segmented as t_seg  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

N = 2100
OFFSETS = {
    "one segment": [0, N],
    "empties and tile edges": [0, 0, 5, 5, 2047, 2048, 2049, 2100, 2100],
    "short runs": [0, 1, 2, 3, 700, 1400, 2099, 2100],
}
CASES = [("add", "int32"), ("add", "float32"), ("max", "float32"),
         ("quaternion_mul", "float32")]


def _tol(op_name, dtype):
    if dtype == "int32" or op_name == "max":
        return {}
    if op_name == "add":
        return dict(rtol=1e-5, atol=1e-2)
    return dict(rtol=0, atol=2e-4)


def _inputs(op_name, dtype, n=N, seed=0):
    x = make_operand(op_name, np.random.default_rng(seed), (n,),
                     jnp.dtype(dtype))
    if op_name == "quaternion_mul":
        norm = jnp.sqrt(sum(l * l for l in x))
        x = tuple(l / norm for l in x)
    return x, jax.tree.map(lambda l: torch.from_numpy(np.array(l)), x)


def _close(got, want, tol):
    g = [l.numpy() for l in torch.utils._pytree.tree_leaves(got)]
    w = [np.asarray(l) for l in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        if tol:
            np.testing.assert_allclose(a, b, **tol)
        else:
            np.testing.assert_array_equal(a, b)


def _descriptors(name):
    offs = np.asarray(OFFSETS[name], np.int32)
    flags = np.array(j_seg.offsets_to_flags(jnp.asarray(offs), N))
    return offs, flags


# ---------------------------------------------------------------------------
# scan@segmented
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op_name,dtype", CASES)
@pytest.mark.parametrize("offsets", sorted(OFFSETS))
@pytest.mark.parametrize("inclusive", [True, False])
def test_segmented_scan_matches_reference(op_name, dtype, offsets, inclusive):
    x, xt = _inputs(op_name, dtype)
    offs, flags = _descriptors(offsets)
    jop, top = j_alg.STD_OPS[op_name], t_alg.STD_OPS[op_name]
    for jl, tl in ((JSegmented(offsets=jnp.asarray(offs)),
                    TSegmented(offsets=torch.from_numpy(offs))),
                   (JSegmented(flags=jnp.asarray(flags)),
                    TSegmented(flags=torch.from_numpy(flags)))):
        want = j_forge.scan(jop, x, inclusive=inclusive, layout=jl,
                            backend="xla")
        for backend in ("torch", "cuda"):
            got = t_forge.scan(top, xt, inclusive=inclusive, layout=tl,
                               backend=backend)
            _close(got, want, _tol(op_name, dtype))


@pytest.mark.parametrize("inclusive", [True, False])
def test_segmented_scan_matches_the_pallas_kernel(inclusive):
    """The reference's K8 in interpret mode, across its block edge."""
    x, xt = _inputs("add", "int32", seed=4)
    offs, _ = _descriptors("empties and tile edges")
    want = j_forge.scan(j_alg.ADD, x, inclusive=inclusive,
                        layout=JSegmented(offsets=jnp.asarray(offs)),
                        backend="pallas-interpret")
    flags = t_seg.offsets_to_flags(torch.from_numpy(offs), N)
    for got in (t_seg.segmented_scan_1d_plain(t_alg.ADD, xt, flags,
                                              inclusive=inclusive),
                t_seg.segmented_scan_1d_cuda(t_alg.ADD, xt, flags,
                                             inclusive=inclusive)):
        _close(got, want, {})


def test_segmented_scan_zero_extent_passthrough():
    x = torch.zeros(0)
    got = t_forge.scan(t_alg.ADD, x, backend="cuda",
                       layout=TSegmented(offsets=torch.zeros(1, dtype=torch.int32)))
    assert got is x


# ---------------------------------------------------------------------------
# mapreduce@segmented
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op_name,dtype", CASES)
@pytest.mark.parametrize("offsets", sorted(OFFSETS))
def test_segmented_mapreduce_matches_reference(op_name, dtype, offsets):
    x, xt = _inputs(op_name, dtype, seed=1)
    offs, flags = _descriptors(offsets)
    ns = int(flags.sum()) + 2        # two trailing segments never started
    jop, top = j_alg.STD_OPS[op_name], t_alg.STD_OPS[op_name]
    for jl, tl in ((JSegmented(offsets=jnp.asarray(offs)),
                    TSegmented(offsets=torch.from_numpy(offs))),
                   (JSegmented(flags=jnp.asarray(flags), num_segments=ns),
                    TSegmented(flags=torch.from_numpy(flags),
                               num_segments=ns))):
        want = j_forge.mapreduce(lambda v: v, jop, x, layout=jl,
                                 backend="xla")
        for backend in ("torch", "cuda"):
            got = t_forge.mapreduce(lambda v: v, top, xt, layout=tl,
                                    backend=backend)
            _close(got, want, _tol(op_name, dtype))


def test_segmented_mapreduce_maps_and_changes_type():
    """The map runs as tensor code before the scan; UnitFloat8 -> f32."""
    rng = np.random.default_rng(9)
    u = rng.integers(0, 256, N).astype(np.uint8)
    offs, _ = _descriptors("empties and tile edges")
    want = j_forge.mapreduce(j_alg.unitfloat8_decode, j_alg.ADD, u,
                             layout=JSegmented(offsets=jnp.asarray(offs)),
                             backend="xla")
    for backend in ("torch", "cuda"):
        got = t_forge.mapreduce(t_alg.unitfloat8_decode, t_alg.ADD,
                                torch.from_numpy(u),
                                layout=TSegmented(offsets=torch.from_numpy(
                                    offs)), backend=backend)
        _close(got, want, dict(rtol=1e-5, atol=1e-4))


@pytest.mark.parametrize("descriptor", ["offsets", "flags"])
def test_segmented_mapreduce_zero_extent_is_identity(descriptor):
    if descriptor == "offsets":
        jl = JSegmented(offsets=jnp.zeros(4, jnp.int32))
        tl = TSegmented(offsets=torch.zeros(4, dtype=torch.int32))
    else:
        jl = JSegmented(flags=jnp.zeros(0, jnp.int32), num_segments=3)
        tl = TSegmented(flags=torch.zeros(0, dtype=torch.int32),
                        num_segments=3)
    want = j_forge.mapreduce(lambda v: v, j_alg.MAX, jnp.zeros(0, jnp.float32),
                             layout=jl, backend="xla")
    got = t_forge.mapreduce(lambda v: v, t_alg.MAX, torch.zeros(0),
                            layout=tl, backend="cuda")
    _close(got, want, {})


# ---------------------------------------------------------------------------
# Validation texts, and the descriptor glue
# ---------------------------------------------------------------------------


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_validation_texts_match_reference():
    x, xt = jnp.zeros(8), torch.zeros(8)
    fl, tfl = jnp.ones(8, jnp.int32), torch.ones(8, dtype=torch.int32)
    offs, toffs = jnp.asarray([0, 8], jnp.int32), torch.tensor([0, 8])
    cases = [
        (lambda: j_forge.mapreduce(lambda v: v, j_alg.ADD, x,
                                   layout=JSegmented(flags=fl),
                                   backend="xla"),
         lambda: t_forge.mapreduce(lambda v: v, t_alg.ADD, xt,
                                   layout=TSegmented(flags=tfl))),
        (lambda: j_forge.scan(j_alg.ADD, x,
                              layout=JSegmented(flags=fl, offsets=offs),
                              backend="xla"),
         lambda: t_forge.scan(t_alg.ADD, xt,
                              layout=TSegmented(flags=tfl, offsets=toffs))),
        (lambda: j_forge.scan(j_alg.ADD, x, reverse=True,
                              layout=JSegmented(offsets=offs), backend="xla"),
         lambda: t_forge.scan(t_alg.ADD, xt, reverse=True,
                              layout=TSegmented(offsets=toffs))),
        (lambda: j_forge.scan(j_alg.ADD, jnp.zeros((2, 4)),
                              layout=JSegmented(offsets=offs), backend="xla"),
         lambda: t_forge.scan(t_alg.ADD, torch.zeros(2, 4),
                              layout=TSegmented(offsets=toffs))),
    ]
    for ref_call, port_call in cases:
        assert _message(port_call) == _message(ref_call)


@pytest.mark.parametrize("offsets", sorted(OFFSETS))
def test_descriptor_glue_matches_reference(offsets):
    offs, flags = _descriptors(offsets)
    tflags = t_seg.offsets_to_flags(torch.from_numpy(offs), N)
    np.testing.assert_array_equal(tflags.numpy(), flags)
    ids = t_seg.flags_to_segment_ids(
        tflags, lambda op, v: t_ref.ref_scan(op, v))
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(j_seg.flags_to_segment_ids(
            jnp.asarray(flags))))
    x, xt = _inputs("add", "int32", seed=2)
    incl = np.cumsum(np.asarray(x))
    ns = int(flags.sum()) + 1
    for kw, tkw in ((dict(offsets=jnp.asarray(offs)),
                     dict(offsets=torch.from_numpy(offs))),
                    (dict(flags=jnp.asarray(flags), num_segments=ns),
                     dict(flags=tflags, num_segments=ns))):
        want = j_seg.gather_segment_lasts(j_alg.ADD, jnp.asarray(incl), **kw)
        got = t_seg.gather_segment_lasts(
            t_alg.ADD, torch.from_numpy(incl),
            lambda op, v: t_ref.ref_scan(op, v), **tkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# On the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inclusive", [True, False])
def test_k8_matches_its_plain_version_on_the_card(cuda_device, inclusive):
    offs, _ = _descriptors("empties and tile edges")
    flags = t_seg.offsets_to_flags(torch.from_numpy(offs), N).to(cuda_device)
    _, q = _inputs("quaternion_mul", "float32")
    q = tuple(l.to(cuda_device) for l in q)
    got = t_seg.segmented_scan_1d_cuda(t_alg.QUATERNION_MUL, q, flags,
                                       inclusive=inclusive)
    want = t_seg.segmented_scan_1d_plain(t_alg.QUATERNION_MUL, q, flags,
                                         inclusive=inclusive)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
