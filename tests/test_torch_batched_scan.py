"""The PyTorch port's batched scan and mapreduce -- K7s and K7m -- against
the JAX package (the batched mapreduce's zero-extent guard and its
reroute through K7s: ``test_torch_batched_reroute.py``).

Inputs come from numpy with a seed (``conftest.make_operand``); the same
arrays go through the JAX function -- its Pallas kernel in interpret mode,
``backend="pallas-interpret"`` -- and through the port's counterpart.  On
the CPU the port's kernel wrappers run their plain versions, so these tests
hold the plain versions (the oracles the card's kernels are held against
in ``chip_smoke.py``) and the route layer to the reference.

Tolerances: integer scans and reductions are bit-exact; the masked
float32 sums are held at rtol = 1e-5, atol = 1e-3, UnitFloat8 and f32 sums
at rtol = atol = 1e-5, the batched scan of probability rows (whose
prefixes stay below 1) at atol = 1e-6, AFFINE at rtol = atol = 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import make_operand  # noqa: E402
from repro.core import operators as j_alg  # noqa: E402
from repro.core import primitives as j_forge  # noqa: E402
from repro.core.layout import Batched as JBatched  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.core.layout import Batched as TBatched  # noqa: E402
from repro_torch.kernels import batched as batched_k  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

PI = "pallas-interpret"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
INT_OPS = ["add", "max", "min", "mul"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


# ---------------------------------------------------------------------------
# K7m: batched masked mapreduce (ADD over f32 with an int32 mask)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,n", [(2, 64), (3, 5), (1, 300), (2, 1)])
def test_k7m_masked_batched_add_matches_pallas(B, n):
    rng = np.random.default_rng(B * 1000 + n)
    logp = make_operand("add", rng, (B, n))
    emitted = rng.integers(0, n + 1, (B,))
    mask = jnp.asarray(np.arange(n)[None, :] < emitted[:, None], jnp.int32)
    want = j_forge.mapreduce(lambda t: jnp.where(t[1] != 0, t[0], 0.0),
                             j_alg.ADD, (logp, mask), layout=JBatched(),
                             backend=PI)
    xs = (_t(logp), _t(mask))
    masked = t_alg.masked_select(0.0)
    for got in (batched_k.batched_mapreduce_plain(masked, t_alg.ADD, xs),
                t_ref.ref_batched_mapreduce(masked, t_alg.ADD, xs),
                batched_k.batched_mapreduce_cuda(masked, t_alg.ADD, xs),
                t_forge.mapreduce(masked, t_alg.ADD, xs, layout=TBatched())):
        assert got.shape == (B,) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("what,B,n", [
    ("add", 3, 5), ("add", 2, 1), ("max", 4, 7), ("max", 1, 300),
    ("uf8", 3, 37), ("uf8", 2, 1), ("f32", 3, 9)])
def test_k7m_batched_mapreduce_matches_pallas(what, B, n):
    """int32 ADD / MAX (bit-exact), UnitFloat8 codes decoded to f32 and
    f32 ADD (rtol = atol = 1e-5), at n = 1 and n not a multiple of any
    load width: the plain version and the wrapper's CPU route against the
    reference's Pallas kernel on the same numpy inputs."""
    rng = np.random.default_rng(B * 100 + n)
    if what == "uf8":
        x = rng.integers(0, 256, (B, n)).astype(np.uint8)
        jf, tf, jop, top = (j_alg.unitfloat8_decode, t_alg.unitfloat8_decode,
                            j_alg.ADD, t_alg.ADD)
    else:
        x = rng.integers(-1000, 1000, (B, n)).astype(
            np.float32 if what == "f32" else np.int32)
        jf, tf = (lambda v: v), t_alg.IDENTITY
        jop, top = (j_alg.MAX, t_alg.MAX) if what == "max" else \
            (j_alg.ADD, t_alg.ADD)
    want = np.asarray(j_forge.mapreduce(jf, jop, jnp.asarray(x),
                                        layout=JBatched(), backend=PI))
    for got in (batched_k.batched_mapreduce_plain(tf, top, _t(x)),
                batched_k.batched_mapreduce_cuda(tf, top, _t(x))):
        assert got.shape == (B,) and _np(got).dtype == want.dtype
        if what in ("add", "max"):
            np.testing.assert_array_equal(_np(got), want)
        else:
            np.testing.assert_allclose(_np(got), want, **F32_TOL)


# ---------------------------------------------------------------------------
# K7s: batched scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op_name", INT_OPS)
@pytest.mark.parametrize("n", [1, 64, 2047, 2048, 2049])
def test_k7s_batched_scan_int32_matches_pallas(op_name, n):
    """Rows up to and across the kernel's one-block tile (2,048)."""
    rng = np.random.default_rng(n)
    lo, hi = (1, 2) if op_name == "mul" else (-50, 50)
    x = jnp.asarray(rng.integers(lo, hi, (3, n)), jnp.int32)
    jop, top = getattr(j_alg, op_name.upper()), getattr(t_alg, op_name.upper())
    for inclusive in (True, False):
        want = np.asarray(j_forge.scan(jop, x, inclusive=inclusive,
                                       layout=JBatched(), backend=PI))
        for got in (t_forge.scan(top, _t(x), inclusive=inclusive,
                                 layout=TBatched()),
                    batched_k.batched_scan_cuda(top, _t(x),
                                                inclusive=inclusive)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("n", [64, 2049])
def test_k7s_batched_scan_f32_probabilities_match_pallas(n):
    """The nucleus cutoff's scan: exclusive ADD over probability rows."""
    rng = np.random.default_rng(n + 1)
    logits = rng.normal(size=(4, n)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want = j_forge.scan(j_alg.ADD, jnp.asarray(probs), inclusive=False,
                        layout=JBatched(), backend=PI)
    for backend in ("torch", "cuda"):
        got = t_forge.scan(t_alg.ADD, torch.from_numpy(probs),
                           inclusive=False, layout=TBatched(),
                           backend=backend)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_k7s_batched_scan_affine_and_reverse_match_pallas():
    a, b = make_operand("affine", np.random.default_rng(12), (3, 70))
    for reverse in (False, True):
        wa, wb = j_forge.scan(j_alg.AFFINE, (a, b), reverse=reverse,
                              layout=JBatched(), backend=PI)
        for backend in ("torch", "cuda"):
            ga, gb = t_forge.scan(t_alg.AFFINE, (_t(a), _t(b)),
                                  reverse=reverse, layout=TBatched(),
                                  backend=backend)
            np.testing.assert_allclose(_np(ga), np.asarray(wa), **F32_TOL)
            np.testing.assert_allclose(_np(gb), np.asarray(wb), **F32_TOL)


@pytest.mark.parametrize("shape", [(0, 5), (3, 0)])
def test_k7s_zero_extent_passthrough_matches_reference(shape):
    x = jnp.zeros(shape, jnp.float32)
    want = j_forge.scan(j_alg.ADD, x, layout=JBatched(), backend="xla")
    xt = torch.zeros(shape)
    got = t_forge.scan(t_alg.ADD, xt, layout=TBatched(), backend="cuda")
    assert got is xt and tuple(got.shape) == want.shape
