"""The PyTorch port's batched mapreduce routes against the JAX package:
the zero-extent guard, and the reroute of an operator that does not
commute through the batched scan (K7s on the card), as the reference's
dispatch makes them.

Inputs come from numpy with a seed (``conftest.make_operand``); each
reference route is jitted, compiled once a shape.  Tolerances: the guard's
identity rows are exact; the rerouted products are held within 1e-5 of
each output's size.
"""
import zlib

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

PI = "pallas-interpret"


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


# ---------------------------------------------------------------------------
# Batched mapreduce routes: the zero-extent guard and the non-commutative
# reroute, as the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op_name", ["add", "max", "min"])
@pytest.mark.parametrize("shape", [(0, 5), (3, 0)])
def test_batched_zero_extent_guard_matches_reference(op_name, shape):
    jop, top = getattr(j_alg, op_name.upper()), getattr(t_alg, op_name.upper())
    for dt in (jnp.float32, jnp.int32):
        x = jnp.zeros(shape, dt)
        want = j_forge.mapreduce(lambda v: v, jop, x, layout=JBatched(),
                                 backend="xla")
        got = t_forge.mapreduce(t_alg.IDENTITY, top, _t(x),
                                layout=TBatched())
        assert got.shape == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def _reroute_operand(op_name, rng, shape):
    """make_operand's element; for rows of thousands of quaternions or 2x2
    matrices, elements within 1% of the identity (that still do not
    commute), so that the products stay of size 1 and float32 rounding in
    another association stays below 1e-5 of it."""
    if op_name == "affine" or shape[1] < 1000:
        return make_operand(op_name, rng, shape)
    ident = (1, 0, 0, 0) if op_name == "quaternion_mul" else (1, 0, 0, 1)
    return tuple(jnp.asarray(c + rng.uniform(-0.01, 0.01, shape),
                             jnp.float32) for c in ident)


@pytest.mark.parametrize("op_name", ["quaternion_mul", "mat2_mul", "affine"])
def test_batched_mapreduce_reroutes_non_commutative_ops(op_name,
                                                        monkeypatch):
    """mapreduce@batched with an operator that does not commute scans the
    mapped rows on scan@batched (K7s on the card) and takes each row's last
    element, as the reference's dispatch does; K7m, which folds in no fixed
    order, is never asked.  Held within 1e-5 of each output's size against
    the reference's pallas-interpret and xla routes, at n = 1 and at the
    reference's scan tile (2,048) +-1."""
    calls = []
    for backend in ("torch", "cuda"):
        impl = t_ki._IMPL_REGISTRY[("scan@batched", backend)]

        def spy(*args, _impl=impl, _backend=backend, **kwargs):
            calls.append(_backend)
            return _impl(*args, **kwargs)

        monkeypatch.setitem(t_ki._IMPL_REGISTRY, ("scan@batched", backend),
                            spy)

        def refuse(*args, **kwargs):
            raise AssertionError("mapreduce@batched reached its own impl")

        monkeypatch.setitem(t_ki._IMPL_REGISTRY,
                            ("mapreduce@batched", backend), refuse)
    jop, top = j_alg.STD_OPS[op_name], t_alg.STD_OPS[op_name]
    rng = np.random.default_rng(zlib.crc32(op_name.encode()))
    for B, n in ((1, 1), (3, 7), (2, 2047), (1, 2048), (2, 2049)):
        xs = _reroute_operand(op_name, rng, (B, n))
        # Both reference routes jitted as one program: compiled once per
        # shape, not op by op.
        wants = jax.jit(lambda x: tuple(j_forge.mapreduce(
            lambda t: t, jop, x, layout=JBatched(), backend=b)
            for b in (PI, "xla")))(xs)
        for backend in ("torch", "cuda"):
            del calls[:]
            got = t_forge.mapreduce(t_alg.IDENTITY, top,
                                    jax.tree.map(_t, xs), layout=TBatched(),
                                    backend=backend)
            assert calls == [backend]
            for want in wants:
                for g, w in zip(got, want):
                    g, w = _np(g), np.asarray(w)
                    assert g.shape == w.shape == (B,)
                    size = max(float(np.abs(w).max()), 1.0)
                    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * size,
                                               err_msg=f"{op_name} {B}x{n}")
