"""The port's batched GEMVs (K7) on integer-valued data against the
reference: ADD, MAX, MIN and MUL over TIMES, int32 and float32, matvec and
vecmat, bit-exact against the reference's xla route (jitted: integer
terms, so a fused multiply-add rounds nothing) -- the harness of
``test_torch_batched.py``, in a file of at most 12 tests so that ``--dist
loadfile`` queues it behind the larger files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import operators as j_alg  # noqa: E402
from repro.core.layout import Batched as JBatched  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core.layout import Batched as TBatched  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_batched import (  # noqa: E402
    PORT_BACKENDS, _assert_close, _ref_route, _route, _seed, _t)


@pytest.mark.parametrize("form", ["matvec", "vecmat"])
@pytest.mark.parametrize("op_name", ["add", "max", "min", "mul"])
def test_batched_gemv_int32_bit_exact(op_name, form):
    """Integer-valued data: every operator bit-exact, int32 and f32."""
    rng = np.random.default_rng(_seed("bmvi", op_name, form))
    jop, top = getattr(j_alg, op_name.upper()), getattr(t_alg, op_name.upper())
    for dt in (np.int32, np.float32):
        A = rng.integers(-3, 4, (3, 37, 70)).astype(dt)
        x = rng.integers(-3, 4, (3, 37 if form == "matvec" else 70)).astype(dt)
        jf = (lambda u, v: u * v)
        # Jitted: integer-valued terms, so a fused multiply-add rounds
        # nothing, and the result stays bit-exact.
        want = _ref_route(form, jf, jop, jnp.asarray(A), jnp.asarray(x),
                          JBatched(), "xla", jit=True)
        for tb in PORT_BACKENDS:
            got = _route(form, t_alg.TIMES, top, _t(A), _t(x), TBatched(), tb)
            _assert_close(got, want, None, True, f"{form} {op_name} {dt}")
