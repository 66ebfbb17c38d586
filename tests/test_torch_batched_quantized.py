"""The port's quantized GEMVs (K9) under other algebras against the JAX
package: max-plus and min-plus over an int8 / fp8 operand, flat and
batched, bit-exact against the reference's xla route -- the harness of
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
    PORT_BACKENDS, Q_BLOCK, QUANT_MODES, _assert_close, _ref_route, _route,
    _seed, _t)


@pytest.mark.parametrize("layout", ["flat", "batched"])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_tropical_bit_exact(mode, layout):
    """A quantized operand under another algebra: max-plus and min-plus
    over the dequantized matrix, bit-exact against the reference's xla
    route (the dequantized elements are the reference's bits, x + a rounds
    once, and MAX / MIN fold in any order).  The Pallas body, interpreted,
    reads 1 ulp off in some outputs: it computes ``x + decode * scale`` in
    one XLA fusion, which can contract into a fused multiply-add; the
    port's kernel rounds the product on its own, as the xla route does."""
    batched = layout == "batched"
    jl, tl = (JBatched(), TBatched()) if batched else (None, None)
    shape = (2, 40, 13) if batched else (40, 13)
    rng = np.random.default_rng(_seed("qt", mode, layout))
    A = rng.normal(size=shape).astype(np.float32)
    jq = j_alg.quantize(jnp.asarray(A), mode=mode, block=Q_BLOCK)
    tq = t_alg.quantize(_t(A), mode=mode, block=Q_BLOCK)
    for form in ("matvec", "vecmat"):
        x = rng.normal(size=shape[:-2] + (
            (40,) if form == "matvec" else (13,))).astype(np.float32)
        for jop, top in ((j_alg.MAX, t_alg.MAX), (j_alg.MIN, t_alg.MIN)):
            want = _ref_route(form, lambda u, v: u + v, jop, jq,
                              jnp.asarray(x), jl, "xla")
            for tb in PORT_BACKENDS:
                got = _route(form, t_alg.PLUS, top, tq, _t(x), tl, tb)
                _assert_close(got, want, None, True,
                              f"{form} {top.name} {mode} {layout}")
