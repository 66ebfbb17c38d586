"""The port's quantized GEMVs (K9), flat and batched, against the reference
-- the quantized legs of ``tests/test_conformance.py``'s matvec / vecmat
rows (K9 under max-plus and min-plus, and on CPU tensors:
``test_torch_batched.py``).

Inputs come from numpy with a seed; the same arrays go through the JAX
routes (``backend="pallas-interpret"``, the Pallas kernel bodies, and
``"xla"``) and through the port's ``torch`` and ``cuda`` routes (on the CPU
the cuda wrappers run their plain versions; the card's kernels are held
against those in ``chip_smoke.py``).

Tolerances: the dequantized elements are bit-exact; ADD over TIMES is
held within 1e-5 of sum |x| |a| per output (another summation order)
against the reference, and within ``ref_quantized_*_bound`` (the
integrated half-step error) of the dense result on the unquantized
matrix.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import operators as j_alg  # noqa: E402
from repro.core.layout import Batched as JBatched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core.layout import Batched as TBatched  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_batched import (  # noqa: E402
    PORT_BACKENDS, _assert_close, _np, _ref_routes, _route, _seed, _t)

# The reference's quantize compiled once per (shape, mode, block), not op
# by op; the conformance tests hand its codes and scales to both packages.
_J_QUANTIZE = jax.jit(j_alg.quantize, static_argnames=("mode", "block"))


# ---------------------------------------------------------------------------
# K9: quantized matvec / vecmat, flat and batched
# ---------------------------------------------------------------------------

QUANT_MODES = ["int8", "fp8_e4m3", "fp8_e5m2"]
Q_BLOCK = 32


def _q_shapes(batched):
    b = Q_BLOCK
    if batched:
        return [(0, 5, 4), (2, 0, 4), (1, 1, 1), (2, b - 1, 5), (1, b, 2),
                (2, b + 1, 7), (1, 40, 130)]
    return [(1, 1), (b - 1, 5), (b, 2), (b + 1, 7), (40, 130)]


@pytest.mark.parametrize("layout", ["flat", "batched"])
@pytest.mark.parametrize("form", ["matvec", "vecmat"])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_gemv_conformance(mode, form, layout):
    batched = layout == "batched"
    jl, tl = (JBatched(), TBatched()) if batched else (None, None)
    rng = np.random.default_rng(_seed("q", mode, form, layout))
    for shape in _q_shapes(batched):
        n, p = shape[-2:]
        lead = shape[:-2]
        A = (rng.normal(size=shape) * 0.2).astype(np.float32)
        x = (rng.normal(size=lead + ((n,) if form == "matvec" else (p,)))
             * 0.2).astype(np.float32)
        jq = _J_QUANTIZE(jnp.asarray(A), mode=mode, block=Q_BLOCK)
        tq = convert.quantized_from_jax(np.asarray(jq.values),
                                        np.asarray(jq.scales), jq.block,
                                        jq.mode, "cpu")
        deq = _np(tq.dequantize())
        scale = (np.abs(x)[..., :, None] * np.abs(deq)).sum(-2) if form == \
            "matvec" else (np.abs(deq) * np.abs(x)[..., None, :]).sum(-1)
        err = f"quantized {form}@{layout} {mode} {shape}"
        jf = (lambda u, v: u * v)
        xt = _t(x)
        dense = _route(form, t_alg.TIMES, t_alg.ADD, _t(A), xt, tl, "torch")
        bound = (t_ref.ref_quantized_matvec_bound if form == "matvec"
                 else t_ref.ref_quantized_vecmat_bound)(tq, xt)
        wants = _ref_routes(form, jf, j_alg.ADD, jq, jnp.asarray(x), jl)
        for jb, want in wants.items():
            for tb in PORT_BACKENDS:
                got = _route(form, t_alg.TIMES, t_alg.ADD, tq, xt, tl, tb)
                _assert_close(got, want, scale, False, f"{err} {tb}/{jb}")
                gap = (got - dense).abs()
                assert bool((gap <= bound + 1e-5).all()), (
                    f"{err}: {float(gap.max()):.3e} beyond the bound")
