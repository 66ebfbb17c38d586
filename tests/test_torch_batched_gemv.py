"""The port's batched GEMVs (K7) against the reference: the matvec /
vecmat rows of ``tests/test_conformance.py``'s matrix (ADD, MIN and the
non-commutative 2x2 shear under MAT2_MUL) at zero extents, tiny shapes and
the reference's row tile +-1, against both reference routes (the Pallas
body interpreted, and xla) and the port's plain oracle -- the harness of
``test_torch_batched.py``, in a file of at most 12 tests so that ``--dist
loadfile`` queues it behind the larger files.  MIN is bit-exact; ADD and
the shear within 1e-5 of sum |x| |a| per output.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.layout import Batched as JBatched  # noqa: E402
from repro_torch.core.layout import Batched as TBatched  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_batched import (  # noqa: E402
    MV_CASES, PORT_BACKENDS, _assert_close, _mv_shapes, _ref_routes, _route,
    _seed, _t)


@pytest.mark.parametrize("form", ["matvec", "vecmat"])
@pytest.mark.parametrize("case", sorted(MV_CASES))
def test_batched_gemv_conformance(case, form):
    (jf_mv, jf_vm, jop), (tf_mv, tf_vm, top) = MV_CASES[case]
    jf, tf = (jf_mv, tf_mv) if form == "matvec" else (jf_vm, tf_vm)
    rng = np.random.default_rng(_seed("bmv", case, form))
    for B, n, p in _mv_shapes():
        A = (rng.normal(size=(B, n, p)) * 0.2).astype(np.float32)
        x = (rng.normal(size=(B, n if form == "matvec" else p)) * 0.2
             ).astype(np.float32)
        # sum |x| |a| per output: the size of an ADD (or shear) result.
        scale = (np.abs(x)[:, :, None] * np.abs(A)).sum(1) if form == \
            "matvec" else (np.abs(A) * np.abs(x)[:, None, :]).sum(2)
        err = f"{form}@batched {case} {B}x{n}x{p}"
        oracle = (t_ref.ref_batched_matvec if form == "matvec"
                  else t_ref.ref_batched_vecmat)(tf, top, _t(A), _t(x))
        wants = _ref_routes(form, jf, jop, jnp.asarray(A), jnp.asarray(x),
                            JBatched())
        for jb, want in wants.items():
            for tb in PORT_BACKENDS:
                got = _route(form, tf, top, _t(A), _t(x), TBatched(), tb)
                _assert_close(got, want, scale, case == "min",
                              f"{err} {tb} vs {jb}")
        _assert_close(oracle, want, scale, case == "min", f"{err} oracle")
