"""The port's segmented sort family against the JAX package, bit for bit:
``sort``, ``argsort`` and ``sort_pairs`` at the segmented layout (CSR
offsets and flags, empty and length-1 segments) for float32 (+-0, +-inf,
NaNs), int32 and uint32 keys, and the sampling path's segmented ``top_k``
on both backends -- the inputs and comparisons of ``test_torch_sort.py``,
in a file of at most 12 tests so that ``--dist loadfile`` queues it behind
the larger files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import primitives as j_forge  # noqa: E402
from repro.core.layout import Segmented as JSegmented  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.core.layout import Segmented as TSegmented  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_sort import DTYPES, N, _keys, _layouts, _same  # noqa: E402


@pytest.mark.parametrize("variant", ["offsets", "flags"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_sort_family_bit_exact(variant, dtype):
    n = N
    k = _keys(dtype, n, seed=9)
    jl, tl = _layouts(variant, n)
    jk, tk = jnp.asarray(k), torch.from_numpy(k)
    for descending in (False, True):
        _same(t_forge.sort(tk, descending=descending, layout=tl),
              j_forge.sort(jk, descending=descending, layout=jl,
                           backend="xla"))
        _same(t_forge.argsort(tk, descending=descending, layout=tl),
              j_forge.argsort(jk, descending=descending, layout=jl,
                              backend="xla"))
    iota = np.arange(n, dtype=np.int32)
    wk, wv = j_forge.sort_pairs(jk, jnp.asarray(iota), layout=jl,
                                backend="xla")
    gk, gv = t_forge.sort_pairs(tk, torch.from_numpy(iota), layout=tl)
    _same(gk, wk)
    _same(gv, wv)


def test_segmented_top_k_sampling_shape():
    """The sampling path's call: (B V,) float32 logits, offsets b V."""
    B, V = 3, N // 3
    rng = np.random.default_rng(12)
    flat = rng.normal(size=B * V).astype(np.float32)
    off = (np.arange(B + 1) * V).astype(np.int32)
    wv, wi = j_forge.top_k(jnp.asarray(flat), 9,
                           layout=JSegmented(offsets=jnp.asarray(off)),
                           backend="xla")
    for backend in ("torch", "cuda"):
        gv, gi = t_forge.top_k(torch.from_numpy(flat), 9,
                               layout=TSegmented(offsets=torch.from_numpy(
                                   off)), backend=backend)
        _same(gv, wv)
        _same(gi, wi)
