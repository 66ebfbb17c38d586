"""The port's segmented ``top_k`` on ragged segments against the JAX
package, bit for bit: k larger than some segments, empty and never-started
segments filled with the identity and index -1, CSR offsets and flags,
float32, int32 and uint32 keys, at 4- and 8-bit digits -- the inputs and
comparisons of ``test_torch_sort.py``, in a file of at most 12 tests so
that ``--dist loadfile`` queues it behind the larger files.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import primitives as j_forge  # noqa: E402
from repro_torch.kernels import sort as sort_k  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_sort import (  # noqa: E402,F401
    DTYPES, N, _keys, _layouts, _same, digit_bits)


@pytest.mark.parametrize("variant", ["offsets", "flags"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_top_k_ragged(variant, dtype, digit_bits):
    """k exceeds some segment lengths; empty and never-started segments
    come back filled with the identity and index -1."""
    n = N
    k = _keys(dtype, n, seed=11)
    jl, tl = _layouts(variant, n)
    for largest in (True, False):
        wv, wi = j_forge.top_k(jnp.asarray(k), 9, largest=largest,
                               layout=jl, backend="xla")
        kw = ({"offsets": tl.offsets} if variant == "offsets" else
              {"flags": tl.flags, "num_segments": 8})
        gv, gi = sort_k.segmented_top_k_radix(
            torch.from_numpy(k), 9, largest=largest, **kw)
        assert gv.shape == wv.shape and gi.dtype == torch.int32
        _same(gv, wv)
        _same(gi, wi)
