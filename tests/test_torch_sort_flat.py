"""The port's flat ``sort`` and ``argsort`` against the JAX package, bit
for bit: float32 (+-0, +-inf, NaNs), int32 and uint32 keys, ascending and
descending, on the ``torch`` and ``cuda`` backends (the cuda wrappers run
their plain versions on CPU tensors) -- the inputs and comparisons of
``test_torch_sort.py``, in a file of at most 12 tests so that ``--dist
loadfile`` queues it behind the larger files.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import primitives as j_forge  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_sort import DTYPES, N, _keys, _same  # noqa: E402


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sort_and_argsort_flat_bit_exact(dtype, descending, backend):
    k = _keys(dtype, N, seed=1)
    jk, tk = jnp.asarray(k), torch.from_numpy(k)
    _same(t_forge.sort(tk, descending=descending, backend=backend),
          j_forge.sort(jk, descending=descending, backend="xla"), dtype)
    got = t_forge.argsort(tk, descending=descending, backend=backend)
    assert got.dtype == torch.int32
    _same(got, j_forge.argsort(jk, descending=descending, backend="xla"))
