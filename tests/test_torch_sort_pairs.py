"""The port's flat ``sort_pairs`` (a pytree of values carried with the
keys) and ``top_k`` (ties and float specials, largest and smallest)
against the JAX package, bit for bit: float32 (+-0, +-inf, NaNs), int32
and uint32 keys -- the inputs and comparisons of ``test_torch_sort.py``,
in a file of at most 12 tests so that ``--dist loadfile`` queues it
behind the larger files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import primitives as j_forge  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_sort import DTYPES, N, _keys, _same  # noqa: E402


@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_pairs_flat_carries_a_pytree(dtype):
    k = _keys(dtype, N, seed=2, ties=True)
    vals = np.random.default_rng(3).normal(size=(N, 3)).astype(np.float32)
    iota = np.arange(N, dtype=np.int32)
    for descending in (False, True):
        wk, (wv, wi) = j_forge.sort_pairs(
            jnp.asarray(k), (jnp.asarray(vals), jnp.asarray(iota)),
            descending=descending, backend="xla")
        gk, (gv, gi) = t_forge.sort_pairs(
            torch.from_numpy(k), (torch.from_numpy(vals),
                                  torch.from_numpy(iota)),
            descending=descending)
        for got, want in ((gk, wk), (gv, wv), (gi, wi)):
            _same(got, want, f"{dtype} desc={descending}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
def test_top_k_flat_ties_and_specials(dtype, largest):
    for ties in (False, True):
        k = _keys(dtype, N, seed=5, ties=ties)
        wv, wi = j_forge.top_k(jnp.asarray(k), 17, largest=largest,
                               backend="xla")
        gv, gi = t_forge.top_k(torch.from_numpy(k), 17, largest=largest)
        _same(gv, wv)
        _same(gi, wi)


def test_top_k_nan_ranks_above_inf():
    k = torch.tensor([1.0, float("inf"), float("nan"), -float("inf"), 2.0])
    v, i = t_forge.top_k(k, 2)
    assert torch.isnan(v[0]) and int(i[0]) == 2
    assert torch.isinf(v[1]) and int(i[1]) == 1
