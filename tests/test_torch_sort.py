"""The PyTorch port's radix-sort family against the JAX package.

``sort``, ``sort_pairs``, ``argsort`` and ``top_k``, each at the flat and
the segmented layout (CSR offsets and flags), go through the reference's
``xla`` backend and through the port (``torch`` backend: the plain versions
of the kernels the composition calls; ``cuda`` backend on CPU tensors runs
the same plain versions through the kernel wrappers).  Inputs come from
numpy with a seed: float32 with +-0, +-inf, NaNs and ties, int32 and
uint32.  Every result is held bit for bit (float keys compared as their
bits, so the canonical NaN and +0.0 are pinned too).  The composition's
digit width is checked at 4 and 8 bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import primitives as j_forge  # noqa: E402
from repro.core.layout import Segmented as JSegmented  # noqa: E402
from repro_torch.core import intrinsics as t_ki  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from repro_torch.core import primitives as t_forge  # noqa: E402
from repro_torch.core.layout import Segmented as TSegmented  # noqa: E402
from repro_torch.kernels import sort as sort_k  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

DTYPES = ["float32", "int32", "uint32"]
OFFSETS = [0, 7, 7, 30, 31, 64, 90]          # empty and length-1 segments
N = OFFSETS[-1]          # one length throughout keeps the reference's
                         # per-shape compilations few


def _keys(dtype, n, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = (rng.integers(-4, 5, n) if ties else rng.normal(size=n)).astype(
            np.float32)
        if n >= 16:
            x[[1, 5, 7, 9, 11, 13, 15]] = [np.nan, -np.nan, np.inf, -np.inf,
                                           0.0, -0.0, np.nan]
        return x
    info = np.iinfo(dtype)
    if ties:
        return rng.integers(0, 9, n).astype(dtype)
    return rng.integers(info.min, int(info.max) + 1, n, dtype=np.int64) \
        .astype(dtype)


def _bits(x):
    """Raw bits of a result (floats as uint32 words), as int64."""
    a = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
    if a.dtype == np.float32:
        a = a.view(np.uint32)
    return a.astype(np.int64)


def _same(got, want, what=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _flags(offsets, n):
    f = np.zeros(n, np.int32)
    for s in offsets[:-1]:
        if s < n:
            f[s] = 1
    return f


def _layouts(variant, n):
    if variant == "offsets":
        off = np.asarray(OFFSETS, np.int32)
        return (JSegmented(offsets=jnp.asarray(off)),
                TSegmented(offsets=torch.from_numpy(off)))
    f = _flags(OFFSETS, n)
    return (JSegmented(flags=jnp.asarray(f), num_segments=8),
            TSegmented(flags=torch.from_numpy(f), num_segments=8))


# ---------------------------------------------------------------------------
# Flat layout
# ---------------------------------------------------------------------------


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


@pytest.fixture(params=[4, 8])
def digit_bits(request, monkeypatch):
    """Runs a test at each radix digit width (``SORT_DIGIT_BITS``)."""
    monkeypatch.setattr(t_ki, "SORT_DIGIT_BITS", request.param)
    return request.param


@pytest.mark.parametrize("dtype", DTYPES)
def test_digit_width_does_not_change_the_result(digit_bits, dtype,
                                                monkeypatch):
    k = _keys(dtype, N, seed=7)
    passes = []
    radix_pass = sort_k._radix_pass
    monkeypatch.setattr(sort_k, "_radix_pass",
                        lambda *a: passes.append(a[2]) or radix_pass(*a))
    want = j_forge.sort(jnp.asarray(k), backend="xla")
    _same(sort_k.sort_radix(torch.from_numpy(k)), want)
    # One scatter pass per digit of the 32-bit keys.
    assert passes == list(range(0, 32, digit_bits))
    wv, wi = j_forge.top_k(jnp.asarray(k), 9, backend="xla")
    gv, gi = sort_k.top_k_radix(torch.from_numpy(k), 9)
    _same(gv, wv)
    _same(gi, wi)


def test_default_digit_width_is_the_h100_value():
    assert t_ki.SORT_DIGIT_BITS == 8


def test_key_bits_fast_path_and_validation():
    rng = np.random.default_rng(6)
    k = rng.integers(0, 13, N).astype(np.uint32)
    want = j_forge.argsort(jnp.asarray(k), key_bits=4, backend="xla")
    _same(t_forge.argsort(torch.from_numpy(k), key_bits=4), want)
    msgs = []
    for call in (lambda: j_forge.sort(jnp.zeros(4, jnp.int32), key_bits=4,
                                      backend="xla"),
                 lambda: t_forge.sort(torch.zeros(4, dtype=torch.int32),
                                      key_bits=4)):
        with pytest.raises(ValueError) as info:
            call()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_zero_length_and_k_bounds():
    k = torch.zeros(0)
    assert t_forge.sort(k).shape == (0,)
    v, i = t_forge.top_k(torch.arange(5, dtype=torch.float32), 0)
    assert v.shape == (0,) and i.shape == (0,) and i.dtype == torch.int32
    with pytest.raises(ValueError, match=r"top_k: need 0 <= k <= n"):
        t_forge.top_k(torch.arange(5, dtype=torch.float32), 6)
    with pytest.raises(TypeError, match="unsupported key dtype"):
        t_forge.sort(torch.zeros(3, dtype=torch.float64))


# ---------------------------------------------------------------------------
# Segmented layout
# ---------------------------------------------------------------------------


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


def test_segmented_descriptor_validation_matches_reference():
    msgs = []
    for call in (
            lambda: j_forge.sort(jnp.zeros(4), layout=JSegmented(),
                                 backend="xla"),
            lambda: t_forge.sort(torch.zeros(4), layout=TSegmented()),
            lambda: j_forge.top_k(jnp.zeros(4), 2, layout=JSegmented(
                flags=jnp.zeros(4, jnp.int32)), backend="xla"),
            lambda: t_forge.top_k(torch.zeros(4), 2, layout=TSegmented(
                flags=torch.zeros(4, dtype=torch.int32)))):
        with pytest.raises(ValueError) as info:
            call()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]


def test_segmented_equality_is_identity():
    off = torch.tensor([0, 2, 4], dtype=torch.int32)
    assert TSegmented(offsets=off) == TSegmented(offsets=off)
    assert TSegmented(offsets=off) != TSegmented(offsets=off.clone())
    assert len({TSegmented(offsets=off), TSegmented(offsets=off)}) == 1


def test_radix_key_transform_round_trips():
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int16,
                  torch.uint8, torch.uint32):
        x = torch.from_numpy(_keys("float32", 64, seed=3)).to(dtype) \
            if dtype.is_floating_point else torch.from_numpy(
                _keys("int32", 64, seed=3)).to(torch.int64).remainder(
                    256 if dtype == torch.uint8 else 2 ** 15).to(dtype)
        bits = t_alg.key_to_radix_bits(x)
        back = t_alg.radix_bits_to_key(bits, dtype)
        assert back.dtype == dtype
        same = (back == x) | (torch.isnan(x) & torch.isnan(back)) \
            if dtype.is_floating_point else back == x
        assert bool(same.all()), dtype
