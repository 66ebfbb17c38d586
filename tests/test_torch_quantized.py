"""The port's quantization codecs against the reference's
(``tests/test_quantized.py``'s contracts, and bit-exactness).

Inputs come from numpy with a seed; the same arrays go through
``repro.core.operators`` and ``repro_torch.core.operators``.  Everything
here is exact: codes, scales, dequantized values, error bounds and the fp8
field codec agree bit for bit, so every comparison is ``array_equal``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import operators as j_alg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import operators as t_alg  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from torch.utils import _pytree as pytree  # noqa: E402

QUANT_MODES = ["int8", "fp8_e4m3", "fp8_e5m2"]
SHAPES = [(1, 1), (31, 3), (32, 4), (33, 5), (2, 40, 7)]


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _mixed(rng, shape):
    """Wildly mixed magnitudes, as the reference's codec tests use."""
    return (rng.normal(size=shape) * rng.uniform(0.01, 10.0, shape)).astype(
        np.float32)


def test_modes_and_formats_match_reference():
    assert t_alg.QUANT_MODES == j_alg.QUANT_MODES
    assert t_alg.FP8_FORMATS == j_alg.FP8_FORMATS
    assert set(t_alg.QUANT_DEVICE) == set(t_alg.QUANT_MODES)
    for mode in ("fp8_e4m3", "fp8_e5m2"):
        assert t_alg._fp8_max_code(mode) == j_alg._fp8_max_code(mode)


@pytest.mark.parametrize("mode", QUANT_MODES[:1])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bit_exact_against_reference(mode, shape):
    """int8 here; the fp8 modes in ``test_torch_quantized_fp8.py``, a file
    of at most 12 tests, which ``--dist loadfile`` queues behind the larger
    files (the reference compiles its fp8 codec per shape, some 3 s a
    test)."""
    bit_exact_against_reference(mode, shape)


def bit_exact_against_reference(mode, shape):
    """Codes, scales, dequantized values and the error bound, bit for bit,
    across block-boundary shapes (block 32) and a batch rank."""
    A = _mixed(np.random.default_rng(len(shape) * 100 + shape[-2]), shape)
    jq = j_alg.quantize(jnp.asarray(A), mode=mode, block=32)
    tq = t_alg.quantize(torch.from_numpy(A), mode=mode, block=32)
    assert tq.shape == A.shape and tq.qtag == jq.qtag == f"{mode}q32"
    assert tq.dtype == torch.float32
    for got, want in ((tq.values, jq.values), (tq.scales, jq.scales),
                      (tq.decoded(), jq.decoded()),
                      (tq.dequantize(), jq.dequantize()),
                      (tq.error_bound(), jq.error_bound())):
        g, w = _np(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantize_within_error_bound(mode):
    """|dequantize(quantize(A)) - A| <= error_bound(), elementwise."""
    rng = np.random.default_rng(5)
    for shape in SHAPES:
        A = torch.from_numpy(_mixed(rng, shape))
        q = t_alg.quantize(A, mode=mode, block=32)
        err = (q.dequantize() - A).abs()
        assert bool((err <= q.error_bound() + 1e-7).all()), (mode, shape)


@pytest.mark.parametrize("mode", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_field_codec_bit_exact(mode):
    """Every one of the 256 codes decodes to the reference's bits (e4m3
    0x7F to 480: every code is finite), and the encoder rounds random
    values, zeros, tiny values and out-of-range values to the same codes."""
    u = np.arange(256, dtype=np.uint8)
    want = np.asarray(j_alg.fp8_decode(jnp.asarray(u), mode))
    got = _np(t_alg.fp8_decode(torch.from_numpy(u), mode))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if mode == "fp8_e4m3":
        assert got[0x7F] == 480.0
    x = (np.random.default_rng(3).normal(size=4000) * 100).astype(np.float32)
    x[:6] = [0.0, -0.0, 1e-30, -1e-3, 448.0 * 3, -1e6]
    np.testing.assert_array_equal(
        _np(t_alg.fp8_encode(torch.from_numpy(x), mode)),
        np.asarray(j_alg.fp8_encode(jnp.asarray(x), mode)))


@pytest.mark.parametrize("mode", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_codes_are_canonical(mode):
    """encode(decode(code)) == code for every code quantize emits."""
    A = torch.from_numpy(
        (np.random.default_rng(11).normal(size=(64, 5)) * 3.0).astype(
            np.float32))
    q = t_alg.quantize(A, mode=mode, block=16)
    re = t_alg.fp8_encode(t_alg.fp8_decode(q.values, mode), mode)
    assert torch.equal(re, q.values)


def test_quantized_pytree_round_trip():
    """(values, scales) are the leaves -- the same rank, so the registry's
    rank checks see them -- and (block, mode) survive as context."""
    A = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    q = t_alg.quantize(A, mode="fp8_e5m2", block=4)
    leaves, spec = pytree.tree_flatten(q)
    assert [l.ndim for l in leaves] == [2, 2]
    assert leaves[0] is q.values and leaves[1] is q.scales
    q2 = pytree.tree_unflatten(leaves, spec)
    assert isinstance(q2, t_alg.Quantized)
    assert (q2.mode, q2.block) == ("fp8_e5m2", 4)
    assert torch.equal(q2.dequantize(), q.dequantize())
    moved = pytree.tree_map(lambda l: l.clone(), q)
    assert (moved.mode, moved.block) == (q.mode, q.block)
    assert torch.equal(moved.values, q.values)


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_kv_quant_round_trip_and_pytree(mode):
    """Per-vector KV codec: bit-exact against the reference, within the
    mode's half-step bound, and a (values, scales) pytree node with its
    static mode."""
    x = (np.random.default_rng(17).normal(size=(2, 6, 3, 8)) * 2.0).astype(
        np.float32)
    jkv = j_alg.quantize_kv(jnp.asarray(x), mode)
    kv = t_alg.quantize_kv(torch.from_numpy(x), mode)
    assert kv.shape == x.shape
    for got, want in ((kv.values, jkv.values), (kv.scales, jkv.scales),
                      (kv.dequantize(), jkv.dequantize())):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert kv.dequantize(torch.float64).dtype == torch.float64
    err = (kv.dequantize() - torch.from_numpy(x)).abs()
    if mode == "int8":
        bound = 0.5 * kv.scales
    else:
        man = t_alg.FP8_FORMATS[mode][1]
        bound = torch.from_numpy(x).abs() * (2.0 ** -man) + kv.scales
    assert bool((err <= bound + 1e-6).all())
    leaves, spec = pytree.tree_flatten(kv)
    kv2 = pytree.tree_unflatten(leaves, spec)
    assert kv2.mode == mode and len(leaves) == 2


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_from_jax_holds_the_same_operand(mode):
    A = _mixed(np.random.default_rng(23), (2, 33, 5))
    jq = j_alg.quantize(jnp.asarray(A), mode=mode, block=32)
    tq = convert.quantized_from_jax(np.asarray(jq.values),
                                    np.asarray(jq.scales), jq.block, jq.mode,
                                    "cpu")
    mine = t_alg.quantize(torch.from_numpy(A), mode=mode, block=32)
    assert (tq.block, tq.mode) == (32, mode)
    assert torch.equal(tq.values, mine.values)
    assert torch.equal(tq.scales, mine.scales)
    np.testing.assert_array_equal(_np(tq.dequantize()),
                                  np.asarray(jq.dequantize()))
    with pytest.raises(ValueError, match="codes are"):
        convert.quantized_from_jax(np.zeros((2, 2), np.float32),
                                   np.ones((1, 2), np.float32), 32, mode,
                                   "cpu")


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kwargs", [dict(mode="int4"), dict(block=0)])
def test_quantize_validation_texts_match_reference(kwargs):
    A = np.ones((4, 4), np.float32)
    assert _message(lambda: t_alg.quantize(torch.from_numpy(A), **kwargs)) \
        == _message(lambda: j_alg.quantize(jnp.asarray(A), **kwargs))
    if "mode" in kwargs:
        assert _message(lambda: t_alg.quantize_kv(torch.from_numpy(A),
                                                  kwargs["mode"])) \
            == _message(lambda: j_alg.quantize_kv(jnp.asarray(A),
                                                  kwargs["mode"]))


def test_device_decode_fragments_name_each_mode():
    """Each mode's decode reads its own code type.  The fp8 decodes move
    the fields into float32's positions (mantissa shifted by 23 - man) and
    rebias by 2^(127 - bias), with no hardware conversion; the same
    arithmetic in numpy float32 gives the codec's bits for all 256 codes."""
    assert t_alg.QUANT_DEVICE["int8"][0] == torch.int8
    c = np.arange(-128, 128).astype(np.int8)
    word = (c.view(np.uint8).astype(np.uint32) ^ 0x80) | 0x4B000000
    np.testing.assert_array_equal(
        word.view(np.float32) - np.float32(8388736.0), c.astype(np.float32))
    for mode, (man_bits, bias) in (("fp8_e4m3", (3, 7)),
                                   ("fp8_e5m2", (2, 15))):
        code, body = t_alg.QUANT_DEVICE[mode]
        assert code == torch.uint8
        assert f"<< {23 - man_bits}" in body
        assert float(2.0 ** (127 - bias)).hex() in body
        assert "__nv_fp8" not in body and "__fmul_rn" in body
        b = np.arange(256, dtype=np.uint32)
        bits = ((b & 0x80) << 24) | ((b & 0x7F) << (23 - man_bits))
        got = bits.view(np.float32) * np.float32(2.0 ** (127 - bias))
        want = _np(t_alg.fp8_decode(torch.arange(256).to(torch.uint8), mode))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
