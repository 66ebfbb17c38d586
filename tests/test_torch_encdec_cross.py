"""Cross attention of the PyTorch port's encoder-decoder
(seamless-m4t-medium) against the JAX package.

The float32 smoke config's first decoder layer, its parameters numpy
draws in the reference's tree handed to both packages (the harness of
``test_torch_models.py``), the inputs numpy draws from a seed, the
reference jitted: ``cross_forward`` (no rope, no qk-norm, every query
over every source frame) on the torch backend's ``blockwise_attention``
and on K10's route, with and without a valid source length, and
``cross_decode`` over a bf16 cache, within rtol = atol = 1e-4 (float32
sums in another order); ``cross_build_cache`` in bf16 equal to the bit.
Sources stay at or under 512 frames: past that the reference's
``blockwise_attention`` misreads a ragged last KV block (ROADMAP.md).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.core import intrinsics as ki  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from test_torch_models import _close, _f32, _x  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

NAME = "seamless-m4t-medium"


def _cross(params_j, params_t):
    """Cross attention's parameters of the first decoder layer."""
    return (jax.tree.map(lambda l: l[0],
                         params_j["decoder"]["units"][0]["cross"]),
            params_t["decoder"]["units"][0][0]["cross"])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("valid", [None, 23])
def test_cross_forward_matches_reference(backend, valid):
    """24 decoder queries over 37 source frames (``enc_valid_len`` None, or
    the first 23 frames): the torch backend's ``blockwise_attention`` and
    K10's route (its plain version, as ``use_backend("cuda")`` reaches it
    on the CPU, over k and v cut to the valid frames)."""
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    pj, pt = _cross(params_j, params_t)
    x = _x((2, 24, cfg_j.d_model), 2)
    enc = _x((2, 37, cfg_j.d_model), 3)
    want = jax.jit(lambda p, x, e: JA.cross_forward(
        p, cfg_j, x, e, enc_valid_len=valid))(pj, jnp.asarray(x),
                                              jnp.asarray(enc))
    with ki.use_backend(backend):
        got = TA.cross_forward(pt, cfg_t, torch.from_numpy(x),
                               torch.from_numpy(enc), enc_valid_len=valid)
    _close(got, want, what=f"cross_forward {backend} valid={valid}")


def test_cross_build_cache_bf16_equal_to_the_bit():
    """k and v over the 37 source frames, (B, T, K, hd), bf16 from float32
    activations.  Weights and frames are multiples of 1/16 in [-1, 1], so
    each float32 product and sum is exact and both packages round the same
    number to bf16."""
    cfg_j, cfg_t, params_j, _ = _f32(NAME)
    rng = np.random.default_rng(4)
    pj = {k: rng.integers(-16, 17, np.shape(v)[1:]).astype(np.float32) / 16
          for k, v in params_j["decoder"]["units"][0]["cross"].items()}
    enc = rng.integers(-16, 17, (2, 37, cfg_j.d_model)).astype(np.float32) / 16
    want = JA.cross_build_cache(jax.tree.map(jnp.asarray, pj), cfg_j,
                                jnp.asarray(enc))
    got = TA.cross_build_cache({k: torch.from_numpy(v) for k, v in pj.items()},
                               cfg_t, torch.from_numpy(enc))
    assert sorted(got) == sorted(want) == ["k", "v"]
    for key in got:
        assert got[key].dtype == torch.bfloat16
        assert tuple(got[key].shape) == want[key].shape == (
            2, 37, cfg_t.n_kv_heads, cfg_t.head_dim)
        np.testing.assert_array_equal(
            got[key].view(torch.int16).numpy(),
            np.asarray(want[key]).view(np.int16), err_msg=key)


def test_cross_decode_matches_reference():
    """One query a row over every frame of a bf16 cross cache."""
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    pj, pt = _cross(params_j, params_t)
    enc = _x((2, 37, cfg_j.d_model), 5)
    x = _x((2, 1, cfg_j.d_model), 6)
    cj = JA.cross_build_cache(pj, cfg_j, jnp.asarray(enc))
    ct = TA.cross_build_cache(pt, cfg_t, torch.from_numpy(enc))
    want = jax.jit(lambda p, x, c: JA.cross_decode(p, cfg_j, x, c))(
        pj, jnp.asarray(x), cj)
    got = TA.cross_decode(pt, cfg_t, torch.from_numpy(x), ct)
    _close(got, want, what="cross_decode")
