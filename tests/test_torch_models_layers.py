"""The PyTorch port's layers against the JAX package: the RG-LRU's forward
and decode (recurrentgemma-2b), GQA's forward and decode on a local ring
and a global cache (recurrentgemma-2b, gemma2-27b), and the ragged last
KV block of ``blockwise_attention`` -- the float32 smoke harness of
``test_torch_models.py`` (rtol = atol = 1e-4), in a file of at most 12
tests so that ``--dist loadfile`` queues it behind the larger files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    NAME, _close, _f32, _unit_block, _x, one_torch_thread)


@pytest.fixture(scope="module")
def rg_f32():
    return _f32(NAME)


def test_rglru_forward_and_decode_match_reference(rg_f32):
    cfg_j, cfg_t, params_j, params_t = rg_f32
    blk_j, blk_t = _unit_block(params_j, params_t, 0)
    x = _x((2, 61, cfg_j.d_model), 1)
    y_j, c_j = jax.jit(lambda p, x: JR.rglru_forward(
        p, cfg_j, x, return_cache=True))(blk_j["mixer"], jnp.asarray(x))
    y_t, c_t = TR.rglru_forward(blk_t["mixer"], cfg_t, torch.from_numpy(x),
                                return_cache=True)
    _close(y_t, y_j, what="rglru_forward y")
    for key in ("h", "conv"):
        _close(c_t[key], c_j[key], what=f"rglru_forward cache {key}")
    assert c_t["h"].dtype == torch.float32
    x1 = _x((2, 1, cfg_j.d_model), 2)
    yd_j, cd_j = jax.jit(lambda p, x, c: JR.rglru_decode(p, cfg_j, x, c))(
        blk_j["mixer"], jnp.asarray(x1), c_j)
    yd_t, cd_t = TR.rglru_decode(blk_t["mixer"], cfg_t, torch.from_numpy(x1),
                                 c_t)
    _close(yd_t, yd_j, what="rglru_decode y")
    for key in ("h", "conv"):
        _close(cd_t[key], cd_j[key], what=f"rglru_decode cache {key}")


@pytest.mark.parametrize("S", [5, 40])
@pytest.mark.parametrize("name,j,is_local", [
    ("recurrentgemma-2b", 2, True), ("gemma2-27b", 1, False)],
    ids=["recurrentgemma-2b-local", "gemma2-27b-global"])
def test_gqa_forward_and_decode_match_reference(name, j, is_local, S):
    """S = 40 overfills the smoke window of 32: a local ring wraps in
    prefill and keeps wrapping through the decode steps, while a global
    layer's 64-slot cache keeps every position and attends to all of
    them."""
    cfg_j, cfg_t, params_j, params_t = _f32(name)
    blk_j, blk_t = _unit_block(params_j, params_t, j)
    x = _x((2, S, cfg_j.d_model), 3)
    y_j, c_j = jax.jit(lambda p, x: JA.gqa_forward(
        p, cfg_j, x, jnp.arange(S), is_local=is_local, return_cache_len=64))(
        blk_j["attn"], jnp.asarray(x))
    y_t, c_t = TA.gqa_forward(blk_t["attn"], cfg_t, torch.from_numpy(x),
                              is_local=is_local, return_cache_len=64)
    _close(y_t, y_j, what="gqa_forward y")
    for key in ("k", "v"):
        _close(c_t[key], c_j[key], what=f"gqa_forward cache {key}")
    pos = np.array([S, S - 3], np.int32)          # rows at their own depths
    j_decode = jax.jit(lambda p, x, c, pos: JA.gqa_decode(
        p, cfg_j, x, c, pos, is_local=is_local))
    for step in range(3):
        x1 = _x((2, 1, cfg_j.d_model), 10 + step)
        y_j, c_j = j_decode(blk_j["attn"], jnp.asarray(x1), c_j,
                            jnp.asarray(pos + step))
        k_in, v_in = c_t["k"], c_t["v"]
        ptrs = (k_in.data_ptr(), v_in.data_ptr())
        y_t, c_t = TA.gqa_decode(blk_t["attn"], cfg_t, torch.from_numpy(x1),
                                 c_t, torch.from_numpy(pos + step),
                                 is_local=is_local)
        # The slot is written in place: the step returns the input tensors.
        assert c_t["k"] is k_in and c_t["v"] is v_in
        assert (c_t["k"].data_ptr(), c_t["v"].data_ptr()) == ptrs
        _close(y_t, y_j, what=f"gqa_decode step {step}")
        for key in ("k", "v"):
            _close(c_t[key], c_j[key], what=f"gqa_decode cache {key}")


@pytest.mark.parametrize("window", [0, 100])
def test_blockwise_attention_ragged_tail_against_dense(window):
    """T = 513 is one key past a 512-key block.  The port reads the tail
    block [512, 513) at its own positions and matches dense attention; the
    reference's dynamic slice clamps that block back to [1, 513) while its
    mask labels the keys from 512 on (recorded in ROADMAP.md)."""
    T, hd = 513, 8
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, T, 1, 2, hd), (1, T, 1, hd), (1, T, 1, hd)))
    pos = np.arange(T)
    got = TA.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 qpos=torch.from_numpy(pos), window=window)
    s = np.einsum("sgd,td->gst", q[0, :, 0], k[0, :, 0]) / np.sqrt(hd)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= (pos[:, None] - pos[None, :]) < window
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = (p / p.sum(-1, keepdims=True)) @ v[0, :, 0]      # (G, S, hd)
    np.testing.assert_allclose(got[0, :, 0].numpy(),
                               dense.transpose(1, 0, 2), rtol=1e-5,
                               atol=1e-5)
