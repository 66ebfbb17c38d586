"""Decode at one position for an aligned batch (the padded path's
``decode_step``) in the PyTorch port against the JAX package.

The reference's ``gqa_decode`` and ``mla_decode`` take ``pos`` as a (B,)
vector (continuous batching) or as one scalar for every row, and write
the step's slot with ``dynamic_update_slice`` in the scalar branch.  Held
here, float32 smoke widths, the same numpy parameters and inputs in both
packages, the reference jitted: gemma2-27b's local layer (a ring of 32
slots, which the steps run past) and global layer, and deepseek-v3's MLA
layer, several steps at one position from a prefilled cache, outputs and
caches within rtol = atol = 1e-5 (float32 sums in another order); and
the port's ``decode_step`` at one position, which it fills into a (B,)
vector on entry, equal to the bit to the same step given that vector, on
both models.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    _close, _f32, _unit_block, _x, one_torch_thread)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("j,is_local", [(0, True), (1, False)])
def test_gqa_decode_at_one_position_matches_reference(j, is_local):
    """gemma2-27b smoke's local (j = 0) and global (j = 1) attention: a
    prefill of 28 positions, then eight steps at positions 28 to 35 (the
    local ring of 32 slots wraps at 32): outputs and caches."""
    cfg_j, cfg_t, params_j, params_t = _f32("gemma2-27b")
    blk_j, blk_t = _unit_block(params_j, params_t, j)
    x = _x((2, 28, cfg_j.d_model), 1)
    _, cj = JA.gqa_forward(blk_j["attn"], cfg_j, jnp.asarray(x),
                           jnp.arange(28), is_local=is_local,
                           return_cache_len=64)
    _, ct = TA.gqa_forward(blk_t["attn"], cfg_t, torch.from_numpy(x),
                           is_local=is_local, return_cache_len=64)
    j_decode = jax.jit(lambda p, c, x, pos: JA.gqa_decode(
        p, cfg_j, x, c, pos, is_local=is_local))
    for step in range(8):
        xs = _x((2, 1, cfg_j.d_model), 10 + step)
        yj, cj = j_decode(blk_j["attn"], cj, jnp.asarray(xs),
                          jnp.asarray(28 + step, jnp.int32))
        yt, ct = TA.gqa_decode(blk_t["attn"], cfg_t, torch.from_numpy(xs),
                               ct, 28 + step, is_local=is_local)
        _close(yt, yj, TOL, what=f"step {step} output")
        for key in ct:
            _close(ct[key], cj[key], TOL, what=f"step {step} cache {key}")


def test_mla_decode_at_one_position_matches_reference():
    """deepseek-v3-671b smoke's MLA layer: a prefill of 40 positions, then
    three steps at positions 40 to 42, given as a 0-d tensor: outputs and
    the latent cache."""
    cfg_j, cfg_t, params_j, params_t = _f32("deepseek-v3-671b")
    blk_j = params_j["decoder"]["prefix"][0]
    blk_t = params_t["decoder"]["prefix"][0]
    x = _x((2, 40, cfg_j.d_model), 2)
    _, cj = JA.mla_forward(blk_j["attn"], cfg_j, jnp.asarray(x),
                           jnp.arange(40), return_cache_len=64)
    _, ct = TA.mla_forward(blk_t["attn"], cfg_t, torch.from_numpy(x),
                           return_cache_len=64)
    j_decode = jax.jit(lambda p, c, x, pos: JA.mla_decode(p, cfg_j, x, c,
                                                          pos))
    for step in range(3):
        xs = _x((2, 1, cfg_j.d_model), 20 + step)
        yj, cj = j_decode(blk_j["attn"], cj, jnp.asarray(xs),
                          jnp.asarray(40 + step, jnp.int32))
        yt, ct = TA.mla_decode(blk_t["attn"], cfg_t, torch.from_numpy(xs),
                               ct, torch.tensor(40 + step))
        _close(yt, yj, TOL, what=f"step {step} output")
        for key in ct:
            _close(ct[key], cj[key], TOL, what=f"step {step} cache {key}")


@pytest.mark.parametrize("name", ["gemma2-27b", "deepseek-v3-671b"])
def test_decode_step_one_position_equals_its_vector(name):
    """A decode step after a prefill of 40 tokens, at position 40 as an
    int and as a (B,) vector of 40s: the same logits and caches to the
    bit."""
    _, cfg_t, _, params_t = _f32(name)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(
        rng.integers(0, cfg_t.vocab_size, (2, 41)).astype(np.int64))
    runs = []
    for pos in (40, torch.full((2,), 40, dtype=torch.int32)):
        _, caches = tlm.prefill(params_t, cfg_t, toks[:, :40], cache_len=64)
        logits, caches = tlm.decode_step(params_t, cfg_t, caches,
                                         toks[:, 40:], pos)
        runs.append((logits, caches))
    (la, ca), (lb, cb) = runs
    assert torch.equal(la, lb)
    leaves_a = torch.utils._pytree.tree_leaves(ca)
    leaves_b = torch.utils._pytree.tree_leaves(cb)
    assert len(leaves_a) == len(leaves_b)
    assert all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))


def test_decode_rejects_a_position_of_another_shape():
    """A position that is neither one number nor a (B,) vector raises."""
    _, cfg_t, _, params_t = _f32("gemma2-27b")
    blk_t = params_t["decoder"]["units"][0][1]["attn"]
    cache = TA.init_gqa_cache(cfg_t, 2, 64, False, torch.float32, "cpu")
    with pytest.raises(ValueError, match="position"):
        TA.gqa_decode(blk_t, cfg_t, torch.zeros(2, 1, cfg_t.d_model), cache,
                      torch.zeros(2, 1, dtype=torch.int32), is_local=False)
