"""The PyTorch port's dense-config features against the JAX package.

The five configs of this slice (gemma3-4b, minitron-4b, moonshot-v1-16b-a3b,
deepseek-coder-33b, internvl2-76b): their FULL and SMOKE fields; the four
MLP activations (swiglu, geglu, relu, relu2) alone and in the MLP; qk-norm
(gemma3) in ``gqa_forward`` and ``gqa_decode``, local and global; and the
parameter layout that ``convert.params_from_jax`` gives each config.
float32 results are held at rtol = atol = 1e-4 (the jitted reference
orders its products otherwise), relu and relu2 in bfloat16 bit for bit
(one rounding of ``r * r`` in the activation dtype on both sides).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    _close, _f32, _unit_block, _x, one_torch_thread)
from test_torch_models import (  # noqa: E402
    test_params_from_jax_layout_and_dtypes as layout_matches_reference)

DENSE = ("gemma3-4b", "minitron-4b", "moonshot-v1-16b-a3b",
         "deepseek-coder-33b", "internvl2-76b")
ACTIVATIONS = ("swiglu", "geglu", "relu", "relu2")


@pytest.mark.parametrize("name", DENSE)
def test_config_fields_match_reference(name):
    for smoke in (False, True):
        cj = dataclasses.asdict(JC.get_config(name, smoke=smoke))
        ct = dataclasses.asdict(TC.get_config(name, smoke=smoke))
        assert ct == cj


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_activations_match_reference(activation):
    """``_act`` alone (float32; relu and relu2 in bfloat16 too, bit for
    bit) and the MLP (gated for swiglu and geglu, ``_act(g) * h``)."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 2, (3, 5, 16)).astype(np.float32)
    _close(TL._act(activation, torch.from_numpy(x)),
           JL._act(activation, jnp.asarray(x)), dict(rtol=1e-6, atol=1e-6),
           what=f"{activation} float32")
    if activation in ("relu", "relu2"):
        got = TL._act(activation, torch.from_numpy(x).bfloat16())
        want = JL._act(activation, jnp.asarray(x, jnp.bfloat16))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))
    params = jax.eval_shape(lambda k: JL.init_mlp(k, 16, 24, activation),
                            jax.random.PRNGKey(0))
    assert ("w_gate" in params) == (activation in ("swiglu", "geglu"))
    tree = jax.tree.map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), params)
    got = TL.mlp({k: torch.from_numpy(v) for k, v in tree.items()},
                 torch.from_numpy(x), activation)
    want = jax.jit(lambda p, x: JL.mlp(p, x, activation))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    _close(got, want, what=f"mlp {activation}")


@pytest.mark.parametrize("j,is_local", [(0, True), (2, False)],
                         ids=["local", "global"])
def test_qk_norm_gqa_forward_and_decode_match_reference(j, is_local):
    """gemma3-4b's smoke layers (qk-norm, global theta 1e6): S = 40 wraps
    the local ring of 32 in prefill, and decode keeps writing it; q and k
    are normed over head_dim after the projection and before rope."""
    cfg_j, cfg_t, params_j, params_t = _f32("gemma3-4b")
    assert cfg_t.qk_norm and cfg_t.rope_theta_global == 1e6
    blk_j, blk_t = _unit_block(params_j, params_t, j)
    assert {"q_norm", "k_norm"} <= set(blk_t["attn"])
    S = 40
    x = _x((2, S, cfg_j.d_model), 3)
    y_j, c_j = jax.jit(lambda p, x: JA.gqa_forward(
        p, cfg_j, x, jnp.arange(S), is_local=is_local, return_cache_len=64))(
        blk_j["attn"], jnp.asarray(x))
    y_t, c_t = TA.gqa_forward(blk_t["attn"], cfg_t, torch.from_numpy(x),
                              is_local=is_local, return_cache_len=64)
    _close(y_t, y_j, what="gqa_forward y")
    for key in ("k", "v"):
        _close(c_t[key], c_j[key], what=f"gqa_forward cache {key}")
    pos = np.array([S, S - 3], np.int32)
    j_decode = jax.jit(lambda p, x, c, pos: JA.gqa_decode(
        p, cfg_j, x, c, pos, is_local=is_local))
    for step in range(2):
        x1 = _x((2, 1, cfg_j.d_model), 10 + step)
        y_j, c_j = j_decode(blk_j["attn"], jnp.asarray(x1), c_j,
                            jnp.asarray(pos + step))
        y_t, c_t = TA.gqa_decode(blk_t["attn"], cfg_t, torch.from_numpy(x1),
                                 c_t, torch.from_numpy(pos + step),
                                 is_local=is_local)
        _close(y_t, y_j, what=f"gqa_decode step {step}")
        for key in ("k", "v"):
            _close(c_t[key], c_j[key], what=f"gqa_decode cache {key}")


def test_params_layout_and_dtypes_match_reference():
    """Each config's converted tree against the reference's own bf16 tree
    by path (``test_torch_models.py``'s check).  The MoE's ``router`` and
    ``router_bias`` stay float32 by path, as the reference builds them; an
    untied config carries ``embed.unembed``.  The reference builds gemma3's
    ``q_norm`` / ``k_norm`` scales in the weight dtype, the port keeps
    every norm scale in float32: each bf16 value is exact in float32, so
    both compute the same norm."""
    for name in DENSE:
        cfg_j, cfg_t, params_j, params_t = _f32(name)
        layout_matches_reference((cfg_j, cfg_t, params_j, params_t))
        bf = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, "cpu",
                             torch.bfloat16)
        assert ("unembed" in bf["embed"]) == (not cfg_t.tie_embeddings)
        blocks = [*bf["decoder"]["prefix"],
                  *[b for u in bf["decoder"]["units"] for b in u],
                  *bf["decoder"]["suffix"]]
        for blk in blocks:
            attn = blk["attn"]
            assert ("q_norm" in attn) == cfg_t.qk_norm, name
            for norm in ("q_norm", "k_norm"):
                if norm in attn:
                    assert attn[norm]["scale"].dtype == torch.float32
            if "moe" in blk:
                moe = blk["moe"]
                assert moe["router"].dtype == torch.float32
                assert moe["router_bias"].dtype == torch.float32
                assert moe["w_in"].dtype == torch.bfloat16
                assert moe["shared"]["w_gate"].dtype == torch.bfloat16
        assert any("moe" in b for b in blocks) == bool(cfg_t.n_experts)
