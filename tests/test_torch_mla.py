"""The PyTorch port's MLA (deepseek-v3's latent attention) and K10's value
head dim against the JAX package.

At deepseek-v3-671b's float32 smoke widths (4 heads, q-LoRA 32, kv-LoRA
16, nope 16, rope 8, v 16), with the same numpy parameters and inputs in
both packages and the reference jitted: ``_mla_q`` and ``_mla_ckv``;
``mla_forward``'s output and latent cache on both prefill routes (the
torch backend's ``blockwise_attention`` and K10's, whose plain version
runs here); three ``mla_decode`` steps with the slots at different
depths, each writing its slot of the cache in place.  All within 1e-5
(float32 sums in another order).  K10's plain version with a value head
narrower than q's against the reference's ``blockwise_attention``: 1e-5
in float32, each output row within 2^-7 of its norm in bfloat16 (one bf16
step of each element at most; q/k are 64 wide, so the scale 1/8 is exact
and the reference's rounding of ``q * scale`` to bf16, where K10 scales
the float32 scores, adds nothing).  K10's generated units and its host
path with v's own width (tensors that say they lie on the card, and a
stand-in library that records the entry call).  Prompts stay at 40
tokens: past 512 the reference's ``blockwise_attention`` misreads a
ragged last KV block (ROADMAP.md).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.core import intrinsics as ki  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import flash_attention as flash_k  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from test_torch_models import _close, _x, one_torch_thread  # noqa: E402,F401
from test_torch_primitives import _Entries, _OnCard  # noqa: E402

NAME = "deepseek-v3-671b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mla():
    """The float32 smoke configs and one MLA layer's parameters, drawn
    with numpy in the reference's tree, in both packages."""
    cfg_j = dataclasses.replace(JC.get_config(NAME, smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config(NAME, smoke=True),
                                dtype="float32")
    shapes = jax.eval_shape(lambda k: JA.init_mla(k, cfg_j),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    tree = jax.tree.map(
        lambda s: rng.normal(0.0, 0.2, s.shape).astype(np.float32), shapes)
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


def test_mla_q_and_ckv_match_reference(mla):
    """The q-LoRA path (rmsnorm of the latent, up-projection, rope on the
    last 8 dims) and the KV latent with its shared rope key."""
    cfg_j, cfg_t, pj, pt = mla
    x = _x((2, 40, cfg_j.d_model), 1)
    pos = np.arange(40)

    @jax.jit
    def ref_parts(p, x):
        return (*JA._mla_q(p, cfg_j, x, jnp.asarray(pos), x.dtype),
                *JA._mla_ckv(p, cfg_j, x, jnp.asarray(pos), x.dtype))

    want = ref_parts(pj, jnp.asarray(x))
    xt, post = torch.from_numpy(x), torch.from_numpy(pos)
    got = (*TA._mla_q(pt, cfg_t, xt, post, xt.dtype),
           *TA._mla_ckv(pt, cfg_t, xt, post, xt.dtype))
    for name, g, w in zip(("q_nope", "q_rope", "ckv", "k_rope"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, TOL, what=name)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_mla_forward_and_latent_cache_match_reference(mla, backend):
    """The prefill on the torch backend's ``blockwise_attention`` and on
    K10's route (its plain version, as on the CPU ``use_backend("cuda")``
    reaches it): output within 1e-5, and the cache holds ``ckv`` and
    ``krope`` at [0, 40) of 64 slots, zeros after."""
    cfg_j, cfg_t, pj, pt = mla
    x = _x((2, 40, cfg_j.d_model), 2)
    yj, cj = jax.jit(lambda p, x: JA.mla_forward(
        p, cfg_j, x, jnp.arange(40), return_cache_len=64))(pj, jnp.asarray(x))
    with ki.use_backend(backend):
        yt, ct = TA.mla_forward(pt, cfg_t, torch.from_numpy(x),
                                return_cache_len=64)
    _close(yt, yj, TOL, what="mla_forward output")
    assert sorted(ct) == sorted(cj) == ["ckv", "krope"]
    for key in ct:
        assert tuple(ct[key].shape) == cj[key].shape
        _close(ct[key], cj[key], TOL, what=f"cache {key}")
        assert not ct[key][:, 40:].any()


def test_mla_decode_steps_match_reference(mla):
    """Three absorbed decode steps from a prefilled cache, the two slots at
    positions 40 and 23: the outputs and the cache within 1e-5; each step
    writes its slot into the cache's own tensors in place."""
    cfg_j, cfg_t, pj, pt = mla
    x = _x((2, 40, cfg_j.d_model), 3)
    _, cj = JA.mla_forward(pj, cfg_j, jnp.asarray(x), jnp.arange(40),
                           return_cache_len=64)
    _, ct = TA.mla_forward(pt, cfg_t, torch.from_numpy(x),
                           return_cache_len=64)
    tensors = (ct["ckv"], ct["krope"])
    j_decode = jax.jit(lambda p, c, x, pos: JA.mla_decode(p, cfg_j, x, c,
                                                          pos))
    pos = np.array([40, 23], np.int32)
    for step in range(3):
        xs = _x((2, 1, cfg_j.d_model), 10 + step)
        yj, cj = j_decode(pj, cj, jnp.asarray(xs), jnp.asarray(pos + step))
        yt, ct = TA.mla_decode(pt, cfg_t, torch.from_numpy(xs), ct,
                               torch.from_numpy(pos + step))
        _close(yt, yj, TOL, what=f"decode step {step}")
        for key in ct:
            _close(ct[key], cj[key], TOL, what=f"step {step} cache {key}")
        assert (ct["ckv"], ct["krope"]) == tensors


def test_mla_decode_takes_a_position_vector_only(mla):
    """The scalar-position branch of the reference (an aligned batch) is
    not in the port: a scalar raises, as ``gqa_decode``'s does."""
    _, cfg_t, _, pt = mla
    cache = TA.init_mla_cache(cfg_t, 2, 64, torch.float32, "cpu")
    with pytest.raises(ValueError, match=r"\(B,\) position vector"):
        TA.mla_decode(pt, cfg_t, torch.zeros(2, 1, cfg_t.d_model), cache,
                      torch.tensor(5))


def _qkv(shape_q, T, dv, dtype, seed):
    B, S, K, G, hd = shape_q
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in (shape_q, (B, T, K, hd), (B, T, K, dv))]


@pytest.mark.parametrize("shape_q,dv", [
    ((1, 40, 4, 1, 64), 48),        # MLA's layout: one query head per kv
    ((2, 37, 2, 3, 64), 16),        # GQA groups, a narrow value head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_plain_version_with_value_head_dim_matches_blockwise(
        shape_q, dv, dtype):
    """K10's plain version (``flash_attention_gqa`` on CPU tensors) with v
    narrower than q and k, causal, against the reference's
    ``blockwise_attention``, which takes v at its own width too; the
    output is v's width.  float32 within 1e-5; bfloat16 each output row
    within 2^-7 of its norm."""
    q, k, v = _qkv(shape_q, shape_q[1], dv, dtype, 5)
    S = shape_q[1]
    got = flash_k.flash_attention_gqa(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    want = jax.jit(lambda q, k, v: JA.blockwise_attention(
        q, k, v, qpos=jnp.arange(S), causal=True))(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)))
    assert tuple(got.shape) == shape_q[:4] + (dv,)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _close(got, want, TOL, what="K10 plain, dv != hd")
    else:
        d = np.linalg.norm(got.float().numpy() - want, axis=-1)
        assert (d / np.linalg.norm(want, axis=-1)).max() <= 2 ** -7


def test_flash_units_carry_value_head_dim():
    """A unit whose value head dim differs from head_dim defines DV, hands
    it to its body and spans the value row in its P V wgmma (MLA's 128,
    not 192); one whose value head is head_dim wide reads as
    before.  A value head wider than q's, or off the steps of 16, raises
    before any build; only a flash unit takes one."""
    u = flash_k.flash_unit(torch.bfloat16, 192, "test", 128)
    assert "constexpr int HD = 192;" in u.source
    assert "constexpr int DV = 128;" in u.source
    assert "using Body = rt::flash::TensorCores<HD, Wgmma, DV>;" in u.source
    assert "m64n128k16" in u.source and "m64n192k16" not in u.source
    assert "run<Body, HD, DV>" in u.source
    assert u.label == "flash bfloat16 head_dim 192 v_head_dim 128"
    f32 = flash_k.flash_unit(torch.float32, 192, "test", 128)
    assert "using Body = rt::flash::CudaCores<HD, DV>;" in f32.source
    same = flash_k.flash_unit(torch.bfloat16, 192, "test", 192)
    assert same is flash_k.flash_unit(torch.bfloat16, 192, "test")
    assert "TensorCores<HD, Wgmma>;" in same.source
    assert "m64n192k16" in same.source and same.digest != u.digest
    with pytest.raises(NotImplementedError, match="value head dim of 16 to"):
        flash_k.flash_unit(torch.bfloat16, 128, "test", 192)
    with pytest.raises(NotImplementedError, match="value head dim of 16 to"):
        flash_k.flash_unit(torch.bfloat16, 128, "test", 24)
    with pytest.raises(ValueError, match="head_dim"):
        _lib.unit("copy", "test", v_head_dim=64)


def test_k10_host_path_launches_at_the_value_width(monkeypatch):
    """On tensors that say they lie on the card, ``flash_attention_gqa`` at
    MLA's layout (q (1, 9, 2, 1, 192), k (1, 9, 2, 192), v (1, 9, 2, 128))
    loads the (bf16, 192, 128) unit, calls its entry once with v's width,
    the scale 1 / sqrt(192) and an output of v's width, and counts one
    launch; a v whose leading dims are not k's raises before anything
    loads or launches."""
    lib = _Entries()
    monkeypatch.setattr(_lib, "load", lambda u: lib.loaded.append(u) or lib)
    monkeypatch.setattr(_lib, "stream_ptr", lambda t: 7)
    monkeypatch.setattr(flash_k.flash_attention_gqa, "launches", 0)
    bf = torch.bfloat16
    q = torch.zeros(1, 9, 2, 1, 192, dtype=bf).as_subclass(_OnCard)
    k = torch.zeros(1, 9, 2, 192, dtype=bf).as_subclass(_OnCard)
    v = torch.zeros(1, 9, 2, 128, dtype=bf).as_subclass(_OnCard)
    with pytest.raises(ValueError, match=r"v \(B, T, K, dv\)"):
        flash_k.flash_attention_gqa(q, k, v[:, :8])
    assert lib.loaded == [] and lib.calls == []
    out = flash_k.flash_attention_gqa(q, k, v)
    assert tuple(out.shape) == (1, 9, 2, 1, 128)
    assert lib.loaded == [flash_k.flash_unit(bf, 192, "test", 128)]
    (name, args), = lib.calls
    assert name == "rt_flash"
    assert args[4:11] == (1, 9, 9, 2, 2, 128, 1)      # B S T H KH dv causal
    assert args[13] == pytest.approx(1 / np.sqrt(192))
    assert flash_k.flash_attention_gqa.launches == 1
