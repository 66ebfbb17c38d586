"""seamless-m4t-medium (the encoder-decoder) in the PyTorch port against
the JAX package.

The float32 smoke config (2 ``enc_attn`` encoder layers, 2 ``dec_attn``
decoder layers, 4 heads of 16, relu MLPs) with the same numpy parameters
in both packages (the harness of ``test_torch_models.py``) and a real
source: ``src_embeds`` of 0.1 N(0, 1), as the reference's
``tests/test_system.py`` draws it.  The engine's own source is all zeros,
which makes the encoder's output and every cross attention exactly zero
(the encoder has no biases), so these checks call the model directly.
Held to the jitted reference: ``_encode``, ``prefill`` (logits and every
cache leaf, the self attention's and the cross attention's), and decode
steps at one position for the whole batch, all within rtol = atol = 1e-4
(float32 sums in another order; the bf16 cross cache within one bf16
step).  Cross attention's own functions are held in
``test_torch_encdec_cross.py``.  The port alone: a
decode step after a prefill of S - 1 tokens gives a prefill of S tokens'
logits, as ``tests/test_system.py::test_arch_prefill_decode_consistency``
holds the reference.  Sources stay at or under 512 frames: past that the
reference's ``blockwise_attention`` misreads a ragged last KV block
(ROADMAP.md).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    _close, _close_caches, _f32, _shapes, _x, numpy_params,
    one_torch_thread)
from test_torch_models import (  # noqa: E402
    test_init_caches_match_reference_shapes as caches_match_reference)

NAME = "seamless-m4t-medium"


def _source(B, T, d, seed):
    """0.1 N(0, 1) frames, float32 numpy."""
    return 0.1 * _x((B, T, d), seed)


def test_config_fields_match_reference():
    """FULL and SMOKE: every field, the encoder's among them."""
    for smoke in (False, True):
        cj = dataclasses.asdict(JC.get_config(NAME, smoke=smoke))
        ct = dataclasses.asdict(TC.get_config(NAME, smoke=smoke))
        assert ct == cj
    full = TC.get_config(NAME)
    assert (full.is_encdec, full.n_enc_layers, full.unit, full.n_heads,
            full.n_kv_heads, full.head_dim) == (True, 12, ("dec_attn",),
                                                 16, 16, 64)


def test_init_params_tree_and_count_match_reference():
    """The port's own draw has the converted tree's paths, shapes and
    dtypes (``encoder``, ``enc_norm``, each decoder block's ``cross`` and
    ``norm_cross``) and the reference's count; FULL counts 614,739,968
    parameters in the reference's tree."""
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    own = tlm.init_params(cfg_t, seed=0, device="cpu")
    assert _shapes(own) == _shapes(params_t)
    assert sorted(own["decoder"]["units"][0][0]) == [
        "attn", "cross", "mlp", "norm1", "norm2", "norm_cross"]
    assert len(own["encoder"]["units"]) == cfg_t.n_enc_layers
    assert tlm.count_params(own) == sum(
        l.size for l in jax.tree.leaves(params_j))
    full = jax.eval_shape(
        lambda k: jlm.init_params(k, JC.get_config(NAME)),
        jax.random.PRNGKey(0))
    assert sum(l.size for l in jax.tree.leaves(full)) == 614_739_968


def test_params_from_jax_unstacks_the_encoder():
    """``encoder.units`` unstacked as ``decoder.units``: each leaf the
    reference's stacked leaf less its unit axis, bit for bit; weights in
    bf16, ``enc_norm`` and every norm scale float32."""
    cfg_j, cfg_t, _, _ = _f32(NAME)
    tree = numpy_params(cfg_j, 5)
    bf = params_from_jax(tree, cfg_t, "cpu", torch.bfloat16)
    assert bf["enc_norm"]["scale"].dtype == torch.float32
    for u, unit in enumerate(bf["encoder"]["units"]):
        (blk,) = unit
        ref = jax.tree.map(lambda l: l[u], tree["encoder"]["units"][0])
        for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
            got = blk
            for k in path:
                got = got[k.key]
            want = torch.from_numpy(np.asarray(leaf))
            assert got.dtype == (torch.float32 if path[-1].key == "scale"
                                 else torch.bfloat16), path
            assert torch.equal(got, want.to(got.dtype)), path


def test_encode_matches_reference():
    """The encoder (bidirectional attention, relu MLPs) and ``enc_norm``
    over a 40-frame source of two rows."""
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    src = _source(2, 40, cfg_j.d_model, 1)
    want = jax.jit(lambda p, s: jlm._encode(p, cfg_j, s))(params_j,
                                                           jnp.asarray(src))
    got = tlm._encode(params_t, cfg_t, torch.from_numpy(src))
    assert tuple(got.shape) == want.shape
    _close(got, want, what="_encode")


def _close_encdec_caches(c_t, c_j, what):
    """Every cache leaf's shape, and its value: the self attention's
    within 1e-4, the bf16 cross cache's within one bf16 step of each
    element (2^-7 of it), since a float32 k or v that differs in its last
    place may round to the neighbouring bf16 value."""
    _close_caches(c_t, c_j, what, dict(rtol=2 ** -7, atol=1e-6))
    self_t = [u[0]["self"] for u in c_t["units"]]
    self_j = [jax.tree.map(lambda l: l[u], c_j["units"][0]["self"])
              for u in range(len(self_t))]
    for u, (t, j) in enumerate(zip(self_t, self_j)):
        for key in t:
            _close(t[key], j[key], what=f"{what} layer {u} self {key}")


def _prefilled(S, T, seed):
    """Both packages' prefill of two rows of S tokens over T frames."""
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_j.vocab_size, (2, S)).astype(np.int32)
    src = _source(2, T, cfg_j.d_model, seed + 1)
    lj, cj = jax.jit(lambda p, t, s: jlm.prefill(
        p, cfg_j, t, cache_len=64, src_embeds=s))(
            params_j, jnp.asarray(toks), jnp.asarray(src))
    lt, ct = tlm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                         cache_len=64, src_embeds=torch.from_numpy(src))
    return rng, (lj, cj), (lt, ct)


def test_prefill_with_source_matches_reference():
    """30 tokens over 45 frames: the logits, and the caches -- each
    decoder layer's self attention k and v (64 slots) and cross attention
    k and v (45 frames, bf16) -- in dtype, shape and value (one bf16 step
    for the cross cache)."""
    _, (lj, cj), (lt, ct) = _prefilled(30, 45, 7)
    _close(lt, lj, what="prefill logits")
    _close_encdec_caches(ct, cj, "prefill caches")
    for (unit,) in ct["units"]:
        assert unit["cross"]["k"].dtype == unit["cross"]["v"].dtype \
            == torch.bfloat16
        assert tuple(unit["cross"]["k"].shape)[:2] == (2, 45)
        assert unit["self"]["k"].dtype == torch.float32


def test_decode_steps_at_one_position_match_reference():
    """Four decode steps of the aligned batch after the prefill, at
    positions 30 to 33 given as one position (a 0-d int32 array in the
    reference, a Python int in the port): logits and caches; the cross
    cache comes back unchanged."""
    rng, (_, cj), (_, ct) = _prefilled(30, 45, 8)
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    cross = [u[0]["cross"] for u in ct["units"]]
    j_decode = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, cfg_j, c, t,
                                                            pos))
    for step in range(4):
        tok = rng.integers(0, cfg_j.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = j_decode(params_j, cj, jnp.asarray(tok),
                          jnp.asarray(30 + step, jnp.int32))
        lt, ct = tlm.decode_step(params_t, cfg_t, ct, torch.from_numpy(tok),
                                 30 + step)
        _close(lt, lj, what=f"decode_step {step} logits")
        _close_encdec_caches(ct, cj, f"decode_step {step} caches")
        assert [u[0]["cross"] for u in ct["units"]] == cross


def test_decode_after_prefill_gives_the_longer_prefill():
    """``decode_step(prefill(t[:S-1]), t[S-1])`` gives ``prefill(t[:S])``'s
    logits, the 16-frame source the same in both, with the port's own
    initialisation: within 1e-3, the reference's tolerance for its own
    (decode reads the bf16 cross cache where prefill reads float32 k and
    v)."""
    _, cfg_t, _, _ = _f32(NAME)
    params_t = tlm.init_params(cfg_t, seed=0, device="cpu")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(
        rng.integers(0, cfg_t.vocab_size, (2, 16)).astype(np.int64))
    src = torch.from_numpy(_source(2, 16, cfg_t.d_model, 10))
    full, _ = tlm.prefill(params_t, cfg_t, toks, cache_len=20,
                          src_embeds=src)
    _, caches = tlm.prefill(params_t, cfg_t, toks[:, :15], cache_len=20,
                            src_embeds=src)
    step, _ = tlm.decode_step(params_t, cfg_t, caches, toks[:, 15:],
                              torch.tensor(15))
    _close(step, full, dict(rtol=1e-3, atol=1e-3),
           what="decode after prefill")


def test_init_caches_match_reference():
    """The zeroed caches: per decoder layer ``self`` and ``cross``, each k
    and v of ``cache_len`` slots, in the reference's order."""
    caches_match_reference(_f32(NAME))
