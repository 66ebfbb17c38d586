"""Quantized KV caches (``Engine(quantize_kv=...)``) in the PyTorch port
against the JAX package.

* Streams of the float32 smoke gemma2 (local ring past its window of 32,
  global layers) equal to the reference engine's for each mode and the
  ``"fp8"`` alias; ``seq_logprob`` within 1e-5.
* Bit for bit, against the reference run eagerly: the engine's cache after
  admission (both engines admit the same prefilled cache, the
  reference's, carried across) -- every
  ``KVQuant`` code and scale (a zero vector's subnormal scale excepted,
  which XLA's CPU backend flushes to zero), every dense leaf -- and a
  decode step's
  quantize-at-write and dequantize-at-read (``attention._kv_write`` against
  the reference's ``_kv_scatter`` on the same cache and vectors).
* The mode check's text, and the alias.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import operators as jalg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import cache as JCA  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.core import operators as talg  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_models import both_params, one_torch_thread  # noqa: E402,F401
from test_torch_serve_slots import (  # noqa: E402
    _ref_to_np, by_path, engine_pair, smoke_configs)

MODES = ("int8", "fp8_e4m3", "fp8_e5m2")
# As many requests as slots (the reference engine compiles one loop); the
# second prompt's 36 tokens and 8 new run the local ring past its window.
REQS = [(list(range(1, 6)), 6), ([(5 * i) % 400 + 1 for i in range(36)], 8)]


@pytest.mark.parametrize("mode", MODES)
def test_quantized_streams_match_reference(mode):
    j_eng, t_eng, (_, cfg_t, _, params_t) = engine_pair(
        "gemma2-27b", quantize_kv=mode)
    assert t_eng.quantize_kv == j_eng.quantize_kv == mode
    t_out = t_eng.generate([TRequest(p, m) for p, m in REQS])
    assert t_out == j_eng.generate([JRequest(p, m) for p, m in REQS])
    assert [len(o) for o in t_out] == [m for _, m in REQS]
    np.testing.assert_allclose(t_eng.last_stats["seq_logprob"],
                               j_eng.last_stats["seq_logprob"],
                               rtol=1e-5, atol=1e-5)
    if mode == "fp8_e4m3":
        # The "fp8" alias: the same engine, in both packages.
        alias = TEngine(cfg_t, params_t, cache_len=64, batch_size=2,
                        device="cpu", quantize_kv="fp8")
        assert alias.quantize_kv == "fp8_e4m3"
        assert alias.generate([TRequest(p, m) for p, m in REQS]) == t_out
        assert JEngine(j_eng.cfg, None, j_eng.params, cache_len=64,
                       batch_size=2, quantize_kv="fp8").quantize_kv == mode


def _np_to_port(tree):
    """A reference cache tree (in the port's layout, numpy leaves) as the
    port's: lists of blocks, each unit a tuple."""
    tree = torch.utils._pytree.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)
    return {"prefix": list(tree["prefix"]),
            "units": [tuple(u) for u in tree["units"]],
            "suffix": list(tree["suffix"])}


@pytest.fixture(scope="module")
def prefilled():
    """The reference's prefill of a 40-token prompt (past the window), as
    its engine's admission receives it; one compilation for every mode."""
    cfg_j, cfg_t = smoke_configs("gemma2-27b")
    params_j, params_t = both_params(cfg_j, cfg_t, 3, torch.float32)
    prompt = np.arange(3, 43, dtype=np.int32)[None, :]
    logits1, caches1 = jax.jit(lambda p, t: jlm.prefill(
        p, cfg_j, t, cache_len=64))(params_j, jnp.asarray(prompt))
    return cfg_j, cfg_t, params_j, params_t, logits1, caches1


@pytest.mark.parametrize("mode", MODES)
def test_admitted_and_written_codes_bit_exact(prefilled, mode):
    cfg_j, cfg_t, params_j, params_t, logits1, caches1 = prefilled
    j_eng = JEngine(cfg_j, None, params_j, cache_len=64, batch_size=2,
                    quantize_kv=mode)
    t_eng = TEngine(cfg_t, params_t, cache_len=64, batch_size=2,
                    device="cpu", quantize_kv=mode)
    # The reference engine's admission (``_admit_impl``: quantize, then
    # the strategy's scatter) eagerly: under jit XLA may divide by the
    # codec's constant as a multiply by its reciprocal, a rounding away
    # from the codec's own.
    with jax.disable_jit():
        j_caches = JCA.scatter_slot(
            j_eng._cache_zeros(2), JCA.quantize_kv_tree(caches1, mode), 1)
    t_state = t_eng._admit_impl(
        t_eng._fresh_state(), _np_to_port(_ref_to_np(caches1)),
        torch.from_numpy(np.array(logits1)), (), 1, 5, 4, -1, 40)
    got, want = by_path(t_state["caches"]), by_path(_ref_to_np(j_caches))
    assert sorted(got, key=str) == sorted(want, key=str)
    assert any(k[-1] == "scales" for k in got)
    # A zero vector (a global cache's slots past the prompt) has the scale
    # tiny / qmax, a subnormal, which XLA's CPU backend flushes to zero;
    # the reference then encodes 0 / 0.  Both read back zeros: the port's
    # codes are zero there, and its scale that subnormal.
    qmax = np.float32(127.0 if mode == "int8" else talg.FP8_FORMATS[mode][3])
    flushed = {k[:-1]: (want[k] == 0) & (got[k] != 0)
               for k in got if k[-1] == "scales"}
    for key in got:
        g, w = got[key], want[key]
        if key[:-1] in flushed:
            f = np.broadcast_to(flushed[key[:-1]], g.shape)
            if key[-1] == "scales":
                assert (g[f] == np.finfo(np.float32).tiny / qmax).all()
            else:
                assert not g[f].any()
            g, w = g[~f], w[~f]
        np.testing.assert_array_equal(g, w, err_msg=str(key))
    assert int(t_state["tok"][1]) == int(np.argmax(np.asarray(logits1)))

    # One decode step's write into a quantized ring, and the read.
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    new = rng.normal(size=(2, 2, 16)).astype(np.float32) * 3
    slot = np.array([5, 31], np.int32)
    j_leaf = jalg.quantize_kv(jnp.asarray(cache), mode)
    t_leaf = talg.quantize_kv(torch.from_numpy(cache), mode)
    j_stored, j_read = JA._kv_scatter(j_leaf, jnp.asarray(new),
                                      jnp.arange(2), jnp.asarray(slot),
                                      jnp.float32)
    t_read = TA._kv_write(t_leaf, torch.from_numpy(new), torch.arange(2),
                          torch.from_numpy(slot).long(), torch.float32)
    for t, j in ((t_leaf.values, j_stored.values),
                 (t_leaf.scales, j_stored.scales), (t_read, j_read)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_quantize_kv_mode_check():
    cfg_j, cfg_t = smoke_configs("gemma2-27b")
    params_j, params_t = both_params(cfg_j, cfg_t, 0, torch.float32)
    texts = []
    for build in (lambda: TEngine(cfg_t, params_t, cache_len=64,
                                  batch_size=2, device="cpu",
                                  quantize_kv="int4"),
                  lambda: JEngine(cfg_j, None, params_j, cache_len=64,
                                  batch_size=2, quantize_kv="int4")):
        with pytest.raises(ValueError, match="quantize_kv") as e:
            build()
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    eng = TEngine(cfg_t, params_t, cache_len=64, batch_size=2, device="cpu",
                  quantize_kv="fp8")
    assert eng.quantize_kv == "fp8_e4m3"
    leaf = eng._fresh_state()["caches"]["units"][0][0]["k"]
    assert isinstance(leaf, talg.KVQuant) and leaf.mode == "fp8_e4m3"
    assert leaf.values.dtype == torch.uint8
    assert not leaf.values.any() and not leaf.scales.any()
