"""Prompt buckets in the PyTorch port against the JAX package.

* ``lm.prefill(..., valid_len=)`` over a right-padded prompt, logits and
  every cache leaf against the reference's jitted prefill at rtol = atol =
  1e-4 (the harness of ``test_torch_models.py``), for the float32 smoke
  recurrentgemma-2b, gemma2-27b and xlstm-1.3b, at a valid length below
  and above the smoke window of 32 (a local ring that has and has not
  wrapped; xLSTM's mLSTM chunks of 8 cut mid-chunk).
* ``Engine(prefill_buckets=...)``: bucketed streams equal to the exact-
  length engine's and to the reference's bucketed engine's (the
  reference's ``tests/test_strategies.py`` cases, plus a 40-token prompt
  whose bucket of 64 holds the ring past its window).
* The bucket spec's resolution and validation texts, and the prefill
  seeing only bucket lengths.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    NAMES, _close, _close_caches, both_params, one_torch_thread)
from test_torch_serve_slots import engine_pair, smoke_configs  # noqa: E402

BUCKET = 48


@functools.cache
def _prefill_case(name):
    """The configs, parameters and the reference's jitted prefill, whose
    traced ``valid_len`` serves both lengths with one compilation."""
    cfg_j, cfg_t = smoke_configs(name)
    params_j, params_t = both_params(cfg_j, cfg_t, 2, torch.float32)
    prefill_j = jax.jit(lambda p, t, v: jlm.prefill(
        p, cfg_j, t, cache_len=64, valid_len=v))
    return cfg_j, cfg_t, params_j, params_t, prefill_j


@pytest.mark.parametrize("valid_len", [20, 40])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_valid_len_matches_reference(name, valid_len):
    cfg_j, cfg_t, params_j, params_t, prefill_j = _prefill_case(name)
    toks = np.zeros((1, BUCKET), np.int32)
    toks[0, :valid_len] = np.random.default_rng(valid_len).integers(
        1, cfg_j.vocab_size, valid_len)
    lj, cj = prefill_j(params_j, jnp.asarray(toks),
                       jnp.asarray(valid_len, jnp.int32))
    lt, ct = tlm.prefill(params_t, cfg_t, torch.from_numpy(toks).long(),
                         cache_len=64, valid_len=valid_len)
    _close(lt, lj, what="prefill(valid_len) logits")
    _close_caches(ct, cj, "prefill(valid_len) caches")
    # The logits are the valid prompt's own: an exact-length prefill's.
    le, _ = tlm.prefill(params_t, cfg_t,
                        torch.from_numpy(toks[:, :valid_len]).long(),
                        cache_len=64)
    _close(lt, le, what="valid_len vs exact-length logits")


BUCKET_REQS = [(list(range(1, 6)), 6, 0), ([9, 8, 7], 5, 1),
               (list(range(3, 20)), 4, 2),
               ([(7 * i) % 500 + 1 for i in range(40)], 5, 3)]


@pytest.mark.parametrize("case", [
    ("gemma2-27b", "pow2", {}),
    ("recurrentgemma-2b", "pow2", {}),
    ("gemma2-27b", [8, 32, 48], dict(temperature=1.0, top_k=5, seed=3))],
    ids=["gemma2-pow2", "recurrentgemma-pow2", "gemma2-sampled"])
def test_bucketed_streams_match_exact_and_reference(case):
    name, buckets, kw = case
    # As many slots as requests: the reference engine compiles one loop.
    j_eng, t_eng, (_, cfg_t, _, params_t) = engine_pair(
        name, batch_size=4, prefill_buckets=buckets, **kw)
    exact = TEngine(cfg_t, params_t, cache_len=64, batch_size=4,
                    device="cpu", **kw)
    t_out = t_eng.generate([TRequest(p, m, seed=s)
                            for p, m, s in BUCKET_REQS])
    assert t_out == exact.generate([TRequest(p, m, seed=s)
                                    for p, m, s in BUCKET_REQS])
    assert t_out == j_eng.generate([JRequest(p, m, seed=s)
                                    for p, m, s in BUCKET_REQS])
    np.testing.assert_allclose(t_eng.last_stats["seq_logprob"],
                               j_eng.last_stats["seq_logprob"],
                               rtol=1e-5, atol=1e-5)


def test_bucket_spec_resolution_and_validation():
    cfg_j, cfg_t = smoke_configs("gemma2-27b")
    params_j, params_t = both_params(cfg_j, cfg_t, 0, torch.float32)
    for spec in ("pow2", [32, 8, 8], (64,)):
        got = TEngine(cfg_t, params_t, cache_len=64, batch_size=2,
                      device="cpu", prefill_buckets=spec).prefill_buckets
        want = JEngine(cfg_j, None, params_j, cache_len=64, batch_size=2,
                       prefill_buckets=spec).prefill_buckets
        assert got == want
    for spec in ([8, 4096], [], [0, 8]):
        errors = []
        for build in (lambda: TEngine(cfg_t, params_t, cache_len=64,
                                      batch_size=2, device="cpu",
                                      prefill_buckets=spec),
                      lambda: JEngine(cfg_j, None, params_j, cache_len=64,
                                      batch_size=2, prefill_buckets=spec)):
            with pytest.raises(ValueError, match="prefill_buckets") as e:
                build()
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_prefill_sees_only_bucket_lengths():
    """Prompts of many lengths hit few prefill shapes: the bucket's, the
    valid length handed beside it (the reference's spy test)."""
    _, cfg_t = smoke_configs("gemma2-27b")
    params = tlm.init_params(cfg_t, seed=0, device="cpu")
    eng = TEngine(cfg_t, params, cache_len=64, batch_size=2, device="cpu",
                  prefill_buckets="pow2")
    seen = []
    real = eng._prefill

    def spy(params, batch):
        seen.append((batch["tokens"].shape[1], batch.get("valid_len")))
        return real(params, batch)

    eng._prefill = spy
    lens = (3, 5, 6, 8, 9, 17, 20)
    eng.generate([TRequest(prompt=list(range(1, n)), max_new_tokens=2,
                           seed=n) for n in lens])
    assert [s[0] for s in seen] == [8, 8, 8, 8, 8, 16, 32]
    assert [s[1] for s in seen] == [2, 4, 5, 7, None, None, 19]
