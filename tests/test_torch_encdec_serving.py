"""The PyTorch port's padded serving path against the JAX package's.

``Engine.generate_padded`` is the reference's fixed-batch loop: the
prompts left-padded in one prefill, then one decode step at one position
for the whole batch a token.  It serves the encoder-decoder, which
``Engine.generate`` routes there (``serve`` refuses it), and it is the
oracle of the continuous path.  Held here, float32 smoke configs, the same
numpy parameters in both packages:

* seamless-m4t-medium: the port's ``generate`` and the reference engine's
  (``Engine(cfg, None, params, ...)``) on the same ragged greedy requests
  give identical tokens and ``last_scores`` within 1e-5 (float32 sums of
  per-token log-probs in another order); more requests than slots run
  batch by batch, each batch the reference's ``generate_padded``;
  ``serve`` raises as the reference's does;
* gemma2-27b (local ring and global layers): the port's
  ``generate_padded`` gives the reference's tokens, and the port's own
  continuous path gives its padded path's tokens on an equal-length
  batch, greedy and sampled, as ``tests/test_serving_parity.py`` holds the
  reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as JC  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_models import both_params, one_torch_thread  # noqa: E402,F401

PROMPT_LENS = (5, 17, 9, 12, 3)
MAX_NEW = (6, 4, 8, 3, 5)


def _engines(name, batch_size, **kw):
    """The reference's and the port's engines of ``name``'s float32 smoke
    config with the same parameters, and five prompts."""
    cfg_j = dataclasses.replace(JC.get_config(name, smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config(name, smoke=True),
                                dtype="float32")
    params_j, params_t = both_params(cfg_j, cfg_t, 3, torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    return (JEngine(cfg_j, None, params_j, cache_len=64,
                    batch_size=batch_size, **kw),
            TEngine(cfg_t, params_t, cache_len=64, batch_size=batch_size,
                    device="cpu", **kw), prompts)


def _requests(req, prompts, n, first=0):
    """Requests ``first`` to ``first + n`` of the five."""
    return [req(prompt=p, max_new_tokens=m) for p, m in
            zip(prompts[first:first + n], MAX_NEW[first:first + n])]


@pytest.fixture(scope="module")
def seamless():
    return _engines("seamless-m4t-medium", 4)


def test_encdec_generate_matches_reference(seamless):
    """Four ragged requests on four slots: ``generate`` runs the padded
    path in both engines; identical tokens, the same scores."""
    j_eng, t_eng, prompts = seamless
    j_out = j_eng.generate(_requests(JRequest, prompts, 4))
    t_out = t_eng.generate(_requests(TRequest, prompts, 4))
    assert [len(o) for o in t_out] == list(MAX_NEW[:4])
    assert t_out == j_out
    np.testing.assert_allclose(t_eng.last_scores, j_eng.last_scores,
                               rtol=1e-5, atol=1e-5)
    assert sorted(t_eng.last_stats) == sorted(j_eng.last_stats)


def test_encdec_generate_runs_batches_of_the_slots():
    """Five requests on two slots: the port's ``generate`` gives the
    reference's ``generate_padded`` of the first two, the next two and the
    last one, and the scores of all five in input order."""
    j_eng, t_eng, prompts = _engines("seamless-m4t-medium", 2)
    t_out = t_eng.generate(_requests(TRequest, prompts, 5))
    j_out, j_scores = [], []
    for first in (0, 2, 4):
        j_out += j_eng.generate_padded(_requests(JRequest, prompts, 2, first))
        j_scores += list(j_eng.last_scores)
    assert t_out == j_out
    np.testing.assert_allclose(t_eng.last_scores, j_scores, rtol=1e-5,
                               atol=1e-5)
    assert len(t_eng.last_stats["seq_logprob"]) == 5


def test_encdec_serve_raises_like_reference(seamless):
    """Continuous batching refuses an encoder-decoder in both engines."""
    j_eng, t_eng, prompts = seamless
    for eng, req in ((j_eng, JRequest), (t_eng, TRequest)):
        with pytest.raises(NotImplementedError, match="generate_padded"):
            eng.serve([(0, req(prompt=prompts[0], max_new_tokens=2))])


@pytest.fixture(scope="module")
def gemma2():
    return _engines("gemma2-27b", 4)


def test_generate_padded_matches_reference(gemma2):
    """A decoder-only model's padded path: four ragged prompts left-padded
    to 17 tokens, two local (ring) and two global layers decoded at one
    position a step; identical tokens, the same scores."""
    j_eng, t_eng, prompts = gemma2
    j_out = j_eng.generate_padded(_requests(JRequest, prompts, 4))
    t_out = t_eng.generate_padded(_requests(TRequest, prompts, 4))
    assert t_out == j_out
    np.testing.assert_allclose(t_eng.last_scores, j_eng.last_scores,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampler", [{}, dict(temperature=0.8, top_k=5)])
def test_continuous_matches_padded_on_equal_length_batch(sampler):
    """The port's own differential oracle: three prompts of one length, the
    continuous path and the padded path give the same tokens and scores
    within 1e-5, greedy and sampled with request seeds."""
    _, eng, _ = _engines("gemma2-27b", 4, **sampler)
    reqs = [TRequest([3, 5, 7], max_new_tokens=6, seed=11),
            TRequest([2, 4, 9], max_new_tokens=5, seed=22),
            TRequest([9, 1, 8], max_new_tokens=4, seed=33)]
    out_c = eng.generate(reqs)
    scores_c = eng.last_scores
    out_p = eng.generate_padded(reqs)
    assert out_c == out_p
    np.testing.assert_allclose(scores_c, eng.last_scores, rtol=1e-5,
                               atol=1e-5)
