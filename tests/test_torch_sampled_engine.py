"""The PyTorch port's sampled ``Engine`` against the JAX package's: on the
float32 smoke recurrentgemma, token streams identical to the reference
``Engine``'s over 4 requests x 8 tokens, with request seeds and slots
recycling, and sequence log-probabilities within 1e-4; a request's stream
does not depend on the batch it is served in.
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


# ---------------------------------------------------------------------------
# The sampled engine against the reference engine
# ---------------------------------------------------------------------------

NAME = "recurrentgemma-2b"
PROMPT_LENS = (5, 40, 17, 9)


@pytest.fixture(scope="module")
def engines():
    cfg_j = dataclasses.replace(JC.get_config(NAME, smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config(NAME, smoke=True),
                                dtype="float32")
    params_j, params_t = both_params(cfg_j, cfg_t, 4, torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    kw = dict(cache_len=64, batch_size=2, temperature=0.8, top_k=40,
              top_p=0.95, seed=3)
    return (JEngine(cfg_j, None, params_j, **kw),
            TEngine(cfg_t, params_t, device="cpu", **kw), prompts)


def test_sampled_engine_streams_identical_to_reference(engines):
    j_eng, t_eng, prompts = engines
    seeds = (None, 7, None, 2)     # None: the submission index
    j_out = j_eng.generate([JRequest(prompt=p, max_new_tokens=8, seed=s)
                            for p, s in zip(prompts, seeds)])
    t_out = t_eng.generate([TRequest(prompt=p, max_new_tokens=8, seed=s)
                            for p, s in zip(prompts, seeds)])
    assert [len(o) for o in t_out] == [8] * 4
    assert t_out == j_out
    np.testing.assert_allclose(t_eng.last_stats["seq_logprob"],
                               j_eng.last_stats["seq_logprob"],
                               rtol=1e-4, atol=1e-4)


def test_sampled_stream_independent_of_batch_composition(engines):
    _, t_eng, prompts = engines
    full = t_eng.generate([TRequest(prompt=p, max_new_tokens=8, seed=i)
                           for i, p in enumerate(prompts)])
    alone = t_eng.generate([TRequest(prompt=prompts[2], max_new_tokens=8,
                                     seed=2)])
    assert alone[0] == full[2]
