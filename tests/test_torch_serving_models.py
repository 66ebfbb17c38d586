"""Engines of the PyTorch port serving models against the JAX package's.

The slice end to end: the JAX ``Engine(cfg, None, params, cache_len=64,
batch_size=2)`` and the port's ``Engine(..., device="cpu")`` serve the same
four ragged greedy requests (one prompt longer than the smoke window of 32,
and more requests than slots, so slots recycle) on the float32 smoke
recurrentgemma and gemma2 (local and global attention, post-norms) with the
same numpy parameters.  Token streams must be identical; sequence
log-probabilities agree within 1e-4 (float32 sums of per-token log-probs
taken in another order).  gemma2 is also served as the reference's own
serving tests serve it (``tests/test_serving.py``: its ``init_params``
from ``PRNGKey(0)``, ``cache_len=64``, four slots).

``serve_both`` and the three served tests are imported by the files that
serve the other models (``test_torch_serving_xlstm.py``,
``test_torch_dense_serving.py``, ``test_torch_moe.py``), each with its own
``served`` fixture: ``--dist loadfile`` gives a file to one worker, and a
file of at most 12 tests is queued behind the larger files.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as JC  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    NAMES, both_params, one_torch_thread)

PROMPT_LENS = (5, 40, 17, 9)
MAX_NEW = (6, 4, 8, 3)


def serve_both(name):
    """Both engines of ``name``'s float32 smoke config with the same
    parameters, and their greedy streams of the four requests."""
    cfg_j = dataclasses.replace(JC.get_config(name, smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config(name, smoke=True),
                                dtype="float32")
    params_j, params_t = both_params(cfg_j, cfg_t, 3, torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_j.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    j_eng = JEngine(cfg_j, None, params_j, cache_len=64, batch_size=2)
    t_eng = TEngine(cfg_t, params_t, cache_len=64, batch_size=2,
                    device="cpu")
    j_out = j_eng.generate([JRequest(prompt=p, max_new_tokens=m)
                            for p, m in zip(prompts, MAX_NEW)])
    t_out = t_eng.generate([TRequest(prompt=p, max_new_tokens=m)
                            for p, m in zip(prompts, MAX_NEW)])
    return j_eng, t_eng, j_out, t_out, prompts


# xlstm-1.3b's served tests are these, run from
# tests/test_torch_serving_xlstm.py: --dist loadfile gives a file to one
# worker, so its reference engine builds beside this file's, not after them.
SERVED_HERE = tuple(n for n in NAMES if n != "xlstm-1.3b")


@pytest.fixture(scope="module", params=SERVED_HERE)
def served(request):
    return serve_both(request.param)


def test_greedy_streams_identical_to_reference(served):
    j_eng, t_eng, j_out, t_out, _ = served
    assert [len(o) for o in t_out] == list(MAX_NEW)
    assert t_out == j_out


def test_seq_logprobs_match_reference(served):
    j_eng, t_eng, _, _, _ = served
    np.testing.assert_allclose(t_eng.last_stats["seq_logprob"],
                               j_eng.last_stats["seq_logprob"],
                               rtol=1e-4, atol=1e-4)
    for key in ("admissions", "total_tokens", "decode_steps", "final_step"):
        assert t_eng.last_stats[key] == j_eng.last_stats[key], key


def test_eos_stops_like_reference(served):
    """EOS set to a token each stream emits mid-way: both engines stop the
    request there (the EOS token included) and free its slot."""
    j_eng, t_eng, j_out, _, prompts = served
    eos = [o[len(o) // 2] for o in j_out]
    j_eos = j_eng.generate([JRequest(prompt=p, max_new_tokens=m, eos_id=e)
                            for p, m, e in zip(prompts, MAX_NEW, eos)])
    t_eos = t_eng.generate([TRequest(prompt=p, max_new_tokens=m, eos_id=e)
                            for p, m, e in zip(prompts, MAX_NEW, eos)])
    assert t_eos == j_eos
    assert all(o[-1] == e and len(o) <= m
               for o, e, m in zip(t_eos, eos, MAX_NEW))


@pytest.fixture(scope="module")
def gemma_engines():
    """gemma2 smoke as ``tests/test_serving.py`` builds it, in float32: the
    reference's ``init_params(PRNGKey(0))``, four slots of 64."""
    cfg_j = dataclasses.replace(JC.get_config("gemma2-27b", smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config("gemma2-27b", smoke=True),
                                dtype="float32")
    # Jitted: one program draws the tree, not one compilation an op.
    params_j = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               "cpu", torch.float32)
    return (JEngine(cfg_j, None, params_j, cache_len=64, batch_size=4),
            TEngine(cfg_t, params_t, cache_len=64, batch_size=4,
                    device="cpu"))


def test_gemma2_engine_streams_identical_to_reference(gemma_engines):
    j_eng, t_eng = gemma_engines
    prompts = ([1, 2, 3, 4], [9, 8], [5, 6, 7], list(range(10, 60)))
    max_new = (6, 4, 5, 12)
    j_out = j_eng.generate([JRequest(prompt=p, max_new_tokens=m)
                            for p, m in zip(prompts, max_new)])
    t_out = t_eng.generate([TRequest(prompt=p, max_new_tokens=m)
                            for p, m in zip(prompts, max_new)])
    assert [len(o) for o in t_out] == list(max_new)
    assert t_out == j_out


def test_gemma2_over_long_request_raises_like_reference(gemma_engines):
    """A global-attention layer's cache must hold prompt + max_new: 60 + 8
    tokens exceed cache_len 64 in both engines, with the same message."""
    errors = []
    for eng, req in zip(gemma_engines, (JRequest, TRequest)):
        with pytest.raises(ValueError) as e:
            eng.generate([req(prompt=list(range(60)), max_new_tokens=8)])
        errors.append(str(e.value))
    assert "global-attention" in errors[1]
    assert errors[0] == errors[1]
