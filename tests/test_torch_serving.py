"""The PyTorch port's serving slice against the JAX package, and its
structure.

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
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.serving import cache as JCA  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.serving import cache as TCA  # noqa: E402
from repro_torch.serving import scheduler as TS  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from test_torch_models import NAMES, both_params  # noqa: E402

NAME = "recurrentgemma-2b"
REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_ROOT = REPO / "src" / "repro_torch"
PROMPT_LENS = (5, 40, 17, 9)
MAX_NEW = (6, 4, 8, 3)


@pytest.fixture(scope="module", params=NAMES)
def served(request):
    cfg_j = dataclasses.replace(JC.get_config(request.param, smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config(request.param, smoke=True),
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
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
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


@pytest.mark.parametrize("counts", [[3, 0, 5, 1], [0], [4, 4]])
def test_compact_ragged_matches_reference(counts):
    B, T = len(counts), 6
    buf = np.arange(B * T, dtype=np.int32).reshape(B, T)
    for device_counts in (True, False):
        c = jnp.asarray(counts, jnp.int32) if device_counts else \
            np.asarray(counts)
        want_flat, want_off = JCA.compact_ragged(jnp.asarray(buf), c)
        got_flat, got_off = TCA.compact_ragged(
            torch.from_numpy(buf), torch.tensor(counts, dtype=torch.int32))
        np.testing.assert_array_equal(got_flat.numpy(), np.asarray(want_flat))
        np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))


def test_scheduler_copy_replays_reference_trace():
    """The port's scheduler copy runs one trace exactly as the reference."""
    trace = [("submit", 0), ("submit", 1), ("submit", 2), ("admit", 0),
             ("complete", 1), ("submit", 3), ("admit", 2), ("complete", 0),
             ("admit", 3), ("complete", 1), ("complete", 0)]
    logs = []
    for mod in (JS, TS):
        sched, log = mod.Scheduler(2), []
        for what, arg in trace:
            if what == "submit":
                log.append(sched.submit(object(), step=arg))
            elif what == "admit":
                log.append([(r.rid, r.slot) for r in sched.admit(step=arg)])
            else:
                log.append(sched.complete(arg, step=5).rid)
            sched.check_invariants()
        logs.append((log, sched.all_done))
    assert logs[0] == logs[1]


def test_port_imports_neither_jax_nor_reference():
    """No module of the port, and not chip_smoke.py, imports jax or the
    reference package."""
    paths = sorted(PORT_ROOT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(paths) > 20
    offenders = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.name}: {name}")
    assert not offenders


def test_engine_without_gpu_or_device_raises(monkeypatch):
    cfg = TC.get_config(NAME, smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        TEngine(cfg, {}, cache_len=64, batch_size=2)
    from repro_torch.models import lm
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        lm.init_params(cfg)
