"""The PyTorch port's models end to end against the JAX package:
recurrentgemma-2b, gemma2-27b and xlstm-1.3b smoke, a float32 prefill and
three decode steps (logits and every cache leaf at rtol = atol = 1e-4),
and a bf16 prefill at 5e-2 -- the harness of ``test_torch_models.py``, in
a file of at most 12 tests so that ``--dist loadfile`` queues it behind
the larger files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    NAMES, _close, _close_caches, _configs, _j_prefill, both_params, f32,
    one_torch_thread)


def test_prefill_and_decode_step_match_reference(f32):
    cfg_j, cfg_t, params_j, params_t = f32
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 40)).astype(np.int32)
    lj, cj = _j_prefill(cfg_j)(params_j, jnp.asarray(toks))
    lt, ct = tlm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                         cache_len=64)
    _close(lt, lj, what="prefill logits")
    _close_caches(ct, cj, "prefill caches")
    # Decode against caches shaped like the engine's (cache_len 64).
    pos = np.array([40, 40], np.int32)
    j_decode = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, cfg_j, c, t,
                                                            pos))
    for step in range(3):
        tok = rng.integers(0, cfg_j.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = j_decode(params_j, cj, jnp.asarray(tok),
                          jnp.asarray(pos + step))
        lt, ct = tlm.decode_step(params_t, cfg_t, ct, torch.from_numpy(tok),
                                 torch.from_numpy(pos + step))
        _close(lt, lj, what=f"decode_step {step} logits")
        _close_caches(ct, cj, f"decode_step {step} caches")


@pytest.mark.parametrize("name", NAMES)
def test_prefill_bf16_matches_reference(name):
    cfg_j, cfg_t = _configs("bfloat16", name)
    params_j, params_t = both_params(cfg_j, cfg_t, 1, torch.bfloat16)
    toks = np.random.default_rng(5).integers(
        0, cfg_j.vocab_size, (1, 24)).astype(np.int32)
    lj, cj = _j_prefill(cfg_j)(params_j, jnp.asarray(toks))
    lt, ct = tlm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                         cache_len=64)
    assert lt.dtype == torch.float32
    _close(lt, lj, dict(rtol=5e-2, atol=5e-2), what="bf16 prefill logits")
    _close_caches(ct, cj, "bf16 prefill caches", dict(rtol=5e-2, atol=5e-2))
