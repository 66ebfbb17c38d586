"""The five dense-config models of the PyTorch port against the JAX package:
gemma3-4b (qk-norm, 5 local : 1 global), minitron-4b (relu2, untied),
moonshot-v1-16b-a3b (a dense stem and MoE layers), deepseek-coder-33b
(swiglu, untied) and internvl2-76b (prefix embeddings), each at its
float32 smoke size with the same numpy parameters in both packages (the
harness of ``test_torch_models.py``).

A prefill of two rows of 40 tokens (gemma3's local ring of 32 wraps),
behind 8 prefix embeddings drawn from a seed for internvl2-76b, then three
decode steps at positions that count the prefix: the logits and every
cache leaf within rtol = atol = 1e-4 of the jitted reference's; the port's
own initialisation and its zeroed caches have the reference's structure.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_dense import DENSE  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    _close, _close_caches, _f32, one_torch_thread)
from test_torch_models import (  # noqa: E402
    test_init_caches_match_reference_shapes as caches_match_reference)
from test_torch_models import (  # noqa: E402
    test_init_params_structure_matches_reference as init_matches_reference)


@pytest.fixture(scope="module", params=DENSE)
def f32(request):
    return _f32(request.param)


def test_prefill_and_decode_step_match_reference(f32):
    cfg_j, cfg_t, params_j, params_t = f32
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 40)).astype(np.int32)
    P = cfg_j.num_prefix_embeds
    prefix_j, prefix_t = {}, {}
    if P:
        ve = rng.normal(0, 1, (2, P, cfg_j.d_model)).astype(np.float32)
        prefix_j["vision_embeds"] = jnp.asarray(ve)
        prefix_t["vision_embeds"] = torch.from_numpy(ve)
    lj, cj = jax.jit(lambda p, t, kw: jlm.prefill(
        p, cfg_j, t, cache_len=64, **kw))(params_j, jnp.asarray(toks),
                                          prefix_j)
    lt, ct = tlm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                         cache_len=64, **prefix_t)
    _close(lt, lj, what="prefill logits")
    _close_caches(ct, cj, "prefill caches")
    pos = np.array([40, 37], np.int32) + P         # positions past the prefix
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


def test_init_params_and_caches_match_reference_structure():
    for name in DENSE:
        init_matches_reference(_f32(name))
        caches_match_reference(_f32(name))
