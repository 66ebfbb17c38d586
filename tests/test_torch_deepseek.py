"""deepseek-v3-671b in the PyTorch port against the JAX package.

The float32 smoke config (3 layers: one ``mla_dense``, two ``mla_moe``
with 8 experts top-2 behind a sigmoid router, one shared expert; the
depth-1 MTP head) with the same numpy parameters in both packages (the
harness of ``test_torch_models.py``): the configs' fields; the port's own
initialisation, MTP head included, has the reference's tree and count;
``params_from_jax`` carries every leaf (``mtp`` as one block) and round-
trips to the reference's numpy tree; a prefill of two rows of 40 tokens
and four decode steps at positions 40 and 37: logits and every latent
cache leaf within rtol = atol = 1e-4 of the jitted reference's; and the
served tests of ``test_torch_serving_models.py`` (greedy streams
identical to the reference ``Engine``'s, log-probabilities within 1e-4,
EOS), one reference engine.
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
    _close, _close_caches, _f32, _shapes, numpy_params, one_torch_thread)
from test_torch_models import (  # noqa: E402
    test_init_caches_match_reference_shapes as caches_match_reference)
from test_torch_models import (  # noqa: E402
    test_params_from_jax_layout_and_dtypes as layout_matches_reference)
from test_torch_serving_models import serve_both  # noqa: E402
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_greedy_streams_identical_to_reference)
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_seq_logprobs_match_reference)
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_eos_stops_like_reference)

NAME = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def served():
    return serve_both(NAME)


def test_config_fields_match_reference():
    """FULL and SMOKE: every field, the MLA widths and ``mtp_depth``
    among them, as the reference's."""
    for smoke in (False, True):
        cj = dataclasses.asdict(JC.get_config(NAME, smoke=smoke))
        ct = dataclasses.asdict(TC.get_config(NAME, smoke=smoke))
        assert ct == cj
    full = TC.get_config(NAME)
    assert (full.use_mla, full.q_lora_rank, full.kv_lora_rank,
            full.qk_nope_head_dim, full.qk_rope_head_dim, full.v_head_dim,
            full.mtp_depth) == (True, 1536, 512, 128, 64, 128, 1)


def test_init_params_tree_and_count_match_reference():
    """The port's own draw has the converted tree's paths, shapes and
    dtypes, the MTP head's ``proj``, ``mla_dense`` block and three norms
    included, and the reference's parameter count."""
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    own = tlm.init_params(cfg_t, seed=0, device="cpu")
    assert _shapes(own) == _shapes(params_t)
    assert sorted(own["mtp"]) == ["block", "final_norm", "norm_e", "norm_h",
                                  "proj"]
    assert sorted(own["mtp"]["block"]["attn"]) == sorted(
        params_j["mtp"]["block"]["attn"])
    assert tlm.count_params(own) == sum(
        int(np.prod(l.shape)) for l in jax.tree.leaves(params_j))


def test_params_from_jax_layout_and_dtypes():
    """Weights in bf16, norm scales (MLA's ``q_norm`` and ``kv_norm``, the
    MTP head's) and the router float32, by path."""
    layout_matches_reference(_f32(NAME))


def test_params_from_jax_round_trips():
    """Every leaf of the reference's numpy tree comes back bit for bit from
    the port's float32 tree: units stacked again, ``mtp`` as it was."""
    cfg_j = dataclasses.replace(JC.get_config(NAME, smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config(NAME, smoke=True),
                                dtype="float32")
    tree = numpy_params(cfg_j, 5)
    port = params_from_jax(tree, cfg_t, "cpu", torch.float32)

    def numpy(node):
        if isinstance(node, dict):
            return {k: numpy(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(numpy(v) for v in node)
        return node.numpy()

    back = numpy(port)
    back["decoder"]["units"] = jax.tree.map(
        lambda *ls: np.stack(ls), *back["decoder"]["units"])
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_prefill_and_four_decode_steps_match_reference():
    """Two rows of 40 tokens, then four decode steps at positions 40 and 37:
    the logits and every latent cache leaf (``ckv``, ``krope``) within
    1e-4 of the jitted reference's."""
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 40)).astype(np.int32)
    lj, cj = jax.jit(lambda p, t: jlm.prefill(p, cfg_j, t, cache_len=64))(
        params_j, jnp.asarray(toks))
    lt, ct = tlm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                         cache_len=64)
    _close(lt, lj, what="prefill logits")
    _close_caches(ct, cj, "prefill caches")
    pos = np.array([40, 37], np.int32)
    j_decode = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, cfg_j, c, t,
                                                            pos))
    for step in range(4):
        tok = rng.integers(0, cfg_j.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = j_decode(params_j, cj, jnp.asarray(tok),
                          jnp.asarray(pos + step))
        lt, ct = tlm.decode_step(params_t, cfg_t, ct, torch.from_numpy(tok),
                                 torch.from_numpy(pos + step))
        _close(lt, lj, what=f"decode_step {step} logits")
        _close_caches(ct, cj, f"decode_step {step} caches")


def test_init_caches_match_reference():
    """The zeroed latent caches: (B, L, kv_lora_rank) and (B, L,
    qk_rope_head_dim) per MLA layer, in the reference's order."""
    caches_match_reference(_f32(NAME))
