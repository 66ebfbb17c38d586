"""The PyTorch port's temperature sampling against the JAX package.

* threefry: ``PRNGKey``, ``fold_in`` and the per-request keys are bit-exact
  against ``jax.random``, and so are the random bits (JAX's partitionable
  counter layout).  Gumbel noise agrees to float32 rounding of ``log``:
  within 2 ulps of the value, or 2 ulps of 1.0 absolute where the outer
  ``log`` of a number near 1 cancels (values near 0).
* ``sample_tokens``: identical ids for the same logits, keys and steps, with
  top-k, top-p, full-vocabulary Gumbel and greedy settings.
The nucleus pins of the reference's ``tests/test_serving.py``:
``test_torch_sampling_nucleus.py``; the sampled ``Engine`` against the
reference's: ``test_torch_sampled_engine.py`` (files of at most 12 tests,
which ``--dist loadfile`` queues behind the larger files).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampling as JSP  # noqa: E402
from repro_torch.serving import sampling as SP  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

SEEDS = np.array([0, 3, -1, 2 ** 31 - 1], np.int32)
DRAWS, VOCAB = 64, 64
STEPS = np.array([0, 1, 17, 99], np.int32)


def _keys(seed=5):
    jk = JSP.request_step_keys(jax.random.PRNGKey(seed), jnp.asarray(SEEDS),
                               jnp.asarray(STEPS))
    tk = SP.request_step_keys(SP.PRNGKey(seed), torch.from_numpy(SEEDS),
                              torch.from_numpy(STEPS))
    return jk, tk


@pytest.mark.parametrize("seed", [0, 7, 123456789, -3])
def test_prng_key_and_fold_in_bit_exact(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    got = SP.PRNGKey(seed)
    np.testing.assert_array_equal(got.numpy(), want)
    for data in (0, 1, 0x5D1AF7, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            SP.fold_in(got, data).numpy(),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                          np.uint32(data))).astype(np.int64))
        np.testing.assert_array_equal(
            SP.stream_key(got, data).numpy(),
            np.asarray(JSP.stream_key(jax.random.PRNGKey(seed),
                                      data)).astype(np.int64))


def test_request_step_keys_and_bits_bit_exact():
    jk, tk = _keys()
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for n in (1, 7, 1000):
        want = jax.vmap(lambda k: jax.random.bits(k, (n,)))(jk)
        np.testing.assert_array_equal(SP.random_bits(tk, n).numpy(),
                                      np.asarray(want).astype(np.int64))
    want = jax.vmap(lambda k: jax.random.uniform(k, (999,)))(jk)
    np.testing.assert_array_equal(SP.uniform(tk, 999).numpy(),
                                  np.asarray(want))


def test_gumbel_within_two_ulps():
    jk, tk = _keys()
    n = 20000
    want = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (n,), jnp.float32))(jk))
    got = SP.gumbel(tk, n).numpy()
    assert got.dtype == np.float32 and got.shape == (len(SEEDS), n)
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert (np.abs(got - want) <= 2 * ulp).all()


# The reference's sampler jitted, as its engine runs it (inside the jitted
# admission and decode loop of serving/strategies/base.py), so the exact-id
# tests hold the port to the reference's real path; compiled once per
# setting instead of op by op.
_J_SAMPLE = jax.jit(JSP.sample_tokens, static_argnames=(
    "temperature", "top_k", "top_p", "top_p_candidates"))


def _sample_both(logits, seeds, steps, **kw):
    want = _J_SAMPLE(
        jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(seeds),
        jnp.asarray(steps), top_p_candidates=64, **kw)
    got = SP.sample_tokens(
        SP.PRNGKey(0), torch.from_numpy(logits), torch.from_numpy(seeds),
        torch.from_numpy(steps), top_p_candidates=64, **kw)
    assert got.dtype == torch.int32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.8, 8, 1.0), (0.8, 0, 0.9), (1.0, 0, 1.0),
                          (0.7, 40, 0.95), (0.0, 0, 1.0)])
def test_sample_tokens_identical_ids(temperature, top_k, top_p):
    rng = np.random.default_rng(1)
    B, V = DRAWS, VOCAB
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    seeds = np.arange(B, dtype=np.int32) + 11
    steps = rng.integers(0, 50, B).astype(np.int32)
    got, want = _sample_both(logits, seeds, steps, temperature=temperature,
                             top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(got, want)
