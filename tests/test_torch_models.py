"""The PyTorch port's models (recurrentgemma-2b, gemma2-27b, xlstm-1.3b)
against the JAX package.

The smoke configs in float32 (``dataclasses.replace(cfg, dtype="float32")``):
parameters are numpy arrays drawn from a seed in the tree of the JAX
``init_params`` (its structure from ``jax.eval_shape``), handed to JAX as they
are and to the port through ``repro_torch.convert.params_from_jax``; the
same numpy inputs go through both models (the JAX side jitted), and
outputs and every cache leaf must agree at rtol = atol = 1e-4 (float32
reassociation: XLA and PyTorch order their dot products and the
recurrence's scans differently).  One bf16 leg holds the
prefill logits at 5e-2: activations round to bf16 at the same points in both
packages, but a one-ulp float32 difference before a rounding point moves a
bf16 value by 2^-8 relative, and such moves pass through every layer.
Prompts stay at or under 512 tokens: past that the reference's
``blockwise_attention`` misreads a ragged last KV block (ROADMAP.md).

This file holds the harness and the configs', parameters' and caches'
structure; the layers run from ``test_torch_models_layers.py`` and the
prefill and decode from ``test_torch_models_prefill.py``, files of at
most 12 tests, which ``--dist loadfile`` queues behind the larger files.
"""
import dataclasses
import functools

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

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's CPU ops on one thread while a test module of the port runs
    (every ``test_torch_*.py`` imports this fixture).  The suite runs in
    several worker processes at once and the port's CPU ops here are
    small: a pool of threads per worker, as many as the cores, only spins
    against the other workers' compilations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
NAME = "recurrentgemma-2b"
NAMES = ("recurrentgemma-2b", "gemma2-27b", "xlstm-1.3b")


def _configs(dtype, name=NAME):
    return (dataclasses.replace(JC.get_config(name, smoke=True), dtype=dtype),
            dataclasses.replace(TC.get_config(name, smoke=True), dtype=dtype))


def numpy_params(cfg_j, seed):
    """float32 numpy parameters in the reference's tree: the RG-LRU's
    ``lam`` as its init draws it (a in [0.9, 0.999]), every other leaf --
    norm scales and biases included, so their paths are exercised --
    normal with std 0.1."""
    shapes = jax.eval_shape(functools.partial(jlm.init_params, cfg=cfg_j),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if getattr(path[-1], "key", None) == "lam":
            a = 0.9 + 0.09 * rng.uniform(0.0, 1.0, s.shape)
            return np.log(np.expm1(-np.log(a) / 8.0)).astype(np.float32)
        return rng.normal(0.0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_params(cfg_j, cfg_t, seed, dtype):
    tree = numpy_params(cfg_j, seed)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg_t, "cpu", dtype))


@functools.cache
def _f32(name):
    cfg_j, cfg_t = _configs("float32", name)
    params_j, params_t = both_params(cfg_j, cfg_t, 0, torch.float32)
    return cfg_j, cfg_t, params_j, params_t


@pytest.fixture(scope="module", params=NAMES)
def f32(request):
    return _f32(request.param)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _unit_block(params_j, params_t, j):
    """Block j of the first unit in both layouts."""
    blk_j = jax.tree.map(lambda l: l[0], params_j["decoder"]["units"][j])
    return blk_j, params_t["decoder"]["units"][0][j]


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_match_reference(name):
    for smoke in (False, True):
        cj = dataclasses.asdict(JC.get_config(name, smoke=smoke))
        ct = dataclasses.asdict(TC.get_config(name, smoke=smoke))
        assert ct == cj


def test_params_from_jax_layout_and_dtypes(f32):
    """Units unstacked, each leaf the reference's stacked leaf less its
    unit axis; weights in bf16; the leaves that the reference's own bf16
    init keeps in float32 (the RG-LRU's lam and biases, the mLSTM's gate
    projections and biases, the sLSTM's gate bias), found by path, stay
    float32, and so do the norm scales (post-norms included)."""
    cfg_j, cfg_t, params_j, params_t = f32
    assert tlm.count_params(params_t) == sum(
        l.size for l in jax.tree.leaves(params_j))
    bf = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, "cpu",
                         torch.bfloat16)
    ref = jax.eval_shape(functools.partial(
        jlm.init_params, cfg=cfg_j, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        shape, dtype = leaf.shape, leaf.dtype
        if keys[:2] == ("decoder", "units"):
            units = [keys[:2] + (u,) + keys[2:] for u in range(cfg_t.n_units)]
            shape = shape[1:]
        else:
            units = [keys]
        for k in units:
            want[k] = (shape, torch.float32 if dtype == jnp.float32 or
                       k[-1] == "scale" else torch.bfloat16)
    assert _shapes(bf) == want
    blocks = [b for u in bf["decoder"]["units"] for b in u]
    assert all(("post_norm1" in b and "post_norm2" in b) == cfg_t.post_norm
               for b in blocks)


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, path + (i,)).items()}
    return {path: (tuple(tree.shape), tree.dtype)}


def test_init_params_structure_matches_reference(f32):
    """The port's own initialisation has the converted tree's paths,
    shapes and dtypes."""
    cfg_j, cfg_t, params_j, params_t = f32
    own = tlm.init_params(cfg_t, seed=0, device="cpu")
    assert _shapes(own) == _shapes(params_t)


def _j_prefill(cfg_j):
    return jax.jit(lambda p, t: jlm.prefill(p, cfg_j, t, cache_len=64))


def _stacked_caches(c_t):
    """The port's per-unit cache list in the reference's stacked layout."""
    return {"prefix": tuple(c_t["prefix"]),
            "units": jax.tree.map(lambda *ls: np.stack([_np(l) for l in ls]),
                                  *[tuple(u) for u in c_t["units"]]),
            "suffix": tuple(c_t["suffix"])}


def _close_caches(c_t, c_j, what, tol=TOL):
    got = jax.tree.leaves(_stacked_caches(c_t))
    want = jax.tree.leaves(c_j)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.shape(g) == np.shape(w), f"{what} leaf {i}"
        _close(g, w, tol, what=f"{what} leaf {i}")


def test_init_caches_match_reference_shapes(f32):
    cfg_j, cfg_t, _, _ = f32
    cj = jlm.init_caches(cfg_j, 3, 64, jnp.float32)
    ct = tlm.init_caches(cfg_t, 3, 64, torch.float32, "cpu")
    got = jax.tree.leaves(_stacked_caches(ct))
    want = jax.tree.leaves(cj)
    assert [np.shape(g) for g in got] == [np.shape(w) for w in want]
    assert [str(g.dtype).removeprefix("torch.") for g in got] == \
        [str(w.dtype) for w in want]
