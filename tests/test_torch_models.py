"""The PyTorch port's models (recurrentgemma-2b, gemma2-27b) against the
JAX package.

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
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

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


@pytest.fixture(scope="module")
def rg_f32():
    return _f32(NAME)


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


def test_rglru_forward_and_decode_match_reference(rg_f32):
    cfg_j, cfg_t, params_j, params_t = rg_f32
    blk_j, blk_t = _unit_block(params_j, params_t, 0)
    x = _x((2, 61, cfg_j.d_model), 1)
    y_j, c_j = jax.jit(lambda p, x: JR.rglru_forward(
        p, cfg_j, x, return_cache=True))(blk_j["mixer"], jnp.asarray(x))
    y_t, c_t = TR.rglru_forward(blk_t["mixer"], cfg_t, torch.from_numpy(x),
                                return_cache=True)
    _close(y_t, y_j, what="rglru_forward y")
    for key in ("h", "conv"):
        _close(c_t[key], c_j[key], what=f"rglru_forward cache {key}")
    assert c_t["h"].dtype == torch.float32
    x1 = _x((2, 1, cfg_j.d_model), 2)
    yd_j, cd_j = jax.jit(lambda p, x, c: JR.rglru_decode(p, cfg_j, x, c))(
        blk_j["mixer"], jnp.asarray(x1), c_j)
    yd_t, cd_t = TR.rglru_decode(blk_t["mixer"], cfg_t, torch.from_numpy(x1),
                                 c_t)
    _close(yd_t, yd_j, what="rglru_decode y")
    for key in ("h", "conv"):
        _close(cd_t[key], cd_j[key], what=f"rglru_decode cache {key}")


@pytest.mark.parametrize("S", [5, 40])
@pytest.mark.parametrize("name,j,is_local", [
    ("recurrentgemma-2b", 2, True), ("gemma2-27b", 1, False)],
    ids=["recurrentgemma-2b-local", "gemma2-27b-global"])
def test_gqa_forward_and_decode_match_reference(name, j, is_local, S):
    """S = 40 overfills the smoke window of 32: a local ring wraps in
    prefill and keeps wrapping through the decode steps, while a global
    layer's 64-slot cache keeps every position and attends to all of
    them."""
    cfg_j, cfg_t, params_j, params_t = _f32(name)
    blk_j, blk_t = _unit_block(params_j, params_t, j)
    x = _x((2, S, cfg_j.d_model), 3)
    y_j, c_j = jax.jit(lambda p, x: JA.gqa_forward(
        p, cfg_j, x, jnp.arange(S), is_local=is_local, return_cache_len=64))(
        blk_j["attn"], jnp.asarray(x))
    y_t, c_t = TA.gqa_forward(blk_t["attn"], cfg_t, torch.from_numpy(x),
                              is_local=is_local, return_cache_len=64)
    _close(y_t, y_j, what="gqa_forward y")
    for key in ("k", "v"):
        _close(c_t[key], c_j[key], what=f"gqa_forward cache {key}")
    pos = np.array([S, S - 3], np.int32)          # rows at their own depths
    j_decode = jax.jit(lambda p, x, c, pos: JA.gqa_decode(
        p, cfg_j, x, c, pos, is_local=is_local))
    for step in range(3):
        x1 = _x((2, 1, cfg_j.d_model), 10 + step)
        y_j, c_j = j_decode(blk_j["attn"], jnp.asarray(x1), c_j,
                            jnp.asarray(pos + step))
        k_in, v_in = c_t["k"], c_t["v"]
        ptrs = (k_in.data_ptr(), v_in.data_ptr())
        y_t, c_t = TA.gqa_decode(blk_t["attn"], cfg_t, torch.from_numpy(x1),
                                 c_t, torch.from_numpy(pos + step),
                                 is_local=is_local)
        # The slot is written in place: the step returns the input tensors.
        assert c_t["k"] is k_in and c_t["v"] is v_in
        assert (c_t["k"].data_ptr(), c_t["v"].data_ptr()) == ptrs
        _close(y_t, y_j, what=f"gqa_decode step {step}")
        for key in ("k", "v"):
            _close(c_t[key], c_j[key], what=f"gqa_decode cache {key}")


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


def test_init_caches_match_reference_shapes(f32):
    cfg_j, cfg_t, _, _ = f32
    cj = jlm.init_caches(cfg_j, 3, 64, jnp.float32)
    ct = tlm.init_caches(cfg_t, 3, 64, torch.float32, "cpu")
    got = jax.tree.leaves(_stacked_caches(ct))
    want = jax.tree.leaves(cj)
    assert [np.shape(g) for g in got] == [np.shape(w) for w in want]
    assert [str(g.dtype).removeprefix("torch.") for g in got] == \
        [str(w.dtype) for w in want]


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


@pytest.mark.parametrize("window", [0, 100])
def test_blockwise_attention_ragged_tail_against_dense(window):
    """T = 513 is one key past a 512-key block.  The port reads the tail
    block [512, 513) at its own positions and matches dense attention; the
    reference's dynamic slice clamps that block back to [1, 513) while its
    mask labels the keys from 512 on (recorded in ROADMAP.md)."""
    T, hd = 513, 8
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, T, 1, 2, hd), (1, T, 1, hd), (1, T, 1, hd)))
    pos = np.arange(T)
    got = TA.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 qpos=torch.from_numpy(pos), window=window)
    s = np.einsum("sgd,td->gst", q[0, :, 0], k[0, :, 0]) / np.sqrt(hd)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= (pos[:, None] - pos[None, :]) < window
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = (p / p.sum(-1, keepdims=True)) @ v[0, :, 0]      # (G, S, hd)
    np.testing.assert_allclose(got[0, :, 0].numpy(),
                               dense.transpose(1, 0, 2), rtol=1e-5,
                               atol=1e-5)
