"""The PyTorch port's xLSTM mixers (mLSTM, sLSTM) against the JAX package.

The float32 smoke xlstm-1.3b (d_model 64, 2 heads, mLSTM chunk 8) with the
numpy parameters of ``test_torch_models.py``: the same numpy inputs go
through the jitted reference mixers and the port's, and outputs and every
cache leaf agree at rtol = atol = 1e-4 (float32 reassociation).  The
mLSTM's intra-chunk attention rounds to bf16 at the same points in both
packages.  Each reference function is jitted once for the module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import operators as jalg  # noqa: E402
from repro.core import primitives as jforge  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch.convert import keeps_f32, params_from_jax  # noqa: E402
from repro_torch.core import operators as talg  # noqa: E402
from repro_torch.core import primitives as tforge  # noqa: E402
from repro_torch.kernels import scan as scan_k  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from test_torch_models import (  # noqa: E402,F401
    _close, _f32, _shapes, _unit_block, _x, one_torch_thread)

NAME = "xlstm-1.3b"


@pytest.fixture(scope="module")
def xl():
    cfg_j, cfg_t, params_j, params_t = _f32(NAME)
    mj, mt = _unit_block(params_j, params_t, 0)
    sj, st = _unit_block(params_j, params_t, cfg_t.unit.index("slstm"))
    jit = {
        "mlstm_forward": jax.jit(lambda p, x: JR.mlstm_forward(
            p, cfg_j, x, return_cache=True)),
        "mlstm_decode": jax.jit(lambda p, x, c: JR.mlstm_decode(
            p, cfg_j, x, c)),
        "slstm_forward": jax.jit(lambda p, x: JR.slstm_forward(
            p, cfg_j, x, return_cache=True)),
        "slstm_decode": jax.jit(lambda p, x, c: JR.slstm_decode(
            p, cfg_j, x, c)),
    }
    return cfg_t, (mj["mixer"], mt["mixer"]), (sj["mixer"], st["mixer"]), jit


def _close_cache(got, want, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        _close(got[key], want[key], what=f"{what} cache {key}")


@pytest.mark.parametrize("T", [19, 5], ids=["two-chunks-and-3", "below-chunk"])
def test_mlstm_forward_and_decode_match_reference(xl, T, monkeypatch):
    """T = 2 chunks + 3 pads the last chunk with neutral gates; T = 5 is
    one chunk of 5.  The chunk outputs vectorized over the chunks, and one
    chunk at a time (the route past the footprint cutoff, taken here with
    the cutoff at 0).  Then three decode steps continue the cache."""
    cfg_t, (pj, pt), _, jit = xl
    assert T in (2 * cfg_t.mlstm_chunk + 3, 5)
    x = _x((2, T, cfg_t.d_model), 20 + T)
    y_j, c_j = jit["mlstm_forward"](pj, jnp.asarray(x))
    y_t, c_t = TR.mlstm_forward(pt, cfg_t, torch.from_numpy(x),
                                return_cache=True)
    _close(y_t, y_j, what="mlstm_forward y")
    _close_cache(c_t, c_j, "mlstm_forward")
    with monkeypatch.context() as m:
        m.setattr(TR, "_MLSTM_INTRA_PARALLEL_MAX_ELEMS", 0)
        y_c, c_c = TR.mlstm_forward(pt, cfg_t, torch.from_numpy(x),
                                    return_cache=True)
    _close(y_c, y_j, what="mlstm_forward y, one chunk at a time")
    _close_cache(c_c, c_j, "mlstm_forward, one chunk at a time")
    assert all(c_t[k].dtype == torch.float32 for k in ("C", "n", "m"))
    for step in range(3):
        x1 = _x((2, 1, cfg_t.d_model), 30 + step)
        y_j, c_j = jit["mlstm_decode"](pj, jnp.asarray(x1), c_j)
        y_t, c_t = TR.mlstm_decode(pt, cfg_t, torch.from_numpy(x1), c_t)
        _close(y_t, y_j, what=f"mlstm_decode step {step} y")
        _close_cache(c_t, c_j, f"mlstm_decode step {step}")


def test_slstm_forward_and_decode_match_reference(xl):
    cfg_t, _, (pj, pt), jit = xl
    x = _x((2, 11, cfg_t.d_model), 40)
    y_j, c_j = jit["slstm_forward"](pj, jnp.asarray(x))
    y_t, c_t = TR.slstm_forward(pt, cfg_t, torch.from_numpy(x),
                                return_cache=True)
    _close(y_t, y_j, what="slstm_forward y")
    _close_cache(c_t, c_j, "slstm_forward")
    for step in range(2):
        x1 = _x((2, 1, cfg_t.d_model), 50 + step)
        y_j, c_j = jit["slstm_decode"](pj, jnp.asarray(x1), c_j)
        y_t, c_t = TR.slstm_decode(pt, cfg_t, torch.from_numpy(x1), c_t)
        _close(y_t, y_j, what=f"slstm_decode step {step} y")
        _close_cache(c_t, c_j, f"slstm_decode step {step}")


def test_mlstm_stabilizer_matches_reference_past_long_t_threshold():
    """(2, 130, 4): past K6's long-T threshold (B C <= 1024, T >= 128),
    where the card takes the long-T path; the CPU runs the plain scan."""
    B, T, H = 2, 130, 4
    assert scan_k.uses_long_t(B, T, H)
    rng = np.random.default_rng(60)
    lf = np.log(1 / (1 + np.exp(-rng.normal(3.0, 1.0, (B, T, H))))
                ).astype(np.float32)
    li = rng.normal(0.0, 2.0, (B, T, H)).astype(np.float32)
    # One reference program: the scan's two leaves -- A (a sum of lf) and
    # B (the max-plus leaf) -- and m, the max against m_0 = 0.
    jA, jB, jm = jax.jit(lambda lf, li: (
        *jforge.scan(jalg.MAXPLUS_AFFINE, (lf, li), axis=1),
        JR._mlstm_stabilizer(lf, li)))(jnp.asarray(lf), jnp.asarray(li))
    tlf, tli = torch.from_numpy(lf), torch.from_numpy(li)
    tA, tB = tforge.scan(talg.MAXPLUS_AFFINE, (tlf, tli), axis=1)
    _close(tA, jA, what="MAXPLUS_AFFINE A leaf")
    _close(tB, jB, what="MAXPLUS_AFFINE B leaf")
    _close(TR._mlstm_stabilizer(tlf, tli), jm, what="mlstm stabilizer m")


def test_params_from_jax_keeps_f32_leaves_by_path(xl):
    """bf16 weights; the mLSTM's gate projections and biases and the
    sLSTM's gate bias stay float32, while the conv's bias under
    ``mixer.conv`` takes bf16 like its kernel."""
    cfg_t = xl[0]
    _, _, params_j, _ = _f32(NAME)
    bf = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, "cpu",
                         torch.bfloat16)
    shapes = _shapes(bf)
    # Unit 0's mixer leaves by key ("w_up"), or parent.key ("conv.bias").
    mixer = {(path[-1] if path[-2] == "mixer" else f"{path[-2]}.{path[-1]}"):
             dtype for path, (_, dtype) in shapes.items()
             if path[:3] == ("decoder", "units", 0) and "mixer" in path}
    f32, bf16 = torch.float32, torch.bfloat16
    for key in ("w_igate", "w_fgate", "b_igate", "b_fgate", "bias"):
        assert mixer[key] == f32, key
    for key in ("w_up", "w_gate", "wq", "wk", "wv", "w_down", "skip_scale",
                "w_in", "r", "w_out", "conv.kernel", "conv.bias", "ffn.w_in",
                "ffn.w_out"):
        assert mixer[key] == bf16, key
    assert not keeps_f32(("decoder", "units", "mixer", "conv", "bias"))
    assert keeps_f32(("decoder", "units", "mixer", "bias"))
