"""The port's Mixture-of-Experts against the JAX package.

``moe_forward`` on moonshot-v1-16b-a3b's smoke config in float32, with the
softmax router and the sigmoid one (its selection bias drawn nonzero), at
a capacity factor that keeps every assignment (C = 80 slots for 80
tokens) and at one so small that most assignments overflow their expert's
buffer: the selected experts are the reference's
``lax.top_k`` choice exactly, each assignment is kept or dropped exactly as
the reference's stable sort-based dispatch decides (both read from the
reference's own statements, ``repro/models/moe.py``, jitted), and the
output and the auxiliary losses agree within 1e-4 (float32 products in
another order).  The served test of ``test_torch_serving_models.py`` runs
moonshot-v1-16b-a3b's smoke config through both engines: identical greedy
streams, log-probabilities within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401
from test_torch_serving_models import serve_both  # noqa: E402
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_greedy_streams_identical_to_reference)
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_seq_logprobs_match_reference)
from test_torch_serving_models import (  # noqa: E402,F401,I001
    test_eos_stops_like_reference)

NAME = "moonshot-v1-16b-a3b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(**kw):
    return (dataclasses.replace(JC.get_config(NAME, smoke=True),
                                dtype="float32", **kw),
            dataclasses.replace(TC.get_config(NAME, smoke=True),
                                dtype="float32", **kw))


def _params(cfg_j, seed):
    """float32 numpy parameters in the reference's MoE tree (router bias
    included, so the sigmoid router's selection differs from its gates)."""
    shapes = jax.eval_shape(lambda k: JM.init_moe(k, cfg_j),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.normal(0.0, 0.3, s.shape).astype(np.float32), shapes)


def _reference_dispatch(params, cfg, x):
    """The reference's routing and capacity dispatch, its own statements
    (moe.py: the router, ``lax.top_k``, the stable argsort, the positions
    and the keep mask), with each assignment's keep flag returned in
    (token, choice) order."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xf = x.reshape(T, D)
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        params["router"])
    if cfg.router_type == "sigmoid":
        scores = jax.nn.sigmoid(logits)
        sel = scores + params["router_bias"][None, :]
        _, idx = jax.lax.top_k(sel, k)
    else:
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    C = JM._capacity(cfg, T)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * k, dtype=jnp.int32) - starts[se]
    keep = jnp.zeros((T * k,), bool).at[order].set(pos < C)
    return idx, keep.reshape(T, k)


@pytest.fixture(scope="module")
def ref_moe():
    """The reference's ``moe_forward`` and dispatch, each jitted once with
    the config static."""
    fwd = jax.jit(lambda p, x, cfg: JM.moe_forward(p, cfg, x),
                  static_argnums=2)
    dispatch = jax.jit(lambda p, x, cfg: _reference_dispatch(p, cfg, x),
                       static_argnums=2)
    return fwd, dispatch


def test_capacity_matches_reference():
    for cf in (0.25, 1.0, 1.25, 2.0):
        cfg_j, cfg_t = _configs(capacity_factor=cf)
        for T in (1, 4, 17, 80, 2100):
            assert TM._capacity(cfg_t, T) == JM._capacity(cfg_j, T), (cf, T)
    # moonshot's full width: one 2,100-token prompt, and four decode slots.
    full_j, full_t = JC.get_config(NAME), TC.get_config(NAME)
    assert TM._capacity(full_t, 2100) == JM._capacity(full_j, 2100) == 248
    assert TM._capacity(full_t, 4) == 8


@pytest.mark.parametrize("capacity_factor", [4.0, 0.25],
                         ids=["no-drops", "drops"])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_forward_matches_reference(ref_moe, router, capacity_factor):
    fwd, dispatch = ref_moe
    cfg_j, cfg_t = _configs(router_type=router,
                            capacity_factor=capacity_factor)
    tree = _params(cfg_j, 1)
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    x = np.random.default_rng(2).normal(
        0, 1, (2, 40, cfg_j.d_model)).astype(np.float32)
    y_j, aux_j = fwd(params_j, jnp.asarray(x), cfg_j)
    idx_j, keep_j = dispatch(params_j, jnp.asarray(x), cfg_j)
    xt = torch.from_numpy(x)
    _, _, _, idx_t = TM.route(params_t, cfg_t, xt.reshape(-1, cfg_t.d_model))
    keep_t = TM.dispatch(idx_t, cfg_t.n_experts,
                         TM._capacity(cfg_t, 80))[1].view(80, -1)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    dropped = int((~np.asarray(keep_j)).sum())       # of 160 assignments
    assert (dropped > 40) if capacity_factor < 1 else (dropped == 0)
    y_t, aux_t = TM.moe_forward(params_t, cfg_t, xt)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    for key in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]),
                                   **TOL)


@pytest.fixture(scope="module", params=[NAME])
def served(request):
    return serve_both(request.param)
