"""The port's training forward against the reference's: ``forward_train``'s
loss, its metrics and the gradient of every parameter leaf
(``torch.autograd`` against the jitted ``jax.value_and_grad``).

Float32 smoke configs: the same numpy parameters (``test_torch_models``'s
``numpy_params``) and the same batch (the reference's ``_host_batch``, 2
rows of 16 tokens) go into both packages.  Loss and metrics are held at
rtol 1e-4, each gradient leaf within 1e-4 of its largest entry (plus
1e-7): float32 sums reassociate between XLA and PyTorch, and the
gradient's chain through a few layers and the unembedding amplifies that
by a few ulps at most.  The port runs ``remat="full"`` (each unit
recomputed in its backward), the reference ``remat="none"``: neither
changes a value.  xLSTM is held on its loss alone: its gradient is the
same composition of ported pieces, and its sLSTM loop is the reference's
slowest program to compile.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.training.data import DataConfig, _host_batch  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_models import numpy_params  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

GRAD_CASES = ("minitron-4b", "recurrentgemma-2b", "moonshot-v1-16b-a3b",
              "deepseek-v3-671b", "seamless-m4t-medium")
RTOL = 1e-4


def setup(name):
    cfg_j = dataclasses.replace(JC.get_config(name, smoke=True),
                                dtype="float32")
    cfg_t = dataclasses.replace(TC.get_config(name, smoke=True),
                                dtype="float32")
    tree = numpy_params(cfg_j, 0)
    batch = _host_batch(DataConfig(seq_len=16, global_batch=2,
                                   vocab_size=cfg_j.vocab_size, seed=3),
                        cfg_j, 0)
    return cfg_j, cfg_t, tree, batch


def port_loss(cfg_t, tree, batch, remat="full"):
    params = params_from_jax(tree, cfg_t, "cpu")
    leaves = [p.requires_grad_() for p in
              torch.utils._pytree.tree_leaves(params)]
    loss, metrics = tlm.forward_train(
        params, cfg_t, {k: torch.from_numpy(np.asarray(v))
                        for k, v in batch.items()}, remat=remat)
    return params, leaves, loss, metrics


def check_metrics(metrics_t, metrics_j):
    assert set(metrics_t) == set(metrics_j)
    for k, v in metrics_j.items():
        np.testing.assert_allclose(metrics_t[k].item(), float(v), rtol=RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_forward_train_loss_metrics_and_every_gradient(name):
    """Loss and metrics (``ce_loss``, ``lb_loss``, ``router_z``,
    ``mtp_loss`` where the config has its head, ``loss``) and the
    gradient of every leaf by path, the port's units stacked back into the
    reference's layout (``convert.params_to_jax``).  A leaf the loss does
    not reach (deepseek-v3's selection bias) has the reference's zero
    gradient."""
    cfg_j, cfg_t, tree, batch = setup(name)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.forward_train(p, cfg_j, b, remat="none"),
        has_aux=True))
    (loss_j, metrics_j), grads_j = fn(jax.tree.map(jnp.asarray, tree),
                                      jax.tree.map(jnp.asarray, batch))
    params, leaves, loss, metrics = port_loss(cfg_t, tree, batch)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    check_metrics(metrics, metrics_j)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g
           for p, g in zip(leaves, got)]
    spec = torch.utils._pytree.tree_structure(params)
    grads_t = params_to_jax(torch.utils._pytree.tree_unflatten(got, spec),
                            cfg_t)
    want = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    have = {jax.tree_util.keystr(p): g for p, g in
            jax.tree_util.tree_flatten_with_path(grads_t)[0]}
    assert set(have) == set(want)
    for path, g in want.items():
        assert have[path].shape == g.shape, path
        bound = RTOL * float(np.abs(g).max()) + 1e-7
        err = float(np.abs(have[path] - g).max())
        assert err <= bound, f"{name} {path}: {err} > {bound}"


def test_xlstm_forward_train_loss():
    """xlstm-1.3b smoke: loss and metrics of ``forward_train``."""
    cfg_j, cfg_t, tree, batch = setup("xlstm-1.3b")
    loss_j, metrics_j = jax.jit(
        lambda p, b: jlm.forward_train(p, cfg_j, b, remat="none"))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    _, _, loss, metrics = port_loss(cfg_t, tree, batch, remat="none")
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    check_metrics(metrics, metrics_j)
