"""The port's optimizers, loss and data against the reference's
(``repro.training.optimizer``, ``layers.softmax_cross_entropy``,
``repro.training.data``), on numpy inputs from a seed.

* AdamW and Adafactor: three updates from carried state (the port's in
  place, the reference's jitted) hold parameters and every moment within
  rtol 1e-5 (atol 1e-7): the same float32 operations in the same order,
  XLA's and PyTorch's ``pow``, ``sqrt`` and means a few ulps apart.
* ``lr_schedule`` and the clip within 1e-6; the two quadratics the
  reference's tests minimise are minimised to the same thresholds.
* ``softmax_cross_entropy`` with the z-loss and masked labels: the value
  and its gradient within 1e-5 of ``jax.value_and_grad``'s.
* Batches: ``SyntheticDataset.batch`` equals the reference's
  ``_host_batch`` to the bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as TOPT  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

SHAPES = {"w": (6, 5), "stack": (3, 4, 2), "b": (7,)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_three_steps_from_carried_state(name):
    """Parameters and state after three updates, each from the state the
    last one left, at steps 4, 5, 6 (inside the warmup and past it), with
    weight decay."""
    cfg_kw = dict(name=name, peak_lr=1e-2, warmup_steps=5, decay_steps=50,
                  weight_decay=0.1)
    jinit, jupd = JOPT.make_optimizer(JOPT.OptimizerConfig(**cfg_kw))
    tinit, tupd = TOPT.make_optimizer(TOPT.OptimizerConfig(**cfg_kw))
    rng = np.random.default_rng(3)
    pj = _tree(rng)
    pt = _t(pj)
    pj = jax.tree.map(jnp.asarray, pj)
    sj, st = jinit(pj), tinit(pt)
    jupd = jax.jit(jupd)
    for step in (4, 5, 6):
        g = _tree(rng, 0.3)
        pj, sj = jupd(jax.tree.map(jnp.asarray, g), sj, pj,
                      jnp.asarray(step, jnp.int32))
        pt, st = tupd(_t(g), st, pt, torch.tensor(step, dtype=torch.int32))
    want = jax.tree_util.tree_flatten_with_path((pj, sj))[0]
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(
               jax.tree.map(lambda t: t.numpy(), (pt, st)))[0]}
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)],
                                   np.asarray(w), rtol=1e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_lr_schedule_and_clip():
    cfg_kw = dict(peak_lr=1.0, warmup_steps=10, decay_steps=100,
                  min_lr_ratio=0.1)
    jc, tc = JOPT.OptimizerConfig(**cfg_kw), TOPT.OptimizerConfig(**cfg_kw)
    for s in (0, 5, 10, 37, 50, 100, 200):
        np.testing.assert_allclose(
            float(TOPT.lr_schedule(tc, torch.tensor(s))),
            float(JOPT.lr_schedule(jc, jnp.asarray(s))), rtol=1e-6)
    g = _tree(np.random.default_rng(5))
    clipped_j, norm_j = JOPT.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    clipped_t, norm_t = TOPT.clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped_t[k].numpy(),
                                   np.asarray(clipped_j[k]), rtol=1e-6,
                                   atol=1e-8)
    np.testing.assert_allclose(float(TOPT.global_norm(clipped_t)), 1.0,
                               rtol=1e-5)
    small, _ = TOPT.clip_by_global_norm({"a": torch.tensor([0.3, 0.4])}, 1.0)
    assert torch.equal(small["a"], torch.tensor([0.3, 0.4]))


@pytest.mark.parametrize("name,shape,steps,thresh", [
    ("adamw", (2,), 150, 0.05), ("adafactor", (4, 3), 200, 0.1)])
def test_minimizes_quadratic(name, shape, steps, thresh):
    """The reference's two quadratics (``tests/test_training.py``), each
    to the reference's threshold."""
    cfg = TOPT.OptimizerConfig(name=name, peak_lr=0.1, warmup_steps=0,
                               decay_steps=steps + 100, weight_decay=0.0)
    init, update = TOPT.make_optimizer(cfg)
    w = torch.tensor([3.0, -2.0]) if shape == (2,) else torch.full(shape, 2.)
    params = {"w": w}
    state = init(params)
    for step in range(steps):
        params, state = update({"w": 2.0 * params["w"]}, state, params,
                               torch.tensor(step))
    assert float(params["w"].abs().max()) < thresh


def test_softmax_cross_entropy_z_loss_and_masked_labels():
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 6] = -5
    fn = jax.jit(jax.value_and_grad(
        lambda x: jL.softmax_cross_entropy(x, jnp.asarray(labels),
                                           z_loss=1e-2)))
    want, want_g = fn(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tL.softmax_cross_entropy(x, torch.from_numpy(labels), z_loss=1e-2)
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)
    assert float(got_g[0, :3].abs().max()) == 0.0
    none = tL.softmax_cross_entropy(x, torch.full((3, 7), -1))
    assert none.item() == 0.0


@pytest.mark.parametrize("name", ["minitron-4b", "seamless-m4t-medium",
                                  "internvl2-76b"])
def test_batches_bit_exact(name):
    """Tokens, labels and, where the config takes them, ``src_embeds`` and
    ``vision_embeds``: the reference's host batch to the bit, on the
    device asked for."""
    cfg_j = JC.get_config(name, smoke=True)
    cfg_t = TC.get_config(name, smoke=True)
    kw = dict(seq_len=24, global_batch=3, vocab_size=cfg_j.vocab_size,
              seed=7)
    ds = tdata.SyntheticDataset(tdata.DataConfig(**kw), cfg_t, device="cpu")
    assert dataclasses.asdict(ds.cfg) == dataclasses.asdict(
        jdata.DataConfig(**kw))
    for step in (0, 123):
        want = jdata._host_batch(jdata.DataConfig(**kw), cfg_j, step)
        got = ds.batch(step)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].device.type == "cpu"
            assert got[k].numpy().dtype == w.dtype
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    b = ds.host_batch(5)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
