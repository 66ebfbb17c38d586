"""The port's train step against the reference's ``make_train_step(cfg,
None, tc)`` on ``tests/test_training.py``'s ``small_cfg`` (minitron-4b
smoke) and ``small_train_cfg``, from the same state (``state_from_jax`` of
the reference's ``init_state``, at step 3 so that the learning rate is
not 0) and the same batch.

* Float32 (config and ``grad_dtype``): the metrics within rtol 1e-5, every
  optimizer moment within 1e-5 of its leaf's largest entry, every
  parameter within 1e-4: the same float32 sums in another order, and
  AdamW's update of a parameter whose gradient is near zero moves by a
  fraction of the learning rate (6e-3) when that gradient's last bits
  move.
* The configured bf16 (``grad_dtype="bfloat16"``): activations and
  gradients round to bf16 at the same points in both, but a float32
  difference of one ulp before a rounding moves a bf16 value by 2^-8 and
  passes through every layer, so the loss and grad norm are held at rtol
  1e-3 and the moments within 5e-2 of their leaf's largest entry.
* ``remat`` "none", "full" and "dots" give the same state to the bit (a
  recomputation repeats the forward exactly on the CPU), for minitron-4b
  and recurrentgemma-2b smoke; ``accum_steps=2`` over a batch of 8 equals
  one step over it (moments within 1e-5 of their largest entry,
  parameters within the reference test's 3e-2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as JC  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro.training.data import DataConfig, _host_batch  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.training import optimizer as TOPT  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401

OPT = dict(peak_lr=1e-2, warmup_steps=5, decay_steps=100, weight_decay=0.0)


def configs(name="minitron-4b", dtype=None):
    cj = JC.get_config(name, smoke=True)
    ct = TC.get_config(name, smoke=True)
    if dtype:
        cj, ct = (dataclasses.replace(c, dtype=dtype) for c in (cj, ct))
    return cj, ct


def train_cfgs(opt="adamw", **kw):
    return (JTS.TrainConfig(optimizer=JOPT.OptimizerConfig(name=opt, **OPT),
                            remat="none", **kw),
            TTS.TrainConfig(optimizer=TOPT.OptimizerConfig(name=opt, **OPT),
                            remat="none", **kw))


def batch_of(cfg, rows=4):
    return _host_batch(DataConfig(seq_len=16, global_batch=rows,
                                  vocab_size=cfg.vocab_size), cfg, 0)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def one_step(opt, grad_dtype, dtype):
    cj, ct = configs(dtype=dtype)
    tj, tt = train_cfgs(opt, grad_dtype=grad_dtype)
    sj = dict(JTS.init_state(jax.random.PRNGKey(42), cj, tj))
    sj["step"] = jnp.asarray(3, jnp.int32)
    st = state_from_jax(jax.tree.map(np.asarray, sj), ct, "cpu")
    batch = batch_of(cj)
    nj, mj = jax.jit(JTS.make_train_step(cj, None, tj))(
        sj, jax.tree.map(jnp.asarray, batch))
    nt, mt = TTS.make_train_step(ct, None, tt)(st, torch_batch(batch))
    return ct, nj, mj, nt, mt


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_one_step_against_reference(opt):
    ct, nj, mj, nt, mt = one_step(opt, "float32", "float32")
    assert set(mt) == set(mj)
    for k, v in mj.items():
        np.testing.assert_allclose(float(mt[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want, got = by_path(nj), by_path(state_to_jax(nt, ct))
    assert set(got) == set(want)
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        if path.startswith("['opt']"):
            assert err <= 1e-5 * float(np.abs(w).max()) + 1e-12, path
        else:
            assert err <= 1e-4, path
    assert int(nt["step"]) == 4

    ct, nj, mj, nt, mt = one_step(opt, "bfloat16", None)
    for k in ("loss", "ce_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-3,
                                   err_msg=k)
    want, got = by_path(nj["opt"]), by_path(state_to_jax(nt, ct)["opt"])
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        assert err <= 5e-2 * float(np.abs(w).max()) + 1e-12, path


def run_steps(name, tt, state, batch, steps=2):
    ct = TC.get_config(name, smoke=True)
    fn = TTS.make_train_step(ct, None, tt)
    for _ in range(steps):
        state, metrics = fn(state, batch)
    return state, metrics


@pytest.mark.parametrize("name", ["minitron-4b", "recurrentgemma-2b"])
def test_remat_settings_give_the_same_state(name):
    ct = TC.get_config(name, smoke=True)
    _, tt = train_cfgs()
    batch = torch_batch(batch_of(ct))
    states = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tt, remat=remat)
        states[remat], _ = run_steps(
            name, cfg, TTS.init_state(ct, cfg, device="cpu"), batch)
    flat = {k: torch.utils._pytree.tree_leaves(s) for k, s in states.items()}
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in
                   zip(flat[remat], flat["none"])), remat


def test_accum_steps_two_equals_one_step():
    ct = TC.get_config("minitron-4b", smoke=True)
    ct = dataclasses.replace(ct, dtype="float32")
    batch = torch_batch(batch_of(ct, rows=8))
    out = {}
    for na in (1, 2):
        _, tt = train_cfgs(accum_steps=na, grad_dtype="float32")
        st = TTS.init_state(ct, tt, device="cpu")
        st["step"].fill_(3)
        out[na], _ = TTS.make_train_step(ct, None, tt)(st, batch)
    for path, w in by_path(state_to_jax(out[1], ct)).items():
        g = by_path(state_to_jax(out[2], ct))[path]
        if path.startswith("['opt']"):
            assert float(np.abs(g - w).max()) <= \
                1e-5 * float(np.abs(w).max()) + 1e-12, path
        else:
            np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-2,
                                       err_msg=path)


def test_remat_recomputes_under_the_forward_s_backend():
    """A CUDA backward runs on the autograd engine's own thread, which sees
    no ``use_backend`` scope: the recomputation of a rematerialized unit
    must still take the forward's route (recurrentgemma-2b smoke, forward
    under ``use_backend("cuda")`` -- on CPU tensors the kernels' plain
    halves, while the data alone would pick the torch route -- the
    gradient taken on another thread, as the engine would; equal to the
    bit to the same thread's)."""
    import threading

    from repro_torch.core import intrinsics as ki
    from repro_torch.models import lm as tlm

    ct = TC.get_config("recurrentgemma-2b", smoke=True)
    _, tt = train_cfgs()
    params = TTS.init_state(ct, tt, device="cpu")["params"]
    batch = torch_batch(batch_of(ct))
    grads = []
    for threaded in (False, True):
        leaves = [p.detach().requires_grad_() for p in
                  torch.utils._pytree.tree_leaves(params)]
        tree = torch.utils._pytree.tree_unflatten(
            leaves, torch.utils._pytree.tree_structure(params))
        with ki.use_backend("cuda"):
            loss, _ = tlm.forward_train(tree, ct, batch, remat="full")
        box = {}

        def backward():
            box["g"] = torch.autograd.grad(loss, leaves)

        if threaded:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        grads.append(box["g"])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
