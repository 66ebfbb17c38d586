"""The port's checkpoints and trainer (``repro_torch.training.checkpoint``,
``trainer``) against the reference's schema and behaviour.

* A checkpoint the reference writes restores into the port
  (``restore`` by the reference's paths, then ``convert.state_from_jax``),
  and one the port writes in the reference's layout restores into the
  reference: both to the bit.
* The manifest: one ``.npy`` per leaf, each path with its shape and dtype;
  ``step_N.tmp`` never visible as a checkpoint; ``cleanup`` keeps the
  newest; the asynchronous saver writes the state as it was when called,
  though the caller then changes it in place.
* The trainer (minitron-4b smoke on the CPU): an injected fault is
  recovered from the newest checkpoint; a run cut at step 6 and resumed to
  10 ends in the state of an uncut run of 10 steps, to the bit.
"""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as JC  # noqa: E402
from repro.training import checkpoint as JCKPT  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.configs import base as TC  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training import optimizer as TOPT  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticDataset  # noqa: E402
from repro_torch.training.trainer import RunConfig, Trainer  # noqa: E402
from test_torch_models import one_torch_thread  # noqa: E402,F401


def leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def equal(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_reference_checkpoints_cross_both_ways(tmp_path, opt):
    cj = JC.get_config("minitron-4b", smoke=True)
    ct = TC.get_config("minitron-4b", smoke=True)
    tj = JTS.TrainConfig(optimizer=JOPT.OptimizerConfig(name=opt))
    ref = JTS.init_state(jax.random.PRNGKey(1), cj, tj)
    ref = jax.tree.map(lambda x: x + 0.5 if x.dtype == np.float32 else x + 7,
                       ref)
    ref_np = jax.tree.map(np.asarray, ref)
    want = state_from_jax(ref_np, ct, "cpu")
    JCKPT.save(str(tmp_path / "ref"), 7, ref)
    assert CKPT.latest_step(str(tmp_path / "ref")) == 7
    got = CKPT.restore(str(tmp_path / "ref"), 7, state_to_jax(want, ct))
    got = state_from_jax(jax.tree.map(np.asarray, got), ct, "cpu")
    assert equal(got, want) and int(got["step"]) == 7

    CKPT.save(str(tmp_path / "port"), 7, state_to_jax(want, ct))
    back = JCKPT.restore(str(tmp_path / "port"), 7,
                         jax.tree.map(lambda x: x, ref))
    assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
               zip(jax.tree.leaves(back), jax.tree.leaves(ref)))


def test_manifest_atomicity_cleanup_and_async(tmp_path):
    rng = np.random.default_rng(0)
    state = {"params": {"w": torch.from_numpy(rng.standard_normal((4, 3))
                                              .astype(np.float32)),
                        "units": [(torch.ones(2),), (torch.zeros(2),)]},
             "step": torch.tensor(5, dtype=torch.int32)}
    d = str(tmp_path / "c")
    path = CKPT.save(d, 5, state)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 5
    assert man["leaves"]["params.w"]["shape"] == [4, 3]
    assert man["leaves"]["params.w"]["dtype"] == "float32"
    assert man["leaves"]["params.units.1.0"]["shape"] == [2]
    assert man["leaves"]["step"] == {"file": man["leaves"]["step"]["file"],
                                     "shape": [], "dtype": "int32"}
    assert sorted(os.listdir(path)) == sorted(
        ["manifest.json"] + [m["file"] for m in man["leaves"].values()])
    assert equal(CKPT.restore(d, 5, state), state)
    os.makedirs(os.path.join(d, "step_9.tmp"))
    assert CKPT.latest_step(d) == 5
    for s in (6, 7, 8):
        CKPT.save(d, s, state)
    CKPT.cleanup(d, keep=2)
    assert CKPT.latest_step(d) == 8
    assert sorted(x for x in os.listdir(d) if not x.endswith(".tmp")) == \
        ["step_7", "step_8"]
    saver = CKPT.AsyncCheckpointer(d, keep=3)
    before = state["params"]["w"].clone()
    saver.save(10, state)
    state["params"]["w"].add_(1.0)          # the next step, in place
    saver.wait()
    got = CKPT.restore(d, 10, state)
    assert torch.equal(got["params"]["w"], before)


def run_cfgs(tmp_path, total, **kw):
    cfg = TC.get_config("minitron-4b", smoke=True)
    tc = TTS.TrainConfig(optimizer=TOPT.OptimizerConfig(
        peak_lr=1e-2, warmup_steps=5, decay_steps=100, weight_decay=0.0),
        remat="none")
    data = SyntheticDataset(DataConfig(seq_len=16, global_batch=4,
                                       vocab_size=cfg.vocab_size), cfg,
                            device="cpu")
    run = RunConfig(total_steps=total, ckpt_dir=str(tmp_path), log_every=100,
                    **kw)
    return cfg, tc, run, data


def test_trainer_recovers_from_injected_fault(tmp_path):
    cfg, tc, run, data = run_cfgs(tmp_path / "ckpt", 12, ckpt_every=4,
                                  max_retries=2)
    boom = {"armed": True}

    def fault_hook(step):
        if step == 6 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    t = Trainer(cfg, None, tc, run, data, fault_hook=fault_hook)
    state = t.run()
    assert t.recoveries == 1 and int(state["step"]) == 12
    assert CKPT.latest_step(run.ckpt_dir) == 12


def test_trainer_resume_equals_an_uncut_run(tmp_path):
    cfg, tc, run, data = run_cfgs(tmp_path / "cut", 6, ckpt_every=3)
    Trainer(cfg, None, tc, run, data).run()
    run.total_steps = 10
    resumed = Trainer(cfg, None, tc, run, data).run()
    cfg, tc, run, data = run_cfgs(tmp_path / "uncut", 10, ckpt_every=3)
    uncut = Trainer(cfg, None, tc, run, data).run()
    assert int(resumed["step"]) == 10 and equal(resumed, uncut)
