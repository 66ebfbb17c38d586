"""The training loop with fault tolerance (the port of
``repro.training.trainer``): checkpoint and restart, failure recovery,
straggler detection.

* Crash and restart: the loop resumes from the newest complete
  checkpoint; the step-indexed data replays exactly the right batches.
* Step failure (a device error, a non-finite loss, an injected fault): the
  step is retried from the last checkpoint up to ``max_retries`` times,
  skipping the poisoned batch.
* Stragglers: a step slower than ``straggler_factor`` times the median of
  the last 20 is counted and logged.

The train step updates the state in place, so a failed step's state is
never trusted: recovery reloads it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.training import checkpoint as CKPT
from repro_torch.training import train_step as TS
from repro_torch.training.data import SyntheticDataset


@dataclasses.dataclass
class RunConfig:
    total_steps: int = 100
    ckpt_dir: str = "repro_ckpt"
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    max_retries: int = 2
    straggler_factor: float = 3.0


class Trainer:
    def __init__(self, cfg, mesh, train_cfg: TS.TrainConfig,
                 run_cfg: RunConfig, dataset: SyntheticDataset,
                 step_fn: Callable | None = None,
                 fault_hook: Callable | None = None):
        self.cfg = cfg
        self.mesh = mesh
        self.train_cfg = train_cfg
        self.run_cfg = run_cfg
        self.dataset = dataset
        self.device = dataset.device
        self.fault_hook = fault_hook  # (step) -> None, may raise
        self.step_times: list = []
        self.straggler_steps: list = []
        self.recoveries = 0
        self.metrics_log: list = []
        self.step_fn = step_fn if step_fn is not None else \
            TS.make_train_step(cfg, mesh, train_cfg)
        self.ckpt = CKPT.AsyncCheckpointer(run_cfg.ckpt_dir,
                                           keep=run_cfg.keep_ckpts)

    # -- state ------------------------------------------------------------

    def _fresh(self):
        return TS.init_state(self.cfg, self.train_cfg, device=self.device)

    def init_or_restore(self):
        state = self._fresh()
        last = CKPT.latest_step(self.run_cfg.ckpt_dir)
        if last is not None:
            state = CKPT.restore(self.run_cfg.ckpt_dir, last, state)
            print(f"[trainer] restored step {last}", flush=True)
            return state, last
        return state, 0

    # -- loop --------------------------------------------------------------

    def run(self):
        state, start = self.init_or_restore()
        step = start
        skip_batches: set = set()
        while step < self.run_cfg.total_steps:
            data_step = step
            while data_step in skip_batches:
                data_step += 1
            batch = self.dataset.batch(data_step)
            t0 = time.time()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
            except Exception as e:  # noqa: BLE001 -- recovery path
                self.recoveries += 1
                if self.recoveries > self.run_cfg.max_retries:
                    raise
                print(f"[trainer] step {step} failed ({e}); recovering",
                      flush=True)
                skip_batches.add(data_step)
                self.ckpt.wait()
                del state
                state, step = self.init_or_restore()
                continue

            dt = time.time() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-20:]))
            if len(self.step_times) > 5 and \
                    dt > self.run_cfg.straggler_factor * med:
                self.straggler_steps.append(step)
                print(f"[trainer] straggler: step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s)", flush=True)

            step += 1
            if step % self.run_cfg.log_every == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["step_time_s"] = dt
                self.metrics_log.append(m)
                print(f"[trainer] step {step}: loss={m['loss']:.4f} "
                      f"ce={m.get('ce_loss', float('nan')):.4f} "
                      f"gnorm={m.get('grad_norm', float('nan')):.2f} "
                      f"({dt:.2f}s)", flush=True)
            if step % self.run_cfg.ckpt_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        CKPT.save(self.run_cfg.ckpt_dir, step, state)
        return state
