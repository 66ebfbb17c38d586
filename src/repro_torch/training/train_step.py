"""The train step (the port of ``repro.training.train_step``'s training
half).

``make_train_step(cfg, mesh, train_cfg)`` returns ``step_fn(state, batch)
-> (state, metrics)``:

* the loss casts every floating parameter to ``grad_dtype`` inside it (the
  reference's collective compression: bf16 activations and gradients),
  and ``torch.autograd`` takes the gradient of the float32 parameters
  through the cast;
* ``accum_steps`` > 1 splits the batch into microbatches along its first
  axis and sums their gradients in float32, then divides;
* the gradients are clipped to ``grad_clip`` by their global norm and the
  optimizer updates parameters and state in place;
* the metrics are ``forward_train``'s (the last microbatch's) plus
  ``grad_norm`` and ``lr``, float32 0-d tensors on the state's device.

The state is ``{"params", "opt", "step"}``; ``step_fn`` updates its tensors
in place and returns the same dict with ``step`` advanced.  Sharded
training (``mesh``) is the distributed layer's, which the port does not
have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.devices import resolve_device
from repro_torch.models import lm
from repro_torch.training import optimizer as OPT

Pytree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OPT.OptimizerConfig = OPT.OptimizerConfig()
    remat: str = "full"               # full | dots | none
    accum_steps: int = 1
    grad_dtype: str = "bfloat16"      # the dtype the loss computes in
    z_loss: float = 1e-4
    lb_coef: float = 0.01
    seed: int = 0


def init_state(cfg, train_cfg: TrainConfig, *, device=None) -> dict:
    """float32 parameters from ``train_cfg.seed`` (``lm.init_params``), the
    optimizer's zero state and step 0 (int32), on ``device`` (default: the
    CUDA device)."""
    dev = resolve_device(device)
    params = lm.init_params(cfg, seed=train_cfg.seed, device=dev)
    opt_init, _ = OPT.make_optimizer(train_cfg.optimizer)
    return {"params": params, "opt": opt_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def value_and_grad(cfg, train_cfg: TrainConfig, params, batch):
    """``forward_train``'s metrics (its ``loss`` among them) and the
    gradient of every parameter leaf, a list in the tree's leaf order with
    the tree's spec: every floating parameter is cast to
    ``train_cfg.grad_dtype`` inside the loss, and the gradient is the float32
    parameters' through the cast."""
    gdtype = getattr(torch, train_cfg.grad_dtype)
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
    low = [p.to(gdtype) if p.is_floating_point() else p for p in leaves]
    loss, metrics = lm.forward_train(
        pytree.tree_unflatten(low, spec), cfg, batch, remat=train_cfg.remat,
        z_loss=train_cfg.z_loss, lb_coef=train_cfg.lb_coef)
    got = iter(torch.autograd.grad(
        loss, [p for p in leaves if p.requires_grad], allow_unused=True))
    grads = []
    for p in leaves:
        g = next(got) if p.requires_grad else None
        # A parameter the loss does not reach (a selection bias) has a
        # zero gradient, as the reference's.
        grads.append(torch.zeros_like(p) if g is None else g)
    return {k: v.detach() for k, v in metrics.items()}, grads, spec


def make_train_step(cfg, mesh=None, train_cfg: TrainConfig = TrainConfig()):
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: sharded training (mesh=) needs the distributed "
            "layer, which the port does not have yet")
    _, opt_update = OPT.make_optimizer(train_cfg.optimizer)

    def train_step(state, batch):
        params = state["params"]
        na = train_cfg.accum_steps
        if na > 1:
            grads = None
            for i in range(na):
                mb = {k: v.reshape((na, v.shape[0] // na) + v.shape[1:])[i]
                      for k, v in batch.items()}
                metrics, g, spec = value_and_grad(cfg, train_cfg, params, mb)
                g = [x.float() for x in g]
                grads = g if grads is None else [
                    a.add_(b) for a, b in zip(grads, g)]
            grads = [g / na for g in grads]
        else:
            metrics, grads, spec = value_and_grad(cfg, train_cfg, params,
                                                  batch)
        grads = pytree.tree_unflatten(grads, spec)
        grads, gnorm = OPT.clip_by_global_norm(
            grads, train_cfg.optimizer.grad_clip)
        step = state["step"]
        lr = OPT.lr_schedule(train_cfg.optimizer, step)
        opt_update(grads, state["opt"], params, step)
        del grads
        state["step"] = step + 1
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return state, metrics

    return train_step
