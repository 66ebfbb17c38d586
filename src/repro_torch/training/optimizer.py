"""Optimizers in plain PyTorch: AdamW and Adafactor, with clipping and the
learning-rate schedule (the port of ``repro.training.optimizer``).

The state mirrors the parameter tree leaf for leaf: AdamW's ``mu`` and
``nu``, Adafactor's ``v``, whose leaf for a parameter of rank >= 2 is the
factored ``{"vr", "vc"}`` (row and column means of the squared gradient)
and otherwise ``{"v"}``.  The reference has no kernel here, so neither has
the port.

An update runs in place under ``torch.no_grad()``: parameters and state
tensors are overwritten leaf by leaf, so the update holds one leaf's
temporaries beside the state, never a second copy of it.  Each leaf takes
the reference's operations in its order (``optimizer.py``'s
``adamw_update`` and ``adafactor_update``), one float32 rounding each: a
product and the sum it feeds round apart, never as one fused
multiply-add.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

Pytree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``min_lr_ratio``
    of it at ``decay_steps``; a float32 0-d tensor on ``step``'s device."""
    step = _step_f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm over every leaf, each leaf's sum of squares added
    in leaf order."""
    return torch.sqrt(sum(l.float().square().sum()
                          for l in pytree.tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    """(grads in float32 scaled to a global norm of at most ``max_norm``,
    the norm before).  Float32 leaves are scaled in place."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        clipped = pytree.tree_map(lambda g: g.float().mul_(scale)
                                  if g.dtype != torch.float32
                                  else g.mul_(scale), grads)
    return clipped, norm


def _write(p: torch.Tensor, update: torch.Tensor, lr: torch.Tensor) -> None:
    """p = p - lr update, rounded to p's dtype."""
    if p.dtype == torch.float32:
        p.sub_(update.mul_(lr))
    else:
        p.copy_((p.float() - update.mul_(lr)).to(p.dtype))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params):
    return {"mu": pytree.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params),
            "nu": pytree.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state, params, step):
    """One AdamW step in place; returns (params, state), the same trees."""
    lr = lr_schedule(cfg, step)
    t = _step_f32(step) + 1.0
    c1 = 1.0 - torch.pow(cfg.b1, t)
    c2 = 1.0 - torch.pow(cfg.b2, t)
    leaves = zip(pytree.tree_leaves(grads), pytree.tree_leaves(state["mu"]),
                 pytree.tree_leaves(state["nu"]), pytree.tree_leaves(params))
    for g, mu, nu, p in leaves:
        g = g.float()
        mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_(g.square().mul_(1 - cfg.b2))
        update = (mu / c1).div_(torch.sqrt(nu / c2).add_(cfg.eps))
        update.add_(p.float() * cfg.weight_decay)
        _write(p, update, lr)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
#
# The reference stacks a stack's units on a leading axis and factors those
# stacked leaves: a unit's norm scale (d,) is a (units, d) leaf there, with
# row and column moments, and its update is clipped to RMS <= 1 over all
# units at once.  The port keeps one tensor a unit, so it walks each
# ``units`` list as the reference's stacked leaves: the same leaf of every
# unit is stacked for the update (one block position's temporaries) and its
# moments are kept stacked, in the reference's layout.
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2


def _moment(shape, device) -> dict:
    def z(s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    if _factored(shape):
        return {"vr": z(shape[:-1]), "vc": z(shape[:-2] + shape[-1:])}
    return {"v": z(shape)}


def _is_units(key, node) -> bool:
    return key == "units" and isinstance(node, list)


def _stacked(nodes):
    """The units' same-placed subtrees ``nodes`` as one tree (tuples and
    dicts) whose leaves are lists of the units' tensors."""
    first = nodes[0]
    if isinstance(first, dict):
        return {k: _stacked([n[k] for n in nodes]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_stacked([n[i] for n in nodes])
                     for i in range(len(first)))
    return list(nodes)


def _groups(params, *trees, stacked=False):
    """(parameter tensors, each tree's node there, stacked) for every leaf
    of ``params``: one tensor, or (``stacked``) a unit stack's same-placed
    leaves, the reference's stacked leaf.  ``trees`` mirror ``params``,
    or (a moment tree) the reference's stacked layout of its units."""
    if isinstance(params, torch.Tensor) or stacked and \
            isinstance(params, list):
        yield (params if stacked else [params]), trees, stacked
    elif isinstance(params, dict):
        for k, node in params.items():
            if _is_units(k, node) and not stacked:
                if node:
                    yield from _groups(_stacked(node), *[
                        t[k] if isinstance(t[k], tuple) else _stacked(t[k])
                        for t in trees], stacked=True)
            else:
                yield from _groups(node, *[t[k] for t in trees],
                                   stacked=stacked)
    else:
        for i, node in enumerate(params):
            yield from _groups(node, *[t[i] for t in trees], stacked=stacked)


def adafactor_init(params):
    return {"v": _init(params)}


def _init(node, stacked=False):
    if isinstance(node, torch.Tensor):
        return _moment(node.shape, node.device)
    if stacked and isinstance(node, list):
        return _moment((len(node),) + node[0].shape, node[0].device)
    if isinstance(node, dict):
        return {k: ((_init(_stacked(v), True) if v else ())
                    if _is_units(k, v) and not stacked else _init(v, stacked))
                for k, v in node.items()}
    return tuple(_init(v, stacked) for v in node)


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads, state, params, step):
    """One Adafactor step in place (no momentum; update clipped to RMS <=
    1); returns (params, state), the same trees."""
    lr = lr_schedule(cfg, step)
    decay = 1.0 - (_step_f32(step) + 1.0) ** -0.8
    keep = 1 - decay
    eps = 1e-30
    for ps, (gs, v), stacked in _groups(params, grads, state["v"]):
        g = torch.stack([x.float() for x in gs]) if stacked else gs.float()
        g2 = g.square().add_(eps)
        if _factored(g.shape):
            vr, vc = v["vr"], v["vc"]
            vr.mul_(decay).add_(g2.mean(dim=-1).mul_(keep))
            vc.mul_(decay).add_(g2.mean(dim=-2).mul_(keep))
            rfac = torch.rsqrt(
                (vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps))
                .add_(eps))
            cfac = torch.rsqrt(vc + eps)
            update = (g * rfac[..., None]).mul_(cfac[..., None, :])
        else:
            v["v"].mul_(decay).add_(g2.mul_(keep))
            update = g * torch.rsqrt(v["v"] + eps)
        rms = torch.sqrt(update.square().mean() + eps)
        update.div_(torch.clamp(rms, min=1.0))
        for p, u in zip(ps, update if stacked else [update]):
            u.add_(p.float() * cfg.weight_decay)
            _write(p, u, lr)
    return params, state


def make_optimizer(cfg: OptimizerConfig):
    """(init, update): ``init(params)`` -> state; ``update(grads, state,
    params, step)`` -> (params, state), in place."""
    if cfg.name == "adamw":
        return adamw_init, lambda *a: adamw_update(cfg, *a)
    if cfg.name == "adafactor":
        return adafactor_init, lambda *a: adafactor_update(cfg, *a)
    raise ValueError(cfg.name)
