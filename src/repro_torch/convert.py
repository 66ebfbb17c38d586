"""Parameters of the JAX reference, as numpy arrays, into the port's layout.

``params_from_jax(tree_of_numpy, cfg, device, dtype)`` takes the tree of
``repro.models.lm.init_params`` with every leaf already converted to a numpy
array (``jax.tree.map(np.asarray, params)``), so this module imports nothing
of JAX.  It

* unstacks ``decoder.units`` (and an encoder-decoder's
  ``encoder.units``), which the reference stacks on a leading axis (its
  ``vmap`` init), into the port's list of per-unit tuples;
* casts every leaf to ``dtype``, except the leaves the reference keeps in
  float32, which stay float32: the norm scales, the RG-LRU's ``lam``,
  ``bias_a`` and ``bias_x``, the mLSTM's gate projections and biases, the
  sLSTM's gate ``bias`` and the MoE's ``router`` and ``router_bias`` -- by
  path, since the conv's ``bias`` (under ``mixer.conv``) takes the weight
  dtype.  An untied ``embed.unembed`` carries across with the rest, and
  so does deepseek-v3's ``mtp`` head, a single block (not stacked), whose
  MLA ``q_norm`` and ``kv_norm`` scales stay float32 by their ``scale``
  key as every norm's.

The same JAX parameters then give both packages the same function.
``quantized_from_jax`` does the same for a quantized matrix operand.

``state_from_jax(state, cfg, device)`` carries the reference's train state
(``repro.training.train_step.init_state``: float32 ``params``, the
optimizer's ``opt`` -- AdamW's ``mu`` and ``nu``, or Adafactor's ``v``
tree -- and ``step``) into the port's layout: params and AdamW's moments
unstacked as ``params_from_jax`` does, every leaf float32; Adafactor's
moments stay in the reference's layout, its units stacked, because they
are moments of the stacked leaves (``training/optimizer.py``).
``state_to_jax`` is its inverse, numpy leaves in the reference's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import operators as alg

F32_LEAVES = ("lam", "bias_a", "bias_x", "scale", "w_igate", "w_fgate",
              "b_igate", "b_fgate", "router", "router_bias")


def keeps_f32(path) -> bool:
    """Whether the leaf at ``path`` (its dict keys, outermost first) stays
    float32: a key of ``F32_LEAVES``, or the sLSTM's ``bias`` directly
    under its ``mixer`` (a conv's ``bias`` sits under ``mixer.conv``)."""
    return path[-1] in F32_LEAVES or tuple(path[-2:]) == ("mixer", "bias")


def _convert(node, path, device, dtype):
    if isinstance(node, dict):
        return {k: _convert(v, path + (k,), device, dtype)
                for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_convert(v, path, device, dtype) for v in node)
    t = torch.from_numpy(np.array(node, dtype=np.float32))
    return t.to(device=device,
                dtype=torch.float32 if keeps_f32(path) else dtype)


def _stacks(cfg) -> dict:
    """The stacks whose ``units`` the reference stacks, and their count."""
    stacks = {"decoder": cfg.n_units}
    if cfg.is_encdec:
        stacks["encoder"] = cfg.n_enc_layers
    return stacks


def params_from_jax(tree, cfg, device, dtype=torch.float32):
    """The port's parameter tree from the reference's (numpy leaves)."""
    out = _convert(tree, (), device, dtype)
    for name, n_units in _stacks(cfg).items():
        stack = dict(out[name])
        units = stack["units"]
        stack["units"] = [tuple(_index(blk, u) for blk in units)
                          for u in range(n_units)]
        out[name] = stack
    return out


def _host(node):
    if isinstance(node, dict):
        return {k: _host(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_host(v) for v in node)
    return node.detach().cpu().numpy()


def params_to_jax(tree, cfg) -> dict:
    """The reference's layout of a port tree (parameters, or an optimizer
    moment that mirrors them), numpy leaves, ``units`` stacked on a leading
    axis again."""
    out = _host(tree)
    for name in _stacks(cfg):
        stack = dict(out[name])
        units = stack["units"]
        stack["units"] = tuple(
            _stack([unit[j] for unit in units]) for j in range(len(units[0]))
        ) if units else ()
        out[name] = stack
    return out


def _stack(nodes):
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return np.stack(nodes)


def state_from_jax(state, cfg, device) -> dict:
    """The port's train state from the reference's (numpy leaves): float32
    params and optimizer moments in the port's layout, ``step`` an int32
    0-d tensor."""
    opt = {name: _convert(tree, (), device, torch.float32) if name == "v"
           else params_from_jax(tree, cfg, device)
           for name, tree in state["opt"].items()}
    return {"params": params_from_jax(state["params"], cfg, device),
            "opt": opt,
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def state_to_jax(state, cfg) -> dict:
    """The reference's layout of a port train state, numpy leaves."""
    return {"params": params_to_jax(state["params"], cfg),
            "opt": {name: _host(tree) if name == "v"
                    else params_to_jax(tree, cfg)
                    for name, tree in state["opt"].items()},
            "step": np.asarray(state["step"].cpu().numpy(), np.int32)}


def _index(node, i):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return node[i]


def quantized_from_jax(values, scales, block: int, mode: str,
                       device) -> alg.Quantized:
    """The port's :class:`~repro_torch.core.operators.Quantized` from the
    reference's (``values`` and ``scales`` as numpy arrays, ``block`` and
    ``mode`` its static fields): the same codes and scales, bit for bit."""
    if mode not in alg.QUANT_MODES:
        raise ValueError(f"mode {mode!r} not in {alg.QUANT_MODES}")
    codes = alg.QUANT_DEVICE[mode][0]
    v = torch.from_numpy(np.array(values))
    if v.dtype != codes:
        raise ValueError(f"{mode} codes are {codes}, got {v.dtype}")
    s = torch.from_numpy(np.array(scales, dtype=np.float32))
    return alg.Quantized(v.to(device), s.to(device), block=int(block),
                         mode=mode)
