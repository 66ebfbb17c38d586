"""Parameters of the JAX reference, as numpy arrays, into the port's layout.

``params_from_jax(tree_of_numpy, cfg, device, dtype)`` takes the tree of
``repro.models.lm.init_params`` with every leaf already converted to a numpy
array (``jax.tree.map(np.asarray, params)``), so this module imports nothing
of JAX.  It

* unstacks ``decoder.units``, which the reference stacks on a leading axis
  (its ``vmap`` init), into the port's list of per-unit tuples;
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


def params_from_jax(tree, cfg, device, dtype=torch.float32):
    """The port's parameter tree from the reference's (numpy leaves)."""
    out = _convert(tree, (), device, dtype)
    dec = dict(out["decoder"])
    units = dec["units"]
    dec["units"] = [tuple(_index(blk, u) for blk in units)
                    for u in range(cfg.n_units)]
    out["decoder"] = dec
    return out


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
