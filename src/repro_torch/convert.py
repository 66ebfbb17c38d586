"""Parameters of the JAX reference, as numpy arrays, into the port's layout.

``params_from_jax(tree_of_numpy, cfg, device, dtype)`` takes the tree of
``repro.models.lm.init_params`` with every leaf already converted to a numpy
array (``jax.tree.map(np.asarray, params)``), so this module imports nothing
of JAX.  It

* unstacks ``decoder.units``, which the reference stacks on a leading axis
  (its ``vmap`` init), into the port's list of per-unit tuples;
* casts every leaf to ``dtype``, except the leaves the reference keeps in
  float32 -- ``lam``, ``bias_a``, ``bias_x`` and the norm scales -- which
  stay float32.

The same JAX parameters then give both packages the same function.
``quantized_from_jax`` does the same for a quantized matrix operand.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import operators as alg

F32_LEAVES = ("lam", "bias_a", "bias_x", "scale")


def _convert(node, key, device, dtype):
    if isinstance(node, dict):
        return {k: _convert(v, k, device, dtype) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_convert(v, key, device, dtype) for v in node)
    t = torch.from_numpy(np.array(node, dtype=np.float32))
    return t.to(device=device,
                dtype=torch.float32 if key in F32_LEAVES else dtype)


def params_from_jax(tree, cfg, device, dtype=torch.float32):
    """The port's parameter tree from the reference's (numpy leaves)."""
    out = _convert(tree, None, device, dtype)
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
