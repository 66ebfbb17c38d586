"""Attention kernel K10 and its plain version.

* :func:`flash_attention` -- fused attention of q (N, S, d) against k (N,
  T, d) and v (N, T, dv), causal, sliding-window and soft-capped, in
  float32 or bfloat16
  (``csrc/flash_attention.cuh``; replaces
  ``repro/kernels/flash_attention.py::flash_attention_pallas``, whose
  signature it keeps);
* :func:`flash_attention_gqa` -- the same kernel in the models' layout, q
  (B, S, K, G, hd), k (B, T, K, hd) and v (B, T, K, dv): query head (k, g)
  reads kv head k in the kernel, never a broadcast copy.  Every GQA and
  MLA prefill of ``models/attention.py`` runs it on the cuda backend.

Plain versions: ``kernels/ref.py``'s :func:`~repro_torch.kernels.ref.
flash_attention_ref` and :func:`~repro_torch.kernels.ref.
flash_attention_gqa_ref`, with the reference kernel's semantics.  Given CPU
tensors, or under ``use_backend("torch")``, a wrapper runs its plain
version; given CUDA tensors it launches the kernel or raises.
``flash_attention_gqa.launches`` counts the kernel's launches through either
entry.  The kernel takes head_dim 16 to 256 in steps of 16, and a value
head dim ``dv`` of its own, 16 to head_dim in steps of 16 (MLA: q and k
192 wide, v 128); the output is v's width.  V is read at its own width,
never padded to q's.

The element type picks the kernel's body (:data:`BODIES`): bfloat16 runs
on the tensor cores (wgmma on a TMA ring), float32 on the CUDA cores,
whose 1e-5 bound rules out TF32.  That is a dispatch by dtype, not a
fallback: either body launches or raises.

``q_block`` and ``kv_block`` are the plain version's tiles.  ``q_block``
changes no result; ``kv_block`` sets the key tiles whose running maxima
the softmax rounds at, and both bodies' are fixed at :data:`KV_BLOCK`
keys, so on the card any other ``kv_block`` raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import intrinsics as ki
from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Q_BLOCK = 256       # the plain version's default query tile: no result
                    # depends on it
KV_BLOCK = 64       # keys per K/V tile of either body (csrc: BK)
# The body each element type runs in csrc/flash_attention.cuh (a unit's
# rt_flash_rows() gives the body's query rows per block).
BODIES = {torch.bfloat16: "TensorCores", torch.float32: "CudaCores"}


def flash_unit(dtype: torch.dtype, head_dim: int, what: str,
               v_head_dim: int | None = None) -> _lib.Unit:
    """The generated unit of K10 for ``dtype`` elements of q/k ``head_dim``
    and value ``v_head_dim`` (default: ``head_dim``), with the body
    :data:`BODIES` gives the dtype."""
    return _lib.unit("flash", what, dtypes=[dtype], head_dim=head_dim,
                     v_head_dim=v_head_dim, body=BODIES.get(dtype))


def _on_card(q: torch.Tensor) -> bool:
    return q.is_cuda and ki.current_backend(q) == "cuda"


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_block=Q_BLOCK, kv_block=KV_BLOCK):
    """K10: q (N, S, d), k (N, T, d) and v (N, T, dv) -> (N, S, dv)."""
    if not _on_card(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, q_block=q_block,
                                       kv_block=kv_block)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 3:
            raise ValueError(f"flash_attention (cuda): {name} must be "
                             f"(N, length, d), got {tuple(t.shape)}")
    out = _launch(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                  window, softcap, kv_block, "flash_attention (cuda)")
    return out[:, :, 0]


def flash_attention_gqa(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_block=Q_BLOCK, kv_block=KV_BLOCK):
    """K10 in the models' layout: q (B, S, K, G, hd), k (B, T, K, hd) and
    v (B, T, K, dv) -> (B, S, K, G, dv)."""
    if not _on_card(q):
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           q_block=q_block, kv_block=kv_block)
    what = "flash_attention_gqa (cuda)"
    if q.ndim != 5:
        raise ValueError(f"{what}: q must be (B, S, K, G, hd), got "
                         f"{tuple(q.shape)}")
    B, S, K, G, hd = q.shape
    out = _launch(q.reshape(B, S, K * G, hd), k, v, causal, window, softcap,
                  kv_block, what)
    return out.reshape(B, S, K, G, v.shape[-1])


def _launch(q, k, v, causal, window, softcap, kv_block, what):
    """q (B, S, H, d), k (B, T, K, d) and v (B, T, K, dv) with K dividing
    H -> (B, S, H, dv)."""
    if kv_block != KV_BLOCK:
        raise ValueError(f"{what}: the kernel's key tiles are {KV_BLOCK} "
                         f"keys, got kv_block={kv_block}")
    B, S, H, d = q.shape
    if k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3] \
            or k.shape[0] != B or k.shape[3] != d or H % k.shape[2] \
            or k.shape[1] == 0 or S == 0:
        raise ValueError(f"{what}: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)}: k must "
                         f"be (B, T >= 1, K, d) and v (B, T, K, dv) with K "
                         f"dividing q's heads, S >= 1")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{what}: q, k and v must share a dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"{what}: window must be >= 0, got {window}")
    dv = v.shape[3]
    unit = flash_unit(q.dtype, d, what, dv)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _lib.require_cuda(what, q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    lib = _lib.load(unit)
    T = k.shape[1]
    out = q.new_empty((B, S, H, dv))
    # The reference's key count of a row that keeps no key: its padded
    # kv tiles (kernels/ref.py: flash_attention_ref).
    kb = min(kv_block, -(-T // 8) * 8)
    empty_l = float(-(-T // kb) * kb)
    _lib.check(lib.rt_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H,
        k.shape[2], dv, int(bool(causal)), int(window), float(softcap),
        1.0 / math.sqrt(d), empty_l, _lib.stream_ptr(q)), what)
    flash_attention_gqa.launches += 1
    return out


flash_attention_gqa.launches = 0
