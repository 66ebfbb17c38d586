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

The gradient: where grad mode is on and q, k or v requires grad, both
entries run through :class:`Attention`, an ``autograd.Function`` whose
forward is K10 writing each row's log-sum-exp too, and whose backward is
:func:`flash_attention_bwd` (``csrc/flash_attention_bwd.cuh`` on its
dtype's body, bf16 on the tensor cores with the host plan
:func:`bwd_plan`; a call counts once in ``flash_attention_bwd.launches``;
plain version ``ref.flash_attention_bwd_ref``, which it runs on CPU
tensors).  Without grad the forward writes no log-sum-exp, as serving has
it.
``flash_attention_gqa.launches`` counts the kernel's launches through either
entry, and ``unit_launches`` the same launches by unit label.  The kernel takes head_dim 16 to 256 in steps of 16, and a value
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

import dataclasses
import math

import torch

from repro_torch.core import intrinsics as ki
from repro_torch.kernels import _lib
from repro_torch.kernels import matvec as matvec_k
from repro_torch.kernels import ref

Q_BLOCK = 256       # the plain version's default query tile: no result
                    # depends on it
KV_BLOCK = 64       # keys per K/V tile of either body (csrc: BK)
# The body each element type runs in csrc/flash_attention.cuh (a unit's
# rt_flash_rows() gives the body's query rows per block).
BODIES = {torch.bfloat16: "TensorCores", torch.float32: "CudaCores"}
unit_launches: dict[str, int] = {}


def flash_unit(dtype: torch.dtype, head_dim: int, what: str,
               v_head_dim: int | None = None) -> _lib.Unit:
    """The generated unit of K10 for ``dtype`` elements of q/k ``head_dim``
    and value ``v_head_dim`` (default: ``head_dim``), with the body
    :data:`BODIES` gives the dtype."""
    return _lib.unit("flash", what, dtypes=[dtype], head_dim=head_dim,
                     v_head_dim=v_head_dim, body=BODIES.get(dtype))


def flash_bwd_unit(dtype: torch.dtype, head_dim: int, what: str,
                   v_head_dim: int | None = None) -> _lib.Unit:
    """The generated unit of K10's gradient for ``dtype`` elements, with
    the body :data:`BODIES` gives the dtype."""
    return _lib.unit("flash_bwd", what, dtypes=[dtype], head_dim=head_dim,
                     v_head_dim=v_head_dim, body=BODIES.get(dtype))


# The gradient's tensor-core dkv launch: blocks of 64 keys; the host splits
# a key tile's work over more blocks where B KH ceil(T / 64) of them would
# leave SMs idle.
BWD_KEYS = 64
BWD_ROWS = 128          # the rows workspace pads S to a multiple of this


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The launch plan of K10's gradient (:func:`bwd_plan`).  ``splits``:
    the dkv blocks each key tile's (query head, query tile) work is split
    over; ``blocks``: the dkv launch's blocks; ``partials``: the float32
    partial tiles (64 keys by hd + dv) the split blocks write; the
    workspace (the rows' D and lse, then the partials) in float32 floats;
    ``counters``: the ticket words of the split's fold."""

    splits: int
    blocks: int
    partials: int
    workspace_floats: int
    counters: int

    @property
    def workspace_bytes(self) -> int:
        return 4 * self.workspace_floats


def query_tiles(k0: int, S: int, T: int, causal: bool,
                window: int) -> list[int]:
    """The 64-row query tiles the dkv blocks of the key tile at ``k0``
    visit, in order (``csrc/flash_attention_bwd.cuh``: QueryTiles): those
    whose rows may keep one of its keys, then those whose rows keep no key
    at all, each once."""
    tile = BWD_KEYS
    eb = min(T + window - 1, S) if window else S
    klast = min(k0 + tile, T) - 1
    qb = k0 if causal else 0
    qe = min(min(klast + window, S) if window else S, eb)
    t0, t1 = qb // tile, (-(-qe // tile) if qb < qe else qb // tile)
    e0, e1 = eb // tile, (-(-S // tile) if eb < S else eb // tile)
    if t1 == t0:
        t0, t1, e0 = e0, e1, e1
    elif e0 < e1 and e0 <= t1:
        t1, e0 = max(t1, e1), e1
    return [*range(t0, t1), *range(e0, e1)]


def bwd_plan(B: int, S: int, T: int, H: int, KH: int, hd: int, dv: int,
             causal: bool, window: int, body: str, sms: int = 132) -> BwdPlan:
    """The host's plan of one K10 gradient on the card.  The CUDA-core body
    keeps its two launches: the workspace holds D, (B, S, H) floats.  The
    tensor-core body: the rows (D and lse log2 e, (B, H, S rounded up to
    128) each), and, where the B KH ceil(T / 64) dkv blocks (one a key
    tile) would leave some of the ``sms`` SMs idle (recurrentgemma-2b's one
    kv head: 64 key tiles), each key tile's G x (its query tiles) items
    split over ``splits`` blocks -- enough for two blocks an SM, at most
    the largest key tile's items -- with a partial tile apiece and a ticket
    word a key tile."""
    if body == "CudaCores":
        return BwdPlan(1, -(-T // 32) * B * KH, 0, B * S * H, 0)
    nkt = -(-T // BWD_KEYS)
    n0 = B * KH * nkt
    splits = 1
    if n0 < sms:
        items = (H // KH) * max(len(query_tiles(kt * BWD_KEYS, S, T, causal,
                                                window)) for kt in range(nkt))
        splits = max(1, min(items, -(-2 * sms // n0)))
    partials = n0 * splits if splits > 1 else 0
    rows = 2 * B * H * (-(-S // BWD_ROWS) * BWD_ROWS)
    return BwdPlan(splits, n0 * splits, partials,
                   rows + partials * BWD_KEYS * (hd + dv),
                   n0 if splits > 1 else 0)


def _on_card(q: torch.Tensor) -> bool:
    return q.is_cuda and ki.current_backend(q) == "cuda"


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_block=Q_BLOCK, kv_block=KV_BLOCK):
    """K10: q (N, S, d), k (N, T, d) and v (N, T, dv) -> (N, S, dv)."""
    if not _on_card(q) and not _needs_grad(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, q_block=q_block,
                                       kv_block=kv_block)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 3:
            raise ValueError(f"flash_attention (cuda): {name} must be "
                             f"(N, length, d), got {tuple(t.shape)}")
    out = _attend(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                  window, softcap, kv_block, "flash_attention (cuda)")
    return out[:, :, 0]


def flash_attention_gqa(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_block=Q_BLOCK, kv_block=KV_BLOCK):
    """K10 in the models' layout: q (B, S, K, G, hd), k (B, T, K, hd) and
    v (B, T, K, dv) -> (B, S, K, G, dv)."""
    if not _on_card(q) and not _needs_grad(q, k, v):
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           q_block=q_block, kv_block=kv_block)
    what = "flash_attention_gqa (cuda)"
    if q.ndim != 5:
        raise ValueError(f"{what}: q must be (B, S, K, G, hd), got "
                         f"{tuple(q.shape)}")
    B, S, K, G, hd = q.shape
    out = _attend(q.reshape(B, S, K * G, hd), k, v, causal, window, softcap,
                  kv_block, what)
    return out.reshape(B, S, K, G, v.shape[-1])


def _attend(q, k, v, causal, window, softcap, kv_block, what):
    """K10 in the kernel's layout, through :class:`Attention` where a
    gradient is wanted."""
    if _needs_grad(q, k, v):
        return Attention.apply(q, k, v, causal, window, softcap, kv_block)
    return _launch(q, k, v, causal, window, softcap, kv_block, what)[0]


class Attention(torch.autograd.Function):
    """K10 with its gradient, in the kernel's layout: q (B, S, H, d), k
    (B, T, K, d), v (B, T, K, dv).  The forward keeps q, k, v, out and the
    rows' log-sum-exp; the backward is :func:`flash_attention_bwd`.  On
    CPU tensors both halves run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, kv_block):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                       softcap=softcap, kv_block=kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        # The backward runs where the forward did: the autograd engine's
        # thread sees no use_backend() scope.
        ctx.args = (causal, window, softcap, kv_block,
                    ki.current_backend(q))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, kv_block, backend = ctx.args
        with ki.use_backend(backend):
            dq, dk, dv = flash_attention_bwd(
                q, k, v, out, lse, dout, causal=causal, window=window,
                softcap=softcap, kv_block=kv_block)
        return dq, dk, dv, None, None, None, None


def flash_attention_lse(q, k, v, *, causal=True, window=0, softcap=0.0,
                        kv_block=KV_BLOCK):
    """K10 in the kernel's layout, q (B, S, H, d), k (B, T, K, d) and v
    (B, T, K, dv), with each row's log-sum-exp: (out (B, S, H, dv), lse
    (B, S, H) float32), the forward half of :class:`Attention`."""
    if _on_card(q):
        return _launch(q, k, v, causal, window, softcap, kv_block,
                       "flash_attention (cuda)", with_lse=True)
    B, S, H, d = q.shape
    out, lse = ref.flash_attention_gqa_ref(
        q.reshape(B, S, k.shape[2], -1, d), k, v, causal=causal,
        window=window, softcap=softcap, kv_block=kv_block, return_lse=True)
    return out.reshape(B, S, H, v.shape[3]), lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        softcap=0.0, kv_block=KV_BLOCK):
    """K10's gradient (dq, dk, dv) in the kernel's layout (see
    :func:`ref.flash_attention_bwd_ref`): on the card one call of
    ``csrc/flash_attention_bwd.cuh`` on the body :data:`BODIES` gives the
    dtype, with the workspace :func:`bwd_plan` sizes (bf16: the rows' D and
    lse, dq over query tiles, dk and dv over key tiles, split and folded
    where the key tiles would not fill the card; float32: dq (and D), then
    dk and dv); given CPU tensors its plain version."""
    empty_l = ref.flash_empty_l(k.shape[1], kv_block)
    if not _on_card(q):
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, window=window,
                                           softcap=softcap, empty_l=empty_l)
    what = "flash_attention_bwd (cuda)"
    _check(q, k, v, window, kv_block, what)
    B, S, H, d = q.shape
    T, KH, dvw = k.shape[1], k.shape[2], v.shape[3]
    if out.shape != (B, S, H, dvw) or dout.shape != out.shape or \
            lse.shape != (B, S, H) or lse.dtype != torch.float32 or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"{what}: out and dout must be {(B, S, H, dvw)} "
                         f"{q.dtype} and lse {(B, S, H)} float32, got "
                         f"{tuple(out.shape)} {out.dtype}, "
                         f"{tuple(dout.shape)} {dout.dtype} and "
                         f"{tuple(lse.shape)} {lse.dtype}")
    unit = flash_bwd_unit(q.dtype, d, what, dvw)
    q, k, v, out, lse, dout = (t.contiguous()
                               for t in (q, k, v, out, lse, dout))
    _lib.require_cuda(what, q, k, v, out, lse, dout)
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    lib = _lib.load(unit)
    plan = bwd_plan(B, S, T, H, KH, d, dvw, causal, window, BODIES[q.dtype],
                    matvec_k.sms(q.get_device()))
    stream = _lib.stream_ptr(q)
    counters = _lib.workspace(q, stream, plan.counters, 0).counters \
        if plan.counters else None
    ws = lse.new_empty(plan.workspace_floats)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _lib.check(lib.rt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), ws.data_ptr(), _lib.ptr(counters),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, T, H, KH, dvw,
        int(bool(causal)), int(window), float(softcap), 1.0 / math.sqrt(d),
        empty_l, plan.splits, stream), what)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _check(q, k, v, window, kv_block, what):
    """The operand checks of both kernels' launches."""
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


def _launch(q, k, v, causal, window, softcap, kv_block, what,
            with_lse=False):
    """q (B, S, H, d), k (B, T, K, d) and v (B, T, K, dv) with K dividing
    H -> (out (B, S, H, dv), lse (B, S, H) float32 or None)."""
    _check(q, k, v, window, kv_block, what)
    B, S, H, d = q.shape
    dv = v.shape[3]
    unit = flash_unit(q.dtype, d, what, dv)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _lib.require_cuda(what, q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    lib = _lib.load(unit)
    T = k.shape[1]
    out = q.new_empty((B, S, H, dv))
    lse = q.new_empty((B, S, H), dtype=torch.float32) if with_lse else None
    # The reference's key count of a row that keeps no key: its padded
    # kv tiles (kernels/ref.py: flash_attention_ref).
    empty_l = ref.flash_empty_l(T, kv_block)
    _lib.check(lib.rt_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H,
        k.shape[2], dv, int(bool(causal)), int(window), float(softcap),
        1.0 / math.sqrt(d), empty_l, _lib.ptr(lse), _lib.stream_ptr(q)),
        what)
    flash_attention_gqa.launches += 1
    unit_launches[unit.label] = unit_launches.get(unit.label, 0) + 1
    return out, lse


flash_attention_gqa.launches = 0
