"""Plain PyTorch oracles for the slice's kernels (the ``ref.py`` contract).

Written against plain tensor operations and independent of the kernels'
block structure -- a log-step (Hillis-Steele) scan and a pairwise ordered
fold, both order-preserving, so they serve non-commutative operators too --
so that kernel-against-ref agreement is a real check.  They run on any
device.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.core import operators as ops_alg

Pytree = Any


def _narrow(xs, axis, start, stop):
    return pytree.tree_map(lambda l: l.narrow(axis, start, stop - start), xs)


def _flip(xs, axis):
    return pytree.tree_map(lambda l: torch.flip(l, (axis,)), xs)


def _inclusive_scan(op, xs, axis):
    """Hillis-Steele: after the step of distance d, element i holds the
    ordered fold of the 2d elements ending at i."""
    n = pytree.tree_leaves(xs)[0].shape[axis]
    out, d = xs, 1
    while d < n:
        comb = op.combine(_narrow(out, axis, 0, n - d), _narrow(out, axis, d, n))
        out = pytree.tree_map(
            lambda o, c: torch.cat([o.narrow(axis, 0, d), c], dim=axis),
            out, comb)
        d *= 2
    return out


def ref_scan(op, xs: Pytree, axis: int = 0, inclusive: bool = True,
             reverse: bool = False) -> Pytree:
    """Inclusive/exclusive scan along ``axis`` with an arbitrary AssocOp.

    ``reverse`` scans from the end: element t folds x[T-1], ..., x[t].
    """
    if reverse:
        xs = _flip(xs, axis)
    out = _inclusive_scan(op, xs, axis)
    if not inclusive:
        # Exclusive: shift by one along axis, filling with the identity.
        n = pytree.tree_leaves(xs)[0].shape[axis]
        ident = op.identity(_narrow(xs, axis, 0, 1))
        out = pytree.tree_map(
            lambda o, i: torch.cat([i, o.narrow(axis, 0, n - 1)], dim=axis),
            out, ident)
    return _flip(out, axis) if reverse else out


def ref_fold(op, vals: Pytree, axis: int) -> Pytree:
    """Ordered pairwise fold of ``vals`` along ``axis`` (axis removed)."""
    vals = pytree.tree_map(lambda l: l.movedim(axis, 0), vals)
    while pytree.tree_leaves(vals)[0].shape[0] > 1:
        n = pytree.tree_leaves(vals)[0].shape[0]
        if n % 2:
            ident = op.identity(pytree.tree_map(lambda l: l[:1], vals))
            vals = pytree.tree_map(lambda l, i: torch.cat([l, i]), vals, ident)
        vals = op.combine(pytree.tree_map(lambda l: l[0::2], vals),
                          pytree.tree_map(lambda l: l[1::2], vals))
    return pytree.tree_map(lambda l: l[0], vals)


def ref_mapreduce(f, op, xs: Pytree, axis=None) -> Pytree:
    """op-reduce of f(x) over ``axis`` (None = all elements)."""
    vals = f(xs)
    if axis is None:
        vals = pytree.tree_map(lambda l: l.reshape(-1), vals)
        axis = 0
    return ref_fold(op, vals, axis)


def ref_matvec(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """y[j] = op_i f(x[i], A[i, j]); A is (n, p), x is (n,), n >= 1."""
    return ref_fold(op, f(x[:, None], A), axis=0)


def ref_vecmat(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """z[i] = op_j f(A[i, j], x[j]); A is (n, p), x is (p,), p >= 1."""
    return ref_fold(op, f(A, x[None, :]), axis=1)


def ref_batched_scan(op, xs: Pytree, *, inclusive: bool = True,
                     reverse: bool = False) -> Pytree:
    """Row-by-row flat scan of ``(B, n)`` leaves, restacked."""
    B = pytree.tree_leaves(xs)[0].shape[0]
    if B == 0:
        return pytree.tree_map(torch.clone, xs)
    rows = [ref_scan(op, pytree.tree_map(lambda l: l[i], xs), axis=0,
                     inclusive=inclusive, reverse=reverse) for i in range(B)]
    return pytree.tree_map(lambda *ls: torch.stack(ls), *rows)


def ref_linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0=None,
                          axis: int = 1, reverse: bool = False) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along ``axis`` (h_{-1} = h0 or 0)."""
    A, B = ref_scan(ops_alg.AFFINE, (a, b), axis=axis, reverse=reverse)
    if h0 is None:
        return B
    return A * h0.unsqueeze(axis) + B


def ref_segmented_scan(op, xs: Pytree, flags: torch.Tensor,
                       inclusive: bool = True) -> Pytree:
    """Segmented scan of flat ``(n,)`` leaves: the scan of the
    :func:`~repro_torch.core.operators.segmented` lift over (flags, xs);
    exclusive shifts by one element and puts the identity at every segment
    start (``flags != 0``)."""
    f = flags.to(torch.int32)
    _, incl = ref_scan(ops_alg.segmented(op), (f, xs), axis=0)
    if inclusive:
        return incl
    ident = op.identity(_narrow(xs, 0, 0, 1))
    shifted = pytree.tree_map(lambda l, i: torch.cat([i, l[:-1]]), incl,
                              ident)
    return pytree.tree_map(lambda s, i: torch.where(f != 0, i, s), shifted,
                           op.identity(incl))


def ref_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x``."""
    return x.clone()


def ref_batched_mapreduce(f, op, xs: Pytree) -> Pytree:
    """Row-by-row op-reduce of ``f(row)`` -> one element per row.

    Length-0 rows (and B == 0 batches) yield ``op``'s identity per row.
    """
    B, n = pytree.tree_leaves(xs)[0].shape[:2]
    one = f(pytree.tree_map(lambda l: l[:1, :0], xs))
    if B == 0 or n == 0:
        return op.identity(pytree.tree_map(
            lambda l: torch.empty((B,), dtype=l.dtype, device=l.device), one))
    rows = [ref_mapreduce(f, op, pytree.tree_map(lambda l: l[i], xs))
            for i in range(B)]
    return pytree.tree_map(lambda *ls: torch.stack(ls), *rows)


def _mv_row_identity(f, op, lhs, rhs, B, extent):
    """``(B, extent)`` identity rows of a zero-term matvec / vecmat."""
    one = f(torch.empty((1, 1), dtype=lhs.dtype, device=rhs.device),
            torch.empty((1, 1), dtype=rhs.dtype, device=rhs.device))
    return op.identity(pytree.tree_map(
        lambda l: torch.empty((B, extent), dtype=l.dtype, device=l.device),
        one))


def _stack_rows(rows):
    return pytree.tree_map(lambda *ls: torch.stack(ls), *rows)


def ref_batched_matvec(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """Row-by-row :func:`ref_matvec` over ``(B, n, p)`` x ``(B, n)``;
    ``B == 0`` or ``n == 0`` (zero reduction terms) yields identity rows."""
    B, n, p = A.shape
    if B == 0 or n == 0:
        return _mv_row_identity(f, op, x, A, B, p)
    return _stack_rows([ref_matvec(f, op, A[b], x[b]) for b in range(B)])


def ref_batched_vecmat(f, op, A: torch.Tensor, x: torch.Tensor) -> Pytree:
    """Row-by-row :func:`ref_vecmat` over ``(B, n, p)`` x ``(B, p)``."""
    B, n, p = A.shape
    if B == 0 or p == 0:
        return _mv_row_identity(f, op, A, x, B, n)
    return _stack_rows([ref_vecmat(f, op, A[b], x[b]) for b in range(B)])


# A quantized matvec / vecmat (f = *, op = ADD) against the unquantized
# matrix may deviate by the integrated dequantization error:
# |sum_i x_i (A - deq)_ij| <= sum_i |x_i| eb_ij, with eb the half-step
# bound of Quantized.error_bound().


def ref_quantized_matvec_bound(q, x: torch.Tensor) -> torch.Tensor:
    """Per-output atol of matvec(TIMES, ADD) against the f32 oracle."""
    return torch.einsum("...n,...np->...p", x.to(torch.float32).abs(),
                        q.error_bound())


def ref_quantized_vecmat_bound(q, x: torch.Tensor) -> torch.Tensor:
    """Per-output atol of vecmat(TIMES, ADD) against the f32 oracle."""
    return torch.einsum("...np,...p->...n", q.error_bound(),
                        x.to(torch.float32).abs())


# ---------------------------------------------------------------------------
# K10: fused attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_block=256, kv_block=256):
    """Plain version of K10 with the reference kernel's semantics
    (``repro/kernels/flash_attention.py``): q (N, S, d), k (N, T, d) and v
    (N, T, dv) -> (N, S, dv) in q's dtype.  ``dv`` is d in the reference
    kernel; MLA's value head is narrower than its q/k head, and the value
    product and the output take v's own width, as the reference's
    ``blockwise_attention`` does.

    Scores are ``(q . k in float32) * (1 / sqrt(d))``, soft-capped as
    ``softcap * tanh(s / softcap)``; a key is kept where ``kpos < T``,
    ``qpos < S``, causal ``qpos >= kpos`` and window ``qpos - kpos <
    window``, positions counting from 0 for q and k alike (also when
    S != T); a dropped score is -1e30.  The online softmax runs over kv
    tiles of ``kb = min(kv_block, round_up(T, 8))`` keys in float32, the
    tail tile zero-padded; p rounds to v's dtype before the float32 p . v
    product; the output is ``acc / max(l, 1e-30)``.  Query rows are
    independent, so ``q_block`` changes no result; it is kept for the
    reference's signature.  A row that sees no key at all (S > T + window
    - 1) averages v over the padded tiles, as the reference kernel does.
    """
    del q_block
    N, S, d = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    kb = min(kv_block, _round_up(T, 8))
    pad = _round_up(T, kb) - T
    kp = F.pad(k, (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    qf = q.float()
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((N, S, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((N, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((N, S, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for start in range(0, T + pad, kb):
        s = torch.einsum("nsd,ntd->nst", qf,
                         kp[:, start:start + kb].float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kpos = start + torch.arange(kb, device=q.device)[None, :]
        mask = (kpos < T) & (qpos < S)
        if causal:
            mask = mask & (qpos >= kpos)
        if window:
            mask = mask & ((qpos - kpos) < window)
        s = torch.where(mask[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("nst,ntd->nsd", p.to(v.dtype).float(),
                          vp[:, start:start + kb].float())
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_gqa_ref(q, k, v, **kw):
    """:func:`flash_attention_ref` in the model's layout: q (B, S, K, G,
    hd), k (B, T, K, hd) and v (B, T, K, dv) -> (B, S, K, G, dv); query
    head (k, g) attends to kv head k, broadcast here."""
    B, S, K, G, _ = q.shape
    T = k.shape[1]

    def heads(x, n):        # (B, n, K, [G,] w) -> (B K G, n, w)
        w = x.shape[-1]
        if x.ndim == 4:
            x = x[:, :, :, None].expand(B, n, K, G, w)
        return x.permute(0, 2, 3, 1, 4).reshape(B * K * G, n, w)

    out = flash_attention_ref(heads(q, S), heads(k, T), heads(v, T), **kw)
    return out.reshape(B, K, G, S, v.shape[-1]).permute(0, 3, 1, 2, 4)


def flash_attention_bytes(N, S, T, d, dtype, q_block=256, kv_block=256):
    """The reference's structural HBM traffic of its TPU kernel: q and out
    once, k and v once per q block, d padded to 128 lanes."""
    sz = torch.empty((), dtype=dtype).element_size()
    d_pad = _round_up(d, 128)
    nq = -(-S // min(q_block, _round_up(S, 8)))
    q_bytes = N * S * d_pad * sz
    kv_bytes = 2 * N * nq * _round_up(T, 8) * d_pad * sz
    out_bytes = N * S * d_pad * sz
    return q_bytes + kv_bytes + out_bytes


def flash_attention_flops(N, S, T, d, causal=True):
    """The reference's operation count: 4 N S T d, halved when causal."""
    f = 4.0 * N * S * T * d
    return f / 2 if causal else f
