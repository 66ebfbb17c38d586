"""Scan kernels K2 (flat) and K6 (channel), each with its plain version.

* :func:`scan_1d_cuda` -- prefix scan of flat ``(n,)`` leaves under any
  operator with a device form, commutative or not (``csrc/scan.cuh``,
  ``csrc/lookback.cuh``; replaces ``repro/kernels/scan.py::scan_1d_pallas``).
  One launch a call: one tile (n <= ``plan.limit``), or the single-pass
  decoupled lookback, whose ticket and tile statuses live in the stream's
  workspace (``_lib.workspace``).  Plain version: :func:`scan_1d_plain`.
* :func:`scan_channel_cuda` -- scan along axis 1 of ``(B, T, C)`` leaves,
  independent per (b, c), forward or reverse (``csrc/scan.cuh``; replaces
  ``scan_channel_pallas``).  It carries ``linear_recurrence`` on the
  channel-tile route (a block per b and 16 channels, T walked in chunks
  with a carry) and the radix sort's rank scan on the long-T path (T
  spread over blocks; see :func:`uses_long_t`).  Plain version:
  :func:`scan_channel_plain`, a serial walk over T.
* :func:`linrec_grad_cuda` -- the gradient of ``linear_recurrence``
  (h_t = a_t h_{t-1} + b_t along axis 1 of ``(B, T, C)``): da, db and dh0
  from a, the forward's h, dh and h0 in one kernel, the adjoint scan fused
  with its shift and products (``csrc/linrec_grad.cuh``; the reference
  differentiates K6's scan with XLA).  Three forms, by shape
  (:func:`linrec_grad_form`).  Plain version: :func:`linrec_grad_plain`,
  the shift, a reverse serial walk and the products as tensor code.
* :func:`maxplus_grad_cuda` -- the gradient of the mLSTM stabilizer's
  inclusive MAXPLUS_AFFINE scan along axis 1 of ``(B, T, H)`` float32
  leaves, in the combine order of the reference's ``lax.associative_scan``
  (``csrc/maxplus_grad.cuh``; the reference differentiates that scan with
  XLA).  Plain version: :func:`maxplus_grad_plain`, the same tree as
  tensor code.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel or raises.  ``launches`` on each wrapper counts the calls
that launched its kernel; K6 counts its long-T path apart, in
``long_t_launches``, and each route's reverse launches again in
``reverse_launches`` and ``long_t_reverse_launches``;
``linrec_grad_cuda.launches`` counts its calls and ``form_launches`` them
by form; ``maxplus_grad_cuda.launches`` counts the stabilizer gradient's.
``nitem`` is the tuning policy's ``nitem_scan`` (None: the kernels'
default of 8): the items a thread of a tile scans, K6's steps a thread a
chunk and its long-T chunk's 8 ``nitem`` steps, each value a unit of its
own (``kernels/_lib.py: KNOB_FAMILIES``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import operators as alg
from repro_torch.kernels import _lib
from repro_torch.kernels import ref

Pytree = Any


def _leaves(what, xs, ndim):
    """The leaves of ``xs``, checked: non-empty, one rank-``ndim`` shape,
    contiguous on one CUDA device."""
    leaves = (xs,) if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)
    shape = leaves[0].shape
    if len(shape) != ndim or 0 in shape or len(leaves) > 1 and any(
            l.shape != shape for l in leaves):
        raise ValueError(f"{what}: leaves must share one non-empty rank-"
                         f"{ndim} shape, got {[tuple(l.shape) for l in leaves]}")
    _lib.require_cuda(what, *leaves)
    return leaves


def scan_unit(what, op, leaves, nitem=None) -> _lib.Unit:
    """The generated unit of K2, K7s and K6 for ``op`` over ``leaves``."""
    return _lib.unit("scan", what, op, [l.dtype for l in leaves], knob=nitem)


# ---------------------------------------------------------------------------
# K2: flat scan
# ---------------------------------------------------------------------------


def scan_1d_plain(op, xs: Pytree, *, inclusive: bool = True) -> Pytree:
    """Plain version of K2: the log-step reference scan of (n,) leaves."""
    return ref.ref_scan(op, xs, axis=0, inclusive=inclusive)


def scan_1d_cuda(op, xs: Pytree, *, inclusive: bool = True,
                 nitem: int | None = None) -> Pytree:
    """K2: inclusive/exclusive scan over flat ``(n,)`` leaves, n >= 1."""
    x = xs if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)[0]
    if not x.is_cuda:
        return scan_1d_plain(op, xs, inclusive=inclusive)
    what = "scan@flat (cuda)"
    leaves = _leaves(what, xs, 1)
    plan = _lib.plan("scan", what, op, xs, knob=nitem)
    lib = plan.lib or plan.load()
    n = x.shape[0]
    outs = [torch.empty_like(l) for l in leaves]
    stream = _lib.stream_ptr(x)
    ptrs = _lib.ptrs((*leaves, *outs))
    if n <= plan.limit:
        rc = lib.rt_scan_tile(*ptrs, 1, n, int(inclusive), stream)
    else:
        # At most one status a limit's elements: the lookback's tiles are
        # no smaller.  A status: two flag words and two values.
        tiles = -(-n // plan.limit)
        w = _lib.workspace(x, stream, 1, 2 * tiles * plan.elem_bytes,
                           2 * tiles)
        rc = lib.rt_scan_lookback(
            *ptrs, n, int(inclusive), w.counters.data_ptr(),
            w.flags.data_ptr(), w.partials.data_ptr(), w.next_epoch(), stream)
    _lib.check(rc, what)
    scan_1d_cuda.launches += 1
    return plan.outputs(outs)


scan_1d_cuda.launches = 0


# ---------------------------------------------------------------------------
# K6: channel scan along axis 1 of (B, T, C)
# ---------------------------------------------------------------------------

# The long-T path takes over when few channels meet a long T.  At B * C <=
# 1024 the channel-tile route runs at most 64 blocks (of 132 SMs), each
# walking all of T; the radix sort's rank scans (256 and 4 channels, T =
# B V) are far below it.  The RG-LRU's recurrence, at B * C >= 2560, stays
# above it on the channel-tile route.  Below LONG_T_MIN_STEPS (two chunks
# of the long path) there is little to spread.
LONG_T_MAX_CHANNELS = 1024
LONG_T_MIN_STEPS = 128


def uses_long_t(B: int, T: int, C: int) -> bool:
    """Whether K6 takes the long-T path for a (B, T, C) scan."""
    return B * C <= LONG_T_MAX_CHANNELS and T >= LONG_T_MIN_STEPS


def _kept(keep, leaves):
    """``keep`` checked against ``leaves``: one flag per leaf, None for
    all of them."""
    if keep is None:
        return (True,) * len(leaves)
    if len(keep) != len(leaves) or not any(keep):
        raise ValueError(f"keep: one flag per leaf and at least one set, "
                         f"got {keep} for {len(leaves)} leaves")
    return tuple(bool(k) for k in keep)


def scan_channel_plain(op, xs: Pytree, *, inclusive: bool = True,
                       reverse: bool = False, keep=None) -> Pytree:
    """Plain version of K6: the serial walk over T, vectorized over (B, C),
    the carry on the left.  A leaf that ``keep`` drops comes back None."""
    leaves, spec = pytree.tree_flatten(xs)
    keep = _kept(keep, leaves)
    T = leaves[0].shape[1]
    outs = [torch.empty_like(l) for l in leaves]
    acc = op.identity(pytree.tree_map(lambda l: l[:, 0], xs))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        x_t = pytree.tree_map(lambda l: l[:, t], xs)
        if inclusive:
            acc = op.combine(acc, x_t)
        for o, v in zip(outs, pytree.tree_leaves(acc)):
            o[:, t] = v
        if not inclusive:
            acc = op.combine(acc, x_t)
    return pytree.tree_unflatten(
        [o if k else None for o, k in zip(outs, keep)], spec)


def scan_channel_cuda(op, xs: Pytree, *, inclusive: bool = True,
                      reverse: bool = False, keep=None,
                      nitem: int | None = None) -> Pytree:
    """K6: scan along axis 1 of ``(B, T, C)`` leaves, independent per
    (b, c); ``reverse`` walks T from the end.  :func:`uses_long_t` picks
    the route from the shape.  ``keep``: one flag per leaf (default all);
    a dropped leaf is not written (its output pointer is null, which the
    element's store skips) and comes back None -- ``linear_recurrence``
    without ``h0`` reads only the B leaf, and the A leaf would be a
    quarter of the bytes."""
    x = xs if isinstance(xs, torch.Tensor) else pytree.tree_leaves(xs)[0]
    if not x.is_cuda:
        return scan_channel_plain(op, xs, inclusive=inclusive, reverse=reverse,
                                  keep=keep)
    what = "scan along T of (B, T, C) (cuda)"
    leaves = _leaves(what, xs, 3)
    keep = _kept(keep, leaves)
    plan = _lib.plan("scan", what, op, xs, knob=nitem)
    B, T, C = x.shape
    if B > 65535:
        raise ValueError(f"{what}: B = {B} exceeds the grid's 65535 rows")
    lib = plan.lib or plan.load()
    long_t = uses_long_t(B, T, C)
    outs = [torch.empty_like(l) if k else None for l, k in zip(leaves, keep)]
    scratch = _lib.scratch(B * C * -(-T // lib.rt_scan_channel_chunk()),
                           len(leaves), x) if long_t else None
    _lib.check(lib.rt_scan_channel(
        *[_lib.ptr(t) for t in (*leaves, *outs)], B, T, C, int(inclusive),
        int(reverse), _lib.ptr(scratch), _lib.stream_ptr(x)), what)
    if long_t:
        scan_channel_cuda.long_t_launches += 1
        scan_channel_cuda.long_t_reverse_launches += int(reverse)
    else:
        scan_channel_cuda.launches += 1
        scan_channel_cuda.reverse_launches += int(reverse)
    return plan.outputs(outs)


# Launches of the channel-tile route and of the long-T path, counted apart;
# each one's reverse ones again among its own.
scan_channel_cuda.launches = 0
scan_channel_cuda.long_t_launches = 0
scan_channel_cuda.reverse_launches = 0
scan_channel_cuda.long_t_reverse_launches = 0


# ---------------------------------------------------------------------------
# linear_recurrence's gradient
# ---------------------------------------------------------------------------

# The forms of csrc/linrec_grad.cuh, in the order of its Form enum.  Up to
# SHORT_T_MAX steps a thread walks one (b, c) (xLSTM's chunk states: T =
# 16); the long-T form takes K6's long-T shapes; the channel tiles the rest
# (the RG-LRU's T in the thousands).
LINREC_FORMS = ("short", "tiles", "long")
SHORT_T_MAX = 64
LONG_CHUNK = 32          # steps a long-T thread walks: the header's CHUNK


def linrec_grad_form(B: int, T: int, C: int) -> str:
    """The form of :func:`linrec_grad_cuda` for a (B, T, C) recurrence."""
    if T <= SHORT_T_MAX:
        return "short"
    return "long" if uses_long_t(B, T, C) else "tiles"


def linrec_grad_plain(a, h, dh, h0=None, *, reverse=False):
    """Plain version of :func:`linrec_grad_cuda`: the adjoint g_t = dh_t +
    a_{t+1} g_{t+1} as K6's plain walk over the shifted a and dh in a's
    type, then db = g, da_t = g_t h_{t-1} (h_{-1} = h0, or 0) and dh0 =
    a_0 g_0, mirrored along T when ``reverse``.  Returns (da, db, dh0),
    dh0 None without h0."""
    zero = torch.zeros_like(a[:, :1])
    start = zero if h0 is None else h0[:, None].to(h.dtype)
    if reverse:
        a_next = torch.cat([zero, a[:, :-1]], dim=1)
        h_prev = torch.cat([h[:, 1:], start], dim=1)
    else:
        a_next = torch.cat([a[:, 1:], zero], dim=1)
        h_prev = torch.cat([start, h[:, :-1]], dim=1)
    _, g = scan_channel_plain(
        alg.AFFINE, (a_next, dh.to(a.dtype)), inclusive=True,
        reverse=not reverse, keep=(False, True))
    edge = -1 if reverse else 0
    dh0 = None if h0 is None else a[:, edge] * g[:, edge]
    return g * h_prev, g, dh0


def linrec_grad_cuda(a, h, dh, h0=None, *, reverse=False):
    """The gradient of ``linear_recurrence`` on the card: (da, db, dh0)
    from a, the forward's h, dh and h0 (or None) in one call of
    ``csrc/linrec_grad.cuh`` -- one kernel launch on the short-T and
    channel-tile forms, three on the long-T form (its chunk maps in
    scratch allocated here).  a, h, dh: (B, T, C), h0: (B, C), contiguous
    on one device; a, h and h0 of one type of ``_lib.LINREC_LEAVES``, dh
    of ``_lib.LINREC_CTYPES``, read in its own type.  Given CPU tensors,
    :func:`linrec_grad_plain`."""
    if not a.is_cuda:
        return linrec_grad_plain(a, h, dh, h0, reverse=reverse)
    what = "linear_recurrence gradient (cuda)"
    leaves = _leaves(what, (a, h, dh), 3)
    B, T, C = a.shape
    if h0 is not None:
        _lib.require_cuda(what, a, h0)
        if h0.shape != (B, C):
            raise ValueError(f"{what}: h0 must be (B, C) = {(B, C)}, got "
                             f"{tuple(h0.shape)}")
    if h.dtype != a.dtype or h0 is not None and h0.dtype != a.dtype:
        raise NotImplementedError(
            f"{what}: a, h and h0 must share one dtype, got "
            f"{[str(t.dtype) for t in (a, h, h0) if t is not None]}")
    if B > 65535:
        raise ValueError(f"{what}: B = {B} exceeds the grid's 65535 rows")
    lib = _lib.load(_lib.unit("linrec_grad", what,
                              dtypes=(a.dtype, dh.dtype)))
    form = linrec_grad_form(B, T, C)
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    scratch = None
    if form == "long":
        scratch = a.new_empty(2 * B * C * -(-T // LONG_CHUNK))
    _lib.check(lib.rt_linrec_grad(
        *[_lib.ptr(t) for t in (*leaves, h0, da, db, dh0, scratch)],
        0 if scratch is None else scratch.nbytes, B, T, C, int(reverse),
        LINREC_FORMS.index(form), _lib.stream_ptr(a)), what)
    linrec_grad_cuda.launches += 1
    linrec_grad_cuda.form_launches[form] += 1
    return da, db, dh0


# Calls that launched the kernel, and the same by form.
linrec_grad_cuda.launches = 0
linrec_grad_cuda.form_launches = dict.fromkeys(LINREC_FORMS, 0)


# ---------------------------------------------------------------------------
# The mLSTM stabilizer's gradient: the MAXPLUS_AFFINE scan's tree, backward
# ---------------------------------------------------------------------------


def _share(u, v):
    """The share of max(u, v)'s adjoint that goes to u: 1, 0 or a half at
    a tie, as ``jax.grad`` splits a tie of ``max``."""
    return torch.where(u > v, 1.0, torch.where(u == v, 0.5, 0.0)).to(u.dtype)


def maxplus_grad_plain(lf, li, dA, dB):
    """Plain version of the stabilizer's gradient (``csrc/maxplus_grad.cuh``):
    (dlf, dli) of the inclusive MAXPLUS_AFFINE scan (A, Bm) of (lf, li)
    along axis 1 of (B, T, H) leaves, given (dA, dB), in the combine order
    of ``lax.associative_scan``'s recursion, which the reference's scan
    runs: level 0 is (lf, li); level l + 1 pairs level l's elements (0, 1),
    (2, 3), ... under (a1 + a2, max(b1 + a2, b2)); the scan of level l
    takes its odd positions from the scan of level l + 1 and each even one
    2 m >= 2 as the combine of that scan's element m - 1 with element 2 m.
    Its transpose, level by level: every max gives its adjoint to the
    larger side, half to each at a tie."""
    LA, LB = [lf], [li]
    while LA[-1].shape[1] >= 2:
        a, b = LA[-1], LB[-1]
        n = a.shape[1] // 2 * 2
        LA.append(a[:, 0:n:2] + a[:, 1:n:2])
        LB.append(torch.maximum(b[:, 0:n:2] + a[:, 1:n:2], b[:, 1:n:2]))
    L = len(LA) - 1
    # The scan's b values of levels L .. 1.
    RB = [None] * (L + 1)
    RB[L] = LB[L]
    for l in range(L - 1, 0, -1):
        n, up = LA[l].shape[1], RB[l + 1]
        r = torch.empty_like(LB[l])
        r[:, 1::2] = up
        r[:, 0] = LB[l][:, 0]
        k = (n - 1) // 2
        r[:, 2::2] = torch.maximum(up[:, :k] + LA[l][:, 2::2], LB[l][:, 2::2])
        RB[l] = r
    # The adjoints up: a level's scan adjoint gives its odd positions, plus
    # what their even combines pass back, to the next level's; its even
    # positions 2 m >= 2 keep their combine's share for their own element.
    GA, GB = [dA.clone()], [dB.clone()]
    for l in range(L):
        n = LA[l].shape[1]
        k = (n - 1) // 2
        ga, gb = GA[l][:, 1:n // 2 * 2:2].clone(), GB[l][:, 1:n // 2 * 2:2].clone()
        ea, eb = GA[l][:, 2::2], GB[l][:, 2::2]
        s = _share(RB[l + 1][:, :k] + LA[l][:, 2::2], LB[l][:, 2::2])
        ga[:, :k] = ga[:, :k] + ea
        gb[:, :k] = gb[:, :k] + s * eb
        GA.append(ga)
        GB.append(gb)
        new_a, new_b = ea + s * eb, (1 - s) * eb
        GA[l][:, 2::2] = new_a
        GB[l][:, 2::2] = new_b
    # The adjoints down through the pair combines.
    for l in range(L - 1, -1, -1):
        n = LA[l].shape[1] // 2 * 2
        ga, gb = GA[l + 1], GB[l + 1]
        s = _share(LB[l][:, 0:n:2] + LA[l][:, 1:n:2], LB[l][:, 1:n:2])
        GA[l][:, 0:n:2] = GA[l][:, 0:n:2] + ga
        GB[l][:, 0:n:2] = GB[l][:, 0:n:2] + s * gb
        GA[l][:, 1:n:2] = ga + s * gb
        GB[l][:, 1:n:2] = (1 - s) * gb
    return GA[0], GB[0]


def maxplus_grad_cuda(lf, li, dA, dB):
    """The stabilizer's gradient (dlf, dli) on the card: one launch of
    ``csrc/maxplus_grad.cuh``, a block per (b, h) column walking the scan's
    tree (its levels in shared memory, or past about T = 5,000 in a
    workspace allocated here).  (B, T, H) float32 leaves.  Given CPU
    tensors, :func:`maxplus_grad_plain`."""
    if not lf.is_cuda:
        return maxplus_grad_plain(lf, li, dA, dB)
    what = "maxplus_grad (cuda)"
    leaves = _leaves(what, (lf, li, dA, dB), 3)
    if any(t.dtype != torch.float32 for t in leaves):
        raise NotImplementedError(
            f"{what}: the kernel takes float32 leaves, got "
            f"{[str(t.dtype) for t in leaves]}")
    lib = _lib.load(_lib.unit("maxplus_grad", what))
    B, T, H = lf.shape
    per = lib.rt_maxplus_grad_floats(T)
    ws = lf.new_empty(B * H * per) if per else None
    dlf, dli = torch.empty_like(lf), torch.empty_like(li)
    _lib.check(lib.rt_maxplus_grad(
        *[t.data_ptr() for t in (lf, li, dA, dB, dlf, dli)], _lib.ptr(ws), B,
        T, H, _lib.stream_ptr(lf)), what)
    maxplus_grad_cuda.launches += 1
    return dlf, dli


maxplus_grad_cuda.launches = 0
