"""LSD radix sort / argsort / top-k built only on the portable primitives.

The port of ``repro.kernels.sort``: no kernel of its own.  Every pass of the
least-significant-digit radix sort is

1. **bit-extract map** -- the current digit of every key
   (``operators.key_to_radix_bits`` first maps any supported key dtype onto
   order-preserving unsigned bits, held in int64);
2. **within-bucket stable rank** via an exclusive ``scan`` down the one-hot
   ``(n, 2^d)`` digit matrix with the buckets as channels -- the
   ``(1, n, 2^d)`` channel scan, kernel K6's long-T path on the card;
3. **per-digit histogram** via ``mapreduce`` over axis 0 of the one-hot
   matrix -- kernel K4's matvec on the card;
4. **digit base offsets** via an exclusive ``scan`` of the histogram (K2);
5. **scatter** of keys (and any payload pytree) to ``base[digit] + rank``,
   plain index code.

Every scan/mapreduce goes through the registry's ``resolve_impl`` with the
``backend`` the registered row pins, so the same composition runs the CUDA
kernels (``cuda``) or the plain versions (``torch``).  Each entry takes a
``policy`` (:class:`~repro_torch.core.intrinsics.TuningPolicy`; None: the
backend's base policy, :func:`~repro_torch.core.intrinsics.resolve_tuning`):
the digit width is its ``sort_digit_bits``, and every scan and mapreduce
of the composition gets it explicitly, so an active autotuner never races
them one by one.  The entries also take the deprecated ``sub_backend=``
spelling of ``backend=`` (``intrinsics.sub_backend_alias``).

The segmented variants take the flag / CSR-offset descriptors: a segmented
sort is two chained stable radix phases -- key digits first, then
segment-id digits -- which is sort-by-``(segment, key)`` without packing the
pair into one word.  Segments are contiguous and the sort is stable, so the
output layout (segment boundaries) is the input layout.

Total order (``operators.key_to_radix_bits``): ints numerically; floats
numerically with ``-0.0 == +0.0`` and all NaNs equal, sorting after +inf
(NaN-last ascending, NaN-first for ``descending``/``largest``).  Ties keep
input order (LSD radix is stable).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import intrinsics as ki
from repro_torch.core import operators as alg
from repro_torch.kernels import segmented as seg_k

Pytree = Any


def _full_mask(kb: int) -> int:
    return (1 << kb) - 1


def _key_bits_for(keys, key_bits):
    """Validate/resolve the significant-bit hint (unsigned keys only)."""
    width = alg.radix_key_bits(keys.dtype)
    if key_bits is None:
        return width
    if keys.dtype not in (torch.uint8, torch.uint16, torch.uint32):
        raise ValueError(
            "key_bits= is only meaningful for unsigned integer keys (signed "
            "and float transforms touch the high bits)")
    if not 0 < key_bits <= width:
        raise ValueError(f"key_bits must be in (0, {width}], got {key_bits}")
    return key_bits


# ---------------------------------------------------------------------------
# The radix pass: rank (scan) + histogram (mapreduce) + offsets (scan) +
# scatter, all through the backend registry.
# ---------------------------------------------------------------------------


def _resolve_policy(policy, backend):
    if policy is not None:
        return policy
    return ki.resolve_tuning(ki.default_policy_name(backend))


def _scan(backend, policy):
    """The resolved ``scan@flat`` of ``backend``, called with ``policy``."""
    scan = ki.resolve_impl("scan@flat", backend)
    return lambda op, xs, **kw: scan(op, xs, policy=policy, **kw)


def _radix_pass(bits, payloads, shift, digit_bits, backend, policy):
    n_buckets = 1 << digit_bits
    scan = _scan(backend, policy)
    mapreduce = ki.resolve_impl("mapreduce@flat", backend)

    digit = ((bits >> shift) & _full_mask(digit_bits)).to(torch.int32)
    onehot = (digit[:, None] == torch.arange(
        n_buckets, dtype=torch.int32, device=bits.device)[None, :]).to(
        torch.int32)

    # Within-bucket stable rank: exclusive +scan along the element axis,
    # buckets as channels ((1, n, R) channel layout).
    rank = scan(alg.ADD, onehot[None], axis=1, inclusive=False)[0]
    # Per-digit histogram and its exclusive scan = each bucket's base offset.
    hist = mapreduce(alg.IDENTITY, alg.ADD, onehot, axis=0, policy=policy)
    base = scan(alg.ADD, hist, inclusive=False)

    digit = digit.long()
    dest = (base[digit] + rank.gather(1, digit[:, None])[:, 0]).long()

    def scatter(v):
        out = torch.empty_like(v)
        out[dest] = v
        return out

    return scatter(bits), tuple(scatter(p) for p in payloads)


def _radix_passes(bits, payloads, key_bits, backend, policy):
    digit_bits = policy.sort_digit_bits
    shift = 0
    while shift < key_bits:
        d = min(digit_bits, key_bits - shift)
        bits, payloads = _radix_pass(bits, payloads, shift, d, backend,
                                     policy)
        shift += d
    return bits, payloads


def _to_bits(keys, kb, descending):
    bits = alg.key_to_radix_bits(keys)
    if descending:
        # Complement reverses the unsigned order; mask back to the
        # significant bits so high bits stay outside the sorted digits.
        bits = ~bits & _full_mask(kb)
    return bits


def _from_bits(bits, dtype, kb, descending):
    if descending:
        bits = ~bits & _full_mask(kb)
    return alg.radix_bits_to_key(bits, dtype)


def _iota(n, like):
    return torch.arange(n, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# Flat sorts.
# ---------------------------------------------------------------------------


@ki.sub_backend_alias
def sort_radix(keys, *, descending=False, key_bits=None, backend="torch",
               policy=None):
    """Stable LSD radix sort of a flat key array."""
    kb = _key_bits_for(keys, key_bits)
    if keys.shape[0] == 0:
        return keys
    bits = _to_bits(keys, kb, descending)
    bits, _ = _radix_passes(bits, (), kb, backend,
                            _resolve_policy(policy, backend))
    return _from_bits(bits, keys.dtype, kb, descending)


@ki.sub_backend_alias
def sort_pairs_radix(keys, values, *, descending=False, key_bits=None,
                     backend="torch", policy=None):
    """Stable key sort carrying an arbitrary pytree payload along."""
    kb = _key_bits_for(keys, key_bits)
    leaves, treedef = pytree.tree_flatten(values)
    n = keys.shape[0]
    if any(l.shape[0] != n for l in leaves):
        raise ValueError(
            "sort_pairs: every payload leaf needs leading extent "
            f"{n}, got {[tuple(l.shape) for l in leaves]}")
    if n == 0:
        return keys, values
    bits = _to_bits(keys, kb, descending)
    bits, leaves = _radix_passes(bits, tuple(leaves), kb, backend,
                                 _resolve_policy(policy, backend))
    return (_from_bits(bits, keys.dtype, kb, descending),
            pytree.tree_unflatten(list(leaves), treedef))


@ki.sub_backend_alias
def argsort_radix(keys, *, descending=False, key_bits=None,
                  backend="torch", policy=None):
    """Stable sorting permutation (int32), via an index payload."""
    _, perm = sort_pairs_radix(keys, _iota(keys.shape[0], keys),
                               descending=descending, key_bits=key_bits,
                               backend=backend, policy=policy)
    return perm


@ki.sub_backend_alias
def top_k_radix(keys, k, *, largest=True, key_bits=None, backend="torch",
                policy=None):
    """(values, indices) of the k extreme elements, sorted, ties stable."""
    n = keys.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"top_k: need 0 <= k <= n, got k={k}, n={n}")
    kb = _key_bits_for(keys, key_bits)
    if k == 0:
        return keys[:0], torch.zeros((0,), dtype=torch.int32,
                                     device=keys.device)
    bits = _to_bits(keys, kb, largest)
    bits, (idx,) = _radix_passes(bits, (_iota(n, keys),), kb, backend,
                                 _resolve_policy(policy, backend))
    return _from_bits(bits[:k], keys.dtype, kb, largest), idx[:k]


# ---------------------------------------------------------------------------
# Segmented variants (flag array / CSR offsets).  The descriptor checks live
# in the registry's dispatch (core/intrinsics.py), the only caller of these
# registered compositions.
# ---------------------------------------------------------------------------


def _segment_ids_and_starts(n, flags, offsets, keys, backend, policy):
    """(seg_ids, start_per_elem, seg_bits): contiguous-run bookkeeping.

    ``seg_ids`` are monotone run ids (offsets-declared empty segments do not
    shift them -- only the relative order matters for the sort phase);
    ``start_per_elem[i]`` is the flat index where element i's run begins,
    a running MAX scan of flagged positions.
    """
    scan = _scan(backend, policy)
    if offsets is not None:
        f = seg_k.offsets_to_flags(offsets, n)
        s_bound = int(offsets.shape[0]) - 1
    else:
        f = flags.to(torch.int32)
        s_bound = n  # static bound: at most one segment per element
    seg_ids = seg_k.flags_to_segment_ids(f, scan)
    iota = _iota(n, keys)
    flagged = torch.where((f != 0) | (iota == 0), iota, torch.full_like(
        iota, -1))
    starts = scan(alg.MAX, flagged)
    seg_bits = max(int(s_bound - 1).bit_length(), 0) if s_bound > 1 else 0
    return seg_ids, starts, seg_bits


def _segmented_sort_core(keys, payload_leaves, *, flags, offsets, descending,
                         key_bits, backend, policy, carry_starts=False):
    """Two stable phases: key digits, then segment-id digits.

    With ``carry_starts`` each element's run-start index rides along as one
    extra int32 payload (argsort / top_k need it to localize indices).
    """
    kb = _key_bits_for(keys, key_bits)
    n = keys.shape[0]
    if n == 0:
        return keys, tuple(payload_leaves), torch.zeros(
            (0,), dtype=torch.int32, device=keys.device)
    policy = _resolve_policy(policy, backend)
    seg_ids, starts, seg_bits = _segment_ids_and_starts(
        n, flags, offsets, keys, backend, policy)
    bits = _to_bits(keys, kb, descending)
    extra = (starts,) if carry_starts else ()
    carried = (seg_ids.to(torch.int64),) + extra + tuple(payload_leaves)
    bits, carried = _radix_passes(bits, carried, kb, backend, policy)
    payload = (bits,) + tuple(carried[1:])
    if seg_bits > 0:
        _, payload = _radix_passes(carried[0], payload, seg_bits, backend,
                                   policy)
    if carry_starts:
        bits, starts, leaves = payload[0], payload[1], tuple(payload[2:])
    else:
        bits, leaves, starts = payload[0], tuple(payload[1:]), None
    return _from_bits(bits, keys.dtype, kb, descending), leaves, starts


@ki.sub_backend_alias
def segmented_sort_radix(keys, *, flags=None, offsets=None, descending=False,
                         key_bits=None, backend="torch", policy=None):
    """Independent stable sort of every contiguous segment (layout kept)."""
    out, _, _ = _segmented_sort_core(
        keys, (), flags=flags, offsets=offsets, descending=descending,
        key_bits=key_bits, backend=backend, policy=policy)
    return out


@ki.sub_backend_alias
def segmented_sort_pairs_radix(keys, values, *, flags=None, offsets=None,
                               descending=False, key_bits=None,
                               backend="torch", policy=None):
    leaves, treedef = pytree.tree_flatten(values)
    n = keys.shape[0]
    if any(l.shape[0] != n for l in leaves):
        raise ValueError(
            "segmented_sort_pairs: every payload leaf needs leading extent "
            f"{n}, got {[tuple(l.shape) for l in leaves]}")
    out, out_leaves, _ = _segmented_sort_core(
        keys, tuple(leaves), flags=flags, offsets=offsets,
        descending=descending, key_bits=key_bits, backend=backend,
        policy=policy)
    return out, pytree.tree_unflatten(list(out_leaves), treedef)


@ki.sub_backend_alias
def segmented_argsort_radix(keys, *, flags=None, offsets=None,
                            descending=False, key_bits=None,
                            backend="torch", policy=None):
    """Within-segment sorting permutation: out[i] is the *offset inside its
    segment* of the element placed at flat position i."""
    _, (perm,), starts = _segmented_sort_core(
        keys, (_iota(keys.shape[0], keys),), flags=flags, offsets=offsets,
        descending=descending, key_bits=key_bits, backend=backend,
        policy=policy, carry_starts=True)
    # The sorted stream keeps the input's segment layout, and each element's
    # run start rode along through both phases -- so within-segment position
    # is the carried global index minus the carried run start.
    return perm - starts


@ki.sub_backend_alias
def segmented_top_k_radix(keys, k, *, flags=None, offsets=None,
                          num_segments=None, largest=True, key_bits=None,
                          backend="torch", policy=None):
    """Per-segment (values, indices): ``(S, k)`` each, extreme-first.

    ``indices`` are within-segment offsets into the original layout; slots
    past a segment's length are filled with the reduction identity
    (``-inf``/dtype-min for ``largest``, ``+inf``/dtype-max otherwise) and
    index ``-1``.  With ``flags``, a static ``num_segments`` is required
    (trailing never-started segments come back entirely filled).
    """
    if k < 0:
        raise ValueError(f"top_k: k must be >= 0, got {k}")
    n = keys.shape[0]
    dev = keys.device
    policy = _resolve_policy(policy, backend)
    scan = _scan(backend, policy)
    if offsets is not None:
        num_segments = int(offsets.shape[0]) - 1
        offs = offsets.to(torch.int32)
    else:
        seg_ids = seg_k.flags_to_segment_ids(flags.to(torch.int32), scan)
        counts = torch.bincount(seg_ids[seg_ids < num_segments].long(),
                                minlength=num_segments).to(torch.int32)
        csum = scan(alg.ADD, counts) if num_segments else counts
        offs = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                          csum])
    counts = offs[1:] - offs[:-1]

    fill = torch.full(
        (num_segments, k),
        alg._min_value(keys.dtype) if largest else alg._max_value(keys.dtype),
        dtype=keys.dtype, device=dev)
    if n == 0 or k == 0:
        return fill, torch.full((num_segments, k), -1, dtype=torch.int32,
                                device=dev)

    sorted_keys, (perm,), starts = _segmented_sort_core(
        keys, (_iota(n, keys),), flags=flags, offsets=offsets,
        descending=largest, key_bits=key_bits, backend=backend,
        policy=policy, carry_starts=True)
    within = perm - starts

    ks = torch.arange(k, dtype=torch.int32, device=dev)
    pos = offs[:-1, None] + ks[None, :]
    valid = ks[None, :] < counts[:, None]
    safe = torch.clamp(pos, 0, n - 1).long()
    vals = torch.where(valid, sorted_keys[safe], fill)
    idx = torch.where(valid, within[safe], torch.full_like(within[safe], -1))
    return vals, idx
