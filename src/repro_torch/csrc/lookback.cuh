// A single-pass prefix scan of flat (n,) leaves by decoupled lookback
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA technical report NVR-2016-002).  K2 (scan.cuh) runs it
// above one tile; K7s's long rows and K8 may adopt it later.
//
// Replaces: src/repro/kernels/scan.py::scan_1d_pallas (body _scan1d_kernel),
// which walks the array on the TPU's sequential grid with a running carry in
// VMEM.  Hopper's blocks run in no order, so the carry travels between
// blocks through memory instead.
// Bound on this card: memory, each element read once and written once
// (2 n element bytes at 3.35 TB/s).  The three-phase scan of tile_scan.cuh
// reads the input twice (3 n); this kernel keeps to 2 n in one launch.
//
// Design.
//  1. Tiles in ticket order.  A block draws its tile with an atomicAdd on a
//     ticket word, not from blockIdx, so every tile before it belongs to a
//     block that has already started: a wait on a predecessor always ends.
//     The block loads its tile coalesced and scans it in registers
//     (tile::scan_tile_regs), ITEMS elements a thread (Lookback<E>).
//  2. Publishing.  Tile t has a status: a flag, its aggregate (the combine
//     of its own elements) and its inclusive prefix (the combine of tiles
//     0 .. t).  An element of at most 4 bytes shares one 8-byte word with
//     its flag, written by one single-copy-atomic store and read by one
//     load, so a reader that sees the flag sees the value: no fence and no
//     second load.  A larger element (up to 40 bytes) cannot share an atomic
//     word with its flag.  Its aggregate and prefix get a slot each, written
//     once per launch, so a reader never sees one half-overwritten; one
//     thread writes the value, fences, and stores the flag with release
//     semantics (st.release.gpu); a reader spins on an acquire load
//     (ld.acquire.gpu) of the flag and only then reads the value, through
//     L2 (ld.global.cg).
//  3. Lookback.  The first warp reads the statuses of the 32 tiles before
//     its own, lane i the tile i + 1 back, until none is unset; the nearest
//     tile with a prefix ends the walk, and the tiles after it give their
//     aggregates.  The window's values fold in tile order by a shuffle tree
//     in which the earlier tile is always the left operand, and the window
//     goes on the LEFT of what later windows found, so the result is exact
//     for operators that do not commute, and integer ADD is bit-exact.  A
//     window without a prefix moves 32 tiles back.  Tile 0 publishes its
//     prefix at once; a block publishes its own prefix after it has handed
//     its prefix to its threads.
//  4. No memset and no second launch: the ticket and the statuses live in the
//     stream's workspace (kernels/_lib.py: workspace).  The reset rule:
//       - the ticket word is 0 at rest; the block that draws the last ticket
//         (gridDim.x - 1) sets it back to 0, after every block has drawn;
//       - a flag holds epoch << 2 | state.  The host passes each launch on
//         the stream the next epoch (1, 2, ..., EPOCH_MAX), so a flag left by
//         an earlier launch reads as unset.  The flags are zeroed when the
//         workspace makes them, and again when the epoch wraps past
//         EPOCH_MAX back to 1;
//       - the value slots need no reset: a reader reads one only after this
//         launch's flag says it is written.
//  5. Traffic: each element read once and written once, plus one status
//     (8 bytes, or 8 + 2 sizeof(E)) a tile of up to 8,192 elements.
#pragma once

#include <cstring>

#include "tile_scan.cuh"

namespace rt {
namespace lookback {
namespace {

constexpr unsigned AGGREGATE = 1;    // flag states; 0: not yet written
constexpr unsigned PREFIX = 2;
constexpr unsigned EPOCH_MAX = (1u << 30) - 1;

// Elements a thread: 128 bytes of them, 32 at most (a tile of 8,192 4-byte
// elements, 4,096 8-byte ones, 2,048 quaternions, 768 40-byte elements);
// four blocks a multiprocessor for 4-byte elements, three for 8- to
// 16-byte ones (as many as fit without spilling an AFFINE f32 pair or a
// quaternion).  A block
// holds its tile in registers while it looks back, and the ticket and the
// lookback come once a tile: the tile is large, and the registers few
// enough that several blocks share a multiprocessor and keep loads in
// flight while others wait.
template <typename E> struct Lookback {
  static constexpr int ITEMS =
      128 / sizeof(E) >= 32 ? 32 : (128 / sizeof(E) >= 1 ? 128 / sizeof(E) : 1);
  static constexpr long SIZE = static_cast<long>(tile::THREADS) * ITEMS;
  static constexpr int MIN_BLOCKS =
      sizeof(E) <= 4 ? 4 : (sizeof(E) <= 16 ? 3 : 1);
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// An element of at most 4 bytes shares one 8-byte word with its flag: the
// flag in the low half, the element's bits in the high half.
template <typename E> constexpr bool PACKED = sizeof(E) <= 4;

// The statuses of one launch's tiles, in the stream's workspace.
template <typename E> struct Status {
  unsigned* flags;   // two words a tile (one 8-byte word when PACKED)
  E* aggregate;      // one element a tile, unless PACKED
  E* prefix;         // one element a tile, unless PACKED
  unsigned epoch;

  // By one thread.  A packed word is one single-copy-atomic store: a
  // reader that sees the flag sees the value.  Otherwise the value, a
  // fence, then the flag with release semantics.
  __device__ void publish(long t, unsigned state, const E& v) const {
    const unsigned flag = epoch << 2 | state;
    if constexpr (PACKED<E>) {
      unsigned bits = 0;
      memcpy(&bits, &v, sizeof(E));
      store_relaxed(reinterpret_cast<unsigned long long*>(flags) + t,
                    static_cast<unsigned long long>(bits) << 32 | flag);
    } else {
      (state == PREFIX ? prefix : aggregate)[t] = v;
      __threadfence();
      store_release(flags + 2 * t, flag);
    }
  }

  // Tile p's status word: its flag in the low half (acquired, unless
  // PACKED: then the element in the high half).
  __device__ unsigned long long poll(long p) const {
    if constexpr (PACKED<E>)
      return load_relaxed(reinterpret_cast<const unsigned long long*>(flags) + p);
    else
      return load_acquire(flags + 2 * p);
  }

  // The value of tile p whose status word ``word`` is this launch's.
  __device__ E value(long p, unsigned long long word) const {
    if constexpr (PACKED<E>) {
      const unsigned bits = static_cast<unsigned>(word >> 32);
      E v;
      memcpy(&v, &bits, sizeof(E));
      return v;
    } else {
      return load_cg((word & 3u) == PREFIX ? prefix + p : aggregate + p);
    }
  }
};

// By the first warp of the block of tile t > 0: the combine of tiles
// 0 .. t - 1 in order, in lane 0.  Lane i reads the tile i + 1 back.
template <typename Op>
__device__ typename Op::E look_back(const Status<typename Op::E>& st, long t) {
  using E = typename Op::E;
  const int lane = threadIdx.x & 31;
  const unsigned ready = st.epoch;
  E found = Op::identity();   // the combine of tiles end .. t - 1
  for (long end = t;; end -= 32) {
    const long p = end - 1 - lane;
    // A lane before tile 0 counts as a prefix it never reaches.
    unsigned long long word = p >= 0 ? st.poll(p) : ready << 2 | PREFIX;
    auto unset = [&] { return (static_cast<unsigned>(word) >> 2) != ready; };
    while (__any_sync(FULL_MASK, unset())) {
      if (unset()) word = st.poll(p);
    }
    const bool has_prefix = (word & 3u) == PREFIX;
    const unsigned prefixes = __ballot_sync(FULL_MASK, has_prefix);
    const int nearest = prefixes ? __ffs(prefixes) - 1 : 32;
    E v = Op::identity();
    if (lane <= nearest && p >= 0) v = st.value(p, word);
    // Fold the window into lane 0; a higher lane holds an earlier tile, so
    // it goes on the left.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const E earlier = E::shfl_down(v, d, 32);
      if (lane + d < 32) v = Op::combine(earlier, v);
    }
    found = Op::combine(v, found);
    if (prefixes) return found;
  }
}

template <typename Op>
__global__ void __launch_bounds__(tile::THREADS,
                                  Lookback<typename Op::E>::MIN_BLOCKS)
scan_lookback(Leaves x, Leaves y, long n, bool inclusive,
              Status<typename Op::E> st, unsigned* ticket) {
  using E = typename Op::E;
  constexpr int ITEMS = Lookback<E>::ITEMS;
  __shared__ tile::TileSmem<E, ITEMS> s;
  __shared__ long tile_s;
  __shared__ E prefix_s;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == gridDim.x - 1) *ticket = 0;   // every block has drawn
    tile_s = t;
  }
  __syncthreads();
  const long t = tile_s;
  const long base = t * Lookback<E>::SIZE;
  E r[ITEMS];
  tile::load_tile<Op>(s, r, base, n, [&](long i) { return E::load(x, i); });
  const E total = tile::scan_tile_regs<Op>(s, r, Op::identity(), inclusive);
  if (t == 0) {
    if (threadIdx.x == 0) st.publish(0, PREFIX, total);
  } else {
    E before;
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) st.publish(t, AGGREGATE, total);
      before = look_back<Op>(st, t);
      if (threadIdx.x == 0) prefix_s = before;
    }
    __syncthreads();
    // Publish after the block has its prefix, so the fence of a value that
    // is not packed delays this warp only.
    if (threadIdx.x == 0) st.publish(t, PREFIX, Op::combine(before, total));
    const E b = prefix_s;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) r[j] = Op::combine(b, r[j]);
  }
  tile::store_tile(s, r, base, n, [&](long i, const E& v) { v.store(y, i); });
}

// The scan of n elements in one launch.  `counters` holds the ticket word
// (0 at rest), `flags` 2 cdiv(n, SIZE) words, 8-byte aligned, and `values`
// 2 cdiv(n, SIZE) elements; epoch is in 1 .. EPOCH_MAX and new on the
// stream.
template <typename Op>
cudaError_t scan(Leaves x, Leaves y, long n, bool inclusive, void* counters,
                 void* flags, void* values, unsigned epoch,
                 cudaStream_t stream) {
  using E = typename Op::E;
  if (n <= 0 || epoch == 0 || epoch > EPOCH_MAX) return cudaErrorInvalidValue;
  const long tiles = (n + Lookback<E>::SIZE - 1) / Lookback<E>::SIZE;
  if (tiles > 0x7fffffffL) return cudaErrorInvalidValue;
  E* v = static_cast<E*>(values);
  const Status<E> st{static_cast<unsigned*>(flags), v, v + tiles, epoch};
  scan_lookback<Op><<<static_cast<unsigned>(tiles), tile::THREADS, 0,
                      stream>>>(x, y, n, inclusive, st,
                                static_cast<unsigned*>(counters));
  return cudaGetLastError();
}

}  // namespace
}  // namespace lookback
}  // namespace rt
