// Block-tile prefix scan and the three-phase, row-batched scan built on it.
//
// The tile helpers (load_tile, scan_tile_regs, store_tile) serve K2's
// single pass (lookback.cuh) and every scan below.  The three-phase scan
// serves K2's and K7s's rows of one tile (scan.cuh: single_tile), K7s's
// longer rows (scan.cuh: B rows), the carry phase of K6's long-T path
// (scan.cuh: one row per channel) and K8 (segmented.cuh: one row under the
// segmented lift).  Every combine keeps element order, so non-commutative
// operators hold and integer ADD is bit-exact.
//
// A scan of `rows` independent rows of n elements (row r is elements
// r n .. r n + n - 1 of each leaf), grid (tiles, rows):
//   1. reduce: each block folds its tile of SIZE elements in element order;
//   2. one block per row scans that row's tile totals (exclusive), walking
//      them a tile at a time with a running carry;
//   3. each block scans its tile again with its total prefix as carry-in.
// It moves 3 n element bytes per row instead of 2 n.  A row of n <= SIZE is
// a single launch of phase 3 with no carry.
//
// Inside a block: each thread loads ITEMS contiguous elements (through
// shared memory, so the global loads coalesce; a pad slot every 32
// elements keeps the transposition free of bank conflicts), scans them
// serially in registers, then the thread aggregates go through a warp
// shuffle scan that combines the lower lane's value on the left, then the
// warp totals through shared memory.  ITEMS is the knob N (the tuning
// policy's nitem_scan, 8 by default; core/intrinsics.py: TuningPolicy),
// at most 8 N bytes and at most 128 bytes of elements, at least one: at
// N = 8, 8 for 4- and 8-byte elements, 4 for a quaternion, 1 for a 40-byte
// one, so the tile's shared memory stays near 16 KB and the registers
// bounded (at most 33 KB at any N); the lookback takes more (Lookback<E>).
// N rides every kernel below as a template parameter, so each value is a
// unit of its own (kernels/_lib.py: unit).
#pragma once

#include "common.cuh"

namespace rt {
namespace tile {
// Internal linkage: each kernel library instantiates its own copies.
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename E, int N = 8> struct Tile {
  static_assert(N >= 1, "a thread scans one item or more");
  static constexpr int BYTES = 8 * N < 128 ? 8 * N : 128;  // at most
  static constexpr int ITEMS =
      BYTES / sizeof(E) >= N ? N : (BYTES / sizeof(E) >= 1 ? BYTES / sizeof(E) : 1);
  static constexpr int SIZE = THREADS * ITEMS;
};

// The shared-memory slot of a tile's element k: one pad slot after every
// 32 elements, so that the 32 threads of a warp, reading or writing their
// ITEMS contiguous elements at the same j, meet 32 different banks (4-byte
// elements; without the pad, ITEMS-way conflicts).
__device__ __forceinline__ int slot(int k) { return k + (k >> 5); }

// A tile's shared memory, for ITEMS elements a thread (Tile's by default).
template <typename E, int ITEMS = Tile<E>::ITEMS> struct TileSmem {
  E items[THREADS * ITEMS + THREADS * ITEMS / 32];
  E warp_excl[WARPS];
  E total;
};

// Coalesced load of one tile into `r` (ITEMS contiguous elements per thread);
// out-of-range slots hold the identity.
template <typename Op, int ITEMS, typename Load>
__device__ void load_tile(TileSmem<typename Op::E, ITEMS>& s,
                          typename Op::E (&r)[ITEMS], long base, long n,
                          Load load) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = j * THREADS + threadIdx.x;
    s.items[slot(k)] = base + k < n ? load(base + k) : Op::identity();
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) r[j] = s.items[slot(threadIdx.x * ITEMS + j)];
  __syncthreads();
}

// Scan the tile held in registers.  On return r[j] is the inclusive (or
// exclusive) prefix of the tile's elements, each with `carry` combined on its
// left; the function returns the tile's own total (without the carry).
template <typename Op, int ITEMS>
__device__ typename Op::E scan_tile_regs(TileSmem<typename Op::E, ITEMS>& s,
                                         typename Op::E (&r)[ITEMS],
                                         typename Op::E carry,
                                         bool inclusive) {
  using E = typename Op::E;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // 1. serial inclusive scan of the thread's own items.
  E incl[ITEMS];
  incl[0] = r[0];
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) incl[j] = Op::combine(incl[j - 1], r[j]);
  // 2. warp inclusive scan of the thread aggregates; the lower lane's value
  //    goes on the left.
  E v = incl[ITEMS - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const E up = E::shfl_up(v, d);
    if (lane >= d) v = Op::combine(up, v);
  }
  E lane_excl = E::shfl_up(v, 1);
  if (lane == 0) lane_excl = Op::identity();
  // 3. warp totals through shared memory, scanned serially by one thread.
  if (lane == 31) s.warp_excl[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    E acc = Op::identity();
    for (int w = 0; w < WARPS; ++w) {
      const E tot = s.warp_excl[w];
      s.warp_excl[w] = acc;
      acc = Op::combine(acc, tot);
    }
    s.total = acc;
  }
  __syncthreads();
  const E prefix =
      Op::combine(Op::combine(carry, s.warp_excl[warp]), lane_excl);
  if (inclusive) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) r[j] = Op::combine(prefix, incl[j]);
  } else {
    r[0] = prefix;
#pragma unroll
    for (int j = 1; j < ITEMS; ++j) r[j] = Op::combine(prefix, incl[j - 1]);
  }
  const E total = s.total;
  __syncthreads();  // s is reused by the caller
  return total;
}

// Coalesced store of the tile in `r`.
template <typename E, int ITEMS, typename Store>
__device__ void store_tile(TileSmem<E, ITEMS>& s, E (&r)[ITEMS], long base,
                           long n, Store store) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) s.items[slot(threadIdx.x * ITEMS + j)] = r[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = j * THREADS + threadIdx.x;
    if (base + k < n) store(base + k, s.items[slot(k)]);
  }
  __syncthreads();
}

// Phase 1: the total of each tile of each row, in element order, into
// totals[row * tiles + tile].
template <typename Op, int N>
__global__ void __launch_bounds__(THREADS)
reduce_tiles(Leaves x, long n, typename Op::E* totals) {
  using E = typename Op::E;
  using T = Tile<E, N>;
  __shared__ TileSmem<E, T::ITEMS> s;
  const long row = static_cast<long>(blockIdx.y) * n;
  const long base = static_cast<long>(blockIdx.x) * T::SIZE;
  E r[T::ITEMS];
  load_tile<Op>(s, r, base, n, [&](long i) { return E::load(x, row + i); });
  const E total = scan_tile_regs<Op>(s, r, Op::identity(), true);
  if (threadIdx.x == 0)
    totals[static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x] = total;
}

// Phase 2: exclusive scan in place of each row's nb values, one block per
// row (blockIdx.y), walking them a tile at a time with a running carry.
template <typename Op, int N>
__global__ void __launch_bounds__(THREADS)
scan_totals(typename Op::E* totals, long nb) {
  using E = typename Op::E;
  using T = Tile<E, N>;
  __shared__ TileSmem<E, T::ITEMS> s;
  E* row = totals + static_cast<long>(blockIdx.y) * nb;
  E carry = Op::identity();
  for (long base = 0; base < nb; base += T::SIZE) {
    E r[T::ITEMS];
    load_tile<Op>(s, r, base, nb, [&](long i) { return row[i]; });
    const E total = scan_tile_regs<Op>(s, r, carry, false);
    store_tile(s, r, base, nb, [&](long i, const E& v) { row[i] = v; });
    carry = Op::combine(carry, total);
  }
}

// Phase 3 (or the whole scan when n <= SIZE): scan each tile with its carry.
// SEG: the element is a segmented lift's (flag, values...) and an exclusive
// scan gives the identity at every element whose own flag starts a segment.
template <typename Op, bool SEG, int N>
__global__ void __launch_bounds__(THREADS)
scan_tiles(Leaves x, Leaves y, long n, bool inclusive,
           const typename Op::E* carries) {
  using E = typename Op::E;
  constexpr int ITEMS = Tile<E, N>::ITEMS;
  __shared__ TileSmem<E, ITEMS> s;
  const long row = static_cast<long>(blockIdx.y) * n;
  const long base = static_cast<long>(blockIdx.x) * Tile<E, N>::SIZE;
  E r[ITEMS];
  load_tile<Op>(s, r, base, n, [&](long i) { return E::load(x, row + i); });
  bool starts[SEG ? ITEMS : 1];
  if constexpr (SEG) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) starts[j] = r[j].v0 != 0;
  }
  const E carry =
      carries ? carries[static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x]
              : Op::identity();
  scan_tile_regs<Op>(s, r, carry, inclusive);
  if constexpr (SEG) {
    if (!inclusive) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (starts[j]) r[j] = Op::identity();
    }
  }
  store_tile(s, r, base, n,
             [&](long i, const E& v) { v.store(y, row + i); });
}

// The whole scan of `rows` rows of n elements.  `scratch` holds
// rows * cdiv(n, SIZE) elements when n > SIZE (unused otherwise).
template <typename Op, bool SEG = false, int N = 8>
cudaError_t launch_scan_rows(Leaves x, Leaves y, long rows, long n,
                             bool inclusive, void* scratch,
                             cudaStream_t stream) {
  using E = typename Op::E;
  constexpr long SIZE = Tile<E, N>::SIZE;
  const long nb = (n + SIZE - 1) / SIZE;
  const unsigned ry = static_cast<unsigned>(rows);
  if (nb <= 1) {
    scan_tiles<Op, SEG, N><<<dim3(1, ry), THREADS, 0, stream>>>(
        x, y, n, inclusive, nullptr);
    return cudaGetLastError();
  }
  E* totals = static_cast<E*>(scratch);
  const dim3 grid(static_cast<unsigned>(nb), ry);
  reduce_tiles<Op, N><<<grid, THREADS, 0, stream>>>(x, n, totals);
  scan_totals<Op, N><<<dim3(1, ry), THREADS, 0, stream>>>(totals, nb);
  scan_tiles<Op, SEG, N><<<grid, THREADS, 0, stream>>>(x, y, n, inclusive,
                                                       totals);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tile
}  // namespace rt
