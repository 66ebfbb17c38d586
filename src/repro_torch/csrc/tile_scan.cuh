// Block-tile prefix scan and the three-phase, row-batched scan built on it.
//
// Shared by K2 (scan_flat.cu: one row), K7s (batched.cu: B rows) and the
// carry phase of K6's long-T path (scan_channel.cu: one row per channel).
// Every combine keeps element order, so the non-commutative AFFINE operator
// and integer ADD (bit-exact) both hold.
//
// A scan of `rows` independent rows of n elements (row r is elements
// r n .. r n + n - 1 of each leaf), grid (tiles, rows):
//   1. reduce: each block folds its tile of TILE elements in element order;
//   2. one block per row scans that row's tile totals (exclusive), walking
//      them a tile at a time with a running carry;
//   3. each block scans its tile again with its total prefix as carry-in.
// It moves 3 n element bytes per row instead of 2 n.  A row of n <= TILE is
// a single launch of phase 3 with no carry.
//
// Inside a block: each thread loads ITEMS contiguous elements (through
// shared memory, so the global loads coalesce), scans them serially in
// registers, then the thread aggregates go through a warp __shfl_up_sync
// scan that combines the lower lane's value on the left, then the warp
// totals through shared memory.
#pragma once

#include "common.cuh"

namespace rt {
namespace tile {
// Internal linkage: each kernel library instantiates its own copies.
namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;

template <typename T> struct TileSmem {
  T items[TILE];
  T warp_excl[WARPS];
  T total;
};

// Coalesced load of one tile into `r` (ITEMS contiguous elements per thread);
// out-of-range slots hold the identity.
template <typename T, typename Op, typename Load>
__device__ void load_tile(TileSmem<T>& s, T (&r)[ITEMS], long base, long n,
                          Load load) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = j * THREADS + threadIdx.x;
    s.items[k] = base + k < n ? load(base + k) : Op::identity();
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) r[j] = s.items[threadIdx.x * ITEMS + j];
  __syncthreads();
}

// Scan the tile held in registers.  On return r[j] is the inclusive (or
// exclusive) prefix of the tile's elements, each with `carry` combined on its
// left; the function returns the tile's own total (without the carry).
template <typename T, typename Op>
__device__ T scan_tile_regs(TileSmem<T>& s, T (&r)[ITEMS], T carry,
                            bool inclusive) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // 1. serial inclusive scan of the thread's own items.
  T incl[ITEMS];
  incl[0] = r[0];
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) incl[j] = Op::combine(incl[j - 1], r[j]);
  // 2. warp inclusive scan of the thread aggregates; the lower lane's value
  //    goes on the left.
  T v = incl[ITEMS - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = shfl_up(v, d);
    if (lane >= d) v = Op::combine(up, v);
  }
  T lane_excl = shfl_up(v, 1);
  if (lane == 0) lane_excl = Op::identity();
  // 3. warp totals through shared memory, scanned serially by one thread.
  if (lane == 31) s.warp_excl[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = Op::identity();
    for (int w = 0; w < WARPS; ++w) {
      const T tot = s.warp_excl[w];
      s.warp_excl[w] = acc;
      acc = Op::combine(acc, tot);
    }
    s.total = acc;
  }
  __syncthreads();
  const T prefix =
      Op::combine(Op::combine(carry, s.warp_excl[warp]), lane_excl);
  if (inclusive) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) r[j] = Op::combine(prefix, incl[j]);
  } else {
    r[0] = prefix;
#pragma unroll
    for (int j = 1; j < ITEMS; ++j) r[j] = Op::combine(prefix, incl[j - 1]);
  }
  const T total = s.total;
  __syncthreads();  // s is reused by the caller
  return total;
}

// Coalesced store of the tile in `r`.
template <typename T, typename Store>
__device__ void store_tile(TileSmem<T>& s, T (&r)[ITEMS], long base, long n,
                           Store store) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) s.items[threadIdx.x * ITEMS + j] = r[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = j * THREADS + threadIdx.x;
    if (base + k < n) store(base + k, s.items[k]);
  }
  __syncthreads();
}

// Phase 1: the total of each tile of each row, in element order, into
// totals[row * tiles + tile].
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
reduce_tiles(const void* x0, const void* x1, long n, T* totals) {
  __shared__ TileSmem<T> s;
  const long row = static_cast<long>(blockIdx.y) * n;
  const long base = static_cast<long>(blockIdx.x) * TILE;
  T r[ITEMS];
  load_tile<T, Op>(s, r, base, n,
                   [&](long i) { return Io<T>::load(x0, x1, row + i); });
  const T total = scan_tile_regs<T, Op>(s, r, Op::identity(), true);
  if (threadIdx.x == 0)
    totals[static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x] = total;
}

// Phase 2: exclusive scan in place of each row's nb values, one block per
// row (blockIdx.y), walking them TILE at a time with a running carry.
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
scan_totals(T* totals, long nb) {
  __shared__ TileSmem<T> s;
  T* row = totals + static_cast<long>(blockIdx.y) * nb;
  T carry = Op::identity();
  for (long base = 0; base < nb; base += TILE) {
    T r[ITEMS];
    load_tile<T, Op>(s, r, base, nb, [&](long i) { return row[i]; });
    const T total = scan_tile_regs<T, Op>(s, r, carry, false);
    store_tile(s, r, base, nb, [&](long i, T v) { row[i] = v; });
    carry = Op::combine(carry, total);
  }
}

// Phase 3 (or the whole scan when n <= TILE): scan each tile with its carry.
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
scan_tiles(const void* x0, const void* x1, void* y0, void* y1, long n,
           bool inclusive, const T* carries) {
  __shared__ TileSmem<T> s;
  const long row = static_cast<long>(blockIdx.y) * n;
  const long base = static_cast<long>(blockIdx.x) * TILE;
  T r[ITEMS];
  load_tile<T, Op>(s, r, base, n,
                   [&](long i) { return Io<T>::load(x0, x1, row + i); });
  const T carry =
      carries ? carries[static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x]
              : Op::identity();
  scan_tile_regs<T, Op>(s, r, carry, inclusive);
  store_tile(s, r, base, n,
             [&](long i, T v) { Io<T>::store(y0, y1, row + i, v); });
}

// The whole scan of `rows` rows of n elements.  `scratch` holds
// rows * cdiv(n, TILE) elements when n > TILE (unused otherwise).
template <typename T, typename Op>
cudaError_t launch_scan_rows(const void* x0, const void* x1, void* y0,
                             void* y1, long rows, long n, bool inclusive,
                             void* scratch, cudaStream_t stream) {
  const long nb = (n + TILE - 1) / TILE;
  const unsigned ry = static_cast<unsigned>(rows);
  if (nb <= 1) {
    scan_tiles<T, Op><<<dim3(1, ry), THREADS, 0, stream>>>(
        x0, x1, y0, y1, n, inclusive, nullptr);
    return cudaGetLastError();
  }
  T* totals = static_cast<T*>(scratch);
  const dim3 grid(static_cast<unsigned>(nb), ry);
  reduce_tiles<T, Op><<<grid, THREADS, 0, stream>>>(x0, x1, n, totals);
  scan_totals<T, Op><<<dim3(1, ry), THREADS, 0, stream>>>(totals, nb);
  scan_tiles<T, Op><<<grid, THREADS, 0, stream>>>(x0, x1, y0, y1, n,
                                                  inclusive, totals);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tile
}  // namespace rt
