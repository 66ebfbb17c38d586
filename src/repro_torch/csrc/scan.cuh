// K2: flat prefix scan of (n,) leaves; K7s: per-row prefix scan of (B, n)
// leaves; K6: scan along T of (B, T, C) leaves, independent per (b, c).
// Templates over the generated functor Op (element Op::E); any operator,
// commutative or not.
//
// K2 replaces: src/repro/kernels/scan.py::scan_1d_pallas (body _scan1d_kernel
// and block_scan_rowmajor), which walks the array on the TPU's sequential
// grid with a running carry in VMEM.
// K7s replaces: src/repro/kernels/batched.py::batched_scan_pallas (the flat
// scan body with the batch on a parallel grid axis).
// Bound on this card: memory.  The least traffic is one read and one write
// of every element (2 n x element bytes at 3.35 TB/s).  Hopper blocks run in
// no order, so the TPU's sequential carry does not carry over: both are
// tile_scan.cuh's three-phase scan (reduce, scan of the tile totals,
// rescan), exact for non-commutative operators, with the row on grid axis y.
// It moves 3 n element bytes instead of 2 n.  A row of n <= one tile (the
// serving path's (B,) count scan, the sampling path's (4, 64) nucleus scan)
// is a single launch with no carry, with an entry of its own (single_tile)
// that takes no scratch.  The single-pass decoupled lookback is the later
// performance step.
//
// K6 replaces: src/repro/kernels/scan.py::scan_channel_pallas (body
// _chan_kernel), which puts channels on the TPU's 128 lanes and walks T
// blocks on the sequential grid axis with a carry in VMEM.  It carries the
// RG-LRU recurrence (AFFINE over an f32 (a, b) pair) through
// linear_recurrence, and every scan along an axis other than 0.
// Bound on this card: memory, every element read once and written once.
// Serial route: one thread owns one (b, c) channel and walks T with the carry
// in registers, so no carry touches memory; neighbouring threads take
// neighbouring c, so each step's loads and stores coalesce.  The cost is
// parallelism: B x C threads (2,560 at B = 1) cannot fill 132 SMs.
// Long-T path, for few channels and long T (the radix sort's rank scan,
// (1, n, 2^d) int32 ADD exclusive): T chunked by CHUNK steps over blocks,
//   1. each thread folds one (b, chunk, c) in walk order into agg;
//   2. the exclusive scan of agg along the chunk axis, one row per (b, c)
//      (tile_scan.cuh's carry phase);
//   3. each thread walks its chunk again with its carry on the left.
// Integer ADD stays bit-exact; float operators reassociate at chunk edges,
// which is why the RG-LRU's shapes stay on the serial route
// (kernels/scan.py picks the route).  Traffic: 3 element bytes of 2.
#pragma once

#include "tile_scan.cuh"

namespace rt {
namespace scan {
namespace {

constexpr int CH_THREADS = 128;
constexpr int CHUNK = 64;

template <typename Op>
__global__ void __launch_bounds__(CH_THREADS)
scan_channels(Leaves x, Leaves y, long T_len, long C, bool inclusive,
              bool reverse) {
  using E = typename Op::E;
  const long c = static_cast<long>(blockIdx.x) * CH_THREADS + threadIdx.x;
  if (c >= C) return;
  const long row = static_cast<long>(blockIdx.y) * T_len * C + c;
  E acc = Op::identity();
  for (long k = 0; k < T_len; ++k) {
    const long t = reverse ? T_len - 1 - k : k;
    const long i = row + t * C;
    const E v = E::load(x, i);
    if (inclusive) {
      acc = Op::combine(acc, v);
      acc.store(y, i);
    } else {
      acc.store(y, i);
      acc = Op::combine(acc, v);
    }
  }
}

// Long-T phase 1: the fold of chunk k of channel (b, c), in walk order.
// Thread index over (chunk, c) within row b = blockIdx.y, c fastest.
template <typename Op>
__global__ void __launch_bounds__(CH_THREADS)
chunk_aggregates(Leaves x, long T_len, long C, long nchunks, bool reverse,
                 typename Op::E* agg) {
  using E = typename Op::E;
  const long idx = static_cast<long>(blockIdx.x) * CH_THREADS + threadIdx.x;
  if (idx >= nchunks * C) return;
  const long k = idx / C, c = idx - k * C;
  const long b = blockIdx.y;
  const long row = b * T_len * C + c;
  const long s1 = (k + 1) * CHUNK < T_len ? (k + 1) * CHUNK : T_len;
  E acc = Op::identity();
#pragma unroll 8
  for (long s = k * CHUNK; s < s1; ++s) {
    const long t = reverse ? T_len - 1 - s : s;
    acc = Op::combine(acc, E::load(x, row + t * C));
  }
  agg[(b * C + c) * nchunks + k] = acc;
}

// Long-T phase 3: walk chunk k again from its carry (the exclusive prefix of
// the chunks before it, left in agg by phase 2).
template <typename Op>
__global__ void __launch_bounds__(CH_THREADS)
chunk_rescan(Leaves x, Leaves y, long T_len, long C, long nchunks,
             bool inclusive, bool reverse, const typename Op::E* agg) {
  using E = typename Op::E;
  const long idx = static_cast<long>(blockIdx.x) * CH_THREADS + threadIdx.x;
  if (idx >= nchunks * C) return;
  const long k = idx / C, c = idx - k * C;
  const long b = blockIdx.y;
  const long row = b * T_len * C + c;
  const long s1 = (k + 1) * CHUNK < T_len ? (k + 1) * CHUNK : T_len;
  E acc = agg[(b * C + c) * nchunks + k];
#pragma unroll 8
  for (long s = k * CHUNK; s < s1; ++s) {
    const long i = row + (reverse ? T_len - 1 - s : s) * C;
    const E v = E::load(x, i);
    if (inclusive) {
      acc = Op::combine(acc, v);
      acc.store(y, i);
    } else {
      acc.store(y, i);
      acc = Op::combine(acc, v);
    }
  }
}

// K2 (rows = 1) and K7s: the whole scan of `rows` rows of n elements.
// `scratch` holds rows * cdiv(n, tile) elements when n > tile.
template <typename Op>
cudaError_t rows(Leaves x, Leaves y, long rows, long n, bool inclusive,
                 void* scratch, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || rows > 65535) return cudaErrorInvalidValue;
  return tile::launch_scan_rows<Op>(x, y, rows, n, inclusive, scratch, stream);
}

// K7s's single-tile form: rows of n <= one tile, one launch, no scratch.
template <typename Op>
cudaError_t single_tile(Leaves x, Leaves y, long rows, long n, bool inclusive,
                        cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || rows > 65535 || n > tile::Tile<typename Op::E>::SIZE)
    return cudaErrorInvalidValue;
  return tile::launch_scan_rows<Op>(x, y, rows, n, inclusive, nullptr, stream);
}

// K6.  A null `scratch` takes the serial route, a non-null one the long-T
// path; scratch holds B * C * cdiv(T, CHUNK) elements.
template <typename Op>
cudaError_t channel(Leaves x, Leaves y, long B, long T_len, long C,
                    bool inclusive, bool reverse, void* scratch,
                    cudaStream_t stream) {
  using E = typename Op::E;
  if (B <= 0 || T_len <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  if (scratch == nullptr) {
    const dim3 grid(static_cast<unsigned>((C + CH_THREADS - 1) / CH_THREADS),
                    static_cast<unsigned>(B));
    scan_channels<Op><<<grid, CH_THREADS, 0, stream>>>(x, y, T_len, C,
                                                        inclusive, reverse);
    return cudaGetLastError();
  }
  if (B * C > 65535) return cudaErrorInvalidValue;
  const long nchunks = (T_len + CHUNK - 1) / CHUNK;
  E* agg = static_cast<E*>(scratch);
  const dim3 grid(
      static_cast<unsigned>((nchunks * C + CH_THREADS - 1) / CH_THREADS),
      static_cast<unsigned>(B));
  chunk_aggregates<Op><<<grid, CH_THREADS, 0, stream>>>(x, T_len, C, nchunks,
                                                         reverse, agg);
  tile::scan_totals<Op><<<dim3(1, static_cast<unsigned>(B * C)),
                          tile::THREADS, 0, stream>>>(agg, nchunks);
  chunk_rescan<Op><<<grid, CH_THREADS, 0, stream>>>(
      x, y, T_len, C, nchunks, inclusive, reverse, agg);
  return cudaGetLastError();
}

}  // namespace
}  // namespace scan
}  // namespace rt
