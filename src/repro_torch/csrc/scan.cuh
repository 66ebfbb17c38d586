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
// of every element (2 n x element bytes at 3.35 TB/s).  Every call is one
// launch.  A row of n <= one tile (the serving path's (B,) count scan, the
// sampling path's (4, 64) nucleus scan) is tile_scan.cuh's scan_tiles with
// no carry (single_tile), which takes no scratch.  K2 above one tile is the
// single-pass decoupled lookback of lookback.cuh: 2 n element bytes, its
// statuses in the stream's workspace.  K7s's rows above one tile still take
// tile_scan.cuh's three phases (reduce, scan of the tile totals, rescan),
// with the row on grid axis y: 3 n element bytes.
//
// K6 replaces: src/repro/kernels/scan.py::scan_channel_pallas (body
// _chan_kernel), which puts channels on the TPU's 128 lanes, scans each T
// block log-step along the sublanes and walks T blocks on the sequential
// grid axis with a carry in VMEM.  It carries the RG-LRU recurrence (AFFINE
// over an f32 (a, b) pair) through linear_recurrence, and every scan along
// an axis other than 0.  Bound on this card: memory, every element read once
// and written once (16 bytes an element for the AFFINE pair).
// Channel-tile route (every shape off the long-T path): the reference's own
// structure, channels on lanes and T walked in order with a carry.
//   - One block of 512 threads owns one b and a tile of CT = 16 adjacent
//     channels: whole 64-byte runs of each row of each leaf.  At B = 1,
//     C = 2560 that is 160 blocks, each with all of T.
//   - T is a loop of chunks inside the block, which takes the place of the
//     TPU's sequential grid axis.  A chunk is RUNS = 32 runs of STEPS steps
//     (the knob N of the tuning policy's nitem_scan, at most 8 N and at
//     most 128 bytes of elements; at N = 8, 64 bytes, 8 at most: 8 AFFINE
//     f32 pairs, 256 steps a chunk).  Runs of more than 64 bytes hold the
//     block to one a multiprocessor, for the registers of two run sets.
//     Thread (run, c) holds its run of channel c in registers; a warp holds
//     two runs of the 16 channels, so each of its loads and stores covers two
//     whole 64-byte row segments and coalesces without a pass through shared
//     memory.  The next chunk's runs load into a second register set while
//     this chunk is scanned, so its loads overlap the scan.
//   - Each thread scans its run in registers; the 32 run totals of each
//     channel are scanned by one warp with shuffles (the earlier run on the
//     left), the carry goes on the left of every run's prefix, and the
//     chunk's total becomes the next chunk's carry, kept in shared memory.
//   - One launch, no workspace, no dependency between blocks; HBM read once
//     and written once.  `reverse` walks the chunks, and the steps inside
//     each chunk, from the end; `exclusive` shifts by one step, with the
//     carry at the first.
//   - It reassociates as the reference does (runs, then the carry), so a
//     float operator differs from the plain serial walk by rounding; integer
//     operators are bit-exact.
// Long-T path, for few channels and long T (the radix sort's rank scan,
// (1, n, 2^d) int32 ADD exclusive): T chunked by CHUNK = 8 N steps (64 at
// N = 8) over blocks,
//   1. each thread folds one (b, chunk, c) in walk order into agg;
//   2. the exclusive scan of agg along the chunk axis, one row per (b, c)
//      (tile_scan.cuh's carry phase);
//   3. each thread walks its chunk again with its carry on the left.
// Integer ADD stays bit-exact; float operators reassociate at chunk edges.
// Traffic: 3 element bytes of 2.
#pragma once

#include "lookback.cuh"
#include "tile_scan.cuh"

namespace rt {
namespace scan {
namespace {

constexpr int CH_THREADS = 128;          // the long-T path
template <int N> struct LongT {          // steps a thread walks
  static constexpr long CHUNK = 8L * N;
};

constexpr int CT = 16;                   // channels a block
constexpr int CT_THREADS = 512;
constexpr int RUNS = CT_THREADS / CT;    // runs of each channel a chunk: 32
static_assert(RUNS == 32 && CT_THREADS / 32 == CT,
              "one warp scans one channel's run totals");

template <typename E, int N = 8> struct Run {  // steps a thread a chunk
  static constexpr int BYTES = 8 * N < 128 ? 8 * N : 128;   // at most
  static constexpr int STEPS =
      BYTES / sizeof(E) >= N ? N : (BYTES / sizeof(E) >= 1 ? BYTES / sizeof(E) : 1);
  static constexpr int MIN_BLOCKS = STEPS * sizeof(E) <= 64 ? 2 : 1;
};

// The channel-tile route: grid (cdiv(C, CT), B).
template <typename Op, int N>
__global__ void __launch_bounds__(CT_THREADS, Run<typename Op::E, N>::MIN_BLOCKS)
scan_channel_tiles(Leaves x, Leaves y, long T_len, long C, bool inclusive,
                   bool reverse) {
  using E = typename Op::E;
  constexpr int R = Run<E, N>::STEPS;
  constexpr long CHUNK_STEPS = static_cast<long>(RUNS) * R;
  __shared__ E run_prefix[RUNS][CT + 1];    // padded: one bank a lane
  __shared__ E carry[CT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ci = lane % CT;
  const int run = warp * (32 / CT) + lane / CT;
  const long c = static_cast<long>(blockIdx.x) * CT + ci;
  const bool live = c < C;
  const long row = static_cast<long>(blockIdx.y) * T_len * C + c;
  const long chunks = (T_len + CHUNK_STEPS - 1) / CHUNK_STEPS;
  if (threadIdx.x < CT) carry[threadIdx.x] = Op::identity();
  // Element index of walk step s (0 .. T - 1) of this thread's channel.
  auto at = [&](long s) { return row + (reverse ? T_len - 1 - s : s) * C; };
  auto load_run = [&](E (&v)[R], long k) {
    const long s0 = k * CHUNK_STEPS + static_cast<long>(run) * R;
#pragma unroll
    for (int j = 0; j < R; ++j)
      v[j] = live && s0 + j < T_len ? E::load(x, at(s0 + j)) : Op::identity();
  };
  E cur[R], next[R];
  load_run(cur, 0);
  for (long k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) load_run(next, k + 1);
    // 1. The run's inclusive scan, in registers.
#pragma unroll
    for (int j = 1; j < R; ++j) cur[j] = Op::combine(cur[j - 1], cur[j]);
    run_prefix[run][ci] = cur[R - 1];
    __syncthreads();
    // 2. Warp w scans channel w's run totals in run order, the carry on the
    //    left; lane 31's inclusive total is the next chunk's carry.
    {
      E v = run_prefix[lane][warp];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const E earlier = E::shfl_up(v, d);
        if (lane >= d) v = Op::combine(earlier, v);
      }
      E before = E::shfl_up(v, 1);
      if (lane == 0) before = Op::identity();
      const E in = carry[warp];
      __syncwarp();
      run_prefix[lane][warp] = Op::combine(in, before);
      if (lane == 31) carry[warp] = Op::combine(in, v);
    }
    __syncthreads();
    // 3. Each step's output: the run's prefix on the left of its own.
    const E p = run_prefix[run][ci];
    const long s0 = k * CHUNK_STEPS + static_cast<long>(run) * R;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (!live || s0 + j >= T_len) break;
      const E v = inclusive ? Op::combine(p, cur[j])
                            : (j == 0 ? p : Op::combine(p, cur[j - 1]));
      v.store(y, at(s0 + j));
    }
    __syncthreads();   // run_prefix is written again by the next chunk
#pragma unroll
    for (int j = 0; j < R; ++j) cur[j] = next[j];
  }
}

// Long-T phase 1: the fold of chunk k of channel (b, c), in walk order.
// Thread index over (chunk, c) within row b = blockIdx.y, c fastest.
template <typename Op, int N>
__global__ void __launch_bounds__(CH_THREADS)
chunk_aggregates(Leaves x, long T_len, long C, long nchunks, bool reverse,
                 typename Op::E* agg) {
  using E = typename Op::E;
  constexpr long CHUNK = LongT<N>::CHUNK;
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
template <typename Op, int N>
__global__ void __launch_bounds__(CH_THREADS)
chunk_rescan(Leaves x, Leaves y, long T_len, long C, long nchunks,
             bool inclusive, bool reverse, const typename Op::E* agg) {
  using E = typename Op::E;
  constexpr long CHUNK = LongT<N>::CHUNK;
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

// K7s: the three-phase scan of `rows` rows of n elements.  `scratch` holds
// rows * cdiv(n, tile) elements when n > tile.
template <typename Op, int N = 8>
cudaError_t rows(Leaves x, Leaves y, long rows, long n, bool inclusive,
                 void* scratch, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || rows > 65535) return cudaErrorInvalidValue;
  return tile::launch_scan_rows<Op, false, N>(x, y, rows, n, inclusive,
                                              scratch, stream);
}

// K2's and K7s's single-tile form: rows of n <= one tile, one launch, no
// scratch.
template <typename Op, int N = 8>
cudaError_t single_tile(Leaves x, Leaves y, long rows, long n, bool inclusive,
                        cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || rows > 65535 ||
      n > tile::Tile<typename Op::E, N>::SIZE)
    return cudaErrorInvalidValue;
  return tile::launch_scan_rows<Op, false, N>(x, y, rows, n, inclusive,
                                              nullptr, stream);
}

// K6.  A null `scratch` takes the channel-tile route, a non-null one the
// long-T path; scratch holds B * C * cdiv(T, CHUNK) elements.
template <typename Op, int N = 8>
cudaError_t channel(Leaves x, Leaves y, long B, long T_len, long C,
                    bool inclusive, bool reverse, void* scratch,
                    cudaStream_t stream) {
  using E = typename Op::E;
  if (B <= 0 || T_len <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  if (scratch == nullptr) {
    const dim3 grid(static_cast<unsigned>((C + CT - 1) / CT),
                    static_cast<unsigned>(B));
    scan_channel_tiles<Op, N><<<grid, CT_THREADS, 0, stream>>>(
        x, y, T_len, C, inclusive, reverse);
    return cudaGetLastError();
  }
  if (B * C > 65535) return cudaErrorInvalidValue;
  constexpr long CHUNK = LongT<N>::CHUNK;
  const long nchunks = (T_len + CHUNK - 1) / CHUNK;
  E* agg = static_cast<E*>(scratch);
  const dim3 grid(
      static_cast<unsigned>((nchunks * C + CH_THREADS - 1) / CH_THREADS),
      static_cast<unsigned>(B));
  chunk_aggregates<Op, N><<<grid, CH_THREADS, 0, stream>>>(
      x, T_len, C, nchunks, reverse, agg);
  tile::scan_totals<Op, N><<<dim3(1, static_cast<unsigned>(B * C)),
                             tile::THREADS, 0, stream>>>(agg, nchunks);
  chunk_rescan<Op, N><<<grid, CH_THREADS, 0, stream>>>(
      x, y, T_len, C, nchunks, inclusive, reverse, agg);
  return cudaGetLastError();
}

}  // namespace
}  // namespace scan
}  // namespace rt
