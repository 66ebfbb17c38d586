// K3: commutative op-reduce of f(x) over flat (n,) leaves, in one launch;
// K7m: the same per row of (B, n) leaves -> (B,).  Templates over the
// generated map Map (In -> Out; it may change the type, as UnitFloat8 does
// from uint8 to f32) and functor Op over Map::Out.
//
// K3 replaces: src/repro/kernels/mapreduce.py::mapreduce_1d_pallas (body
// _mapreduce_kernel), which folds tiles into a VMEM accumulator along the
// TPU's sequential grid and collapses it on the last step.
// K7m replaces: src/repro/kernels/batched.py::batched_mapreduce_pallas (the
// mapreduce body over a (B, cdiv(n, block)) grid, the batch axis parallel
// and the tile axis sequential).
//
// Bound on this card: memory, one read of every input leaf element (1 byte
// per element for UnitFloat8) and one write of the result.  K3: a
// grid-stride accumulation of f(x) in registers, in the mapped type; then a
// warp shuffle tree and the warp totals through shared memory; then
// single-launch completion: each block writes its partial, fences, and takes
// an atomic ticket, and the block that draws the last ticket folds the
// partials through L2.  The grid is capped at two blocks per SM, so the
// partials stay a few hundred elements.  The knob N (the tuning policy's
// nitem_reduce, 8 by default) is the items a thread of the grid takes
// before the grid grows, a template parameter of the unit.  K3's small
// form, for n <= SMALL (one block's THREADS x N, the serving path's (B,)
// flags):
// one block reduces and stores the result, one launch with no memset, no
// ticket and no partials; at these sizes the host's launch, not the device,
// takes the time.
//
// K7m: the host plans each launch (kernels/batched.py: rows_geometry) from
// (B, n, the leaves' widths and alignment, the card's SM count) and passes
// it in, seven longs; every call is one launch.  A thread reads VEC
// adjacent elements of every leaf a load -- VEC x its size bytes, 16 for
// four f32 or sixteen UnitFloat8 codes -- where n % VEC == 0 and each leaf
// is aligned to its load (else a narrower load: nothing is copied), four
// loads in flight.  Three kinds:
//   LANES (short rows, up to 512 loads): a group of 4-32 lanes a row and
//     256 / lanes rows a block; the group folds by shuffles, with no
//     shared memory and no barrier, and its first lane stores the row.
//   BLOCK (B alone fills the card): a block a row, its threads striding
//     the row, a block reduction, thread 0 stores.
//   SPLIT (B below the card's block target, long rows): each row cut into
//     `chunks` chunks over grid y.  Each block writes its partial to the
//     stream's workspace, fences, and takes a ticket from its row's
//     counter; the block that draws the last folds the row's partials in
//     chunk order (warp 0, through L2) and sets the counter back to 0 for
//     the next launch on the stream.  No memset, no second launch.
// Every fold is in a fixed order, so an f32 sum is the same from run to
// run.  A thread's loads stride the row, so K7m is registered for
// commutative operators only, as the reference asserts (mapreduce.py:89).
#pragma once

#include "common.cuh"

#include <cstring>

namespace rt {
namespace mapreduce {
namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 2 * 132;
template <int N> struct Flat {            // K3 at the knob N
  static_assert(N >= 1, "a thread takes one item or more");
  static constexpr long SMALL = static_cast<long>(THREADS) * N;  // grid 1
  static long grid(long n) {
    const long want = (n + SMALL - 1) / SMALL;
    return want < 1 ? 1 : (want > MAX_BLOCKS ? MAX_BLOCKS : want);
  }
};

template <typename Map, typename Op>
__global__ void __launch_bounds__(THREADS)
flat_kernel(Leaves x, long n, typename Op::E* partials, unsigned* ticket,
            Leaves out) {
  using E = typename Op::E;
  using In = typename Map::In;
  __shared__ E warp_smem[THREADS / 32];
  __shared__ bool is_last;
  E acc = Op::identity();
  const long stride = static_cast<long>(gridDim.x) * THREADS;
  for (long i = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += stride)
    acc = Op::combine(acc, Map::apply(In::load(x, i)));
  E v = block_reduce_commutative<Op, THREADS>(acc, warp_smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    __threadfence();  // publish the partial before taking a ticket
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  E p = Op::identity();
  for (long j = threadIdx.x; j < gridDim.x; j += THREADS) {
    p = Op::combine(p, load_cg(partials + j));  // L2, never a stale L1 line
  }
  v = block_reduce_commutative<Op, THREADS>(p, warp_smem);
  if (threadIdx.x == 0) v.store(out, 0);
}

// K3's small form: one block folds all n elements.
template <typename Map, typename Op>
__global__ void __launch_bounds__(THREADS)
small_kernel(Leaves x, long n, Leaves out) {
  using E = typename Op::E;
  using In = typename Map::In;
  __shared__ E warp_smem[THREADS / 32];
  E acc = Op::identity();
  for (long i = threadIdx.x; i < n; i += THREADS)
    acc = Op::combine(acc, Map::apply(In::load(x, i)));
  acc = block_reduce_commutative<Op, THREADS>(acc, warp_smem);
  if (threadIdx.x == 0) acc.store(out, 0);
}

// K3.  `partials` holds Flat<N>::grid(n) elements of Op::E; `ticket` is
// one 4-byte word of scratch.
template <typename Map, typename Op, int N = 8>
cudaError_t flat(Leaves x, long n, void* partials, void* ticket, Leaves out,
                 cudaStream_t stream) {
  if constexpr (!Op::COMMUTATIVE) {
    return cudaErrorInvalidValue;
  } else {
    if (n <= 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    const long grid = Flat<N>::grid(n);
    flat_kernel<Map, Op><<<static_cast<unsigned>(grid), THREADS, 0, stream>>>(
        x, n, static_cast<typename Op::E*>(partials),
        static_cast<unsigned*>(ticket), out);
    return cudaGetLastError();
  }
}

// K3's small form, n <= SMALL: one block, one launch, nothing to clear.
template <typename Map, typename Op, int N = 8>
cudaError_t small(Leaves x, long n, Leaves out, cudaStream_t stream) {
  if constexpr (!Op::COMMUTATIVE) {
    return cudaErrorInvalidValue;
  } else {
    if (n <= 0 || n > Flat<N>::SMALL) return cudaErrorInvalidValue;
    small_kernel<Map, Op><<<1, THREADS, 0, stream>>>(x, n, out);
    return cudaGetLastError();
  }
}

// ---------------------------------------------------------------------------
// K7m
// ---------------------------------------------------------------------------

enum RowsKind { LANES = 0, BLOCK = 1, SPLIT = 2 };
constexpr long MAX_GRID_X = 2147483647;
constexpr long MAX_GRID_Y = 65535;

// The launch the host planned (kernels/batched.py: rows_geometry), seven
// longs.  vec: elements a load; lanes: LANES's lanes a row (THREADS for
// BLOCK and SPLIT); chunks, per_chunk: a row's chunks and the loads of one
// (LANES and BLOCK: one chunk of the whole row).
struct RowsGeometry {
  long kind, vec, lanes, B, n, chunks, per_chunk;
};

// Fold loads w, w + stride, ... < end of the row starting at element
// `base` (load w holds elements base + w W .. + W - 1 of every leaf) into
// acc, U loads in flight a thread, each folded in element order.
template <typename Map, typename Op, int W>
__device__ __forceinline__ void fold_loads(const Leaves& x, long base, long w,
                                           long end, long stride,
                                           typename Op::E& acc) {
  using In = typename Map::In;
  constexpr int U = 4;
  for (; w + (U - 1) * stride < end; w += U * stride) {
    In e[U][W];
#pragma unroll
    for (int k = 0; k < U; ++k)
      In::template load_vec<W>(x, base + (w + k * stride) * W, e[k]);
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int u = 0; u < W; ++u) acc = Op::combine(acc, Map::apply(e[k][u]));
  }
  for (; w < end; w += stride) {
    In e[W];
    In::template load_vec<W>(x, base + w * W, e);
#pragma unroll
    for (int u = 0; u < W; ++u) acc = Op::combine(acc, Map::apply(e[u]));
  }
}

// LANES: `lanes` threads a row, 256 / lanes rows a block.
template <typename Map, typename Op, int W>
__global__ void __launch_bounds__(THREADS)
rows_lanes(Leaves x, RowsGeometry g, Leaves out) {
  using E = typename Op::E;
  const int lanes = static_cast<int>(g.lanes);
  const long row =
      static_cast<long>(blockIdx.x) * (THREADS / lanes) + threadIdx.x / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  E acc = Op::identity();
  if (row < g.B) fold_loads<Map, Op, W>(x, row * g.n, lane, g.n / W, lanes, acc);
  // Every lane of the warp takes part, a row past B with the identity.
  for (int d = lanes / 2; d > 0; d >>= 1)
    acc = Op::combine(acc, E::shfl_down(acc, d, lanes));
  if (lane == 0 && row < g.B) acc.store(out, row);
}

// Warp 0 of a SPLIT row's last block: the row's K partials in chunk order
// -- lane l a run of them in order, then the lanes in lane order (lane 0
// ends holding lanes 0 .. 31) -- read through L2, never a stale L1 line.
template <typename Op>
__device__ __forceinline__ typename Op::E fold_in_order(
    const typename Op::E* p, long K) {
  using E = typename Op::E;
  const long lane = threadIdx.x & 31;
  const long len = (K + 31) / 32;
  const long k1 = (lane + 1) * len < K ? (lane + 1) * len : K;
  E v = Op::identity();
  for (long k = lane * len; k < k1; ++k) v = Op::combine(v, load_cg(p + k));
  for (int d = 1; d < 32; d <<= 1) v = Op::combine(v, E::shfl_down(v, d, 32));
  return v;
}

// BLOCK and SPLIT: block (row, chunk) folds the chunk's loads; `partials`
// holds B chunks elements of Op::E (row-major), `counters` B zero words,
// both read only when chunks > 1.
template <typename Map, typename Op, int W>
__global__ void __launch_bounds__(THREADS)
rows_blocks(Leaves x, RowsGeometry g, typename Op::E* partials,
            unsigned* counters, Leaves out) {
  using E = typename Op::E;
  __shared__ E warp_smem[THREADS / 32];
  __shared__ bool last;
  const long row = blockIdx.x;
  const long loads = g.n / W;
  const long c0 = static_cast<long>(blockIdx.y) * g.per_chunk;
  const long c1 = c0 + g.per_chunk < loads ? c0 + g.per_chunk : loads;
  E acc = Op::identity();
  fold_loads<Map, Op, W>(x, row * g.n, c0 + threadIdx.x, c1, THREADS, acc);
  acc = block_reduce_commutative<Op, THREADS>(acc, warp_smem);
  if (g.chunks == 1) {
    if (threadIdx.x == 0) acc.store(out, row);
    return;
  }
  E* part = partials + row * g.chunks;
  if (threadIdx.x == 0) {
    part[blockIdx.y] = acc;
    __threadfence();  // publish the partial before taking a ticket
    const unsigned ticket = atomicAdd(counters + row, 1u);
    last = ticket == g.chunks - 1;
    if (last) counters[row] = 0;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  __threadfence();
  acc = fold_in_order<Op>(part, g.chunks);
  if (threadIdx.x == 0) acc.store(out, row);
}

template <typename Map, typename Op, int W>
cudaError_t launch_rows(const Leaves& x, const RowsGeometry& g,
                        void* counters, void* partials, const Leaves& out,
                        cudaStream_t stream) {
  using In = typename Map::In;
  using E = typename Op::E;
  if constexpr (W * In::WIDEST > 16) {
    return cudaErrorInvalidValue;          // a load holds at most 16 bytes
  } else {
    for (int k = 0; k < In::LEAVES; ++k)
      if (reinterpret_cast<unsigned long>(x.p[k]) % (W * In::BYTES[k]))
        return cudaErrorInvalidValue;
    const long loads = g.n / W;
    if (g.kind == LANES) {
      if (g.lanes < 4 || g.lanes > 32 || (g.lanes & (g.lanes - 1)) ||
          g.chunks != 1)
        return cudaErrorInvalidValue;
      const long per_block = THREADS / g.lanes;
      const long grid = (g.B + per_block - 1) / per_block;
      if (grid > MAX_GRID_X) return cudaErrorInvalidValue;
      rows_lanes<Map, Op, W><<<static_cast<unsigned>(grid), THREADS, 0,
                               stream>>>(x, g, out);
    } else {
      if (g.lanes != THREADS || g.B > MAX_GRID_X || g.chunks > MAX_GRID_Y ||
          g.per_chunk <= 0 || (g.chunks - 1) * g.per_chunk >= loads ||
          g.chunks * g.per_chunk < loads ||
          (g.kind == BLOCK) != (g.chunks == 1) ||
          (g.chunks > 1 && (counters == nullptr || partials == nullptr)))
        return cudaErrorInvalidValue;
      rows_blocks<Map, Op, W>
          <<<dim3(static_cast<unsigned>(g.B), static_cast<unsigned>(g.chunks)),
             THREADS, 0, stream>>>(x, g, static_cast<E*>(partials),
                                   static_cast<unsigned*>(counters), out);
    }
    return cudaGetLastError();
  }
}

// K7m: `geo` points at the seven longs of a RowsGeometry; `counters` (B
// zero words) and `partials` (B chunks elements of Op::E) are the stream's
// workspace, read only when chunks > 1.
template <typename Map, typename Op>
cudaError_t rows(const Leaves& x, const Leaves& out, const void* geo,
                 void* counters, void* partials, cudaStream_t stream) {
  if constexpr (!Op::COMMUTATIVE) {
    return cudaErrorInvalidValue;
  } else {
    RowsGeometry g;
    std::memcpy(&g, geo, sizeof g);
    if (g.B <= 0 || g.n <= 0 || g.vec <= 0 || g.n % g.vec ||
        (g.kind != LANES && g.kind != BLOCK && g.kind != SPLIT))
      return cudaErrorInvalidValue;
    switch (g.vec) {
      case 1: return launch_rows<Map, Op, 1>(x, g, counters, partials, out, stream);
      case 2: return launch_rows<Map, Op, 2>(x, g, counters, partials, out, stream);
      case 4: return launch_rows<Map, Op, 4>(x, g, counters, partials, out, stream);
      case 8: return launch_rows<Map, Op, 8>(x, g, counters, partials, out, stream);
      case 16: return launch_rows<Map, Op, 16>(x, g, counters, partials, out, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace
}  // namespace mapreduce
}  // namespace rt
