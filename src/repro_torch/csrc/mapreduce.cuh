// K3: commutative op-reduce of f(x) over flat (n,) leaves, in one launch;
// K7m: the same per row of (B, n) leaves -> (B,).  Templates over the
// generated map Map (In -> Out; it may change the type, as UnitFloat8 does
// from uint8 to f32) and functor Op over Map::Out.
//
// K3 replaces: src/repro/kernels/mapreduce.py::mapreduce_1d_pallas (body
// _mapreduce_kernel), which folds tiles into a VMEM accumulator along the
// TPU's sequential grid and collapses it on the last step.
// K7m replaces: src/repro/kernels/batched.py::batched_mapreduce_pallas (the
// mapreduce body with the batch on a parallel grid axis).
//
// Bound on this card: memory, one read of every input leaf element (1 byte
// per element for UnitFloat8) and one write of the result.  K3: a
// grid-stride accumulation of f(x) in registers, in the mapped type; then a
// warp shuffle tree and the warp totals through shared memory; then
// single-launch completion: each block writes its partial, fences, and takes
// an atomic ticket, and the block that draws the last ticket folds the
// partials through L2.  The grid is capped at two blocks per SM, so the
// partials stay a few hundred elements.  K3's small form, for n <= SMALL
// (one block's THREADS x ITEMS_PER_THREAD, the serving path's (B,) flags):
// one block reduces and stores the result, one launch with no memset, no
// ticket and no partials; at these sizes the host's launch, not the device,
// takes the time.  K7m: one block per row, the same block reduction; rows
// are independent, so no cross-block completion (K3's small form is its
// kernel with one row).
// Commutative operators only, as the reference asserts (mapreduce.py:89):
// blocks and lanes finish in any order.
#pragma once

#include "common.cuh"

namespace rt {
namespace mapreduce {
namespace {

constexpr int THREADS = 256;
constexpr int ITEMS_PER_THREAD = 8;
constexpr int MAX_BLOCKS = 2 * 132;
constexpr long SMALL = THREADS * ITEMS_PER_THREAD;  // grid_for(n) == 1

long grid_for(long n) {
  const long want = (n + THREADS * ITEMS_PER_THREAD - 1) / (THREADS * ITEMS_PER_THREAD);
  return want < 1 ? 1 : (want > MAX_BLOCKS ? MAX_BLOCKS : want);
}

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

template <typename Map, typename Op>
__global__ void __launch_bounds__(THREADS)
rows_kernel(Leaves x, long n, Leaves out) {
  using E = typename Op::E;
  using In = typename Map::In;
  __shared__ E warp_smem[THREADS / 32];
  const long row = static_cast<long>(blockIdx.x) * n;
  E acc = Op::identity();
  for (long i = threadIdx.x; i < n; i += THREADS)
    acc = Op::combine(acc, Map::apply(In::load(x, row + i)));
  acc = block_reduce_commutative<Op, THREADS>(acc, warp_smem);
  if (threadIdx.x == 0) acc.store(out, blockIdx.x);
}

// K3.  `partials` holds grid_for(n) elements of Op::E; `ticket` is one
// 4-byte word of scratch.
template <typename Map, typename Op>
cudaError_t flat(Leaves x, long n, void* partials, void* ticket, Leaves out,
                 cudaStream_t stream) {
  if constexpr (!Op::COMMUTATIVE) {
    return cudaErrorInvalidValue;
  } else {
    if (n <= 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    const long grid = grid_for(n);
    flat_kernel<Map, Op><<<static_cast<unsigned>(grid), THREADS, 0, stream>>>(
        x, n, static_cast<typename Op::E*>(partials),
        static_cast<unsigned*>(ticket), out);
    return cudaGetLastError();
  }
}

// K3's small form, n <= SMALL: one block, one launch, nothing to clear.
template <typename Map, typename Op>
cudaError_t small(Leaves x, long n, Leaves out, cudaStream_t stream) {
  if constexpr (!Op::COMMUTATIVE) {
    return cudaErrorInvalidValue;
  } else {
    if (n <= 0 || n > SMALL) return cudaErrorInvalidValue;
    rows_kernel<Map, Op><<<1, THREADS, 0, stream>>>(x, n, out);
    return cudaGetLastError();
  }
}

// K7m.
template <typename Map, typename Op>
cudaError_t rows(Leaves x, long B, long n, Leaves out, cudaStream_t stream) {
  if constexpr (!Op::COMMUTATIVE) {
    return cudaErrorInvalidValue;
  } else {
    if (B <= 0 || n <= 0 || B > 2147483647L) return cudaErrorInvalidValue;
    rows_kernel<Map, Op><<<static_cast<unsigned>(B), THREADS, 0, stream>>>(
        x, n, out);
    return cudaGetLastError();
  }
}

}  // namespace
}  // namespace mapreduce
}  // namespace rt
