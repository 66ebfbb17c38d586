// K3: commutative op-reduce of f(x) over flat (n,) leaves, in one launch.
//
// Replaces: src/repro/kernels/mapreduce.py::mapreduce_1d_pallas (body
// _mapreduce_kernel), which folds tiles into a VMEM accumulator along the
// TPU's sequential grid and collapses it on the last step.  On the serving
// path it is the decode loop's all-done predicate: MAX over the int32 (B,)
// active flags.
//
// Bound on this card: memory, one read of every input element (plus the mask
// for the masked map).  At the serving path's n = B the launch itself is the
// cost.  Design: a grid-stride accumulation in registers, in the mapped
// dtype; then a warp shuffle tree and the warp totals through shared memory;
// then single-launch completion: each block writes its partial, fences, and
// takes an atomic ticket, and the block that draws the last ticket folds the
// partials.  The grid is capped at two blocks per SM, so the partials stay a
// few hundred elements.  Commutative operators only, as the reference
// asserts (mapreduce.py:89): blocks finish in any order.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS_PER_THREAD = 8;
constexpr int MAX_BLOCKS = 2 * 132;

long grid_for(long n) {
  const long want = (n + THREADS * ITEMS_PER_THREAD - 1) / (THREADS * ITEMS_PER_THREAD);
  return want < 1 ? 1 : (want > MAX_BLOCKS ? MAX_BLOCKS : want);
}

// The map f: identity, or the masked select where(mask != 0, x, fill).
template <typename T>
__device__ __forceinline__ T mapped(const T* x, const int* mask, int map,
                                    T fill, long i) {
  if (map == rt::MAP_MASKED) return mask[i] != 0 ? x[i] : fill;
  return x[i];
}

template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
mapreduce_flat(const T* x, const int* mask, int map, T fill, long n,
               T* partials, unsigned* ticket, T* out) {
  __shared__ T warp_smem[THREADS / 32];
  __shared__ bool is_last;
  T acc = Op::identity();
  const long stride = static_cast<long>(gridDim.x) * THREADS;
  for (long i = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += stride)
    acc = Op::combine(acc, mapped(x, mask, map, fill, i));
  T v = rt::block_reduce_commutative<T, Op, THREADS>(acc, warp_smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    __threadfence();  // publish the partial before taking a ticket
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  T p = Op::identity();
  for (long j = threadIdx.x; j < gridDim.x; j += THREADS)
    p = Op::combine(p, __ldcg(partials + j));  // L2, never a stale L1 line
  v = rt::block_reduce_commutative<T, Op, THREADS>(p, warp_smem);
  if (threadIdx.x == 0) out[0] = v;
}

template <typename T, typename Op>
cudaError_t launch(const void* x, const void* mask, int map, double fill,
                   long n, void* partials, void* ticket, void* out,
                   cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  const long grid = grid_for(n);
  mapreduce_flat<T, Op><<<static_cast<unsigned>(grid), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(mask), map,
      static_cast<T>(fill), n, static_cast<T*>(partials),
      static_cast<unsigned*>(ticket), static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks the launch uses for n elements: the caller sizes `partials` to it.
long rt_mapreduce_flat_grid(long n) { return grid_for(n); }

// Returns a cudaError_t code: 0 on a clean launch.  `mask` is an int32 array
// read only by the masked map; `ticket` is one 4-byte word of scratch.
int rt_mapreduce_flat(int op, int dtype, int map, const void* x,
                      const void* mask, double fill, long n, void* partials,
                      void* ticket, void* out, void* stream) {
  if (n <= 0 || (map != rt::MAP_IDENTITY && map != rt::MAP_MASKED))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_COMMUTATIVE(op, dtype,
                          return launch<T, OP>(x, mask, map, fill, n, partials,
                                               ticket, out, st));
  return cudaErrorInvalidValue;
}

}  // extern "C"
