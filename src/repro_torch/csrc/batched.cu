// K7m: per-row commutative op-reduce of f(x) over (B, n) leaves -> (B,).
//
// Replaces: src/repro/kernels/batched.py::batched_mapreduce_pallas (the
// mapreduce body with the batch on a parallel grid axis).  On the serving
// path it computes the per-slot sequence scores: ADD of where(mask, logp, 0)
// over the f32 (B, T) step log-probs and the int32 (B, T) emitted mask.
//
// Bound on this card: memory, one read of every value and mask element and
// one write per row.  Design: one block per row; the map (identity or masked
// select) runs in registers as the block strides over the row, then the same
// warp-shuffle / shared-memory block reduction as K3.  Rows are independent,
// so no cross-block completion is needed.  At the serving path's few short
// rows the launch itself is the cost.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
mapreduce_rows(const T* x, const int* mask, int map, T fill, long n, T* out) {
  __shared__ T warp_smem[THREADS / 32];
  const long row = static_cast<long>(blockIdx.x) * n;
  T acc = Op::identity();
  for (long i = threadIdx.x; i < n; i += THREADS) {
    T v = x[row + i];
    if (map == rt::MAP_MASKED && mask[row + i] == 0) v = fill;
    acc = Op::combine(acc, v);
  }
  acc = rt::block_reduce_commutative<T, Op, THREADS>(acc, warp_smem);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <typename T, typename Op>
cudaError_t launch(const void* x, const void* mask, int map, double fill,
                   long B, long n, void* out, cudaStream_t stream) {
  mapreduce_rows<T, Op><<<static_cast<unsigned>(B), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(mask), map,
      static_cast<T>(fill), n, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a clean launch.  `mask` is an int32 array
// read only by the masked map.
int rt_mapreduce_batched(int op, int dtype, int map, const void* x,
                         const void* mask, double fill, long B, long n,
                         void* out, void* stream) {
  if (B <= 0 || n <= 0 || B > 2147483647L ||
      (map != rt::MAP_IDENTITY && map != rt::MAP_MASKED))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_COMMUTATIVE(op, dtype,
                          return launch<T, OP>(x, mask, map, fill, B, n, out,
                                               st));
  return cudaErrorInvalidValue;
}

}  // extern "C"
