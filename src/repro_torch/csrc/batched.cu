// K7m: per-row commutative op-reduce of f(x) over (B, n) leaves -> (B,),
// and K7s: per-row prefix scan of (B, n) leaves.
//
// K7s replaces: src/repro/kernels/batched.py::batched_scan_pallas (the flat
// scan body with the batch on a parallel grid axis and the carry reset at
// every row's first block).  On the serving path it is the nucleus cutoff of
// temperature sampling: an exclusive ADD scan of the (B, k) f32 candidate
// probabilities (k = top_k, or 64 candidates under top-p alone).
// Bound on this card: memory, one read and one write of every element.
// Design: tile_scan.cuh's three-phase scan with the row on grid axis y, so
// every row is an independent flat scan in element order (AFFINE included):
// a row of n <= 2,048 elements is one block and one launch; longer rows
// take reduce, scan of the tile totals and rescan.  At the sampling shape
// (4, 64) the launch itself is the cost.
//
// K7m.
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
#include "tile_scan.cuh"

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

// Elements per block of K7s; the caller sizes `scratch` to
// B * cdiv(n, TILE) elements (8 bytes each for AFFINE, 4 otherwise) when
// n > TILE.
int rt_scan_batched_tile() { return rt::tile::TILE; }

// K7s.  Returns a cudaError_t code: 0 on a clean launch.
int rt_scan_batched(int op, int dtype, const void* x0, const void* x1,
                    void* y0, void* y1, long B, long n, int inclusive,
                    void* scratch, void* stream) {
  if (B <= 0 || n <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_ALL(op, dtype,
                  return rt::tile::launch_scan_rows<T, OP>(
                      x0, x1, y0, y1, B, n, inclusive != 0, scratch, st));
  return cudaErrorInvalidValue;
}

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
