// K4: generalized semiring matvec and vecmat over a row-major (n, p) matrix.
//
//   matvec  y[j] = op_i f(x[i], A[i, j])   (reduce over rows)
//   vecmat  z[i] = op_j f(A[i, j], x[j])   (reduce over columns)
//
// Replaces: src/repro/kernels/matvec.py::matvec_pallas (body _matvec_kernel)
// and ::vecmat_pallas (body _vecmat_kernel), which walk the reduction axis on
// the TPU's sequential grid with the output block as accumulator.  On the
// serving path matvec is the radix sort's digit histogram: mapreduce(ADD)
// over axis 0 of the (n, 2^d) int32 one-hot digit matrix, n = B V =
// 1,024,000 and 2^d = 256 (4 in the segment-id pass), f = take A.
//
// f is MAP_IDENTITY (take the matrix element; the mapreduce axis forms) or
// MAP_TIMES (x * a); op is ADD/MUL/MAX/MIN over int32 or f32, all
// commutative.
//
// Bound on this card: memory, one read of A (plus x) and one write of the
// output; at the histogram shape 1.05 GB, 0.31 ms at 3.35 TB/s.  Hopper has
// no sequential grid to carry the accumulator, and one thread per output
// column would give 256 threads for a billion-byte read.  Design: two-phase
// partials.
//   1. The grid is (output tiles, chunks of the reduction axis).  Each block
//      folds its chunk into one partial per output element, in registers,
//      then combines its thread groups' partials in group order through
//      shared memory, and writes (chunks, outputs) partials (or the output
//      itself when there is one chunk).  The chunk count is picked to give
//      about four blocks per SM.
//   2. A second launch folds the partials in chunk order.
// matvec: a block has tc columns (32, or the next power of two >= p when p
// is narrower) and 256 / tc row groups; group g folds rows g, g + groups, ...
// of the chunk, so a warp reads 128 contiguous bytes at every step, also for
// p = 4 (8 rows of 16 bytes).  vecmat: groups of g lanes (32, or the next
// power of two >= p) share a row, lanes stride over the chunk's columns, and
// the group reduces by shuffles.  The fold order differs from a row-by-row
// fold, which integer ops do not see; f32 ADD rounds differently.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long TARGET_BLOCKS = 4 * 132;
constexpr long MAX_GRID_Y = 65535;

long cdiv(long a, long b) { return (a + b - 1) / b; }
long clampl(long v, long lo, long hi) { return v < lo ? lo : (v > hi ? hi : v); }

// The narrowest power of two >= m, capped at one warp.
int group_width(long m) {
  int w = 1;
  while (w < 32 && w < m) w <<= 1;
  return w;
}

template <typename T>
__device__ __forceinline__ T times(T a, T x) { return a * x; }
template <>
__device__ __forceinline__ int times<int>(int a, int x) {
  return rt::wrap_mul(a, x);
}
template <>
__device__ __forceinline__ float times<float>(float a, float x) {
  return __fmul_rn(a, x);  // no contraction into the ADD: round as torch
}

// ---------------------------------------------------------------------------
// matvec
// ---------------------------------------------------------------------------

struct Plan {
  int width;       // columns per block (matvec) or lanes per row (vecmat)
  long tiles;      // grid x
  long chunks;     // grid y: chunks of the reduction axis
  long per_chunk;  // reduction-axis extent of one chunk
};

Plan matvec_plan(long n, long p) {
  Plan pl;
  pl.width = group_width(p);
  pl.tiles = cdiv(p, pl.width);
  const long groups = THREADS / pl.width;
  // At least 8 rows per thread group in a chunk.
  long chunks = clampl(cdiv(TARGET_BLOCKS, pl.tiles), 1,
                       clampl(n / (8 * groups), 1, MAX_GRID_Y));
  pl.per_chunk = cdiv(n, chunks);
  pl.chunks = cdiv(n, pl.per_chunk);
  return pl;
}

template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
matvec_partials(const T* A, const T* x, int map, long n, long p, int tc,
                long per_chunk, T* out) {
  __shared__ T part[THREADS];
  const int col = threadIdx.x & (tc - 1);
  const int grp = threadIdx.x / tc;
  const int groups = THREADS / tc;
  const long j = static_cast<long>(blockIdx.x) * tc + col;
  const long r0 = static_cast<long>(blockIdx.y) * per_chunk;
  const long r1 = r0 + per_chunk < n ? r0 + per_chunk : n;
  T acc = Op::identity();
  if (j < p) {
    if (map == rt::MAP_TIMES) {
#pragma unroll 4
      for (long i = r0 + grp; i < r1; i += groups)
        acc = Op::combine(acc, times(A[i * p + j], x[i]));
    } else {
#pragma unroll 4
      for (long i = r0 + grp; i < r1; i += groups)
        acc = Op::combine(acc, A[i * p + j]);
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (grp == 0 && j < p) {
    T v = part[col];
    for (int g = 1; g < groups; ++g) v = Op::combine(v, part[g * tc + col]);
    out[static_cast<long>(blockIdx.y) * p + j] = v;
  }
}

// ---------------------------------------------------------------------------
// vecmat
// ---------------------------------------------------------------------------

Plan vecmat_plan(long n, long p) {
  Plan pl;
  pl.width = group_width(p);
  pl.tiles = cdiv(n, THREADS / pl.width);
  long chunks = clampl(cdiv(TARGET_BLOCKS, pl.tiles), 1,
                       clampl(p / (8 * pl.width), 1, MAX_GRID_Y));
  pl.per_chunk = cdiv(cdiv(p, chunks), pl.width) * pl.width;
  pl.chunks = cdiv(p, pl.per_chunk);
  return pl;
}

template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
vecmat_partials(const T* A, const T* x, int map, long n, long p, int g,
                long per_chunk, T* out) {
  const int lane = threadIdx.x & (g - 1);
  const long i = static_cast<long>(blockIdx.x) * (THREADS / g) + threadIdx.x / g;
  const long c0 = static_cast<long>(blockIdx.y) * per_chunk;
  const long c1 = c0 + per_chunk < p ? c0 + per_chunk : p;
  T acc = Op::identity();
  if (i < n) {
    const T* row = A + i * p;
    if (map == rt::MAP_TIMES) {
#pragma unroll 4
      for (long c = c0 + lane; c < c1; c += g)
        acc = Op::combine(acc, times(row[c], x[c]));
    } else {
#pragma unroll 4
      for (long c = c0 + lane; c < c1; c += g) acc = Op::combine(acc, row[c]);
    }
  }
  // Every lane of the warp takes part in the shuffles, in or out of range.
  for (int d = g / 2; d > 0; d >>= 1)
    acc = Op::combine(acc, rt::shfl_down(acc, d, g));
  if (lane == 0 && i < n) out[static_cast<long>(blockIdx.y) * n + i] = acc;
}

// ---------------------------------------------------------------------------
// Phase 2 of both: fold the (chunks, m) partials in chunk order.
// ---------------------------------------------------------------------------

template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
fold_partials(const T* partials, long chunks, long m, T* out) {
  const long j = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= m) return;
  T v = partials[j];
  for (long k = 1; k < chunks; ++k) v = Op::combine(v, partials[k * m + j]);
  out[j] = v;
}

template <typename T, typename Op>
cudaError_t launch(bool is_matvec, const void* A, const void* x, int map,
                   long n, long p, void* partials, void* out,
                   cudaStream_t stream) {
  const Plan pl = is_matvec ? matvec_plan(n, p) : vecmat_plan(n, p);
  const long m = is_matvec ? p : n;  // outputs
  T* dst = static_cast<T*>(pl.chunks > 1 ? partials : out);
  const dim3 grid(static_cast<unsigned>(pl.tiles),
                  static_cast<unsigned>(pl.chunks));
  if (is_matvec)
    matvec_partials<T, Op><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(x), map, n, p,
        pl.width, pl.per_chunk, dst);
  else
    vecmat_partials<T, Op><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(x), map, n, p,
        pl.width, pl.per_chunk, dst);
  if (pl.chunks > 1)
    fold_partials<T, Op><<<static_cast<unsigned>(cdiv(m, THREADS)), THREADS,
                           0, stream>>>(dst, pl.chunks, m,
                                        static_cast<T*>(out));
  return cudaGetLastError();
}

int run(bool is_matvec, int op, int dtype, int map, const void* A,
        const void* x, long n, long p, void* partials, void* out,
        void* stream) {
  if (n <= 0 || p <= 0 || (map != rt::MAP_IDENTITY && map != rt::MAP_TIMES) ||
      (map == rt::MAP_TIMES && x == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_COMMUTATIVE(op, dtype,
                          return launch<T, OP>(is_matvec, A, x, map, n, p,
                                               partials, out, st));
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Chunks of the reduction axis for an (n, p) matrix: when above 1 the
// caller sizes `partials` to chunks * p (matvec) or chunks * n (vecmat)
// elements; otherwise `partials` is unused.
long rt_matvec_chunks(long n, long p) { return matvec_plan(n, p).chunks; }
long rt_vecmat_chunks(long n, long p) { return vecmat_plan(n, p).chunks; }

// Return a cudaError_t code: 0 on a clean launch.  `x` is read only by
// MAP_TIMES.
int rt_matvec(int op, int dtype, int map, const void* A, const void* x,
              long n, long p, void* partials, void* out, void* stream) {
  return run(true, op, dtype, map, A, x, n, p, partials, out, stream);
}

int rt_vecmat(int op, int dtype, int map, const void* A, const void* x,
              long n, long p, void* partials, void* out, void* stream) {
  return run(false, op, dtype, map, A, x, n, p, partials, out, stream);
}

}  // extern "C"
