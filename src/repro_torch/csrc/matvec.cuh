// K4: generalized semiring matvec and vecmat over a row-major (n, p) matrix,
// and K5: the tall-narrow matvec for p <= 64.  Templates over the generated
// map Map and functor Op over Map::Out.
//
//   matvec  y[j] = op_i f(x[i], A[i, j])   (reduce over rows)
//   vecmat  z[i] = op_j f(A[i, j], x[j])   (reduce over columns)
//
// Map::In holds (x, a) for matvec and (a, x) for vecmat; with one leaf it is
// the matrix element alone (the mapreduce axis forms, no vector).
//
// K4 replaces: src/repro/kernels/matvec.py::matvec_pallas (body
// _matvec_kernel) and ::vecmat_pallas (body _vecmat_kernel), which walk the
// reduction axis on the TPU's sequential grid with the output block as
// accumulator.
// K5 replaces: src/repro/kernels/matvec.py::matvec_packed_pallas (body
// _matvec_packed_kernel), which packs 128 // p row groups into the TPU's
// lanes so a narrow matrix does not pad p columns to 128.
//
// Bound on this card: memory, one read of A (plus x) and one write of the
// output: at the radix histogram (1,024,000 x 256) int32 1.05 GB, 0.31 ms; at
// K5's (10^6, 10) f32 44 MB, 0.013 ms, where two launches and the wrapper
// are the cost.  Hopper has no sequential grid to carry the accumulator, so
// every form is two-phase:
//   1. The grid is (output tiles, chunks of the reduction axis).  Each block
//      folds its chunk into one partial per output element, in registers,
//      then combines its thread groups' partials in group order through
//      shared memory, and writes (chunks, outputs) partials (or the output
//      itself when there is one chunk).  The chunk count gives about four
//      blocks per SM.
//   2. A second launch folds the partials: in chunk order, or, for a
//      commutative op, one block per output.
// K4 matvec: a block has tc columns (32, or the next power of two >= p) and
// 256 / tc row groups.  A commutative op interleaves the rows over the
// groups (group g folds rows g, g + groups, ...), so a warp reads 128
// contiguous bytes at every step, also for p = 4; an op that does not
// commute gives each group a contiguous run of rows, so the fold stays in
// row order.  K4 vecmat: groups of g lanes (32, or the next power of two
// >= p) share a row; a commutative op strides the lanes over the chunk's
// columns and reduces by a shuffle tree; an op that does not commute gives
// each lane a contiguous run of columns and reduces by an ordered shuffle
// tree (distances 1, 2, 4, ...).
// K5: the matrix is read as the flat stream of n p elements, so a block's
// loads are whole 128-byte lines whatever p is.  A block uses the first
// W = (256 / p) p threads; thread t always holds column t % p of row group
// t / p, and steps W elements (W / p rows) at a time.  The g = W / p group
// partials of a column fold in shared memory.  Commutative operators only,
// as in the reference: groups interleave the rows.
#pragma once

#include "common.cuh"

namespace rt {
namespace matvec {
namespace {

constexpr int THREADS = 256;
constexpr long TARGET_BLOCKS = 4 * 132;
constexpr long MAX_GRID_Y = 65535;

__host__ __device__ inline long cdiv(long a, long b) { return (a + b - 1) / b; }
long clampl(long v, long lo, long hi) { return v < lo ? lo : (v > hi ? hi : v); }

// The narrowest power of two >= m, capped at one warp.
int group_width(long m) {
  int w = 1;
  while (w < 32 && w < m) w <<= 1;
  return w;
}

// The map's input element at row i, column j.  MATVEC: In = (x[i], A[i, j]);
// otherwise In = (A[i, j], x[j]).  One-leaf In: A[i, j] alone.
template <typename In, bool MATVEC>
__device__ __forceinline__ In element(const void* A, const void* x, long i,
                                      long j, long p) {
  In e;
  if constexpr (In::LEAVES == 1) {
    e.v0 = static_cast<const typename In::T0*>(A)[i * p + j];
  } else if constexpr (MATVEC) {
    e.v0 = static_cast<const typename In::T0*>(x)[i];
    e.v1 = static_cast<const typename In::T1*>(A)[i * p + j];
  } else {
    e.v0 = static_cast<const typename In::T0*>(A)[i * p + j];
    e.v1 = static_cast<const typename In::T1*>(x)[j];
  }
  return e;
}

struct Plan {
  int width;       // columns per block (matvec), lanes per row (vecmat)
  long tiles;      // grid x
  long chunks;     // grid y: chunks of the reduction axis
  long per_chunk;  // reduction-axis extent of one chunk
};

// ---------------------------------------------------------------------------
// K4 matvec
// ---------------------------------------------------------------------------

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

template <typename Map, typename Op>
__global__ void __launch_bounds__(THREADS)
matvec_partials(const void* A, const void* x, long n, long p, int tc,
                long per_chunk, typename Op::E* partials, Leaves out,
                bool direct) {
  using E = typename Op::E;
  using In = typename Map::In;
  __shared__ E part[THREADS];
  const int col = threadIdx.x & (tc - 1);
  const int grp = threadIdx.x / tc;
  const int groups = THREADS / tc;
  const long j = static_cast<long>(blockIdx.x) * tc + col;
  const long r0 = static_cast<long>(blockIdx.y) * per_chunk;
  const long r1 = r0 + per_chunk < n ? r0 + per_chunk : n;
  E acc = Op::identity();
  if (j < p) {
    if constexpr (Op::COMMUTATIVE) {
#pragma unroll 4
      for (long i = r0 + grp; i < r1; i += groups)
        acc = Op::combine(acc, Map::apply(element<In, true>(A, x, i, j, p)));
    } else {
      const long len = cdiv(r1 - r0, groups);
      const long g0 = r0 + grp * len;
      const long g1 = g0 + len < r1 ? g0 + len : r1;
      for (long i = g0; i < g1; ++i)
        acc = Op::combine(acc, Map::apply(element<In, true>(A, x, i, j, p)));
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (grp == 0 && j < p) {
    E v = part[col];
    for (int g = 1; g < groups; ++g) v = Op::combine(v, part[g * tc + col]);
    if (direct)
      v.store(out, j);
    else
      partials[static_cast<long>(blockIdx.y) * p + j] = v;
  }
}

// ---------------------------------------------------------------------------
// K4 vecmat
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

template <typename Map, typename Op>
__global__ void __launch_bounds__(THREADS)
vecmat_partials(const void* A, const void* x, long n, long p, int g,
                long per_chunk, typename Op::E* partials, Leaves out,
                bool direct) {
  using E = typename Op::E;
  using In = typename Map::In;
  const int lane = threadIdx.x & (g - 1);
  const long i = static_cast<long>(blockIdx.x) * (THREADS / g) + threadIdx.x / g;
  const long c0 = static_cast<long>(blockIdx.y) * per_chunk;
  const long c1 = c0 + per_chunk < p ? c0 + per_chunk : p;
  E acc = Op::identity();
  if (i < n) {
    if constexpr (Op::COMMUTATIVE) {
#pragma unroll 4
      for (long c = c0 + lane; c < c1; c += g)
        acc = Op::combine(acc, Map::apply(element<In, false>(A, x, i, c, p)));
    } else {
      const long len = cdiv(c1 - c0, g);
      const long l0 = c0 + lane * len;
      const long l1 = l0 + len < c1 ? l0 + len : c1;
      for (long c = l0; c < l1; ++c)
        acc = Op::combine(acc, Map::apply(element<In, false>(A, x, i, c, p)));
    }
  }
  // Every lane of the warp takes part in the shuffles, in or out of range.
  if constexpr (Op::COMMUTATIVE) {
    for (int d = g / 2; d > 0; d >>= 1)
      acc = Op::combine(acc, E::shfl_down(acc, d, g));
  } else {
    // Lane l ends holding lanes l .. l + 2d - 1 in order (l a multiple of
    // 2d); lane 0 holds the whole row chunk.
    for (int d = 1; d < g; d <<= 1)
      acc = Op::combine(acc, E::shfl_down(acc, d, g));
  }
  if (lane == 0 && i < n) {
    if (direct)
      acc.store(out, i);
    else
      partials[static_cast<long>(blockIdx.y) * n + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// K5 packed matvec
// ---------------------------------------------------------------------------

Plan packed_plan(long n, long p) {
  Plan pl;
  pl.width = static_cast<int>((THREADS / p) * p);  // active threads
  pl.tiles = 1;
  const long groups = THREADS / p;
  long chunks = clampl(TARGET_BLOCKS, 1,
                       clampl(n / (8 * groups), 1, MAX_GRID_Y));
  pl.per_chunk = cdiv(n, chunks);
  pl.chunks = cdiv(n, pl.per_chunk);
  return pl;
}

template <typename Map, typename Op>
__global__ void __launch_bounds__(THREADS)
packed_partials(const void* A, const void* x, long n, long p, int w,
                long per_chunk, typename Op::E* partials, Leaves out,
                bool direct) {
  using E = typename Op::E;
  using In = typename Map::In;
  __shared__ E part[THREADS];
  const int t = threadIdx.x;
  const long groups = w / p;
  const long r0 = static_cast<long>(blockIdx.y) * per_chunk;
  const long r1 = r0 + per_chunk < n ? r0 + per_chunk : n;
  E acc = Op::identity();
  if (t < w) {
    const long j = t % p;
#pragma unroll 4
    for (long i = r0 + t / p; i < r1; i += groups)
      acc = Op::combine(acc, Map::apply(element<In, true>(A, x, i, j, p)));
  }
  part[t] = acc;
  __syncthreads();
  if (t < p) {
    E v = part[t];
    for (long g = 1; g < groups; ++g) v = Op::combine(v, part[g * p + t]);
    if (direct)
      v.store(out, t);
    else
      partials[static_cast<long>(blockIdx.y) * p + t] = v;
  }
}

// ---------------------------------------------------------------------------
// Phase 2 of every form: fold the (chunks, m) partials.  In chunk order, one
// thread per output; for a commutative op one block per output, its threads
// striding over the chunks, so few outputs of many chunks (K5's p columns)
// do not wait on one thread's chain of loads.
// ---------------------------------------------------------------------------

template <typename Op>
__global__ void __launch_bounds__(THREADS)
fold_partials(const typename Op::E* partials, long chunks, long m,
              Leaves out) {
  using E = typename Op::E;
  const long j = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= m) return;
  E v = partials[j];
#pragma unroll 8
  for (long k = 1; k < chunks; ++k) v = Op::combine(v, partials[k * m + j]);
  v.store(out, j);
}

template <typename Op>
__global__ void __launch_bounds__(THREADS)
fold_partials_commutative(const typename Op::E* partials, long chunks, long m,
                          Leaves out) {
  using E = typename Op::E;
  __shared__ E warp_smem[THREADS / 32];
  const long j = blockIdx.x;
  E v = Op::identity();
  for (long k = threadIdx.x; k < chunks; k += THREADS)
    v = Op::combine(v, partials[k * m + j]);
  v = block_reduce_commutative<Op, THREADS>(v, warp_smem);
  if (threadIdx.x == 0) v.store(out, j);
}

enum Form { MATVEC = 0, VECMAT = 1, PACKED = 2 };

Plan plan(int form, long n, long p) {
  return form == MATVEC ? matvec_plan(n, p)
                        : (form == VECMAT ? vecmat_plan(n, p) : packed_plan(n, p));
}

// `partials` holds plan(...).chunks * outputs elements of Op::E when chunks
// > 1 (unused otherwise); `x` is read only when Map::In has two leaves.
template <typename Map, typename Op>
cudaError_t run(int form, const void* A, const void* x, long n, long p,
                void* partials, Leaves out, cudaStream_t stream) {
  using E = typename Op::E;
  if (n <= 0 || p <= 0 || (Map::In::LEAVES == 2 && x == nullptr))
    return cudaErrorInvalidValue;
  const Plan pl = plan(form, n, p);
  const long m = form == VECMAT ? n : p;  // outputs
  const bool direct = pl.chunks == 1;
  E* part = static_cast<E*>(partials);
  const dim3 grid(static_cast<unsigned>(pl.tiles),
                  static_cast<unsigned>(pl.chunks));
  if (form == MATVEC) {
    matvec_partials<Map, Op><<<grid, THREADS, 0, stream>>>(
        A, x, n, p, pl.width, pl.per_chunk, part, out, direct);
  } else if (form == VECMAT) {
    vecmat_partials<Map, Op><<<grid, THREADS, 0, stream>>>(
        A, x, n, p, pl.width, pl.per_chunk, part, out, direct);
  } else {
    if constexpr (!Op::COMMUTATIVE) {
      return cudaErrorInvalidValue;
    } else {
      if (p > 64 || Map::In::LEAVES != 2) return cudaErrorInvalidValue;
      packed_partials<Map, Op><<<grid, THREADS, 0, stream>>>(
          A, x, n, p, pl.width, pl.per_chunk, part, out, direct);
    }
  }
  if (direct) return cudaGetLastError();
  if constexpr (Op::COMMUTATIVE) {
    fold_partials_commutative<Op><<<static_cast<unsigned>(m), THREADS, 0,
                                     stream>>>(part, pl.chunks, m, out);
  } else {
    fold_partials<Op><<<static_cast<unsigned>(cdiv(m, THREADS)), THREADS, 0,
                         stream>>>(part, pl.chunks, m, out);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace matvec
}  // namespace rt
