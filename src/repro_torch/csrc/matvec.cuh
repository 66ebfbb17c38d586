// K4: generalized semiring matvec and vecmat over a row-major (n, p) matrix,
// K5: the tall-narrow matvec for p <= 64, K7's batched GEMVs over (B, n, p)
// matrices against per-batch vectors, and K9: the same forms over a
// quantized matrix (int8 or fp8 codes with block scales).  Templates over
// the generated map Map, functor Op over Map::Out, and a matrix operand Mat
// (Dense, or Quantized with the generated decode Dec).
//
//   matvec  y[b, j] = op_i f(x[b, i], A[b, i, j])   (reduce over rows)
//   vecmat  z[b, i] = op_j f(A[b, i, j], x[b, j])   (reduce over columns)
//
// with B = 1 for the flat forms.  Map::In holds (x, a) for matvec and
// (a, x) for vecmat; with one leaf it is the matrix element alone (the
// mapreduce axis forms, no vector).
//
// K4 replaces: src/repro/kernels/matvec.py::matvec_pallas (body
// _matvec_kernel) and ::vecmat_pallas (body _vecmat_kernel), which walk the
// reduction axis on the TPU's sequential grid with the output block as
// accumulator.
// K5 replaces: src/repro/kernels/matvec.py::matvec_packed_pallas (body
// _matvec_packed_kernel), which packs 128 // p row groups into the TPU's
// lanes so a narrow matrix does not pad p columns to 128.
// K7 replaces: src/repro/kernels/batched.py::batched_matvec_pallas and
// ::batched_vecmat_pallas, the K4 bodies under a leading batch grid axis.
// K9 replaces: src/repro/kernels/matvec.py::matvec_quantized_pallas and
// ::vecmat_quantized_pallas (bodies _matvec_q_kernel, _vecmat_q_kernel,
// _dequant_tile) and src/repro/kernels/batched.py::
// batched_matvec_quantized_pallas and ::batched_vecmat_quantized_pallas.
//
// Bound on this card: memory, one read of A (plus x) and one write of the
// output: at the radix histogram (1,024,000 x 256) int32 1.05 GB, 0.31 ms; at
// K5's (10^6, 10) f32 44 MB, 0.013 ms, where two launches and the wrapper
// are the cost; K9 at the unembed GEMV (2560, 256000) int8 with block 64
// reads 655 MB of codes and 41 MB of scales, 0.21 ms.  Hopper has no
// sequential grid to carry the accumulator, so every form is two-phase:
//   1. The grid is (B x output tiles, chunks of the reduction axis): the
//      batch folds into grid x, so B > 65,535 launches.  Each block folds
//      its chunk into one partial per output element, in registers, then
//      combines its thread groups' partials in group order through shared
//      memory, and writes (chunks, B x outputs) partials (or the output
//      itself when there is one chunk).  The chunk count gives about four
//      blocks per SM over the whole batch; at large B x outputs it is one,
//      and the form is one launch.  Offsets are 64-bit (B n p passes 2^31).
//   2. A second launch folds the partials: in chunk order, one thread per
//      output, or, for a commutative op over many chunks, one block per
//      output.
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
// K9: the matrix operand loads a code (int8_t or uint8_t), decodes it to the
// bits of the reference's field decode with integer operations (the fp8
// fields moved into float32's positions and rebiased by a power of two;
// no hardware fp8 conversion: the reference decodes every code as finite,
// e4m3 0x7F as 480) and multiplies it by its block's scale in f32, rounded
// on its own; only that value reaches the map.  A matvec thread walks down one column and keeps the
// column's scale in a register for `block` rows; vecmat lanes of one row
// read the row's scale row beside the codes.  Every row reads its own
// scale, so a chunk may cut a quantization block (the reference's row tile
// had to be a multiple of `block`: a TPU tiling rule).
#pragma once

#include "common.cuh"

#include <type_traits>

namespace rt {
namespace matvec {
namespace {

constexpr int THREADS = 256;
constexpr long TARGET_BLOCKS = 4 * 132;
constexpr long MAX_GRID_X = 2147483647;
constexpr long MAX_GRID_Y = 65535;
// From this many chunks on, a commutative op folds each output's partials
// with a whole block; below it, one thread per output.
constexpr long BLOCK_FOLD_CHUNKS = 32;

__host__ __device__ inline long cdiv(long a, long b) { return (a + b - 1) / b; }
long clampl(long v, long lo, long hi) { return v < lo ? lo : (v > hi ? hi : v); }

// The narrowest power of two >= m, capped at one warp.
int group_width(long m) {
  int w = 1;
  while (w < 32 && w < m) w <<= 1;
  return w;
}

// ---------------------------------------------------------------------------
// Matrix operands: element (b, i, j) of a row-major (B, n, p) matrix, as the
// map's matrix leaf type V, VEC adjacent columns at a time (p % VEC == 0).
// column(b, j) walks down columns j .. j + VEC - 1 (rows in increasing
// order), row(b, i) along a row: raw() is the load alone, decode() turns
// it into VEC elements, so a loop can issue several loads before it waits
// on any.
// ---------------------------------------------------------------------------

template <typename T>
struct Dense {
  using V = T;
  static constexpr int VEC = 1;
  const T* a;
  long n, p;

  struct Column {
    using Raw = T;
    const T* c;
    long p;
    __device__ T raw(long i) const { return c[i * p]; }
    __device__ void decode(long, T r, T (&v)[1]) { v[0] = r; }
  };
  struct Row {
    using Raw = T;
    const T* r;
    __device__ T raw(long j) const { return r[j]; }
    __device__ void decode(T w, T (&v)[1]) const { v[0] = w; }
  };
  __device__ Column column(long b, long j) const {
    return Column{a + b * n * p + j, p};
  }
  __device__ Row row(long b, long i) const { return Row{a + (b * n + i) * p}; }
};

// Codes q (B, n, p) of Dec::Code and f32 scales s (B, nb, p), one per
// `block` rows per column.  An element is __fmul_rn(Dec::apply(code),
// scale): the dequantized value of the plain version, bit for bit.  With
// VEC = 4 a thread loads four adjacent codes as one 32-bit word and their
// scales as one float4 (codes 4-byte and scales 16-byte aligned), so a warp
// reads 128 bytes of codes per row, not 32.
template <typename Dec, int W>
struct Quantized {
  using V = float;
  using Code = typename Dec::Code;
  static constexpr int VEC = W;
  static_assert(W == 1 || W == 4, "one code or a 32-bit word of four");
  using Word = typename std::conditional<W == 1, Code, unsigned>::type;
  const Code* q;
  const float* s;
  long n, p, block, nb;

  // The W codes of a word, each times its scale, rounded on its own.
  __device__ static void dequantize(Word w, const float (&scale)[W],
                                    float (&v)[W]) {
    if constexpr (W == 1) {
      v[0] = __fmul_rn(Dec::apply(w), scale[0]);
    } else {
#pragma unroll
      for (int u = 0; u < W; ++u)
        v[u] = __fmul_rn(Dec::apply(static_cast<Code>((w >> (8 * u)) & 0xffu)),
                         scale[u]);
    }
  }

  __device__ static void load_scales(const float* sc, float (&scale)[W]) {
    if constexpr (W == 1) {
      scale[0] = sc[0];
    } else {
      const float4 s4 = *reinterpret_cast<const float4*>(sc);
      scale[0] = s4.x, scale[1] = s4.y, scale[2] = s4.z, scale[3] = s4.w;
    }
  }

  struct Column {
    using Raw = Word;
    const Code* c;
    const float* sc;
    long p, block;
    long end;      // the first row past the block whose scales are held
    float scale[W];
    __device__ Raw raw(long i) const {
      return *reinterpret_cast<const Raw*>(c + i * p);
    }
    __device__ void decode(long i, Raw w, float (&v)[W]) {
      if (i >= end) {                  // rows only ever increase
        const long k = i / block;
        load_scales(sc + k * p, scale);
        end = (k + 1) * block;
      }
      dequantize(w, scale, v);
    }
  };
  struct Row {
    struct Raw {
      Word w;
      float scale[W];
    };
    const Code* r;
    const float* sr;
    __device__ Raw raw(long j) const {
      Raw o;
      o.w = *reinterpret_cast<const Word*>(r + j);
      load_scales(sr + j, o.scale);
      return o;
    }
    __device__ void decode(const Raw& o, float (&v)[W]) const {
      dequantize(o.w, o.scale, v);
    }
  };
  __device__ Column column(long b, long j) const {
    return Column{q + b * n * p + j, s + b * nb * p + j, p, block, -1, {}};
  }
  __device__ Row row(long b, long i) const {
    return Row{q + (b * n + i) * p, s + (b * nb + i / block) * p};
  }
};

// The map's input for matrix element `a` at row i (matvec: In = (x[i], a))
// or column j (vecmat: In = (a, x[j])); `xb` is the batch's vector.
// One-leaf In: the matrix element alone.
template <typename In, typename V>
__device__ __forceinline__ In mv_element(const void* xb, V a, long i) {
  In e;
  if constexpr (In::LEAVES == 1) {
    e.v0 = a;
  } else {
    e.v0 = static_cast<const typename In::T0*>(xb)[i];
    e.v1 = a;
  }
  return e;
}

template <typename In, typename V>
__device__ __forceinline__ In vm_element(V a, const void* xb, long j) {
  In e;
  e.v0 = a;
  if constexpr (In::LEAVES == 2) e.v1 = static_cast<const typename In::T1*>(xb)[j];
  return e;
}

// Batch b's vector: x + b * len elements of the vector's leaf type.
template <typename T>
__device__ __forceinline__ const void* batch_vector(const void* x, long b,
                                                    long len) {
  return x == nullptr ? nullptr : static_cast<const T*>(x) + b * len;
}

// matvec's matrix leaf type: the last leaf of In.
template <typename In, int LEAVES = In::LEAVES>
struct MatrixLeaf {
  using T = typename In::T1;
};
template <typename In>
struct MatrixLeaf<In, 1> {
  using T = typename In::T0;
};

// Fold rows i, i + step, ... < end of one thread's VEC columns into acc, in
// row order.  Four rows at a time: their matrix loads all issue before the
// first is decoded, so a thread keeps four loads in flight whatever the
// decode and the operator cost.
template <typename Map, typename Op, int VEC, typename Col>
__device__ __forceinline__ void fold_rows(Col& c, const void* xb, long i,
                                          long end, long step,
                                          typename Op::E (&acc)[VEC]) {
  using In = typename Map::In;
  using V = typename MatrixLeaf<In>::T;
  constexpr int U = 4;
  for (; i + (U - 1) * step < end; i += U * step) {
    typename Col::Raw raw[U];
#pragma unroll
    for (int k = 0; k < U; ++k) raw[k] = c.raw(i + k * step);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      V a[VEC];
      c.decode(i + k * step, raw[k], a);
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        acc[u] = Op::combine(
            acc[u], Map::apply(mv_element<In>(xb, a[u], i + k * step)));
    }
  }
  for (; i < end; i += step) {
    V a[VEC];
    c.decode(i, c.raw(i), a);
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      acc[u] = Op::combine(acc[u], Map::apply(mv_element<In>(xb, a[u], i)));
  }
}

struct Plan {
  int width;       // columns per block (matvec), lanes per row (vecmat)
  long tiles;      // output tiles per batch; grid x = B * tiles
  long chunks;     // grid y: chunks of the reduction axis
  long per_chunk;  // reduction-axis extent of one chunk
};

// ---------------------------------------------------------------------------
// K4 / K7 / K9 matvec
// ---------------------------------------------------------------------------

Plan matvec_plan(long B, long n, long p, int vec) {
  Plan pl;
  pl.width = group_width(cdiv(p, vec));
  pl.tiles = cdiv(p, pl.width * vec);
  const long groups = THREADS / pl.width;
  // At least 8 rows per thread group in a chunk.
  long chunks = clampl(cdiv(TARGET_BLOCKS, B * pl.tiles), 1,
                       clampl(n / (8 * groups), 1, MAX_GRID_Y));
  pl.per_chunk = cdiv(n, chunks);
  pl.chunks = cdiv(n, pl.per_chunk);
  return pl;
}

template <typename Map, typename Op, typename Mat>
__global__ void __launch_bounds__(THREADS)
matvec_partials(Mat M, const void* x, long B, long tiles, int tc,
                long per_chunk, typename Op::E* partials, Leaves out,
                bool direct) {
  using E = typename Op::E;
  using In = typename Map::In;
  using V = typename Mat::V;
  constexpr int VEC = Mat::VEC;
  static_assert(std::is_same<typename MatrixLeaf<In>::T, V>::value,
                "the map's matrix leaf is the operand's element type");
  __shared__ E part[THREADS * VEC];
  const long n = M.n, p = M.p;
  const long b = blockIdx.x / tiles;
  const long tile = blockIdx.x - b * tiles;
  const int col = threadIdx.x & (tc - 1);
  const int grp = threadIdx.x / tc;
  const int groups = THREADS / tc;
  const long j = (tile * tc + col) * VEC;  // the first of VEC columns
  const long r0 = static_cast<long>(blockIdx.y) * per_chunk;
  const long r1 = r0 + per_chunk < n ? r0 + per_chunk : n;
  E acc[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc[u] = Op::identity();
  if (j < p) {
    auto c = M.column(b, j);
    const void* xb = batch_vector<typename In::T0>(x, b, n);
    if constexpr (Op::COMMUTATIVE) {
      fold_rows<Map, Op, VEC>(c, xb, r0 + grp, r1, groups, acc);
    } else {
      const long len = cdiv(r1 - r0, groups);
      const long g0 = r0 + grp * len;
      fold_rows<Map, Op, VEC>(c, xb, g0, g0 + len < r1 ? g0 + len : r1, 1,
                              acc);
    }
  }
#pragma unroll
  for (int u = 0; u < VEC; ++u) part[threadIdx.x * VEC + u] = acc[u];
  __syncthreads();
  if (grp == 0 && j < p) {
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      E v = part[col * VEC + u];
      for (int g = 1; g < groups; ++g)
        v = Op::combine(v, part[(g * tc + col) * VEC + u]);
      if (direct)
        v.store(out, b * p + j + u);
      else
        partials[static_cast<long>(blockIdx.y) * B * p + b * p + j + u] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// K4 / K7 / K9 vecmat
// ---------------------------------------------------------------------------

Plan vecmat_plan(long B, long n, long p, int vec) {
  Plan pl;
  pl.width = group_width(cdiv(p, vec));
  pl.tiles = cdiv(n, THREADS / pl.width);
  const long step = static_cast<long>(pl.width) * vec;  // a row's lanes
  long chunks = clampl(cdiv(TARGET_BLOCKS, B * pl.tiles), 1,
                       clampl(p / (8 * step), 1, MAX_GRID_Y));
  pl.per_chunk = cdiv(cdiv(p, chunks), step) * step;
  pl.chunks = cdiv(p, pl.per_chunk);
  return pl;
}

template <typename Map, typename Op, typename Mat>
__global__ void __launch_bounds__(THREADS)
vecmat_partials(Mat M, const void* x, long B, long tiles, int g,
                long per_chunk, typename Op::E* partials, Leaves out,
                bool direct) {
  using E = typename Op::E;
  using In = typename Map::In;
  using V = typename Mat::V;
  constexpr int VEC = Mat::VEC;
  static_assert(std::is_same<typename In::T0, V>::value,
                "the map's matrix leaf is the operand's element type");
  const long n = M.n, p = M.p;
  const long b = blockIdx.x / tiles;
  const long tile = blockIdx.x - b * tiles;
  const int lane = threadIdx.x & (g - 1);
  const long i = tile * (THREADS / g) + threadIdx.x / g;
  const long c0 = static_cast<long>(blockIdx.y) * per_chunk;
  const long c1 = c0 + per_chunk < p ? c0 + per_chunk : p;
  E acc = Op::identity();
  if (i < n) {
    const auto r = M.row(b, i);
    const void* xb = batch_vector<typename MatrixLeaf<In>::T>(x, b, p);
    V a[VEC];
    // Chunk bounds and lane runs are whole multiples of VEC (p % VEC == 0).
    // (Issuing four steps' loads before decoding, as matvec's fold_rows
    // does, measured 7-13% slower on the f32 GEMV here.)
    if constexpr (Op::COMMUTATIVE) {
#pragma unroll 4
      for (long c = c0 + lane * VEC; c < c1; c += g * VEC) {
        r.decode(r.raw(c), a);
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc = Op::combine(acc, Map::apply(vm_element<In>(a[u], xb, c + u)));
      }
    } else {
      const long len = cdiv(cdiv(c1 - c0, VEC), g) * VEC;
      const long l0 = c0 + lane * len;
      const long l1 = l0 + len < c1 ? l0 + len : c1;
      for (long c = l0; c < l1; c += VEC) {
        r.decode(r.raw(c), a);
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc = Op::combine(acc, Map::apply(vm_element<In>(a[u], xb, c + u)));
      }
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
      acc.store(out, b * n + i);
    else
      partials[static_cast<long>(blockIdx.y) * B * n + b * n + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// K5 packed matvec (flat, dense)
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

template <typename Map, typename Op, typename Mat>
__global__ void __launch_bounds__(THREADS)
packed_partials(Mat M, const void* x, int w, long per_chunk,
                typename Op::E* partials, Leaves out, bool direct) {
  using E = typename Op::E;
  __shared__ E part[THREADS];
  const long n = M.n, p = M.p;
  const int t = threadIdx.x;
  const long groups = w / p;
  const long r0 = static_cast<long>(blockIdx.y) * per_chunk;
  const long r1 = r0 + per_chunk < n ? r0 + per_chunk : n;
  E acc = Op::identity();
  if (t < w) {
    auto c = M.column(0, t % p);
    E accs[1] = {acc};
    fold_rows<Map, Op, 1>(c, x, r0 + t / p, r1, groups, accs);
    acc = accs[0];
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
// thread per output; for a commutative op over many chunks one block per
// output, its threads striding over the chunks, so few outputs of many
// chunks (K5's p columns) do not wait on one thread's chain of loads.
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

// `vec`: the operand's columns per load (Mat::VEC).
Plan plan(int form, long B, long n, long p, int vec) {
  return form == MATVEC ? matvec_plan(B, n, p, vec)
                        : (form == VECMAT ? vecmat_plan(B, n, p, vec)
                                          : packed_plan(n, p));
}

// A quantized operand loads four codes at a time where p allows it.
int quant_vec(long p) { return p % 4 == 0 ? 4 : 1; }

// `partials` holds plan(...).chunks * B * outputs elements of Op::E when
// chunks > 1 (unused otherwise); `x` (B vectors) is read only when Map::In
// has two leaves.  The outputs are (B, outputs), row-major.
template <typename Map, typename Op, typename Mat>
cudaError_t run(int form, const Mat& M, const void* x, long B,
                void* partials, Leaves out, cudaStream_t stream) {
  using E = typename Op::E;
  const long n = M.n, p = M.p;
  if (B <= 0 || n <= 0 || p <= 0 || (Map::In::LEAVES == 2 && x == nullptr) ||
      (form == PACKED && (B != 1 || Mat::VEC != 1)) || p % Mat::VEC != 0)
    return cudaErrorInvalidValue;
  const Plan pl = plan(form, B, n, p, Mat::VEC);
  if (B * pl.tiles > MAX_GRID_X) return cudaErrorInvalidValue;
  const long m = B * (form == VECMAT ? n : p);  // outputs
  const bool direct = pl.chunks == 1;
  E* part = static_cast<E*>(partials);
  const dim3 grid(static_cast<unsigned>(B * pl.tiles),
                  static_cast<unsigned>(pl.chunks));
  if (form == MATVEC) {
    matvec_partials<Map, Op, Mat><<<grid, THREADS, 0, stream>>>(
        M, x, B, pl.tiles, pl.width, pl.per_chunk, part, out, direct);
  } else if (form == VECMAT) {
    vecmat_partials<Map, Op, Mat><<<grid, THREADS, 0, stream>>>(
        M, x, B, pl.tiles, pl.width, pl.per_chunk, part, out, direct);
  } else {
    if constexpr (!Op::COMMUTATIVE || Mat::VEC != 1) {
      return cudaErrorInvalidValue;
    } else {
      if (p > 64 || Map::In::LEAVES != 2) return cudaErrorInvalidValue;
      packed_partials<Map, Op, Mat><<<grid, THREADS, 0, stream>>>(
          M, x, pl.width, pl.per_chunk, part, out, direct);
    }
  }
  if (direct) return cudaGetLastError();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Op::COMMUTATIVE && pl.chunks >= BLOCK_FOLD_CHUNKS) {
    fold_partials_commutative<Op><<<static_cast<unsigned>(m), THREADS, 0,
                                     stream>>>(part, pl.chunks, m, out);
  } else {
    fold_partials<Op><<<static_cast<unsigned>(cdiv(m, THREADS)), THREADS, 0,
                         stream>>>(part, pl.chunks, m, out);
  }
  return cudaGetLastError();
}

// A dense matrix of the map's leaf type (x and A share one dtype).
template <typename Map, typename Op>
cudaError_t run_dense(int form, const void* A, const void* x, long B, long n,
                      long p, void* partials, Leaves out,
                      cudaStream_t stream) {
  using T = typename MatrixLeaf<typename Map::In>::T;
  return run<Map, Op>(form, Dense<T>{static_cast<const T*>(A), n, p}, x, B,
                      partials, out, stream);
}

// A quantized matrix: codes of Dec::Code, f32 scales, one per `block` rows;
// four codes a load where quant_vec(p) says so (the caller aligns codes to 4
// and scales to 16 bytes).
template <typename Map, typename Op, typename Dec>
cudaError_t run_quantized(int form, const void* q, const void* s, long block,
                          const void* x, long B, long n, long p,
                          void* partials, Leaves out, cudaStream_t stream) {
  using Code = typename Dec::Code;
  if (block <= 0 || form == PACKED) return cudaErrorInvalidValue;
  const Code* codes = static_cast<const Code*>(q);
  const float* scales = static_cast<const float*>(s);
  if (quant_vec(p) == 4) {
    if (reinterpret_cast<unsigned long>(q) % 4 ||
        reinterpret_cast<unsigned long>(s) % 16)
      return cudaErrorInvalidValue;
    const Quantized<Dec, 4> M{codes, scales, n, p, block, cdiv(n, block)};
    return run<Map, Op>(form, M, x, B, partials, out, stream);
  }
  const Quantized<Dec, 1> M{codes, scales, n, p, block, cdiv(n, block)};
  return run<Map, Op>(form, M, x, B, partials, out, stream);
}

}  // namespace
}  // namespace matvec
}  // namespace rt
