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
// output: at the paper's Table V/VI shapes of 10^7 f32 elements 40 MB,
// 0.012 ms (and the matrix fits the 50 MB L2, so back-to-back calls read
// it faster than that); at (10^4, 10^4) 400 MB, 0.119 ms; at the radix
// histogram (1,024,000 x 256) int32 1.05 GB, 0.31 ms; K9 at the unembed
// GEMV (2560, 256000) int8 with block 64 reads 655 MB of codes and 41 MB of
// scales, 0.21 ms.  Below 0.1 ms a call's time is the host's unless the
// launch is lean, so the host plans every launch (kernels/matvec.py:
// geometry) and passes it in; every form is one launch.
//
// Five kinds of launch, each a grid of (B x output tiles, chunks of the
// reduction axis) blocks of 256 threads:
//   COLUMNS (matvec, K4 / K7 / K9): a block has tc column threads, each
//     holding VEC adjacent columns, and 256 / tc row groups.  A dense
//     matrix under a commutative op interleaves the rows over the groups,
//     so the block's warps stay on nearby rows; an op that does not commute,
//     and every quantized matrix, gives each group a contiguous run of rows
//     (a quantized column thread then loads its scales once per
//     quantization block it meets, not once per row group).  Few rows (the
//     short matvec, n = 10): one group, one chunk, each thread walks all n
//     rows of its columns and stores its output, no barrier at all.
//   ROWS (vecmat over p > 64, dense, K4 / K7): `lanes` threads share a row
//     (a power of two up to the whole block), striding over its columns for
//     a commutative op, or each a contiguous run in column order; the lanes
//     combine by an (ordered) shuffle tree, then warp totals in order
//     through shared memory.
//   STRIPS (vecmat over a quantized matrix, K9): a block owns a strip of
//     at most STRIP_MAX rows that never leaves one quantization block of
//     one batch, over a chunk of columns.  Each of its eight warps walks
//     one contiguous run of the chunk, whatever the op, 32 lanes x VEC
//     columns a step.  At each step a lane loads its VEC columns' scales
//     and x once and applies them to every row of the strip, so every
//     scale leaves memory once per strip and chunk (B nb p floats over a
//     launch), not once per row (B n p).  The rows go eight at a time,
//     eight code loads in flight a lane: each lane folds its VEC columns
//     of a row in order, the warp folds the eight rows across its lanes
//     in lane order by an ordered reduce-scatter (fold_eight), and lanes
//     0 .. 7 add the rows' totals to the warp's in shared memory; the
//     warps combine in order at the end.
//   PACKED (K5, matvec, p <= 64, commutative, flat dense): the matrix is
//     read as the flat stream of n p elements, VEC at a time.  A step is S
//     elements, a multiple of p and of VEC, so thread t's VEC elements always
//     sit in the same columns (VEC t + u) % p, whatever p is, and its row
//     advances by S / p each step.  The block folds its per-thread
//     accumulators by column in shared memory.
//   TALL (vecmat over p <= 64, dense): a block copies its R rows, one
//     contiguous stream of R p elements, into shared memory with coalesced
//     VEC-wide loads, then thread r folds row r in column order, so any
//     operator keeps its order.
// Wide loads: VEC = 4 four-byte elements (16 bytes) per load where the host
// found A 16-byte aligned (and p % 4 == 0 for COLUMNS and ROWS), else
// VEC = 1; a quantized matrix VEC = 16 one-byte codes per 16-byte load
// (codes and scales 16-byte aligned, p % 16 == 0), else 4 codes per 32-bit
// load (codes 4-byte and scales 16-byte aligned, p % 4 == 0), else one;
// the host's choice, counted per form.  A misaligned operand takes a
// narrower load and is never copied.
// Chunks: where one pass over the reduction axis would leave the card idle
// (few outputs, a long axis), it is cut into chunks over grid y.  Each block
// writes its partials to the stream's workspace, fences, and takes a ticket
// from its output tile's counter; the block that draws the last ticket
// folds the tile's partials in chunk order (through L2) into the output and
// resets the counter to 0 for the next launch on the stream.  No memset, no
// second launch; one workspace (counters, partials) per stream, so launches
// on two streams never share a counter.
// K9: the matrix operand loads VEC codes (int8_t or uint8_t) at once, takes
// each out of its word with one byte permute (prmt), decodes it to the
// bits of the reference's field decode with integer operations (int8 by
// the 2^23 trick; the fp8 fields moved into float32's positions and
// rebiased by a power of two; no hardware fp8 conversion: the reference
// decodes every code as finite, e4m3 0x7F as 480) and multiplies it by its
// block's scale in f32, rounded on its own; only that value reaches the
// map.  A matvec thread walks down VEC columns and keeps their scales in
// registers for `block` rows; a STRIPS lane keeps its VEC columns' scales
// for every row of its strip.  The reference (_dequant_tile) broadcasts
// one scale tile over its rows in VMEM, so its scales leave HBM once a
// tile; these kernels keep that property in registers.  A matvec chunk may
// cut a quantization block (the reference's row tile had to be a multiple
// of `block`: a TPU tiling rule); a strip never does.
#pragma once

#include "common.cuh"

#include <cstring>
#include <type_traits>

namespace rt {
namespace matvec {
namespace {

constexpr int THREADS = 256;
constexpr long MAX_GRID_X = 2147483647;
constexpr long MAX_GRID_Y = 65535;
constexpr int PACKED_MAX_COLS = 64;
// TALL's shared tile: R p elements of at most this many bytes.
constexpr int TALL_BYTES = 16384;
// STRIPS: the most rows a strip holds, and the warps of a block.
constexpr int STRIP_MAX = 128;
constexpr int WARPS = THREADS / 32;

enum Kind { COLUMNS = 0, ROWS = 1, PACKED = 2, TALL = 3, STRIPS = 4 };

// The launch the host planned (kernels/matvec.py: geometry), ten longs.
// width: COLUMNS column threads per block, ROWS lanes per row, PACKED
// active threads (S / vec), TALL rows per block, STRIPS rows per strip.
// per_chunk: the reduction extent of one chunk (rows, columns, or
// PACKED's flat elements).  stream: 1 where a dense ROWS launch's matrix
// outgrows L2, so that its 16-byte loads evict first.
struct Geometry {
  long kind, vec, width, B, n, p, tiles, chunks, per_chunk, stream;
};

__host__ __device__ inline long cdiv(long a, long b) { return (a + b - 1) / b; }

// VEC adjacent elements, loaded as one 16-byte (VEC = 4) or plain word.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A dense row load: VEC elements in one instruction; a 16-byte ROWS load
// of a matrix larger than L2 (`CS`) marked evict-first (ld.global.cs), so
// that it does not evict what a later load of the same call, or the next
// call, would find in L2.  Measured on the H100 against plain loads, in
// one call: K7's vecmat at (40, 2048, 256) 9% faster, at (8, 4096, 4096)
// 2.5%; COLUMNS gained or lost 2-3% by what ran before it, so it has none.
template <bool CS, typename T>
__device__ __forceinline__ T load_word(const T* p) {
  if constexpr (CS && sizeof(T) == 16) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
    T out;
    std::memcpy(&out, &r, sizeof out);
    return out;
  } else {
    return *p;
  }
}

// Wide loads only of 4-byte leaves, and only where the partials of VEC
// columns fit the blocks' shared memory.
template <typename T, typename E>
constexpr bool wide_ok() {
  return sizeof(T) == 4 && sizeof(E) <= 16;
}

// ---------------------------------------------------------------------------
// Matrix operands: element (b, i, j) of a row-major (B, n, p) matrix, as the
// map's matrix leaf type V, VEC adjacent columns at a time (p % VEC == 0).
// column(b, j) walks down columns j .. j + VEC - 1 (rows in increasing
// order), row(b, i) along a row: raw() is the load alone, decode() turns
// it into VEC elements, so a loop can issue several loads before it waits
// on any.
// ---------------------------------------------------------------------------

template <typename T, int W, bool CS = false>
struct Dense {
  using V = T;
  static constexpr int VEC = W;
  static constexpr bool QUANT = false;
  static constexpr bool EVICT = CS;
  using Word = Pack<T, W>;
  const T* a;
  long n, p;

  struct Column {
    using Raw = Word;
    const T* c;
    long p;
    __device__ Raw raw(long i) const {
      return *reinterpret_cast<const Word*>(c + i * p);
    }
    __device__ void decode(long, const Raw& r, T (&v)[W]) {
#pragma unroll
      for (int u = 0; u < W; ++u) v[u] = r.v[u];
    }
  };
  struct Row {
    using Raw = Word;
    const T* r;
    __device__ Raw raw(long j) const {
      return load_word<CS>(reinterpret_cast<const Word*>(r + j));
    }
    __device__ void decode(const Raw& w, T (&v)[W]) const {
#pragma unroll
      for (int u = 0; u < W; ++u) v[u] = w.v[u];
    }
  };
  __device__ Column column(long b, long j) const {
    return Column{a + b * n * p + j, p};
  }
  __device__ Row row(long b, long i) const { return Row{a + (b * n + i) * p}; }
};

// W adjacent codes of Dec::Code in one load -- one code, a 32-bit word of
// four, or a 16-byte vector of sixteen -- and their W f32 scales (one
// float, or float4s).  An element is __fmul_rn(Dec::apply(code), scale):
// the dequantized value of the plain version, bit for bit.
template <typename Dec, int W>
struct Codes {
  using Code = typename Dec::Code;
  static_assert(W == 1 || W == 4 || W == 16,
                "one code, a 32-bit word of four or 16 bytes of sixteen");
  using Raw = typename std::conditional<
      W == 1, Code,
      typename std::conditional<W == 4, unsigned, uint4>::type>::type;

  __device__ static Raw load(const Code* c) {
    return *reinterpret_cast<const Raw*>(c);
  }
  __device__ static void scales(const float* s, float (&v)[W]) {
    if constexpr (W == 1) {
      v[0] = s[0];
    } else {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const float4 f = reinterpret_cast<const float4*>(s)[k];
        v[4 * k] = f.x, v[4 * k + 1] = f.y, v[4 * k + 2] = f.z,
        v[4 * k + 3] = f.w;
      }
    }
  }
  // The W codes of a load, each times its scale, rounded on its own; code u
  // of a word leaves it by one byte permute (byte u, zeros above).
  __device__ static void dequantize(const Raw& r, const float (&s)[W],
                                    float (&v)[W]) {
    if constexpr (W == 1) {
      v[0] = __fmul_rn(Dec::apply(r), s[0]);
    } else {
      unsigned w[W / 4];
      if constexpr (W == 4) {
        w[0] = r;
      } else {
        w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
      }
#pragma unroll
      for (int k = 0; k < W / 4; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned byte = __byte_perm(w[k], 0u, 0x4440u | u);
          v[4 * k + u] =
              __fmul_rn(Dec::apply(static_cast<Code>(byte)), s[4 * k + u]);
        }
    }
  }
};

// Codes q (B, n, p) and f32 scales s (B, nb, p), one per `block` rows per
// column, VEC = W codes a load (codes W-byte aligned, scales 16-byte
// aligned for W > 1, p % W == 0).  column(b, j) walks down columns
// j .. j + W - 1 and keeps their W scales in registers until its rows
// leave the quantization block.
template <typename Dec, int W>
struct Quantized {
  using V = float;
  using Code = typename Dec::Code;
  using Decode = Dec;
  using Load = Codes<Dec, W>;
  static constexpr int VEC = W;
  static constexpr bool QUANT = true;
  static constexpr bool EVICT = false;
  const Code* q;
  const float* s;
  long n, p, block, nb;

  struct Column {
    using Raw = typename Load::Raw;
    const Code* c;
    const float* sc;
    long p, block;
    long end;      // the first row past the block whose scales are held
    float scale[W];
    __device__ Raw raw(long i) const { return Load::load(c + i * p); }
    __device__ void decode(long i, const Raw& w, float (&v)[W]) {
      if (i >= end) {                  // rows only ever increase
        const long k = i / block;
        Load::scales(sc + k * p, scale);
        end = (k + 1) * block;
      }
      Load::dequantize(w, scale, v);
    }
  };
  __device__ Column column(long b, long j) const {
    return Column{q + b * n * p + j, s + b * nb * p + j, p, block, -1, {}};
  }
};

// The map's input for matrix element `a` beside the vector's element `xv`:
// matvec In = (x[i], a), vecmat In = (a, x[j]); one-leaf In: `a` alone.
template <typename In, typename V, typename X>
__device__ __forceinline__ In mv_element(X xv, V a) {
  In e;
  if constexpr (In::LEAVES == 1) {
    e.v0 = a;
  } else {
    e.v0 = xv;
    e.v1 = a;
  }
  return e;
}

template <typename In, typename V, typename X>
__device__ __forceinline__ In vm_element(V a, X xv) {
  In e;
  e.v0 = a;
  if constexpr (In::LEAVES == 2) e.v1 = xv;
  return e;
}

// matvec's vector leaf (In's first of two) and matrix leaf (its last);
// with one leaf there is no vector, and the vector type is a placeholder.
template <typename In, int LEAVES = In::LEAVES>
struct Leaf {
  using X = typename In::T0;
  using A = typename In::T1;
};
template <typename In>
struct Leaf<In, 1> {
  using X = char;
  using A = typename In::T0;
};

// Element k of the vector xb, or nothing when the map takes no vector.
template <typename X>
__device__ __forceinline__ X vec_at(const void* xb, long k) {
  return xb == nullptr ? X{} : static_cast<const X*>(xb)[k];
}

// Batch b's vector: x + b * len elements of the vector's leaf type.
template <typename T>
__device__ __forceinline__ const void* batch_vector(const void* x, long b,
                                                    long len) {
  return x == nullptr ? nullptr : static_cast<const T*>(x) + b * len;
}

// Fold rows i, i + step, ... < end of one thread's VEC columns into acc, in
// row order.  Eight rows at a time: their matrix loads all issue before the
// first is decoded, so a thread keeps eight loads in flight (128 bytes)
// whatever the decode and the operator cost.
template <typename Map, typename Op, int VEC, typename Col>
__device__ __forceinline__ void fold_rows(Col& c, const void* xb, long i,
                                          long end, long step,
                                          typename Op::E (&acc)[VEC]) {
  using In = typename Map::In;
  using V = typename Leaf<In>::A;
  using X = typename Leaf<In>::X;
  constexpr int U = 8;
  for (; i + (U - 1) * step < end; i += U * step) {
    typename Col::Raw raw[U];
    X xv[U];
#pragma unroll
    for (int k = 0; k < U; ++k) raw[k] = c.raw(i + k * step);
#pragma unroll
    for (int k = 0; k < U; ++k) xv[k] = vec_at<X>(xb, i + k * step);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      V a[VEC];
      c.decode(i + k * step, raw[k], a);
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        acc[u] = Op::combine(acc[u], Map::apply(mv_element<In>(xv[k], a[u])));
    }
  }
  for (; i < end; i += step) {
    V a[VEC];
    c.decode(i, c.raw(i), a);
    const X xv = vec_at<X>(xb, i);
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      acc[u] = Op::combine(acc[u], Map::apply(mv_element<In>(xv, a[u])));
  }
}

// ---------------------------------------------------------------------------
// Chunks: the last block of an output tile folds the tile's partials.
// ---------------------------------------------------------------------------

// After this block wrote its partials (every writer fenced), whether it drew
// the last of its tile's `chunks` tickets; every thread must call it.  The
// last block finds its counter at `chunks` and resets it to 0 for the next
// launch on this stream.
__device__ __forceinline__ bool last_of_tile(unsigned* counters,
                                             bool* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(counters + blockIdx.x, 1u);
    *flag = ticket == gridDim.y - 1;
    if (*flag) counters[blockIdx.x] = 0;
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// Fold the K chunks' partials (k, base + o), o < R <= THREADS, of an output
// tile into out[base + o], in chunk order, with the whole block: R2 (the
// power of two >= R) columns by THREADS / R2 groups, as COLUMNS folds rows,
// then the groups in order through `smem` (THREADS elements).
template <typename Op>
__device__ void fold_chunks(const typename Op::E* partials, long K, long m,
                            long base, int R, Leaves out,
                            typename Op::E* smem) {
  using E = typename Op::E;
  int R2 = 1;
  while (R2 < R) R2 <<= 1;
  const int groups = THREADS / R2;
  const int o = threadIdx.x & (R2 - 1);
  const int grp = threadIdx.x / R2;
  E v = Op::identity();
  if (o < R) {
    const E* col = partials + base + o;
    if constexpr (Op::COMMUTATIVE) {
#pragma unroll 4
      for (long k = grp; k < K; k += groups)
        v = Op::combine(v, load_cg(col + k * m));
    } else {
      const long len = cdiv(K, groups);
      const long k1 = (grp + 1) * len < K ? (grp + 1) * len : K;
#pragma unroll 4
      for (long k = grp * len; k < k1; ++k)
        v = Op::combine(v, load_cg(col + k * m));
    }
  }
  smem[threadIdx.x] = v;
  __syncthreads();
  if (grp == 0 && o < R) {
    for (int g = 1; g < groups; ++g) v = Op::combine(v, smem[g * R2 + o]);
    v.store(out, base + o);
  }
}

// fold_chunks over a tile of R outputs, THREADS at a time (a COLUMNS tile
// of 16-code loads holds up to 4,096 columns).
template <typename Op>
__device__ void fold_tile(const typename Op::E* partials, long K, long m,
                          long base, long R, Leaves out,
                          typename Op::E* smem) {
  for (long o = 0; o < R; o += THREADS) {
    if (o) __syncthreads();            // smem is read by the last piece
    fold_chunks<Op>(partials, K, m, base + o,
                    static_cast<int>(R - o < THREADS ? R - o : THREADS), out,
                    smem);
  }
}

// ---------------------------------------------------------------------------
// COLUMNS: K4 / K7 / K9 matvec
// ---------------------------------------------------------------------------

template <typename Map, typename Op, typename Mat>
__global__ void __launch_bounds__(THREADS)
matvec_columns(Mat M, const void* x, Geometry g, typename Op::E* partials,
               unsigned* counters, Leaves out) {
  using E = typename Op::E;
  using In = typename Map::In;
  using V = typename Mat::V;
  constexpr int VEC = Mat::VEC;
  static_assert(std::is_same<typename Leaf<In>::A, V>::value,
                "the map's matrix leaf is the operand's element type");
  // The row groups combine PV of a thread's VEC columns a pass.
  constexpr int PV = VEC < 4 ? VEC : 4;
  __shared__ E part[THREADS * PV];
  __shared__ bool last;
  const long n = M.n, p = M.p;
  const int tc = static_cast<int>(g.width);
  const long b = blockIdx.x / g.tiles;
  const long tile = blockIdx.x - b * g.tiles;
  const int col = threadIdx.x & (tc - 1);
  const int grp = threadIdx.x / tc;
  const int groups = THREADS / tc;
  const long j = (tile * tc + col) * VEC;  // the first of VEC columns
  const long r0 = static_cast<long>(blockIdx.y) * g.per_chunk;
  const long r1 = r0 + g.per_chunk < n ? r0 + g.per_chunk : n;
  E acc[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc[u] = Op::identity();
  if (j < p) {
    auto c = M.column(b, j);
    const void* xb = batch_vector<typename Leaf<In>::X>(x, b, n);
    if constexpr (Op::COMMUTATIVE && !Mat::QUANT) {
      fold_rows<Map, Op, VEC>(c, xb, r0 + grp, r1, groups, acc);
    } else {
      const long len = cdiv(r1 - r0, groups);
      const long g0 = r0 + grp * len;
      fold_rows<Map, Op, VEC>(c, xb, g0, g0 + len < r1 ? g0 + len : r1, 1,
                              acc);
    }
  }
  if (groups > 1) {  // combine the row groups in group order
#pragma unroll
    for (int u0 = 0; u0 < VEC; u0 += PV) {
      if (u0) __syncthreads();         // the last pass has read part
#pragma unroll
      for (int u = 0; u < PV; ++u) part[threadIdx.x * PV + u] = acc[u0 + u];
      __syncthreads();
      if (grp == 0 && j < p) {
#pragma unroll
        for (int u = 0; u < PV; ++u)
          for (int k = 1; k < groups; ++k)
            acc[u0 + u] =
                Op::combine(acc[u0 + u], part[(k * tc + col) * PV + u]);
      }
    }
  }
  const long m = g.B * p;
  if (g.chunks == 1) {
    if (grp == 0 && j < p) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[u].store(out, b * p + j + u);
    }
    return;
  }
  if (grp == 0 && j < p) {
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      partials[static_cast<long>(blockIdx.y) * m + b * p + j + u] = acc[u];
    __threadfence();  // publish the partials before the ticket
  }
  if (!last_of_tile(counters, &last)) return;
  const long first = tile * tc * VEC;
  fold_tile<Op>(partials, gridDim.y, m, b * p + first,
                p - first < tc * VEC ? p - first : tc * VEC, out, part);
}

// ---------------------------------------------------------------------------
// ROWS: K4 / K7 / K9 vecmat
// ---------------------------------------------------------------------------

template <typename Map, typename Op, typename Mat>
__global__ void __launch_bounds__(THREADS)
vecmat_rows(Mat M, const void* x, Geometry g, typename Op::E* partials,
            unsigned* counters, Leaves out) {
  using E = typename Op::E;
  using In = typename Map::In;
  using V = typename Mat::V;
  using X = typename Leaf<In>::X;
  constexpr int VEC = Mat::VEC;
  static_assert(std::is_same<typename In::T0, V>::value,
                "the map's matrix leaf is the operand's element type");
  __shared__ E part[THREADS];
  __shared__ bool last;
  const long n = M.n, p = M.p;
  const int lanes = static_cast<int>(g.width);
  const int rows = THREADS / lanes;        // rows per block
  const long b = blockIdx.x / g.tiles;
  const long tile = blockIdx.x - b * g.tiles;
  const int lane = threadIdx.x & (lanes - 1);
  const long i = tile * rows + threadIdx.x / lanes;
  const long c0 = static_cast<long>(blockIdx.y) * g.per_chunk;
  const long c1 = c0 + g.per_chunk < p ? c0 + g.per_chunk : p;
  E acc = Op::identity();
  if (i < n) {
    const auto r = M.row(b, i);
    const void* xb = batch_vector<X>(x, b, p);
    V a[VEC];
    // Chunk bounds and lane runs are whole multiples of VEC (p % VEC == 0).
    if constexpr (Op::COMMUTATIVE) {
#pragma unroll 8
      for (long c = c0 + lane * VEC; c < c1; c += lanes * VEC) {
        r.decode(r.raw(c), a);
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc = Op::combine(
              acc, Map::apply(vm_element<In>(a[u], vec_at<X>(xb, c + u))));
      }
    } else {
      const long len = cdiv(cdiv(c1 - c0, VEC), lanes) * VEC;
      const long l0 = c0 + lane * len;
      const long l1 = l0 + len < c1 ? l0 + len : c1;
      for (long c = l0; c < l1; c += VEC) {
        r.decode(r.raw(c), a);
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc = Op::combine(
              acc, Map::apply(vm_element<In>(a[u], vec_at<X>(xb, c + u))));
      }
    }
  }
  // Every lane of the warp takes part in the shuffles, in or out of range.
  const int width = lanes < 32 ? lanes : 32;
  if constexpr (Op::COMMUTATIVE) {
    for (int d = width / 2; d > 0; d >>= 1)
      acc = Op::combine(acc, E::shfl_down(acc, d, width));
  } else {
    // Lane l ends holding lanes l .. l + 2d - 1 in order (l a multiple of
    // 2d); lane 0 holds the warp's part of the row chunk.
    for (int d = 1; d < width; d <<= 1)
      acc = Op::combine(acc, E::shfl_down(acc, d, width));
  }
  if (lanes > 32) {  // a row spans lanes / 32 warps: their totals in order
    if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = acc;
    __syncthreads();
    if (lane == 0)
      for (int w = 1; w < lanes / 32; ++w)
        acc = Op::combine(acc, part[threadIdx.x / 32 + w]);
    __syncthreads();  // part is reused by the chunk fold
  }
  const long m = g.B * n;
  if (g.chunks == 1) {
    if (lane == 0 && i < n) acc.store(out, b * n + i);
    return;
  }
  if (lane == 0 && i < n) {
    partials[static_cast<long>(blockIdx.y) * m + b * n + i] = acc;
    __threadfence();
  }
  if (!last_of_tile(counters, &last)) return;
  const long first = tile * rows;
  fold_chunks<Op>(partials, gridDim.y, m, b * n + first,
                  static_cast<int>(n - first < rows ? n - first : rows), out,
                  part);
}

// ---------------------------------------------------------------------------
// STRIPS: K9 vecmat, a strip of one quantization block's rows a block
// ---------------------------------------------------------------------------

// A strip holds at most STRIP_MAX rows of one quantization block: the
// min(block, n) rows of a block fall into strips_per_block strips of
// `rows` (the last strip of a short final block may be empty).
__host__ __device__ inline long strips_per_block(long n, long block,
                                                 long rows) {
  return cdiv(block < n ? block : n, rows);
}

// The warp's fold of eight values a lane (eight rows), each over the 32
// lanes in lane order, by an ordered reduce-scatter: 9 shuffles, not 8 x 5.
// Lanes pair up at distance 1, 2, 4 -- the lower lane's values on the left
// -- and each step halves the rows a lane keeps; then distance 8 and 16
// fold whole rows.  Lane l ends holding row 4 (l & 1) + (l & 2) + (l >> 2
// & 1) (strip_row below).
template <typename Op>
__device__ __forceinline__ typename Op::E fold_eight(
    const typename Op::E (&v)[8], int lane) {
  using E = typename Op::E;
  const bool u1 = lane & 1, u2 = lane & 2, u4 = lane & 4;
  E a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const E r = E::shfl_xor(u1 ? v[j] : v[4 + j], 1);
    a[j] = u1 ? Op::combine(r, v[4 + j]) : Op::combine(v[j], r);
  }
  E c[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const E r = E::shfl_xor(u2 ? a[j] : a[2 + j], 2);
    c[j] = u2 ? Op::combine(r, a[2 + j]) : Op::combine(a[j], r);
  }
  const E r = E::shfl_xor(u4 ? c[0] : c[1], 4);
  E t = u4 ? Op::combine(r, c[1]) : Op::combine(c[0], r);
#pragma unroll
  for (int m = 8; m < 32; m <<= 1) {
    const E s = E::shfl_xor(t, m);
    t = (lane & m) ? Op::combine(s, t) : Op::combine(t, s);
  }
  return t;
}

// The row of the eight whose fold fold_eight leaves in lane `lane`.
__device__ __forceinline__ int strip_row(int lane) {
  return ((lane & 1) << 2) | (lane & 2) | ((lane >> 2) & 1);
}

template <typename Map, typename Op, typename Dec, int W>
__global__ void __launch_bounds__(THREADS)
vecmat_strips(Quantized<Dec, W> M, const void* x, Geometry g,
              typename Op::E* partials, unsigned* counters, Leaves out) {
  using E = typename Op::E;
  using In = typename Map::In;
  using X = typename Leaf<In>::X;
  using Load = Codes<Dec, W>;
  constexpr int U = 8;                            // rows in flight
  static_assert(std::is_same<typename In::T0, float>::value,
                "the map's matrix leaf is the dequantized float");
  __shared__ E acc[WARPS][STRIP_MAX];             // a warp's row totals
  __shared__ bool last;
  const long n = M.n, p = M.p, block = M.block;
  const long rows = g.width;                      // a strip's rows, at most
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long b = blockIdx.x / g.tiles;
  const long tile = blockIdx.x - b * g.tiles;
  const long spq = strips_per_block(n, block, rows);
  const long k = tile / spq;                      // the quantization block
  const long r0 = k * block + (tile - k * spq) * rows;
  const long kend = (k + 1) * block < n ? (k + 1) * block : n;
  const long r1 = r0 + rows < kend ? r0 + rows : kend;
  const long R = r1 > r0 ? r1 - r0 : 0;
  // The warp's contiguous run of the chunk, 32 W columns a step.
  const long c0 = static_cast<long>(blockIdx.y) * g.per_chunk;
  const long c1 = c0 + g.per_chunk < p ? c0 + g.per_chunk : p;
  const long len = cdiv(cdiv(c1 - c0, 32 * W), WARPS) * 32 * W;
  const long w0 = c0 + warp * len;
  const long w1 = w0 + len < c1 ? w0 + len : c1;
  for (long r = lane; r < R; r += 32) acc[warp][r] = Op::identity();
  __syncwarp();
  const typename Dec::Code* q = M.q + (b * n + r0) * p;
  const float* sc = M.s + (b * M.nb + k) * p;
  const void* xb = batch_vector<X>(x, b, p);
  for (long s = w0; s < w1; s += 32 * W) {
    const long c = s + lane * W;
    const bool on = c < w1;           // a lane past the run adds identity
    float scale[W];
    X xv[W];
    if (on) {
      Load::scales(sc + c, scale);
#pragma unroll
      for (int u = 0; u < W; ++u) xv[u] = vec_at<X>(xb, c + u);
    }
    // The strip's rows, U at a time: each lane folds its W columns of a
    // row in order, the warp its lanes in order (fold_eight), and lanes
    // 0 .. 7 add the rows' totals to the warp's.
    for (long r = 0; r < R; r += U) {
      typename Load::Raw raw[U];
#pragma unroll
      for (int v = 0; v < U; ++v)
        if (on && r + v < R) raw[v] = Load::load(q + (r + v) * p + c);
      E part[U];
#pragma unroll
      for (int v = 0; v < U; ++v) {
        part[v] = Op::identity();
        if (on && r + v < R) {
          float a[W];
          Load::dequantize(raw[v], scale, a);
#pragma unroll
          for (int u = 0; u < W; ++u)
            part[v] = Op::combine(part[v],
                                  Map::apply(vm_element<In>(a[u], xv[u])));
        }
      }
      const E row_total = fold_eight<Op>(part, lane);
      const long i = r + strip_row(lane);
      if (lane < U && i < R)
        acc[warp][i] = Op::combine(acc[warp][i], row_total);
    }
  }
  __syncthreads();
  // Thread t folds row t's warp totals in warp order.
  E total = Op::identity();
  if (threadIdx.x < R) {
    for (int w = 0; w < WARPS; ++w)
      total = Op::combine(total, acc[w][threadIdx.x]);
  }
  const long m = g.B * n;
  if (g.chunks == 1) {
    if (threadIdx.x < R) total.store(out, b * n + r0 + threadIdx.x);
    return;
  }
  if (threadIdx.x < R) {
    partials[static_cast<long>(blockIdx.y) * m + b * n + r0 + threadIdx.x] =
        total;
    __threadfence();
  }
  if (!last_of_tile(counters, &last)) return;
  fold_tile<Op>(partials, gridDim.y, m, b * n + r0, R, out, &acc[0][0]);
}

// ---------------------------------------------------------------------------
// PACKED: K5, the tall-narrow matvec over the flat stream (dense, B = 1,
// commutative)
// ---------------------------------------------------------------------------

template <typename Map, typename Op, typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
packed_stream(const T* a, const void* x, Geometry g, typename Op::E* partials,
              unsigned* counters, Leaves out) {
  using E = typename Op::E;
  using In = typename Map::In;
  using X = typename Leaf<In>::X;
  using Word = Pack<T, VEC>;
  __shared__ E sm[THREADS * VEC];
  __shared__ E fold[THREADS];
  __shared__ bool last;
  const long p = g.p;
  const long S = g.width * VEC;          // elements per step, a multiple of p
  const long total = g.n * p;
  const long e0 = static_cast<long>(blockIdx.y) * g.per_chunk;
  const long e1 = e0 + g.per_chunk < total ? e0 + g.per_chunk : total;
  const int t = threadIdx.x;
  E acc[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc[u] = Op::identity();
  if (t < g.width) {
    const long off = static_cast<long>(VEC) * t;
    const long drow = S / p;
    long row[VEC];                         // row of element e + u
#pragma unroll
    for (int u = 0; u < VEC; ++u) row[u] = e0 / p + (off + u) / p;
    long e = e0 + off;
    constexpr int U = 4;
    for (; e + (U - 1) * S + VEC <= e1; e += U * S) {
      Word w[U];
#pragma unroll
      for (int k = 0; k < U; ++k)
        w[k] = *reinterpret_cast<const Word*>(a + e + k * S);
#pragma unroll
      for (int k = 0; k < U; ++k) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          acc[u] = Op::combine(acc[u], Map::apply(mv_element<In>(
              vec_at<X>(x, row[u]), w[k].v[u])));
          row[u] += drow;
        }
      }
    }
    for (; e + VEC <= e1; e += S) {
      const Word w = *reinterpret_cast<const Word*>(a + e);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        acc[u] = Op::combine(acc[u], Map::apply(mv_element<In>(
            vec_at<X>(x, row[u]), w.v[u])));
        row[u] += drow;
      }
    }
    // The stream's last partial word: its elements one at a time.
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      if (e + u < e1)
        acc[u] = Op::combine(acc[u], Map::apply(mv_element<In>(
            vec_at<X>(x, row[u]), a[e + u])));
  }
  // Entry s of the step is column s % p.  Thread (column j, part q) folds
  // entries j + p (q + Q k), then thread j the Q parts.
#pragma unroll
  for (int u = 0; u < VEC; ++u) sm[VEC * t + u] = acc[u];
  __syncthreads();
  const int Q = THREADS / static_cast<int>(p);
  E v = Op::identity();
  if (t < Q * p) {
    for (long s = t; s < S; s += static_cast<long>(Q) * p)
      v = Op::combine(v, sm[s]);
  }
  fold[t] = v;
  __syncthreads();
  if (t < p) {
    for (int q = 1; q < Q; ++q) v = Op::combine(v, fold[q * p + t]);
    if (g.chunks == 1) {
      v.store(out, t);
    } else {
      partials[static_cast<long>(blockIdx.y) * p + t] = v;
      __threadfence();
    }
  }
  if (g.chunks == 1) return;
  if (!last_of_tile(counters, &last)) return;
  fold_chunks<Op>(partials, gridDim.y, p, 0, static_cast<int>(p), out, fold);
}

// ---------------------------------------------------------------------------
// TALL: vecmat over p <= 64 columns (dense): a block's rows through shared
// memory, each row folded by one thread in column order
// ---------------------------------------------------------------------------

template <typename Map, typename Op, typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
vecmat_tall(const T* a, const void* x, Geometry g, Leaves out) {
  using E = typename Op::E;
  using In = typename Map::In;
  using X = typename Leaf<In>::X;
  using Word = Pack<T, VEC>;
  __shared__ Word tile[TALL_BYTES / sizeof(Word)];
  T* el = reinterpret_cast<T*>(tile);
  const long p = g.p;
  const long R = g.width;                  // rows per block, a multiple of 4
  const long r0 = static_cast<long>(blockIdx.x) * R;
  const long rows_total = g.B * g.n;
  const long r1 = r0 + R < rows_total ? r0 + R : rows_total;
  const long count = (r1 - r0) * p;
  const T* src = a + r0 * p;               // 16-byte aligned when VEC = 4
  const long words = count / VEC;
  for (long k = threadIdx.x; k < words; k += THREADS)
    tile[k] = reinterpret_cast<const Word*>(src)[k];
  for (long k = words * VEC + threadIdx.x; k < count; k += THREADS)
    el[k] = src[k];
  __syncthreads();
  const long r = r0 + threadIdx.x;
  if (r < r1) {
    const long b = r / g.n;
    const void* xb = batch_vector<X>(x, b, p);
    const T* row = el + static_cast<long>(threadIdx.x) * p;
    E acc = Op::identity();
    for (long j = 0; j < p; ++j)
      acc = Op::combine(acc, Map::apply(vm_element<In>(row[j],
                                                       vec_at<X>(xb, j))));
    acc.store(out, r);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The planned grid, or an error for a geometry the kernels do not take.
inline cudaError_t grid_of(const Geometry& g, dim3* grid) {
  if (g.B <= 0 || g.n <= 0 || g.p <= 0 || g.tiles <= 0 || g.chunks <= 0 ||
      g.chunks > MAX_GRID_Y || g.tiles > MAX_GRID_X || g.per_chunk < 0 ||
      (g.vec != 1 && g.vec != 4 && g.vec != 16) || g.width <= 0 ||
      g.width > THREADS ||
      (g.kind != PACKED && g.kind != TALL && g.kind != STRIPS &&
       (g.width & (g.width - 1))) ||
      (g.kind != PACKED && g.kind != TALL && g.p % g.vec != 0))
    return cudaErrorInvalidValue;
  // TALL's tiles run over all B n rows; the other kinds have B x tiles.
  const long x = g.kind == TALL ? g.tiles : g.B * g.tiles;
  if (x > MAX_GRID_X) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(x), static_cast<unsigned>(g.chunks));
  return cudaSuccess;
}

template <typename Map, typename Op, typename Mat>
cudaError_t launch_mat(const Geometry& g, const Mat& M, const void* x,
                       void* counters, void* partials, Leaves out,
                       cudaStream_t stream) {
  using E = typename Op::E;
  dim3 grid;
  cudaError_t err = grid_of(g, &grid);
  if (err != cudaSuccess) return err;
  if ((Map::In::LEAVES == 2 && x == nullptr) ||
      (g.chunks > 1 && (counters == nullptr || partials == nullptr)))
    return cudaErrorInvalidValue;
  E* part = static_cast<E*>(partials);
  unsigned* count = static_cast<unsigned*>(counters);
  if (g.kind == COLUMNS) {
    if constexpr (Mat::EVICT) {
      return cudaErrorInvalidValue;    // evict-first loads are ROWS's alone
    } else {
      if (g.tiles != cdiv(cdiv(g.p, g.vec), g.width))
        return cudaErrorInvalidValue;
      matvec_columns<Map, Op, Mat><<<grid, THREADS, 0, stream>>>(
          M, x, g, part, count, out);
    }
  } else if constexpr (Mat::QUANT) {
    // STRIPS: strips of `width` rows in every quantization block, chunks
    // of whole warp steps.
    if (g.kind != STRIPS || g.width > STRIP_MAX ||
        g.tiles !=
            cdiv(g.n, M.block) * strips_per_block(g.n, M.block, g.width) ||
        g.per_chunk % (32 * g.vec) != 0)
      return cudaErrorInvalidValue;
    vecmat_strips<Map, Op, typename Mat::Decode, Mat::VEC>
        <<<grid, THREADS, 0, stream>>>(M, x, g, part, count, out);
  } else {
    if (g.kind != ROWS || g.tiles != cdiv(g.n, THREADS / g.width))
      return cudaErrorInvalidValue;
    vecmat_rows<Map, Op, Mat><<<grid, THREADS, 0, stream>>>(
        M, x, g, part, count, out);
  }
  return cudaGetLastError();
}

template <typename Map, typename Op, typename T, int VEC>
cudaError_t launch_stream(const Geometry& g, const T* a, const void* x,
                          void* counters, void* partials, Leaves out,
                          cudaStream_t stream) {
  using E = typename Op::E;
  dim3 grid;
  cudaError_t err = grid_of(g, &grid);
  if (err != cudaSuccess) return err;
  if (g.kind == TALL) {
    if (g.chunks != 1 || g.width % 4 != 0 ||
        g.width * g.p * static_cast<long>(sizeof(T)) > TALL_BYTES ||
        g.tiles != cdiv(g.B * g.n, g.width) || g.p > PACKED_MAX_COLS)
      return cudaErrorInvalidValue;
    vecmat_tall<Map, Op, T, VEC><<<grid, THREADS, 0, stream>>>(a, x, g, out);
    return cudaGetLastError();
  }
  if constexpr (!Op::COMMUTATIVE || Map::In::LEAVES != 2) {
    return cudaErrorInvalidValue;
  } else {
    const long S = g.width * VEC;
    if (g.B != 1 || g.tiles != 1 || g.p > PACKED_MAX_COLS || S % g.p != 0 ||
        g.per_chunk % S != 0 || x == nullptr ||
        (g.chunks > 1 && (counters == nullptr || partials == nullptr)))
      return cudaErrorInvalidValue;
    packed_stream<Map, Op, T, VEC><<<grid, THREADS, 0, stream>>>(
        a, x, g, static_cast<E*>(partials), static_cast<unsigned*>(counters),
        out);
    return cudaGetLastError();
  }
}

// A dense matrix of the map's leaf type (x and A share one dtype).  `in`
// holds In's leaves in the map's order: (x, A) for COLUMNS and PACKED,
// (A, x) for ROWS and TALL, (A) alone without a vector.  `geo` points at
// the ten longs of a Geometry; `counters` (one zero word per grid-x tile)
// and `partials` (chunks x outputs elements of Op::E) are the stream's
// workspace, read only when chunks > 1.
template <typename Map, typename Op>
cudaError_t run_dense(const Leaves& in, const Leaves& out, const void* geo,
                      void* counters, void* partials, cudaStream_t stream) {
  using In = typename Map::In;
  using T = typename Leaf<In>::A;
  using E = typename Op::E;
  static_assert(std::is_same<typename In::T0, T>::value,
                "x and A share one dtype");
  Geometry g;
  std::memcpy(&g, geo, sizeof g);
  if (g.vec != 1 && g.vec != 4) return cudaErrorInvalidValue;
  const bool matvec_order = g.kind == COLUMNS || g.kind == PACKED;
  const T* A = static_cast<const T*>(
      In::LEAVES == 2 && matvec_order ? in.p[1] : in.p[0]);
  const void* x = In::LEAVES == 2 ? in.p[matvec_order ? 0 : 1] : nullptr;
  if (g.vec == 4) {
    if constexpr (wide_ok<T, E>()) {
      if (reinterpret_cast<unsigned long>(A) % 16)
        return cudaErrorInvalidValue;
      if (g.kind == COLUMNS || g.kind == ROWS)
        return g.kind == ROWS && g.stream
            ? launch_mat<Map, Op>(g, Dense<T, 4, true>{A, g.n, g.p}, x,
                                  counters, partials, out, stream)
            : launch_mat<Map, Op>(g, Dense<T, 4>{A, g.n, g.p}, x, counters,
                                   partials, out, stream);
      return launch_stream<Map, Op, T, 4>(g, A, x, counters, partials, out,
                                          stream);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (g.kind == COLUMNS || g.kind == ROWS)
    return launch_mat<Map, Op>(g, Dense<T, 1>{A, g.n, g.p}, x, counters,
                               partials, out, stream);
  return launch_stream<Map, Op, T, 1>(g, A, x, counters, partials, out,
                                      stream);
}

// A quantized matrix: codes of Dec::Code, f32 scales, one per `block` rows;
// vec codes a load, as the host chose from the operands' alignment (16:
// codes and scales 16-byte aligned, p % 16 == 0; 4: codes 4-byte and
// scales 16-byte aligned, p % 4 == 0; else 1).  COLUMNS and STRIPS only.
template <typename Map, typename Op, typename Dec, int W>
cudaError_t launch_quantized(const Geometry& g, const void* q, const void* s,
                             long block, const void* x, void* counters,
                             void* partials, Leaves out, cudaStream_t stream) {
  using Code = typename Dec::Code;
  if (W > 1 && (reinterpret_cast<unsigned long>(q) % W ||
                reinterpret_cast<unsigned long>(s) % 16))
    return cudaErrorInvalidValue;
  const Quantized<Dec, W> M{static_cast<const Code*>(q),
                            static_cast<const float*>(s), g.n, g.p, block,
                            cdiv(g.n, block)};
  return launch_mat<Map, Op>(g, M, x, counters, partials, out, stream);
}

template <typename Map, typename Op, typename Dec>
cudaError_t run_quantized(const void* geo, const void* q, const void* s,
                          long block, const void* x, void* counters,
                          void* partials, Leaves out, cudaStream_t stream) {
  Geometry g;
  std::memcpy(&g, geo, sizeof g);
  if (block <= 0 || (g.kind != COLUMNS && g.kind != STRIPS))
    return cudaErrorInvalidValue;
  if (g.vec == 16)
    return launch_quantized<Map, Op, Dec, 16>(g, q, s, block, x, counters,
                                              partials, out, stream);
  if (g.vec == 4)
    return launch_quantized<Map, Op, Dec, 4>(g, q, s, block, x, counters,
                                             partials, out, stream);
  return launch_quantized<Map, Op, Dec, 1>(g, q, s, block, x, counters,
                                           partials, out, stream);
}

}  // namespace
}  // namespace matvec
}  // namespace rt
