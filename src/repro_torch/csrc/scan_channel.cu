// K6: scan along T of (B, T, C) leaves, independent per (b, c) channel.
//
// Replaces: src/repro/kernels/scan.py::scan_channel_pallas (body _chan_kernel),
// which puts channels on the TPU's 128 lanes and walks T blocks on the
// sequential grid axis with a carry in VMEM.  On the serving path it carries
// the RG-LRU recurrence h_t = a_t h_{t-1} + b_t (AFFINE over an f32 (a, b)
// pair) through linear_recurrence@batched.
//
// Bound on this card: memory.  Every element is read once and written once:
// for AFFINE (2 leaves read + 2 written) x 4 bytes x B T C.  The design keeps
// that traffic and nothing else: one thread owns one (b, c) channel and walks
// T serially with the carry in registers, so no carry ever touches memory and
// no cross-thread combine is needed (the GPU counterpart of "channels ride
// the lanes").  Neighbouring threads take neighbouring c, so each step's
// loads and stores coalesce into whole 128-byte lines.  The cost is
// parallelism: B x C threads (2,560 at B = 1) cannot fill 132 SMs, and each
// thread waits out T dependent load latencies.
//
// The long-T path, for few channels and long T (the radix sort's rank scan:
// (1, n, 2^d) int32 ADD, exclusive, with n = B V = 1,024,000 and 256 or 4
// channels), spreads T over blocks in three phases:
//   1. each thread owns one (b, chunk, c) and folds the chunk's CHUNK steps
//      in walk order into agg[b, c, chunk];
//   2. the exclusive scan of agg along the chunk axis, one row per (b, c)
//      (tile_scan.cuh's carry phase);
//   3. each thread walks its chunk again with its carry on the left.
// Threads with neighbouring c take neighbouring addresses at every step, as
// on the serial route.  Every combine keeps element order, so integer ADD is
// bit-exact; float operators (AFFINE) reassociate at chunk boundaries, which
// is why the RG-LRU's shapes stay on the serial route (kernels/scan.py picks
// the route).  Traffic: the input is read twice and the output written once,
// 3 element bytes where 2 are the bound, plus the aggregates (1/CHUNK).
#include "tile_scan.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 64;

template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
scan_channels(const void* x0, const void* x1, void* y0, void* y1, long T_len,
              long C, bool inclusive, bool reverse) {
  const long c = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= C) return;
  const long row = static_cast<long>(blockIdx.y) * T_len * C + c;
  T acc = Op::identity();
  for (long k = 0; k < T_len; ++k) {
    const long t = reverse ? T_len - 1 - k : k;
    const long i = row + t * C;
    const T x = rt::Io<T>::load(x0, x1, i);
    if (inclusive) {
      acc = Op::combine(acc, x);
      rt::Io<T>::store(y0, y1, i, acc);
    } else {
      rt::Io<T>::store(y0, y1, i, acc);
      acc = Op::combine(acc, x);
    }
  }
}

// Long-T phase 1: the fold of chunk k of channel (b, c), in walk order.
// Thread index over (chunk, c) within row b = blockIdx.y, c fastest.
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
chunk_aggregates(const void* x0, const void* x1, long T_len, long C,
                 long nchunks, bool reverse, T* agg) {
  const long idx = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= nchunks * C) return;
  const long k = idx / C, c = idx - k * C;
  const long b = blockIdx.y;
  const long row = b * T_len * C + c;
  const long s1 = (k + 1) * CHUNK < T_len ? (k + 1) * CHUNK : T_len;
  T acc = Op::identity();
#pragma unroll 8
  for (long s = k * CHUNK; s < s1; ++s) {
    const long t = reverse ? T_len - 1 - s : s;
    acc = Op::combine(acc, rt::Io<T>::load(x0, x1, row + t * C));
  }
  agg[(b * C + c) * nchunks + k] = acc;
}

// Long-T phase 3: walk chunk k again from its carry (the exclusive prefix of
// the chunks before it, left in agg by phase 2).
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
chunk_rescan(const void* x0, const void* x1, void* y0, void* y1, long T_len,
             long C, long nchunks, bool inclusive, bool reverse,
             const T* agg) {
  const long idx = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= nchunks * C) return;
  const long k = idx / C, c = idx - k * C;
  const long b = blockIdx.y;
  const long row = b * T_len * C + c;
  const long s1 = (k + 1) * CHUNK < T_len ? (k + 1) * CHUNK : T_len;
  T acc = agg[(b * C + c) * nchunks + k];
#pragma unroll 8
  for (long s = k * CHUNK; s < s1; ++s) {
    const long i = row + (reverse ? T_len - 1 - s : s) * C;
    const T x = rt::Io<T>::load(x0, x1, i);
    if (inclusive) {
      acc = Op::combine(acc, x);
      rt::Io<T>::store(y0, y1, i, acc);
    } else {
      rt::Io<T>::store(y0, y1, i, acc);
      acc = Op::combine(acc, x);
    }
  }
}

template <typename T, typename Op>
cudaError_t launch(const void* x0, const void* x1, void* y0, void* y1, long B,
                   long T_len, long C, bool inclusive, bool reverse,
                   void* scratch, cudaStream_t stream) {
  if (scratch == nullptr) {
    const dim3 grid(static_cast<unsigned>((C + THREADS - 1) / THREADS),
                    static_cast<unsigned>(B));
    scan_channels<T, Op><<<grid, THREADS, 0, stream>>>(
        x0, x1, y0, y1, T_len, C, inclusive, reverse);
    return cudaGetLastError();
  }
  const long nchunks = (T_len + CHUNK - 1) / CHUNK;
  T* agg = static_cast<T*>(scratch);
  const dim3 grid(static_cast<unsigned>((nchunks * C + THREADS - 1) / THREADS),
                  static_cast<unsigned>(B));
  chunk_aggregates<T, Op><<<grid, THREADS, 0, stream>>>(
      x0, x1, T_len, C, nchunks, reverse, agg);
  rt::tile::scan_totals<T, Op>
      <<<dim3(1, static_cast<unsigned>(B * C)), rt::tile::THREADS, 0,
          stream>>>(agg, nchunks);
  chunk_rescan<T, Op><<<grid, THREADS, 0, stream>>>(
      x0, x1, y0, y1, T_len, C, nchunks, inclusive, reverse, agg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Steps per chunk of the long-T path: the caller sizes `scratch` to
// B * C * cdiv(T, CHUNK) elements (8 bytes each for AFFINE, 4 otherwise).
int rt_scan_channel_chunk() { return CHUNK; }

// Returns a cudaError_t code: 0 on a clean launch.  A null `scratch` takes
// the serial route (one thread per channel), a non-null one the long-T path.
int rt_scan_channel(int op, int dtype, const void* x0, const void* x1,
                    void* y0, void* y1, long B, long T_len, long C,
                    int inclusive, int reverse, void* scratch, void* stream) {
  if (B <= 0 || T_len <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  if (scratch != nullptr && B * C > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_ALL(op, dtype,
                  return launch<T, OP>(x0, x1, y0, y1, B, T_len, C,
                                       inclusive != 0, reverse != 0, scratch,
                                       st));
  return cudaErrorInvalidValue;
}

}  // extern "C"
