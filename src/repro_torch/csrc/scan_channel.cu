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
// thread waits out T dependent load latencies.  Chunking T across blocks
// with a carry exchange is the later performance step.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

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

template <typename T, typename Op>
cudaError_t launch(const void* x0, const void* x1, void* y0, void* y1, long B,
                   long T_len, long C, bool inclusive, bool reverse,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((C + THREADS - 1) / THREADS),
                  static_cast<unsigned>(B));
  scan_channels<T, Op><<<grid, THREADS, 0, stream>>>(x0, x1, y0, y1, T_len, C,
                                                     inclusive, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a clean launch.
int rt_scan_channel(int op, int dtype, const void* x0, const void* x1,
                    void* y0, void* y1, long B, long T_len, long C,
                    int inclusive, int reverse, void* stream) {
  if (B <= 0 || T_len <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_ALL(op, dtype,
                  return launch<T, OP>(x0, x1, y0, y1, B, T_len, C,
                                       inclusive != 0, reverse != 0, st));
  return cudaErrorInvalidValue;
}

}  // extern "C"
