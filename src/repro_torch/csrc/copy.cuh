// K1: y = x over a flat buffer of any dtype (copied as bytes).
//
// Replaces: src/repro/kernels/copy.py::copy_pallas (body _copy_kernel), which
// moves `nitem` (sublane, 128) tiles HBM -> VMEM -> HBM per grid step: the
// practical bandwidth ceiling of the paper's Fig. 1.
//
// Bound on this card: memory, one read and one write of every byte: at
// n = 10^8 f32, 800 MB, 0.239 ms at 3.35 TB/s.  Design: 16-byte vector loads
// and stores; each thread moves NITEM vectors (the reference's knob,
// `nitem`), all loads issued before the first store so NITEM loads are in
// flight per thread; neighbouring threads take neighbouring vectors, so a
// warp's every access is whole 128-byte lines.  The ragged end (under 16
// bytes) is copied byte by byte by the last block; misaligned pointers take
// a byte-wise grid-stride loop.
#pragma once

#include "common.cuh"

namespace rt {
namespace copy {
namespace {

constexpr int THREADS = 256;

template <int NITEM>
__global__ void __launch_bounds__(THREADS)
copy_vectors(const uint4* x, uint4* y, long nvec, const unsigned char* xt,
             unsigned char* yt, int tail) {
  const long base = static_cast<long>(blockIdx.x) * THREADS * NITEM + threadIdx.x;
  uint4 r[NITEM];
#pragma unroll
  for (int k = 0; k < NITEM; ++k) {
    const long i = base + static_cast<long>(k) * THREADS;
    if (i < nvec) r[k] = x[i];
  }
#pragma unroll
  for (int k = 0; k < NITEM; ++k) {
    const long i = base + static_cast<long>(k) * THREADS;
    if (i < nvec) y[i] = r[k];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail)
    yt[threadIdx.x] = xt[threadIdx.x];
}

__global__ void __launch_bounds__(THREADS)
copy_bytes(const unsigned char* x, unsigned char* y, long n) {
  const long stride = static_cast<long>(gridDim.x) * THREADS;
  for (long i = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += stride)
    y[i] = x[i];
}

template <int NITEM>
cudaError_t launch_vectors(const void* x, void* y, long nbytes,
                           cudaStream_t stream) {
  const long nvec = nbytes / 16;
  const int tail = static_cast<int>(nbytes - nvec * 16);
  const long per_block = static_cast<long>(THREADS) * NITEM;
  const long blocks = nvec > 0 ? (nvec + per_block - 1) / per_block : 1;
  const unsigned char* xb = static_cast<const unsigned char*>(x);
  unsigned char* yb = static_cast<unsigned char*>(y);
  copy_vectors<NITEM><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), nvec,
      xb + nvec * 16, yb + nvec * 16, tail);
  return cudaGetLastError();
}

// nitem in {1, 2, 4, 8, 16}.
cudaError_t run(const void* x, void* y, long nbytes, int nitem,
                cudaStream_t stream) {
  if (nbytes <= 0) return cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (!aligned) {
    const long want = (nbytes + THREADS - 1) / THREADS;
    const long blocks = want < 4 * 132 ? want : 4 * 132;
    copy_bytes<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y),
        nbytes);
    return cudaGetLastError();
  }
  switch (nitem) {
    case 1: return launch_vectors<1>(x, y, nbytes, stream);
    case 2: return launch_vectors<2>(x, y, nbytes, stream);
    case 4: return launch_vectors<4>(x, y, nbytes, stream);
    case 8: return launch_vectors<8>(x, y, nbytes, stream);
    case 16: return launch_vectors<16>(x, y, nbytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace copy
}  // namespace rt
