// The mLSTM stabilizer's gradient: dlf and dli of the inclusive scan of
// (lf, li) under MAXPLUS_AFFINE along axis 1 of (B, T, H) float32 leaves,
// given the adjoints dA and dB of its two outputs, in the combine order of
// the reference's scan.
//
// Replaces: src/repro/kernels/scan.py::scan_channel_pallas (K6 here) in
// the backward pass of the reference's stabilizer,
// src/repro/models/recurrent.py::_mlstm_stabilizer.  The reference defines
// no backward kernel: jax.grad differentiates its forge.scan, which is
// lax.associative_scan on the XLA route, and splits the adjoint in halves
// at every tied max of that scan's tree.  A gradient taken along a serial
// walk over T splits it at each step instead, and the two part at a chain
// of three or more tied steps.  So this kernel walks the tree.  Plain version: kernels/scan.py::maxplus_grad_plain, the same
// levels as tensor code.
//
// The tree (lax.associative_scan's recursion): level 0 is (lf, li), n_0 =
// T; level l + 1 pairs level l's elements (0, 1), (2, 3), ... under the
// combine (a1 + a2, max(b1 + a2, b2)), n_{l+1} = n_l / 2, down to one
// element.  The scan of level l takes its odd positions from the scan of
// level l + 1 and its even ones 2 m >= 2 as combine(scan_{l+1}[m - 1],
// e_l[2 m]).  Every max sends its adjoint to the larger side, or half to
// each at a tie, as jax.grad's does.  One block per (b, h) column: the
// up-sweep of the levels, the scan's b values of levels 1 and up, then the
// adjoints up the levels (each scan adjoint less what its even combines
// take) and back down through the pair combines, each level a loop over its
// positions between __syncthreads.  The levels (five floats an element of
// 2 T at most) sit in shared memory up to about T = 5,000; past that in a
// workspace the wrapper allocates, so any T is taken.
//
// Bound on this card: bytes (lf, li, dA, dB read, dlf, dli written once),
// 0.029 us at xlstm-1.3b's train shape (1, 1,024, 4); a column's ~4 log2 T
// level steps, each a barrier, make it latency-bound: a few microseconds.
// It replaces a reverse K6 launch and some twenty tensor operations around
// it.
#pragma once

#include "common.cuh"

namespace rt {
namespace maxplus_grad {
namespace {

constexpr int THREADS = 512;
constexpr int MAX_LEVELS = 32;
// Shared memory for a column's levels (of the 227 KB a block may use).
constexpr long SMEM_MAX = 200 * 1024;

// The elements of every level of T.
inline long level_elements(long T) {
  long total = 0;
  for (long n = T;; n /= 2) {
    total += n;
    if (n < 2) return total;
  }
}

// The floats a column takes: its levels' lf and li sums, the scan's b
// values and the two adjoints.
inline long column_floats(long T) { return 5 * level_elements(T); }

// The workspace floats a column needs: 0 where it fits in shared memory.
inline long floats(long T) {
  const long n = column_floats(T);
  return 4 * n <= SMEM_MAX ? 0 : n;
}

// The share of a max's adjoint that goes to u, of max(u, v).
__device__ __forceinline__ float share(float u, float v) {
  return u > v ? 1.f : u == v ? 0.5f : 0.f;
}

__global__ void __launch_bounds__(THREADS)
tree_grad(const float* __restrict__ lf, const float* __restrict__ li,
          const float* __restrict__ dA, const float* __restrict__ dB,
          float* __restrict__ dlf, float* __restrict__ dli, float* ws,
          int T, int H, long per_col, int in_smem) {
  extern __shared__ float smem[];
  const int col = blockIdx.x, b = col / H, h = col % H, tid = threadIdx.x;
  float* base = in_smem ? smem : ws + static_cast<long>(col) * per_col;
  const long N = per_col / 5;
  float* LA = base;                      // the levels' a (lf sums)
  float* LB = base + N;                  // and b
  float* RB = base + 2 * N;              // the scan's b, levels 1 and up
  float* GA = base + 3 * N;              // adjoints of a
  float* GB = base + 4 * N;              // and of b
  int n[MAX_LEVELS];
  long off[MAX_LEVELS];
  int L = 0;
  n[0] = T;
  off[0] = 0;
  while (n[L] >= 2) {
    n[L + 1] = n[L] / 2;
    off[L + 1] = off[L] + n[L];
    ++L;
  }

  const long at0 = static_cast<long>(b) * T * H + h;
  for (int i = tid; i < T; i += THREADS) {
    const long at = at0 + static_cast<long>(i) * H;
    LA[i] = lf[at];
    LB[i] = li[at];
    GA[i] = dA[at];
    GB[i] = dB[at];
  }
  __syncthreads();
  // Up: the pairs of each level.
  for (int l = 0; l < L; ++l) {
    const float* a = LA + off[l];
    const float* c = LB + off[l];
    for (int m = tid; m < n[l + 1]; m += THREADS) {
      LA[off[l + 1] + m] = a[2 * m] + a[2 * m + 1];
      LB[off[l + 1] + m] = fmaxf(c[2 * m] + a[2 * m + 1], c[2 * m + 1]);
    }
    __syncthreads();
  }
  // Down: the scan's b of levels L .. 1 (level L's one element is its own
  // scan).
  if (tid == 0) RB[off[L]] = LB[off[L]];
  __syncthreads();
  for (int l = L - 1; l >= 1; --l) {
    const float* up = RB + off[l + 1];
    for (int i = tid; i < n[l]; i += THREADS) {
      const long j = off[l] + i;
      RB[j] = i & 1 ? up[i / 2]
            : i == 0 ? LB[j]
                     : fmaxf(up[i / 2 - 1] + LA[j], LB[j]);
    }
    __syncthreads();
  }
  // The adjoints up: level l + 1's scan adjoint is its odd positions' plus
  // what their even combines pass back; level l's even positions 2 m >= 2
  // keep their combine's share for their own element.
  for (int l = 0; l < L; ++l) {
    const long o = off[l], o1 = off[l + 1];
    const int nl = n[l];
    for (int m = tid; m < n[l + 1]; m += THREADS) {
      float ga = GA[o + 2 * m + 1], gb = GB[o + 2 * m + 1];
      if (2 * m + 2 < nl) {
        const long e = o + 2 * m + 2;
        const float s = share(RB[o1 + m] + LA[e], LB[e]);
        ga = ga + GA[e];
        gb = gb + s * GB[e];
      }
      GA[o1 + m] = ga;
      GB[o1 + m] = gb;
    }
    __syncthreads();
    for (int m = 1 + tid; 2 * m < nl; m += THREADS) {
      const long e = o + 2 * m;
      const float s = share(RB[o1 + m - 1] + LA[e], LB[e]);
      const float ga = GA[e], gb = GB[e];
      GA[e] = ga + s * gb;
      GB[e] = (1.f - s) * gb;
    }
  }
  __syncthreads();
  // The adjoints down through the pair combines.
  for (int l = L - 1; l >= 0; --l) {
    const long o = off[l], o1 = off[l + 1];
    for (int m = tid; m < n[l + 1]; m += THREADS) {
      const long e = o + 2 * m;
      const float ga = GA[o1 + m], gb = GB[o1 + m];
      const float s = share(LB[e] + LA[e + 1], LB[e + 1]);
      GA[e] = GA[e] + ga;
      GB[e] = GB[e] + s * gb;
      GA[e + 1] = ga + s * gb;
      GB[e + 1] = (1.f - s) * gb;
    }
    __syncthreads();
  }
  for (int i = tid; i < T; i += THREADS) {
    const long at = at0 + static_cast<long>(i) * H;
    dlf[at] = GA[i];
    dli[at] = GB[i];
  }
}

// lf, li, dA, dB, dlf, dli: (B, T, H) float32, contiguous; ws: B H
// floats(T) floats, or null where floats(T) is 0.
inline cudaError_t run(const void* lf, const void* li, const void* dA,
                       const void* dB, void* dlf, void* dli, void* ws,
                       long B, long T, long H, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || T > INT_MAX || H > INT_MAX ||
      B * H > INT_MAX)
    return cudaErrorInvalidValue;
  const long per = column_floats(T);
  const bool in_smem = floats(T) == 0;
  if (!in_smem && ws == nullptr) return cudaErrorInvalidValue;
  const size_t smem = in_smem ? 4 * per : 0;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_grad, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_MAX));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  tree_grad<<<static_cast<unsigned>(B * H), THREADS, smem, stream>>>(
      static_cast<const float*>(lf), static_cast<const float*>(li),
      static_cast<const float*>(dA), static_cast<const float*>(dB),
      static_cast<float*>(dlf), static_cast<float*>(dli),
      static_cast<float*>(ws), static_cast<int>(T), static_cast<int>(H), per,
      static_cast<int>(in_smem));
  return cudaGetLastError();
}

}  // namespace
}  // namespace maxplus_grad
}  // namespace rt
