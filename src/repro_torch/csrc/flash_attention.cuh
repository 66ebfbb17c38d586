// K10: fused attention with causal, sliding-window and soft-cap masks, for
// every GQA prefill of the models; float32 and bfloat16.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel), which keeps the online softmax's running (m, l, acc)
// in VMEM across a sequential kv-block grid axis so that no score tile
// reaches HBM.
//
// Semantics are the reference kernel's (plain version:
// kernels/ref.py::flash_attention_ref): s = (q . k in float32) * scale,
// then softcap * tanh(s / softcap); a key counts where kpos < T, causal
// qpos >= kpos and window qpos - kpos < window, positions from 0 for q and
// k alike; a dropped score is -1e30; p rounds to the element type before
// the float32 p . v product; out = acc / max(l, 1e-30).
//
// Bound on this card: operations.  At gemma2-27b's prefill (32 query heads,
// 16 kv heads, head_dim 128, T = 2,100) one layer is 36.1 GFLOP against
// 51.6 MB of q, k, v and out: 0.037 ms at the 989 TFLOP/s bf16 tensor peak.
// This first kernel does its products on the float32 cores (67 TFLOP/s), so
// it cannot come near that bound; tensor cores and TMA are later work.
//
// Design.  A block of 4 warps owns 32 query rows of one (batch, query
// head); each warp owns 8 rows and keeps their (m, l, acc) in registers
// (acc split over the lanes by head dimension).  The block walks kv tiles
// of 64 keys staged in shared memory (rows padded by 4 elements so that
// the lanes' row reads hit distinct banks); for the scores a lane takes
// keys lane and lane + 32 against all 8 rows (q broadcast from shared
// memory as float32), the row max and sum reduce across lanes by
// __shfl_xor_sync, and the rounded p go through shared memory to the p . v
// loop, where a lane owns head dimensions lane, lane + 32, ...  Query head
// h reads kv head h / (H / KH) through its own offsets: the GQA broadcast is
// never materialised.
//
// Tiles that are wholly masked for the block (above the causal diagonal,
// before the window) are skipped: exact, since once a row has met a kept
// key a dropped one has p = 0, and what a row gathered before its first
// kept key is scaled by alpha = 0.  A row that keeps no key at all (S > T +
// window - 1) gets the reference's answer: its block visits every tile,
// p = 1 throughout, and acc is divided by the reference's padded key count
// (`empty_l`).  Key rows at or past T are never read; they are zeros.
// Later query tiles (more keys under a causal mask) are scheduled first.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace rt {
namespace flash {
namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 8;                  // query rows per warp
constexpr int BQ = WARPS * ROWS;         // query rows per block
constexpr int BK = 64;                   // keys per shared-memory tile
constexpr int PAD = 4;                   // elements of padding per K/V row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive elements of a shared-memory row as float32 (8-byte
// aligned for bf16, 16-byte for float32).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

template <typename T, int HD>
struct Smem {
  static constexpr int KROW = HD + PAD;
  static constexpr size_t q = sizeof(float) * BQ * HD;
  static constexpr size_t kv = sizeof(T) * BK * KROW;
  static constexpr size_t p = sizeof(float) * BQ * BK;
  static constexpr size_t bytes = q + 2 * kv + p;
};

// q, out: (B, S, H, HD); k, v: (B, T, KH, HD); all contiguous.
template <typename T, int HD>
__global__ void __launch_bounds__(WARPS * 32)
attend(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ out, int S, int T_len, int H,
       int KH, int nqt, int causal, int window, float softcap, float scale,
       float empty_l) {
  using SM = Smem<T, HD>;
  constexpr int KROW = SM::KROW;
  constexpr int DI = (HD + 31) / 32;     // head dimensions per lane
  constexpr int CH = HD * sizeof(T) / 8; // 8-byte chunks per K/V row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* ks = reinterpret_cast<T*>(smem + SM::q);
  T* vs = reinterpret_cast<T*>(smem + SM::q + SM::kv);
  float* ps = reinterpret_cast<float*>(smem + SM::q + 2 * SM::kv);

  const int BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / BH);
  const int b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long qstride = static_cast<long>(H) * HD;
  const long kstride = static_cast<long>(KH) * HD;
  const T* qb = q + (static_cast<long>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<long>(b) * T_len * KH + kh) * HD;
  const T* vb = v + (static_cast<long>(b) * T_len * KH + kh) * HD;

  for (int e = threadIdx.x; e < BQ * HD; e += WARPS * 32) {
    const int r = e / HD, t = q0 + r;
    qs[e] = t < S ? to_f(qb[t * qstride + e % HD]) : 0.f;
  }

  // The block's kv range: every key a row of it keeps, or all keys when
  // one of its rows keeps none.
  const int qlast = min(q0 + BQ, S) - 1;
  int k_begin = 0, k_end = T_len;
  const bool empty_row = window > 0 &&
      static_cast<long>(qlast) >= static_cast<long>(T_len) + window - 1;
  if (!empty_row) {
    if (causal) k_end = min(T_len, qlast + 1);
    if (window) k_begin = max(0, q0 - window + 1) / BK * BK;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DI];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DI; ++i) acc[r][i] = 0.f;
  }
  const float* qw = qs + warp * ROWS * HD;
  float* pw = ps + warp * ROWS * BK;
  const int qrow0 = q0 + warp * ROWS;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                     // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * CH; e += WARPS * 32) {
      const int r = e / CH, c = e % CH, t = k0 + r;
      uint2 kk = make_uint2(0u, 0u), vv = make_uint2(0u, 0u);
      if (t < T_len) {
        kk = reinterpret_cast<const uint2*>(kb + t * kstride)[c];
        vv = reinterpret_cast<const uint2*>(vb + t * kstride)[c];
      }
      reinterpret_cast<uint2*>(ks + r * KROW)[c] = kk;
      reinterpret_cast<uint2*>(vs + r * KROW)[c] = vv;
    }
    __syncthreads();

    // Scores of keys k0 + lane and k0 + 32 + lane against the warp's rows.
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const T* k0r = ks + lane * KROW;
    const T* k1r = ks + (lane + 32) * KROW;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 a = load4(k0r + d), c = load4(k1r + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = load4(qw + r * HD + d);
        s[r][0] = fmaf(x.x, a.x, s[r][0]);
        s[r][0] = fmaf(x.y, a.y, s[r][0]);
        s[r][0] = fmaf(x.z, a.z, s[r][0]);
        s[r][0] = fmaf(x.w, a.w, s[r][0]);
        s[r][1] = fmaf(x.x, c.x, s[r][1]);
        s[r][1] = fmaf(x.y, c.y, s[r][1]);
        s[r][1] = fmaf(x.z, c.z, s[r][1]);
        s[r][1] = fmaf(x.w, c.w, s[r][1]);
      }
    }

    // Online softmax per row; rounded p to shared memory.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qp = qrow0 + r;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        float sc = s[r][j] * scale;
        if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
        bool keep = kp < T_len && qp < S;
        if (causal) keep = keep && qp >= kp;
        if (window) keep = keep && qp - kp < window;
        x[j] = keep ? sc : NEG_INF;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      pw[r * BK + lane] = to_f(from_f<T>(p0));
      pw[r * BK + lane + 32] = to_f(from_f<T>(p1));
#pragma unroll
      for (int i = 0; i < DI; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // acc += p . v over the tile's keys.
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pr[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pr[r] = load4(pw + r * BK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* vrow = vs + (j + jj) * KROW;
#pragma unroll
        for (int i = 0; i < DI; ++i) {
          const int d = lane + 32 * i;
          if (HD % 32 != 0 && d >= HD) continue;
          const float vd = to_f(vrow[d]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y
                           : jj == 2 ? pr[r].z : pr[r].w;
            acc[r][i] = fmaf(pj, vd, acc[r][i]);
          }
        }
      }
    }
  }

  T* ob = out + (static_cast<long>(b) * S * H + h) * HD;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qp = qrow0 + r;
    if (qp >= S) continue;
    const float lr = m[r] == NEG_INF ? empty_l : fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d = lane + 32 * i;
      if (HD % 32 != 0 && d >= HD) continue;
      ob[qp * qstride + d] = from_f<T>(acc[r][i] / lr);
    }
  }
}

template <typename T, int HD>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                long B, long S, long T_len, long H, long KH, int causal,
                long window, float softcap, float scale, float empty_l,
                cudaStream_t stream) {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256, "head_dim");
  if (B < 1 || S < 1 || T_len < 1 || KH < 1 || H % KH != 0 ||
      S > INT_MAX || T_len > INT_MAX || window < 0 || window > INT_MAX)
    return cudaErrorInvalidValue;
  const long nqt = (S + BQ - 1) / BQ;
  const long blocks = nqt * B * H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<T, HD>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attend<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  attend<T, HD><<<static_cast<unsigned>(blocks), WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<int>(S),
      static_cast<int>(T_len), static_cast<int>(H), static_cast<int>(KH),
      static_cast<int>(nqt), causal, static_cast<int>(window), softcap, scale,
      empty_l);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash
}  // namespace rt
