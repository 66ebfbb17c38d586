// K10's gradient: dQ, dK and dV of the fused attention of
// flash_attention.cuh from q, k, v, out, dout and the forward's log-sum-exp
// of each row (lse), for every form the forward takes: causal or not, a
// sliding window, a soft cap, S != T, GQA (H query heads over KH kv heads),
// a value head dim DV of its own (DV <= HD), rows that keep no key.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas in
// the backward pass.  The reference defines no backward for that kernel:
// its models train attention through the XLA autodiff of
// blockwise_attention (src/repro/models/attention.py).  On the card the
// forward is K10, so its gradient is a kernel too.  Plain version:
// kernels/ref.py::flash_attention_bwd_ref.
//
// With P = exp(s - lse) (s the scaled, soft-capped score of a kept key, P =
// 0 for a dropped one) and D = rowsum(dout . out):
//   dV = P^T dout, P rounded to the element type first (as the forward
//        rounds p before its p . v product);
//   dP = dout V^T;  dS = P (dP - D), times 1 - (s / softcap)^2 under a cap
//        (the chain through tanh);
//   dQ = scale dS K;  dK = scale dS^T Q.
// A row that keeps no key (S > T + window - 1) averaged v over the forward's
// padded key count, empty_l: its P is 1 / empty_l at every key, its dS 0.
//
// Two launches, no atomics, so a gradient repeats bit for bit: `dq` over
// query tiles (it also writes D, which `dkv` reads), then `dkv` over key
// tiles, each block summing the G query heads of its kv head in registers
// (the GQA broadcast is never materialised).  Everything is float32 on the
// CUDA cores: tiles of 64 query rows and 32 keys in shared memory (rows
// padded by one float against bank conflicts), 256 threads, each owning a
// 4 x 2 piece of the score tile and a strip of its block's accumulator.
//
// Bound on this card: operations.  At recurrentgemma-2b's layer (B = 1, S =
// T = 4,096, 10 query heads over 1 kv head of 256, window 2,048) 62.9 M kept
// pairs take 2,560 flop each (q . k, dout . v, dS K, dS^T q and P^T dout,
// 2 x 256 each, and the elementwise work): 161 GFLOP, 0.163 ms at the
// 989 TFLOP/s bf16 tensor peak, against 0.027 ms for its 92 MB.  This first
// form runs on the CUDA cores (67 TFLOP/s float32 at most) and is far from
// that bound; wgmma on a TMA ring is a later redesign.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace rt {
namespace flash_bwd {
namespace {

constexpr int THREADS = 256;
constexpr int RQ = 64;                   // query rows per tile
constexpr int RK = 32;                   // keys per tile
constexpr int IQ = RQ / 16, JK = RK / 16;

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E> __device__ __forceinline__ E elem(float x);
template <> __device__ __forceinline__ float elem<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 elem<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

template <int HD, int DV>
struct Smem {
  static constexpr int KP = HD + 1, VP = DV + 1, PP = RK + 1;
  static constexpr size_t q = sizeof(float) * RQ * KP;
  static constexpr size_t dout = sizeof(float) * RQ * VP;
  static constexpr size_t k = sizeof(float) * RK * KP;
  static constexpr size_t v = sizeof(float) * RK * VP;
  static constexpr size_t p = sizeof(float) * RQ * PP;
  static constexpr size_t rows = sizeof(float) * 2 * RQ;   // lse, D
  static constexpr size_t bytes = q + dout + k + v + p + rows;
  static_assert(bytes <= 232448, "the tiles fit a block's shared memory");
};

// Which keys a query row keeps, and the score's terms.
struct Mask {
  int S, T, causal, window;
  float softcap, scale, inv_empty;

  __device__ bool keep(int row, int col) const {
    bool k = row < S && col < T;
    if (causal) k = k && row >= col;
    if (window) k = k && row - col < window;
    return k;
  }
  __device__ bool empty(int row) const {
    return window > 0 && row < S &&
           static_cast<long>(row) >= static_cast<long>(T) + window - 1;
  }
  // The capped, scaled score of the raw product x.
  __device__ float score(float x) const {
    const float s = x * scale;
    return softcap != 0.f ? softcap * tanhf(s / softcap) : s;
  }
  // dS of a kept pair from its score, P, dP and the row's D.
  __device__ float ds(float sc, float p, float dp, float d) const {
    float g = p * (dp - d);
    if (softcap != 0.f) {
      const float t = sc / softcap;
      g *= 1.f - t * t;
    }
    return g;
  }
};

// rows x W elements of a (B, len, heads, W) array into shared memory as
// float32, rows [r0, r0 + rows) of head `head`; rows at or past `lim` are
// zeros.
template <int W, int ROWS, typename E>
__device__ __forceinline__ void stage(float* dst, const E* src, long b,
                                      int len, int heads, int head, int r0,
                                      int lim) {
  for (int e = threadIdx.x; e < ROWS * W; e += THREADS) {
    const int r = e / W, c = e % W, row = r0 + r;
    dst[r * (W + 1) + c] =
        row < lim
            ? f32(src[((b * len + row) * heads + head) * static_cast<long>(W)
                      + c])
            : 0.f;
  }
}

// dQ over query tiles; writes D = rowsum(dout . out) for dkv.  One block per
// (query tile, batch, query head).
template <typename E, int HD, int DV>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
          const E* __restrict__ v, const E* __restrict__ out,
          const E* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ Dg, E* __restrict__ dq, int S, int T, int H,
          int KH, int nqt, Mask mk) {
  using SM = Smem<HD, DV>;
  constexpr int KP = SM::KP, VP = SM::VP, PP = SM::PP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + SM::q);
  float* ks = reinterpret_cast<float*>(smem + SM::q + SM::dout);
  float* vs = reinterpret_cast<float*>(smem + SM::q + SM::dout + SM::k);
  float* ps = reinterpret_cast<float*>(smem + SM::q + SM::dout + SM::k +
                                       SM::v);
  float* lse_s = ps + RQ * PP;
  float* d_s = lse_s + RQ;

  const int BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH, qt = blockIdx.x / BH;
  const int b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = qt * RQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  stage<HD, RQ>(qs, q, b, S, H, h, q0, S);
  stage<DV, RQ>(dos, dout, b, S, H, h, q0, S);
  // D of each row, a warp a row.
  for (int r = warp; r < RQ; r += THREADS / 32) {
    const int row = q0 + r;
    float d = 0.f;
    if (row < S) {
      const long base = ((static_cast<long>(b) * S + row) * H + h) * DV;
      for (int c = lane; c < DV; c += 32)
        d += f32(dout[base + c]) * f32(out[base + c]);
    }
    d = warp_sum(d);
    if (lane == 0) {
      d_s[r] = d;
      lse_s[r] = row < S ? lse[(static_cast<long>(b) * S + row) * H + h] : 0.f;
      if (row < S) Dg[(static_cast<long>(b) * S + row) * H + h] = d;
    }
  }

  const int qlast = min(q0 + RQ, S) - 1;
  const int kb = mk.window ? max(0, q0 - mk.window + 1) : 0;
  const int ke = mk.causal ? min(T, qlast + 1) : T;
  float acc[IQ][HD / 16];
#pragma unroll
  for (int i = 0; i < IQ; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += RK) {
    __syncthreads();                     // the previous tile is consumed
    stage<HD, RK>(ks, k, b, T, KH, kh, k0, T);
    stage<DV, RK>(vs, v, b, T, KH, kh, k0, T);
    __syncthreads();
    float s[IQ][JK], dp[IQ][JK];
#pragma unroll
    for (int i = 0; i < IQ; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float a[IQ], c[JK];
#pragma unroll
      for (int i = 0; i < IQ; ++i) a[i] = qs[(ty + 16 * i) * KP + d];
#pragma unroll
      for (int j = 0; j < JK; ++j) c[j] = ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < IQ; ++i)
#pragma unroll
        for (int j = 0; j < JK; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
    for (int e = 0; e < DV; ++e) {
      float a[IQ], c[JK];
#pragma unroll
      for (int i = 0; i < IQ; ++i) a[i] = dos[(ty + 16 * i) * VP + e];
#pragma unroll
      for (int j = 0; j < JK; ++j) c[j] = vs[(tx + 16 * j) * VP + e];
#pragma unroll
      for (int i = 0; i < IQ; ++i)
#pragma unroll
        for (int j = 0; j < JK; ++j) dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < IQ; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        float g = 0.f;
        if (mk.keep(row, col)) {
          const float sc = mk.score(s[i][j]);
          g = mk.ds(sc, expf(sc - lse_s[r]), dp[i][j], d_s[r]);
        }
        ps[r * PP + c] = g;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < RK; ++kk) {
      float g[IQ];
#pragma unroll
      for (int i = 0; i < IQ; ++i) g[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const float kv = ks[kk * KP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < IQ; ++i) acc[i][j] = fmaf(g[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < IQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    E* dst = dq + ((static_cast<long>(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      dst[tx + 16 * j] = elem<E>(acc[i][j] * mk.scale);
  }
}

// dK and dV over key tiles: one block per (key tile, batch, kv head), over
// every query row of its G query heads that keeps one of its keys, and the
// rows that keep none.
template <typename E, int HD, int DV>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
           const E* __restrict__ v, const E* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ Dg,
           E* __restrict__ dk, E* __restrict__ dv, int S, int T, int H,
           int KH, int nkt, Mask mk) {
  using SM = Smem<HD, DV>;
  constexpr int KP = SM::KP, VP = SM::VP, PP = SM::PP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + SM::q);
  float* ks = reinterpret_cast<float*>(smem + SM::q + SM::dout);
  float* vs = reinterpret_cast<float*>(smem + SM::q + SM::dout + SM::k);
  float* ps = reinterpret_cast<float*>(smem + SM::q + SM::dout + SM::k +
                                       SM::v);
  float* lse_s = ps + RQ * PP;
  float* d_s = lse_s + RQ;

  const int BK = gridDim.x / nkt;
  const int bk = blockIdx.x % BK, kt = blockIdx.x / BK;
  const int b = bk / KH, kh = bk % KH, G = H / KH;
  const int k0 = kt * RK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage<HD, RK>(ks, k, b, T, KH, kh, k0, T);
  stage<DV, RK>(vs, v, b, T, KH, kh, k0, T);

  // Rows [qb, qe) may keep a key of the tile; rows from `eb` keep none.
  const int klast = min(k0 + RK, T) - 1;
  const long eb_long = mk.window ? static_cast<long>(T) + mk.window - 1 : S;
  const int eb = static_cast<int>(min(eb_long, static_cast<long>(S)));
  const int qb = mk.causal ? k0 : 0;
  const int qe = min(mk.window ? static_cast<int>(min(
                         static_cast<long>(klast) + mk.window,
                         static_cast<long>(S)))
                               : S,
                     eb);

  float ak[JK][HD / 16], av[JK][DV / 16];
#pragma unroll
  for (int i = 0; i < JK; ++i) {
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) ak[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 16; ++j) av[i][j] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int range = 0; range < 2; ++range) {
      const int r_begin = range == 0 ? qb : eb;
      const int r_end = range == 0 ? qe : S;
      for (int q0 = r_begin; q0 < r_end; q0 += RQ) {
        __syncthreads();                 // the previous tile is consumed
        stage<HD, RQ>(qs, q, b, S, H, h, q0, r_end);
        stage<DV, RQ>(dos, dout, b, S, H, h, q0, r_end);
        for (int r = threadIdx.x; r < RQ; r += THREADS) {
          const int row = q0 + r;
          const long at = (static_cast<long>(b) * S + row) * H + h;
          lse_s[r] = row < r_end ? lse[at] : 0.f;
          d_s[r] = row < r_end ? Dg[at] : 0.f;
        }
        __syncthreads();
        float s[IQ][JK], dp[IQ][JK];
#pragma unroll
        for (int i = 0; i < IQ; ++i)
#pragma unroll
          for (int j = 0; j < JK; ++j) s[i][j] = dp[i][j] = 0.f;
        if (range == 0) {
          for (int d = 0; d < HD; ++d) {
            float a[IQ], c[JK];
#pragma unroll
            for (int i = 0; i < IQ; ++i) a[i] = qs[(ty + 16 * i) * KP + d];
#pragma unroll
            for (int j = 0; j < JK; ++j) c[j] = ks[(tx + 16 * j) * KP + d];
#pragma unroll
            for (int i = 0; i < IQ; ++i)
#pragma unroll
              for (int j = 0; j < JK; ++j)
                s[i][j] = fmaf(a[i], c[j], s[i][j]);
          }
          for (int e = 0; e < DV; ++e) {
            float a[IQ], c[JK];
#pragma unroll
            for (int i = 0; i < IQ; ++i) a[i] = dos[(ty + 16 * i) * VP + e];
#pragma unroll
            for (int j = 0; j < JK; ++j) c[j] = vs[(tx + 16 * j) * VP + e];
#pragma unroll
            for (int i = 0; i < IQ; ++i)
#pragma unroll
              for (int j = 0; j < JK; ++j)
                dp[i][j] = fmaf(a[i], c[j], dp[i][j]);
          }
        }
        // P, rounded to the element type, for dV; then dS for dK.
        float p[IQ][JK], sc[IQ][JK];
#pragma unroll
        for (int i = 0; i < IQ; ++i) {
          const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
          for (int j = 0; j < JK; ++j) {
            const int c = tx + 16 * j, col = k0 + c;
            sc[i][j] = mk.score(s[i][j]);
            float pv = 0.f;
            if (row < r_end && mk.keep(row, col))
              pv = expf(sc[i][j] - lse_s[r]);
            else if (row < r_end && col < T && mk.empty(row))
              pv = mk.inv_empty;
            p[i][j] = pv;
            ps[r * PP + c] = f32(elem<E>(pv));
          }
        }
        __syncthreads();
        for (int r = 0; r < RQ; ++r) {
          float pr[JK];
#pragma unroll
          for (int i = 0; i < JK; ++i) pr[i] = ps[r * PP + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < DV / 16; ++j) {
            const float x = dos[r * VP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < JK; ++i) av[i][j] = fmaf(pr[i], x, av[i][j]);
          }
        }
        if (range != 0) continue;        // rows that keep no key: dS = 0
        __syncthreads();
#pragma unroll
        for (int i = 0; i < IQ; ++i) {
          const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
          for (int j = 0; j < JK; ++j) {
            const int c = tx + 16 * j, col = k0 + c;
            ps[r * PP + c] = row < r_end && mk.keep(row, col)
                                 ? mk.ds(sc[i][j], p[i][j], dp[i][j], d_s[r])
                                 : 0.f;
          }
        }
        __syncthreads();
        for (int r = 0; r < RQ; ++r) {
          float gr[JK];
#pragma unroll
          for (int i = 0; i < JK; ++i) gr[i] = ps[r * PP + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < HD / 16; ++j) {
            const float x = qs[r * KP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < JK; ++i) ak[i][j] = fmaf(gr[i], x, ak[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < JK; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= T) continue;
    const long at = (static_cast<long>(b) * T + col) * KH + kh;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      dk[at * HD + tx + 16 * j] = elem<E>(ak[i][j] * mk.scale);
#pragma unroll
    for (int j = 0; j < DV / 16; ++j)
      dv[at * DV + tx + 16 * j] = elem<E>(av[i][j]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) configured = true;
  return e;
}

// q, dq: (B, S, H, HD); k, dk: (B, T, KH, HD); v, dv: (B, T, KH, DV); out,
// dout: (B, S, H, DV); lse, D: (B, S, H) float32; all contiguous.  The
// launches run in order on `stream`: dq (writing D), then dkv.
template <typename E, int HD, int DV>
cudaError_t run(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* D, void* dq,
                void* dk, void* dv, long B, long S, long T, long H, long KH,
                int causal, long window, float softcap, float scale,
                float empty_l, cudaStream_t stream) {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256, "head_dim");
  static_assert(DV % 16 == 0 && DV >= 16 && DV <= HD, "v_head_dim");
  if (B < 1 || S < 1 || T < 1 || KH < 1 || H % KH != 0 || S > INT_MAX ||
      T > INT_MAX || window < 0 || window > INT_MAX)
    return cudaErrorInvalidValue;
  const long nqt = (S + RQ - 1) / RQ, nkt = (T + RK - 1) / RK;
  if (nqt * B * H > INT_MAX || nkt * B * KH > INT_MAX)
    return cudaErrorInvalidValue;
  const Mask mk{static_cast<int>(S), static_cast<int>(T), causal,
                static_cast<int>(window), softcap, scale, 1.f / empty_l};
  constexpr size_t smem = Smem<HD, DV>::bytes;
  static bool dq_ready = false, dkv_ready = false;
  cudaError_t e = allow_smem(dq_kernel<E, HD, DV>, smem, dq_ready);
  if (e != cudaSuccess) return e;
  e = allow_smem(dkv_kernel<E, HD, DV>, smem, dkv_ready);
  if (e != cudaSuccess) return e;
  dq_kernel<E, HD, DV><<<static_cast<unsigned>(nqt * B * H), THREADS, smem,
                         stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(out),
      static_cast<const E*>(dout), lse, D, static_cast<E*>(dq),
      static_cast<int>(S), static_cast<int>(T), static_cast<int>(H),
      static_cast<int>(KH), static_cast<int>(nqt), mk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<E, HD, DV><<<static_cast<unsigned>(nkt * B * KH), THREADS, smem,
                          stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, D,
      static_cast<E*>(dk), static_cast<E*>(dv), static_cast<int>(S),
      static_cast<int>(T), static_cast<int>(H), static_cast<int>(KH),
      static_cast<int>(nkt), mk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_bwd
}  // namespace rt
