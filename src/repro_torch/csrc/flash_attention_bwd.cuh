// K10's gradient: dQ, dK and dV of the fused attention of
// flash_attention.cuh from q, k, v, out, dout and the forward's log-sum-exp
// of each row (lse), for every form the forward takes: causal or not, a
// sliding window, a soft cap, S != T, GQA (H query heads over KH kv heads),
// a value head dim DV of its own (DV <= HD; MLA: HD 192, DV 128), head dims
// 16 to 256 in steps of 16, rows that keep no key.
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
// Bound on this card: operations.  At recurrentgemma-2b's layer (B = 1, S =
// T = 4,096, 10 query heads over 1 kv head of 256, window 2,048) 62.9 M kept
// pairs take 2,560 flop each (q . k and dout . v, dS K and dS^T q, P^T
// dout: five products of 2 x 256): 161 GFLOP, 0.163 ms at the 989 TFLOP/s
// bf16 tensor peak, against 0.027 ms for its 92 MB.  This design computes
// seven products a kept pair, not five (below), so its own floor is 0.228
// ms there.
//
// No launch uses atomics on the gradient: a gradient repeats bit for bit,
// which the trainer's bit-exact resume relies on.
//
// TensorCores (bfloat16, the models' path): three launches.
//  * `rows`: D = rowsum(dout . out) and lse log2(e) of each row, a warp a
//    row, into a workspace of (B, H, SP) float32 rows (SP: S rounded up to
//    128), which the other two load 64 or 128 at a time by bulk copy.
//  * `dq`: one block per (batch, query head, BQ query rows), a producer
//    warpgroup and GROUPS consumer warpgroups of 64 rows each (GROUPS = 2,
//    BQ = 128, where the rows' q and dout and a two-stage ring fit the 227
//    KB of shared memory; else 1, BQ = 64: head dims 256 / 256).  q and dout
//    load once; K and V tiles of 64 keys stream through a ring, each stage
//    with a full barrier for K, one for V and an empty barrier.  Per tile S
//    = Q K^T and dP = dO V^T (wgmma m64n64k16 from shared memory), P and dS
//    in the accumulators' registers, then dQ += dS K with dS rounded to
//    bf16 from registers as the A operand (wgmma m64n{HDP}k16, K read
//    MN-major).  So dq recomputes S and dP: seven products a kept pair
//    where the function needs five; the price of having no atomics.
//  * `dkv`: one block per (batch, kv head, 64-key tile, split): a producer
//    warpgroup and two consumers.  K and V load once; q, dout and the rows'
//    lse and D tiles of 64 query rows stream through the ring, over the G
//    query heads of the kv head and every query tile that keeps a key of
//    the tile (causal, window) or keeps none.  At head dim 256 a 64 x 256
//    float32 accumulator takes 128 registers a thread of a warpgroup, so dK
//    and dV do not fit one: one warpgroup owns dV, the other dK.
//      - the V group: S^T = K Q^T, P^T = exp2 of the scaled, capped score
//        less lse in registers (masked only on edge tiles: the causal
//        diagonal, the window's edge, the tails of S and T, rows that keep
//        no key), P^T (dS's factor: times 1 - t^2 under a cap) to a float32
//        exchange buffer in shared memory (double-buffered, a thread's
//        values at its own slots: no bank conflicts), then dV += P^T dO with
//        P^T rounded to bf16 as the A operand;
//      - the K group: dP^T = V dO^T meanwhile, then dS^T = P^T (dP^T - D)
//        from the buffer and dK += dS^T Q, dS^T rounded to bf16 as the A
//        operand.  Named barriers hand each buffer over and back.
//    The two groups do two products each per tile and interleave.
//    setmaxnreg gives the producer 40 registers and each consumer 232.
//    Where B KH (T / 64) blocks would not fill the card (recurrentgemma:
//    64 key tiles for 132 SMs), the host splits each key tile's work
//    (query head major, then query tile) over `splits` blocks
//    (kernels/flash_attention.py: bwd_plan); each writes its partial dK and
//    dV in float32 to the workspace, and the last of them (a ticket counter
//    in the stream's workspace, which it sets back to 0) folds the
//    partials in split order and writes dK and dV: the fold's order is
//    fixed, so the result does not depend on which block came last.
// The tensor maps are the forward's (rank 4 over the arrays as given,
// boxes of 64 head dims with the 128-byte swizzle, zero fill of padded
// head dims and of rows at or past S or T); query head h reads kv head h /
// G by the maps' head coordinate, so the GQA broadcast is never
// materialised.  The wgmma instructions, whose operand lists depend on HDP
// and DVP, are generated per unit (kernels/_lib.py: _wgmma_bwd).
//
// CudaCores (float32; no served or trained model runs float32 attention on
// the card, and the 1e-5 bound rules out TF32): two launches, `dq` over
// query tiles (it also writes D, which `dkv` reads), then `dkv` over key
// tiles, each block summing the G query heads of its kv head in registers.
// Tiles of 64 query rows and 32 keys in shared memory as float32 (rows
// padded by one float against bank conflicts), 256 threads, each owning a
// 4 x 2 piece of the score tile and a strip of its block's accumulator.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"
#include "flash_attention.cuh"

namespace rt {
namespace flash_bwd {
namespace {

// The arguments of one gradient, as the C entry takes them.  q, dq: (B, S,
// H, HD); k, dk: (B, T, KH, HD); v, dv: (B, T, KH, DV); out, dout: (B, S, H,
// DV); lse: (B, S, H) float32; all contiguous.  ws: float32 workspace
// (CudaCores: D, B S H floats; TensorCores: the rows, 2 B H SP floats, then
// the partials, B KH ceil(T / 64) splits 64 (HD + DV) floats where splits
// > 1); counters: B KH ceil(T / 64) words, 0 at rest, where splits > 1.
struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* ws;
  unsigned* counters;
  void *dq, *dk, *dv;
  long B, S, T, H, KH;
  int causal;
  long window;
  float softcap, scale, empty_l;
  long splits;
};

// ---------------------------------------------------------------------------
// CudaCores: float32.
// ---------------------------------------------------------------------------

namespace cc {

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

}  // namespace cc

template <int HD, int DV = HD>
struct CudaCores {
  using Elem = float;

  static cudaError_t run(const Args& a, cudaStream_t stream) {
    using namespace cc;
    if (a.splits != 1) return cudaErrorInvalidValue;
    const long nqt = (a.S + RQ - 1) / RQ, nkt = (a.T + RK - 1) / RK;
    if (nqt * a.B * a.H > INT_MAX || nkt * a.B * a.KH > INT_MAX)
      return cudaErrorInvalidValue;
    const Mask mk{static_cast<int>(a.S), static_cast<int>(a.T), a.causal,
                  static_cast<int>(a.window), a.softcap, a.scale,
                  1.f / a.empty_l};
    constexpr size_t smem = Smem<HD, DV>::bytes;
    static bool dq_ready = false, dkv_ready = false;
    cudaError_t e = allow_smem(dq_kernel<float, HD, DV>, smem, dq_ready);
    if (e != cudaSuccess) return e;
    e = allow_smem(dkv_kernel<float, HD, DV>, smem, dkv_ready);
    if (e != cudaSuccess) return e;
    dq_kernel<float, HD, DV><<<static_cast<unsigned>(nqt * a.B * a.H),
                               THREADS, smem, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.out),
        static_cast<const float*>(a.dout), a.lse, a.ws,
        static_cast<float*>(a.dq), static_cast<int>(a.S),
        static_cast<int>(a.T), static_cast<int>(a.H), static_cast<int>(a.KH),
        static_cast<int>(nqt), mk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dkv_kernel<float, HD, DV><<<static_cast<unsigned>(nkt * a.B * a.KH),
                                THREADS, smem, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.ws, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        static_cast<int>(a.S), static_cast<int>(a.T), static_cast<int>(a.H),
        static_cast<int>(a.KH), static_cast<int>(nkt), mk);
    return cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// TensorCores: bfloat16 by wgmma on a TMA ring.
// ---------------------------------------------------------------------------

namespace tc {

using namespace rt::flash::tc;
using rt::flash::BK;
using bf16 = __nv_bfloat16;

// Named barriers of the dkv consumers (0 is __syncthreads): the exchange
// buffer b is full (X_FULL + b) and free again (X_FREE + b); the ticket.
constexpr int X_FULL = 1, X_FREE = 3, TICKET = 5;
constexpr int CONSUMERS = 256;           // the two consumer warpgroups
constexpr uint32_t BOX = BK * ROW_BYTES;  // one swizzled box of 64 rows

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(CONSUMERS)
               : "memory");
}

// `bytes` contiguous bytes into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The score terms of both kernels, in log2 units: a raw product x becomes
// s log2(e), capped as the forward caps it; t = s / softcap, whose
// 1 - t^2 is tanh's derivative.
struct Score {
  bool cap;
  float lin, exp_k, cap2, neg2cap2, inv_cap2;

  __device__ Score(float softcap, float scale)
      : cap(softcap != 0.f), lin(scale * LOG2E),
        exp_k(cap ? 2.f * LOG2E * scale / softcap : 0.f),
        cap2(softcap * LOG2E), neg2cap2(-2.f * softcap * LOG2E),
        inv_cap2(cap ? 1.f / (softcap * LOG2E) : 0.f) {}

  __device__ __forceinline__ float log2s(float x) const {
    return cap ? fmaf(neg2cap2, rcp(ex2(x * exp_k) + 1.f), cap2) : x * lin;
  }
  // dS's factor of P: 1 - t^2 under a cap.
  __device__ __forceinline__ float factor(float s2) const {
    if (!cap) return 1.f;
    const float t = s2 * inv_cap2;
    return 1.f - t * t;
  }
};

// Which keys a row keeps; a row at or past `eb` (< S) keeps none.
struct Keep {
  int S, T, causal, window, eb;
  __device__ __forceinline__ bool operator()(int row, int key) const {
    bool k = row < S && key < T;
    if (causal) k = k && row >= key;
    if (window) k = k && row - key < window;
    return k;
  }
  __device__ __forceinline__ bool empty(int row, int key) const {
    return row >= eb && row < S && key < T;
  }
};

__device__ __forceinline__ int empty_begin(int S, int T, int window) {
  return window ? static_cast<int>(min(static_cast<long>(T) + window - 1,
                                       static_cast<long>(S)))
                : S;
}

// S = A B^T over `depth` (a multiple of 16) into d: A's 64 rows and B's 64
// rows both K-major in boxes of 64 columns, `a_box` and `b_box` bytes apart.
template <typename W, int DEPTH>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t a_box, uint32_t b,
                                         uint32_t b_box) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DEPTH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    W::qk(d, desc(a + (kk / 4) * a_box + off, 16, 1024),
          desc(b + (kk / 4) * b_box + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc (64 x N) += A (64 x 64, bf16 fragments) B, B's 64 rows MN-major in
// boxes of 64 rows (BOX bytes apart along N): the unit's N = HDP form
// (HEAD) or its N = DVP form.
template <typename W, bool HEAD, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t b) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = desc(b + kk * 16 * ROW_BYTES, BOX, 1024);
    if constexpr (HEAD)
      W::pk(acc, pa[kk], d);
    else
      W::pv(acc, pa[kk], d);
  }
  wgmma_commit();
}

// One warpgroup's 64 x N accumulator (rows r0 + 8 e, columns 8 j + col +
// t) to bf16 rows of `width` columns at `dst` + row * `stride`, times `mul`;
// rows at or past `rows` are not stored.
template <int N>
__device__ __forceinline__ void store_bf16(const float (&acc)[N / 2],
                                           bf16* dst, long stride, int r0,
                                           int col, int rows, int width,
                                           float mul) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 8 * e;
    if (r >= rows) continue;
    bf16* row = dst + r * stride;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (8 * j < width)
        *reinterpret_cast<uint32_t*>(row + 8 * j + col) =
            pack_bf16(acc[4 * j + 2 * e] * mul, acc[4 * j + 2 * e + 1] * mul);
  }
}

// ---- rows: D and lse log2(e), a warp a row of (B, H, SP). ----

__global__ void __launch_bounds__(256)
rows_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2,
            float* __restrict__ Dw, int S, int H, int DV, int SP,
            long total) {
  const long w = static_cast<long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= total) return;
  const int s = static_cast<int>(w % SP);
  const long bh = w / SP;
  const long b = bh / H;
  const int h = static_cast<int>(bh % H);
  float d = 0.f, l = 0.f;
  if (s < S) {
    const long at = (b * S + s) * H + h;
    if (lane * 8 < DV) {
      const uint4 x = *reinterpret_cast<const uint4*>(dout + at * DV + lane * 8);
      const uint4 y = *reinterpret_cast<const uint4*>(out + at * DV + lane * 8);
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fx = __bfloat1622float2(xa[i]);
        const float2 fy = __bfloat1622float2(ya[i]);
        d = fmaf(fx.x, fy.x, d);
        d = fmaf(fx.y, fy.y, d);
      }
    }
    d = cc::warp_sum(d);
    l = lse[at] * LOG2E;
  }
  if (lane == 0) {
    lse2[w] = l;
    Dw[w] = d;
  }
}

// ---- dq ----

template <int HD, int DV>
struct DqShape {
  static constexpr int HDP = (HD + 63) / 64 * 64, DVP = (DV + 63) / 64 * 64;
  static constexpr int HB = HDP / 64, VB = DVP / 64;
  static constexpr size_t ring(int groups, int stages) {
    return 1024 + static_cast<size_t>(groups) * 64 * ROW_BYTES * (HB + VB)
         + static_cast<size_t>(groups) * 64 * 8
         + static_cast<size_t>(stages) * BOX * (HB + VB);
  }
  // Two consumer groups (128 query rows) where their q and dout and a
  // two-stage ring fit; one at head dims 256 / 256.
  static constexpr int GROUPS = ring(2, 2) <= SMEM_LIMIT ? 2 : 1;
  static constexpr int STAGES = ring(GROUPS, 3) <= SMEM_LIMIT ? 3 : 2;
  static constexpr int BQ = 64 * GROUPS;
  static constexpr int THREADS = 128 * (GROUPS + 1);
  static constexpr uint32_t Q_BOX = BQ * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = HB * Q_BOX, O_BYTES = VB * Q_BOX;
  static constexpr uint32_t K_BYTES = HB * BOX, V_BYTES = VB * BOX;
  static constexpr uint32_t ROWS = 2 * BQ * 4;        // lse2, then D
  static constexpr size_t SMEM = ring(GROUPS, STAGES);
  static_assert(SMEM <= SMEM_LIMIT, "q, dout and a two-stage ring fit");
};

// q: (B, S, H, HD) and dout (B, S, H, DV) through maps of BQ-row boxes; k
// and v of 64-row boxes; dq: (B, S, H, HD).
template <int HD, int DV, typename W>
__global__ void __launch_bounds__(DqShape<HD, DV>::THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          const __grid_constant__ CUtensorMap omap,
          const float* __restrict__ lse2, const float* __restrict__ Dw,
          bf16* __restrict__ dq, int S, int T, int H, int KH, int SP,
          int nqt, int causal, int window, float softcap, float scale) {
  using SH = DqShape<HD, DV>;
  constexpr int STAGES = SH::STAGES, BQ = SH::BQ, HDP = SH::HDP;
  static_assert(W::HN == HDP, "the unit's dS K wgmma spans the padded row");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t so = sq + SH::Q_BYTES;
  const uint32_t skv = so + SH::O_BYTES;       // stage s: K, then V
  const uint32_t srows = skv + STAGES * (SH::K_BYTES + SH::V_BYTES);
  const float* rows_s =
      reinterpret_cast<const float*>(smem_raw + (srows - raw));
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full_k = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto full_v = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + 2 * STAGES + s]); };
  auto k_tile = [&](int s) { return skv + s * (SH::K_BYTES + SH::V_BYTES); };
  auto v_tile = [&](int s) { return k_tile(s) + SH::K_BYTES; };

  const int BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / BH);
  const int b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = qt * BQ;
  // Rows from eb keep no key: their dS, and so their dq, is 0.
  const int eb = empty_begin(S, T, window);
  const int rows_end = min(S, eb);
  const int qlast = min(q0 + BQ, rows_end) - 1;
  int begin = 0, end = 0;
  if (qlast >= q0) {
    begin = window ? max(0, q0 - window + 1) / BK * BK : 0;
    end = causal ? min(T, qlast + 1) : T;
  }
  const int tiles = end > begin ? (end - begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full_k(s), 1);
      bar_init(full_v(s), 1);
      bar_init(empty(s), SH::GROUPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == 0) {
    // Producer.
    if constexpr (SH::GROUPS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      bar_expect(bar_q, SH::Q_BYTES + SH::O_BYTES + SH::ROWS);
      for (int j = 0; j < SH::HB; ++j)
        tma_load(sq + j * SH::Q_BOX, &qmap, bar_q, 64 * j, h, q0, b);
      for (int j = 0; j < SH::VB; ++j)
        tma_load(so + j * SH::Q_BOX, &omap, bar_q, 64 * j, h, q0, b);
      const long at = (static_cast<long>(b) * H + h) * SP + q0;
      bulk_load(srows, lse2 + at, BQ * 4, bar_q);
      bulk_load(srows + BQ * 4, Dw + at, BQ * 4, bar_q);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES, k0 = begin + i * BK;
        bar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        bar_expect(full_k(s), SH::K_BYTES);
        for (int j = 0; j < SH::HB; ++j)
          tma_load(k_tile(s) + j * BOX, &kmap, full_k(s), 64 * j, kh, k0, b);
        bar_expect(full_v(s), SH::V_BYTES);
        for (int j = 0; j < SH::VB; ++j)
          tma_load(v_tile(s) + j * BOX, &vmap, full_v(s), 64 * j, kh, k0, b);
      }
    }
  } else {
    // Consumers: group g owns query rows q0 + 64 (g - 1) .. + 63.
    if constexpr (SH::GROUPS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int rlo = q0 + 64 * (group - 1);
    const int lr = 64 * (group - 1) + 16 * warp + lane / 4;   // e = 0
    const int r0 = q0 + lr, col = 2 * (lane % 4);
    const uint32_t qa = sq + (group - 1) * 64 * ROW_BYTES;
    const uint32_t oa = so + (group - 1) * 64 * ROW_BYTES;
    const Score sco(softcap, scale);
    const Keep keep{S, T, causal, window, eb};

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    bar_wait(bar_q, 0);
    const float l2[2] = {rows_s[lr], rows_s[lr + 8]};
    const float dd[2] = {rows_s[BQ + lr], rows_s[BQ + lr + 8]};
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES, k0 = begin + i * BK;
      const uint32_t parity = (i / STAGES) & 1;
      float sc[32], dp[32];
      uint32_t pa[4][4];
      bar_wait(full_k(s), parity);
      issue_ss<W, HD>(sc, qa, SH::Q_BOX, k_tile(s), BOX);
      bar_wait(full_v(s), parity);
      issue_ss<W, DV>(dp, oa, SH::Q_BOX, v_tile(s), BOX);
      wgmma_wait();
      fence_regs(sc);
      fence_regs(dp);
      // Only tiles that hold a dropped pair for one of the group's rows
      // are masked.
      const bool mask = k0 + BK > T || (causal && k0 + BK - 1 > rlo) ||
                        (window && k0 <= rlo + 63 - window) ||
                        rlo + 64 > rows_end;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int e = (r / 2) % 2;
        const float x = sco.log2s(sc[r]);
        const float g = ex2(x - l2[e]) * sco.factor(x) * (dp[r] - dd[e]);
        const bool kept =
            !mask || keep(r0 + 8 * e, k0 + 8 * (r / 4) + col + r % 2);
        sc[r] = kept ? g : 0.f;
      }
      pack_p(sc, pa);
      issue_rs<W, true, HDP>(acc, pa, k_tile(s));
      wgmma_wait();
      fence_regs(acc);
      if (tid == 0) bar_arrive(empty(s));
    }
    store_bf16<HDP>(acc, dq + (static_cast<long>(b) * S * H + h) * HD,
                    static_cast<long>(H) * HD, r0, col, S, HD, scale);
  }
}

// ---- dkv ----

template <int HD, int DV>
struct DkvShape {
  static constexpr int HDP = (HD + 63) / 64 * 64, DVP = (DV + 63) / 64 * 64;
  static constexpr int HB = HDP / 64, VB = DVP / 64;
  static constexpr int THREADS = 128 + CONSUMERS;
  static constexpr uint32_t K_BYTES = HB * BOX, V_BYTES = VB * BOX;
  static constexpr uint32_t Q_BYTES = HB * BOX, O_BYTES = VB * BOX;
  static constexpr uint32_t STAGE = Q_BYTES + O_BYTES;
  static constexpr uint32_t X_FLOATS = 64 * 64;        // one exchange buffer
  static constexpr uint32_t ROWS = 2 * 64 * 4;         // lse2, then D
  static constexpr size_t ring(int stages) {
    return 1024 + K_BYTES + V_BYTES + static_cast<size_t>(stages) * STAGE
         + 2 * 4 * X_FLOATS + static_cast<size_t>(stages) * ROWS;
  }
  static constexpr int STAGES = ring(3) <= SMEM_LIMIT ? 3 : 2;
  static constexpr size_t SMEM = ring(STAGES);
  static_assert(SMEM <= SMEM_LIMIT, "K, V, two buffers and two stages fit");
};

// The query tiles a key tile meets, in one or two ranges: [t0, t1) whose
// rows may keep one of its keys, then [e0, e1) whose rows keep none.
struct QueryTiles {
  int t0, t1, e0, e1, n1, nq;
  __device__ QueryTiles(int k0, int S, int T, int causal, int window,
                        int eb) {
    const int klast = min(k0 + BK, T) - 1;
    const int qb = causal ? k0 : 0;
    int qe = window ? static_cast<int>(min(static_cast<long>(klast) + window,
                                           static_cast<long>(S)))
                    : S;
    qe = min(qe, eb);
    t0 = qb / BK;
    t1 = qb < qe ? (qe + BK - 1) / BK : t0;
    e0 = eb / BK;
    e1 = eb < S ? (S + BK - 1) / BK : e0;
    if (t1 == t0) {
      t0 = e0;
      t1 = e1;
      e0 = e1;
    } else if (e0 < e1 && e0 <= t1) {
      t1 = max(t1, e1);
      e0 = e1;
    }
    n1 = t1 - t0;
    nq = n1 + e1 - e0;
  }
  __device__ __forceinline__ int tile(int j) const {
    return j < n1 ? t0 + j : e0 + j - n1;
  }
};

// The last of a key tile's `splits` blocks (after all wrote their
// partials) sums them in split order and writes dK (times scale) and dV;
// the 256 consumer threads, `t` of them.
template <int HD, int DV>
__device__ __forceinline__ void fold(const float* __restrict__ part,
                                     unsigned* __restrict__ counter,
                                     int splits, int* last, bf16* dk,
                                     bf16* dv, long dk_stride, long dv_stride,
                                     int k0, int T, float scale, int t) {
  constexpr int W = HD + DV;
  __threadfence();                       // publish the partial
  named_sync(TICKET);
  if (t == 0) {
    const unsigned ticket = atomicAdd(counter, 1u);
    *last = ticket == static_cast<unsigned>(splits - 1);
    if (*last) *counter = 0u;            // 0 at rest for the next launch
  }
  named_sync(TICKET);
  if (!*last) return;
  __threadfence();
  for (int e = t; e < 64 * W / 4; e += CONSUMERS) {
    float4 sum = __ldcg(reinterpret_cast<const float4*>(part) + e);
    for (int p = 1; p < splits; ++p) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
                                  part + static_cast<long>(p) * 64 * W) + e);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int row = 4 * e / W, c = 4 * e % W, key = k0 + row;
    if (key >= T) continue;
    const bool is_k = c < HD;
    const float m = is_k ? scale : 1.f;
    bf16* dst = is_k ? dk + key * dk_stride + c
                     : dv + key * dv_stride + (c - HD);
    uint2 pk;
    pk.x = pack_bf16(sum.x * m, sum.y * m);
    pk.y = pack_bf16(sum.z * m, sum.w * m);
    *reinterpret_cast<uint2*>(dst) = pk;
  }
}

// A consumer group's 64 x N accumulator as float32 columns [off, off +
// width) of its block's partial rows, W = HD + DV floats a row.
template <int N>
__device__ __forceinline__ void store_part(const float (&acc)[N / 2],
                                           float* dst, int row_stride,
                                           int r0, int col, int width) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float* row = dst + (r0 + 8 * e) * row_stride;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (8 * j < width)
        *reinterpret_cast<float2*>(row + 8 * j + col) =
            make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
  }
}

// q (B, S, H, HD), dout (B, S, H, DV), k (B, T, KH, HD), v (B, T, KH, DV)
// through maps of 64-row boxes; dk, dv as k, v.
template <int HD, int DV, typename W>
__global__ void __launch_bounds__(DkvShape<HD, DV>::THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const __grid_constant__ CUtensorMap omap,
           const float* __restrict__ lse2, const float* __restrict__ Dw,
           float* __restrict__ part, unsigned* __restrict__ counters,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int T, int H,
           int KH, int SP, int nkt, int splits, int causal, int window,
           float softcap, float scale, float inv_empty) {
  using SH = DkvShape<HD, DV>;
  constexpr int STAGES = SH::STAGES, HDP = SH::HDP, DVP = SH::DVP;
  static_assert(W::HN == HDP && W::VN == DVP,
                "the unit's wgmma forms span the padded rows");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  __shared__ int last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;
  const uint32_t sv = sk + SH::K_BYTES;
  const uint32_t sst = sv + SH::V_BYTES;      // stage s: q, then dout
  const uint32_t sx = sst + STAGES * SH::STAGE;
  const uint32_t srows = sx + 2 * 4 * SH::X_FLOATS;
  float* xbuf = reinterpret_cast<float*>(smem_raw + (sx - raw));
  const float* rows_s =
      reinterpret_cast<const float*>(smem_raw + (srows - raw));
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto q_tile = [&](int s) { return sst + s * SH::STAGE; };
  auto o_tile = [&](int s) { return q_tile(s) + SH::Q_BYTES; };

  // Block: split p of key tile kt of (b, kh); heavier key tiles (more
  // query rows under a causal mask) first.
  const int nbk = gridDim.x / (splits * nkt);
  const int p = blockIdx.x % splits, grp = blockIdx.x / splits;
  const int kt = grp / nbk, bk = grp % nbk;
  const int b = bk / KH, kh = bk % KH, G = H / KH;
  const int k0 = kt * BK;
  const int eb = empty_begin(S, T, window);
  const QueryTiles qts(k0, S, T, causal, window, eb);
  const long items = static_cast<long>(G) * qts.nq;
  const int i0 = static_cast<int>(items * p / splits);
  const int i1 = static_cast<int>(items * (p + 1) / splits);
  const int n_items = i1 - i0;

  if (threadIdx.x == 0) {
    bar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 2);             // one arrival per consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == 0) {
    // Producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      bar_expect(bar_kv, SH::K_BYTES + SH::V_BYTES);
      for (int j = 0; j < SH::HB; ++j)
        tma_load(sk + j * BOX, &kmap, bar_kv, 64 * j, kh, k0, b);
      for (int j = 0; j < SH::VB; ++j)
        tma_load(sv + j * BOX, &vmap, bar_kv, 64 * j, kh, k0, b);
      for (int n = 0; n < n_items; ++n) {
        const int i = i0 + n, s = n % STAGES;
        const int h = kh * G + i / qts.nq;
        const int q0 = qts.tile(i % qts.nq) * BK;
        bar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
        bar_expect(full(s), SH::STAGE + SH::ROWS);
        for (int j = 0; j < SH::HB; ++j)
          tma_load(q_tile(s) + j * BOX, &qmap, full(s), 64 * j, h, q0, b);
        for (int j = 0; j < SH::VB; ++j)
          tma_load(o_tile(s) + j * BOX, &omap, full(s), 64 * j, h, q0, b);
        const long at = (static_cast<long>(b) * H + h) * SP + q0;
        bulk_load(srows + s * SH::ROWS, lse2 + at, 256, full(s));
        bulk_load(srows + s * SH::ROWS + 256, Dw + at, 256, full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int lr = 16 * warp + lane / 4;         // key row of e = 0
    const int col = 2 * (lane % 4);              // query column offset
    const long dk_stride = static_cast<long>(KH) * HD;
    const long dv_stride = static_cast<long>(KH) * DV;
    bf16* dk_b = dk + (static_cast<long>(b) * T * KH + kh) * HD;
    bf16* dv_b = dv + (static_cast<long>(b) * T * KH + kh) * DV;
    float* part_b = part + static_cast<long>(grp) * splits * 64 * (HD + DV);
    bar_wait(bar_kv, 0);
    if (group == 1) {
      // dV: S^T, P^T, then dV += P^T dO.
      const Score sco(softcap, scale);
      const Keep keep{S, T, causal, window, eb};
      float acc[DVP / 2];
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
      for (int n = 0; n < n_items; ++n) {
        const int i = i0 + n, s = n % STAGES, xb = n & 1;
        const int q0 = qts.tile(i % qts.nq) * BK;
        float st[32];
        uint32_t pa[4][4];
        bar_wait(full(s), (n / STAGES) & 1);
        issue_ss<W, HD>(st, sk, BOX, q_tile(s), BOX);
        const float* l2 = rows_s + s * (SH::ROWS / 4);
        float lv[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(l2 + 8 * j + col);
          lv[2 * j] = x.x;
          lv[2 * j + 1] = x.y;
        }
        wgmma_wait();
        fence_regs(st);
        const bool mask = q0 + BK > min(S, eb) || k0 + BK > T ||
                          (causal && q0 < k0 + BK - 1) ||
                          (window && q0 + BK - 1 - k0 >= window);
        if (n >= 2) named_sync(X_FREE + xb);
        float* xw = xbuf + xb * SH::X_FLOATS + tid;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int c = 2 * (r / 4) + r % 2;     // lv index of the column
          const float x = sco.log2s(st[r]);
          float pr = ex2(x - lv[c]);
          float pk = pr * sco.factor(x);
          if (mask) {
            const int key = k0 + lr + 8 * ((r / 2) % 2);
            const int row = q0 + 8 * (r / 4) + col + r % 2;
            const bool kept = keep(row, key);
            pk = kept ? pk : 0.f;
            pr = kept ? pr : keep.empty(row, key) ? inv_empty : 0.f;
          }
          st[r] = pr;
          xw[r * 128] = pk;
        }
        named_arrive(X_FULL + xb);
        pack_p(st, pa);
        issue_rs<W, false, DVP>(acc, pa, o_tile(s));
        wgmma_wait();
        fence_regs(acc);
        if (tid == 0) bar_arrive(empty(s));
      }
      // Take back the buffers of the last two tiles.
      for (int n = max(0, n_items - 2); n < n_items; ++n)
        named_sync(X_FREE + (n & 1));
      if (splits == 1) {
        store_bf16<DVP>(acc, dv_b + static_cast<long>(k0) * dv_stride,
                        dv_stride, lr, col, T - k0, DV, 1.f);
      } else {
        store_part<DVP>(acc, part_b + static_cast<long>(p) * 64 * (HD + DV)
                                 + HD, HD + DV, lr, col, DV);
        fold<HD, DV>(part_b, counters + grp, splits, &last, dk_b, dv_b,
                     dk_stride, dv_stride, k0, T, scale, tid);
      }
    } else {
      // dK: dP^T, dS^T from the V group's P^T, then dK += dS^T Q.
      float acc[HDP / 2];
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
      for (int n = 0; n < n_items; ++n) {
        const int s = n % STAGES, xb = n & 1;
        float dp[32];
        uint32_t pa[4][4];
        bar_wait(full(s), (n / STAGES) & 1);
        issue_ss<W, DV>(dp, sv, BOX, o_tile(s), BOX);
        const float* d2 = rows_s + s * (SH::ROWS / 4) + 64;
        float dd[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(d2 + 8 * j + col);
          dd[2 * j] = x.x;
          dd[2 * j + 1] = x.y;
        }
        wgmma_wait();
        fence_regs(dp);
        named_sync(X_FULL + xb);
        const float* xr = xbuf + xb * SH::X_FLOATS + tid;
#pragma unroll
        for (int r = 0; r < 32; ++r)
          dp[r] = xr[r * 128] * (dp[r] - dd[2 * (r / 4) + r % 2]);
        named_arrive(X_FREE + xb);
        pack_p(dp, pa);
        issue_rs<W, true, HDP>(acc, pa, q_tile(s));
        wgmma_wait();
        fence_regs(acc);
        if (tid == 0) bar_arrive(empty(s));
      }
      if (splits == 1) {
        store_bf16<HDP>(acc, dk_b + static_cast<long>(k0) * dk_stride,
                        dk_stride, lr, col, T - k0, HD, scale);
      } else {
        store_part<HDP>(acc, part_b + static_cast<long>(p) * 64 * (HD + DV),
                        HD + DV, lr, col, HD);
        fold<HD, DV>(part_b, counters + grp, splits, &last, dk_b, dv_b,
                     dk_stride, dv_stride, k0, T, scale, 128 + tid);
      }
    }
  }
}

}  // namespace tc

template <int HD, typename W, int DV = HD>
struct TensorCores {
  using Elem = __nv_bfloat16;

  static cudaError_t run(const Args& a, cudaStream_t stream) {
    using namespace tc;
    using cc::allow_smem;
    using DQ = DqShape<HD, DV>;
    using KV = DkvShape<HD, DV>;
    const long SP = (a.S + 127) / 128 * 128;
    const long nqt = (a.S + DQ::BQ - 1) / DQ::BQ;
    const long nkt = (a.T + BK - 1) / BK;
    const long bh = a.B * a.H;
    if (a.splits < 1 || a.splits > INT_MAX / 4 || nqt * bh > INT_MAX ||
        nkt * a.B * a.KH * a.splits > INT_MAX || bh * SP > INT_MAX / 4 ||
        (a.splits > 1 && a.counters == nullptr))
      return cudaErrorInvalidValue;
    float* lse2 = a.ws;
    float* Dw = a.ws + bh * SP;
    float* part = a.ws + 2 * bh * SP;
    CUtensorMap qmap, qmap_dq, kmap, vmap, omap, omap_dq;
    if (!encode(&qmap, a.q, a.B, a.S, a.H, HD, BK) ||
        !encode(&qmap_dq, a.q, a.B, a.S, a.H, HD, DQ::BQ) ||
        !encode(&omap, a.dout, a.B, a.S, a.H, DV, BK) ||
        !encode(&omap_dq, a.dout, a.B, a.S, a.H, DV, DQ::BQ) ||
        !encode(&kmap, a.k, a.B, a.T, a.KH, HD, BK) ||
        !encode(&vmap, a.v, a.B, a.T, a.KH, DV, BK))
      return cudaErrorInvalidValue;
    static bool dq_ready = false, dkv_ready = false;
    cudaError_t e = allow_smem(dq_kernel<HD, DV, W>, DQ::SMEM, dq_ready);
    if (e != cudaSuccess) return e;
    e = allow_smem(dkv_kernel<HD, DV, W>, KV::SMEM, dkv_ready);
    if (e != cudaSuccess) return e;
    const long rows = bh * SP;
    rows_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
        static_cast<const bf16*>(a.out), static_cast<const bf16*>(a.dout),
        a.lse, lse2, Dw, static_cast<int>(a.S), static_cast<int>(a.H), DV,
        static_cast<int>(SP), rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dq_kernel<HD, DV, W><<<static_cast<unsigned>(nqt * bh), DQ::THREADS,
                           DQ::SMEM, stream>>>(
        qmap_dq, kmap, vmap, omap_dq, lse2, Dw, static_cast<bf16*>(a.dq),
        static_cast<int>(a.S), static_cast<int>(a.T), static_cast<int>(a.H),
        static_cast<int>(a.KH), static_cast<int>(SP), static_cast<int>(nqt),
        a.causal, static_cast<int>(a.window), a.softcap, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dkv_kernel<HD, DV, W><<<static_cast<unsigned>(nkt * a.B * a.KH *
                                                  a.splits),
                            KV::THREADS, KV::SMEM, stream>>>(
        qmap, kmap, vmap, omap, lse2, Dw, part, a.counters,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        static_cast<int>(a.S), static_cast<int>(a.T), static_cast<int>(a.H),
        static_cast<int>(a.KH), static_cast<int>(SP), static_cast<int>(nkt),
        static_cast<int>(a.splits), a.causal, static_cast<int>(a.window),
        a.softcap, a.scale, 1.f / a.empty_l);
    return cudaGetLastError();
  }
};

// The checks both bodies share, then the body.
template <typename Body, int HD, int DV = HD>
cudaError_t run(const Args& a, cudaStream_t stream) {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256, "head_dim");
  static_assert(DV % 16 == 0 && DV >= 16 && DV <= HD, "v_head_dim");
  if (a.B < 1 || a.S < 1 || a.T < 1 || a.KH < 1 || a.H % a.KH != 0 ||
      a.S > INT_MAX || a.T > INT_MAX || a.window < 0 || a.window > INT_MAX ||
      a.ws == nullptr)
    return cudaErrorInvalidValue;
  return Body::run(a, stream);
}

}  // namespace
}  // namespace flash_bwd
}  // namespace rt
