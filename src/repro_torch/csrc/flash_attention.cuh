// K10: fused attention with causal, sliding-window and soft-cap masks, for
// every GQA and MLA prefill of the models; bfloat16 on the tensor cores,
// float32 on the CUDA cores.  q and k rows are HD wide, v and out rows DV
// (DV <= HD; MLA: HD 192, DV 128), so V is read at its own width, never
// padded to q's.
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
// k alike; a dropped score is -1e30; the running maximum moves once per kv
// tile of BK = 64 keys; l sums the float32 p; p rounds to the element type
// before the float32 p . v product; out = acc / max(l, 1e-30).
//
// Bound on this card: operations.  At gemma2-27b's prefill (32 query heads,
// 16 kv heads, head_dim 128, T = 2,100) one layer is 36.1 GFLOP against
// 51.6 MB of q, k, v and out: 0.0365 ms at the 989 TFLOP/s bf16 tensor peak
// (0.0154 ms for the bytes); at deepseek-v3's MLA layer (128 heads, HD 192,
// DV 128) 180.7 GFLOP against 344 MB: 0.183 ms (0.103 for the bytes).
// Beside the products, every score takes an exp2 and, soft-capped, an exp2
// and a reciprocal more on the special-function units, which do 16 a clock
// per SM.
//
// TensorCores (bfloat16, the models' path).  One block per (batch, query
// head, 64 G query rows): a producer warpgroup and G consumer warpgroups,
// G = 3 up to a value head of 128 and 2 above it (the O accumulator, DV
// wide, needs 64 or 128 registers a thread; setmaxnreg gives the producer
// 24 or 40 and each consumer 160 or 232; q's width costs no registers).
// The producer's first thread issues TMA loads: q's
// rows once, then K and V tiles of 64 keys into a ring of STAGES stages,
// each stage with a full barrier for K, one for V and an empty barrier the
// consumers arrive at.  A consumer group owns 64 query rows and, per tile:
// S = Q K^T by wgmma.m64n64k16 (both operands K-major in shared memory);
// the online softmax in registers in the accumulator's layout, in log2
// units (a row's max over the quad of lanes that hold it by two shuffles,
// maxima and sums as trees; l kept per lane and summed at the end; O's
// rescale skipped, exactly, when no row of the warp has a new maximum);
// then O += P V by wgmma.m64n{DVP}k16 with P's bf16 fragment taken from
// the S accumulator's registers and V read MN-major (transposed) from shared
// memory.  The groups interleave on their own: one's softmax runs while
// another's products do.  The softmax, not the products, sets the pace (a
// tile's exp2, and with the soft cap an exp2 and a reciprocal more per
// score, on 16 special-function lanes per SM), and a third group hides more
// of its latency.
// The tensor maps are rank 4 over the arrays as given, (head_dim, heads,
// length, batch), with boxes of (64, 1, rows, 1) and the 128-byte swizzle,
// which caps a box row at 64 bf16: a row of head_dim 128 or 256 loads as 2
// or 4 boxes, and a head_dim that is not a multiple of 64 is padded to HDP
// (v's to DVP) with zeros by the hardware, as are key rows at or past T and
// query rows at or past S; nothing crosses into the next batch element.  V
// has a map and a box count of its own.  The ring takes three stages where
// they fit in the 227 KB of shared memory a block may use (MLA's 72 KB of q
// and three 40 KB stages of K and V: 193 KB), else two (head_dim 256).
// Query head h reads kv head h / (H / KH) through the maps' head
// coordinate: the GQA broadcast is never materialised.  Only tiles that
// hold a dropped key (the causal diagonal, the window's edge, the T tail)
// are masked.  The soft cap's tanh is 1 - 2 / (2^(2 x log2 e) + 1) from
// ex2.approx and rcp.approx, a few float32 ulp from tanhf (tanh.approx.f32's
// 2^-11 would move a capped score by 0.02 at softcap 50, more than the bf16
// rounding of p).  The wgmma
// instructions, whose operand lists depend on DVP, are generated per unit
// (kernels/_lib.py: struct Wgmma).
//
// CudaCores (float32).  A block of 4 warps owns 32 query rows; each warp
// owns 8 rows and keeps their (m, l, acc) in registers (acc, DV wide, split
// over the lanes by value dimension); K and V tiles of 64 keys are staged in
// shared memory, a lane takes keys lane and lane + 32 for the scores, and p
// goes through shared memory to the p . v loop.  The float32 check's 1e-5 row
// bound rules out TF32, and no served model runs float32 attention on the
// card.
//
// Both bodies skip tiles that are wholly masked for the block (above the
// causal diagonal, before the window): exact, since once a row has met a
// kept key a dropped one has p = 0, and what a row gathered before its first
// kept key is scaled by alpha = 0.  A row that keeps no key at all (S > T +
// window - 1) gets the reference's answer: its block visits every tile, p =
// 1 throughout, and acc is divided by the reference's padded key count
// (`empty_l`).  Key rows at or past T are zeros.  Later query tiles (more
// keys under a causal mask) are scheduled first.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <type_traits>

#include "common.cuh"

namespace rt {
namespace flash {
namespace {

constexpr int BK = 64;                   // keys per K/V tile
constexpr float NEG_INF = -1e30f;

// The block's kv range [begin, end): every key a row of q0 .. qlast keeps,
// in whole tiles, or all keys when one of its rows keeps none.
struct KvRange {
  int begin, end;
  __device__ KvRange(int q0, int qlast, int T_len, int causal, int window) {
    begin = 0;
    end = T_len;
    const bool empty_row = window > 0 &&
        static_cast<long>(qlast) >= static_cast<long>(T_len) + window - 1;
    if (!empty_row) {
      if (causal) end = min(T_len, qlast + 1);
      if (window) begin = max(0, q0 - window + 1) / BK * BK;
    }
  }
};

// ---------------------------------------------------------------------------
// CudaCores: float32.
// ---------------------------------------------------------------------------

namespace cc {

constexpr int WARPS = 4;
constexpr int ROWS = 8;                  // query rows per warp
constexpr int BQ = WARPS * ROWS;         // query rows per block
constexpr int PAD = 4;                   // floats of padding per K/V row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

template <int HD, int DV>
struct Smem {
  static constexpr int KROW = HD + PAD;
  static constexpr int VROW = DV + PAD;
  static constexpr size_t q = sizeof(float) * BQ * HD;
  static constexpr size_t k = sizeof(float) * BK * KROW;
  static constexpr size_t v = sizeof(float) * BK * VROW;
  static constexpr size_t p = sizeof(float) * BQ * BK;
  static constexpr size_t bytes = q + k + v + p;
};

// q: (B, S, H, HD); k: (B, T, KH, HD); v: (B, T, KH, DV); out: (B, S, H,
// DV); all contiguous.
template <int HD, int DV>
__global__ void __launch_bounds__(WARPS * 32)
attend(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ out, int S,
       int T_len, int H, int KH, int nqt, int causal, int window,
       float softcap, float scale, float empty_l) {
  using SM = Smem<HD, DV>;
  constexpr int KROW = SM::KROW, VROW = SM::VROW;
  constexpr int DI = (DV + 31) / 32;     // value dimensions per lane
  constexpr int CH = HD / 2;             // 8-byte chunks per K row
  constexpr int VCH = DV / 2;            // and per V row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + SM::q);
  float* vs = reinterpret_cast<float*>(smem + SM::q + SM::k);
  float* ps = reinterpret_cast<float*>(smem + SM::q + SM::k + SM::v);

  const int BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / BH);
  const int b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long qstride = static_cast<long>(H) * HD;
  const long kstride = static_cast<long>(KH) * HD;
  const long vstride = static_cast<long>(KH) * DV;
  const float* qb = q + (static_cast<long>(b) * S * H + h) * HD;
  const float* kb = k + (static_cast<long>(b) * T_len * KH + kh) * HD;
  const float* vb = v + (static_cast<long>(b) * T_len * KH + kh) * DV;

  for (int e = threadIdx.x; e < BQ * HD; e += WARPS * 32) {
    const int r = e / HD, t = q0 + r;
    qs[e] = t < S ? qb[t * qstride + e % HD] : 0.f;
  }
  const KvRange kv(q0, min(q0 + BQ, S) - 1, T_len, causal, window);

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

  for (int k0 = kv.begin; k0 < kv.end; k0 += BK) {
    __syncthreads();                     // the previous tile is consumed
    for (int e = threadIdx.x; e < BK * CH; e += WARPS * 32) {
      const int r = e / CH, c = e % CH, t = k0 + r;
      uint2 kk = make_uint2(0u, 0u);
      if (t < T_len) kk = reinterpret_cast<const uint2*>(kb + t * kstride)[c];
      reinterpret_cast<uint2*>(ks + r * KROW)[c] = kk;
    }
    for (int e = threadIdx.x; e < BK * VCH; e += WARPS * 32) {
      const int r = e / VCH, c = e % VCH, t = k0 + r;
      uint2 vv = make_uint2(0u, 0u);
      if (t < T_len) vv = reinterpret_cast<const uint2*>(vb + t * vstride)[c];
      reinterpret_cast<uint2*>(vs + r * VROW)[c] = vv;
    }
    __syncthreads();

    // Scores of keys k0 + lane and k0 + 32 + lane against the warp's rows.
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0r = ks + lane * KROW;
    const float* k1r = ks + (lane + 32) * KROW;
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

    // Online softmax per row; p to shared memory.
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
      pw[r * BK + lane] = p0;
      pw[r * BK + lane + 32] = p1;
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
        const float* vrow = vs + (j + jj) * VROW;
#pragma unroll
        for (int i = 0; i < DI; ++i) {
          const int d = lane + 32 * i;
          if (DV % 32 != 0 && d >= DV) continue;
          const float vd = vrow[d];
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

  const long ostride = static_cast<long>(H) * DV;
  float* ob = out + (static_cast<long>(b) * S * H + h) * DV;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qp = qrow0 + r;
    if (qp >= S) continue;
    const float lr = m[r] == NEG_INF ? empty_l : fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d = lane + 32 * i;
      if (DV % 32 != 0 && d >= DV) continue;
      ob[qp * ostride + d] = acc[r][i] / lr;
    }
  }
}

}  // namespace cc

template <int HD, int DV = HD>
struct CudaCores {
  using Elem = float;
  static constexpr int BQ = cc::BQ;

  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, long B, long S, long T_len, long H,
                         long KH, int causal, long window, float softcap,
                         float scale, float empty_l, cudaStream_t stream) {
    const long nqt = (S + BQ - 1) / BQ;
    const long blocks = nqt * B * H;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    constexpr size_t smem = cc::Smem<HD, DV>::bytes;
    static bool configured = false;
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          cc::attend<HD, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      configured = true;
    }
    cc::attend<HD, DV><<<static_cast<unsigned>(blocks), cc::WARPS * 32, smem,
                         stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<int>(S), static_cast<int>(T_len), static_cast<int>(H),
        static_cast<int>(KH), static_cast<int>(nqt), causal,
        static_cast<int>(window), softcap, scale, empty_l);
    return cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// TensorCores: bfloat16 by wgmma on a TMA ring.
// ---------------------------------------------------------------------------

namespace tc {

constexpr uint32_t ROW_BYTES = 128;      // one swizzled box row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

// The shared memory a block may use (227 KB), less room for the barriers.
constexpr size_t SMEM_LIMIT = 232448 - 256;

template <int HD, int DV>
struct Shape {
  static constexpr int HDP = (HD + 63) / 64 * 64;   // whole 64-wide boxes
  static constexpr int DVP = (DV + 63) / 64 * 64;
  // Consumer groups of 64 query rows: three where a thread's registers
  // hold O (DVP / 2 of them) at 160 a thread, two (at 232) for wider value
  // rows.  q's width sets only the QK^T loop's length.
  static constexpr int GROUPS = DVP <= 128 ? 3 : 2;
  static constexpr int BQ = 64 * GROUPS;             // query rows per block
  static constexpr int THREADS = 128 * (GROUPS + 1);
  static constexpr int BOXES = HDP / 64;             // of a q or k row
  static constexpr int VBOXES = DVP / 64;            // of a v row
  static constexpr uint32_t Q_BOX = BQ * ROW_BYTES;
  static constexpr uint32_t KV_BOX = BK * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = BOXES * Q_BOX;
  static constexpr uint32_t K_BYTES = BOXES * KV_BOX;    // K of a tile
  static constexpr uint32_t V_BYTES = VBOXES * KV_BOX;   // V of a tile
  // The 128-byte swizzle repeats every 1,024 bytes, so every box starts on
  // a 1,024-byte boundary; the slack aligns the dynamic base.
  static constexpr size_t ring(int stages) {
    return 1024 + Q_BYTES + static_cast<size_t>(stages) * (K_BYTES + V_BYTES);
  }
  static constexpr int STAGES = ring(3) <= SMEM_LIMIT ? 3 : 2;
  static constexpr size_t SMEM = ring(STAGES);
  static_assert(SMEM <= SMEM_LIMIT, "q and a two-stage ring fit a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait until the barrier's phase of this parity has completed.  A wait
// that lasts seconds means a lost arrival: trap rather than hang the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 33)) __trap();
  }
}

// One box of a rank-4 tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff)
       | static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32
       | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// S = Q K^T for one warpgroup's 64 rows against a tile of 64 keys.  Both
// operands are K-major boxes of 64 columns: the k-th 16 columns of a row
// sit 32 k bytes into its 128-byte box row (the swizzle is applied to the
// address), 8-row groups 1,024 bytes apart.
template <typename W, int HD, int DV>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t qa,
                                         uint32_t kt) {
  using SH = Shape<HD, DV>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    W::qk(sc, desc(qa + (kk / 4) * SH::Q_BOX + off, 16, 1024),
          desc(kt + (kk / 4) * SH::KV_BOX + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V: P from registers; V's rows are keys, its 64-wide boxes of value
// dimensions KV_BOX apart (the leading offset), 8-key groups 1,024 bytes
// apart.
template <typename W, int DVP>
__device__ __forceinline__ void issue_pv(float (&o)[DVP / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t vt) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    W::pv(o, pa[kk], desc(vt + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
  wgmma_commit();
}

// The online softmax of a lane's two rows, in log2 units: a score s
// becomes s log2(e), so p = 2^(x - m) and alpha = 2^(m_old - m_new).
// Register 4 j + 2 e + t of a tile holds row row[e], key k0 + 8 j + col + t.
struct Softmax {
  int row[2], col, lo[2], hi[2];         // a row keeps keys lo .. hi
  bool cap;
  float lin, exp_k, cap2, neg2cap2;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  __device__ Softmax(int r0, int c, int T, int causal, int window,
                     float softcap, float scale)
      : row{r0, r0 + 8}, col(c), cap(softcap != 0.f), lin(scale * LOG2E),
        exp_k(cap ? 2.f * LOG2E * scale / softcap : 0.f),
        cap2(softcap * LOG2E), neg2cap2(-2.f * softcap * LOG2E) {
    for (int e = 0; e < 2; ++e) {
      lo[e] = window ? row[e] - window + 1 : -(1 << 30);
      hi[e] = causal ? min(T - 1, row[e]) : T - 1;
    }
  }

  // Scores (f32 products) to p in place; alpha per row.
  __device__ __forceinline__ void tile(float (&sc)[32], int k0, bool mask,
                                       float (&alpha)[2]) {
    if (cap) {
      // softcap tanh(u) = softcap (1 - 2 / (e^(2 u) + 1)).
#pragma unroll
      for (int r = 0; r < 32; ++r)
        sc[r] = fmaf(neg2cap2, rcp(ex2(sc[r] * exp_k) + 1.f), cap2);
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] *= lin;
    }
    if (mask) {
      // Key k0 + col + c of register 4 j + 2 e + t has c = 8 j + t.
      const int lo0 = lo[0] - k0 - col, hi0 = hi[0] - k0 - col;
      const int lo1 = lo[1] - k0 - col, hi1 = hi[1] - k0 - col;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int c = 8 * (r / 4) + r % 2;
        const bool keep = (r / 2) % 2 ? c >= lo1 && c <= hi1
                                      : c >= lo0 && c <= hi0;
        sc[r] = keep ? sc[r] : NEG_INF;
      }
    }
    // Row maxima and sums as trees, both rows at once: short chains.
    float mx[2][8], sum[2][8];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx[e][j] = fmaxf(sc[4 * j + 2 * e], sc[4 * j + 2 * e + 1]);
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < w; ++j) mx[e][j] = fmaxf(mx[e][j], mx[e][j + w]);
    float m_new[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = fmaxf(mx[e][0], __shfl_xor_sync(FULL_MASK, mx[e][0], 1));
      x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 2));
      m_new[e] = fmaxf(m[e], x);
      alpha[e] = ex2(m[e] - m_new[e]);
      m[e] = m_new[e];
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = ex2(sc[r] - m_new[(r / 2) % 2]);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum[e][j] = sc[4 * j + 2 * e] + sc[4 * j + 2 * e + 1];
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < w; ++j) sum[e][j] += sum[e][j + w];
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e][0];
  }
};

// p's bf16 A fragments: k-step kk covers keys 16 kk .. 16 kk + 15, which
// are the registers 8 kk .. 8 kk + 7 in the order the A operand takes them.
__device__ __forceinline__ void pack_p(const float (&p)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = pack_bf16(p[8 * kk + 2 * x], p[8 * kk + 2 * x + 1]);
}

// O *= alpha, per row; skipped, exactly, when no row of the warp has a
// new maximum.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
  if (!__any_sync(FULL_MASK, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// q: (B, S, H, HD), k: (B, T, KH, HD), v: (B, T, KH, DV) through the
// tensor maps; out: (B, S, H, DV).
template <int HD, int DV, typename W>
__global__ void __launch_bounds__(Shape<HD, DV>::THREADS, 1)
attend(const __grid_constant__ CUtensorMap qmap,
       const __grid_constant__ CUtensorMap kmap,
       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* out, int S,
       int T_len, int H, int KH, int nqt, int causal, int window,
       float softcap, float scale, float empty_l) {
  using SH = Shape<HD, DV>;
  constexpr int DVP = SH::DVP, STAGES = SH::STAGES;
  static_assert(W::N == DVP,
                "the unit's P . V wgmma spans the padded value row");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t skv = sq + SH::Q_BYTES;     // stage s: K, then V
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
  constexpr int BQ = SH::BQ;
  const int q0 = qt * BQ;
  const KvRange kv(q0, min(q0 + BQ, S) - 1, T_len, causal, window);
  const int tiles = (kv.end - kv.begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full_k(s), 1);
      bar_init(full_v(s), 1);
      bar_init(empty(s), SH::GROUPS);    // one arrival per consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == 0) {
    // Producer.
    if constexpr (SH::GROUPS == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      bar_expect(bar_q, SH::Q_BYTES);
      for (int j = 0; j < SH::BOXES; ++j)
        tma_load(sq + j * SH::Q_BOX, &qmap, bar_q, 64 * j, h, q0, b);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES, k0 = kv.begin + i * BK;
        bar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        bar_expect(full_k(s), SH::K_BYTES);
        for (int j = 0; j < SH::BOXES; ++j)
          tma_load(k_tile(s) + j * SH::KV_BOX, &kmap, full_k(s), 64 * j, kh,
                   k0, b);
        bar_expect(full_v(s), SH::V_BYTES);
        for (int j = 0; j < SH::VBOXES; ++j)
          tma_load(v_tile(s) + j * SH::KV_BOX, &vmap, full_v(s), 64 * j, kh,
                   k0, b);
      }
    }
  } else {
    // Consumers: group g owns query rows q0 + 64 (g - 1) .. + 63.
    if constexpr (SH::GROUPS == 3)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int rlo = q0 + 64 * (group - 1);
    Softmax sm(rlo + 16 * warp + lane / 4, 2 * (lane % 4), T_len, causal,
               window, softcap, scale);
    const uint32_t qa = sq + (group - 1) * 64 * ROW_BYTES;

    float o[DVP / 2];
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
    bar_wait(bar_q, 0);
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES, k0 = kv.begin + i * BK;
      const uint32_t parity = (i / STAGES) & 1;
      float sc[32], alpha[2];
      uint32_t pa[4][4];
      bar_wait(full_k(s), parity);
      issue_qk<W, HD, DV>(sc, qa, k_tile(s));
      wgmma_wait();
      fence_regs(sc);
      // Only tiles that hold a dropped key for one of the group's rows
      // are masked: the causal diagonal, the window's edge, the T tail.
      sm.tile(sc, k0, k0 + BK > T_len || (causal && k0 + BK - 1 > rlo) ||
                          (window && k0 <= rlo + 63 - window), alpha);
      pack_p(sc, pa);
      rescale(o, alpha);
      bar_wait(full_v(s), parity);
      issue_pv<W, DVP>(o, pa, v_tile(s));
      wgmma_wait();
      fence_regs(o);
      if (tid == 0) bar_arrive(empty(s));
    }

    // Epilogue: l summed over the quad; rows at or past S are not stored.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sum = sm.l[e];
      sum += __shfl_xor_sync(FULL_MASK, sum, 1);
      sum += __shfl_xor_sync(FULL_MASK, sum, 2);
      const float inv =
          1.f / (sm.m[e] == NEG_INF ? empty_l : fmaxf(sum, 1e-30f));
      if (sm.row[e] >= S) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<long>(b) * S + sm.row[e]) * H + h) * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + sm.col) =
            pack_bf16(o[4 * j + 2 * e] * inv, o[4 * j + 2 * e + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime, so that the unit
// links no libcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The map of a contiguous (B, length, heads, HD) bf16 array, in boxes of
// (64, 1, rows, 1).
inline bool encode(CUtensorMap* map, const void* p, long B, long len,
                   long heads, int hd, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * hd;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * len};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

template <int HD, typename W, int DV = HD>
struct TensorCores {
  using Elem = __nv_bfloat16;
  using SH = tc::Shape<HD, DV>;
  static constexpr int BQ = SH::BQ;

  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, long B, long S, long T_len, long H,
                         long KH, int causal, long window, float softcap,
                         float scale, float empty_l, cudaStream_t stream) {
    const long nqt = (S + BQ - 1) / BQ;
    const long blocks = nqt * B * H;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    CUtensorMap qmap, kmap, vmap;
    if (!tc::encode(&qmap, q, B, S, H, HD, BQ) ||
        !tc::encode(&kmap, k, B, T_len, KH, HD, BK) ||
        !tc::encode(&vmap, v, B, T_len, KH, DV, BK))
      return cudaErrorInvalidValue;
    constexpr size_t smem = SH::SMEM;
    static bool configured = false;
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          tc::attend<HD, DV, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      configured = true;
    }
    tc::attend<HD, DV, W><<<static_cast<unsigned>(blocks), SH::THREADS, smem,
                            stream>>>(
        qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
        static_cast<int>(S), static_cast<int>(T_len), static_cast<int>(H),
        static_cast<int>(KH), static_cast<int>(nqt), causal,
        static_cast<int>(window), softcap, scale, empty_l);
    return cudaGetLastError();
  }
};

// The checks both bodies share, then the body.
template <typename Body, int HD, int DV = HD>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                long B, long S, long T_len, long H, long KH, int causal,
                long window, float softcap, float scale, float empty_l,
                cudaStream_t stream) {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256, "head_dim");
  static_assert(DV % 16 == 0 && DV >= 16 && DV <= HD, "v_head_dim");
  if (B < 1 || S < 1 || T_len < 1 || KH < 1 || H % KH != 0 ||
      S > INT_MAX || T_len > INT_MAX || window < 0 || window > INT_MAX)
    return cudaErrorInvalidValue;
  return Body::run(q, k, v, out, B, S, T_len, H, KH, causal, window, softcap,
                   scale, empty_l, stream);
}

}  // namespace
}  // namespace flash
}  // namespace rt
