// The gradient of linear_recurrence, h_t = a_t h_{t-1} + b_t along axis 1
// of (B, T, C) leaves (h_{-1} = h0, or 0), in one kernel (three on the
// long-T form): given a, the forward's h, dh and h0, it writes
//   db_t = g_t,  g_t = dh_t + a_{t+1} g_{t+1}  (a_T taken as 0),
//   da_t = g_t h_{t-1},  dh0 = a_0 g_0  (when h0 is given).
// A `reverse` recurrence (h_t = a_t h_{t+1} + b_t) mirrors all of it along
// T.  Nothing else is materialized: a_{t+1} is loaded at its shifted index
// and h_{t-1} (h0, or 0, at the edge) in the store epilogue, so neither a
// shifted a nor a shifted h is built, and dh is read in its own floating
// type (float, double, bfloat16 or half; kernels/_lib.py: LINREC_CTYPES),
// so no cast pass runs.  Leaves a, h, h0, da, db, dh0: float or double, one
// type.  No atomics: two calls give the same bits.
//
// Replaces: src/repro/kernels/scan.py::scan_channel_pallas (K6 here) in
// the backward pass of linear_recurrence, and no Pallas kernel of its own:
// the reference defines no backward kernel, jax.grad differentiates the
// scan with XLA.  The port's backward ran K6 in reverse over a shifted a
// and a cast dh, built by two torch.cat and a cast, then the products as
// tensor ops; this kernel is all of it.
//
// Bound on this card: bytes.  Five tensors of B T C elements (a, h, dh
// read, da and db written once), 20 B T C bytes in float32 -- 0.0626 ms at
// the RG-LRU's (1, 4096, 2560), 0.40 ms at xLSTM's (1, 16, 4,194,304) on
// 3.35 TB/s -- and next to no arithmetic (three operations a step).  So
// each form reads every element once and writes it once, coalesced across
// neighbouring channels, and keeps enough loads in flight to cover the
// memory's latency.  The adjoint walks the steps in the order opposite to
// the forward's ("walk step" s below: s = 0 is t = T - 1, or t = 0 for a
// reverse recurrence).  The forms, chosen on the host (kernels/scan.py:
// linrec_grad_form; each size below won against its neighbours, timed on
// the H100):
//   - short T (T <= 64, xLSTM's chunk states): a thread owns one (b, c)
//     and walks T, the loads of each group of GROUP = 2 steps issued
//     before their arithmetic, the steps associated in runs of 8 as K6's
//     channel tiles associate them (walk, below).  Neighbouring threads own
//     neighbouring channels, so every load and store coalesces, and no scan
//     crosses threads: at T = 16 a channel-tile block keeps 2 of its 32
//     runs busy.  The small group keeps a float thread at 32 registers,
//     so 8 blocks of 256 fit an SM and the card's latency is covered by
//     threads, not by a thread's own loads.
//   - channel tiles (the RG-LRU's T in the thousands): K6's channel-tile
//     route (scan.cuh: scan_channel_tiles) walking in the adjoint's order.
//     A block of 512 threads owns b and 16 channels; a chunk is 32 runs of
//     16 bytes of steps (4 in float, 2 in double), each run in registers,
//     the 32 run totals of a channel scanned by one warp, the carry in
//     shared memory, the next chunk's loads (the shifted a and dh) in
//     flight while this one is scanned, this chunk's h loaded at its start
//     for the epilogue, where the products and the stores run.  Runs of 16
//     bytes keep a thread within 64 registers, unspilled, for two blocks
//     an SM.
//   - long T, few channels (B C <= 1024 and T >= 128, where K6 takes its
//     long-T path): that path's three phases on the shifted pair -- each
//     thread folds a chunk of CHUNK = 32 steps, tile_scan.cuh's
//     scan_totals scans the chunk totals of each (b, c), each thread walks
//     its chunk again from its carry with the products fused into the
//     walk, as the short form walks.  It reads a and dh twice: the price
//     of spreading T over the card.
// Each form reassociates (runs, then the carry), so each differs from the
// plain version's serial walk by rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "tile_scan.cuh"

namespace rt {
namespace linrec_grad {
namespace {

// A walk step's adjoint map x -> a x + g: AFFINE's element.  Composing p,
// then q, gives (q.a p.a, q.a p.g + q.g), each operation rounded alone.
template <typename L> struct Adj {
  L a, g;
  __device__ static Adj shfl_up(Adj v, int d) {
    return {__shfl_up_sync(FULL_MASK, v.a, d),
            __shfl_up_sync(FULL_MASK, v.g, d)};
  }
};

template <typename L> struct AdjOp {
  using E = Adj<L>;
  __device__ static E identity() { return {L(1), L(0)}; }
  __device__ static E combine(const E& p, const E& q) {
    return {mul_rn(q.a, p.a), add_rn(mul_rn(q.a, p.g), q.g)};
  }
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// dh at i in the leaves' type (rounded to nearest, as torch's cast).
template <typename L, typename G>
__device__ __forceinline__ L grad_at(const G* __restrict__ dh, long i) {
  return static_cast<L>(widen(dh[i]));
}

enum Form { SHORT = 0, TILES = 1, LONG = 2 };

constexpr int SHORT_THREADS = 256;
constexpr int GROUP = 2;                 // steps a short-T load group
constexpr int RUN = 8;                   // steps K6's runs associate
constexpr int CT = 16;                   // channels a channel-tile block
constexpr int CT_THREADS = 512;
constexpr int RUNS = CT_THREADS / CT;    // runs of each channel a chunk: 32
static_assert(RUNS == 32 && CT_THREADS / 32 == CT,
              "one warp scans one channel's run totals");
template <typename L> struct Run {       // steps a run: 16 bytes of leaves
  static constexpr int STEPS = 16 / sizeof(L);
};
constexpr int LONG_THREADS = 128;
constexpr long CHUNK = 32;               // steps a long-T thread walks
static_assert(CHUNK % RUN == 0, "a long-T chunk starts a run");
constexpr int LONG_GROUP = 8;            // steps a long-T load group

// The pointers of one call.  Walk step s of channel (b, c) is element
// first + s * step: first is its t = T - 1 (t = 0 when reverse), step -C
// (+C).
template <typename L, typename G> struct Ptrs {
  const L* __restrict__ a;
  const L* __restrict__ h;
  const G* __restrict__ dh;
  const L* __restrict__ h0;
  L* __restrict__ da;
  L* __restrict__ db;
  L* __restrict__ dh0;
};

// Walk steps [s0, s1) of one channel (s0 a multiple of RUN) from adjoint g
// and the a of the step before s0 (0 before the first), each group of N
// steps' loads (a, dh and the epilogue's h) issued before any of its
// arithmetic; db and da stored.  `start`: h0, or 0, past the walk's last
// step.  The steps associate as K6's channel tiles do (scan.cuh: runs of
// RUN steps): a run's maps compose from the identity and each step's
// adjoint is that composition applied to the adjoint before the run.  So
// at T <= 2 RUN (xLSTM's chunk states at 1,024 tokens: T = 16) the walk
// gives the bits of the backward the port ran before this kernel (a
// reverse K6 launch), and the train steps' gradients stay as they were.
template <int N, typename L, typename G>
__device__ __forceinline__ void walk(const Ptrs<L, G>& p, long first,
                                     long step, long s0, long s1, long T,
                                     L start, L& g, L& a_prev) {
  L run_a = L(1), run_g = L(0), carry = g;
  for (; s0 < s1; s0 += N) {
    L av[N], dv[N], hv[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long s = s0 + j, i = first + s * step;
      if (s < s1) {
        av[j] = p.a[i];
        dv[j] = grad_at<L>(p.dh, i);
        hv[j] = s + 1 < T ? p.h[i + step] : start;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long s = s0 + j, i = first + s * step;
      if (s >= s1) break;
      if (s % RUN == 0) {
        run_a = L(1);
        run_g = L(0);
        carry = g;
      }
      run_a = mul_rn(a_prev, run_a);
      run_g = add_rn(mul_rn(a_prev, run_g), dv[j]);
      g = add_rn(mul_rn(run_a, carry), run_g);
      p.db[i] = g;
      p.da[i] = mul_rn(g, hv[j]);
      a_prev = av[j];
    }
  }
}

// Short T: grid cdiv(B C, SHORT_THREADS), a thread per (b, c).
template <typename L, typename G>
__global__ void __launch_bounds__(SHORT_THREADS, 8)
short_t(Ptrs<L, G> p, long T, long C, long BC, bool reverse) {
  const long idx = static_cast<long>(blockIdx.x) * SHORT_THREADS + threadIdx.x;
  if (idx >= BC) return;
  const long b = idx / C;
  const long row = b * T * C + (idx - b * C);
  const long step = reverse ? C : -C;
  const long first = reverse ? row : row + (T - 1) * C;
  const L start = p.h0 ? p.h0[idx] : L(0);
  L g = L(0), a_prev = L(0);   // the map before the first step is (0, 0)
  walk<GROUP>(p, first, step, 0, T, T, start, g, a_prev);
  if (p.dh0) p.dh0[idx] = mul_rn(a_prev, g);
}

// Channel tiles: grid (cdiv(C, CT), B).
template <typename L, typename G>
__global__ void __launch_bounds__(CT_THREADS, 2)
tiles(Ptrs<L, G> p, long T, long C, bool reverse) {
  using Op = AdjOp<L>;
  using E = Adj<L>;
  constexpr int R = Run<L>::STEPS;
  constexpr long CHUNK_STEPS = static_cast<long>(RUNS) * R;
  __shared__ E run_prefix[RUNS][CT + 1];    // padded: one bank a lane
  __shared__ E carry[CT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ci = lane % CT;
  const int run = warp * (32 / CT) + lane / CT;
  const long c = static_cast<long>(blockIdx.x) * CT + ci;
  const bool live = c < C;
  const long row = static_cast<long>(blockIdx.y) * T * C + c;
  const long step = reverse ? C : -C;
  const long first = reverse ? row : row + (T - 1) * C;
  const long chunks = (T + CHUNK_STEPS - 1) / CHUNK_STEPS;
  const long edge = static_cast<long>(blockIdx.y) * C + c;   // (b, c) of h0
  const L start = live && p.h0 ? p.h0[edge] : L(0);
  if (threadIdx.x < CT) carry[threadIdx.x] = Op::identity();
  // Walk step s's map: a at walk step s - 1 (none before the first), dh at
  // s.
  auto load_run = [&](E (&v)[R], long k) {
    const long s0 = k * CHUNK_STEPS + static_cast<long>(run) * R;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long s = s0 + j, i = first + s * step;
      if (live && s < T) {
        v[j].a = s > 0 ? p.a[i - step] : L(0);
        v[j].g = grad_at<L>(p.dh, i);
      } else {
        v[j] = Op::identity();
      }
    }
  };
  // The epilogue's h at the next walk step.
  auto load_h = [&](L (&hv)[R], long k) {
    const long s0 = k * CHUNK_STEPS + static_cast<long>(run) * R;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long s = s0 + j;
      hv[j] = live && s + 1 < T ? p.h[first + (s + 1) * step] : start;
    }
  };
  E cur[R], next[R];
  load_run(cur, 0);
  for (long k = 0; k < chunks; ++k) {
    const long s0 = k * CHUNK_STEPS + static_cast<long>(run) * R;
    L hv[R];
    load_h(hv, k);
    if (k + 1 < chunks) load_run(next, k + 1);
    // 1. The run's inclusive scan, in registers.
#pragma unroll
    for (int j = 1; j < R; ++j) cur[j] = Op::combine(cur[j - 1], cur[j]);
    run_prefix[run][ci] = cur[R - 1];
    __syncthreads();
    // 2. Warp w scans channel w's run totals in run order, the carry on the
    //    left; lane 31's inclusive total is the next chunk's carry.
    {
      E v = run_prefix[lane][warp];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const E earlier = E::shfl_up(v, d);
        if (lane >= d) v = Op::combine(earlier, v);
      }
      E before = E::shfl_up(v, 1);
      if (lane == 0) before = Op::identity();
      const E in = carry[warp];
      __syncwarp();
      run_prefix[lane][warp] = Op::combine(in, before);
      if (lane == 31) carry[warp] = Op::combine(in, v);
    }
    __syncthreads();
    // 3. The epilogue: g, then db, da and, at the last step, dh0.
    const E pre = run_prefix[run][ci];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long s = s0 + j, i = first + s * step;
      if (!live || s >= T) break;
      const L g = Op::combine(pre, cur[j]).g;
      p.db[i] = g;
      p.da[i] = mul_rn(g, hv[j]);
      if (s == T - 1 && p.dh0) p.dh0[edge] = mul_rn(p.a[i], g);
    }
    __syncthreads();   // run_prefix is written again by the next chunk
#pragma unroll
    for (int j = 0; j < R; ++j) cur[j] = next[j];
  }
}

// Long T, phase 1: the map of chunk k of channel (b, c), in walk order.
// Thread index over (chunk, c) within row b = blockIdx.y, c fastest.
template <typename L, typename G>
__global__ void __launch_bounds__(LONG_THREADS)
long_aggregates(Ptrs<L, G> p, long T, long C, long nchunks, bool reverse,
                Adj<L>* agg) {
  using Op = AdjOp<L>;
  const long idx = static_cast<long>(blockIdx.x) * LONG_THREADS + threadIdx.x;
  if (idx >= nchunks * C) return;
  const long k = idx / C, c = idx - k * C;
  const long b = blockIdx.y;
  const long row = b * T * C + c;
  const long step = reverse ? C : -C;
  const long first = reverse ? row : row + (T - 1) * C;
  const long s1 = (k + 1) * CHUNK < T ? (k + 1) * CHUNK : T;
  long s = k * CHUNK;
  L a_prev = s > 0 ? p.a[first + (s - 1) * step] : L(0);
  Adj<L> acc = Op::identity();
#pragma unroll 8
  for (; s < s1; ++s) {
    const long i = first + s * step;
    acc = Op::combine(acc, Adj<L>{a_prev, grad_at<L>(p.dh, i)});
    a_prev = p.a[i];
  }
  agg[(b * C + c) * nchunks + k] = acc;
}

// Long T, phase 3: walk chunk k again from its carry (the exclusive prefix
// of the chunks before it, left in agg by phase 2): g before the chunk is
// the carry's g (the map applied to the zero adjoint past the end).
template <typename L, typename G>
__global__ void __launch_bounds__(LONG_THREADS)
long_rescan(Ptrs<L, G> p, long T, long C, long nchunks, bool reverse,
            const Adj<L>* agg) {
  const long idx = static_cast<long>(blockIdx.x) * LONG_THREADS + threadIdx.x;
  if (idx >= nchunks * C) return;
  const long k = idx / C, c = idx - k * C;
  const long b = blockIdx.y;
  const long row = b * T * C + c;
  const long step = reverse ? C : -C;
  const long first = reverse ? row : row + (T - 1) * C;
  const long s0 = k * CHUNK;
  const long s1 = s0 + CHUNK < T ? s0 + CHUNK : T;
  const L start = p.h0 ? p.h0[b * C + c] : L(0);
  L a_prev = s0 > 0 ? p.a[first + (s0 - 1) * step] : L(0);
  L g = agg[(b * C + c) * nchunks + k].g;
  walk<LONG_GROUP>(p, first, step, s0, s1, T, start, g, a_prev);
  if (s1 == T && p.dh0) p.dh0[b * C + c] = mul_rn(a_prev, g);
}

// The bytes of the long-T form's scratch: B C cdiv(T, CHUNK) maps.
template <typename L> long scratch_bytes(long B, long T, long C) {
  return B * C * ((T + CHUNK - 1) / CHUNK) * static_cast<long>(sizeof(Adj<L>));
}

// The whole gradient.  a, h, dh, da, db: (B, T, C), h0 and dh0: (B, C) or
// both null, contiguous.  `form`: Form, the host's choice.  The long-T form
// takes `scratch` of `scratch_len` bytes, at least scratch_bytes<L>.
template <typename L, typename G>
cudaError_t run(const void* a, const void* h, const void* dh, const void* h0,
                void* da, void* db, void* dh0, void* scratch, long scratch_len,
                long B, long T, long C, bool reverse, int form,
                cudaStream_t stream) {
  if (B <= 0 || T <= 0 || C <= 0 || (h0 == nullptr) != (dh0 == nullptr))
    return cudaErrorInvalidValue;
  const Ptrs<L, G> p{static_cast<const L*>(a), static_cast<const L*>(h),
                     static_cast<const G*>(dh), static_cast<const L*>(h0),
                     static_cast<L*>(da), static_cast<L*>(db),
                     static_cast<L*>(dh0)};
  switch (form) {
    case SHORT: {
      const long blocks = (B * C + SHORT_THREADS - 1) / SHORT_THREADS;
      if (blocks > INT_MAX) return cudaErrorInvalidValue;
      short_t<L, G><<<static_cast<unsigned>(blocks), SHORT_THREADS, 0,
                      stream>>>(p, T, C, B * C, reverse);
      break;
    }
    case TILES: {
      if (B > 65535) return cudaErrorInvalidValue;
      const dim3 grid(static_cast<unsigned>((C + CT - 1) / CT),
                      static_cast<unsigned>(B));
      tiles<L, G><<<grid, CT_THREADS, 0, stream>>>(p, T, C, reverse);
      break;
    }
    case LONG: {
      if (B * C > 65535 || scratch == nullptr ||
          scratch_len < scratch_bytes<L>(B, T, C))
        return cudaErrorInvalidValue;
      const long nchunks = (T + CHUNK - 1) / CHUNK;
      Adj<L>* agg = static_cast<Adj<L>*>(scratch);
      const long blocks = (nchunks * C + LONG_THREADS - 1) / LONG_THREADS;
      const dim3 grid(static_cast<unsigned>(blocks),
                      static_cast<unsigned>(B));
      long_aggregates<L, G><<<grid, LONG_THREADS, 0, stream>>>(
          p, T, C, nchunks, reverse, agg);
      tile::scan_totals<AdjOp<L>, 8>
          <<<dim3(1, static_cast<unsigned>(B * C)), tile::THREADS, 0,
             stream>>>(agg, nchunks);
      long_rescan<L, G><<<grid, LONG_THREADS, 0, stream>>>(
          p, T, C, nchunks, reverse, agg);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace linrec_grad
}  // namespace rt
