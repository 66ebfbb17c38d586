// Leaf helpers, leaf pointers and block-level building blocks shared by the
// hand-written Hopper kernels of repro_torch (sm_90a).
//
// The kernels are templates over a generated element type and functor
// (kernels/_lib.py writes them from each operator's and map's device form):
//
//   struct E {                        // one element: leaves v0 .. v(k-1)
//     using T0 = float; ...           // leaf types: float, double, int,
//     T0 v0; ...                      //   unsigned char, signed char
//     static constexpr int LEAVES, WIDEST, BYTES[LEAVES];  // leaf sizes
//     static E load(const rt::Leaves&, long i);
//     template <int W>                // W elements a leaf, one load each
//     static void load_vec(const rt::Leaves&, long i, E (&e)[W]);
//     void store(const rt::Leaves&, long i) const;  // skips null leaves
//     static E shfl_up(E, int d);  static E shfl_down(E, int d, int width);
//     static E shfl_xor(E, int m);
//   };
//   struct Op  { using E = ...; static constexpr bool COMMUTATIVE;
//                static E identity(); static E combine(const E&, const E&); };
//   struct Map { using In = ...; using Out = ...;
//                static Out apply(const In&); };
//
// Every combine keeps operand order (earlier on the left), because many
// operators (AFFINE, QUATERNION_MUL, the segmented lift) do not commute.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace rt {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_LEAVES = 5;

// One pointer per leaf of an element (unused ones null): leaves live in
// separate arrays, as the pytree's leaves do.
struct Leaves {
  void* p[MAX_LEAVES];
};

inline Leaves leaves(void* const* p) {
  Leaves l;
  for (int k = 0; k < MAX_LEAVES; ++k) l.p[k] = p[k];
  return l;
}

// ---------------------------------------------------------------------------
// Limits (identities of MAX / MIN / LOGSUMEXP).
// ---------------------------------------------------------------------------

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static float lowest() { return -__int_as_float(0x7f800000); }
  __device__ static float highest() { return __int_as_float(0x7f800000); }
};
template <> struct Lim<double> {
  __device__ static double lowest() {
    return -__longlong_as_double(0x7ff0000000000000LL);
  }
  __device__ static double highest() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};
template <> struct Lim<int> {
  __device__ static int lowest() { return INT_MIN; }
  __device__ static int highest() { return INT_MAX; }
};
template <> struct Lim<unsigned char> {
  __device__ static unsigned char lowest() { return 0; }
  __device__ static unsigned char highest() { return 255; }
};
template <> struct Lim<signed char> {
  __device__ static signed char lowest() { return -128; }
  __device__ static signed char highest() { return 127; }
};

// ---------------------------------------------------------------------------
// Leaf arithmetic.  Integer add and mul wrap like torch's integer arithmetic
// (the unsigned detour keeps the overflow defined); float max and min
// propagate NaN like torch.maximum / torch.minimum.  The *_rn forms round
// each operation on its own, so the compiler never fuses a product into a
// following sum (torch rounds them apart).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ unsigned char add(unsigned char a, unsigned char b) {
  return static_cast<unsigned char>(a + b);
}
__device__ __forceinline__ signed char add(signed char a, signed char b) {
  return static_cast<signed char>(static_cast<unsigned char>(a + b));
}

__device__ __forceinline__ float mul(float a, float b) { return a * b; }
__device__ __forceinline__ double mul(double a, double b) { return a * b; }
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ unsigned char mul(unsigned char a, unsigned char b) {
  return static_cast<unsigned char>(a * b);
}
__device__ __forceinline__ signed char mul(signed char a, signed char b) {
  return static_cast<signed char>(static_cast<unsigned char>(a * b));
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ int add_rn(int a, int b) { return add(a, b); }
__device__ __forceinline__ unsigned char add_rn(unsigned char a, unsigned char b) {
  return add(a, b);
}
__device__ __forceinline__ signed char add_rn(signed char a, signed char b) {
  return add(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ int mul_rn(int a, int b) { return mul(a, b); }
__device__ __forceinline__ unsigned char mul_rn(unsigned char a, unsigned char b) {
  return mul(a, b);
}
__device__ __forceinline__ signed char mul_rn(signed char a, signed char b) {
  return mul(a, b);
}

template <typename T>
__device__ __forceinline__ T max(T a, T b) {
  return (a != a || a > b) ? a : b;  // a NaN on either side wins
}
template <typename T>
__device__ __forceinline__ T min(T a, T b) {
  return (a != a || a < b) ? a : b;
}

template <typename T>
__device__ __forceinline__ bool is_neg_inf(T v) {
  return v == Lim<T>::lowest();
}

__device__ __forceinline__ float exp(float v) { return expf(v); }
__device__ __forceinline__ double exp(double v) { return ::exp(v); }

// jnp.logaddexp: max + log1p(exp(-|a - b|)), and a + b where a - b is NaN,
// which makes logaddexp(-inf, -inf) = -inf and (inf, inf) = inf.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = a - b;
  if (d != d) return a + b;
  return max(a, b) + log1pf(expf(-fabsf(d)));
}
__device__ __forceinline__ double logaddexp(double a, double b) {
  const double d = a - b;
  if (d != d) return a + b;
  return max(a, b) + log1p(::exp(-fabs(d)));
}

// ---------------------------------------------------------------------------
// Warp shuffles of one leaf (the generated elements shuffle leaf by leaf).
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T shfl_up_leaf(T v, int d) {
  return __shfl_up_sync(FULL_MASK, v, d);
}
template <>
__device__ __forceinline__ unsigned char shfl_up_leaf(unsigned char v, int d) {
  return static_cast<unsigned char>(
      __shfl_up_sync(FULL_MASK, static_cast<int>(v), d));
}
template <>
__device__ __forceinline__ signed char shfl_up_leaf(signed char v, int d) {
  return static_cast<signed char>(
      __shfl_up_sync(FULL_MASK, static_cast<int>(v), d));
}
template <typename T>
__device__ __forceinline__ T shfl_down_leaf(T v, int d, int width) {
  return __shfl_down_sync(FULL_MASK, v, d, width);
}
template <>
__device__ __forceinline__ unsigned char shfl_down_leaf(unsigned char v, int d,
                                                        int width) {
  return static_cast<unsigned char>(
      __shfl_down_sync(FULL_MASK, static_cast<int>(v), d, width));
}
template <>
__device__ __forceinline__ signed char shfl_down_leaf(signed char v, int d,
                                                      int width) {
  return static_cast<signed char>(
      __shfl_down_sync(FULL_MASK, static_cast<int>(v), d, width));
}

template <typename T>
__device__ __forceinline__ T shfl_xor_leaf(T v, int m) {
  return __shfl_xor_sync(FULL_MASK, v, m);
}
template <>
__device__ __forceinline__ unsigned char shfl_xor_leaf(unsigned char v,
                                                       int m) {
  return static_cast<unsigned char>(
      __shfl_xor_sync(FULL_MASK, static_cast<int>(v), m));
}
template <>
__device__ __forceinline__ signed char shfl_xor_leaf(signed char v, int m) {
  return static_cast<signed char>(
      __shfl_xor_sync(FULL_MASK, static_cast<int>(v), m));
}

// An element read through L2 only (ld.global.cg), never from a stale L1
// line: for values another block wrote during this launch.
template <typename E>
__device__ E load_cg(const E* p) {
  E v;
  if constexpr (sizeof(E) % 4 == 0) {
    const unsigned* src = reinterpret_cast<const unsigned*>(p);
    unsigned* dst = reinterpret_cast<unsigned*>(&v);
    for (unsigned w = 0; w < sizeof(E) / 4; ++w) dst[w] = __ldcg(src + w);
  } else {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(p);
    unsigned char* dst = reinterpret_cast<unsigned char*>(&v);
    for (unsigned w = 0; w < sizeof(E); ++w) dst[w] = __ldcg(src + w);
  }
  return v;
}

// W adjacent elements of one leaf, read in one load of W sizeof(T) bytes
// (at most 16, the address a multiple of that): the generated elements'
// load_vec, K7m's loads.
template <typename T, int W>
struct alignas(sizeof(T) * W) LeafVec {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ LeafVec<T, W> load_leaf(const void* p, long i) {
  static_assert(sizeof(T) * W <= 16, "a load holds at most 16 bytes");
  return *reinterpret_cast<const LeafVec<T, W>*>(static_cast<const T*>(p) + i);
}

// ---------------------------------------------------------------------------
// Commutative block reduction: warp shuffle tree, then the warp totals
// through shared memory.  Every thread of the block must call it; thread 0
// gets the result.  `warp_smem` holds THREADS / 32 elements.
// ---------------------------------------------------------------------------

template <typename Op, int THREADS>
__device__ typename Op::E block_reduce_commutative(typename Op::E v,
                                                   typename Op::E* warp_smem) {
  using E = typename Op::E;
  static_assert(THREADS % 32 == 0, "whole warps");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = Op::combine(v, E::shfl_down(v, d, 32));
  if (lane == 0) warp_smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_smem[lane] : Op::identity();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = Op::combine(v, E::shfl_down(v, d, 32));
  }
  return v;
}

}  // namespace rt
