// Device operator functors, element I/O and block-level building blocks shared
// by the hand-written Hopper kernels of repro_torch (sm_90a).
//
// An operator is a functor with `identity()` and `combine(earlier, later)`.
// Every combine keeps operand order, because AFFINE does not commute.  The
// element types are float, int32 and the (a, b) float pair of AFFINE; a pair
// lives in two separate arrays (one per pytree leaf) and is loaded and stored
// through `Io<Pair>`.
//
// The op and dtype codes below must match `OP_CODES` / `DTYPE_CODES` in
// repro_torch/kernels/_lib.py.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace rt {

enum OpCode { OP_ADD = 0, OP_MUL = 1, OP_MAX = 2, OP_MIN = 3, OP_AFFINE = 4 };
enum DType { DT_F32 = 0, DT_I32 = 1 };
enum MapCode { MAP_IDENTITY = 0, MAP_MASKED = 1, MAP_TIMES = 2 };

constexpr unsigned FULL_MASK = 0xffffffffu;

struct Pair {
  float a, b;
};

// ---------------------------------------------------------------------------
// Limits (identity of MAX / MIN).
// ---------------------------------------------------------------------------

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static float lowest() { return -__int_as_float(0x7f800000); }
  __device__ static float highest() { return __int_as_float(0x7f800000); }
};
template <> struct Lim<int> {
  __device__ static int lowest() { return INT_MIN; }
  __device__ static int highest() { return INT_MAX; }
};

// ---------------------------------------------------------------------------
// Operators.  Integer add and mul wrap like torch's int32 arithmetic (the
// unsigned detour keeps the overflow defined); float max and min propagate
// NaN like torch.maximum / torch.minimum.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

template <typename T> struct Add {
  __device__ static T identity() { return T(0); }
  __device__ static T combine(T x, T y) { return x + y; }
};
template <> struct Add<int> {
  __device__ static int identity() { return 0; }
  __device__ static int combine(int x, int y) { return wrap_add(x, y); }
};

template <typename T> struct Mul {
  __device__ static T identity() { return T(1); }
  __device__ static T combine(T x, T y) { return x * y; }
};
template <> struct Mul<int> {
  __device__ static int identity() { return 1; }
  __device__ static int combine(int x, int y) { return wrap_mul(x, y); }
};

template <typename T> struct Max {
  __device__ static T identity() { return Lim<T>::lowest(); }
  __device__ static T combine(T x, T y) { return x > y ? x : y; }
};
template <> struct Max<float> {
  __device__ static float identity() { return Lim<float>::lowest(); }
  __device__ static float combine(float x, float y) {
    return (x != x || x > y) ? x : y;
  }
};

template <typename T> struct Min {
  __device__ static T identity() { return Lim<T>::highest(); }
  __device__ static T combine(T x, T y) { return x < y ? x : y; }
};
template <> struct Min<float> {
  __device__ static float identity() { return Lim<float>::highest(); }
  __device__ static float combine(float x, float y) {
    return (x != x || x < y) ? x : y;
  }
};

// x -> a x + b; combine(p, q) applies p first, then q:
// (q.a * p.a, q.a * p.b + q.b), as core/operators.py::_affine_combine.
struct Affine {
  __device__ static Pair identity() { return Pair{1.0f, 0.0f}; }
  __device__ static Pair combine(Pair p, Pair q) {
    return Pair{__fmul_rn(q.a, p.a), __fadd_rn(__fmul_rn(q.a, p.b), q.b)};
  }
};

// ---------------------------------------------------------------------------
// Warp shuffles for every element type.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float shfl_up(float v, int d) {
  return __shfl_up_sync(FULL_MASK, v, d);
}
__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(FULL_MASK, v, d);
}
__device__ __forceinline__ Pair shfl_up(Pair v, int d) {
  return Pair{__shfl_up_sync(FULL_MASK, v.a, d), __shfl_up_sync(FULL_MASK, v.b, d)};
}
__device__ __forceinline__ float shfl_down(float v, int d) {
  return __shfl_down_sync(FULL_MASK, v, d);
}
__device__ __forceinline__ int shfl_down(int v, int d) {
  return __shfl_down_sync(FULL_MASK, v, d);
}
__device__ __forceinline__ float shfl_down(float v, int d, int width) {
  return __shfl_down_sync(FULL_MASK, v, d, width);
}
__device__ __forceinline__ int shfl_down(int v, int d, int width) {
  return __shfl_down_sync(FULL_MASK, v, d, width);
}

// ---------------------------------------------------------------------------
// Element I/O: a scalar element is one array, a pair is two.
// ---------------------------------------------------------------------------

template <typename T> struct Io {
  __device__ static T load(const void* p0, const void*, long i) {
    return static_cast<const T*>(p0)[i];
  }
  __device__ static void store(void* p0, void*, long i, T v) {
    static_cast<T*>(p0)[i] = v;
  }
};
template <> struct Io<Pair> {
  __device__ static Pair load(const void* p0, const void* p1, long i) {
    return Pair{static_cast<const float*>(p0)[i], static_cast<const float*>(p1)[i]};
  }
  __device__ static void store(void* p0, void* p1, long i, Pair v) {
    static_cast<float*>(p0)[i] = v.a;
    static_cast<float*>(p1)[i] = v.b;
  }
};

// ---------------------------------------------------------------------------
// Commutative block reduction: warp shuffle tree, then the warp totals
// through shared memory.  Every thread of the block must call it; thread 0
// gets the result.  `warp_smem` holds THREADS / 32 elements.
// ---------------------------------------------------------------------------

template <typename T, typename Op, int THREADS>
__device__ T block_reduce_commutative(T v, T* warp_smem) {
  static_assert(THREADS % 32 == 0, "whole warps");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = Op::combine(v, shfl_down(v, d));
  if (lane == 0) warp_smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_smem[lane] : Op::identity();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = Op::combine(v, shfl_down(v, d));
  }
  return v;
}

// ---------------------------------------------------------------------------
// Op / dtype dispatch for the C entry points: expands the body with `T` and `OP`
// (the variadic body) bound to the element type and functor.  Unknown pairs return
// cudaErrorInvalidValue, which the Python wrapper raises on.
// ---------------------------------------------------------------------------

#define RT_DISPATCH_COMMUTATIVE(op, dtype, ...)                            \
  do {                                                                      \
    if ((dtype) == rt::DT_F32) {                                            \
      using T = float;                                                      \
      switch (op) {                                                         \
        case rt::OP_ADD: { using OP = rt::Add<T>; __VA_ARGS__; break; }            \
        case rt::OP_MUL: { using OP = rt::Mul<T>; __VA_ARGS__; break; }            \
        case rt::OP_MAX: { using OP = rt::Max<T>; __VA_ARGS__; break; }            \
        case rt::OP_MIN: { using OP = rt::Min<T>; __VA_ARGS__; break; }            \
        default: return cudaErrorInvalidValue;                              \
      }                                                                     \
    } else if ((dtype) == rt::DT_I32) {                                     \
      using T = int;                                                        \
      switch (op) {                                                         \
        case rt::OP_ADD: { using OP = rt::Add<T>; __VA_ARGS__; break; }            \
        case rt::OP_MUL: { using OP = rt::Mul<T>; __VA_ARGS__; break; }            \
        case rt::OP_MAX: { using OP = rt::Max<T>; __VA_ARGS__; break; }            \
        case rt::OP_MIN: { using OP = rt::Min<T>; __VA_ARGS__; break; }            \
        default: return cudaErrorInvalidValue;                              \
      }                                                                     \
    } else {                                                                \
      return cudaErrorInvalidValue;                                         \
    }                                                                       \
  } while (0)

// The commutative ops plus AFFINE over a float pair (dtype must be F32).
#define RT_DISPATCH_ALL(op, dtype, ...)                                    \
  do {                                                                      \
    if ((op) == rt::OP_AFFINE) {                                            \
      if ((dtype) != rt::DT_F32) return cudaErrorInvalidValue;              \
      using T = rt::Pair;                                                   \
      using OP = rt::Affine;                                                \
      __VA_ARGS__;                                                          \
    } else {                                                                \
      RT_DISPATCH_COMMUTATIVE(op, dtype, __VA_ARGS__);                      \
    }                                                                       \
  } while (0)

}  // namespace rt
