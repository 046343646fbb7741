// The SwiGLU gate (K10) for sm_90a, forward and backward.
//
// Replaces no Pallas kernel: the JAX package's swiglu
// (models/layers.py:73) runs silu(g.astype(f32)).astype(x.dtype) * u as XLA
// ops, which its jitted train step (train/loop.py:108) and decode step
// (serve/engine.py:74) fuse between the gate/up and down products.  Per
// element, with T the input type and f = float:
//
//   a = T(f(g) / (1 + exp(-f(g))))           (torch's silu, rounded to T)
//   h = T(a * u)
//
// and from the cotangent dh, as autograd rounds each op:
//
//   du = T(dh * a)
//   q = T(dh * u);  sg = 1 / (1 + exp(-f(g)))
//   dg = T(q * sg * (1 + f(g) * (1 - sg)))   (torch's silu_backward)
//
// What bounds it: a few flops a byte; the bytes (g, u read once and h
// written once; the backward reads dh, g, u and writes dg, du).  Design:
// one elementwise pass in a grid of one wave, each thread striding over
// 16-byte chunks of E elements (one vector load a tensor on the vector
// route; the scalar route, for sizes or views that are not whole vectors,
// takes one element a step).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define SG_THREADS 256

template <typename T> struct Lanes { static constexpr int E = 16 / sizeof(T); };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned bf2_pack(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float* f) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (std::is_same<T, float>::value)
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  else
    return make_uint4(bf2_pack(f[0], f[1]), bf2_pack(f[2], f[3]),
                      bf2_pack(f[4], f[5]), bf2_pack(f[6], f[7]));
}

// the L values at element i of p: one 16-byte load (VEC, L = E) or one
// element (L = 1)
template <typename T, bool VEC>
__device__ __forceinline__ void load_at(const T* p, long long i, float* f) {
  if constexpr (VEC)
    unpack<T>(__ldg(reinterpret_cast<const uint4*>(p + i)), f);
  else
    f[0] = ld(p + i);
}
template <typename T, bool VEC>
__device__ __forceinline__ void store_at(T* p, long long i, const float* f) {
  if constexpr (VEC)
    *reinterpret_cast<uint4*>(p + i) = pack<T>(f);
  else
    st(p + i, f[0]);
}

// silu(gf) rounded to T, and the sigmoid, as torch's silu and
// silu_backward compute them
__device__ __forceinline__ float silu_of(float gf) {
  return __fdiv_rn(gf, __fadd_rn(1.0f, expf(-gf)));
}
__device__ __forceinline__ float sigmoid_of(float gf) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gf)));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(SG_THREADS)
sg_fwd(const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ h,
       long long n) {
  constexpr int L = VEC ? Lanes<T>::E : 1;
  const long long steps = n / L;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    float fg[L], fu[L], o[L];
    load_at<T, VEC>(g, k * L, fg);
    load_at<T, VEC>(u, k * L, fu);
#pragma unroll
    for (int j = 0; j < L; ++j)
      o[j] = __fmul_rn(rnd<T>(silu_of(fg[j])), fu[j]);
    store_at<T, VEC>(h, k * L, o);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(SG_THREADS)
sg_bwd(const T* __restrict__ dh, const T* __restrict__ g,
       const T* __restrict__ u, T* __restrict__ dg, T* __restrict__ du,
       long long n) {
  constexpr int L = VEC ? Lanes<T>::E : 1;
  const long long steps = n / L;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < steps; k += (long long)gridDim.x * blockDim.x) {
    float fd[L], fg[L], fu[L], og[L], ou[L];
    load_at<T, VEC>(dh, k * L, fd);
    load_at<T, VEC>(g, k * L, fg);
    load_at<T, VEC>(u, k * L, fu);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float a = rnd<T>(silu_of(fg[j]));
      ou[j] = __fmul_rn(fd[j], a);
      const float q = rnd<T>(__fmul_rn(fd[j], fu[j]));
      const float sg = sigmoid_of(fg[j]);
      og[j] = __fmul_rn(__fmul_rn(q, sg),
                        __fadd_rn(1.0f, __fmul_rn(fg[j],
                                                  __fsub_rn(1.0f, sg))));
    }
    store_at<T, VEC>(dg, k * L, og);
    store_at<T, VEC>(du, k * L, ou);
  }
}

// ---------------------------------------------------------------------------
// launchers: dtype 0 float32, 1 bfloat16; vec 1 for the vector route (n
// whole 16-byte vectors, every pointer 16-byte aligned), 0 for the scalar
// route; blocks: the grid (one wave of the card); each returns
// cudaGetLastError()
// ---------------------------------------------------------------------------

static int grid_of(long long n, int per, int blocks) {
  const long long need = (n / per + SG_THREADS - 1) / SG_THREADS;
  return (int)(need < blocks ? (need < 1 ? 1 : need) : blocks);
}

extern "C" int sg_fwd_launch(int dtype, int vec, long long n, int blocks,
                             const void* g, const void* u, void* h,
                             void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = vec ? (dtype == 1 ? 8 : 4) : 1;
  if (n % per) return (int)cudaErrorInvalidValue;
  const int grid = grid_of(n, per, blocks);
#define SG_FWD(T, VE)                                                   \
  sg_fwd<T, VE><<<grid, SG_THREADS, 0, s>>>((const T*)g, (const T*)u,   \
                                            (T*)h, n)
  if (dtype == 1) {
    if (vec) SG_FWD(__nv_bfloat16, true); else SG_FWD(__nv_bfloat16, false);
  } else {
    if (vec) SG_FWD(float, true); else SG_FWD(float, false);
  }
#undef SG_FWD
  return (int)cudaGetLastError();
}

extern "C" int sg_bwd_launch(int dtype, int vec, long long n, int blocks,
                             const void* dh, const void* g, const void* u,
                             void* dg, void* du, void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = vec ? (dtype == 1 ? 8 : 4) : 1;
  if (n % per) return (int)cudaErrorInvalidValue;
  const int grid = grid_of(n, per, blocks);
#define SG_BWD(T, VE)                                                     \
  sg_bwd<T, VE><<<grid, SG_THREADS, 0, s>>>((const T*)dh, (const T*)g,    \
                                            (const T*)u, (T*)dg, (T*)du, n)
  if (dtype == 1) {
    if (vec) SG_BWD(__nv_bfloat16, true); else SG_BWD(__nv_bfloat16, false);
  } else {
    if (vec) SG_BWD(float, true); else SG_BWD(float, false);
  }
#undef SG_BWD
  return (int)cudaGetLastError();
}
