// The Mamba decode's state step (K8) for sm_90a.
//
// Replaces no Pallas kernel: the JAX package's mamba_decode
// (models/mamba.py:248-257, with dt's softplus and A at :245-246) runs as
// XLA ops inside its jitted decode step (serve/engine.py:74), which fuses
// them.  The port ran them as ~20 eager kernels a layer and token.  For one
// token, per batch row b and head h (group g of h's heads):
//
//   dt = softplus(float(dt_raw[b,h]) + dt_bias[h]);  A = -exp(A_log[h])
//   dA = exp(dt * A)
//   s_new[n,p] = s[n,p] * dA + B[g,n] * (dt * float(x[p]))       (float32)
//   y[p] = T(sum_n C[g,n] T(s_new[n,p]));  out[p] = T(y + T(x[p] * T(D[h])))
//
// Each elementwise op rounds as the plain version's torch op (__fmul_rn /
// __fadd_rn; softplus as torch's log1p(exp(x)) below its threshold of 20),
// so s_new is the plain version's bit for bit; the sum over n runs in
// another order than the plain version's product (cuBLAS), so y is within
// an ulp of it, and bitwise across calls.
//
// What bounds it: the float32 state, read once and written once (4 MiB a
// layer at mamba2-1.3b's 64 heads x 128 x 64 and batch 1): bytes.  Design:
// one block per (row, head, 32 columns of P), DEC_NG groups of n a block,
// each thread one column p and every DEC_NG-th n; the groups' partial sums
// of y meet in shared memory and are added in group order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DEC_PC 32
#define DEC_NG 8

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

// torch's softplus at beta 1, threshold 20
__device__ __forceinline__ float softplus(float a) {
  return a > 20.0f ? a : log1pf(expf(a));
}

template <typename T>
__global__ void __launch_bounds__(DEC_PC * DEC_NG)
decode_step(const T* xs, const float* ssm, const T* dt_raw,
            const float* dt_bias, const float* A_log, const T* Bm,
            const T* Cm, const float* D, float* s_new, T* y, int H, int G,
            int N, int P) {
  __shared__ float part[DEC_NG][DEC_PC];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int pi = threadIdx.x % DEC_PC, ng = threadIdx.x / DEC_PC;
  const int p = blockIdx.y * DEC_PC + pi;
  const float dt = softplus(__fadd_rn(ld(dt_raw + bh), dt_bias[h]));
  const float A = -expf(A_log[h]);
  const float dA = expf(__fmul_rn(dt, A));
  const T* bn = Bm + (size_t)(b * G + g) * N;
  const T* cn = Cm + (size_t)(b * G + g) * N;
  float acc = 0.0f, x = 0.0f;
  if (p < P) {
    x = ld(xs + (size_t)bh * P + p);
    const float dtx = __fmul_rn(dt, x);
    const size_t base = (size_t)bh * N * P + p;
#pragma unroll 4
    for (int n = ng; n < N; n += DEC_NG) {
      const size_t i = base + (size_t)n * P;
      const float s = __fadd_rn(__fmul_rn(ssm[i], dA),
                                __fmul_rn(ld(bn + n), dtx));
      s_new[i] = s;
      acc = __fadd_rn(acc, __fmul_rn(ld(cn + n), rnd<T>(s)));
    }
  }
  part[ng][pi] = acc;
  __syncthreads();
  if (ng == 0 && p < P) {
    float t = part[0][pi];
#pragma unroll
    for (int j = 1; j < DEC_NG; ++j) t = __fadd_rn(t, part[j][pi]);
    const float yv = rnd<T>(t);
    st(y + (size_t)bh * P + p,
       __fadd_rn(yv, rnd<T>(__fmul_rn(x, rnd<T>(D[h])))));
  }
}

// dtype 0 float32, 1 bfloat16; returns cudaGetLastError()
extern "C" int decode_step_launch(int dtype, int Bt, int H, int G, int N,
                                  int P, const void* xs, const float* ssm,
                                  const void* dt_raw, const float* dt_bias,
                                  const float* A_log, const void* Bm,
                                  const void* Cm, const float* D,
                                  float* s_new, void* y, void* stream) {
  if (Bt < 1 || H < 1 || G < 1 || H % G || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Bt * H, (P + DEC_PC - 1) / DEC_PC);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    decode_step<__nv_bfloat16><<<grid, DEC_PC * DEC_NG, 0, s>>>(
        (const __nv_bfloat16*)xs, ssm, (const __nv_bfloat16*)dt_raw, dt_bias,
        A_log, (const __nv_bfloat16*)Bm, (const __nv_bfloat16*)Cm, D, s_new,
        (__nv_bfloat16*)y, H, G, N, P);
  else
    decode_step<float><<<grid, DEC_PC * DEC_NG, 0, s>>>(
        (const float*)xs, ssm, (const float*)dt_raw, dt_bias, A_log,
        (const float*)Bm, (const float*)Cm, D, s_new, (float*)y, H, G, N, P);
  return (int)cudaGetLastError();
}
