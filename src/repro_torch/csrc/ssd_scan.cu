// Mamba-2 SSD chunked scan (K3) for sm_90a.
//
// Replaces the JAX package's Pallas kernel kernels/ssd_scan.py::
// ssd_scan_pallas (pallas_call body _ssd_kernel).  For x [Bt, S, H, P],
// dt [Bt, S, H] (> 0), A [H] (< 0) and B, C [Bt, S, G, N] it computes the
// SSM recurrence
//   state_t = exp(dt_t A) state_{t-1} + B_t^T (dt_t x_t),   y_t = C_t state_t
// chunk by chunk, as the Pallas kernel does: with dA = dt A, cum its
// inclusive cumsum over the chunk and total = cum[-1],
//   y       = ((C B^T) * exp(cum_i - cum_j) [i >= j]) (x dt)
//           + (C * exp(cum)) state_prev
//   state   = exp(total) state_prev + B^T (x dt exp(total - cum)).
// Everything is float32 inside; y is written in x's type, the final state
// [Bt, H, N, P] in float32.  Head h reads B/C group h / (H / G).
//
// Design.  One block of 256 threads per (batch, head) walks the sequence in
// chunks of 64, whatever the model's chunk: chunking is exact, and a 64 x 64
// float32 score matrix (16 KB) fits shared memory where the model's
// 256 x 256 one (256 KB) would not.  A chunk's B and C (transposed), x dt,
// the scores and the running state [N][P] live in shared memory; the state
// never leaves the block until the end.  Thread (ty, tx) owns a 4 x 4 score
// tile, a 4 x (P / 16) tile of y and an (N / 16) x (P / 16) tile of the
// state.  Tail positions past S are masked (dt = 0, x = 0), so any S works.
// N and P are 64 or 128.
//
// What bounds it.  Per chunk about 2 L N (L + 2 P) + 2 L L P float32 FMA
// operations; one block per (batch, head) means Bt * H blocks (64 at
// mamba2-1.3b's batch 1, half of the 132 SMs) and a chain of S / 64
// dependent chunks per block, so it is latency- and occupancy-bound well
// before the 67 TFLOP/s float32 rate.  Splitting the chunks across blocks
// (a second pass for the state carry) and tensor-core products are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kL = 64;         // inner chunk
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kStride = kL + 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int N, int P>
constexpr size_t smem_bytes() {
  // B^T, C^T [N][kStride]; x dt [kL][P]; scores^T [kL][kStride];
  // state [N][P]; cum, dt [kL]
  return sizeof(float) *
         (2 * N * kStride + kL * P + kL * kStride + N * P + 2 * kL);
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int G) {
  static_assert(N % 64 == 0 && P % 64 == 0, "N and P: multiples of 64");
  constexpr int kPc = P / 64;  // groups of 4 p-columns per thread
  constexpr int kNr = N / 16;  // state rows per thread
  extern __shared__ float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);  // [N][kStride]
  float* ct = bt + N * kStride;                 // [N][kStride]
  float* xdt = ct + N * kStride;                // [kL][P]
  float* sc = xdt + kL * P;                     // scores^T [kL(j)][kStride(i)]
  float* st = sc + kL * kStride;                // [N][P]
  float* cum = st + N * P;                      // [kL]
  float* dts = cum + kL;                        // [kL]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float a_h = A[h];

  for (int idx = tid; idx < N * P; idx += kThreads) st[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kL) {
    __syncthreads();  // previous chunk's state update done
    if (tid < kL) {
      const int t = c0 + tid;
      dts[tid] = t < S ? dt[((long long)b * S + t) * H + h] : 0.f;
    }
    for (int idx = tid; idx < kL * N; idx += kThreads) {
      const int i = idx / N, n = idx % N;
      const int t = c0 + i;
      float bv = 0.f, cv = 0.f;
      if (t < S) {
        const long long off = (((long long)b * S + t) * G + grp) * N + n;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      bt[n * kStride + i] = bv;
      ct[n * kStride + i] = cv;
    }
    __syncthreads();
    for (int idx = tid; idx < kL * P; idx += kThreads) {
      const int i = idx / P, p = idx % P;
      const int t = c0 + i;
      xdt[idx] =
          t < S ? to_f32(x[(((long long)b * S + t) * H + h) * P + p]) * dts[i]
                : 0.f;
    }
    if (tid < 32) {  // inclusive cumsum of dA = dt * A, two per lane
      const float d0 = dts[2 * tid] * a_h, d1 = dts[2 * tid + 1] * a_h;
      float run = d0 + d1;
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += up;
      }
      const float before = run - (d0 + d1);
      cum[2 * tid] = before + d0;
      cum[2 * tid + 1] = before + d0 + d1;
    }
    __syncthreads();

    // scores[i][j] = (C_i . B_j) exp(cum_i - cum_j) for i >= j, stored ^T
    {
      float s[4][4];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      if (ty >= tx) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 ca = *reinterpret_cast<const float4*>(ct + n * kStride + 4 * ty);
          const float4 ba = *reinterpret_cast<const float4*>(bt + n * kStride + 4 * tx);
          const float cv[4] = {ca.x, ca.y, ca.z, ca.w};
          const float bv[4] = {ba.x, ba.y, ba.z, ba.w};
          for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
      }
      for (int i = 0; i < 4; ++i) {
        const int ii = 4 * ty + i;
        for (int j = 0; j < 4; ++j) {
          const int jj = 4 * tx + j;
          sc[jj * kStride + ii] =
              ii >= jj ? s[i][j] * expf(cum[ii] - cum[jj]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = scores (x dt) + exp(cum) * (C state_prev)
    {
      float yi[4][kPc][4], yo[4][kPc][4];
      for (int i = 0; i < 4; ++i)
        for (int q = 0; q < kPc; ++q)
          for (int e = 0; e < 4; ++e) yi[i][q][e] = yo[i][q][e] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kL; ++j) {
        const float4 sa = *reinterpret_cast<const float4*>(sc + j * kStride + 4 * ty);
        const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
        for (int q = 0; q < kPc; ++q) {
          const float4 xa = *reinterpret_cast<const float4*>(xdt + j * P + 64 * q + 4 * tx);
          const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
          for (int i = 0; i < 4; ++i)
            for (int e = 0; e < 4; ++e) yi[i][q][e] = fmaf(sv[i], xv[e], yi[i][q][e]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 ca = *reinterpret_cast<const float4*>(ct + n * kStride + 4 * ty);
        const float cv[4] = {ca.x, ca.y, ca.z, ca.w};
        for (int q = 0; q < kPc; ++q) {
          const float4 sa = *reinterpret_cast<const float4*>(st + n * P + 64 * q + 4 * tx);
          const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
          for (int i = 0; i < 4; ++i)
            for (int e = 0; e < 4; ++e) yo[i][q][e] = fmaf(cv[i], sv[e], yo[i][q][e]);
        }
      }
      for (int i = 0; i < 4; ++i) {
        const int t = c0 + 4 * ty + i;
        if (t >= S) continue;
        const float decay_in = expf(cum[4 * ty + i]);
        T* out = y + (((long long)b * S + t) * H + h) * P;
        for (int q = 0; q < kPc; ++q)
          for (int e = 0; e < 4; ++e)
            out[64 * q + 4 * tx + e] =
                from_f32<T>(yi[i][q][e] + decay_in * yo[i][q][e]);
      }
    }
    __syncthreads();  // state_prev and x dt fully read

    const float total = cum[kL - 1];
    for (int idx = tid; idx < kL * P; idx += kThreads)
      xdt[idx] *= expf(total - cum[idx / P]);
    __syncthreads();

    // state = exp(total) state + B^T (x dt exp(total - cum)); rows ty + 16r
    {
      const float carry = expf(total);
      float acc[kNr][kPc][4];
      for (int r = 0; r < kNr; ++r)
        for (int q = 0; q < kPc; ++q)
          for (int e = 0; e < 4; ++e) acc[r][q][e] = 0.f;
#pragma unroll 2
      for (int i = 0; i < kL; ++i) {
        float xv[kPc][4];
        for (int q = 0; q < kPc; ++q) {
          const float4 xa = *reinterpret_cast<const float4*>(xdt + i * P + 64 * q + 4 * tx);
          xv[q][0] = xa.x; xv[q][1] = xa.y; xv[q][2] = xa.z; xv[q][3] = xa.w;
        }
        for (int r = 0; r < kNr; ++r) {
          const float bv = bt[(ty + 16 * r) * kStride + i];
          for (int q = 0; q < kPc; ++q)
            for (int e = 0; e < 4; ++e) acc[r][q][e] = fmaf(bv, xv[q][e], acc[r][q][e]);
        }
      }
      for (int r = 0; r < kNr; ++r)
        for (int q = 0; q < kPc; ++q)
          for (int e = 0; e < 4; ++e) {
            float* cell = st + (ty + 16 * r) * P + 64 * q + 4 * tx + e;
            *cell = *cell * carry + acc[r][q][e];
          }
    }
  }
  __syncthreads();
  float* out = state_out + ((long long)b * H + h) * N * P;
  for (int idx = tid; idx < N * P; idx += kThreads) out[idx] = st[idx];
}

template <typename T, int N, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int Bt, int S, int H, int G,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N, P>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(H, Bt);
  ssd_scan_kernel<T, N, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, S, H, G);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, void* y, float* state, int Bt, int S, int H,
             int G, int N, int P, cudaStream_t stream) {
  if (N == 64 && P == 64)
    return launch<T, 64, 64>(x, dt, A, Bm, Cm, y, state, Bt, S, H, G, stream);
  if (N == 64 && P == 128)
    return launch<T, 64, 128>(x, dt, A, Bm, Cm, y, state, Bt, S, H, G, stream);
  if (N == 128 && P == 64)
    return launch<T, 128, 64>(x, dt, A, Bm, Cm, y, state, Bt, S, H, G, stream);
  if (N == 128 && P == 128)
    return launch<T, 128, 128>(x, dt, A, Bm, Cm, y, state, Bt, S, H, G, stream);
  return -1;
}

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16.  Returns a CUDA error
// code (0 on success); -1 for a shape or type the kernel does not take.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int Bt, int S, int H, int G,
                               int N, int P, int dtype, cudaStream_t stream) {
  if (Bt <= 0 || S <= 0 || G <= 0 || H % G != 0) return -1;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return dispatch<float>(x, dtf, Af, Bm, Cm, y, sf, Bt, S, H, G, N, P, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, sf, Bt, S, H, G, N, P,
                                   stream);
  return -1;
}
