// Causal GQA flash attention (K2) for sm_90a.
//
// Replaces the JAX package's Pallas kernel kernels/flash_attention.py::
// flash_attention_pallas (pallas_call body _flash_kernel): causal self-
// attention with an optional sliding window, q [B, S, Hq, D] against k/v
// [B, S, Hkv, D], Hq = G * Hkv.  Per output row it computes
//   softmax(scale * q . k^T  masked to k_pos <= q_pos and q_pos - k_pos < window) . v
// by the online softmax in float32: running max m, running sum l and an
// accumulator acc; p = exp(s - m) is rounded to the input type before the
// p . v product (as the Pallas kernel's p.astype(v.dtype)), l sums the
// unrounded p, and the output is acc / max(l, 1e-30) in the input type.
// Masked logits are -1e30, as in the Pallas kernel.
//
// Design.  One block of 256 threads per (64 folded rows, kv head, batch).
// The G query heads of a kv group are folded into rows: folded row
// R = pos * G + g of kv head h is q[b, pos, h * G + g, :], so the rows of a
// tile are contiguous in memory and one K/V tile serves all G heads.  The
// block walks the 64-key tiles its rows can see (kv tiles wholly above the
// diagonal or left of the window are never loaded) and stages each in
// shared memory as float32: K transposed for the q . k^T product, then V in
// the same buffer for p . v.  Thread (ty, tx) owns rows 4ty..4ty+3, keys
// 4tx..4tx+3 of the score tile and columns 4tx + 64j .. +3 of the output,
// so the row max and row sum are shuffles across the 16 threads of a row
// and m, l and acc stay in registers.  Any S >= 1: tail keys and rows are
// masked.  D is 64 or 128.
//
// What bounds it.  All products are float32 FMAs (no tensor cores in this
// first version): about 2 * 2 * D * (live score entries) operations, so at
// long S it is bound by the 67 TFLOP/s float32 rate, far above its byte
// bound.  Making it fast (mma/wgmma on bf16 tiles, TMA, warp
// specialisation) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // folded q rows per block
constexpr int kKeys = 64;      // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // keeps float4 alignment, spreads banks
constexpr int kStride = 64 + kPad;
constexpr float kNegInf = -1e30f;

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
// p rounded to the input type, as the Pallas kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  // Q^T [D][kStride] + (K^T [D][kStride] | V [kKeys][D]) + P^T [kKeys][kStride]
  return sizeof(float) * (2 * D * kStride + kKeys * kStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Hq, int Hkv, int window, float scale) {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  constexpr int kCols = D / 64;  // groups of 4 output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kStride]
  float* kv = qt + D * kStride;                 // K^T [D][kStride] or V [kKeys][D]
  float* pt = kv + D * kStride;                 // [kKeys][kStride]

  const int G = Hq / Hkv;
  const int tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long n_rows = (long long)S * G;
  const long long r0 = (long long)tile * kRows;
  const int pos_lo = (int)(r0 / G);
  const int pos_hi = (int)((min(r0 + kRows, n_rows) - 1) / G);

  // Q tile, transposed: qt[d][r] = q row r0 + r (zero past the end)
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const long long R = r0 + r;
    float val = 0.f;
    if (R < n_rows) {
      const long long pos = R / G, g = R % G;
      val = to_f32(q[((b * (long long)S + pos) * Hq + h * G + g) * D + d]);
    }
    qt[d * kStride + r] = val;
  }

  int row_pos[4];
  for (int i = 0; i < 4; ++i) {
    row_pos[i] = (int)((r0 + 4 * ty + i) / G);
  }
  float m[4], l[4], acc[4][kCols][4];
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    for (int j = 0; j < kCols; ++j)
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  const int j_hi = pos_hi / kKeys;
  int j_lo = 0;
  if (window > 0) j_lo = max(0, pos_lo - (window - 1)) / kKeys;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * kKeys;
    __syncthreads();  // previous tile's V and P fully read
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int key = k0 + c;
      kv[d * kStride + c] =
          key < S ? to_f32(k[((b * (long long)S + key) * Hkv + h) * D + d]) : 0.f;
    }
    __syncthreads();

    // scores s[i][c] = scale * q_row . k_key for this thread's 4 x 4
    float s[4][4];
    for (int i = 0; i < 4; ++i)
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kStride + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(kv + d * kStride + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kvv[4] = {ka.x, ka.y, ka.z, ka.w};
      for (int i = 0; i < 4; ++i)
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kvv[c], s[i][c]);
    }

    // mask, online softmax across the 16 threads that share a row
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 4 * tx + c;
        bool ok = key < S && key <= row_pos[i];
        if (window > 0) ok = ok && row_pos[i] - key < window;
        s[i][c] = ok ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        pt[(4 * tx + c) * kStride + 4 * ty + i] = round_to<T>(p);
      }
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      for (int j = 0; j < kCols; ++j)
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= alpha;
    }
    __syncthreads();  // K^T fully read, P written

    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int key = k0 + c;
      kv[c * D + d] =
          key < S ? to_f32(v[((b * (long long)S + key) * Hkv + h) * D + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * kStride + 4 * ty);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      for (int j = 0; j < kCols; ++j) {
        const float4 va =
            *reinterpret_cast<const float4*>(kv + c * D + 64 * j + 4 * tx);
        const float vv[4] = {va.x, va.y, va.z, va.w};
        for (int i = 0; i < 4; ++i)
          for (int e = 0; e < 4; ++e) acc[i][j][e] = fmaf(pv[i], vv[e], acc[i][j][e]);
      }
    }
  }

  for (int i = 0; i < 4; ++i) {
    const long long R = r0 + 4 * ty + i;
    if (R >= n_rows) continue;
    const long long pos = R / G, g = R % G;
    T* out = o + ((b * (long long)S + pos) * Hq + h * G + g) * D;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    for (int j = 0; j < kCols; ++j)
      for (int e = 0; e < 4; ++e)
        out[64 * j + 4 * tx + e] = from_f32<T>(acc[i][j][e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long n_rows = (long long)S * (Hq / Hkv);
  dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), Hkv, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0: no window.  Returns a CUDA
// error code (0 on success); -1 for a shape or type the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Hq, int Hkv, int D, int window,
                                      float scale, int dtype,
                                      cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, S, Hq, Hkv, window, scale, stream);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, S, Hq, Hkv, window, scale, stream);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, Hq, Hkv, window, scale,
                                     stream);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, Hq, Hkv, window, scale,
                                      stream);
  return -1;
}
