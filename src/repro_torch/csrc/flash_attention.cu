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
// Masked logits are -1e30, as in the Pallas kernel.  Both kernels fold the
// G query heads of a kv group into rows: folded row R = pos * G + g of kv
// head h is q[b, pos, h * G + g, :], so one K/V tile serves all G heads.
// Tiles wholly above the diagonal or left of the window are never loaded;
// only diagonal and window-edge tiles are masked; any S >= 1 works (tail
// keys and rows are masked).  Three routes; kernels/flash_attention.py::route
// names one from (D, type) and the launcher takes exactly that one, never
// another on a failure.  The fast routes take the head dims the build's
// FLASH_FAST_D32_MASK lists (the wrapper's HEAD_DIMS: 64, 128, 160, 256), by
// type:
//
// bfloat16: tensor cores (flash_attention_wgmma).  One block per 128 folded
// rows of one kv head: two consumer warpgroups own 64 rows each and one
// producer warp keeps a ring of kStages K/V tiles (64 keys each) in flight
// with TMA (cp.async.bulk.tensor, 128-byte swizzle, completion on
// mbarriers).  S = Q . K^T is wgmma.mma_async with Q resident in shared
// memory (A) and the K tile as the K-major B operand; O += P . V is wgmma
// with P as the A operand in registers (rounded to bf16 there, the Pallas
// kernel's rounding point) and the V tile as the MN-major B operand
// (transposed by the instruction).  The head dim is cut into 64-column
// panels (one TMA box and one 128-byte swizzle span each; D = 160 is three
// panels, the last half filled with zeros by TMA's out-of-bounds fill).
// Blocks with the longest key range start first.  The softmax runs in the
// log2 domain (scale * log2 e folded into the logits, exp2).
// D = 256 (paligemma-3b) takes the same kernel with 64-key tiles: four Q
// panels (64 KB) and two K/V stages of 32 KB each (128 KB) make ~193 KB of
// the 227 KB a block may use.  A consumer thread holds O's 128 float32 (64
// rows x 256 / 128 threads) beside S's 32 and P's 16 registers, more than
// the 168 a thread of the 288-thread block gets (ptxas counts it as three
// warpgroups: 65,536 / 384): with the producer warp it spills 856 bytes
// and takes 2.5x as long.  setmaxnreg (a producer warpgroup at 40
// registers, consumers at 232) did not lift ptxas's allocation limit, and
// 32-key tiles would leave ~165 of 168, so at D = 256 the block is the two
// consumer warpgroups alone (255 registers a thread): thread 0 issues each
// K/V tile's TMA loads at the top of the iteration before the tile's,
// after waiting for the stage to be released, as the producer warp would.
// D <= 160 keep the producer warp: the same inline loads there made
// yi-6b's, stablelm-12b's and gemma3-27b's prefills 3-7% slower (PERF.md).
// chip_smoke.py's build log checks that ptxas spills nothing there.
//
// float32: float32 FMAs (flash_attention_fma), one block of 256 threads per
// 64 folded rows; K is staged transposed and V in the same buffer (156,672
// bytes of shared memory at D = 256).  TF32 tensor cores keep ~3 digits and
// cannot meet float32's 2e-5 tolerance.
//
// generic (flash_attention_generic): any other 1 <= D <= 256, float32 or
// bfloat16 (the reduced configs' 8-20).  The float32 kernel's tiling with
// the head dim padded to DP (16, 32, 64, 128 or 256)
// in shared memory and registers: loads are plain and masked (no TMA: a
// bf16 row of D = 12 is 24 bytes, not a multiple of 16), padded columns
// are zeros and never stored, everything runs in float32 FMAs with inputs
// widened from their type, and p is rounded to the input type before P . V.
//
// What bounds it.  About 4 * D operations per live (q, k) pair and head:
// at long S the bf16 kernel is bound by the tensor cores and the softmax's
// exp2 between the two products, the float32 one by the 67 TFLOP/s FMA rate.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kRows = 64;      // folded q rows per block
constexpr int kKeys = 64;      // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // keeps float4 alignment, spreads banks
constexpr int kStride = 64 + kPad;

template <int D>
constexpr size_t smem_bytes() {
  // Q^T [D][kStride] + (K^T [D][kStride] | V [kKeys][D]) + P^T [kKeys][kStride]
  return sizeof(float) * (2 * D * kStride + kKeys * kStride);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int S, int Hq, int Hkv,
                    int window, float scale) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int kCols = (D + 63) / 64;  // groups of 4 output columns per thread
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
      val = q[((b * (long long)S + pos) * Hq + h * G + g) * D + d];
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
          key < S ? k[((b * (long long)S + key) * Hkv + h) * D + d] : 0.f;
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
        pt[(4 * tx + c) * kStride + 4 * ty + i] = p;
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
          key < S ? v[((b * (long long)S + key) * Hkv + h) * D + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * kStride + 4 * ty);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      for (int j = 0; j < kCols; ++j) {
        if (64 * j + 4 * tx >= D) continue;  // D = 160: half of the last group
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
    float* out = o + ((b * (long long)S + pos) * Hq + h * G + g) * D;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(b * (long long)Hq + h * G + g) * S + pos] = m[i] + logf(l[i]);
    for (int j = 0; j < kCols; ++j) {
      if (64 * j + 4 * tx >= D) continue;
      for (int e = 0; e < 4; ++e) out[64 * j + 4 * tx + e] = acc[i][j][e] * inv;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Hq, int Hkv, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long n_rows = (long long)S * (Hq / Hkv);
  dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), Hkv, B);
  flash_attention_fma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Hq, Hkv,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// generic: any head dim up to 256, float32 or bfloat16, on float32 FMAs
// ---------------------------------------------------------------------------

namespace gen {

constexpr int kRows = 64;      // folded q rows per block
constexpr int kKeys = 64;      // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kStride = 64 + 4;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int DP>
constexpr size_t smem_bytes() {
  // Q^T [DP][kStride] + (K^T [DP][kStride] | V [kKeys][DP]) + P^T [kKeys][kStride]
  return sizeof(float) * (2 * DP * kStride + kKeys * kStride);
}

// Thread (ty, tx) scores rows 4 ty .. 4 ty + 3 against keys 4 tx .. 4 tx + 3
// and accumulates the output columns tx + 16 j, j < DP / 16.
template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_generic(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int S, int Hq, int Hkv, int D,
                        int window, float scale) {
  constexpr int kCols = DP / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DP][kStride]
  float* kv = qt + DP * kStride;                // K^T [DP][kStride] or V [kKeys][DP]
  float* pt = kv + DP * kStride;                // [kKeys][kStride]

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
      val = widen(q[((b * (long long)S + pos) * Hq + h * G + g) * D + d]);
    }
    qt[d * kStride + r] = val;
  }

  int row_pos[4];
  for (int i = 0; i < 4; ++i) row_pos[i] = (int)((r0 + 4 * ty + i) / G);
  float m[4], l[4], acc[4][kCols];
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
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
          key < S ? widen(k[((b * (long long)S + key) * Hkv + h) * D + d]) : 0.f;
    }
    __syncthreads();

    // scores s[i][c] = scale * q_row . k_key over the D real columns
    float s[4][4];
    for (int i = 0; i < 4; ++i)
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
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
        // P . V takes p rounded to the input type; l sums it unrounded
        pt[(4 * tx + c) * kStride + 4 * ty + i] = widen(narrow<T>(p));
      }
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // K^T fully read, P written

    // V [kKeys][DP], columns past D zero
    for (int idx = tid; idx < kKeys * DP; idx += kThreads) {
      const int c = idx / DP, d = idx % DP;
      const int key = k0 + c;
      kv[idx] = key < S && d < D
                    ? widen(v[((b * (long long)S + key) * Hkv + h) * D + d])
                    : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < kKeys; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * kStride + 4 * ty);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = kv[c * DP + tx + 16 * j];
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  for (int i = 0; i < 4; ++i) {
    const long long R = r0 + 4 * ty + i;
    if (R >= n_rows) continue;
    const long long pos = R / G, g = R % G;
    T* out = o + ((b * (long long)S + pos) * Hq + h * G + g) * D;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(b * (long long)Hq + h * G + g) * S + pos] = m[i] + logf(l[i]);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < D) out[col] = narrow<T>(acc[i][j] * inv);
    }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Hq, int Hkv, int D, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_generic<DP, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long n_rows = (long long)S * (Hq / Hkv);
  dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), Hkv, B);
  flash_attention_generic<DP, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Hq, Hkv, D,
      window, scale);
  return (int)cudaGetLastError();
}

// the smallest padded width that holds D
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int S, int Hq, int Hkv, int D, int window, float scale,
             cudaStream_t stream) {
  if (D < 1 || D > 256) return -1;
  if (D <= 16) return launch<16, T>(q, k, v, o, lse, B, S, Hq, Hkv, D, window, scale, stream);
  if (D <= 32) return launch<32, T>(q, k, v, o, lse, B, S, Hq, Hkv, D, window, scale, stream);
  if (D <= 64) return launch<64, T>(q, k, v, o, lse, B, S, Hq, Hkv, D, window, scale, stream);
  if (D <= 128) return launch<128, T>(q, k, v, o, lse, B, S, Hq, Hkv, D, window, scale, stream);
  return launch<256, T>(q, k, v, o, lse, B, S, Hq, Hkv, D, window, scale, stream);
}

}  // namespace gen

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma kernel
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;          // folded q rows per block (2 warpgroups)
constexpr int kKeys = 64;           // keys per K/V tile
constexpr int kConsumers = 256;     // 2 consumer warpgroups (warps 0-7)
constexpr int kPanelCols = 64;      // bf16 columns per 128-byte swizzle span
constexpr int kRowBytes = 128;      // one panel row
constexpr int kTileBytes = kKeys * kRowBytes;  // one panel of a K or V tile

template <int D>
struct Shape {
  static constexpr int kPanels = (D + kPanelCols - 1) / kPanelCols;
  static constexpr int kSteps = D / 16;                  // k-steps of Q . K^T
  static constexpr int kQPanel = kRows * kRowBytes;      // one Q panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kTileBytes;  // K (or V) of a stage
  static constexpr int kStages = D <= 128 ? 3 : 2;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 3 * kStages * 8;
  // O is kPanels x 32 float32 a consumer thread: four panels (D = 256) do
  // not fit the 168 registers ptxas gives a thread of 288, so there the
  // block has no producer warp; below that the producer warp is faster
  // (the header says why and how).
  static constexpr bool kInlineLoads = kPanels > 3;
  static constexpr int kThreads = kConsumers + (kInlineLoads ? 0 : 32);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed; a completion that
// never comes (~17 s of clock) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands use
// only the stride between 8-row groups (1024 bytes); for the MN-major V
// panel (64 columns: one swizzle span) both offsets are that stride.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  constexpr uint64_t kStride = 1024 >> 4;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (kStride << 16) |
         (kStride << 32) | (1ull << 62);
}

// pin the accumulator registers around the asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define WG_REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"

// d[64 x 64] (+)= A[64 x 16] (shared, K-major) . B[16 x 64] (shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v,
                      const bf16* __restrict__ q, bf16* __restrict__ o,
                      float* __restrict__ lse, int S, int Hq, int Hkv,
                      int window, float scale_log2) {
  using Sh = Shape<D>;
  constexpr int kPanels = Sh::kPanels;
  constexpr int kStages = Sh::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles need 1024-byte alignment
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = base;                        // Q [panel][128 rows][128 B]
  uint8_t* skv = sq + Sh::kQBytes;           // stage s: K, then V
  uint64_t* full_k = reinterpret_cast<uint64_t*>(skv + 2 * kStages * Sh::kKVBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int G = Hq / Hkv;
  const int tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long n_rows = (long long)S * G;
  const long long r0 = (long long)tile * kRows;
  const int pos_lo = (int)(r0 / G);
  const int pos_hi = (int)((min(r0 + kRows, n_rows) - 1) / G);
  const int j_hi = pos_hi / kKeys;
  const int j_lo = window > 0 ? max(0, pos_lo - (window - 1)) / kKeys : 0;
  const int n_tiles = j_hi - j_lo + 1;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K/V tile it into stage it % kStages, once every consumer warp has
  // released the stage's previous tile
  auto load_tile = [&](int it) {
    const int st = it % kStages;
    const uint32_t use = it / kStages;
    mbar_wait(&empty[st], (use & 1) ^ 1);
    const int k0 = (j_lo + it) * kKeys;
    uint8_t* kbuf = skv + st * 2 * Sh::kKVBytes;
    uint8_t* vbuf = kbuf + Sh::kKVBytes;
    mbar_expect_tx(&full_k[st], Sh::kKVBytes);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      tma_load_4d(kbuf + p * kTileBytes, &tmap_k, &full_k[st],
                  p * kPanelCols, h, k0, b);
    mbar_expect_tx(&full_v[st], Sh::kKVBytes);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      tma_load_4d(vbuf + p * kTileBytes, &tmap_v, &full_v[st],
                  p * kPanelCols, h, k0, b);
  };

  if constexpr (Sh::kInlineLoads) {
    // the first kStages - 1 tiles; thread 0 issues each later one at the
    // top of the iteration kStages - 1 before it
    if (threadIdx.x == 0)
      for (int it = 0; it < min(kStages - 1, n_tiles); ++it) load_tile(it);
  } else if (warp == 8) {
    // producer: one thread issues every TMA load
    if (lane == 0)
      for (int it = 0; it < n_tiles; ++it) load_tile(it);
    return;
  }

  // consumers: warpgroup wgi owns tile rows 64 wgi .. 64 wgi + 63
  const int wgi = warp / 4;
  const int tw = threadIdx.x % 128;
  const int wiw = warp % 4;

  // this warpgroup's Q rows into shared memory, 128-byte swizzled
  for (int idx = tw; idx < 64 * kPanels * 8; idx += 128) {
    const int c = idx % 8;
    const int r = (idx / 8) % 64;
    const int p = idx / (8 * 64);
    const int R = 64 * wgi + r;
    const long long Rg = r0 + R;
    const int col = p * kPanelCols + c * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (Rg < n_rows && col < D) {
      const long long pos = Rg / G, g = Rg % G;
      val = *reinterpret_cast<const uint4*>(
          q + ((b * (long long)S + pos) * Hq + h * G + g) * D + col);
    }
    *reinterpret_cast<uint4*>(sq + p * Sh::kQPanel + R * kRowBytes +
                              ((c ^ (R & 7)) << 4)) = val;
  }
  // generic-proxy stores -> visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + wgi, 128);

  // a thread holds rows rA and rA + 8 of its warpgroup's 64
  const int rA = 64 * wgi + 16 * wiw + lane / 4;
  const long long RA = r0 + rA, RB = RA + 8;
  const int posA = (int)(RA / G), posB = (int)(RB / G);
  const int qd = lane % 4;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;
  float acc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  const uint32_t q_addr = smem_u32(sq) + wgi * 64 * kRowBytes;
  const uint32_t kv_addr = smem_u32(skv);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int k0 = (j_lo + it) * kKeys;
    const uint32_t k_addr = kv_addr + st * 2 * Sh::kKVBytes;
    const uint32_t v_addr = k_addr + Sh::kKVBytes;
    if constexpr (Sh::kInlineLoads) {
      if (threadIdx.x == 0 && it + kStages - 1 < n_tiles)
        load_tile(it + kStages - 1);
      __syncwarp();
    }

    // S = Q . K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(&full_k[st], par);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::kSteps; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
      wgmma_ss(s, desc_sw128(q_addr + (kk / 4) * Sh::kQPanel + off),
               desc_sw128(k_addr + (kk / 4) * kTileBytes + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // mask (diagonal and window-edge tiles only), online softmax in log2
    const bool edge = k0 + kKeys - 1 > pos_lo || k0 + kKeys > S ||
                      (window > 0 && pos_hi - k0 >= window);
    float mxA = -INFINITY, mxB = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * (i / 4) + 2 * qd + (i % 2);
        const int pos = (i % 4) < 2 ? posA : posB;
        bool ok = key < S && key <= pos;
        if (window > 0) ok = ok && pos - key < window;
        x = ok ? x : kNegInf;
      }
      s[i] = x;
      if ((i % 4) < 2) mxA = fmaxf(mxA, x);
      else mxB = fmaxf(mxB, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
    }
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    const float alA = exp2f(mA - mnA), alB = exp2f(mB - mnB);
    mA = mnA;
    mB = mnB;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i % 4) < 2) {
        s[i] = exp2f(s[i] - mnA);
        sumA += s[i];
      } else {
        s[i] = exp2f(s[i] - mnB);
        sumB += s[i];
      }
    }
    lA = lA * alA + sumA;  // per-thread partial sums; reduced at the end
    lB = lB * alB + sumB;
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= (i % 4) < 2 ? alA : alB;

    // P in registers as wgmma's A fragments: k-step kk covers keys 16kk..+15
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P . V, one 64-column panel per instruction
    mbar_wait(&full_v[st], par);
#pragma unroll
    for (int p = 0; p < kPanels; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        wgmma_rs(acc[p], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3],
                 desc_sw128(v_addr + p * kTileBytes + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int p = 0; p < kPanels; ++p) fence_regs(acc[p]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float invA = 1.f / fmaxf(lA, 1e-30f), invB = 1.f / fmaxf(lB, 1e-30f);
  // L in natural units: m is kept in the log2 domain of scale * log2 e
  if (lse != nullptr && qd == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    if (RA < n_rows)
      lse[(b * (long long)Hq + h * G + (int)(RA % G)) * S + posA] =
          mA * kLn2 + logf(lA);
    if (RB < n_rows)
      lse[(b * (long long)Hq + h * G + (int)(RB % G)) * S + posB] =
          mB * kLn2 + logf(lB);
  }
  bf16* outA = nullptr;
  bf16* outB = nullptr;
  if (RA < n_rows)
    outA = o + ((b * (long long)S + posA) * Hq + h * G + (int)(RA % G)) * D;
  if (RB < n_rows)
    outB = o + ((b * (long long)S + posB) * Hq + h * G + (int)(RB % G)) * D;
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (p * kPanelCols + 8 * j >= D) continue;  // D = 160: zero half-panel
      const int col = p * kPanelCols + 8 * j + 2 * qd;
      if (outA)
        *reinterpret_cast<uint32_t*>(outA + col) =
            pack_bf16(acc[p][4 * j] * invA, acc[p][4 * j + 1] * invA);
      if (outB)
        *reinterpret_cast<uint32_t*>(outB + col) =
            pack_bf16(acc[p][4 * j + 2] * invB, acc[p][4 * j + 3] * invB);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up in the already loaded driver
// library (no link-time dependency on libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// k or v [B, S, Hkv, D] as a 4-D tensor (D, Hkv, S, B); one box is 64
// columns x 1 head x 64 keys, 128-byte swizzled; keys past S and columns
// past D read as zeros.
int kv_map(CUtensorMap* map, const void* ptr, int B, int S, int Hkv, int D) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)S * Hkv * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, 1, (cuuint32_t)kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Hq, int Hkv, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::kSmem;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return -3;
  CUtensorMap tk, tv;
  if (kv_map(&tk, k, B, S, Hkv, D) || kv_map(&tv, v, B, S, Hkv, D)) return -2;
  const long long n_rows = (long long)S * (Hq / Hkv);
  dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), Hkv, B);
  flash_attention_wgmma<D><<<grid, Shape<D>::kThreads, smem, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(o), lse, S, Hq,
      Hkv, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace wg

// The fast routes' head dims: bit D / 32 - 1 set for each.
// kernels/flash_attention.py owns the set (HEAD_DIMS) and passes it to nvcc
// as -DFLASH_FAST_D32_MASK; each listed D instantiates the FMA and wgmma
// kernels, and the launcher takes those routes at exactly these D.
#ifndef FLASH_FAST_D32_MASK
#error "build with -DFLASH_FAST_D32_MASK=<bit D / 32 - 1 per fast head dim>"
#endif
constexpr unsigned kFastD32 = FLASH_FAST_D32_MASK;

constexpr bool fast_d(int d) {
  return d >= 32 && d <= 256 && d % 32 == 0 && ((kFastD32 >> (d / 32 - 1)) & 1u);
}

// route 0 (fma, float32) or 1 (wgmma, bfloat16) at a fast head dim D
template <int D>
int launch_fast(int route, const void* q, const void* k, const void* v,
                void* o, float* lse, int B, int S, int Hq, int Hkv,
                float scale, int window, cudaStream_t stream) {
  if constexpr (fast_d(D)) {
    if (route == 0)
      return f32::launch<D>(q, k, v, o, lse, B, S, Hq, Hkv, window, scale, stream);
    return wg::launch<D>(q, k, v, o, lse, B, S, Hq, Hkv, window, scale, stream);
  }
  return -1;
}

}  // namespace

// route: 0 fma (float32), 1 wgmma (bfloat16), both at the fast head dims;
// 2 generic (float32 or bfloat16, 1 <= D <= 256), as kernels/
// flash_attention.py::route names it.  dtype: 0 float32, 1 bfloat16.
// window <= 0: no window.  lse: null, or float32 [B, Hq, S] that receives
// each row's log-sum-exp L = m + log(l) of its scaled, masked logits in
// natural units (the wgmma route converts its log2-domain max), which K2's
// backward (csrc/flash_attention_bwd.cu) reads; serving passes null and
// no route's output changes with it.  Returns a CUDA error code (0 on
// success); -1 for a route, shape or type the kernel does not take, -2 if
// the CUDA driver cannot encode a TMA descriptor, -3 for a pointer that is
// not 16-byte aligned (wgmma).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int S, int Hq, int Hkv, int D,
                                      int window, float scale, int dtype,
                                      int route, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  float* l = static_cast<float*>(lse);
  if (route == 2) {
    if (dtype == 0)
      return gen::dispatch<float>(q, k, v, o, l, B, S, Hq, Hkv, D, window, scale, stream);
    if (dtype == 1)
      return gen::dispatch<__nv_bfloat16>(q, k, v, o, l, B, S, Hq, Hkv, D, window, scale, stream);
    return -1;
  }
  if (route != dtype || (route != 0 && route != 1) || !fast_d(D)) return -1;
  switch (D) {
    case 32: return launch_fast<32>(route, q, k, v, o, l, B, S, Hq, Hkv, scale, window, stream);
    case 64: return launch_fast<64>(route, q, k, v, o, l, B, S, Hq, Hkv, scale, window, stream);
    case 96: return launch_fast<96>(route, q, k, v, o, l, B, S, Hq, Hkv, scale, window, stream);
    case 128: return launch_fast<128>(route, q, k, v, o, l, B, S, Hq, Hkv, scale, window, stream);
    case 160: return launch_fast<160>(route, q, k, v, o, l, B, S, Hq, Hkv, scale, window, stream);
    case 192: return launch_fast<192>(route, q, k, v, o, l, B, S, Hq, Hkv, scale, window, stream);
    case 224: return launch_fast<224>(route, q, k, v, o, l, B, S, Hq, Hkv, scale, window, stream);
    case 256: return launch_fast<256>(route, q, k, v, o, l, B, S, Hq, Hkv, scale, window, stream);
    default: return -1;
  }
}
