// The Mamba block's D skip and gated RMSNorm (K7) for sm_90a, forward and
// backward.
//
// Replaces no Pallas kernel: the JAX package's Mamba block runs the skip
// `y + xs * D` (models/mamba.py:215) and models/mamba.py::_gated_norm as XLA
// ops, which its jitted train step (train/loop.py:108) and decode step
// (serve/engine.py:74) fuse.  Per row of width W (d_inner, or a rank's
// share of it), with h = c / P the channel's head and T the input type:
//
//   u = y + xs * T(D[h])                       (each op rounded to T; no D:
//                                               u = y)
//   v = u * T(silu(float(z)))                  (rounded to T)
//   out = T(float(v) * rsqrt(sum(v^2) / width + eps) * scale)
//
// width is the whole row's (d_inner) where a mesh splits the row over
// ranks.  Every elementwise op rounds as the plain version's separate torch
// op (__fmul_rn / __fadd_rn, SiLU as x / (1 + expf(-x)), rsqrtf as torch's
// rsqrt); the row's sum of squares is taken in a fixed order (each thread
// its strided channels in turn, then a fixed shuffle tree and the warps in
// order), which is another order than torch's reduction: the output is
// within an ulp of the plain version's and bitwise across calls.
//
// Modes: FUSED (the whole row in one block); SUM (a row's sum of squares
// into ss) and FINISH (the rest from a given ss) around an all-reduce of ss
// over the ranks that share a row: FINISH fed the FUSED block's own ss gives
// its bits.  The backward splits the same way at its row dot.
//
// The backward from dout, recomputing u, v and with the forward's rstd r:
//   a = dout * scale;  dot = sum_c a v;  dv = a r - v (dot r^3 / width)
//   du = dv * g;  dz = dv * u * s (1 + z (1 - s)),  s = 1 / (1 + e^-z)
//   dy = du,  dxs = du * T(D[h]),  dscale[c] = sum_rows dout v r,
//   dD[h] = sum_{rows, p} du xs
// in float32, dy, dxs, dz rounded to T.  The sums over rows go into one slot
// per block of rows and gn_reduce adds them in a fixed order (no atomics):
// two calls give the same bits.
//
// What bounds it: a few flops a byte; the bytes (each input read once,
// each output written once).  Design: one block of GN_THREADS a row
// (GN_WIDE_THREADS where the rows are too few to fill the card: the
// decode's), the row re-read from L1/L2 for its second pass; the backward:
// a block walks rows_per_block rows, its per-channel sums in shared memory,
// a thread owning its channels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GN_THREADS 256
// the forward over fewer rows than this (the decode's one row a sequence)
// runs GN_WIDE_THREADS a row: one block a row leaves most of the card idle
#define GN_WIDE_THREADS 1024
#define GN_WIDE_ROWS 264
#define GN_MAX_BLOCKS 512
#define GN_REDUCE_THREADS 256
#define GN_FUSED 0
#define GN_SUM 1
#define GN_FINISH 2

struct GN {
  const void* y;
  const void* xs;       // null: no D skip
  const void* z;
  const float* D;       // [W / P]
  const float* scale;   // [W]
  const void* dout;     // backward
  void* out;            // forward: the output; backward: dy
  void* dxs;            // backward
  void* dz;             // backward
  float* rstd;          // [R]: forward writes, backward reads
  float* row;           // [R]: ss (forward) or dot (backward), in or out
  float* slot_scale;    // backward: [blocks][W]
  float* slot_D;        // backward: [blocks][W]
  int R, W, P, rows_per_block;
  float width, eps;
};

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

// the block's sum of each thread's v, in a fixed order; every thread gets it
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* sh) {
  constexpr int WARPS = THREADS / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                    // sh free from any earlier use
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = sh[0];
    for (int i = 1; i < WARPS; ++i) t = __fadd_rn(t, sh[i]);
    sh[WARPS] = t;
  }
  __syncthreads();
  return sh[WARPS];
}

// u, the gate g and v of channel c (floats of T values), and e = exp(-z)
template <typename T>
__device__ __forceinline__ void gate(const GN& a, const T* y, const T* xs,
                                     const T* z, int c, float& u, float& zf,
                                     float& e, float& g, float& v) {
  u = ld(y + c);
  if (xs) {
    const float d = rnd<T>(a.D[c / a.P]);
    u = rnd<T>(__fadd_rn(u, rnd<T>(__fmul_rn(ld(xs + c), d))));
  }
  zf = ld(z + c);
  e = expf(-zf);
  g = rnd<T>(__fdiv_rn(zf, __fadd_rn(1.0f, e)));
  v = rnd<T>(__fmul_rn(u, g));
}

template <typename T, int MODE, int THREADS>
__global__ void __launch_bounds__(THREADS) gn_fwd(const GN a) {
  __shared__ float sh[THREADS / 32 + 1];
  const int r = blockIdx.x;
  const size_t off = (size_t)r * a.W;
  const T* y = (const T*)a.y + off;
  const T* xs = a.xs ? (const T*)a.xs + off : nullptr;
  const T* z = (const T*)a.z + off;
  float u, zf, e, g, v, ss;
  if (MODE != GN_FINISH) {
    float part = 0.0f;
#pragma unroll 4
    for (int c = threadIdx.x; c < a.W; c += THREADS) {
      gate<T>(a, y, xs, z, c, u, zf, e, g, v);
      part = __fadd_rn(part, __fmul_rn(v, v));
    }
    ss = block_sum<THREADS>(part, sh);
    if (MODE == GN_SUM) {
      if (threadIdx.x == 0) a.row[r] = ss;
      return;
    }
  } else {
    ss = a.row[r];
  }
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, a.width), a.eps));
  if (threadIdx.x == 0) a.rstd[r] = rs;
  T* out = (T*)a.out + off;
#pragma unroll 4
  for (int c = threadIdx.x; c < a.W; c += THREADS) {
    gate<T>(a, y, xs, z, c, u, zf, e, g, v);
    st(out + c, __fmul_rn(__fmul_rn(v, rs), a.scale[c]));
  }
}

// slot_scale / slot_D: this block's sums over its rows, one per channel, in
// dynamic shared memory (2 W floats) until the block ends
template <typename T, int MODE>
__global__ void __launch_bounds__(GN_THREADS) gn_bwd(const GN a) {
  __shared__ float sh[GN_THREADS / 32 + 1];
  extern __shared__ float acc[];
  float* acc_s = acc;
  float* acc_d = acc + a.W;
  if (MODE != GN_SUM)
    for (int c = threadIdx.x; c < a.W; c += GN_THREADS) {
      acc_s[c] = 0.0f;
      acc_d[c] = 0.0f;
    }
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.R, r0 + a.rows_per_block);
  float u, zf, e, g, v;
  for (int r = r0; r < r1; ++r) {
    const size_t off = (size_t)r * a.W;
    const T* y = (const T*)a.y + off;
    const T* xs = (const T*)a.xs + off;
    const T* z = (const T*)a.z + off;
    const T* dout = (const T*)a.dout + off;
    const float rs = a.rstd[r];
    float dot;
    if (MODE != GN_FINISH) {
      float part = 0.0f;
      for (int c = threadIdx.x; c < a.W; c += GN_THREADS) {
        gate<T>(a, y, xs, z, c, u, zf, e, g, v);
        part = __fadd_rn(part, __fmul_rn(__fmul_rn(ld(dout + c), a.scale[c]),
                                         v));
      }
      dot = block_sum<GN_THREADS>(part, sh);
      if (MODE == GN_SUM) {
        if (threadIdx.x == 0) a.row[r] = dot;
        continue;
      }
    } else {
      dot = a.row[r];
    }
    const float coef = __fdiv_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(dot, rs), rs), rs), a.width);
    T* dy = (T*)a.out + off;
    T* dxs = (T*)a.dxs + off;
    T* dz = (T*)a.dz + off;
    for (int c = threadIdx.x; c < a.W; c += GN_THREADS) {
      gate<T>(a, y, xs, z, c, u, zf, e, g, v);
      const float d_out = ld(dout + c);
      const float dv = __fsub_rn(__fmul_rn(__fmul_rn(d_out, a.scale[c]), rs),
                                 __fmul_rn(v, coef));
      const float du = __fmul_rn(dv, g);
      const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
      const float dzc = __fmul_rn(
          __fmul_rn(__fmul_rn(dv, u), s),
          __fadd_rn(1.0f, __fmul_rn(zf, __fsub_rn(1.0f, s))));
      st(dy + c, du);
      st(dxs + c, __fmul_rn(du, rnd<T>(a.D[c / a.P])));
      st(dz + c, dzc);
      acc_s[c] = __fadd_rn(acc_s[c], __fmul_rn(d_out, __fmul_rn(v, rs)));
      acc_d[c] = __fadd_rn(acc_d[c], __fmul_rn(du, ld(xs + c)));
    }
  }
  if (MODE == GN_SUM) return;
  const size_t so = (size_t)blockIdx.x * a.W;
  for (int c = threadIdx.x; c < a.W; c += GN_THREADS) {
    a.slot_scale[so + c] = acc_s[c];
    a.slot_D[so + c] = acc_d[c];
  }
}

// dscale[c] and dD[h]: block h adds its P channels' slots in block order,
// then the P channel sums in channel order
__global__ void __launch_bounds__(GN_REDUCE_THREADS)
gn_reduce(const float* slot_scale, const float* slot_D, int n_blocks, int W,
          int P, float* dscale, float* dD) {
  extern __shared__ float ch[];       // [P]
  const int h = blockIdx.x;
  for (int p = threadIdx.x; p < P; p += GN_REDUCE_THREADS) {
    const int c = h * P + p;
    float s = 0.0f, d = 0.0f;
    for (int b = 0; b < n_blocks; ++b) {
      s = __fadd_rn(s, slot_scale[(size_t)b * W + c]);
      d = __fadd_rn(d, slot_D[(size_t)b * W + c]);
    }
    dscale[c] = s;
    ch[p] = d;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int p = 0; p < P; ++p) t = __fadd_rn(t, ch[p]);
    dD[h] = t;
  }
}

// ---------------------------------------------------------------------------
// launchers: dtype 0 float32, 1 bfloat16; mode GN_FUSED, GN_SUM, GN_FINISH;
// each returns cudaGetLastError()
// ---------------------------------------------------------------------------

extern "C" int gn_fwd_launch(int dtype, int mode, int R, int W, int P,
                             float width, float eps, const void* y,
                             const void* xs, const void* z, const float* D,
                             const float* scale, void* out, float* rstd,
                             float* row, void* stream) {
  if (R < 1 || W < 1 || P < 1 || W % P) return (int)cudaErrorInvalidValue;
  GN a = {};
  a.y = y; a.xs = xs; a.z = z; a.D = D; a.scale = scale; a.out = out;
  a.rstd = rstd; a.row = row; a.R = R; a.W = W; a.P = P;
  a.width = width; a.eps = eps;
  cudaStream_t s = (cudaStream_t)stream;
#define GN_FWD_N(T, N)                                                 \
  if (mode == GN_FUSED) gn_fwd<T, GN_FUSED, N><<<R, N, 0, s>>>(a);     \
  else if (mode == GN_SUM) gn_fwd<T, GN_SUM, N><<<R, N, 0, s>>>(a);    \
  else gn_fwd<T, GN_FINISH, N><<<R, N, 0, s>>>(a);
#define GN_FWD(T)                                                      \
  if (R < GN_WIDE_ROWS) {                                              \
    GN_FWD_N(T, GN_WIDE_THREADS)                                       \
  } else {                                                             \
    GN_FWD_N(T, GN_THREADS)                                            \
  }
  if (dtype == 1) {
    GN_FWD(__nv_bfloat16)
  } else {
    GN_FWD(float)
  }
#undef GN_FWD
#undef GN_FWD_N
  return (int)cudaGetLastError();
}

// rows a backward block walks, and so the number of blocks (slots)
extern "C" int gn_bwd_rows_per_block(int R) {
  const int blocks = R < GN_MAX_BLOCKS ? R : GN_MAX_BLOCKS;
  return (R + blocks - 1) / blocks;
}

template <typename T, int MODE>
static int bwd_one(const GN& a, int blocks, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    int err = (int)cudaFuncSetAttribute(
        gn_bwd<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  gn_bwd<T, MODE><<<blocks, GN_THREADS, smem, s>>>(a);
  return 0;
}

// The backward.  mode GN_SUM writes each row's dot into row and nothing
// else; GN_FUSED and GN_FINISH write dy, dxs, dz, dscale [W], dD [W / P],
// using slots (2 * blocks * W floats of scratch).
extern "C" int gn_bwd_launch(int dtype, int mode, int R, int W, int P,
                             float width, const void* y, const void* xs,
                             const void* z, const float* D,
                             const float* scale, const void* dout,
                             const float* rstd, float* row, void* dy,
                             void* dxs, void* dz, float* slots,
                             float* dscale, float* dD, void* stream) {
  if (R < 1 || W < 1 || P < 1 || W % P || !xs || !D)
    return (int)cudaErrorInvalidValue;
  const int rpb = gn_bwd_rows_per_block(R);
  const int blocks = (R + rpb - 1) / rpb;
  GN a = {};
  a.y = y; a.xs = xs; a.z = z; a.D = D; a.scale = scale; a.dout = dout;
  a.out = dy; a.dxs = dxs; a.dz = dz; a.rstd = (float*)rstd; a.row = row;
  a.slot_scale = slots; a.slot_D = slots + (size_t)blocks * W;
  a.R = R; a.W = W; a.P = P; a.rows_per_block = rpb; a.width = width;
  const size_t smem = mode == GN_SUM ? 0 : 2 * (size_t)W * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
#define GN_BWD(T)                                                   \
  if (mode == GN_FUSED) err = bwd_one<T, GN_FUSED>(a, blocks, smem, s); \
  else if (mode == GN_SUM) err = bwd_one<T, GN_SUM>(a, blocks, smem, s); \
  else err = bwd_one<T, GN_FINISH>(a, blocks, smem, s);
  if (dtype == 1) {
    GN_BWD(__nv_bfloat16)
  } else {
    GN_BWD(float)
  }
#undef GN_BWD
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err || mode == GN_SUM) return err;
  const int pt = P < GN_REDUCE_THREADS ? P : GN_REDUCE_THREADS;
  gn_reduce<<<W / P, pt, (size_t)P * sizeof(float), s>>>(
      a.slot_scale, a.slot_D, blocks, W, P, dscale, dD);
  return (int)cudaGetLastError();
}
