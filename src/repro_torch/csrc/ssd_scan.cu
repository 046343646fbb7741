// Mamba-2 SSD chunked scan (K3) for sm_90a.
//
// Replaces the JAX package's Pallas kernel kernels/ssd_scan.py::
// ssd_scan_pallas (pallas_call body _ssd_kernel).  For x [Bt, S, H, P],
// dt [Bt, S, H] (> 0), A [H] (< 0) and B, C [Bt, S, G, N] it computes the
// SSM recurrence
//   state_t = exp(dt_t A) state_{t-1} + B_t^T (dt_t x_t),   y_t = C_t state_t
// chunk by chunk: with dA = dt A, cum its inclusive cumsum over the chunk and
// total = cum[-1],
//   y       = ((C B^T) * exp(cum_i - cum_j) [i >= j]) (x dt)
//           + (C * exp(cum)) state_prev
//   state   = exp(total) state_prev + B^T (x dt exp(total - cum)).
// y is written in x's type, the final state [Bt, H, N, P] in float32.  Head
// h reads B/C group h / (H / G).
//
// Design: the chunk walk is split across blocks, as the model's own chunked
// path decomposes it (models/mamba.py::ssd_chunked).  Three kernels per
// call over chunks of kL positions (64 for float32, 128 for bfloat16)
// whatever the model's chunk (chunking is exact); tail positions past S
// are masked (dt = 0, x = 0), so any S works:
//   1. chunk pass, grid (chunks, H, Bt): dA's cumsum, the chunk's state
//      contribution B^T (x dt exp(total - cum)) [N, P] into the scratch
//      `states` [Bt, chunks, H, N, P] and exp(total) into `decay`;
//   2. state pass, grid (N P / 512, H, Bt): walks the chunks in series per
//      state element in float32, s_c = exp(total_c) s_{c-1} + contrib_c,
//      overwrites each chunk's slot with its incoming state and writes the
//      final state;
//   3. output pass, grid (chunks, H, Bt): y from C, B, x dt and the
//      incoming state.
// The wrapper allocates the scratch; the kernels allocate nothing.  The
// inner chunk is decided here alone: the wrapper reads it from
// ssd_scan_inner_chunk to size the scratch, and ssd_scan_launch refuses a
// chunk count that does not match it.
//
// bfloat16: the four chunk products (C B^T, scores x, C state_prev and
// B^T (x w)) run on the tensor cores, mma.sync m16n8k16 with bf16 operands
// and float32 accumulation, fed by ldmatrix from padded shared tiles.  x, B
// and C enter as they are (exact in bf16); every float32 factor (dt, the
// decays) is folded into the other operand, which is float32 and enters as
// two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), so each such product
// is two mma.  Rounding those operands to bf16 instead, as the model's
// chunked path rounds them, missed the 5e-2 bf16 tolerance against the
// exact recurrence (max abs error 0.11).  The scratch is float32.
// float32: the same grid with float32 FMA products (1e-3 holds only there).
//
// Routes.  kernels/ssd_scan.py::route names one from (N, P, type) and the
// launcher takes exactly that one.  The chunked route above takes the N and
// P the build's SSD_FAST_N_MASK and SSD_FAST_P_MASK list (the wrapper's
// STATE_DIMS and HEAD_DIMS: 64, 128).  The generic route (ssd_scan_generic)
// takes any other N, P whose float32 state fits in shared memory (the
// reduced mamba2's N = P = 16): one block per (batch, head) runs the exact
// per-token recurrence of kernels/ref.py::ssd_ref, one thread per column p
// of the state [N, P] (in shared memory), so y_t[p] = C_t . state[:, p] is
// that thread's own sum; B_t, C_t and x_t are staged in shared memory per
// token.  No scratch.  Bound by the S dependent tokens.
//
// What bounds it.  The inputs' bytes (read once) and the scratch traffic:
// the float32 chunk states are written once, read and rewritten by the
// state pass, and read by the output pass (16 x Bt x chunks x H x N x P
// bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;  // inner chunk of the float32 passes

// inclusive cumsum of dA = dt * A over a chunk of L, by warp 0: L / 32
// consecutive positions per lane, then a scan of the lanes' sums
template <int L>
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cum,
                                             float a_h, int tid) {
  constexpr int kPer = L / 32;
  if (tid < 32) {
    float v[kPer];
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      run += dts[kPer * tid + u] * a_h;
      v[u] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += up;
    }
    const float before = incl - run;
#pragma unroll
    for (int u = 0; u < kPer; ++u) cum[kPer * tid + u] = before + v[u];
  }
}

// ---------------------------------------------------------------------------
// state pass (both types): the only serial walk, elementwise in float32
// ---------------------------------------------------------------------------

constexpr int kStateThreads = 128;  // 4 state elements per thread
constexpr int kStateAhead = 16;     // chunks loaded ahead per thread

__global__ void __launch_bounds__(kStateThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               float* __restrict__ state_out, int nc, int H, int NP) {
  const int e = 4 * (blockIdx.x * kStateThreads + threadIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= NP) return;
  const long long step = (long long)H * NP;
  float* slot = states + ((long long)b * nc * H + h) * NP + e;
  const float* dec = decay + (long long)b * nc * H + h;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kStateAhead) {
    float4 contrib[kStateAhead];
    float carry[kStateAhead];
#pragma unroll
    for (int u = 0; u < kStateAhead; ++u) {
      if (c0 + u < nc) {
        contrib[u] = *reinterpret_cast<const float4*>(slot + (c0 + u) * step);
        carry[u] = dec[(long long)(c0 + u) * H];
      }
    }
#pragma unroll
    for (int u = 0; u < kStateAhead; ++u) {
      if (c0 + u < nc) {
        // the chunk's slot now holds its incoming state
        *reinterpret_cast<float4*>(slot + (c0 + u) * step) = s;
        s.x = carry[u] * s.x + contrib[u].x;
        s.y = carry[u] * s.y + contrib[u].y;
        s.z = carry[u] * s.z + contrib[u].z;
        s.w = carry[u] * s.w + contrib[u].w;
      }
    }
  }
  *reinterpret_cast<float4*>(state_out + ((long long)b * H + h) * NP + e) = s;
}

// ---------------------------------------------------------------------------
// float32: FMA chunk and output passes, 256 threads (16 x 16) per block
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kStride = kL + 4;

// B^T [N][kStride]; x dt [kL][P]; cum, dt [kL]
template <int N, int P>
constexpr size_t chunk_smem() {
  return sizeof(float) * (N * kStride + kL * P + 2 * kL);
}

// B^T, C^T [N][kStride]; x dt [kL][P]; scores^T [kL][kStride]; state [N][P];
// cum, dt [kL]
template <int N, int P>
constexpr size_t output_smem() {
  return sizeof(float) *
         (2 * N * kStride + kL * P + kL * kStride + N * P + 2 * kL);
}

// dt of the chunk, B^T (and C^T) and x dt into shared memory; zero past S
template <int N, int P, bool kWithC>
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* bt,
    float* ct, float* xdt, float* dts, int b, int c0, int h, int grp, int S,
    int H, int G, int tid) {
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
      bv = Bm[off];
      if (kWithC) cv = Cm[off];
    }
    bt[n * kStride + i] = bv;
    if (kWithC) ct[n * kStride + i] = cv;
  }
  __syncthreads();
  for (int idx = tid; idx < kL * P; idx += kThreads) {
    const int i = idx / P, p = idx % P;
    const int t = c0 + i;
    xdt[idx] = t < S ? x[(((long long)b * S + t) * H + h) * P + p] * dts[i] : 0.f;
  }
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_fma(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              float* __restrict__ states, float* __restrict__ decay, int S,
              int H, int G) {
  constexpr int kPc = P / 64;  // groups of 4 p-columns per thread
  constexpr int kNr = N / 16;  // state rows per thread
  extern __shared__ float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);  // [N][kStride]
  float* xdt = bt + N * kStride;                // [kL][P]
  float* cum = xdt + kL * P;                    // [kL]
  float* dts = cum + kL;                        // [kL]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  load_chunk<N, P, false>(x, dt, Bm, nullptr, bt, nullptr, xdt, dts, b,
                          c * kL, h, grp, S, H, G, tid);
  chunk_cumsum<kL>(dts, cum, A[h], tid);
  __syncthreads();
  const float total = cum[kL - 1];
  for (int idx = tid; idx < kL * P; idx += kThreads)
    xdt[idx] *= expf(total - cum[idx / P]);
  __syncthreads();

  // contribution B^T (x dt exp(total - cum)); rows ty + 16 r
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
  float* out = states + (((long long)b * nc + c) * H + h) * N * P;
  for (int r = 0; r < kNr; ++r)
    for (int q = 0; q < kPc; ++q)
      for (int e = 0; e < 4; ++e)
        out[(ty + 16 * r) * P + 64 * q + 4 * tx + e] = acc[r][q][e];
  if (tid == 0) decay[((long long)b * nc + c) * H + h] = expf(total);
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_output_fma(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ states,
               float* __restrict__ y, int S, int H, int G) {
  constexpr int kPc = P / 64;
  extern __shared__ float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);  // [N][kStride]
  float* ct = bt + N * kStride;                 // [N][kStride]
  float* xdt = ct + N * kStride;                // [kL][P]
  float* sc = xdt + kL * P;                     // scores^T [kL(j)][kStride(i)]
  float* st = sc + kL * kStride;                // [N][P]
  float* cum = st + N * P;                      // [kL]
  float* dts = cum + kL;                        // [kL]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int c0 = c * kL;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float* prev = states + (((long long)b * nc + c) * H + h) * N * P;
  for (int idx = tid; idx < N * P; idx += kThreads) st[idx] = prev[idx];
  load_chunk<N, P, true>(x, dt, Bm, Cm, bt, ct, xdt, dts, b, c0, h, grp, S,
                         H, G, tid);
  chunk_cumsum<kL>(dts, cum, A[h], tid);
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
        sc[jj * kStride + ii] = ii >= jj ? s[i][j] * expf(cum[ii] - cum[jj]) : 0.f;
      }
    }
  }
  __syncthreads();

  // y = scores (x dt) + exp(cum) * (C state_prev)
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
    float* out = y + (((long long)b * S + t) * H + h) * P;
    for (int q = 0; q < kPc; ++q)
      for (int e = 0; e < 4; ++e)
        out[64 * q + 4 * tx + e] = yi[i][q][e] + decay_in * yo[i][q][e];
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor-core chunk and output passes, 8 warps per block
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr int kL = 128;  // inner chunk of the tensor-core passes
constexpr int kThreads = 256;  // 8 warps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// a float32 pair as two bf16 pairs whose sum carries ~16 bits of it
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// c += (a_hi + a_lo) . b: a float32 operand on bf16 tensor cores
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint32_t b0,
                                     uint32_t b1) {
  mma(c, hi, b0, b1);
  mma(c, lo, b0, b1);
}

// Shared tiles, rows padded by 8 bf16 (16 bytes) so the 8 rows of an
// ldmatrix land in distinct banks.  Both passes keep dt and dA's cumsum.
// The chunk pass holds B and x, then stages its float32 result [N][P + 4]
// in the same bytes.  The output pass holds C throughout; its second
// region first holds the incoming state as a hi and a lo bf16 tile, then
// B and x (two phases keep four blocks on an SM).
template <int N, int P>
struct Tiles {
  static constexpr int kPN = N + 8;   // pitch of B, C rows [kL][kPN]
  static constexpr int kPP = P + 8;   // pitch of x [kL][kPP], state [N][kPP]
  static constexpr int kPS = P + 4;   // pitch of the float32 staging [N][kPS]
  static constexpr size_t kRowsBC = sizeof(bf16) * kL * kPN;
  static constexpr size_t kRowsX = sizeof(bf16) * kL * kPP;
  static constexpr size_t kState = sizeof(bf16) * N * kPP;
  static constexpr size_t kCum = 0;                          // float [kL]
  static constexpr size_t kDt = kCum + sizeof(float) * kL;   // float [kL]
  static constexpr size_t kB = kDt + sizeof(float) * kL;     // chunk pass
  static constexpr size_t kX = kB + kRowsBC;
  static constexpr size_t kStage = kB;
  static constexpr size_t kChunkBytes =
      kB + cmax(kRowsBC + kRowsX, sizeof(float) * N * kPS);
  static constexpr size_t kC = kB;                           // output pass
  static constexpr size_t kR = kC + kRowsBC;
  static constexpr size_t kSHi = kR, kSLo = kR + kState;
  static constexpr size_t kOB = kR, kOX = kR + kRowsBC;
  static constexpr size_t kOutputBytes = kR + cmax(2 * kState, kRowsBC + kRowsX);
};

// one 16-byte group of 8 bf16 values, or zeros
__device__ __forceinline__ uint4 load8(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// rows c0 .. c0 + kL - 1 of B or C (group grp) into [kL][N + 8]; zero past S
template <int N>
__device__ __forceinline__ void load_bc(const bf16* __restrict__ src, bf16* dst,
                                        int b, int c0, int grp, int S, int G,
                                        int tid) {
  for (int idx = tid; idx < kL * N / 8; idx += kThreads) {
    const int i = idx / (N / 8), n8 = idx % (N / 8);
    const int t = c0 + i;
    const long long off = (((long long)b * S + t) * G + grp) * N + n8 * 8;
    *reinterpret_cast<uint4*>(dst + i * (N + 8) + n8 * 8) = load8(src + off, t < S);
  }
}

// rows c0 .. c0 + kL - 1 of x (head h) into [kL][P + 8]; zero past S
template <int P>
__device__ __forceinline__ void load_x(const bf16* __restrict__ x, bf16* dst,
                                       int b, int c0, int h, int S, int H,
                                       int tid) {
  for (int idx = tid; idx < kL * P / 8; idx += kThreads) {
    const int i = idx / (P / 8), p8 = idx % (P / 8);
    const int t = c0 + i;
    *reinterpret_cast<uint4*>(dst + i * (P + 8) + p8 * 8) =
        load8(x + (((long long)b * S + t) * H + h) * P + p8 * 8, t < S);
  }
}

// dt of the chunk (zero past S); after the barrier, dA's cumsum
__device__ __forceinline__ void load_dt_cum(const float* __restrict__ dt,
                                            float a_h, float* dts, float* cum,
                                            int b, int c0, int h, int S, int H,
                                            int tid) {
  if (tid < kL) {
    const int t = c0 + tid;
    dts[tid] = t < S ? dt[((long long)b * S + t) * H + h] : 0.f;
  }
  __syncthreads();
  chunk_cumsum<kL>(dts, cum, a_h, tid);
  __syncthreads();
}

// chunk pass: states[n][p] = sum_i (B[i][n] w_i) x[i][p] with
// w_i = dt_i exp(total - cum_i); the 8 warps tile [N][P] as kWM x kWP
template <int N, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              float* __restrict__ states, float* __restrict__ decay, int S,
              int H, int G) {
  using Tl = Tiles<N, P>;
  constexpr int kWM = N / 16 < 8 ? N / 16 : 8;  // warps along the state rows
  constexpr int kWP = 8 / kWM;                   // warps along P
  constexpr int kMT = N / 16 / kWM;              // 16-row m-tiles per warp
  constexpr int kPT = P / 8 / kWP;               // 8-column n-tiles per warp
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int c0 = c * kL;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;

  float* cum = reinterpret_cast<float*>(smem + Tl::kCum);
  float* dts = reinterpret_cast<float*>(smem + Tl::kDt);
  load_bc<N>(Bm, reinterpret_cast<bf16*>(smem + Tl::kB), b, c0, grp, S, G, tid);
  load_x<P>(x, reinterpret_cast<bf16*>(smem + Tl::kX), b, c0, h, S, H, tid);
  load_dt_cum(dt, A[h], dts, cum, b, c0, h, S, H, tid);
  const float total = cum[kL - 1];
  const uint32_t bs = smem_u32(smem + Tl::kB);
  const uint32_t xs = smem_u32(smem + Tl::kX);
  const int n_base = (warp % kWM) * kMT * 16;
  const int p_base = (warp / kWM) * kPT * 8;
  float acc[kMT][kPT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][pt][e] = 0.f;

#pragma unroll
  for (int ks = 0; ks < kL / 16; ++ks) {
    // this thread's four positions of the k-step and their weights
    const int k0 = 16 * ks + 2 * qd;
    const float w0 = dts[k0] * expf(total - cum[k0]);
    const float w1 = dts[k0 + 1] * expf(total - cum[k0 + 1]);
    const float w8 = dts[k0 + 8] * expf(total - cum[k0 + 8]);
    const float w9 = dts[k0 + 9] * expf(total - cum[k0 + 9]);
    uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      // A = B^T: stored [k = i][m = n], transposed by ldmatrix
      uint32_t raw[4];
      const int row = 16 * ks + (lane % 8) + 8 * (lane / 16);
      const int col = n_base + 16 * mt + 8 * ((lane / 8) % 2);
      ldsm_x4_t(raw, bs + 2 * (row * Tl::kPN + col));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack_bf16(raw[r]);
        const float wa = r < 2 ? w0 : w8, wb = r < 2 ? w1 : w9;
        split(v.x * wa, v.y * wb, ahi[mt][r], alo[mt][r]);
      }
    }
#pragma unroll
    for (int np = 0; np < kPT / 2; ++np) {
      // B = x: stored [k = i][n = p]
      uint32_t r[4];
      const int row = 16 * ks + (lane % 8) + 8 * ((lane / 8) % 2);
      const int col = p_base + 16 * np + 8 * (lane / 16);
      ldsm_x4_t(r, xs + 2 * (row * Tl::kPP + col));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma2(acc[mt][2 * np], ahi[mt], alo[mt], r[0], r[1]);
        mma2(acc[mt][2 * np + 1], ahi[mt], alo[mt], r[2], r[3]);
      }
    }
  }

  // stage the [N][P] result in shared memory, then write it in full rows
  __syncthreads();  // B and x fully read
  float* stage = reinterpret_cast<float*>(smem + Tl::kStage);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt) {
      const int n = n_base + 16 * mt + g, p = p_base + 8 * pt + 2 * qd;
      *reinterpret_cast<float2*>(stage + n * Tl::kPS + p) =
          make_float2(acc[mt][pt][0], acc[mt][pt][1]);
      *reinterpret_cast<float2*>(stage + (n + 8) * Tl::kPS + p) =
          make_float2(acc[mt][pt][2], acc[mt][pt][3]);
    }
  __syncthreads();
  float* out = states + (((long long)b * nc + c) * H + h) * N * P;
  for (int idx = tid; idx < N * P / 4; idx += kThreads) {
    const int n = idx / (P / 4), p4 = idx % (P / 4);
    *reinterpret_cast<float4*>(out + n * P + 4 * p4) =
        *reinterpret_cast<const float4*>(stage + n * Tl::kPS + 4 * p4);
  }
  if (tid == 0) decay[((long long)b * nc + c) * H + h] = expf(total);
}

// output pass: y[i] = exp(cum_i) C_i state_prev
//                     + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[j];
// warp w owns chunk rows 16 w .. 16 w + 15; keys go in groups of 64
template <int N, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_output_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, const float* __restrict__ states,
               bf16* __restrict__ y, int S, int H, int G) {
  using Tl = Tiles<N, P>;
  constexpr int kKS = N / 16;  // k-steps over the state dim
  constexpr int kPT = P / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int c0 = c * kL;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;

  float* cum = reinterpret_cast<float*>(smem + Tl::kCum);
  float* dts = reinterpret_cast<float*>(smem + Tl::kDt);
  // phase 1: C and the chunk's incoming state [N][P] as a hi and a lo tile
  load_bc<N>(Cm, reinterpret_cast<bf16*>(smem + Tl::kC), b, c0, grp, S, G, tid);
  {
    bf16* shi = reinterpret_cast<bf16*>(smem + Tl::kSHi);
    bf16* slo = reinterpret_cast<bf16*>(smem + Tl::kSLo);
    const float* prev = states + (((long long)b * nc + c) * H + h) * N * P;
    for (int idx = tid; idx < N * P / 4; idx += kThreads) {
      const int n = idx / (P / 4), p4 = idx % (P / 4);
      const float4 v = *reinterpret_cast<const float4*>(prev + n * P + p4 * 4);
      uint2 hi, lo;
      split(v.x, v.y, hi.x, lo.x);
      split(v.z, v.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(shi + n * Tl::kPP + p4 * 4) = hi;
      *reinterpret_cast<uint2*>(slo + n * Tl::kPP + p4 * 4) = lo;
    }
  }
  load_dt_cum(dt, A[h], dts, cum, b, c0, h, S, H, tid);

  const uint32_t bs = smem_u32(smem + Tl::kOB);
  const uint32_t cs = smem_u32(smem + Tl::kC);
  const uint32_t xs = smem_u32(smem + Tl::kOX);
  const uint32_t shi = smem_u32(smem + Tl::kSHi);
  const uint32_t slo = smem_u32(smem + Tl::kSLo);
  const int i0 = 16 * warp;

  // this warp's 16 rows of C as the A fragment of state-dim k-step ks
  const uint32_t c_row = cs + 2 * ((i0 + (lane % 8) + 8 * ((lane / 8) % 2)) *
                                       Tl::kPN + 8 * (lane / 16));

  // inter-chunk part first: exp(cum_i) (C state_prev)
  float yacc[kPT][4];
#pragma unroll
  for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    uint32_t ca[4];
    ldsm_x4(ca, c_row + 2 * 16 * ks);
#pragma unroll
    for (int np = 0; np < P / 16; ++np) {
      uint32_t rh[4], rl[4];  // B = state: stored [k = n][n = p]
      const int row = 16 * ks + (lane % 8) + 8 * ((lane / 8) % 2);
      const int col = 16 * np + 8 * (lane / 16);
      ldsm_x4_t(rh, shi + 2 * (row * Tl::kPP + col));
      ldsm_x4_t(rl, slo + 2 * (row * Tl::kPP + col));
      mma(yacc[2 * np], ca, rh[0], rh[1]);
      mma(yacc[2 * np], ca, rl[0], rl[1]);
      mma(yacc[2 * np + 1], ca, rh[2], rh[3]);
      mma(yacc[2 * np + 1], ca, rl[2], rl[3]);
    }
  }
  const float cumA = cum[i0 + g], cumB = cum[i0 + g + 8];
  const float eA = expf(cumA), eB = expf(cumB);
#pragma unroll
  for (int pt = 0; pt < kPT; ++pt) {
    yacc[pt][0] *= eA;
    yacc[pt][1] *= eA;
    yacc[pt][2] *= eB;
    yacc[pt][3] *= eB;
  }

  // phase 2: B and x where the state tiles were
  __syncthreads();
  load_bc<N>(Bm, reinterpret_cast<bf16*>(smem + Tl::kOB), b, c0, grp, S, G, tid);
  load_x<P>(x, reinterpret_cast<bf16*>(smem + Tl::kOX), b, c0, h, S, H, tid);
  __syncthreads();

  // scores = C B^T over the keys j <= this warp's rows, 64 keys at a time
  // (16-key tiles jt <= warp), then scores exp(cum_i - cum_j) dt_j, causal,
  // in float32 as hi + lo, times x
#pragma unroll
  for (int half = 0; half < kL / 64; ++half) {
    if (4 * half > warp) break;
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t ca[4];
      ldsm_x4(ca, c_row + 2 * 16 * ks);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int jt = 4 * half + np;
        if (jt > warp) break;
        uint32_t r[4];  // B = B^T: stored [n = j][k = state]
        const int row = 16 * jt + (lane % 8) + 8 * (lane / 16);
        const int col = 16 * ks + 8 * ((lane / 8) % 2);
        ldsm_x4(r, bs + 2 * (row * Tl::kPN + col));
        mma(sc[2 * np], ca, r[0], r[1]);
        mma(sc[2 * np + 1], ca, r[2], r[3]);
      }
    }
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
      const int jt = 4 * half + kj;
      if (jt > warp) break;
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        const int nt = 2 * kj + sub;
        const int j = 16 * jt + 8 * sub + 2 * qd;
        const int iA = i0 + g, iB = iA + 8;
        const float v0 = iA >= j ? sc[nt][0] * expf(cumA - cum[j]) * dts[j] : 0.f;
        const float v1 = iA >= j + 1 ? sc[nt][1] * expf(cumA - cum[j + 1]) * dts[j + 1] : 0.f;
        const float v2 = iB >= j ? sc[nt][2] * expf(cumB - cum[j]) * dts[j] : 0.f;
        const float v3 = iB >= j + 1 ? sc[nt][3] * expf(cumB - cum[j + 1]) * dts[j + 1] : 0.f;
        split(v0, v1, ahi[2 * sub], alo[2 * sub]);
        split(v2, v3, ahi[2 * sub + 1], alo[2 * sub + 1]);
      }
#pragma unroll
      for (int np = 0; np < P / 16; ++np) {
        uint32_t r[4];  // B = x: stored [k = j][n = p]
        const int row = 16 * jt + (lane % 8) + 8 * ((lane / 8) % 2);
        const int col = 16 * np + 8 * (lane / 16);
        ldsm_x4_t(r, xs + 2 * (row * Tl::kPP + col));
        mma2(yacc[2 * np], ahi, alo, r[0], r[1]);
        mma2(yacc[2 * np + 1], ahi, alo, r[2], r[3]);
      }
    }
  }

  const int tA = c0 + i0 + g, tB = tA + 8;
#pragma unroll
  for (int pt = 0; pt < kPT; ++pt) {
    const int p = 8 * pt + 2 * qd;
    if (tA < S)
      *reinterpret_cast<uint32_t*>(y + (((long long)b * S + tA) * H + h) * P + p) =
          pack_bf16(yacc[pt][0], yacc[pt][1]);
    if (tB < S)
      *reinterpret_cast<uint32_t*>(y + (((long long)b * S + tB) * H + h) * P + p) =
          pack_bf16(yacc[pt][2], yacc[pt][3]);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// generic route: the exact per-token recurrence, any N and P
// ---------------------------------------------------------------------------

namespace gen {

constexpr int kThreads = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// floats of shared memory: state [N][P], B_t and C_t [N], x_t [P]
inline size_t smem_bytes(int N, int P) {
  return sizeof(float) * ((size_t)N * P + 2 * N + P);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_generic(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y,
                 float* __restrict__ state_out, int S, int H, int G, int N,
                 int P) {
  extern __shared__ float sm[];
  float* st = sm;             // [N][P]
  float* bs = st + N * P;     // [N]
  float* cs = bs + N;         // [N]
  float* xs = cs + N;         // [P]
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;
  const float a = A[h];
  for (int t = 0; t < S; ++t) {
    __syncthreads();  // the previous token's B, C and x fully read
    const long long row = (long long)b * S + t;
    const long long bc = (row * G + grp) * N;
    const long long xo = (row * H + h) * P;
    for (int i = tid; i < N; i += kThreads) {
      bs[i] = widen(Bm[bc + i]);
      cs[i] = widen(Cm[bc + i]);
    }
    for (int i = tid; i < P; i += kThreads) xs[i] = widen(x[xo + i]);
    __syncthreads();
    const float d = dt[row * H + h];
    const float dA = expf(d * a);
    for (int p = tid; p < P; p += kThreads) {
      const float dx = d * xs[p];
      float acc = 0.f;
      for (int n = 0; n < N; ++n) {
        const float s = st[n * P + p] * dA + bs[n] * dx;
        st[n * P + p] = s;
        acc += cs[n] * s;
      }
      store(y + xo + p, acc);
    }
  }
  __syncthreads();
  float* out = state_out + ((long long)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) out[e] = st[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int Bt, int S, int H, int G,
           int N, int P, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, P);
  if (cudaError_t e = cudaFuncSetAttribute(
          ssd_scan_generic<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem))
    return (int)e;
  ssd_scan_generic<T><<<dim3(H, Bt), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, S, H, G, N, P);
  return (int)cudaGetLastError();
}

}  // namespace gen

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
constexpr int inner_chunk() { return sizeof(T) == 4 ? kL : tc::kL; }

template <typename T, int N, int P>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, float* states, float* decay,
           int Bt, int S, int H, int G, cudaStream_t stream) {
  constexpr int L = inner_chunk<T>();
  const int nc = (S + L - 1) / L;
  const dim3 chunk_grid(nc, H, Bt);
  const dim3 state_grid(N * P / (4 * kStateThreads), H, Bt);
  static bool configured = false;
  if constexpr (sizeof(T) == 4) {
    constexpr size_t s1 = f32::chunk_smem<N, P>(), s3 = f32::output_smem<N, P>();
    if (!configured) {
      if (int e = set_smem(f32::ssd_chunk_fma<N, P>, s1)) return e;
      if (int e = set_smem(f32::ssd_output_fma<N, P>, s3)) return e;
      configured = true;
    }
    f32::ssd_chunk_fma<N, P><<<chunk_grid, f32::kThreads, s1, stream>>>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
        states, decay, S, H, G);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    ssd_state_pass<<<state_grid, kStateThreads, 0, stream>>>(
        states, decay, state, nc, H, N * P);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    f32::ssd_output_fma<N, P><<<chunk_grid, f32::kThreads, s3, stream>>>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), states, static_cast<float*>(y), S, H, G);
  } else {
    using bf16 = __nv_bfloat16;
    constexpr size_t s1 = tc::Tiles<N, P>::kChunkBytes;
    constexpr size_t s3 = tc::Tiles<N, P>::kOutputBytes;
    if (!configured) {
      if (int e = set_smem(tc::ssd_chunk_mma<N, P>, s1)) return e;
      if (int e = set_smem(tc::ssd_output_mma<N, P>, s3)) return e;
      configured = true;
    }
    tc::ssd_chunk_mma<N, P><<<chunk_grid, tc::kThreads, s1, stream>>>(
        static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
        states, decay, S, H, G);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    ssd_state_pass<<<state_grid, kStateThreads, 0, stream>>>(
        states, decay, state, nc, H, N * P);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    tc::ssd_output_mma<N, P><<<chunk_grid, tc::kThreads, s3, stream>>>(
        static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), states, static_cast<bf16*>(y), S, H, G);
  }
  return (int)cudaGetLastError();
}

// The chunked route's N and P: bit d / 64 - 1 set for each.
// kernels/ssd_scan.py owns the sets (STATE_DIMS, HEAD_DIMS) and passes them
// to nvcc as -DSSD_FAST_N_MASK and -DSSD_FAST_P_MASK; each listed (N, P)
// instantiates the chunked kernels, and the launcher takes the chunked
// route at exactly these.  The chunked kernels are written for 64 and 128.
#if !defined(SSD_FAST_N_MASK) || !defined(SSD_FAST_P_MASK)
#error "build with -DSSD_FAST_N_MASK and -DSSD_FAST_P_MASK (bit d / 64 - 1 per dim)"
#endif

constexpr bool listed(unsigned mask, int d) {
  return (d == 64 || d == 128) && ((mask >> (d / 64 - 1)) & 1u);
}

template <typename T, int N, int P>
int launch_chunked(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* state,
                   float* states, float* decay, int Bt, int S, int H, int G,
                   cudaStream_t stream) {
  if constexpr (listed(SSD_FAST_N_MASK, N) && listed(SSD_FAST_P_MASK, P))
    return launch<T, N, P>(x, dt, A, Bm, Cm, y, state, states, decay, Bt, S,
                           H, G, stream);
  return -1;
}

template <typename T, int N>
int dispatch_p(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, float* state, float* states,
               float* decay, int Bt, int S, int H, int G, int P,
               cudaStream_t stream) {
  if (P == 64)
    return launch_chunked<T, N, 64>(x, dt, A, Bm, Cm, y, state, states, decay, Bt, S, H, G, stream);
  if (P == 128)
    return launch_chunked<T, N, 128>(x, dt, A, Bm, Cm, y, state, states, decay, Bt, S, H, G, stream);
  return -1;
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, void* y, float* state, float* states, float* decay,
             int Bt, int S, int H, int G, int N, int P, cudaStream_t stream) {
  if (!listed(SSD_FAST_N_MASK, N) || !listed(SSD_FAST_P_MASK, P)) return -1;
  if (N == 64)
    return dispatch_p<T, 64>(x, dt, A, Bm, Cm, y, state, states, decay, Bt, S, H, G, P, stream);
  if (N == 128)
    return dispatch_p<T, 128>(x, dt, A, Bm, Cm, y, state, states, decay, Bt, S, H, G, P, stream);
  return -1;
}

}  // namespace

// The inner chunk L for inputs of `dtype` (0 float32, 1 bfloat16); -1 for
// another type.
extern "C" int ssd_scan_inner_chunk(int dtype) {
  if (dtype == 0) return inner_chunk<float>();
  if (dtype == 1) return inner_chunk<__nv_bfloat16>();
  return -1;
}

// route: 0 chunked (N and P as listed), 1 generic (any N, P whose state
// fits in shared memory), as kernels/ssd_scan.py::route names it.  dtype
// (of x, B, C and y): 0 float32, 1 bfloat16.  On the chunked route the
// float32 scratch `states` holds Bt x nc x H x N x P elements and `decay`
// Bt x nc x H, with nc = ceil(S / L) chunks of ssd_scan_inner_chunk(dtype)
// positions; the generic route takes no scratch (nc 0, null pointers).
// Returns a CUDA error code (0 on success); -1 for a route, shape or type
// the kernel does not take or a scratch sized for another chunk count, -3
// for a bf16 pointer that is not 16-byte aligned (chunked).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, void* states, void* decay, int Bt,
                               int S, int H, int G, int N, int P, int dtype,
                               int nc, int route, cudaStream_t stream) {
  if (Bt <= 0 || S <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0)
    return -1;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (route == 1) {
    if (nc != 0) return -1;
    if (dtype == 0)
      return gen::launch<float>(x, dtf, Af, Bm, Cm, y, sf, Bt, S, H, G, N, P,
                                stream);
    if (dtype == 1)
      return gen::launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, sf, Bt, S, H,
                                        G, N, P, stream);
    return -1;
  }
  if (route != 0) return -1;
  const int L = ssd_scan_inner_chunk(dtype);
  if (L <= 0 || nc != (S + L - 1) / L) return -1;
  float* df = static_cast<float*>(decay);
  float* cf = static_cast<float*>(states);
  if (dtype == 0)
    return dispatch<float>(x, dtf, Af, Bm, Cm, y, sf, cf, df, Bt, S, H, G,
                           N, P, stream);
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
         reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(y) |
         reinterpret_cast<uintptr_t>(states)) % 16)
      return -3;
    return dispatch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, sf, cf, df, Bt,
                                   S, H, G, N, P, stream);
  }
  return -1;
}
