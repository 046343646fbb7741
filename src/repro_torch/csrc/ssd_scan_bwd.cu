// Backward of the Mamba-2 SSD scan (K3) for sm_90a.
//
// The JAX package has no backward kernel for its Pallas scan
// (kernels/ssd_scan.py::ssd_scan_pallas): its training step differentiates
// models/mamba.py::ssd_chunked, which XLA fuses.  This file is the scan's
// gradient as kernels, so that training runs the SSD through K3 in both
// directions (kernels/ops.py::SSDScan).  For the forward of ssd_scan.cu
//   state_t = exp(dt_t A) state_{t-1} + B_t^T (dt_t x_t),   y_t = C_t state_t
// and the cotangents dy [Bt, S, H, P] and dfinal [Bt, H, N, P] (or none) it
// gives dx (x's type), ddt [Bt, S, H] and dA [H] (float32), dB and dC
// [Bt, S, G, N] (B's type).  kernels/ssd_scan.py::ssd_scan_backward_plain
// is the same decomposition in eager float32, the oracle.
//
// Chunked route (N, P as the forward's chunked route), chunks of L
// positions (64; 32 for float32 inputs at N = P = 128, so that a chunk's
// float32 tiles fit shared memory), dA = dt A, cum its inclusive cumsum
// over the chunk, total = cum[-1], e_j = exp(total - cum_j),
// W_ij = exp(cum_i - cum_j) [i >= j]:
//   1. chunk pass, grid (chunks, H, Bt): the chunk's state contribution
//      B^T (x dt e) and its cotangent contribution C^T (dy exp(cum)), both
//      [N, P], and exp(total);
//   2. state passes, grid (N P / 512, H, Bt): forward over the chunks, each
//      slot becomes its chunk's incoming state S_prev; in reverse, seeded by
//      dfinal, dS_{c-1} = exp(total_c) dS_c + contribution_c, each slot
//      becomes the cotangent dS of its chunk's outgoing state;
//   3. gradient pass, grid (chunks, H, Bt), per chunk and head:
//        scores = C B^T, M = dy x^T, SW = scores W, MW = M W dt_j,
//        dx_j  = dt_j (e_j (B dS)_j + (SW^T dy)_j)
//        dB_j  = dt_j e_j (dS x_j)  + (MW^T C)_j        (this head's part)
//        dC_i  = exp(cum_i) (S_prev dy_i) + (MW B)_i    (this head's part)
//        dcum  = rowsum(SW M dt_j) - colsum(SW M dt_j) - e dt (x . B dS)
//                + exp(cum) (dy . C S_prev), and at the last position
//                dtotal = sum_j e_j dt_j (x_j . (B dS)_j) + exp(total)
//                <S_prev, dS>,
//        d(dA) = the reverse cumsum of dcum, ddt = x . dx / dt + A d(dA),
//        and this chunk's part of dA, sum_j dt_j d(dA)_j;
//   4. reductions: dB and dC summed over the H / G heads of each group in
//      head order, dA over batch and chunks in order.  No float atomics:
//      two calls give the same bits.
// bfloat16 inputs: the chunk and gradient passes run their products on the
// tensor cores (mma.sync m16n8k16, bf16 operands, float32 accumulation,
// ldmatrix from padded tiles), as the forward's passes do; x, B, C and dy
// enter as they are, every float32 operand (states, cotangents, SW, MW,
// the chunk weights) as hi = bf16(v) plus lo = bf16(v - hi), two mma per
// product.  float32 inputs: the same passes on float32 FMAs from shared
// memory, tiles stored with their columns XOR-swizzled by the row so that
// row and column walks both meet 16 distinct banks.  Positions past S load
// as zeros (dt = 0), so any S works.
//
// Generic route (any other N, P whose state and cotangent fit shared
// memory together): one block per (batch, head) runs the exact per-token
// recurrence forward, keeping the state at the start of every segment of
// kSeg tokens (global scratch), then walks the segments in reverse: it
// recomputes a segment's states from its checkpoint into a second scratch
// and runs the adjoint
//   G_t = exp(dt_{t+1} A) G_{t+1} + C_t^T dy_t   (G seeded by dfinal)
// token by token in reverse, one thread per column p of G [N, P] in shared
// memory.  Sums over p go through shared memory in a fixed order.
//
// What bounds it.  The inputs' and outputs' bytes read and written once;
// the chunked route adds its float32 scratch (chunk states and cotangents
// written, walked and read: 24 x Bt x chunks x H x N x P bytes) and the
// per-head dB/dC partials (16 x Bt x S x H x N bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kThreads = 256;  // chunk and gradient passes: 16 x 16

// chunk length of the chunked route: 64 for bf16 inputs (tensor-core
// passes); for float32 inputs 64, or 32 at N = P = 128 so that the FMA
// gradient pass's float32 tiles fit shared memory
template <typename T, int N, int P>
__host__ __device__ constexpr int chunk_len() {
  return sizeof(T) == 2 || N * P <= 128 * 64 ? 64 : 32;
}

// element (r, c) of a [rows][COLS] float tile, COLS a multiple of 32, its
// column XOR-swizzled by the row: a walk along a row or down a column of
// 16 (or 32) consecutive elements meets distinct banks
template <int COLS>
__device__ __forceinline__ int sw(int r, int c) {
  return r * COLS + (c ^ (r & 31));
}

// inclusive cumsum of dA = dt * A over a chunk of L, by warp 0
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

// the sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// acc[r][q] += sum_k a(ty + 16 r, k) b(k, tx + 16 q), a and b reading
// shared memory
template <int R, int Q, typename FA, typename FB>
__device__ __forceinline__ void gemm(float (&acc)[R][Q], int K, FA a, FB b,
                                     int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[R], bv[Q];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = a(ty + 16 * r, k);
#pragma unroll
    for (int q = 0; q < Q; ++q) bv[q] = b(k, tx + 16 * q);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

template <int R, int Q>
__device__ __forceinline__ void zero(float (&acc)[R][Q]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[r][q] = 0.f;
}

// rows c0 .. c0 + L - 1 of a [Bt, S, per_t, W] tensor (row `sub` of each
// position) into a swizzled [L][W] float tile, times scale(i); zero
// past S
template <int L, int W, typename T, typename FS>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* dst, int b, int c0, int sub,
                                          int per_t, int S, int tid,
                                          FS scale) {
  for (int idx = tid; idx < L * W; idx += kThreads) {
    const int i = idx / W, w = idx % W;
    const int t = c0 + i;
    float v = 0.f;
    if (t < S)
      v = widen(src[(((long long)b * S + t) * per_t + sub) * W + w]) *
          scale(i);
    dst[sw<W>(i, w)] = v;
  }
}

// dt of the chunk (zero past S) and, after the barrier, dA's cumsum
template <int L>
__device__ __forceinline__ void load_dt_cum(const float* __restrict__ dt,
                                            float a_h, float* dts, float* cum,
                                            int b, int c0, int h, int S,
                                            int H, int tid) {
  if (tid < L) {
    const int t = c0 + tid;
    dts[tid] = t < S ? dt[((long long)b * S + t) * H + h] : 0.f;
  }
  __syncthreads();
  chunk_cumsum<L>(dts, cum, a_h, tid);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// chunked route, float32 inputs: FMA passes (bf16 inputs: namespace tcb)
// ---------------------------------------------------------------------------

// 1. chunk pass: states[n][p] = sum_i B_i[n] dt_i e_i x_i[p] and
//    dstates[n][p] = sum_i C_i[n] exp(cum_i) dy_i[p]; decay = exp(total)
template <int N, int P>
constexpr size_t chunk_smem() {
  constexpr int L = chunk_len<float, N, P>();
  return sizeof(float) * (2 * L * N + 2 * L * P + 2 * L);
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_pass(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ dy,
               float* __restrict__ states, float* __restrict__ dstates,
               float* __restrict__ decay, int S, int H, int G) {
  constexpr int L = chunk_len<float, N, P>();
  constexpr int R = N / 16, Q = P / 16;
  extern __shared__ float4 smem4[];
  float* bw = reinterpret_cast<float*>(smem4);  // [L][N] B dt e
  float* ce = bw + L * N;                       // [L][N] C exp(cum)
  float* xs = ce + L * N;                       // [L][P]
  float* dys = xs + L * P;                      // [L][P]
  float* cum = dys + L * P;                     // [L]
  float* dts = cum + L;                         // [L]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, c0 = c * L;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_dt_cum<L>(dt, A[h], dts, cum, b, c0, h, S, H, tid);
  const float total = cum[L - 1];
  load_rows<L, N>(Bm, bw, b, c0, grp, G, S, tid, [&](int i) {
    return dts[i] * expf(total - cum[i]);
  });
  load_rows<L, N>(Cm, ce, b, c0, grp, G, S, tid,
                  [&](int i) { return expf(cum[i]); });
  load_rows<L, P>(x, xs, b, c0, h, H, S, tid, [](int) { return 1.f; });
  load_rows<L, P>(dy, dys, b, c0, h, H, S, tid, [](int) { return 1.f; });
  __syncthreads();
  const long long slot = (((long long)b * nc + c) * H + h) * N * P;
  float acc[R][Q];
  zero(acc);
  gemm(acc, L, [&](int n, int i) { return bw[sw<N>(i, n)]; },
       [&](int i, int p) { return xs[sw<P>(i, p)]; }, ty, tx);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q)
      states[slot + (ty + 16 * r) * P + tx + 16 * q] = acc[r][q];
  zero(acc);
  gemm(acc, L, [&](int n, int i) { return ce[sw<N>(i, n)]; },
       [&](int i, int p) { return dys[sw<P>(i, p)]; }, ty, tx);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q)
      dstates[slot + (ty + 16 * r) * P + tx + 16 * q] = acc[r][q];
  if (tid == 0) decay[((long long)b * nc + c) * H + h] = expf(total);
}

// 2. state passes: the only serial walks, elementwise in float32.  Forward:
//    slot_c <- the state entering chunk c.  Reverse, from `seed` (or zero):
//    slot_c <- the cotangent of the state leaving chunk c.
constexpr int kStateThreads = 128;  // 4 state elements per thread

template <bool kReverse>
__global__ void __launch_bounds__(kStateThreads)
bwd_state_pass(float* __restrict__ slots, const float* __restrict__ decay,
               const float* __restrict__ seed, int nc, int H, int NP) {
  const int e = 4 * (blockIdx.x * kStateThreads + threadIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= NP) return;
  const long long step = (long long)H * NP;
  float* base = slots + ((long long)b * nc * H + h) * NP + e;
  const float* dec = decay + (long long)b * nc * H + h;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kReverse && seed != nullptr)
    s = *reinterpret_cast<const float4*>(seed + ((long long)b * H + h) * NP + e);
  for (int u = 0; u < nc; ++u) {
    const int c = kReverse ? nc - 1 - u : u;
    float* slot = base + c * step;
    const float4 contrib = *reinterpret_cast<const float4*>(slot);
    const float carry = dec[(long long)c * H];
    *reinterpret_cast<float4*>(slot) = s;
    s.x = carry * s.x + contrib.x;
    s.y = carry * s.y + contrib.y;
    s.z = carry * s.z + contrib.z;
    s.w = carry * s.w + contrib.w;
  }
}

// 3. gradient pass
template <int N, int P>
constexpr size_t grad_smem() {
  constexpr int L = chunk_len<float, N, P>();
  // B, C [L][N]; x, dy [L][P]; S_prev or dS [N][P] (first the T matrix
  // [L][L]); SW, MW [L][L]; dts, cum, dcum, u, ddtx, csdy, dda [L]; 8 warp
  // sums and <S_prev, dS>
  return sizeof(float) *
         (2 * L * N + 2 * L * P + N * P + 2 * L * L + 7 * L + 8 + 1);
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
bwd_grad_pass(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ states,
              const float* __restrict__ dstates, float* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ dbh,
              float* __restrict__ dch, float* __restrict__ da_part, int S,
              int H, int G) {
  constexpr int L = chunk_len<float, N, P>();
  static_assert(L * L <= N * P, "the T matrix lives in the state tile");
  constexpr int R = L / 16;  // output rows per thread (positions)
  constexpr int QL = L / 16, QN = N / 16, QP = P / 16;
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);  // [L][N]
  float* cs = bs + L * N;                       // [L][N]
  float* xs = cs + L * N;                       // [L][P]
  float* dys = xs + L * P;                      // [L][P]
  float* mat = dys + L * P;                     // [N][P]; first T [L][L]
  float* swm = mat + N * P;                     // [L][L] SW
  float* mwm = swm + L * L;                     // [L][L] MW dt_j
  float* dts = mwm + L * L;                     // [L]
  float* cum = dts + L;
  float* dcum = cum + L;
  float* uvec = dcum + L;
  float* ddtx = uvec + L;
  float* csdy = ddtx + L;
  float* dda = csdy + L;
  float* red = dda + L;                         // [8] warp sums, then [8]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, c0 = c * L;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid / 32, lane = tid % 32;
  const float a_h = A[h];
  const long long slot = (((long long)b * nc + c) * H + h) * N * P;

  load_dt_cum<L>(dt, a_h, dts, cum, b, c0, h, S, H, tid);
  const float total = cum[L - 1];
  auto one = [](int) { return 1.f; };
  load_rows<L, N>(Bm, bs, b, c0, grp, G, S, tid, one);
  load_rows<L, N>(Cm, cs, b, c0, grp, G, S, tid, one);
  load_rows<L, P>(x, xs, b, c0, h, H, S, tid, one);
  load_rows<L, P>(dy, dys, b, c0, h, H, S, tid, one);
  __syncthreads();

  // scores = C B^T and M = dy x^T on one tiling; SW, MW dt_j and
  // T = SW M dt_j
  {
    float sc[R][QL], mm[R][QL];
    zero(sc);
    zero(mm);
    gemm(sc, N, [&](int i, int n) { return cs[sw<N>(i, n)]; },
         [&](int n, int j) { return bs[sw<N>(j, n)]; }, ty, tx);
    gemm(mm, P, [&](int i, int p) { return dys[sw<P>(i, p)]; },
         [&](int p, int j) { return xs[sw<P>(j, p)]; }, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < QL; ++q) {
        const int i = ty + 16 * r, j = tx + 16 * q;
        const float w = i >= j ? expf(cum[i] - cum[j]) : 0.f;
        const float s = sc[r][q] * w;
        swm[sw<L>(i, j)] = s;
        mwm[sw<L>(i, j)] = mm[r][q] * w * dts[j];
        mat[sw<L>(i, j)] = s * dts[j] * mm[r][q];
      }
  }
  __syncthreads();
  if (tid < L) {  // row sums minus column sums of T, in index order
    float row = 0.f, col = 0.f;
    for (int k = 0; k < L; ++k) {
      row += mat[sw<L>(tid, k)];
      col += mat[sw<L>(k, tid)];
    }
    dcum[tid] = row - col;
  }
  __syncthreads();  // T fully read

  // dS into the state tile, and <S_prev, dS>
  {
    float sd = 0.f;
    for (int idx = tid; idx < N * P; idx += kThreads) {
      const float v = dstates[slot + idx];
      sd = fmaf(states[slot + idx], v, sd);
      mat[sw<P>(idx / P, idx % P)] = v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    if (lane == 0) red[warp] = sd;
  }
  __syncthreads();
  if (tid == 0) {
    float sd = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sd += red[w];
    red[8] = sd;
  }

  // dx: e_j (B dS)_j + (SW^T dy)_j, times dt_j; u_j = e_j dt_j x_j . (B dS)_j
  {
    float acc[R][QP];
    zero(acc);
    gemm(acc, N, [&](int j, int n) { return bs[sw<N>(j, n)]; },
         [&](int n, int p) { return mat[sw<P>(n, p)]; }, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = ty + 16 * r;
      const float e = expf(total - cum[j]);
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < QP; ++q) {
        part = fmaf(acc[r][q], xs[sw<P>(j, tx + 16 * q)], part);
        acc[r][q] *= e;
      }
      part = row_sum16(part);
      if (tx == 0) uvec[j] = e * dts[j] * part;
    }
    gemm(acc, L, [&](int j, int i) { return swm[sw<L>(i, j)]; },
         [&](int i, int p) { return dys[sw<P>(i, p)]; }, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = ty + 16 * r, t = c0 + j;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < QP; ++q) {
        const int p = tx + 16 * q;
        part = fmaf(acc[r][q], xs[sw<P>(j, p)], part);
        if (t < S)
          store(dx + (((long long)b * S + t) * H + h) * P + p,
                dts[j] * acc[r][q]);
      }
      part = row_sum16(part);
      if (tx == 0) ddtx[j] = part;
    }
  }

  // this head's dB: dt_j e_j (dS x_j) + (MW^T C)_j
  {
    float acc[R][QN];
    zero(acc);
    gemm(acc, P, [&](int j, int p) { return xs[sw<P>(j, p)]; },
         [&](int p, int n) { return mat[sw<P>(n, p)]; }, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = ty + 16 * r;
      const float f = dts[j] * expf(total - cum[j]);
#pragma unroll
      for (int q = 0; q < QN; ++q) acc[r][q] *= f;
    }
    gemm(acc, L, [&](int j, int i) { return mwm[sw<L>(i, j)]; },
         [&](int i, int n) { return cs[sw<N>(i, n)]; }, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = c0 + ty + 16 * r;
      if (t >= S) continue;
#pragma unroll
      for (int q = 0; q < QN; ++q)
        dbh[(((long long)b * S + t) * H + h) * N + tx + 16 * q] = acc[r][q];
    }
  }
  __syncthreads();  // dS fully read

  for (int idx = tid; idx < N * P; idx += kThreads)
    mat[sw<P>(idx / P, idx % P)] = states[slot + idx];
  __syncthreads();

  // this head's dC: exp(cum_i) (S_prev dy_i) + (MW B)_i
  {
    float acc[R][QN];
    zero(acc);
    gemm(acc, P, [&](int i, int p) { return dys[sw<P>(i, p)]; },
         [&](int p, int n) { return mat[sw<P>(n, p)]; }, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float f = expf(cum[ty + 16 * r]);
#pragma unroll
      for (int q = 0; q < QN; ++q) acc[r][q] *= f;
    }
    gemm(acc, L, [&](int i, int j) { return mwm[sw<L>(i, j)]; },
         [&](int j, int n) { return bs[sw<N>(j, n)]; }, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = c0 + ty + 16 * r;
      if (t >= S) continue;
#pragma unroll
      for (int q = 0; q < QN; ++q)
        dch[(((long long)b * S + t) * H + h) * N + tx + 16 * q] = acc[r][q];
    }
  }

  // exp(cum_i) dy_i . (C S_prev)_i
  {
    float acc[R][QP];
    zero(acc);
    gemm(acc, N, [&](int i, int n) { return cs[sw<N>(i, n)]; },
         [&](int n, int p) { return mat[sw<P>(n, p)]; }, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = ty + 16 * r;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < QP; ++q)
        part = fmaf(acc[r][q], dys[sw<P>(i, tx + 16 * q)], part);
      part = row_sum16(part);
      if (tx == 0) csdy[i] = expf(cum[i]) * part;
    }
  }
  __syncthreads();

  // dcum, its reverse cumsum d(dA), ddt and this chunk's part of dA
  if (tid == 0) {
    float dtotal = 0.f;
    for (int j = 0; j < L; ++j) dtotal += uvec[j];
    dtotal += expf(total) * red[8];
    float run = 0.f, da = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      run += dcum[k] - uvec[k] + csdy[k] + (k == L - 1 ? dtotal : 0.f);
      dda[k] = run;
      da = fmaf(dts[k], run, da);
    }
    da_part[((long long)b * nc + c) * H + h] = da;
  }
  __syncthreads();
  if (tid < L && c0 + tid < S)
    ddt[((long long)b * S + c0 + tid) * H + h] = ddtx[tid] + a_h * dda[tid];
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: the chunk and gradient passes on the tensor cores,
// mma.sync m16n8k16 with bf16 operands and float32 accumulation, fed by
// ldmatrix from padded shared tiles, as the forward's tensor-core passes
// are.  x, B, C and dy enter as they are (exact in bf16); every float32
// operand (a chunk's state or cotangent, SW and MW, the chunk weights)
// enters as two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), so each
// such product is two mma.  Chunks of 64 positions at every (N, P).
// ---------------------------------------------------------------------------

namespace tcb {

constexpr int L = 64;

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

// Fragments of a bf16 tile with row pitch `pitch` (elements) at shared
// address `base`.  A (16 x 16 at rows m0, columns k0) of a tile stored
// [m][k] or [k][m]; B (k0 .. k0 + 15 by the two n-tiles n0, n0 + 8) of a
// tile stored [k][n] or [n][k].
__device__ __forceinline__ void a_mk(uint32_t (&a)[4], uint32_t base,
                                     int pitch, int m0, int k0, int lane) {
  ldsm_x4(a, base + 2 * ((m0 + (lane % 8) + 8 * ((lane / 8) % 2)) * pitch +
                         k0 + 8 * (lane / 16)));
}
__device__ __forceinline__ void a_km(uint32_t (&a)[4], uint32_t base,
                                     int pitch, int m0, int k0, int lane) {
  ldsm_x4_t(a, base + 2 * ((k0 + (lane % 8) + 8 * (lane / 16)) * pitch +
                           m0 + 8 * ((lane / 8) % 2)));
}
__device__ __forceinline__ void b_kn(uint32_t (&b)[4], uint32_t base,
                                     int pitch, int k0, int n0, int lane) {
  ldsm_x4_t(b, base + 2 * ((k0 + (lane % 8) + 8 * ((lane / 8) % 2)) * pitch +
                           n0 + 8 * (lane / 16)));
}
__device__ __forceinline__ void b_nk(uint32_t (&b)[4], uint32_t base,
                                     int pitch, int k0, int n0, int lane) {
  ldsm_x4(b, base + 2 * ((n0 + (lane % 8) + 8 * (lane / 16)) * pitch + k0 +
                         8 * ((lane / 8) % 2)));
}

// One operand of a product: a bf16 tile (hi), and for a float32 operand
// its lo tile; `kn` says how it is stored ([m][k] or [k][n]: true).
struct Op {
  uint32_t hi, lo;
  int pitch;
};

// acc[nt] (the n-tiles n0 + 8 nt) += A[m0 .. m0 + 15][0 .. K) . B[0 .. K)[.]
// with A stored [m][k] (kAMK) or [k][m], B stored [k][n] (kBKN) or [n][k];
// kALo / kBLo: the operand is float32 as hi + lo (never both)
template <int NT, bool kAMK, bool kALo, bool kBKN, bool kBLo>
__device__ __forceinline__ void mm(float (&acc)[NT][4], int K, Op A, int m0,
                                   Op B, int n0, int lane) {
  static_assert(NT % 2 == 0 && !(kALo && kBLo), "two n-tiles a load");
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4], a2[4];
    if (kAMK) a_mk(a, A.hi, A.pitch, m0, k0, lane);
    else a_km(a, A.hi, A.pitch, m0, k0, lane);
    if (kALo) {
      if (kAMK) a_mk(a2, A.lo, A.pitch, m0, k0, lane);
      else a_km(a2, A.lo, A.pitch, m0, k0, lane);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      if (kBKN) b_kn(b, B.hi, B.pitch, k0, n0 + 16 * np, lane);
      else b_nk(b, B.hi, B.pitch, k0, n0 + 16 * np, lane);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
      if (kALo) {
        mma(acc[2 * np], a2, b[0], b[1]);
        mma(acc[2 * np + 1], a2, b[2], b[3]);
      }
      if (kBLo) {
        if (kBKN) b_kn(b, B.lo, B.pitch, k0, n0 + 16 * np, lane);
        else b_nk(b, B.lo, B.pitch, k0, n0 + 16 * np, lane);
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// rows c0 .. c0 + L - 1 of a [Bt, S, per_t, W] bf16 tensor (row `sub` of
// each position) into a [L][W + 8] tile; zero past S
template <int W>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          uint8_t* dst, int b, int c0,
                                          int sub, int per_t, int S,
                                          int tid) {
  for (int idx = tid; idx < L * W / 8; idx += kThreads) {
    const int i = idx / (W / 8), w8 = idx % (W / 8);
    const int t = c0 + i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < S)
      v = *reinterpret_cast<const uint4*>(
          src + (((long long)b * S + t) * per_t + sub) * W + w8 * 8);
    *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(dst) + i * (W + 8) +
                              w8 * 8) = v;
  }
}

// a float32 [N][P] matrix into a hi and a lo bf16 tile [N][P + 8]; with
// `dot`, also the thread's part of <src, dot>
template <int N, int P>
__device__ __forceinline__ float load_split(const float* __restrict__ src,
                                            const float* __restrict__ dot,
                                            uint8_t* hi_tile,
                                            uint8_t* lo_tile, int tid) {
  bf16* shi = reinterpret_cast<bf16*>(hi_tile);
  bf16* slo = reinterpret_cast<bf16*>(lo_tile);
  float acc = 0.f;
  for (int idx = tid; idx < N * P / 4; idx += kThreads) {
    const int n = idx / (P / 4), p4 = idx % (P / 4);
    const float4 v = *reinterpret_cast<const float4*>(src + n * P + 4 * p4);
    if (dot != nullptr) {
      const float4 d = *reinterpret_cast<const float4*>(dot + n * P + 4 * p4);
      acc = fmaf(v.x, d.x, fmaf(v.y, d.y, fmaf(v.z, d.z, fmaf(v.w, d.w, acc))));
    }
    uint2 h, l;
    split(v.x, v.y, h.x, l.x);
    split(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(shi + n * (P + 8) + 4 * p4) = h;
    *reinterpret_cast<uint2*>(slo + n * (P + 8) + 4 * p4) = l;
  }
  return acc;
}

// 1. chunk pass: states[n][p] = sum_i (B_i[n] dt_i e_i) x_i[p] and
//    dstates[n][p] = sum_i (C_i[n] exp(cum_i)) dy_i[p]; the 8 warps tile
//    [N][P] as kWM x kWP
template <int N, int P>
struct ChunkTiles {
  static constexpr size_t kB = 2 * sizeof(float) * L;  // after dts, cum
  static constexpr size_t kC = kB + 2 * L * (N + 8);
  static constexpr size_t kX = kC + 2 * L * (N + 8);
  static constexpr size_t kDY = kX + 2 * L * (P + 8);
  static constexpr size_t kBytes = kDY + 2 * L * (P + 8);
};

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
bwd_chunk_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
              float* __restrict__ states, float* __restrict__ dstates,
              float* __restrict__ decay, int S, int H, int G) {
  using Tl = ChunkTiles<N, P>;
  constexpr int kWM = N / 16 < 8 ? N / 16 : 8;  // warps along the state rows
  constexpr int kWP = 8 / kWM;                   // warps along P
  constexpr int kMT = N / 16 / kWM;              // 16-row m-tiles per warp
  constexpr int kPT = P / 8 / kWP;               // 8-column n-tiles per warp
  extern __shared__ __align__(16) uint8_t smem[];
  float* dts = reinterpret_cast<float*>(smem);
  float* cum = dts + L;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, c0 = c * L;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  load_tile<N>(Bm, smem + Tl::kB, b, c0, grp, G, S, tid);
  load_tile<N>(Cm, smem + Tl::kC, b, c0, grp, G, S, tid);
  load_tile<P>(x, smem + Tl::kX, b, c0, h, H, S, tid);
  load_tile<P>(dy, smem + Tl::kDY, b, c0, h, H, S, tid);
  load_dt_cum<L>(dt, A[h], dts, cum, b, c0, h, S, H, tid);
  const float total = cum[L - 1];
  const int n_base = (warp % kWM) * kMT * 16;
  const int p_base = (warp / kWM) * kPT * 8;
  const long long slot = (((long long)b * nc + c) * H + h) * N * P;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    // A = (B w)^T or (C exp(cum))^T: stored [k = i][m = n], the position's
    // weight folded in as hi + lo; B = x or dy: stored [k = i][n = p]
    const uint32_t as = smem_u32(smem + (which ? Tl::kC : Tl::kB));
    const uint32_t bs = smem_u32(smem + (which ? Tl::kDY : Tl::kX));
    float acc[kMT][kPT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) zero(acc[mt]);
#pragma unroll
    for (int ks = 0; ks < L / 16; ++ks) {
      const int k0 = 16 * ks + 2 * qd;
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = k0 + (u & 1) + 8 * (u >> 1);
        w[u] = which ? expf(cum[i]) : dts[i] * expf(total - cum[i]);
      }
      uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t raw[4];
        a_km(raw, as, N + 8, n_base + 16 * mt, 16 * ks, lane);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack_bf16(raw[r]);
          const float wa = r < 2 ? w[0] : w[2], wb = r < 2 ? w[1] : w[3];
          split(v.x * wa, v.y * wb, ahi[mt][r], alo[mt][r]);
        }
      }
#pragma unroll
      for (int np = 0; np < kPT / 2; ++np) {
        uint32_t r[4];
        b_kn(r, bs, P + 8, 16 * ks, p_base + 16 * np, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(acc[mt][2 * np], ahi[mt], r[0], r[1]);
          mma(acc[mt][2 * np], alo[mt], r[0], r[1]);
          mma(acc[mt][2 * np + 1], ahi[mt], r[2], r[3]);
          mma(acc[mt][2 * np + 1], alo[mt], r[2], r[3]);
        }
      }
    }
    float* out = (which ? dstates : states) + slot;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt) {
        const int n = n_base + 16 * mt + g, p = p_base + 8 * pt + 2 * qd;
        *reinterpret_cast<float2*>(out + n * P + p) =
            make_float2(acc[mt][pt][0], acc[mt][pt][1]);
        *reinterpret_cast<float2*>(out + (n + 8) * P + p) =
            make_float2(acc[mt][pt][2], acc[mt][pt][3]);
      }
  }
  if (tid == 0) decay[((long long)b * nc + c) * H + h] = expf(total);
}

// 3. gradient pass.  Warp w owns rows 16 (w % 4) .. + 15 of every [L][.]
//    product and one half of its columns (w / 4: colh).
template <int N, int P>
struct GradTiles {
  static constexpr int kPN = N + 8, kPP = P + 8, kPL = L + 8;
  static constexpr size_t kB = 0;                          // bf16 [L][kPN]
  static constexpr size_t kC = kB + 2 * L * kPN;
  static constexpr size_t kX = kC + 2 * L * kPN;           // bf16 [L][kPP]
  static constexpr size_t kDY = kX + 2 * L * kPP;
  static constexpr size_t kSH = kDY + 2 * L * kPP;         // bf16 [N][kPP]
  static constexpr size_t kSL = kSH + 2 * N * kPP;
  static constexpr size_t kWH = kSL + 2 * N * kPP;         // bf16 [L][kPL]
  static constexpr size_t kWL = kWH + 2 * L * kPL;
  static constexpr size_t kMH = kWL + 2 * L * kPL;
  static constexpr size_t kML = kMH + 2 * L * kPL;
  static constexpr size_t kT = kML + 2 * L * kPL;          // float [L][L+1]
  static constexpr size_t kV = kT + sizeof(float) * L * (L + 1);
  // floats at kV: dts, cum, dcum, dda [L]; part [3][2][L]; red [9]
  static constexpr size_t kBytes = kV + sizeof(float) * (10 * L + 9);
};

// the sum over the 4 lanes of a quad (one fragment row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// sum over this thread's columns of acc . tile (bf16 [L][pitch]), rows g
// and g + 8 of the warp's m-tile, reduced over the quad
template <int NT>
__device__ __forceinline__ float2 row_dots(const float (&acc)[NT][4],
                                           const bf16* tile, int pitch,
                                           int i0, int n0, int qd) {
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + 8 * nt + 2 * qd;
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(tile + i0 * pitch + col));
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(tile + (i0 + 8) * pitch +
                                                 col));
    r0 = fmaf(acc[nt][0], u.x, fmaf(acc[nt][1], u.y, r0));
    r1 = fmaf(acc[nt][2], v.x, fmaf(acc[nt][3], v.y, r1));
  }
  return make_float2(quad_sum(r0), quad_sum(r1));
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
bwd_grad_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const float* __restrict__ states,
             const float* __restrict__ dstates, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ dbh,
             float* __restrict__ dch, float* __restrict__ da_part, int S,
             int H, int G) {
  using Tl = GradTiles<N, P>;
  constexpr int kPN = Tl::kPN, kPP = Tl::kPP, kPL = Tl::kPL;
  constexpr int NTL = L / 16, NTN = N / 16, NTP = P / 16;  // n-tiles a warp
  extern __shared__ __align__(16) uint8_t smem[];
  float* tm = reinterpret_cast<float*>(smem + Tl::kT);
  float* dts = reinterpret_cast<float*>(smem + Tl::kV);
  float* cum = dts + L;
  float* dcum = cum + L;
  float* dda = dcum + L;
  float* part = dda + L;             // [3][2][L]: u, x . dxdt, dy . C S
  float* red = part + 6 * L;         // [8] warp sums, [8] <S_prev, dS>
  const bf16* xs = reinterpret_cast<const bf16*>(smem + Tl::kX);
  const bf16* dys = reinterpret_cast<const bf16*>(smem + Tl::kDY);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, c0 = c * L;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int m0 = 16 * (warp % 4), colh = warp / 4;
  const int i0 = m0 + g, i1 = i0 + 8;
  const float a_h = A[h];
  const long long slot = (((long long)b * nc + c) * H + h) * N * P;
  const Op opB{smem_u32(smem + Tl::kB), 0u, kPN};
  const Op opC{smem_u32(smem + Tl::kC), 0u, kPN};
  const Op opX{smem_u32(smem + Tl::kX), 0u, kPP};
  const Op opDY{smem_u32(smem + Tl::kDY), 0u, kPP};
  const Op opS{smem_u32(smem + Tl::kSH), smem_u32(smem + Tl::kSL), kPP};
  const Op opSW{smem_u32(smem + Tl::kWH), smem_u32(smem + Tl::kWL), kPL};
  const Op opMW{smem_u32(smem + Tl::kMH), smem_u32(smem + Tl::kML), kPL};

  load_tile<N>(Bm, smem + Tl::kB, b, c0, grp, G, S, tid);
  load_tile<N>(Cm, smem + Tl::kC, b, c0, grp, G, S, tid);
  load_tile<P>(x, smem + Tl::kX, b, c0, h, H, S, tid);
  load_tile<P>(dy, smem + Tl::kDY, b, c0, h, H, S, tid);
  {  // dS into the state tiles, and <S_prev, dS>
    float sd = load_split<N, P>(dstates + slot, states + slot,
                                smem + Tl::kSH, smem + Tl::kSL, tid);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    if (lane == 0) red[warp] = sd;
  }
  load_dt_cum<L>(dt, a_h, dts, cum, b, c0, h, S, H, tid);
  const float total = cum[L - 1];

  // scores = C B^T and M = dy x^T on one tiling; SW, MW dt_j (hi + lo)
  // and T = SW M dt_j
  {
    const int n0 = colh * (L / 2);
    float sc[NTL][4], mv[NTL][4];
    zero(sc);
    zero(mv);
    mm<NTL, true, false, false, false>(sc, N, opC, m0, opB, n0, lane);
    mm<NTL, true, false, false, false>(mv, P, opDY, m0, opX, n0, lane);
    bf16* swh = reinterpret_cast<bf16*>(smem + Tl::kWH);
    bf16* swl = reinterpret_cast<bf16*>(smem + Tl::kWL);
    bf16* mwh = reinterpret_cast<bf16*>(smem + Tl::kMH);
    bf16* mwl = reinterpret_cast<bf16*>(smem + Tl::kML);
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int j = n0 + 8 * nt + 2 * qd;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = rr ? i1 : i0;
        float s[2], m[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = j + e;
          const float w = i >= jj ? expf(cum[i] - cum[jj]) : 0.f;
          s[e] = sc[nt][2 * rr + e] * w;
          m[e] = mv[nt][2 * rr + e] * w * dts[jj];
          tm[i * (L + 1) + jj] = s[e] * dts[jj] * mv[nt][2 * rr + e];
        }
        uint32_t hi, lo;
        split(s[0], s[1], hi, lo);
        *reinterpret_cast<uint32_t*>(swh + i * kPL + j) = hi;
        *reinterpret_cast<uint32_t*>(swl + i * kPL + j) = lo;
        split(m[0], m[1], hi, lo);
        *reinterpret_cast<uint32_t*>(mwh + i * kPL + j) = hi;
        *reinterpret_cast<uint32_t*>(mwl + i * kPL + j) = lo;
      }
    }
  }
  __syncthreads();
  if (tid < L) {  // row sums minus column sums of T, in index order
    float row = 0.f, col = 0.f;
    for (int k = 0; k < L; ++k) {
      row += tm[tid * (L + 1) + k];
      col += tm[k * (L + 1) + tid];
    }
    dcum[tid] = row - col;
  }

  const float e0 = expf(total - cum[i0]), e1 = expf(total - cum[i1]);
  const float d0 = dts[i0], d1 = dts[i1];
  const int t0 = c0 + i0, t1 = c0 + i1;
  // dx: e_j (B dS)_j + (SW^T dy)_j, times dt_j; u_j = e_j dt_j x_j . (B dS)_j
  {
    const int n0 = colh * (P / 2);
    float acc[NTP][4];
    zero(acc);
    mm<NTP, true, false, true, true>(acc, N, opB, m0, opS, n0, lane);
    const float2 u = row_dots(acc, xs, kPP, i0, n0, qd);
    if (qd == 0) {
      part[colh * L + i0] = e0 * d0 * u.x;
      part[colh * L + i1] = e1 * d1 * u.y;
    }
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
    mm<NTP, false, true, true, false>(acc, L, opSW, m0, opDY, n0, lane);
    const float2 r = row_dots(acc, xs, kPP, i0, n0, qd);
    if (qd == 0) {
      part[(2 + colh) * L + i0] = r.x;
      part[(2 + colh) * L + i1] = r.y;
    }
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      const int p = n0 + 8 * nt + 2 * qd;
      if (t0 < S)
        *reinterpret_cast<uint32_t*>(dx + (((long long)b * S + t0) * H + h) * P + p) =
            pack_bf16(d0 * acc[nt][0], d0 * acc[nt][1]);
      if (t1 < S)
        *reinterpret_cast<uint32_t*>(dx + (((long long)b * S + t1) * H + h) * P + p) =
            pack_bf16(d1 * acc[nt][2], d1 * acc[nt][3]);
    }
  }

  // this head's dB: dt_j e_j (dS x_j) + (MW^T C)_j
  {
    const int n0 = colh * (N / 2);
    float acc[NTN][4];
    zero(acc);
    mm<NTN, true, false, false, true>(acc, P, opX, m0, opS, n0, lane);
    const float f0 = d0 * e0, f1 = d1 * e1;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      acc[nt][0] *= f0;
      acc[nt][1] *= f0;
      acc[nt][2] *= f1;
      acc[nt][3] *= f1;
    }
    mm<NTN, false, true, true, false>(acc, L, opMW, m0, opC, n0, lane);
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int n = n0 + 8 * nt + 2 * qd;
      if (t0 < S)
        *reinterpret_cast<float2*>(dbh + (((long long)b * S + t0) * H + h) * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (t1 < S)
        *reinterpret_cast<float2*>(dbh + (((long long)b * S + t1) * H + h) * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();  // dS fully read
  load_split<N, P>(states + slot, nullptr, smem + Tl::kSH, smem + Tl::kSL,
                   tid);
  __syncthreads();

  // this head's dC: exp(cum_i) (S_prev dy_i) + (MW B)_i
  {
    const int n0 = colh * (N / 2);
    float acc[NTN][4];
    zero(acc);
    mm<NTN, true, false, false, true>(acc, P, opDY, m0, opS, n0, lane);
    const float f0 = expf(cum[i0]), f1 = expf(cum[i1]);
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      acc[nt][0] *= f0;
      acc[nt][1] *= f0;
      acc[nt][2] *= f1;
      acc[nt][3] *= f1;
    }
    mm<NTN, true, true, true, false>(acc, L, opMW, m0, opB, n0, lane);
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int n = n0 + 8 * nt + 2 * qd;
      if (t0 < S)
        *reinterpret_cast<float2*>(dch + (((long long)b * S + t0) * H + h) * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (t1 < S)
        *reinterpret_cast<float2*>(dch + (((long long)b * S + t1) * H + h) * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }

  // exp(cum_i) dy_i . (C S_prev)_i
  {
    const int n0 = colh * (P / 2);
    float acc[NTP][4];
    zero(acc);
    mm<NTP, true, false, true, true>(acc, N, opC, m0, opS, n0, lane);
    const float2 r = row_dots(acc, dys, kPP, i0, n0, qd);
    if (qd == 0) {
      part[(4 + colh) * L + i0] = expf(cum[i0]) * r.x;
      part[(4 + colh) * L + i1] = expf(cum[i1]) * r.y;
    }
  }
  __syncthreads();

  // dcum, its reverse cumsum d(dA), ddt and this chunk's part of dA
  if (tid == 0) {
    float sd = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sd += red[w];
    float dtotal = 0.f;
    for (int j = 0; j < L; ++j) dtotal += part[j] + part[L + j];
    dtotal += expf(total) * sd;
    float run = 0.f, da = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      run += dcum[k] - (part[k] + part[L + k]) +
             (part[4 * L + k] + part[5 * L + k]) +
             (k == L - 1 ? dtotal : 0.f);
      dda[k] = run;
      da = fmaf(dts[k], run, da);
    }
    da_part[((long long)b * nc + c) * H + h] = da;
  }
  __syncthreads();
  if (tid < L && c0 + tid < S)
    ddt[((long long)b * S + c0 + tid) * H + h] =
        part[2 * L + tid] + part[3 * L + tid] + a_h * dda[tid];
}

}  // namespace tcb

// ---------------------------------------------------------------------------
// generic route: the per-token recurrence in reverse
// ---------------------------------------------------------------------------

constexpr int kGenThreads = 128;
constexpr int kSeg = 64;  // tokens per checkpointed segment

inline size_t generic_smem(int N, int P) {
  return sizeof(float) * (2 * (size_t)N * P + 2 * N + 4 * P);
}

// ckpt [Bt, H, segments, N, P]: the state before each segment's first
// token; segst [Bt, H, kSeg, N, P]: the states after each token of the
// segment being walked
template <typename T>
__global__ void __launch_bounds__(kGenThreads)
bwd_generic(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const T* __restrict__ dy,
            const float* __restrict__ dfinal, T* __restrict__ dx,
            float* __restrict__ ddt, float* __restrict__ dbh,
            float* __restrict__ dch, float* __restrict__ ckpt,
            float* __restrict__ segst, float* __restrict__ da_part, int S,
            int H, int G, int N, int P) {
  extern __shared__ float sm[];
  float* st = sm;              // [N][P] state
  float* gs = st + N * P;      // [N][P] cotangent
  float* bsv = gs + N * P;     // [N]
  float* csv = bsv + N;        // [N]
  float* xsv = csv + N;        // [P]
  float* dyv = xsv + P;        // [P]
  float* r1 = dyv + P;         // [P] x . dx / dt partials
  float* r2 = r1 + P;          // [P] <G, state_{t-1}> partials
  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int NP = N * P;
  const int nseg = (S + kSeg - 1) / kSeg;
  const float a_h = A[h];
  float* my_ckpt = ckpt + ((long long)b * H + h) * nseg * NP;
  float* my_seg = segst + ((long long)b * H + h) * kSeg * NP;

  auto load_bc = [&](int t) {
    const long long bc = (((long long)b * S + t) * G + grp) * N;
    for (int i = tid; i < N; i += kGenThreads) {
      bsv[i] = widen(Bm[bc + i]);
      csv[i] = widen(Cm[bc + i]);
    }
  };
  auto load_x = [&](int t) {
    const long long xo = (((long long)b * S + t) * H + h) * P;
    for (int i = tid; i < P; i += kGenThreads) {
      xsv[i] = widen(x[xo + i]);
      dyv[i] = widen(dy[xo + i]);
    }
  };
  // state <- exp(dt A) state + B_t^T (dt x_t), as the forward computes it
  auto advance = [&](int t) {
    const float d = dt[((long long)b * S + t) * H + h];
    const float da = expf(d * a_h);
    for (int p = tid; p < P; p += kGenThreads) {
      const float dxv = d * xsv[p];
      for (int n = 0; n < N; ++n) st[n * P + p] = st[n * P + p] * da + bsv[n] * dxv;
    }
  };

  // forward: checkpoints
  for (int e = tid; e < NP; e += kGenThreads) st[e] = 0.f;
  for (int t = 0; t < S; ++t) {
    __syncthreads();
    if (t % kSeg == 0)
      for (int e = tid; e < NP; e += kGenThreads)
        my_ckpt[(long long)(t / kSeg) * NP + e] = st[e];
    load_bc(t);
    load_x(t);
    __syncthreads();
    advance(t);
  }
  __syncthreads();
  for (int e = tid; e < NP; e += kGenThreads)
    gs[e] = dfinal ? dfinal[((long long)b * H + h) * NP + e] : 0.f;

  float dA_acc = 0.f;  // thread 0's
  for (int sg = nseg - 1; sg >= 0; --sg) {
    const int t0 = sg * kSeg, t1 = min(S, t0 + kSeg);
    __syncthreads();
    for (int e = tid; e < NP; e += kGenThreads)
      st[e] = my_ckpt[(long long)sg * NP + e];
    for (int t = t0; t < t1; ++t) {
      __syncthreads();
      load_bc(t);
      load_x(t);
      __syncthreads();
      advance(t);
      __syncthreads();
      for (int e = tid; e < NP; e += kGenThreads)
        my_seg[(long long)(t - t0) * NP + e] = st[e];
    }
    for (int t = t1 - 1; t >= t0; --t) {
      __syncthreads();  // the previous token's reads of gs and the vectors
      load_bc(t);
      load_x(t);
      __syncthreads();
      const float d = dt[((long long)b * S + t) * H + h];
      const float da = expf(d * a_h);
      const float* cur = my_seg + (long long)(t - t0) * NP;
      const float* prev =
          t > t0 ? my_seg + (long long)(t - t0 - 1) * NP
                 : my_ckpt + (long long)sg * NP;
      const long long xo = (((long long)b * S + t) * H + h) * P;
      for (int p = tid; p < P; p += kGenThreads) {
        float dxdt = 0.f, dap = 0.f;
        for (int n = 0; n < N; ++n) {
          const float g = gs[n * P + p] + csv[n] * dyv[p];
          gs[n * P + p] = g;
          dxdt = fmaf(bsv[n], g, dxdt);
          dap = fmaf(g, prev[n * P + p], dap);
        }
        store(dx + xo + p, d * dxdt);
        r1[p] = xsv[p] * dxdt;
        r2[p] = dap;
      }
      __syncthreads();
      const long long no = (((long long)b * S + t) * H + h) * N;
      for (int n = tid; n < N; n += kGenThreads) {
        float dc = 0.f, db = 0.f;
        for (int p = 0; p < P; ++p) {
          dc = fmaf(dyv[p], cur[n * P + p], dc);
          db = fmaf(gs[n * P + p], xsv[p], db);
        }
        dch[no + n] = dc;
        dbh[no + n] = d * db;
      }
      if (tid == 0) {
        float sx = 0.f, sa = 0.f;
        for (int p = 0; p < P; ++p) {
          sx += r1[p];
          sa += r2[p];
        }
        ddt[((long long)b * S + t) * H + h] = sx + a_h * da * sa;
        dA_acc = fmaf(d * da, sa, dA_acc);
      }
      __syncthreads();  // gs read for dB
      for (int e = tid; e < NP; e += kGenThreads) gs[e] *= da;
    }
  }
  if (tid == 0) da_part[(long long)b * H + h] = dA_acc;
}

// ---------------------------------------------------------------------------
// reductions, in a fixed order
// ---------------------------------------------------------------------------

// dst[b, t, g, n] = sum over the heads r of group g, in order, of
// src[b, t, g rep + r, n]; blockIdx.y picks (dbh -> dB) or (dch -> dC)
template <typename T>
__global__ void bwd_reduce_groups(const float* __restrict__ dbh,
                                  const float* __restrict__ dch,
                                  T* __restrict__ dB, T* __restrict__ dC,
                                  long long rows, int H, int G, int N) {
  const float* src = blockIdx.y ? dch : dbh;
  T* dst = blockIdx.y ? dC : dB;
  const int rep = H / G;
  const long long total = rows * G * N;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(idx % N);
    const long long rg = idx / N;  // (b, t) * G + g
    const int g = (int)(rg % G);
    const long long row = rg / G;
    const float* s = src + (row * H + (long long)g * rep) * N + n;
    float v = 0.f;
    for (int r = 0; r < rep; ++r) v += s[(long long)r * N];
    store(dst + idx, v);
  }
}

// dA[h] = sum over (b, c) in order of part[b, c, h]
__global__ void bwd_reduce_dA(const float* __restrict__ part,
                              float* __restrict__ dA, int rows, int H) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float v = 0.f;
    for (int r = 0; r < rows; ++r) v += part[(long long)r * H + h];
    dA[h] = v;
  }
}

template <typename T>
int reduce(const float* dbh, const float* dch, void* dB, void* dC,
           const float* da_part, float* dA, int Bt, int S, int H, int G,
           int N, int part_rows, cudaStream_t stream) {
  const long long total = (long long)Bt * S * G * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  bwd_reduce_groups<T><<<dim3(blocks, 2), 256, 0, stream>>>(
      dbh, dch, static_cast<T*>(dB), static_cast<T*>(dC),
      (long long)Bt * S, H, G, N);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_reduce_dA<<<1, 256, 0, stream>>>(da_part, dA, part_rows, H);
  return (int)cudaGetLastError();
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *dy, *dfinal;
  void *dx, *ddt, *dA, *dB, *dC, *states, *dstates, *decay, *dbh, *dch,
      *da_part;
  int Bt, S, H, G, N, P, nc;
  cudaStream_t stream;
};

template <typename T, int N, int P>
int launch_chunked(const Args& a) {
  constexpr int L = chunk_len<T, N, P>();
  if (a.nc != (a.S + L - 1) / L) return -1;
  const dim3 chunk_grid(a.nc, a.H, a.Bt);
  const dim3 state_grid(N * P / (4 * kStateThreads), a.H, a.Bt);
  constexpr bool kTc = sizeof(T) == 2;  // bf16: the tensor-core passes
  constexpr size_t s1 = kTc ? tcb::ChunkTiles<N, P>::kBytes
                            : chunk_smem<N, P>();
  constexpr size_t s3 = kTc ? tcb::GradTiles<N, P>::kBytes
                            : grad_smem<N, P>();
  static bool configured = false;
  if (!configured) {
    if constexpr (kTc) {
      if (int e = set_smem(tcb::bwd_chunk_mma<N, P>, s1)) return e;
      if (int e = set_smem(tcb::bwd_grad_mma<N, P>, s3)) return e;
    } else {
      if (int e = set_smem(bwd_chunk_pass<N, P>, s1)) return e;
      if (int e = set_smem(bwd_grad_pass<N, P>, s3)) return e;
    }
    configured = true;
  }
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const T* dy = static_cast<const T*>(a.dy);
  const float* dt = static_cast<const float*>(a.dt);
  const float* A = static_cast<const float*>(a.A);
  float* states = static_cast<float*>(a.states);
  float* dstates = static_cast<float*>(a.dstates);
  float* decay = static_cast<float*>(a.decay);
  if constexpr (kTc)
    tcb::bwd_chunk_mma<N, P><<<chunk_grid, kThreads, s1, a.stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, decay, a.S, a.H, a.G);
  else
    bwd_chunk_pass<N, P><<<chunk_grid, kThreads, s1, a.stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, decay, a.S, a.H, a.G);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_state_pass<false><<<state_grid, kStateThreads, 0, a.stream>>>(
      states, decay, nullptr, a.nc, a.H, N * P);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bwd_state_pass<true><<<state_grid, kStateThreads, 0, a.stream>>>(
      dstates, decay, static_cast<const float*>(a.dfinal), a.nc, a.H, N * P);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if constexpr (kTc)
    tcb::bwd_grad_mma<N, P><<<chunk_grid, kThreads, s3, a.stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, static_cast<T*>(a.dx),
        static_cast<float*>(a.ddt), static_cast<float*>(a.dbh),
        static_cast<float*>(a.dch), static_cast<float*>(a.da_part), a.S,
        a.H, a.G);
  else
    bwd_grad_pass<N, P><<<chunk_grid, kThreads, s3, a.stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, static_cast<T*>(a.dx),
        static_cast<float*>(a.ddt), static_cast<float*>(a.dbh),
        static_cast<float*>(a.dch), static_cast<float*>(a.da_part), a.S,
        a.H, a.G);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  return reduce<T>(static_cast<const float*>(a.dbh),
                   static_cast<const float*>(a.dch), a.dB, a.dC,
                   static_cast<const float*>(a.da_part),
                   static_cast<float*>(a.dA), a.Bt, a.S, a.H, a.G, N,
                   a.Bt * a.nc, a.stream);
}

template <typename T>
int launch_generic(const Args& a) {
  if (a.nc != (a.S + kSeg - 1) / kSeg) return -1;
  const size_t smem = generic_smem(a.N, a.P);
  static size_t configured = 0;  // the largest shared memory allowed so far
  if (smem > configured) {
    if (int e = set_smem(bwd_generic<T>, smem)) return e;
    configured = smem;
  }
  bwd_generic<T><<<dim3(a.H, a.Bt), kGenThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.dfinal), static_cast<T*>(a.dx),
      static_cast<float*>(a.ddt), static_cast<float*>(a.dbh),
      static_cast<float*>(a.dch), static_cast<float*>(a.states),
      static_cast<float*>(a.dstates), static_cast<float*>(a.da_part), a.S,
      a.H, a.G, a.N, a.P);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  return reduce<T>(static_cast<const float*>(a.dbh),
                   static_cast<const float*>(a.dch), a.dB, a.dC,
                   static_cast<const float*>(a.da_part),
                   static_cast<float*>(a.dA), a.Bt, a.S, a.H, a.G, a.N, a.Bt,
                   a.stream);
}

// The chunked route's N and P, as the forward's (ssd_scan.cu): the build
// passes kernels/ssd_scan.py's STATE_DIMS and HEAD_DIMS as masks.
#if !defined(SSD_FAST_N_MASK) || !defined(SSD_FAST_P_MASK)
#error "build with -DSSD_FAST_N_MASK and -DSSD_FAST_P_MASK (bit d / 64 - 1 per dim)"
#endif

constexpr bool listed(unsigned mask, int d) {
  return (d == 64 || d == 128) && ((mask >> (d / 64 - 1)) & 1u);
}

template <typename T, int N, int P>
int chunked_np(const Args& a) {
  if constexpr (listed(SSD_FAST_N_MASK, N) && listed(SSD_FAST_P_MASK, P))
    return launch_chunked<T, N, P>(a);
  return -1;
}

template <typename T>
int dispatch(const Args& a) {
  if (!listed(SSD_FAST_N_MASK, a.N) || !listed(SSD_FAST_P_MASK, a.P))
    return -1;
  if (a.N == 64)
    return a.P == 64 ? chunked_np<T, 64, 64>(a) : chunked_np<T, 64, 128>(a);
  return a.P == 64 ? chunked_np<T, 128, 64>(a) : chunked_np<T, 128, 128>(a);
}

}  // namespace

// Positions per chunk of the chunked route (route 0) at (N, P) for inputs
// of `dtype` (0 float32, 1 bfloat16), or per checkpointed segment of the
// generic route (route 1); -1 for a route, (N, P) or type the library
// does not take.
extern "C" int ssd_scan_bwd_chunk(int route, int N, int P, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  if (route == 1) return kSeg;
  if (route != 0 || !listed(SSD_FAST_N_MASK, N) ||
      !listed(SSD_FAST_P_MASK, P))
    return -1;
  return dtype == 1 || N * P <= 128 * 64 ? 64 : 32;
}

// route: 0 chunked, 1 generic, as kernels/ssd_scan.py::backward_route names
// it; dtype (of x, B, C, dy, dx, dB, dC): 0 float32, 1 bfloat16.  dfinal may
// be null (a zero cotangent).  Float32 scratch: dbh, dch [Bt, S, H, N];
// chunked: states, dstates [Bt, nc, H, N, P], decay and da_part
// [Bt, nc, H] with nc = ceil(S / ssd_scan_bwd_chunk(0, N, P, dtype));
// generic:
// states [Bt, H, nc, N, P] (checkpoints, nc = ceil(S / 64)), dstates
// [Bt, H, 64, N, P] (one segment's states), da_part [Bt, H], decay unused.
// Returns a CUDA error code (0 on success); -1 for a route, shape or type
// the kernel does not take or scratch sized for another chunk count, -3
// for a pointer that is not 16-byte aligned (chunked, bf16).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* states, void* dstates, void* decay,
    void* dbh, void* dch, void* da_part, int Bt, int S, int H, int G, int N,
    int P, int dtype, int nc, int route, cudaStream_t stream) {
  if (Bt <= 0 || S <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0)
    return -1;
  const Args a{x,      dt,      A,     Bm,  Cm,  dy,     dfinal,
               dx,     ddt,     dA,    dB,  dC,  states, dstates,
               decay,  dbh,     dch,   da_part,
               Bt,     S,       H,     G,   N,   P,      nc,
               stream};
  if (route == 1) {
    if (dtype == 0) return launch_generic<float>(a);
    if (dtype == 1) return launch_generic<bf16>(a);
    return -1;
  }
  if (route != 0 || decay == nullptr) return -1;
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
         reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(dy) |
         reinterpret_cast<uintptr_t>(dx)) %
        16)
      return -3;
    return dispatch<bf16>(a);
  }
  return -1;
}
