// Backward of the Mamba-2 SSD scan (K3) for sm_90a.
//
// Replaces no kernel of the JAX package: it has no backward kernel for its
// Pallas scan (kernels/ssd_scan.py::ssd_scan_pallas), and its training step
// differentiates models/mamba.py::ssd_chunked, which XLA fuses.  This file
// is the scan's gradient as kernels, so that training runs the SSD through
// K3 in both directions (kernels/ops.py::SSDScan).  For the forward of
// ssd_scan.cu
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
// W_ij = exp(cum_i - cum_j) [i >= j].  Each chunk's incoming state S_prev
// is not recomputed: the forward (ssd_scan.cu) leaves the state entering
// each of its chunks in its scratch, and autograd keeps that tensor for the
// backward.  The forward's chunk is L or 2 L (bf16: 128 against 64), and
// the state's cotangent dS is kept at the forward's chunks too; where a
// backward chunk is half of a forward chunk, its block carries the saved
// state forward over the first half (S_prev of the second half) or the
// saved cotangent back over the second half (dS of the first half): one
// [N, P] product over L positions a head.  Three steps:
//   1. reverse walk, grid (H, Bt): one block per (sequence, head) carries
//      dS in registers from the last chunk to the first, seeded by dfinal,
//      adds each chunk's dS <- exp(total_c) dS + C^T (dy exp(cum)) and
//      writes dS once at each forward chunk's end; the next chunks' tiles
//      load by cp.async into a ring while a product runs;
//   2. gradient pass, grid (chunks, G x slabs of 8 heads, Bt): C B^T once
//      per slab, then per head in order (its x, dy and dt, and the other
//      half's, loaded together by cp.async)
//        M = dy x^T, SW = scores W, MW = M W dt_j,
//        dx_j  = dt_j (e_j (B dS)_j + (SW^T dy)_j)
//        dB_j += dt_j e_j (dS x_j)  + (MW^T C)_j
//        dC_i += exp(cum_i) (S_prev dy_i) + (MW B)_i
//        dcum  = rowsum(SW M dt_j) - colsum(SW M dt_j) - e dt (x . B dS)
//                + exp(cum) (dy . C S_prev), and at the last position
//                dtotal = sum_j e_j dt_j (x_j . (B dS)_j) + exp(total)
//                <S_prev, dS>,
//        d(dA) = the reverse cumsum of dcum, ddt = x . dx / dt + A d(dA),
//        and this chunk's part of dA, sum_j dt_j d(dA)_j;
//      dB and dC stay in registers across the slab's heads, and one part
//      per slab is written;
//   3. reductions: dB and dC summed over the slabs of each group in order,
//      dA over batch and chunks in order.  No float atomics: two calls give
//      the same bits.
// bfloat16 inputs: the walk's and the gradient pass's products run on the
// tensor cores (mma.sync m16n8k16, bf16 operands, float32 accumulation,
// ldmatrix from padded tiles), as the forward's passes do; x, B, C and dy
// enter as they are, every float32 operand (states, cotangents, SW, MW,
// the chunk weights) as hi = bf16(v) plus lo = bf16(v - hi), two mma per
// product (without the lo terms dx, dB and dC land 2.5e-3 from the plain
// version: scripts/k3_bwd_lo_control.py).  float32 inputs: the same steps
// on float32 FMAs from shared memory, tiles stored with their columns
// XOR-swizzled by the row so that row and column walks both meet 16
// distinct banks.  Positions past S load as zeros (dt = 0), so any S works.
//
// Generic route (any other N, P whose state and cotangent fit shared
// memory together): one block per (batch, head) runs the exact per-token
// recurrence forward, keeping the state at the start of every segment of
// kSeg tokens (global scratch), then walks the segments in reverse: it
// recomputes a segment's states from its checkpoint into a second scratch
// and runs the adjoint
//   G_t = exp(dt_{t+1} A) G_{t+1} + C_t^T dy_t   (G seeded by dfinal)
// token by token in reverse, one thread per column p of G [N, P] in shared
// memory, with per-head dB and dC parts.  Sums over p go through shared
// memory in a fixed order.
//
// What bounds it.  The inputs' and outputs' bytes read and written once
// are the bound of record; the chunked route moves besides the forward's
// saved states and dS, each written or read once a forward chunk and read
// again by the other half where a chunk is half of one (4 x Bt x chunks x
// H x N x P bytes each time, at the forward's chunk), and the slab parts
// of dB and dC (8 x Bt x S x G x slabs x N bytes written and read).  At
// mamba2-1.3b's training shape that is ~1.2 GB against 3.4 GB before this
// design, whose recomputed chunk states and cotangents were each written,
// walked in place and read again, and whose dB and dC went through
// per-head parts: its two serial walks alone took a third of the call.
// Now the gradient pass takes three quarters of the call.  It runs one
// block of 8 warps an SM (130-231 KB of shared memory, 255 registers).
// scripts/k3_bwd_phases.py splits its cycles at that shape: about half in
// the chunk products on mma.sync (with their hi + lo terms), 30% in
// bringing each head's S_prev and dS into the tiles (the half-chunk
// product and the float32 loads), a tenth in waiting for the head's rows,
// the rest in elementwise work and barriers.  The walk is bound by its dS
// stores.

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

constexpr int kThreads = 256;    // walk and gradient passes: 16 x 16
constexpr int kSlabHeads = 8;    // heads of one group a gradient block takes

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

// 1. reverse walk, grid (H, Bt): one block per (sequence, head) carries the
//    state's cotangent dS [N][P] in registers from the last chunk to the
//    first, writing it at each forward chunk's end as the tensor-core walk
//    does; dS <- exp(total_c) dS + C_c^T (exp(cum) dy)_c.
template <int N, int P>
constexpr size_t walk_smem() {
  constexpr int L = chunk_len<float, N, P>();
  return sizeof(float) * (L * N + L * P + 2 * L);
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
bwd_walk_fma(const float* __restrict__ dt, const float* __restrict__ A,
             const float* __restrict__ Cm, const float* __restrict__ dy,
             const float* __restrict__ dfinal, float* __restrict__ dstates,
             int S, int H, int G, int nc, int ratio) {
  constexpr int L = chunk_len<float, N, P>();
  constexpr int R = N / 16, Q = P / 16;
  extern __shared__ float4 smem4[];
  float* ce = reinterpret_cast<float*>(smem4);  // [L][N] C exp(cum)
  float* dys = ce + L * N;                      // [L][P]
  float* cum = dys + L * P;                     // [L]
  float* dts = cum + L;                         // [L]
  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[R][Q];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q)
      acc[r][q] = dfinal == nullptr ? 0.f
                  : dfinal[(((long long)b * H + h) * N + ty + 16 * r) * P +
                           tx + 16 * q];
  const int ncf = (nc + ratio - 1) / ratio;  // the forward's chunks
  for (int c = nc - 1; c >= 0; --c) {
    const long long slot =
        (((long long)b * ncf + c / ratio) * H + h) * N * P;
    if (c % ratio == ratio - 1 || c == nc - 1)  // a forward chunk's end
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < Q; ++q)
          dstates[slot + (ty + 16 * r) * P + tx + 16 * q] = acc[r][q];
    __syncthreads();  // the previous chunk's tiles read
    load_dt_cum<L>(dt, A[h], dts, cum, b, c * L, h, S, H, tid);
    const float decay = expf(cum[L - 1]);
    load_rows<L, N>(Cm, ce, b, c * L, grp, G, S, tid,
                    [&](int i) { return expf(cum[i]); });
    load_rows<L, P>(dy, dys, b, c * L, h, H, S, tid, [](int) { return 1.f; });
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[r][q] *= decay;
    gemm(acc, L, [&](int n, int i) { return ce[sw<N>(i, n)]; },
         [&](int i, int p) { return dys[sw<P>(i, p)]; }, ty, tx);
  }
}

// 2. gradient pass, grid (chunks, G x slabs of kSlabHeads heads, Bt)
template <int N, int P>
constexpr size_t grad_smem() {
  constexpr int L = chunk_len<float, N, P>();
  // B, C and the previous chunk's B [L][N]; x, dy and the previous chunk's
  // weighted x [L][P]; S_prev or dS [N][P] (first the T matrix [L][L]);
  // SW, MW [L][L]; dts, cum, dcum, u, ddtx, csdy, dda, dtp, cump [L]; 8
  // warp sums and <S_prev, dS>
  return sizeof(float) *
         (3 * L * N + 3 * L * P + N * P + 2 * L * L + 9 * L + 8 + 1);
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
bwd_grad_pass(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ states,
              const float* __restrict__ dstates, float* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ db_part,
              float* __restrict__ dc_part, float* __restrict__ da_part, int S,
              int H, int G, int ncf, int ratio, int spg) {
  constexpr int L = chunk_len<float, N, P>();
  static_assert(L * L <= N * P, "the T matrix lives in the state tile");
  constexpr int R = L / 16;  // output rows per thread (positions)
  constexpr int QL = L / 16, QN = N / 16, QP = P / 16;
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);  // [L][N]
  float* cs = bs + L * N;                       // [L][N]
  float* bps = cs + L * N;                      // [L][N] other half's B or C
  float* xs = bps + L * N;                      // [L][P]
  float* dys = xs + L * P;                      // [L][P]
  float* xps = dys + L * P;                     // [L][P] other half's x or dy
  float* mat = xps + L * P;                     // [N][P]; first T [L][L]
  float* swm = mat + N * P;                     // [L][L] SW
  float* mwm = swm + L * L;                     // [L][L] MW dt_j
  float* dts = mwm + L * L;                     // [L]
  float* cum = dts + L;
  float* dcum = cum + L;
  float* uvec = dcum + L;
  float* ddtx = uvec + L;
  float* csdy = ddtx + L;
  float* dda = csdy + L;
  float* dtp = dda + L;
  float* cump = dtp + L;
  float* red = cump + L;                        // [8] warp sums, then [8]
  const int c = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, parts = gridDim.y, c0 = c * L;
  const int rep = H / G, grp = slab / spg;
  const int h_begin = grp * rep + (slab % spg) * kSlabHeads;
  const int h_end = min(h_begin + kSlabHeads, (grp + 1) * rep);
  // the forward chunk holding this one, and which half of it this is
  // (ratio 2): the second half derives S_prev, the first half dS
  const int cf = c / ratio, sub = c % ratio;
  const bool mid_state = ratio == 2 && sub == 1;
  const bool mid_cotangent = ratio == 2 && sub == 0;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid / 32, lane = tid % 32;
  auto one = [](int) { return 1.f; };

  load_rows<L, N>(Bm, bs, b, c0, grp, G, S, tid, one);
  load_rows<L, N>(Cm, cs, b, c0, grp, G, S, tid, one);
  if (mid_state) load_rows<L, N>(Bm, bps, b, c0 - L, grp, G, S, tid, one);
  if (mid_cotangent) load_rows<L, N>(Cm, bps, b, c0 + L, grp, G, S, tid, one);
  __syncthreads();
  // scores = C B^T, once for the slab's heads
  float sc[R][QL];
  zero(sc);
  gemm(sc, N, [&](int i, int n) { return cs[sw<N>(i, n)]; },
       [&](int n, int j) { return bs[sw<N>(j, n)]; }, ty, tx);
  // the slab's dB and dC, summed over its heads in order
  float accB[R][QN], accC[R][QN];
  zero(accB);
  zero(accC);

  for (int h = h_begin; h < h_end; ++h) {
    const float a_h = A[h];
    // the forward's state entering chunk cf and the walk's dS leaving it
    const long long fslot = (((long long)b * ncf + cf) * H + h) * N * P;
    const float* fwd = states + fslot;
    const float* ds = dstates + fslot;
    float sd = 0.f;  // this thread's part of <S_prev, dS>
    __syncthreads();  // the previous head's tiles and vectors read
    load_dt_cum<L>(dt, a_h, dts, cum, b, c0, h, S, H, tid);
    const float total = cum[L - 1];
    load_rows<L, P>(x, xs, b, c0, h, H, S, tid, one);
    load_rows<L, P>(dy, dys, b, c0, h, H, S, tid, one);
    __syncthreads();

    // M = dy x^T; SW, MW dt_j and T = SW M dt_j
    {
      float mm[R][QL];
      zero(mm);
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
    if (mid_cotangent) {
      // dS leaving this chunk: the walk's, leaving the next, carried back
      // over the next chunk
      if (tid < L)
        dtp[tid] = c0 + L + tid < S
                       ? dt[((long long)b * S + c0 + L + tid) * H + h] : 0.f;
      __syncthreads();
      chunk_cumsum<L>(dtp, cump, a_h, tid);
      __syncthreads();
      load_rows<L, P>(dy, xps, b, c0 + L, h, H, S, tid,
                      [&](int i) { return expf(cump[i]); });
      __syncthreads();
      float acc[N / 16][QP];
      zero(acc);
      gemm(acc, L, [&](int n, int i) { return bps[sw<N>(i, n)]; },
           [&](int i, int p) { return xps[sw<P>(i, p)]; }, ty, tx);
      const float dn = expf(cump[L - 1]);
#pragma unroll
      for (int r = 0; r < N / 16; ++r)
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          const int n = ty + 16 * r, p = tx + 16 * q;
          const float v = fmaf(dn, ds[n * P + p], acc[r][q]);
          sd = fmaf(v, fwd[n * P + p], sd);
          mat[sw<P>(n, p)] = v;
        }
    } else {
      for (int idx = tid; idx < N * P; idx += kThreads)
        mat[sw<P>(idx / P, idx % P)] = ds[idx];
    }
    __syncthreads();

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

    // dB += dt_j e_j (dS x_j) + (MW^T C)_j
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
        for (int q = 0; q < QN; ++q) accB[r][q] = fmaf(f, acc[r][q], accB[r][q]);
      }
      gemm(accB, L, [&](int j, int i) { return mwm[sw<L>(i, j)]; },
           [&](int i, int n) { return cs[sw<N>(i, n)]; }, ty, tx);
    }
    __syncthreads();  // dS fully read

    // S_prev into the state tile, and <S_prev, dS>: the forward's state
    // entering chunk cf, advanced over the first half of it where this
    // chunk is the second
    if (!mid_state) {
      for (int idx = tid; idx < N * P; idx += kThreads) {
        const float v = fwd[idx];
        if (!mid_cotangent) sd = fmaf(v, ds[idx], sd);
        mat[sw<P>(idx / P, idx % P)] = v;
      }
    } else {
      if (tid < L) dtp[tid] = dt[((long long)b * S + c0 - L + tid) * H + h];
      __syncthreads();
      chunk_cumsum<L>(dtp, cump, a_h, tid);
      __syncthreads();
      const float tp = cump[L - 1];
      load_rows<L, P>(x, xps, b, c0 - L, h, H, S, tid,
                      [&](int i) { return dtp[i] * expf(tp - cump[i]); });
      __syncthreads();
      float acc[N / 16][QP];
      zero(acc);
      gemm(acc, L, [&](int n, int i) { return bps[sw<N>(i, n)]; },
           [&](int i, int p) { return xps[sw<P>(i, p)]; }, ty, tx);
      const float dp = expf(tp);
#pragma unroll
      for (int r = 0; r < N / 16; ++r)
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          const int n = ty + 16 * r, p = tx + 16 * q;
          const float v = fmaf(dp, fwd[n * P + p], acc[r][q]);
          sd = fmaf(v, ds[n * P + p], sd);
          mat[sw<P>(n, p)] = v;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    if (lane == 0) red[warp] = sd;
    __syncthreads();

    // dC += exp(cum_i) (S_prev dy_i) + (MW B)_i
    {
      float acc[R][QN];
      zero(acc);
      gemm(acc, P, [&](int i, int p) { return dys[sw<P>(i, p)]; },
           [&](int p, int n) { return mat[sw<P>(n, p)]; }, ty, tx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float f = expf(cum[ty + 16 * r]);
#pragma unroll
        for (int q = 0; q < QN; ++q) accC[r][q] = fmaf(f, acc[r][q], accC[r][q]);
      }
      gemm(accC, L, [&](int i, int j) { return mwm[sw<L>(i, j)]; },
           [&](int j, int n) { return bs[sw<N>(j, n)]; }, ty, tx);
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
      float sdt = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) sdt += red[w];
      float dtotal = 0.f;
      for (int j = 0; j < L; ++j) dtotal += uvec[j];
      dtotal += expf(total) * sdt;
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

  // the slab's parts of dB and dC
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = c0 + ty + 16 * r;
    if (t >= S) continue;
    const long long row = (((long long)b * S + t) * parts + slab) * N;
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      db_part[row + tx + 16 * q] = accB[r][q];
      dc_part[row + tx + 16 * q] = accC[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: the walk and the gradient pass on the tensor cores,
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
// each position) into a [L][W + 8] tile; zero past S.  Every load of a
// thread is issued before the first store, so their latencies overlap.
template <int W>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          uint8_t* dst, int b, int c0,
                                          int sub, int per_t, int S,
                                          int tid) {
  constexpr int U = L * W / 8 / kThreads;
  static_assert(U * kThreads * 8 == L * W, "whole 16-byte rows a thread");
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = tid + u * kThreads;
    const int i = idx / (W / 8), w8 = idx % (W / 8);
    const int t = c0 + i;
    v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (t < S)
      v[u] = *reinterpret_cast<const uint4*>(
          src + (((long long)b * S + t) * per_t + sub) * W + w8 * 8);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = tid + u * kThreads;
    const int i = idx / (W / 8), w8 = idx % (W / 8);
    *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(dst) + i * (W + 8) +
                              w8 * 8) = v[u];
  }
}

// a float32 [N][P] matrix into a hi and a lo bf16 tile [N][P + 8]; with
// `dot`, also the thread's part of <src, dot>.  Loads go in batches of 8
// float4 a thread, each batch issued whole before it is used.
template <int N, int P>
__device__ __forceinline__ float load_split(const float* __restrict__ src,
                                            const float* __restrict__ dot,
                                            uint8_t* hi_tile,
                                            uint8_t* lo_tile, int tid) {
  constexpr int U = N * P / 4 / kThreads, kBatch = U < 8 ? U : 8;
  static_assert(U % kBatch == 0, "whole batches");
  bf16* shi = reinterpret_cast<bf16*>(hi_tile);
  bf16* slo = reinterpret_cast<bf16*>(lo_tile);
  float acc = 0.f;
  for (int u0 = 0; u0 < U; u0 += kBatch) {
    float4 v[kBatch], d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = tid + (u0 + u) * kThreads;
      v[u] = *reinterpret_cast<const float4*>(src + 4 * idx);
      if (dot != nullptr)
        d[u] = *reinterpret_cast<const float4*>(dot + 4 * idx);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = tid + (u0 + u) * kThreads;
      const int n = idx / (P / 4), p4 = idx % (P / 4);
      if (dot != nullptr)
        acc = fmaf(v[u].x, d[u].x, fmaf(v[u].y, d[u].y,
                   fmaf(v[u].z, d[u].z, fmaf(v[u].w, d[u].w, acc))));
      uint2 h, l;
      split(v[u].x, v[u].y, h.x, l.x);
      split(v[u].z, v[u].w, h.y, l.y);
      *reinterpret_cast<uint2*>(shi + n * (P + 8) + 4 * p4) = h;
      *reinterpret_cast<uint2*>(slo + n * (P + 8) + 4 * p4) = l;
    }
  }
  return acc;
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// `valid` is false (nothing is read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// rows c0 .. c0 + L - 1 of a [Bt, S, per_t, W] bf16 tensor into a
// [L][W + 8] tile by cp.async (one group the caller commits); zero past S
template <int W>
__device__ __forceinline__ void issue_tile(const bf16* __restrict__ src,
                                           uint32_t dst, int b, int c0,
                                           int sub, int per_t, int S,
                                           int tid) {
  for (int idx = tid; idx < L * W / 8; idx += kThreads) {
    const int i = idx / (W / 8), w8 = idx % (W / 8);
    const int t = c0 + i;
    const bf16* from =
        src + (((long long)b * S + (t < S ? t : 0)) * per_t + sub) * W + w8 * 8;
    cp_async16(dst + 2 * (i * (W + 8) + w8 * 8), from, t < S);
  }
}

// 4 bytes from global to shared memory, asynchronously; zero where `valid`
// is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// 1. reverse walk, grid (H, Bt): one block per (sequence, head) carries the
//    state's cotangent dS [N][P] in the warps' accumulators from the last
//    chunk to the first.  At the end of each forward chunk (every `ratio`
//    chunks, and the last) it writes dS, the cotangent of the state
//    leaving it, into that forward chunk's slot; then, every chunk,
//    dS <- exp(total_c) dS + (C_c exp(cum))^T dy_c on the tensor cores
//    (C's weight folded in as hi + lo).  The tiles of the
//    next kWalkStages - 1 chunks (C, dy, dt) load by cp.async into a ring
//    while this one's product runs.  The 8 warps tile [N][P] as kWM x kWP.
constexpr int kWalkStages = 3;

template <int N, int P>
struct WalkTiles {
  static constexpr int kPN = N + 8, kPP = P + 8;
  static constexpr size_t kDY = 2 * L * kPN;               // after C
  static constexpr size_t kDT = kDY + 2 * L * kPP;         // float [L]
  static constexpr size_t kStage = kDT + sizeof(float) * L;
  static constexpr size_t kCum = kWalkStages * kStage;     // float [L]
  static constexpr size_t kBytes = kCum + sizeof(float) * L;
};

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
bwd_walk_mma(const float* __restrict__ dt, const float* __restrict__ A,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const float* __restrict__ dfinal, float* __restrict__ dstates,
             int S, int H, int G, int nc, int ratio) {
  using Tl = WalkTiles<N, P>;
  constexpr int kWM = N / 16 < 8 ? N / 16 : 8;  // warps along the state rows
  constexpr int kWP = 8 / kWM;                   // warps along P
  constexpr int NT = P / 8 / kWP;                // 8-column n-tiles per warp
  static_assert(N / 16 == kWM, "one 16-row m-tile per warp");
  extern __shared__ __align__(16) uint8_t smem[];
  float* cum = reinterpret_cast<float*>(smem + Tl::kCum);
  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int m0 = 16 * (warp % kWM), p0 = (warp / kWM) * NT * 8;
  const int r0 = m0 + g;  // this thread's state rows: r0, r0 + 8
  const float a_h = A[h];
  const uint32_t base = smem_u32(smem);
  const int ncf = (nc + ratio - 1) / ratio;  // the forward's chunks
  float* out0 = dstates + ((long long)b * ncf * H + h) * N * P;
  const long long step = (long long)H * N * P;  // one forward chunk's slots

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int p = p0 + 8 * nt + 2 * qd;
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (dfinal != nullptr) {
      const float* seed = dfinal + ((long long)b * H + h) * N * P;
      lo = *reinterpret_cast<const float2*>(seed + r0 * P + p);
      hi = *reinterpret_cast<const float2*>(seed + (r0 + 8) * P + p);
    }
    acc[nt][0] = lo.x;
    acc[nt][1] = lo.y;
    acc[nt][2] = hi.x;
    acc[nt][3] = hi.y;
  }
  // chunk c's C, dy and dt into stage st (nothing for c < 0); one group
  auto issue = [&](int c, int st) {
    if (c >= 0) {
      const uint32_t at = base + st * Tl::kStage;
      issue_tile<N>(Cm, at, b, c * L, grp, G, S, tid);
      issue_tile<P>(dy, at + Tl::kDY, b, c * L, h, H, S, tid);
      if (tid < L) {
        const int t = c * L + tid;
        cp_async4(at + Tl::kDT + 4 * tid,
                  dt + ((long long)b * S + (t < S ? t : 0)) * H + h, t < S);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < kWalkStages - 1; ++u) issue(nc - 1 - u, u);
  for (int u = 0; u < nc; ++u) {
    const int c = nc - 1 - u, st = u % kWalkStages;
    if (c % ratio == ratio - 1 || c == nc - 1) {  // a forward chunk's end
      float* out = out0 + (c / ratio) * step;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int p = p0 + 8 * nt + 2 * qd;
        *reinterpret_cast<float2*>(out + r0 * P + p) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (r0 + 8) * P + p) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    // the stage read in the last step takes the chunk kWalkStages - 1 on
    issue(c - (kWalkStages - 1), (u + kWalkStages - 1) % kWalkStages);
    cp_async_wait<kWalkStages - 1>();
    __syncthreads();  // stage st in place
    const uint32_t cs = base + st * Tl::kStage;
    chunk_cumsum<L>(reinterpret_cast<const float*>(
                        smem + st * Tl::kStage + Tl::kDT),
                    cum, a_h, tid);
    __syncthreads();
    const float decay = expf(cum[L - 1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= decay;
#pragma unroll
    for (int ks = 0; ks < L / 16; ++ks) {
      // A = (C exp(cum))^T: stored [k = i][m = n], the weight folded in as
      // hi + lo; B = dy: stored [k = i][n = p]
      const int k0 = 16 * ks + 2 * qd;
      float w[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) w[v] = expf(cum[k0 + (v & 1) + 8 * (v >> 1)]);
      uint32_t raw[4], ahi[4], alo[4];
      a_km(raw, cs, Tl::kPN, m0, 16 * ks, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack_bf16(raw[r]);
        split(v.x * (r < 2 ? w[0] : w[2]), v.y * (r < 2 ? w[1] : w[3]),
              ahi[r], alo[r]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t rb[4];
        b_kn(rb, cs + Tl::kDY, Tl::kPP, 16 * ks, p0 + 16 * np, lane);
        mma(acc[2 * np], ahi, rb[0], rb[1]);
        mma(acc[2 * np], alo, rb[0], rb[1]);
        mma(acc[2 * np + 1], ahi, rb[2], rb[3]);
        mma(acc[2 * np + 1], alo, rb[2], rb[3]);
      }
    }
    __syncthreads();  // stage st and cum read
  }
}

// 2. gradient pass, grid (chunks, G x slabs of kSlabHeads heads, Bt).
//    B, C and C B^T are loaded and computed once for the slab; x, dy, dt,
//    dS and S_prev per head.  Warp w owns rows 16 (w % 4) .. + 15 of every
//    [L][.] product and one half of its columns (w / 4: colh); the slab's
//    dB and dC stay in the warps' accumulators across its heads.
template <int N, int P>
struct GradTiles {
  static constexpr int kPN = N + 8, kPP = P + 8, kPL = L + 8;
  static constexpr size_t kB = 0;                          // bf16 [L][kPN]
  static constexpr size_t kC = kB + 2 * L * kPN;
  static constexpr size_t kBP = kC + 2 * L * kPN;          // other half's
  static constexpr size_t kSH = kBP + 2 * L * kPN;         // bf16 [N][kPP]
  static constexpr size_t kSL = kSH + 2 * N * kPP;
  static constexpr size_t kWH = kSL + 2 * N * kPP;         // bf16 [L][kPL]
  static constexpr size_t kWL = kWH + 2 * L * kPL;
  static constexpr size_t kMH = kWL + 2 * L * kPL;
  static constexpr size_t kML = kMH + 2 * L * kPL;
  static constexpr size_t kT = kML + 2 * L * kPL;          // float [L][L+1]
  static constexpr size_t kV = kT + sizeof(float) * L * (L + 1);
  // floats at kV: cum, dcum, dda, cump [L]; part [3][2][L]; red [8] warp
  // sums
  static constexpr size_t kHead = kV + sizeof(float) * (10 * L + 8);
  // a head's rows, loaded together by cp.async: x, dy and the other half's
  // x or dy (bf16 [L][kPP]); dt and the other half's dt (float [L])
  static constexpr size_t kX = kHead, kDY = kX + 2 * L * kPP;
  static constexpr size_t kXN = kDY + 2 * L * kPP;
  static constexpr size_t kDT = kXN + 2 * L * kPP;
  static constexpr size_t kDTN = kDT + sizeof(float) * L;
  static constexpr size_t kBytes = kDTN + sizeof(float) * L;
  static_assert(kHead % 16 == 0, "16-byte tiles");
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

// acc[nt] = f0 * acc[nt] on rows g, f1 on rows g + 8
template <int NT>
__device__ __forceinline__ void scale_rows(float (&acc)[NT][4], float f0,
                                           float f1) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] *= f0;
    acc[nt][1] *= f0;
    acc[nt][2] *= f1;
    acc[nt][3] *= f1;
  }
}

// into += f0 / f1 * acc by rows, as scale_rows
template <int NT>
__device__ __forceinline__ void add_rows(float (&into)[NT][4],
                                         const float (&acc)[NT][4], float f0,
                                         float f1) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    into[nt][0] = fmaf(f0, acc[nt][0], into[nt][0]);
    into[nt][1] = fmaf(f0, acc[nt][1], into[nt][1]);
    into[nt][2] = fmaf(f1, acc[nt][2], into[nt][2]);
    into[nt][3] = fmaf(f1, acc[nt][3], into[nt][3]);
  }
}

// A state or a cotangent [N][P] carried over one chunk, into the state
// tiles (hi + lo):
//   v = decay base + sum_i (A_i w_i)^T X_i
// with A a bf16 tile [L][N + 8] (B or C rows of the chunk), X one
// [L][P + 8] (x or dy rows) and the weights w_i folded into A as hi + lo,
// on the tensor cores.  Returns this thread's part of <v, dot>.  The 8
// warps tile [N][P] as kWM x kWP.  Where a backward chunk is half of a
// forward chunk it gives S_prev of the second half (A = the first half's
// B, X its x, w = dt exp(total - cum), base the forward's saved state) and
// dS of the first (A = the second half's C, X its dy, w = exp(cum), base
// the walk's dS at the forward chunk's end).
template <int N, int P, typename FW>
__device__ __forceinline__ float advance_state(
    const float* __restrict__ base, const float* __restrict__ dot,
    uint32_t a_tile, uint32_t x_tile, FW weight, float decay, bf16* shi,
    bf16* slo, int warp, int lane) {
  constexpr int kPP = P + 8;
  constexpr int kWM = N / 16 < 8 ? N / 16 : 8;  // warps along the state rows
  constexpr int kWP = 8 / kWM;                   // warps along P
  constexpr int kMT = N / 16 / kWM;              // 16-row m-tiles per warp
  constexpr int kPT = P / 8 / kWP;               // 8-column n-tiles per warp
  const int g = lane / 4, qd = lane % 4;
  const int n_base = (warp % kWM) * kMT * 16;
  const int p_base = (warp / kWM) * kPT * 8;
  float acc[kMT][kPT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) zero(acc[mt]);
#pragma unroll
  for (int ks = 0; ks < L / 16; ++ks) {
    const int k0 = 16 * ks + 2 * qd;
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = weight(k0 + (u & 1) + 8 * (u >> 1));
    uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t raw[4];
      a_km(raw, a_tile, N + 8, n_base + 16 * mt, 16 * ks, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack_bf16(raw[r]);
        split(v.x * (r < 2 ? w[0] : w[2]), v.y * (r < 2 ? w[1] : w[3]),
              ahi[mt][r], alo[mt][r]);
      }
    }
#pragma unroll
    for (int np = 0; np < kPT / 2; ++np) {
      uint32_t r[4];
      b_kn(r, x_tile, kPP, 16 * ks, p_base + 16 * np, lane);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma(acc[mt][2 * np], ahi[mt], r[0], r[1]);
        mma(acc[mt][2 * np], alo[mt], r[0], r[1]);
        mma(acc[mt][2 * np + 1], ahi[mt], r[2], r[3]);
        mma(acc[mt][2 * np + 1], alo[mt], r[2], r[3]);
      }
    }
  }
  float sd = 0.f;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n_base + 16 * mt + g + 8 * half;
        const int p = p_base + 8 * pt + 2 * qd;
        const float2 f = *reinterpret_cast<const float2*>(base + n * P + p);
        const float2 d = *reinterpret_cast<const float2*>(dot + n * P + p);
        const float v0 = fmaf(decay, f.x, acc[mt][pt][2 * half]);
        const float v1 = fmaf(decay, f.y, acc[mt][pt][2 * half + 1]);
        sd = fmaf(v0, d.x, fmaf(v1, d.y, sd));
        uint32_t hi, lo;
        split(v0, v1, hi, lo);
        *reinterpret_cast<uint32_t*>(shi + n * kPP + p) = hi;
        *reinterpret_cast<uint32_t*>(slo + n * kPP + p) = lo;
      }
  return sd;
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
bwd_grad_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const float* __restrict__ states,
             const float* __restrict__ dstates, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ db_part,
             float* __restrict__ dc_part, float* __restrict__ da_part, int S,
             int H, int G, int ncf, int ratio, int spg) {
  using Tl = GradTiles<N, P>;
  constexpr int kPN = Tl::kPN, kPP = Tl::kPP, kPL = Tl::kPL;
  constexpr int NTL = L / 16, NTN = N / 16, NTP = P / 16;  // n-tiles a warp
  extern __shared__ __align__(16) uint8_t smem[];
  float* tm = reinterpret_cast<float*>(smem + Tl::kT);
  float* cum = reinterpret_cast<float*>(smem + Tl::kV);
  float* dcum = cum + L;
  float* dda = dcum + L;
  float* cump = dda + L;             // the other half's cumsum
  float* part = cump + L;            // [3][2][L]: u, x . dxdt, dy . C S
  float* red = part + 6 * L;         // [8] warp sums of <S_prev, dS>
  bf16* shi = reinterpret_cast<bf16*>(smem + Tl::kSH);
  bf16* slo = reinterpret_cast<bf16*>(smem + Tl::kSL);
  const int c = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, parts = gridDim.y, c0 = c * L;
  const int rep = H / G, grp = slab / spg;
  const int h_begin = grp * rep + (slab % spg) * kSlabHeads;
  const int h_end = min(h_begin + kSlabHeads, (grp + 1) * rep);
  // the forward chunk holding this one, and which half of it this is
  // (ratio 2): the second half derives S_prev, the first half dS
  const int cf = c / ratio, sub = c % ratio;
  const bool mid_state = ratio == 2 && sub == 1;
  const bool mid_cotangent = ratio == 2 && sub == 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int m0 = 16 * (warp % 4), colh = warp / 4;
  const int i0 = m0 + g, i1 = i0 + 8;
  const int t0 = c0 + i0, t1 = c0 + i1;
  const Op opB{smem_u32(smem + Tl::kB), 0u, kPN};
  const Op opC{smem_u32(smem + Tl::kC), 0u, kPN};
  const Op opS{smem_u32(shi), smem_u32(slo), kPP};
  const Op opSW{smem_u32(smem + Tl::kWH), smem_u32(smem + Tl::kWL), kPL};
  const Op opMW{smem_u32(smem + Tl::kMH), smem_u32(smem + Tl::kML), kPL};

  load_tile<N>(Bm, smem + Tl::kB, b, c0, grp, G, S, tid);
  load_tile<N>(Cm, smem + Tl::kC, b, c0, grp, G, S, tid);
  // the other half's B (for S_prev) or C (for dS)
  if (mid_state) load_tile<N>(Bm, smem + Tl::kBP, b, c0 - L, grp, G, S, tid);
  if (mid_cotangent)
    load_tile<N>(Cm, smem + Tl::kBP, b, c0 + L, grp, G, S, tid);
  __syncthreads();
  // scores = C B^T, once for the slab's heads
  float sc[NTL][4];
  zero(sc);
  mm<NTL, true, false, false, false>(sc, N, opC, m0, opB, colh * (L / 2),
                                     lane);
  // the slab's dB and dC, summed over its heads in order
  float accB[NTN][4], accC[NTN][4];
  zero(accB);
  zero(accC);

  const bf16* xs = reinterpret_cast<const bf16*>(smem + Tl::kX);
  const bf16* dys = reinterpret_cast<const bf16*>(smem + Tl::kDY);
  const float* dts = reinterpret_cast<const float*>(smem + Tl::kDT);
  const float* dtn = reinterpret_cast<const float*>(smem + Tl::kDTN);
  const Op opX{smem_u32(xs), 0u, kPP};
  const Op opDY{smem_u32(dys), 0u, kPP};
  const uint32_t other = smem_u32(smem + Tl::kXN);
  const int c_other = mid_state ? c0 - L : c0 + L;

  for (int h = h_begin; h < h_end; ++h) {
    const float a_h = A[h];
    // the forward's state entering chunk cf and the walk's dS leaving it
    const long long fslot = (((long long)b * ncf + cf) * H + h) * N * P;
    const float* fwd = states + fslot;
    const float* ds = dstates + fslot;
    float sd = 0.f;  // this thread's part of <S_prev, dS>
    __syncthreads();  // the previous head's tiles and vectors read
    // this head's rows at once: x, dy and dt of this chunk, and the other
    // half's x (for S_prev) or dy (for dS) and dt
    {
      const uint32_t at = smem_u32(smem);
      issue_tile<P>(x, at + Tl::kX, b, c0, h, H, S, tid);
      issue_tile<P>(dy, at + Tl::kDY, b, c0, h, H, S, tid);
      if (ratio == 2)
        issue_tile<P>(mid_state ? x : dy, at + Tl::kXN, b, c_other, h, H, S,
                      tid);
      const int k = tid % L, t = (tid < L ? c0 : c_other) + k;
      if (tid < L || (tid < 2 * L && ratio == 2))
        cp_async4(at + (tid < L ? Tl::kDT : Tl::kDTN) + 4 * k,
                  dt + ((long long)b * S + (t < S ? t : 0)) * H + h, t < S);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // this head's rows in place
    if (warp == 0) chunk_cumsum<L>(dts, cum, a_h, lane);
    if (warp == 1 && ratio == 2) chunk_cumsum<L>(dtn, cump, a_h, lane);
    __syncthreads();
    const float total = cum[L - 1];
    if (mid_cotangent) {
      // dS leaving this chunk: the walk's, leaving the next, carried back
      // over the next chunk
      sd = advance_state<N, P>(
          ds, fwd, smem_u32(smem + Tl::kBP), other,
          [&](int i) { return expf(cump[i]); }, expf(cump[L - 1]), shi, slo,
          warp, lane);
    } else {
      load_split<N, P>(ds, nullptr, smem + Tl::kSH, smem + Tl::kSL, tid);
    }

    // M = dy x^T; SW, MW dt_j (hi + lo) and T = SW M dt_j
    {
      const int n0 = colh * (L / 2);
      float mv[NTL][4];
      zero(mv);
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
    {  // row sums minus column sums of T: 4 threads a row, each a quarter
       // in index order, the quarters summed over the quad
      static_assert(4 * L == kThreads, "a quad of threads per row of T");
      const int r = tid / 4, k0 = (tid % 4) * (L / 4);
      float row = 0.f, col = 0.f;
#pragma unroll
      for (int k = k0; k < k0 + L / 4; ++k) {
        row += tm[r * (L + 1) + k];
        col += tm[k * (L + 1) + r];
      }
      row = quad_sum(row);
      col = quad_sum(col);
      if (tid % 4 == 0) dcum[r] = row - col;
    }

    const float e0 = expf(total - cum[i0]), e1 = expf(total - cum[i1]);
    const float d0 = dts[i0], d1 = dts[i1];
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
      scale_rows(acc, e0, e1);
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

    // dB += dt_j e_j (dS x_j) + (MW^T C)_j
    {
      float acc[NTN][4];
      zero(acc);
      mm<NTN, true, false, false, true>(acc, P, opX, m0, opS, colh * (N / 2),
                                        lane);
      add_rows(accB, acc, d0 * e0, d1 * e1);
      mm<NTN, false, true, true, false>(accB, L, opMW, m0, opC,
                                        colh * (N / 2), lane);
    }
    __syncthreads();  // dS fully read

    // S_prev into the state tiles, and <S_prev, dS>: the forward's state
    // entering chunk cf, advanced over the first half of it where this
    // chunk is the second
    {
      if (mid_state) {
        const float tp = cump[L - 1];
        sd = advance_state<N, P>(
            fwd, ds, smem_u32(smem + Tl::kBP), other,
            [&](int i) { return dtn[i] * expf(tp - cump[i]); }, expf(tp),
            shi, slo, warp, lane);
      } else if (mid_cotangent) {
        load_split<N, P>(fwd, nullptr, smem + Tl::kSH, smem + Tl::kSL, tid);
      } else {
        sd = load_split<N, P>(fwd, ds, smem + Tl::kSH, smem + Tl::kSL, tid);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sd += __shfl_xor_sync(0xffffffffu, sd, off);
      if (lane == 0) red[warp] = sd;
    }
    __syncthreads();

    // dC += exp(cum_i) (S_prev dy_i) + (MW B)_i
    {
      float acc[NTN][4];
      zero(acc);
      mm<NTN, true, false, false, true>(acc, P, opDY, m0, opS,
                                        colh * (N / 2), lane);
      add_rows(accC, acc, expf(cum[i0]), expf(cum[i1]));
      mm<NTN, true, true, true, false>(accC, L, opMW, m0, opB,
                                       colh * (N / 2), lane);
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

    // dcum, its reverse cumsum d(dA), ddt and this chunk's part of dA, by
    // warp 0: positions 2 lane and 2 lane + 1, sums over the warp by a
    // butterfly (every lane the same bits)
    if (warp == 0) {
      static_assert(L == 64, "two positions a lane");
      float sd = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) sd += red[w];
      const int k = 2 * lane;
      const float u0 = part[k] + part[L + k];
      const float u1 = part[k + 1] + part[L + k + 1];
      float dtotal = u0 + u1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dtotal += __shfl_xor_sync(0xffffffffu, dtotal, off);
      dtotal += expf(total) * sd;
      const float v0 = dcum[k] - u0 + (part[4 * L + k] + part[5 * L + k]);
      const float v1 = dcum[k + 1] - u1 +
                       (part[4 * L + k + 1] + part[5 * L + k + 1]) +
                       (lane == 31 ? dtotal : 0.f);
      // suffix sums: this lane's pair, then the lanes above
      const float pair = v0 + v1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += up;
      }
      float above = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) above = 0.f;
      const float run1 = v1 + above, run0 = v0 + run1;
      dda[k] = run0;
      dda[k + 1] = run1;
      float da = fmaf(dts[k], run0, dts[k + 1] * run1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, off);
      if (lane == 0) da_part[((long long)b * nc + c) * H + h] = da;
    }
    __syncthreads();
    if (tid < L && c0 + tid < S)
      ddt[((long long)b * S + c0 + tid) * H + h] =
          part[2 * L + tid] + part[3 * L + tid] + a_h * dda[tid];
  }

  // the slab's parts of dB and dC
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
    const int n = colh * (N / 2) + 8 * nt + 2 * qd;
    const long long r0 = (((long long)b * S + t0) * parts + slab) * N + n;
    const long long r1 = (((long long)b * S + t1) * parts + slab) * N + n;
    if (t0 < S) {
      *reinterpret_cast<float2*>(db_part + r0) =
          make_float2(accB[nt][0], accB[nt][1]);
      *reinterpret_cast<float2*>(dc_part + r0) =
          make_float2(accC[nt][0], accC[nt][1]);
    }
    if (t1 < S) {
      *reinterpret_cast<float2*>(db_part + r1) =
          make_float2(accB[nt][2], accB[nt][3]);
      *reinterpret_cast<float2*>(dc_part + r1) =
          make_float2(accC[nt][2], accC[nt][3]);
    }
  }
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

// dst[b, t, g, n] = sum over k < spg, in order, of src[b, t, g spg + k, n]
// (src [Bt, S, parts, N], parts = G spg); blockIdx.y picks (db_part -> dB)
// or (dc_part -> dC)
template <typename T>
__global__ void bwd_reduce_groups(const float* __restrict__ db_part,
                                  const float* __restrict__ dc_part,
                                  T* __restrict__ dB, T* __restrict__ dC,
                                  long long rows, int G, int N, int spg) {
  const float* src = blockIdx.y ? dc_part : db_part;
  T* dst = blockIdx.y ? dC : dB;
  const long long total = rows * G * N;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(idx % N);
    const long long rg = idx / N;  // (b, t) * G + g
    const float* s = src + rg * spg * N + n;
    float v = 0.f;
    for (int k = 0; k < spg; ++k) v += s[(long long)k * N];
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
int reduce(const float* db_part, const float* dc_part, void* dB, void* dC,
           const float* da_part, float* dA, int Bt, int S, int H, int G,
           int N, int spg, int part_rows, cudaStream_t stream) {
  const long long total = (long long)Bt * S * G * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  bwd_reduce_groups<T><<<dim3(blocks, 2), 256, 0, stream>>>(
      db_part, dc_part, static_cast<T*>(dB), static_cast<T*>(dC),
      (long long)Bt * S, G, N, spg);
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
  const void *x, *dt, *A, *Bm, *Cm, *dy, *dfinal, *states;
  void *dx, *ddt, *dA, *dB, *dC, *scratch_a, *scratch_b, *db_part, *dc_part,
      *da_part;
  int Bt, S, H, G, N, P, nc, fwd_chunk;
  cudaStream_t stream;
};

template <typename T, int N, int P>
int launch_chunked(const Args& a) {
  constexpr int L = chunk_len<T, N, P>();
  if (a.nc != (a.S + L - 1) / L) return -1;
  // the forward's chunks: L or 2 L positions (a chunk that is the second
  // half of one derives its incoming state)
  if (a.fwd_chunk != L && a.fwd_chunk != 2 * L) return -1;
  const int ratio = a.fwd_chunk / L;
  const int ncf = (a.S + a.fwd_chunk - 1) / a.fwd_chunk;
  const int spg = (a.H / a.G + kSlabHeads - 1) / kSlabHeads;
  const dim3 walk_grid(a.H, a.Bt);
  const dim3 grad_grid(a.nc, a.G * spg, a.Bt);
  constexpr bool kTc = sizeof(T) == 2;  // bf16: the tensor-core passes
  constexpr size_t s1 = kTc ? tcb::WalkTiles<N, P>::kBytes
                            : walk_smem<N, P>();
  constexpr size_t s2 = kTc ? tcb::GradTiles<N, P>::kBytes
                            : grad_smem<N, P>();
  static bool configured = false;
  if (!configured) {
    if constexpr (kTc) {
      if (int e = set_smem(tcb::bwd_walk_mma<N, P>, s1)) return e;
      if (int e = set_smem(tcb::bwd_grad_mma<N, P>, s2)) return e;
    } else {
      if (int e = set_smem(bwd_walk_fma<N, P>, s1)) return e;
      if (int e = set_smem(bwd_grad_pass<N, P>, s2)) return e;
    }
    configured = true;
  }
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const T* dy = static_cast<const T*>(a.dy);
  const float* dt = static_cast<const float*>(a.dt);
  const float* A = static_cast<const float*>(a.A);
  const float* dfinal = static_cast<const float*>(a.dfinal);
  const float* states = static_cast<const float*>(a.states);
  float* dstates = static_cast<float*>(a.scratch_a);
  float* db_part = static_cast<float*>(a.db_part);
  float* dc_part = static_cast<float*>(a.dc_part);
  float* da_part = static_cast<float*>(a.da_part);
  if constexpr (kTc)
    tcb::bwd_walk_mma<N, P><<<walk_grid, kThreads, s1, a.stream>>>(
        dt, A, Cm, dy, dfinal, dstates, a.S, a.H, a.G, a.nc, ratio);
  else
    bwd_walk_fma<N, P><<<walk_grid, kThreads, s1, a.stream>>>(
        dt, A, Cm, dy, dfinal, dstates, a.S, a.H, a.G, a.nc, ratio);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if constexpr (kTc)
    tcb::bwd_grad_mma<N, P><<<grad_grid, kThreads, s2, a.stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, static_cast<T*>(a.dx),
        static_cast<float*>(a.ddt), db_part, dc_part, da_part, a.S, a.H,
        a.G, ncf, ratio, spg);
  else
    bwd_grad_pass<N, P><<<grad_grid, kThreads, s2, a.stream>>>(
        x, dt, A, Bm, Cm, dy, states, dstates, static_cast<T*>(a.dx),
        static_cast<float*>(a.ddt), db_part, dc_part, da_part, a.S, a.H,
        a.G, ncf, ratio, spg);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  return reduce<T>(db_part, dc_part, a.dB, a.dC, da_part,
                   static_cast<float*>(a.dA), a.Bt, a.S, a.H, a.G, N, spg,
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
      static_cast<float*>(a.ddt), static_cast<float*>(a.db_part),
      static_cast<float*>(a.dc_part), static_cast<float*>(a.scratch_a),
      static_cast<float*>(a.scratch_b), static_cast<float*>(a.da_part), a.S,
      a.H, a.G, a.N, a.P);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  // per-head partials: the heads of a group are its parts
  return reduce<T>(static_cast<const float*>(a.db_part),
                   static_cast<const float*>(a.dc_part), a.dB, a.dC,
                   static_cast<const float*>(a.da_part),
                   static_cast<float*>(a.dA), a.Bt, a.S, a.H, a.G, a.N,
                   a.H / a.G, a.Bt, a.stream);
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

// Heads per slab of the chunked route's gradient pass: each group's heads
// go in ceil(H / G / slab) slabs, each with its own dB and dC part.
extern "C" int ssd_scan_bwd_slab_heads() { return kSlabHeads; }

// route: 0 chunked, 1 generic, as kernels/ssd_scan.py::backward_route names
// it; dtype (of x, B, C, dy, dx, dB, dC): 0 float32, 1 bfloat16.  dfinal may
// be null (a zero cotangent).  Float32 scratch, chunked: `states` the
// forward's incoming chunk states [Bt, ceil(S / fwd_chunk), H, N, P]
// (read only; fwd_chunk = ssd_scan_inner_chunk of the forward, 1 or 2
// times ssd_scan_bwd_chunk(0, N, P, dtype)), scratch_a the cotangents of
// the states leaving the forward's chunks [Bt, ceil(S / fwd_chunk), H, N,
// P], nc = ceil(S / ssd_scan_bwd_chunk(0, N, P, dtype)), scratch_b unused, db_part and dc_part [Bt, S, G ceil(H / G / slab), N]
// (slab = ssd_scan_bwd_slab_heads()), da_part [Bt, nc, H].  Generic (states
// and fwd_chunk unused): scratch_a [Bt, H, nc, N, P] (checkpoints, nc =
// ceil(S / 64)), scratch_b [Bt, H, 64, N, P] (one segment's states), db_part
// and dc_part [Bt, S, H, N], da_part [Bt, H].  Returns a CUDA error code (0
// on success); -1 for a route, shape or type the kernel does not take or
// scratch sized for another chunk count, -3 for a pointer that is not
// 16-byte aligned (chunked, bf16).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* states,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* scratch_a,
    void* scratch_b, void* db_part, void* dc_part, void* da_part, int Bt,
    int S, int H, int G, int N, int P, int dtype, int nc, int fwd_chunk,
    int route, cudaStream_t stream) {
  if (Bt <= 0 || S <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0)
    return -1;
  const Args a{x,       dt,      A,         Bm,        Cm,      dy,
               dfinal,  states,  dx,        ddt,       dA,      dB,
               dC,      scratch_a, scratch_b, db_part, dc_part, da_part,
               Bt,      S,       H,         G,         N,       P,
               nc,      fwd_chunk, stream};
  if (route == 1) {
    if (dtype == 0) return launch_generic<float>(a);
    if (dtype == 1) return launch_generic<bf16>(a);
    return -1;
  }
  if (route != 0 || states == nullptr) return -1;
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
