// The Mamba layer's one-token decode step (K8) for sm_90a.
//
// Replaces no Pallas kernel: the JAX package's mamba_decode
// (models/mamba.py:236-257: the three _causal_conv calls with their SiLU,
// dt's softplus, the decay, the state update and the D skip) runs as XLA ops
// inside its jitted decode step (serve/engine.py:74), which fuses them.  For
// one token, per batch row b, head h (group g of h's heads) and column p:
//
//   conv, per channel of xs (h's P), B and C (g's N each), window
//   win = [state[0..K-2], x_t]:
//     pre = ((w[0] win[0] + w[1] win[1]) + ...) + bias     (in the input type T)
//     out = T(silu(float(pre)));  new state = win[1..K-1]
//   dt = softplus(float(dt_raw[b,h]) + dt_bias[h]);  A = -exp(A_log[h])
//   dA = exp(dt * A)
//   s_new[n,p] = s[n,p] * dA + B[n] * (dt * x[p])                 (float32)
//   y[p] = T(sum_n C[n] T(s_new[n,p]));  out[p] = T(y + T(x[p] * T(D[h])))
//
// The conv rounds as K6's forward (csrc/mamba_conv.cu): each product, sum
// and the bias to T in that order, each float32 op rounded to T as torch's
// eager ops are (in bf16 this gives K6's bf16-pair mul.rn/add.rn bits: a
// product of two bf16 values is exact in float32, a sum of two exact or off
// by under a quarter ulp), so its outputs and new states are
// causal_conv_plain's bit for bit.  Each op of the state update rounds as the
// plain version's torch op (__fmul_rn / __fadd_rn, no FMA; softplus as
// torch's log1p(exp(x)) below its threshold of 20), so s_new is its bit for
// bit.  The sum over n runs in a fixed order (a thread's rows in turn, a
// butterfly of warp shuffles, the warps in order through shared memory),
// another order than the plain version's product: y is within its rounding,
// and two calls give the same bits.  All four states are read once and
// written once, in place.
//
// What bounds it: bytes, the float32 state read and written once (4 MiB a
// layer at mamba2-1.3b's 64 heads x 128 x 64 and batch 1; the conv states,
// inputs and weights add ~0.1 MB), and at one token the latency of the
// chain load -> conv -> barrier -> update -> sum -> store.  Design: a block
// per (row, head, chunk of VPB 16-byte vectors of P), about one block an SM
// (see plan below); a thread owns one vector column (4 neighbouring p) on NR
// rows of N, and issues its NR state loads before anything else, so dt's
// softplus, the decay and the convs run while they are in flight
// (mamba2-1.3b: 128 blocks of 256 threads, 32 columns and 4 rows a thread,
// 16 KB in flight a block; jamba's layer: 128 blocks of whole 128-column
// heads, 16 rows a thread, 64 KB a block).  The convs run one channel a
// thread: every block computes the group's 2N B and C values itself, and its
// first threads the chunk's xs channels.
//
// In place, and the one race: the xs channels of a chunk and ssm[b, h, :, p]
// belong to one block, which reads them before it writes them.  The B/C conv
// state is shared by every block of a group: each reads its window, so no
// block may shift it before all have read.  The cure: once a block's reads
// are done (the windows' values are in shared memory, past a barrier), one
// lane of its last warp adds one to the group's counter (an acq_rel atomic,
// with no global store of the block before it); the block that brings the
// count to the group's number of blocks is the last reader, and its last
// warp writes the group's new B/C state from those windows and sets the
// counter back to 0 for the next launch.  The atomic's result is read only
// then, so the convs' SiLU, the update and the sum run while it is in
// flight.  No block waits for another: the launch captures in a CUDA graph
// and replays bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DEC_K 4            // conv taps (every configuration's d_conv)
#define DEC_THREADS 256    // threads a block at most
#define DEC_MAX_VPB 32     // 16-byte column vectors a block at most
#define DEC_MAX_NR 16      // state rows a thread at most
#define DEC_FILL 128       // blocks wanted: about one an SM
#define DEC_MAX_N 128      // d_state at most (2N B/C channels, one a thread)

struct DecArgs {
  const void* xs;          // [Bt, 1, H*P] the projection, before the conv
  const void* Bm;          // [Bt, 1, G*N]
  const void* Cm;
  const void* dt;          // [Bt, 1, H] raw
  const void* wx;          // [K, H*P] conv weights, [K, G*N] for B and C
  const void* wB;
  const void* wC;
  const void* bx;          // conv biases
  const void* bB;
  const void* bC;
  void* sx;                // [Bt, K-1, H*P] conv states, in place
  void* sB;                // [Bt, K-1, G*N]
  void* sC;
  float* ssm;              // [Bt, H, N, P] float32, in place
  const float* dt_bias;    // [H]
  const float* A_log;
  const float* D;
  void* y;                 // [Bt, H, P] out
  int* counters;           // [Bt * G] zeros between launches
  int H, G, N, P;
  int VPB;                 // 16-byte column vectors a block
  int R;                   // rows of threads a block (blockDim.x / VPB)
  int CH;                  // column chunks a head (P / 4 / VPB)
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// v rounded to T and back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch's softplus at beta 1, threshold 20
__device__ __forceinline__ float softplus(float a) {
  return a > 20.0f ? a : log1pf(expf(a));
}

// torch's silu: x / (1 + exp(-x)) in float32
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

// one channel's conv window (state[0..K-2], rows ``stride`` apart, then the
// projection ``raw``), weights and bias, loaded
struct Conv {
  float win[DEC_K], w[DEC_K], bias;
};

template <typename T>
__device__ __forceinline__ Conv conv_load(const T* st, size_t stride,
                                          const T* raw, const T* w,
                                          size_t wstride, const T* bias) {
  Conv c;
#pragma unroll
  for (int i = 0; i < DEC_K - 1; ++i) c.win[i] = ld(st + i * stride);
  c.win[DEC_K - 1] = ld(raw);
#pragma unroll
  for (int i = 0; i < DEC_K; ++i) c.w[i] = ld(w + i * wstride);
  c.bias = ld(bias);
  return c;
}

// the conv with its SiLU, rounded as the plain ops: each product, sum and
// the bias to T in that order (as K6's forward; a product of two bf16
// values is exact in float32, so rounding each float32 op to bf16 gives
// torch's eager bf16 ops, and K6's bf16-pair route, bit for bit)
template <typename T>
__device__ __forceinline__ float conv_silu(const Conv& c) {
  float acc = rnd<T>(__fmul_rn(c.win[0], c.w[0]));
#pragma unroll
  for (int i = 1; i < DEC_K; ++i)
    acc = rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(c.win[i], c.w[i]))));
  return rnd<T>(silu(rnd<T>(__fadd_rn(acc, c.bias))));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// add one to a group's counter; returns the count before.  acq_rel: this
// block's reads of the group's window (done: their values are in shared
// memory, past a barrier) come before it, and the last reader's writes of
// the new state after it
__device__ __forceinline__ int count(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

template <typename T, int NR>
__global__ void __launch_bounds__(DEC_THREADS)
decode_layer(const __grid_constant__ DecArgs a) {
  __shared__ float bc[2 * DEC_MAX_N];                  // B's, then C's conv
  __shared__ float bc_win[DEC_K][2 * DEC_MAX_N];       // their windows
  __shared__ float xc[DEC_MAX_VPB * 4];                // the xs channels'
  __shared__ float part[DEC_THREADS / 32][DEC_MAX_VPB * 4];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, warps = nt / 32;
  const int H = a.H, G = a.G, N = a.N, P = a.P, VPB = a.VPB, R = a.R;
  const int chunk = blockIdx.x % a.CH;
  const int bh = blockIdx.x / a.CH;                    // b * H + h
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int vc = tid % VPB, r = tid / VPB;
  const int p0 = (chunk * VPB + vc) * 4;
  const int GN = G * N, HP = H * P, cols = VPB * 4;

  // 1. the thread's state rows, every load issued before the prologue
  float* srow = a.ssm + (size_t)bh * N * P + p0;
  float s[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int n = r + i * R;
    const float4 v = n < N
        ? *reinterpret_cast<const float4*>(srow + (size_t)n * P)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    s[i][0] = v.x;
    s[i][1] = v.y;
    s[i][2] = v.z;
    s[i][3] = v.w;
  }

  // 2. dt and the decay
  const float dt = softplus(__fadd_rn(ld((const T*)a.dt + bh), a.dt_bias[h]));
  const float dA = expf(__fmul_rn(dt, -expf(a.A_log[h])));

  // 3. the convs' loads, one channel a thread: the chunk's xs channels
  // (the first threads; these channels are this block's alone) and the
  // group's B and C, whose windows go to shared memory: once they are
  // there, this block's reads of the group's state are done
  const bool xs_thread = tid < cols, bc_thread = tid < 2 * N;
  T* sx = (T*)a.sx + (size_t)b * (DEC_K - 1) * HP + h * P + chunk * cols +
          tid;
  Conv xconv, bconv;
  if (xs_thread) {
    const int ch = h * P + chunk * cols + tid;
    xconv = conv_load<T>(sx, HP, (const T*)a.xs + (size_t)b * HP + ch,
                         (const T*)a.wx + ch, HP, (const T*)a.bx + ch);
  }
  if (bc_thread) {
    const bool isC = tid >= N;
    const int ch = g * N + (isC ? tid - N : tid);
    bconv = conv_load<T>(
        (const T*)(isC ? a.sC : a.sB) + (size_t)b * (DEC_K - 1) * GN + ch, GN,
        (const T*)(isC ? a.Cm : a.Bm) + (size_t)b * GN + ch,
        (const T*)(isC ? a.wC : a.wB) + ch, GN,
        (const T*)(isC ? a.bC : a.bB) + ch);
#pragma unroll
    for (int i = 0; i < DEC_K; ++i) bc_win[i][tid] = bconv.win[i];
  }
  __syncthreads();

  // 4. count this block's reads of the group's window (the last warp's
  // first lane; the result is read only at the end, so the convs, the
  // update and the sum run while the atomic is in flight)
  int ticket = 0;
  if (warp == warps - 1 && lane == 0) ticket = count(a.counters + b * G + g);
  if (bc_thread) bc[tid] = conv_silu<T>(bconv);
  if (xs_thread) xc[tid] = conv_silu<T>(xconv);
  __syncthreads();

  // 5. the state update, written in place, and the thread's partial y
  float x[4], dtx[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = xc[vc * 4 + j];
    dtx[j] = __fmul_rn(dt, x[j]);
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int n = r + i * R;
    if (n < N) {
      const float bv = bc[n], cv = bc[N + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fadd_rn(__fmul_rn(s[i][j], dA), __fmul_rn(bv, dtx[j]));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(cv, rnd<T>(s[i][j])));
      }
      *reinterpret_cast<float4*>(srow + (size_t)n * P) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
  }

  // 6. y over N: a butterfly over the warp's rows (every lane of a column
  // ends with the same bits), then the warps in order
  for (int off = VPB; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  }
  if (lane < VPB) {
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp][vc * 4 + j] = acc[j];
  }
  __syncthreads();
  if (xs_thread) {
    float t = part[0][tid];
    for (int w = 1; w < warps; ++w) t = __fadd_rn(t, part[w][tid]);
    st((T*)a.y + (size_t)bh * P + chunk * cols + tid,
       __fadd_rn(rnd<T>(t), rnd<T>(__fmul_rn(xc[tid], rnd<T>(a.D[h])))));
#pragma unroll
    for (int i = 0; i < DEC_K - 1; ++i)
      st(sx + (size_t)i * HP, xconv.win[i + 1]);
  }

  // 7. the group's new B/C conv state, by its last reader's last warp,
  // which then sets the counter back to zero for the next launch
  if (warp == warps - 1) {
    const int blocks = (H / G) * a.CH;
    if (__shfl_sync(0xffffffffu, ticket, 0) == blocks - 1) {
      for (int c = lane; c < 2 * N; c += 32) {
        const bool isC = c >= N;
        T* st0 = (T*)(isC ? a.sC : a.sB) + (size_t)b * (DEC_K - 1) * GN +
                 g * N + (isC ? c - N : c);
#pragma unroll
        for (int i = 0; i < DEC_K - 1; ++i) st(st0 + (size_t)i * GN,
                                               bc_win[i + 1][c]);
      }
      if (lane == 0) atomicExch(a.counters + b * G + g, 0);
    }
  }
}

// rows of threads for VPB vector columns: N rounded up to whole warps, and
// at least enough threads for the 2N B/C channels, at most DEC_THREADS
static int rows_for(int N, int vpb) {
  const int lanes = 32 / vpb;
  const int need = N > (2 * N + vpb - 1) / vpb ? N : (2 * N + vpb - 1) / vpb;
  const int r = (need + lanes - 1) / lanes * lanes;
  return r < DEC_THREADS / vpb ? r : DEC_THREADS / vpb;
}

// The launch's shape for Bt x H heads, N and P: VPB (16-byte column vectors
// a block: a power of two dividing P / 4, up to 32), R (rows of threads), NR
// (rows a thread, at most DEC_MAX_NR) and CH (column chunks a head).  The
// blocks (Bt H CH) are about one an SM: the largest VPB that still makes
// DEC_FILL blocks (fewer, wider blocks: fewer atomics on a group's counter
// and fewer copies of the group's B/C conv), or the largest VPB where even
// VPB = 1 makes fewer.  False where the kernel does not take the shape.
static bool plan(int BtH, int N, int P, int* VPB, int* R, int* NR, int* CH) {
  if (N < 1 || N > DEC_MAX_N || P < 4 || P % 4) return false;
  const int v = P / 4;
  int top = 1;
  while (top * 2 <= DEC_MAX_VPB && v % (top * 2) == 0) top *= 2;
  int vpb = top;
  if ((long long)BtH * v >= DEC_FILL)
    while (vpb > 1 && (long long)BtH * (v / vpb) < DEC_FILL) vpb /= 2;
  while (vpb > 1 && (N + rows_for(N, vpb) - 1) / rows_for(N, vpb) >
                        DEC_MAX_NR)
    vpb /= 2;
  const int r = rows_for(N, vpb);
  *VPB = vpb;
  *R = r;
  *NR = (N + r - 1) / r;
  *CH = v / vpb;
  return *NR <= DEC_MAX_NR && 2 * N <= vpb * r;
}

template <typename T>
static void launch(const DecArgs& a, int nr, int blocks, int threads,
                   cudaStream_t s) {
  if (nr <= 1)
    decode_layer<T, 1><<<blocks, threads, 0, s>>>(a);
  else if (nr <= 2)
    decode_layer<T, 2><<<blocks, threads, 0, s>>>(a);
  else if (nr <= 4)
    decode_layer<T, 4><<<blocks, threads, 0, s>>>(a);
  else if (nr <= 8)
    decode_layer<T, 8><<<blocks, threads, 0, s>>>(a);
  else
    decode_layer<T, 16><<<blocks, threads, 0, s>>>(a);
}

// 1 where the kernel takes conv width K, d_state N and head dim P
extern "C" int decode_layer_takes(int K, int N, int P) {
  int vpb, r, nr, ch;
  return K == DEC_K && plan(1, N, P, &vpb, &r, &nr, &ch);
}

// dtype 0 float32, 1 bfloat16; ptrs: xs, B, C, dt, wx, wB, wC, bx, bB, bC,
// sx, sB, sC, ssm, dt_bias, A_log, D, y (as DecArgs); counters: n_counters
// ints, zero; returns cudaGetLastError()
extern "C" int decode_layer_launch(int dtype, int Bt, int H, int G, int N,
                                   int P, int K, void** ptrs, int* counters,
                                   int n_counters, void* stream) {
  int vpb, r, nr, ch;
  if (Bt < 1 || H < 1 || G < 1 || H % G || K != DEC_K ||
      !plan(Bt * H, N, P, &vpb, &r, &nr, &ch) || n_counters < Bt * G ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  DecArgs a;
  a.xs = ptrs[0];
  a.Bm = ptrs[1];
  a.Cm = ptrs[2];
  a.dt = ptrs[3];
  a.wx = ptrs[4];
  a.wB = ptrs[5];
  a.wC = ptrs[6];
  a.bx = ptrs[7];
  a.bB = ptrs[8];
  a.bC = ptrs[9];
  a.sx = ptrs[10];
  a.sB = ptrs[11];
  a.sC = ptrs[12];
  a.ssm = (float*)ptrs[13];
  a.dt_bias = (const float*)ptrs[14];
  a.A_log = (const float*)ptrs[15];
  a.D = (const float*)ptrs[16];
  a.y = ptrs[17];
  a.counters = counters;
  a.H = H;
  a.G = G;
  a.N = N;
  a.P = P;
  a.VPB = vpb;
  a.R = r;
  a.CH = ch;
  const int blocks = Bt * H * ch;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    launch<__nv_bfloat16>(a, nr, blocks, vpb * r, s);
  else
    launch<float>(a, nr, blocks, vpb * r, s);
  return (int)cudaGetLastError();
}
