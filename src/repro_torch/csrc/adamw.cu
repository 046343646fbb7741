// AdamW update kernel (K5) for sm_90a.
//
// Replaces the JAX package's optimizer update as its train step runs it:
// train/optimizer.py::adamw_update (the global gradient norm, clipping,
// float32 moments in and out, decoupled weight decay, bias corrections),
// with the step's NaN-skip (jnp.where on every output), inside the jitted
// step of train/loop.py::jit_train_step, whose donate_argnums=(0, 1) lets
// XLA fuse the update and write the new parameters and moments over the
// old buffers.  The arithmetic is a transcription of
// repro_torch/kernels/adamw.py::adamw_step_plain_, op for op.
//
// What bounds it: every parameter's gradient is read twice (the norm must
// be known before any element is updated) and its parameter, moments are
// read and written once: 24 bytes a parameter with bf16 parameters and
// gradients and float32 moments, 16 with bf16 moments, and ~1 FLOP a
// byte.  So it is bound by device memory's bytes; the design moves each
// byte once per pass and does nothing else.
//
// Design:
// - One table in device memory, built once by the caller for a set of
//   tensors that the update writes in place: per tensor the parameter and
//   moment pointers (in and out; equal in place), its length, a dtype code
//   and the decay flag, and the prefix of its chunk counts.  The tensors
//   are cut into chunks of ADAMW_CHUNK elements, one block a chunk, every
//   tensor of every dtype in one launch; a block finds its tensor by a
//   binary search of the prefix.  The gradients are new tensors every
//   step, so their pointers come with each launch, by value in a kernel
//   parameter (GradPtrs, at most GRAD_CAP tensors): a CUDA graph records
//   them at capture, and no host copy runs inside the step.
// - Pass 1, adamw_norm: a block's sum of squares of its chunk of the
//   gradient into a fixed slot; adamw_finish (one block) adds the slots in
//   a fixed order in double, then the norm, the clip scale, the NaN-skip
//   flag ok = isfinite(loss) && isfinite(norm) and the step count (+1 only
//   when ok).  No float atomics: two calls give the same bits, and so do a
//   graph's replay and an eager call.
// - On a mesh each rank updates its local shards, and the norm is the
//   whole gradient's: adamw_finish splits at its reduction into adamw_sum
//   (the same fixed-order sum of this rank's slots, into one double in
//   device memory) and adamw_finish_total (the rest, from a given double).
//   Between the two the caller all-reduces that double over the mesh, so
//   K5's finish is one device function fed either total: where nothing is
//   reduced the split reads the fused kernel's bits.  A row flagged
//   NO_NORM (a shard replicated over a mesh dimension, on the ranks past
//   coordinate 0 of it) writes 0 into its slots, so every element of the
//   gradient enters the global sum once.  Its blocks still read it: a
//   branch out before the loop made ptxas spill in adamw_norm and cost a
//   tenth of the norm pass on every row.  A row of 0 elements has no
//   chunk, and a rank whose rows are all empty still sums (to 0).
// - Pass 2, adamw_apply: p, m, v <- AdamW(g * scale) for every element;
//   when !ok it writes nothing in place (out of place it copies the
//   inputs).  The scale, ok and the bias corrections c1, c2 are read from
//   device memory (the caller computes c1, c2 with the plain version's
//   torch scalar ops, so they are its bits).
// - Each operation rounds as the plain version's separate tensor op does:
//   __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn and __fsqrt_rn, never
//   contracted into an FMA; bf16 results by __float2bfloat16_rn, as
//   torch's casts round.  The Python constants (b1, 1 - b1, b2, 1 - b2, lr,
//   weight_decay, eps, grad_clip, 1e-9) arrive rounded to float32, as a
//   torch scalar op rounds them.
// - Memory: 16-byte vector loads and stores of 8 elements where every
//   pointer of the tensor reaches 16-byte alignment at one element index
//   (a tensor's start from the caching allocator always does), with a
//   scalar head and tail in each chunk; a tensor whose pointers never
//   share an alignment runs scalar.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ADAMW_CHUNK
#define ADAMW_CHUNK 32768
#endif
#define ADAMW_THREADS 256
#define ADAMW_FINISH_THREADS 1024

// Gradient pointers a launch carries by value (16 KB): CUDA 12.1 raised the
// kernel parameter limit from 4 KB to 32 KB.
#if CUDART_VERSION < 12010
#error "adamw.cu passes 16 KB of kernel parameters: it needs CUDA 12.1 or later"
#endif
#define GRAD_CAP 2048

// A table row: pointers p, m, v, p_out, m_out, v_out, then numel and a
// code (bit 0: parameters bf16, bit 1: gradients bf16, bit 2: moments
// bf16, bit 8: decay, bit 9: left out of the norm on this rank).  The
// n + 1 chunk prefixes follow the n rows.
#define ROW 8
#define P_BF16 1
#define G_BF16 2
#define M_BF16 4
#define DECAY 256
#define NO_NORM 512

struct GradPtrs {
  const void* g[GRAD_CAP];
};

struct Hyper {
  float b1, omb1, b2, omb2, lr, wd, eps;
};

__device__ __forceinline__ float ld1(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld1(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st1(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void st1(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void ld8(const float* p, long long i,
                                    float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  const float4 b = *reinterpret_cast<const float4*>(p + i + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, long long i,
                                    float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p + i);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // a bf16 is the high half of its float32
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void st8(float* p, long long i,
                                    const float (&x)[8]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + i + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, long long i,
                                    const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k]));
    const uint32_t hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The smallest element index a in [0, 8) at which every (pointer, element
// size) pair is 16-byte aligned, or -1.  From a, every index a + 8k is.
__device__ __forceinline__ int vector_phase(const uintptr_t* ptr,
                                            const int* size, int n) {
  for (int a = 0; a < 8; ++a) {
    bool all = true;
    for (int k = 0; k < n; ++k)
      all = all && ((ptr[k] + (uintptr_t)a * size[k]) % 16 == 0);
    if (all) return a;
  }
  return -1;
}

// The table row holding chunk c: the last row whose chunk prefix is <= c
// (rows without chunks are passed over).
__device__ __forceinline__ int find_row(const long long* prefix, int n_rows,
                                        long long c) {
  int lo = 0, hi = n_rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The chunk [s, e) of a tensor: scalar head [s, vs), vectors of 8 from vs,
// scalar tail [ve, e).
struct Span {
  long long s, vs, nv, ve, e;
};

__device__ __forceinline__ Span chunk_span(long long k, long long numel,
                                           int phase) {
  Span r;
  r.s = k * ADAMW_CHUNK;
  r.e = min(r.s + (long long)ADAMW_CHUNK, numel);
  r.vs = phase < 0 ? r.e : min(r.e, r.s + phase);
  r.nv = (r.e - r.vs) / 8;
  r.ve = r.vs + 8 * r.nv;
  return r;
}

template <typename G>
__device__ float sum_squares(const G* g, const Span& sp) {
  float acc = 0.f;
  for (long long i = sp.s + threadIdx.x; i < sp.vs; i += ADAMW_THREADS) {
    const float x = ld1(g, i);
    acc = __fmaf_rn(x, x, acc);
  }
  for (long long j = threadIdx.x; j < sp.nv; j += ADAMW_THREADS) {
    float x[8];
    ld8(g, sp.vs + 8 * j, x);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = __fmaf_rn(x[k], x[k], acc);
  }
  for (long long i = sp.ve + threadIdx.x; i < sp.e; i += ADAMW_THREADS) {
    const float x = ld1(g, i);
    acc = __fmaf_rn(x, x, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(ADAMW_THREADS)
adamw_norm(const long long* __restrict__ tab, int n_rows, GradPtrs gp,
           float* __restrict__ slots) {
  const long long* prefix = tab + (long long)ROW * n_rows;
  const long long c = blockIdx.x;
  const int r = find_row(prefix, n_rows, c);
  const long long* row = tab + (long long)ROW * r;
  const int code = (int)row[7];
  const void* g = gp.g[r];
  const uintptr_t ptr[1] = {(uintptr_t)g};
  const int size[1] = {code & G_BF16 ? 2 : 4};
  const Span sp = chunk_span(c - prefix[r], row[6],
                             vector_phase(ptr, size, 1));
  float acc = code & G_BF16
                  ? sum_squares((const __nv_bfloat16*)g, sp)
                  : sum_squares((const float*)g, sp);
  // fixed-order block sum: a shuffle tree per warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  __shared__ float warp_sum[ADAMW_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = warp_sum[0];
    for (int w = 1; w < ADAMW_THREADS / 32; ++w) s = __fadd_rn(s, warp_sum[w]);
    slots[c] = code & NO_NORM ? 0.f : s;     // counted on another rank
  }
}

// The slots' sum in double, in a fixed order: a strided sum per thread,
// then a tree over the block's threads; every thread returns it.
__device__ double slot_sum(const float* __restrict__ slots, long long n_slots,
                           double* part) {
  double acc = 0.0;
  for (long long i = threadIdx.x; i < n_slots; i += ADAMW_FINISH_THREADS)
    acc += (double)slots[i];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = ADAMW_FINISH_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  return part[0];
}

// From the gradient's sum of squares: scal[0] = the gradient norm, scal[1]
// = the clip scale, scal[2] = ok (1 or 0); step_out = step_in + ok.
__device__ void finish_from(double total, const float* __restrict__ loss,
                            float clip, float tiny, const int* step_in,
                            int* step_out, float* __restrict__ scal) {
  const float norm = (float)sqrt(total);
  // the plain version: clamp(grad_clip / (norm + 1e-9), max=1), where
  // torch divides a number by a tensor as reciprocal(tensor) * number
  const float r = __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(norm, tiny)), clip);
  const bool ok = isfinite(norm) && (loss == nullptr || isfinite(*loss));
  scal[0] = norm;
  scal[1] = r > 1.0f ? 1.0f : r;
  scal[2] = ok ? 1.0f : 0.0f;
  step_out[0] = step_in[0] + (ok ? 1 : 0);
}

__global__ void __launch_bounds__(ADAMW_FINISH_THREADS)
adamw_finish(const float* __restrict__ slots, long long n_slots,
             const float* __restrict__ loss, float clip, float tiny,
             const int* step_in, int* step_out, float* __restrict__ scal) {
  __shared__ double part[ADAMW_FINISH_THREADS];
  const double total = slot_sum(slots, n_slots, part);
  if (threadIdx.x == 0)
    finish_from(total, loss, clip, tiny, step_in, step_out, scal);
}

// The mesh's split finish: this rank's sum, then (after the all-reduce)
// the rest from the whole gradient's.
__global__ void __launch_bounds__(ADAMW_FINISH_THREADS)
adamw_sum(const float* __restrict__ slots, long long n_slots,
          double* __restrict__ total) {
  __shared__ double part[ADAMW_FINISH_THREADS];
  const double t = slot_sum(slots, n_slots, part);
  if (threadIdx.x == 0) total[0] = t;
}

__global__ void adamw_finish_total(const double* __restrict__ total,
                                   const float* __restrict__ loss, float clip,
                                   float tiny, const int* step_in,
                                   int* step_out, float* __restrict__ scal) {
  finish_from(total[0], loss, clip, tiny, step_in, step_out, scal);
}

// One element, as adamw_step_plain_ computes it tensor by tensor.
__device__ __forceinline__ void adamw_element(float g, float& p, float& m,
                                              float& v, float scale, float c1,
                                              float c2, bool decay,
                                              const Hyper& h) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(gs, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(gs, gs), h.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps);
  float delta = __fdiv_rn(__fdiv_rn(m, c1), den);
  if (decay) delta = __fadd_rn(delta, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, delta));
}

template <typename P, typename G, typename M>
__device__ void apply_chunk(const long long* row, const void* gv, long long k,
                            bool ok, float scale, float c1, float c2,
                            const Hyper& h) {
  const P* p = (const P*)row[0];
  const M* m = (const M*)row[1];
  const M* v = (const M*)row[2];
  P* po = (P*)row[3];
  M* mo = (M*)row[4];
  M* vo = (M*)row[5];
  const G* g = (const G*)gv;
  const bool decay = row[7] & DECAY;
  const uintptr_t ptr[7] = {(uintptr_t)p, (uintptr_t)m, (uintptr_t)v,
                            (uintptr_t)po, (uintptr_t)mo, (uintptr_t)vo,
                            (uintptr_t)g};
  const int size[7] = {(int)sizeof(P), (int)sizeof(M), (int)sizeof(M),
                       (int)sizeof(P), (int)sizeof(M), (int)sizeof(M),
                       (int)sizeof(G)};
  const Span sp = chunk_span(k, row[6], vector_phase(ptr, size, 7));
  for (int part = 0; part < 2; ++part) {      // scalar head, then tail
    const long long a = part ? sp.ve : sp.s, b = part ? sp.e : sp.vs;
    for (long long i = a + threadIdx.x; i < b; i += ADAMW_THREADS) {
      float pi = ld1(p, i), mi = ld1(m, i), vi = ld1(v, i);
      if (ok) adamw_element(ld1(g, i), pi, mi, vi, scale, c1, c2, decay, h);
      st1(po, i, pi);
      st1(mo, i, mi);
      st1(vo, i, vi);
    }
  }
  for (long long j = threadIdx.x; j < sp.nv; j += ADAMW_THREADS) {
    const long long i = sp.vs + 8 * j;
    float pi[8], mi[8], vi[8];
    ld8(p, i, pi);
    ld8(m, i, mi);
    ld8(v, i, vi);
    if (ok) {
      float gi[8];
      ld8(g, i, gi);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        adamw_element(gi[e], pi[e], mi[e], vi[e], scale, c1, c2, decay, h);
    }
    st8(po, i, pi);
    st8(mo, i, mi);
    st8(vo, i, vi);
  }
}

__global__ void __launch_bounds__(ADAMW_THREADS)
adamw_apply(const long long* __restrict__ tab, int n_rows, GradPtrs gp,
            const float* __restrict__ scal, const float* __restrict__ c1p,
            const float* __restrict__ c2p, Hyper h) {
  const long long* prefix = tab + (long long)ROW * n_rows;
  const long long c = blockIdx.x;
  const int r = find_row(prefix, n_rows, c);
  const long long* row = tab + (long long)ROW * r;
  const bool ok = scal[2] != 0.0f;
  // skipped in place: nothing to write
  if (!ok && row[0] == row[3] && row[1] == row[4] && row[2] == row[5]) return;
  const long long k = c - prefix[r];
  const void* g = gp.g[r];
  const float scale = scal[1], c1 = *c1p, c2 = *c2p;
  switch ((int)row[7] & 7) {
    case 0: apply_chunk<float, float, float>(row, g, k, ok, scale, c1, c2, h); break;
    case P_BF16: apply_chunk<__nv_bfloat16, float, float>(row, g, k, ok, scale, c1, c2, h); break;
    case G_BF16: apply_chunk<float, __nv_bfloat16, float>(row, g, k, ok, scale, c1, c2, h); break;
    case P_BF16 | G_BF16: apply_chunk<__nv_bfloat16, __nv_bfloat16, float>(row, g, k, ok, scale, c1, c2, h); break;
    case M_BF16: apply_chunk<float, float, __nv_bfloat16>(row, g, k, ok, scale, c1, c2, h); break;
    case P_BF16 | M_BF16: apply_chunk<__nv_bfloat16, float, __nv_bfloat16>(row, g, k, ok, scale, c1, c2, h); break;
    case G_BF16 | M_BF16: apply_chunk<float, __nv_bfloat16, __nv_bfloat16>(row, g, k, ok, scale, c1, c2, h); break;
    default: apply_chunk<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(row, g, k, ok, scale, c1, c2, h); break;
  }
}

static int fill_grads(GradPtrs& gp, const void* const* g, int n) {
  if (n <= 0 || n > GRAD_CAP) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) gp.g[i] = g[i];
  for (int i = n; i < GRAD_CAP; ++i) gp.g[i] = nullptr;
  return 0;
}

extern "C" int adamw_grad_capacity() { return GRAD_CAP; }

extern "C" int adamw_chunk() { return ADAMW_CHUNK; }

// Pass 1 over the table's n_rows rows and n_chunks chunks; g holds the
// rows' gradient pointers, in the table's order.
extern "C" int adamw_norm_launch(const long long* tab, int n_rows,
                                 long long n_chunks, const void* const* g,
                                 float* slots, void* stream) {
  GradPtrs gp;
  int err = fill_grads(gp, g, n_rows);
  if (err) return err;
  if (n_chunks <= 0) return 0;
  adamw_norm<<<(unsigned)n_chunks, ADAMW_THREADS, 0, (cudaStream_t)stream>>>(
      tab, n_rows, gp, slots);
  return (int)cudaGetLastError();
}

extern "C" int adamw_finish_launch(const float* slots, long long n_slots,
                                   const float* loss, float clip, float tiny,
                                   const int* step_in, int* step_out,
                                   float* scal, void* stream) {
  adamw_finish<<<1, ADAMW_FINISH_THREADS, 0, (cudaStream_t)stream>>>(
      slots, n_slots, loss, clip, tiny, step_in, step_out, scal);
  return (int)cudaGetLastError();
}

extern "C" int adamw_sum_launch(const float* slots, long long n_slots,
                                double* total, void* stream) {
  adamw_sum<<<1, ADAMW_FINISH_THREADS, 0, (cudaStream_t)stream>>>(
      slots, n_slots, total);
  return (int)cudaGetLastError();
}

extern "C" int adamw_finish_total_launch(const double* total,
                                         const float* loss, float clip,
                                         float tiny, const int* step_in,
                                         int* step_out, float* scal,
                                         void* stream) {
  adamw_finish_total<<<1, 1, 0, (cudaStream_t)stream>>>(
      total, loss, clip, tiny, step_in, step_out, scal);
  return (int)cudaGetLastError();
}

extern "C" int adamw_apply_launch(const long long* tab, int n_rows,
                                  long long n_chunks, const void* const* g,
                                  const float* scal, const float* c1,
                                  const float* c2, float b1, float omb1,
                                  float b2, float omb2, float lr, float wd,
                                  float eps, void* stream) {
  GradPtrs gp;
  int err = fill_grads(gp, g, n_rows);
  if (err) return err;
  if (n_chunks <= 0) return 0;
  const Hyper h = {b1, omb1, b2, omb2, lr, wd, eps};
  adamw_apply<<<(unsigned)n_chunks, ADAMW_THREADS, 0, (cudaStream_t)stream>>>(
      tab, n_rows, gp, scal, c1, c2, h);
  return (int)cudaGetLastError();
}
