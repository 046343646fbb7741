// Causal depthwise conv with its SiLU (K6) for sm_90a, forward and backward.
//
// Replaces no Pallas kernel: the JAX package's Mamba block runs
// models/mamba.py::_causal_conv (with jax.nn.silu) as XLA ops, which its
// jitted train step (train/loop.py:108) and decode step
// (serve/engine.py:74) fuse.  The port ran the same ops eagerly, about a
// dozen passes over each input.  Per channel c of a segment [Bt, S, C]:
//
//   xp = [state or zeros (K-1 rows); x]          [Bt, S+K-1, C]
//   pre[t] = ((w[0] xp[t] + w[1] xp[t+1]) + ...) + b      (in x's type)
//   y[t] = silu(float(pre[t])) rounded to x's type
//   new_state = xp[S .. S+K-2]                    (the decode's next state)
//
// Each product, each running sum and the bias round to the input type in
// that order (__fmul_rn / __fadd_rn, never an FMA, then
// __float2bfloat16_rn for bf16), and SiLU is x / (1 + expf(-x)) in float32,
// as torch's eager ops compute them: the forward gives the plain version's
// bits.  One launch covers the block's three segments (xs, B, C).
//
// The backward (training: no state) recomputes pre and
//   dpre[t] = float(g[t]) * s * (1 + p (1 - s)),  p = pre[t], s = 1/(1+e^-p)
//   dx[t]   = sum_i w[i] dpre[t+K-1-i]         (dpre = 0 past the sequence)
//   dw[i]   = sum_{b,t} xp[b,t+i] dpre[b,t],   db = sum_{b,t} dpre[b,t]
// in float32; dx, dw, db round to the input type at the end.  The sums over
// batch and sequence go into one float32 slot per (sequence, tile) block,
// and conv_reduce adds the slots in a fixed order: no atomics, so two calls
// give the same bits and a graph's replay equals an eager call.
//
// What bounds it: ~4 flops a byte; each input read and each output written
// once is the bound (bytes).  Design: one thread per channel (neighbouring
// threads on neighbouring addresses) walks a tile of CONV_TILE positions
// with the K-wide window of xp in registers (K a template parameter, up to
// CONV_MAX_K); a block reads K-1 rows beyond its tile (the halo).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CONV_MAX_K 8
#define CONV_SEGS 3
#define CONV_THREADS 128
#define CONV_TILE 64
#define CONV_REDUCE_THREADS 256

struct Seg {
  const void* x;
  const void* w;
  const void* b;
  const void* state;      // [Bt, K-1, C] or null (zeros)
  const void* g;          // backward: the output's cotangent
  void* y;                // forward: the output
  void* new_state;        // forward: [Bt, K-1, C] or null
  void* dx;               // backward
  void* dw;
  void* db;
  int C;
  int c_off;              // the segment's first channel in the slots
  int first_block;        // the segment's first block along x
};

struct Segs {
  Seg s[CONV_SEGS];
  int n;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// v rounded to T and back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch's silu: x / (1 + exp(-x)) in float32
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

// pre from the window win[0..K-1] = xp[t..t+K-1], rounded as the plain ops
template <typename T, int K>
__device__ __forceinline__ float conv_pre(const float* win, const float* w,
                                          float bias) {
  float acc = rnd<T>(__fmul_rn(win[0], w[0]));
#pragma unroll
  for (int i = 1; i < K; ++i)
    acc = rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(win[i], w[i]))));
  return rnd<T>(__fadd_rn(acc, bias));
}

__device__ __forceinline__ int seg_of(const Segs& segs, int bx) {
  int si = 0;
#pragma unroll
  for (int j = 1; j < CONV_SEGS; ++j)
    if (j < segs.n && bx >= segs.s[j].first_block) si = j;
  return si;
}

template <typename T, int K>
__global__ void __launch_bounds__(CONV_THREADS)
conv_fwd(const Segs segs, int S, int n_tiles) {
  const Seg& sg = segs.s[seg_of(segs, blockIdx.x)];
  const int c = (blockIdx.x - sg.first_block) * CONV_THREADS + threadIdx.x;
  const int C = sg.C;
  if (c >= C) return;
  const int bt = blockIdx.y / n_tiles, tile = blockIdx.y % n_tiles;
  const int t0 = tile * CONV_TILE, t1 = min(S, t0 + CONV_TILE);
  const T* x = (const T*)sg.x + (size_t)bt * S * C + c;
  const T* state = sg.state ? (const T*)sg.state + (size_t)bt * (K - 1) * C + c
                            : nullptr;
  float w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = ld((const T*)sg.w + (size_t)i * C + c);
  const float bias = ld((const T*)sg.b + c);
  auto xp = [&](int m) -> float {
    if (m < K - 1) return state ? ld(state + (size_t)m * C) : 0.0f;
    return ld(x + (size_t)(m - (K - 1)) * C);
  };
  float win[K];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) win[i] = xp(t0 + i);
  T* y = (T*)sg.y + (size_t)bt * S * C + c;
  for (int t = t0; t < t1; ++t) {
    win[K - 1] = xp(t + K - 1);
    st(y + (size_t)t * C, silu(conv_pre<T, K>(win, w, bias)));
#pragma unroll
    for (int i = 0; i < K - 1; ++i) win[i] = win[i + 1];
  }
  if (sg.new_state && tile == n_tiles - 1) {
    T* ns = (T*)sg.new_state + (size_t)bt * (K - 1) * C + c;
#pragma unroll
    for (int j = 0; j < K - 1; ++j) st(ns + (size_t)j * C, xp(S + j));
  }
}

// slots: float [Bt * n_tiles][K + 1][c_total]: a block's partial dw (rows
// 0..K-1) and db (row K) of its channels
template <typename T, int K>
__global__ void __launch_bounds__(CONV_THREADS)
conv_bwd(const Segs segs, int S, int n_tiles, int c_total, float* slots) {
  const Seg& sg = segs.s[seg_of(segs, blockIdx.x)];
  const int c = (blockIdx.x - sg.first_block) * CONV_THREADS + threadIdx.x;
  const int C = sg.C;
  if (c >= C) return;
  const int bt = blockIdx.y / n_tiles, tile = blockIdx.y % n_tiles;
  const int t0 = tile * CONV_TILE, t1 = min(S, t0 + CONV_TILE);
  const T* x = (const T*)sg.x + (size_t)bt * S * C + c;
  const T* g = (const T*)sg.g + (size_t)bt * S * C + c;
  T* dx = (T*)sg.dx + (size_t)bt * S * C + c;
  float w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = ld((const T*)sg.w + (size_t)i * C + c);
  const float bias = ld((const T*)sg.b + c);
  auto xp = [&](int m) -> float {
    return m < K - 1 ? 0.0f : ld(x + (size_t)(m - (K - 1)) * C);
  };
  float win[K], dwin[K], dw[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    dw[i] = 0.0f;
    dwin[i] = 0.0f;
  }
  float db = 0.0f;
#pragma unroll
  for (int i = 0; i < K - 1; ++i) win[i] = xp(t0 + i);
  // dx[tau] needs dpre[tau .. tau+K-1]: walk K-1 positions past the tile
  for (int t = t0; t < t1 + K - 1; ++t) {
    float d = 0.0f;
    if (t < S) {
      win[K - 1] = xp(t + K - 1);
      const float p = conv_pre<T, K>(win, w, bias);
      const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-p)));
      d = __fmul_rn(__fmul_rn(ld(g + (size_t)t * C), s),
                    __fadd_rn(1.0f, __fmul_rn(p, __fsub_rn(1.0f, s))));
    }
    dwin[K - 1] = d;
    if (t < t1) {
#pragma unroll
      for (int i = 0; i < K; ++i) dw[i] = __fadd_rn(dw[i], __fmul_rn(win[i], d));
      db = __fadd_rn(db, d);
    }
    const int tau = t - (K - 1);
    if (tau >= t0 && tau < t1) {
      float acc = __fmul_rn(w[0], dwin[K - 1]);
#pragma unroll
      for (int i = 1; i < K; ++i)
        acc = __fadd_rn(acc, __fmul_rn(w[i], dwin[K - 1 - i]));
      st(dx + (size_t)tau * C, acc);
    }
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {
      win[i] = win[i + 1];
      dwin[i] = dwin[i + 1];
    }
  }
  float* slot = slots + (size_t)(bt * n_tiles + tile) * (K + 1) * c_total +
                sg.c_off + c;
#pragma unroll
  for (int i = 0; i < K; ++i) slot[(size_t)i * c_total] = dw[i];
  slot[(size_t)K * c_total] = db;
}

// dw, db of every segment: the slots of each (i, channel) added in slot
// order
template <typename T>
__global__ void __launch_bounds__(CONV_REDUCE_THREADS)
conv_reduce(const Segs segs, int K, int c_total, int n_slots,
            const float* slots) {
  const int idx = blockIdx.x * CONV_REDUCE_THREADS + threadIdx.x;
  if (idx >= (K + 1) * c_total) return;
  const int i = idx / c_total, cg = idx % c_total;
  float acc = 0.0f;
  for (int s = 0; s < n_slots; ++s)
    acc = __fadd_rn(acc, slots[((size_t)s * (K + 1) + i) * c_total + cg]);
  int si = 0;
  for (int j = 1; j < segs.n; ++j)
    if (cg >= segs.s[j].c_off) si = j;
  const Seg& sg = segs.s[si];
  const int c = cg - sg.c_off;
  if (i < K)
    st((T*)sg.dw + (size_t)i * sg.C + c, acc);
  else
    st((T*)sg.db + c, acc);
}

// ---------------------------------------------------------------------------
// launchers: dtype 0 float32, 1 bfloat16; each returns cudaGetLastError()
// ---------------------------------------------------------------------------

static int fill(Segs& segs, int n, const void* const* x, const void* const* w,
                const void* const* b, const void* const* state,
                const void* const* g, void* const* y, void* const* new_state,
                void* const* dx, void* const* dw, void* const* db,
                const int* C) {
  if (n < 1 || n > CONV_SEGS) return (int)cudaErrorInvalidValue;
  int blocks = 0, c_off = 0;
  for (int j = 0; j < CONV_SEGS; ++j) {
    Seg s = {};
    if (j < n) {
      s.x = x[j];
      s.w = w[j];
      s.b = b[j];
      s.state = state ? state[j] : nullptr;
      s.g = g ? g[j] : nullptr;
      s.y = y ? y[j] : nullptr;
      s.new_state = new_state ? new_state[j] : nullptr;
      s.dx = dx ? dx[j] : nullptr;
      s.dw = dw ? dw[j] : nullptr;
      s.db = db ? db[j] : nullptr;
      s.C = C[j];
      if (C[j] < 1) return (int)cudaErrorInvalidValue;
      s.c_off = c_off;
      s.first_block = blocks;
      c_off += C[j];
      blocks += (C[j] + CONV_THREADS - 1) / CONV_THREADS;
    }
    segs.s[j] = s;
  }
  segs.n = n;
  return 0;
}

static int total_blocks(const Segs& segs) {
  const Seg& last = segs.s[segs.n - 1];
  return last.first_block + (last.C + CONV_THREADS - 1) / CONV_THREADS;
}

static int total_channels(const Segs& segs) {
  const Seg& last = segs.s[segs.n - 1];
  return last.c_off + last.C;
}

#define CONV_K_CASES(MACRO, T) \
  switch (K) {                 \
    case 1: MACRO(T, 1); break; \
    case 2: MACRO(T, 2); break; \
    case 3: MACRO(T, 3); break; \
    case 4: MACRO(T, 4); break; \
    case 5: MACRO(T, 5); break; \
    case 6: MACRO(T, 6); break; \
    case 7: MACRO(T, 7); break; \
    case 8: MACRO(T, 8); break; \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int conv_max_k() { return CONV_MAX_K; }

// The forward over n segments; state and new_state null for training.
extern "C" int conv_fwd_launch(int dtype, int n, int Bt, int S, int K,
                               const void* const* x, const void* const* w,
                               const void* const* b,
                               const void* const* state, void* const* y,
                               void* const* new_state, const int* C,
                               void* stream) {
  Segs segs;
  int err = fill(segs, n, x, w, b, state, nullptr, y, new_state, nullptr,
                 nullptr, nullptr, C);
  if (err) return err;
  if (Bt < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (S + CONV_TILE - 1) / CONV_TILE;
  const dim3 grid(total_blocks(segs), Bt * n_tiles);
  cudaStream_t st_ = (cudaStream_t)stream;
#define FWD(T, KK) conv_fwd<T, KK><<<grid, CONV_THREADS, 0, st_>>>(segs, S, n_tiles)
  if (dtype == 1) {
    CONV_K_CASES(FWD, __nv_bfloat16)
  } else {
    CONV_K_CASES(FWD, float)
  }
#undef FWD
  return (int)cudaGetLastError();
}

// Float32 words of the backward's slots for these shapes.
extern "C" long long conv_slot_words(int Bt, int S, int K, int c_total) {
  const long long n_tiles = (S + CONV_TILE - 1) / CONV_TILE;
  return (long long)Bt * n_tiles * (K + 1) * c_total;
}

// The backward (no state): dx, dw, db of n segments from their cotangents g;
// slots: conv_slot_words(...) floats of scratch.
extern "C" int conv_bwd_launch(int dtype, int n, int Bt, int S, int K,
                               const void* const* x, const void* const* w,
                               const void* const* b, const void* const* g,
                               void* const* dx, void* const* dw,
                               void* const* db, const int* C, float* slots,
                               void* stream) {
  Segs segs;
  int err = fill(segs, n, x, w, b, nullptr, g, nullptr, nullptr, dx, dw, db,
                 C);
  if (err) return err;
  if (Bt < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (S + CONV_TILE - 1) / CONV_TILE;
  const int c_total = total_channels(segs);
  const dim3 grid(total_blocks(segs), Bt * n_tiles);
  cudaStream_t st_ = (cudaStream_t)stream;
#define BWD(T, KK) \
  conv_bwd<T, KK><<<grid, CONV_THREADS, 0, st_>>>(segs, S, n_tiles, c_total, slots)
  if (dtype == 1) {
    CONV_K_CASES(BWD, __nv_bfloat16)
  } else {
    CONV_K_CASES(BWD, float)
  }
#undef BWD
  err = (int)cudaGetLastError();
  if (err) return err;
  const int work = (K + 1) * c_total;
  const int blocks = (work + CONV_REDUCE_THREADS - 1) / CONV_REDUCE_THREADS;
  if (dtype == 1)
    conv_reduce<__nv_bfloat16><<<blocks, CONV_REDUCE_THREADS, 0, st_>>>(
        segs, K, c_total, Bt * n_tiles, slots);
  else
    conv_reduce<float><<<blocks, CONV_REDUCE_THREADS, 0, st_>>>(
        segs, K, c_total, Bt * n_tiles, slots);
  return (int)cudaGetLastError();
}
