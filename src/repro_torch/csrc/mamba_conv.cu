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
// that order, never fused into an FMA, and SiLU is x / (1 + expf(-x)) in
// float32, as torch's eager ops compute them: the forward gives the plain
// version's bits.  In bf16 the products and sums run on bf16 pairs
// (mul.rn.bf16x2, add.rn.bf16x2): a product of two bf16 values is exact in
// float32 and a sum of two is either exact or off by less than a quarter of
// a bf16 ulp, so one rounding to bf16 gives what float32 then bf16 gives.
// One launch covers the block's three segments (xs, B, C), laid side by
// side as one space of channels.
//
// The backward (training: no state) recomputes pre and
//   dpre[t] = float(g[t]) * s * (1 + p (1 - s)),  p = pre[t], s = 1/(1+e^-p)
//   dx[t]   = sum_i w[i] dpre[t+K-1-i]         (dpre = 0 past the sequence)
//   dw[i]   = sum_{b,t} xp[b,t+i] dpre[b,t],   db = sum_{b,t} dpre[b,t]
// in float32; dx, dw, db round to the input type at the end.  The sums over
// batch and sequence go into one float32 slot row per block, and
// conv_reduce adds the rows in a fixed order: no atomics, so two calls
// give the same bits and a graph's replay equals an eager call.
//
// What bounds it: the bytes (each input read and each output written once)
// and, close behind, the instructions of the exact rounding and the IEEE
// SiLU and its derivative (~25 an element forward, ~50 backward).  Design: a
// thread owns a chunk of E neighbouring channels (the vector route: 16 bytes
// forward; 8 bytes of bf16 backward, whose window, weights and sums then fit
// two blocks an SM, where 16-byte chunks would hold twice the registers and
// leave one; the scalar route, for widths or views that are not whole
// vectors: one channel) and walks an even share of the batch's positions
// with its K-wide window of inputs in registers: each input element is read
// once, plus K-1 rows at the ends of a share.  A chunk is read by its own
// thread only, so loads go straight to registers (staging them in shared
// memory would add a copy and save no read): the forward loads
// CONV_FWD_AHEAD positions ahead; the backward walks K positions a step,
// loading them together, each position's window and dpre slots fixed at
// compile time (slot = position mod K), so no register moves.  A block is 32
// chunks by up to 8 warps, and the grid is sized to the blocks the card
// holds at once (one wave, no tail).  The backward's warps add their dw/db
// in order into the block's one slot row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#define CONV_MAX_K 8
#define CONV_SEGS 3
#define CONV_LANES 32        // chunks across a block (blockDim.x)
#define CONV_WARPS 8         // warps down a block (blockDim.y) at most
#define CONV_FWD_AHEAD 2     // positions the forward loads ahead
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
  int c_off;              // the segment's first channel in the joint space
};

struct Segs {
  Seg s[CONV_SEGS];
  int n;
  int c_total;
};

// ---------------------------------------------------------------------------
// chunks of E values of T in registers: bf16 pairs (words) where E is even,
// else floats
// ---------------------------------------------------------------------------

template <typename T, int E>
struct Chunk {
  static_assert(E == 1 || (int)sizeof(T) * E == 8 || (int)sizeof(T) * E == 16,
                "a chunk is one value or an 8- or 16-byte vector");
  static constexpr bool PAIRS = std::is_same<T, __nv_bfloat16>::value &&
                                E % 2 == 0;
  static constexpr int N = PAIRS ? E / 2 : E;
  typename std::conditional<PAIRS, unsigned, float>::type r[N];

  __device__ __forceinline__ float at(int i) const {
    if constexpr (PAIRS)
      return __uint_as_float(i % 2 ? r[i / 2] & 0xffff0000u : r[i / 2] << 16);
    else
      return r[i];
  }
};

__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// two floats rounded to bf16 as one pair (lo the lower address)
__device__ __forceinline__ unsigned bf2_pack(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

template <typename T, int E>
__device__ __forceinline__ Chunk<T, E> load(const T* p) {
  Chunk<T, E> c;
  constexpr int BYTES = (int)sizeof(T) * E;
  if constexpr (BYTES == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < Chunk<T, E>::N; ++i)
      if constexpr (Chunk<T, E>::PAIRS) c.r[i] = w[i];
      else c.r[i] = __uint_as_float(w[i]);
  } else if constexpr (BYTES == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const unsigned w[2] = {q.x, q.y};
#pragma unroll
    for (int i = 0; i < Chunk<T, E>::N; ++i)
      if constexpr (Chunk<T, E>::PAIRS) c.r[i] = w[i];
      else c.r[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<T, float>::value) {
    c.r[0] = __ldg(p);
  } else {
    c.r[0] = __bfloat162float(*p);
  }
  return c;
}

template <typename T, int E>
__device__ __forceinline__ Chunk<T, E> zeros() {
  Chunk<T, E> c;
#pragma unroll
  for (int i = 0; i < Chunk<T, E>::N; ++i) c.r[i] = 0;
  return c;
}

// E floats rounded to T and stored at p
template <typename T, int E>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (E == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) p[i] = f[i];
    }
  } else if constexpr (E == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf2_pack(f[0], f[1]), bf2_pack(f[2], f[3]),
                   bf2_pack(f[4], f[5]), bf2_pack(f[6], f[7]));
  } else if constexpr (E == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf2_pack(f[0], f[1]), bf2_pack(f[2], f[3]));
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) p[i] = __float2bfloat16_rn(f[i]);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store(T* p, const Chunk<T, E>& c) {
  float f[E];
#pragma unroll
  for (int i = 0; i < E; ++i) f[i] = c.at(i);
  store<T, E>(p, f);
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

// pre of a chunk from the window win[0..K-1] = xp[t..t+K-1], rounded as the
// plain ops
template <typename T, int K, int E>
__device__ __forceinline__ void conv_pre(const Chunk<T, E>* win,
                                         const Chunk<T, E>* w,
                                         const Chunk<T, E>& bias,
                                         float* pre) {
  using C = Chunk<T, E>;
  if constexpr (C::PAIRS) {
#pragma unroll
    for (int q = 0; q < C::N; ++q) {
      unsigned acc = bf2_mul(win[0].r[q], w[0].r[q]);
#pragma unroll
      for (int i = 1; i < K; ++i)
        acc = bf2_add(acc, bf2_mul(win[i].r[q], w[i].r[q]));
      acc = bf2_add(acc, bias.r[q]);
      pre[2 * q] = __uint_as_float(acc << 16);
      pre[2 * q + 1] = __uint_as_float(acc & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float acc = rnd<T>(__fmul_rn(win[0].at(e), w[0].at(e)));
#pragma unroll
      for (int i = 1; i < K; ++i)
        acc = rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(win[i].at(e),
                                                     w[i].at(e)))));
      pre[e] = rnd<T>(__fadd_rn(acc, bias.at(e)));
    }
  }
}

// the segment and its channel of joint channel gc (chunks never straddle
// segments: on the vector route every C is a multiple of E)
__device__ __forceinline__ const Seg& seg_of(const Segs& segs, int gc) {
  int si = 0;
#pragma unroll
  for (int j = 1; j < CONV_SEGS; ++j)
    if (j < segs.n && gc >= segs.s[j].c_off) si = j;
  return segs.s[si];
}

// a warp's even share [p0, p1) of the Bt * S positions, by its index gw
// among nw warps of a column of blocks
__device__ __forceinline__ void share(int Bt, int S, long long* p0,
                                      long long* p1) {
  const long long total = (long long)Bt * S;
  const long long nw = (long long)gridDim.y * blockDim.y;
  const long long gw = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  *p0 = total * gw / nw;
  *p1 = total * (gw + 1) / nw;
}

template <typename T, int K, int E>
__global__ void __launch_bounds__(CONV_LANES * CONV_WARPS)
conv_fwd(const __grid_constant__ Segs segs, int Bt, int S) {
  using C = Chunk<T, E>;
  const int gc = (blockIdx.x * CONV_LANES + threadIdx.x) * E;
  if (gc >= segs.c_total) return;
  const Seg& sg = seg_of(segs, gc);
  const int c = gc - sg.c_off, Cn = sg.C;
  C w[K], win[K];
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = load<T, E>((const T*)sg.w + (size_t)i * Cn + c);
  const C bias = load<T, E>((const T*)sg.b + c);
  long long p, p1;
  share(Bt, S, &p, &p1);
  while (p < p1) {
    const int bt = (int)(p / S), t0 = (int)(p - (long long)bt * S);
    const int t1 = (int)min((long long)S, t0 + (p1 - p));
    const T* x = (const T*)sg.x + (size_t)bt * S * Cn + c;
    const T* state = sg.state ? (const T*)sg.state + (size_t)bt * (K - 1) * Cn + c
                              : nullptr;
    T* y = (T*)sg.y + (size_t)bt * S * Cn + c;
    // xp[t0 .. t0+K-2]
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {
      const int m = t0 + i;
      win[i] = m >= K - 1 ? load<T, E>(x + (size_t)(m - (K - 1)) * Cn)
               : state ? load<T, E>(state + (size_t)m * Cn) : zeros<T, E>();
    }
    for (int t = t0; t < t1; t += CONV_FWD_AHEAD) {
      C ahead[CONV_FWD_AHEAD];
#pragma unroll
      for (int u = 0; u < CONV_FWD_AHEAD; ++u)
        if (t + u < t1) ahead[u] = load<T, E>(x + (size_t)(t + u) * Cn);
#pragma unroll
      for (int u = 0; u < CONV_FWD_AHEAD; ++u) {
        if (t + u < t1) {
          win[K - 1] = ahead[u];
          float out[E];
          conv_pre<T, K, E>(win, w, bias, out);
#pragma unroll
          for (int e = 0; e < E; ++e) out[e] = silu(out[e]);
          store<T, E>(y + (size_t)(t + u) * Cn, out);
#pragma unroll
          for (int i = 0; i < K - 1; ++i) win[i] = win[i + 1];
        }
      }
    }
    // the window now holds xp[S .. S+K-2]: the sequence's next state
    if (sg.new_state && t1 == S) {
      T* ns = (T*)sg.new_state + (size_t)bt * (K - 1) * Cn + c;
#pragma unroll
      for (int j = 0; j < K - 1; ++j) store<T, E>(ns + (size_t)j * Cn, win[j]);
    }
    p += t1 - t0;
  }
}

// slots: float [gridDim.y][K + 1][c_total]: a block's dw (rows 0..K-1) and
// db (row K) of its channels, its warps added in order
template <typename T, int K, int E>
__global__ void __launch_bounds__(CONV_LANES * CONV_WARPS)
conv_bwd(const __grid_constant__ Segs segs, int Bt, int S, float* slots) {
  using C = Chunk<T, E>;
  __shared__ float red[CONV_LANES][(CONV_MAX_K + 1) * E];
  const int gc = (blockIdx.x * CONV_LANES + threadIdx.x) * E;
  const bool on = gc < segs.c_total;
  float dw[K][E], db[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    db[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) dw[i][e] = 0.0f;
  }
  if (on) {
    const Seg& sg = seg_of(segs, gc);
    const int c = gc - sg.c_off, Cn = sg.C;
    C w[K], win[K];
    float wf[K][E], dwin[K][E];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      w[i] = load<T, E>((const T*)sg.w + (size_t)i * Cn + c);
#pragma unroll
      for (int e = 0; e < E; ++e) wf[i][e] = w[i].at(e);
    }
    const C bias = load<T, E>((const T*)sg.b + c);
    long long p, p1;
    share(Bt, S, &p, &p1);
    while (p < p1) {
      const int bt = (int)(p / S), t0 = (int)(p - (long long)bt * S);
      const int t1 = (int)min((long long)S, t0 + (p1 - p));
      const size_t off = (size_t)bt * S * Cn + c;
      const T* x = (const T*)sg.x + off;
      const T* g = (const T*)sg.g + off;
      T* dx = (T*)sg.dx + off;
      // xp[t0 + j] and dpre[t0 + j] live in slot j % K of win and dwin:
      // the walk goes K positions a step, so each position's slots are
      // known at compile time and nothing moves between registers
#pragma unroll
      for (int i = 0; i < K - 1; ++i) {
        const int m = t0 + i;
        win[i] = m >= K - 1 ? load<T, E>(x + (size_t)(m - (K - 1)) * Cn)
                            : zeros<T, E>();
      }
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) dwin[i][e] = 0.0f;
      // dx[tau] needs dpre[tau .. tau+K-1]: walk K-1 positions past t1
      const int t_end = t1 + K - 1;
      for (int t = t0; t < t_end; t += K) {
        C ax[K], ag[K];
#pragma unroll
        for (int u = 0; u < K; ++u)
          if (t + u < S && t + u < t_end) {
            ax[u] = load<T, E>(x + (size_t)(t + u) * Cn);
            ag[u] = load<T, E>(g + (size_t)(t + u) * Cn);
          }
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int tt = t + u;
          if (tt >= t_end) break;
          // position tt: xp[tt + i] in slot (u + i) % K, dpre[tt - i] in
          // slot (u - i) mod K
          C wv[K];
#pragma unroll
          for (int i = 0; i < K; ++i) wv[i] = win[(u + i) % K];
          float d[E];
          if (tt < S) {
            wv[K - 1] = win[(u + K - 1) % K] = ax[u];
            float pre[E];
            conv_pre<T, K, E>(wv, w, bias, pre);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float pe = pre[e];
              const float s = __frcp_rn(__fadd_rn(1.0f, expf(-pe)));
              d[e] = __fmul_rn(__fmul_rn(ag[u].at(e), s),
                               __fadd_rn(1.0f, __fmul_rn(pe, __fsub_rn(1.0f, s))));
            }
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) d[e] = 0.0f;
          }
#pragma unroll
          for (int e = 0; e < E; ++e) dwin[u][e] = d[e];
          if (tt < t1) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
#pragma unroll
              for (int i = 0; i < K; ++i)
                dw[i][e] = __fadd_rn(dw[i][e], __fmul_rn(wv[i].at(e), d[e]));
              db[e] = __fadd_rn(db[e], d[e]);
            }
          }
          const int tau = tt - (K - 1);
          if (tau >= t0) {
            float o[E];
#pragma unroll
            for (int e = 0; e < E; ++e) {
              float acc = __fmul_rn(wf[0][e], dwin[u][e]);
#pragma unroll
              for (int i = 1; i < K; ++i)
                acc = __fadd_rn(acc,
                                __fmul_rn(wf[i][e], dwin[(u + K - i) % K][e]));
              o[e] = acc;
            }
            store<T, E>(dx + (size_t)tau * Cn, o);
          }
        }
      }
      p += t1 - t0;
    }
  }
  // the warps' sums added in warp order into warp 0's
  for (int wy = 1; wy < (int)blockDim.y; ++wy) {
    if (threadIdx.y == wy) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
#pragma unroll
        for (int i = 0; i < K; ++i) red[threadIdx.x][i * E + e] = dw[i][e];
        red[threadIdx.x][K * E + e] = db[e];
      }
    }
    __syncthreads();
    if (threadIdx.y == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
#pragma unroll
        for (int i = 0; i < K; ++i)
          dw[i][e] = __fadd_rn(dw[i][e], red[threadIdx.x][i * E + e]);
        db[e] = __fadd_rn(db[e], red[threadIdx.x][K * E + e]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.y != 0 || !on) return;
  const int ct = segs.c_total;
  float* slot = slots + (size_t)blockIdx.y * (K + 1) * ct + gc;
#pragma unroll
  for (int e = 0; e < E; ++e) {
#pragma unroll
    for (int i = 0; i < K; ++i) slot[(size_t)i * ct + e] = dw[i][e];
    slot[(size_t)K * ct + e] = db[e];
  }
}

// dw, db of every segment: the slot rows of each (i, channel) added in row
// order
template <typename T>
__global__ void __launch_bounds__(CONV_REDUCE_THREADS)
conv_reduce(const __grid_constant__ Segs segs, int K, int n_slots,
            const float* slots) {
  const int c_total = segs.c_total;
  const int idx = blockIdx.x * CONV_REDUCE_THREADS + threadIdx.x;
  if (idx >= (K + 1) * c_total) return;
  const int i = idx / c_total, cg = idx % c_total;
  float acc = 0.0f;
  for (int s = 0; s < n_slots; ++s)
    acc = __fadd_rn(acc, slots[((size_t)s * (K + 1) + i) * c_total + cg]);
  const Seg& sg = seg_of(segs, cg);
  const int c = cg - sg.c_off;
  T* out = i < K ? (T*)sg.dw + (size_t)i * sg.C + c : (T*)sg.db + c;
  if constexpr (std::is_same<T, float>::value) *out = acc;
  else *out = __float2bfloat16_rn(acc);
}

// ---------------------------------------------------------------------------
// launchers: kind = dtype (0 float32, 1 bfloat16) + 2 for the vector route
// (chunks of 16 bytes forward, of CONV_BWD_BF16_BYTES (bf16) or 16 bytes
// (float32) backward; the scalar route: one channel a thread); each
// returns cudaGetLastError()
// ---------------------------------------------------------------------------

#define CONV_BWD_BF16_BYTES 8

static int fill(Segs& segs, int n, int E, const void* const* x,
                const void* const* w, const void* const* b,
                const void* const* state, const void* const* g,
                void* const* y, void* const* new_state, void* const* dx,
                void* const* dw, void* const* db, const int* C) {
  if (n < 1 || n > CONV_SEGS) return (int)cudaErrorInvalidValue;
  int c_off = 0;
  for (int j = 0; j < CONV_SEGS; ++j) {
    Seg s = {};
    if (j < n) {
      if (C[j] < 1 || C[j] % E) return (int)cudaErrorInvalidValue;
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
      s.c_off = c_off;
      c_off += C[j];
    }
    segs.s[j] = s;
  }
  segs.n = n;
  segs.c_total = c_off;
  return 0;
}

// Blocks of `kernel` at `threads` the device holds at once, asked of the
// runtime once per (kernel, threads, device): a launch inside a graph
// capture then calls nothing but the launch.
static int resident_blocks(const void* kernel, int threads, int* out) {
  struct Entry { const void* fn; int threads, dev, blocks; };
  static Entry seen[256];
  static int n_seen = 0;
  static std::mutex lock;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == kernel && seen[i].threads == threads &&
        seen[i].dev == dev) {
      *out = seen[i].blocks;
      return 0;
    }
  int sms = 0, per_sm = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                             threads, 0);
  if (err) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (n_seen < 256) seen[n_seen++] = {kernel, threads, dev, *out};
  return 0;
}

// the grid: a column of blocks a slab of CONV_LANES chunks, warps a block
// min(CONV_WARPS, positions), and as many blocks a column as fill the
// blocks the card holds at once (never more than the positions need)
static int conv_grid(const void* kernel, int c_total, int E, long long pos,
                     dim3* grid, dim3* block) {
  const int wy = (int)(pos < CONV_WARPS ? pos : CONV_WARPS);
  const int slabs = (c_total / E + CONV_LANES - 1) / CONV_LANES;
  int resident = 0;
  const int err = resident_blocks(kernel, CONV_LANES * wy, &resident);
  if (err) return err;
  long long rows = (long long)resident / slabs;
  const long long need = (pos + wy - 1) / wy;
  if (rows > need) rows = need;
  if (rows < 1) rows = 1;
  *grid = dim3(slabs, (unsigned)rows);
  *block = dim3(CONV_LANES, wy);
  return 0;
}

#define CONV_K_CASES(MACRO, T, E) \
  switch (K) {                    \
    case 1: MACRO(T, 1, E); break; \
    case 2: MACRO(T, 2, E); break; \
    case 3: MACRO(T, 3, E); break; \
    case 4: MACRO(T, 4, E); break; \
    case 5: MACRO(T, 5, E); break; \
    case 6: MACRO(T, 6, E); break; \
    case 7: MACRO(T, 7, E); break; \
    case 8: MACRO(T, 8, E); break; \
    default: return (int)cudaErrorInvalidValue; \
  }

// the routes by kind: (T, E), the bf16 vector route's E by direction
#define CONV_ROUTES(MACRO, BF16_E)                                          \
  switch (kind) {                                                           \
    case 0: CONV_K_CASES(MACRO, float, 1) break;                            \
    case 1: CONV_K_CASES(MACRO, __nv_bfloat16, 1) break;                    \
    case 2: CONV_K_CASES(MACRO, float, 4) break;                            \
    case 3: CONV_K_CASES(MACRO, __nv_bfloat16, BF16_E) break;               \
    default: return (int)cudaErrorInvalidValue;                             \
  }
#define CONV_BWD_BF16_E (CONV_BWD_BF16_BYTES / 2)

// channels of a thread's chunk for kind (backward or not)
static int chunk_of(int kind, bool backward) {
  if (!(kind & 2)) return 1;
  if (kind & 1) return backward ? CONV_BWD_BF16_E : 8;
  return 4;
}

extern "C" int conv_max_k() { return CONV_MAX_K; }

// The forward over n segments; state and new_state null for training.
extern "C" int conv_fwd_launch(int kind, int n, int Bt, int S, int K,
                               const void* const* x, const void* const* w,
                               const void* const* b,
                               const void* const* state, void* const* y,
                               void* const* new_state, const int* C,
                               void* stream) {
  Segs segs;
  int err = fill(segs, n, chunk_of(kind, false), x, w, b, state, nullptr, y,
                 new_state, nullptr, nullptr, nullptr, C);
  if (err) return err;
  if (Bt < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = (cudaStream_t)stream;
  const long long pos = (long long)Bt * S;
  dim3 grid, block;
#define FWD(T, KK, EE)                                                   \
  {                                                                      \
    err = conv_grid((const void*)conv_fwd<T, KK, EE>, segs.c_total, EE,  \
                    pos, &grid, &block);                                 \
    if (err) return err;                                                 \
    conv_fwd<T, KK, EE><<<grid, block, 0, st_>>>(segs, Bt, S);           \
  }
  CONV_ROUTES(FWD, 8)
#undef FWD
  return (int)cudaGetLastError();
}

// the backward's grid for these shapes
static int bwd_grid(int kind, int K, int Bt, int S, int c_total, dim3* grid,
                    dim3* block) {
  int err = 0;
#define BGRID(T, KK, EE)                                                   \
  err = conv_grid((const void*)conv_bwd<T, KK, EE>, c_total, EE,           \
                  (long long)Bt * S, grid, block);
  CONV_ROUTES(BGRID, CONV_BWD_BF16_E)
#undef BGRID
  return err;
}

// Slot rows of the backward (its grid's columns) for these shapes: the
// scratch is slot_rows * (K + 1) * c_total floats; a negative error code
// where the shapes are refused.
extern "C" int conv_bwd_slot_rows(int kind, int Bt, int S, int K,
                                  int c_total) {
  if (Bt < 1 || S < 1 || c_total < 1 || c_total % chunk_of(kind, true))
    return -(int)cudaErrorInvalidValue;
  dim3 grid, block;
  const int err = bwd_grid(kind, K, Bt, S, c_total, &grid, &block);
  return err ? -err : (int)grid.y;
}

// The backward (no state): dx, dw, db of n segments from their cotangents g;
// slots: slot_rows * (K + 1) * c_total floats of scratch.
extern "C" int conv_bwd_launch(int kind, int n, int Bt, int S, int K,
                               const void* const* x, const void* const* w,
                               const void* const* b, const void* const* g,
                               void* const* dx, void* const* dw,
                               void* const* db, const int* C, float* slots,
                               int slot_rows, void* stream) {
  Segs segs;
  int err = fill(segs, n, chunk_of(kind, true), x, w, b, nullptr, g, nullptr,
                 nullptr, dx, dw, db, C);
  if (err) return err;
  if (Bt < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = (cudaStream_t)stream;
  dim3 grid, block;
  err = bwd_grid(kind, K, Bt, S, segs.c_total, &grid, &block);
  if (err) return err;
  if ((int)grid.y != slot_rows) return (int)cudaErrorInvalidValue;
#define BWD(T, KK, EE)                                                   \
  conv_bwd<T, KK, EE><<<grid, block, 0, st_>>>(segs, Bt, S, slots)
  CONV_ROUTES(BWD, CONV_BWD_BF16_E)
#undef BWD
  err = (int)cudaGetLastError();
  if (err) return err;
  const int work = (K + 1) * segs.c_total;
  const int blocks = (work + CONV_REDUCE_THREADS - 1) / CONV_REDUCE_THREADS;
  if (kind & 1)
    conv_reduce<__nv_bfloat16><<<blocks, CONV_REDUCE_THREADS, 0, st_>>>(
        segs, K, slot_rows, slots);
  else
    conv_reduce<float><<<blocks, CONV_REDUCE_THREADS, 0, st_>>>(
        segs, K, slot_rows, slots);
  return (int)cudaGetLastError();
}
