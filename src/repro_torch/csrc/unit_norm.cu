// The unit's residual add and RMSNorm (K9) for sm_90a, forward and backward.
//
// Replaces no Pallas kernel: the JAX package's layers run the residual add
// (models/transformer.py:153, :161, :291, :296, :365, :370) and
// models/layers.py:44 rmsnorm as XLA ops, which its jitted train step
// (train/loop.py:108) and decode step (serve/engine.py:74) fuse into the
// next norm.  Per row of width W, with T the input type:
//
//   s = T(x + h)                                 (no h: s = x)
//   y = T((float(s) * rsqrt(sum(s^2) / W + eps)) * scale)
//
// every op rounded as the plain version's separate torch op (__fadd_rn,
// __fmul_rn, rsqrtf as torch's rsqrt); the row's sum of squares is taken in
// a fixed order (each thread its chunks in turn, a fixed shuffle tree, the
// warps in order), another order than torch's reduction: y is within an ulp
// of the plain version's, s bit for bit, and both are bitwise across calls.
// The forward writes each row's float32 r = rsqrt(...) for the backward.
//
// The backward from dy (the norm's cotangent) and ds (the stream's own,
// optional), the saved s and r, in float32:
//   n = s r;  a = dy * scale;  dot = sum_c a n
//   dn = r (a - n (dot / W));  d = T(ds + T(dn))     (no ds: d = T(dn))
//   dscale[c] = sum_rows dy n
// d is the gradient of both x and h (rounded as autograd adds the norm's
// branch to the stream's).  The sums over rows go into one slot row per
// block and un_reduce adds them in a fixed tree (no atomics): two calls
// give the same bits.
//
// What bounds it: a few flops a byte; the bytes (x, h read once, s, y
// written once; the backward reads dy, ds, s and writes d).  Design: a
// thread owns fixed chunks of E neighbouring channels (E = 16 bytes: one
// vector load on the vector route, E loads of one element on the scalar
// route, for widths or views that are not whole vectors) and keeps their
// values in registers from the row's sum to its output.  Forward: a block
// a row.  Backward: one wave of blocks, each walking an even run of rows
// with the next row's chunks (and r) loaded before the current row's block
// sum, its dscale sums in registers until its slot row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define UN_FWD_THREADS 256    // forward block over many rows
#define UN_MAX_THREADS 1024
#define UN_WIDE_ROWS 264      // fewer rows (the decode's): wide blocks
#define UN_MAX_CHUNKS 2048    // of 16 bytes a row
#define UN_REDUCE_COLS 32
#define UN_REDUCE_THREADS 256

struct UN {
  const void* x;
  const void* h;        // forward: null without the add
  const float* scale;   // [W]
  const void* dy;       // backward
  const void* ds;       // backward: null without the stream's cotangent
  void* s;              // forward: x + h (with h); backward: reads it
  void* y;              // forward: the norm; backward: d
  float* rstd;          // [R]: forward writes, backward reads
  float* slots;         // backward: [blocks][W]
  int R, W;
  float eps;
};

// elements of T in 16 bytes
template <typename T> struct Lanes { static constexpr int E = 16 / sizeof(T); };

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

// two floats rounded to bf16 as one pair (lo the lower address)
__device__ __forceinline__ unsigned bf2_pack(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// a 16-byte chunk's E values as floats, and back (rounded to T)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float* f) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (std::is_same<T, float>::value)
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  else
    return make_uint4(bf2_pack(f[0], f[1]), bf2_pack(f[2], f[3]),
                      bf2_pack(f[4], f[5]), bf2_pack(f[6], f[7]));
}

// the chunk of row p at channel c: one 16-byte load (VEC) or element by
// element, zeros past W
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* p, int c, int W) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p + c));
  } else {
    constexpr int E = Lanes<T>::E;
    float f[E];
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = c + i < W ? ld(p + c + i) : 0.0f;
    return pack<T>(f);
  }
}
template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* p, int c, int W,
                                            const float* f) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(p + c) = pack<T>(f);
  } else {
#pragma unroll
    for (int i = 0; i < Lanes<T>::E; ++i)
      if (c + i < W) st(p + c + i, f[i]);
  }
}
// E floats of a float32 vector [W] at c (zeros past W)
template <typename T, bool VEC>
__device__ __forceinline__ void load_f32(const float* p, int c, int W,
                                         float* f) {
  constexpr int E = Lanes<T>::E;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + c + i));
      f[i] = q.x; f[i + 1] = q.y; f[i + 2] = q.z; f[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = c + i < W ? p[c + i] : 0.0f;
  }
}
template <typename T, bool VEC>
__device__ __forceinline__ void store_f32(float* p, int c, int W,
                                          const float* f) {
  constexpr int E = Lanes<T>::E;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < E; i += 4)
      *reinterpret_cast<float4*>(p + c + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (c + i < W) p[c + i] = f[i];
  }
}

// a warp's sum of each lane's v, in a fixed tree, to lane 0
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// the block's sum of each thread's part, to every thread: a warp tree,
// then the warps in order (sh: one float a warp, not read again before the
// block's next __syncthreads)
__device__ __forceinline__ float block_sum(float part, float* sh) {
  part = warp_sum(part);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = part;
  __syncthreads();
  float t = sh[0];
  const int warps = blockDim.x >> 5;
  for (int i = 1; i < warps; ++i) t = __fadd_rn(t, sh[i]);
  return t;
}

// Forward: block r takes row r; thread chunks k * blockDim.x + threadIdx.x
// for k < VPT.
template <typename T, int VPT, bool VEC, bool ADD>
__global__ void __launch_bounds__(UN_MAX_THREADS) un_fwd(const UN a) {
  constexpr int E = Lanes<T>::E;
  __shared__ float sh[UN_MAX_THREADS / 32];
  const int r = blockIdx.x, W = a.W;
  const size_t off = (size_t)r * W;
  const T* x = (const T*)a.x + off;
  const T* h = ADD ? (const T*)a.h + off : nullptr;
  uint4 qx[VPT], qh[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * E;
    if (c < W) {
      qx[k] = load_chunk<T, VEC>(x, c, W);
      if (ADD) qh[k] = load_chunk<T, VEC>(h, c, W);
    }
  }
  float v[VPT][E];
  float part = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * E;
    if (c < W) {
      unpack<T>(qx[k], v[k]);
      if (ADD) {
        float fh[E];
        unpack<T>(qh[k], fh);
#pragma unroll
        for (int i = 0; i < E; ++i) v[k][i] = rnd<T>(__fadd_rn(v[k][i], fh[i]));
        store_chunk<T, VEC>((T*)a.s + off, c, W, v[k]);
      }
#pragma unroll
      for (int i = 0; i < E; ++i)
        part = __fadd_rn(part, __fmul_rn(v[k][i], v[k][i]));
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) v[k][i] = 0.0f;
    }
  }
  const float ss = block_sum(part, sh);
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)W), a.eps));
  if (threadIdx.x == 0) a.rstd[r] = rs;
  T* y = (T*)a.y + off;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * E;
    if (c < W) {
      float sc[E], o[E];
      load_f32<T, VEC>(a.scale, c, W, sc);
#pragma unroll
      for (int i = 0; i < E; ++i)
        o[i] = __fmul_rn(__fmul_rn(v[k][i], rs), sc[i]);
      store_chunk<T, VEC>(y, c, W, o);
    }
  }
}

// Backward: block b walks rows [b R / gridDim.x, (b + 1) R / gridDim.x);
// its thread owns chunks k * blockDim.x + threadIdx.x for k < VPT.  The
// next row's dy, s, ds chunks and r are loaded into registers before the
// current row's block sum.
template <typename T, int VPT, bool VEC, bool DS>
__global__ void __launch_bounds__(UN_MAX_THREADS) un_bwd(const UN a) {
  constexpr int E = Lanes<T>::E;
  __shared__ float sh[2][UN_MAX_THREADS / 32];
  const int W = a.W, tid = threadIdx.x, nt = blockDim.x;
  const int r0 = (int)((long long)blockIdx.x * a.R / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * a.R / gridDim.x);
  const T* dyp = (const T*)a.dy;
  const T* sp = (const T*)a.s;
  const T* dsp = (const T*)a.ds;
  float sc[VPT][E], acc[VPT][E];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * nt + tid) * E;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[k][i] = 0.0f;
    if (c < W) load_f32<T, VEC>(a.scale, c, W, sc[k]);
  }
  uint4 qdy[VPT], qs[VPT], qds[VPT];
  float rs_next = 0.0f;
  auto fetch = [&](int row) {
    const size_t off = (size_t)row * W;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = (k * nt + tid) * E;
      if (c < W) {
        qdy[k] = load_chunk<T, VEC>(dyp + off, c, W);
        qs[k] = load_chunk<T, VEC>(sp + off, c, W);
        if (DS) qds[k] = load_chunk<T, VEC>(dsp + off, c, W);
      }
    }
    rs_next = a.rstd[row];
  };
  if (r0 < r1) fetch(r0);
  for (int r = r0, i = 0; r < r1; ++r, ++i) {
    uint4 cdy[VPT], cs[VPT], cds[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      cdy[k] = qdy[k];
      cs[k] = qs[k];
      if (DS) cds[k] = qds[k];
    }
    const float rs = rs_next;
    if (r + 1 < r1) fetch(r + 1);
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = (k * nt + tid) * E;
      if (c < W) {
        float fdy[E], fs[E];
        unpack<T>(cdy[k], fdy);
        unpack<T>(cs[k], fs);
#pragma unroll
        for (int j = 0; j < E; ++j)
          part = __fadd_rn(part, __fmul_rn(__fmul_rn(fdy[j], sc[k][j]),
                                           __fmul_rn(fs[j], rs)));
      }
    }
    const float dot = block_sum(part, sh[i & 1]);
    const float coef = __fdiv_rn(dot, (float)W);
    const size_t off = (size_t)r * W;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = (k * nt + tid) * E;
      if (c < W) {
        float fdy[E], fs[E], fds[E], d[E];
        unpack<T>(cdy[k], fdy);
        unpack<T>(cs[k], fs);
        if (DS) unpack<T>(cds[k], fds);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float n = __fmul_rn(fs[j], rs);
          const float av = __fmul_rn(fdy[j], sc[k][j]);
          const float dn = rnd<T>(
              __fmul_rn(rs, __fsub_rn(av, __fmul_rn(n, coef))));
          d[j] = DS ? __fadd_rn(fds[j], dn) : dn;
          acc[k][j] = __fadd_rn(acc[k][j], __fmul_rn(fdy[j], n));
        }
        store_chunk<T, VEC>((T*)a.y + off, c, W, d);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * nt + tid) * E;
    if (c < W) store_f32<T, VEC>(a.slots + (size_t)blockIdx.x * W, c, W,
                                 acc[k]);
  }
}

// dscale[c]: the block's columns c0 .. c0 + UN_REDUCE_COLS - 1, each summed
// over the slot rows in UN_REDUCE_THREADS / UN_REDUCE_COLS groups of rows
// (a fixed split), whose partials are then added in group order
__global__ void __launch_bounds__(UN_REDUCE_THREADS)
un_reduce(const float* slots, int n_slots, int W, float* dscale) {
  __shared__ float part[UN_REDUCE_THREADS];
  constexpr int groups = UN_REDUCE_THREADS / UN_REDUCE_COLS;
  const int col = threadIdx.x % UN_REDUCE_COLS;
  const int grp = threadIdx.x / UN_REDUCE_COLS;
  const int c = blockIdx.x * UN_REDUCE_COLS + col;
  const int k0 = (int)((long long)grp * n_slots / groups);
  const int k1 = (int)((long long)(grp + 1) * n_slots / groups);
  float s = 0.0f;
  if (c < W)
    for (int k = k0; k < k1; ++k) s = __fadd_rn(s, slots[(size_t)k * W + c]);
  part[threadIdx.x] = s;
  __syncthreads();
  if (grp == 0 && c < W) {
    for (int j = 1; j < groups; ++j)
      s = __fadd_rn(s, part[j * UN_REDUCE_COLS + col]);
    dscale[c] = s;
  }
}

// ---------------------------------------------------------------------------
// launchers: dtype 0 float32, 1 bfloat16; vec 1 for the vector route (every
// row whole 16-byte vectors, every pointer 16-byte aligned), 0 for the
// scalar route; each returns cudaGetLastError() (or an error code for
// arguments the kernels do not take)
// ---------------------------------------------------------------------------

static int chunks_of(int dtype, int W) {
  const int e = dtype == 1 ? 8 : 4;
  return (W + e - 1) / e;
}

// the widest row: UN_MAX_CHUNKS chunks (UN_MAX_THREADS threads of two)
static int un_max_width(int dtype) {
  return (dtype == 1 ? 8 : 4) * UN_MAX_CHUNKS;
}

// threads of a block and chunks a thread: one chunk where the row fits
// `most` threads, else two
static void block_shape(int dtype, int W, int most, int* threads, int* vpt) {
  const int n = chunks_of(dtype, W);
  *vpt = n <= most ? 1 : 2;
  *threads = ((n + *vpt - 1) / *vpt + 31) / 32 * 32;
}

extern "C" int un_fwd_launch(int dtype, int vec, int R, int W, float eps,
                             const void* x, const void* h,
                             const float* scale, void* s, void* y,
                             float* rstd, void* stream) {
  if (R < 1 || W < 1 || W > un_max_width(dtype) || (h && !s))
    return (int)cudaErrorInvalidValue;
  UN a = {};
  a.x = x; a.h = h; a.scale = scale; a.s = s; a.y = y; a.rstd = rstd;
  a.R = R; a.W = W; a.eps = eps;
  int threads, vpt;
  block_shape(dtype, W, R < UN_WIDE_ROWS ? UN_MAX_THREADS : UN_FWD_THREADS,
              &threads, &vpt);
  cudaStream_t st = (cudaStream_t)stream;
#define UN_FWD_GO(T, V, VE, AD) un_fwd<T, V, VE, AD><<<R, threads, 0, st>>>(a)
#define UN_FWD_A(T, V, VE)                                  \
  if (h) UN_FWD_GO(T, V, VE, true);                         \
  else UN_FWD_GO(T, V, VE, false);
#define UN_FWD_V(T, VE)                                     \
  if (vpt == 1) { UN_FWD_A(T, 1, VE) } else { UN_FWD_A(T, 2, VE) }
  if (dtype == 1) {
    if (vec) { UN_FWD_V(__nv_bfloat16, true) } else { UN_FWD_V(__nv_bfloat16, false) }
  } else {
    if (vec) { UN_FWD_V(float, true) } else { UN_FWD_V(float, false) }
  }
#undef UN_FWD_V
#undef UN_FWD_A
#undef UN_FWD_GO
  return (int)cudaGetLastError();
}

// Blocks of the backward for rows of W (the slot rows of its scratch:
// blocks * W floats): the blocks the card holds at once, at most R.  A
// negative value is an error code.
extern "C" int un_bwd_blocks(int dtype, int vec, int ds, int R, int W) {
  if (R < 1 || W < 1 || W > un_max_width(dtype))
    return -(int)cudaErrorInvalidValue;
  int threads, vpt, per_sm = 0, dev = 0, sms = 0;
  block_shape(dtype, W, UN_MAX_THREADS, &threads, &vpt);
  int err;
#define UN_OCC(T, V, VE, D)                                                \
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
      &per_sm, un_bwd<T, V, VE, D>, threads, 0);
#define UN_OCC_D(T, V, VE)                                                 \
  if (ds) { UN_OCC(T, V, VE, true) } else { UN_OCC(T, V, VE, false) }
#define UN_OCC_V(T, VE)                                                    \
  if (vpt == 1) { UN_OCC_D(T, 1, VE) } else { UN_OCC_D(T, 2, VE) }
  if (dtype == 1) {
    if (vec) { UN_OCC_V(__nv_bfloat16, true) } else { UN_OCC_V(__nv_bfloat16, false) }
  } else {
    if (vec) { UN_OCC_V(float, true) } else { UN_OCC_V(float, false) }
  }
#undef UN_OCC_V
#undef UN_OCC_D
#undef UN_OCC
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return -err;
  const int n = (per_sm < 1 ? 1 : per_sm) * sms;
  return n < R ? n : R;
}

// The backward: d [R, W] (into y) and dscale [W] from dy, ds (or null), s
// and rstd, with slots (blocks * W floats of scratch, blocks as
// un_bwd_blocks gives them).
extern "C" int un_bwd_launch(int dtype, int vec, int R, int W,
                             const void* dy, const void* ds, const void* s,
                             const float* scale, const float* rstd, void* d,
                             float* slots, int blocks, float* dscale,
                             void* stream) {
  if (R < 1 || W < 1 || W > un_max_width(dtype) || blocks < 1 ||
      blocks > R)
    return (int)cudaErrorInvalidValue;
  UN a = {};
  a.dy = dy; a.ds = ds; a.s = (void*)s; a.scale = scale; a.y = d;
  a.rstd = (float*)rstd; a.slots = slots; a.R = R; a.W = W;
  int threads, vpt;
  block_shape(dtype, W, UN_MAX_THREADS, &threads, &vpt);
  cudaStream_t st = (cudaStream_t)stream;
#define UN_BWD_GO(T, V, VE, D) un_bwd<T, V, VE, D><<<blocks, threads, 0, st>>>(a)
#define UN_BWD_D(T, V, VE)                                   \
  if (ds) UN_BWD_GO(T, V, VE, true);                         \
  else UN_BWD_GO(T, V, VE, false);
#define UN_BWD_V(T, VE)                                      \
  if (vpt == 1) { UN_BWD_D(T, 1, VE) } else { UN_BWD_D(T, 2, VE) }
  if (dtype == 1) {
    if (vec) { UN_BWD_V(__nv_bfloat16, true) } else { UN_BWD_V(__nv_bfloat16, false) }
  } else {
    if (vec) { UN_BWD_V(float, true) } else { UN_BWD_V(float, false) }
  }
#undef UN_BWD_V
#undef UN_BWD_D
#undef UN_BWD_GO
  int err = (int)cudaGetLastError();
  if (err) return err;
  un_reduce<<<(W + UN_REDUCE_COLS - 1) / UN_REDUCE_COLS, UN_REDUCE_THREADS, 0,
              st>>>(slots, blocks, W, dscale);
  return (int)cudaGetLastError();
}
