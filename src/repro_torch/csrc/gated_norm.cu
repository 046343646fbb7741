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
// its channels in turn, then a fixed shuffle tree, the warps in order and,
// in the backward, the blocks of a cluster in rank order), which is another
// order than torch's reduction: the output is within an ulp of the plain
// version's and bitwise across calls.
//
// Modes: FUSED (the whole row in one pass); SUM (a row's sum of squares
// into ss) and FINISH (the rest from a given ss) around an all-reduce of ss
// over the ranks that share a row: FINISH fed the FUSED pass's own ss gives
// its bits.  The backward splits the same way at its row dot.
//
// The backward from dout, recomputing u, v and with the forward's rstd r:
//   a = dout * scale;  dot = sum_c a v;  dv = a r - v (dot r^3 / width)
//   du = dv * g;  dz = dv * u * s (1 + z (1 - s)),  s = 1 / (1 + e^-z)
//   dy = du,  dxs = du * T(D[h]),  dscale[c] = sum_rows dout v r,
//   dD[h] = sum_{rows, p} du xs
// in float32, dy, dxs, dz rounded to T.  The sums over rows go into one slot
// row per cluster of blocks and gn_reduce adds them in a fixed tree (no
// atomics): two calls give the same bits.
//
// What bounds it: a few flops a byte; the bytes (each input read once,
// each output written once).  Design: a thread owns fixed chunks of E
// neighbouring channels (E = 16 bytes: one vector load on the vector route,
// E loads of one element on the scalar route, for widths or views that are
// not whole vectors), keeps their values in registers from the row's sum to
// its output, and computes each element's gate once; a chunk's heads are
// found once, by one division.  Forward: a block a row.  Backward: a row
// is cut into at most GN_MAX_CLUSTER blocks of at most GN_BWD_THREADS
// threads, one chunk a thread, that form a thread block cluster and add
// the row dot's partials through distributed shared memory; the card
// holds one wave of clusters, each walks an even run of rows with the next
// GN_STAGES - 1 rows in flight (cp.async into the thread's own slots of a
// shared ring), and a thread's dscale and dD sums stay in registers until
// its cluster's slot row.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

#define GN_FWD_THREADS 256    // forward block over many rows
#define GN_MAX_THREADS 1024
#define GN_WIDE_ROWS 264      // fewer rows (the decode's): wide blocks
#define GN_BWD_THREADS 512
#define GN_MAX_CLUSTER 8
#define GN_MAX_CHUNKS 2048    // of 16 bytes a row
#define GN_STAGES 4           // rows of the backward's ring
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
  float* slot_scale;    // backward: [clusters][W]
  float* slot_D;        // backward: [clusters][W]
  int R, W, P, clusters;
  float width, eps;
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

// T(D[head]) of the chunk's E channels from c: one division, the head then
// advanced along the chunk
template <typename T>
__device__ __forceinline__ void head_d(const float* D, int c, int P, int W,
                                       float* d) {
  int h = c / P, p = c - h * P;
#pragma unroll
  for (int i = 0; i < Lanes<T>::E; ++i) {
    d[i] = c + i < W ? rnd<T>(D[h]) : 0.0f;
    if (++p == P) {
      p = 0;
      ++h;
    }
  }
}

// u, the gate g and v of one element (each op rounded as the plain
// version's), and e = exp(-z)
template <typename T>
__device__ __forceinline__ void gate(float y, float x, float d, bool skip,
                                     float zf, float& u, float& e, float& g,
                                     float& v) {
  u = skip ? rnd<T>(__fadd_rn(y, rnd<T>(__fmul_rn(x, d)))) : y;
  e = expf(-zf);
  g = rnd<T>(__fdiv_rn(zf, __fadd_rn(1.0f, e)));
  v = rnd<T>(__fmul_rn(u, g));
}

// a warp's sum of each lane's v, in a fixed tree, to lane 0
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// sh[0 .. warps-1] added in order
__device__ __forceinline__ float warps_in_order(const float* sh, int warps) {
  float t = sh[0];
  for (int i = 1; i < warps; ++i) t = __fadd_rn(t, sh[i]);
  return t;
}

// Forward: block r takes row r; thread chunks k * blockDim.x + threadIdx.x
// for k < VPT.
template <typename T, int MODE, int VPT, bool VEC>
__global__ void __launch_bounds__(GN_MAX_THREADS) gn_fwd(const GN a) {
  constexpr int E = Lanes<T>::E;
  __shared__ float sh[GN_MAX_THREADS / 32];
  const int r = blockIdx.x, W = a.W;
  const size_t off = (size_t)r * W;
  const T* y = (const T*)a.y + off;
  const T* xs = a.xs ? (const T*)a.xs + off : nullptr;
  const T* z = (const T*)a.z + off;
  uint4 qy[VPT], qx[VPT], qz[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * E;
    if (c < W) {
      qy[k] = load_chunk<T, VEC>(y, c, W);
      qz[k] = load_chunk<T, VEC>(z, c, W);
      if (xs) qx[k] = load_chunk<T, VEC>(xs, c, W);
    }
  }
  float v[VPT][E];
  float part = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * E;
    if (c < W) {
      float fy[E], fx[E], fz[E], d[E];
      unpack<T>(qy[k], fy);
      unpack<T>(qz[k], fz);
      if (xs) {
        unpack<T>(qx[k], fx);
        head_d<T>(a.D, c, a.P, W, d);
      }
#pragma unroll
      for (int i = 0; i < E; ++i) {
        float u, e, g;
        gate<T>(fy[i], xs ? fx[i] : 0.0f, xs ? d[i] : 0.0f, xs != nullptr,
                fz[i], u, e, g, v[k][i]);
        if (MODE != GN_FINISH)
          part = __fadd_rn(part, __fmul_rn(v[k][i], v[k][i]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) v[k][i] = 0.0f;
    }
  }
  float ss;
  if (MODE != GN_FINISH) {
    part = warp_sum(part);
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = part;
    __syncthreads();
    ss = warps_in_order(sh, blockDim.x >> 5);
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
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * E;
    if (c < W) {
      float sc[E], o[E];
      load_f32<T, VEC>(a.scale, c, W, sc);
#pragma unroll
      for (int i = 0; i < E; ++i) o[i] = __fmul_rn(__fmul_rn(v[k][i], rs), sc[i]);
      store_chunk<T, VEC>(out, c, W, o);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Backward: cluster q (of gridDim.x / CL blocks of CL) walks rows
// [q R / clusters, (q + 1) R / clusters); its block of rank k owns the
// row's chunks k * blockDim.x + threadIdx.x.  The vector route streams the
// rows' dout, y, xs, z chunks through a ring of GN_STAGES rows in dynamic
// shared memory, each thread copying and reading its own slots.
template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(GN_BWD_THREADS, 1) gn_bwd(const GN a) {
  constexpr int E = Lanes<T>::E;
  extern __shared__ uint4 ring[];           // [GN_STAGES][4][blockDim.x]
  __shared__ float shw[2][GN_BWD_THREADS / 32];
  __shared__ float red[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q = blockIdx.x / CL;
  const int W = a.W, nt = blockDim.x, tid = threadIdx.x;
  const int r0 = (int)((long long)q * a.R / a.clusters);
  const int r1 = (int)((long long)(q + 1) * a.R / a.clusters);
  const int c = (rank * nt + tid) * E;
  const bool on = c < W;
  const int warps = nt >> 5;
  float sc[E], dd[E], acc_s[E], acc_d[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    acc_s[i] = 0.0f;
    acc_d[i] = 0.0f;
  }
  if (on) {
    load_f32<T, VEC>(a.scale, c, W, sc);
    head_d<T>(a.D, c, a.P, W, dd);
  }
  const T* src[4] = {(const T*)a.dout, (const T*)a.y, (const T*)a.xs,
                     (const T*)a.z};
  auto issue = [&](int row, int stage) {
    if (on) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cp_async16(&ring[(stage * 4 + k) * nt + tid],
                   src[k] + (size_t)row * W + c);
    }
  };
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < GN_STAGES - 1; ++s) {
      if (r0 + s < r1) issue(r0 + s, s);
      cp_commit();
    }
  }
  for (int r = r0, i = 0; r < r1; ++r, ++i) {
    const int par = i & 1;
    uint4 qd[4];
    if constexpr (VEC) {
      if (r + GN_STAGES - 1 < r1)
        issue(r + GN_STAGES - 1, (i + GN_STAGES - 1) % GN_STAGES);
      cp_commit();
      cp_wait<GN_STAGES - 1>();
      const int stage = i % GN_STAGES;
#pragma unroll
      for (int k = 0; k < 4; ++k) qd[k] = ring[(stage * 4 + k) * nt + tid];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        qd[k] = on ? load_chunk<T, false>(src[k] + (size_t)r * W, c, W)
                   : make_uint4(0, 0, 0, 0);
    }
    const float rs = a.rstd[r];
    float u[E], g[E], v[E], s[E], t[E];
    float part = 0.0f;
    if (on) {
      float fo[E], fy[E], fx[E], fz[E];
      unpack<T>(qd[0], fo);
      unpack<T>(qd[1], fy);
      unpack<T>(qd[2], fx);
      unpack<T>(qd[3], fz);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        float e;
        gate<T>(fy[k], fx[k], dd[k], true, fz[k], u[k], e, g[k], v[k]);
        s[k] = __frcp_rn(__fadd_rn(1.0f, e));
        t[k] = __fadd_rn(1.0f, __fmul_rn(fz[k], __fsub_rn(1.0f, s[k])));
        if (MODE != GN_FINISH)
          part = __fadd_rn(part, __fmul_rn(__fmul_rn(fo[k], sc[k]), v[k]));
      }
    }
    float dot;
    if (MODE != GN_FINISH) {
      part = warp_sum(part);
      if ((tid & 31) == 0) shw[par][tid >> 5] = part;
      if (CL == 1) {
        __syncthreads();
        dot = warps_in_order(shw[par], warps);
      } else {
        __syncthreads();
        if (tid == 0) red[par] = warps_in_order(shw[par], warps);
        cluster.sync();
        dot = *cluster.map_shared_rank(&red[par], 0);
        for (int k = 1; k < CL; ++k)
          dot = __fadd_rn(dot, *cluster.map_shared_rank(&red[par], k));
      }
      if (MODE == GN_SUM) {
        if (rank == 0 && tid == 0) a.row[r] = dot;
        continue;
      }
    } else {
      dot = a.row[r];
    }
    if (!on) continue;
    const float coef = __fdiv_rn(
        __fmul_rn(__fmul_rn(__fmul_rn(dot, rs), rs), rs), a.width);
    float fo[E], fx[E], dy[E], dx[E], dz[E];
    unpack<T>(qd[0], fo);
    unpack<T>(qd[2], fx);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float dv = __fsub_rn(__fmul_rn(__fmul_rn(fo[k], sc[k]), rs),
                                 __fmul_rn(v[k], coef));
      const float du = __fmul_rn(dv, g[k]);
      dz[k] = __fmul_rn(__fmul_rn(__fmul_rn(dv, u[k]), s[k]), t[k]);
      dy[k] = du;
      dx[k] = __fmul_rn(du, dd[k]);
      acc_s[k] = __fadd_rn(acc_s[k], __fmul_rn(fo[k], __fmul_rn(v[k], rs)));
      acc_d[k] = __fadd_rn(acc_d[k], __fmul_rn(du, fx[k]));
    }
    const size_t off = (size_t)r * W;
    store_chunk<T, VEC>((T*)a.out + off, c, W, dy);
    store_chunk<T, VEC>((T*)a.dxs + off, c, W, dx);
    store_chunk<T, VEC>((T*)a.dz + off, c, W, dz);
  }
  if (MODE != GN_SUM && on) {
    store_f32<T, VEC>(a.slot_scale + (size_t)q * W, c, W, acc_s);
    store_f32<T, VEC>(a.slot_D + (size_t)q * W, c, W, acc_d);
  }
  // no block leaves while another of its cluster may read its red[]
  if (CL > 1) cluster.sync();
}

// dscale[c] and dD[h]: block h sums its P channels' slot rows, in groups
// of rows (a fixed split) whose partials are then added in group order;
// dD: each column of the block adds its channels' sums in channel order,
// then thread 0 the columns in order
__global__ void __launch_bounds__(GN_REDUCE_THREADS)
gn_reduce(const float* slot_scale, const float* slot_D, int n_slots, int W,
          int P, float* dscale, float* dD) {
  __shared__ float ps[GN_REDUCE_THREADS], pd[GN_REDUCE_THREADS];
  int cols = 32;
  while (cols < P && cols < GN_REDUCE_THREADS) cols <<= 1;
  const int groups = GN_REDUCE_THREADS / cols;
  const int col = threadIdx.x % cols, grp = threadIdx.x / cols;
  const int k0 = (int)((long long)grp * n_slots / groups);
  const int k1 = (int)((long long)(grp + 1) * n_slots / groups);
  const int h = blockIdx.x;
  float dsum = 0.0f;
  for (int base = 0; base < P; base += cols) {
    const int p = base + col;
    const size_t c = (size_t)h * P + p;
    float s = 0.0f, d = 0.0f;
    if (p < P)
      for (int k = k0; k < k1; ++k) {
        s = __fadd_rn(s, slot_scale[(size_t)k * W + c]);
        d = __fadd_rn(d, slot_D[(size_t)k * W + c]);
      }
    ps[threadIdx.x] = s;
    pd[threadIdx.x] = d;
    __syncthreads();
    if (grp == 0 && p < P) {
      for (int j = 1; j < groups; ++j) {
        s = __fadd_rn(s, ps[j * cols + col]);
        d = __fadd_rn(d, pd[j * cols + col]);
      }
      dscale[c] = s;
      dsum = __fadd_rn(dsum, d);
    }
    __syncthreads();
  }
  if (grp == 0) ps[col] = dsum;
  __syncthreads();
  if (threadIdx.x == 0) dD[h] = warps_in_order(ps, cols);
}

// ---------------------------------------------------------------------------
// launchers: dtype 0 float32, 1 bfloat16; vec 1 for the vector route (every
// row whole 16-byte vectors, every pointer 16-byte aligned), 0 for the
// scalar route; mode GN_FUSED, GN_SUM, GN_FINISH; each returns
// cudaGetLastError()
// ---------------------------------------------------------------------------

static int chunks_of(int dtype, int W) {
  const int e = dtype == 1 ? 8 : 4;
  return (W + e - 1) / e;
}

// widest row either direction takes: GN_MAX_CHUNKS chunks (a forward
// block of GN_MAX_THREADS threads of two chunks, the whole row in
// registers; a backward cluster of GN_MAX_CLUSTER / 2 blocks)
static int gn_max_width(int dtype) {
  return (dtype == 1 ? 8 : 4) * GN_MAX_CHUNKS;
}

extern "C" int gn_fwd_launch(int dtype, int vec, int mode, int R, int W,
                             int P, float width, float eps, const void* y,
                             const void* xs, const void* z, const float* D,
                             const float* scale, void* out, float* rstd,
                             float* row, void* stream) {
  if (R < 1 || W < 1 || P < 1 || W % P || W > gn_max_width(dtype))
    return (int)cudaErrorInvalidValue;
  GN a = {};
  a.y = y; a.xs = xs; a.z = z; a.D = D; a.scale = scale; a.out = out;
  a.rstd = rstd; a.row = row; a.R = R; a.W = W; a.P = P;
  a.width = width; a.eps = eps;
  // chunks a thread: one where the row fits GN_FWD_THREADS (the decode's
  // few rows: GN_MAX_THREADS) threads, else two
  const int n = chunks_of(dtype, W);
  const int vpt =
      n <= (R < GN_WIDE_ROWS ? GN_MAX_THREADS : GN_FWD_THREADS) ? 1 : 2;
  const int threads = ((n + vpt - 1) / vpt + 31) / 32 * 32;
  cudaStream_t s = (cudaStream_t)stream;
#define GN_FWD_GO(T, M, V, VE) gn_fwd<T, M, V, VE><<<R, threads, 0, s>>>(a)
#define GN_FWD_V(T, M, VE)                          \
  if (vpt == 1) GN_FWD_GO(T, M, 1, VE);             \
  else GN_FWD_GO(T, M, 2, VE);
#define GN_FWD_M(T, VE)                             \
  if (mode == GN_FUSED) { GN_FWD_V(T, GN_FUSED, VE) }        \
  else if (mode == GN_SUM) { GN_FWD_V(T, GN_SUM, VE) }       \
  else { GN_FWD_V(T, GN_FINISH, VE) }
  if (dtype == 1) {
    if (vec) { GN_FWD_M(__nv_bfloat16, true) } else { GN_FWD_M(__nv_bfloat16, false) }
  } else {
    if (vec) { GN_FWD_M(float, true) } else { GN_FWD_M(float, false) }
  }
#undef GN_FWD_M
#undef GN_FWD_V
#undef GN_FWD_GO
  return (int)cudaGetLastError();
}

// the backward's blocks: threads a block and blocks a cluster (a row)
static void bwd_shape(int dtype, int W, int* threads, int* cl) {
  const int n = chunks_of(dtype, W);
  const int t = (n + 31) / 32 * 32;
  *threads = t < GN_BWD_THREADS ? t : GN_BWD_THREADS;
  *cl = (n + *threads - 1) / *threads;
}

static size_t bwd_smem(int vec, int threads) {
  return vec ? (size_t)GN_STAGES * 4 * threads * sizeof(uint4) : 0;
}

static cudaLaunchConfig_t bwd_config(int threads, int cl, int clusters,
                                     size_t smem, cudaStream_t s,
                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cl);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Answers of the runtime about a kernel, asked once per (kernel, key,
// device): a launch inside a graph capture then calls nothing but the
// launch.  ask(dev) returns an error code and sets the answer.
template <typename F>
static int once(const void* kernel, long long key, int* out, F ask) {
  struct Entry { const void* fn; long long key; int dev, value; };
  static Entry seen[256];
  static int n_seen = 0;
  static std::mutex lock;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == kernel && seen[i].key == key && seen[i].dev == dev) {
      *out = seen[i].value;
      return 0;
    }
  err = ask(out);
  if (err) return err;
  if (n_seen < 256) seen[n_seen++] = {kernel, key, dev, *out};
  return 0;
}

// the largest ring a backward block takes, allowed once a kernel and
// device (the attribute is one value a kernel: a smaller one set for a
// narrow row would refuse a wide row's launch)
template <typename T, int MODE, bool VEC>
static int bwd_prepare() {
  int done = 0;
  return once((const void*)gn_bwd<T, MODE, VEC>, 0, &done, [&](int* out) {
    *out = 1;
    return (int)cudaFuncSetAttribute(
        gn_bwd<T, MODE, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bwd_smem(1, GN_BWD_THREADS));
  });
}

// Clusters of the backward (slot rows of its scratch: 2 * clusters * W
// floats) for R rows of W: the clusters of the FUSED kernel the card holds
// at once, at most R; every mode uses the same, so FINISH matches FUSED.
extern "C" int gn_bwd_clusters(int dtype, int vec, int R, int W) {
  if (R < 1 || W < 1 || W > gn_max_width(dtype)) return -1;
  int threads, cl;
  bwd_shape(dtype, W, &threads, &cl);
  if (cl > GN_MAX_CLUSTER) return -1;
  const size_t smem = bwd_smem(vec, threads);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = bwd_config(threads, cl, 1, smem, nullptr, attr);
  int n = 0, err;
#define GN_CLUSTERS(T, VE)                                                 \
  err = bwd_prepare<T, GN_FUSED, VE>();                                \
  if (!err)                                                                \
    err = once((const void*)gn_bwd<T, GN_FUSED, VE>,                       \
               (long long)threads * 64 + cl, &n, [&](int* out) {           \
                 return (int)cudaOccupancyMaxActiveClusters(               \
                     out, gn_bwd<T, GN_FUSED, VE>, &cfg);                  \
               });
  if (dtype == 1) {
    if (vec) { GN_CLUSTERS(__nv_bfloat16, true) } else { GN_CLUSTERS(__nv_bfloat16, false) }
  } else {
    if (vec) { GN_CLUSTERS(float, true) } else { GN_CLUSTERS(float, false) }
  }
#undef GN_CLUSTERS
  if (err) return -err;
  if (n < 1) n = 1;
  return n < R ? n : R;
}

// The backward.  mode GN_SUM writes each row's dot into row and nothing
// else; GN_FUSED and GN_FINISH write dy, dxs, dz, dscale [W], dD [W / P],
// using slots (2 * clusters * W floats of scratch, clusters as
// gn_bwd_clusters gives them).
extern "C" int gn_bwd_launch(int dtype, int vec, int mode, int R, int W,
                             int P, float width, const void* y,
                             const void* xs, const void* z, const float* D,
                             const float* scale, const void* dout,
                             const float* rstd, float* row, void* dy,
                             void* dxs, void* dz, float* slots, int clusters,
                             float* dscale, float* dD, void* stream) {
  if (R < 1 || W < 1 || P < 1 || W % P || !xs || !D || clusters < 1 ||
      clusters > R || W > gn_max_width(dtype))
    return (int)cudaErrorInvalidValue;
  int threads, cl;
  bwd_shape(dtype, W, &threads, &cl);
  if (cl > GN_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  GN a = {};
  a.y = y; a.xs = xs; a.z = z; a.D = D; a.scale = scale; a.dout = dout;
  a.out = dy; a.dxs = dxs; a.dz = dz; a.rstd = (float*)rstd; a.row = row;
  a.slot_scale = slots; a.slot_D = slots + (size_t)clusters * W;
  a.R = R; a.W = W; a.P = P; a.clusters = clusters; a.width = width;
  const size_t smem = bwd_smem(vec, threads);
  cudaStream_t s = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = bwd_config(threads, cl, clusters, smem, s, attr);
  int err;
#define GN_BWD_GO(T, M, VE)                                             \
  err = bwd_prepare<T, M, VE>();                                    \
  if (!err) err = (int)cudaLaunchKernelEx(&cfg, gn_bwd<T, M, VE>, a);
#define GN_BWD_M(T, VE)                                               \
  if (mode == GN_FUSED) { GN_BWD_GO(T, GN_FUSED, VE) }                \
  else if (mode == GN_SUM) { GN_BWD_GO(T, GN_SUM, VE) }               \
  else { GN_BWD_GO(T, GN_FINISH, VE) }
  if (dtype == 1) {
    if (vec) { GN_BWD_M(__nv_bfloat16, true) } else { GN_BWD_M(__nv_bfloat16, false) }
  } else {
    if (vec) { GN_BWD_M(float, true) } else { GN_BWD_M(float, false) }
  }
#undef GN_BWD_M
#undef GN_BWD_GO
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err || mode == GN_SUM) return err;
  gn_reduce<<<W / P, GN_REDUCE_THREADS, 0, s>>>(
      a.slot_scale, a.slot_D, clusters, W, P, dscale, dD);
  return (int)cudaGetLastError();
}
