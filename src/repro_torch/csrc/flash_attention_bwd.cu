// K2's backward: the gradient of causal GQA attention for sm_90a.
//
// Replaces what the JAX package's train step (src/repro/train/loop.py,
// jax.jit of the step) differentiates: gqa_forward's attention_any
// (src/repro/models/attention.py, dense_attention at S <= 2048), whose
// gradient XLA builds from the [B, Hkv, G, S, S] float32 logits.  The
// Pallas kernel K2 replaces (kernels/flash_attention.py::_flash_kernel) has
// no backward of its own.  For q [B, S, Hq, D], k/v [B, S, Hkv, D],
// Hq = G * Hkv, the forward's output O, its per-row log-sum-exp L (float32
// [B, Hq, S], natural units, written by csrc/flash_attention.cu) and the
// output's cotangent dO, over the live pairs only (k_pos <= q_pos and
// q_pos - k_pos < window):
//   P  = exp(scale * q . k^T - L)
//   dV = P^T . dO,            dP = dO . V^T
//   D_ = rowsum(dO o O)       (float32, one value a row)
//   dS = P o (dP - D_)
//   dQ = scale * dS . K,      dK = scale * dS^T . Q
// with dK and dV summed over the G query heads of each kv head.  Rows are
// folded as in the forward: folded row R = pos * G + g of kv head h is
// q[b, pos, h * G + g, :], so a kv head's G query heads are rows of one
// walk and the group's sum happens inside one block.
//
// Three kernels a call and no floating-point atomics: every sum is taken
// in one fixed order, so two calls (and two replays of a captured call)
// give the same bits.
//   flash_bwd_delta    D_, one warp a row (the only scratch: B * Hq * S
//                      float32, from the wrapper's torch.empty).
//   flash_bwd_dkdv_*   one block per (kv head, batch, tile of keys): K and
//                      V stay in shared memory; the block walks the folded
//                      q rows from the tile's diagonal (R = k0 * G) to the
//                      window's far edge (or the end) in tiles of 64 rows,
//                      recomputing P and dP; dK and dV accumulate in
//                      float32 registers and are written once.
//   flash_bwd_dq_*     one block per (kv head, batch, tile of folded rows):
//                      Q, dO, L and D_ stay; it walks the key tiles the rows
//                      reach in order, recomputing P and dP; dQ accumulates
//                      in registers and is written once.
// No [S, S] tensor is formed anywhere.
//
// Three routes; kernels/flash_attention.py::backward_route names one from
// (D, type) and the launcher takes exactly that one:
//
// wgmma (bfloat16 at the head dims the build's FLASH_BWD_WGMMA_D32_MASK
// lists: the wrapper's BWD_WGMMA_HEAD_DIMS, D = 64 and 128).  Blocks of two
// warpgroups; warpgroup w owns 64 keys (dK/dV walk) or 64 folded rows (dQ
// walk) of the block's 128.  Every product is wgmma m64n64k16 with float32
// accumulation on 128-byte-swizzled tiles of 64-column panels:
//   dK/dV, a step of 64 rows:  S^T = K . Q^T;  P^T = exp(scale S^T - L),
//       rounded to bf16, packed straight from the accumulator into the A
//       fragments of dV += P^T . dO (dO read MN-major), issued with dP^T =
//       V . dO^T;  dS^T = P^T o (dP^T - D_) from the rounded P^T, packed
//       the same way into dK += dS^T . Q (Q read MN-major).
//   dQ, a step of 64 keys:  S = Q . K^T and dP = dO . V^T, the exp of S
//       while dP runs;  dS = P o (dP - D_), packed into dQ += dS . K (K
//       read MN-major).
// P^T and dS^T (P and dS) never leave registers: the S^T accumulator's
// layout is that of the next product's A operand.
//
// The streamed tiles run through a ring of four stages with a `full` and
// an `empty` mbarrier each; at step it the copies of step it + 2 are
// issued while step it's first product runs.  K and V (dQ walk) and, where the
// group G divides 64, Q and dO (dK/dV walk: a tile is then 64 / G whole
// positions, one TMA box a panel) come by TMA, one tensor from the first
// thread of each warpgroup.  Q and dO of a group that does not divide 64
// (arctic-480b's 7), whose tiles start mid-group, and L and D_ come by
// cp.async from the block's threads, whose landing the copy unit reports
// to the same barrier.  No block-wide barrier inside a walk: a warpgroup
// waits only for its stage's data and for every warp to have read the
// stage it refills, so one's exp can overlap the other's products.  Steps
// whose pairs are all dead for a warpgroup (the second's first G steps,
// the first's last ones under a window) skip their products; only steps
// that cross the diagonal, the window's far edge or the end of S mask.
// The block is the two warpgroups alone, every thread a loader: 256
// threads may hold 255 registers each, and the dK/dV walk at D = 128 keeps
// dK and dV (128 float32) beside S^T or dP^T (32 each) without a spill
// (chip_smoke.py's phase 7 checks it; a producer warpgroup that gives its
// registers away by setmaxnreg left ptxas spilling this walk).  D = 160
// and 256 stay on mma: at 64 columns a product their dK and dV alone are
// 192 and 256 float32 a thread, and ptxas, given the wgmma dK/dV walk at
// D = 256, takes 255 registers and spills 1,672 bytes (its dQ walk 254,
// no spill; scripts/k2_bwd_wide_ptxas.py; the route's D = 64 and 128 walks
// take 206 / 162 and 249 / 194).
//
// mma (bfloat16 at the head dims the build's FLASH_BWD_MMA_D32_MASK lists:
// the wrapper's BWD_MMA_HEAD_DIMS, D = 160 and 256): the five products on
// the tensor cores, mma.sync m16n8k16 with bf16 operands and float32
// accumulation, fed by ldmatrix from padded shared tiles (row pitch D + 8
// elements, so the 8 rows of one ldmatrix fall on 8 distinct bank groups).
// P and dS are rounded to bf16 for the products that take them, where the
// forward rounds p; P's exponent and dS are float32.  The streamed operand
// (Q and dO in the dK/dV walk, K and V in the dQ walk) is double-buffered
// with cp.async, so the next tile's loads fly while this tile's products
// run.  Eight warps, tiles of 64 keys and 64 rows: the S^T / dP^T (S / dP)
// tile of 64 x 64 is 4 x 2 warp tiles of 16 x 32; the dK/dV (dQ)
// accumulator of 64 x D is 4 x 2 warp tiles of 16 x D/2.  P and dS go
// through shared memory between the two.
//
// generic (float32 inputs at any D <= 256, bfloat16 at the head dims the
// tensor-core routes do not take): float32 FMAs, the inputs widened in
// shared memory with the head dim padded to DP (16, 32, 64, 128 or 256)
// and a pitch of DP + 1 floats (odd: a column read by 16 threads hits 16
// banks).  Tiles of 64 keys and 64 rows (32 at DP = 256, where four 64-row
// tiles would not fit 227 KB).  Thread (ty, tx) of 16 x 16 owns keys (or
// rows) ty + 16 i and rows (or keys) tx + 16 c of a score tile, and
// columns tx + 16 j of an accumulator; bf16 inputs round P and dS to bf16
// for their products, as the mma route does.
//
// What bounds it.  Five products of 2 * D operations per live (q, k) pair
// and head (S and dP twice: each walk recomputes them; counted once in
// the bound, 10 * D), at the bf16 tensor peak on the tensor-core routes
// and the float32 FMA peak on the generic one.  The design's first cost
// is that recompute (7 products where the bound counts 5; fusing dQ into
// the dK/dV walk would need atomics or an ordered semaphore); on wgmma,
// 64-column products read both operands from shared memory at about the
// rate the tensor cores consume them, and each warpgroup's steps chain a
// product, its exp and the next product.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ bool live(int pos, int key, int window) {
  return key <= pos && (window <= 0 || pos - key < window);
}

// ---------------------------------------------------------------------------
// D_ = rowsum(dO o O): one warp a row, the lanes' sums added by a fixed
// xor tree
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int S, int Hq, int D,
                long long n_rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // a whole warp leaves together
  const T* a = o + row * D;
  const T* c = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(widen(a[d]), widen(c[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    // row = (b * S + pos) * Hq + hq  ->  delta[(b * Hq + hq) * S + pos]
    const long long hq = row % Hq, bs = row / Hq;
    const long long pos = bs % S, b = bs / S;
    delta[(b * Hq + hq) * S + pos] = s;
  }
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S,
                 int Hq, int D, cudaStream_t stream) {
  const long long n_rows = (long long)B * S * Hq;
  flash_bwd_delta<T><<<(unsigned)((n_rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, S, Hq, D,
      n_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mma route: bfloat16 on mma.sync
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;      // keys per key tile, rows per row tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kPS = kTile + 8; // pitch of the P / dS tiles (elements)

template <int D>
struct Shape {
  static_assert(D % 32 == 0, "the mma route takes D a multiple of 32");
  static constexpr int kP = D + 8;            // pitch of a 64 x D tile
  static constexpr int kTileElems = kTile * kP;
  static constexpr int kNT = D / 16;          // n-tiles of a warp's D / 2
  static constexpr int kUnroll = D <= 128 ? 16 : 2;  // mm2's k loop
  // four 64 x D tiles (one resident pair, one pair double-buffered, so
  // six), the P and dS tiles, and L, D_ and the rows' positions (twice)
  static constexpr size_t kSmem =
      sizeof(bf16) * (6 * kTileElems + 2 * kTile * kPS) +
      2 * 3 * kTile * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, or zero where !ok
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Two products of one shape, interleaved so that each k-step issues two
// independent chains: c0[nt] += A0 . B0 and c1[nt] += A1 . B1 over columns
// n0 + 8 nt, A[m0 .. m0 + 15][0 .. K) stored [m][k] at pitch pa, B[0 .. K)
// stored [n][k] (kBKN false: the product takes B^T of a row-major tile) or
// [k][n] (true) at pitch pb.  The k loop unrolls by U, so the next
// step's ldmatrix loads overlap this step's mma: fully up to D = 128, by
// two above (a full unroll spills at D = 160, unrolling by two spills at
// D = 64).
template <int K, int NT, bool kBKN, int U>
__device__ __forceinline__ void mm2(float (&c0)[NT][4], float (&c1)[NT][4],
                                    uint32_t a0_base, uint32_t a1_base,
                                    int pa, int m0, uint32_t b0_base,
                                    uint32_t b1_base, int pb, int n0,
                                    int lane) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "two n-tiles a load");
#pragma unroll(U)
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a_off =
        2 * ((m0 + (lane % 8) + 8 * ((lane / 8) % 2)) * pa + k0 +
             8 * (lane / 16));
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, a0_base + a_off);
    ldsm_x4(a1, a1_base + a_off);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int n = n0 + 16 * np;
      const uint32_t b_off =
          kBKN ? 2 * ((k0 + (lane % 8) + 8 * ((lane / 8) % 2)) * pb + n +
                      8 * (lane / 16))
               : 2 * ((n + (lane % 8) + 8 * (lane / 16)) * pb + k0 +
                      8 * ((lane / 8) % 2));
      uint32_t b0[4], b1[4];
      if (kBKN) {
        ldsm_x4_t(b0, b0_base + b_off);
        ldsm_x4_t(b1, b1_base + b_off);
      } else {
        ldsm_x4(b0, b0_base + b_off);
        ldsm_x4(b1, b1_base + b_off);
      }
      mma(c0[2 * np], a0, b0[0], b0[1]);
      mma(c1[2 * np], a1, b1[0], b1[1]);
      mma(c0[2 * np + 1], a0, b0[2], b0[3]);
      mma(c1[2 * np + 1], a1, b1[2], b1[3]);
    }
  }
}

// One product: c[nt] += A . B as in mm2
template <int K, int NT, bool kBKN, int U>
__device__ __forceinline__ void mm(float (&c)[NT][4], uint32_t a_base,
                                   int pa, int m0, uint32_t b_base, int pb,
                                   int n0, int lane) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "two n-tiles a load");
#pragma unroll(U)
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_base + 2 * ((m0 + (lane % 8) + 8 * ((lane / 8) % 2)) * pa +
                             k0 + 8 * (lane / 16)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int n = n0 + 16 * np;
      uint32_t b[4];
      if (kBKN)
        ldsm_x4_t(b, b_base + 2 * ((k0 + (lane % 8) + 8 * ((lane / 8) % 2)) *
                                       pb + n + 8 * (lane / 16)));
      else
        ldsm_x4(b, b_base + 2 * ((n + (lane % 8) + 8 * (lane / 16)) * pb +
                                 k0 + 8 * ((lane / 8) % 2)));
      mma(c[2 * np], a, b[0], b[1]);
      mma(c[2 * np + 1], a, b[2], b[3]);
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

// 64 rows of a [B, S, H, D] tensor into a shared tile of pitch D + 8, one
// cp.async per 16 bytes; `row(r)` gives row r's global offset in elements,
// or -1 for a row past the end (zeros)
template <int D, typename RowFn>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          RowFn row) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const long long off = row(r);
    cp16(dst + r * Shape<D>::kP + 8 * c, src + (off < 0 ? 0 : off + 8 * c),
         off >= 0);
  }
}

// dK and dV of one tile of 64 keys of kv head h
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int S, int Hq, int Hkv, int window,
                   float scale) {
  using Sh = Shape<D>;
  constexpr int P = Sh::kP;
  constexpr int NT = Sh::kNT;
  extern __shared__ uint4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);
  bf16* sV = sK + Sh::kTileElems;
  bf16* sQ = sV + Sh::kTileElems;          // [2][64][P]
  bf16* sdO = sQ + 2 * Sh::kTileElems;     // [2][64][P]
  bf16* sP = sdO + 2 * Sh::kTileElems;     // P^T [64 keys][kPS]
  bf16* sdS = sP + kTile * kPS;            // dS^T [64 keys][kPS]
  float* sL = reinterpret_cast<float*>(sdS + kTile * kPS);  // [2][64]
  float* sD = sL + 2 * kTile;                               // [2][64]
  int* sPos = reinterpret_cast<int*>(sD + 2 * kTile);       // [2][64]

  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // key tile 0 (the longest walk) first
  const long long n_rows = (long long)S * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D>(sK, k, [&](int r) -> long long {
    const int key = k0 + r;
    return key < S ? ((b * (long long)S + key) * Hkv + h) * D : -1;
  });
  load_tile<D>(sV, v, [&](int r) -> long long {
    const int key = k0 + r;
    return key < S ? ((b * (long long)S + key) * Hkv + h) * D : -1;
  });

  // the rows that reach this tile: pos >= k0, and pos < k0 + 64 + window - 1
  const long long r_lo = (long long)k0 * G;
  const int pos_end = window > 0 ? min(S, k0 + kTile - 1 + window) : S;
  const long long r_end = (long long)pos_end * G;
  const int n_it = (int)((r_end - r_lo + kTile - 1) / kTile);

  auto issue = [&](int it) {
    const int buf = it & 1;
    const long long q0 = r_lo + (long long)it * kTile;
    auto row = [&](int r) -> long long {
      const int R = (int)(q0 + r);  // S * G < 2^31 (the launcher checks)
      if (R >= n_rows) return -1;
      const int pos = R / G, g = R - pos * G;
      return ((b * (long long)S + pos) * Hq + h * G + g) * D;
    };
    load_tile<D>(sQ + buf * Sh::kTileElems, q, row);
    load_tile<D>(sdO + buf * Sh::kTileElems, dout, row);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const int R = (int)(q0 + r);
      const bool ok = R < n_rows;
      const int pos = ok ? R / G : 0, g = ok ? R - pos * G : 0;
      const long long li = (b * (long long)Hq + h * G + g) * S + pos;
      cp4(sL + buf * kTile + r, lse + li, ok);
      cp4(sD + buf * kTile + r, delta + li, ok);
      sPos[buf * kTile + r] = ok ? (int)pos : -1;  // -1: no key is live
    }
    cp_commit();
  };

  // warp tiles: S^T / dP^T keys sm0 .. +15 by rows sn0 .. +31; dK / dV
  // keys sm0 .. +15 by columns dn0 .. + D/2 - 1
  const int sm0 = 16 * (warp % 4), sn0 = 32 * (warp / 4);
  const int dn0 = (D / 2) * (warp / 4);
  float acc_k[NT][4], acc_v[NT][4];
  zero(acc_k);
  zero(acc_v);
  const float scale_log2 = scale * kLog2e;

  issue(0);  // with K and V, one group
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    __syncthreads();  // the previous tile's P, dS and buffers fully read
    if (it + 1 < n_it) {
      issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* tq = sQ + buf * Sh::kTileElems;
    const bf16* tdo = sdO + buf * Sh::kTileElems;
    const float* tl = sL + buf * kTile;
    const float* td = sD + buf * kTile;
    const int* tp = sPos + buf * kTile;

    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    mm2<D, 4, false, Sh::kUnroll>(st, dpt, smem_u32(sK), smem_u32(sV), P,
                                  sm0, smem_u32(tq), smem_u32(tdo), P, sn0,
                                  lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kr = sm0 + lane / 4 + 8 * half;  // key within the tile
        const int key = k0 + kr;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rl = sn0 + 8 * nt + 2 * (lane % 4) + e;
          const int i = 2 * half + e;
          p[e] = live(tp[rl], key, window)
                     ? exp2f(st[nt][i] * scale_log2 - tl[rl] * kLog2e)
                     : 0.f;
          ds[e] = p[e] * (dpt[nt][i] - td[rl]);
        }
        const int col = sn0 + 8 * nt + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(sP + kr * kPS + col) =
            pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(sdS + kr * kPS + col) =
            pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();
    mm2<kTile, NT, true, Sh::kUnroll>(acc_v, acc_k, smem_u32(sP),
                                      smem_u32(sdS), kPS, sm0, smem_u32(tdo),
                                      smem_u32(tq), P, dn0, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + sm0 + lane / 4 + 8 * half;
    if (key >= S) continue;
    const long long base = ((b * (long long)S + key) * Hkv + h) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = dn0 + 8 * nt + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(dk + base + col) =
          pack_bf16(acc_k[nt][2 * half] * scale,
                    acc_k[nt][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + col) =
          pack_bf16(acc_v[nt][2 * half], acc_v[nt][2 * half + 1]);
    }
  }
}

// dQ of one tile of 64 folded rows of kv head h
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq, int S,
                 int Hq, int Hkv, int window, float scale) {
  using Sh = Shape<D>;
  constexpr int P = Sh::kP;
  constexpr int NT = Sh::kNT;
  extern __shared__ uint4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sdO = sQ + Sh::kTileElems;
  bf16* sK = sdO + Sh::kTileElems;         // [2][64][P]
  bf16* sV = sK + 2 * Sh::kTileElems;      // [2][64][P]
  bf16* sdS = sV + 2 * Sh::kTileElems;     // dS [64 rows][kPS]
  float* sL = reinterpret_cast<float*>(sdS + 2 * kTile * kPS);
  float* sD = sL + kTile;
  int* sPos = reinterpret_cast<int*>(sD + kTile);

  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long n_rows = (long long)S * G;
  const long long r0 = (long long)(gridDim.z - 1 - blockIdx.z) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  auto row = [&](int r) -> long long {
    const int R = (int)(r0 + r);
    if (R >= n_rows) return -1;
    const int pos = R / G, g = R - pos * G;
    return ((b * (long long)S + pos) * Hq + h * G + g) * D;
  };
  load_tile<D>(sQ, q, row);
  load_tile<D>(sdO, dout, row);
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    const int R = (int)(r0 + r);
    const bool ok = R < n_rows;
    const int pos = ok ? R / G : 0, g = ok ? R - pos * G : 0;
    const long long li = (b * (long long)Hq + h * G + g) * S + pos;
    cp4(sL + r, lse + li, ok);
    cp4(sD + r, delta + li, ok);
    sPos[r] = ok ? (int)pos : -1;
  }

  const int pos_lo = (int)(r0 / G);
  const int pos_hi = (int)((min(r0 + kTile, n_rows) - 1) / G);
  const int j_hi = pos_hi / kTile;
  const int j_lo = window > 0 ? max(0, pos_lo - (window - 1)) / kTile : 0;
  const int n_it = j_hi - j_lo + 1;

  auto issue = [&](int it) {
    const int buf = it & 1;
    const int kb = (j_lo + it) * kTile;
    auto krow = [&](int r) -> long long {
      const int key = kb + r;
      return key < S ? ((b * (long long)S + key) * Hkv + h) * D : -1;
    };
    load_tile<D>(sK + buf * Sh::kTileElems, k, krow);
    load_tile<D>(sV + buf * Sh::kTileElems, v, krow);
    cp_commit();
  };

  // warp tiles: S / dP rows sm0 .. +15 by keys sn0 .. +31; dQ rows
  // sm0 .. +15 by columns dn0 .. + D/2 - 1
  const int sm0 = 16 * (warp % 4), sn0 = 32 * (warp / 4);
  const int dn0 = (D / 2) * (warp / 4);
  float acc[NT][4];
  zero(acc);
  const float scale_log2 = scale * kLog2e;

  issue(0);  // with Q, dO, L and D_, one group
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    const int kb = (j_lo + it) * kTile;
    __syncthreads();  // the previous tile's dS and buffers fully read
    if (it + 1 < n_it) {
      issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* tk = sK + buf * Sh::kTileElems;
    const bf16* tv = sV + buf * Sh::kTileElems;

    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm2<D, 4, false, Sh::kUnroll>(s, dp, smem_u32(sQ), smem_u32(sdO), P,
                                  sm0, smem_u32(tk), smem_u32(tv), P, sn0,
                                  lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = sm0 + lane / 4 + 8 * half;
      const int pos = sPos[rl];
      const float l2 = sL[rl] * kLog2e, dl = sD[rl];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = sn0 + 8 * nt + 2 * (lane % 4);
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * half + e;
          const float p = live(pos, kb + col + e, window)
                              ? exp2f(s[nt][i] * scale_log2 - l2)
                              : 0.f;
          ds[e] = p * (dp[nt][i] - dl);
        }
        *reinterpret_cast<uint32_t*>(sdS + rl * kPS + col) =
            pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();
    mm<kTile, NT, true, Sh::kUnroll>(acc, smem_u32(sdS), kPS, sm0,
                                     smem_u32(tk), P, dn0, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long off = row(sm0 + lane / 4 + 8 * half);
    if (off < 0) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = dn0 + 8 * nt + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(dq + off + col) =
          pack_bf16(acc[nt][2 * half] * scale, acc[nt][2 * half + 1] * scale);
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int B, int S, int Hq, int Hkv, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::kSmem;
  static bool configured = false;
  if (!configured) {
    if (int e = set_smem(flash_bwd_dkdv_mma<D>, smem)) return e;
    if (int e = set_smem(flash_bwd_dq_mma<D>, smem)) return e;
    configured = true;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv)) % 16)
    return -3;
  const auto* bq = static_cast<const bf16*>(q);
  const auto* bk = static_cast<const bf16*>(k);
  const auto* bv = static_cast<const bf16*>(v);
  const auto* bdo = static_cast<const bf16*>(dout);
  const long long n_rows = (long long)S * (Hq / Hkv);
  dim3 kv_grid(Hkv, B, (S + kTile - 1) / kTile);
  flash_bwd_dkdv_mma<D><<<kv_grid, kThreads, smem, stream>>>(
      bq, bk, bv, bdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, Hq, Hkv, window, scale);
  if (int e = (int)cudaGetLastError()) return e;
  dim3 q_grid(Hkv, B, (unsigned)((n_rows + kTile - 1) / kTile));
  flash_bwd_dq_mma<D><<<q_grid, kThreads, smem, stream>>>(
      bq, bk, bv, bdo, lse, delta, static_cast<bf16*>(dq), S, Hq, Hkv, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// wgmma route: bfloat16 on wgmma, a producer warpgroup, P and dS in registers
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;
using tc::pack_bf16;
constexpr int kRows = 64;          // a warpgroup's keys (rows); a streamed tile
constexpr int kBlock = 128;        // a block's keys (rows): two warpgroups
constexpr int kThreads = 256;      // two warpgroups
constexpr int kStages = 4;         // the ring of streamed tiles
constexpr int kRowBytes = 128;     // a swizzled panel row: 64 bf16 columns

template <int D>
struct Shape {
  static_assert(D == 64 || D == 128, "the wgmma route takes D = 64 or 128");
  static constexpr int kPanels = D / 64;           // 64-column panels
  static constexpr int kKSteps = D / 16;           // k-steps over D
  static constexpr int kChunks = D / 8;            // 16-byte chunks a row
  static constexpr int kPanel = kRows * kRowBytes; // a panel of a 64-row tile
  static constexpr int kTile = kPanels * kPanel;   // a 64 x D tile
  // dK/dV: K and V of the block's 128 keys stay; a stage holds Q, dO, L
  // and D_ of 64 folded rows
  static constexpr int kStageKV = 2 * kTile + 1024;  // L, D_: 512 bytes
  static constexpr size_t kSmemKV =
      1024 + 4 * kTile + kStages * kStageKV + 2 * kStages * 8;
  // dQ: Q and dO of the block's 128 rows stay; a stage holds K and V of 64
  // keys
  static constexpr int kStageQ = 2 * kTile;
  static constexpr size_t kSmemQ =
      1024 + 4 * kTile + kStages * kStageQ + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// bring a TMA descriptor (a __grid_constant__ parameter) into its cache
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed; a completion that
// never comes (~17 s of clock) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// generic-proxy stores (cp.async, st.shared) -> visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands use
// only the stride between 8-row groups (1024 bytes); for an MN-major panel
// (64 columns: one swizzle span) both offsets are that stride.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  constexpr uint64_t kStride = 1024 >> 4;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (kStride << 16) |
         (kStride << 32) | (1ull << 62);
}

// 2^x (MUFU.EX2; subnormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the two bf16 of a packed pair, widened
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// pin registers around the asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

#define WG_ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define WG_REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"

#define WG_OUT32(d)                                                           \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),     \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),            \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),        \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),        \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),        \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),        \
      "=f"(d[31])

// d[64 x 64] = A[64 x 16] (shared, K-major) . B[16 x 64] (shared, K-major)
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(0));
}

// d[64 x 64] += A[64 x 16] (shared, K-major) . B[16 x 64] (shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_ACC32
#undef WG_OUT32
#undef WG_REGS32

// d = A . B^T over D (64 x 64), A and B 64 x D tiles of 64-column panels
// read K-major; issued, not waited for
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t b) {
  using Sh = Shape<D>;
  wgmma_ss_first(d, desc_sw128(a), desc_sw128(b));
#pragma unroll
  for (int kk = 1; kk < Sh::kKSteps; ++kk) {
    const uint32_t off = (kk / 4) * Sh::kPanel + (kk % 4) * 32;
    wgmma_ss(d, desc_sw128(a + off), desc_sw128(b + off));
  }
}

// acc[p] += A . B over 64 rows of K, A the packed bf16 fragments of a
// 64 x 64 accumulator (k-step kk: a[4 kk .. 4 kk + 3]), B a 64 x D tile read
// MN-major, one panel a product; issued, not waited for
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[Shape<D>::kPanels][32],
                                         const uint32_t (&a)[16], uint32_t b) {
  using Sh = Shape<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < Sh::kPanels; ++p)
      wgmma_rs(acc[p], a + 4 * kk,
               desc_sw128(b + p * Sh::kPanel + kk * 16 * kRowBytes));
}

// 64 rows of two [B, S, H, D] tensors that share row offsets into two
// 128-byte-swizzled 64 x D tiles by cp.async, 16 bytes a copy, from N
// threads (t < N); row(r) gives row r's offset in elements, or -1 (zeros)
template <int D, int N, typename RowFn>
__device__ __forceinline__ void load_rows(uint8_t* dst0, const bf16* src0,
                                          uint8_t* dst1, const bf16* src1,
                                          int t, RowFn row) {
  using Sh = Shape<D>;
  static_assert(N % Sh::kChunks == 0, "a thread copies one column chunk");
  const int c = t % Sh::kChunks;  // the same chunk of every row it copies
  const int col = (c / 8) * Sh::kPanel + ((c % 8) << 4);
#pragma unroll 1
  for (int r = t / Sh::kChunks; r < kRows; r += N / Sh::kChunks) {
    const long long off = row(r);
    const int at = col + r * kRowBytes;
    const int swz = (r & 7) << 4;  // 128-byte swizzle: chunk ^= row % 8
    const long long from = off < 0 ? 0 : off + 8 * c;
    tc::cp16(dst0 + (at ^ swz), src0 + from, off >= 0);
    tc::cp16(dst1 + (at ^ swz), src1 + from, off >= 0);
  }
}

// The ring's handshake.  A step's stage is filled kAhead steps before it
// is read: at step it, once every warp has read the stage of step it - 2
// (its `empty` barrier, one arrival a warp), step it + kAhead goes into
// it, while the step's first product runs.  The stage's `full` barrier
// takes an arrival from the copy unit for each thread that copies by
// cp.async (when its copies have landed) and from each thread that issues
// TMA (with its bytes), so a stage is ready when its data is, whatever
// step each warpgroup is at.
constexpr int kAhead = kStages - 2;

__device__ __forceinline__ void stage_issued(uint64_t* full) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(full))
               : "memory");
}

__device__ __forceinline__ void stage_wait(uint64_t* full, int it,
                                           bool copied) {
  mbar_wait(full, (it / kStages) & 1);
  if (copied) fence_async_smem();  // cp.async wrote what wgmma reads
}

__device__ __forceinline__ void stage_read(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// before issuing step it + kAhead into the stage of step it - 2
__device__ __forceinline__ void stage_free(uint64_t* empty, int it) {
  mbar_wait(empty, (((it + kAhead) / kStages) & 1) ^ 1);
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* out0;  // dK (dK/dV walk) or dQ
  bf16* out1;  // dV
  int S, Hq, Hkv, window;
  float scale;
};

// dK and dV of one tile of 128 keys of kv head h: warpgroup w owns keys
// k0 + 64 w .. + 63 (K and V stay) and reads each streamed tile of 64
// folded rows (Q, dO, L and D_) from the ring.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ Args a,
                     const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do) {
  using Sh = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles need 1024-byte alignment
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = base;                    // [warpgroup][panel][64 keys][128 B]
  uint8_t* sV = sK + 2 * Sh::kTile;
  uint8_t* ring = sV + 2 * Sh::kTile;    // stage: Q, dO, L, D_
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * Sh::kStageKV);
  uint64_t* empty = full + kStages;

  const int S = a.S, Hq = a.Hq, Hkv = a.Hkv, window = a.window;
  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBlock;  // key tile 0 (the longest walk) first
  const int n_rows = S * G;            // S * G < 2^31 (the launcher checks)
  // the rows that reach this tile: pos >= k0, pos < k0 + 128 + window - 1
  const int r_lo = k0 * G;
  const int pos_end = window > 0 ? min(S, k0 + kBlock - 1 + window) : S;
  const int n_it = (int)(((long long)pos_end * G - r_lo + kRows - 1) / kRows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wgi = warp / 4, wiw = warp % 4, tw = tid % 128;
  const int kw0 = k0 + kRows * wgi;  // this warpgroup's first key
  // a group that divides 64 makes a tile of rows 64 / G whole positions:
  // one TMA box of (64 columns, G heads, 64 / G positions) a panel
  const bool tma = kRows % G == 0;

  // the TMA issuers: thread 0 (Q) and thread 128 (dO)
  const bool issuer = tma && tw == 0;
  if (issuer) tma_prefetch(wgi ? &tm_do : &tm_q);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kThreads + (tma ? 2 : 0));
      mbar_init(&empty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the rows of step it into its stage: Q and dO by TMA from the issuers,
  // or by every thread; L and D_ by threads 0-127
  auto issue = [&](int it) {
    uint64_t* bar = &full[it % kStages];
    uint8_t* sq = ring + (it % kStages) * Sh::kStageKV;
    float* sl = reinterpret_cast<float*>(sq + 2 * Sh::kTile);
    const int q0 = r_lo + it * kRows;
    if (tma) {
      if (issuer) {
        uint8_t* dst = sq + wgi * Sh::kTile;
        mbar_expect_tx(bar, Sh::kTile);
#pragma unroll
        for (int p = 0; p < Sh::kPanels; ++p)
          tma_load_4d(dst + p * Sh::kPanel, wgi ? &tm_do : &tm_q, bar, 64 * p,
                      h * G, q0 / G, b);
      }
    } else {
      load_rows<D, kThreads>(sq, a.q, sq + Sh::kTile, a.dout, tid,
                           [&](int r) -> long long {
                             const int R = q0 + r;
                             if (R >= n_rows) return -1;
                             const int pos = R / G;
                             return ((b * (long long)S + pos) * Hq + h * G +
                                     R - pos * G) * D;
                           });
    }
    if (tid < 2 * kRows) {
      const int r = tid % kRows;
      const int R = q0 + r;
      const bool ok = R < n_rows;
      const int pos = ok ? R / G : 0, g = ok ? R - pos * G : 0;
      const long long li = (b * (long long)Hq + h * G + g) * S + pos;
      tc::cp4(sl + tid, (tid < kRows ? a.lse : a.delta) + li, ok);
    }
    stage_issued(bar);
  };

  // this warpgroup's K and V rows (ready with step 0's stage), then the
  // first kAhead steps
  load_rows<D, 128>(sK + wgi * Sh::kTile, a.k, sV + wgi * Sh::kTile, a.v, tw,
                    [&](int r) -> long long {
                      const int key = kw0 + r;
                      return key < S ? ((b * (long long)S + key) * Hkv + h) * D
                                     : -1;
                    });
  for (int it = 0; it < min(n_it, kAhead); ++it) issue(it);

  // a thread holds keys keyA and keyA + 8 of the S^T / dK / dV tiles, and
  // the rows (columns of S^T) 8 j + 2 qd + e, j < 8, e < 2
  const int qd = lane % 4;
  const int keyA = kw0 + 16 * wiw + lane / 4;
  const float scale_log2 = a.scale * kLog2e;
  const uint32_t k_addr = smem_u32(sK + wgi * Sh::kTile);
  const uint32_t v_addr = smem_u32(sV + wgi * Sh::kTile);
  float acc_k[Sh::kPanels][32], acc_v[Sh::kPanels][32];
#pragma unroll
  for (int p = 0; p < Sh::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[p][i] = acc_v[p][i] = 0.f;

  // a step's tile of rows q0 .. q0 + 63 against this warpgroup's keys
  // kw0 .. kw0 + 63: every pair dead below dead_lo (rows before the
  // keys) and from dead_hi (past the window), some dead (masked) below
  // edge_lo (the diagonal), from edge_hi (the window's far edge) and in
  // the tile past S * G
  constexpr long long kNever = 1ll << 62;
  const long long dead_lo = (long long)kw0 * G - (kRows - 1);
  const long long edge_lo = (long long)(kw0 + kRows - 1) * G;
  const long long dead_hi =
      window > 0 ? (long long)(kw0 + kRows - 1 + window) * G : kNever;
  const long long edge_hi =
      window > 0 ? (long long)(kw0 + window) * G - (kRows - 1) : kNever;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int q0 = r_lo + it * kRows;
    const bool dead = kw0 >= S || q0 < dead_lo || q0 >= dead_hi;
    const bool edge =
        q0 + kRows > n_rows || q0 < edge_lo || q0 >= edge_hi;
    uint8_t* sq = ring + st * Sh::kStageKV;
    const uint32_t q_addr = smem_u32(sq);
    const uint32_t do_addr = q_addr + Sh::kTile;
    const float* sl = reinterpret_cast<const float*>(sq + 2 * Sh::kTile);
    const float* sd = sl + kRows;
    stage_wait(&full[st], it, !tma || it == 0);

    // S^T = K . Q^T, keys by rows; while it runs, step it + kAhead's copies
    float s[32];
    if (!dead) {
      wgmma_fence();
      issue_ss<D>(s, k_addr, q_addr);
      wgmma_commit();
    }
    if (it + kAhead < n_it) {
      stage_free(&empty[(it + kAhead) % kStages], it);
      issue(it + kAhead);
    }

    if (!dead) {
      wgmma_wait0();
      fence_regs(s);

      // P^T, rounded to bf16, as A fragments: it never leaves registers
      uint32_t pa[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * qd);
        const float lx = l.x * kLog2e, ly = l.y * kLog2e;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half;
          pa[2 * j + half] = pack_bf16(ex2(s[i] * scale_log2 - lx),
                                       ex2(s[i + 1] * scale_log2 - ly));
        }
      }
      if (edge) {  // the dead pairs' P^T to zero
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int R = q0 + 8 * j + 2 * qd + e;
            const int pos = R < n_rows ? R / G : -1;  // -1: past the end
            const uint32_t keep = e ? 0x0000FFFFu : 0xFFFF0000u;
#pragma unroll
            for (int half = 0; half < 2; ++half)
              if (!live(pos, keyA + 8 * half, window)) pa[2 * j + half] &= keep;
          }
      }

      // dV += P^T . dO (dO read MN-major) and dP^T = V . dO^T, one group
      float dp[32];
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p) fence_regs(acc_v[p]);
      fence_regs(pa);
      wgmma_fence();
      issue_rs<D>(acc_v, pa, do_addr);
      issue_ss<D>(dp, v_addr, do_addr);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dp);
      fence_regs(pa);
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p) fence_regs(acc_v[p]);

      // dS^T = P^T o (dP^T - D_) from the rounded P^T, as A fragments
      uint32_t da[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * qd);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 p = unpack_bf16(pa[2 * j + half]);
          const int i = 4 * j + 2 * half;
          da[2 * j + half] =
              pack_bf16(p.x * (dp[i] - dd.x), p.y * (dp[i + 1] - dd.y));
        }
      }

      // dK += dS^T . Q, Q read MN-major
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p) fence_regs(acc_k[p]);
      fence_regs(da);
      wgmma_fence();
      issue_rs<D>(acc_k, da, q_addr);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(da);
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p) fence_regs(acc_k[p]);
    }
    stage_read(&empty[st], lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = keyA + 8 * half;
    if (key >= S) continue;
    const long long row = ((b * (long long)S + key) * Hkv + h) * D;
#pragma unroll
    for (int p = 0; p < Sh::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * qd;
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<uint32_t*>(a.out0 + row + col) =
            pack_bf16(acc_k[p][i] * a.scale, acc_k[p][i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.out1 + row + col) =
            pack_bf16(acc_v[p][i], acc_v[p][i + 1]);
      }
  }
}

// dQ of one tile of 128 folded rows of kv head h: warpgroup w owns rows
// r0 + 64 w .. + 63 (Q, dO, L and D_ stay) and reads each streamed tile of
// 64 keys (K and V) from the ring.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ Args a,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v) {
  using Sh = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;                    // [warpgroup][panel][64 rows][128 B]
  uint8_t* sdO = sQ + 2 * Sh::kTile;
  uint8_t* ring = sdO + 2 * Sh::kTile;   // stage: K, V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * Sh::kStageQ);
  uint64_t* empty = full + kStages;

  const int S = a.S, Hq = a.Hq, Hkv = a.Hkv, window = a.window;
  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_rows = S * G;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kBlock;  // longest first
  const int pos_lo = r0 / G;
  const int pos_hi = (min(r0 + kBlock, n_rows) - 1) / G;
  const int j_hi = pos_hi / kRows;
  const int j_lo = window > 0 ? max(0, pos_lo - (window - 1)) / kRows : 0;
  const int n_it = j_hi - j_lo + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wgi = warp / 4, wiw = warp % 4, tw = tid % 128;
  const int rw0 = r0 + kRows * wgi;  // this warpgroup's first row

  // the TMA issuers: thread 0 (K) and thread 128 (V)
  const bool issuer = tw == 0;
  if (issuer) tma_prefetch(wgi ? &tm_v : &tm_k);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 2);  // the issuers' arrivals with their bytes
      mbar_init(&empty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V of step it into its stage, by TMA from the issuers
  auto issue = [&](int it) {
    if (!issuer) return;
    uint64_t* bar = &full[it % kStages];
    uint8_t* dst = ring + (it % kStages) * Sh::kStageQ + wgi * Sh::kTile;
    mbar_expect_tx(bar, Sh::kTile);
#pragma unroll
    for (int p = 0; p < Sh::kPanels; ++p)
      tma_load_4d(dst + p * Sh::kPanel, wgi ? &tm_v : &tm_k, bar, 64 * p, h,
                  (j_lo + it) * kRows, b);
  };
  auto row = [&](int r) -> long long {
    const int R = rw0 + r;
    if (R >= n_rows) return -1;
    const int pos = R / G;
    return ((b * (long long)S + pos) * Hq + h * G + R - pos * G) * D;
  };
  // this warpgroup's Q and dO rows (ready with step 0's stage), then the
  // first kAhead steps
  load_rows<D, 128>(sQ + wgi * Sh::kTile, a.q, sdO + wgi * Sh::kTile, a.dout,
                    tw, row);
  tc::cp_commit();
  for (int it = 0; it < min(n_it, kAhead); ++it) issue(it);

  // a thread holds rows rA and rA + 8 of its warpgroup's 64, and the keys
  // (columns of S) 8 j + 2 qd + e, j < 8, e < 2
  const int qd = lane % 4;
  const int rA = 16 * wiw + lane / 4;
  int pos[2];
  float l2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = rw0 + rA + 8 * half;
    const bool ok = R < n_rows;
    pos[half] = ok ? R / G : -1;  // -1: no key is live
    const int g = ok ? R - pos[half] * G : 0;
    const long long li =
        (b * (long long)Hq + h * G + g) * S + (ok ? pos[half] : 0);
    l2[half] = ok ? a.lse[li] * kLog2e : 0.f;
    dl[half] = ok ? a.delta[li] : 0.f;
  }
  tc::cp_wait<0>();
  fence_async_smem();
  __syncthreads();  // the resident tiles written, visible to wgmma
  const bool rows_live = rw0 < n_rows;
  const int w_lo = rw0 / G;
  const int w_hi = min(S - 1, (rw0 + kRows - 1) / G);
  const float scale_log2 = a.scale * kLog2e;
  const uint32_t q_addr = smem_u32(sQ + wgi * Sh::kTile);
  const uint32_t do_addr = smem_u32(sdO + wgi * Sh::kTile);
  float acc[Sh::kPanels][32];
#pragma unroll
  for (int p = 0; p < Sh::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int kb = (j_lo + it) * kRows;
    const bool dead = !rows_live || kb > w_hi ||
                      (window > 0 && w_lo - (kb + kRows - 1) >= window);
    const bool edge = rw0 + kRows > n_rows || kb + kRows - 1 > w_lo ||
                      (window > 0 && w_hi - kb >= window);
    const uint32_t k_addr = smem_u32(ring + st * Sh::kStageQ);
    const uint32_t v_addr = k_addr + Sh::kTile;
    stage_wait(&full[st], it, false);

    // S = Q . K^T and dP = dO . V^T, rows by keys, two groups; while they
    // run, step it + kAhead's copies
    float s[32], dp[32];
    if (!dead) {
      wgmma_fence();
      issue_ss<D>(s, q_addr, k_addr);
      wgmma_commit();
      issue_ss<D>(dp, do_addr, v_addr);
      wgmma_commit();
    }
    if (it + kAhead < n_it) {
      stage_free(&empty[(it + kAhead) % kStages], it);
      issue(it + kAhead);
    }

    if (!dead) {
      fence_regs(dp);
      wgmma_wait1();
      fence_regs(s);

      // P, rounded to bf16 as the dK/dV walk rounds it, while dP runs
      uint32_t pa[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half;
          pa[2 * j + half] = pack_bf16(ex2(s[i] * scale_log2 - l2[half]),
                                       ex2(s[i + 1] * scale_log2 - l2[half]));
        }
      if (edge) {  // the dead pairs' P to zero
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kb + 8 * j + 2 * qd + e;
            const uint32_t keep = e ? 0x0000FFFFu : 0xFFFF0000u;
#pragma unroll
            for (int half = 0; half < 2; ++half)
              if (!live(pos[half], key, window)) pa[2 * j + half] &= keep;
          }
      }
      wgmma_wait0();
      fence_regs(dp);

      // dS = P o (dP - D_) as bf16 A fragments, never leaving registers
      uint32_t da[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 p = unpack_bf16(pa[2 * j + half]);
          const int i = 4 * j + 2 * half;
          da[2 * j + half] = pack_bf16(p.x * (dp[i] - dl[half]),
                                       p.y * (dp[i + 1] - dl[half]));
        }

      // dQ += dS . K, K read MN-major
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p) fence_regs(acc[p]);
      fence_regs(da);
      wgmma_fence();
      issue_rs<D>(acc, da, k_addr);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(da);
#pragma unroll
      for (int p = 0; p < Sh::kPanels; ++p) fence_regs(acc[p]);
    }
    stage_read(&empty[st], lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long off = row(rA + 8 * half);
    if (off < 0) continue;
#pragma unroll
    for (int p = 0; p < Sh::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * qd;
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<uint32_t*>(a.out0 + off + col) =
            pack_bf16(acc[p][i] * a.scale, acc[p][i + 1] * a.scale);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up in the already loaded driver
// library (no link-time dependency on libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// x [B, S, H, D] bf16 as a 4-D tensor (D, H, S, B); one box is 64 columns
// x `heads` heads x `rows` positions, 128-byte swizzled (its rows in the
// order (position, head): folded rows when heads is a whole group); rows
// past S read as zeros
int rows_map(CUtensorMap* map, const void* x, int B, int S, int H, int D,
             int heads, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)heads, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(x), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int B, int S, int Hq, int Hkv, int window, float scale,
           cudaStream_t stream) {
  using Sh = Shape<D>;
  static bool configured = false;
  if (!configured) {
    if (int e = tc::set_smem(flash_bwd_dkdv_wgmma<D>, Sh::kSmemKV)) return e;
    if (int e = tc::set_smem(flash_bwd_dq_wgmma<D>, Sh::kSmemQ)) return e;
    configured = true;
  }
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
            lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
            Hq, Hkv, window, scale};
  const int G = Hq / Hkv;
  CUtensorMap tq{}, tdo{}, tk{}, tv{};  // Q and dO: only where G divides 64
  if (kRows % G == 0 && (rows_map(&tq, q, B, S, Hq, D, G, kRows / G) ||
                         rows_map(&tdo, dout, B, S, Hq, D, G, kRows / G)))
    return -2;
  if (rows_map(&tk, k, B, S, Hkv, D, 1, kRows) ||
      rows_map(&tv, v, B, S, Hkv, D, 1, kRows))
    return -2;
  dim3 kv_grid(Hkv, B, (S + kBlock - 1) / kBlock);
  flash_bwd_dkdv_wgmma<D><<<kv_grid, kThreads, Sh::kSmemKV, stream>>>(a, tq,
                                                                       tdo);
  if (int e = (int)cudaGetLastError()) return e;
  a.out0 = static_cast<bf16*>(dq);
  a.out1 = nullptr;
  const long long n_rows = (long long)S * (Hq / Hkv);
  dim3 q_grid(Hkv, B, (unsigned)((n_rows + kBlock - 1) / kBlock));
  flash_bwd_dq_wgmma<D><<<q_grid, kThreads, Sh::kSmemQ, stream>>>(a, tk, tv);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// generic route: float32 FMAs, any head dim up to 256
// ---------------------------------------------------------------------------

namespace gen {

constexpr int kThreads = 256;  // 16 x 16

template <int DP>
struct Shape {
  static constexpr int kTile = DP <= 128 ? 64 : 32;  // keys or rows a tile
  static constexpr int kT = kTile / 16;              // a thread's keys / rows
  static constexpr int kCols = DP / 16;              // a thread's columns
  static constexpr int kP = DP + 1;                  // pitch (floats)
  static constexpr int kPS = kTile + 1;
  // four kTile x DP tiles, P and dS, L, D_ and the rows' positions
  static constexpr size_t kSmem =
      sizeof(float) * (4 * kTile * kP + 2 * kTile * kPS + 3 * kTile);
};

// kTile rows of a [B, S, H, D] tensor, widened, columns past D zero;
// `row(r)` gives row r's offset in elements, or -1 (zeros)
template <int DP, typename T, typename RowFn>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int D,
                                          RowFn row) {
  using Sh = Shape<DP>;
  for (int idx = threadIdx.x; idx < Sh::kTile * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const long long off = row(r);
    dst[r * Sh::kP + c] = off >= 0 && c < D ? widen(src[off + c]) : 0.f;
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_generic(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, int S, int Hq, int Hkv, int D,
                       int window, float scale) {
  using Sh = Shape<DP>;
  constexpr int TL = Sh::kTile, TT = Sh::kT, TC = Sh::kCols;
  constexpr int P = Sh::kP, PS = Sh::kPS;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + TL * P;
  float* sQ = sV + TL * P;
  float* sdO = sQ + TL * P;
  float* sP = sdO + TL * P;   // P^T [keys][rows]
  float* sdS = sP + TL * PS;  // dS^T [keys][rows]
  float* sL = sdS + TL * PS;
  float* sD = sL + TL;
  int* sPos = reinterpret_cast<int*>(sD + TL);

  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * TL;
  const long long n_rows = (long long)S * G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  auto krow = [&](int r) -> long long {
    const int key = k0 + r;
    return key < S ? ((b * (long long)S + key) * Hkv + h) * D : -1;
  };
  load_tile<DP>(sK, k, D, krow);
  load_tile<DP>(sV, v, D, krow);

  const long long r_lo = (long long)k0 * G;
  const int pos_end = window > 0 ? min(S, k0 + TL - 1 + window) : S;
  const long long r_end = (long long)pos_end * G;

  float acc_k[TT][TC], acc_v[TT][TC];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (long long q0 = r_lo; q0 < r_end; q0 += TL) {
    __syncthreads();  // the previous tile fully read
    auto row = [&](int r) -> long long {
      const long long R = q0 + r;
      if (R >= n_rows) return -1;
      const long long pos = R / G, g = R % G;
      return ((b * (long long)S + pos) * Hq + h * G + g) * D;
    };
    load_tile<DP>(sQ, q, D, row);
    load_tile<DP>(sdO, dout, D, row);
    if (threadIdx.x < TL) {
      const long long R = q0 + threadIdx.x;
      const bool ok = R < n_rows;
      const long long pos = ok ? R / G : 0, g = ok ? R % G : 0;
      const long long li = (b * (long long)Hq + h * G + g) * S + pos;
      sL[threadIdx.x] = ok ? lse[li] : 0.f;
      sD[threadIdx.x] = ok ? delta[li] : 0.f;
      sPos[threadIdx.x] = ok ? (int)pos : -1;
    }
    __syncthreads();

    // S^T and dP^T: keys ty + 16 i by rows tx + 16 c
    float st[TT][TT], dpt[TT][TT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int c = 0; c < TT; ++c) st[i][c] = dpt[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kk[TT], vv[TT], qq[TT], oo[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        kk[i] = sK[(ty + 16 * i) * P + d];
        vv[i] = sV[(ty + 16 * i) * P + d];
        qq[i] = sQ[(tx + 16 * i) * P + d];
        oo[i] = sdO[(tx + 16 * i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int c = 0; c < TT; ++c) {
          st[i][c] = fmaf(kk[i], qq[c], st[i][c]);
          dpt[i][c] = fmaf(vv[i], oo[c], dpt[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int c = 0; c < TT; ++c) {
        const int kr = ty + 16 * i, rl = tx + 16 * c;
        const float p = live(sPos[rl], k0 + kr, window)
                            ? expf(st[i][c] * scale - sL[rl])
                            : 0.f;
        const float ds = p * (dpt[i][c] - sD[rl]);
        sP[kr * PS + rl] = widen(narrow<T>(p));
        sdS[kr * PS + rl] = widen(narrow<T>(ds));
      }
    __syncthreads();

    for (int r = 0; r < TL; ++r) {
      float pp[TT], dd[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        pp[i] = sP[(ty + 16 * i) * PS + r];
        dd[i] = sdS[(ty + 16 * i) * PS + r];
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float o = sdO[r * P + tx + 16 * j];
        const float x = sQ[r * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TT; ++i) {
          acc_v[i][j] = fmaf(pp[i], o, acc_v[i][j]);
          acc_k[i][j] = fmaf(dd[i], x, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
    const long long base = ((b * (long long)S + key) * Hkv + h) * D;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = tx + 16 * j;
      if (col >= D) continue;
      dk[base + col] = narrow<T>(acc_k[i][j] * scale);
      dv[base + col] = narrow<T>(acc_v[i][j]);
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_generic(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int S, int Hq, int Hkv, int D, int window, float scale) {
  using Sh = Shape<DP>;
  constexpr int TL = Sh::kTile, TT = Sh::kT, TC = Sh::kCols;
  constexpr int P = Sh::kP, PS = Sh::kPS;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + TL * P;
  float* sK = sdO + TL * P;
  float* sV = sK + TL * P;
  float* sdS = sV + TL * P;  // dS [rows][keys]
  float* sL = sdS + 2 * TL * PS;
  float* sD = sL + TL;
  int* sPos = reinterpret_cast<int*>(sD + TL);

  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long n_rows = (long long)S * G;
  const long long r0 = (long long)(gridDim.z - 1 - blockIdx.z) * TL;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  auto row = [&](int r) -> long long {
    const long long R = r0 + r;
    if (R >= n_rows) return -1;
    const long long pos = R / G, g = R % G;
    return ((b * (long long)S + pos) * Hq + h * G + g) * D;
  };
  load_tile<DP>(sQ, q, D, row);
  load_tile<DP>(sdO, dout, D, row);
  if (threadIdx.x < TL) {
    const long long R = r0 + threadIdx.x;
    const bool ok = R < n_rows;
    const long long pos = ok ? R / G : 0, g = ok ? R % G : 0;
    const long long li = (b * (long long)Hq + h * G + g) * S + pos;
    sL[threadIdx.x] = ok ? lse[li] : 0.f;
    sD[threadIdx.x] = ok ? delta[li] : 0.f;
    sPos[threadIdx.x] = ok ? (int)pos : -1;
  }

  const int pos_lo = (int)(r0 / G);
  const int pos_hi = (int)((min(r0 + TL, n_rows) - 1) / G);
  const int j_hi = pos_hi / TL;
  const int j_lo = window > 0 ? max(0, pos_lo - (window - 1)) / TL : 0;

  float acc[TT][TC];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int kb = jt * TL;
    __syncthreads();  // the previous tile fully read
    auto krow = [&](int r) -> long long {
      const int key = kb + r;
      return key < S ? ((b * (long long)S + key) * Hkv + h) * D : -1;
    };
    load_tile<DP>(sK, k, D, krow);
    load_tile<DP>(sV, v, D, krow);
    __syncthreads();

    // S and dP: rows ty + 16 i by keys tx + 16 c
    float s[TT][TT], dp[TT][TT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int c = 0; c < TT; ++c) s[i][c] = dp[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qq[TT], oo[TT], kk[TT], vv[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        qq[i] = sQ[(ty + 16 * i) * P + d];
        oo[i] = sdO[(ty + 16 * i) * P + d];
        kk[i] = sK[(tx + 16 * i) * P + d];
        vv[i] = sV[(tx + 16 * i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int c = 0; c < TT; ++c) {
          s[i][c] = fmaf(qq[i], kk[c], s[i][c]);
          dp[i][c] = fmaf(oo[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int c = 0; c < TT; ++c) {
        const int rl = ty + 16 * i, kc = tx + 16 * c;
        const float p = live(sPos[rl], kb + kc, window)
                            ? expf(s[i][c] * scale - sL[rl])
                            : 0.f;
        sdS[rl * PS + kc] = widen(narrow<T>(p * (dp[i][c] - sD[rl])));
      }
    __syncthreads();

    for (int c = 0; c < TL; ++c) {
      float dd[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i) dd[i] = sdS[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float x = sK[c * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TT; ++i) acc[i][j] = fmaf(dd[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const long long off = row(ty + 16 * i);
    if (off < 0) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = tx + 16 * j;
      if (col < D) dq[off + col] = narrow<T>(acc[i][j] * scale);
    }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int B, int S, int Hq, int Hkv, int D, int window, float scale,
           cudaStream_t stream) {
  using Sh = Shape<DP>;
  static bool configured = false;
  if (!configured) {
    if (int e = tc::set_smem(flash_bwd_dkdv_generic<DP, T>, Sh::kSmem))
      return e;
    if (int e = tc::set_smem(flash_bwd_dq_generic<DP, T>, Sh::kSmem))
      return e;
    configured = true;
  }
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* tdo = static_cast<const T*>(dout);
  const long long n_rows = (long long)S * (Hq / Hkv);
  dim3 kv_grid(Hkv, B, (S + Sh::kTile - 1) / Sh::kTile);
  flash_bwd_dkdv_generic<DP, T><<<kv_grid, kThreads, Sh::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, Hq, Hkv, D, window, scale);
  if (int e = (int)cudaGetLastError()) return e;
  dim3 q_grid(Hkv, B, (unsigned)((n_rows + Sh::kTile - 1) / Sh::kTile));
  flash_bwd_dq_generic<DP, T><<<q_grid, kThreads, Sh::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, Hq, Hkv, D, window,
      scale);
  return (int)cudaGetLastError();
}

// the smallest padded width that holds D
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, int B, int S, int Hq, int Hkv, int D, int window,
             float scale, cudaStream_t stream) {
#define FLASH_BWD_GEN(DP)                                                  \
  return launch<DP, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Hq, Hkv, \
                       D, window, scale, stream)
  if (D < 1 || D > 256) return -1;
  if (D <= 16) FLASH_BWD_GEN(16);
  if (D <= 32) FLASH_BWD_GEN(32);
  if (D <= 64) FLASH_BWD_GEN(64);
  if (D <= 128) FLASH_BWD_GEN(128);
  FLASH_BWD_GEN(256);
#undef FLASH_BWD_GEN
}

}  // namespace gen

// The tensor-core routes' head dims: bit D / 32 - 1 set for each.
// kernels/flash_attention.py owns the sets (BWD_MMA_HEAD_DIMS,
// BWD_WGMMA_HEAD_DIMS) and passes them to nvcc as -DFLASH_BWD_MMA_D32_MASK
// and -DFLASH_BWD_WGMMA_D32_MASK; each listed D instantiates its route's
// kernels, and the launcher takes a route at exactly its D.
#ifndef FLASH_BWD_MMA_D32_MASK
#error "build with -DFLASH_BWD_MMA_D32_MASK=<bit D / 32 - 1 per mma head dim>"
#endif
#ifndef FLASH_BWD_WGMMA_D32_MASK
#error "build with -DFLASH_BWD_WGMMA_D32_MASK=<bit D / 32 - 1 per wgmma D>"
#endif
constexpr unsigned kMmaD32 = FLASH_BWD_MMA_D32_MASK;
constexpr unsigned kWgmmaD32 = FLASH_BWD_WGMMA_D32_MASK;

constexpr bool in_mask(unsigned mask, int d) {
  return d >= 32 && d <= 256 && d % 32 == 0 && ((mask >> (d / 32 - 1)) & 1u);
}

// route 0 (mma) or 2 (wgmma) at head dim D, if the build instantiated it
template <int D>
int launch_tensor(int route, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv,
                  int window, float scale, cudaStream_t stream) {
  if constexpr (in_mask(kMmaD32, D))
    if (route == 0)
      return tc::launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Hq,
                           Hkv, window, scale, stream);
  if constexpr (in_mask(kWgmmaD32, D))
    if (route == 2)
      return wg::launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Hq,
                           Hkv, window, scale, stream);
  return -1;
}

}  // namespace

// q [B, S, Hq, D], k/v [B, S, Hkv, D], o and dout [B, S, Hq, D] of one type
// (dtype 0 float32, 1 bfloat16); lse float32 [B, Hq, S] from the forward;
// delta float32 [B, Hq, S], the scratch D_ written here; dq, dk, dv like
// q, k, v.  route: 0 mma (bfloat16 at the mma head dims), 1 generic (any
// 1 <= D <= 256), 2 wgmma (bfloat16 at the wgmma head dims), as
// kernels/flash_attention.py::backward_route names it.  window <= 0: no
// window.  Three kernels on `stream`.  Returns a CUDA error code (0 on
// success); -1 for a route, shape or type the kernel does not take, -2 if
// the CUDA driver cannot encode a TMA descriptor (wgmma), -3 for a pointer
// that is not 16-byte aligned (mma, wgmma), checked before any launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int Hq, int Hkv, int D, int window, float scale,
    int dtype, int route, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D < 1 || D > 256 ||
      (long long)S * (Hq / Hkv) >= (1ll << 31))
    return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (route == 0 && (dtype != 1 || !in_mask(kMmaD32, D))) return -1;
  if (route == 2 && (dtype != 1 || !in_mask(kWgmmaD32, D))) return -1;
  if (route < 0 || route > 2) return -1;
  if (route != 1 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv)) % 16)
    return -3;  // before any launch
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  int err = dtype == 0
                ? launch_delta<float>(o, dout, dl, B, S, Hq, D, stream)
                : launch_delta<__nv_bfloat16>(o, dout, dl, B, S, Hq, D, stream);
  if (err) return err;
  if (route == 1)
    return dtype == 0
               ? gen::dispatch<float>(q, k, v, dout, l, dl, dq, dk, dv, B, S,
                                      Hq, Hkv, D, window, scale, stream)
               : gen::dispatch<__nv_bfloat16>(q, k, v, dout, l, dl, dq, dk,
                                              dv, B, S, Hq, Hkv, D, window,
                                              scale, stream);
  switch (D) {
#define FLASH_BWD_TENSOR(DD)                                                 \
  case DD:                                                                   \
    return launch_tensor<DD>(route, q, k, v, dout, l, dl, dq, dk, dv, B, S, \
                             Hq, Hkv, window, scale, stream)
    FLASH_BWD_TENSOR(32);
    FLASH_BWD_TENSOR(64);
    FLASH_BWD_TENSOR(96);
    FLASH_BWD_TENSOR(128);
    FLASH_BWD_TENSOR(160);
    FLASH_BWD_TENSOR(192);
    FLASH_BWD_TENSOR(224);
    FLASH_BWD_TENSOR(256);
#undef FLASH_BWD_TENSOR
    default:
      return -1;
  }
}
