// GRU fit kernel (K4) for sm_90a.
//
// Replaces the JAX package's GRU fit, core/rnn_predictor.py::_compiled_fit
// (jax.jit of fit): per row, normalise the series, run `steps` Adam steps
// of backpropagation through time over a 12-unit GRU (loss: the mean of
// (preds[:-1] - y[1:])^2, preds[t] = wo . h_{t+1} + bo), then forecast
// preds[-1] * sd + mu after one last forward pass.  The arithmetic is a
// transcription of repro_torch/kernels/gru_fit.py (gru_forward,
// gru_grad_manual and gru_fit_plain), which the CPU tests hold against
// autograd and the JAX package.
//
// What bounds it: each Adam step runs the GRU forward over the n steps of
// the series and the reverse recursion back, each a chain of n dependent
// steps, so one row is a chain of steps * 2n dependent GRU steps (18,000
// at n = 60).  A row reads 4n bytes and the 517 initial parameters and
// writes 4, so the kernel is bound by the latency of that chain: inside a
// row the only parallelism is across the 12 units and the two gates.
//
// Design: the critical path of a step, and nothing else on it.
// - Forward step: broadcast h -> Wr . h -> sigmoid -> r * h -> broadcast
//   -> Wc . (r * h) -> tanhf -> h'.  Reverse step: gh -> dac -> broadcast
//   -> Wc^T . dac -> dar -> broadcast -> Wr^T . dar -> gh.
// - One warp per row, one row per block.  Lanes 0-11 (side 0) and 12-23
//   (side 1) both hold the 12 units, lane 12 * side + u unit u: side 0
//   computes the reset gate r, side 1 the update gate z, in the same
//   instructions on other weights, so the two gates cost one gate's time.
//   Lanes 24-31 repeat lanes 0-7 and store nothing.  Every lane of unit u
//   computes c, h' and, in the reverse pass, gh alike, so only z crosses
//   from side 1 (one shuffle, off the path).
// - In the reverse pass side 1 computes Wz^T . daz while side 0 computes
//   Wc^T . dac (one shuffle swaps the two results between the sides, off
//   the path).  h, r * h, z, r and c come from shared memory, where the
//   forward left them.  Each lane owns 18 of the 432 weight-gradient
//   entries: side 0 row u of gWc and gWr[u][0..5], side 1 row u of gWz and
//   gWr[u][6..11].
// - A 12-term sum is one fixed tree of depth 4 (kernels/gru_fit.py::
//   _rowsum): s_k = (p_k + p_{k+4}) + p_{k+8}, then (s_0 + s_1) +
//   (s_2 + s_3), against 11 dependent adds left to right.
// - A step's 12 values reach every lane through shared memory: the owners
//   store them (the forward's h and r * h are stored for the reverse pass
//   anyway), __syncwarp, and every lane reads them back in three 128-bit
//   loads.  On the H100 12 __shfl_sync were ~12% slower (PERF.md): a
//   broadcast issues 12 of them, and one shuffle's latency is about a
//   shared-memory round trip's.
// - Shared memory holds the parameters, both Adam moments and the gradient
//   (517 each), the normalised series, the loss's adjoint per step, and
//   per step h, r * h and (z, r, c) for the reverse pass (~27 KB).  The
//   predictions and their adjoints run after the forward, one time step
//   per lane; Adam runs over the 517 parameters, 17 per lane.
//
// Rounding: every 12-term sum runs in _rowsum's tree, every other sum in
// the plain version's order, and the library is built with -fmad=false, so
// each operation rounds on its own exactly as the plain version's separate
// tensor ops do; the sigmoid is 1 / (1 + expf(-x)) and the tanh tanhf, as
// PyTorch's CUDA kernels compute them (approximate intrinsics would break
// this).  On the same card the two agree bit for bit unless a library
// function (expf, tanhf, powf, sqrtf) differs.  Rows never interact, so a
// row's result is bitwise independent of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kH = 12;
constexpr int kMaxN = 64;
constexpr int kWarp = 32;
// offsets of the flat parameter vector (kernels/gru_fit.py: LAYOUT)
constexpr int kWz = 0, kWr = 144, kWc = 288, kUz = 432, kUr = 444,
              kUc = 456, kBz = 468, kBr = 480, kBc = 492, kWo = 504,
              kBo = 516, kParams = 517;
constexpr unsigned kAll = 0xffffffffu;

// The rows read as float4 come first, each 48 bytes, so all stay 16-byte
// aligned.
struct __align__(16) Row {
  float hs[kMaxN + 1][kH];   // hs[t]: the state before step t
  float rhs[kMaxN][kH];      // r * h of step t
  float4 zrc[kMaxN][kH];     // (z, r, c, -) of step t
  float ex[3][kH];           // reverse-pass broadcasts: dac, daz, dar
  float p[kParams], m[kParams], v[kParams], g[kParams];
  float y[kMaxN];            // normalised series
  float gp[kMaxN];           // d loss / d preds[t]
  float mu, sd;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// v[j] = row[j], j < 12, which the lanes owning them have stored before
// the call
__device__ __forceinline__ void bcast(float (&v)[kH], const float* row) {
  __syncwarp();
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 a = r4[k];
    v[4 * k] = a.x;
    v[4 * k + 1] = a.y;
    v[4 * k + 2] = a.z;
    v[4 * k + 3] = a.w;
  }
}

// sum_j w[j] * v[j] in _rowsum's tree: s_k = (p_k + p_{k+4}) + p_{k+8},
// then (s_0 + s_1) + (s_2 + s_3)
__device__ __forceinline__ float dot(const float (&w)[kH],
                                     const float (&v)[kH]) {
  float s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = w[k] * v[k] + w[k + 4] * v[k + 4];
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = s[k] + w[k + 8] * v[k + 8];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// This lane's weights for unit u on its side (0: r, 1: z).
struct Unit {
  float wg[kH], wc[kH];   // forward: row u of Wr (side 0) or Wz, row u of Wc
  float ta[kH], wrc[kH];  // reverse: column u of Wc (side 0) or Wz, of Wr
  float ug, bg, uc, bc, wo;

  __device__ __forceinline__ void load(const float* p, int u, int side) {
    const int wgate = side ? kWz : kWr;
    const int wt = side ? kWz : kWc;
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      wg[j] = p[wgate + u * kH + j];
      wc[j] = p[kWc + u * kH + j];
      ta[j] = p[wt + j * kH + u];
      wrc[j] = p[kWr + j * kH + u];
    }
    ug = p[(side ? kUz : kUr) + u];
    bg = p[(side ? kBz : kBr) + u];
    uc = p[kUc + u];
    bc = p[kBc + u];
    wo = p[kWo + u];
  }
};

// The GRU over s.y[0..n) from h = 0 (gru_forward); leaves each step's
// state, r * h and gates in shared memory.
__device__ void forward(Row& s, const Unit& w, int n, int u, bool owner) {
  float h = 0.f;
  if (owner) s.hs[0][u] = 0.f;
  for (int t = 0; t < n; ++t) {
    const float x = s.y[t];
    float hv[kH];
    bcast(hv, s.hs[t]);
    float a = dot(w.wg, hv);
    a = a + w.ug * x;
    a = a + w.bg;
    const float g = sigmoid(a);                    // r (side 0) or z
    const float z = __shfl_sync(kAll, g, kH + u);
    const float rh = g * h;                        // r * h on side 0
    if (owner) s.rhs[t][u] = rh;
    float rv[kH];
    bcast(rv, s.rhs[t]);
    float ac = dot(w.wc, rv);
    ac = ac + w.uc * x;
    ac = ac + w.bc;
    const float c = tanhf(ac);
    h = (1.f - z) * h + z * c;
    if (owner) {
      s.zrc[t][u] = make_float4(z, g, c, 0.f);
      s.hs[t + 1][u] = h;
    }
  }
}

// preds[t] = wo . hs[t+1] + bo, one t per lane
__device__ __forceinline__ float pred_at(const Row& s, int t) {
  float hv[kH], wo[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    hv[j] = s.hs[t + 1][j];
    wo[j] = s.p[kWo + j];
  }
  return dot(wo, hv) + s.p[kBo];
}

// The loss's gradient into s.g by the reverse recursion (gru_grad_manual).
__device__ void backward(Row& s, const Unit& w, int n, int u, int side,
                         int lane) {
  constexpr int kHalf = kH / 2;
  float ga[kH], gr[kHalf];  // row u of gWc (side 0) or gWz; half of gWr's
#pragma unroll
  for (int j = 0; j < kH; ++j) ga[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) gr[j] = 0.f;
  float gua = 0.f, gba = 0.f, gur = 0.f, gbr = 0.f;
  float gwo = 0.f, gbo = 0.f, gh = 0.f;
  // the right-hand vector of this side's gate gradient: r * h or h
  const float* va_rows = side ? &s.hs[0][0] : &s.rhs[0][0];
  float h1 = s.hs[n][u];
  for (int t = n - 1; t >= 0; --t) {
    const float gp = s.gp[t];
    const float x = s.y[t];
    gwo = gwo + gp * h1;
    gbo = gbo + gp;
    gh = gh + gp * w.wo;
    const float h = s.hs[t][u];
    const float4 zrc = s.zrc[t][u];
    const float z = zrc.x, r = zrc.y, c = zrc.z;
    const float dz = gh * (c - h);
    const float dc = gh * z;
    float dh = gh * (1.f - z);
    const float dac = dc * (1.f - c * c);
    const float daz = dz * (z * (1.f - z));
    const float a = side ? daz : dac;
    if (lane < 2 * kH) s.ex[side][u] = a;
    float av[kH];
    bcast(av, s.ex[side]);
    const float d1 = dot(w.ta, av);   // Wc^T dac (side 0) or Wz^T daz
    const float other = __shfl_sync(kAll, d1, side ? u : kH + u);
    const float dar = (d1 * h) * (r * (1.f - r));   // right on side 0
    if (lane < kH) s.ex[2][u] = dar;
    float dv[kH];
    bcast(dv, s.ex[2]);
    const float drh = side ? other : d1;
    dh = dh + drh * r;
    dh = dh + (side ? d1 : other);
    dh = dh + dot(w.wrc, dv);
    gh = dh;

    // the gradients, off the path
    const float dar_u = __shfl_sync(kAll, dar, u);
    const float4* va4 = reinterpret_cast<const float4*>(va_rows + t * kH);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 q = va4[k];
      ga[4 * k] = ga[4 * k] + a * q.x;
      ga[4 * k + 1] = ga[4 * k + 1] + a * q.y;
      ga[4 * k + 2] = ga[4 * k + 2] + a * q.z;
      ga[4 * k + 3] = ga[4 * k + 3] + a * q.w;
    }
    const float* hb = &s.hs[t][kHalf * side];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) gr[j] = gr[j] + dar_u * hb[j];
    gua = gua + a * x;
    gba = gba + a;
    gur = gur + dar_u * x;
    gbr = gbr + dar_u;
    h1 = h;
  }
  if (lane < kH) {
#pragma unroll
    for (int j = 0; j < kH; ++j) s.g[kWc + u * kH + j] = ga[j];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) s.g[kWr + u * kH + j] = gr[j];
    s.g[kUc + u] = gua;
    s.g[kBc + u] = gba;
    s.g[kUr + u] = gur;
    s.g[kBr + u] = gbr;
    s.g[kWo + u] = gwo;
  } else if (lane < 2 * kH) {
#pragma unroll
    for (int j = 0; j < kH; ++j) s.g[kWz + u * kH + j] = ga[j];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) s.g[kWr + u * kH + kHalf + j] = gr[j];
    s.g[kUz + u] = gua;
    s.g[kBz + u] = gba;
  }
  if (lane == 0) s.g[kBo] = gbo;
}

__global__ void __launch_bounds__(kWarp)
gru_fit_kernel(const float* __restrict__ y, const float* __restrict__ p0,
               float* __restrict__ out, int n, int steps, float lr) {
  __shared__ Row s;
  const int lane = threadIdx.x;
  const int u = lane % kH;
  const int side = (lane / kH) & 1;
  const bool owner = lane < kH;
  const float* yr = y + static_cast<long long>(blockIdx.x) * n;

  for (int k = lane; k < kParams; k += kWarp) {
    s.p[k] = p0[k];
    s.m[k] = 0.f;
    s.v[k] = 0.f;
  }
  // normalise (kernels/arima_bank.py: _prepare with d = 0): sums left to
  // right
  if (lane == 0) {
    const float nf = static_cast<float>(n);
    float sum = yr[0];
    for (int i = 1; i < n; ++i) sum = sum + yr[i];
    const float mu = sum / nf;
    float ss = (yr[0] - mu) * (yr[0] - mu);
    for (int i = 1; i < n; ++i) ss = ss + (yr[i] - mu) * (yr[i] - mu);
    float sd = sqrtf(ss / nf);
    sd = sd < 1e-8f ? 1e-8f : sd;  // torch.clamp(min=1e-8): NaN stays NaN
    s.mu = mu;
    s.sd = sd;
  }
  __syncwarp();
  for (int t = lane; t < n; t += kWarp) s.y[t] = (yr[t] - s.mu) / s.sd;
  __syncwarp();

  // 2 / (n - 1) rounded once from double, as a Python float scalar is
  const float scale = static_cast<float>(2.0 / (n - 1));
  Unit w;
  for (int it = 0; it < steps; ++it) {
    w.load(s.p, u, side);
    forward(s, w, n, u, owner);
    __syncwarp();
    for (int t = lane; t < n; t += kWarp)
      s.gp[t] = t < n - 1 ? scale * (pred_at(s, t) - s.y[t + 1]) : 0.f;
    __syncwarp();
    backward(s, w, n, u, side, lane);
    __syncwarp();
    // Adam (float32 step counter), 17 parameters per lane
    const float step = static_cast<float>(it + 1);
    const float bc1 = 1.f - powf(0.9f, step);
    const float bc2 = 1.f - powf(0.999f, step);
    for (int k = lane; k < kParams; k += kWarp) {
      const float g = s.g[k];
      const float m = 0.9f * s.m[k] + 0.1f * g;
      const float v = 0.999f * s.v[k] + 0.001f * g * g;
      s.m[k] = m;
      s.v[k] = v;
      const float mh = m / bc1;
      const float vh = v / bc2;
      s.p[k] = s.p[k] - lr * mh / (sqrtf(vh) + 1e-8f);
    }
    __syncwarp();
  }
  w.load(s.p, u, side);
  forward(s, w, n, u, owner);
  __syncwarp();
  if (lane == 0) out[blockIdx.x] = pred_at(s, n - 1) * s.sd + s.mu;
}

}  // namespace

// y [rows, n] float32, p0 [517] float32 (the same initial parameters for
// every row), out [rows].  Returns a CUDA error code (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int gru_fit_launch(const float* y, const float* p0, float* out,
                              int rows, int n, int steps, float lr,
                              void* stream) {
  if (rows < 1 || n < 2 || n > kMaxN || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gru_fit_kernel<<<rows, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      y, p0, out, n, steps, lr);
  return static_cast<int>(cudaGetLastError());
}
