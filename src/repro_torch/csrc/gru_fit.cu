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
// writes 4, so the kernel is bound by that chain's latency: inside a row
// the only parallelism is across the 12 units.
//
// Design.
// - One warp per row, one row per block.  Lane u < 12 owns unit u: the
//   rows u of Wz, Wr and Wc (the forward's products) and their columns u
//   (the reverse recursion's transposed products) in registers, and row u
//   of each weight gradient.  A step's 12-term sums read the other units'
//   values by __shfl_sync, all 32 lanes taking part (lanes 12..31 compute
//   on unit 11's copy and store nothing).
// - Shared memory holds the parameters, both Adam moments and the gradient
//   (517 each), the normalised series, the loss's adjoint per step, and the
//   forward's h, z, r and c per step for the reverse pass (~21 KB).
// - The predictions and their adjoints run after the forward, one time
//   step per lane; Adam runs over the 517 parameters, 17 per lane.
//
// Rounding: every sum runs left to right (all products, then the adds in
// index order), and the library is built with -fmad=false, so each
// operation rounds on its own exactly as the plain version's separate
// tensor ops do; the sigmoid is 1 / (1 + expf(-x)) and the tanh tanhf, as
// PyTorch's CUDA kernels compute them.  On the same card the two agree bit
// for bit unless a library function (expf, tanhf, powf, sqrtf) differs.
// Rows never interact, so a row's result is bitwise independent of the
// launch.

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

struct Row {
  float p[kParams], m[kParams], v[kParams], g[kParams];
  float y[kMaxN];            // normalised series
  float gp[kMaxN];           // d loss / d preds[t]
  float hs[kMaxN + 1][kH];   // hs[t]: the state before step t
  float zs[kMaxN][kH], rs[kMaxN][kH], cs[kMaxN][kH];
  float mu, sd;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// every lane's copy of lane j's value, j = 0 .. 11
__device__ __forceinline__ void gather(float (&out)[kH], float mine) {
#pragma unroll
  for (int j = 0; j < kH; ++j) out[j] = __shfl_sync(kAll, mine, j);
}

// sum_j w[j] * v[j], left to right
__device__ __forceinline__ float dot(const float (&w)[kH],
                                     const float (&v)[kH]) {
  float s = w[0] * v[0];
#pragma unroll
  for (int j = 1; j < kH; ++j) s = s + w[j] * v[j];
  return s;
}

// This lane's unit's weights: rows (forward) and columns (reverse) of the
// three gate matrices, the input and bias terms and its output weight.
struct Unit {
  float wz[kH], wr[kH], wc[kH];     // row u
  float wzc[kH], wrc[kH], wcc[kH];  // column u
  float uz, ur, uc, bz, br, bc, wo;

  __device__ __forceinline__ void load(const float* p, int u) {
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      wz[j] = p[kWz + u * kH + j];
      wr[j] = p[kWr + u * kH + j];
      wc[j] = p[kWc + u * kH + j];
      wzc[j] = p[kWz + j * kH + u];
      wrc[j] = p[kWr + j * kH + u];
      wcc[j] = p[kWc + j * kH + u];
    }
    uz = p[kUz + u];
    ur = p[kUr + u];
    uc = p[kUc + u];
    bz = p[kBz + u];
    br = p[kBr + u];
    bc = p[kBc + u];
    wo = p[kWo + u];
  }
};

// The GRU over s.y[0..n) from h = 0 (gru_forward); keeps each step's
// state and gates.
__device__ void forward(Row& s, const Unit& w, int n, int u, bool owner) {
  float h = 0.f;
  for (int t = 0; t < n; ++t) {
    const float x = s.y[t];
    float hj[kH];
    gather(hj, h);
    float az = dot(w.wz, hj);
    float ar = dot(w.wr, hj);
    az = az + w.uz * x;
    ar = ar + w.ur * x;
    az = az + w.bz;
    ar = ar + w.br;
    const float z = sigmoid(az);
    const float r = sigmoid(ar);
    float rhj[kH];
    gather(rhj, r * h);
    float ac = dot(w.wc, rhj);
    ac = ac + w.uc * x;
    ac = ac + w.bc;
    const float c = tanhf(ac);
    if (owner) {
      s.hs[t][u] = h;
      s.zs[t][u] = z;
      s.rs[t][u] = r;
      s.cs[t][u] = c;
    }
    h = (1.f - z) * h + z * c;
  }
  if (owner) s.hs[n][u] = h;
}

// preds[t] = wo . hs[t+1] + bo (left to right), one t per lane
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
__device__ void backward(Row& s, const Unit& w, int n, int u, bool owner,
                         int lane) {
  float gwz[kH], gwr[kH], gwc[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j) gwz[j] = gwr[j] = gwc[j] = 0.f;
  float guz = 0.f, gur = 0.f, guc = 0.f, gbz = 0.f, gbr = 0.f, gbc = 0.f;
  float gwo = 0.f, gbo = 0.f, gh = 0.f;
  for (int t = n - 1; t >= 0; --t) {
    const float gp = s.gp[t];
    const float x = s.y[t];
    gwo = gwo + gp * s.hs[t + 1][u];
    gbo = gbo + gp;
    gh = gh + gp * w.wo;
    const float h = s.hs[t][u], z = s.zs[t][u], r = s.rs[t][u],
                c = s.cs[t][u];
    const float dz = gh * (c - h);
    const float dc = gh * z;
    float dh = gh * (1.f - z);
    const float dac = dc * (1.f - c * c);
    const float daz = dz * (z * (1.f - z));
    float rhj[kH], dacs[kH];
    gather(rhj, r * h);
    gather(dacs, dac);
#pragma unroll
    for (int j = 0; j < kH; ++j) gwc[j] = gwc[j] + dac * rhj[j];
    guc = guc + dac * x;
    gbc = gbc + dac;
    const float drh = dot(w.wcc, dacs);
    const float dr = drh * h;
    dh = dh + drh * r;
    const float dar = dr * (r * (1.f - r));
    float hj[kH], dazs[kH], dars[kH];
    gather(hj, h);
    gather(dazs, daz);
    gather(dars, dar);
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      gwz[j] = gwz[j] + daz * hj[j];
      gwr[j] = gwr[j] + dar * hj[j];
    }
    guz = guz + daz * x;
    gbz = gbz + daz;
    gur = gur + dar * x;
    gbr = gbr + dar;
    dh = dh + dot(w.wzc, dazs);
    dh = dh + dot(w.wrc, dars);
    gh = dh;
  }
  if (owner) {
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      s.g[kWz + u * kH + j] = gwz[j];
      s.g[kWr + u * kH + j] = gwr[j];
      s.g[kWc + u * kH + j] = gwc[j];
    }
    s.g[kUz + u] = guz;
    s.g[kUr + u] = gur;
    s.g[kUc + u] = guc;
    s.g[kBz + u] = gbz;
    s.g[kBr + u] = gbr;
    s.g[kBc + u] = gbc;
    s.g[kWo + u] = gwo;
  }
  if (lane == 0) s.g[kBo] = gbo;
}

__global__ void __launch_bounds__(kWarp)
gru_fit_kernel(const float* __restrict__ y, const float* __restrict__ p0,
               float* __restrict__ out, int n, int steps, float lr) {
  __shared__ Row s;
  const int lane = threadIdx.x;
  const int u = lane < kH ? lane : kH - 1;
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
    w.load(s.p, u);
    forward(s, w, n, u, owner);
    __syncwarp();
    for (int t = lane; t < n; t += kWarp)
      s.gp[t] = t < n - 1 ? scale * (pred_at(s, t) - s.y[t + 1]) : 0.f;
    __syncwarp();
    backward(s, w, n, u, owner, lane);
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
  w.load(s.p, u);
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
