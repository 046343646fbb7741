// Latency probe for the GRU fit kernel's chain bound (K4, gru_fit.cu).
//
// One warp times dependent chains of the operations that make up a GRU
// step's critical path in gru_fit.cu (its header lists the path), in SM
// cycles per operation.  chip_smoke.py builds it with the fit's flags
// (-fmad=false), launches it once and turns the cycles into the fit's
// chain-latency bound; nothing in the package builds or calls it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;

// the fit's sigmoid (gru_fit.cu)
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

constexpr int kProbeOps = 512;
constexpr int kProbes = 7;

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// keeps the chain on v between the two clock reads around it
__device__ __forceinline__ void pin(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// One warp times dependent chains of kProbeOps operations (clock64) and
// writes SM cycles per operation to cycles[0..kProbes): an add, a
// multiply, a __shfl_sync, the shared-memory broadcast (a store,
// __syncwarp, a 128-bit load of it), the sigmoid as the fit computes it,
// and tanhf then a multiply at |x| ~ 3 and at |x| < 0.5 (tanhf's two
// ranges).  in[0..3] = (1e-7, 1.0000001, 3, 0.9) keep the compiler from
// folding the chains.
__global__ void gru_latency_probe(const float* __restrict__ in,
                                  float* __restrict__ cycles,
                                  float* __restrict__ sink) {
  __shared__ __align__(16) float buf[2][kWarp];
  const int lane = threadIdx.x;
  const int next = (lane + 1) % kWarp;
  const float add = in[0], mul = in[1], big = in[2], small = in[3];
  long long t[kProbes + 1];
  float v = 0.5f + lane * 1e-3f, acc = 0.f;
  for (int k = 0; k < kProbes; ++k) {
    if (k == 4) v = 0.5f + lane * 1e-3f;
    if (k == 6) v = 0.4f;
    pin(v);
    t[k] = clock_now();
    pin(v);
    switch (k) {
      case 0:
#pragma unroll 8
        for (int i = 0; i < kProbeOps; ++i) v = v + add;
        break;
      case 1:
#pragma unroll 8
        for (int i = 0; i < kProbeOps; ++i) v = v * mul;
        break;
      case 2:
#pragma unroll 8
        for (int i = 0; i < kProbeOps; ++i) v = __shfl_sync(kAll, v, next);
        break;
      case 3:
        // two buffers in turn: a store never meets the last round's loads
#pragma unroll 2
        for (int i = 0; i < kProbeOps; ++i) {
          buf[i & 1][lane] = v;
          __syncwarp();
          v = reinterpret_cast<const float4*>(buf[i & 1])[0].y;
        }
        break;
      case 4:
#pragma unroll 8
        for (int i = 0; i < kProbeOps; ++i) v = sigmoid(v);
        break;
      case 5:
#pragma unroll 8
        for (int i = 0; i < kProbeOps; ++i) v = tanhf(v) * big;
        break;
      default:
#pragma unroll 8
        for (int i = 0; i < kProbeOps; ++i) v = tanhf(v) * small;
        break;
    }
    pin(v);
    t[k + 1] = clock_now();
    acc = acc + v;
  }
  if (lane == 0)
    for (int k = 0; k < kProbes; ++k)
      cycles[k] = static_cast<float>(t[k + 1] - t[k]) / kProbeOps;
  sink[lane] = acc;
}

}  // namespace

// in [4], cycles [7], sink [32] float32 on the card (gru_latency_probe).
extern "C" int gru_latency_probe_launch(const float* in, float* cycles,
                                        float* sink, void* stream) {
  gru_latency_probe<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      in, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}
