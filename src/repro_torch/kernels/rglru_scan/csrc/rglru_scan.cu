// RG-LRU linear scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_rglru_kernel` in
// src/repro/kernels/rglru_scan/rglru_scan.py (launched from
// `rglru_scan_pallas`). Computes, elementwise over the width,
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0,
// and returns every h_t and the last one.
//
// Layout: a, b, h (B, S, W) fp32 with a unit width stride (the model's
// layout, no transpose); h0 and h_last (B, W) fp32 read and written through
// a batch stride. h_last may alias h0 (the slot's "h" state): each thread
// reads its own h0 value before it writes the same h_last value.
//
// Design. The TPU walks sequence blocks as the last, sequential grid axis
// and carries h across grid steps in VMEM scratch. Here one thread owns one
// (batch row, channel) and walks the whole sequence with h in a register,
// h = fmaf(a, h, b). Neighbouring threads own neighbouring channels, so
// every load and store is coalesced across the width. Each thread issues
// the loads of U time steps before it uses any of them, so a group of U
// steps costs about one memory latency instead of U. The same kernel serves
// the prefill (S = prompt length) and the decode step (S = 1).
//
// What bounds it on the H100: 2 flops per element against 12 bytes moved
// (a and b read, h written), so the bound is the bytes over the memory
// rate. The known weak point is parallelism: at B = 1 and W = 2560 the grid
// is 20 blocks of 128 threads on 132 SMs, and each thread runs S dependent
// steps, so at long prompts the time is S / U memory latencies, not the
// bytes. A chunked two-pass scan over the sequence (or the gates fused into
// the scan) is the later step.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // threads per block, one channel each
constexpr int U = 16;    // time steps whose loads are in flight together

__global__ void __launch_bounds__(NT)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* h0, float* __restrict__ h, float* h_last, int S,
             int W, long long sb, long long ss, long long h0b,
             long long hlb) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int bb = blockIdx.y;
  if (w >= W) return;
  const long long base = bb * sb + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = h0[bb * h0b + w];
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = __ldg(ap + (t + u) * ss);
      bv[u] = __ldg(bp + (t + u) * ss);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      hv = fmaf(av[u], hv, bv[u]);
      hp[(t + u) * ss] = hv;
    }
  }
  for (; t < S; ++t) {
    hv = fmaf(__ldg(ap + t * ss), hv, __ldg(bp + t * ss));
    hp[t * ss] = hv;
  }
  h_last[bb * hlb + w] = hv;
}

}  // namespace

// a, b, h: (B, S, W) fp32 with strides (sb, ss, 1) in elements; h0, h_last:
// (B, W) fp32 with batch strides h0b, hlb. Returns the cudaError_t of the
// launch (0 on success); never synchronizes.
extern "C" int faillite_rglru_scan(const void* a, const void* b,
                                   const void* h0, void* h, void* h_last,
                                   int B, int S, int W, long long sb,
                                   long long ss, long long h0b,
                                   long long hlb, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W, sb, ss, h0b, hlb);
  return (int)cudaGetLastError();
}
