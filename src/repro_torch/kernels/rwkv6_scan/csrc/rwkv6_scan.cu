// RWKV-6 WKV recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_wkv_kernel` in
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py (launched from `wkv6_pallas`).
// Per (batch row, head), with an (hs x hs) fp32 state S from s0:
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,        w_t = exp(lw_t).
// This is the recurrence the model's `wkv_scan` states. The TPU kernel
// computes the chunk-parallel form from a zero state and clamps
// lw >= -40/chunk so that its exp(-cum) factors stay finite; the recurrence
// has no such exponent, so this kernel takes lw as it is (no clamp) and
// starts from the slot's state.
//
// Layout: r, k, v (B, S, nh, hs) in the activation dtype (fp32 or bf16)
// and lw (B, S, nh, hs) fp32, read through batch/sequence/head element
// strides with a unit last stride (the model's layout, no transpose);
// u (nh, hs) fp32; s0 and s_out (B, nh, hs, hs) fp32 with each (b, h) block
// contiguous; y (B, S, nh, hs) fp32. s_out may alias s0: thread j reads
// column j of its block before it writes the same column.
//
// Design. One block of hs threads serves one (batch row, head); thread j
// keeps column j of the state in registers (hs floats), so the state never
// leaves the SM between steps. The block stages CT steps of r, k and
// w = exp(lw) (and v) in shared memory at a time, each thread issuing all
// of its loads for the CT steps before it stores any. Then each step is hs
// fused multiply-adds per thread with broadcast shared-memory reads. The
// same kernel serves the prefill and the decode step (S = 1).
//
// What bounds it on the H100: about 7 hs^2 flops per (b, h, t) on 4 hs
// values read and hs written, so at hs = 64 the work is ~28 flops a byte:
// fp32 operations outside the tensor cores bound it. Known weak points:
// 40 blocks at B = 1 (40 heads) on 132 SMs, and no tensor cores. The chunked
// form on mma/wgmma (intra-chunk products as matrix products) is the later
// step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CT = 16;  // time steps staged per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {
  long long b, s, h;
};

template <typename T, int HS>
__global__ void __launch_bounds__(HS)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, const float* s0,
           float* __restrict__ y, float* s_out, int S, Strides rs, Strides ks,
           Strides vs, Strides ws, Strides ys, long long s0b, long long s0h,
           long long sob, long long soh) {
  __shared__ float sr[CT][HS], sk[CT][HS], sw[CT][HS], sv[CT][HS], su[HS];
  const int j = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;

  float st[HS];  // st[i] = S[i][j]
  const float* s0p = s0 + b * s0b + h * s0h;
#pragma unroll
  for (int i = 0; i < HS; ++i) st[i] = s0p[i * HS + j];
  su[j] = u[h * HS + j];

  const T* rp = r + b * rs.b + h * rs.h + j;
  const T* kp = k + b * ks.b + h * ks.h + j;
  const T* vp = v + b * vs.b + h * vs.h + j;
  const float* wp = lw + b * ws.b + h * ws.h + j;
  float* yp = y + b * ys.b + h * ys.h + j;

  for (int t0 = 0; t0 < S; t0 += CT) {
    const int n = min(CT, S - t0);
    float cr[CT], ck[CT], cw[CT], cv[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < n) {
        const long long t = t0 + c;
        cr[c] = to_f(rp[t * rs.s]);
        ck[c] = to_f(kp[t * ks.s]);
        cv[c] = to_f(vp[t * vs.s]);
        cw[c] = wp[t * ws.s];
      }
    }
    __syncthreads();  // the previous pass's shared reads are done
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < n) {
        sr[c][j] = cr[c];
        sk[c][j] = ck[c];
        sw[c][j] = expf(cw[c]);
        sv[c][j] = cv[c];
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float yj = 0.f;
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const float kv = sk[c][i] * vj;
        yj = fmaf(sr[c][i], fmaf(su[i], kv, st[i]), yj);
        st[i] = fmaf(sw[c][i], st[i], kv);
      }
      yp[(long long)(t0 + c) * ys.s] = yj;
    }
  }

  float* sop = s_out + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < HS; ++i) sop[i * HS + j] = st[i];
}

template <typename T, int HS>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* lw, const float* u, const float* s0, float* y,
                   float* s_out, int B, int NH, int S, Strides rs, Strides ks,
                   Strides vs, Strides ws, Strides ys, long long s0b,
                   long long s0h, long long sob, long long soh,
                   cudaStream_t stream) {
  dim3 grid(NH, B);
  wkv_kernel<T, HS><<<grid, HS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, s0, y, s_out, S, rs, ks, vs, ws, ys,
      s0b, s0h, sob, soh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hs(int hs, const void* r, const void* k, const void* v,
                        const float* lw, const float* u, const float* s0,
                        float* y, float* s_out, int B, int NH, int S,
                        Strides rs, Strides ks, Strides vs, Strides ws,
                        Strides ys, long long s0b, long long s0h,
                        long long sob, long long soh, cudaStream_t stream) {
  switch (hs) {
    case 8:
      return launch<T, 8>(r, k, v, lw, u, s0, y, s_out, B, NH, S, rs, ks, vs,
                          ws, ys, s0b, s0h, sob, soh, stream);
    case 16:
      return launch<T, 16>(r, k, v, lw, u, s0, y, s_out, B, NH, S, rs, ks, vs,
                           ws, ys, s0b, s0h, sob, soh, stream);
    case 32:
      return launch<T, 32>(r, k, v, lw, u, s0, y, s_out, B, NH, S, rs, ks, vs,
                           ws, ys, s0b, s0h, sob, soh, stream);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s0, y, s_out, B, NH, S, rs, ks, vs,
                           ws, ys, s0b, s0h, sob, soh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16. Strides are in elements:
// (batch, sequence, head) for r, k, v, lw and y; (batch, head) for s0 and
// s_out. Returns the cudaError_t of the launch (0 on success); never
// synchronizes.
extern "C" int faillite_wkv6(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* y, void* s_out, int dtype, int B,
    int NH, int S, int hs, long long rsb, long long rss, long long rsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long wsb, long long wss, long long wsh, long long ysb,
    long long yss, long long ysh, long long s0b, long long s0h, long long sob,
    long long soh, void* stream) {
  if (B <= 0 || NH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Strides rs{rsb, rss, rsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ws{wsb, wss, wsh}, ys{ysb, yss, ysh};
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sof = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hs<float>(hs, r, k, v, lwf, uf, s0f, yf, sof, B, NH,
                                   S, rs, ks, vs, ws, ys, s0b, s0h, sob, soh,
                                   st);
  if (dtype == 1)
    return (int)dispatch_hs<__nv_bfloat16>(hs, r, k, v, lwf, uf, s0f, yf, sof,
                                           B, NH, S, rs, ks, vs, ws, ys, s0b,
                                           s0h, sob, soh, st);
  return (int)cudaErrorInvalidValue;
}
