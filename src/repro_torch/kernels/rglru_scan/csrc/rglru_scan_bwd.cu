// Backward of K3's gated route (the RG-LRU scan) for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces no TPU kernel of its own: the JAX package takes the gradient of
// its `rglru_scan` (src/repro/models/rglru.py, an associative scan over the
// gates of `_gates`) from XLA's autodiff. This kernel is the reverse of
// `faillite_rglru_gated_scan` in rglru_scan.cu, whose TPU counterpart is
// `_rglru_kernel` in src/repro/kernels/rglru_scan/rglru_scan.py. With
//   r = sigmoid(ga), i = sigmoid(gx), log_a = (-8 softplus(L)) r,
//   a = exp(log_a), mult = sqrt(max(1 - exp(2 log_a), 1e-12)),
//   b = mult i x,  h_t = a_t h_{t-1} + b_t  (h_{-1} = h0),
// and the gradients dh of h and dh_last of the last state, it computes the
// adjoint g_t = dh_t + a_{t+1} g_{t+1} (g_{S-1} = dh_{S-1} + dh_last) and
//   da_t = g_t h_{t-1}, db_t = g_t, dh0 = a_0 g_0,
//   dlog_a = da a + db i x dmult,  dmult = -exp(2 log_a) / mult where the
//   clamp is not active and 0 where it is (torch.clamp's and jnp.maximum's
//   gradient off a tie),
//   dga = dlog_a (-8 softplus(L)) r (1 - r), dgx = db mult x i (1 - i),
//   dxb = db mult i, dL = -8 sigmoid(L) sum_{b,t} dlog_a r,
// the plain version being `rglru_gated_scan_bwd_ref` in ../ref.py.
//
// Layout: ga, gx, xb as the forward reads them ((B, S, W) of the model
// dtype, f32 or bf16, batch and sequence strides, unit width stride); h and
// dh (B, S, W) fp32 contiguous; h0, dh_last, dh0 (B, W) fp32 contiguous;
// dga, dgx, dxb (B, S, W) contiguous in the model dtype; log_lambda and
// dlog_lambda (W,) fp32; `part` (B, W) fp32 scratch.
//
// Design: the forward's chunked scan run in reverse. `rglru_bwd_kernel`
// gives a block CH = 8 channels of one row and cuts the sequence into the
// forward's NC = 32 chunks of L = ceil(S / 32) steps, a thread each. Pass 1:
// each thread scans its chunk's adjoint from the right with a zero carry
// to (P, H) = (prod a, a_{t0} g_{t0}). The threads of chunk 0 combine the
// carries from the last chunk back to the first in shared memory
// (C_{k-1} = P_k C_k + H_k, from dh_last), which gives dh0. Pass 2: each
// chunk rescans from its carry, recomputing a and b from (ga, gx, xb,
// log_lambda) in registers as the forward does, reads h_{t-1} from the
// forward's output, and writes dga, dgx and dxb. Each thread sums its
// dlog_a r; a block sums its chunks in chunk order into `part`, and
// `rglru_bwd_lambda_kernel` sums `part` over the rows in row order: no
// atomics, so two launches give the same bits. Loads are issued U steps at
// a time before their arithmetic.
//
// What bounds it on the H100: about 80 operations per element (the gates
// recomputed, their derivatives) against 32 bytes moved in f32 (ga, gx, xb,
// h, dh read, dga, dgx, dxb written), so bytes over the memory rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CH = 8;          // channels a block, as the forward
constexpr int NC = 32;         // chunks of the sequence, as the forward
constexpr int NT = CH * NC;    // threads a block
constexpr int U = 8;           // steps whose loads are issued together
constexpr int LAM_NT = 256;    // threads a block of the dlog_lambda sum

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// F.softplus with beta 1 and threshold 20
__device__ __forceinline__ float softplus_f(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <typename T>
struct Args {
  const T* ga;
  const T* gx;
  const T* xb;
  const float* log_lambda;
  const float* h0;
  const float* h;
  const float* dh;
  const float* dh_last;
  T* dga;
  T* dgx;
  T* dxb;
  float* dh0;
  float* part;
  long long gasb, gass, gxsb, gxss, xbsb, xbss;
};

// a_t of one step, as the forward's gate computes it
__device__ __forceinline__ float decay(float c, float ga) {
  return expf(__fmul_rn(c, sigmoid_f(ga)));
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_bwd_kernel(Args<T> p, int S, int W) {
  __shared__ float sP[NC][CH], sH[NC][CH];
  const int c = threadIdx.x % CH, chunk = threadIdx.x / CH;
  const int w = blockIdx.x * CH + c, bb = blockIdx.y;
  const bool on = w < W;
  const int L = (S + NC - 1) / NC;
  const int t0 = min(S, chunk * L), t1 = on ? min(S, t0 + L) : t0;
  const int wc = on ? w : 0;
  const T* ga = p.ga + bb * p.gasb + wc;
  const T* gx = p.gx + bb * p.gxsb + wc;
  const T* xb = p.xb + bb * p.xbsb + wc;
  const long long row = (long long)bb * S * W + wc;
  const float* dh = p.dh + row;
  const float* h = p.h + row;
  const float cw = __fmul_rn(-8.f, softplus_f(p.log_lambda[wc]));

  // pass 1: the chunk's adjoint from a zero carry, right to left
  float P = 1.f, H = 0.f;
  for (int ge = t1; ge > t0; ge -= U) {
    float gr[U], dr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = ge - 1 - u;
      if (t >= t0) {
        gr[u] = to_f<T>(ga[(long long)t * p.gass]);
        dr[u] = dh[(long long)t * W];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ge - 1 - u >= t0) {
        const float a = decay(cw, gr[u]);
        H = __fmul_rn(a, __fadd_rn(dr[u], H));
        P = __fmul_rn(P, a);
      }
    }
  }
  sP[chunk][c] = P;
  sH[chunk][c] = H;
  __syncthreads();
  if (chunk == 0) {
    // the carry into each chunk from the right, last chunk first
    float carry = on ? p.dh_last[bb * W + w] : 0.f;
    for (int k = NC - 1; k >= 0; --k) {
      const float pk = sP[k][c], hk = sH[k][c];
      sH[k][c] = carry;
      carry = fmaf(pk, carry, hk);
    }
    if (on) p.dh0[bb * W + w] = carry;
  }
  __syncthreads();

  // pass 2: rescan from the carry, the gradients of every step
  float x = sH[chunk][c];
  float lam = 0.f;  // sum of dlog_a r over the chunk
  for (int ge = t1; ge > t0; ge -= U) {
    T gar[U], gxr[U], xbr[U];
    float dr[U], hp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = ge - 1 - u;
      if (t >= t0) {
        gar[u] = ga[t * p.gass];
        gxr[u] = gx[t * p.gxss];
        xbr[u] = xb[t * p.xbss];
        dr[u] = dh[t * W];
        hp[u] = t > 0 ? h[(t - 1) * W] : p.h0[bb * W + wc];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = ge - 1 - u;
      if (t >= t0) {
        const float r = sigmoid_f(to_f<T>(gar[u]));
        const float i = sigmoid_f(to_f<T>(gxr[u]));
        const float xv = to_f<T>(xbr[u]);
        const float log_a = __fmul_rn(cw, r);
        const float a = expf(log_a);
        const float e2 = expf(__fmul_rn(2.f, log_a));
        const float one_m = __fsub_rn(1.f, e2);
        const float m = __fsqrt_rn(fmaxf(one_m, 1e-12f));
        const float g = __fadd_rn(dr[u], x);
        x = __fmul_rn(a, g);
        const float dm = one_m > 1e-12f ? __fdiv_rn(-e2, m) : 0.f;
        const float gi = __fmul_rn(g, i);
        const float dlog_a = fmaf(__fmul_rn(g, hp[u]), a,
                                  __fmul_rn(__fmul_rn(gi, xv), dm));
        lam = fmaf(dlog_a, r, lam);
        const long long o = (long long)bb * S * W + t * W + w;
        p.dga[o] = from_f<T>(__fmul_rn(__fmul_rn(__fmul_rn(dlog_a, cw), r),
                                       __fsub_rn(1.f, r)));
        p.dgx[o] = from_f<T>(__fmul_rn(
            __fmul_rn(__fmul_rn(__fmul_rn(g, m), xv), i), __fsub_rn(1.f, i)));
        p.dxb[o] = from_f<T>(__fmul_rn(__fmul_rn(g, m), i));
      }
    }
  }
  sP[chunk][c] = lam;  // chunk 0 read sP before the last barrier
  __syncthreads();
  if (chunk == 0 && on) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) s += sP[k][c];
    p.part[bb * W + w] = s;
  }
}

// dlog_lambda[w] = -8 sigmoid(L_w) sum_b part[b][w], the rows in order
__global__ void __launch_bounds__(LAM_NT)
rglru_bwd_lambda_kernel(const float* __restrict__ part,
                        const float* __restrict__ log_lambda,
                        float* __restrict__ dlog_lambda, int B, int W) {
  const int w = blockIdx.x * LAM_NT + threadIdx.x;
  if (w >= W) return;
  float s = 0.f;
  for (int bb = 0; bb < B; ++bb) s += part[(long long)bb * W + w];
  dlog_lambda[w] = __fmul_rn(__fmul_rn(s, -8.f), sigmoid_f(log_lambda[w]));
}

template <typename T>
cudaError_t launch(const Args<T>& a, float* dlog_lambda, int B, int S, int W,
                   cudaStream_t stream) {
  rglru_bwd_kernel<T><<<dim3((W + CH - 1) / CH, B), NT, 0, stream>>>(a, S, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_lambda_kernel<<<(W + LAM_NT - 1) / LAM_NT, LAM_NT, 0, stream>>>(
      a.part, a.log_lambda, dlog_lambda, B, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* ga, const void* gx, const void* xb,
                const float* log_lambda, const float* h0, const float* h,
                const float* dh, const float* dh_last, void* dga, void* dgx,
                void* dxb, float* dlog_lambda, float* dh0, float* part, int B,
                int S, int W, long long gasb, long long gass, long long gxsb,
                long long gxss, long long xbsb, long long xbss,
                cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(ga), static_cast<const T*>(gx),
                  static_cast<const T*>(xb), log_lambda, h0, h, dh, dh_last,
                  static_cast<T*>(dga), static_cast<T*>(dgx),
                  static_cast<T*>(dxb), dh0, part, gasb, gass, gxsb, gxss,
                  xbsb, xbss};
  return launch(a, dlog_lambda, B, S, W, stream);
}

}  // namespace

// dtype (of ga, gx, xb and of dga, dgx, dxb): 0 = float32, 1 = bfloat16.
// Strides of ga, gx, xb in elements; every other tensor contiguous as the
// header says; `part` (B, W) fp32 scratch. Two launches on `stream`;
// returns the first cudaError_t (0 on success); never synchronizes.
extern "C" int faillite_rglru_gated_scan_bwd(
    const void* ga, const void* gx, const void* xb, const void* log_lambda,
    const void* h0, const void* h, const void* dh, const void* dh_last,
    void* dga, void* dgx, void* dxb, void* dlog_lambda, void* dh0, void* part,
    int dtype, int B, int S, int W, long long gasb, long long gass,
    long long gxsb, long long gxss, long long xbsb, long long xbss,
    void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lam = static_cast<const float*>(log_lambda);
  const float* h0f = static_cast<const float*>(h0);
  const float* hf = static_cast<const float*>(h);
  const float* dhf = static_cast<const float*>(dh);
  const float* dlf = static_cast<const float*>(dh_last);
  float* dlam = static_cast<float*>(dlog_lambda);
  float* dh0f = static_cast<float*>(dh0);
  float* pf = static_cast<float*>(part);
  if (dtype == 0)
    return (int)run<float>(ga, gx, xb, lam, h0f, hf, dhf, dlf, dga, dgx, dxb,
                           dlam, dh0f, pf, B, S, W, gasb, gass, gxsb, gxss,
                           xbsb, xbss, st);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(ga, gx, xb, lam, h0f, hf, dhf, dlf, dga,
                                   dgx, dxb, dlam, dh0f, pf, B, S, W, gasb,
                                   gass, gxsb, gxss, xbsb, xbss, st);
  return (int)cudaErrorInvalidValue;
}
