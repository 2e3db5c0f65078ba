// RG-LRU linear scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_rglru_kernel` in
// src/repro/kernels/rglru_scan/rglru_scan.py (launched from
// `rglru_scan_pallas`). Computes, elementwise over the width,
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0,
// and returns every h_t and the last one. Two routes share one design:
//
//  - `faillite_rglru_scan` takes a and b (B, S, W) fp32, the TPU kernel's
//    own contract;
//  - `faillite_rglru_gated_scan` takes what the model has before the
//    elementwise tail of `_gates` (src/repro_torch/models/rglru.py): the
//    block-diagonal gate products ga and gx and the post-conv input xb
//    (B, S, W) in the model dtype (f32 or bf16), and log_lambda (W,) f32.
//    It computes a and b in registers, in the order of operations of
//    `_gates` (and of `rglru_gates_ref` in ../ref.py):
//      r = sigmoid(ga), i = sigmoid(gx), log_a = (-8 softplus(L)) r,
//      a = exp(log_a), b = sqrt(max(1 - exp(2 log_a), 1e-12)) i x,
//    each step rounded as PyTorch rounds it (no FMA contraction), so a and
//    b never reach device memory: the route reads 3 inputs of the model
//    dtype and writes h, where the unfused layer runs ~16 elementwise
//    kernels that write a and b in fp32 for the scan to read back.
//
// Layout: every (B, S, W) input is read through its own batch and sequence
// strides with a unit width stride (the model's layout, no transpose); h is
// (B, S, W) fp32 with strides (hsb, W, 1); h0 and h_last (B, W) fp32 through
// batch strides. h_last may alias h0 (the slot's "h" state).
//
// What bounds it on the H100: a few operations per element (the gated
// route ~60 with its two sigmoids, two exps and a sqrt) against 12 bytes
// moved (a, b in and h out; the gated route 3 x 2 + 4 in bf16), so the
// bound is bytes over the memory rate: 0.002 ms at recurrentgemma-2b's
// 256-token prefill. The TPU walks sequence blocks as the last, sequential
// grid axis and carries h across grid steps in VMEM scratch; a thread per
// channel walking S dependent steps (the first port) gives 20 blocks at
// B = 1 and S / 16 memory latencies in a row. The design here:
//
//  - prefill (S > 1), `rglru_chunk_kernel`: a block owns CH = 8 channels
//    of one row (320 blocks at B = 1, W = 2560: one wave at 3 blocks an
//    SM, where 16 channels gave 160 blocks of which the 133rd on waited
//    for a second wave) and cuts the sequence into NC = 32 chunks of
//    L = ceil(S / 32) steps, a thread each (channel = tid % 8, chunk =
//    tid / 8: 8 lanes read 8 neighbouring channels, a 32-byte sector of
//    fp32). The chunk count is fixed and L follows from S alone, so
//    two launches give the same bits. Pass 1: each thread scans its chunk
//    from zero to (P, H) = (prod a, h_end), all its loads issued before
//    its arithmetic. The 32 chunk carries are combined in shared memory
//    in chunk order by the threads of chunk 0 (carry_c = P_{c-1} carry_{c-1}
//    + H_{c-1}, from h0). Pass 2: each chunk rescans from its carry-in with
//    h = fma(a, h, b) and writes h. When L <= U = 8 (S <= 256, the main
//    path's prompts) a and b stay in registers between the passes; a longer
//    prompt walks its chunk in groups of U and pass 2 recomputes a and b
//    from L2-hot inputs, which keeps registers flat at a 2100-token prompt.
//    Rounding: chunk 0 is the sequential scan bit for bit; a later chunk
//    starts from a carry whose product of L decays is rounded L times;
//  - decode (S = 1), `rglru_step_kernel`: one thread per (row, channel),
//    gates inline, one load of each input and one fma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CH = 8;          // channels a block (the chunked kernel)
constexpr int NC = 32;         // chunks of the sequence a block
constexpr int NT = CH * NC;    // threads a block
constexpr int U = 8;           // steps a group; a and b kept when L <= U
constexpr int STEP_NT = 256;   // threads a block (the decode step)
static_assert(NC % U == 0, "the carries are combined U at a time");

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// torch.sigmoid of an fp32 tensor: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// F.softplus with beta 1 and threshold 20
__device__ __forceinline__ float softplus_f(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// The (a, b) route: the decays and inputs as they are.
struct ABSrc {
  const float* a;
  const float* b;
  long long sb, ss;
  struct View {
    const float* a;
    const float* b;
    long long ss;
    struct Raw {
      float a, b;
    };
    __device__ __forceinline__ Raw load(int t) const {
      return {__ldg(a + t * ss), __ldg(b + t * ss)};
    }
    __device__ __forceinline__ void gate(const Raw& r, float& av,
                                         float& bv) const {
      av = r.a;
      bv = r.b;
    }
  };
  __device__ __forceinline__ View at(int bb, int w) const {
    const long long o = bb * sb + w;
    return {a + o, b + o, ss};
  }
};

// The gated route: a and b from the gate products, op for op as `_gates`.
template <typename T>
struct GatedSrc {
  const T* ga;
  const T* gx;
  const T* xb;
  const float* log_lambda;
  long long gasb, gass, gxsb, gxss, xbsb, xbss;
  struct View {
    const T* ga;
    const T* gx;
    const T* xb;
    long long gass, gxss, xbss;
    float c;  // -8 * softplus(log_lambda[w])
    struct Raw {
      T ga, gx, xb;
    };
    __device__ __forceinline__ Raw load(int t) const {
      return {ga[t * gass], gx[t * gxss], xb[t * xbss]};
    }
    __device__ __forceinline__ void gate(const Raw& r, float& av,
                                         float& bv) const {
      const float rr = sigmoid_f(to_f<T>(r.ga));
      const float ii = sigmoid_f(to_f<T>(r.gx));
      const float log_a = __fmul_rn(c, rr);
      av = expf(log_a);
      const float m = __fsqrt_rn(
          fmaxf(__fsub_rn(1.f, expf(__fmul_rn(2.f, log_a))), 1e-12f));
      bv = __fmul_rn(__fmul_rn(m, ii), to_f<T>(r.xb));
    }
  };
  __device__ __forceinline__ View at(int bb, int w) const {
    return {ga + bb * gasb + w, gx + bb * gxsb + w, xb + bb * xbsb + w,
            gass, gxss, xbss, __fmul_rn(-8.f, softplus_f(log_lambda[w]))};
  }
};

// a and b of steps t0 .. t0 + U - 1, the loads all issued first; steps at
// or past t1 give the identity (a = 1, b = 0)
template <class V>
__device__ __forceinline__ void group(const V& v, int t0, int t1,
                                      float (&av)[U], float (&bv)[U]) {
  typename V::Raw raw[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (t0 + u < t1) raw[u] = v.load(t0 + u);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (t0 + u < t1) {
      v.gate(raw[u], av[u], bv[u]);
    } else {
      av[u] = 1.f;
      bv[u] = 0.f;
    }
  }
}

template <class Src>
__global__ void __launch_bounds__(NT)
rglru_chunk_kernel(Src src, const float* h0, float* __restrict__ h,
                   float* h_last, int S, int W, long long hsb,
                   long long h0b, long long hlb) {
  __shared__ float sP[NC][CH], sH[NC][CH];
  const int c = threadIdx.x % CH, chunk = threadIdx.x / CH;
  const int w = blockIdx.x * CH + c, bb = blockIdx.y;
  const bool on = w < W;
  const int L = (S + NC - 1) / NC;
  const int t0 = min(S, chunk * L), t1 = on ? min(S, t0 + L) : t0;
  const typename Src::View v = src.at(bb, on ? w : 0);
  float* hp = h + bb * hsb + w;

  float av[U], bv[U];
  float P = 1.f, H = 0.f;
  if (L <= U) {
    group(v, t0, t1, av, bv);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      H = fmaf(av[u], H, bv[u]);
      P = __fmul_rn(P, av[u]);
    }
  } else {
    for (int g = t0; g < t1; g += U) {
      group(v, g, t1, av, bv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        H = fmaf(av[u], H, bv[u]);
        P = __fmul_rn(P, av[u]);
      }
    }
  }
  sP[chunk][c] = P;
  sH[chunk][c] = H;
  __syncthreads();
  if (chunk == 0) {
    // carry-in of each chunk, in chunk order; h0 is read here, before any
    // thread writes h_last. The (P, H) of U chunks are loaded together.
    float carry = on ? h0[bb * h0b + w] : 0.f;
    for (int k0 = 0; k0 < NC; k0 += U) {
      float p[U], hh[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = sP[k0 + u][c];
        hh[u] = sH[k0 + u][c];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sH[k0 + u][c] = carry;
        carry = fmaf(p[u], carry, hh[u]);
      }
    }
  }
  __syncthreads();
  float hv = sH[chunk][c];
  if (L <= U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < t1) {
        hv = fmaf(av[u], hv, bv[u]);
        hp[(long long)(t0 + u) * W] = hv;
      }
    }
  } else {
    for (int g = t0; g < t1; g += U) {
      group(v, g, t1, av, bv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g + u < t1) {
          hv = fmaf(av[u], hv, bv[u]);
          hp[(long long)(g + u) * W] = hv;
        }
      }
    }
  }
  if (on && t1 == S && t0 < S) h_last[bb * hlb + w] = hv;
}

template <class Src>
__global__ void __launch_bounds__(STEP_NT)
rglru_step_kernel(Src src, const float* h0, float* __restrict__ h,
                  float* h_last, int B, int W, long long hsb, long long h0b,
                  long long hlb) {
  const long long i = (long long)blockIdx.x * STEP_NT + threadIdx.x;
  if (i >= (long long)B * W) return;
  const int bb = (int)(i / W), w = (int)(i % W);
  const typename Src::View v = src.at(bb, w);
  float av, bv;
  v.gate(v.load(0), av, bv);
  const float hv = fmaf(av, h0[bb * h0b + w], bv);
  h[bb * hsb + w] = hv;
  h_last[bb * hlb + w] = hv;
}

template <class Src>
cudaError_t launch(const Src& src, const void* h0, void* h, void* h_last,
                   int B, int S, int W, long long h0b, long long hlb,
                   cudaStream_t stream) {
  const long long hsb = (long long)S * W;
  if (S == 1) {
    const long long n = (long long)B * W;
    rglru_step_kernel<Src><<<(unsigned)((n + STEP_NT - 1) / STEP_NT),
                             STEP_NT, 0, stream>>>(
        src, static_cast<const float*>(h0), static_cast<float*>(h),
        static_cast<float*>(h_last), B, W, hsb, h0b, hlb);
  } else {
    rglru_chunk_kernel<Src><<<dim3((W + CH - 1) / CH, B), NT, 0, stream>>>(
        src, static_cast<const float*>(h0), static_cast<float*>(h),
        static_cast<float*>(h_last), S, W, hsb, h0b, hlb);
  }
  return cudaGetLastError();
}

}  // namespace

// a, b: (B, S, W) fp32 with strides (sb, ss, 1) in elements; h: (B, S, W)
// fp32, contiguous; h0, h_last: (B, W) fp32 with batch strides h0b, hlb.
// Returns the cudaError_t of the launch (0 on success); never
// synchronizes.
extern "C" int faillite_rglru_scan(const void* a, const void* b,
                                   const void* h0, void* h, void* h_last,
                                   int B, int S, int W, long long sb,
                                   long long ss, long long h0b,
                                   long long hlb, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const ABSrc src{static_cast<const float*>(a), static_cast<const float*>(b),
                  sb, ss};
  return (int)launch(src, h0, h, h_last, B, S, W, h0b, hlb,
                     static_cast<cudaStream_t>(stream));
}

// ga, gx, xb: (B, S, W) of dtype `dtype` (0 = float32, 1 = bfloat16), each
// with strides (*sb, *ss, 1) in elements; log_lambda (W,) fp32; h, h0 and
// h_last as for faillite_rglru_scan. Returns the cudaError_t of the launch
// (0 on success); never synchronizes.
extern "C" int faillite_rglru_gated_scan(
    const void* ga, const void* gx, const void* xb, const void* log_lambda,
    const void* h0, void* h, void* h_last, int dtype, int B, int S, int W,
    long long gasb, long long gass, long long gxsb, long long gxss,
    long long xbsb, long long xbss, long long h0b, long long hlb,
    void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lam = static_cast<const float*>(log_lambda);
  if (dtype == 0) {
    const GatedSrc<float> src{
        static_cast<const float*>(ga), static_cast<const float*>(gx),
        static_cast<const float*>(xb), lam, gasb, gass, gxsb, gxss, xbsb,
        xbss};
    return (int)launch(src, h0, h, h_last, B, S, W, h0b, hlb, st);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const GatedSrc<bf> src{static_cast<const bf*>(ga),
                           static_cast<const bf*>(gx),
                           static_cast<const bf*>(xb), lam, gasb, gass, gxsb,
                           gxss, xbsb, xbss};
    return (int)launch(src, h0, h, h_last, B, S, W, h0b, hlb, st);
  }
  return (int)cudaErrorInvalidValue;
}
