// Prefill flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (launched from
// `flash_attention_bhsd`). Computes, per (batch, query head),
//   out = softmax(q k^T / sqrt(hd) + mask) v
// with GQA (kv head = h / G), causal and/or sliding-window masks
// (k > q - window), NEG_INF = -1e30 (finite) and l clamped at 1e-30, the
// same arithmetic as the TPU kernel, in an fp32 online softmax.
//
// Layout: q (B, Sq, H, hd), k/v (B, Skv, KVH, hd), out (B, Sq, H, hd), read
// through batch/sequence/head element strides with a unit last stride, so
// the model's layout needs no transpose.
//
// Design. The TPU walks KV blocks as the last, sequential grid axis and
// keeps (m, l, acc) in VMEM scratch across grid steps. Hopper blocks run in
// no order, so one block owns one (b, h, 32-row query tile) and walks the
// KV tiles in a loop, keeping m, l and acc in fp32 registers. Tiles wholly
// above the causal diagonal, wholly outside the window, or past Skv are
// never visited. Q, K and V tiles are staged in shared memory as fp32
// with 16-byte loads, each thread issuing all of its loads for a tile
// before storing any (rows padded by one word so column reads hit
// distinct banks); each of
// the 128 threads computes a 4x4 block of scores with scalar FMAs and owns
// 4 query rows x hd/16 output columns, the same rows as its scores, so the
// row statistics reduce over the 16 lanes of a half warp with shuffles.
//
// What bounds it on the H100: at the main path's prefill shapes
// (S <= 512, H = 16, hd = 128) the work is about 4*S^2/2*hd*H flops on
// bytes that fit in L2, so the bound is the tensor-core rate. This kernel
// does its products with scalar fp32 FMAs (no mma/wgmma, no TMA), so it
// runs far from that bound; wgmma with TMA-fed tiles is the later step.
// At head_dim 256 (recurrentgemma-2b) the fp32 tiles take ~170 KB of
// dynamic shared memory, so one block fits on an SM; its sliding-window
// prefill (window 2048) visits only the KV tiles of each query tile's band.
// head_dim 16 (the reduced configs the thread testbed serves) is the same
// code at one output column per thread and row (DJ = 1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 32;    // query rows per block
constexpr int BK = 64;    // keys per KV tile
constexpr int NT = 128;   // threads per block
constexpr int PS = BK + 16;  // row stride of the P tile (two rows per warp
                             // land in disjoint bank halves)

struct Strides {
  long long b, s, h;
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype() does
}

// Unpack one 16-byte vector: 4 floats or 8 bfloat16 values.
__device__ __forceinline__ void unpack(const uint4& u, float (&out)[4],
                                       const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&out)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage `rows` rows of HD values into shared memory as fp32 (times
// `scale`): row r comes from src + r * row_stride, or is zero when
// r >= valid. Each thread issues up to CH 16-byte loads before it stores
// any of them, so a tile costs a few memory latencies rather than one per
// element. src rows must be 16-byte aligned (the wrapper checks).
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const T* src, long long row_stride,
                                           int rows, int valid, float scale,
                                           int tid, int nthreads) {
  constexpr int EPV = 16 / (int)sizeof(T);  // values per vector
  constexpr int VPR = HD / EPV;             // vectors per row
  constexpr int CH = 8;
  const int total = rows * VPR;
  for (int base = tid; base < total; base += CH * nthreads) {
    uint4 r[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int i = base + u * nthreads, row = i / VPR;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && row < valid)
        r[u] = __ldg(reinterpret_cast<const uint4*>(
            src + row * row_stride + (i % VPR) * EPV));
    }
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int i = base + u * nthreads;
      if (i >= total) break;
      float f[EPV];
      unpack(r[u], f, src);
      float* d = dst + (i / VPR) * dst_stride + (i % VPR) * EPV;
#pragma unroll
      for (int e = 0; e < EPV; ++e) d[e] = f[e] * scale;
    }
  }
}

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * PS;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int G, int Sq, int Skv,
          Strides qs, Strides ks, Strides vs, Strides os, float scale,
          int causal, int window) {
  constexpr int KS = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x KS, pre-scaled
  float* sK = sQ + BQ * KS;    // BK x KS
  float* sV = sK + BK * KS;    // BK x HD
  float* sP = sV + BK * HD;    // BQ x PS

  const int tid = threadIdx.x;
  const int tr = tid / 16;     // rows tr + 8 i, i < 4
  const int tc = tid % 16;     // score cols tc + 16 j, out cols tc + 16 jj
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  stage_rows<T, HD>(sQ, KS, qb + q0 * qs.s, qs.s, BQ, Sq - q0, scale, tid,
                    NT);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // KV tiles that some row of this query tile needs (as `needed` in the
  // TPU kernel): below Skv, not wholly above the diagonal, not wholly
  // left of the window.
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + BQ);
  int k_first = 0;
  if (window > 0) k_first = (max(0, q0 - window + 1) / BK) * BK;

  for (int k0 = k_first; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's sK/sV/sP reads are done
    stage_rows<T, HD>(sK, KS, kb + k0 * ks.s, ks.s, BK, Skv - k0, 1.f, tid,
                      NT);
    stage_rows<T, HD>(sV, HD, vb + k0 * vs.s, vs.s, BK, Skv - k0, 1.f, tid,
                      NT);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr + 8 * i) * KS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tc + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        bool ok = qp < Sq && kp < Skv;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(tr + 8 * i) * PS + tc + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = sV[c * HD + tc + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(tr + 8 * i) * PS + c];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tr + 8 * i;
    if (qp >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + b * os.b + qp * os.s + h * os.h;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) orow[tc + 16 * jj] = from_f<T>(acc[i][jj] / li);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Skv, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal, int window,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kern = fa_kernel<T, HD>;
  // once per instantiation (thread-safe static init); one device per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / KVH, Sq, Skv, qs, ks,
      vs, os, (float)(1.0 / sqrt((double)HD)), causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int KVH, int Sq, int Skv,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KVH, Sq, Skv, qs, ks, vs, os,
                           causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Skv, qs, ks, vs, os,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Skv, qs, ks, vs, os,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Skv, qs, ks, vs, os,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KVH, Sq, Skv, qs, ks, vs, os,
                            causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int faillite_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KVH, int Sq, int Skv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss, long long osh,
    int causal, int window, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || B <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, o, B, H, KVH, Sq, Skv, qs, ks,
                                   vs, os, causal, window, st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KVH, Sq, Skv,
                                           qs, ks, vs, os, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
