// Decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_dec_kernel` in
// src/repro/kernels/decode_attention/decode_attention.py (launched from
// `decode_attention_bhd`). One query token per sequence attends to its KV
// cache: key position p is valid iff p < lens[b] and, when window > 0,
// p >= lens[b] - window. GQA (kv head = h / G), fp32 online softmax with
// NEG_INF = -1e30 and l clamped at 1e-30, as in the TPU kernel.
//
// Layout: q (B, 1, H, hd), caches (B, Smax, KVH, hd) — the model's slot
// cache, read in place through element strides — lens (B,) int32,
// out (B, 1, H, hd).
//
// Design. The TPU walks KV chunks as the last, sequential grid axis, one
// query head per grid row. Here one block serves one (b, kv head) and all
// G query heads of its group, one warp per head, so each K/V byte of the
// cache is read from device memory once per group instead of G times. The
// block walks 64-key tiles from the window start up to lens[b] only; the
// unused tail of the cache is never read. K and V tiles are staged in
// shared memory as fp32 with 16-byte loads, all of a thread's loads for a
// tile in flight at once (K rows padded by one word); lane i scores keys i
// and i + 32 of the tile, the warp reduces the row max and sum with
// shuffles, and each lane keeps hd/32 output columns in registers.
//
// What bounds it on the H100: decode reads every valid K/V byte once and
// does 4*hd flops per (head, key), far below the card's ops:byte ratio, so
// the bound is the KV bytes over the memory rate. The known weak point is
// parallelism: at B = 4 slots and KVH = 2 the grid is 8 blocks on 132 SMs
// (4 blocks for recurrentgemma-2b's single KV head at head_dim 256), so one
// SM streams a whole sequence. The fix is split-KV flash-decoding
// (partials over KV chunks on many blocks, then a second reduce pass).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;       // keys per KV tile
constexpr int MAX_G = 32;    // one warp per query head of the group

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  long long qsb, qsh;          // q (B, 1, H, hd)
  long long ksb, kss, ksh;     // k cache (B, Smax, KVH, hd)
  long long vsb, vss, vsh;     // v cache
  long long osb, osh;          // out (B, 1, H, hd)
};

template <int HD>
int smem_bytes(int G) {
  return (BK * (HD + 1) + BK * HD + G * HD + G * BK) * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void dec_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ lens, T* __restrict__ o,
                           int G, int Smax, Args a, float scale, int window) {
  constexpr int KS = HD + 1;
  // output columns of a lane: lane + 32 jj; below 32 columns (head_dim 16)
  // lane i reads column i % HD and only lanes i < HD store
  constexpr int DJ = HD >= 32 ? HD / 32 : 1;
  extern __shared__ float smem[];
  float* sK = smem;             // BK x KS
  float* sV = sK + BK * KS;     // BK x HD
  float* sQ = sV + BK * HD;     // G x HD, pre-scaled
  float* sP = sQ + G * HD;      // G x BK

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = kvh * G + warp;
  const int col = HD >= 32 ? lane : lane % HD;

  stage_rows<T, HD>(sQ, HD, q + b * a.qsb + kvh * G * a.qsh, a.qsh, G, G,
                    scale, threadIdx.x, nthreads);

  const int n_valid = max(0, min(lens[b], Smax));
  const int lo = window > 0 ? max(0, n_valid - window) : 0;
  const T* kb = k + b * a.ksb + kvh * a.ksh;
  const T* vb = v + b * a.vsb + kvh * a.vsh;
  const float* qg = sQ + warp * HD;
  float* pg = sP + warp * BK;

  float m = NEG_INF, l = 0.f, acc[DJ];
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) acc[jj] = 0.f;

  for (int k0 = (lo / BK) * BK; k0 < n_valid; k0 += BK) {
    __syncthreads();  // previous tile's reads are done (and sQ is written)
    stage_rows<T, HD>(sK, KS, kb + k0 * a.kss, a.kss, BK, n_valid - k0, 1.f,
                      threadIdx.x, nthreads);
    stage_rows<T, HD>(sV, HD, vb + k0 * a.vss, a.vss, BK, n_valid - k0, 1.f,
                      threadIdx.x, nthreads);
    __syncthreads();

    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = qg[d];
      s0 = fmaf(qd, sK[lane * KS + d], s0);
      s1 = fmaf(qd, sK[(lane + 32) * KS + d], s1);
    }
    const int p0 = k0 + lane, p1 = k0 + lane + 32;
    if (!(p0 < n_valid && p0 >= lo)) s0 = NEG_INF;
    if (!(p1 < n_valid && p1 >= lo)) s1 = NEG_INF;

    const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
    const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(e0 + e1);
    m = m_new;
    pg[lane] = e0;
    pg[lane + 32] = e1;
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[jj] *= corr;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = pg[c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        acc[jj] = fmaf(p, sV[c * HD + col + 32 * jj], acc[jj]);
    }
  }

  const float li = fmaxf(l, 1e-30f);
  T* orow = o + b * a.osb + h * a.osh;
  if (HD < 32 && lane >= HD) return;
#pragma unroll
  for (int jj = 0; jj < DJ; ++jj) orow[col + 32 * jj] = from_f<T>(acc[jj] / li);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, void* o, int B, int H, int KVH, int Smax,
                   const Args& a, int window, cudaStream_t stream) {
  const int G = H / KVH;
  const int smem = smem_bytes<HD>(G);
  auto kern = dec_kernel<T, HD>;
  // once per instantiation, for the largest group (thread-safe static
  // init); one device per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<HD>(MAX_G));
  if (attr != cudaSuccess) return attr;
  dim3 grid(KVH, B);
  kern<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(o), G, Smax, a,
      (float)(1.0 / sqrt((double)HD)), window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* lens, void* o, int B, int H, int KVH,
                        int Smax, const Args& a, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, lens, o, B, H, KVH, Smax, a, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, lens, o, B, H, KVH, Smax, a, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, lens, o, B, H, KVH, Smax, a, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, lens, o, B, H, KVH, Smax, a, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, lens, o, B, H, KVH, Smax, a, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int faillite_decode_attention(
    const void* q, const void* k, const void* v, const void* lens, void* o,
    int dtype, int B, int H, int KVH, int Smax, int hd, long long qsb,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long osh, int window,
    void* stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > MAX_G || B <= 0 || Smax <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh};
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, ln, o, B, H, KVH, Smax, a,
                                   window, st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, ln, o, B, H, KVH,
                                           Smax, a, window, st);
  return (int)cudaErrorInvalidValue;
}
