// Decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_dec_kernel` in
// src/repro/kernels/decode_attention/decode_attention.py (launched from
// `decode_attention_bhd`). One query token per sequence attends to its KV
// cache: key position p is valid iff p < lens[b] and, when window > 0,
// p >= lens[b] - window. GQA (kv head = h / G), fp32 online softmax with
// NEG_INF = -1e30 and l clamped at 1e-30, as in the TPU kernel; the output
// is rounded once to the input dtype.
//
// Layout: q (B, 1, H, hd), caches (B, Smax, KVH, hd) — the model's slot
// cache, read in place through element strides — lens (B,) int32,
// out (B, 1, H, hd).
//
// What bounds it on the H100: decode reads every valid K/V byte once and
// does 4*hd flops per (head, key), far below the card's ops:byte ratio, so
// the bound is the KV bytes over the memory rate. At the main path's
// shapes that is well under a microsecond, so what costs is parallelism
// and latency: one block per (b, kv head) is 8 blocks on 132 SMs at 4
// slots x 2 KV heads, and one SM then streams a whole sequence alone.
//
// Design: split-KV (flash-decoding), two kernels a call.
//  - `dec_split_kernel`, grid (n_split, KVH, B). The host picks n_split
//    and the chunk length from (B, KVH, Smax) and the card's SM count only
//    (ops.plan_split), never from lens, so a decode step needs no host
//    sync and can be captured in a CUDA graph. Chunk s covers the fixed
//    absolute key positions [s * chunk, (s + 1) * chunk), a multiple of the
//    32-key tile. A block serves all G query heads of its KV head, one warp
//    a head, so each K/V byte is read once per group. It walks its chunk's
//    valid tiles only, loading them with cp.async.cg 16-byte copies into a
//    2-stage ring of bf16 (or f32) rows, rows outside [lo, lens[b])
//    zero-filled so that a stale NaN never meets p = 0; lane i scores key
//    i of a tile against the pre-scaled fp32 q, the warp reduces max and
//    sum with shuffles, and each lane keeps hd/32 output columns. It writes
//    the chunk's (m, l, acc) in fp32 to a workspace the wrapper allocates.
//    A chunk wholly past lens[b], or wholly before the window's start,
//    reads nothing and writes m = NEG_INF, l = 0, acc = 0, so it never
//    reaches exp(NEG_INF - NEG_INF) = 1. With n_split = 1 the block writes
//    the output itself and the second kernel is not launched.
//  - `dec_combine_kernel`, grid (KVH, B), merges the partials in fixed
//    split order: M = max m_i, w_i = exp(m_i - M), out = sum w_i acc_i /
//    max(sum w_i l_i, 1e-30). No atomics: the result is bit-identical from
//    run to run.
// A row's output depends on its own q, cache row and lens[b] only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TK = 32;       // keys per tile: one per lane
constexpr int MAX_G = 32;    // one warp per query head of the group

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// N consecutive values at p (aligned to N values) as floats
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = f.x;
      out[4 * i + 1] = f.y;
      out[4 * i + 2] = f.z;
      out[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float (&out)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      float f[8];
      unpack(reinterpret_cast<const uint4*>(p)[i], f, p);
#pragma unroll
      for (int e = 0; e < 8; ++e) out[8 * i + e] = f[e];
    }
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = c.x;
    out[3] = c.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x;
    out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*p);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  long long qsb, qsh;          // q (B, 1, H, hd)
  long long ksb, kss, ksh;     // k cache (B, Smax, KVH, hd)
  long long vsb, vss, vsh;     // v cache
  long long osb, osh;          // out (B, 1, H, hd)
};

// Shared-memory layout of one (T, HD): a ring of 2 stages of K and V
// tiles, each TK rows padded by 16 bytes (lane i reads row i, so the pad
// spreads a column of 16-byte reads over distinct bank groups), then q of
// the group as pre-scaled fp32.
template <typename T, int HD>
struct Dec {
  static constexpr int EPV = 16 / (int)sizeof(T);  // values a 16-byte chunk
  static constexpr int NCH = HD / EPV;             // chunks a row
  static constexpr int RS = HD * (int)sizeof(T) + 16;  // row stride, bytes
  static constexpr int TILE = TK * RS;
  static constexpr int CPL = HD >= 32 ? HD / 32 : 1;  // columns a lane
  static int smem_bytes(int G) { return 4 * TILE + G * HD * 4; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(32 * MAX_G, 1)
dec_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lens,
                 T* __restrict__ o, float* __restrict__ part_acc,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 int G, int Smax, int chunk, Args a, float scale,
                 int window) {
  using C = Dec<T, HD>;
  constexpr int CPL = C::CPL;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  float* sQ = reinterpret_cast<float*>(dec_smem + 4 * C::TILE);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // output columns of a lane: col0 .. col0 + CPL - 1; below 32 columns
  // (head_dim 16) lane i reads column i % HD and only lanes i < HD store
  const int col0 = HD >= 32 ? lane * CPL : lane % HD;

  const int n_valid = max(0, min(lens[b], Smax));
  const int lo = window > 0 ? max(0, n_valid - window) : 0;
  const int c0 = split * chunk;
  const int k_begin = max(c0, lo), k_end = min(c0 + chunk, n_valid);

  float m = NEG_INF, l = 0.f, acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;

  if (k_begin < k_end) {
    const T* kb = k + b * a.ksb + kvh * a.ksh;
    const T* vb = v + b * a.vsb + kvh * a.vsh;
    const int t0 = k_begin / TK, t1 = (k_end + TK - 1) / TK;
    // K and V rows of tile t into stage st; rows outside [lo, n_valid)
    // zero-filled, their source the first valid row (never read)
    auto issue = [&](int t, int st) {
      unsigned char* dst = dec_smem + st * 2 * C::TILE;
      for (int i = tid; i < 2 * TK * C::NCH; i += nthreads) {
        const int which = i / (TK * C::NCH);
        const int r = (i / C::NCH) % TK, c = i % C::NCH;
        const int pos = t * TK + r;
        const bool ok = pos >= lo && pos < n_valid;
        const T* src = (which ? vb : kb) +
                       (long long)(ok ? pos : k_begin) * (which ? a.vss
                                                                : a.kss) +
                       c * C::EPV;
        cp_async16(dst + which * C::TILE + r * C::RS + c * 16, src, ok);
      }
    };
    issue(t0, 0);
    cp_async_commit();
    const T* qg = q + b * a.qsb + (long long)kvh * G * a.qsh;
    for (int i = tid; i < G * HD; i += nthreads)
      sQ[i] = to_f(qg[(i / HD) * a.qsh + i % HD]) * scale;
    const float* qh = sQ + warp * HD;

    for (int t = t0; t < t1; ++t) {
      const int st = (t - t0) & 1;
      if (t + 1 < t1) {
        issue(t + 1, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile t (and q) landed for every thread's copies
      const unsigned char* sK = dec_smem + st * 2 * C::TILE;
      const unsigned char* sV = sK + C::TILE;

      float s = 0.f;
      const unsigned char* krow = sK + lane * C::RS;
#pragma unroll 2
      for (int c = 0; c < C::NCH; ++c) {
        float kf[C::EPV];
        unpack(*reinterpret_cast<const uint4*>(krow + c * 16), kf,
               static_cast<const T*>(nullptr));
#pragma unroll
        for (int e = 0; e < C::EPV; ++e)
          s = fmaf(qh[c * C::EPV + e], kf[e], s);
      }
      const int kp = t * TK + lane;
      if (!(kp >= lo && kp < n_valid)) s = NEG_INF;

      // every visited tile holds a valid key, so m_new is finite here
      const float m_new = fmaxf(m, warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] *= corr;
#pragma unroll 8
      for (int j = 0; j < TK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        float vf[CPL];
        load_vals<CPL>(reinterpret_cast<const T*>(sV + j * C::RS) + col0,
                       vf);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = fmaf(pj, vf[c], acc[c]);
      }
      __syncthreads();  // every warp is done with stage st before reload
    }
  }

  if (HD < 32 && lane >= HD) return;
  const int h = kvh * G + warp;
  if (n_split == 1) {
    const float li = fmaxf(l, 1e-30f);
    T* orow = o + b * a.osb + h * a.osh + col0;
#pragma unroll
    for (int c = 0; c < CPL; ++c) orow[c] = from_f<T>(acc[c] / li);
    return;
  }
  const long long row =
      ((long long)(b * gridDim.y + kvh) * n_split + split) * G + warp;
  if (lane == 0) {
    part_m[row] = m;
    part_l[row] = l;
  }
  float* prow = part_acc + row * HD + col0;
#pragma unroll
  for (int c = 0; c < CPL; ++c) prow[c] = acc[c];
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * MAX_G, 1)
dec_combine_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_l, T* __restrict__ o,
                   int G, int n_split, Args a) {
  constexpr int CPL = Dec<T, HD>::CPL;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = HD >= 32 ? lane * CPL : lane % HD;
  // partial rows of this head: row0 + s * G for split s
  const long long row0 =
      (long long)(b * gridDim.x + kvh) * n_split * G + warp;

  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_m[row0 + s * G]);
  float den = 0.f, acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long r = row0 + s * G;
    const float w = expf(part_m[r] - M);
    if (w == 0.f) continue;  // an empty chunk (or one far below M): adds 0
    den += w * part_l[r];
    float pa[CPL];
    load_vals<CPL>(part_acc + r * HD + col0, pa);
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] += w * pa[c];
  }
  if (HD < 32 && lane >= HD) return;
  const float d = fmaxf(den, 1e-30f);
  T* orow = o + b * a.osb + (kvh * G + warp) * a.osh + col0;
#pragma unroll
  for (int c = 0; c < CPL; ++c) orow[c] = from_f<T>(acc[c] / d);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, void* o, float* part_acc, float* part_m,
                   float* part_l, int B, int H, int KVH, int Smax,
                   int n_split, int chunk, const Args& a, int window,
                   cudaStream_t stream) {
  using C = Dec<T, HD>;
  const int G = H / KVH;
  auto kern = dec_split_kernel<T, HD>;
  // once per instantiation, for the largest group (thread-safe static
  // init); one device per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::smem_bytes(MAX_G));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(n_split, KVH, B), 32 * G, C::smem_bytes(G), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(o), part_acc, part_m,
      part_l, G, Smax, chunk, a, (float)(1.0 / sqrt((double)HD)), window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  dec_combine_kernel<T, HD><<<dim3(KVH, B), 32 * G, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(o), G, n_split, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* lens, void* o, float* pa, float* pm,
                        float* pl, int B, int H, int KVH, int Smax,
                        int n_split, int chunk, const Args& a, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, lens, o, pa, pm, pl, B, H, KVH, Smax,
                           n_split, chunk, a, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, lens, o, pa, pm, pl, B, H, KVH, Smax,
                           n_split, chunk, a, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, lens, o, pa, pm, pl, B, H, KVH, Smax,
                           n_split, chunk, a, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, lens, o, pa, pm, pl, B, H, KVH, Smax,
                            n_split, chunk, a, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, lens, o, pa, pm, pl, B, H, KVH, Smax,
                            n_split, chunk, a, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. n_split
// chunks of `chunk` keys (a multiple of 32) must cover Smax, the last one
// not empty; with n_split > 1, part_acc (B, KVH, n_split, G, hd) and
// part_m, part_l (B, KVH, n_split, G) are fp32 workspaces. Returns the
// cudaError_t of the launches (0 on success); never synchronizes.
extern "C" int faillite_decode_attention(
    const void* q, const void* k, const void* v, const void* lens, void* o,
    void* part_acc, void* part_m, void* part_l, int dtype, int B, int H,
    int KVH, int Smax, int hd, int n_split, int chunk, long long qsb,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long osh, int window,
    void* stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > MAX_G || B <= 0 || Smax <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_split <= 0 || chunk <= 0 || chunk % TK != 0 ||
      (long long)n_split * chunk < Smax ||
      (long long)(n_split - 1) * chunk >= Smax)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (!part_acc || !part_m || !part_l))
    return (int)cudaErrorInvalidValue;
  const Args a{qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh};
  const int* ln = static_cast<const int*>(lens);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, ln, o, pa, pm, pl, B, H, KVH,
                                   Smax, n_split, chunk, a, window, st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, ln, o, pa, pm, pl, B,
                                           H, KVH, Smax, n_split, chunk, a,
                                           window, st);
  return (int)cudaErrorInvalidValue;
}
