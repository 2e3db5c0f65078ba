// Backward of the prefill flash attention for Hopper (sm_90a), plain C
// interface for ctypes.
//
// The JAX package has no backward TPU kernel: it trains through XLA's
// autodiff of `flash_attention_jnp` (src/repro/models/layers.py), the
// gradient of the function `_fa_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py computes. This file
// computes that gradient for the forward of flash_attention.cu, with
// FlashAttention-2's backward structure and the forward's masks: causal
// (q >= k), sliding window (k > q - window), non-causal with Sq != Skv,
// GQA (kv head = h / G, G = H / KVH), head_dim 16/32/64/128/256, float32
// or bfloat16 inputs read through (batch, sequence, head) element strides
// with a unit last stride, fp32 arithmetic throughout:
//
//   D  = rowsum(dO * O)                           (fa_bwd_d_kernel)
//   P  = exp(S - lse), S = (scale q) k^T, from the forward's lse
//   dS = P * (dO V^T - D)
//   dV = sum over the group's heads of P^T dO      (fa_bwd_dkdv_kernel)
//   dK = sum over the group's heads of dS^T (scale q)
//   dQ = scale dS K                                (fa_bwd_dq_kernel)
//
// One block of the dK/dV kernel owns one (b, kv head, key tile) and walks
// the query tiles of all G query heads of its group, so the group's sum is
// a loop in one block: no floating-point atomics, and two runs give
// bit-equal gradients. One block of the dQ kernel owns one (b, h, query
// tile) and walks the key tiles. Tiles the forward skips (wholly above the
// causal diagonal, wholly outside the window, past Sq or Skv) are skipped;
// masked entries of P are exactly 0.
//
// What bounds it: the products are ~2.5x the forward's operations, and at
// the training shapes (S 256-2100, hd 64-256) the bytes fit in L2, so the
// bound is operations. This first kernel is scalar: every tile is staged
// in shared memory as fp32 (rows padded by one word so column reads hit
// distinct banks), each of the 256 threads computes a block of scores
// and dP with FMAs, P and dS go through shared memory, and each thread
// owns a block of rows x columns of the dK/dV (or dQ) accumulators in
// registers. Tensor cores (mma or wgmma), TMA and a split over query
// tiles for short sequences are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Tile sizes and thread layouts of one head_dim.
template <int HD>
struct Cfg {
  static constexpr int BQ = HD >= 256 ? 32 : 64;  // query rows a tile
  static constexpr int BK = HD >= 256 ? 32 : 64;  // keys a tile
  static constexpr int KS = HD + 1;   // row stride of the Q/dO/K/V tiles
  static constexpr int PS = BK + 1;   // row stride of the P and dS tiles
  // scores: a 16 x 16 thread grid, rows ti + 16 a, columns tj + 16 c
  static constexpr int RA = BQ / 16, CA = BK / 16;
  // accumulators: TC threads across head_dim (a warp's lanes on
  // consecutive columns), TR across rows
  static constexpr int TC = HD < 32 ? HD : 32;
  static constexpr int TR = NT / TC;
  static constexpr int NC = HD / TC;    // a thread's columns
  static constexpr int SMEM_FLOATS =
      (2 * BQ + 2 * BK) * KS + 2 * BQ * PS + 2 * BQ;
};

// Stage `rows` rows of HD values as fp32 (times `scale`): row r from
// src + r * rs, zero when r >= valid. Consecutive threads read
// consecutive values of a row.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int rows, int valid, float scale) {
  for (int i = threadIdx.x; i < rows * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] = r < valid ? to_f(src[r * rs + d]) * scale : 0.f;
  }
}

// lse and D of the BQ rows from q0 (zero past Sq).
__device__ __forceinline__ void stage_rows(float* sL, float* sD,
                                           const float* lrow,
                                           const float* drow, int q0, int Sq,
                                           int BQ) {
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const int qp = q0 + i;
    sL[i] = qp < Sq ? lrow[qp] : 0.f;
    sD[i] = qp < Sq ? drow[qp] : 0.f;
  }
}

// P and dS of the (q0, k0) tile pair into shared memory, from the staged
// Q (pre-scaled), dO, K, V, lse and D. Masked entries are 0 in both.
template <int HD>
__device__ __forceinline__ void scores(const float* sQ, const float* sDO,
                                       const float* sK, const float* sV,
                                       const float* sL, const float* sD,
                                       float* sP, float* sDS, int q0, int k0,
                                       int Sq, int Skv, int causal,
                                       int window) {
  using C = Cfg<HD>;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float s[C::RA][C::CA], dp[C::RA][C::CA];
#pragma unroll
  for (int a = 0; a < C::RA; ++a)
#pragma unroll
    for (int c = 0; c < C::CA; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[C::RA], da[C::RA], kc[C::CA], vc[C::CA];
#pragma unroll
    for (int a = 0; a < C::RA; ++a) {
      qa[a] = sQ[(ti + 16 * a) * C::KS + d];
      da[a] = sDO[(ti + 16 * a) * C::KS + d];
    }
#pragma unroll
    for (int c = 0; c < C::CA; ++c) {
      kc[c] = sK[(tj + 16 * c) * C::KS + d];
      vc[c] = sV[(tj + 16 * c) * C::KS + d];
    }
#pragma unroll
    for (int a = 0; a < C::RA; ++a)
#pragma unroll
      for (int c = 0; c < C::CA; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(da[a], vc[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < C::RA; ++a) {
    const int r = ti + 16 * a, qp = q0 + r;
#pragma unroll
    for (int c = 0; c < C::CA; ++c) {
      const int j = tj + 16 * c, kp = k0 + j;
      bool ok = qp < Sq && kp < Skv;
      if (causal) ok = ok && qp >= kp;
      if (window > 0) ok = ok && kp > qp - window;
      const float p = ok ? expf(s[a][c] - sL[r]) : 0.f;
      sP[r * C::PS + j] = p;
      sDS[r * C::PS + j] = p * (dp[a][c] - sD[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
fa_bwd_d_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ Dv, int H, int Sq, int hd, Strides os,
                Strides dos, int rows) {
  const int row = (blockIdx.x * NT + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int qp = row % Sq, h = (row / Sq) % H, b = row / (Sq * H);
  const T* orow = o + b * os.b + qp * os.s + h * os.h;
  const T* drow = dout + b * dos.b + qp * dos.s + h * dos.h;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32)
    s = fmaf(to_f(orow[d]), to_f(drow[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) Dv[row] = s;   // (B, H, Sq) row-major: row = (b H + h) Sq + q
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ Dv,
                   T* __restrict__ dk, T* __restrict__ dv, int G, int H,
                   int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                   Strides dos, Strides dks, Strides dvs, float scale,
                   int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, KS = C::KS, PS = C::PS;
  constexpr int NR = BK / C::TR;   // a thread's key rows
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * KS;
  float* sQ = sV + BK * KS;
  float* sDO = sQ + BQ * KS;
  float* sP = sDO + BQ * KS;
  float* sDS = sP + BQ * PS;
  float* sL = sDS + BQ * PS;
  float* sD = sL + BQ;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int tr = threadIdx.x / C::TC, tc = threadIdx.x % C::TC;
  stage<T, HD>(sK, k + b * ks.b + kvh * ks.h + k0 * ks.s, ks.s, BK, Skv - k0,
               1.f);
  stage<T, HD>(sV, v + b * vs.b + kvh * vs.h + k0 * vs.s, vs.s, BK, Skv - k0,
               1.f);

  // query tiles that see some key of this tile: at or below the causal
  // diagonal, inside the window (q < k + window)
  const int q_first = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;

  float adk[NR][C::NC], adv[NR][C::NC];
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int e = 0; e < C::NC; ++e) adk[a][e] = adv[a][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const float* lrow = lse + ((long long)b * H + h) * Sq;
    const float* drow = Dv + ((long long)b * H + h) * Sq;
    for (int q0 = q_first; q0 < q_end; q0 += BQ) {
      __syncthreads();   // the previous pair's readers are done
      stage<T, HD>(sQ, qb + q0 * qs.s, qs.s, BQ, Sq - q0, scale);
      stage<T, HD>(sDO, db + q0 * dos.s, dos.s, BQ, Sq - q0, 1.f);
      stage_rows(sL, sD, lrow, drow, q0, Sq, BQ);
      __syncthreads();
      scores<HD>(sQ, sDO, sK, sV, sL, sD, sP, sDS, q0, k0, Sq, Skv, causal,
                 window);
      __syncthreads();
      // dV += P^T dO, dK += dS^T (scale Q)
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float dov[C::NC], qv[C::NC];
#pragma unroll
        for (int e = 0; e < C::NC; ++e) {
          dov[e] = sDO[i * KS + tc + C::TC * e];
          qv[e] = sQ[i * KS + tc + C::TC * e];
        }
#pragma unroll
        for (int a = 0; a < NR; ++a) {
          const float p = sP[i * PS + tr + C::TR * a];
          const float ds = sDS[i * PS + tr + C::TR * a];
#pragma unroll
          for (int e = 0; e < C::NC; ++e) {
            adv[a][e] = fmaf(p, dov[e], adv[a][e]);
            adk[a][e] = fmaf(ds, qv[e], adk[a][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int kp = k0 + tr + C::TR * a;
    if (kp >= Skv) continue;
    T* dkr = dk + b * dks.b + kp * dks.s + kvh * dks.h;
    T* dvr = dv + b * dvs.b + kp * dvs.s + kvh * dvs.h;
#pragma unroll
    for (int e = 0; e < C::NC; ++e) {
      dkr[tc + C::TC * e] = from_f<T>(adk[a][e]);
      dvr[tc + C::TC * e] = from_f<T>(adv[a][e]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ Dv,
                 T* __restrict__ dq, int G, int H, int Sq, int Skv,
                 Strides qs, Strides ks, Strides vs, Strides dos,
                 Strides dqs, float scale, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, KS = C::KS, PS = C::PS;
  constexpr int NR = BQ / C::TR;   // a thread's query rows
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * KS;
  float* sQ = sV + BK * KS;
  float* sDO = sQ + BQ * KS;
  float* sP = sDO + BQ * KS;
  float* sDS = sP + BQ * PS;
  float* sL = sDS + BQ * PS;
  float* sD = sL + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tr = threadIdx.x / C::TC, tc = threadIdx.x % C::TC;
  stage<T, HD>(sQ, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, BQ, Sq - q0,
               scale);
  stage<T, HD>(sDO, dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s, BQ,
               Sq - q0, 1.f);
  stage_rows(sL, sD, lse + ((long long)b * H + h) * Sq,
             Dv + ((long long)b * H + h) * Sq, q0, Sq, BQ);
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // key tiles some row of this query tile needs, as in the forward
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + BQ);
  int k_first = 0;
  if (window > 0) k_first = (max(0, q0 - window + 1) / BK) * BK;

  float acc[NR][C::NC];
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int e = 0; e < C::NC; ++e) acc[a][e] = 0.f;

  for (int k0 = k_first; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    stage<T, HD>(sK, kb + k0 * ks.s, ks.s, BK, Skv - k0, 1.f);
    stage<T, HD>(sV, vb + k0 * vs.s, vs.s, BK, Skv - k0, 1.f);
    __syncthreads();
    scores<HD>(sQ, sDO, sK, sV, sL, sD, sP, sDS, q0, k0, Sq, Skv, causal,
               window);
    __syncthreads();
    // dQ += dS K (scaled at the end)
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float kv[C::NC];
#pragma unroll
      for (int e = 0; e < C::NC; ++e) kv[e] = sK[j * KS + tc + C::TC * e];
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        const float ds = sDS[(tr + C::TR * a) * PS + j];
#pragma unroll
        for (int e = 0; e < C::NC; ++e) acc[a][e] = fmaf(ds, kv[e], acc[a][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int qp = q0 + tr + C::TR * a;
    if (qp >= Sq) continue;
    T* dqr = dq + b * dqs.b + qp * dqs.s + h * dqs.h;
#pragma unroll
    for (int e = 0; e < C::NC; ++e)
      dqr[tc + C::TC * e] = from_f<T>(acc[a][e] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* Dv;
  void *dq, *dk, *dv;
  int B, H, KVH, Sq, Skv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
};

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = Cfg<HD>::SMEM_FLOATS * (int)sizeof(float);
  auto kdkdv = fa_bwd_dkdv_kernel<T, HD>;
  auto kdq = fa_bwd_dq_kernel<T, HD>;
  // once per instantiation (thread-safe static init); one device per process
  static const cudaError_t attr = [] {
    constexpr int bytes = Cfg<HD>::SMEM_FLOATS * (int)sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkdv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(
                     fa_bwd_dq_kernel<T, HD>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }();
  if (attr != cudaSuccess) return attr;
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int G = a.H / a.KVH;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int rows = a.B * a.H * a.Sq;
  fa_bwd_d_kernel<T><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, stream>>>(
      static_cast<const T*>(a.o), dout, a.Dv, a.H, a.Sq, HD, a.os, a.dos,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 g_kv((a.Skv + Cfg<HD>::BK - 1) / Cfg<HD>::BK, a.KVH, a.B);
  kdkdv<<<g_kv, NT, smem, stream>>>(
      q, k, v, dout, a.lse, a.Dv, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      G, a.H, a.Sq, a.Skv, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, scale,
      a.causal, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 g_q((a.Sq + Cfg<HD>::BQ - 1) / Cfg<HD>::BQ, a.H, a.B);
  kdq<<<g_q, NT, smem, stream>>>(q, k, v, dout, a.lse, a.Dv,
                                 static_cast<T*>(a.dq), G, a.H, a.Sq, a.Skv,
                                 a.qs, a.ks, a.vs, a.dos, a.dqs, scale,
                                 a.causal, a.window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o, dout, dq (B, Sq, H, hd); k, v,
// dk, dv (B, Skv, KVH, hd), through element strides (batch, sequence,
// head) with a unit last stride. lse (the forward's) and D (scratch) are
// (B, H, Sq) contiguous fp32. Launches the D pass, the dK/dV kernel and
// the dQ kernel on `stream`; returns the first cudaError_t (0 on
// success); never synchronizes.
extern "C" int faillite_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int dtype, int B, int H, int KVH, int Sq, int Skv, int hd,
    const long long* strides, int causal, int window, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || B <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.Dv = static_cast<float*>(D);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.Sq = Sq;
  a.Skv = Skv;
  // strides: 8 tensors x (batch, sequence, head), in the order
  // q, k, v, o, dout, dq, dk, dv
  Strides* st[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks,
                    &a.dvs};
  for (int i = 0; i < 8; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_hd<float>(hd, a, s);
  if (dtype == 1) return (int)dispatch_hd<__nv_bfloat16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}
