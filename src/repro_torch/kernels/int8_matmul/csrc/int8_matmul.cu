// Weight-only int8 matmul with the dequant in the epilogue, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_int8_mm_kernel` in
// src/repro/kernels/int8_matmul/int8_matmul.py (launched from
// `int8_matmul_pallas`). Computes
//   out[m, n] = cast_out( scale[n] * sum_k f32(x[m, k]) * f32(w_q[k, n]) )
// with x (M, K) float32 or bfloat16, w_q (K, N) int8, scale (N,) float32,
// an fp32 sum and the scale applied once per output, as the TPU kernel's
// `_finalize` does.
//
// Layout: x row-major with row stride ldx (elements) and a unit column
// stride; w_q and out row-major and contiguous. M, N and K may be ragged:
// the kernel masks every edge itself, so the TPU wrapper's pad copies of
// x, w_q and scale are not needed, and rows need not be aligned (an int8
// row of 130 bytes is not).
//
// Design. The TPU grid walks K as its last, sequential axis and keeps the
// accumulator in VMEM scratch. Here one block of 256 threads owns one
// BM x 64 output tile and walks K in tiles of 32 in a loop, the sums in
// fp32 registers (each thread BM/16 rows x 4 columns). Each K step stages
// the x tile and the w_q tile in shared memory as fp32 (int8 widened
// there, never in device memory), and the next step's loads are issued
// into registers before this step's products, so they are in flight
// while it computes. w_q is read as 4-byte words when N % 4 == 0 and the
// base is 4-byte aligned, else byte by byte. BM is 16 for M <= 16 (decode:
// 4 slots) so a block does not compute 64 rows of which 60 are padding,
// and 64 otherwise. Products are scalar fp32 FMAs: f32 inputs never go
// through TF32.
//
// What bounds it on the H100: at decode (M = 4) the int8 weight bytes,
// K * N, over the memory rate; at prefill (M = 256 at qwen3-32b's MLP)
// the 2*M*N*K operations over the bf16 tensor-core rate. This kernel's
// scalar FMAs reach neither: an int8 code is exact in bf16, so mma.sync
// or wgmma on bf16 tiles with fp32 accumulation (x in bf16) is the later
// design, with cp.async/TMA feeding a ring of tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K per step
constexpr int NT = 256;       // threads per block
constexpr int XS = BK + 1;    // row stride of the x tile (no bank conflicts)

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
  return __float2bfloat16(x);  // round to nearest even, as astype() does
}

// One K step's loads, held in registers between issue and store.
template <typename TX, int BM>
struct Tile {
  static constexpr int XN = BM * BK / NT;  // x values per thread
  float x[XN];
  int w[2];                                // 8 int8 codes per thread
};

template <typename TX, int BM>
__device__ __forceinline__ void load_tile(Tile<TX, BM>& t, const TX* x,
                                          const int8_t* w, int M, int N,
                                          int K, long long ldx, int m0,
                                          int n0, int k0, bool vec, int tid) {
#pragma unroll
  for (int u = 0; u < Tile<TX, BM>::XN; ++u) {
    const int i = tid + u * NT, r = i / BK, c = i % BK;
    const int m = m0 + r, k = k0 + c;
    t.x[u] = (m < M && k < K) ? to_f<TX>(x[m * ldx + k]) : 0.f;
  }
  if (vec) {
    // word i of the tile: row i / 16, columns 4 (i % 16) .. +3
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * NT, r = i / 16, c = (i % 16) * 4;
      const int k = k0 + r, n = n0 + c;
      t.w[u] = (k < K && n < N)
                   ? __ldg(reinterpret_cast<const int*>(w + (long long)k * N + n))
                   : 0;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * NT, r = i / 16, c = (i % 16) * 4;
      const int k = k0 + r;
      unsigned int word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + c + e;
        const int8_t b = (k < K && n < N) ? w[(long long)k * N + n] : 0;
        word |= (unsigned int)(uint8_t)b << (8 * e);
      }
      t.w[u] = (int)word;
    }
  }
}

template <typename TX, int BM>
__device__ __forceinline__ void store_tile(const Tile<TX, BM>& t, float* sX,
                                           float* sW, int tid) {
#pragma unroll
  for (int u = 0; u < Tile<TX, BM>::XN; ++u) {
    const int i = tid + u * NT;
    sX[(i / BK) * XS + i % BK] = t.x[u];
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * NT, r = i / 16, c = (i % 16) * 4;
    const unsigned int word = (unsigned int)t.w[u];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sW[r * BN + c + e] = (float)(int8_t)(uint8_t)(word >> (8 * e));
  }
}

template <typename TX, typename TO, int BM>
__global__ void __launch_bounds__(NT)
int8_mm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, TO* __restrict__ out, int M,
               int N, int K, long long ldx, int vec) {
  constexpr int RM = BM / 16;   // rows per thread: ty + 16 i
  __shared__ float sX[BM * XS];
  __shared__ float sW[BK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Tile<TX, BM> t;
  load_tile<TX, BM>(t, x, w, M, N, K, ldx, m0, n0, 0, vec != 0, tid);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's reads of sX/sW are done
    store_tile<TX, BM>(t, sX, sW, tid);
    __syncthreads();
    if (k0 + BK < K)  // next step's loads in flight during the products
      load_tile<TX, BM>(t, x, w, M, N, K, ldx, m0, n0, k0 + BK, vec != 0,
                        tid);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[RM], wv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) xv[i] = sX[(ty + 16 * i) * XS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = sW[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M) out[(long long)m * N + n] = from_f<TO>(acc[i][j] * s);
    }
  }
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   int M, int N, int K, long long ldx, int vec,
                   cudaStream_t stream) {
  const dim3 block(NT);
  if (M <= 16) {
    const dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    int8_mm_kernel<TX, TO, 16><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<TO*>(out), M, N, K, ldx,
        vec);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    int8_mm_kernel<TX, TO, 64><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<TO*>(out), M, N, K, ldx,
        vec);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_out(int out_dtype, const void* x, const void* w,
                         const void* scale, void* out, int M, int N, int K,
                         long long ldx, int vec, cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<TX, float>(x, w, scale, out, M, N, K, ldx, vec, stream);
  if (out_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, w, scale, out, M, N, K, ldx, vec,
                                     stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16, for x and for out. ldx is x's row
// stride in elements. Returns the cudaError_t of the launch (0 on
// success); never synchronizes.
extern "C" int faillite_int8_matmul(const void* x, const void* w,
                                    const void* scale, void* out, int x_dtype,
                                    int out_dtype, int M, int N, int K,
                                    long long ldx, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0);
  if (x_dtype == 0)
    return (int)dispatch_out<float>(out_dtype, x, w, scale, out, M, N, K, ldx,
                                    vec, st);
  if (x_dtype == 1)
    return (int)dispatch_out<__nv_bfloat16>(out_dtype, x, w, scale, out, M, N,
                                            K, ldx, vec, st);
  return (int)cudaErrorInvalidValue;
}
