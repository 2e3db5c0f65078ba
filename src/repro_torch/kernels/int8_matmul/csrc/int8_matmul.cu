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
// the kernels mask every edge themselves, so the TPU wrapper's pad copies
// of x, w_q and scale are not needed, and rows need not be aligned (an int8
// row of 130 bytes is not): unaligned operands are staged by plain loads
// instead of cp.async.
//
// What bounds it on the H100: at decode (M = 4) the int8 weight bytes,
// K * N, over the memory rate (0.039 ms at qwen3-32b's MLP); at prefill
// (M = 256) the 2 M N K operations over the bf16 tensor-core rate (0.068
// ms). The TPU grid walks K as its last, sequential axis with the
// accumulator in VMEM scratch; here a block walks its K range in a loop.
//
// bf16 x, `int8_mm_tc_kernel`, on the tensor cores:
//  - a block of 4 warps owns BM x BN = 128 columns; each warp owns 32
//    columns as four m16n8k16 column tiles and every row of the tile (MT
//    m16 tiles: 1 at decode, M <= 16; 4 above), products
//    mma.sync.m16n8k16 bf16 -> fp32;
//  - x tiles (bf16) and w_q tiles (int8, never widened in memory) fill a
//    ring of STAGES stages of BK = 32 in shared memory through 16-byte
//    cp.async copies (zero-filled past M and K), STAGES - 1 stages in
//    flight while one is computed;
//  - x fragments come from ldmatrix; a w_q fragment is widened to bf16 in
//    registers (an int8 code is exact in bf16; two byte_perm and a float
//    add a code). The columns of the four tiles are interleaved (column j
//    of tile t is 4 j + t of the warp's 32), so one 32-bit shared load
//    gives a k row's codes for all four tiles, and the accumulators of a
//    thread hold 8 neighbouring columns of a row, stored as one vector;
//  - where the output tiles alone do not fill the card (always at decode:
//    40 blocks at qwen3-32b's down projection; 160 at its prefill) the
//    host splits K into n_split ranges (ops.plan_splitk, from M, N, K and
//    the SM count only); each block writes fp32 partial sums to a
//    workspace, and `int8_combine_kernel` adds the splits in split order
//    and applies the scale, so two launches give the same bits;
//  - grid (M tiles, N tiles, splits) with M fastest, so the blocks that
//    share a w_q column tile run together and read it from L2.
// At prefill the issue of the legacy mma.sync path, not the bytes, holds
// it back: a block's K loop alternates a barrier, the stage's loads, the
// widening and the products, and larger warp tiles (64 x 64) lower the
// occupancy without gaining more than they lose. wgmma, with the codes
// widened into shared memory by a producer warpgroup, is the next design.
//
// float32 x, `int8_mm_f32_kernel`: the scalar kernel of the first port,
// unchanged. Tensor cores would mean TF32 (three decimal digits) for x;
// its products are scalar fp32 FMAs over BM x 64 tiles staged as fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype() does
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BK = 32;        // K a stage
constexpr int XS = TC_BK + 8;    // bf16 row stride of an x tile (80 bytes:
                                 // ldmatrix rows in distinct banks)

constexpr int TC_NT = 128;       // threads a block: 4 warps
constexpr int TC_BN = 128;       // output columns a block, 32 a warp
constexpr int WSB = TC_BN + 16;  // byte row stride of a w_q tile (144: the
                                 // fragment loads of a warp in 32 banks)

// A block's tile: MT m16 tiles (BM = 16 MT rows, every warp all of them)
// and STAGES stages in the ring.
template <int MT_, int STAGES_>
struct Tc {
  static constexpr int MT = MT_, STAGES = STAGES_, BM = 16 * MT;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy of which the first `bytes` are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte t of `lo` and byte t of `hi` (int8 codes, each XOR 0x80, i.e. the
// code + 128 as an unsigned byte) as two bf16 in one register, lo in the
// low half. 2^23 + u has u in its low mantissa bits; less 2^23 + 128 it is
// the code, exactly, and an integer of at most 8 bits keeps its high 16
// bits as its bf16.
template <int T>
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t lo, uint32_t hi) {
  constexpr uint32_t SEL = 0x7650 | T;
  const float flo =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, SEL)) - 8388736.f;
  const float fhi =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, SEL)) - 8388736.f;
  return __byte_perm(__float_as_uint(flo), __float_as_uint(fhi), 0x7632);
}

// 8 neighbouring outputs, 16-byte aligned, in one or two vector stores
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// Issue the copies of one stage: x rows m0 .. m0 + BM - 1 and w_q rows
// k0 .. k0 + BK - 1 (k < k_end), columns n0 .. n0 + BN - 1. vx / vw: the
// operand's rows are 16-byte aligned, so cp.async can read them; else
// plain loads and shared stores.
template <class C>
__device__ __forceinline__ void tc_stage(bf16* sx, int8_t* sw,
                                         const bf16* x, const int8_t* w,
                                         int M, int N, long long ldx, int m0,
                                         int n0, int k0, int k_end, bool vx,
                                         bool vw, int tid) {
  // x: BM rows of BK / 8 chunks of 8 bf16
  constexpr int XCH = TC_BK / 8;
  for (int i = tid; i < C::BM * XCH; i += TC_NT) {
    const int r = i / XCH, c = (i % XCH) * 8;
    const int m = m0 + r, k = k0 + c;
    const int valid = (m < M) ? max(0, min(8, k_end - k)) : 0;
    if (vx) {
      cp_async16(sx + r * XS + c, valid ? x + m * ldx + k : x, 2 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sx[r * XS + c + e] =
            e < valid ? x[m * ldx + k + e] : __float2bfloat16(0.f);
    }
  }
  // w_q: BK rows of BN / 16 chunks of 16 codes
  for (int i = tid; i < TC_BK * (TC_BN / 16); i += TC_NT) {
    const int r = i / (TC_BN / 16), c = (i % (TC_BN / 16)) * 16;
    const int k = k0 + r, n = n0 + c;
    const int valid = (k < k_end) ? max(0, min(16, N - n)) : 0;
    if (vw) {
      cp_async16(sw + r * WSB + c, valid ? w + (long long)k * N + n : w,
                 valid);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        sw[r * WSB + c + e] = e < valid ? w[(long long)k * N + n + e] : 0;
    }
  }
}

template <class C, typename TO>
__global__ void __launch_bounds__(TC_NT)
int8_mm_tc_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, TO* __restrict__ out,
                  float* __restrict__ ws, int M, int N, int K, long long ldx,
                  int k_chunk, int vx, int vw, int vo) {
  constexpr int MT = C::MT, STAGES = C::STAGES;
  constexpr int XT = C::BM * XS, WT = TC_BK * WSB;  // a stage's tiles
  __shared__ __align__(128) bf16 sx0[STAGES * XT];
  __shared__ __align__(128) int8_t sw0[STAGES * WT];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * TC_BN;
  const int split = blockIdx.z;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int steps = (k_end - k_begin + TC_BK - 1) / TC_BK;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][t][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      tc_stage<C>(sx0 + s * XT, sw0 + s * WT, x, w, M, N, ldx, m0, n0,
                  k_begin + s * TC_BK, k_end, vx, vw, tid);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();   // stage `it` has landed
    __syncthreads();               // ... for every thread; and the slot
                                   // read in iteration it - 1 is free
    const int nxt = it + STAGES - 1;
    if (nxt < steps) {
      const int sl = nxt % STAGES;
      tc_stage<C>(sx0 + sl * XT, sw0 + sl * WT, x, w, M, N, ldx, m0, n0,
                  k_begin + nxt * TC_BK, k_end, vx, vw, tid);
    }
    cp_async_commit();
    const int sl = it % STAGES;
    const bf16* sx = sx0 + sl * XT;
    const int8_t* sw = sw0 + sl * WT + warp * 32 + 4 * g;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], sx + (16 * i + lane % 16) * XS + kk + (lane / 16) * 8);
      // rows 2q, 2q + 1, 2q + 8 and 2q + 9 of the k16 step, each word the
      // codes of the four tiles' column g
      const uint32_t flip = 0x80808080u;
      const int8_t* wr = sw + (kk + 2 * q) * WSB;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr) ^ flip;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + WSB) ^ flip;
      const uint32_t w2 =
          *reinterpret_cast<const uint32_t*>(wr + 8 * WSB) ^ flip;
      const uint32_t w3 =
          *reinterpret_cast<const uint32_t*>(wr + 9 * WSB) ^ flip;
      uint32_t b0[4], b1[4];
      b0[0] = codes_bf16x2<0>(w0, w1);
      b0[1] = codes_bf16x2<1>(w0, w1);
      b0[2] = codes_bf16x2<2>(w0, w1);
      b0[3] = codes_bf16x2<3>(w0, w1);
      b1[0] = codes_bf16x2<0>(w2, w3);
      b1[1] = codes_bf16x2<1>(w2, w3);
      b1[2] = codes_bf16x2<2>(w2, w3);
      b1[3] = codes_bf16x2<3>(w2, w3);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_bf16(acc[i][t], a[i], b0[t], b1[t]);
    }
  }
  cp_async_wait<0>();

  // A thread holds, for rows g and g + 8 of each m tile, the 8 columns
  // nc .. nc + 7: column nc + e is tile e % 4, accumulator e / 4 (+ 2 for
  // row g + 8).
  const int nc = n0 + warp * 32 + 8 * q;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    sc[e] = (ws == nullptr && nc + e < N) ? scale[nc + e] : 1.f;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 16 * i + g + 8 * half;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = acc[i][e % 4][e / 4 + 2 * half] * sc[e];
      if (ws != nullptr) {
        float* dst = ws + ((long long)split * M + m) * N + nc;
        if (vo && nc + 8 <= N) {
          store8(dst, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (nc + e < N) dst[e] = v[e];
        }
      } else {
        TO* dst = out + (long long)m * N + nc;
        if (vo && nc + 8 <= N) {
          store8(dst, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (nc + e < N) dst[e] = from_f<TO>(v[e]);
        }
      }
    }
  }
}

// out = (sum over splits, in split order) * scale, cast
template <typename TO>
__global__ void __launch_bounds__(256)
int8_combine_kernel(const float* __restrict__ ws,
                    const float* __restrict__ scale, TO* __restrict__ out,
                    int M, int N, int n_split) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float s = ws[i];
  for (int p = 1; p < n_split; ++p) s += ws[p * mn + i];
  out[i] = from_f<TO>(s * scale[i % N]);
}

template <class C, typename TO>
cudaError_t launch_tc(const void* x, const void* w, const void* scale,
                      void* out, void* ws, int M, int N, int K, long long ldx,
                      int n_split, int k_chunk, cudaStream_t stream) {
  const int vx = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0;
  const int vw = reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 16 == 0;
  const int vo = N % 8 == 0;
  float* wsf = n_split > 1 ? static_cast<float*>(ws) : nullptr;
  const dim3 grid((M + C::BM - 1) / C::BM, (N + TC_BN - 1) / TC_BN, n_split);
  int8_mm_tc_kernel<C, TO><<<grid, TC_NT, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<TO*>(out), wsf, M, N, K,
      ldx, k_chunk, vx, vw, vo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long mn = (long long)M * N;
  int8_combine_kernel<TO><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      wsf, static_cast<const float*>(scale), static_cast<TO*>(out), M, N,
      n_split);
  return cudaGetLastError();
}

// the two tile shapes: decode (one 16-row tile, 16 x 128; 35 KB of
// shared memory) and prefill (64 x 128; 39 KB), both static
using TcDecode = Tc<1, 6>;
using TcPrefill = Tc<4, 4>;

// ---------------------------------------------------------------------------
// float32 x: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K per step
constexpr int NT = 256;       // threads per block
constexpr int FS = BK + 1;    // row stride of the x tile (no bank conflicts)

// One K step's loads, held in registers between issue and store.
template <int BM>
struct Tile {
  static constexpr int XN = BM * BK / NT;  // x values per thread
  float x[XN];
  int w[2];                                // 8 int8 codes per thread
};

template <int BM>
__device__ __forceinline__ void load_tile(Tile<BM>& t, const float* x,
                                          const int8_t* w, int M, int N,
                                          int K, long long ldx, int m0,
                                          int n0, int k0, bool vec, int tid) {
#pragma unroll
  for (int u = 0; u < Tile<BM>::XN; ++u) {
    const int i = tid + u * NT, r = i / BK, c = i % BK;
    const int m = m0 + r, k = k0 + c;
    t.x[u] = (m < M && k < K) ? x[m * ldx + k] : 0.f;
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

template <int BM>
__device__ __forceinline__ void store_tile(const Tile<BM>& t, float* sX,
                                           float* sW, int tid) {
#pragma unroll
  for (int u = 0; u < Tile<BM>::XN; ++u) {
    const int i = tid + u * NT;
    sX[(i / BK) * FS + i % BK] = t.x[u];
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

template <typename TO, int BM>
__global__ void __launch_bounds__(NT)
int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, TO* __restrict__ out,
                   int M, int N, int K, long long ldx, int vec) {
  constexpr int RM = BM / 16;   // rows per thread: ty + 16 i
  __shared__ float sX[BM * FS];
  __shared__ float sW[BK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Tile<BM> t;
  load_tile<BM>(t, x, w, M, N, K, ldx, m0, n0, 0, vec != 0, tid);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's reads of sX/sW are done
    store_tile<BM>(t, sX, sW, tid);
    __syncthreads();
    if (k0 + BK < K)  // next step's loads in flight during the products
      load_tile<BM>(t, x, w, M, N, K, ldx, m0, n0, k0 + BK, vec != 0, tid);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[RM], wv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) xv[i] = sX[(ty + 16 * i) * FS + kk];
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

template <typename TO>
cudaError_t launch_f32(const void* x, const void* w, const void* scale,
                       void* out, int M, int N, int K, long long ldx,
                       cudaStream_t stream) {
  const int vec = (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const dim3 block(NT);
  if (M <= 16) {
    const dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    int8_mm_f32_kernel<TO, 16><<<grid, block, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<TO*>(out), M, N, K, ldx,
        vec);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    int8_mm_f32_kernel<TO, 64><<<grid, block, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<TO*>(out), M, N, K, ldx,
        vec);
  }
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch(int x_dtype, const void* x, const void* w,
                     const void* scale, void* out, void* ws, int M, int N,
                     int K, long long ldx, int n_split, int k_chunk,
                     cudaStream_t stream) {
  if (x_dtype == 0) {
    if (n_split != 1) return cudaErrorInvalidValue;
    return launch_f32<TO>(x, w, scale, out, M, N, K, ldx, stream);
  }
  if (x_dtype != 1) return cudaErrorInvalidValue;
  if (M <= 16)
    return launch_tc<TcDecode, TO>(x, w, scale, out, ws, M, N, K, ldx,
                                   n_split, k_chunk, stream);
  return launch_tc<TcPrefill, TO>(x, w, scale, out, ws, M, N, K, ldx,
                                  n_split, k_chunk, stream);
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16, for x and for out. ldx is x's row
// stride in elements. bf16 x: K is cut into n_split ranges of k_chunk (a
// multiple of 32, none empty); with n_split > 1, ws is an fp32 workspace of
// n_split * M * N. float32 x takes n_split = 1. Returns the cudaError_t of
// the launch (0 on success); never synchronizes.
extern "C" int faillite_int8_matmul(const void* x, const void* w,
                                    const void* scale, void* out, void* ws,
                                    int x_dtype, int out_dtype, int M, int N,
                                    int K, int n_split, int k_chunk,
                                    long long ldx, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || n_split <= 0 || k_chunk <= 0 ||
      k_chunk % TC_BK != 0 || (long long)n_split * k_chunk < K ||
      (long long)(n_split - 1) * k_chunk >= K ||
      (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return (int)dispatch<float>(x_dtype, x, w, scale, out, ws, M, N, K, ldx,
                                n_split, k_chunk, st);
  if (out_dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x_dtype, x, w, scale, out, ws, M, N,
                                        K, ldx, n_split, k_chunk, st);
  return (int)cudaErrorInvalidValue;
}
