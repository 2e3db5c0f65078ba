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
// with a unit last stride, fp32 sums throughout:
//
//   D  = rowsum(dO * O)                                (fa_bwd_d_kernel)
//   P  = exp(scale S - lse), S = q k^T, from the forward's lse
//   dS = P * (dO V^T - D)
//   dV = sum over the group's heads of P^T dO           (fa_bwd_dkdv_kernel)
//   dK = scale sum over the group's heads of dS^T q
//   dQ = scale dS K                                     (fa_bwd_dq_kernel)
//
// What bounds it on the H100: the five products are 2.5x the forward's
// operations. At the 3xTF32 rate (the TF32 tensor-core rate over three
// products) the f32 rows of PERF.md's table are bound by operations
// (qwen2.5-3b S=256 0.0082 ms, arctic-480b G = 7 0.014, whisper's encoder
// 0.14, recurrentgemma-2b hd 256 0.34, gemma3-27b's window 0.40) but for
// whisper's 64 x 1500 cross attention, bound by bytes (0.0077 ms) as is
// the bf16 qwen2.5-3b row (0.0028 ms). At S = 256 the work is small, so
// how many blocks are in flight sets the time as much as the products
// do. The design:
//  - every product runs on the tensor cores with fp32 accumulators: bf16
//    inputs as mma.sync.m16n8k16 bf16, fp32 inputs as 3xTF32
//    (mma.sync.m16n8k8 with each operand split into a TF32 high part and
//    a TF32 remainder, hi.hi + hi.lo + lo.hi, as rwkv6_scan.cu's chunked
//    route does), which keeps about 21 bits of each product: plain TF32
//    keeps 11 and would break the f32 tolerance (1e-4 of max|g|);
//  - K, V, Q and dO tiles stay in the input dtype in shared memory, filled
//    by 16-byte cp.async copies, the streamed tiles through a 2-stage ring
//    so the next tile loads while the current one is computed. bf16 rows
//    use the forward's 16-byte XOR swizzle and ldmatrix (.trans for an
//    operand read along its rows); fp32 rows are padded by 4 words, so the
//    fragment loads of a warp hit 32 distinct banks;
//  - the dK/dV kernel computes the transposed scores S^T = K q^T and
//    dP^T = V dO^T directly: a warp owns 16 keys, so P^T and dS^T are its
//    accumulator fragments, and they feed dV += P^T dO and dK += dS^T q as
//    the A operand from registers (packed to bf16; in fp32 split hi/lo,
//    with the k index permuted to match the accumulator layout and B read
//    in the same order). The dQ kernel does the same with S and dS for its
//    16 query rows. Nothing round-trips through shared memory; rounding P
//    and dS to bf16 is the bf16 route's one change in numerics;
//  - a block is two groups of four warps. In a group each warp owns 16
//    output rows and up to 128 of their columns (at head_dim 256 two warps
//    share 16 rows, each holding half of the dK/dV (dQ) accumulators and
//    recomputing the same scores), so no instantiation holds more than 128
//    accumulator registers a thread. The two groups own the same outputs
//    and split each streamed tile (the queries of a dK/dV step, the keys
//    of a dQ step), so a block keeps two warps on each of the SM's four
//    schedulers: at S = 256 the grid is about one block an SM, and one
//    warp a scheduler cannot hide the latency of the shared-memory loads
//    and the dependent products. Group 1 adds its sums into group 0's at
//    the end, in that fixed order;
//  - the GQA group: when B x KVH x key tiles blocks are under 1.5 waves of
//    one block an SM (qwen2.5-3b B=2 S=256: 16 blocks for 132 SMs), the
//    wrapper's launch plan (ops.py `plan_bwd`, from the shapes and the SM
//    count alone) splits it: one block per (query head, key tile) writes
//    fp32 partial dK/dV into a scratch (B, Skv, H, hd) x 2, and
//    `fa_bwd_dkdv_reduce_kernel` sums each group's G partials in the order
//    g = 0 .. G-1. Otherwise one block walks its group's heads in a loop,
//    which saves the partials' round trip where the grid already fills
//    the card (gemma3-27b's 528 blocks). Either way there are no atomics
//    and two runs give bit-equal gradients;
//  - dQ stays a separate pass over (b, h, query tile) that recomputes S
//    and dP: atomics would lose bit-equal repeats and a per-key-tile
//    scratch would hold (B, key tiles, Sq, H, hd) fp32;
//  - tiles wholly above the causal diagonal, wholly outside the window or
//    past Sq / Skv are skipped (a warp skips its part of a tile that is
//    masked for all of its rows), masks are evaluated only on tiles that
//    cut an edge, and masked entries of P are exactly 0. Key tiles
//    (dK/dV) and query tiles (dQ) are launched longest first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NGRP = 2;            // warp groups of the dK/dV and dQ kernels
constexpr int GT = 128;            // threads a group: 4 warps
constexpr int NT = NGRP * GT;      // threads of the dK/dV and dQ kernels
constexpr int D_NT = 256;          // threads of the D pass
constexpr int R_NT = 256;          // threads of the group reduction
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// Copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
// 4-byte copy, zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of 16-byte chunk c of row r in a bf16 tile of HD values a
// row, XOR-swizzled as in flash_attention.cu: the 8 rows an ldmatrix reads
// at one chunk column land in 8 distinct 16-byte bank groups.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int NCH = HD / 8;
  if constexpr (NCH >= 8)
    return (r * NCH + (c ^ (r & 7))) * 8;
  else
    return (r * NCH + (c ^ ((r / (8 / NCH)) & (NCH - 1)))) * 8;
}

// Tiles of `rows` rows of HD values: bf16 swizzled, fp32 with rows padded
// to HD + 4 words (row stride = 4 mod 32 banks).
template <typename T, int HD>
struct Tile;
template <int HD>
struct Tile<bf16, HD> {
  static constexpr int CH = 8;   // values a 16-byte chunk
  __host__ __device__ static constexpr int elems(int rows) {
    return rows * HD;
  }
  __device__ static int chunk(int r, int c) { return swz<HD>(r, c); }
};
template <int HD>
struct Tile<float, HD> {
  static constexpr int CH = 4;
  static constexpr int LD = HD + 4;
  __host__ __device__ static constexpr int elems(int rows) {
    return rows * LD;
  }
  __device__ static int chunk(int r, int c) { return r * LD + 4 * c; }
};

// Issue the cp.async copies of `rows` rows into a tile; row r comes from
// src + r * rs, and rows at or past `valid` are zero-filled (their source
// address is row 0, never read).
template <typename T, int HD>
__device__ __forceinline__ void tile_async(T* dst, const T* src, long long rs,
                                           int rows, int valid) {
  using TL = Tile<T, HD>;
  constexpr int NCH = HD / TL::CH;
  for (int i = threadIdx.x; i < rows * NCH; i += NT) {
    const int r = i / NCH, c = i % NCH;
    const bool ok = r < valid;
    cp_async16(dst + TL::chunk(r, c), src + (ok ? r : 0) * rs + c * TL::CH,
               ok);
  }
}

// n values of a (B, H, Sq) fp32 row from position p0 (zero past Sq)
__device__ __forceinline__ void row_async(float* dst, const float* row,
                                          int p0, int Sq, int n) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool ok = p0 + i < Sq;
    cp_async4(dst + i, row + (ok ? p0 + i : 0), ok);
  }
}

// ---------------------------------------------------------------------------
// Warp products. Fragment layouts (g = lane / 4, t = lane % 4): the fp32
// accumulator of a 16 x 8 tile holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1) in both instructions.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

// two floats -> one register of two bf16 (lo in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32: hi keeps 11 significant bits, lo the next 11
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// m16n8k8 TF32: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (t, g), b1 (t + 4, g)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += a * b[j] (j < JG) in 3xTF32: hi.hi + hi.lo + lo.hi, the small
// terms first, each term issued for all JG tiles before the next, so no
// product waits on the one just before it
template <int JG>
__device__ __forceinline__ void mma_3xtf32(float (*acc)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[JG][2],
                                           const uint32_t (&bl)[JG][2]) {
#pragma unroll
  for (int j = 0; j < JG; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < JG; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < JG; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
}

// acc[j] (j < NJ) += A[a0 .. a0 + 16)[0 .. HD) * B[b0 + 8 j .. + 8)[0 .. HD)^T:
// rows of two tiles against each other (S = q k^T and dP = dO V^T, or
// their transposes)
template <int HD, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4], const bf16* tA,
                                         int a0, const bf16* tB, int b0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd) {
    uint32_t a[4];
    ldsm_x4(a, tA + swz<HD>(a0 + (lane & 15), 2 * kd + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j) {
      uint32_t bb[4];
      ldsm_x4(bb, tB + swz<HD>(b0 + 16 * j + ((lane >> 4) << 3) + (lane & 7),
                               2 * kd + ((lane >> 3) & 1)));
      mma_bf16(acc[2 * j], a, bb[0], bb[1]);
      mma_bf16(acc[2 * j + 1], a, bb[2], bb[3]);
    }
  }
}
template <int HD, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4], const float* tA,
                                         int a0, const float* tB, int b0) {
  constexpr int LD = Tile<float, HD>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k0 = 0; k0 < HD; k0 += 8) {
    const float* pa = tA + (a0 + g) * LD + k0 + t;
    uint32_t ah[4], al[4];
    split(pa[0], ah[0], al[0]);
    split(pa[8 * LD], ah[1], al[1]);
    split(pa[4], ah[2], al[2]);
    split(pa[8 * LD + 4], ah[3], al[3]);
    constexpr int JG = NJ < 4 ? NJ : 4;   // n-tiles a 3xTF32 group
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += JG) {
      uint32_t bh[JG][2], bl[JG][2];
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        const float* pb = tB + (b0 + 8 * (j0 + j) + g) * LD + k0 + t;
        split(pb[0], bh[j][0], bl[j][0]);
        split(pb[4], bh[j][1], bl[j][1]);
      }
      mma_3xtf32<JG>(acc + j0, ah, al, bh, bl);
    }
  }
}

// acc[j] (j < NJ) += X * B[r0 .. r0 + 8 NI)[c0 + 8 j .. + 8): X the 16 x 8 NI
// matrix whose 16 x 8 tiles are the accumulator fragments x[0 .. NI) (P^T,
// dS^T or dS), B a tile read along its rows (dO, q or K)
template <int HD, int NI, int NJ>
__device__ __forceinline__ void mma_regs(float (&acc)[NJ][4],
                                         const float (&x)[NI][4],
                                         const bf16* tB, int r0, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NI / 2; ++kk) {
    // two accumulator tiles side by side are one m16n8k16 A fragment
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j) {
      uint32_t bb[4];
      ldsm_x4_t(bb, tB + swz<HD>(r0 + 16 * kk + (lane & 7) +
                                     (((lane >> 3) & 1) << 3),
                                 c0 / 8 + 2 * j + (lane >> 4)));
      mma_bf16(acc[2 * j], a, bb[0], bb[1]);
      mma_bf16(acc[2 * j + 1], a, bb[2], bb[3]);
    }
  }
}
template <int HD, int NI, int NJ>
__device__ __forceinline__ void mma_regs(float (&acc)[NJ][4],
                                         const float (&x)[NI][4],
                                         const float* tB, int r0, int c0) {
  constexpr int LD = Tile<float, HD>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NI; ++kk) {
    // the k index is permuted: A's columns t and t + 4 are the
    // accumulator's 2t and 2t + 1, and B's rows are read in that order
    uint32_t ah[4], al[4];
    split(x[kk][0], ah[0], al[0]);
    split(x[kk][2], ah[1], al[1]);
    split(x[kk][1], ah[2], al[2]);
    split(x[kk][3], ah[3], al[3]);
    constexpr int JG = NJ < 4 ? NJ : 4;   // n-tiles a 3xTF32 group
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += JG) {
      uint32_t bh[JG][2], bl[JG][2];
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        const float* pb =
            tB + (r0 + 8 * kk + 2 * t) * LD + c0 + 8 * (j0 + j) + g;
        split(pb[0], bh[j][0], bl[j][0]);
        split(pb[LD], bh[j][1], bl[j][1]);
      }
      mma_3xtf32<JG>(acc + j0, ah, al, bh, bl);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// two adjacent values of a row of T
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// ---------------------------------------------------------------------------
// Tile sizes of one (dtype, head_dim). A block is NGRP groups of 4 warps.
// A warp owns 16 output rows (keys in dK/dV, queries in dQ) and DW of the
// HD output columns; the groups own the same outputs and take different
// parts of each streamed tile (queries in dK/dV, keys in dQ), and group 1
// adds its sums into group 0's at the end, in that fixed order.
// ---------------------------------------------------------------------------

template <typename T, int HD>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int DW = HD < 128 ? HD : 128;
  static constexpr int NCG = HD / DW;       // column groups
  static constexpr int NRG = 4 / NCG;       // row groups of 16
  // dK/dV: keys a block (ops.py `plan_bwd`'s bk), queries a group's step
  static constexpr int BK = 16 * NRG;
  static constexpr int BQ = HD >= 256 ? 16 : 32;
  // dQ: queries a block, keys a group's step (fp32 tiles are twice the
  // bytes)
  static constexpr int BQD = 16 * NRG;
  static constexpr int BKD =
      HD >= 256 ? (F32 ? 16 : 32) : (F32 && HD >= 128 ? 32 : 64);
  // rows of a stage of the streamed tiles
  static constexpr int SQ = NGRP * BQ, SK = NGRP * BKD;
  static constexpr int SMEM_KV =
      (2 * Tile<T, HD>::elems(BK) + 4 * Tile<T, HD>::elems(SQ)) *
          (int)sizeof(T) +
      4 * SQ * (int)sizeof(float);
  static constexpr int SMEM_Q =
      (2 * Tile<T, HD>::elems(BQD) + 4 * Tile<T, HD>::elems(SK)) *
      (int)sizeof(T);
  // group 1's accumulators on their way to group 0 fit in the streamed
  // tiles' stages
  static_assert((DW / 8) * 4 * GT * (int)sizeof(float) <=
                    4 * Tile<T, HD>::elems(SQ) * (int)sizeof(T),
                "dK/dV reduction does not fit");
  static_assert((DW / 8) * 4 * GT * (int)sizeof(float) <=
                    4 * Tile<T, HD>::elems(SK) * (int)sizeof(T),
                "dQ reduction does not fit");
};

// Group 1 hands its accumulators to group 0 through shared memory `red`,
// and group 0 adds them to its own.
template <int NJ>
__device__ __forceinline__ void add_group1(float (&acc)[NJ][4], float* red) {
  const int grp = threadIdx.x / GT, tg = threadIdx.x % GT;
  __syncthreads();   // every earlier read of red's memory is done
  if (grp == 1) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(j * 4 + e) * GT + tg] = acc[j][e];
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += red[(j * 4 + e) * GT + tg];
  }
}

template <typename T>
__global__ void __launch_bounds__(D_NT)
fa_bwd_d_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ Dv, int H, int Sq, int hd, Strides os,
                Strides dos, int rows) {
  const int row = (blockIdx.x * D_NT + threadIdx.x) / 32;
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

// One block per (head, b, key tile), key tiles in grid z (the first,
// longest under a causal mask, first). Unsplit (part == null): the head is
// a KV head and the block walks the query tiles of its G query heads,
// writing dk/dv. Split: the head is a query head and the block writes its
// fp32 partial dK/dV to part (B, Skv, H, HD) and part + B Skv H HD. Each
// stage holds NGRP x BQ queries, BQ for each warp group.
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ Dv,
                   T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ part, int G, int H, int Sq, int Skv,
                   Strides qs, Strides ks, Strides vs, Strides dos,
                   Strides dks, Strides dvs, float scale, float scale_log2,
                   int causal, int window) {
  using C = Cfg<T, HD>;
  using TL = Tile<T, HD>;
  constexpr int BK = C::BK, BQ = C::BQ, SQ = C::SQ, NQ = BQ / 8;
  constexpr int NJ = C::DW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + TL::elems(BK);
  T* sQ = sV + TL::elems(BK);            // 2 stages
  T* sDO = sQ + 2 * TL::elems(SQ);       // 2 stages
  float* sL = reinterpret_cast<float*>(sDO + 2 * TL::elems(SQ));
  float* sD = sL + 2 * SQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / 4, rg = warp % 4 % C::NRG, cg = warp % 4 / C::NRG;
  const int b = blockIdx.y, k0 = blockIdx.z * BK;
  const bool split_group = part != nullptr;
  const int kvh = split_group ? blockIdx.x / G : blockIdx.x;
  const int h0 = split_group ? blockIdx.x : kvh * G;
  const int nh = split_group ? 1 : G;

  // query stages that see some key of this tile: at or below the causal
  // diagonal, inside the window (q < k + window)
  const int q_first = causal ? (k0 / SQ) * SQ : 0;
  const int q_end = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  const int n_qt = q_end > q_first ? (q_end - q_first + SQ - 1) / SQ : 0;
  const int n_it = nh * n_qt;

  auto stage = [&](int it, int st) {
    const int h = h0 + it / n_qt, q0 = q_first + (it % n_qt) * SQ;
    tile_async<T, HD>(sQ + st * TL::elems(SQ), q + b * qs.b + h * qs.h +
                      q0 * qs.s, qs.s, SQ, Sq - q0);
    tile_async<T, HD>(sDO + st * TL::elems(SQ), dout + b * dos.b +
                      h * dos.h + q0 * dos.s, dos.s, SQ, Sq - q0);
    const long long row = ((long long)b * H + h) * Sq;
    row_async(sL + st * SQ, lse + row, q0, Sq, SQ);
    row_async(sD + st * SQ, Dv + row, q0, Sq, SQ);
  };
  tile_async<T, HD>(sK, k + b * ks.b + kvh * ks.h + k0 * ks.s, ks.s, BK,
                    Skv - k0);
  tile_async<T, HD>(sV, v + b * vs.b + kvh * vs.h + k0 * vs.s, vs.s, BK,
                    Skv - k0);
  if (n_it > 0) stage(0, 0);
  cp_async_commit();

  const int kw = k0 + 16 * rg;   // this warp's first key
  const int c0 = cg * C::DW;     // and first output column
  const int r0 = grp * BQ;       // and its group's first query of a stage
  float adk[NJ][4], adv[NJ][4];
  zero(adk);
  zero(adv);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int q0 = q_first + (it % n_qt) * SQ + r0;   // the group's queries
    if (it + 1 < n_it) {
      stage(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // stage st (and K, V) landed for every thread's copies
    const T* tQ = sQ + st * TL::elems(SQ);
    const T* tDO = sDO + st * TL::elems(SQ);
    const float* tL = sL + st * SQ + r0;
    const float* tD = sD + st * SQ + r0;

    // this warp's 16 keys against its group's queries: skip when every
    // pair is masked
    bool skip = kw >= Skv || q0 >= Sq;
    if (causal && q0 + BQ - 1 < kw) skip = true;
    if (window > 0 && kw + 15 <= q0 - window) skip = true;
    if (!skip) {
      float s[NQ][4], dp[NQ][4];
      zero(s);
      zero(dp);
      mma_rows<HD, NQ>(s, sK, 16 * rg, tQ, r0);     // S^T = K q^T
      mma_rows<HD, NQ>(dp, sV, 16 * rg, tDO, r0);   // dP^T = V dO^T
      const bool need_mask = kw + 16 > Skv || q0 + BQ > Sq ||
                             (causal && q0 < kw + 15) ||
                             (window > 0 && kw <= q0 + BQ - 1 - window);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jq = 8 * j + 2 * t + (e & 1);   // the group's query
          bool ok = true;
          if (need_mask) {
            const int key = kw + g + 8 * (e >> 1), qp = q0 + jq;
            ok = key < Skv && qp < Sq;
            if (causal) ok = ok && qp >= key;
            if (window > 0) ok = ok && key > qp - window;
          }
          const float p =
              ok ? exp2f(fmaf(s[j][e], scale_log2, -tL[jq] * LOG2E)) : 0.f;
          s[j][e] = p;                         // P^T
          dp[j][e] = p * (dp[j][e] - tD[jq]);  // dS^T
        }
      mma_regs<HD, NQ, NJ>(adv, s, tDO, r0, c0);   // dV += P^T dO
      mma_regs<HD, NQ, NJ>(adk, dp, tQ, r0, c0);   // dK += dS^T q
    }
    __syncthreads();   // every warp is done with stage st before its reload
  }
  cp_async_wait<0>();   // K and V's copies, when no tile was visited
  float* red = reinterpret_cast<float*>(sQ);
  add_group1(adk, red);
  add_group1(adv, red);
  if (grp != 0) return;

  const long long half = (long long)gridDim.y * Skv * H * HD;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kw + g + 8 * i;
      if (key >= Skv) continue;
      const int col = c0 + 8 * j + 2 * t;
      const float kx = adk[j][2 * i] * scale, ky = adk[j][2 * i + 1] * scale;
      const float vx = adv[j][2 * i], vy = adv[j][2 * i + 1];
      if (split_group) {
        float* pk = part + (((long long)b * Skv + key) * H + h0) * HD + col;
        store2(pk, kx, ky);
        store2(pk + half, vx, vy);
      } else {
        store2(dk + b * dks.b + key * dks.s + kvh * dks.h + col, kx, ky);
        store2(dv + b * dvs.b + key * dvs.s + kvh * dvs.h + col, vx, vy);
      }
    }
}

// dk/dv[b, key, kvh] = the sum of part[b, key, kvh G + g] over g = 0 .. G-1
// in that order, each thread 4 values of one row of dk and of dv.
template <typename T, int HD>
__global__ void __launch_bounds__(R_NT)
fa_bwd_dkdv_reduce_kernel(const float* __restrict__ part,
                          T* __restrict__ dk, T* __restrict__ dv, int G,
                          int H, int KVH, int Skv, Strides dks, Strides dvs,
                          long long n4, long long half) {
  const long long i = (long long)blockIdx.x * R_NT + threadIdx.x;
  if (i >= n4) return;
  constexpr int V4 = HD / 4;
  const int c = (int)(i % V4) * 4;
  long long r = i / V4;
  const int kvh = (int)(r % KVH);
  r /= KVH;
  const int key = (int)(r % Skv), b = (int)(r / Skv);
  const float* pk = part + (((long long)b * Skv + key) * H + kvh * G) * HD + c;
  float4 sk = *reinterpret_cast<const float4*>(pk);
  float4 sv = *reinterpret_cast<const float4*>(pk + half);
  for (int gg = 1; gg < G; ++gg) {
    const float4 x = *reinterpret_cast<const float4*>(pk + gg * HD);
    const float4 y = *reinterpret_cast<const float4*>(pk + half + gg * HD);
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  T* rk = dk + b * dks.b + key * dks.s + kvh * dks.h + c;
  T* rv = dv + b * dvs.b + key * dvs.s + kvh * dvs.h + c;
  store2(rk, sk.x, sk.y);
  store2(rk + 2, sk.z, sk.w);
  store2(rv, sv.x, sv.y);
  store2(rv + 2, sv.z, sv.w);
}

// One block per (h, b, query tile), query tiles in grid z, longest (last
// under a causal mask) first; the block walks the key tiles its rows see,
// NGRP x BKD keys a stage, BKD for each warp group.
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ Dv,
                 T* __restrict__ dq, int G, int H, int Sq, int Skv,
                 Strides qs, Strides ks, Strides vs, Strides dos,
                 Strides dqs, float scale, float scale_log2, int causal,
                 int window) {
  using C = Cfg<T, HD>;
  using TL = Tile<T, HD>;
  constexpr int BQ = C::BQD, BKT = C::BKD, SK = C::SK, NK = BKT / 8;
  constexpr int NJ = C::DW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + TL::elems(BQ);
  T* sK = sDO + TL::elems(BQ);           // 2 stages
  T* sV = sK + 2 * TL::elems(SK);        // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / 4, rg = warp % 4 % C::NRG, cg = warp % 4 / C::NRG;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / G;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // key stages some row of this query tile needs, as in the forward
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + BQ);
  int k_first = 0;
  if (window > 0) k_first = (max(0, q0 - window + 1) / SK) * SK;
  const int n_tiles = k_end > k_first ? (k_end - k_first + SK - 1) / SK : 0;

  tile_async<T, HD>(sQ, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, BQ,
                    Sq - q0);
  tile_async<T, HD>(sDO, dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s,
                    BQ, Sq - q0);
  if (n_tiles > 0) {
    tile_async<T, HD>(sK, kb + k_first * ks.s, ks.s, SK, Skv - k_first);
    tile_async<T, HD>(sV, vb + k_first * vs.s, vs.s, SK, Skv - k_first);
  }
  cp_async_commit();

  const int wq = q0 + 16 * rg;   // this warp's first query row
  const int c0 = cg * C::DW;
  const int r0 = grp * BKT;      // its group's first key of a stage
  // lse (in log2 units) and D of the thread's rows wq + g and wq + g + 8
  float l2[2], dd[2];
  const long long row = ((long long)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = wq + g + 8 * i;
    l2[i] = qp < Sq ? lse[row + qp] * LOG2E : 0.f;
    dd[i] = qp < Sq ? Dv[row + qp] : 0.f;
  }
  float acc[NJ][4];
  zero(acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = k_first + it * SK + r0;   // the group's keys
    if (it + 1 < n_tiles) {
      const int k1 = k_first + (it + 1) * SK;
      tile_async<T, HD>(sK + (st ^ 1) * TL::elems(SK), kb + k1 * ks.s, ks.s,
                        SK, Skv - k1);
      tile_async<T, HD>(sV + (st ^ 1) * TL::elems(SK), vb + k1 * vs.s, vs.s,
                        SK, Skv - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // stage it (and q, dO) landed for every thread's copies
    const T* tK = sK + st * TL::elems(SK);
    const T* tV = sV + st * TL::elems(SK);

    bool skip = wq >= Sq || k0 >= Skv;
    if (causal && k0 > wq + 15) skip = true;
    if (window > 0 && k0 + BKT - 1 <= wq - window) skip = true;
    if (!skip) {
      float s[NK][4], dp[NK][4];
      zero(s);
      zero(dp);
      mma_rows<HD, NK>(s, sQ, 16 * rg, tK, r0);     // S = q K^T
      mma_rows<HD, NK>(dp, sDO, 16 * rg, tV, r0);   // dP = dO V^T
      const bool need_mask = k0 + BKT > Skv || wq + 16 > Sq ||
                             (causal && k0 + BKT - 1 > wq) ||
                             (window > 0 && k0 <= wq + 15 - window);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          bool ok = true;
          if (need_mask) {
            const int qp = wq + g + 8 * i, key = k0 + 8 * j + 2 * t + (e & 1);
            ok = key < Skv && qp < Sq;
            if (causal) ok = ok && qp >= key;
            if (window > 0) ok = ok && key > qp - window;
          }
          const float p = ok ? exp2f(fmaf(s[j][e], scale_log2, -l2[i])) : 0.f;
          dp[j][e] = p * (dp[j][e] - dd[i]);   // dS
        }
      mma_regs<HD, NK, NJ>(acc, dp, tK, r0, c0);   // dQ += dS K
    }
    __syncthreads();   // every warp is done with stage st before its reload
  }
  cp_async_wait<0>();   // q and dO's copies, when no tile was visited
  add_group1(acc, reinterpret_cast<float*>(sK));
  if (grp != 0) return;

#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = wq + g + 8 * i;
      if (qp >= Sq) continue;
      store2(dq + b * dqs.b + qp * dqs.s + h * dqs.h + c0 + 8 * j + 2 * t,
             acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
    }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* Dv;
  void *dq, *dk, *dv;
  float* part;
  int B, H, KVH, Sq, Skv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
};

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  // once per instantiation (thread-safe static init); one device per process
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkdv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_KV);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(
                     fa_bwd_dq_kernel<T, HD>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_Q);
  }();
  if (attr != cudaSuccess) return attr;
  const double sc = 1.0 / sqrt((double)HD);
  const float scale = (float)sc, scale_log2 = (float)(sc * 1.4426950408889634);
  const int G = a.H / a.KVH;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);

  const int rows = a.B * a.H * a.Sq;
  fa_bwd_d_kernel<T><<<(rows + D_NT / 32 - 1) / (D_NT / 32), D_NT, 0,
                       stream>>>(static_cast<const T*>(a.o), dout, a.Dv, a.H,
                                 a.Sq, HD, a.os, a.dos, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_kt = (a.Skv + C::BK - 1) / C::BK;
  dim3 g_kv(a.part ? a.H : a.KVH, a.B, n_kt);
  fa_bwd_dkdv_kernel<T, HD><<<g_kv, NT, C::SMEM_KV, stream>>>(
      q, k, v, dout, a.lse, a.Dv, dk, dv, a.part, G, a.H, a.Sq, a.Skv, a.qs,
      a.ks, a.vs, a.dos, a.dks, a.dvs, scale, scale_log2, a.causal, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (a.part) {
    const long long n4 = (long long)a.B * a.Skv * a.KVH * (HD / 4);
    const long long half = (long long)a.B * a.Skv * a.H * HD;
    fa_bwd_dkdv_reduce_kernel<T, HD>
        <<<(unsigned)((n4 + R_NT - 1) / R_NT), R_NT, 0, stream>>>(
            a.part, dk, dv, G, a.H, a.KVH, a.Skv, a.dks, a.dvs, n4, half);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  dim3 g_q(a.H, a.B, (a.Sq + C::BQD - 1) / C::BQD);
  fa_bwd_dq_kernel<T, HD><<<g_q, NT, C::SMEM_Q, stream>>>(
      q, k, v, dout, a.lse, a.Dv, static_cast<T*>(a.dq), G, a.H, a.Sq, a.Skv,
      a.qs, a.ks, a.vs, a.dos, a.dqs, scale, scale_log2, a.causal, a.window);
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
// head) with a unit last stride and 16-byte aligned rows; dq, dk, dv
// contiguous. lse (the forward's) and D (scratch) are (B, H, Sq)
// contiguous fp32. A non-null `scratch` (2 B Skv H hd fp32; the launch
// plan of ops.py `plan_bwd`) splits each GQA group across blocks. Launches the D pass, the dK/dV
// kernel (and the group reduction when split) and the dQ kernel on
// `stream`; returns the first cudaError_t (0 on success); never
// synchronizes.
extern "C" int faillite_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int dtype, int B, int H, int KVH, int Sq, int Skv, int hd,
    const long long* strides, int causal, int window, void* scratch,
    void* stream) {
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
  a.part = static_cast<float*>(scratch);
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
  if (dtype == 1) return (int)dispatch_hd<bf16>(hd, a, s);
  return (int)cudaErrorInvalidValue;
}
