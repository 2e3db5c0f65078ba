// Prefill flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (launched from
// `flash_attention_bhsd`). Computes, per (batch, query head),
//   out = softmax(q k^T / sqrt(hd) + mask) v
// with GQA (kv head = h / G), causal and/or sliding-window masks
// (k > q - window), NEG_INF = -1e30 (finite) and l clamped at 1e-30, the
// same arithmetic as the TPU kernel, in an fp32 online softmax; the output
// is rounded once to the input dtype. When the caller passes `lse` (B, H,
// Sq) fp32, each query row's log-sum-exp of its scaled scores, m + log(l)
// with the same clamp, is written there for the backward
// (flash_attention_bwd.cu); a null `lse` writes nothing, so serving's
// launches are unchanged.
//
// Layout: q (B, Sq, H, hd), k/v (B, Skv, KVH, hd), out (B, Sq, H, hd), read
// through batch/sequence/head element strides with a unit last stride, so
// the model's layout needs no transpose.
//
// The TPU walks KV blocks as the last, sequential grid axis and keeps
// (m, l, acc) in VMEM scratch across grid steps. Hopper blocks run in no
// order, so one block owns one (b, h, query tile) and walks the KV tiles in
// a loop, keeping m, l and acc in fp32 registers. Tiles wholly above the
// causal diagonal, wholly outside the window, or past Skv are never
// visited. The C entry point dispatches by dtype to one of two kernels.
//
// bf16: `fa_tc_kernel`, FlashAttention-2's structure on tensor cores. What
// bounds it on the H100: at the main path's prefill shapes (S <= 512,
// hd 128) the bytes fit in L2 and the bound is bytes at a few microseconds,
// so what costs is latency and occupancy; at S = 2100 with head_dim 256 the
// products dominate and the bound is the tensor-core rate. The design:
//  - 4 warps a block, 16 query rows each (BQ = 64); both products are
//    mma.sync.m16n8k16 bf16 -> fp32;
//  - K and V tiles stay bf16 in shared memory (no widening), with a
//    16-byte-chunk XOR swizzle that keeps ldmatrix (ldmatrix.trans for V)
//    free of bank conflicts;
//  - cp.async.cg 16-byte copies fill a 2-stage ring, so the next KV tile
//    loads while the current one is computed; rows past the valid range
//    are zero-filled;
//  - the online softmax runs on the score fragments (row max and sum over
//    the 4 lanes of a quad); P is packed to bf16 in registers and fed to
//    the PV mma as its A operand (the m16n8 accumulator layout is the
//    m16n8k16 A layout), with no round trip through shared memory. P's
//    rounding to bf16 is the one change in numerics against the plain
//    version; l sums the fp32 P;
//  - masks are applied only on tiles that cut the diagonal, the window's
//    edge or Skv; a warp skips a tile that is wholly masked for its rows;
//  - query tiles are launched longest first (most KV tiles), so the
//    diagonal's long blocks do not form the tail;
//  - Q is read from shared memory per k-step rather than held in
//    registers, and head_dim 256 uses 32-key tiles, so the O accumulators
//    (hd / 2 fp32 registers a thread) fit without spills;
//  - the output goes through the warp's own Q rows in shared memory and
//    leaves in 16-byte stores.
// head_dim 16 and 32 are the same code with fewer chunks per row.
//
// float32: `fa_kernel`, the scalar kernel of the first port, unchanged.
// Tensor cores would mean TF32, which keeps about three decimal digits and
// breaks the f32 tolerance (2e-5) and the model's fp32 parity (1e-3 on the
// logits). Q, K and V tiles are staged in shared memory as fp32 with
// 16-byte loads, each thread issuing all of its loads for a tile before
// storing any (rows padded by one word so column reads hit distinct
// banks); each of the 128 threads computes a 4x4 block of scores with
// scalar FMAs and owns 4 query rows x hd/16 output columns, the same rows
// as its scores, so the row statistics reduce over the 16 lanes of a half
// warp with shuffles. It is bound by its scalar FMAs, far from the fp32
// rate; the f32 rows are the testbed's head_dim-16 smoke rungs and the
// fp32 parity checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

// Unpack one 16-byte vector of 4 floats.
__device__ __forceinline__ void unpack(const uint4& u, float (&out)[4],
                                       const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
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
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int G, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
          Strides os, float scale, int causal, int window) {
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
    // the grid is (query tiles, H, B); m is in units of the scaled scores
    if (lse != nullptr && tc == 0)
      lse[((long long)b * gridDim.y + h) * Sq + qp] = m[i] + logf(li);
    T* orow = o + b * os.b + qp * os.s + h * os.h;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) orow[tc + 16 * jj] = from_f<T>(acc[i][jj] / li);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KVH, int Sq, int Skv,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   int window, cudaStream_t stream) {
  constexpr int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kern = fa_kernel<T, HD>;
  // once per instantiation (thread-safe static init); one device per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H / KVH, Sq, Skv,
      qs, ks, vs, os, (float)(1.0 / sqrt((double)HD)), causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async tiles, P in registers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BQ = 64;      // query rows per block: 4 warps x 16 rows
constexpr int TC_NT = 128;     // threads per block
constexpr int TC_STAGES = 2;   // KV tiles in flight

// keys per KV tile: 32 at head_dim 256 keeps the score fragments small
// beside the 128 fp32 O accumulators a thread holds there
template <int HD>
__host__ __device__ constexpr int tc_bk() { return HD >= 256 ? 32 : 64; }

template <int HD>
constexpr int tc_smem_bytes() {
  return (TC_BQ + 2 * TC_STAGES * tc_bk<HD>()) * HD * (int)sizeof(bf16);
}

// Element offset of 16-byte chunk c of row r in a tile of HD bf16 values a
// row. The chunk index is XORed with bits of the row so that the 8 rows an
// ldmatrix reads at one chunk column land in 8 distinct 16-byte bank
// groups (rows of fewer than 8 chunks take the bits above those that
// already spread them).
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int NCH = HD / 8;
  if constexpr (NCH >= 8)
    return (r * NCH + (c ^ (r & 7))) * 8;
  else
    return (r * NCH + (c ^ ((r / (8 / NCH)) & (NCH - 1)))) * 8;
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

// Issue the cp.async copies of `rows` rows of HD bf16 values into a
// swizzled tile; row r comes from src + r * row_stride, and rows at or past
// `valid` are zero-filled (their source address is row 0, never read).
template <int HD>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src,
                                           long long row_stride, int rows,
                                           int valid, int tid) {
  constexpr int NCH = HD / 8;
  for (int i = tid; i < rows * NCH; i += TC_NT) {
    const int r = i / NCH, c = i % NCH;
    const bool ok = r < valid;
    cp_async16(dst + swz<HD>(r, c), src + (ok ? r : 0) * row_stride + c * 8,
               ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_NT)
fa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int G, int Sq, int Skv, Strides qs,
             Strides ks, Strides vs, Strides os, float scale_log2,
             int causal, int window) {
  constexpr int BKT = tc_bk<HD>();
  constexpr int NCH = HD / 8;   // 16-byte chunks a row
  constexpr int NS = BKT / 8;   // score n-tiles of a warp
  constexpr int ND = HD / 8;    // output n-tiles of a warp
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);   // TC_BQ x HD
  bf16* sK = sQ + TC_BQ * HD;                    // stages x BKT x HD
  bf16* sV = sK + TC_STAGES * BKT * HD;          // stages x BKT x HD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;  // longest first
  const int kvh = h / G;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  // KV tiles some row of this query tile needs, as in the f32 kernel
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + TC_BQ);
  int k_first = 0;
  if (window > 0) k_first = (max(0, q0 - window + 1) / BKT) * BKT;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BKT - 1) / BKT : 0;

  tile_async<HD>(sQ, qb + q0 * qs.s, qs.s, TC_BQ, Sq - q0, tid);
  if (n_tiles > 0) {
    tile_async<HD>(sK, kb + k_first * ks.s, ks.s, BKT, Skv - k_first, tid);
    tile_async<HD>(sV, vb + k_first * vs.s, vs.s, BKT, Skv - k_first, tid);
  }
  cp_async_commit();

  const int wq0 = q0 + 16 * warp;    // this warp's first query row
  const int r0 = wq0 + lane / 4;     // a thread's rows: r0 and r0 + 8
  const int qrow = 16 * warp + (lane & 15);
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_first + t * BKT;
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int k1 = k0 + BKT;
      tile_async<HD>(sK + (st ^ 1) * BKT * HD, kb + k1 * ks.s, ks.s, BKT,
                     Skv - k1, tid);
      tile_async<HD>(sV + (st ^ 1) * BKT * HD, vb + k1 * vs.s, vs.s, BKT,
                     Skv - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) landed for every thread's copies
    const bf16* tK = sK + st * BKT * HD;
    const bf16* tV = sV + st * BKT * HD;

    // a tile wholly above the diagonal or left of the window for all 16
    // rows of this warp contributes nothing to them
    bool skip = causal && k0 > wq0 + 15;
    if (window > 0 && k0 + BKT - 1 < wq0 - window + 1) skip = true;
    if (!skip) {
      // S = Q K^T
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        uint32_t a[4];
        ldsm_x4(a, sQ + swz<HD>(qrow, 2 * kd + (lane >> 4)));
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          uint32_t bb[4];
          ldsm_x4(bb, tK + swz<HD>(16 * j + ((lane >> 4) << 3) + (lane & 7),
                                   2 * kd + ((lane >> 3) & 1)));
          mma_bf16(s[2 * j], a, bb[0], bb[1]);
          mma_bf16(s[2 * j + 1], a, bb[2], bb[3]);
        }
      }

      // scale into the log2 domain; mask only where the tile cuts Skv,
      // the diagonal or the window's edge for this warp's rows
      const bool need_mask = k0 + BKT > Skv ||
                             (causal && k0 + BKT - 1 > wq0) ||
                             (window > 0 && k0 < wq0 + 16 - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (need_mask) {
            const int r = r0 + (e >> 1) * 8;
            const int kp = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
            bool ok = kp < Skv;
            if (causal) ok = ok && r >= kp;
            if (window > 0) ok = ok && kp > r - window;
            if (!ok) x = NEG_INF;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          rs[e >> 1] += p;
        }
      // l stays a per-thread partial sum; the quad reduces it at the end
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        acc[d][0] *= corr[0];
        acc[d][1] *= corr[0];
        acc[d][2] *= corr[1];
        acc[d][3] *= corr[1];
      }

      // O += P V, P from registers as the A operand
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bb[4];
          ldsm_x4_t(bb, tV + swz<HD>(16 * kk + (lane & 7) +
                                         (((lane >> 3) & 1) << 3),
                                     2 * dp + (lane >> 4)));
          mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
          mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its reload
  }

  cp_async_wait<0>();
  __syncthreads();  // Q's copies have landed even when no tile was visited
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  // m is in log2 units of the scaled scores: lse = m ln 2 + ln l. The
  // grid is (H, query tiles, B); one lane of each quad writes its 2 rows
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 8 * i;
      if (qp < Sq)
        lse[((long long)b * gridDim.x + h) * Sq + qp] =
            m[i] * 0.6931471805599453f + logf(l[i]);
    }
  }
  // normalize into this warp's own Q rows, then store 16 bytes a lane
  const int orow = 16 * warp + lane / 4;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    *reinterpret_cast<uint32_t*>(sQ + swz<HD>(orow, d) + 2 * (lane & 3)) =
        pack_bf16(acc[d][0] / l[0], acc[d][1] / l[0]);
    *reinterpret_cast<uint32_t*>(sQ + swz<HD>(orow + 8, d) +
                                 2 * (lane & 3)) =
        pack_bf16(acc[d][2] / l[1], acc[d][3] / l[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * NCH; i += 32) {
    const int r = i / NCH, c = i % NCH, qp = wq0 + r;
    if (qp < Sq)
      *reinterpret_cast<uint4*>(o + b * os.b + qp * os.s + h * os.h + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + swz<HD>(16 * warp + r, c));
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int KVH, int Sq, int Skv,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      int causal, int window, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<HD>();
  auto kern = fa_tc_kernel<HD>;
  // once per instantiation (thread-safe static init); one device per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(H, (Sq + TC_BQ - 1) / TC_BQ, B);
  kern<<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H / KVH, Sq,
      Skv, qs, ks, vs, os, (float)(1.4426950408889634 / sqrt((double)HD)),
      causal, window);
  return cudaGetLastError();
}

// float32 takes the scalar kernel, bfloat16 the tensor-core kernel
template <typename T, int HD>
cudaError_t launch_dt(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int KVH, int Sq, int Skv,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch<float, HD>(q, k, v, o, lse, B, H, KVH, Sq, Skv, qs, ks, vs,
                             os, causal, window, stream);
  else
    return launch_tc<HD>(q, k, v, o, lse, B, H, KVH, Sq, Skv, qs, ks, vs, os,
                         causal, window, stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int H, int KVH, int Sq,
                        int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                        int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_dt<T, 16>(q, k, v, o, lse, B, H, KVH, Sq, Skv, qs, ks,
                              vs, os, causal, window, stream);
    case 32:
      return launch_dt<T, 32>(q, k, v, o, lse, B, H, KVH, Sq, Skv, qs, ks,
                              vs, os, causal, window, stream);
    case 64:
      return launch_dt<T, 64>(q, k, v, o, lse, B, H, KVH, Sq, Skv, qs, ks,
                              vs, os, causal, window, stream);
    case 128:
      return launch_dt<T, 128>(q, k, v, o, lse, B, H, KVH, Sq, Skv, qs, ks,
                               vs, os, causal, window, stream);
    case 256:
      return launch_dt<T, 256>(q, k, v, o, lse, B, H, KVH, Sq, Skv, qs, ks,
                               vs, os, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `lse` is
// null or (B, H, Sq) contiguous fp32. Returns the cudaError_t of the launch
// (0 on success); never synchronizes.
extern "C" int faillite_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int H, int KVH, int Sq, int Skv, int hd, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh,
    int causal, int window, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || B <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, o, static_cast<float*>(lse),
                                   B, H, KVH, Sq, Skv, qs, ks, vs, os, causal,
                                   window, st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o,
                                           static_cast<float*>(lse), B, H, KVH,
                                           Sq, Skv, qs, ks, vs, os, causal,
                                           window, st);
  return (int)cudaErrorInvalidValue;
}
