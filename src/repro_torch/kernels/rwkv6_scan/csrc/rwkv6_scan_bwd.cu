// Backward of K4's chunked WKV-6 for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces no TPU kernel of its own: the JAX package takes the gradient of
// its `wkv_chunked` / `wkv_scan` (src/repro/models/rwkv6.py) from XLA's
// autodiff. This is the reverse of `faillite_wkv6_chunked` in
// rwkv6_scan.cu, whose TPU counterpart is `_wkv_kernel` in
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py, and its plain version is
// `wkv6_chunked_bwd_ref(..., sub=16)` in ../ref.py. Per (batch row, head),
// chunks of CHUNK = 32 steps (the last one padded with zeros, as the
// forward pads), cut into sub-chunks of SUB = 16 rows as the forward cuts
// them, with cum the inclusive and cum_prev the exclusive cumulative sum of
// lw in a chunk, L = cum of its last row, S_in the chunk's incoming state
// (the forward's `states` buffer, kept by the autograd Function) and dS_out
// the adjoint of its outgoing state:
//
//   (a) `wkv_bwd_chunk_kernel`, a block per (chunk, head, row): the
//       chunk's G = (r e^{cum_prev})^T dy (hs x hs) and its decay e^{L};
//   (b) `wkv_bwd_scan_kernel`, a thread per state element: the chunks
//       walked backwards from ds_out, dS_in = e^{L} (rows) dS_out + G,
//       writing each chunk's dS_out over its G and dS_in of chunk 0 to ds0;
//   (c) `wkv_bwd_out_kernel`, a block per (chunk, head, row): with
//       E[t, s] = e^{cum_prev_t - cum_s} (exponent <= 0) for s < t,
//         dr_t = e^{cum_prev_t} S_in dy_t + sum_{s<t} (dy_t . v_s) k_s E
//                + (dy_t . v_t) u k_t,
//         dk_s = sum_{t>s} (dy_t . v_s) r_t E + e^{L - cum_s} dS_out v_s
//                + (dy_s . v_s) u r_s,
//         dv_s = sum_{t>s} A[t, s] dy_t + (r_s . u k_s) dy_s
//                + (k_s e^{L - cum_s}) dS_out,  A[t, s] = sum_i r_t k_s E,
//       and dlw from the gradients of the cumulative sums (X_t = r_t dr'_t,
//       Y_t and Z_t the intra-chunk and state parts of k_t dk'_t, the prime
//       leaving out the bonus):
//         dlw_tau = sum_{t>tau} X_t - sum_{t>=tau} Y_t + sum_{t<tau} Z_t
//                   + e^{L} sum_j S_in dS_out,
//       one thread per channel walking the chunk; and the chunk's partial
//       of du = sum_t (dy_t . v_t) r_t k_t;
//   (d) `wkv_bwd_du_kernel`: du summed over rows and chunks in order.
//
// Products. Every matrix product runs on the tensor cores as mma.sync
// m16n8k8 TF32 with fp32 sums, split 3xTF32 (hi.hi + hi.lo + lo.hi) where an
// operand is fp32 data, as the forward's: G in (a); in (c) dA = dy v^T,
// dr_inter = e^{cum_prev} (dy S_in^T), dk_state = e^{L - cum} (v dS_out^T),
// dv = A^T dy + (k e^{L - cum}) dS_out and the off-diagonal sub-chunk pairs.
// A bf16 v is exact in TF32 and is not split. For t in sub-chunk p and s
// before its first row b_p, E factors into R~_t = r_t e^{cum_prev_t -
// cum_prev_{b_p}} and K~_s = k_s e^{cum_prev_{b_p} - cum_s}, both exponents
// <= 0: A's off-diagonal tile is R~ K~^T, and those pairs' dr_in and dk_in
// are e^{cum_prev_t - cum_prev_{b_p}} (dA K~) and e^{cum_prev_{b_p} - cum_s}
// (dA^T R~). The pairs inside a diagonal sub-chunk (2 x 120 a chunk) stay
// exact in fp32: each E[t, s, i] is evaluated once, by the thread that owns
// channel i of a set of rows t of the sub-chunk, which adds it into dr_in
// and dk_in in registers and into its share of A[t, s]; the shares of A are
// summed across the channels by a butterfly reduce-scatter of warp
// shuffles, and the row sets' dk_in and the warps' A in set order. So every
// exponential evaluated has an exponent <= 0 and lw needs no clamp. Sums run
// in a fixed order with no atomics: two launches give the same bits.
//
// Layout chosen for the H100: kernel (c) keeps every tile of its chunk in
// shared memory (r, k, v, dy, cum, S_in, dS_out, A, dA, the off-diagonal
// factors and the dr/dk partials: 104 KB at hs = 64), so two blocks of
// eight warps fit on an SM (228 KB) and a block's load, cumsum and product
// phases overlap the other's; its rows are padded to 4 mod 32 floats (the
// A fragments and the B fragments read with the row on the fragment's
// group index are then conflict-free) and A/dA to 8 mod 32 (read
// transposed). Warps tile each 32 x hs product as 2 row tiles x 4 column
// groups, so every warp holds one tile of dr_inter, dk_state and dv at once
// and finishes dr, dk, dv and the dlw terms of its elements in registers.
// The grid is (chunk, head, row), ceil(S / 32) x nh x B blocks: 640 at
// rwkv6-3b's B=2 S=256, 2.4 waves of two blocks an SM.
//
// Layout: r, k, v (B, S, nh, hs) in the activation dtype (fp32 or bf16),
// lw and dy (B, S, nh, hs) fp32, all read through batch/sequence/head
// element strides with a unit last stride; u (nh, hs), states and the
// scratch `gbuf` (B, nh, nc, hs, hs), ds_out and ds0 (B, nh, hs, hs),
// `decay` and `du_part` (B, nh, nc, hs), all fp32 and contiguous; dr, dk,
// dv (B, S, nh, hs) contiguous in r's dtype, dlw likewise in fp32, du
// (nh, hs) fp32.
//
// What bounds it on the H100: the function needs about 14 hs^2 operations
// per (b, h, t) (the recurrence's reverse: the state's adjoint, dr, dk, dv,
// dlw and the state recomputed), which at hs = 64 and the 3xTF32 rate lies
// near the bytes it must move. The chunked form moves more: each chunk's
// hs x hs state, G and adjoint through memory (about 4 x 16 KB a chunk).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 32;  // steps of a chunk, as the forward
constexpr int SUB = 16;    // rows of a sub-chunk, as the forward
constexpr int NSUB = CHUNK / SUB;
constexpr int NTH = 256;   // threads of kernels (a) and (c): eight warps
constexpr int NWARP = NTH / 32;
constexpr int SCAN_NT = 256;
constexpr int LT = CHUNK + 8;  // row stride of A and dA (8 mod 32)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two consecutive outputs, n even
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Strides {
  long long b, s, h;
};

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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc[j] (the 16 x 8 tile at rows m0.., columns n0 + 8 j, j < nj)
// += A[m0 : m0 + 16, kb : ke] @ B[kb : ke, n0 + 8 j ..], with A(row, kk) =
// fa(row, kk) and B(kk, col) = fb(kk, col) in fp32, 3xTF32; SPLIT_A /
// SPLIT_B false drops that operand's low part (exact in TF32). Fragment
// layouts of m16n8k8 .tf32 (g = lane / 4, t = lane % 4): a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g);
// c0/c1 (g, 2t / 2t + 1), c2/c3 (g + 8, 2t / 2t + 1).
template <int NJ, bool SPLIT_A, bool SPLIT_B, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NJ][4], int m0, int n0,
                                         int nj, int kb, int ke, FA fa,
                                         FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = kb; k0 < ke; k0 += 8) {
    uint32_t ah[4], al[4];
    split(fa(m0 + g, k0 + t), ah[0], al[0]);
    split(fa(m0 + g + 8, k0 + t), ah[1], al[1]);
    split(fa(m0 + g, k0 + t + 4), ah[2], al[2]);
    split(fa(m0 + g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        const int n = n0 + 8 * j + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(fb(k0 + t, n), bh0, bl0);
        split(fb(k0 + t + 4, n), bh1, bl1);
        if (SPLIT_A) mma_tf32(acc[j], al, bh0, bh1);
        if (SPLIT_B) mma_tf32(acc[j], ah, bl0, bl1);
        mma_tf32(acc[j], ah, bh0, bh1);
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
}

// Each thread of kernels (a) and (c) loads one channel i = tid % HS of
// ROWS consecutive rows of the chunk (part = tid / HS of PARTS), all of its
// global loads issued before any is used; consecutive threads read
// consecutive channels. Rows past S are zeros, as `wkv_chunked` pads.
template <int HS>
struct Rows {
  static constexpr int PARTS = NTH / HS, ROWS = CHUNK / PARTS;
};

template <typename T, int HS>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, Strides xs,
                                          int b, int h, int t0, int S,
                                          float (&out)[Rows<HS>::ROWS]) {
  const int i = threadIdx.x % HS, part = threadIdx.x / HS;
#pragma unroll
  for (int q = 0; q < Rows<HS>::ROWS; ++q) {
    const long long ta = t0 + part * Rows<HS>::ROWS + q;
    out[q] = ta < S ? to_f(x[b * xs.b + ta * xs.s + h * xs.h + i]) : 0.f;
  }
}

// In place, the inclusive cumulative sum of lw down each channel's column
// of a [CHUNK][ld] shared tile, one thread per channel, in step order (the
// forward's own order and rounding)
template <int HS>
__device__ __forceinline__ void column_cumsum(float* col0, int ld) {
  if (threadIdx.x < HS) {
    float* col = col0 + threadIdx.x;
    float run = 0.f;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      run += col[t * ld];
      col[t * ld] = run;
    }
  }
}

// (a): per (chunk, head, row), G = (r e^{cum_prev})^T dy (hs x hs) into gbuf
// and e^{L} into decay: the forward's state kernel with (r e^{cum_prev}, dy)
// in place of (k e^{L - cum}, v)
template <typename T, int HS>
__global__ void __launch_bounds__(NTH)
wkv_bwd_chunk_kernel(const T* __restrict__ r, const float* __restrict__ lw,
                     const float* __restrict__ dy, float* __restrict__ gbuf,
                     float* __restrict__ decay, int S, int NH, int nc,
                     Strides rs, Strides ws, Strides ds) {
  // both operands are read with the time index on the fragment's t: rows
  // padded to 8 mod 32 floats
  constexpr int LB = HS + 8, LC = HS + 4, ROWS = Rows<HS>::ROWS;
  __shared__ float sr[CHUNK][LB], sd[CHUNK][LB], sc[CHUNK][LC];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CHUNK;
  const int i = threadIdx.x % HS, row0 = (threadIdx.x / HS) * ROWS;
  float rr[ROWS], dr[ROWS], wr[ROWS];
  load_rows<T, HS>(r, rs, b, h, t0, S, rr);
  load_rows<float, HS>(dy, ds, b, h, t0, S, dr);
  load_rows<float, HS>(lw, ws, b, h, t0, S, wr);
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    sr[row0 + q][i] = rr[q];
    sd[row0 + q][i] = dr[q];
    sc[row0 + q][i] = wr[q];
  }
  __syncthreads();
  column_cumsum<HS>(&sc[0][0], LC);  // sc[t] = cum_t (inclusive)
  __syncthreads();
  // r_t e^{cum_prev_t}, exponent <= 0
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int t = row0 + q;
    if (t > 0) sr[t][i] *= expf(sc[t - 1][i]);
  }
  const long long bhc = ((long long)b * NH + h) * nc + c;
  if (threadIdx.x < HS)
    decay[bhc * HS + threadIdx.x] = expf(sc[CHUNK - 1][threadIdx.x]);
  __syncthreads();

  // warps tile the (HS x HS) output: WM along the key channels (16 rows a
  // tile), WN along the value channels, NJ tiles of 8 columns each
  constexpr int MT = (HS + 15) / 16, NT8 = HS / 8;
  constexpr int WM = MT, WN = NWARP / WM, NJ = (NT8 + WN - 1) / WN;
  const int warp = threadIdx.x >> 5;
  const int mt = warp / WN, wn = warp % WN;
  const int nj = min(NJ, NT8 - wn * NJ);
  if (mt >= MT || nj <= 0) return;
  float acc[NJ][4];
  zero(acc);
  const int m0 = mt * 16, n0 = wn * NJ * 8;
  const float* rp = &sr[0][0];
  const float* dp = &sd[0][0];
  warp_mma<NJ, true, true>(
      acc, m0, n0, nj, 0, CHUNK,
      [=](int i, int t) { return i < HS ? rp[t * LB + i] : 0.f; },
      [=](int t, int n) { return dp[t * LB + n]; });
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float* out = gbuf + bhc * HS * HS;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nj) {
      const int n = n0 + 8 * j + 2 * tq;
      const int i0 = m0 + g, i1 = m0 + g + 8;
      if (i0 < HS) store2(out + i0 * HS + n, acc[j][0], acc[j][1]);
      if (i1 < HS) store2(out + i1 * HS + n, acc[j][2], acc[j][3]);
    }
  }
}

// (b): per (b, h) state element e, the chunks last to first: write dS_out
// of chunk c over its G and carry dS_in = e^{L_c} dS_out + G_c; ds0 gets
// dS_in of chunk 0. GRP chunks' loads are issued together.
__global__ void __launch_bounds__(SCAN_NT)
wkv_bwd_scan_kernel(float* __restrict__ gbuf, const float* __restrict__ decay,
                    const float* __restrict__ ds_out, float* __restrict__ ds0,
                    int HS, int NH, int nc) {
  const int e = blockIdx.x * SCAN_NT + threadIdx.x;
  if (e >= HS * HS) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * NH + h;
  const long long step = (long long)HS * HS;
  float* p = gbuf + bh * nc * step + e;
  const float* dc = decay + bh * nc * HS + e / HS;
  float carry = ds_out[bh * step + e];
  constexpr int GRP = 8;
  for (int c1 = nc; c1 > 0; c1 -= GRP) {
    float gc[GRP], dd[GRP];
#pragma unroll
    for (int q = 0; q < GRP; ++q) {
      const int c = c1 - 1 - q;
      if (c >= 0) {
        gc[q] = p[c * step];
        dd[q] = dc[(long long)c * HS];
      }
    }
#pragma unroll
    for (int q = 0; q < GRP; ++q) {
      const int c = c1 - 1 - q;
      if (c >= 0) {
        p[c * step] = carry;
        carry = fmaf(dd[q], carry, gc[q]);
      }
    }
  }
  ds0[bh * step + e] = carry;
}

// The butterfly reduce-scatter of GW values across each aligned group of GW
// lanes: lane l of a group returns the group's sum of value l % GW. Each
// step O keeps half the values and adds the partner's half, in a fixed
// order (a template step, so every index is a constant).
template <int GW, int O>
__device__ __forceinline__ void reduce_step(float (&v)[GW], int lane) {
  if constexpr (O >= 1) {
    const bool up = lane & O;
#pragma unroll
    for (int k = 0; k < O; ++k) {
      const float send = up ? v[k] : v[k + O];
      const float keep = up ? v[k + O] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_step<GW, O / 2>(v, lane);
  }
}

template <int GW>
__device__ __forceinline__ float reduce_scatter(float (&v)[GW]) {
  reduce_step<GW, GW / 2>(v, threadIdx.x & 31);
  return v[0];
}

// The exact pairs of the diagonal sub-chunks. Thread (channel i, sub-chunk
// p, row set q) owns rows t = q + R m (m < RPT) of sub-chunk p and walks the
// pair positions (m, s), s < R (m + 1), a superset of s <= t that is the
// same for every q: s < t is a pair, s = t the bonus, s > t a zero.
template <int HS>
struct Diag {
  static constexpr int R = NTH / (HS * NSUB);  // row sets
  static constexpr int RPT = SUB / R;          // rows a thread
  static constexpr int GW = HS < 32 ? HS : 32; // lanes of a channel group
  static constexpr int H = HS / GW;            // channel groups (warps)
  static constexpr int NPOS = R * RPT * (RPT + 1) / 2;
  static constexpr int NB = (NPOS + GW - 1) / GW;  // reduce-scatter batches
  static constexpr int NPH = R > H ? R : H;        // ordered merge phases
  // pair position pos -> its row block m (positions R m (m + 1) / 2 ..)
  static constexpr __host__ __device__ int row_of(int pos) {
    int m = 0;
    while (m < RPT - 1 && pos >= R * (m + 1) * (m + 2) / 2) ++m;
    return m;
  }
};

// the dynamic shared memory of kernel (c), in floats
template <int HS>
constexpr int out_smem_floats() {
  return 6 * CHUNK * (HS + 4) + (CHUNK + 1) * (HS + 4) + 2 * HS * (HS + 4) +
         2 * CHUNK * LT + HS;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// (c): per (chunk, head, row), dr, dk, dv, dlw and the chunk's du partial
template <typename T, int HS>
__global__ void __launch_bounds__(NTH, 2)
wkv_bwd_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u,
                   const float* __restrict__ states,
                   const float* __restrict__ dy,
                   const float* __restrict__ dsout, T* __restrict__ dr,
                   T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ dlw, float* __restrict__ du_part,
                   int S, int NH, int nc, Strides rs, Strides ks, Strides vs,
                   Strides ws, Strides ds) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int LA = HS + 4;
  extern __shared__ float smem[];
  float* sr = smem;                  // [CHUNK][LA] r
  float* sk = sr + CHUNK * LA;       // [CHUNK][LA] k
  float* sv = sk + CHUNK * LA;       // [CHUNK][LA] v, then Z
  float* sd = sv + CHUNK * LA;       // [CHUNK][LA] dy
  float* sq = sd + CHUNK * LA;       // [CHUNK][LA] K~ (p = 0), R~ (p = 1),
                                     //   then dk_in, then Y
  float* sp = sq + CHUNK * LA;       // [CHUNK][LA] dr_in, then X
  float* sc = sp + CHUNK * LA;       // [CHUNK+1][LA] row t: cum_prev_t
  float* ss = sc + (CHUNK + 1) * LA; // [HS][LA] S_in
  float* sD = ss + HS * LA;          // [HS][LA] dS_out
  float* sa = sD + HS * LA;          // [CHUNK][LT] A, bonus on the diagonal
  float* sda = sa + CHUNK * LT;      // [CHUNK][LT] dA = dy v^T
  float* su = sda + CHUNK * LT;      // [HS] u
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CHUNK;
  const long long bhc = ((long long)b * NH + h) * nc + c;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;

  // S_in and dS_out by cp.async (16 bytes a copy), then the rows
  {
    const float* sin_g = states + bhc * HS * HS;
    const float* dso_g = dsout + bhc * HS * HS;
    for (int e4 = threadIdx.x; e4 < HS * HS / 4; e4 += NTH) {
      const int e = 4 * e4, row = e / HS, col = e % HS;
      cp_async16(ss + row * LA + col, sin_g + e);
      cp_async16(sD + row * LA + col, dso_g + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    constexpr int ROWS = Rows<HS>::ROWS;
    const int i = threadIdx.x % HS, row0 = (threadIdx.x / HS) * ROWS;
    float rr[ROWS], kr[ROWS], vr[ROWS], dr_[ROWS], wr[ROWS];
    load_rows<T, HS>(r, rs, b, h, t0, S, rr);
    load_rows<T, HS>(k, ks, b, h, t0, S, kr);
    load_rows<T, HS>(v, vs, b, h, t0, S, vr);
    load_rows<float, HS>(dy, ds, b, h, t0, S, dr_);
    load_rows<float, HS>(lw, ws, b, h, t0, S, wr);
    if (threadIdx.x < HS) {
      su[threadIdx.x] = u[h * HS + threadIdx.x];
      sc[threadIdx.x] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int t = row0 + q;
      sr[t * LA + i] = rr[q];
      sk[t * LA + i] = kr[q];
      sv[t * LA + i] = vr[q];
      sd[t * LA + i] = dr_[q];
      sc[(t + 1) * LA + i] = wr[q];
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();
  // sc[t] = cum_prev_t = cum_{t-1}; sc[CHUNK] = L
  column_cumsum<HS>(sc + LA, LA);
  __syncthreads();

  // dA = dy v^T on the six 16 x 8 tiles at or below the diagonal
  // sub-chunks (warps 0-5); meanwhile the off-diagonal factors and A's zeros
  if (warp < 6) {
    const int mt = warp < 2 ? 0 : 1, nt = warp < 2 ? warp : warp - 2;
    float acc[1][4];
    zero(acc);
    warp_mma<1, true, F32>(
        acc, mt * SUB, nt * 8, 1, 0, HS,
        [=](int t, int j) { return sd[t * LA + j]; },
        [=](int j, int s) { return sv[s * LA + j]; });
    const int t = mt * SUB + g, s = nt * 8 + 2 * tq;
    store2(sda + t * LT + s, acc[0][0], acc[0][1]);
    store2(sda + (t + 8) * LT + s, acc[0][2], acc[0][3]);
  }
  // K~_s = k_s e^{cum_prev_b - cum_s} (s < b), R~_t = r_t e^{cum_prev_t -
  // cum_prev_b} (t >= b), b = SUB: both exponents <= 0
  for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
    const int t = e / HS, i = e % HS;
    const float cb = sc[SUB * LA + i];
    if (t < SUB)
      sq[t * LA + i] = sk[t * LA + i] * expf(cb - sc[(t + 1) * LA + i]);
    else
      sq[t * LA + i] = sr[t * LA + i] * expf(sc[t * LA + i] - cb);
  }
  for (int e = threadIdx.x; e < CHUNK * CHUNK; e += NTH)
    sa[(e / CHUNK) * LT + e % CHUNK] = 0.f;
  __syncthreads();

  // the off-diagonal sub-chunk pairs (t >= SUB, s < SUB) as products, one
  // 16 x 8 tile a unit: A = R~ K~^T (2 units), dr_in = e^{cum_prev_t -
  // cum_prev_b} (dA K~) and dk_in = e^{cum_prev_b - cum_s} (dA^T R~) (HS / 8
  // each). dr_in goes to sp's rows >= SUB and dk_in, for now, to its rows
  // < SUB, which no product reads.
  {
    constexpr int NT8 = HS / 8;
    for (int x = warp; x < 2 + 2 * NT8; x += NWARP) {
      float acc[1][4];
      zero(acc);
      if (x < 2) {
        warp_mma<1, true, true>(
            acc, SUB, x * 8, 1, 0, HS,
            [=](int t, int i) { return sq[t * LA + i]; },
            [=](int i, int s) { return sq[s * LA + i]; });
        const int t = SUB + g, s = x * 8 + 2 * tq;
        store2(sa + t * LT + s, acc[0][0], acc[0][1]);
        store2(sa + (t + 8) * LT + s, acc[0][2], acc[0][3]);
      } else if (x < 2 + NT8) {
        const int n0 = (x - 2) * 8;
        warp_mma<1, true, true>(
            acc, SUB, n0, 1, 0, SUB,
            [=](int t, int s) { return sda[t * LT + s]; },
            [=](int s, int i) { return sq[s * LA + i]; });
        const int i = n0 + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = SUB + g + 8 * half;
          const float* ct = sc + t * LA + i;
          const float* cb = sc + SUB * LA + i;
          store2(sp + t * LA + i, acc[0][2 * half] * expf(ct[0] - cb[0]),
                 acc[0][2 * half + 1] * expf(ct[1] - cb[1]));
        }
      } else {
        const int n0 = (x - 2 - NT8) * 8;
        warp_mma<1, true, true>(
            acc, 0, n0, 1, SUB, CHUNK,
            [=](int s, int t) { return sda[t * LT + s]; },
            [=](int t, int i) { return sq[t * LA + i]; });
        const int i = n0 + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = g + 8 * half;
          const float* cs = sc + (s + 1) * LA + i;
          const float* cb = sc + SUB * LA + i;
          store2(sp + s * LA + i, acc[0][2 * half] * expf(cb[0] - cs[0]),
                 acc[0][2 * half + 1] * expf(cb[1] - cs[1]));
        }
      }
    }
  }
  __syncthreads();

  // the diagonal sub-chunks' exact pairs
  {
    using D = Diag<HS>;
    constexpr int R = D::R, RPT = D::RPT, GW = D::GW;
    const int i = threadIdx.x % HS, col = threadIdx.x / HS;
    const int p = col % NSUB, q = col / NSUB, grp = i / GW;
    const int pb = p * SUB;
    // dk_in's off-diagonal part moves to sq (rows < SUB); sq's other rows
    // start at zero
    for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
      const int t = e / HS, ii = e % HS;
      sq[t * LA + ii] = t < SUB ? sp[t * LA + ii] : 0.f;
    }
    float drin[RPT], dkin[SUB], res[D::NB], vals[GW];
    const float ui = su[i];
#pragma unroll
    for (int s = 0; s < SUB; ++s) dkin[s] = 0.f;
    float rt = 0.f, cpt = 0.f, acc = 0.f;
    int t = 0, tg = 0;
    // one flat walk over the positions, every index a constant
#pragma unroll
    for (int pos = 0; pos < D::NPOS; ++pos) {
      const int m = D::row_of(pos), s = pos - R * m * (m + 1) / 2;
      if (s == 0) {  // a new row: this thread's row q + R m
        t = q + R * m;
        tg = pb + t;
        rt = sr[tg * LA + i];
        cpt = sc[tg * LA + i];
        acc = 0.f;
      }
      const float ks_ = sk[(pb + s) * LA + i];
      const float e =
          s < t ? expf(fminf(cpt - sc[(pb + s + 1) * LA + i], 0.f)) : 0.f;
      const float da = sda[tg * LT + pb + s];
      acc = fmaf(da * ks_, e, acc);
      dkin[s] = fmaf(da * rt, e, dkin[s]);
      vals[pos % GW] = rt * ks_ * (s == t ? ui : e);
      if (s == R * (m + 1) - 1) drin[m] = acc;
      if (pos % GW == GW - 1 || pos == D::NPOS - 1) {
#pragma unroll
        for (int z = pos % GW + 1; z < GW; ++z) vals[z] = 0.f;
        res[pos / GW] = reduce_scatter<GW>(vals);
      }
    }
    __syncthreads();  // sq's rows are in place; every pass above is done
    // merge in a fixed order: dr_in (owned rows) at once, then the row sets'
    // dk_in and the channel groups' shares of A, one phase each
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int t = pb + q + R * m;
      sp[t * LA + i] = (p > 0 ? sp[t * LA + i] : 0.f) + drin[m];
    }
    for (int ph = 0; ph < D::NPH; ++ph) {
      if (q == ph) {
#pragma unroll
        for (int s = 0; s < SUB; ++s) sq[(pb + s) * LA + i] += dkin[s];
      }
      if (grp == ph) {
#pragma unroll
        for (int bt = 0; bt < D::NB; ++bt) {
          const int pos = bt * GW + lane % GW;
          const int m = D::row_of(pos);
          const int s = pos - R * m * (m + 1) / 2, t = q + R * m;
          if (pos < D::NPOS && s <= t) sa[(pb + t) * LT + pb + s] += res[bt];
        }
      }
      __syncthreads();
    }
  }

  // dr_inter = e^{cum_prev} (dy S_in^T), dk_state = e^{L - cum}
  // (v dS_out^T) and dv = A^T dy + (k e^{L - cum}) dS_out: warps tile the
  // (CHUNK x HS) outputs as 2 row tiles x WN column groups
  constexpr int NT8 = HS / 8, WN = NWARP / NSUB, NJ = (NT8 + WN - 1) / WN;
  const int mt = warp / WN, wn = warp % WN;
  const int nj = min(NJ, NT8 - wn * NJ);
  const int m0 = mt * SUB, n0 = wn * NJ * 8;
  float zr[NJ][4];
  if (nj > 0) {
    float ar[NJ][4], ak[NJ][4], av[NJ][4];
    zero(ar);
    zero(ak);
    zero(av);
    warp_mma<NJ, true, true>(
        ar, m0, n0, nj, 0, HS, [=](int t, int j) { return sd[t * LA + j]; },
        [=](int j, int i) { return ss[i * LA + j]; });
    warp_mma<NJ, F32, true>(
        ak, m0, n0, nj, 0, HS, [=](int s, int j) { return sv[s * LA + j]; },
        [=](int j, int i) { return sD[i * LA + j]; });
    warp_mma<NJ, true, true>(
        av, m0, n0, nj, m0, CHUNK,
        [=](int s, int t) { return sa[t * LT + s]; },
        [=](int t, int j) { return sd[t * LA + j]; });
    const float* cl = sc + CHUNK * LA;
    warp_mma<NJ, true, true>(
        av, m0, n0, nj, 0, HS,
        [=](int s, int i) {
          return sk[s * LA + i] * expf(cl[i] - sc[(s + 1) * LA + i]);
        },
        [=](int i, int j) { return sD[i * LA + j]; });
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        const int n = n0 + 8 * j + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = m0 + g + 8 * half;
          const float db = sda[t * LT + t];
          float o_r[2], o_k[2];
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const int i = n + w, x = t * LA + i;
            const float rt = sr[x], kt = sk[x], bu = db * su[i];
            const float inter = ar[j][2 * half + w] * expf(sc[x]);
            const float state =
                ak[j][2 * half + w] * expf(cl[i] - sc[x + LA]);
            const float rin = sp[x], kin = sq[x];
            o_r[w] = fmaf(bu, kt, inter + rin);
            o_k[w] = fmaf(bu, rt, kin + state);
            sp[x] = rt * (inter + rin);  // X
            sq[x] = kt * kin;            // Y
            zr[j][2 * half + w] = kt * state;  // Z
          }
          if (t0 + t < S) {
            const long long o = ((long long)(b * S + t0 + t) * NH + h) * HS + n;
            store2(dr + o, o_r[0], o_r[1]);
            store2(dk + o, o_k[0], o_k[1]);
            store2(dv + o, av[j][2 * half], av[j][2 * half + 1]);
          }
        }
      }
    }
  }
  __syncthreads();  // every product has read v
  if (nj > 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        const int n = n0 + 8 * j + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = m0 + g + 8 * half;
          store2(sv + t * LA + n, zr[j][2 * half], zr[j][2 * half + 1]);
        }
      }
    }
  }
  __syncthreads();

  // dlw and du's partial, one thread per key channel
  if (threadIdx.x < HS) {
    const int i = threadIdx.x;
    float zl = 0.f;  // e^{L} sum_j S_in dS_out, columns rotated by the row
    for (int jj = 0; jj < HS; ++jj) {
      const int j = (jj + i) % HS;
      zl = fmaf(ss[i * LA + j], sD[i * LA + j], zl);
    }
    zl *= expf(sc[CHUNK * LA + i]);
    float pre = 0.f, dup = 0.f;  // sum of Z over t < tau; du's partial
    for (int t = 0; t < CHUNK; ++t) {
      const float z = sv[t * LA + i];
      sv[t * LA + i] = pre;
      pre += z;
      dup = fmaf(sda[t * LT + t] * sr[t * LA + i], sk[t * LA + i], dup);
    }
    du_part[bhc * HS + i] = dup;
    float sxs = 0.f, sys = 0.f;  // sum of X over t > tau, of Y over t >= tau
    for (int t = CHUNK - 1; t >= 0; --t) {
      sys += sq[t * LA + i];
      if (t0 + t < S) {
        const long long o = ((long long)(b * S + t0 + t) * NH + h) * HS + i;
        dlw[o] = sxs - sys + sv[t * LA + i] + zl;
      }
      sxs += sp[t * LA + i];
    }
  }
}

// (d): du[h][i] = sum over rows b, then chunks c, of du_part[b][h][c][i]
__global__ void wkv_bwd_du_kernel(const float* __restrict__ du_part,
                                  float* __restrict__ du, int B, int NH,
                                  int nc, int HS) {
  const int h = blockIdx.x, i = threadIdx.x;
  if (i >= HS) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = du_part + ((long long)b * NH + h) * nc * HS + i;
    for (int c = 0; c < nc; ++c) acc += p[(long long)c * HS];
  }
  du[h * HS + i] = acc;
}

struct Ptrs {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;
  const float* states;
  const float* dy;
  const float* ds_out;
  void* dr;
  void* dk;
  void* dv;
  float* dlw;
  float* du;
  float* ds0;
  float* gbuf;
  float* decay;
  float* du_part;
};

template <typename T, int HS>
cudaError_t launch(const Ptrs& p, int B, int NH, int S, Strides rs,
                   Strides ks, Strides vs, Strides ws, Strides ds,
                   cudaStream_t stream) {
  const int nc = (S + CHUNK - 1) / CHUNK;
  const T* r = static_cast<const T*>(p.r);
  const dim3 grid(nc, NH, B);
  wkv_bwd_chunk_kernel<T, HS><<<grid, NTH, 0, stream>>>(
      r, p.lw, p.dy, p.gbuf, p.decay, S, NH, nc, rs, ws, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sgrid((HS * HS + SCAN_NT - 1) / SCAN_NT, NH, B);
  wkv_bwd_scan_kernel<<<sgrid, SCAN_NT, 0, stream>>>(p.gbuf, p.decay,
                                                      p.ds_out, p.ds0, HS,
                                                      NH, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = out_smem_floats<HS>() * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_bwd_out_kernel<T, HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  wkv_bwd_out_kernel<T, HS><<<grid, NTH, smem, stream>>>(
      r, static_cast<const T*>(p.k), static_cast<const T*>(p.v), p.lw, p.u,
      p.states, p.dy, p.gbuf, static_cast<T*>(p.dr), static_cast<T*>(p.dk),
      static_cast<T*>(p.dv), p.dlw, p.du_part, S, NH, nc, rs, ks, vs, ws, ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_du_kernel<<<NH, HS, 0, stream>>>(p.du_part, p.du, B, NH, nc, HS);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hs, const Ptrs& p, int B, int NH, int S, Strides rs,
                     Strides ks, Strides vs, Strides ws, Strides ds,
                     cudaStream_t stream) {
  switch (hs) {
    case 8:
      return launch<T, 8>(p, B, NH, S, rs, ks, vs, ws, ds, stream);
    case 16:
      return launch<T, 16>(p, B, NH, S, rs, ks, vs, ws, ds, stream);
    case 32:
      return launch<T, 32>(p, B, NH, S, rs, ks, vs, ws, ds, stream);
    case 64:
      return launch<T, 64>(p, B, NH, S, rs, ks, vs, ws, ds, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v and of dr, dk, dv): 0 = float32, 1 = bfloat16. Strides
// are in elements, (batch, sequence, head), for r, k, v, lw and dy; every
// other tensor is contiguous as the header says, with nc = ceil(S / 32).
// Four launches on `stream`; returns the first cudaError_t (0 on success);
// never synchronizes.
extern "C" int faillite_wkv6_bwd(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* states, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dlw, void* du, void* ds0, void* gbuf,
    void* decay, void* du_part, int dtype, int B, int NH, int S, int hs,
    long long rsb, long long rss, long long rsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long wsb,
    long long wss, long long wsh, long long dsb, long long dss,
    long long dsh, void* stream) {
  if (B <= 0 || NH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Strides rs{rsb, rss, rsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ws{wsb, wss, wsh}, ds{dsb, dss, dsh};
  const Ptrs p{r,
               k,
               v,
               static_cast<const float*>(lw),
               static_cast<const float*>(u),
               static_cast<const float*>(states),
               static_cast<const float*>(dy),
               static_cast<const float*>(ds_out),
               dr,
               dk,
               dv,
               static_cast<float*>(dlw),
               static_cast<float*>(du),
               static_cast<float*>(ds0),
               static_cast<float*>(gbuf),
               static_cast<float*>(decay),
               static_cast<float*>(du_part)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(hs, p, B, NH, S, rs, ks, vs, ws,
                                              ds, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(hs, p, B, NH, S, rs, ks, vs, ws, ds,
                                        st);
  return (int)cudaErrorInvalidValue;
}
