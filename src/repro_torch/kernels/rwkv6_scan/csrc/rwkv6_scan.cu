// RWKV-6 WKV for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_wkv_kernel` in
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py (launched from `wkv6_pallas`).
// Per (batch row, head), with an (hs x hs) fp32 state S from s0:
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,        w_t = exp(lw_t).
// This is the recurrence the model's `wkv_scan` states. The TPU kernel
// computes the chunk-parallel form from a zero state and clamps
// lw >= -40/chunk, because its split (r e^{cum_prev}) @ (k e^{-cum})^T
// overflows for strong decays. Both paths here take lw as it is (no clamp)
// and start from the slot's state.
//
// Layout: r, k, v (B, S, nh, hs) in the activation dtype (fp32 or bf16)
// and lw (B, S, nh, hs) fp32, read through batch/sequence/head element
// strides with a unit last stride (the model's layout, no transpose);
// u (nh, hs) fp32; s0 and s_out (B, nh, hs, hs) fp32 with each (b, h) block
// contiguous; y (B, S, nh, hs) fp32. s_out may alias s0.
//
// Two paths, chosen by the wrapper from S alone:
//
// * Decode (S = 1): `wkv_kernel`, the recurrence. One block of hs threads
//   serves one (batch row, head); thread j keeps column j of the state in
//   registers and reads column j of s0 before it writes the same column of
//   s_out. It stages CT steps of r, k, w = exp(lw) and v in shared memory at
//   a time, then each step is hs fused multiply-adds per thread. About
//   7 hs^2 flops on 4 hs values read per (b, h): fp32 operations bound it.
//
// * Prefill (S > 1): the chunk-parallel form of the model's `wkv_chunked`,
//   in three kernels over chunks of CHUNK = 32 steps (the last one padded
//   with zeros, as `wkv_chunked` pads), each chunk cut into sub-chunks of
//   SUB = 16 rows. With cum the inclusive cumulative sum of lw inside a
//   chunk, cum_prev the exclusive one and b_p the first row of sub-chunk p,
//   every exponent that is evaluated is <= 0, so nothing overflows and lw
//   needs no clamp:
//     (a) `wkv_chunk_state_kernel`, one block per (chunk, head, row): the
//         chunk's state increment dS = (k e^{cum_last - cum})^T v and its
//         decay e^{cum_last};
//     (b) `wkv_chunk_scan_kernel`: per state element, a walk over the chunks
//         S_in[c+1] = e^{cum_last_c} S_in[c] + dS_c that writes each chunk's
//         S_in over its dS in the scratch buffer and the final state to
//         s_out. The thread that reads an element of s0 is the one that
//         writes it to s_out, and (c) reads only the scratch buffer, so
//         s_out may be s0;
//     (c) `wkv_chunk_out_kernel`, one block per (chunk, head, row):
//         y = (r e^{cum_prev}) @ S_in + A @ v, where A (CHUNK x CHUNK, lower
//         triangular) holds, for t in sub-chunk p and s < b_p,
//         (r_t e^{cum_prev_t - cum_prev_{b_p}}) . (k_s e^{cum_prev_{b_p} - cum_s})
//         (a matrix product), on the diagonal sub-chunks
//         sum_k r_t k_s exp(min(cum_prev_t - cum_s, 0)) for s < t, computed
//         exactly in fp32 outside the tensor cores as `wkv_chunked` does, and
//         the bonus r_t . (u k_t) at s = t.
//   Every matrix product runs on the tensor cores as mma.sync m16n8k8 TF32
//   with fp32 sums, split 3xTF32 (hi.hi + hi.lo + lo.hi) wherever an operand
//   is fp32 data (the state, the decayed r and k, A), which keeps about 21
//   bits of each product; a bf16 v is exact in TF32 and is not split. Blocks
//   run in parallel over chunks: nh x ceil(S / 32) of them per row, 320 at
//   rwkv6-3b's 40 heads and S = 256, against 40 for the recurrence. Sums run
//   in a fixed order with no atomics, so the result is deterministic.
//   Kernels (a) and (c) run eight warps a block; each thread loads its
//   rows of one channel before it uses any and sums its lw rows in
//   registers. What bounds it on the H100: the function needs about
//   7 hs^2 flops per (b, h, t) (the bound chip_smoke.py reports, at the fp32
//   rate); the chunked form does more (the diagonal's exponentials, 3 mma
//   per product) and moves each chunk's hs x hs state through memory four
//   times (written by (a), read and written by (b), read by (c)), and a
//   block's chain load -> cumsum -> products is short, so bytes and
//   per-block latency, not the tensor cores, set its time.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CT = 16;  // time steps staged per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {
  long long b, s, h;
};

template <typename T, int HS>
__global__ void __launch_bounds__(HS)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, const float* s0,
           float* __restrict__ y, float* s_out, int S, Strides rs, Strides ks,
           Strides vs, Strides ws, Strides ys, long long s0b, long long s0h,
           long long sob, long long soh) {
  __shared__ float sr[CT][HS], sk[CT][HS], sw[CT][HS], sv[CT][HS], su[HS];
  const int j = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;

  float st[HS];  // st[i] = S[i][j]
  const float* s0p = s0 + b * s0b + h * s0h;
#pragma unroll
  for (int i = 0; i < HS; ++i) st[i] = s0p[i * HS + j];
  su[j] = u[h * HS + j];

  const T* rp = r + b * rs.b + h * rs.h + j;
  const T* kp = k + b * ks.b + h * ks.h + j;
  const T* vp = v + b * vs.b + h * vs.h + j;
  const float* wp = lw + b * ws.b + h * ws.h + j;
  float* yp = y + b * ys.b + h * ys.h + j;

  for (int t0 = 0; t0 < S; t0 += CT) {
    const int n = min(CT, S - t0);
    float cr[CT], ck[CT], cw[CT], cv[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < n) {
        const long long t = t0 + c;
        cr[c] = to_f(rp[t * rs.s]);
        ck[c] = to_f(kp[t * ks.s]);
        cv[c] = to_f(vp[t * vs.s]);
        cw[c] = wp[t * ws.s];
      }
    }
    __syncthreads();  // the previous pass's shared reads are done
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < n) {
        sr[c][j] = cr[c];
        sk[c][j] = ck[c];
        sw[c][j] = expf(cw[c]);
        sv[c][j] = cv[c];
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float yj = 0.f;
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const float kv = sk[c][i] * vj;
        yj = fmaf(sr[c][i], fmaf(su[i], kv, st[i]), yj);
        st[i] = fmaf(sw[c][i], st[i], kv);
      }
      yp[(long long)(t0 + c) * ys.s] = yj;
    }
  }

  float* sop = s_out + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < HS; ++i) sop[i * HS + j] = st[i];
}

template <typename T, int HS>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* lw, const float* u, const float* s0, float* y,
                   float* s_out, int B, int NH, int S, Strides rs, Strides ks,
                   Strides vs, Strides ws, Strides ys, long long s0b,
                   long long s0h, long long sob, long long soh,
                   cudaStream_t stream) {
  dim3 grid(NH, B);
  wkv_kernel<T, HS><<<grid, HS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, s0, y, s_out, S, rs, ks, vs, ws, ys,
      s0b, s0h, sob, soh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hs(int hs, const void* r, const void* k, const void* v,
                        const float* lw, const float* u, const float* s0,
                        float* y, float* s_out, int B, int NH, int S,
                        Strides rs, Strides ks, Strides vs, Strides ws,
                        Strides ys, long long s0b, long long s0h,
                        long long sob, long long soh, cudaStream_t stream) {
  switch (hs) {
    case 8:
      return launch<T, 8>(r, k, v, lw, u, s0, y, s_out, B, NH, S, rs, ks, vs,
                          ws, ys, s0b, s0h, sob, soh, stream);
    case 16:
      return launch<T, 16>(r, k, v, lw, u, s0, y, s_out, B, NH, S, rs, ks, vs,
                           ws, ys, s0b, s0h, sob, soh, stream);
    case 32:
      return launch<T, 32>(r, k, v, lw, u, s0, y, s_out, B, NH, S, rs, ks, vs,
                           ws, ys, s0b, s0h, sob, soh, stream);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s0, y, s_out, B, NH, S, rs, ks, vs,
                           ws, ys, s0b, s0h, sob, soh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The chunked path (S > 1)
// ---------------------------------------------------------------------------

constexpr int CHUNK = 32;  // steps of a chunk
constexpr int SUB = 16;    // rows of a sub-chunk: the mma M tile
constexpr int NSUB = CHUNK / SUB;
constexpr int NTH = 256;   // threads of kernels (a) and (c): eight warps
constexpr int NWARP = NTH / 32;
constexpr int SCAN_NT = 256;

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
// fa(row, kk) and B(kk, col) = fb(kk, col) in fp32, 3xTF32; SPLIT_B false
// drops B's low part (B exact in TF32). Fragment layouts of m16n8k8 .tf32
// (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); c0/c1 (g, 2t / 2t + 1),
// c2/c3 (g + 8, 2t / 2t + 1).
template <int NJ, bool SPLIT_B, class FA, class FB>
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
        mma_tf32(acc[j], al, bh0, bh1);
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
// consecutive channels.
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
// of a [CHUNK][ld] shared tile, one thread per channel, in step order
// (one rounding per step, as the recurrence's own decay products have):
// a sum split across threads rounds each exponent difference more than
// once, which lw near -20 turns into visible error.
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

// (a): per (chunk, head, row), dS = (k e^{cum_last - cum})^T v (hs x hs)
// into `states` and e^{cum_last} into `decay`.
template <typename T, int HS>
__global__ void __launch_bounds__(NTH)
wkv_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ lw,
                       float* __restrict__ states, float* __restrict__ decay,
                       int S, int NH, int nc, Strides ks, Strides vs,
                       Strides ws) {
  // k^T is the A operand (row = key channel, read down a column of sk) and
  // v the B operand: both are read with the time index on t, so their rows
  // are padded to 8 mod 32 floats (conflict-free fragment loads)
  constexpr int LB = HS + 8, LC = HS + 4, ROWS = Rows<HS>::ROWS;
  __shared__ float sk[CHUNK][LB], sv[CHUNK][LB], sc[CHUNK][LC];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CHUNK;
  const int i = threadIdx.x % HS, row0 = (threadIdx.x / HS) * ROWS;
  float kr[ROWS], vr[ROWS], wr[ROWS];
  load_rows<T, HS>(k, ks, b, h, t0, S, kr);  // rows past S: zeros, as
  load_rows<T, HS>(v, vs, b, h, t0, S, vr);  // wkv_chunked pads
  load_rows<float, HS>(lw, ws, b, h, t0, S, wr);
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    sk[row0 + q][i] = kr[q];
    sv[row0 + q][i] = vr[q];
    sc[row0 + q][i] = wr[q];
  }
  __syncthreads();
  column_cumsum<HS>(&sc[0][0], LC);  // sc[t] = cum_t (inclusive)
  __syncthreads();
  // k_s e^{cum_last - cum_s}, exponent <= 0
#pragma unroll
  for (int q = 0; q < ROWS; ++q)
    sk[row0 + q][i] *= expf(sc[CHUNK - 1][i] - sc[row0 + q][i]);
  const long long bh = (long long)b * NH + h;
  if (threadIdx.x < HS)
    decay[(bh * nc + c) * HS + threadIdx.x] =
        expf(sc[CHUNK - 1][threadIdx.x]);
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
  const float* kp = &sk[0][0];
  const float* vp = &sv[0][0];
  warp_mma<NJ, !std::is_same<T, __nv_bfloat16>::value>(
      acc, m0, n0, nj, 0, CHUNK,
      [=](int i, int s) { return i < HS ? kp[s * LB + i] : 0.f; },
      [=](int s, int n) { return vp[s * LB + n]; });
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float* out = states + (bh * nc + c) * HS * HS;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nj) {
      const int n = n0 + 8 * j + 2 * tq;
      const int i0 = m0 + g, i1 = m0 + g + 8;
      if (i0 < HS) {
        out[i0 * HS + n] = acc[j][0];
        out[i0 * HS + n + 1] = acc[j][1];
      }
      if (i1 < HS) {
        out[i1 * HS + n] = acc[j][2];
        out[i1 * HS + n + 1] = acc[j][3];
      }
    }
  }
}

// (b): per (b, h) state element e, walk the chunks in order: write S_in[c]
// over dS_c and carry S_in[c+1] = e^{cum_last_c} S_in[c] + dS_c; the final
// state goes to s_out. Reads s0[e] before it writes s_out[e], in one thread.
__global__ void __launch_bounds__(SCAN_NT)
wkv_chunk_scan_kernel(float* __restrict__ states,
                      const float* __restrict__ decay, const float* s0,
                      float* s_out, int HS, int NH, int nc, long long s0b,
                      long long s0h, long long sob, long long soh) {
  const int e = blockIdx.x * SCAN_NT + threadIdx.x;
  if (e >= HS * HS) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * NH + h;
  const long long step = (long long)HS * HS;
  float* p = states + bh * nc * step + e;
  const float* g = decay + bh * nc * HS + e / HS;
  float st = s0[b * s0b + h * s0h + e];
  constexpr int GRP = 8;  // chunks whose loads are issued together
  for (int c0 = 0; c0 < nc; c0 += GRP) {
    float ds[GRP], dc[GRP];
#pragma unroll
    for (int q = 0; q < GRP; ++q) {
      if (c0 + q < nc) {
        ds[q] = p[(c0 + q) * step];
        dc[q] = g[(long long)(c0 + q) * HS];
      }
    }
#pragma unroll
    for (int q = 0; q < GRP; ++q) {
      if (c0 + q < nc) {
        p[(c0 + q) * step] = st;
        st = fmaf(dc[q], st, ds[q]);
      }
    }
  }
  s_out[b * sob + h * soh + e] = st;
}

// the dynamic shared memory of kernel (c), in floats
template <int HS>
constexpr int out_smem_floats() {
  return CHUNK * (HS + 4) * 3 + CHUNK * (HS + 8) + (CHUNK + 1) * (HS + 4) +
         HS * (HS + 8) + CHUNK * (CHUNK + 4) + HS;
}

// (c): per (chunk, head, row), y = (r e^{cum_prev}) @ S_in + A @ v.
template <typename T, int HS>
__global__ void __launch_bounds__(NTH)
wkv_chunk_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u,
                     const float* __restrict__ states, float* __restrict__ y,
                     int S, int NH, int nc, Strides rs, Strides ks,
                     Strides vs, Strides ws, Strides ys) {
  // row strides in floats: 4 mod 32 for tiles read as A fragments (row on
  // g) and for k (read with the time index on g), 8 mod 32 for tiles read
  // as B fragments (row on t)
  constexpr int LA = HS + 4, LB = HS + 8, LT = CHUNK + 4;
  extern __shared__ float smem[];
  float* sr = smem;                  // [CHUNK][LA] r, then r e^{cum_prev}
  float* srl = sr + CHUNK * LA;      // [CHUNK][LA] r e^{cum_prev - cum_prev_b}
  float* sk = srl + CHUNK * LA;      // [CHUNK][LA] k
  float* sv = sk + CHUNK * LA;       // [CHUNK][LB] v
  float* sc = sv + CHUNK * LB;       // [CHUNK+1][LA] row t: cum_prev_t
  float* ss = sc + (CHUNK + 1) * LA; // [HS][LB] S_in
  float* sa = ss + HS * LB;          // [CHUNK][LT] A
  float* su = sa + CHUNK * LT;       // [HS] u
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CHUNK;
  const long long bh = (long long)b * NH + h;
  constexpr int ROWS = Rows<HS>::ROWS;
  constexpr int SV = HS * HS / 4 / NTH;  // float4s of S_in per thread
  const int i = threadIdx.x % HS, row0 = (threadIdx.x / HS) * ROWS;
  float rr[ROWS], kr[ROWS], vr[ROWS], wr[ROWS];
  float4 sin4[SV > 0 ? SV : 1];
  const float4* s_in =
      reinterpret_cast<const float4*>(states + (bh * nc + c) * HS * HS);
#pragma unroll
  for (int q = 0; q < SV; ++q) sin4[q] = s_in[threadIdx.x + q * NTH];
  load_rows<T, HS>(r, rs, b, h, t0, S, rr);
  load_rows<T, HS>(k, ks, b, h, t0, S, kr);
  load_rows<T, HS>(v, vs, b, h, t0, S, vr);
  load_rows<float, HS>(lw, ws, b, h, t0, S, wr);
  if (SV == 0 && threadIdx.x < HS * HS / 4) sin4[0] = s_in[threadIdx.x];
  if (threadIdx.x < HS) {
    su[threadIdx.x] = u[h * HS + threadIdx.x];
    sc[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    sr[(row0 + q) * LA + i] = rr[q];
    sk[(row0 + q) * LA + i] = kr[q];
    sv[(row0 + q) * LB + i] = vr[q];
    sc[(row0 + q + 1) * LA + i] = wr[q];
  }
#pragma unroll
  for (int q = 0; q < (SV > 0 ? SV : 1); ++q) {
    const int e4 = threadIdx.x + q * NTH;
    if (e4 < HS * HS / 4) {
      const int e = 4 * e4;
      float* d = ss + (e / HS) * LB + e % HS;
      d[0] = sin4[q].x;
      d[1] = sin4[q].y;
      d[2] = sin4[q].z;
      d[3] = sin4[q].w;
    }
  }
  __syncthreads();
  // sc[t] = cum_prev_t = cum_{t-1}; sc[CHUNK] = cum_last
  column_cumsum<HS>(sc + LA, LA);
  __syncthreads();
  // r decayed to the first row of its sub-chunk (exponent <= 0)
  for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
    const int t = e / HS, i = e % HS;
    const int bp = (t / SUB) * SUB;
    srl[t * LA + i] =
        sr[t * LA + i] * expf(sc[t * LA + i] - sc[bp * LA + i]);
  }
  // the diagonal sub-chunks of A, exactly: pair q of the 120 (t, s) with
  // s < t in sub-chunk p (one round of the block's threads), rows read
  // as float4 (LA is a multiple of 4)
  constexpr int TRI = SUB * (SUB - 1) / 2;
  for (int x = threadIdx.x; x < NSUB * TRI; x += NTH) {
    const int p = x / TRI;
    int q = x % TRI, tt = 1;
    while (q >= tt) {  // q -> (tt, q) in row-major strict-lower order
      q -= tt;
      ++tt;
    }
    const int t = p * SUB + tt, s = p * SUB + q;
    const float4* rt = reinterpret_cast<const float4*>(sr + t * LA);
    const float4* kt = reinterpret_cast<const float4*>(sk + s * LA);
    const float4* ct = reinterpret_cast<const float4*>(sc + t * LA);
    const float4* cs = reinterpret_cast<const float4*>(sc + (s + 1) * LA);
    float a = 0.f;  // sum_i r_t k_s exp(min(cum_prev_t - cum_s, 0))
#pragma unroll 4
    for (int i4 = 0; i4 < HS / 4; ++i4) {
      const float4 r4 = rt[i4], k4 = kt[i4], c4 = ct[i4], d4 = cs[i4];
      a = fmaf(r4.x * k4.x, expf(fminf(c4.x - d4.x, 0.f)), a);
      a = fmaf(r4.y * k4.y, expf(fminf(c4.y - d4.y, 0.f)), a);
      a = fmaf(r4.z * k4.z, expf(fminf(c4.z - d4.z, 0.f)), a);
      a = fmaf(r4.w * k4.w, expf(fminf(c4.w - d4.w, 0.f)), a);
    }
    sa[t * LT + s] = a;
  }
  // the bonus r_t . (u k_t) at s = t, and 0 above the diagonal inside a
  // diagonal sub-chunk (the A @ v product reads every column up to the
  // end of the row's sub-chunk)
  for (int x = threadIdx.x; x < NSUB * SUB * SUB; x += NTH) {
    const int p = x / (SUB * SUB), tt = (x / SUB) % SUB, q = x % SUB;
    const int t = p * SUB + tt;
    if (q == tt) {
      const float4* rt = reinterpret_cast<const float4*>(sr + t * LA);
      const float4* kt = reinterpret_cast<const float4*>(sk + t * LA);
      const float4* u4 = reinterpret_cast<const float4*>(su);
      float a = 0.f;
#pragma unroll 4
      for (int i4 = 0; i4 < HS / 4; ++i4) {
        const float4 r4 = rt[i4], k4 = kt[i4], w4 = u4[i4];
        a = fmaf(r4.x * w4.x, k4.x, a);
        a = fmaf(r4.y * w4.y, k4.y, a);
        a = fmaf(r4.z * w4.z, k4.z, a);
        a = fmaf(r4.w * w4.w, k4.w, a);
      }
      sa[t * LT + t] = a;
    } else if (q > tt) {
      sa[t * LT + p * SUB + q] = 0.f;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // the off-diagonal sub-chunk pairs: A[t in p, s < b_p], (16 x 8) tiles
  // enumerated over (p >= 1, q < 2p), one warp each
  for (int x = warp; x < NSUB * (NSUB - 1); x += NWARP) {
    int p = 1, q = x;
    while (q >= 2 * p) {
      q -= 2 * p;
      ++p;
    }
    const int bp = p * SUB;
    float acc[1][4];
    zero(acc);
    const float* cb = sc + bp * LA;  // cum_prev at b_p
    warp_mma<1, true>(
        acc, bp, q * 8, 1, 0, HS,
        [=](int t, int i) { return srl[t * LA + i]; },
        [=](int i, int s) {
          return sk[s * LA + i] * expf(cb[i] - sc[(s + 1) * LA + i]);
        });
    const int s = q * 8 + 2 * tq;
    sa[(bp + g) * LT + s] = acc[0][0];
    sa[(bp + g) * LT + s + 1] = acc[0][1];
    sa[(bp + g + 8) * LT + s] = acc[0][2];
    sa[(bp + g + 8) * LT + s + 1] = acc[0][3];
  }
  // r e^{cum_prev}, in place (srl and the diagonal are done with r)
  for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
    const int t = e / HS, i = e % HS;
    sr[t * LA + i] *= expf(sc[t * LA + i]);
  }
  __syncthreads();

  // y: warps tile (CHUNK x HS), NWARP / NSUB warps on each sub-chunk of rows
  constexpr int NT8 = HS / 8, WN = NWARP / NSUB, NJ = (NT8 + WN - 1) / WN;
  const int mt = warp / WN, wn = warp % WN;
  const int nj = min(NJ, NT8 - wn * NJ);
  if (nj <= 0) return;
  float acc[NJ][4];
  zero(acc);
  const int m0 = mt * SUB, n0 = wn * NJ * 8;
  warp_mma<NJ, true>(
      acc, m0, n0, nj, 0, HS, [=](int t, int i) { return sr[t * LA + i]; },
      [=](int i, int n) { return ss[i * LB + n]; });
  warp_mma<NJ, !std::is_same<T, __nv_bfloat16>::value>(
      acc, m0, n0, nj, 0, m0 + SUB,
      [=](int t, int s) { return sa[t * LT + s]; },
      [=](int s, int n) { return sv[s * LB + n]; });
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nj) {
      const int n = n0 + 8 * j + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long ta = t0 + m0 + g + 8 * half;
        if (ta < S) {
          float* yp = y + b * ys.b + ta * ys.s + h * ys.h + n;
          yp[0] = acc[j][2 * half];
          yp[1] = acc[j][2 * half + 1];
        }
      }
    }
  }
}

template <typename T, int HS>
cudaError_t launch_chunked(const void* r, const void* k, const void* v,
                           const float* lw, const float* u, const float* s0,
                           float* y, float* s_out, float* states,
                           float* decay, int B, int NH, int S, Strides rs,
                           Strides ks, Strides vs, Strides ws, Strides ys,
                           long long s0b, long long s0h, long long sob,
                           long long soh, cudaStream_t stream) {
  const int nc = (S + CHUNK - 1) / CHUNK;
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const dim3 grid(nc, NH, B);
  wkv_chunk_state_kernel<T, HS><<<grid, NTH, 0, stream>>>(
      kp, vp, lw, states, decay, S, NH, nc, ks, vs, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sgrid((HS * HS + SCAN_NT - 1) / SCAN_NT, NH, B);
  wkv_chunk_scan_kernel<<<sgrid, SCAN_NT, 0, stream>>>(
      states, decay, s0, s_out, HS, NH, nc, s0b, s0h, sob, soh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = out_smem_floats<HS>() * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_chunk_out_kernel<T, HS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  wkv_chunk_out_kernel<T, HS><<<grid, NTH, smem, stream>>>(
      rp, kp, vp, lw, u, states, y, S, NH, nc, rs, ks, vs, ws, ys);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_chunked(int hs, const void* r, const void* k,
                             const void* v, const float* lw, const float* u,
                             const float* s0, float* y, float* s_out,
                             float* states, float* decay, int B, int NH,
                             int S, Strides rs, Strides ks, Strides vs,
                             Strides ws, Strides ys, long long s0b,
                             long long s0h, long long sob, long long soh,
                             cudaStream_t stream) {
#define WKV_CHUNKED(HS_)                                                    \
  case HS_:                                                                 \
    return launch_chunked<T, HS_>(r, k, v, lw, u, s0, y, s_out, states,     \
                                  decay, B, NH, S, rs, ks, vs, ws, ys, s0b, \
                                  s0h, sob, soh, stream);
  switch (hs) {
    WKV_CHUNKED(8)
    WKV_CHUNKED(16)
    WKV_CHUNKED(32)
    WKV_CHUNKED(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef WKV_CHUNKED
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16. Strides are in elements:
// (batch, sequence, head) for r, k, v, lw and y; (batch, head) for s0 and
// s_out. Returns the cudaError_t of the launch (0 on success); never
// synchronizes.
extern "C" int faillite_wkv6(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* y, void* s_out, int dtype, int B,
    int NH, int S, int hs, long long rsb, long long rss, long long rsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long wsb, long long wss, long long wsh, long long ysb,
    long long yss, long long ysh, long long s0b, long long s0h, long long sob,
    long long soh, void* stream) {
  if (B <= 0 || NH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Strides rs{rsb, rss, rsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ws{wsb, wss, wsh}, ys{ysb, yss, ysh};
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sof = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hs<float>(hs, r, k, v, lwf, uf, s0f, yf, sof, B, NH,
                                   S, rs, ks, vs, ws, ys, s0b, s0h, sob, soh,
                                   st);
  if (dtype == 1)
    return (int)dispatch_hs<__nv_bfloat16>(hs, r, k, v, lwf, uf, s0f, yf, sof,
                                           B, NH, S, rs, ks, vs, ws, ys, s0b,
                                           s0h, sob, soh, st);
  return (int)cudaErrorInvalidValue;
}

// The chunked path (S > 1): the arguments of faillite_wkv6, then the
// scratch buffers states (B, nh, ceil(S / 32), hs, hs) and decay
// (B, nh, ceil(S / 32), hs), both fp32 and contiguous. Three launches on
// `stream`; returns the first cudaError_t (0 on success); never
// synchronizes.
extern "C" int faillite_wkv6_chunked(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* y, void* s_out, void* states,
    void* decay, int dtype, int B, int NH, int S, int hs, long long rsb,
    long long rss, long long rsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long wsb, long long wss,
    long long wsh, long long ysb, long long yss, long long ysh, long long s0b,
    long long s0h, long long sob, long long soh, void* stream) {
  if (B <= 0 || NH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Strides rs{rsb, rss, rsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      ws{wsb, wss, wsh}, ys{ysb, yss, ysh};
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sof = static_cast<float*>(s_out);
  float* stf = static_cast<float*>(states);
  float* dcf = static_cast<float*>(decay);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_chunked<float>(hs, r, k, v, lwf, uf, s0f, yf, sof,
                                        stf, dcf, B, NH, S, rs, ks, vs, ws,
                                        ys, s0b, s0h, sob, soh, st);
  if (dtype == 1)
    return (int)dispatch_chunked<__nv_bfloat16>(
        hs, r, k, v, lwf, uf, s0f, yf, sof, stf, dcf, B, NH, S, rs, ks, vs,
        ws, ys, s0b, s0h, sob, soh, st);
  return (int)cudaErrorInvalidValue;
}
