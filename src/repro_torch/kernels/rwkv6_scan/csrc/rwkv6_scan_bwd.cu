// Backward of K4's chunked WKV-6 for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces no TPU kernel of its own: the JAX package takes the gradient of
// its `wkv_chunked` / `wkv_scan` (src/repro/models/rwkv6.py) from XLA's
// autodiff. This is the reverse of `faillite_wkv6_chunked` in
// rwkv6_scan.cu, whose TPU counterpart is `_wkv_kernel` in
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py, and its plain version is
// `wkv6_chunked_bwd_ref` in ../ref.py. Per (batch row, head), chunks of
// CHUNK = 32 steps (the last one padded with zeros, as the forward pads),
// with cum the inclusive and cum_prev the exclusive cumulative sum of lw in
// a chunk, L = cum of its last row, S_in the chunk's incoming state (the
// forward's `states` buffer, kept by the autograd Function) and dS_out the
// adjoint of its outgoing state:
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
// Every exponential evaluated has an exponent <= 0 (the pairs E computed
// one by one, as the forward computes its diagonal sub-chunks), so lw
// needs no clamp. Sums run in a fixed order with no atomics: two launches
// give the same bits. The products run in scalar fp32 (no tensor cores).
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
// dlw and the state recomputed), which at hs = 64 lies above the bytes it
// must move, so fp32 operations set its bound. This kernel does more: the
// pairs' exponentials (about C hs per step, three times each) and each
// chunk's hs x hs state and its adjoint through memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CHUNK = 32;  // steps of a chunk, as the forward
constexpr int NTH = 256;   // threads of kernels (a) and (c)
constexpr int SCAN_NT = 256;

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
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;
};

// rows t0 .. t0 + CHUNK - 1 of x (b, :, h, :) into a [CHUNK][ld] tile as
// fp32, rows past S as zeros
template <typename T, int HS>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, Strides xs,
                                          int b, int h, int t0, int S,
                                          float* tile, int ld) {
  for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
    const int t = e / HS, i = e % HS;
    const long long ta = t0 + t;
    tile[t * ld + i] =
        ta < S ? to_f(x[b * xs.b + ta * xs.s + h * xs.h + i]) : 0.f;
  }
}

// sc[0] = 0 and sc[t + 1] = cum_t (inclusive) down each channel's column of
// lw in a [CHUNK + 1][ld] tile, one thread per channel, in step order (the
// forward's own order)
template <int HS>
__device__ __forceinline__ void load_cum(const float* __restrict__ lw,
                                         Strides ws, int b, int h, int t0,
                                         int S, float* sc, int ld) {
  load_tile<float, HS>(lw, ws, b, h, t0, S, sc + ld, ld);
  if (threadIdx.x < HS) sc[threadIdx.x] = 0.f;
  __syncthreads();
  if (threadIdx.x < HS) {
    float* col = sc + ld + threadIdx.x;
    float run = 0.f;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      run += col[t * ld];
      col[t * ld] = run;
    }
  }
}

// (a): per (chunk, head, row), G = (r e^{cum_prev})^T dy into gbuf and
// e^{L} into decay
template <typename T, int HS>
__global__ void __launch_bounds__(NTH)
wkv_bwd_chunk_kernel(const T* __restrict__ r, const float* __restrict__ lw,
                     const float* __restrict__ dy, float* __restrict__ gbuf,
                     float* __restrict__ decay, int S, int NH, int nc,
                     Strides rs, Strides ws, Strides ds) {
  __shared__ float sr[CHUNK][HS], sd[CHUNK][HS], sc[CHUNK + 1][HS];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CHUNK;
  load_tile<T, HS>(r, rs, b, h, t0, S, &sr[0][0], HS);
  load_tile<float, HS>(dy, ds, b, h, t0, S, &sd[0][0], HS);
  load_cum<HS>(lw, ws, b, h, t0, S, &sc[0][0], HS);
  __syncthreads();
  for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
    const int t = e / HS, i = e % HS;
    sr[t][i] *= expf(sc[t][i]);  // r e^{cum_prev}, exponent <= 0
  }
  const long long bhc = ((long long)b * NH + h) * nc + c;
  if (threadIdx.x < HS)
    decay[bhc * HS + threadIdx.x] = expf(sc[CHUNK][threadIdx.x]);
  __syncthreads();
  float* g = gbuf + bhc * HS * HS;
  for (int e = threadIdx.x; e < HS * HS; e += NTH) {
    const int i = e / HS, j = e % HS;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < CHUNK; ++t) acc = fmaf(sr[t][i], sd[t][j], acc);
    g[e] = acc;
  }
}

// (b): per (b, h) state element e, the chunks last to first: write dS_out
// of chunk c over its G and carry dS_in = e^{L_c} dS_out + G_c; ds0 gets
// dS_in of chunk 0
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
  for (int c = nc - 1; c >= 0; --c) {
    const float gc = p[c * step];
    p[c * step] = carry;
    carry = fmaf(dc[(long long)c * HS], carry, gc);
  }
  ds0[bh * step + e] = carry;
}

// the dynamic shared memory of kernel (c), in floats
template <int HS>
constexpr int out_smem_floats() {
  return (CHUNK * 9 + 1) * (HS + 1) + 2 * HS * (HS + 1) + 2 * CHUNK * CHUNK +
         HS;
}

// (c): per (chunk, head, row), dr, dk, dv, dlw and the chunk's du partial
template <typename T, int HS>
__global__ void __launch_bounds__(NTH)
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
  // rows of HS + 1 floats: the pair loops read down a column by s (and
  // the state tiles by i) one lane a row, on distinct banks
  constexpr int LD = HS + 1, LS = HS + 1;
  extern __shared__ float smem[];
  float* sr = smem;                  // [CHUNK][LD] r
  float* sk = sr + CHUNK * LD;       // [CHUNK][LD] k
  float* sv = sk + CHUNK * LD;       // [CHUNK][LD] v
  float* sd = sv + CHUNK * LD;       // [CHUNK][LD] dy
  float* sx = sd + CHUNK * LD;       // [CHUNK][LD] X = r dr'
  float* sy = sx + CHUNK * LD;       // [CHUNK][LD] Y = k dk' (intra)
  float* sz = sy + CHUNK * LD;       // [CHUNK][LD] Z = k dk' (state)
  float* skd = sz + CHUNK * LD;      // [CHUNK][LD] k e^{L - cum}
  float* sc = skd + CHUNK * LD;      // [CHUNK+1][LD] 0, cum_0, .., cum_last
  float* ss = sc + (CHUNK + 1) * LD; // [HS][LS] S_in
  float* sD = ss + HS * LS;          // [HS][LS] dS_out
  float* sa = sD + HS * LS;          // [CHUNK][CHUNK] A, bonus on the diagonal
  float* sda = sa + CHUNK * CHUNK;   // [CHUNK][CHUNK] dy_t . v_s, s <= t
  float* su = sda + CHUNK * CHUNK;   // [HS] u
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CHUNK;
  const long long bhc = ((long long)b * NH + h) * nc + c;
  load_tile<T, HS>(r, rs, b, h, t0, S, sr, LD);
  load_tile<T, HS>(k, ks, b, h, t0, S, sk, LD);
  load_tile<T, HS>(v, vs, b, h, t0, S, sv, LD);
  load_tile<float, HS>(dy, ds, b, h, t0, S, sd, LD);
  const float* sin_g = states + bhc * HS * HS;
  const float* dso_g = dsout + bhc * HS * HS;
  for (int e = threadIdx.x; e < HS * HS; e += NTH) {
    ss[(e / HS) * LS + e % HS] = sin_g[e];
    sD[(e / HS) * LS + e % HS] = dso_g[e];
  }
  if (threadIdx.x < HS) su[threadIdx.x] = u[h * HS + threadIdx.x];
  load_cum<HS>(lw, ws, b, h, t0, S, sc, LD);
  __syncthreads();

  for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
    const int t = e / HS, i = e % HS;
    skd[t * LD + i] =
        sk[t * LD + i] * expf(sc[CHUNK * LD + i] - sc[(t + 1) * LD + i]);
  }
  // A (the pairs s < t and the bonus at s = t) and dy_t . v_s for s <= t
  for (int x = threadIdx.x; x < CHUNK * CHUNK; x += NTH) {
    const int t = x / CHUNK, s = x % CHUNK;
    float a = 0.f, da = 0.f;
    if (s < t) {
      for (int i = 0; i < HS; ++i)
        a = fmaf(sr[t * LD + i] * sk[s * LD + i],
                 expf(sc[t * LD + i] - sc[(s + 1) * LD + i]), a);
    } else if (s == t) {
      for (int i = 0; i < HS; ++i)
        a = fmaf(sr[t * LD + i] * su[i], sk[t * LD + i], a);
    }
    if (s <= t) {
      for (int j = 0; j < HS; ++j)
        da = fmaf(sd[t * LD + j], sv[s * LD + j], da);
    }
    sa[x] = a;
    sda[x] = da;
  }
  __syncthreads();

  // dr and dk of each (step, key channel), and the terms of dlw
  for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
    const int t = e / HS, i = e % HS;
    const float cp = sc[t * LD + i], cu = sc[(t + 1) * LD + i];
    float inter = 0.f, state = 0.f;
    for (int j = 0; j < HS; ++j) {
      inter = fmaf(ss[i * LS + j], sd[t * LD + j], inter);
      state = fmaf(sD[i * LS + j], sv[t * LD + j], state);
    }
    inter *= expf(cp);
    state *= expf(sc[CHUNK * LD + i] - cu);
    float rin = 0.f, kin = 0.f;
    for (int s = 0; s < t; ++s)
      rin = fmaf(sda[t * CHUNK + s] * sk[s * LD + i],
                 expf(cp - sc[(s + 1) * LD + i]), rin);
    for (int q = t + 1; q < CHUNK; ++q)
      kin = fmaf(sda[q * CHUNK + t] * sr[q * LD + i],
                 expf(sc[q * LD + i] - cu), kin);
    const float rt = sr[t * LD + i], kt = sk[t * LD + i];
    const float db = sda[t * CHUNK + t];
    sx[t * LD + i] = rt * (inter + rin);
    sy[t * LD + i] = kt * kin;
    sz[t * LD + i] = kt * state;
    if (t0 + t < S) {
      const long long o = ((long long)(b * S + t0 + t) * NH + h) * HS + i;
      dr[o] = from_f<T>(inter + rin + db * su[i] * kt);
      dk[o] = from_f<T>(kin + state + db * su[i] * rt);
    }
  }
  // dv of each (step, value channel)
  for (int e = threadIdx.x; e < CHUNK * HS; e += NTH) {
    const int t = e / HS, j = e % HS;
    if (t0 + t >= S) continue;
    float acc = 0.f;
    for (int q = t; q < CHUNK; ++q)
      acc = fmaf(sa[q * CHUNK + t], sd[q * LD + j], acc);
    for (int i = 0; i < HS; ++i)
      acc = fmaf(skd[t * LD + i], sD[i * LS + j], acc);
    const long long o = ((long long)(b * S + t0 + t) * NH + h) * HS + j;
    dv[o] = from_f<T>(acc);
  }
  __syncthreads();

  // dlw and du's partial, one thread per key channel
  if (threadIdx.x < HS) {
    const int i = threadIdx.x;
    float zl = 0.f;
    for (int j = 0; j < HS; ++j) zl = fmaf(ss[i * LS + j], sD[i * LS + j], zl);
    zl *= expf(sc[CHUNK * LD + i]);
    float pre = 0.f, dup = 0.f;  // sum of Z over t < tau; du's partial
    for (int t = 0; t < CHUNK; ++t) {
      const float z = sz[t * LD + i];
      sz[t * LD + i] = pre;
      pre += z;
      dup = fmaf(sda[t * CHUNK + t] * sr[t * LD + i], sk[t * LD + i], dup);
    }
    du_part[bhc * HS + i] = dup;
    float sxs = 0.f, sys = 0.f;  // sum of X over t > tau, of Y over t >= tau
    for (int t = CHUNK - 1; t >= 0; --t) {
      sys += sy[t * LD + i];
      if (t0 + t < S) {
        const long long o = ((long long)(b * S + t0 + t) * NH + h) * HS + i;
        dlw[o] = sxs - sys + sz[t * LD + i] + zl;
      }
      sxs += sx[t * LD + i];
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
