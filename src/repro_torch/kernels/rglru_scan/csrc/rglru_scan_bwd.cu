// Backward of K3's gated route (the RG-LRU scan) for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces no TPU kernel of its own: the JAX package takes the gradient of
// its `rglru_scan` (src/repro/models/rglru.py, an associative scan over the
// gates of `_gates`) from XLA's autodiff. This kernel is the reverse of
// `faillite_rglru_gated_scan` in rglru_scan.cu, whose TPU counterpart is
// `_rglru_kernel` in src/repro/kernels/rglru_scan/rglru_scan.py. With
//   r = sigmoid(ga), i = sigmoid(gx), log_a = (-8 softplus(L)) r,
//   a = exp(log_a), mult = sqrt(max(1 - exp(2 log_a), 1e-12)),
//   b = mult i x,  h_t = a_t h_{t-1} + b_t  (h_{-1} = h0),
// and the gradients dh of h and dh_last of the last state, it computes the
// adjoint g_t = dh_t + a_{t+1} g_{t+1} (g_{S-1} = dh_{S-1} + dh_last) and
//   da_t = g_t h_{t-1}, db_t = g_t, dh0 = a_0 g_0,
//   dlog_a = da a + db i x dmult,  dmult = -exp(2 log_a) / mult where the
//   clamp is not active and 0 where it is (torch.clamp's and jnp.maximum's
//   gradient off a tie),
//   dga = dlog_a (-8 softplus(L)) r (1 - r), dgx = db mult x i (1 - i),
//   dxb = db mult i, dL = -8 sigmoid(L) sum_{b,t} dlog_a r,
// the plain version being `rglru_gated_scan_bwd_ref` in ../ref.py, and the
// order of this kernel's sums `rglru_gated_scan_bwd_chunked_ref`.
//
// Layout: ga, gx, xb as the forward reads them ((B, S, W) of the model
// dtype, f32 or bf16, batch and sequence strides, unit width stride); h and
// dh (B, S, W) fp32 contiguous; h0, dh_last, dh0 (B, W) fp32 contiguous;
// dga, dgx, dxb (B, S, W) contiguous in the model dtype; log_lambda and
// dlog_lambda (W,) fp32; `part` (B CL, W) fp32 scratch.
//
// Design: the forward's chunked scan run in reverse, the sequence cut into
// chunks of L steps that the wrapper plans (`plan_chunks` in ../ops.py,
// from B, S, W and the SM count). A warp is one chunk of 32 VEC
// consecutive channels of one row (VEC = 2 channels a thread, one
// __nv_bfloat162 or float2 load, where W is even), so each load of a step
// is one contiguous 128- or 256-byte row of every input. A block holds
// NW <= 16 chunks of its channels and a thread block cluster CL <= 8
// blocks, the NW CL chunks of the whole sequence: the cluster spreads one
// channel group over CL SMs. Pass 1: each thread loads its chunk's ga and
// dh, all of them before any is used, and scans the adjoint from the right
// with a zero carry to (P, H) = (prod a, a_{t0} g_{t0}). The carries into
// the chunks (C_{k-1} = P_k C_k + H_k, from dh_last) compose the affine
// maps f_k(x) = P_k x + H_k: a Kogge-Stone tree of warp shuffles inside the
// block (a warp per channel, a lane per chunk), then each block's
// composite read from the later blocks of its cluster through distributed
// shared memory and applied last to first; dh0 is the whole composition at
// dh_last. Pass 2: each chunk rescans from its carry, recomputing a and b
// from (ga, gx, xb, log_lambda) as the forward does, reads h_{t-1}, and
// writes dga, dgx and dxb, the loads of U steps issued together. A chunk
// of at most KMAX = 8 steps (recurrentgemma-2b's S = 256 at B = 1) holds
// its ga and dh in registers between the passes, so each input is read
// once; a longer one reads them again in pass 2. Each thread sums its
// dlog_a r; a block sums its chunks by a shuffle tree into `part` (B CL
// rows), and `rglru_bwd_lambda_kernel` sums `part` over its rows in row
// order: no atomics, and every order fixed by the plan, so two launches
// give the same bits.
//
// What the H100 measurements chose (chip_smoke.py phase 8 (a), PERF.md):
// the time follows the rounds of blocks, not the bytes read: a block's
// loads, its carries and its stores run one after the other, so a grid the
// card cannot hold at once (more than 16 warps an SM at up to 128
// registers a thread) pays that chain twice. The plan takes the most
// chunks the card holds at once, in blocks of 16 warps. Holding ga and dh
// in registers gained about a tenth at B = 1; staging every input in
// shared memory by cp.async gained nothing. The sigmoids' quotient and mult's square root go
// through the SFU (within 2 ulp); only e^{2 log_a}, whose 1 - e^{2 log_a}
// cancels, is rounded as torch.exp rounds it.
//
// What bounds it on the H100: about 35 operations per element (the gates
// recomputed, their derivatives) against 32 bytes moved in f32 (ga, gx, xb,
// h, dh read, dga, dgx, dxb written; 20 in bf16), so bytes over the memory
// rate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAXW = 16;       // chunks (warps) a block at most
constexpr int MAXCL = 8;       // blocks a cluster at most (portable size)
constexpr int KMAX = 8;        // steps of a chunk held in registers at most
constexpr int U = 4;           // steps whose loads are issued together
static_assert(KMAX % U == 0, "a held chunk is whole groups of U steps");
constexpr int LAM_NT = 256;    // threads a block of the dlog_lambda sum
constexpr unsigned FULL = 0xffffffffu;

// 1 / (1 + exp(-x)) with exp as torch.exp rounds it and the quotient by
// the SFU's reciprocal (within 2 ulp): no branch to a division's slow path
// between the step's instructions
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.f, __fadd_rn(1.f, expf(-x)));
}

// F.softplus with beta 1 and threshold 20
__device__ __forceinline__ float softplus_f(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// VEC consecutive values of one step, as one load or store
template <typename T, int VEC>
struct Pack;
template <>
struct Pack<float, 1> {
  using type = float;
  static __device__ __forceinline__ float get(type x, int) { return x; }
  static __device__ __forceinline__ type make(const float (&f)[1]) {
    return f[0];
  }
};
template <>
struct Pack<float, 2> {
  using type = float2;
  static __device__ __forceinline__ float get(type x, int v) {
    return v ? x.y : x.x;
  }
  static __device__ __forceinline__ type make(const float (&f)[2]) {
    return make_float2(f[0], f[1]);
  }
};
template <>
struct Pack<__nv_bfloat16, 1> {
  using type = __nv_bfloat16;
  static __device__ __forceinline__ float get(type x, int) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ type make(const float (&f)[1]) {
    return __float2bfloat16(f[0]);
  }
};
template <>
struct Pack<__nv_bfloat16, 2> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float get(type x, int v) {
    return v ? __high2float(x) : __low2float(x);
  }
  static __device__ __forceinline__ type make(const float (&f)[2]) {
    return __floats2bfloat162_rn(f[0], f[1]);
  }
};

template <typename T, int VEC>
__device__ __forceinline__ typename Pack<T, VEC>::type ld(const T* p) {
  return *reinterpret_cast<const typename Pack<T, VEC>::type*>(p);
}

template <typename T>
struct Args {
  const T* ga;
  const T* gx;
  const T* xb;
  const float* log_lambda;
  const float* h0;
  const float* h;
  const float* dh;
  const float* dh_last;
  T* dga;
  T* dgx;
  T* dxb;
  float* dh0;
  float* part;
  long long gasb, gass, gxsb, gxss, xbsb, xbss;
};

// One step's gradients from the carry x (updated to a g), its r and a,
// dh, gx, xb and h_{t-1}: written to dga, dgx, dxb at o and dlog_a r
// added to lam.
template <typename T, int VEC>
__device__ __forceinline__ void step_grads(
    const Args<T>& p, long long o, const float (&cw)[VEC],
    const float (&r)[VEC], const float (&a)[VEC],
    typename Pack<float, VEC>::type dh, typename Pack<T, VEC>::type gx,
    typename Pack<T, VEC>::type xb, typename Pack<float, VEC>::type hp,
    float (&x)[VEC], float (&lam)[VEC]) {
  using PT = Pack<T, VEC>;
  using PF = Pack<float, VEC>;
  float oga[VEC], ogx[VEC], oxb[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float i = sigmoid_f(PT::get(gx, v));
    const float xv = PT::get(xb, v);
    const float log_a = __fmul_rn(cw[v], r[v]);
    const float e2 = expf(__fmul_rn(2.f, log_a));
    const float one_m = __fsub_rn(1.f, e2);
    // mult = sqrt(max(1 - e2, 1e-12)) and d mult / d log_a = -e2 / mult
    // through one reciprocal square root (within 2 ulp each)
    const float clamped = fmaxf(one_m, 1e-12f);
    const float rs = rsqrtf(clamped);
    const float m = __fmul_rn(clamped, rs);
    const float g = __fadd_rn(PF::get(dh, v), x[v]);
    x[v] = __fmul_rn(a[v], g);
    const float dm = one_m > 1e-12f ? -__fmul_rn(e2, rs) : 0.f;
    const float gi = __fmul_rn(g, i);
    const float dlog_a = fmaf(__fmul_rn(g, PF::get(hp, v)), a[v],
                              __fmul_rn(__fmul_rn(gi, xv), dm));
    lam[v] = fmaf(dlog_a, r[v], lam[v]);
    oga[v] = __fmul_rn(__fmul_rn(__fmul_rn(dlog_a, cw[v]), r[v]),
                       __fsub_rn(1.f, r[v]));
    ogx[v] = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(g, m), xv), i),
                       __fsub_rn(1.f, i));
    oxb[v] = __fmul_rn(__fmul_rn(g, m), i);
  }
  using Q = typename PT::type;
  *reinterpret_cast<Q*>(p.dga + o) = PT::make(oga);
  *reinterpret_cast<Q*>(p.dgx + o) = PT::make(ogx);
  *reinterpret_cast<Q*>(p.dxb + o) = PT::make(oxb);
}

// r = sigmoid(ga) and a = exp(-8 softplus(L) r) of one step
template <typename T, int VEC>
__device__ __forceinline__ void gate_a(typename Pack<T, VEC>::type ga,
                                       const float (&cw)[VEC], float (&r)[VEC],
                                       float (&a)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    r[v] = sigmoid_f(Pack<T, VEC>::get(ga, v));
    a[v] = expf(__fmul_rn(cw[v], r[v]));
  }
}

// One block: channels [32 VEC g, 32 VEC (g + 1)) of row y, chunks
// [NW rank, NW (rank + 1)) of the sequence (rank in the cluster of CL
// blocks x = CL g + rank), chunk = warp. K > 0 (chunks of L <= K steps):
// pass 1 loads the chunk's ga and dh into registers, all at once, and
// pass 2 uses them again; K = 0: pass 1 reads ga and dh in groups of U
// steps and pass 2 reads them again. Pass 2 reads gx, xb and h_{t-1} in
// groups of U steps, all of a group's loads issued together.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(32 * MAXW)
rglru_bwd_kernel(Args<T> p, int S, int W, int L, int CL) {
  using PT = Pack<T, VEC>;
  using PF = Pack<float, VEC>;
  using T2 = typename PT::type;
  using F2 = typename PF::type;
  constexpr int CW = 32 * VEC;  // channels a block
  constexpr int KR = K > 0 ? K : 1;
  __shared__ float sP[MAXW][CW + 1], sH[MAXW][CW + 1];
  __shared__ float cP[CW], cH[CW], sX[CW];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x, warp = threadIdx.y, nw = blockDim.y;
  const int cb = (blockIdx.x / CL) * CW, bb = blockIdx.y;
  const int chunk = rank * nw + warp;
  const int w = cb + lane * VEC;  // the thread's first channel
  const bool on = w < W;          // VEC = 2 only for even W
  const int t0 = min(S, chunk * L), t1 = on ? min(S, t0 + L) : t0;
  const int wc = on ? w : 0;
  const T* ga = p.ga + bb * p.gasb + wc;
  const T* gx = p.gx + bb * p.gxsb + wc;
  const T* xb = p.xb + bb * p.xbsb + wc;
  const long long row = (long long)bb * S * W + wc;
  const float* dh = p.dh + row;
  const float* h = p.h + row;
  // K > 0: step t1 - 1 - u of ga and dh in slot u
  T2 gak[KR];
  F2 dhk[KR];
  if constexpr (K > 0) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const long long t = t1 - 1 - u;
      if (t >= t0) {
        gak[u] = ld<T, VEC>(ga + t * p.gass);
        dhk[u] = ld<float, VEC>(dh + t * W);
      }
    }
  }
  float cw[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    cw[v] = __fmul_rn(-8.f, softplus_f(p.log_lambda[on ? w + v : 0]));

  // pass 1: the chunk's adjoint from a zero carry, right to left
  float P[VEC], H[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    P[v] = 1.f;
    H[v] = 0.f;
  }
  if constexpr (K > 0) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      if (t1 - 1 - u >= t0) {
        float r[VEC], a[VEC];
        gate_a<T, VEC>(gak[u], cw, r, a);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          H[v] = __fmul_rn(a[v], __fadd_rn(PF::get(dhk[u], v), H[v]));
          P[v] = __fmul_rn(P[v], a[v]);
        }
      }
    }
  } else {
    for (int se = t1; se > t0; se -= U) {
      T2 gar[U];
      F2 dhr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long t = se - 1 - u;
        if (t >= t0) {
          gar[u] = ld<T, VEC>(ga + t * p.gass);
          dhr[u] = ld<float, VEC>(dh + t * W);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (se - 1 - u >= t0) {
          float r[VEC], a[VEC];
          gate_a<T, VEC>(gar[u], cw, r, a);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            H[v] = __fmul_rn(a[v], __fadd_rn(PF::get(dhr[u], v), H[v]));
            P[v] = __fmul_rn(P[v], a[v]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    sP[warp][lane * VEC + v] = P[v];
    sH[warp][lane * VEC + v] = H[v];
  }
  __syncthreads();
  // the carries. With f_k(x) = P_k x + H_k, a Kogge-Stone suffix scan
  // over the block's chunks (lane = chunk) gives F_k = f_k o ... o f_last;
  // chunk k keeps F_{k+1} (the identity for the last), the block its
  // composite F_0
  for (int c = warp; c < CW; c += nw) {
    float pk = lane < nw ? sP[lane][c] : 1.f;
    float hk = lane < nw ? sH[lane][c] : 0.f;
    for (int d = 1; d < nw; d *= 2) {
      const float po = __shfl_down_sync(FULL, pk, d);
      const float ho = __shfl_down_sync(FULL, hk, d);
      if (lane + d < nw) {
        hk = fmaf(pk, ho, hk);
        pk = __fmul_rn(pk, po);
      }
    }
    const float pn = __shfl_down_sync(FULL, pk, 1);
    const float hn = __shfl_down_sync(FULL, hk, 1);
    if (lane < nw) {
      sP[lane][c] = lane + 1 < nw ? pn : 1.f;
      sH[lane][c] = lane + 1 < nw ? hn : 0.f;
    }
    if (lane == 0) {
      cP[c] = pk;
      cH[c] = hk;
    }
  }
  cluster.sync();
  // the carry at this block's right end: dh_last through the composites of
  // the later blocks of the cluster, last to first; dh0 from the first
  for (int c = warp * 32 + lane; c < CW; c += 32 * nw) {
    const bool valid = cb + c < W;
    float x = valid ? p.dh_last[bb * W + cb + c] : 0.f;
    for (int q = CL - 1; q > rank; --q)
      x = fmaf(cluster.map_shared_rank(cP, q)[c], x,
               cluster.map_shared_rank(cH, q)[c]);
    sX[c] = x;
    if (rank == 0 && valid) p.dh0[bb * W + cb + c] = fmaf(cP[c], x, cH[c]);
  }
  cluster.sync();  // no block leaves while another reads its composite

  // pass 2: rescan from the carry, the gradients of every step
  float x[VEC], lam[VEC];  // the carry; the sum of dlog_a r over the chunk
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int c = lane * VEC + v;
    x[v] = fmaf(sP[warp][c], sX[c], sH[warp][c]);
    lam[v] = 0.f;
  }
  const long long o0 = (long long)bb * S * W + w;
  // the U steps se - 1, ..., se - U; K > 0: held in slots kb, kb + 1, ..
  auto group = [&](int se, int kb) {
    T2 gar[U], gxr[U], xbr[U];
    F2 dhr[U], hp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = se - 1 - u;
      if (t >= t0) {
        if constexpr (K == 0) {
          gar[u] = ld<T, VEC>(ga + t * p.gass);
          dhr[u] = ld<float, VEC>(dh + t * W);
        } else {
          gar[u] = gak[kb + u];
          dhr[u] = dhk[kb + u];
        }
        gxr[u] = ld<T, VEC>(gx + t * p.gxss);
        xbr[u] = ld<T, VEC>(xb + t * p.xbss);
        hp[u] = t > 0 ? ld<float, VEC>(h + (t - 1) * W)
                      : ld<float, VEC>(p.h0 + bb * W + wc);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = se - 1 - u;
      if (t >= t0) {
        float r[VEC], a[VEC];
        gate_a<T, VEC>(gar[u], cw, r, a);
        step_grads<T, VEC>(p, o0 + t * W, cw, r, a, dhr[u], gxr[u], xbr[u],
                           hp[u], x, lam);
      }
    }
  };
  if constexpr (K > 0) {
#pragma unroll
    for (int kb = 0; kb < K; kb += U) group(t1 - kb, kb);
  } else {
    for (int se = t1; se > t0; se -= U) group(se, 0);
  }
  // dlog_lambda's partial of this block: its chunks summed by a shuffle
  // tree, one row of `part` a (row, cluster rank)
#pragma unroll
  for (int v = 0; v < VEC; ++v) sP[warp][lane * VEC + v] = lam[v];
  __syncthreads();  // the carries were read from sP before
  for (int c = warp; c < CW; c += nw) {
    float s = lane < nw ? sP[lane][c] : 0.f;
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0 && cb + c < W)
      p.part[((long long)bb * CL + rank) * W + cb + c] = s;
  }
}

// dlog_lambda[w] = -8 sigmoid(L_w) sum_q part[q][w], the rows in order
__global__ void __launch_bounds__(LAM_NT)
rglru_bwd_lambda_kernel(const float* __restrict__ part,
                        const float* __restrict__ log_lambda,
                        float* __restrict__ dlog_lambda, int rows, int W) {
  const int w = blockIdx.x * LAM_NT + threadIdx.x;
  if (w >= W) return;
  float s = 0.f;
  for (int q = 0; q < rows; ++q) s += part[(long long)q * W + w];
  dlog_lambda[w] = __fmul_rn(__fmul_rn(s, -8.f), sigmoid_f(log_lambda[w]));
}

template <typename T, int VEC, int K>
cudaError_t launch(const Args<T>& a, float* dlog_lambda, int B, int S, int W,
                   int cl, int nw, int L, cudaStream_t stream) {
  constexpr int CW = 32 * VEC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + CW - 1) / CW * cl, B);
  cfg.blockDim = dim3(32, nw);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, rglru_bwd_kernel<T, VEC, K>, a,
                                       S, W, L, cl);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_lambda_kernel<<<(W + LAM_NT - 1) / LAM_NT, LAM_NT, 0, stream>>>(
      a.part, a.log_lambda, dlog_lambda, B * cl, W);
  return cudaGetLastError();
}

// chunks of at most KMAX steps hold ga and dh in registers between the
// passes; longer ones read them again
template <typename T, int VEC>
cudaError_t launch_k(const Args<T>& a, float* dlog_lambda, int B, int S,
                     int W, int cl, int nw, int L, cudaStream_t stream) {
  if (L <= KMAX) return launch<T, VEC, KMAX>(a, dlog_lambda, B, S, W, cl,
                                             nw, L, stream);
  return launch<T, VEC, 0>(a, dlog_lambda, B, S, W, cl, nw, L, stream);
}

template <typename T>
cudaError_t run(const void* ga, const void* gx, const void* xb,
                const float* log_lambda, const float* h0, const float* h,
                const float* dh, const float* dh_last, void* dga, void* dgx,
                void* dxb, float* dlog_lambda, float* dh0, float* part, int B,
                int S, int W, int vec, int cl, int nw, int L, long long gasb,
                long long gass, long long gxsb, long long gxss, long long xbsb,
                long long xbss, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(ga), static_cast<const T*>(gx),
                  static_cast<const T*>(xb), log_lambda, h0, h, dh, dh_last,
                  static_cast<T*>(dga), static_cast<T*>(dgx),
                  static_cast<T*>(dxb), dh0, part, gasb, gass, gxsb, gxss,
                  xbsb, xbss};
  if (vec == 1)
    return launch_k<T, 1>(a, dlog_lambda, B, S, W, cl, nw, L, stream);
  return launch_k<T, 2>(a, dlog_lambda, B, S, W, cl, nw, L, stream);
}

}  // namespace

// dtype (of ga, gx, xb and of dga, dgx, dxb): 0 = float32, 1 = bfloat16.
// vec: channels a thread (2 only for an even W and even strides);
// a cluster of cl <= 8 blocks of nw <= 16 chunks of L steps covers the
// sequence (cl nw L >= S), as `plan_chunks` plans. Strides of ga, gx, xb
// in elements; every other tensor contiguous as the header says; `part`
// (B cl, W) fp32 scratch. Two launches on `stream`; returns the first
// cudaError_t (0 on success); never synchronizes.
extern "C" int faillite_rglru_gated_scan_bwd(
    const void* ga, const void* gx, const void* xb, const void* log_lambda,
    const void* h0, const void* h, const void* dh, const void* dh_last,
    void* dga, void* dgx, void* dxb, void* dlog_lambda, void* dh0, void* part,
    int dtype, int B, int S, int W, int vec, int cl, int nw, int L,
    long long gasb, long long gass, long long gxsb, long long gxss,
    long long xbsb, long long xbss, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || cl <= 0 || cl > MAXCL || nw <= 0 ||
      nw > MAXW || L <= 0 || (long long)cl * nw * L < S ||
      (vec == 2 && W % 2) || (vec != 1 && vec != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lam = static_cast<const float*>(log_lambda);
  const float* h0f = static_cast<const float*>(h0);
  const float* hf = static_cast<const float*>(h);
  const float* dhf = static_cast<const float*>(dh);
  const float* dlf = static_cast<const float*>(dh_last);
  float* dlam = static_cast<float*>(dlog_lambda);
  float* dh0f = static_cast<float*>(dh0);
  float* pf = static_cast<float*>(part);
  if (dtype == 0)
    return (int)run<float>(ga, gx, xb, lam, h0f, hf, dhf, dlf, dga, dgx, dxb,
                           dlam, dh0f, pf, B, S, W, vec, cl, nw, L, gasb,
                           gass, gxsb, gxss, xbsb, xbss, st);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(ga, gx, xb, lam, h0f, hf, dhf, dlf, dga,
                                   dgx, dxb, dlam, dh0f, pf, B, S, W, vec, cl,
                                   nw, L, gasb, gass, gxsb, gxss, xbsb, xbss,
                                   st);
  return (int)cudaErrorInvalidValue;
}
