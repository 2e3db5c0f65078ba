// Masked first maximum (the planner's worst-fit reduction) for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_masked_argmax_kernel` in
// src/repro/kernels/planner_argmax/planner_argmax.py (launched from
// `masked_argmax_pallas`). For each of N rows it returns the FIRST index s
// with mask[s] set and values[s] maximal, and that value; (-1, -inf) when
// the row's mask is empty. Exact: comparisons only, no arithmetic.
//
// Layout: values (N, S) float or double with a unit column stride and a
// row stride vs, which may be 0 (one headroom column shared by every
// row: the planner asks for the worst-fit server of each candidate
// variant at once); mask (N, S) bool, one byte, row stride ms; idx int32
// (N,) and val (N,) in the values' type.
//
// Design. The TPU kernel walks (1, 512) tiles in order on one core and
// carries (max, index) in SMEM, taking a later tile only on a strict
// improvement. Here blocks run in parallel, so the order is rebuilt from
// the rule itself: one block per row; each thread walks s = tid, tid+NT,
// ... in ascending order and replaces its (val, idx) pair only on a
// strict improvement, so it keeps the first of its equal maxima; pairs
// then combine by "larger val wins; on equal val the smaller idx wins",
// first with warp shuffles, then across warps through shared memory.
// That combine is associative and commutative, so the result does not
// depend on the order of the reduction: it is the first maximum.
//
// What bounds it on the H100: S * (itemsize + 1) bytes per row (less
// when the values are shared), no arithmetic, so bytes. At the planner's
// sizes (S = servers, 10^3 to 10^4; N = candidate variants, <= 8) a
// launch moves tens of kilobytes, and its time is the launch and one
// block's latency, not the bytes.
//
// The round kernel, `plan_round_kernel`, runs a whole planning round of
// the greedy planner (Algorithm 1, Lines 7-14) in one launch, with this
// reduction inline: the port of the JAX package's jitted `place_chunk`
// scan (src/repro/core/planner/kernels.py), which launches the TPU kernel
// once per chunk. One block walks the round's apps in placement order.
// For each app, its threads run over the servers once and keep, for every
// candidate variant j in [start, stop) at once (MAXV at a time), the first
// maximum of the headroom among servers that are alive, not excluded for
// the app, and have free >= the variant's threshold for every resource;
// every warp then combines the warps' partials the same way, so every
// thread knows each variant's worst-fit server, and the first variant
// that also passes the alpha-budget test is placed. Thread 0 updates the
// server's free row and headroom; every thread keeps its own copy of the
// budget. Then warp 0 runs the upgrade pass over the same order. The state
// (free, headroom, alive and the exclusion stamps) lives in shared memory
// when it fits, else in global memory, where it stays in L2. The host
// reads the round's (variant, server, upgrade) once.
//
// A request with a latency hook passes its mask `lat` (A, V, S) bytes over
// the global server rows, in placement order: variant j of app i may go
// to server s only where lat[(i * V + j) * S + s] is set. The place loop
// tests it beside the feasibility compare and the upgrade pass beside its
// candidate test, as numpy gates both passes. The mask is read from
// global memory (at most A * V * S bytes, once each); a null `lat` skips
// both reads. The place loop first folds a server's mask bytes for the
// variants it reduces into one bit word: testing the bytes inside the
// variant loop kept four row pointers live and made the float kernel
// spill 76 bytes.
//
// Bit-exactness with numpy (vectorized.plan_greedy): the feasibility
// compare is in the state dtype against thresholds the host rounded up
// (`_cmp_thresholds`), the alpha-budget and upgrade tests are f64, and
// every state update is written with the _rn intrinsics, so nvcc cannot
// contract any of it into an FMA: free[k] -= d computes in f64 and casts
// to the state dtype; the upgrade gives back the current variant and takes
// the new one with two casts; the headroom is min over resources of
// free / capacity divided in the state dtype. A round is a chain of
// dependent apps, so its time is the number of apps times the latency of
// one app (a pass over S servers and two block barriers), not the bytes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int NONE = 0x7fffffff; // "no element yet"; loses every combine

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() { return -CUDART_INF_F; }
template <>
__device__ __forceinline__ double neg_inf<double>() { return -CUDART_INF; }

// Does (v2, i2) beat (v1, i1)? An empty pair (i == NONE) beats nothing.
template <typename T>
__device__ __forceinline__ bool beats(T v2, int i2, T v1, int i1) {
  if (i2 == NONE) return false;
  if (i1 == NONE) return true;
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

template <typename T>
__device__ __forceinline__ void warp_combine(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
masked_argmax_kernel(const T* __restrict__ values,
                     const unsigned char* __restrict__ mask, int S,
                     long long vs, long long ms, int* __restrict__ idx_out,
                     T* __restrict__ val_out) {
  const long long row = blockIdx.x;
  const T* v = values + row * vs;
  const unsigned char* m = mask + row * ms;
  T best = neg_inf<T>();
  int bi = NONE;
  for (int s = threadIdx.x; s < S; s += NT) {
    if (m[s]) {
      const T x = v[s];
      if (bi == NONE || x > best) {
        best = x;
        bi = s;
      }
    }
  }
  warp_combine(best, bi);
  __shared__ T sv[NW];
  __shared__ int si[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < NW ? sv[lane] : neg_inf<T>();
    bi = lane < NW ? si[lane] : NONE;
    warp_combine(best, bi);
    if (lane == 0) {
      idx_out[row] = bi == NONE ? -1 : bi;
      val_out[row] = bi == NONE ? neg_inf<T>() : best;
    }
  }
}


// ---------------------------------------------------------------------------
// The round kernel
// ---------------------------------------------------------------------------

constexpr int RT = 512;            // threads of the round kernel
constexpr int RW = RT / 32;        // its warps
constexpr int MAXV = 4;            // candidate variants reduced at once
constexpr int MAXR = 4;            // resources
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory the round kernel may stage its state in
constexpr int STAGE_MAX = 200 * 1024;

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T from_f64(double x);
template <>
__device__ __forceinline__ float from_f64<float>(double x) {
  return __double2float_rn(x);
}
template <>
__device__ __forceinline__ double from_f64<double>(double x) {
  return x;
}

// min over the resources of free / capacity, in the state dtype
template <typename T>
__device__ __forceinline__ T headroom(const T* f, const T* c, int R) {
  T h = div_rn(f[0], c[0]);
#pragma unroll
  for (int r = 1; r < MAXR; ++r) {
    if (r < R) {
      const T x = div_rn(f[r], c[r]);
      if (x < h) h = x;
    }
  }
  return h;
}

template <typename T>
__global__ void __launch_bounds__(RT)
plan_round_kernel(T* free_g, T* head_g, double* budget_g,
                  const T* __restrict__ cap,
                  const unsigned char* __restrict__ alive_g,
                  const int* __restrict__ excl_off,
                  const int* __restrict__ excl_row,
                  const double* __restrict__ dm, const T* __restrict__ dmc,
                  const int* __restrict__ start, const int* __restrict__ stop,
                  const unsigned char* __restrict__ lat,
                  int A, int S, int V, int R, int* out, int* stamp_g,
                  int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T part_v[MAXV][RW];
  __shared__ int part_i[MAXV][RW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* fr = free_g;
  T* hd = head_g;
  int* stamp = stamp_g;
  const unsigned char* alive = alive_g;
  if (staged) {
    fr = reinterpret_cast<T*>(smem);
    hd = fr + (size_t)S * R;
    stamp = reinterpret_cast<int*>(hd + S);
    unsigned char* al = reinterpret_cast<unsigned char*>(stamp + S);
    for (int x = tid; x < S * R; x += RT) fr[x] = free_g[x];
    for (int s = tid; s < S; s += RT) {
      hd[s] = head_g[s];
      al[s] = alive_g[s];
    }
    alive = al;
  }
  // stamp[s] == i: row s is excluded for app i
  for (int s = tid; s < S; s += RT) stamp[s] = -1;
  double bud[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) bud[r] = r < R ? budget_g[r] : 0.0;
  __syncthreads();
  if (A > 0)
    for (int e = excl_off[0] + tid; e < excl_off[1]; e += RT)
      stamp[excl_row[e]] = 0;
  __syncthreads();

  // Lines 7-12, app by app in placement order
  for (int i = 0; i < A; ++i) {
    const int a = start[i], b = stop[i];
    int jrel = b - a, kpl = -1;      // unplaced: (nvar - start, -1)
    for (int j0 = a; j0 < b; j0 += MAXV) {
      const int nj = min(MAXV, b - j0);
      T thr[MAXV][MAXR], best[MAXV];
      int bi[MAXV];
#pragma unroll
      for (int jj = 0; jj < MAXV; ++jj) {
        best[jj] = neg_inf<T>();
        bi[jj] = NONE;
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          thr[jj][r] = (jj < nj && r < R)
                           ? dmc[((size_t)i * V + j0 + jj) * R + r]
                           : T(0);
      }
      // this app's mask rows from variant j0 on, or null
      const unsigned char* lrow =
          lat != nullptr ? lat + ((size_t)i * V + j0) * S : nullptr;
      for (int s = tid; s < S; s += RT) {
        if (!alive[s] || stamp[s] == i) continue;
        // the latency mask's bits for this server, variant j0 + jj in bit jj
        unsigned allow = (1u << MAXV) - 1;
        if (lrow != nullptr) {
          allow = 0;
#pragma unroll
          for (int jj = 0; jj < MAXV; ++jj)
            if (jj < nj && lrow[jj * S + s]) allow |= 1u << jj;
        }
        T f[MAXR];
#pragma unroll
        for (int r = 0; r < MAXR; ++r) f[r] = r < R ? fr[(size_t)s * R + r] : T(0);
        const T h = hd[s];
#pragma unroll
        for (int jj = 0; jj < MAXV; ++jj) {
          bool ok = jj < nj && ((allow >> jj) & 1u);
#pragma unroll
          for (int r = 0; r < MAXR; ++r) ok = ok && (r >= R || f[r] >= thr[jj][r]);
          // ascending s per thread: a strict improvement keeps the first
          if (ok && (bi[jj] == NONE || h > best[jj])) {
            best[jj] = h;
            bi[jj] = s;
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < MAXV; ++jj) {
        if (jj < nj) {
          warp_combine(best[jj], bi[jj]);
          if (lane == 0) {
            part_v[jj][warp] = best[jj];
            part_i[jj][warp] = bi[jj];
          }
        }
      }
      __syncthreads();
      // every warp combines the partials alike: each thread learns every
      // variant's worst-fit server and takes the first variant that has
      // one and passes the alpha-budget test
      int found = -1, fk = -1;
#pragma unroll
      for (int jj = 0; jj < MAXV; ++jj) {
        if (jj < nj) {
          T v = lane < RW ? part_v[jj][lane] : neg_inf<T>();
          int ix = lane < RW ? part_i[jj][lane] : NONE;
          warp_combine(v, ix);
          ix = __shfl_sync(FULL, ix, 0);
          if (found < 0 && ix != NONE) {
            const double* d = dm + ((size_t)i * V + j0 + jj) * R;
            bool ok = true;
#pragma unroll
            for (int r = 0; r < MAXR; ++r)
              ok = ok && (r >= R || bud[r] >= __dsub_rn(d[r], 1e-9));
            if (ok) {
              found = jj;
              fk = ix;
            }
          }
        }
      }
      if (found >= 0) {
        const int j = j0 + found;
        jrel = j - a;
        kpl = fk;
        const double* d = dm + ((size_t)i * V + j) * R;
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < R) bud[r] = __dsub_rn(bud[r], d[r]);
        if (tid == 0) {  // free[k] -= d in f64, cast to the state dtype
          T* f = fr + (size_t)fk * R;
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            if (r < R) f[r] = from_f64<T>(__dsub_rn((double)f[r], d[r]));
          hd[fk] = headroom(f, cap + (size_t)fk * R, R);
        }
      }
      const bool last = found >= 0 || j0 + MAXV >= b;
      if (last && i + 1 < A)  // the next app's exclusions
        for (int e = excl_off[i + 1] + tid; e < excl_off[i + 2]; e += RT)
          stamp[excl_row[e]] = i + 1;
      __syncthreads();
      if (found >= 0) break;
    }
    if (tid == 0) {
      out[i] = jrel;
      out[A + i] = kpl;
    }
  }
  __syncthreads();

  // Lines 13-14 over the same order, in warp 0: lane l tests the l-th
  // larger variant, the first that fits the server's row and the budget
  // wins; give(current) then take(upgrade), two casts, as numpy does
  if (warp == 0) {
    for (int i = 0; i < A; ++i) {
      const int jr = out[i], k = out[A + i];
      const int jc = start[i] + jr;
      int up = -1;
      if (k >= 0 && jc > 0) {
        const unsigned char* lapp =
            lat != nullptr ? lat + (size_t)i * V * S : nullptr;
        const double* dc = dm + ((size_t)i * V + jc) * R;
        T* f = fr + (size_t)k * R;
        for (int u0 = 0; u0 < jc && up < 0; u0 += 32) {
          const int ju = u0 + lane;
          bool ok = ju < jc && (lapp == nullptr || lapp[ju * S + k]);
          if (ok) {
            const double* du = dm + ((size_t)i * V + ju) * R;
#pragma unroll
            for (int r = 0; r < MAXR; ++r) {
              if (r < R) {
                const double ext = __dsub_rn(__dsub_rn(du[r], dc[r]), 1e-9);
                ok = ok && (double)f[r] >= ext && bud[r] >= ext;
              }
            }
          }
          const unsigned m = __ballot_sync(FULL, ok);
          if (m) up = u0 + __ffs(m) - 1;
        }
        if (up >= 0) {
          const double* du = dm + ((size_t)i * V + up) * R;
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            if (r < R) bud[r] = __dsub_rn(__dadd_rn(bud[r], dc[r]), du[r]);
          if (lane == 0) {
#pragma unroll
            for (int r = 0; r < MAXR; ++r) {
              if (r < R) {
                const T given = from_f64<T>(__dadd_rn((double)f[r], dc[r]));
                f[r] = from_f64<T>(__dsub_rn((double)given, du[r]));
              }
            }
            hd[k] = headroom(f, cap + (size_t)k * R, R);
          }
        }
        __syncwarp();
      }
      if (lane == 0) out[2 * A + i] = up;
    }
    if (lane == 0)
      for (int r = 0; r < R; ++r) budget_g[r] = bud[r];
  }
  if (staged) {
    __syncthreads();
    for (int x = tid; x < S * R; x += RT) free_g[x] = fr[x];
    for (int s = tid; s < S; s += RT) head_g[s] = hd[s];
  }
}

template <typename T>
cudaError_t launch_round(void* free, void* head, void* budget,
                         const void* cap, const void* alive,
                         const void* excl_off, const void* excl_row,
                         const void* dm, const void* dmc, const void* start,
                         const void* stop, const void* lat, void* out,
                         void* stamp, int A, int S, int V, int R,
                         cudaStream_t stream) {
  const size_t bytes = (size_t)S * (R + 1) * sizeof(T) + (size_t)S * 5;
  const int staged = bytes <= (size_t)STAGE_MAX;
  static const cudaError_t attr = cudaFuncSetAttribute(
      plan_round_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      STAGE_MAX);
  if (attr != cudaSuccess) return attr;
  plan_round_kernel<T><<<1, RT, staged ? bytes : 0, stream>>>(
      static_cast<T*>(free), static_cast<T*>(head),
      static_cast<double*>(budget), static_cast<const T*>(cap),
      static_cast<const unsigned char*>(alive),
      static_cast<const int*>(excl_off), static_cast<const int*>(excl_row),
      static_cast<const double*>(dm), static_cast<const T*>(dmc),
      static_cast<const int*>(start), static_cast<const int*>(stop),
      static_cast<const unsigned char*>(lat), A, S, V, R,
      static_cast<int*>(out), static_cast<int*>(stamp), staged);
  return cudaGetLastError();
}

}  // namespace

// values: (N, S) with row stride vs (elements; 0 = shared) and unit column
// stride; mask: (N, S) bytes with row stride ms; idx: int32 (N,); val: (N,)
// in the values' type. dtype 0 = float32, 2 = float64. Returns the
// cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int faillite_masked_argmax(const void* values, const void* mask,
                                      void* idx, void* val, int N, int S,
                                      long long vs, long long ms, int dtype,
                                      void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* ip = static_cast<int*>(idx);
  if (dtype == 0) {
    masked_argmax_kernel<float><<<N, NT, 0, st>>>(
        static_cast<const float*>(values), m, S, vs, ms, ip,
        static_cast<float*>(val));
  } else if (dtype == 2) {
    masked_argmax_kernel<double><<<N, NT, 0, st>>>(
        static_cast<const double*>(values), m, S, vs, ms, ip,
        static_cast<double*>(val));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One planning round (see plan_round_kernel). free (S, R) and head (S,)
// in the state dtype and budget (R,) float64 are updated in place; cap
// (S, R) state dtype; alive (S,) bool; the exclusions as CSR by app:
// excl_off int32 (A + 1) offsets into excl_row int32 (server rows); dm
// (A, V, R) float64 demands and dmc (A, V, R) state-dtype thresholds;
// start/stop int32 (A,): the variants app i may try; lat (A, V, S) bytes,
// the latency mask (nonzero = allowed; V * S < 2^31), or null for none;
// out int32 (3, A):
// the placed variant relative to start (stop - start when unplaced), the
// server row (-1) and the upgraded variant (-1); stamp int32 (S,) scratch.
// All contiguous. dtype 0 = float32, 2 = float64; R <= 4. One launch on
// `stream`; returns its cudaError_t (0 on success); never synchronizes.
extern "C" int faillite_plan_round(void* free, void* head, void* budget,
                                   const void* cap, const void* alive,
                                   const void* excl_off, const void* excl_row,
                                   const void* dm, const void* dmc,
                                   const void* start, const void* stop,
                                   const void* lat, void* out, void* stamp,
                                   int A, int S, int V, int R, int dtype,
                                   void* stream) {
  if (A <= 0) return 0;
  if (S <= 0 || V <= 0 || R <= 0 || R > MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_round<float>(
        free, head, budget, cap, alive, excl_off, excl_row, dm, dmc, start,
        stop, lat, out, stamp, A, S, V, R, st));
  if (dtype == 2)
    return static_cast<int>(launch_round<double>(
        free, head, budget, cap, alive, excl_off, excl_row, dm, dmc, start,
        stop, lat, out, stamp, A, S, V, R, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
