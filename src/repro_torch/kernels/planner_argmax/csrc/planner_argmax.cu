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
// block's latency, not the bytes; one block per row keeps at most N of
// the 132 SMs busy. Fusing the planner's whole place/upgrade scan into
// one persistent kernel is the later step.

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
