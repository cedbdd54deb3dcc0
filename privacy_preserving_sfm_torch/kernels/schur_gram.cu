// Schur Gram of the explicit-Schur bundle adjustment, for Hopper (sm_90a).
//
// Replaces the reference's TPU kernels in
// privacy_preserving_sfm_tpu/optim/schur_pcg.py:
//   * SoA layout: `_gram_soa_kernel` (`gram_soa`, C <= 512, :383) and
//     `_gram_soa_blocked_kernel` (`gram_soa_blocked`, 512 < C <= 1024,
//     :500), with the semantics of their XLA twin `gram_soa_xla`;
//   * AoS layout: `_gram_kernel` (`gram_fused`, C <= 256, K <= 16, :256),
//     the Gram of the dense-block solver `ba_dense`, with the semantics of
//     `build_u_matrix` followed by its one Gram product.
// Both compute, for per-observation blocks lh[p, k, a, i] (a < 3, i < 6):
//
//   V[p, a, c*6+i] = sum_{k : cam[p, k] == c} lh[p, k, a, i]
//   S_corr         = V^T V                     (6C, 6C), layout 6c+i
//   rhs_corr       = V^T vec(gL)                (6C,)
//
// The layouts differ only in where lh, cam and gL live:
//   SoA: lh (18K, P) row (a*6+i)*K + k, cam (K, P), gl (3, P);
//   AoS: lh (P, K, 3, 6),               cam (P, K), gl (P, 3).
//
// Design.  On the TPU the whole (6C)^2 accumulator sat in VMEM and the
// grid walked points in order.  Here S_corr (151 MB in f32 at C = 1024)
// lives in global memory, and the sum order must stay deterministic, so
// the kernel is output-stationary on camera rows: CTA (c1, j) owns the
// 6 rows of camera c1 against the column cameras c2 in chunk j with
// c2 >= c1, holds that strip in shared memory, and walks c1's
// observations in (point, slot) order from a camera-sorted list.  For each
// observation (p, k1) it stages the point's 18K lh values and K camera ids
// in shared memory; each thread then owns one (k2, i1, i2) term and adds
// sum_a lh[a,i1,k1] * lh[a,i2,k2] to its strip entry.  Slots of one point
// that repeat a camera are summed by the thread of the first of them, so
// no two threads of one step touch one entry and every entry is summed in
// a fixed order: two runs give bit-equal output, with no atomics.  The
// upper blocks (c2 > c1, and i1 <= i2 on the diagonal block) are mirrored
// on write-out, so S_corr is symmetric by construction.  rhs_corr rows of
// c1 are summed by the CTA whose chunk holds c1.
//
// Staging.  The SoA layout puts one point's 18K values P elements apart:
// each staging thread reads its own stride-P element, one sector per
// value.  In the AoS layout they are 18K contiguous values, read by
// consecutive threads in order (coalesced) and transposed into the
// shared (a*6+i)*K + k layout on the way; camera ids and gL likewise.
// Everything after staging is the same code for both layouts.
//
// bf16 mode (the reference's schur_precision="bf16"): each staged lh value
// is rounded to bfloat16 (nearest even) and converted back, and products
// are summed in the input precision; rhs_corr reads the unrounded values
// from global memory.  Off, the code path is the f32/f64 one unchanged.
//
// Bound.  Work is the true sparse Gram, sum_p K_p^2 * 36 * 3 FMAs, with
// none of the one-hot padding of the dense formulation; the kernel is
// latency-bound on its per-observation barrier steps (three
// __syncthreads per observation of c1), in both layouts.  Pipelining the
// staging loads and batching observations are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Element offsets of (p, k, a*6+i) in lh, (p, k) in cam and (p, a) in gl.
template <bool kAoS>
__device__ __forceinline__ size_t lh_at(int p, int k, int ai, int K, int P) {
  return kAoS ? (static_cast<size_t>(p) * K + k) * 18 + ai
              : (static_cast<size_t>(ai) * K + k) * P + p;
}

template <bool kAoS>
__device__ __forceinline__ size_t cam_at(int p, int k, int K, int P) {
  return kAoS ? static_cast<size_t>(p) * K + k
              : static_cast<size_t>(k) * P + p;
}

template <bool kAoS>
__device__ __forceinline__ size_t gl_at(int p, int a, int P) {
  return kAoS ? static_cast<size_t>(p) * 3 + a
              : static_cast<size_t>(a) * P + p;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ double round_bf16(double x) {
  return static_cast<double>(round_bf16(static_cast<float>(x)));
}

template <typename T, bool kAoS>
__global__ void __launch_bounds__(kThreads)
schur_gram_kernel(const T* __restrict__ lh,        // see the layouts above
                  const T* __restrict__ gl,
                  const int* __restrict__ cam,     // < 0: no camera
                  const int* __restrict__ order,   // k*P + p, sorted by (cam, p, k)
                  const int* __restrict__ offsets, // (C + 1) into order
                  T* __restrict__ S,               // (6C, 6C)
                  T* __restrict__ rhs,             // (6C,)
                  int K, int P, int C, int CB, int bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c1 = blockIdx.x;
  const int lo = blockIdx.y * CB;
  const int hi = min(lo + CB, C);
  if (hi <= c1) return;  // this chunk lies below the diagonal
  const int col_lo = max(lo, c1);
  const bool owns_rhs = c1 >= lo && c1 < hi;
  const int tid = threadIdx.x;
  const int stride = 6 * CB;  // one strip row

  T* acc = reinterpret_cast<T*>(smem_raw);  // (6, 6*CB)
  T* lh_s = acc + 6 * stride;               // (18, K)
  T* gl_s = lh_s + 18 * K;                  // (3,) padded to 4
  int* cam_s = reinterpret_cast<int*>(gl_s + 4);
  int* nxt_s = cam_s + K;    // next slot of the same camera, or -1
  int* first_s = nxt_s + K;  // 1 if no earlier slot has the same camera

  for (int e = tid; e < 6 * stride; e += blockDim.x) acc[e] = T(0);
  T rhs_acc = T(0);

  const int beg = offsets[c1];
  const int end = offsets[c1 + 1];
  for (int o = beg; o < end; ++o) {
    const int f = order[o];
    const int k1 = f / P;
    const int p = f - k1 * P;
    __syncthreads();  // the previous step is done with the staging buffers
    // Thread j reads the j-th value of the point in memory order.
    for (int j = tid; j < 18 * K; j += blockDim.x) {
      const int k = kAoS ? j / 18 : j % K;
      const int ai = kAoS ? j - k * 18 : j / K;
      const T v = lh[lh_at<kAoS>(p, k, ai, K, P)];
      lh_s[ai * K + k] = bf16 ? round_bf16(v) : v;
    }
    for (int k = tid; k < K; k += blockDim.x)
      cam_s[k] = cam[cam_at<kAoS>(p, k, K, P)];
    if (tid < 3) gl_s[tid] = gl[gl_at<kAoS>(p, tid, P)];
    __syncthreads();
    for (int k = tid; k < K; k += blockDim.x) {
      const int c = cam_s[k];
      int first = 1;
      for (int j = 0; j < k; ++j) {
        if (cam_s[j] == c) { first = 0; break; }
      }
      int nx = -1;
      for (int j = k + 1; j < K; ++j) {
        if (cam_s[j] == c) { nx = j; break; }
      }
      first_s[k] = first;
      nxt_s[k] = nx;
    }
    __syncthreads();
    for (int idx = tid; idx < 36 * K; idx += blockDim.x) {
      const int k2 = idx / 36;
      const int e = idx - k2 * 36;
      const int i1 = e / 6;
      const int i2 = e - i1 * 6;
      const int c2 = cam_s[k2];
      if (c2 < col_lo || c2 >= hi || !first_s[k2]) continue;
      if (c2 == c1 && i2 < i1) continue;
      T v = T(0);
      for (int kk = k2; kk >= 0; kk = nxt_s[kk]) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          v += lh_s[(a * 6 + i1) * K + k1] * lh_s[(a * 6 + i2) * K + kk];
      }
      acc[i1 * stride + (c2 - lo) * 6 + i2] += v;
    }
    if (owns_rhs && tid < 6) {
      T v = T(0);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        v += lh[lh_at<kAoS>(p, k1, a * 6 + tid, K, P)] * gl_s[a];
      rhs_acc += v;
    }
  }
  __syncthreads();

  const size_t n = 6 * static_cast<size_t>(C);
  const int ncol = (hi - col_lo) * 6;
  for (int idx = tid; idx < 6 * ncol; idx += blockDim.x) {
    const int i1 = idx / ncol;
    const int j = idx - i1 * ncol;
    const int c2 = col_lo + j / 6;
    const int i2 = j % 6;
    const int base = (c2 - lo) * 6;
    if (c2 == c1) {
      const T v = i1 <= i2 ? acc[i1 * stride + base + i2]
                           : acc[i2 * stride + base + i1];
      S[(c1 * 6 + i1) * n + c2 * 6 + i2] = v;
    } else {
      const T v = acc[i1 * stride + base + i2];
      S[(c1 * 6 + i1) * n + c2 * 6 + i2] = v;
      S[(c2 * 6 + i2) * n + c1 * 6 + i1] = v;
    }
  }
  if (owns_rhs && tid < 6) rhs[c1 * 6 + tid] = rhs_acc;
}

template <typename T>
size_t gram_smem_bytes(int K, int CB) {
  return sizeof(T) * (36 * static_cast<size_t>(CB) + 18 * K + 4) +
         sizeof(int) * 3 * static_cast<size_t>(K);
}

template <typename T, bool kAoS>
int launch_gram(const T* lh, const T* gl, const int* cam, const int* order,
                const int* offsets, T* S, T* rhs, int K, int P, int C,
                int CB, int bf16, cudaStream_t stream) {
  if (C <= 0) return 0;
  const size_t smem = gram_smem_bytes<T>(K, CB);
  cudaError_t err = cudaFuncSetAttribute(
      schur_gram_kernel<T, kAoS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(C, (C + CB - 1) / CB);
  schur_gram_kernel<T, kAoS><<<grid, kThreads, smem, stream>>>(
      lh, gl, cam, order, offsets, S, rhs, K, P, C, CB, bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define PPSFM_GRAM_ENTRY(NAME, T, AOS)                                       \
  int NAME(const T* lh, const T* gl, const int* cam, const int* order,      \
           const int* offsets, T* S, T* rhs, int K, int P, int C, int CB,   \
           int bf16, void* stream) {                                         \
    return launch_gram<T, AOS>(lh, gl, cam, order, offsets, S, rhs, K, P,   \
                               C, CB, bf16,                                  \
                               static_cast<cudaStream_t>(stream));           \
  }

PPSFM_GRAM_ENTRY(ppsfm_schur_gram_f32, float, false)
PPSFM_GRAM_ENTRY(ppsfm_schur_gram_f64, double, false)
PPSFM_GRAM_ENTRY(ppsfm_schur_gram_aos_f32, float, true)
PPSFM_GRAM_ENTRY(ppsfm_schur_gram_aos_f64, double, true)

#undef PPSFM_GRAM_ENTRY

}  // extern "C"
