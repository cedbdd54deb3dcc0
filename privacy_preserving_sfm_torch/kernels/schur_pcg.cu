// Block-Jacobi PCG on the dense reduced camera system, for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel `_pcg_kernel` (`pcg_fused`,
// privacy_preserving_sfm_tpu/optim/schur_pcg.py:46-104) with the contract
// of its XLA twin `pcg_xla`: x = pcg(S, Minv, rhs, iters) for dense
// symmetric S and Minv of (N, N), a fixed iteration count, and the same
// 1e-30 guards on pAp and rz.
//
// Design.  The TPU kernel kept S, Minv and the CG vectors in VMEM.  Here
// S alone is 1.6 MB at C = 100 and 151 MB at C = 1024 (f32), so it streams
// from global memory (L2 holds it at the small sizes).  One persistent
// cooperative kernel runs the whole loop: a warp computes one row of each
// matvec (S p, Minv r) with a fixed lane order and a shuffle tree; each
// block folds its rows' dot-product terms in warp order into one partial;
// after a grid-wide sync every block reduces all partials with the same
// fixed tree, so the scalars alpha and beta are identical in every block
// and the result is deterministic.  Four grid syncs per CG step.  Values
// written during the run are read with __ldcg (L2), since L1 is not
// coherent across SMs.
//
// Bound.  Bytes: two dense N x N matvecs per step (S and Minv) at C = 1024
// are 302 MB per step in f32; at the mapper's sizes the grid syncs and
// the per-row latency dominate.  Using Minv's 6x6 block diagonal and
// vectorised row loads are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T guard(T v) {
  return (v < T(0) ? -v : v) < T(1e-30) ? T(1e-30) : v;
}

// Dot product of a read-only matrix row with a vector written in this run.
template <typename T>
__device__ __forceinline__ T warp_dot(const T* __restrict__ row, const T* v,
                                      int n, int lane) {
  T s = T(0);
  for (int j = lane; j < n; j += 32) s += __ldg(row + j) * __ldcg(v + j);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Writes this block's partial sum: the warps' terms, added in warp order.
template <typename T>
__device__ void block_partial(T term, T* wpart, T* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) wpart[warp] = term;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += wpart[w];
    __stcg(out + blockIdx.x, s);
  }
  __syncthreads();
}

// Sum of all blocks' partials by a fixed tree: the same value in every block.
template <typename T>
__device__ T grid_total(const T* part, T* red) {
  T s = T(0);
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += blockDim.x)
    s += __ldcg(part + i);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const T out = red[0];
  __syncthreads();
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
schur_pcg_kernel(const T* __restrict__ S, const T* __restrict__ Minv,
                 const T* __restrict__ rhs, T* x, T* r, T* p, T* z, T* Ap,
                 T* part, int N, int iters) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[kThreads];
  __shared__ T wpart[kWarps];
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int tw = gridDim.x * kWarps;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = gridDim.x * blockDim.x;
  T* part_a = part;
  T* part_b = part + gridDim.x;
  const size_t n = static_cast<size_t>(N);

  // z0 = Minv rhs; x = 0; r = rhs; p = z0; rz = r . z0.
  T term = T(0);
  for (int row = gw; row < N; row += tw) {
    const T v = warp_dot(Minv + row * n, rhs, N, lane);
    if (lane == 0) {
      const T b = __ldg(rhs + row);
      __stcg(p + row, v);
      __stcg(r + row, b);
      __stcg(x + row, T(0));
      term += b * v;
    }
  }
  block_partial(term, wpart, part_b);
  grid.sync();
  T rz = grid_total(part_b, red);

  for (int it = 0; it < iters; ++it) {
    // Ap = S p; pAp = p . Ap.
    term = T(0);
    for (int row = gw; row < N; row += tw) {
      const T v = warp_dot(S + row * n, p, N, lane);
      if (lane == 0) {
        __stcg(Ap + row, v);
        term += __ldcg(p + row) * v;
      }
    }
    block_partial(term, wpart, part_a);
    grid.sync();
    const T alpha = rz / guard(grid_total(part_a, red));
    for (int i = gt; i < N; i += nt) {
      __stcg(x + i, __ldcg(x + i) + alpha * __ldcg(p + i));
      __stcg(r + i, __ldcg(r + i) - alpha * __ldcg(Ap + i));
    }
    grid.sync();
    // z = Minv r; rz_new = r . z.
    term = T(0);
    for (int row = gw; row < N; row += tw) {
      const T v = warp_dot(Minv + row * n, r, N, lane);
      if (lane == 0) {
        __stcg(z + row, v);
        term += __ldcg(r + row) * v;
      }
    }
    block_partial(term, wpart, part_b);
    grid.sync();
    const T rz_new = grid_total(part_b, red);
    const T beta = rz_new / guard(rz);
    for (int i = gt; i < N; i += nt)
      __stcg(p + i, __ldcg(z + i) + beta * __ldcg(p + i));
    rz = rz_new;
    grid.sync();
  }
}

template <typename T>
int launch_pcg(const T* S, const T* Minv, const T* rhs, T* x, T* work,
               int N, int iters, int max_blocks, cudaStream_t stream) {
  if (N <= 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, schur_pcg_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = per_sm * sms;
  const int row_blocks = (N + kWarps - 1) / kWarps;
  if (blocks > row_blocks) blocks = row_blocks;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  T* r = work;
  T* p = work + N;
  T* z = work + 2 * static_cast<size_t>(N);
  T* Ap = work + 3 * static_cast<size_t>(N);
  T* part = work + 4 * static_cast<size_t>(N);
  void* args[] = {&S, &Minv, &rhs, &x, &r, &p, &z, &Ap, &part, &N, &iters};
  err = cudaLaunchCooperativeKernel(
      (void*)schur_pcg_kernel<T>, dim3(blocks),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// work: 4 * N + 2 * max_blocks elements of scratch.
int ppsfm_schur_pcg_f32(const float* S, const float* Minv, const float* rhs,
                        float* x, float* work, int N, int iters,
                        int max_blocks, void* stream) {
  return launch_pcg<float>(S, Minv, rhs, x, work, N, iters, max_blocks,
                           static_cast<cudaStream_t>(stream));
}

int ppsfm_schur_pcg_f64(const double* S, const double* Minv,
                        const double* rhs, double* x, double* work, int N,
                        int iters, int max_blocks, void* stream) {
  return launch_pcg<double>(S, Minv, rhs, x, work, N, iters, max_blocks,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
