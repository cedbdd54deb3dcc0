// Block-Jacobi PCG on the reduced camera system, for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel `_pcg_kernel` (`pcg_fused`,
// privacy_preserving_sfm_tpu/optim/schur_pcg.py:46-104, the kernel call
// at :93) with the contract in which the solvers hold their system:
// `iters` PCG steps on S x = rhs, S = blockdiag(D) - S_corr, from S_corr
// (n, n) symmetric, the (C, 6, 6) blocks D (the damped Hcc) and M (the
// block-Jacobi preconditioner), rhs (n,), n = 6C, with the reference's
// 1e-30 guards on pAp and rz.  The reference pads S and Minv to a multiple
// of 128 with identity rows and rhs with zeros; there r, z, p and S p stay
// exactly 0 and add exact zeros to every dot product, so this kernel works
// at n and reads no dense Minv.
//
// Bound.  A solve needs S_corr once per step: iters * n^2 values, from L2
// while S_corr fits it (float32 n up to ~3,000), else from HBM.  The steps
// are dependent and each needs two device-wide sums (pAp, then r.z), so at
// the mapper's sizes (n of a few hundred) the exchange latency, not bytes,
// sets the time: the floor is about iters * 2 exchanges.
//
// Design.  One persistent launch runs the whole loop.  A CTA owns whole
// 6-row camera blocks, so z = M r reads 36 values a block and fuses with
// the x/r update and the r.z partial.  Every CTA keeps a replica of p in
// shared memory and updates it from the shared z and the scalar beta, the
// same arithmetic in every CTA, so each step has two exchanges:
//   phase 1: p = z + beta p (replica); Ap rows; pAp partial; exchange 1;
//   phase 2: x += alpha p, r -= alpha Ap, z = M r on the owned rows, r.z
//            partial; exchange 2 (skipped in the last step: x is final).
// Why this is race-free with one z buffer and no second p buffer: z is
// written only in phase 2 (by its owners) and read only in phase 1, and
// an exchange lies between every phase 1 and the next phase 2 and between
// every phase 2 and the next phase 1; each replica of p is private to its
// CTA; the pAp partials are written in phase 1 and read just after
// exchange 1, and are next written after exchange 2, which no CTA passes
// before every CTA has read them (the r.z partials likewise, with the
// exchanges swapped); Ap (grid path) is written in phase 1 and read in
// phase 2 by the rows' owners.  Determinism: every sum runs in a fixed
// order (a lane's strided terms in order, then a butterfly that leaves the
// same value on every lane; CTA partials in CTA order), so alpha and beta
// are bit-identical in every CTA and a solve gives one result every run.
//
// Two paths, chosen on the host by size and dtype:
// (i) cluster: one thread-block cluster of 16 CTAs (a non-portable size)
//     holds its owned rows of S_corr in shared memory for the whole
//     solve (n = 600 in float32: 1.44 MB, 90 KB a CTA), so a step reads no
//     global memory; z and the partials are pushed into every CTA's shared
//     memory (distributed shared memory) and the exchanges are cluster
//     barriers.  Bound by two barriers a step.
// (ii) grid: a cooperative grid of one CTA an SM streams S_corr rows with
//     16-byte loads (8-byte in float32 when n is not a multiple of 4),
//     rows spread over every warp of the grid; z, Ap and the partials go
//     through L2 and the exchanges are grid syncs.  Bound by two grid syncs
//     a step at small n, by S_corr's bytes at large n.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 16;  // CTAs of the cluster path

template <typename T>
struct PcgArgs {
  const T* S;    // (n, n) S_corr, row-major
  const T* D;    // (C, 6, 6) blocks of S's block diagonal
  const T* M;    // (C, 6, 6) block-Jacobi preconditioner
  const T* rhs;  // (n,)
  T* x;          // (n,) out
  T* z;          // (n,) grid path: z, written by the rows' owners
  T* Ap;         // (n,) grid path: S p
  T* part;       // (2 * gridDim.x,) grid path: pAp, then r.z partials
  int C;
  int iters;
};

template <typename T, int W>
struct VecOf;
template <>
struct VecOf<float, 4> { using type = float4; };
template <>
struct VecOf<float, 2> { using type = float2; };
template <>
struct VecOf<double, 2> { using type = double2; };

__device__ __forceinline__ float vdot(float s, float4 a, float4 b) {
  s += a.x * b.x;
  s += a.y * b.y;
  s += a.z * b.z;
  return s + a.w * b.w;
}
__device__ __forceinline__ float vdot(float s, float2 a, float2 b) {
  s += a.x * b.x;
  return s + a.y * b.y;
}
__device__ __forceinline__ double vdot(double s, double2 a, double2 b) {
  s += a.x * b.x;
  return s + a.y * b.y;
}

template <typename T>
__device__ __forceinline__ T guard(T v) {
  return (v < T(0) ? -v : v) < T(1e-30) ? T(1e-30) : v;
}

// Butterfly sum over the warp: every lane ends with the same value, since
// each step adds the same two numbers on both lanes of a pair.
template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// A row of S_corr (global or shared) times p (shared), nv vectors of W:
// lane l adds vectors l, l + 32, ... in order, then the butterfly.
template <typename T, int W, bool kGlobal>
__device__ __forceinline__ T row_dot(const T* row, const T* p, int nv,
                                     int lane) {
  using V = typename VecOf<T, W>::type;
  const V* r = reinterpret_cast<const V*>(row);
  const V* q = reinterpret_cast<const V*>(p);
  T s = T(0);
#pragma unroll 4
  for (int j = lane; j < nv; j += 32) {
    V a;
    if constexpr (kGlobal) {
      a = __ldg(r + j);
    } else {
      a = r[j];
    }
    s = vdot(s, a, q[j]);
  }
  return warp_sum(s);
}

// Row k of a 6x6 block b (global) times the 6 values v.
template <typename T>
__device__ __forceinline__ T dot6(const T* __restrict__ b, const T* v) {
  T s = T(0);
#pragma unroll
  for (int j = 0; j < 6; ++j) s += __ldg(b + j) * v[j];
  return s;
}

// Row i of blockdiag(D) p, from the full vector p.
template <typename T>
__device__ __forceinline__ T diag_row(const T* __restrict__ D, const T* p,
                                      int i) {
  const int c = i / 6;
  return dot6(D + static_cast<size_t>(c) * 36 + (i - 6 * c) * 6, p + 6 * c);
}

// The warps' terms summed in warp order (term is the same on every lane of
// a warp); the result is valid on every lane of warp 0.
template <typename T>
__device__ __forceinline__ T block_terms(T term, T* wbuf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) wbuf[warp] = term;
  __syncthreads();
  return warp == 0 ? warp_sum(lane < kWarps ? wbuf[lane] : T(0)) : T(0);
}

// Per-row terms t[0, rows) summed in a fixed order by warp 0 (after a
// __syncthreads); valid on every lane of warp 0.
template <typename T>
__device__ __forceinline__ T rows_sum(const T* t, int rows, int lane) {
  T s = T(0);
  for (int i = lane; i < rows; i += 32) s += t[i];
  return warp_sum(s);
}

// Owned rows [0, rows) starting at camera c0: z = M r into z_out[i] and
// t[i] = r_i z_i.  Thread per row; the caller syncs before (r ready) and
// after (z, t ready).
template <typename T>
__device__ __forceinline__ void owned_z(const T* __restrict__ M, const T* r,
                                        T* z_out, T* t, int rows, int c0) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int c = i / 6;
    const T zi = dot6(M + static_cast<size_t>(c0 + c) * 36 + (i - 6 * c) * 6,
                      r + 6 * c);
    z_out[i] = zi;
    t[i] = r[i] * zi;
  }
}

// Cameras [split(k), split(k + 1)) belong to part k of K: whole cameras,
// an even split.
__device__ __forceinline__ int split(int C, int k, int K) {
  return static_cast<int>(static_cast<long long>(C) * k / K);
}

// ---------------------------------------------------------------------------
// (ii) Grid path
// ---------------------------------------------------------------------------

// Sum of the G partials (global), the same fixed tree in every CTA; the
// result is valid on every thread.
template <typename T>
__device__ __forceinline__ T grid_total(const T* part, int G, T* wbuf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T s = T(0);
  for (int i = threadIdx.x; i < G; i += kThreads) s += __ldcg(part + i);
  s = warp_sum(s);
  if (lane == 0) wbuf[warp] = s;
  __syncthreads();
  return warp_sum(lane < kWarps ? wbuf[lane] : T(0));
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
pcg_grid_kernel(PcgArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T wterm[kWarps];
  __shared__ T wtot[kWarps];
  const int C = a.C;
  const int n = 6 * C;
  const int nv = n / W;
  const int G = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = split(C, blockIdx.x, G);
  const int rows = 6 * (split(C, blockIdx.x + 1, G) - c0);
  const int r0 = 6 * c0;
  const int rows_max = 6 * ((C + G - 1) / G);
  T* p = reinterpret_cast<T*>(smem);  // (n) this CTA's replica of p
  T* r = p + n;                       // (rows_max) owned r
  T* x = r + rows_max;                // owned x
  T* t = x + rows_max;                // owned rows' terms of r.z
  T* part_a = a.part;
  T* part_b = a.part + G;

  // x = 0, r = rhs, z = M r, rz = r.z.
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    r[i] = __ldg(a.rhs + r0 + i);
    x[i] = T(0);
  }
  __syncthreads();
  owned_z(a.M, r, t + rows_max, t, rows, c0);  // z staged after t
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads)
    __stcg(a.z + r0 + i, t[rows_max + i]);
  if (warp == 0) {
    const T s = rows_sum(t, rows, lane);
    if (lane == 0) __stcg(part_b + blockIdx.x, s);
  }
  grid.sync();
  T rz = grid_total(part_b, G, wtot);
  T beta = T(0);

  for (int it = 0; it < a.iters; ++it) {
    // Phase 1: p = z + beta p (p = z in the first step); Ap = D p - S_corr p
    // on rows spread over every warp of the grid; the pAp partial.
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const T zj = __ldcg(a.z + j);
      p[j] = it == 0 ? zj : zj + beta * p[j];
    }
    __syncthreads();
    T term = T(0);
    for (int i = blockIdx.x * kWarps + warp; i < n; i += G * kWarps) {
      const T s = row_dot<T, W, true>(a.S + static_cast<size_t>(i) * n, p,
                                      nv, lane);
      const T ap = diag_row(a.D, p, i) - s;
      if (lane == 0) __stcg(a.Ap + i, ap);
      term += p[i] * ap;
    }
    const T pap = block_terms(term, wterm);
    if (threadIdx.x == 0) __stcg(part_a + blockIdx.x, pap);
    grid.sync();

    // Phase 2: x += alpha p; r -= alpha Ap; z = M r; the r.z partial.
    const T alpha = rz / guard(grid_total(part_a, G, wtot));
    for (int i = threadIdx.x; i < rows; i += kThreads)
      x[i] += alpha * p[r0 + i];
    if (it + 1 == a.iters) break;
    for (int i = threadIdx.x; i < rows; i += kThreads)
      r[i] -= alpha * __ldcg(a.Ap + r0 + i);
    __syncthreads();
    owned_z(a.M, r, t + rows_max, t, rows, c0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += kThreads)
      __stcg(a.z + r0 + i, t[rows_max + i]);
    if (warp == 0) {
      const T s = rows_sum(t, rows, lane);
      if (lane == 0) __stcg(part_b + blockIdx.x, s);
    }
    grid.sync();
    const T rz_new = grid_total(part_b, G, wtot);
    beta = rz_new / guard(rz);
    rz = rz_new;
  }
  for (int i = threadIdx.x; i < rows; i += kThreads) a.x[r0 + i] = x[i];
}

// ---------------------------------------------------------------------------
// (i) Cluster path
// ---------------------------------------------------------------------------

// Sum of the cluster's partials (local shared memory, pushed by every
// CTA), in rank order by a butterfly: the same value on every lane of every
// warp, in every CTA.
template <typename T>
__device__ __forceinline__ T cluster_total(const T* part, int cs, int lane) {
  return warp_sum(lane < cs ? part[lane] : T(0));
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
pcg_cluster_kernel(PcgArgs<T> a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T wterm[kWarps];
  __shared__ T part_a[kCluster];  // pAp partials, by rank
  __shared__ T part_b[kCluster];  // r.z partials, by rank
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = a.C;
  const int n = 6 * C;
  const int nv = n / W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = split(C, rank, cs);
  const int rows = 6 * (split(C, rank + 1, cs) - c0);
  const int r0 = 6 * c0;
  const int rows_max = 6 * ((C + cs - 1) / cs);
  T* srow = reinterpret_cast<T*>(smem);  // (rows_max, n) S_corr rows
  T* p = srow + static_cast<size_t>(rows_max) * n;  // (n) replica of p
  T* zf = p + n;        // (n) z, each owner's rows pushed to every CTA
  T* r = zf + n;        // (rows_max) owned r
  T* x = r + rows_max;  // owned x
  T* ap = x + rows_max;  // owned S p
  T* t = ap + rows_max;  // owned rows' terms of r.z

  // The owned rows of S_corr, once, into shared memory.
  {
    using V = typename VecOf<T, W>::type;
    const V* src =
        reinterpret_cast<const V*>(a.S + static_cast<size_t>(r0) * n);
    V* dst = reinterpret_cast<V*>(srow);
    const int total = rows * nv;
#pragma unroll 4
    for (int j = threadIdx.x; j < total; j += kThreads)
      dst[j] = __ldg(src + j);
  }
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    r[i] = __ldg(a.rhs + r0 + i);
    x[i] = T(0);
  }
  // Every CTA of the cluster runs before any writes into another's shared
  // memory.
  cluster.sync();

  // Pushes the owned rows of zf and this CTA's partial v (valid on warp 0)
  // into every CTA of the cluster.
  auto push = [&](T* part, T v) {
    for (int idx = threadIdx.x; idx < cs * rows; idx += kThreads) {
      const int k = idx / rows;
      const int i = r0 + idx - k * rows;
      if (k != rank) cluster.map_shared_rank(zf, k)[i] = zf[i];
    }
    if (warp == 0 && lane < cs) cluster.map_shared_rank(part, lane)[rank] = v;
  };

  owned_z(a.M, r, zf + r0, t, rows, c0);
  __syncthreads();
  push(part_b, warp == 0 ? rows_sum(t, rows, lane) : T(0));
  cluster.sync();
  T rz = cluster_total(part_b, cs, lane);
  T beta = T(0);

  for (int it = 0; it < a.iters; ++it) {
    // Phase 1: p = z + beta p; Ap = D p - S_corr p on the owned rows.
    for (int j = threadIdx.x; j < n; j += kThreads)
      p[j] = it == 0 ? zf[j] : zf[j] + beta * p[j];
    __syncthreads();
    T term = T(0);
    for (int i = warp; i < rows; i += kWarps) {
      const T s = row_dot<T, W, false>(srow + static_cast<size_t>(i) * n, p,
                                       nv, lane);
      const T v = diag_row(a.D, p, r0 + i) - s;
      if (lane == 0) ap[i] = v;
      term += p[r0 + i] * v;
    }
    const T pap = block_terms(term, wterm);
    if (warp == 0 && lane < cs)
      cluster.map_shared_rank(part_a, lane)[rank] = pap;
    cluster.sync();

    // Phase 2: x += alpha p; r -= alpha Ap; z = M r; the r.z partial.
    const T alpha = rz / guard(cluster_total(part_a, cs, lane));
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      x[i] += alpha * p[r0 + i];
      r[i] -= alpha * ap[i];
    }
    if (it + 1 == a.iters) break;
    __syncthreads();
    owned_z(a.M, r, zf + r0, t, rows, c0);
    __syncthreads();
    push(part_b, warp == 0 ? rows_sum(t, rows, lane) : T(0));
    cluster.sync();
    const T rz_new = cluster_total(part_b, cs, lane);
    beta = rz_new / guard(rz);
    rz = rz_new;
  }
  // No CTA touches another's shared memory after the last cluster barrier.
  for (int i = threadIdx.x; i < rows; i += kThreads) a.x[r0 + i] = x[i];
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T>
size_t cluster_smem(int C) {
  const size_t n = 6 * static_cast<size_t>(C);
  const size_t rows_max =
      6 * static_cast<size_t>((C + kCluster - 1) / kCluster);
  return (rows_max * n + 2 * n + 4 * rows_max) * sizeof(T);
}

template <typename T>
size_t grid_smem(int C, int G) {
  const size_t n = 6 * static_cast<size_t>(C);
  const size_t rows_max = 6 * static_cast<size_t>((C + G - 1) / G);
  return (n + 4 * rows_max) * sizeof(T);
}

cudaLaunchConfig_t cluster_config(int cs, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Opens `kernel`'s dynamic shared memory to the most a CTA can have (and
// allows clusters of kCluster CTAs), once per kernel; returns that most, 0 if
// the card refuses.
template <typename K>
size_t open_smem(K kernel) {
  int device = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&device) == cudaSuccess &&
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) == cudaSuccess &&
      cudaFuncGetAttributes(&fa, kernel) == cudaSuccess) {
    const int most = optin - static_cast<int>(fa.sharedSizeBytes);
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most) == cudaSuccess &&
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) == cudaSuccess)
      return static_cast<size_t>(most);
  }
  cudaGetLastError();
  return 0;
}

// Whether one cluster of kCluster CTAs holds C cameras; kept for the last
// C, since a solve launches at one C throughout.  A refusal is an answer,
// not a failure: its error is cleared, so that the launch's check sees
// only its own.
template <typename T, int W>
bool cluster_fits(int C, cudaStream_t stream) {
  auto kernel = pcg_cluster_kernel<T, W>;
  static const size_t most = open_smem(kernel);
  static int last_C = -1;
  static bool last_fit = false;
  if (C == last_C) return last_fit;
  const size_t smem = cluster_smem<T>(C);
  bool fit = false;
  if (smem <= most) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(kCluster, smem, stream, &attr);
    int clusters = 0;
    fit = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) ==
              cudaSuccess &&
          clusters > 0;
    cudaGetLastError();
  }
  last_C = C;
  last_fit = fit;
  return fit;
}

// path: 0 auto (the cluster path where it fits, else the grid path), 1
// cluster, 2 grid.  *taken: the path launched, 1 cluster, 2 grid.
template <typename T, int W>
int launch_pcg(PcgArgs<T> a, int blocks, int path, int* taken,
               cudaStream_t stream) {
  *taken = 0;
  if (a.C <= 0) return 0;
  cudaError_t err;
  if (path != 2) {
    if (cluster_fits<T, W>(a.C, stream)) {
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg =
          cluster_config(kCluster, cluster_smem<T>(a.C), stream, &attr);
      err = cudaLaunchKernelEx(&cfg, pcg_cluster_kernel<T, W>, a);
      if (err != cudaSuccess) return static_cast<int>(err);
      *taken = 1;
      return static_cast<int>(cudaGetLastError());
    }
    if (path == 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto kernel = pcg_grid_kernel<T, W>;
  static const size_t most = open_smem(kernel);
  const size_t smem = grid_smem<T>(a.C, blocks);
  if (blocks < 1 || smem > most)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // Refuses a grid that cannot be resident all at once.
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  *taken = 2;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
PcgArgs<T> pcg_args(const T* S, const T* D, const T* M, const T* rhs, T* x,
                    T* work, int C, int iters) {
  const size_t n = 6 * static_cast<size_t>(C);
  return PcgArgs<T>{S, D, M, rhs, x, work, work + n, work + 2 * n, C, iters};
}

// ---------------------------------------------------------------------------
// Probes for the floor: one grid sync, one cluster barrier, the L2 rate
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) grid_sync_probe_kernel(int reps) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < reps; ++i) grid.sync();
}

__global__ void __launch_bounds__(kThreads)
cluster_sync_probe_kernel(int reps) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < reps; ++i) cluster.sync();
}

// Reads buf (nv 16-byte vectors, held in L2 after the first pass) reps
// times over the grid; one sum a thread keeps the loads live.
__global__ void __launch_bounds__(kThreads)
l2_read_probe_kernel(const float4* __restrict__ buf, int nv, int reps,
                     float* out) {
  float s = 0.f;
  for (int r = 0; r < reps; ++r)
#pragma unroll 4
    for (int j = blockIdx.x * kThreads + threadIdx.x; j < nv;
         j += gridDim.x * kThreads) {
      const float4 v = __ldcg(buf + j);
      s += v.x + v.y + v.z + v.w;
    }
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// x (6C,) from S_corr (6C, 6C), D and M (C, 6, 6) and rhs (6C,); work:
// 2 * 6C + 2 * blocks elements of scratch (grid path); blocks: the grid
// path's CTAs (one an SM).  See launch_pcg for path and taken.
int ppsfm_schur_pcg_f32(const float* S, const float* D, const float* M,
                        const float* rhs, float* x, float* work, int C,
                        int iters, int blocks, int path, int* taken,
                        void* stream) {
  const PcgArgs<float> a = pcg_args(S, D, M, rhs, x, work, C, iters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((6 * C) % 4 == 0) return launch_pcg<float, 4>(a, blocks, path, taken, s);
  return launch_pcg<float, 2>(a, blocks, path, taken, s);
}

int ppsfm_schur_pcg_f64(const double* S, const double* D, const double* M,
                        const double* rhs, double* x, double* work, int C,
                        int iters, int blocks, int path, int* taken,
                        void* stream) {
  return launch_pcg<double, 2>(pcg_args(S, D, M, rhs, x, work, C, iters),
                               blocks, path, taken,
                               static_cast<cudaStream_t>(stream));
}

// `reps` grid syncs of a cooperative grid of `blocks` CTAs (cluster_ctas
// 0), or `reps` barriers of one cluster of cluster_ctas CTAs; both of the
// PCG's CTA size.
int ppsfm_sync_probe(int cluster_ctas, int reps, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster_ctas > 0) {
    err = cudaFuncSetAttribute(cluster_sync_probe_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(cluster_ctas, 0, s, &attr);
    err = cudaLaunchKernelEx(&cfg, cluster_sync_probe_kernel, reps);
  } else {
    void* args[] = {&reps};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(grid_sync_probe_kernel), dim3(blocks),
        dim3(kThreads), args, 0, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// reps reads of buf (nv float4, L2-resident) by `blocks` CTAs of the
// PCG's size; out: blocks * 512 floats.
int ppsfm_l2_probe(const void* buf, int nv, int reps, float* out, int blocks,
                   void* stream) {
  l2_read_probe_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), nv, reps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
