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
// The layouts differ only in where lh, the slot map and gL live:
//   SoA: lh (18K, P) row (a*6+i)*K + k, slot map (K, P), gl (3, P);
//   AoS: lh (P, K, 3, 6),               slot map (P, K), gl (P, 3).
//
// Inputs beside lh and gl come from the wrapper's Gram plan
// (optim/schur_pcg.py:gram_plan), built once per solve: each point's
// distinct cameras in ascending order (dcam (P, M), count (P,)), the slot
// -> distinct-camera map (slot_d, -1 for a slot with no camera), and the
// (point, distinct camera) observations sorted by (camera, point), as
// flat rows p*M + j of Vc with per-camera offsets (C + 1,).
//
// Pass 1, compaction (gram_compact_kernel).  A CTA takes consecutive
// points; its threads walk the slots in order and write
//   Vc[p, j, 0:18]  = 0 + the point's slots in its j-th distinct camera,
//                     added in slot order: the reference's V entry;
//   Vc[p, j, 18:24] = Vc[p, j, 0:18]^T gL[p]   (the rhs term, unrounded).
// Reads coalesce in both layouts (SoA: threads run along points; AoS:
// along the 18 values of a slot).  The sums are built in a shared-memory
// tile of up to 32 points' rows (as many as fit 112 KB, but at least one
// 32-byte sector of a SoA row: 8 points in float32, 4 in float64), copied
// out whole, so writes coalesce too; only M > 149 adds into Vc in global
// memory instead.  In bf16 mode the V entry, not the slot, is rounded to
// bfloat16 (nearest even) after its rhs term is taken, as the reference
// rounds V (`astype(bfloat16)` of the built V panels, and of the one-hot
// product in `gram_soa_xla`), and the three TPU kernels keep their rhs in
// float32.  From here on both stagings run the same code.
//
// Pass 2, camera strips (gram_strip_kernel).  Output-stationary, which is
// what keeps S deterministic without atomics: CTA (c1, chunk, split) owns
// the 6 rows of camera c1 against the column cameras c2 >= c1 of one chunk
// of CB cameras.  c1's observation list is cut into NS splits, and each
// split into one fixed sub-range per warp.  A warp keeps a private strip
// (6, 6*CB) in shared memory and walks its sub-range with no block
// barrier: for observation (p, j1) every lane holds the 18 values of
// Vc[p, j1] in registers and takes (j2, i2) tasks, adding
// sum_a Vc[p,j1,a,i1] Vc[p,j2,a,i2] for i1 < 6 into strip entry
// (i1, c2, i2).  The point's cameras ascend, so the columns of the chunk
// with c2 >= c1 are one range of j2, found by a warp-wide count, and no
// lane takes a task outside it.  A point's distinct cameras are distinct,
// so no two lanes of one observation touch one entry, and __syncwarp
// orders observations.
// The warps' strips are then summed in warp order; with NS > 1 each split
// writes a partial (6C, 6C) upper part and gram_reduce_kernel sums the
// splits in order.  So every entry is summed in a fixed order: two runs,
// and the SoA and AoS stagings, give bit-equal output.  The diagonal
// block is written from its i1 <= i2 half and every upper block mirrored,
// so S_corr is symmetric by construction; each camera's rows are written
// whether it has observations or not.
//
// Bound.  Work is the sparse Gram over the upper camera pairs, with none
// of the one-hot padding of the dense formulation: for a point of m_p
// distinct cameras, 108 FMAs for each of its m_p (m_p - 1) / 2 pairs
// c1 < c2, 63 for the i1 <= i2 half of each diagonal block and 18 for
// each rhs term.  Pass 1 reads lh and
// writes Vc once each, in full lines (20 MB in float32 at the main
// path's shape, a few microseconds of the card's bandwidth).  At the main
// path's shape (K = 6, P = 20000, C = 100) the FMAs take a few
// microseconds of the card's FP32 rate and Vc (11.5 MB) sits in L2; pass
// 2 is bound by the instructions each walk of an observation issues (the
// list entry, its row, the column range, then one round of at most 36
// tasks), and an observation is walked once for each column chunk at or
// right of its camera.  The splits give each SM about 24 warps, which
// hide the loads' latency: staging the next observations' rows into a
// shared ring by cp.async, tried on an H100, added instructions and
// shared memory and was no faster.  At K = 128 the shared-memory
// read-modify-writes of the strips (one per 3 FMAs) bound pass 2.
// float32 stays on the CUDA cores in full FP32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 32;  // points per compaction CTA, at most
constexpr int kRow = 24;     // one Vc row: 18 V entries and 6 rhs terms
constexpr int kTileBytes = 112 * 1024;  // pass 1's shared tile, at most

// Element offsets of (p, k, a*6+i) in lh, (p, k) in the slot map and
// (p, a) in gl.
template <bool kAoS>
__device__ __forceinline__ size_t lh_at(int p, int k, int ai, int K, int P) {
  return kAoS ? (static_cast<size_t>(p) * K + k) * 18 + ai
              : (static_cast<size_t>(ai) * K + k) * P + p;
}

template <bool kAoS>
__device__ __forceinline__ size_t slot_at(int p, int k, int K, int P) {
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

// kTile: the CTA's pts points of Vc are built in shared memory (each
// point's rows at an odd stride, against bank conflicts) and copied out
// whole, so both stagings write Vc in full lines; otherwise (one sector's
// worth of points over kTileBytes) the slots are added into Vc in global
// memory.
template <typename T, bool kAoS, bool kTile>
__global__ void __launch_bounds__(kThreads)
gram_compact_kernel(const T* __restrict__ lh, const T* __restrict__ gl,
                    const int* __restrict__ slot_d,  // < 0: no camera
                    const int* __restrict__ count,   // (P,)
                    T* __restrict__ Vc,              // (P, M, kRow)
                    int K, int P, int M, int pts, int bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p0 = blockIdx.x * pts;
  const int np = min(pts, P - p0);
  const int per_point = M * kRow;
  const int pstride = kTile ? per_point + 1 : per_point;
  T* base = kTile ? reinterpret_cast<T*>(smem_raw)
                  : Vc + static_cast<size_t>(p0) * per_point;
  for (int idx = threadIdx.x; idx < pts * 18; idx += kThreads) {
    const int pl = kAoS ? idx / 18 : idx % pts;
    const int e = kAoS ? idx - pl * 18 : idx / pts;
    if (pl >= np) continue;
    const int p = p0 + pl;
    T* row = base + static_cast<size_t>(pl) * pstride + e;
    const int m = count[p];
    for (int j = 0; j < m; ++j) row[j * kRow] = T(0);
    for (int k = 0; k < K; ++k) {
      const int d = slot_d[slot_at<kAoS>(p, k, K, P)];
      if (d < 0) continue;
      row[d * kRow] += lh[lh_at<kAoS>(p, k, e, K, P)];
    }
  }
  __syncthreads();  // the block's V entries are in place
  for (int idx = threadIdx.x; idx < np * 6 * M; idx += kThreads) {
    const int pl = idx / (6 * M);
    const int r = idx - pl * 6 * M;
    const int j = r / 6;
    const int i = r - j * 6;
    const int p = p0 + pl;
    if (j >= count[p]) continue;
    T* row = base + static_cast<size_t>(pl) * pstride + j * kRow;
    const T v0 = row[i], v1 = row[6 + i], v2 = row[12 + i];
    row[18 + i] = v0 * gl[gl_at<kAoS>(p, 0, P)] +
                  v1 * gl[gl_at<kAoS>(p, 1, P)] +
                  v2 * gl[gl_at<kAoS>(p, 2, P)];
    if (bf16) {
      row[i] = round_bf16(v0);
      row[6 + i] = round_bf16(v1);
      row[12 + i] = round_bf16(v2);
    }
  }
  if (kTile) {
    __syncthreads();
    T* dst = Vc + static_cast<size_t>(p0) * per_point;
    for (int idx = threadIdx.x; idx < np * per_point; idx += kThreads)
      dst[idx] = base[idx + idx / per_point];  // skip the stride's pad
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_strip_kernel(const T* __restrict__ Vc,        // (P, M, kRow)
                  const int* __restrict__ dcam,    // (P, M), -1 tail
                  const int* __restrict__ count,   // (P,)
                  const int* __restrict__ obs,     // p*M + j, by (camera, p)
                  const int* __restrict__ offsets, // (C + 1,) into obs
                  T* __restrict__ S, T* __restrict__ rhs,
                  T* __restrict__ ws, T* __restrict__ ws_rhs,
                  int M, int C, int CB, int NS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c1 = blockIdx.x;
  const int lo = blockIdx.y * CB;
  const int hi = min(lo + CB, C);
  if (hi <= c1) return;  // this chunk lies below the diagonal
  const int split = blockIdx.z;
  const int col_lo = max(lo, c1);
  const bool owns_rhs = c1 >= lo && c1 < hi;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int stride = 6 * CB;  // one strip row

  T* strips = reinterpret_cast<T*>(smem_raw);  // (kWarps, 6, 6*CB)
  T* rsum = strips + kWarps * 6 * stride;       // (kWarps, 6)
  T* acc = strips + warp * 6 * stride;
  for (int e = lane; e < 6 * stride; e += 32) acc[e] = T(0);
  __syncwarp();

  const int beg = offsets[c1];
  const long long len = offsets[c1 + 1] - beg;
  const int part = split * kWarps + warp;
  const int parts = NS * kWarps;
  const int o_lo = beg + static_cast<int>(len * part / parts);
  const int o_hi = beg + static_cast<int>(len * (part + 1) / parts);
  T racc = T(0);
  const bool all_cols = lo == 0 && hi == C;
  for (int o = o_lo; o < o_hi; ++o) {
    const int f = obs[o];
    const int p = f / M;
    const int j1 = f - p * M;
    const T* a1p = Vc + static_cast<size_t>(f) * kRow;
    T a1[18];
#pragma unroll
    for (int e = 0; e < 18; ++e) a1[e] = a1p[e];
    if (owns_rhs && lane < 6) racc += a1p[18 + lane];
    // The point's cameras ascend, so its columns c2 in [col_lo, hi) are
    // the distinct cameras j2 in [max(j1, #{c2 < lo}), #{c2 < hi}).
    const int* dc = dcam + static_cast<size_t>(p) * M;
    const int m = count[p];
    int n_lo = 0, n_hi = m;
    if (!all_cols) {
      n_hi = 0;
      for (int j = lane; j < m; j += 32) {
        const int c = dc[j];
        n_lo += c < lo;
        n_hi += c < hi;
      }
      n_lo = __reduce_add_sync(0xffffffffu, n_lo);
      n_hi = __reduce_add_sync(0xffffffffu, n_hi);
    }
    const T* vp = Vc + static_cast<size_t>(p) * M * kRow;
    const int t_end = 6 * n_hi;
#pragma unroll 2
    for (int t = 6 * max(j1, n_lo) + lane; t < t_end; t += 32) {
      const int j2 = t / 6;
      const int i2 = t - j2 * 6;
      const T* a2 = vp + static_cast<size_t>(j2) * kRow;
      const T b0 = a2[i2], b1 = a2[6 + i2], b2 = a2[12 + i2];
      T* out = acc + (dc[j2] - lo) * 6 + i2;
#pragma unroll
      for (int i1 = 0; i1 < 6; ++i1)
        out[i1 * stride] += a1[i1] * b0 + a1[6 + i1] * b1 + a1[12 + i1] * b2;
    }
    __syncwarp();  // the next observation may add into the same entries
  }
  if (owns_rhs && lane < 6) rsum[warp * 6 + lane] = racc;
  __syncthreads();

  const size_t n = 6 * static_cast<size_t>(C);
  T* dst = NS == 1 ? S : ws + static_cast<size_t>(split) * n * n;
  const int ncol = (hi - col_lo) * 6;
  for (int idx = tid; idx < 6 * ncol; idx += kThreads) {
    const int i1 = idx / ncol;
    const int j = idx - i1 * ncol;
    const int c2 = col_lo + j / 6;
    const int i2 = j % 6;
    // The diagonal block is read from its i1 <= i2 half.
    const bool swap = c2 == c1 && i2 < i1;
    const int r = swap ? i2 : i1;
    const int c = (c2 - lo) * 6 + (swap ? i1 : i2);
    T v = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += strips[(w * 6 + r) * stride + c];
    dst[(c1 * 6 + i1) * n + c2 * 6 + i2] = v;
    if (NS == 1 && c2 != c1) S[(c2 * 6 + i2) * n + c1 * 6 + i1] = v;
  }
  if (owns_rhs && tid < 6) {
    T v = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += rsum[w * 6 + tid];
    (NS == 1 ? rhs : ws_rhs + static_cast<size_t>(split) * n)[c1 * 6 + tid] =
        v;
  }
}

// S and rhs from the NS split partials, summed in split order; a lower
// block reads the upper block it mirrors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const T* __restrict__ ws, const T* __restrict__ ws_rhs,
                   T* __restrict__ S, T* __restrict__ rhs, int C, int NS) {
  const size_t n = 6 * static_cast<size_t>(C);
  const size_t total = n * n;
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < total; idx += step) {
    const size_t r = idx / n;
    const size_t c = idx - r * n;
    const size_t src = c / 6 < r / 6 ? c * n + r : idx;
    T v = T(0);
    for (int s = 0; s < NS; ++s) v += ws[s * total + src];
    S[idx] = v;
    if (idx < n) {
      T u = T(0);
      for (int s = 0; s < NS; ++s) u += ws_rhs[s * n + idx];
      rhs[idx] = u;
    }
  }
}

template <typename T, bool kAoS>
int launch_gram(const T* lh, const T* gl, const int* slot_d, const int* dcam,
                const int* count, const int* obs, const int* offsets, T* Vc,
                T* ws, T* ws_rhs, T* S, T* rhs, int K, int P, int C, int M,
                int CB, int NS, int bf16, cudaStream_t stream) {
  if (C <= 0) return 0;
  cudaError_t err;
  if (P > 0 && M > 0) {
    // As many points as fit the tile, down to one 32-byte sector of each
    // SoA row, so the reads stay in full sectors.
    const size_t row_bytes =
        sizeof(T) * (static_cast<size_t>(M) * kRow + 1);
    int pts = kPoints;
    while (pts * sizeof(T) > 32 && pts * row_bytes > kTileBytes) pts /= 2;
    const size_t tile = pts * row_bytes;
    if (tile <= kTileBytes) {
      err = cudaFuncSetAttribute(gram_compact_kernel<T, kAoS, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(tile));
      if (err != cudaSuccess) return static_cast<int>(err);
      gram_compact_kernel<T, kAoS, true>
          <<<(P + pts - 1) / pts, kThreads, tile, stream>>>(
              lh, gl, slot_d, count, Vc, K, P, M, pts, bf16);
    } else {
      gram_compact_kernel<T, kAoS, false>
          <<<(P + kPoints - 1) / kPoints, kThreads, 0, stream>>>(
              lh, gl, slot_d, count, Vc, K, P, M, kPoints, bf16);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(T) * kWarps * (36 * static_cast<size_t>(CB) + 6);
  err = cudaFuncSetAttribute(gram_strip_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(C, (C + CB - 1) / CB, NS);
  gram_strip_kernel<T><<<grid, kThreads, smem, stream>>>(
      Vc, dcam, count, obs, offsets, S, rhs, ws, ws_rhs, M, C, CB, NS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (NS > 1) {
    const size_t n = 6 * static_cast<size_t>(C);
    const size_t blocks = (n * n + kThreads - 1) / kThreads;
    gram_reduce_kernel<T><<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                            kThreads, 0, stream>>>(ws, ws_rhs, S, rhs, C, NS);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

#define PPSFM_GRAM_ENTRY(NAME, T, AOS)                                       \
  int NAME(const T* lh, const T* gl, const int* slot_d, const int* dcam,    \
           const int* count, const int* obs, const int* offsets, T* Vc,     \
           T* ws, T* ws_rhs, T* S, T* rhs, int K, int P, int C, int M,      \
           int CB, int NS, int bf16, void* stream) {                        \
    return launch_gram<T, AOS>(lh, gl, slot_d, dcam, count, obs, offsets,   \
                               Vc, ws, ws_rhs, S, rhs, K, P, C, M, CB, NS,  \
                               bf16, static_cast<cudaStream_t>(stream));     \
  }

PPSFM_GRAM_ENTRY(ppsfm_schur_gram_f32, float, false)
PPSFM_GRAM_ENTRY(ppsfm_schur_gram_f64, double, false)
PPSFM_GRAM_ENTRY(ppsfm_schur_gram_aos_f32, float, true)
PPSFM_GRAM_ENTRY(ppsfm_schur_gram_aos_f64, double, true)

#undef PPSFM_GRAM_ENTRY

}  // extern "C"
