// Exact descriptor matching: best dot, second dot and argmax in both
// directions for B pairs of uint8 descriptor sets.
//
// Replaces the TPU kernels privacy_preserving_sfm_tpu/features/
// matching_kernels.py:top2_scores_bidir (both directions, the matcher's
// main path) and top2_scores (the row direction only, a mode of this
// kernel).  Semantics are those of the plain version
// (features/matching.py:_top2_both_batched_plain): dots are exact
// integers, an invalid row or column counts as -1e9, argmax takes the
// first occurrence, and the second best masks only the argmax position,
// so a duplicate of the best gives second == best.  A row or column with
// no valid candidate gives best = second = -1e9 and idx = 0.
//
// What bounds it: compute.  A pair of N1 x N2 descriptors of 128 bytes
// is 2 * N1 * N2 * 128 integer operations (17.2 G at 8192 x 8192) for
// 2 MB of input, and every one of the N1 * N2 dots also passes through a
// top-2 update along its row and along its column.
//
// What the design does about it:
// * The contraction runs on the tensor cores as
//   mma.sync.m16n8k32.row.col.s32.u8.u8.s32: unsigned bytes in, exact
//   int32 sums out (every dot <= 255^2 * 128 < 2^24, so the float32
//   outputs are exact too).  Nothing is biased or re-centred.
// * One CTA takes one (pair, 128-row block) and holds its A fragments in
//   registers; it streams the pair's candidates through shared memory in
//   128-column tiles, double-buffered with cp.async, so the N1 x N2 dot
//   matrix never reaches device memory.
// * The row state (best, second, idx) stays in registers across tiles.
// * CTAs run in no order, so no column state carries from one to the
//   next: each CTA writes its row block's column top-2 to a partial table
//   (3, B, ceil(N1 / 128), N2), and a second short kernel merges the
//   partials of each column in row-block order.
// * Every merge is exact and commutative (the larger value wins, the
//   smaller index on a tie), so results are the same whatever order the
//   warps, lanes and blocks are combined in: no atomics, bit-identical
//   from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // rows per CTA
constexpr int BN = 128;        // candidate columns per tile
constexpr int DIM = 128;       // descriptor bytes
constexpr int LD = DIM + 16;   // shared-memory row stride: no bank conflicts
constexpr int THREADS = 256;   // 8 warps: 4 along rows x 2 along columns
constexpr int NEG = -1000000000;  // the plain version's masked dot, -1e9

constexpr int SMEM_A = BM * LD;
constexpr int SMEM_B = 2 * BN * LD;
constexpr int SMEM_BYTES = SMEM_A + SMEM_B + 2 * BN * 4 + 3 * 4 * BN * 4;

// Adds value v at index j to a running top-2; indices arrive in
// increasing order, so the strict > keeps the first occurrence.
__device__ __forceinline__ void push(int& b, int& s, int& i, int v, int j) {
  const bool gt = v > b;
  s = gt ? b : max(s, v);
  i = gt ? j : i;
  b = gt ? v : b;
}

// Merges another top-2 of a disjoint index range: the larger best wins,
// the smaller index on a tie.  Commutative and associative.
__device__ __forceinline__ void merge(int& b, int& s, int& i, int ob, int os,
                                      int oi) {
  const bool other = ob > b || (ob == b && oi < i);
  s = other ? max(b, os) : max(s, ob);
  i = other ? oi : i;
  b = other ? ob : b;
}

__device__ __forceinline__ void merge_lanes(int& b, int& s, int& i,
                                            int mask) {
  const int ob = __shfl_xor_sync(0xffffffffu, b, mask);
  const int os = __shfl_xor_sync(0xffffffffu, s, mask);
  const int oi = __shfl_xor_sync(0xffffffffu, i, mask);
  merge(b, s, i, ob, os, oi);
}

__device__ __forceinline__ void mma_u8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [r0, r0 + 128) of an (n, 128) byte matrix into shared memory with
// row stride LD; rows past n are zero.
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src,
                                          int r0, int n, int tid) {
#pragma unroll
  for (int k = 0; k < BM * DIM / 16 / THREADS; ++k) {
    const int q = tid + k * THREADS;
    const int row = q >> 3, col = (q & 7) * 16;
    uint8_t* d = dst + row * LD + col;
    if (r0 + row < n) {
      cp_async16(d, src + static_cast<size_t>(r0 + row) * DIM + col);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// grid (ceil(n1 / BM), nb), THREADS threads, SMEM_BYTES dynamic shared
// memory.  Writes the row direction to bd12/sd12/idx12 (nb, n1) and, when
// BIDIR, the column partials to part (3, nb, gridDim.x, n2).
template <bool BIDIR>
__global__ void __launch_bounds__(THREADS)
    match_top2_kernel(const uint8_t* __restrict__ d1,
                      const uint8_t* __restrict__ d2,
                      const uint8_t* __restrict__ v1,
                      const uint8_t* __restrict__ v2, int n1, int n2,
                      float* __restrict__ bd12, float* __restrict__ sd12,
                      int* __restrict__ idx12, int* __restrict__ part) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sa = smem;
  uint8_t* sb = smem + SMEM_A;
  int* svalid = reinterpret_cast<int*>(smem + SMEM_A + SMEM_B);  // 2 x BN
  int* sred = svalid + 2 * BN;  // 3 x 4 x BN

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int rb = blockIdx.x, pair = blockIdx.y, nrb = gridDim.x;
  const int r0 = rb * BM;
  const uint8_t* A = d1 + static_cast<size_t>(pair) * n1 * DIM;
  const uint8_t* B = d2 + static_cast<size_t>(pair) * n2 * DIM;
  const uint8_t* V1 = v1 + static_cast<size_t>(pair) * n1;
  const uint8_t* V2 = v2 + static_cast<size_t>(pair) * n2;

  load_tile(sa, A, r0, n1, tid);
  load_tile(sb, B, 0, n2, tid);
  cp_async_commit();
  if (tid < BN) svalid[tid] = (tid < n2 && V2[tid]) ? 1 : 0;

  // This thread's four rows, in increasing order: q = mi * 2 + h is row
  // wm * 32 + mi * 16 + h * 8 + g of the block.
  bool rvalid[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + wm * 32 + q * 8 + g;
    rvalid[q] = r < n1 && V1[r];
  }
  int rbest[4], rsec[4], ridx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    rbest[q] = NEG;
    rsec[q] = NEG;
    ridx[q] = 0;
  }

  cp_async_wait_all();
  __syncthreads();

  // A fragments of the warp's 32 rows for the whole depth of 128.
  uint32_t af[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint8_t* p = sa + (wm * 32 + mi * 16 + g) * LD + kk * 32 + t * 4;
      af[mi][kk][0] = lds32(p);
      af[mi][kk][1] = lds32(p + 8 * LD);
      af[mi][kk][2] = lds32(p + 16);
      af[mi][kk][3] = lds32(p + 8 * LD + 16);
    }
  }

  const int ntiles = (n2 + BN - 1) / BN;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int buf = jt & 1;
    const int c0 = jt * BN;
    if (jt + 1 < ntiles) {
      load_tile(sb + (buf ^ 1) * BN * LD, B, c0 + BN, n2, tid);
      if (tid < BN) {
        const int c = c0 + BN + tid;
        svalid[(buf ^ 1) * BN + tid] = (c < n2 && V2[c]) ? 1 : 0;
      }
    }
    cp_async_commit();

    int acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    const uint8_t* tb = sb + buf * BN * LD;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint8_t* p = tb + (wn * 64 + ni * 8 + g) * LD + kk * 32 + t * 4;
        const uint32_t bf[2] = {lds32(p), lds32(p + 16)};
        mma_u8(acc[0][ni], af[0][kk], bf);
        mma_u8(acc[1][ni], af[1][kk], bf);
      }
    }

    // Mask: accumulator e of m-tile mi is row q = mi * 2 + (e >> 1) and
    // column wn * 64 + ni * 8 + t * 2 + (e & 1) of the tile.
    const int* vm = svalid + buf * BN;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool cv = vm[wn * 64 + ni * 8 + t * 2 + (e & 1)] != 0;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (!(cv && rvalid[mi * 2 + (e >> 1)])) acc[mi][ni][e] = NEG;
        }
      }
    }

    // Row direction, columns in increasing order.
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = c0 + wn * 64 + ni * 8 + t * 2 + c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          push(rbest[q], rsec[q], ridx[q], acc[q >> 1][ni][(q & 1) * 2 + c],
               col);
        }
      }
    }

    if (BIDIR) {
      // Column direction: the thread's four rows, then the warp's 32
      // (lanes differing in g), then the four row warps in shared memory.
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          int cb = NEG, cs = NEG, ci = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            push(cb, cs, ci, acc[q >> 1][ni][(q & 1) * 2 + c],
                 r0 + wm * 32 + q * 8 + g);
          }
          merge_lanes(cb, cs, ci, 4);
          merge_lanes(cb, cs, ci, 8);
          merge_lanes(cb, cs, ci, 16);
          if (g == 0) {
            const int col = wn * 64 + ni * 8 + t * 2 + c;
            sred[(0 * 4 + wm) * BN + col] = cb;
            sred[(1 * 4 + wm) * BN + col] = cs;
            sred[(2 * 4 + wm) * BN + col] = ci;
          }
        }
      }
      __syncthreads();
      if (tid < BN && c0 + tid < n2) {
        int cb = sred[tid], cs = sred[4 * BN + tid], ci = sred[8 * BN + tid];
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          merge(cb, cs, ci, sred[w * BN + tid], sred[(4 + w) * BN + tid],
                sred[(8 + w) * BN + tid]);
        }
        const size_t plane = static_cast<size_t>(gridDim.y) * nrb * n2;
        const size_t o =
            (static_cast<size_t>(pair) * nrb + rb) * n2 + c0 + tid;
        part[o] = cb;
        part[plane + o] = cs;
        part[2 * plane + o] = ci;
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // Row direction: the four lanes of a group, then the two column warps.
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    merge_lanes(rbest[q], rsec[q], ridx[q], 1);
    merge_lanes(rbest[q], rsec[q], ridx[q], 2);
  }
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = wm * 32 + q * 8 + g;
      sred[(0 * 2 + wn) * BM + row] = rbest[q];
      sred[(1 * 2 + wn) * BM + row] = rsec[q];
      sred[(2 * 2 + wn) * BM + row] = ridx[q];
    }
  }
  __syncthreads();
  if (tid < BM && r0 + tid < n1) {
    int b = sred[tid], s = sred[2 * BM + tid], i = sred[4 * BM + tid];
    merge(b, s, i, sred[BM + tid], sred[3 * BM + tid], sred[5 * BM + tid]);
    const size_t o = static_cast<size_t>(pair) * n1 + r0 + tid;
    bd12[o] = static_cast<float>(b);
    sd12[o] = static_cast<float>(s);
    idx12[o] = i;
  }
}

// One thread per (pair, column): merges the column partials of the
// row blocks in order.
__global__ void merge_columns_kernel(const int* __restrict__ part, int nb,
                                     int nrb, int n2,
                                     float* __restrict__ bd21,
                                     float* __restrict__ sd21,
                                     int* __restrict__ idx21) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (k >= static_cast<long long>(nb) * n2) return;
  const int pair = static_cast<int>(k / n2), col = static_cast<int>(k % n2);
  const size_t plane = static_cast<size_t>(nb) * nrb * n2;
  int b = NEG, s = NEG, i = 0;
  for (int r = 0; r < nrb; ++r) {
    const size_t o = (static_cast<size_t>(pair) * nrb + r) * n2 + col;
    merge(b, s, i, part[o], part[plane + o], part[2 * plane + o]);
  }
  bd21[k] = static_cast<float>(b);
  sd21[k] = static_cast<float>(s);
  idx21[k] = i;
}

template <bool BIDIR>
cudaError_t launch_main(const uint8_t* d1, const uint8_t* d2,
                        const uint8_t* v1, const uint8_t* v2, int nb, int n1,
                        int n2, float* bd12, float* sd12, int* idx12,
                        int* part, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_top2_kernel<BIDIR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((n1 + BM - 1) / BM, nb);
  match_top2_kernel<BIDIR><<<grid, THREADS, SMEM_BYTES, stream>>>(
      d1, d2, v1, v2, n1, n2, bd12, sd12, idx12, part);
  return cudaGetLastError();
}

}  // namespace

// d1 (nb, n1, 128) and d2 (nb, n2, 128) uint8, v1 (nb, n1) and
// v2 (nb, n2) uint8 0/1, all contiguous and 16-byte aligned.  Outputs
// (nb, n1) bd12, sd12 float32 and idx12 int32.  With bd21 non-null, also
// the column direction (nb, n2) bd21, sd21, idx21, through the int32
// scratch part of 3 * nb * ceil(n1 / 128) * n2 elements; with bd21 null,
// the row direction only (part and sd21, idx21 unused).
extern "C" int ppsfm_match_top2(const void* d1, const void* d2,
                                const void* v1, const void* v2, int nb,
                                int n1, int n2, void* bd12, void* sd12,
                                void* idx12, void* bd21, void* sd21,
                                void* idx21, void* part, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint8_t*>(d1);
  const auto* b = static_cast<const uint8_t*>(d2);
  const auto* va = static_cast<const uint8_t*>(v1);
  const auto* vb = static_cast<const uint8_t*>(v2);
  if (nb <= 0 || n1 <= 0 || n2 <= 0) return cudaErrorInvalidValue;
  if (bd21 == nullptr) {
    return launch_main<false>(a, b, va, vb, nb, n1, n2,
                              static_cast<float*>(bd12),
                              static_cast<float*>(sd12),
                              static_cast<int*>(idx12), nullptr, s);
  }
  cudaError_t err = launch_main<true>(
      a, b, va, vb, nb, n1, n2, static_cast<float*>(bd12),
      static_cast<float*>(sd12), static_cast<int*>(idx12),
      static_cast<int*>(part), s);
  if (err != cudaSuccess) return err;
  const int nrb = (n1 + BM - 1) / BM;
  const long long total = static_cast<long long>(nb) * n2;
  const int threads = 256;
  merge_columns_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                               threads),
                         threads, 0, s>>>(static_cast<const int*>(part), nb,
                                          nrb, n2, static_cast<float*>(bd21),
                                          static_cast<float*>(sd21),
                                          static_cast<int*>(idx21));
  return cudaGetLastError();
}
