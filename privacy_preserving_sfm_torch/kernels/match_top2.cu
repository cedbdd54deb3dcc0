// Exact descriptor matching: best dot, second dot and argmax in both
// directions for B pairs of uint8 descriptor sets.
//
// Replaces the TPU kernels privacy_preserving_sfm_tpu/features/
// matching_kernels.py:250 top2_scores_bidir (both directions, the
// matcher's main path) and :123 top2_scores (the row direction only, a
// mode of this kernel).  Semantics are those of the plain version
// (features/matching.py:_top2_both_batched_plain): dots are exact
// integers, an invalid row or column counts as -1e9, argmax takes the
// first occurrence, and the second best masks only the argmax position,
// so a duplicate of the best gives second == best.  A row or column with
// no valid candidate gives best = second = -1e9 and idx = 0.
//
// What bounds it on an H100.  A pair of N1 x N2 descriptors of 128 bytes
// is 2 * N1 * N2 * 128 int8 tensor-core operations: 17.2 G at 8192 x 8192,
// 8.68 us a pair at the 1,979 TOP/s peak.  Every dot then passes through a
// top-2 update in each direction: one IMAD (the key, below) and three
// integer min/max a dot and direction, plus 5 instructions per 64 dots at
// each tile's end, about 3.1 instructions on the ALU pipe (16 lanes a
// clock on each of an SM's four schedulers): 67.1 M x 3.1 / (132 SMs x 64
// a clock) = 25 k clocks, 13-14 us a pair and direction at 1.8-1.98 GHz.
// That epilogue, not the contraction, is the floor: computing each
// direction as its own contraction (below) doubles the tensor work to
// 17.4 us a pair at the peak, which runs beside the epilogue.
//
// What the design does about it:
// * Packed keys.  A dot of two uint8 descriptors is at most
//   255^2 * 128 = 8,323,200 < 2^23, so key = dot * 256 + r fits an int32
//   (at most 2,130,739,455 < 2^31) and a row's keys order as its dots, with
//   r breaking ties: within a column tile r = 254 - pos for the position
//   pos in [0, 128) of the column in the tile (the earlier column has the
//   larger key), and the running state carries r = 255, so it wins a tie
//   against any later tile.  The top-2 update is then
//   b' = max(b, k), s' = max(s, min(b, k)): no index register and no
//   compare-and-select per dot.  At a tile's end a best found in that tile
//   records its column (c0 + 254 - r) and is re-marked r = 255.
// * Masking in the key.  key = acc * 256 + cst[column], where the
//   producer writes cst = 254 - pos for a valid column and
//   INT32_MIN + 254 - pos for a masked one (or one past N, whose
//   descriptor the copy fills with zeros): a masked entry's key is below
//   -16.7 M, every valid key is at least 127, so masked entries lose to
//   every valid one and decode to -1e9, index 0, with no per-dot select.
//   A masked row is written as -1e9, -1e9, 0 at the end.
// * No column state.  The column direction is the row direction of the
//   swapped pair (d2 against d1), run by other CTAs of the same launch;
//   a column's state then lives in registers across all of its tiles like
//   a row's, and nothing is reduced across CTAs per tile: no (3, B,
//   N1 / 128, N2) partial table.
// * The contraction is wgmma.mma_async m64n128k32 .s32.u8.u8 from shared
//   memory: a CTA is two consumer warpgroups of 64 rows each and one
//   producer warp.  Both descriptor tables are row-major (N, 128) bytes,
//   K-major, and a row is exactly one 128-byte swizzle span, so the
//   producer's TMA copies 128-row tiles as they are (128-byte swizzle,
//   rows past N zero-filled) into a ring of four stages under full and
//   empty mbarriers; the rows' block is copied once.  At 92 registers two
//   CTAs share an SM, so four warpgroups take turns: one's products run on
//   the tensor cores while the others fold theirs into their row states.
// * A CTA walks every column tile of its rows, so a launch of few pairs
//   runs few CTAs (one pair at 8192 x 8192: 128 on 132 SMs).  Splitting
//   the tiles over more CTAs, with the partials merged by a second
//   kernel, was measured on an H100 and dropped: it cut the device time
//   of some small launches (2 x 1000 x 8192: 0.054 to 0.025 ms) and added
//   to others (one pair: 0.051 to 0.053 ms), but every such call is bound
//   by its host path (0.07-0.2 ms), where the difference does not show.
// * Each row's result is written by one thread, from a merge of its four
//   lanes that takes the larger value, the smaller index on a tie: no
//   atomics, bit-identical from run to run.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows per CTA: two warpgroups of 64
constexpr int BN = 128;          // candidate columns per tile
constexpr int DIM = 128;         // descriptor bytes
constexpr int STAGES = 4;        // column tiles in flight
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int TILE_BYTES = BN * DIM;     // a tile, and the rows' block
constexpr int NEG = -1000000000;  // the plain version's masked dot, -1e9
constexpr int CARRIED = 255;      // r of a best carried from a past tile
// A barrier wait this long traps (mbar_wait): two minutes.
constexpr uint64_t WAIT_LIMIT_NS = 120ull * 1000000000ull;

// Shared memory from a 1024-byte aligned base (the swizzle's period).
constexpr int OFF_A = 0;
constexpr int OFF_B = OFF_A + TILE_BYTES;
constexpr int OFF_CST = OFF_B + STAGES * TILE_BYTES;
constexpr int OFF_BAR = OFF_CST + STAGES * BN * 4;
constexpr int SMEM_BYTES = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;

// One direction of the search: the rows' top-2 over the columns.
struct Side {
  const uint8_t* vrows;  // (nb, nrows) 0/1
  const uint8_t* vcols;  // (nb, ncols) 0/1
  int nrows, ncols;
  float* best;           // (nb, nrows)
  float* second;
  int* idx;
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of parity ``parity`` to complete.  A wait of more
// than WAIT_LIMIT_NS on the global timer, which runs on while the context
// is switched out (time-slicing, MPS, a debugger), can only be a lost
// arrival: it traps, so a fault ends the launch with an error instead of
// hanging the card.  A trap is a sticky error: the process's CUDA context
// is lost with it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(a, parity)) {
    if (global_ns() - start > WAIT_LIMIT_NS) __trap();
  }
}

// A 128-row box of an (nb, n, 128) byte tensor, rows [row, row + 128) of
// pair ``pair``, into shared memory with the 128-byte swizzle; rows past n
// are zero.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int row, int pair, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(pair),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading an accumulator before the wait that
// completes it.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, int32) = A (64 x 32 bytes) . B (128 x 32 bytes)^T (+ d
// when accumulate), both operands in shared memory.
__device__ __forceinline__ void wgmma128(int (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The products of one tile: d = A . B^T over the depth of 128, four
// k-steps of 32 bytes, as one commit group.
__device__ __forceinline__ void issue_tile(int (&d)[64], uint32_t a,
                                           uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma128(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), kk);
  }
  wgmma_commit();
}

// Folds a tile's products into the thread's two row states.  Register
// j * 4 + rr * 2 + c is row rr * 8 + g of the warp's 16 and column
// j * 8 + t * 2 + c of the tile.
__device__ __forceinline__ void fold(const int (&d)[64], const int* cst,
                                     int t, int (&best)[2], int (&sec)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int2 cv = *reinterpret_cast<const int2*>(cst + j * 8 + t * 2);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = d[j * 4 + rr * 2 + c] * 256 + (c ? cv.y : cv.x);
        sec[rr] = max(sec[rr], min(best[rr], k));
        best[rr] = max(best[rr], k);
      }
    }
  }
}

// At a tile's end (columns from c0), a best found in the tile records its
// column and is carried.
__device__ __forceinline__ void carry(int (&best)[2], int (&bidx)[2],
                                      int c0) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = best[rr] & CARRIED;
    bidx[rr] = r != CARRIED ? c0 + 254 - r : bidx[rr];
    best[rr] |= CARRIED;
  }
}

// grid (blocks of side 0 + blocks of side 1, nb), THREADS threads,
// SMEM_BYTES dynamic shared memory; a side has ceil(nrows / BM) blocks.
// m1 and m2 map d1 and d2.  Writes each side's rows.  Two CTAs an SM.
__global__ void __launch_bounds__(THREADS, 2)
    match_top2_kernel(const __grid_constant__ CUtensorMap m1,
                      const __grid_constant__ CUtensorMap m2, Side s0,
                      Side s1, int blocks0) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem + OFF_A;
  uint8_t* sb = smem + OFF_B;
  int* scst = reinterpret_cast<int*>(smem + OFF_CST);  // STAGES x BN
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* bar_a = empty + STAGES;

  const bool swapped = static_cast<int>(blockIdx.x) >= blocks0;
  const Side S = swapped ? s1 : s0;
  const CUtensorMap* rmap = swapped ? &m2 : &m1;
  const CUtensorMap* cmap = swapped ? &m1 : &m2;
  const int r0 = (swapped ? blockIdx.x - blocks0 : blockIdx.x) * BM;
  const int pair = blockIdx.y;
  const int n = (S.ncols + BN - 1) / BN;  // column tiles, >= 1
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(bar_a, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer warp: the rows' block once, then the column tiles through
    // the ring, each with its columns' key constants.
    const int lane = tid - CONSUMERS;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_a, TILE_BYTES);
      tma_load(sa, rmap, r0, pair, bar_a);
    }
    const uint8_t* VC = S.vcols + static_cast<size_t>(pair) * S.ncols;
    for (int i = 0; i < n; ++i) {
      const int stage = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[stage], ((i / STAGES) & 1) ^ 1);
      const int c0 = i * BN;
#pragma unroll
      for (int k = lane; k < BN; k += 32) {
        const int c = c0 + k;
        scst[stage * BN + k] =
            ((c < S.ncols && VC[c]) ? 0 : INT32_MIN) + (254 - k);
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], TILE_BYTES);
        tma_load(sb + stage * TILE_BYTES, cmap, c0, pair, &full[stage]);
      } else {
        mbar_arrive(&full[stage]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes rows wg * 64 + [0, 64) of the block; a
  // thread holds rows ww * 16 + g and ww * 16 + g + 8 of those.
  const int wg = tid >> 7, ww = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t a_addr = smem_u32(sa) + wg * (64 * DIM);
  const uint32_t b_addr = smem_u32(sb);
  int best[2] = {INT32_MIN, INT32_MIN}, sec[2] = {INT32_MIN, INT32_MIN};
  int bidx[2] = {0, 0};

  int acc[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = 0;
  mbar_wait(bar_a, 0);
  for (int i = 0; i < n; ++i) {
    const int stage = i % STAGES;
    mbar_wait(&full[stage], (i / STAGES) & 1);
    issue_tile(acc, a_addr, b_addr + stage * TILE_BYTES);
    wgmma_wait<0>();
    fence_acc(acc);
    fold(acc, scst + stage * BN, t, best, sec);
    carry(best, bidx, i * BN);
    mbar_arrive(&empty[stage]);
  }

  // Decode (a key below 0 is a masked entry, -1e9 at index 0), then merge
  // the four lanes that share a row.
  const uint8_t* VR = S.vrows + static_cast<size_t>(pair) * S.nrows;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    int b = best[rr] >= 0 ? best[rr] >> 8 : NEG;
    int s = sec[rr] >= 0 ? sec[rr] >> 8 : NEG;
    int i = best[rr] >= 0 ? bidx[rr] : 0;
    merge_lanes(b, s, i, 1);
    merge_lanes(b, s, i, 2);
    const int row = r0 + wg * 64 + ww * 16 + rr * 8 + g;
    if (t != 0 || row >= S.nrows) continue;
    if (!VR[row]) {
      b = NEG;
      s = NEG;
      i = 0;
    }
    const size_t o = static_cast<size_t>(pair) * S.nrows + row;
    S.best[o] = static_cast<float>(b);
    S.second[o] = static_cast<float>(s);
    S.idx[o] = i;
  }
}

Side make_side(const void* vrows, const void* vcols, int nrows, int ncols,
               void* best, void* second, void* idx) {
  Side s;
  s.vrows = static_cast<const uint8_t*>(vrows);
  s.vcols = static_cast<const uint8_t*>(vcols);
  s.nrows = nrows;
  s.ncols = ncols;
  s.best = static_cast<float*>(best);
  s.second = static_cast<float*>(second);
  s.idx = static_cast<int*>(idx);
  return s;
}

// The TMA map of an (nb, n, 128) uint8 tensor in 128-row boxes with the
// 128-byte swizzle; rows past n read as zero.
cudaError_t encode_map(CUtensorMap* map, const void* base, int nb, int n) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DIM),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DIM),
                                 static_cast<cuuint64_t>(n) * DIM};
  const cuuint32_t box[3] = {DIM, BN, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      match_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace

// d1 (nb, n1, 128) and d2 (nb, n2, 128) uint8, v1 (nb, n1) and
// v2 (nb, n2) uint8 0/1, all contiguous and 16-byte aligned.  Writes the
// row direction (nb, n1) to bd12, sd12 float32 and idx12 int32; with bd21
// non-null, also the column direction (nb, n2) to bd21, sd21, idx21.
extern "C" int ppsfm_match_top2(const void* d1, const void* d2,
                                const void* v1, const void* v2, int nb,
                                int n1, int n2, void* bd12, void* sd12,
                                void* idx12, void* bd21, void* sd21,
                                void* idx21, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb <= 0 || nb > 65535 || n1 <= 0 || n2 <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  CUtensorMap m1, m2;
  err = encode_map(&m1, d1, nb, n1);
  if (err == cudaSuccess) err = encode_map(&m2, d2, nb, n2);
  if (err != cudaSuccess) return err;
  const Side s0 = make_side(v1, v2, n1, n2, bd12, sd12, idx12);
  Side s1 = s0;
  int blocks1 = 0;
  if (bd21 != nullptr) {
    s1 = make_side(v2, v1, n2, n1, bd21, sd21, idx21);
    blocks1 = (n2 + BM - 1) / BM;
  }
  const int blocks0 = (n1 + BM - 1) / BM;
  const dim3 grid(blocks0 + blocks1, nb);
  match_top2_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(m1, m2, s0, s1,
                                                       blocks0);
  return cudaGetLastError();
}
