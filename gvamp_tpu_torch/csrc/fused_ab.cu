// v6_fused_ab of the PyTorch port, written by hand for Hopper (sm_90a):
//   zt[d][k][p] = sum_m a_k[m, p] * w8[d][m] + b_k[m, p] * mu8[d][m]
// axm_i8s's contract (fragments.cu): words uint32[Nw, Mpad], the digits of
// W and of -U at one joint scale per column (matvec._quant_digits_pair),
// both planes' products in one int32[D, 4, 4*Nw] sum that the wrapper
// folds once, |sum| <= 381*Mpad (the wrapper keeps it below 2^31).  Bound
// through the plain C interface of gvamp_tpu_torch/ops/_build.py; the
// wrapper, the digit layout and the plain version (matvec.axm_i8s_ref) are
// in gvamp_tpu_torch/ops/study.py.
//
// Replaces `v6_fused_ab` / _v6_kernel (tools/bench_variants.py:199, 215)
// with the right-hand side it was written for: per marker tile, the
// a-plane against [w8] and the b-plane against [-u8] in one K-concatenated
// contraction (concatenate([a8, b8], axis=1) there).
//
// Bound on this card: the one read of the 4*Nw*Mpad bytes of the words
// (10.74 GB at config Bm, 3.21 ms at 3.35 TB/s) while D is small; the
// contraction, 2 * 16*Nw * Mpad * D int8 operations per plane, at 1,979
// TOP/s from D = 32 on (5.56 ms at D = 64, 22.2 ms at D = 256, config
// Bm).  On top of the read each word costs the integer pipe its byte
// transpose and the decode of both planes (about 15 instructions per word,
// as in fragments.cu), and at wide D each word tile meets the digit tile
// of its markers once per block: 2*Kt*N bytes of digits from L2 per
// R*Kt*4 bytes of words, N/(2R) times the words (1/8 at D <= 16, 2 at D =
// 64, 16 at D = 256).
//
// Design.  The words reach shared memory once, through a ring of kStages
// tiles that one producer warp fills with cp.async.bulk copies (one per
// word row, 4*Kt bytes, and one for the tile's digits), completing on the
// stage's `full` mbarrier; the consumers release a stage on its `empty`
// mbarrier.  There is no __syncthreads after the barriers' set-up.  Two
// or three consumer warpgroups share each word tile.
//   * Decode in registers.  The contraction runs along the markers, so the
//     A operand of wgmma m64nNk32 (u8 x s8 -> s32, A from registers) is
//     four markers of one planar row per register, as in fragments.cu:
//     lane (g, t) of a warp reads 16 bytes at markers 4t and 16+4t of a
//     32-marker step of its word row (row 8*rg + g of the tile) from shared
//     memory, byte-transposes the byte rows it takes (three byte permutes
//     each, the first two shared by the two byte rows of a half word),
//     decodes their a- and b-fields (swar.cuh) and takes each plane where
//     it lies (plane_at: one AND, where plane64's shift as well measured
//     slower on an H100).  A warp's 16 rows of an m64 tile are rows g
//     (plane 2h of byte row b) and g+8 (plane 2h+1) of its 8 word rows, so
//     each lane's loads supply all of its fragment rows; the output rows
//     are a permutation of the fragment rows.
//   * One chain over [a | b].  For each 32 markers every m tile takes two
//     wgmma into the same accumulators: the a-fields against the tile's w8
//     block and the b-fields against its mu8 block.  The digits of a tile
//     lie in shared memory in wgmma's core-matrix layout without swizzle
//     ([type][Kt/16][N/8][8 rows][16 bytes]: LBO 16 N bytes between the
//     two 16-marker halves of a step, SBO 128 bytes between groups of 8
//     digit rows), as the wrapper lays them out, and are read by
//     descriptor.  A step's wgmma are committed as one group and waited
//     for before the next step rewrites the A registers: with two sets of
//     A registers and the next step decoded while the group runs, ptxas
//     serialized every wgmma (C7513), which measured slower; the other
//     warpgroups of the SM decode meanwhile.
//   * n = D in one read: N, the wgmma's n, is D rounded up to 8, 16, 32,
//     64, 128 or 256 (issued as wgmma of n <= 64 side by side); only D >
//     256 splits over the grid's z axis, 256 digit rows per group.
//   * Registers.  A lane decodes each word of its row for kP of the 16
//     planar rows, kP/2 m tiles of N/2 int32 each: kP*N/4 accumulators and
//     4 kP operand registers (two planes x kP/2 tiles x 4).  A warp's slot
//     is (row group rg, subset of its 16 planar rows), 16/kP subsets per
//     row group, so a tile holds 8 * (consumer warps) * kP / 16 word rows,
//     and each word is read from shared memory by 16/kP warps.
//       N = 8, 16:  kP = 8 (at most 32 + 32; its two byte rows share their
//                   first permutes), two blocks of 288 threads per SM, at
//                   most 96 registers a thread (what ptxas allows them);
//                   32 word rows a tile, 8 bytes per word from shared
//                   memory.
//       N = 32:     kP = 4, one block of 384 threads per SM: the producer
//                   warpgroup keeps 56 registers (setmaxnreg) and the two
//                   consumer warpgroups rise from 168 to 224 (registers
//                   move within an SM sub-partition, where one producer
//                   warp's 112 spare registers per lane serve two consumer
//                   warps); 16 word rows.
//       N = 64:     kP = 4 (64 + 16), three consumer warpgroups, 512
//                   threads: from 128 registers to 152 (72 spare for
//                   three); 24 word rows (the third warpgroup hides more
//                   of the wgmma waits: faster at B = 16 on an H100).
//       N = 128, 256: kP = 2 (at most 128 + 8; the fields of a byte row
//                   serve two planes instead of four), as N = 32; 8 word
//                   rows.
//   * Shared memory per stage: the digits (2 Kt N bytes) and the tile's
//     word rows of Kt markers, each row padded by 64 bytes so that a
//     quarter warp's 16-byte loads (word rows g, g+1, four lanes t each)
//     touch all 32 banks once.  Kt = 256 markers at N <= 64 (1 KB row
//     copies, fewer and larger than at 128 markers, which measured slower
//     at B = 2 and 16 on an H100), 128 beyond;
//     two stages at N <= 16 (76-84 KB a block, two blocks per SM), four at
//     N = 32 (132 KB), three beyond (110-206 KB).  Each block re-reads the
//     digits of its markers from L2: N / (2 x word rows) times the bytes
//     of its words (1/8 at N = 8, 1.3 at N = 64, 16 at N = 256).
//   * Exact int32: plane k's sums are 4^k times the true ones, each marker
//     adding at most 64 * (2 + 1) * 127 per output (plane 3); a part of at
//     most kMaxTiles tiles stays inside int32, and each part is shifted
//     back before its atomicAdd into the zeroed output.  Marker tiles
//     split over gridDim.y in such parts (and to fill the card), word-row
//     tiles over gridDim.x, digit groups over gridDim.z.
//   * Ragged edges: the bulk copies bring only the markers below Mpad and
//     the word rows below Nw; what the stage held before stays, and
//     decodes to fields in {0, 1, 2} like any word.  The wrapper's digits
//     are zero past Mpad and past D, so those products vanish; rows past
//     Nw and digit rows past D are never written.
// The launcher validates its arguments, checks the register count that the
// setmaxnreg arithmetic assumes, and returns a CUDA error code
// (cudaGetLastError() after the launch); indices are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async.cuh"
#include "mma.cuh"
#include "swar.cuh"

namespace {

constexpr int kMaxStages = 4;      // word tiles in the ring, at most
constexpr int kHeadBytes = 128;    // the ring's mbarriers (2 kMaxStages)
// setmaxnreg: the registers the producer warpgroup keeps
constexpr int kProducerRegs = 56;
// the largest scaled term of one marker (both planes of plane 3, 4^3
// times the true one; plane_at)
constexpr int64_t kSharedTerm = (3 << 6) * 127;
// the widest digit group of one launch
constexpr int kMaxN = 256;

// Per digit group width N (chosen from H100 runs at B = 2, 5, 16 and 64):
// the planar rows a lane takes, the markers per word tile (fused_ab_kt),
// the stages of the ring and the consumer warpgroups of a block.
__host__ __device__ constexpr int fab_p(int n) {
  return n <= 16 ? 8 : n <= 64 ? 4 : 2;
}
__host__ __device__ constexpr int fab_kt(int n) { return n <= 64 ? 256 : 128; }
__host__ __device__ constexpr int fab_stages(int n) {
  return n <= 16 ? 2 : n == 32 ? 4 : 3;
}
__host__ __device__ constexpr int fab_wgs(int n) { return n == 64 ? 3 : 2; }

// The shape of the kernel for N digit rows (see the design above).
template <int N>
struct Fab {
  // From N = 32 on, one block per SM whose producer warpgroup gives its
  // registers to the consumers (setmaxnreg); below, two blocks per SM of
  // 288 threads, at most 96 registers each (what ptxas allows them)
  static constexpr bool kMoveRegs = N >= 32;
  static constexpr int kWgs = fab_wgs(N);  // consumer warpgroups
  static constexpr int kConsumerWarps = 4 * kWgs;
  static constexpr int kThreads = 32 * kConsumerWarps + (kMoveRegs ? 128 : 32);
  static constexpr int kBlocksPerSm = kMoveRegs ? 1 : 2;
  static constexpr int kChunk = N < 64 ? N : 64;  // the n of one wgmma
  static constexpr int kChunks = N / kChunk;
  // planar rows per lane: kP N / 4 accumulators, 64 at most below N = 128
  static constexpr int kP = fab_p(N);
  static constexpr int kSubsets = 16 / kP;     // slots per word row
  static constexpr int kTiles = kP / 2;        // m tiles per warp
  static constexpr int kBytes = kP >= 8 ? 2 : 1;  // byte rows per lane
  static constexpr int kRows = 8 * kConsumerWarps / kSubsets;  // per tile
  static constexpr int kKt = fab_kt(N);
  static constexpr int kStages = fab_stages(N);
  static constexpr int kSteps = kKt / 32;
  static constexpr int kPitch = 4 * kKt + 64;  // bytes per word row
  static constexpr int kDigBytes = 2 * kKt * N;
  static constexpr int kStageBytes = kDigBytes + kRows * kPitch;
  static constexpr int kSmem = kHeadBytes + kStages * kStageBytes;
  static_assert(kStages <= kMaxStages, "the ring's mbarriers");
  // the registers ptxas gives a thread of a kernel with setmaxnreg (65536
  // over the block's threads, rounded down to 8), which the consumers'
  // rise to kConsumerRegs assumes: registers move within an SM
  // sub-partition, where one producer warp's spare registers serve kWgs
  // consumer warps
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs =
      (kLaunchRegs + (kLaunchRegs - kProducerRegs) / kWgs) / 8 * 8;
  static_assert(kConsumerWarps % kSubsets == 0, "whole row groups");
  // tiles per part that keep the scaled sums inside int32
  static constexpr int64_t kMaxTiles = INT32_MAX / ((int64_t)kKt * kSharedTerm);
  static_assert(kRows % 8 == 0 && kRows <= 32, "one row copy per lane");
  static_assert(kSmem <= 232448 / kBlocksPerSm - 1024, "shared memory");
};

__device__ __forceinline__ void wgmma_u8s8(int32_t (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.s8 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_u8s8(int32_t (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_u8s8(int32_t (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_u8s8(int32_t (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most K of this warp's committed groups are in flight
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// Keep the compiler from moving register accesses across the wgmma fences
// and waits: a step's operands are all computed before its fence, so that
// its wgmma issue back to back, and the sums are read after the last
// wait.
template <typename T, int K>
__device__ __forceinline__ void fence_regs(T (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void fence_desc(uint64_t& d) {
  asm volatile("" : "+l"(d)::"memory");
}

// Plane k of decoded fields where it lies: byte b holds 4^k times the
// field at bits 2k, 2k+1 of byte b, a u8 of at most 2 * 64.  One AND, where
// plane64 (swar.cuh) also shifts: the sums of plane k's rows are 4^k times
// the true ones and are shifted back by 2k.
__device__ __forceinline__ uint32_t plane_at(uint32_t fields, int k) {
  return fields & (kM3 << (2 * k));
}

// The descriptor of a K-major operand in shared memory without swizzle:
// the start address, LBO (the stride between core matrices along K) and
// SBO (between groups of 8 rows), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ uint4 ld_shared16(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

// Byte row b of four neighbouring marker words: byte j of the result is
// byte b of word j (transpose_quad's y[b]); `pair` selects b's half of
// the words, `half` b itself, so two byte rows of one half share the
// first two permutes.
__device__ __forceinline__ uint32_t byte_row(uint4 x, uint32_t pair,
                                             uint32_t half) {
  return __byte_perm(__byte_perm(x.x, x.y, pair), __byte_perm(x.z, x.w, pair),
                     half);
}

template <int N>
__global__ void __launch_bounds__(Fab<N>::kThreads, Fab<N>::kBlocksPerSm)
fused_ab_kernel(const uint32_t* __restrict__ words,  // [Nw, Mpad]
                const uint8_t* __restrict__ dig,     // the wrapper's layout
                int32_t* __restrict__ out,           // [D, 4, 4*Nw], zeroed
                int64_t nw, int64_t mpad, int64_t d_total,
                int64_t tiles_per_part) {
  using S = Fab<N>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint8_t* ring = smem + kHeadBytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t i0 = (int64_t)blockIdx.x * S::kRows;
  const int64_t tiles = (mpad + S::kKt - 1) / S::kKt;
  const int64_t j0 = (int64_t)blockIdx.y * tiles_per_part;
  const int64_t j1 = imin(tiles, j0 + tiles_per_part);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, S::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= S::kConsumerWarps) {
    // the producer: per tile, one bulk copy per word row below Nw and one
    // for the digits of the tile, once the consumers have released the
    // stage's previous tile; the rest of its warpgroup only gives up its
    // registers
    if constexpr (S::kMoveRegs)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    if (warp > S::kConsumerWarps) return;
    const int rows = (int)imin(S::kRows, nw - i0);
    const uint8_t* dg = dig + (int64_t)blockIdx.z * tiles * S::kDigBytes;
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t n = j - j0;
      const int s = (int)(n % S::kStages);
      if (n >= S::kStages)
        mbar_wait(empty + s, (uint32_t)((n / S::kStages - 1) & 1));
      const uint32_t seg = 4u * (uint32_t)imin(S::kKt, mpad - j * S::kKt);
      uint8_t* stage = ring + s * S::kStageBytes;
      // the stage's earlier tile was read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0)
        mbar_expect_tx(full + s, rows * seg + (uint32_t)S::kDigBytes);
      __syncwarp();
      for (int r = lane; r < rows; r += 32)
        bulk_copy(stage + S::kDigBytes + r * S::kPitch,
                  words + (i0 + r) * mpad + j * S::kKt, seg, full + s);
      if (lane == 0)
        bulk_copy(stage, dg + j * S::kDigBytes, S::kDigBytes, full + s);
    }
  } else {
    if constexpr (S::kMoveRegs)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          S::kConsumerRegs));
    // this warp's slot: row group rg (its lanes' word rows 8 rg + g) and
    // the subset `sub` of their planar rows; its m tile q takes plane pair
    // h of byte row b, pi = sub * kTiles + q = 2 b + h
    const int rg = warp / S::kSubsets, sub = warp % S::kSubsets;
    const int g = lane >> 2, t = lane & 3;
    const int row = 8 * rg + g;
    const int b0 = sub * S::kTiles / 2;  // the lane's first byte row
    const uint32_t pair = (b0 >> 1) ? 0x7362u : 0x5140u;
    uint32_t half[S::kBytes];
#pragma unroll
    for (int bi = 0; bi < S::kBytes; ++bi)
      half[bi] = ((b0 + bi) & 1) ? 0x7632u : 0x5410u;
    // the plane pair of each m tile (known at compile time but at kP = 2);
    // its byte row is b0 + q / 2
    int hq[S::kTiles];
#pragma unroll
    for (int q = 0; q < S::kTiles; ++q)
      hq[q] = S::kTiles > 1 ? q & 1 : sub & 1;

    int32_t acc[S::kTiles][S::kChunks][S::kChunk / 2];
#pragma unroll
    for (int q = 0; q < S::kTiles; ++q)
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < S::kChunk / 2; ++e) acc[q][c][e] = 0;

    for (int64_t j = j0; j < j1; ++j) {
      const int64_t n = j - j0;
      const int s = (int)(n % S::kStages);
      mbar_wait(full + s, (uint32_t)((n / S::kStages) & 1));
      __syncwarp();
      const uint8_t* stage = ring + s * S::kStageBytes;
      const uint8_t* wp = stage + S::kDigBytes + row * S::kPitch + 16 * t;
      // digits: [type][Kt/16][N/8][8][16]; step st starts 32 st N bytes
      // into a type, chunk c of the n dimension 16 kChunk bytes into a step
      const uint64_t desc = smem_desc(stage, 16u * N, 128u);
      uint4 x0 = ld_shared16(wp), x1 = ld_shared16(wp + 64);
      // every tile takes all kSteps steps, the last one too: its markers
      // past Mpad meet zero digits
#pragma unroll
      for (int st = 0; st < S::kSteps; ++st) {
        // the a- and b-fields of the lane's byte rows at both quads
        uint32_t fa[2][S::kBytes], fb[2][S::kBytes];
#pragma unroll
        for (int bi = 0; bi < S::kBytes; ++bi) {
          const uint32_t y0 = byte_row(x0, pair, half[bi]);
          const uint32_t y1 = byte_row(x1, pair, half[bi]);
          fa[0][bi] = swar_a_fields(y0);
          fa[1][bi] = swar_a_fields(y1);
          fb[0][bi] = swar_b_fields(y0);
          fb[1][bi] = swar_b_fields(y1);
        }
        if (st + 1 < S::kSteps) {  // the next step's words, in flight now
          x0 = ld_shared16(wp + 128 * (st + 1));
          x1 = ld_shared16(wp + 128 * (st + 1) + 64);
        }
        // A fragments: rows g (plane 2h) and g+8 (plane 2h+1) at markers
        // 4t.. (a[0], a[1]) and 16+4t.. (a[2], a[3]) of the step
        uint32_t a[S::kTiles][2][4];
#pragma unroll
        for (int q = 0; q < S::kTiles; ++q) {
          const int bi = q / 2, k0 = 2 * hq[q];
          a[q][0][0] = plane_at(fa[0][bi], k0);
          a[q][0][1] = plane_at(fa[0][bi], k0 + 1);
          a[q][0][2] = plane_at(fa[1][bi], k0);
          a[q][0][3] = plane_at(fa[1][bi], k0 + 1);
          a[q][1][0] = plane_at(fb[0][bi], k0);
          a[q][1][1] = plane_at(fb[0][bi], k0 + 1);
          a[q][1][2] = plane_at(fb[1][bi], k0);
          a[q][1][3] = plane_at(fb[1][bi], k0 + 1);
        }
        // the descriptors of the step's w8 and mu8 blocks, chunk by chunk
        // (at N = 256 computed between the wgmma: eight more registers
        // would spill)
        uint64_t dsc[S::kChunks][2];
#pragma unroll
        for (int c = 0; c < S::kChunks; ++c) {
          dsc[c][0] =
              desc + (uint64_t)((32 * st * N + 16 * S::kChunk * c) >> 4);
          dsc[c][1] = dsc[c][0] + (uint64_t)((S::kKt * N) >> 4);
          if constexpr (S::kChunks <= 2) {
            fence_desc(dsc[c][0]);
            fence_desc(dsc[c][1]);
          }
        }
#pragma unroll
        for (int q = 0; q < S::kTiles; ++q) {
          fence_regs(a[q][0]);
          fence_regs(a[q][1]);
        }
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < S::kTiles; ++q)
#pragma unroll
          for (int c = 0; c < S::kChunks; ++c) {
            wgmma_u8s8(acc[q][c], a[q][0], dsc[c][0]);  // a-plane, w8
            wgmma_u8s8(acc[q][c], a[q][1], dsc[c][1]);  // b-plane, mu8
          }
        wgmma_commit();
        // the A registers are rewritten by the next step: wait for this
        // step's wgmma to read them (overlapping the next step's decode
        // with them makes ptxas serialize every wgmma instead)
        wgmma_wait<0>();
      }
      // every wgmma of this warpgroup that read the stage has completed
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
#pragma unroll
    for (int q = 0; q < S::kTiles; ++q)
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) fence_regs(acc[q][c]);
    // acc[q][c][4 jj + r]: fragment row g + 8 (r >> 1), i.e. plane
    // 2 hq[q] + (r >> 1) of byte row b0 + q / 2 of word row i0 + row;
    // column c kChunk + 8 jj + 2t + (r & 1) of digit group blockIdx.z
    const int64_t i = i0 + row;
    if (i >= nw) return;
    const int64_t nb = 4 * nw;
#pragma unroll
    for (int q = 0; q < S::kTiles; ++q) {
      const int b = b0 + q / 2;
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < S::kChunk / 2; ++e) {
          const int r = e & 3;
          const int k = 2 * hq[q] + (r >> 1);
          const int64_t d = (int64_t)blockIdx.z * N + c * S::kChunk +
                            8 * (e >> 2) + 2 * t + (r & 1);
          if (d < d_total)
            atomicAdd(out + (d * 4 + k) * nb + 4 * i + b,
                      acc[q][c][e] >> (2 * k));
        }
    }
  }
}

template <int N>
int launch_fused_ab(const uint32_t* words, const uint8_t* dig, int32_t* out,
                    int64_t nw, int64_t mpad, int64_t d_total,
                    cudaStream_t stream) {
  using S = Fab<N>;
  auto kernel = fused_ab_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers inside the block's allocation: the
  // consumers' rise assumes the count it was computed from (else it would
  // wait for registers that never come)
  if constexpr (S::kMoveRegs) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != S::kLaunchRegs)
      return (int)cudaErrorInvalidConfiguration;
  }
  int64_t target = 0;
  if (const int e = dot_target(kernel, S::kThreads, S::kSmem, &target))
    return e;
  const int64_t tiles = cdiv(mpad, S::kKt);
  const int64_t rows = cdiv(nw, S::kRows), groups = cdiv(d_total, N);
  const int64_t per_part =
      imin(part_length(tiles, rows * groups, target), S::kMaxTiles);
  const dim3 grid((unsigned)rows, (unsigned)cdiv(tiles, per_part),
                  (unsigned)groups);
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(words, dig, out, nw,
                                                  mpad, d_total, per_part);
  return (int)cudaGetLastError();
}

// The digit group's width for D digit rows, D rounded up to 8, 16, 32, 64,
// 128 or 256 (groups of 256 past that), and the markers per tile for it:
// the layout the wrapper gives the digits (ops/study.py's fused_ab_n and
// fused_ab_kt)
int64_t fused_ab_n(int64_t d_total) {
  int64_t n = 8;
  while (n < d_total && n < kMaxN) n *= 2;
  return n;
}

int64_t fused_ab_kt(int64_t n) { return fab_kt((int)n); }

}  // namespace

extern "C" {

// words int32[Nw, Mpad] (16-byte aligned), dig int8[groups, tiles, 2,
// Kt/16, N/8, 8, 16] (ops/study.py's fused_ab_digits: zero past D and
// Mpad, N = fused_ab_n(D), Kt = fused_ab_kt(N)), out int32[D, 4, 4*Nw],
// zeroed
int gvamp_fused_ab(const void* words, const void* dig, void* out, int64_t nw,
                   int64_t mpad, int64_t d_total, int64_t n, int64_t kt,
                   void* stream) {
  if (nw <= 0 || mpad <= 0 || mpad % 4 != 0 || d_total <= 0 ||
      n != fused_ab_n(d_total) || kt != fused_ab_kt(n) ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dig) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* d = static_cast<const uint8_t*>(dig);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch_fused_ab<8>(w, d, o, nw, mpad, d_total, s);
    case 16: return launch_fused_ab<16>(w, d, o, nw, mpad, d_total, s);
    case 32: return launch_fused_ab<32>(w, d, o, nw, mpad, d_total, s);
    case 64: return launch_fused_ab<64>(w, d, o, nw, mpad, d_total, s);
    case 128: return launch_fused_ab<128>(w, d, o, nw, mpad, d_total, s);
    default: return launch_fused_ab<256>(w, d, o, nw, mpad, d_total, s);
  }
}

}  // extern "C"
