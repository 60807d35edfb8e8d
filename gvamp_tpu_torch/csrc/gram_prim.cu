// The fused primal Gram of the block CG, written by hand for Hopper (sm_90a):
//   gram_i8a (complete genotypes, the a-plane only):
//     z = na (A_a W - colsum_u),  av = A_a^T z,  zout = z (the wrapper's sv)
//   gram_i8 (missing calls, both planes):
//     z = na (A_a W - A_b U),     av = A_a^T z,  bv = A_b^T z
// in one read of the packed words from HBM for any width B.  Bound through
// the plain C interface of gvamp_tpu_torch/ops/_build.py; the wrappers and
// the plain PyTorch versions (gram_i8a_ref, gram_i8_ref) are in
// gvamp_tpu_torch/ops/matvec.py.
//
// Replaces gram_i8a_pallas / _gram_i8a_kernel and gram_i8_pallas /
// _gram_i8_kernel (gvamp_tpu/ops/matvec.py:963, 1133), which walk the
// sample bands in sequence, cache one band of words in VMEM and run band
// i's forward dots beside band i-1's transpose dots (:883-947).
//
// Numerics (the plain versions repeat every step): the forward digit
// products of W (and of -U, under one shared scale per column, in the same
// int32 sum) over all Mpad markers are exact; per band of kT word rows each
// sample is folded to f32 (fold4), masked, the band's max |z| per column
// gives 4 radix-127 scales, z is requantised into 4 digits, the transpose
// digit products of the band (exact) are folded with its scales and added
// to av (and bv) band after band, in band order.  Every f32 step is a
// round-to-nearest intrinsic (fold4, __fmul_rn, __fsub_rn, __fdiv_rn,
// __fadd_rn, rintf), so the kernel equals its plain version bit for bit.
// kT is a numerics boundary (GRAM_BAND_NW), never sized from the card.
//
// Bound on this card: the one read of the 4 Nw Mpad bytes of the words
// (10.74 GB at configs B and Bm: 3.21 ms at 3.35 TB/s); the contractions
// (2 N M 8 int8 operations per side, plane and group of two columns) take
// about a tenth of that on the tensor cores.  Each word is decoded twice
// (once per side) and byte-transposed once, as in fragments.cu's digit
// products, whose lane maps the two sides follow: alone, those kernels run
// at 87-90% of the read on one plane.  A band's forward sums run over every
// marker, so every block must add its partials of band i before any block
// can requantise band i: a grid-wide dependency per band (1,280 bands at
// config B).  Met with one grid.sync per band, synchronous loads and both
// sides in series on every warp, it cost 35 ms at config B; in series even
// with the loads ahead and the barrier split, 15.8 ms, 11 us per band,
// most of it the latencies of the loads of digits and of av from L2, of
// the atomics' fence and of the spin (a clock64 profile on an H100).  So
// the two sides run on separate warps that overlap them, and what is left
// per band is a chain across the blocks: every block's forward side, the
// arrivals, the fold and requantisation, the transpose side.
//
// Design: one persistent block per SM (a cooperative launch, so that every
// block is resident and the spins below cannot deadlock); block j owns a
// fixed range of rq marker quads (R = 4 rq words per row).  Warps 0-7, the
// forward group, and warps 8-15, the transpose group, each walk the bands
// in order, meeting through shared-memory mbarriers and the global
// counters; each group has its own named barrier.
//   * A ring of kRing band tiles in shared memory, loaded ahead with the
//     Tensor Memory Accelerator: at the end of its band j the forward
//     group's first 16 lanes each issue one row copy of band j+2
//     (cp.async.bulk, 16 R bytes) completing on the slot's `full`
//     mbarrier, once both groups have released band j-1's slot (its
//     `empty` mbarrier).
//   * Forward group, band j: axm_i8's lane map from the tile (warp w takes
//     row group w % 2, 8 word rows, and the 32-marker steps w / 2, w / 2 +
//     4, ...), the B fragments W's digits (and -U's against the b-plane,
//     into the same accumulator) from a digit tile in shared memory (loaded
//     once for B <= 2, per band and digit group beyond); the warps' sums,
//     shifted back, meet in shared int32 atomics on one [8 digit rows x 256
//     samples] tile, which the group adds into the band's slot of partials
//     with one global atomic per sum (exact: the order of the blocks does
//     not matter); then a release-add on the slot's arrival counter.  Then
//     the transpose side of band j-1's marker groups 8-15 (below), once the
//     transpose group has handed over that band's digits (the
//     `digits_full` / `digits_free` mbarriers).  On two planes the arrival
//     comes after that transpose side instead: each order measured faster
//     on an H100 for its own form.
//   * Transpose group, band i: waits until every block has arrived at band
//     i (a spin on the counter), then per group of 8 digit rows (two
//     columns): thread = sample, both columns folded, masked, the band's
//     max |z| per column (a warp max, then 8 warps'), the 4 scales and each
//     sample's 4 digits into shared memory, [plane][digit row][row] as the
//     B fragments read them, a zero residual's divisions skipped; then the
//     transpose side of marker groups 0-7.
//   * Transpose side: atxm_i8's lane map from the tile, warp w of a group
//     taking one 64-marker group (two steps of 8 word rows, one plane type
//     after the other); lanes t and t^1 exchange digits so that each folds
//     its marker's column with the band's scales and adds it to its
//     running sum of av (and bv), kept in registers from band to band for
//     one digit group (B <= 2) and stored at the end, or loaded before the
//     contraction and stored after it for wider B.  Each block owns its
//     markers: no f32 atomic, av summed in band order.
//   * The partial slots form a ring of kZRing.  When every block has
//     arrived at band i, every block has released band i-3's tile, so it
//     has read band i-3's partials: block (i - 3) mod grid then zeroes that
//     slot and bumps its zeroed counter, on which the forward group waits
//     before adding into the slot again (kZRing - 3 bands later).  The
//     counters are monotonic within a launch, so one word per slot and
//     counter serves every band; each lies on an L2 line of its own, and
//     the spins poll every 32 ns or so, so that 132 pollers leave the line
//     to the atomics.  The last block to finish zeroes the slots and the
//     counters, so the scratch is all zero again after a launch.  A spin
//     that outlasts kSpinCycles (seconds) traps: a fault raises rather than
//     hangs.
//   * The tile rows are not swizzled (a row copy lands whole) but shifted:
//     row r starts swz(r) = 0, 4, 2, 6 chunks of 16 bytes (r % 4) past a
//     pitch that is a multiple of 128 bytes.  The forward side's quarter
//     warp (rows 2p, 2p+1, chunks c..c+3) and the transpose side's (rows
//     t = 0..3, chunks c + g, g in {2p, 2p+1}) then both touch 8 distinct
//     chunk positions mod 8 (the 32 banks), which no single pitch gives
//     (gram_aat.cu needs an XOR swizzle for the same two maps).
// Integer ranges: plane64 makes the tensor-core sums 64 times the true
// ones; each warp's sum stays inside int32 (static_asserts below) and is
// shifted back (exact: its low 6 bits are zero) before any addition
// across warps or blocks, so the global forward sums are the true ones,
// at most 381 Mpad, which the launcher keeps below 2^31.
// Shared memory: the ring, 3 x 16 x pitch words (pitch = 4 rq + 24 rounded
// up to 32 words), the digit tile, 2 x 8 x (4 rq rounded up to 128, plus
// 16) bytes, and 10,976 bytes of barriers, the forward tile, the band's
// digits and the scales: 224,224 bytes at config B's 131,072 markers.
// The route's edge is rq = 256 quads per block (one marker group per warp,
// 230,368 bytes): Mpad up to 135,168 on 132 SMs.
// The launcher validates its arguments and returns a CUDA error code
// (cudaGetLastError() after the launch); indices are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async.cuh"
#include "mma.cuh"
#include "swar.cuh"

namespace {

constexpr int kT = 16;                        // word rows per band (numerics)
constexpr int kBandRows = 4 * kT;             // planar rows per plane and band
constexpr int kBandSamples = 4 * kBandRows;   // samples of a band, all planes
constexpr int kRing = 3;                      // band tiles in the ring
constexpr int kZRing = 8;                     // partial-sum slots in the ring
constexpr int kThreads = 512;
constexpr int kGroup = 256;                   // threads per warp group
constexpr int kGroupWarps = kGroup / 32;
constexpr int kBarForward = 1, kBarTranspose = 2;  // named barriers
constexpr int kMaxCols = 64;                  // columns per launch (D <= 256)
// the transpose side's 64-marker groups: one per warp of either group,
// whose running sums stay in registers (8 in the two-plane form), so R up
// to 2 x 8 x 64 = 1,024 words
constexpr int kMarkerGroups = 2 * kGroupWarps;
static_assert(kGroup == kBandSamples, "one fold thread per sample");
static_assert(kGroupWarps == 8, "4 forward warps per row group");
static_assert(kT <= 32, "one lane per row copy");

// tile rows: shifted by up to 6 chunks (24 words), pitch a multiple of 32
// words (128 bytes)
constexpr int kRowShift = 24;
constexpr int kPitchAlign = 32;
// the band's digits: [4 planes][8 digit rows][kDigPitch bytes], 64 used;
// 80 bytes (20 words) put the 8 digit rows a quarter warp reads on
// distinct banks
constexpr int kDigPitch = 80;
// shared memory besides the ring and the forward digit tile: the
// mbarriers and the last block's flag (128 bytes), the forward tile
// [8 digit rows][4 planes][64 rows] int32, the band's digits, the group's
// scales [2][4] and the warps' max [2][8]
constexpr int kHeadBytes = 128;
constexpr int kFtileInts = 8 * kBandSamples;
constexpr int64_t kFixedBytes =
    kHeadBytes + 4 * kFtileInts + 4 * 8 * kDigPitch + 4 * 2 * 4 + 4 * 2 * 8;
// shared memory a block may use on an H100 (227 KB)
constexpr int64_t kSmemBudget = 232448;
// the largest row of a block: the transpose side's marker groups
constexpr int64_t kMaxRowWords = kMarkerGroups * 64;
// the global scratch: the counters, each on a 128-byte line of its own
// (the arrivals and the zeroings of each partial slot, the blocks that have
// finished), then the partial slots [kZRing][D][4][kBandRows]
constexpr int kLineInts = 32;
constexpr int kCounters = 2 * kZRing + 1;
constexpr int kCounterInts = kCounters * kLineInts;

// plane64's factor, as in fragments.cu: the tensor-core sums are 1 <<
// kScaleShift times the true ones, each term at most 64 * 2 * 127 (one
// plane) or 64 * (2 + 1) * 127 (both planes into one sum, the forward side)
constexpr int kScaleShift = 6;
constexpr int64_t kScaledTerm = (2 << kScaleShift) * 127;
static_assert(kMaxRowWords * (kScaledTerm + kScaledTerm / 2) < INT32_MAX,
              "a warp's forward sum over a block's markers");
static_assert(2 * 32 * 4 * kScaledTerm < INT32_MAX,
              "a warp's transpose sum over a band");
// the true global forward sums at the route's edge on an H100 (132 blocks
// of at most kMaxRowWords markers); the launcher checks 381 Mpad < 2^31
static_assert(132 * kMaxRowWords * 381 < INT32_MAX, "global forward sums");
static_assert(kFixedBytes + 4 * kRing * kT * (kMaxRowWords + 32) +
                      2 * 8 * (kMaxRowWords + 16) <=
                  kSmemBudget,
              "the largest block's shared memory");

// words per tile row in shared memory: the block's 4 rq words, the shift
// of up to kRowShift, rounded up to a multiple of kPitchAlign
__host__ __device__ __forceinline__ int64_t tile_pitch(int64_t rq) {
  return (4 * rq + kRowShift + kPitchAlign - 1) / kPitchAlign * kPitchAlign;
}

// bytes per row of the forward digit tile: the block's 4 rq markers
// rounded up to 128, plus 16 (so that the 8 rows a quarter warp reads lie
// on distinct banks); zero past the block's markers
__host__ __device__ __forceinline__ int64_t dig_pitch(int64_t rq) {
  return (4 * rq + 127) / 128 * 128 + 16;
}

int64_t prim_quads_per_block(int64_t mpad, int64_t nblocks) {
  return cdiv(mpad / 4, nblocks);
}

int64_t prim_smem_bytes(int64_t mpad, int64_t nblocks) {
  const int64_t rq = prim_quads_per_block(mpad, nblocks);
  return kFixedBytes + 4 * kRing * kT * tile_pitch(rq) + 2 * 8 * dig_pitch(rq);
}

int64_t prim_scratch_ints(int64_t ncols) {
  return kCounterInts + (int64_t)kZRing * 4 * ncols * kBandSamples;
}

// the shift of tile row r in 16-byte chunks
__device__ __forceinline__ int swz(int r) { return ((r & 1) << 2) | (r & 2); }

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// one thread, after a barrier of its group: *p += 1 with release semantics
// at GPU scope, so that the group's writes before the barrier (its global
// atomics, its zeroing) are visible to a thread that acquires the count
__device__ __forceinline__ void release_add(uint32_t* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

// one thread: wait until *p >= target (a monotonic counter of other
// blocks), polling every 32 ns or so, so that 132 pollers leave the
// counter's L2 line free for the atomics they wait on
__device__ __forceinline__ void wait_count(const uint32_t* p, uint32_t target) {
  const long long t0 = clock64();
  while (ld_acquire(p) < target) {
    if (clock64() - t0 > kSpinCycles) __trap();
    __nanosleep(32);
  }
}

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kGroup) : "memory");
}

// one warp: the kT rows of band `band` (the block's quads q0.., 16 nqb bytes
// each) into ring slot `tile`, one row copy per lane, completing on `bar`
__device__ __forceinline__ void load_band(const uint32_t* words, int64_t mpad,
                                          int band, int64_t q0, int nqb,
                                          uint32_t* tile, int pitch,
                                          uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const uint32_t bytes = 16u * (uint32_t)nqb;
  if (lane < kT) {
    // the slot's earlier band was read through the generic proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_expect_tx(bar, kT * bytes);
  }
  __syncwarp();
  if (lane < kT)
    bulk_copy(tile + lane * pitch + 4 * swz(lane),
              words + ((int64_t)band * kT + lane) * mpad + 4 * q0, bytes, bar);
}

// The forward group's threads: digit rows 8 dg .. 8 dg + 7 of W (and of
// -U) at the block's markers into the digit tile [2][8][dp], zero past D
// and past the block's rlen markers.
__device__ __forceinline__ void load_digits(const uint8_t* wdig,
                                            const uint8_t* udig, uint8_t* fdig,
                                            int dp, int dg, int d_total,
                                            int64_t mpad, int m_block,
                                            int rlen, int tid, int nthreads) {
  const int row_words = dp / 4;
  const int types = udig ? 2 : 1;
  for (int e = tid; e < types * 8 * row_words; e += nthreads) {
    const int p = e / (8 * row_words);
    const int n = (e / row_words) % 8;
    const int o = 4 * (e % row_words);
    uint32_t v = 0u;
    if (8 * dg + n < d_total && o < rlen)
      v = __ldg(reinterpret_cast<const uint32_t*>(
          (p ? udig : wdig) + (8 * dg + n) * mpad + m_block + o));
    reinterpret_cast<uint32_t*>(fdig)[e] = v;
  }
}

// Position of (digit row n, sample s = 64 k + p) in the forward tile: the
// row index XORed with (n / 2) % 4, so that the atomics of one instruction
// (n = 2t + c, p = 4r + b, r = 8rg + g) fall on 32 distinct banks.
__device__ __forceinline__ int ftile_at(int n, int k, int p) {
  return (n * 4 + k) * kBandRows + (p ^ ((n >> 1) & 3));
}

// The forward contraction of one band and digit group: forward warp w
// takes row group w % 2 and the 32-marker steps w / 2, w / 2 + 4, ...; lane
// (g, t) loads 16 bytes at markers m + 4t and m + 16 + 4t of tile row r = 8
// rg + g and the u32 of digit row g of the digit tile at the same markers
// (W's, and -U's for the b-plane), transposes the words into four people's
// marker quads, decodes the planes and contracts them into the 8 m tiles
// of acc.  Markers past the block's rlen meet zero digits.  The sums,
// shifted back, are added into the forward tile.
template <bool kGeneral>
__device__ __forceinline__ void fw_side(const uint32_t* tile, int pitch,
                                        int rlen, const uint8_t* fdig,
                                        int dp, int32_t* ftile) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 8 * (warp & 1) + g;
  const uint32_t* row = tile + r * pitch + 4 * swz(r) + 4 * t;
  const uint8_t* wd = fdig + g * dp + 4 * t;
  const uint8_t* ud = wd + 8 * dp;
  int32_t acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;
  // two steps unrolled on one plane, so that their loads overlap; one on
  // two (within 128 registers)
  constexpr int kUnroll = kGeneral ? 1 : 2;
#pragma unroll kUnroll
  for (int m = 32 * (warp >> 1); m < rlen; m += 32 * (kGroupWarps / 2)) {
    const uint4 x0 = *reinterpret_cast<const uint4*>(row + m);
    const uint4 x1 = *reinterpret_cast<const uint4*>(row + m + 16);
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wd + m);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wd + m + 16);
    uint32_t u0 = 0u, u1 = 0u;
    if constexpr (kGeneral) {
      u0 = *reinterpret_cast<const uint32_t*>(ud + m);
      u1 = *reinterpret_cast<const uint32_t*>(ud + m + 16);
    }
    uint32_t y0[4], y1[4];
    transpose_quad(x0, y0);
    transpose_quad(x1, y1);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t f0 = swar_a_fields(y0[b]), f1 = swar_a_fields(y1[b]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // planes 2h (fragment row g) and 2h+1 (row g+8) of person 4r + b
        const uint32_t a[4] = {plane64(f0, 2 * h), plane64(f0, 2 * h + 1),
                               plane64(f1, 2 * h), plane64(f1, 2 * h + 1)};
        mma_u8s8(acc[2 * b + h], a, w0, w1);
      }
      if constexpr (kGeneral) {
        const uint32_t e0 = swar_b_fields(y0[b]), e1 = swar_b_fields(y1[b]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a[4] = {plane64(e0, 2 * h), plane64(e0, 2 * h + 1),
                                 plane64(e1, 2 * h), plane64(e1, 2 * h + 1)};
          mma_u8s8(acc[2 * b + h], a, u0, u1);
        }
      }
    }
  }
  // acc[2b + h][2*half + c] is plane 2h + half, row 4r + b, digit row 2t + c
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          atomicAdd(ftile + ftile_at(2 * t + c, 2 * h + half, 4 * r + b),
                    acc[2 * b + h][2 * half + c] >> kScaleShift);
}

// The transpose side of one band and digit group from ring slot `tile`,
// 64-marker group mg: two steps of 8 word rows, lane (g, t) loading the
// 16-byte chunks 16 mg + 8l + g (markers past the block's R words re-read
// its last chunk: their sums are never written) of tile rows ia = 8st + t
// and ia + 4, contracting each plane k against the u32 digits of digit row
// g at people 4ia and 4(ia + 4), the a-plane and then, with kGeneral, the
// b-plane.  Lanes t and t^1 then exchange digits so that each folds its
// marker's column with the band's scales and adds the fold to its running
// sum: sum[p][lh] is marker 64 mg + 32 (lh / 2) + 4g + 2 (lh % 2) + (t &
// 1), column col0 + t / 2, plane type p.  With `resident` (one digit
// group) the sums stay in registers from band to band and the kernel
// stores them at its end; else they are loaded from av (and bv) before the
// contraction and stored after it.
template <bool kGeneral>
__device__ __forceinline__ void tx_side(const uint32_t* tile, int pitch,
                                        int rlen, int mg, const int8_t* zd8,
                                        const float* scs, int col0,
                                        int64_t ncols, int64_t mpad,
                                        int m_block, float* av, float* bv,
                                        bool resident,
                                        float (&sum)[kGeneral ? 2 : 1][4]) {
  constexpr int kTypes = kGeneral ? 2 : 1;
  if (64 * mg >= rlen) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int last_chunk = rlen / 4 - 1;
  const int cl = t >> 1;
  const bool odd = t & 1;
  const int64_t b = col0 + cl;
  float* const outs[2] = {av, bv};
  auto marker = [&](int lh) {
    return 64 * mg + 32 * (lh / 2) + 4 * g + 2 * (lh % 2) + odd;
  };
  if (!resident) {
#pragma unroll
    for (int lh = 0; lh < 4; ++lh) {
      const int mm = marker(lh);
#pragma unroll
      for (int p = 0; p < kTypes; ++p)
        sum[p][lh] = mm < rlen && b < ncols
                         ? outs[p][b * mpad + m_block + mm] : 0.f;
    }
  }
  // one plane type at a time, so that one set of accumulators is live (the
  // two-plane form fits 128 registers); the words are read from shared
  // memory again for the second; the loop stays rolled, so that the
  // compiler does not interleave the two
#pragma unroll 1
  for (int p = 0; p < kTypes; ++p) {
    int32_t acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int ia = 8 * st + t, ib = ia + 4;
      const uint4* ra =
          reinterpret_cast<const uint4*>(tile + ia * pitch + 4 * swz(ia));
      const uint4* rb =
          reinterpret_cast<const uint4*>(tile + ib * pitch + 4 * swz(ib));
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const int q = min(16 * mg + 8 * l + g, last_chunk);
        const uint4 xa = ra[q], xb = rb[q];
        const uint32_t wa[4] = {xa.x, xa.y, xa.z, xa.w};
        const uint32_t wb[4] = {xb.x, xb.y, xb.z, xb.w};
        uint32_t fa[4], fb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fa[e] = p == 0 ? swar_a_fields(wa[e]) : swar_b_fields(wa[e]);
          fb[e] = p == 0 ? swar_a_fields(wb[e]) : swar_b_fields(wb[e]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int8_t* v = zd8 + (kk * 8 + g) * kDigPitch;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(v + 4 * ia);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(v + 4 * ib);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t a[4] = {plane64(fa[2 * h], kk),
                                   plane64(fa[2 * h + 1], kk),
                                   plane64(fb[2 * h], kk),
                                   plane64(fb[2 * h + 1], kk)};
            mma_u8s8(acc[2 * l + h], a, b0, b1);
          }
        }
      }
    }
    // acc[2l + h][2*half + c], shifted back, is marker 64 mg + 32 l + 4g +
    // 2h + half, digit row 2t + c: digits 2(t&1) + c of column t/2.  The
    // even lane owns half 0, the odd one half 1; each sends the partner its
    // digits of the partner's half.
    const float s[4] = {scs[4 * cl], scs[4 * cl + 1], scs[4 * cl + 2],
                        scs[4 * cl + 3]};
#pragma unroll
    for (int lh = 0; lh < 4; ++lh) {
      int32_t a[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = acc[lh][c] >> kScaleShift;
      const int32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
      const int32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
      const int32_t o0 = odd ? a[2] : a[0], o1 = odd ? a[3] : a[1];
      const int32_t td[4] = {odd ? r0 : o0, odd ? r1 : o1, odd ? o0 : r0,
                             odd ? o1 : r1};
      sum[p][lh] = __fadd_rn(sum[p][lh], fold4(td, s));
    }
  }
  if (!resident) {
#pragma unroll
    for (int lh = 0; lh < 4; ++lh) {
      const int mm = marker(lh);
      if (mm < rlen && b < ncols) {
#pragma unroll
        for (int p = 0; p < kTypes; ++p)
          outs[p][b * mpad + m_block + mm] = sum[p][lh];
      }
    }
  }
}

// The running sums of a lane's markers (column t / 2 of one digit group),
// stored at the end of the kernel: marker group mg.
template <bool kGeneral>
__device__ __forceinline__ void store_sums(const float (&sum)[kGeneral ? 2 : 1][4],
                                           int mg, int rlen, int64_t ncols,
                                           int64_t mpad, int m_block,
                                           float* av, float* bv) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t b = t >> 1;
  float* const outs[2] = {av, bv};
#pragma unroll
  for (int lh = 0; lh < 4; ++lh) {
    const int mm = 64 * mg + 32 * (lh / 2) + 4 * g + 2 * (lh % 2) + (t & 1);
    if (mm < rlen && b < ncols) {
#pragma unroll
      for (int p = 0; p < (kGeneral ? 2 : 1); ++p)
        outs[p][b * mpad + m_block + mm] = sum[p][lh];
    }
  }
}

template <bool kGeneral>
__global__ void __launch_bounds__(kThreads, 1)
gram_prim_kernel(const uint32_t* __restrict__ words,  // [Nw, Mpad]
                 const uint8_t* __restrict__ wdig,    // [4B][Mpad], row 4b+d
                 const uint8_t* __restrict__ udig,    // -U's, the same (general)
                 const float* __restrict__ wsc,       // [4][B] digit scales
                 const float* __restrict__ cu,        // [B] colsum_u (a-only)
                 const float* __restrict__ na,        // [4][Nb][B]
                 int32_t* scratch,                    // counters, partial slots
                 float* __restrict__ zout,            // [4][Nb][B] (a-only)
                 float* av,                           // [B][Mpad]
                 float* bv,                           // [B][Mpad] (general)
                 int64_t nw, int64_t mpad, int64_t ncols, int64_t rq) {
  constexpr int kTypes = kGeneral ? 2 : 1;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);          // [kRing]
  uint64_t* empty = full + kRing;                              // [kRing]
  uint64_t* digits_full = empty + kRing;   // the band's digits are written
  uint64_t* digits_free = digits_full + 1; // ... and read by the forward group
  int* last_flag = reinterpret_cast<int*>(digits_free + 1);
  // block constants and counters in 32 bits where they fit (registers are
  // the two-plane form's limit)
  const int pitch = (int)tile_pitch(rq);
  const int dp = (int)dig_pitch(rq);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kHeadBytes);
  int32_t* ftile = reinterpret_cast<int32_t*>(ring + kRing * kT * pitch);
  uint8_t* fdig = reinterpret_cast<uint8_t*>(ftile + kFtileInts);  // [2][8][dp]
  int8_t* zd8 = reinterpret_cast<int8_t*>(fdig + 2 * 8 * dp);  // [4][8][kDigPitch]
  float* scs = reinterpret_cast<float*>(zd8 + 4 * 8 * kDigPitch);  // [2][4]
  float* wmax = scs + 8;                                           // [2][8]
  // counter c of the scratch (counters + c * kLineInts): arrivals of slot
  // s at c = s, zeroings at kZRing + s, finished blocks at 2 kZRing
  uint32_t* const counters = reinterpret_cast<uint32_t*>(scratch);
  int32_t* zacc = scratch + kCounterInts;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t nblocks = gridDim.x;
  const int64_t nq = mpad / 4;
  const int64_t q0 = (int64_t)blockIdx.x * rq;
  const int nqb = (int)imin(rq, nq - q0);  // quads of this block (> 0)
  const int rlen = 4 * nqb;                // words per tile row
  const int m_block = (int)(4 * q0);       // Mpad < 2^31 / 381
  const int64_t nb = 4 * nw;
  const int nbands = (int)(nw / kT);
  const int d_total = (int)(4 * ncols);
  const int groups = (int)((ncols + 1) / 2);
  const int slot_ints = d_total * kBandSamples;
  const uint8_t* const udig_or_null = kGeneral ? udig : nullptr;
  // one digit group: the transpose sums stay in registers
  const bool resident = groups == 1;
  float sum[kTypes][4];
#pragma unroll
  for (int p = 0; p < kTypes; ++p)
#pragma unroll
    for (int lh = 0; lh < 4; ++lh) sum[p][lh] = 0.f;

  for (int i = tid; i < kFtileInts; i += kThreads) ftile[i] = 0;
  if (groups == 1)
    load_digits(wdig, udig_or_null, fdig, dp, 0, d_total, mpad, m_block, rlen,
                tid, kThreads);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // both groups transpose from each tile
    }
    mbar_init(digits_full, 1);
    mbar_init(digits_free, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int j = 0; j < kRing - 1 && j < nbands; ++j)
      load_band(words, mpad, j, q0, nqb, ring + j * kT * pitch, pitch, full + j);

  if (tid < kGroup) {
    // ---------------- forward group ----------------
    // band j's forward side, then the transpose side of band j - 1's
    // marker groups 8..15, then band j + 2's load
    for (int j = 0; j <= nbands; ++j) {
      if (j < nbands) {
        const int s = j % kRing;
        const uint32_t* tile = ring + s * kT * pitch;
        const int zs = j % kZRing;
        int32_t* zslot = zacc + zs * slot_ints;
        mbar_wait(full + s, (uint32_t)((j / kRing) & 1));
        for (int dg = 0; dg < groups; ++dg) {
          if (groups > 1) {
            load_digits(wdig, udig_or_null, fdig, dp, dg, d_total, mpad,
                        m_block, rlen, tid, kGroup);
            group_sync(kBarForward);
          }
          fw_side<kGeneral>(tile, pitch, rlen, fdig, dp, ftile);
          // the slot's earlier band has been read by every block and zeroed
          if (tid == 0 && dg == 0 && j >= kZRing)
            wait_count(counters + (kZRing + zs) * kLineInts, (uint32_t)(j / kZRing));
          group_sync(kBarForward);
          // the digit rows past D took zero digits: their sums are zero
          const int live = min(8, d_total - 8 * dg) * kBandSamples;
          for (int e = tid; e < live; e += kGroup) {
            const int nn = e / kBandSamples, k = (e / kBandRows) % 4,
                      p = e % kBandRows;
            const int at = ftile_at(nn, k, p);
            const int32_t v = ftile[at];
            ftile[at] = 0;
            atomicAdd(zslot + ((8 * dg + nn) * 4 + k) * kBandRows + p, v);
          }
          group_sync(kBarForward);
        }
        // the block's arrival at band j: here on one plane; after the
        // transpose side below on two, whose forward side takes longer
        // (both orders measured on an H100, each faster for its form)
        if (!kGeneral && tid == 0) release_add(counters + zs * kLineInts);
      }
      if (j >= 1) {
        const int i = j - 1;
        const uint32_t* tile = ring + (i % kRing) * kT * pitch;
        for (int dg = 0; dg < groups; ++dg) {
          const int x = i * groups + dg;  // the digits' handover count
          mbar_wait(digits_full, (uint32_t)(x & 1));
          tx_side<kGeneral>(tile, pitch, rlen, kGroupWarps + warp, zd8, scs,
                            2 * dg, ncols, mpad, m_block, av, bv, resident,
                            sum);
          group_sync(kBarForward);
          if (tid == 0) mbar_arrive(digits_free);
        }
        if (tid == 0) mbar_arrive(empty + i % kRing);
      }
      if (kGeneral && j < nbands && tid == 0)
        release_add(counters + (j % kZRing) * kLineInts);
      // band j + 2 into the slot that band j - 1 leaves
      const int jn = j + kRing - 1;
      if (warp == 0 && jn < nbands) {
        const int sn = jn % kRing;
        if (jn >= kRing) mbar_wait(empty + sn, (uint32_t)((jn / kRing - 1) & 1));
        load_band(words, mpad, jn, q0, nqb, ring + sn * kT * pitch, pitch,
                  full + sn);
      }
    }
    if (resident)
      store_sums<kGeneral>(sum, kGroupWarps + warp, rlen, ncols, mpad,
                           m_block, av, bv);
  } else {
    // ---------------- transpose group ----------------
    // band i's fold and requantisation, then the transpose side of its
    // marker groups 0..7
    const int u = tid - kGroup;         // the fold's sample: plane fk, row fp
    const int fk = u >> 6, fp = u & 63;
    const int uw = u >> 5;              // transpose warp
    for (int i = 0; i < nbands; ++i) {
      const int s = i % kRing;
      const uint32_t* tile = ring + s * kT * pitch;
      const int zs = i % kZRing;
      const int32_t* zslot = zacc + zs * slot_ints;
      // the first digit group's masks, scales and colsum_u, loaded before
      // the wait
      float mk[2], sd[2][4], cuv[2];
      auto operands = [&](int dg) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int64_t b = imin(2 * dg + c, ncols - 1);
          mk[c] = __ldg(na + (fk * nb + kBandRows * (int64_t)i + fp) * ncols + b);
#pragma unroll
          for (int d = 0; d < 4; ++d) sd[c][d] = __ldg(wsc + d * ncols + b);
          cuv[c] = kGeneral ? 0.f : __ldg(cu + b);
        }
      };
      operands(0);
      if (u == 0) wait_count(counters + zs * kLineInts, nblocks * (uint32_t)(i / kZRing + 1));
      mbar_wait(full + s, (uint32_t)((i / kRing) & 1));
      group_sync(kBarTranspose);
      // every block has arrived at band i, so every block has read band
      // i - 3's partials: this block's turn to zero their slot?
      const int iz = i - kRing;
      if (iz >= 0 && iz + kZRing < nbands && (uint32_t)iz % nblocks == blockIdx.x) {
        int32_t* zz = zacc + (iz % kZRing) * slot_ints;
        for (int e = u; e < slot_ints; e += kGroup) zz[e] = 0;
        group_sync(kBarTranspose);
        if (u == 0) {
          release_add(counters + (kZRing + iz % kZRing) * kLineInts);
        }
      }
      for (int dg = 0; dg < groups; ++dg) {
        const int x = i * groups + dg;  // the digits' handover count
        if (dg > 0) operands(dg);
        // fold and mask both columns of the group (a column past B is
        // zero), the band's max of each
        float z[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int64_t b = 2 * dg + c;
          if (b < ncols) {
            int32_t tt[4];
#pragma unroll
            for (int d = 0; d < 4; ++d)
              tt[d] = __ldcg(zslot + ((4 * b + d) * 4 + fk) * kBandRows + fp);
            const float f = fold4(tt, sd[c]);
            z[c] = kGeneral ? __fmul_rn(f, mk[c])
                            : __fmul_rn(__fsub_rn(f, cuv[c]), mk[c]);
            if (!kGeneral && blockIdx.x == 0)
              zout[(fk * nb + kBandRows * (int64_t)i + fp) * ncols + b] = z[c];
          }
          float mx = fabsf(z[c]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          if (lane == 0) wmax[8 * c + uw] = mx;
        }
        group_sync(kBarTranspose);
        // requantise: the 4 scales of each column, each sample's 4 digits;
        // the two columns' chains interleaved.  A zero residual gives zero
        // digits and stays zero, so its division is skipped.
        float mx[2], sc[2][4], rr[2];
        int8_t q[2][4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          mx[c] = wmax[8 * c];
#pragma unroll
          for (int w = 1; w < kGroupWarps; ++w)
            mx[c] = fmaxf(mx[c], wmax[8 * c + w]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sc[c][0] = __fdiv_rn(mx[c] == 0.f ? 1.f : mx[c], 127.f);
#pragma unroll
        for (int d = 1; d < 4; ++d)
#pragma unroll
          for (int c = 0; c < 2; ++c) sc[c][d] = __fdiv_rn(sc[c][d - 1], 127.f);
#pragma unroll
        for (int c = 0; c < 2; ++c) rr[c] = z[c];
#pragma unroll
        for (int d = 0; d < 4; ++d)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float dz = 0.f;
            if (rr[c] != 0.f) {
              dz = rintf(__fdiv_rn(rr[c], sc[c][d]));
              rr[c] = __fsub_rn(rr[c], __fmul_rn(dz, sc[c][d]));
            }
            q[c][d] = (int8_t)(int)dz;
          }
        // the forward group is done with the previous digits
        if (x >= 1) mbar_wait(digits_free, (uint32_t)((x - 1) & 1));
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            zd8[(fk * 8 + 4 * c + d) * kDigPitch + fp] = q[c][d];
            if (u == 0) scs[4 * c + d] = sc[c][d];
          }
        group_sync(kBarTranspose);
        if (u == 0) mbar_arrive(digits_full);
        tx_side<kGeneral>(tile, pitch, rlen, uw, zd8, scs, 2 * dg, ncols,
                          mpad, m_block, av, bv, resident, sum);
        group_sync(kBarTranspose);  // the next group rewrites wmax
      }
      if (u == 0) mbar_arrive(empty + s);  // this group is done with band i
    }
    if (resident)
      store_sums<kGeneral>(sum, uw, rlen, ncols, mpad, m_block, av, bv);
  }

  // the last block to finish zeroes the partial slots and the counters:
  // every block is done with them
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *last_flag = atomicAdd(counters + 2 * kZRing * kLineInts, 1u) + 1 == nblocks;
    __threadfence();
  }
  __syncthreads();
  if (*last_flag) {
    for (int e = tid; e < kZRing * slot_ints; e += kThreads) zacc[e] = 0;
    if (tid < kCounters) counters[tid * kLineInts] = 0;
  }
}

// words int32[Nw, Mpad], wdig (and udig) int8[4B, Mpad] (row 4b + d), wsc
// f32[4, B], cu f32[B] (a-only), na f32[4, Nb, B], scratch int32
// [prim_scratch_ints(B)] zeroed (and zero again after the launch), zout
// f32[4, Nb, B] (a-only), av (and bv) f32[B, Mpad] zeroed
template <bool kGeneral>
int launch_gram_prim(const void* words, const void* wdig, const void* udig,
                     const void* wsc, const void* cu, const void* na,
                     void* scratch, void* zout, void* av, void* bv,
                     int64_t nw, int64_t mpad, int64_t ncols, int64_t nblocks,
                     void* stream) {
  if (nw <= 0 || nw % kT != 0 || mpad <= 0 || mpad % 4 != 0 || ncols <= 0 ||
      ncols > kMaxCols || nblocks <= 0 || 381 * mpad >= INT32_MAX ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      4 * prim_quads_per_block(mpad, nblocks) > kMaxRowWords ||
      prim_smem_bytes(mpad, nblocks) > kSmemBudget)
    return (int)cudaErrorInvalidValue;
  auto kern = gram_prim_kernel<kGeneral>;
  int64_t rq = prim_quads_per_block(mpad, nblocks);
  const int64_t smem = prim_smem_bytes(mpad, nblocks);
  const int64_t grid = cdiv(mpad / 4, rq);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a cooperative grid must be resident all at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  const uint32_t* a_words = static_cast<const uint32_t*>(words);
  const uint8_t* a_wdig = static_cast<const uint8_t*>(wdig);
  const uint8_t* a_udig = static_cast<const uint8_t*>(udig);
  const float* a_wsc = static_cast<const float*>(wsc);
  const float* a_cu = static_cast<const float*>(cu);
  const float* a_na = static_cast<const float*>(na);
  int32_t* a_scratch = static_cast<int32_t*>(scratch);
  float* a_zout = static_cast<float*>(zout);
  float* a_av = static_cast<float*>(av);
  float* a_bv = static_cast<float*>(bv);
  void* args[] = {&a_words, &a_wdig, &a_udig, &a_wsc, &a_cu, &a_na,
                  &a_scratch, &a_zout, &a_av, &a_bv, &nw, &mpad, &ncols, &rq};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3((unsigned)grid), dim3(kThreads), args,
                                    (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the band height, the shared memory of one block and the int32 scratch of
// one launch, so that the wrapper can check that it agrees with
// ops/matvec.py and size the scratch
int gvamp_gram_band_nw() { return kT; }

int64_t gvamp_gram_smem(int64_t mpad, int64_t nblocks) {
  return prim_smem_bytes(mpad, nblocks);
}

int64_t gvamp_gram_scratch_ints(int64_t ncols) {
  return prim_scratch_ints(ncols);
}

int gvamp_gram_i8a(const void* words, const void* wdig, const void* wsc,
                   const void* cu, const void* na, void* scratch, void* zout,
                   void* av, int64_t nw, int64_t mpad, int64_t ncols,
                   int64_t nblocks, void* stream) {
  return launch_gram_prim<false>(words, wdig, nullptr, wsc, cu, na, scratch,
                                 zout, av, nullptr, nw, mpad, ncols, nblocks,
                                 stream);
}

int gvamp_gram_i8(const void* words, const void* wdig, const void* udig,
                  const void* wsc, const void* na, void* scratch, void* av,
                  void* bv, int64_t nw, int64_t mpad, int64_t ncols,
                  int64_t nblocks, void* stream) {
  return launch_gram_prim<true>(words, wdig, udig, wsc, nullptr, na, scratch,
                                nullptr, av, bv, nw, mpad, ncols, nblocks,
                                stream);
}

}  // extern "C"
