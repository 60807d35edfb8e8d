// Packed-genotype products of the PyTorch port whose tensor-core fragments
// come straight from the SWAR decode, written by hand for Hopper (sm_90a):
// the five digit products, axm_i8 and atxm_i8 on genotypes with missing
// calls (both planes, a and b), axm_i8a and atxm_i8a on complete genotypes
// (the a-plane only), and axm_i8s, the forward product whose two planes
// share one digit scale and one int32 sum.  Bound through the plain C
// interface of gvamp_tpu_torch/ops/_build.py; the wrappers, their
// quantisation and fold and the plain PyTorch versions are in
// gvamp_tpu_torch/ops/matvec.py.
//
// Layout as in matvec.cu: words uint32[Nw, Mpad] word-major, byte b of word row
// i holding the codes of planar rows (k, 4i+b).  The digit contract
// (gvamp_tpu/ops/matvec.py:441-512): the right-hand sides arrive as radix-127
// int8 digit rows, quantised and later folded back to f32 by the wrapper, and
// the kernels return exact int32 contractions, |sum| <= 254*K for a contraction
// of length K (381*K for the shared sum; the wrappers keep it below 2^31).
// Integer addition is exact in any order, so the results equal the plain
// versions bit for bit whatever the grid or the order of the atomics.
//
// Each direction is one loop with a compile-time form: the transpose loop has a
// plane count (kBoth), the forward loop a form (kOnePlane, kTwoPlanes,
// kShared).  The one-plane form is the two-plane one without the b-fields,
// their accumulators, digit loads, mma and atomics; the shared form is the
// two-plane one with the b-plane's mma added into the a-plane's accumulators.
// So the contracts share every lane map and cannot drift apart.  The kernels
// read every packed word once per group of 8 digit rows (the mma's n), for both
// planes together where there are two: once at B <= 2 (D <= 8 digit rows),
// ceil(D/8) times in all.  A word's a-fields (and b-fields, swar.cuh) give,
// plane by plane, registers of four values that are the A fragments of mma.sync
// m16n8k32 (mma.cuh) as they stand; there is no shared memory and no barrier.
// Each plane goes to the top two bits of its bytes (plane64: 64 times its
// value, u8 x s8 products), which costs the integer pipe a mask and leaves the
// shift to the multiply-add pipe; the sums are then 64 times the true ones,
// exact in int32 while a part of the contraction stays under kTxMaxSteps /
// kFwMaxSteps / kFwSharedMaxSteps steps, and each part is shifted back before
// it is added to the output.  Each lane loads 16-byte pieces of its rows so
// that a row is read in 128-byte segments per step, the width at which the
// register-direct study kernels (study.cu) ran near the read.
// Digit groups of 8 rows spread over gridDim.z, the walk along the
// contraction over gridDim.y; parts meet in atomicAdd on the zeroed output.
// Rows past the end and digit rows past D re-read the last valid one and
// are never written.  Every launcher validates its arguments and returns a
// CUDA error code (cudaGetLastError() after the launch); indices are
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "swar.cuh"

namespace {

// plane64's factor: the kernels' sums are 1 << kScaleShift times the true
// ones, and each term is at most 64 * 2 * 127 in magnitude
constexpr int kScaleShift = 6;
constexpr int64_t kScaledTerm = (2 << kScaleShift) * 127;

// --------------------------------------------------------------------------
// atxm_i8: (av, bv)[d][m] = sum_{k, p} (a_k, b_k)[m, p] * vdig[k][d][p]
// atxm_i8a: av[d][m] = sum_{k, p} a_k[m, p] * vdig[k][d][p]
//
// Replace atxm_i8_pallas / _atxm_i8_kernel (gvamp_tpu/ops/matvec.py:651-677,
// 704), the transpose product on genotypes with missing calls, and
// atxm_i8a_pallas / _atxm_i8a_kernel (:1560, 1581), its a-plane form on
// complete genotypes: words int32[Nw, Mpad], the digits of V transposed to
// int8[4, D, 4*Nw] (matvec._quant_digits_t), one quantisation for both
// planes, int32[D, Mpad] out per plane, |sum| <= 254*16*Nw.
//
// Bound on this card: the one read of the 4*Nw*Mpad bytes of the words
// (10.74 GB at configs B and Bm, 3.21 ms at 3.35 TB/s) for D <= 8; the
// decode of both planes, about 12.5 instructions per word on the integer
// pipe and 8.5 on the multiply-add pipe (the loop's SASS on an H100),
// takes each a little under that read, the a-plane alone less; the
// contraction (2*16*Nw*Mpad*8 int8 operations per plane and digit group)
// takes a tenth of it per plane on the tensor cores.
//
// Design: v8_atxm_vt's (study.cu), with the b-plane beside the a-plane in
// the two-plane form.  The contraction runs over people, with the markers
// as the mma's m: one word of one marker, decoded for plane k, holds the
// values of people 4i..4i+3 in byte order, one register of an A fragment
// (row = marker, column = person), with no transpose; four consecutive
// people of one digit row are one aligned u32 of the [4, D, 4*Nw] digits,
// one register of the B fragment.  A warp owns 64 markers (four m tiles) x
// 8 digit rows and walks the word rows 8 at a time (32 people of every
// plane per mma): lane (g, t) loads 16 bytes at each of markers m0+32l+4g
// (l = 0, 1) of word rows i0+t and i0+t+4, so each of the warp's 8 word
// rows is read in 128-byte segments; m tile (l, h) takes markers
// m0+32l+4g+2h (fragment row g) and m0+32l+4g+2h+1 (row g+8).  Each word is
// decoded once into a-fields (and b-fields); for plane k both take the
// same B fragment (the u32 of digit row d0+g at people 4(i0+t) and
// 4(i0+t+4)), as the TPU kernel feeds one vt to both dots.  The four
// planes accumulate into the same C fragments, one set per plane type: 4
// tiles x 4 = 16 int32 per lane and type.  The warps of a block walk the
// same word rows, so they share the digit loads in L1.  Word-row steps
// split over gridDim.y, in parts of at most kTxMaxSteps (the scaled sums'
// limit), and digit groups of 8 rows over gridDim.z: the grid reads each
// word once per digit group, ceil(D/8) times.  Markers past Mpad (a
// multiple of 4, so a 16-byte load is all in or all out) re-read the last
// valid ones; word rows past Nw occur only in the last step, whose masked
// form loads them as zero words against zero digits.
// --------------------------------------------------------------------------
constexpr int kTxThreads = 256;
constexpr int kTxLoads = 2;  // 16-byte loads per word row and lane in a step
constexpr int kTxWarpMarkers = 32 * kTxLoads;
constexpr int kTxMarkers = kTxWarpMarkers * (kTxThreads / 32);  // per block
// steps per part that keep a part's scaled sum in int32: 128 terms (4
// planes x 32 people) per step and output, in either form (each output
// sums one plane type)
constexpr int64_t kTxMaxSteps = INT32_MAX / (128 * kScaledTerm);

// One step of 8 word rows (32 people of every plane) from word row 8*st:
// lane (g, t) loads its markers' words (16 bytes at each of wp[l]) of rows
// 8st+t and 8st+t+4 and, for each plane, the digits of those people in its
// digit row, and contracts the decodes into the m tiles' C fragments,
// acc[0] for the a-plane and, with kBoth, acc[1] for the b-plane.  With
// kMasked, word rows past Nw load as zero words against zero digits.
template <bool kMasked, bool kBoth>
__device__ __forceinline__ void atxm_i8_step(const uint32_t* const wp[],
                                             const uint8_t* vp,
                                             int64_t plane_bytes, int64_t nw,
                                             int64_t mpad, int64_t st,
                                             int32_t acc[][2 * kTxLoads][4]) {
  constexpr int kTypes = kBoth ? 2 : 1;
  const int t = threadIdx.x & 3;
  const int64_t ia = 8 * st + t, ib = ia + 4;  // word rows of a0/a1, a2/a3
  const bool la = !kMasked || ia < nw, lb = !kMasked || ib < nw;
  uint4 xa[kTxLoads], xb[kTxLoads];
#pragma unroll
  for (int l = 0; l < kTxLoads; ++l) {
    xa[l] = la ? __ldg(reinterpret_cast<const uint4*>(wp[l] + ia * mpad))
               : zero4();
    xb[l] = lb ? __ldg(reinterpret_cast<const uint4*>(wp[l] + ib * mpad))
               : zero4();
  }
  // the a-fields (fa[0], fb[0]) and b-fields (fa[1], fb[1]) of rows ia
  // and ib
  uint32_t fa[kTypes][kTxLoads][4], fb[kTypes][kTxLoads][4];
#pragma unroll
  for (int l = 0; l < kTxLoads; ++l) {
    const uint32_t wa[4] = {xa[l].x, xa[l].y, xa[l].z, xa[l].w};
    const uint32_t wb[4] = {xb[l].x, xb[l].y, xb[l].z, xb[l].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      fa[0][l][q] = swar_a_fields(wa[q]);
      fb[0][l][q] = swar_a_fields(wb[q]);
      if constexpr (kBoth) {
        fa[1][l][q] = swar_b_fields(wa[q]);
        fb[1][l][q] = swar_b_fields(wb[q]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint8_t* v = vp + k * plane_bytes;
    const uint32_t b0 =
        la ? __ldg(reinterpret_cast<const uint32_t*>(v + 4 * ia)) : 0u;
    const uint32_t b1 =
        lb ? __ldg(reinterpret_cast<const uint32_t*>(v + 4 * ib)) : 0u;
#pragma unroll
    for (int l = 0; l < kTxLoads; ++l)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < kTypes; ++p) {
          const uint32_t a[4] = {plane64(fa[p][l][2 * h], k),
                                 plane64(fa[p][l][2 * h + 1], k),
                                 plane64(fb[p][l][2 * h], k),
                                 plane64(fb[p][l][2 * h + 1], k)};
          mma_u8s8(acc[p][2 * l + h], a, b0, b1);
        }
  }
}

template <bool kBoth>
__global__ void __launch_bounds__(kTxThreads)
atxm_i8_kernel(const uint32_t* __restrict__ words,  // [Nw, Mpad]
               const uint8_t* __restrict__ vdig,    // [4, D, 4*Nw]
               int32_t* __restrict__ out_a,         // [D, Mpad]
               int32_t* __restrict__ out_b,         // [D, Mpad], kBoth
               int64_t nw, int64_t mpad, int64_t d_total,
               int64_t steps_per_part) {
  constexpr int kTypes = kBoth ? 2 : 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t m0 =
      (int64_t)blockIdx.x * kTxMarkers + (int64_t)kTxWarpMarkers * warp;
  if (m0 >= mpad) return;  // no barrier in this kernel
  const int64_t d0 = (int64_t)blockIdx.z * 8;
  const int64_t nb = 4 * nw;
  const int64_t steps = (nw + 7) / 8;
  const int64_t i_lo = (int64_t)blockIdx.y * steps_per_part;
  const int64_t i_hi = imin(steps, i_lo + steps_per_part);
  // this lane's markers m0+32l+4g..+3; markers past Mpad and digit rows
  // past D read the last valid ones again: their sums are never written
  const uint32_t* wp[kTxLoads];
#pragma unroll
  for (int l = 0; l < kTxLoads; ++l)
    wp[l] = words + imin(m0 + 32 * l + 4 * g, mpad - 4);
  // digit row d0+g of plane 0; plane k is k*D*Nb bytes on
  const uint8_t* vp = vdig + imin(d0 + g, d_total - 1) * nb;
  const int64_t plane_bytes = d_total * nb;

  int32_t acc[kTypes][2 * kTxLoads][4];
#pragma unroll
  for (int p = 0; p < kTypes; ++p)
#pragma unroll
    for (int h = 0; h < 2 * kTxLoads; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][h][c] = 0;

  // whole steps with unmasked loads, so that the compiler issues the loads
  // of the unrolled steps together; then the partial last step
  const int64_t sf = imin(i_hi, nw / 8);
#pragma unroll 2
  for (int64_t st = i_lo; st < sf; ++st)
    atxm_i8_step<false, kBoth>(wp, vp, plane_bytes, nw, mpad, st, acc);
  if (sf < i_hi)
    atxm_i8_step<true, kBoth>(wp, vp, plane_bytes, nw, mpad, sf, acc);
  // acc[p][2l + h][2*half + c] is marker m0 + 32l + 4g + 2h + half, digit
  // row d0 + 2t + c
  int32_t* const out[2] = {out_a, out_b};
#pragma unroll
  for (int lh = 0; lh < 2 * kTxLoads; ++lh)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + 32 * (lh / 2) + 4 * g + 2 * (lh % 2) + half;
      if (m >= mpad) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t d = d0 + 2 * t + c;
        if (d >= d_total) continue;
        const int64_t o = d * mpad + m;
#pragma unroll
        for (int p = 0; p < kTypes; ++p)
          atomicAdd(out[p] + o, acc[p][lh][2 * half + c] >> kScaleShift);
      }
    }
}

// --------------------------------------------------------------------------
// axm_i8: (za, zb)[d][k][p] = sum_m (a_k[m, p] * wdig[d][m],
//                                   b_k[m, p] * udig[d][m])
// axm_i8a: za[d][k][p] = sum_m a_k[m, p] * wdig[d][m]
// axm_i8s: zt[d][k][p] = sum_m a_k[m, p] * wdig[d][m]
//                              + b_k[m, p] * mudig[d][m]
//
// Replace axm_i8_pallas / _axm_i8_kernel (gvamp_tpu/ops/matvec.py:514-536,
// 539), the forward product on genotypes with missing calls, and
// axm_i8a_pallas / _axm_i8a_kernel and _axm_i8a_wide_kernel (:755-841, 797;
// the TPU's orientation switch at D > 64 has no counterpart here), its
// a-plane form on complete genotypes: words int32[Nw, Mpad], the digits of W
// (and of U) int8[D, Mpad] each under its own scales (matvec._quant_rows),
// so the a-plane and b-plane products stay apart: int32[D, 4, 4*Nw] out per
// plane, |sum| <= 254*Mpad.  And axm_i8s_pallas / _axm_i8s_kernel (:580-601,
// 618), the shared-scale form: the digits of W and of -U under ONE scale per
// column (matvec._quant_digits_pair), both planes' products in one int32[D,
// 4, 4*Nw] sum that the wrapper folds once, |sum| <= (2*127 + 127)*Mpad =
// 381*Mpad.
//
// Bound on this card: the one read of the words (3.21 ms at configs B and
// Bm) for D <= 8.  On top of it each word costs two byte permutes (the
// transpose below) and the decode of both planes: about 15 instructions on
// the integer pipe and 8 on the multiply-add pipe (the loop's SASS on an
// H100), each near the read's time, the a-plane alone less; the
// contraction is a tenth of it per plane on the tensor cores.
//
// Design: the contraction runs along the markers, the fast axis of the
// words, so one register of four markers of one planar row needs the byte
// transpose (transpose_quad).  A warp owns 8 word rows x 8 digit rows and
// walks the markers 32 at a time (the mma's k): lane (g, t) loads 16 bytes
// at each of markers m+4t and m+16+4t of word row i0+g (64 contiguous bytes
// of each row per load instruction).  transpose_quad turns each load into
// y[b], four markers of person 4(i0+g)+b, decoded into a-fields (and
// b-fields).  A word row holds 16 planar rows (b, k); m tile 2b+h takes row
// (2h, 4(i0+g)+b) as fragment row g and (2h+1, 4(i0+g)+b) as row g+8, so 8
// tiles cover the 8 x 16 planar rows, with contraction index 4t+j = marker
// m+4t+j and 16+4t+j = marker m+16+4t+j.  B fragments: the u32 of digit row
// d0+g at markers m+4t and m+16+4t, of W for the a-plane tiles and of U (-U
// in the shared form) for the b-plane ones.  8 mma per step and plane type,
// 8 tiles x 4 = 32 int32 per lane and sum: the two-plane form keeps a set
// per plane type, the shared form adds both planes' mma into one set, so it
// holds half the sums and makes half the atomics.  Its two mma per tile
// and step depend on each other, a chain the two-plane form does not
// have; the shared form covers it with more warps: its one set fits 64
// registers, 4 blocks (32 warps) per SM, it takes one step per loop
// iteration, and every form issues a step's a-plane mma before its
// b-plane ones.  (With 80 registers, 3 blocks per SM, two steps per
// iteration and a tile's two mma back to back, the shared form ran slower
// than the two-plane one on an H100.)  A block holds kFwGroups
// groups of 8 word rows; the kFwSplit warps of a group take its steps in
// turn (warp s of the group steps j0+s, j0+s+kFwSplit, ...), so that
// together they read kFwSplit x 128 contiguous bytes of each row at a time
// and share the digit loads in L1; they meet in atomicAdd on the output.
// (One warp per 8 rows, each row read in 128-byte pieces far apart, ran
// slower on an H100.)  Marker steps split over gridDim.y, in parts of at
// most kFwMaxSteps (kFwSharedMaxSteps in the shared form), and digit groups
// of 8 rows over gridDim.z: the grid reads each word once per digit group,
// ceil(D/8) times.  Whole steps load unmasked; markers past Mpad (a multiple
// of 4) occur only in the last step, whose masked form loads them as zero
// words against zero digits.
// --------------------------------------------------------------------------
constexpr int kFwThreads = 256;
constexpr int kFwGroups = 2;  // groups of 8 word rows per block
constexpr int kFwSplit = kFwThreads / 32 / kFwGroups;  // warps per group
constexpr int kFwStep = 32;  // markers per step
// the forward loop's forms: the a-plane alone (axm_i8a), both planes into
// sums of their own (axm_i8), both planes into one sum (axm_i8s)
constexpr int kOnePlane = 0;
constexpr int kTwoPlanes = 1;
constexpr int kShared = 2;
// steps per part that keep a part's scaled sum in int32: 32 terms (32
// markers) per step and output, each at most kScaledTerm where an output
// sums one plane type (each warp of a group sums a kFwSplit-th of them, so
// its own sum keeps room) and 64 * (2*127 + 127) where it sums both
constexpr int64_t kFwMaxSteps = INT32_MAX / (32 * kScaledTerm);
constexpr int64_t kSharedTerm = (3 << kScaleShift) * 127;
constexpr int64_t kFwSharedMaxSteps = INT32_MAX / (32 * kSharedTerm);

// decodes (plane types) and sets of sums of each form
template <int kForm>
constexpr int kFwPlanes = kForm == kOnePlane ? 1 : 2;
template <int kForm>
constexpr int kFwSums = kForm == kTwoPlanes ? 2 : 1;

// One step of 32 markers from marker m: lane (g, t) loads 16 bytes at m+4t
// and m+16+4t of its word row and of its digit rows of W (and, with two
// planes, of U or -U; the row pointers carry the 4t), decodes the planes
// and contracts them into the 8 tiles of acc[0] (a-plane against W) and
// acc[1] (b-plane against U) or, in the shared form, both into acc[0].
// With kMasked, markers past Mpad (m >= lane_mpad) load as zero words
// against zero digits.
template <bool kMasked, int kForm>
__device__ __forceinline__ void axm_i8_step(const uint32_t* row,
                                            const uint8_t* wd,
                                            const uint8_t* ud, int64_t m,
                                            int64_t lane_mpad,
                                            int32_t acc[][8][4]) {
  constexpr int kTypes = kFwPlanes<kForm>;
  const bool l0 = !kMasked || m < lane_mpad;
  const bool l1 = !kMasked || m + 16 < lane_mpad;
  const uint4 x0 =
      l0 ? __ldg(reinterpret_cast<const uint4*>(row + m)) : zero4();
  const uint4 x1 =
      l1 ? __ldg(reinterpret_cast<const uint4*>(row + m + 16)) : zero4();
  // dig[p]: the B fragment of plane type p, W's digits then U's
  uint32_t dig[kTypes][2];
  dig[0][0] = l0 ? __ldg(reinterpret_cast<const uint32_t*>(wd + m)) : 0u;
  dig[0][1] = l1 ? __ldg(reinterpret_cast<const uint32_t*>(wd + m + 16)) : 0u;
  if constexpr (kTypes == 2) {
    dig[1][0] = l0 ? __ldg(reinterpret_cast<const uint32_t*>(ud + m)) : 0u;
    dig[1][1] =
        l1 ? __ldg(reinterpret_cast<const uint32_t*>(ud + m + 16)) : 0u;
  }
  uint32_t y0[4], y1[4];
  transpose_quad(x0, y0);
  transpose_quad(x1, y1);
  // the a-fields (f0[b][0], f1[b][0]) and b-fields (f0[b][1], f1[b][1]) of
  // y0[b], y1[b]
  uint32_t f0[4][kTypes], f1[4][kTypes];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f0[b][0] = swar_a_fields(y0[b]);
    f1[b][0] = swar_a_fields(y1[b]);
    if constexpr (kTypes == 2) {
      f0[b][1] = swar_b_fields(y0[b]);
      f1[b][1] = swar_b_fields(y1[b]);
    }
  }
  // the a-plane's 8 mma, then the b-plane's: in the shared form each
  // b-plane mma adds to the tile its a-plane mma has just written, 8 mma
  // later rather than at once
#pragma unroll
  for (int p = 0; p < kTypes; ++p)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // planes 2h (fragment row g) and 2h+1 (row g+8) of person byte b
        const uint32_t a[4] = {plane64(f0[b][p], 2 * h),
                               plane64(f0[b][p], 2 * h + 1),
                               plane64(f1[b][p], 2 * h),
                               plane64(f1[b][p], 2 * h + 1)};
        mma_u8s8(acc[kForm == kShared ? 0 : p][2 * b + h], a, dig[p][0],
                 dig[p][1]);
      }
}

// Compiled for 4 resident blocks per SM (64 registers) in the forms with
// one set of sums, 2 in the two-plane form with its two sets.
template <int kForm>
__global__ void __launch_bounds__(kFwThreads, kForm == kTwoPlanes ? 2 : 4)
axm_i8_kernel(const uint32_t* __restrict__ words,  // [Nw, Mpad]
              const uint8_t* __restrict__ wdig,    // [D, Mpad]
              const uint8_t* __restrict__ udig,    // [D, Mpad], two planes
              int32_t* __restrict__ out_a,         // [D, 4, 4*Nw]
              int32_t* __restrict__ out_b,         // [D, 4, 4*Nw], kTwoPlanes
              int64_t nw, int64_t mpad, int64_t d_total,
              int64_t steps_per_part) {
  constexpr int kSums = kFwSums<kForm>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int sub = warp % kFwSplit;  // this warp's turn in its group
  const int64_t i0 =
      (int64_t)blockIdx.x * (8 * kFwGroups) + 8 * (warp / kFwSplit);
  if (i0 >= nw) return;  // no barrier in this kernel
  const int64_t d0 = (int64_t)blockIdx.z * 8;
  const int64_t steps = (mpad + kFwStep - 1) / kFwStep;
  const int64_t j0 = (int64_t)blockIdx.y * steps_per_part;
  const int64_t j1 = imin(steps, j0 + steps_per_part);
  // word rows past Nw and digit rows past D read the last one again: their
  // sums are never written
  const uint32_t* row = words + imin(i0 + g, nw - 1) * mpad + 4 * t;
  const int64_t dr = imin(d0 + g, d_total - 1) * mpad + 4 * t;
  const uint8_t* wd = wdig + dr;
  const uint8_t* ud = kForm == kOnePlane ? nullptr : udig + dr;
  const int64_t lane_mpad = mpad - 4 * t;

  int32_t acc[kSums][8][4];
#pragma unroll
  for (int p = 0; p < kSums; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][j][c] = 0;

  // whole steps with unmasked loads, then the partial last step, each
  // taken by the group's warp whose turn it is
  const int64_t jf = imin(j1, mpad / kFwStep);
  if constexpr (kForm == kShared) {
#pragma unroll 1
    for (int64_t j = j0 + sub; j < jf; j += kFwSplit)
      axm_i8_step<false, kForm>(row, wd, ud, j * kFwStep, lane_mpad, acc);
  } else {
#pragma unroll 2
    for (int64_t j = j0 + sub; j < jf; j += kFwSplit)
      axm_i8_step<false, kForm>(row, wd, ud, j * kFwStep, lane_mpad, acc);
  }
  if (jf < j1 && (jf - j0) % kFwSplit == sub)
    axm_i8_step<true, kForm>(row, wd, ud, jf * kFwStep, lane_mpad, acc);
  // acc[p][2b + h][2*half + c] is planar row (2h + half, 4(i0 + g) + b),
  // digit row d0 + 2t + c
  const int64_t i = i0 + g;
  if (i >= nw) return;
  const int64_t nb = 4 * nw;
  int32_t* const out[2] = {out_a, out_b};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int64_t d = d0 + 2 * t + c;
    if (d >= d_total) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t o = (d * 4 + 2 * h + half) * nb + 4 * i + b;
#pragma unroll
          for (int p = 0; p < kSums; ++p)
            atomicAdd(out[p] + o,
                      acc[p][2 * b + h][2 * half + c] >> kScaleShift);
        }
  }
}

// The arguments every launcher refuses: the kernels load the words 16
// bytes at a time and a marker quad is all in or all out.
bool bad_args(const void* words, int64_t nw, int64_t mpad, int64_t d_total) {
  return nw <= 0 || mpad <= 0 || mpad % 4 != 0 || d_total <= 0 ||
         reinterpret_cast<uintptr_t>(words) % 16 != 0;
}

// words int32[Nw, Mpad], vdig int8[4, D, 4*Nw], out_a (and, with kBoth,
// out_b) int32[D, Mpad], zeroed
template <bool kBoth>
int launch_atxm(const void* words, const void* vdig, void* out_a,
                void* out_b, int64_t nw, int64_t mpad, int64_t d_total,
                void* stream) {
  if (bad_args(words, nw, mpad, d_total)) return (int)cudaErrorInvalidValue;
  int64_t target = 0;
  if (const int e =
          dot_target(atxm_i8_kernel<kBoth>, kTxThreads, 0, &target))
    return e;
  const int64_t cols = cdiv(mpad, kTxMarkers), groups = cdiv(d_total, 8);
  const int64_t steps = cdiv(nw, 8);
  const int64_t per_part =
      imin(part_length(steps, cols * groups, target), kTxMaxSteps);
  const dim3 grid((unsigned)cols, (unsigned)cdiv(steps, per_part),
                  (unsigned)groups);
  atxm_i8_kernel<kBoth>
      <<<grid, kTxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(words),
          static_cast<const uint8_t*>(vdig), static_cast<int32_t*>(out_a),
          static_cast<int32_t*>(out_b), nw, mpad, d_total, per_part);
  return (int)cudaGetLastError();
}

// words int32[Nw, Mpad], wdig (and, with two planes, udig) int8[D, Mpad],
// out_a (and, with kTwoPlanes, out_b) int32[D, 4, 4*Nw], zeroed
template <int kForm>
int launch_axm(const void* words, const void* wdig, const void* udig,
               void* out_a, void* out_b, int64_t nw, int64_t mpad,
               int64_t d_total, void* stream) {
  if (bad_args(words, nw, mpad, d_total)) return (int)cudaErrorInvalidValue;
  int64_t target = 0;
  if (const int e = dot_target(axm_i8_kernel<kForm>, kFwThreads, 0, &target))
    return e;
  const int64_t rows = cdiv(nw, 8 * kFwGroups), groups = cdiv(d_total, 8);
  const int64_t steps = cdiv(mpad, kFwStep);
  const int64_t per_part =
      imin(part_length(steps, rows * groups, target),
           kForm == kShared ? kFwSharedMaxSteps : kFwMaxSteps);
  const dim3 grid((unsigned)rows, (unsigned)cdiv(steps, per_part),
                  (unsigned)groups);
  axm_i8_kernel<kForm>
      <<<grid, kFwThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(words),
          static_cast<const uint8_t*>(wdig),
          static_cast<const uint8_t*>(udig), static_cast<int32_t*>(out_a),
          static_cast<int32_t*>(out_b), nw, mpad, d_total, per_part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// words int32[Nw, Mpad], vdig int8[4, D, 4*Nw], out_a / out_b int32[D,
// Mpad], zeroed
int gvamp_atxm_i8(const void* words, const void* vdig, void* out_a,
                  void* out_b, int64_t nw, int64_t mpad, int64_t d_total,
                  void* stream) {
  return launch_atxm<true>(words, vdig, out_a, out_b, nw, mpad, d_total,
                           stream);
}

// the a-plane only: out int32[D, Mpad], zeroed
int gvamp_atxm_i8a(const void* words, const void* vdig, void* out,
                   int64_t nw, int64_t mpad, int64_t d_total, void* stream) {
  return launch_atxm<false>(words, vdig, out, nullptr, nw, mpad, d_total,
                            stream);
}

// words int32[Nw, Mpad], wdig / udig int8[D, Mpad], out_a / out_b
// int32[D, 4, 4*Nw], zeroed
int gvamp_axm_i8(const void* words, const void* wdig, const void* udig,
                 void* out_a, void* out_b, int64_t nw, int64_t mpad,
                 int64_t d_total, void* stream) {
  return launch_axm<kTwoPlanes>(words, wdig, udig, out_a, out_b, nw, mpad,
                                d_total, stream);
}

// the a-plane only: wdig int8[D, Mpad], out int32[D, 4, 4*Nw], zeroed
int gvamp_axm_i8a(const void* words, const void* wdig, void* out, int64_t nw,
                  int64_t mpad, int64_t d_total, void* stream) {
  return launch_axm<kOnePlane>(words, wdig, nullptr, out, nullptr, nw, mpad,
                               d_total, stream);
}

// the shared form: wdig / mudig int8[D, Mpad] (the digits of W and of -U
// at one scale per column), out int32[D, 4, 4*Nw], zeroed
int gvamp_axm_i8s(const void* words, const void* wdig, const void* mudig,
                  void* out, int64_t nw, int64_t mpad, int64_t d_total,
                  void* stream) {
  return launch_axm<kShared>(words, wdig, mudig, out, nullptr, nw, mpad,
                             d_total, stream);
}

}  // extern "C"
