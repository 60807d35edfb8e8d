// The fused dual Gram of the XXT solve, written by hand for Hopper (sm_90a):
//   gram_aat_i8a (complete genotypes, the a-plane only):
//     z = A_a W - colsum(mave W),  W = msig2 (A_a^T V - sv mave)
//   gram_aat_i8 (missing calls, both planes):
//     z = A_a W - A_b (mave W),    W = msig2 (A_a^T V - mave A_b^T V)
// in one read of the packed words from HBM for any width B.  Bound through
// the plain C interface of gvamp_tpu_torch/ops/_build.py; the wrappers and
// the plain PyTorch versions (gram_aat_i8a_ref, gram_aat_i8_ref) are in
// gvamp_tpu_torch/ops/matvec.py.
//
// Replaces gram_aat_i8a_pallas / _gram_aat_i8a_kernel and
// gram_aat_i8_pallas / _gram_aat_i8_kernel (gvamp_tpu/ops/matvec.py:
// 1207-1381, 1400-1520), which walk the marker stripes in sequence, take
// each stripe's transpose dots while they copy it into a VMEM stripe cache
// (:1290-1300, 1371-1381), and run the forward dots from that cache.
//
// Numerics (the plain versions repeat every step): per stripe of kGramS
// markers the transpose digit products of V (exact int32) are folded to
// f32, W is formed and requantised into 4 radix-127 digits with one scale
// per stripe and column (W and -mave W share it), the forward digit
// products of those digits (exact int32; both planes summed before the
// fold) are folded with the stripe's scales, and the folded partials of
// the kGramGroup consecutive stripes of a block are added in stripe order
// into the block's slice of zpart.  The wrapper sums the slices with one
// torch.sum.  Every f32 step is a round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, rintf), which nvcc never contracts into
// an FMA, so each rounds as the plain version's separate torch op does and
// the kernel equals its plain version bit for bit.  kGramS and kGramGroup
// are numerics boundaries (GRAM_AAT_STRIPE, GRAM_AAT_GROUP), never sized
// from the card.
//
// Bound on this card: the one read of the 4 Nw Mpad bytes of the words
// (671 MB at config X, N=5,120 x M=524,288: 0.20 ms at 3.35 TB/s); the
// contractions (2 N M 8 int8 operations per side, plane and group of two
// columns) are a tenth of that on the tensor cores.  Each word is decoded
// twice (once per side) and byte-transposed once, as in fragments.cu's two
// digit products, whose loops the two sides follow.
//
// Design: one block takes kGramGroup consecutive stripes, one at a time.
// Per stripe and group of 8 digit rows (two columns of V, 4 digits each;
// B <= 2 is one group):
//   1. Transpose side (fragments.cu's atxm_i8_step lane map): a warp step
//      covers the stripe's 64 markers (four m16n8k32 m tiles, kTxLoads =
//      2 16-byte loads per word row and lane) x 8 word rows (32 people of
//      every plane), the A fragments straight from the SWAR decode
//      (plane64), the B fragments the u32 digits of V.  The 8 warps take
//      the stripe's steps in turn.  In the first digit group each lane
//      loads its words from HBM into registers, contracts them there and
//      stores the raw words into the shared-memory stripe cache; every
//      further digit group re-walks the cache, never HBM.  The warps' sums,
//      shifted back, meet in shared-memory int32 atomics on one [8 digit
//      rows x 64 markers] tile per plane type (exact in any order).
//   2. Fold, W, max, requantise: warp c takes column c of the group, two
//      markers per lane: the digit sums folded (fold4), W (and -mave W),
//      the stripe's max |W| by shuffles, the 4 scales and each marker's 4
//      digits into shared memory.
//   3. Forward side (fragments.cu's axm_i8_step lane map), from the cache:
//      warps take groups of 8 word rows, each two k steps of 32 markers
//      (transpose_quad, then the decode); the B fragments are the stripe's
//      W digits (and -mave W digits against the b-plane, into the same
//      accumulators).  The C fragment spreads a column's 4 digits over
//      lanes t and t^1; one exchange per tile brings them to the lane that
//      owns the planar row, which folds them left to right (fold4) and
//      adds 4 consecutive people as one float4 to the block's partial.
// Three barriers per stripe and digit group.  Shared memory: the cache,
// Nw x kGramS words, and 5,152 bytes of tiles, digits and scales; two
// blocks share an SM (228 KB, 1 KB reserved per block) up to Nw = 431,
// one block holds up to Nw = 887.
// Rows past Nw load as zero words against zero digits (transpose) or
// re-read the last row and are never written (forward); digit rows past
// D = 4B re-read the last valid one and are never written.  The launcher
// validates its arguments and returns a CUDA error code
// (cudaGetLastError() after the launch); indices are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "swar.cuh"

namespace {

constexpr int kGramS = 64;       // markers per stripe (numerics)
constexpr int kGramGroup = 8;    // stripes per block, summed in order (numerics)
constexpr int kGramThreads = 256;
constexpr int kGramWarps = kGramThreads / 32;
constexpr int kTxLoads = kGramS / 32;  // 16-byte loads per word row and lane
constexpr int kTile = 8 * kGramS;      // one [8 digit rows][kGramS] tile
// shared memory after the cache: the transpose sums [2 types][8][kGramS]
// int32, the stripe's digits [2 types][8][kGramS] int8 (W, then -mave W)
// and the scales [2 columns][4] f32
constexpr int64_t kScratchBytes = 4 * 2 * kTile + 2 * kTile + 4 * 2 * 4;
// shared memory a block may use on an H100 (227 KB)
constexpr int64_t kSmemBudget = 232448;

// plane64's factor, as in fragments.cu: the tensor-core sums are 1 <<
// kScaleShift times the true ones, each term at most 64 * 2 * 127
constexpr int kScaleShift = 6;
constexpr int64_t kScaledTerm = (2 << kScaleShift) * 127;
// The scaled transpose sum of a whole column, 16 Nw terms, stays inside
// int32 for every Nw the budget admits, so one warp's share of the steps
// needs no part limit; the forward side sums 64 markers of both planes.
constexpr int64_t kMaxNw = (kSmemBudget - kScratchBytes) / (4 * kGramS);
static_assert(16 * kMaxNw * kScaledTerm < INT32_MAX, "transpose sums");
static_assert(kGramS * (kScaledTerm + kScaledTerm / 2) < INT32_MAX,
              "forward sums");

int64_t gram_smem_bytes(int64_t nw) { return 4 * kGramS * nw + kScratchBytes; }

// The stripe cache: row r holds the stripe's kGramS words of word row r, as
// 16 16-byte chunks, chunk q stored at q ^ swz(r).  A 16-byte access is
// served per quarter warp, conflict-free when its 8 lanes hit 8 distinct
// chunk positions mod 8 (the 32 banks).  The transpose side's quarter warp
// (g in {2p, 2p+1}, t = 0..3) touches rows 8s+t, chunks 8l+g: with swz(r)
// = 0, 4, 2, 6 for r = 0..3 mod 4, g ^ swz(r) takes 8 values.  The forward
// side's (rows 8s+g, chunks 8k+4u+t) touches two rows whose swz differ in
// bit 2, so (4u | t) ^ swz fills one half of the 8 positions for one row
// and the other half for the other.  A padded row instead needs a pitch of
// 8 mod 32 words for the first and 16 mod 32 for the second; the swizzle
// needs no padding, so the cache takes 256 bytes per word row.
__device__ __forceinline__ int swz(int64_t r) {
  return (int)(((r & 1) << 2) | (r & 2));
}

__device__ __forceinline__ uint4* chunk(uint32_t* cache, int64_t r, int q) {
  return reinterpret_cast<uint4*>(cache + r * kGramS) + (q ^ swz(r));
}

// Position of (digit row n, marker m) in a transpose-sum tile: the marker
// index is XORed with (n / 2) % 4, so that the atomics of one instruction
// (n = 2t + c, m = 4g + const) fall on 32 distinct banks.
__device__ __forceinline__ int tile_at(int n, int m) {
  return n * kGramS + (m ^ ((n >> 1) & 3));
}

// One transpose step of 8 word rows from word row 8st: lane (g, t) takes
// the 16-byte chunks 8l+g (markers 32l+4g..+3 of the stripe) of word rows
// ia = 8st+t and ib = ia+4, from HBM through `stripe` (kLoad, storing them
// into the cache) or from the cache, and contracts the decodes of each
// plane k against the u32 digits of digit row g at people 4ia and 4ib
// (`vp`, plane k at k * plane_bytes): acc[0] for the a-plane and, with
// kBoth, acc[1] for the b-plane.  With kMasked, word rows past Nw load as
// zero words against zero digits and are not stored.
template <bool kMasked, bool kLoad, bool kBoth>
__device__ __forceinline__ void tx_step(const uint32_t* stripe,
                                        uint32_t* cache, const uint8_t* vp,
                                        int64_t plane_bytes, int64_t nw,
                                        int64_t mpad, int64_t st,
                                        int32_t acc[][2 * kTxLoads][4]) {
  constexpr int kTypes = kBoth ? 2 : 1;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int64_t ia = 8 * st + t, ib = ia + 4;
  const bool la = !kMasked || ia < nw, lb = !kMasked || ib < nw;
  uint4 xa[kTxLoads], xb[kTxLoads];
#pragma unroll
  for (int l = 0; l < kTxLoads; ++l) {
    const int q = 8 * l + g;
    if constexpr (kLoad) {
      xa[l] = la ? __ldg(reinterpret_cast<const uint4*>(stripe + ia * mpad) + q)
                 : zero4();
      xb[l] = lb ? __ldg(reinterpret_cast<const uint4*>(stripe + ib * mpad) + q)
                 : zero4();
    } else {
      xa[l] = la ? *chunk(cache, ia, q) : zero4();
      xb[l] = lb ? *chunk(cache, ib, q) : zero4();
    }
  }
  if constexpr (kLoad) {
#pragma unroll
    for (int l = 0; l < kTxLoads; ++l) {
      if (la) *chunk(cache, ia, 8 * l + g) = xa[l];
      if (lb) *chunk(cache, ib, 8 * l + g) = xb[l];
    }
  }
  // the a-fields (fa[0], fb[0]) and b-fields (fa[1], fb[1]) of rows ia, ib
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

// The transpose side of one stripe and digit group: the warp's steps
// (warp, warp + kGramWarps, ...; the partial last step masked), then its
// sums, shifted back, added into the tiles `tsum` (one per plane type).
template <bool kLoad, bool kBoth>
__device__ __forceinline__ void tx_side(const uint32_t* stripe,
                                        uint32_t* cache, const uint8_t* vp,
                                        int64_t plane_bytes, int64_t nw,
                                        int64_t mpad, int32_t* tsum) {
  constexpr int kTypes = kBoth ? 2 : 1;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  int32_t acc[kTypes][2 * kTxLoads][4];
#pragma unroll
  for (int p = 0; p < kTypes; ++p)
#pragma unroll
    for (int h = 0; h < 2 * kTxLoads; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][h][c] = 0;
  const int64_t full = nw / 8;
  int64_t st = warp;
#pragma unroll 2
  for (; st < full; st += kGramWarps)
    tx_step<false, kLoad, kBoth>(stripe, cache, vp, plane_bytes, nw, mpad, st,
                                 acc);
  if (st == full && full * 8 < nw)
    tx_step<true, kLoad, kBoth>(stripe, cache, vp, plane_bytes, nw, mpad, st,
                                acc);
  // acc[p][2l + h][2*half + c] is marker 32l + 4g + 2h + half, digit row
  // 2t + c
#pragma unroll
  for (int lh = 0; lh < 2 * kTxLoads; ++lh)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int at = tile_at(2 * t + c,
                               32 * (lh / 2) + 4 * g + 2 * (lh % 2) + half);
#pragma unroll
        for (int p = 0; p < kTypes; ++p)
          atomicAdd(tsum + p * kTile + at, acc[p][lh][2 * half + c] >> kScaleShift);
      }
}

// The forward side's k step ks (markers 32ks..32ks+31 of the stripe) of
// cache row r: lane (g, t) reads chunks 8ks+t and 8ks+4+t, transposes them
// into four people's marker quads, decodes the planes and contracts them
// into the 8 tiles of acc against the B fragments dig[p][ks] (W's digits
// for the a-plane, -mave W's for the b-plane, both into acc).
template <bool kBoth>
__device__ __forceinline__ void fw_step(uint32_t* cache, int64_t r, int ks,
                                        const uint32_t dig[][2][2],
                                        int32_t acc[8][4]) {
  constexpr int kTypes = kBoth ? 2 : 1;
  const int t = threadIdx.x & 3;
  uint32_t y0[4], y1[4];
  transpose_quad(*chunk(cache, r, 8 * ks + t), y0);
  transpose_quad(*chunk(cache, r, 8 * ks + 4 + t), y1);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    uint32_t f0[kTypes], f1[kTypes];
    f0[0] = swar_a_fields(y0[b]);
    f1[0] = swar_a_fields(y1[b]);
    if constexpr (kBoth) {
      f0[1] = swar_b_fields(y0[b]);
      f1[1] = swar_b_fields(y1[b]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < kTypes; ++p) {
        // planes 2h (fragment row g) and 2h+1 (row g+8) of person byte b
        const uint32_t a[4] = {plane64(f0[p], 2 * h), plane64(f0[p], 2 * h + 1),
                               plane64(f1[p], 2 * h), plane64(f1[p], 2 * h + 1)};
        mma_u8s8(acc[2 * b + h], a, dig[p][ks][0], dig[p][ks][1]);
      }
  }
}

template <bool kBoth>
__global__ void __launch_bounds__(kGramThreads, 2)
gram_aat_kernel(const uint32_t* __restrict__ words,  // [Nw, Mpad]
                const uint8_t* __restrict__ vdig,    // [4][4B][4 Nw], row 4b+d
                const float* __restrict__ vsc,       // [4][B] scales of V's digits
                const float* __restrict__ sv,        // [B] colsum(V) (a-only)
                const float* __restrict__ mave,      // [Mpad]
                const float* __restrict__ msig2,     // [Mpad]
                float* __restrict__ zpart,           // [nJ/G][B][4][4 Nw]
                float* __restrict__ wout,            // [B][Mpad] (a-only)
                int64_t nw, int64_t mpad, int64_t ncols) {
  constexpr int kTypes = kBoth ? 2 : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* cache = smem;                                             // [Nw][kGramS]
  int32_t* tsum = reinterpret_cast<int32_t*>(cache + nw * kGramS);   // [2][kTile]
  int8_t* dig8 = reinterpret_cast<int8_t*>(tsum + 2 * kTile);         // [2][kTile]
  float* scs = reinterpret_cast<float*>(dig8 + 2 * kTile);            // [2][4]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t nb = 4 * nw;
  const int64_t d_total = 4 * ncols;
  const int64_t plane_bytes = d_total * nb;
  const int64_t groups = (ncols + 1) / 2;
  const int64_t steps = (nw + 7) / 8;
  const int64_t jg = blockIdx.x;
  const int64_t j_lo = jg * kGramGroup;
  const int64_t j_hi = imin(mpad / kGramS, j_lo + kGramGroup);
  for (int i = threadIdx.x; i < 2 * kTile; i += kGramThreads) tsum[i] = 0;

  for (int64_t j = j_lo; j < j_hi; ++j) {
    const int64_t m0 = j * kGramS;
    for (int64_t dg = 0; dg < groups; ++dg) {
      // the previous forward side is done with the cache, digits and scales
      __syncthreads();
      // 1. transpose side, digit rows 8dg..8dg+7 (past D: the last one)
      const uint8_t* vp = vdig + imin(8 * dg + g, d_total - 1) * nb;
      if (dg == 0)
        tx_side<true, kBoth>(words + m0, cache, vp, plane_bytes, nw, mpad, tsum);
      else
        tx_side<false, kBoth>(words + m0, cache, vp, plane_bytes, nw, mpad, tsum);
      __syncthreads();

      // 2. warp c: column 2dg + c, markers lane and lane + 32
      if (warp < 2) {
        const int64_t b = 2 * dg + warp;
        const int64_t bc = imin(b, ncols - 1);  // past B: never written
        const float s[4] = {vsc[bc], vsc[ncols + bc], vsc[2 * ncols + bc],
                            vsc[3 * ncols + bc]};
        float wv[2], uv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mm = lane + 32 * e;
          const int64_t m = m0 + mm;
          int32_t ta[4], tb[4];
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int at = tile_at(4 * warp + d, mm);
            ta[d] = tsum[at];
            tsum[at] = 0;
            if constexpr (kBoth) {
              tb[d] = tsum[kTile + at];
              tsum[kTile + at] = 0;
            }
          }
          const float av = fold4(ta, s);
          if constexpr (kBoth) {
            const float bv = fold4(tb, s);
            wv[e] = __fmul_rn(msig2[m], __fsub_rn(av, __fmul_rn(mave[m], bv)));
            uv[e] = __fmul_rn(-mave[m], wv[e]);
          } else {
            wv[e] = __fmul_rn(msig2[m], __fsub_rn(av, __fmul_rn(sv[bc], mave[m])));
            uv[e] = 0.f;
            if (b < ncols) wout[b * mpad + m] = wv[e];
          }
        }
        float mx = fmaxf(fmaxf(fabsf(wv[0]), fabsf(uv[0])),
                         fmaxf(fabsf(wv[1]), fabsf(uv[1])));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sc[4];
        sc[0] = __fdiv_rn(mx == 0.f ? 1.f : mx, 127.f);
#pragma unroll
        for (int d = 1; d < 4; ++d) sc[d] = __fdiv_rn(sc[d - 1], 127.f);
        if (lane == 0) {
#pragma unroll
          for (int d = 0; d < 4; ++d) scs[4 * warp + d] = sc[d];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mm = lane + 32 * e;
          float r = wv[e], ru = uv[e];
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int n = 4 * warp + d;
            const float dw = rintf(__fdiv_rn(r, sc[d]));
            dig8[n * kGramS + mm] = (int8_t)(int)dw;
            r = __fsub_rn(r, __fmul_rn(dw, sc[d]));
            if constexpr (kBoth) {
              const float du = rintf(__fdiv_rn(ru, sc[d]));
              dig8[kTile + n * kGramS + mm] = (int8_t)(int)du;
              ru = __fsub_rn(ru, __fmul_rn(du, sc[d]));
            }
          }
        }
      }
      __syncthreads();

      // 3. forward side: B fragments, digit row g at markers 32ks + 4t and
      // 32ks + 16 + 4t; this lane folds column 2dg + t/2
      uint32_t dig[kTypes][2][2];
#pragma unroll
      for (int p = 0; p < kTypes; ++p)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            dig[p][ks][u] = *reinterpret_cast<const uint32_t*>(
                dig8 + p * kTile + g * kGramS + 32 * ks + 16 * u + 4 * t);
      const int cl = t >> 1;
      const bool odd = t & 1;
      const float s[4] = {scs[4 * cl], scs[4 * cl + 1], scs[4 * cl + 2],
                          scs[4 * cl + 3]};
      const int64_t b = 2 * dg + cl;
      for (int64_t grp = warp; grp < steps; grp += kGramWarps) {
        const int64_t i = 8 * grp + g;
        int32_t acc[8][4];
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[q][c] = 0;
        fw_step<kBoth>(cache, imin(i, nw - 1), 0, dig, acc);
        fw_step<kBoth>(cache, imin(i, nw - 1), 1, dig, acc);
        // acc[2b' + h][2*half + c], shifted back, is planar row (2h + half,
        // 4i + b'), digit row 2t + c: digits 2(t&1) + c of column t/2.  The
        // even lane owns half 0, the odd one half 1; each sends the partner
        // its digits of the partner's half.
        float z[2][4];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int32_t a[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) a[c] = acc[2 * bb + h][c] >> kScaleShift;
            const int32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
            const int32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
            const int32_t o0 = odd ? a[2] : a[0], o1 = odd ? a[3] : a[1];
            const int32_t td[4] = {odd ? r0 : o0, odd ? r1 : o1,
                                   odd ? o0 : r0, odd ? o1 : r1};
            z[h][bb] = fold4(td, s);
          }
        if (i >= nw || b >= ncols) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t k = 2 * h + (odd ? 1 : 0);
          float4* dst = reinterpret_cast<float4*>(
              zpart + ((jg * ncols + b) * 4 + k) * nb + 4 * i);
          float4 v = make_float4(z[h][0], z[h][1], z[h][2], z[h][3]);
          if (j != j_lo) {
            const float4 o = *dst;
            v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y),
                            __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
          }
          *dst = v;
        }
      }
    }
  }
}

// words int32[Nw, Mpad], vdig int8[4, 4B, 4 Nw] (row 4b + d), vsc f32[4, B],
// sv f32[B] (a-only), mave / msig2 f32[Mpad], zpart f32[nJ/G, B, 4, 4 Nw],
// wout f32[B, Mpad] (a-only)
template <bool kBoth>
int launch_gram_aat(const void* words, const void* vdig, const void* vsc,
                    const void* sv, const void* mave, const void* msig2,
                    void* zpart, void* wout, int64_t nw, int64_t mpad,
                    int64_t ncols, void* stream) {
  if (nw <= 0 || mpad <= 0 || mpad % kGramS != 0 || ncols <= 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(zpart) % 16 != 0 ||
      gram_smem_bytes(nw) > kSmemBudget)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = gram_smem_bytes(nw);
  cudaError_t err = cudaFuncSetAttribute(
      gram_aat_kernel<kBoth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gram_aat_kernel<kBoth>
      <<<(unsigned)cdiv(mpad / kGramS, kGramGroup), kGramThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(words), static_cast<const uint8_t*>(vdig),
          static_cast<const float*>(vsc), static_cast<const float*>(sv),
          static_cast<const float*>(mave), static_cast<const float*>(msig2),
          static_cast<float*>(zpart), static_cast<float*>(wout), nw, mpad,
          ncols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the stripe width, the stripes per block and the shared memory of one
// block, so that the wrapper can check that it agrees with ops/matvec.py
int gvamp_gram_aat_stripe() { return kGramS; }

int gvamp_gram_aat_group() { return kGramGroup; }

int64_t gvamp_gram_aat_smem(int64_t nw) { return gram_smem_bytes(nw); }

int gvamp_gram_aat_i8a(const void* words, const void* vdig, const void* vsc,
                       const void* sv, const void* mave, const void* msig2,
                       void* zpart, void* wout, int64_t nw, int64_t mpad,
                       int64_t ncols, void* stream) {
  return launch_gram_aat<false>(words, vdig, vsc, sv, mave, msig2, zpart,
                                wout, nw, mpad, ncols, stream);
}

int gvamp_gram_aat_i8(const void* words, const void* vdig, const void* vsc,
                      const void* mave, const void* msig2, void* zpart,
                      int64_t nw, int64_t mpad, int64_t ncols, void* stream) {
  return launch_gram_aat<true>(words, vdig, vsc, nullptr, mave, msig2, zpart,
                               nullptr, nw, mpad, ncols, stream);
}

}  // extern "C"
