// The bf16-split products of the PyTorch port on bf16 tensor cores, written
// by hand for Hopper (sm_90a): axm_bf16 and atxm_bf16, the products of
// axm_i8 / atxm_i8 with each f32 right-hand side split into three bf16
// parts hi, mid and lo (x ~= hi + mid + lo; _split_hi_lo in ops/matvec.py,
// as gvamp_tpu/ops/matvec.py:115-132).  Bound through the plain C
// interface of gvamp_tpu_torch/ops/_build.py; the wrappers, the operand
// layouts and the plain PyTorch versions are in gvamp_tpu_torch/ops/matvec.py.
//
// Layout as in matvec.cu: words uint32[Nw, Mpad] word-major, byte b of word
// row i holding the codes of planar rows (k, 4i+b), k = bit pair.  A decoded
// a in {0,1,2} or b in {0,1} is exact in bf16 and its product with a bf16
// part is exact in f32, so mma.sync m16n8k16 bf16 x bf16 -> f32 (mma.cuh)
// computes exactly the TPU's bf16 x bf16 -> f32 MXU dots (_axm_kernel /
// _atxm_kernel, gvamp_tpu/ops/matvec.py:319-435); only the order of the f32
// sums differs.  Each part keeps its own sums, and the parts meet as (hi +
// mid) + lo in the wrapper, as the TPU kernels add them.
//
// No byte is converted to float, and no float operation makes the A
// fragments: bf16 bits m below 0x100 (the mantissa and the exponent's
// lowest bit) are the value m 2^-133 (subnormal up to 0x7F, then the first
// binade continues the same line to 0xFF), and the tensor cores take such
// inputs exactly.  So the decoded fields of a word
// (swar.cuh: a in {0, 1, 2} or b in {0, 1} at bits 2k, 2k+1 of each byte)
// masked to plane k in bytes 0 and 2, one LOP3, are a register of two
// bf16 values a 4^k 2^-133, byte 0's in the low half; bytes 1 and 3 the
// same after one shift of the fields by 8.  The wrappers scale each column
// of the right-hand side by a power of two 2^s (exact) that puts its
// largest value just below 2^127, so every product a 4^k 2^(s-133) part
// and every partial sum lies in f32's normal range and rounds exactly as
// the unscaled one; the forward kernel divides each plane's rows by 4^k
// as it writes them, the transpose kernel's right-hand side holds plane k
// times 4^-k, and the wrappers multiply the results by 2^(133-s).  A
// register holds the values of bytes (0, 2) or (1, 3) of a four-value
// group, as the contraction index pairs (2t, 2t+1) and (2t+8, 2t+9); the
// wrappers store each quad of the right-hand side as (0, 2, 1, 3), so the
// B fragment of a lane is 8 contiguous bytes.  (A byte permute per register
// from constant pools with a selector per two codes, or a mask that ORs in
// the exponent of 128 and a bf16x2 fma that takes 128 off again, costs
// about twice the instructions and ran at 10-11 ms on an H100: PERF.md.)
//
// The mma's n holds parts x columns, n = p*CG + c for part p and column c of
// a group of CG columns (CG = 1 at B = 1, else 2; 3 or 6 of the 8 n): at B
// <= 2 the words are read once, above that once per column pair
// (gridDim.z).  The wrapper pads B to whole groups with zero columns.
//
// Sums.  The tensor cores add an mma's products to its C without rounding
// to nearest (they align the terms to the largest and cut the rest), and
// the error of a long chain of mma grows with its length; so each chain
// starts from a zeroed C and runs a fixed number of steps (kFwChain /
// kTxChain, 16 mma per output), and __fadd_rn adds the chain into the
// output's f32 running sum (the forward kernel keeps it in registers, the
// transpose kernel, with twice the sums, in shared memory).  A running sum
// takes at most kMaxChains chains (the part length over gridDim.y), and
// each part writes its own partial rows, which the wrapper sums in a fixed
// order: no float atomics, so the results do not depend on scheduling.  On
// dyadic inputs (multiples of 1/8 in [0, 1]) every partial sum is exact,
// so the kernels equal their plain versions bit for bit whatever the chain
// and the grid.
//
// Every launcher validates its arguments and returns a CUDA error code
// (cudaGetLastError() after the launch); indices are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "swar.cuh"

namespace {

// The bf16 register of plane k of bytes 0 and 2 of decoded fields f, byte
// 0's in the low half: each half is the field at bits 2k, 2k+1, the value
// field 4^k 2^-133
__device__ __forceinline__ uint32_t plane_bits(uint32_t f, int k) {
  return f & (0x00030003u << (2 * k));
}

// The a-fields and b-fields of a word (swar.cuh's swar_a_fields /
// swar_b_fields) in five operations: with notlo = ~lo and t = w >> 1 (the
// high bits at the low bits' places), a = 2 notlo - (notlo & hi) = notlo +
// (notlo & ~hi), a sum that never carries out of its field, and b = hi |
// notlo
__device__ __forceinline__ void decode_fields(uint32_t w, uint32_t& fa,
                                              uint32_t& fb) {
  const uint32_t t = w >> 1;
  fa = (~w & kM5) + (~w & ~t & kM5);
  fb = (~w | t) & kM5;
}

// 4^-k, exact in f32: the forward kernel's factor for the rows of plane k
__device__ __forceinline__ float plane_unscale(int k) {
  return __uint_as_float(0x3F800000u - 0x01000000u * k);
}

constexpr int kThreads = 256;
// chains per running sum: the part length's limit (at most 128 * 16 mma
// per output in one f32 running sum)
constexpr int64_t kMaxChains = 128;

// columns per group: n = p * CG + c
int group_cols(int64_t ncols) { return ncols == 1 ? 1 : 2; }

// __fadd_rn of a chain's C fragments c[j] into the lane's running sums
// sums[32 j] (shared memory, one float4 per fragment, lanes adjacent)
template <int kN>
__device__ __forceinline__ void add_chain(float4* sums,
                                          const float (&c)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float4 v = sums[32 * j];
    v.x = __fadd_rn(v.x, c[j][0]);
    v.y = __fadd_rn(v.y, c[j][1]);
    v.z = __fadd_rn(v.z, c[j][2]);
    v.w = __fadd_rn(v.w, c[j][3]);
    sums[32 * j] = v;
  }
}

template <int kN>
__device__ __forceinline__ void zero_sums(float4* sums) {
#pragma unroll
  for (int j = 0; j < kN; ++j) sums[32 * j] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The ring of a warp's steps in flight: cp.async copies a step's words
// and fragment bytes into shared memory while the warp computes an earlier
// step; bytes past the end are zero-filled (src-size 0).  Each lane reads
// only what it copied itself, so cp.async.wait_group is the only wait.
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The words, read once, bypass L1 (.cg); the fragments, which the other
// warps of the block read too, go through it (.ca).
template <bool kL1>
__device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
  if constexpr (kL1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     shared_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     shared_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this lane's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// --------------------------------------------------------------------------
// axm_bf16: z[c][k][p] = sum over parts, (hi + mid) + lo, of
//   sum_m a_k[m, p] * w_part[m, c] - b_k[m, p] * u_part[m, c]
//
// Replaces axm_pallas / _axm_kernel (gvamp_tpu/ops/matvec.py:319-373):
// words int32[Nw, Mpad], the parts of W and of -U interleaved per marker
// quad as bf16 [G, 3CG, Mpad/4, 2, 4] (row p*CG + c of group z is part p of
// column z*CG + c; a quad's 4 parts of W, then its 4 of -U, each in the
// order 0, 2, 1, 3), f32 [P, G, 3CG, 4, 4*Nw] out, one partial row set per
// part of the markers.
//
// Bound on this card: the one read of the 4*Nw*Mpad bytes of the words
// (10.74 GB at configs B and Bm, 3.21 ms at 3.35 TB/s) for B <= 2; the
// bf16 operations (2 planes x 3 parts x 2*N*Mpad*B) take 0.52 ms per
// column at 989 TFLOP/s.  What holds it on an H100 is issue, not the
// read: per word 16 masks (one per A register), the field decode (5), two
// shifts and two byte permutes (the transpose), about 27 integer
// instructions with the ring's copies and addresses, which at 64 a clock
// and SM take 4.3 ms at config B; and 4 mma.sync per warp and 32 words
// (1.39 ms of tensor work at the dense peak), which add to rather than
// hide under the integer work (PERF.md).
//
// Design: axm_i8_kernel's lane map (fragments.cu), in its shared form: A =
// [a | b] against [w; -u] into one set of sums (negating a bf16 part is
// exact).  A warp owns 8 word rows x the 8 n and walks the markers 64 at a
// time: lane (g, t) takes 16 bytes at markers m+16q+4t (q = 0..3) of word
// row i0+g; transpose_quad turns each into y[b], four markers of person
// 4(i0+g)+b.  m tile 2b+h takes planar row (2h, 4(i0+g)+b) as fragment row
// g and (2h+1, 4(i0+g)+b) as row g+8, so 8 tiles cover the 8 x 16 planar
// rows; the contraction indices (2t, 2t+1) of the mma for load q are
// markers m+16q+4t, +2 and (2t+8, 2t+9) are m+16q+4t+1, +3 (bytes 0, 2 and
// 1, 3 of y[b]).  B fragments: the 16 bytes of row n = g at the quad of
// markers m+16q+4t.. (W's parts for the a-plane, -U's for the b-plane);
// lanes with g >= 3CG copy none, so their columns, never written, hold
// what the slot held.  A step is 8 mma per tile (a- and b-plane, four
// loads), a chain kFwChain steps.  A block holds kFwGroups groups of 8
// word rows; the kFwSplit warps of a group take its steps in turn, reading
// kFwSplit x 256 contiguous bytes of each row at a time, each keeping
// kFwStages of its steps in flight in its ring (4 KB a step); at the end
// they meet in shared memory, added in a fixed order.  Marker steps split
// over gridDim.y (at most kMaxChains chains per warp), column groups over
// gridDim.z.  Markers past Mpad (a multiple of 4) occur only in the last
// step, where they fill as zero words against zero parts; rows past Nw
// read the last one again and are never written.
// --------------------------------------------------------------------------
constexpr int kFwGroups = 2;                          // 8-row groups a block
constexpr int kFwSplit = kThreads / 32 / kFwGroups;   // warps per group
constexpr int kFwLoads = 4;          // 16-byte loads a lane and step
constexpr int kFwStep = 16 * kFwLoads;                // markers per step
constexpr int kFwChain = 2;                           // steps per chain
// steps in the ring, one chain: a chain's slots are compile-time
constexpr int kFwStages = kFwChain;

// one step of one warp in shared memory: the words of its loads, and the
// fragments (W's parts, then -U's) at their marker quads
struct FwSlot {
  uint4 x[kFwLoads][32];
  uint4 f[kFwLoads][32];
};
constexpr int kFwSmem = kFwStages * (kThreads / 32) * (int)sizeof(FwSlot);

// Start copying a step into slot s: the lane's words at xp + 16 q, its
// fragments at fp + 4 q quads.  Only a step that reaches past Mpad (m =
// its first marker) tests its markers, copying zeros past the end.
__device__ __forceinline__ void axm_bf16_fetch(FwSlot& s, int lane,
                                               const uint32_t* xp,
                                               const uint4* fp, bool live,
                                               int m, int mpad) {
  if (m + kFwStep <= mpad) {
#pragma unroll
    for (int q = 0; q < kFwLoads; ++q) {
      copy16<false>(&s.x[q][lane], xp + 16 * q, true);
      if (live) copy16<true>(&s.f[q][lane], fp + 4 * q, true);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kFwLoads; ++q) {
      const bool in = m + 16 * q + 4 * (lane & 3) < mpad;
      copy16<false>(&s.x[q][lane], in ? xp + 16 * q : xp, in);
      if (live) copy16<true>(&s.f[q][lane], in ? fp + 4 * q : fp, in);
    }
  }
}

// One step from slot s into the 8 tiles' C fragments c: per load, the
// a-plane mma against W's parts and the b-plane ones against -U's.  With
// kFirst the first mma into each tile writes its C (a chain's first step).
template <bool kFirst>
__device__ __forceinline__ void axm_bf16_step(const FwSlot& s, int lane,
                                              float c[8][4]) {
#pragma unroll
  for (int q = 0; q < kFwLoads; ++q) {
    const uint4 f = s.f[q][lane];
    const uint32_t bw[2] = {f.x, f.y}, bu[2] = {f.z, f.w};
    uint32_t y[4];
    transpose_quad(s.x[q][lane], y);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // the a-fields and b-fields of markers (0, 2) and, shifted, (1, 3)
      uint32_t fa, fb;
      decode_fields(y[b], fa, fb);
      const uint32_t fa8 = fa >> 8, fb8 = fb >> 8;
      // the a-plane mma of both tiles, then the b-plane ones
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a[4] = {plane_bits(fa, 2 * h),
                               plane_bits(fa, 2 * h + 1),
                               plane_bits(fa8, 2 * h),
                               plane_bits(fa8, 2 * h + 1)};
        if (kFirst && q == 0)
          mma_bf16<true>(c[2 * b + h], a, bw[0], bw[1]);
        else
          mma_bf16(c[2 * b + h], a, bw[0], bw[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a[4] = {plane_bits(fb, 2 * h),
                               plane_bits(fb, 2 * h + 1),
                               plane_bits(fb8, 2 * h),
                               plane_bits(fb8, 2 * h + 1)};
        mma_bf16(c[2 * b + h], a, bu[0], bu[1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
axm_bf16_kernel(const uint32_t* __restrict__ words,  // [Nw, Mpad]
                const uint4* __restrict__ rhs,  // bf16 [G, R, Mpad/4, 2, 4]
                float* __restrict__ out,        // [P, G, R, 4, 4*Nw]
                int64_t nw, int64_t mpad, int rows_n,
                int64_t steps_per_part) {
  // the warps' running sums at the end, [warp][tile][lane] (slots in the
  // float4)
  __shared__ float4 red[kThreads / 32][8][32];
  extern __shared__ uint4 dyn[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int sub = warp % kFwSplit;  // this warp's turn in its group
  const int64_t i0 =
      (int64_t)blockIdx.x * (8 * kFwGroups) + 8 * (warp / kFwSplit);
  const int64_t z = blockIdx.z;
  const int64_t steps = (mpad + kFwStep - 1) / kFwStep;
  const int64_t j0 = (int64_t)blockIdx.y * steps_per_part + sub;
  const int64_t j1 = imin(steps, (int64_t)blockIdx.y * steps_per_part +
                                     steps_per_part);
  // this warp's steps j0, j0 + kFwSplit, ... below j1
  const int own = (i0 < nw && j0 < j1)
                      ? (int)((j1 - j0 + kFwSplit - 1) / kFwSplit)
                      : 0;
  const bool live = g < rows_n;
  // this lane's words and fragments at its first step, j0; word rows past
  // Nw read the last one again: their sums are never written
  int m = (int)(j0 * kFwStep);  // the first marker of the next step fetched
  const uint32_t* xp = words + imin(i0 + g, nw - 1) * mpad + 4 * t + m;
  const uint4* fp =
      rhs + (z * rows_n + (live ? g : 0)) * (mpad / 4) + t + m / 4;
  FwSlot* ring = reinterpret_cast<FwSlot*>(dyn) + warp * kFwStages;
  constexpr int kAdvance = kFwSplit * kFwStep;  // markers between own steps

  float acc[8][4], c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kFwStages - 1; ++i) {
    if (i < own) {
      axm_bf16_fetch(ring[i], lane, xp, fp, live, m, (int)mpad);
      xp += kAdvance;
      fp += kAdvance / 4;
      m += kAdvance;
    }
    copy_commit();
  }
  // chains of kFwChain of the warp's steps, the last one shorter; step
  // ch + j of a chain lies in slot j
#pragma unroll 1
  for (int ch = 0; ch < own; ch += kFwChain) {
#pragma unroll
    for (int j = 0; j < kFwChain; ++j) {
      if (ch + j >= own) break;
      if (ch + j + kFwStages - 1 < own) {
        axm_bf16_fetch(ring[(j + kFwStages - 1) % kFwStages], lane, xp, fp,
                       live, m, (int)mpad);
        xp += kAdvance;
        fp += kAdvance / 4;
        m += kAdvance;
      }
      copy_commit();
      copy_wait<kFwStages - 1>();
      if (j == 0)
        axm_bf16_step<true>(ring[j], lane, c);
      else
        axm_bf16_step<false>(ring[j], lane, c);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], c[j][e]);
  }
  // the group's warps meet in shared memory: warp sub of the group adds
  // tiles 2 sub and 2 sub + 1 of all kFwSplit warps, in warp order
#pragma unroll
  for (int j = 0; j < 8; ++j)
    red[warp][j][lane] = make_float4(acc[j][0], acc[j][1], acc[j][2],
                                     acc[j][3]);
  __syncthreads();
  const int64_t i = i0 + g;
  if (i >= nw) return;  // after the block's only barrier
  const int w0 = warp - sub;
  const int64_t nb = 4 * nw;
  const int64_t part = blockIdx.y;
  const int64_t groups = gridDim.z;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // tile 2 sub + h: b = sub
    float4 v = red[w0][2 * sub + h][lane];
#pragma unroll
    for (int w = 1; w < kFwSplit; ++w) {
      const float4 u = red[w0 + w][2 * sub + h][lane];
      v = make_float4(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y),
                      __fadd_rn(v.z, u.z), __fadd_rn(v.w, u.w));
    }
    // slot 2 half + cc is planar row (2h + half, 4i + b), n = 2t + cc,
    // whose values carry the factor 4^(2h + half)
    const float slot[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e / 2, n = 2 * t + e % 2;
      if (n >= rows_n) continue;
      out[((part * groups + z) * rows_n + n) * 4 * nb + (2 * h + half) * nb +
          4 * i + sub] = __fmul_rn(slot[e], plane_unscale(2 * h + half));
    }
  }
}

// --------------------------------------------------------------------------
// atxm_bf16: (av, bv)[c][m] = sum over parts, (hi + mid) + lo, of
//   sum_{k, p} (a_k, b_k)[m, p] * v_part[k, p, c]
//
// Replaces atxm_pallas / _atxm_kernel (gvamp_tpu/ops/matvec.py:376-435):
// words int32[Nw, Mpad], the parts of V times 4^-k for plane k as bf16
// [G, 3CG, Nw, 4, 4] (row p*CG + c of group z is part p of column z*CG + c;
// per quad of people its 4 planes, each in the order 0, 2, 1, 3), f32 [2,
// P, G, 3CG, Mpad] out (a-plane, then b-plane), one partial row set per
// part of the word rows.
//
// Bound on this card: the one read of the words (3.21 ms at configs B and
// Bm) for B <= 2; the bf16 operations as for axm_bf16.  What holds it is
// issue, as there: per word 16 masks, the field decode and two shifts,
// about 27 integer instructions with the ring's copies and addresses
// (4.3 ms at config B), and 4 mma.sync per warp and 32 words.
//
// Design: atxm_i8_kernel's lane map (fragments.cu): the contraction runs
// over people, with the markers as the mma's m, so one word of one marker
// holds four people of every plane and needs no transpose.  A warp owns 64
// markers (four m tiles) x the 8 n and walks the word rows 8 at a time:
// lane (g, t) takes 16 bytes at each of markers m0+32l+4g (l = 0, 1) of
// word rows i0+t and i0+t+4 (row sets r = 0, 1), so each of the warp's 8
// word rows is read in 128-byte segments; m tile (l, h) takes markers
// m0+32l+4g+2h (fragment row g) and m0+32l+4g+2h+1 (row g+8).  For plane
// k, the mma of row set r takes people 4(i0+t+4r), 4(i0+t+4r)+2 as
// contraction indices (2t, 2t+1) and 4(i0+t+4r)+1, +3 as (2t+8, 2t+9)
// (each quad of people stored as 0, 2, 1, 3); its B fragment is the 8
// bytes of row n = g of V's plane k at those people, shared by the a-plane
// and b-plane mma, as the TPU kernel feeds one vk to both dots; the 4
// planes of a quad are 32 contiguous bytes, two 16-byte copies.  A step is
// 8 mma per tile and plane type (two row sets x 4 planes), a chain
// kTxChain steps, into two sets of 4 tiles x 4 sums.  Each
// warp keeps kTxStages steps in flight in its ring (4 KB a step; the
// fragments of V, the same for every warp of the block, come from L1) and
// owns its outputs.  Word-row steps split over gridDim.y (at most
// kMaxChains chains per part), column groups over gridDim.z.  Markers past
// Mpad (a multiple of 4, so a 16-byte load is all in or all out) are not
// copied and never written; word rows past Nw occur only in the last step,
// where they fill as zero words against zero parts.
// --------------------------------------------------------------------------
constexpr int kTxLoads = 2;  // 16-byte loads per word row and lane in a step
constexpr int kTxWarpMarkers = 32 * kTxLoads;
constexpr int kTxMarkers = kTxWarpMarkers * (kThreads / 32);  // per block
constexpr int kTxChain = 2;  // steps per chain
// steps in the ring, one chain: a chain's slots are compile-time
constexpr int kTxStages = kTxChain;

// one step of one warp in shared memory: the words of both row sets and
// both loads, and the fragments of V's planes (0-1, 2-3) at both row sets'
// people
struct TxSlot {
  uint4 x[2][kTxLoads][32];
  uint4 f[2][2][32];
};
constexpr int kTxSmem = kTxStages * (kThreads / 32) * (int)sizeof(TxSlot);

// Start copying a step into slot s: the lane's words at xp[r] (+32 words
// for the second load), its fragments at fp (+8 for the second row set);
// lanes whose markers lie past Mpad (mk[l] false) copy no words, so those
// rows, never written, hold what the slot held.  Only the last step, whose
// word rows (ir, the first row set's) may reach past Nw, tests them,
// copying zeros past the end.
__device__ __forceinline__ void atxm_bf16_fetch(TxSlot& s, int lane,
                                                const uint32_t* const xp[2],
                                                const uint4* fp, bool live,
                                                const bool mk[kTxLoads],
                                                int64_t ir, int64_t nw) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = ir + 4 * r < nw;
#pragma unroll
    for (int l = 0; l < kTxLoads; ++l)
      if (mk[l])
        copy16<false>(&s.x[r][l][lane], in ? xp[r] + 32 * l : xp[0], in);
    if (live)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        copy16<true>(&s.f[r][e][lane], in ? fp + 8 * r + e : fp, in);
  }
}

// One step from slot s into the C fragments c[0] (a-plane) and c[1]
// (b-plane) of the warp's 4 tiles; kFirst as in axm_bf16_step.
template <bool kFirst>
__device__ __forceinline__ void atxm_bf16_step(const TxSlot& s, int lane,
                                               float c[2][4][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the a-fields and b-fields of the row set's 8 words (markers q of
    // load l): people (0, 2) and, shifted, (1, 3)
    uint32_t fa[kTxLoads][4], fb[kTxLoads][4];
#pragma unroll
    for (int l = 0; l < kTxLoads; ++l) {
      const uint4 x = s.x[r][l][lane];
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) decode_fields(w[q], fa[l][q], fb[l][q]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 fk = s.f[r][k / 2][lane];
      const uint2 f = k % 2 ? make_uint2(fk.z, fk.w) : make_uint2(fk.x, fk.y);
#pragma unroll
      for (int l = 0; l < kTxLoads; ++l)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // m tile (l, h): fragment rows g and g+8 are markers 2h, 2h+1
          const uint32_t a[4] = {plane_bits(fa[l][2 * h], k),
                                 plane_bits(fa[l][2 * h + 1], k),
                                 plane_bits(fa[l][2 * h] >> 8, k),
                                 plane_bits(fa[l][2 * h + 1] >> 8, k)};
          const uint32_t b[4] = {plane_bits(fb[l][2 * h], k),
                                 plane_bits(fb[l][2 * h + 1], k),
                                 plane_bits(fb[l][2 * h] >> 8, k),
                                 plane_bits(fb[l][2 * h + 1] >> 8, k)};
          if (kFirst && r == 0 && k == 0) {
            mma_bf16<true>(c[0][2 * l + h], a, f.x, f.y);
            mma_bf16<true>(c[1][2 * l + h], b, f.x, f.y);
          } else {
            mma_bf16(c[0][2 * l + h], a, f.x, f.y);
            mma_bf16(c[1][2 * l + h], b, f.x, f.y);
          }
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
atxm_bf16_kernel(const uint32_t* __restrict__ words,  // [Nw, Mpad]
                 const uint4* __restrict__ v2,  // bf16 [G, R, Nw, 4, 4]
                 float* __restrict__ out,       // [2, P, G, R, Mpad]
                 int64_t nw, int64_t mpad, int rows_n,
                 int64_t steps_per_part) {
  // the lanes' running sums, [warp][plane type * 4 + tile][lane]
  __shared__ float4 red[kThreads / 32][8][32];
  extern __shared__ uint4 dyn[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t m0 =
      (int64_t)blockIdx.x * kTxMarkers + (int64_t)kTxWarpMarkers * warp;
  if (m0 >= mpad) return;  // no barrier in this kernel
  const int64_t z = blockIdx.z;
  const int64_t steps = (nw + 7) / 8;
  const int64_t i_lo = (int64_t)blockIdx.y * steps_per_part;
  const int own = (int)(imin(steps, i_lo + steps_per_part) - i_lo);
  // this lane's words (markers m0+32l+4g..+3 of word rows 8 i_lo + t and
  // + 4) and fragments (the person quads of those rows) at its first step
  bool mk[kTxLoads];
#pragma unroll
  for (int l = 0; l < kTxLoads; ++l) mk[l] = m0 + 32 * l + 4 * g < mpad;
  const bool live = g < rows_n;
  int64_t ir = 8 * i_lo + t;  // the first row set's word row, next fetch
  const uint32_t* xp[2] = {words + ir * mpad + m0 + 4 * g,
                           words + (ir + 4) * mpad + m0 + 4 * g};
  const uint4* fp = v2 + ((z * rows_n + (live ? g : 0)) * nw + ir) * 2;
  TxSlot* ring = reinterpret_cast<TxSlot*>(dyn) + warp * kTxStages;

  float4* const sums = &red[warp][0][lane];
  zero_sums<8>(sums);
  float c[2][4][4];
  const int64_t advance = 8 * mpad;  // words between steps
#pragma unroll
  for (int i = 0; i < kTxStages - 1; ++i) {
    if (i < own) {
      atxm_bf16_fetch(ring[i], lane, xp, fp, live, mk, ir, nw);
      xp[0] += advance;
      xp[1] += advance;
      fp += 16;
      ir += 8;
    }
    copy_commit();
  }
  // chains of kTxChain steps, the last one shorter; step ch + j of a
  // chain lies in slot j
#pragma unroll 1
  for (int ch = 0; ch < own; ch += kTxChain) {
#pragma unroll
    for (int j = 0; j < kTxChain; ++j) {
      if (ch + j >= own) break;
      if (ch + j + kTxStages - 1 < own) {
        atxm_bf16_fetch(ring[(j + kTxStages - 1) % kTxStages], lane, xp, fp,
                        live, mk, ir, nw);
        xp[0] += advance;
        xp[1] += advance;
        fp += 16;
        ir += 8;
      }
      copy_commit();
      copy_wait<kTxStages - 1>();
      if (j == 0)
        atxm_bf16_step<true>(ring[j], lane, c);
      else
        atxm_bf16_step<false>(ring[j], lane, c);
    }
    add_chain(sums, c[0]);
    add_chain(sums + 32 * 4, c[1]);
  }
  // sums[32 (4p + 2l + h)] slot 2 half + cc is marker m0 + 32l + 4g + 2h +
  // half, n = 2t + cc
  const int64_t parts = gridDim.y, groups = gridDim.z;
#pragma unroll
  for (int lh = 0; lh < 2 * kTxLoads; ++lh)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + 32 * (lh / 2) + 4 * g + 2 * (lh % 2) + half;
      if (m >= mpad) continue;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int n = 2 * t + cc;
        if (n >= rows_n) continue;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float4 v = sums[32 * (4 * p + lh)];
          const float slot[4] = {v.x, v.y, v.z, v.w};
          out[(((p * parts + blockIdx.y) * groups + z) * rows_n + n) * mpad +
              m] = slot[2 * half + cc];
        }
      }
    }
}

// The arguments every launcher refuses: the kernels copy the words and
// the parts 16 bytes at a time, and a marker quad is all in or all out.
bool bad_args(const void* words, const void* rhs, int64_t nw, int64_t mpad,
              int64_t ncols) {
  return nw <= 0 || mpad <= 0 || mpad % 4 != 0 || ncols <= 0 ||
         reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(rhs) % 16 != 0;
}

// The grid of a launch: (rows or marker blocks, parts, column groups) and
// the steps per part, the target's split capped at kMaxChains chains per
// running sum.  Returns a CUDA error.
template <typename Kernel>
int grid_of(Kernel kernel, int smem, int64_t blocks, int64_t steps,
            int64_t ncols, int64_t max_steps, dim3* grid,
            int64_t* per_part) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int64_t target = 0;
  if (const int e = dot_target(kernel, kThreads, smem, &target)) return e;
  const int64_t groups = cdiv(ncols, group_cols(ncols));
  *per_part = imin(part_length(steps, blocks * groups, target), max_steps);
  const int64_t parts = cdiv(steps, *per_part);
  if (parts > 65535 || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)blocks, (unsigned)parts, (unsigned)groups);
  return 0;
}

int axm_grid(int64_t nw, int64_t mpad, int64_t ncols, dim3* grid,
             int64_t* per_part) {
  return grid_of(axm_bf16_kernel, kFwSmem, cdiv(nw, 8 * kFwGroups),
                 cdiv(mpad, kFwStep), ncols, kMaxChains * kFwChain * kFwSplit,
                 grid, per_part);
}

int atxm_grid(int64_t nw, int64_t mpad, int64_t ncols, dim3* grid,
              int64_t* per_part) {
  return grid_of(atxm_bf16_kernel, kTxSmem, cdiv(mpad, kTxMarkers), cdiv(nw, 8),
                 ncols, kMaxChains * kTxChain, grid, per_part);
}

}  // namespace

extern "C" {

// number of marker parts the axm_bf16 launch uses (a negative CUDA error
// on failure): the wrapper sizes its partial output [P, G, 3CG, 4, 4*Nw]
// with it
int64_t gvamp_axm_bf16_parts(int64_t nw, int64_t mpad, int64_t ncols) {
  dim3 grid;
  int64_t per_part = 0;
  if (const int e = axm_grid(nw, mpad, ncols, &grid, &per_part)) return -e;
  return grid.y;
}

// words int32[Nw, Mpad]; rhs the bf16 parts of W and of -U interleaved
// per quad, [G, 3CG, Mpad/4, 2, 4]; out f32 [P, G, 3CG, 4, 4*Nw], every
// entry written
int gvamp_axm_bf16(const void* words, const void* rhs, void* out, int64_t nw,
                   int64_t mpad, int64_t ncols, void* stream) {
  if (bad_args(words, rhs, nw, mpad, ncols)) return (int)cudaErrorInvalidValue;
  dim3 grid;
  int64_t per_part = 0;
  if (const int e = axm_grid(nw, mpad, ncols, &grid, &per_part)) return e;
  axm_bf16_kernel<<<grid, kThreads, kFwSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint4*>(rhs),
      static_cast<float*>(out), nw, mpad, 3 * group_cols(ncols), per_part);
  return (int)cudaGetLastError();
}

// number of word-row parts the atxm_bf16 launch uses (a negative CUDA
// error on failure): the wrapper sizes its partial output [2, P, G, 3CG,
// Mpad] with it
int64_t gvamp_atxm_bf16_parts(int64_t nw, int64_t mpad, int64_t ncols) {
  dim3 grid;
  int64_t per_part = 0;
  if (const int e = atxm_grid(nw, mpad, ncols, &grid, &per_part)) return -e;
  return grid.y;
}

// words int32[Nw, Mpad]; v2 the bf16 parts of V (plane k times 4^-k) as
// [G, 3CG, Nw, 4, 4]; out f32 [2, P, G, 3CG, Mpad], every entry written
int gvamp_atxm_bf16(const void* words, const void* v2, void* out, int64_t nw,
                    int64_t mpad, int64_t ncols, void* stream) {
  if (bad_args(words, v2, nw, mpad, ncols)) return (int)cudaErrorInvalidValue;
  dim3 grid;
  int64_t per_part = 0;
  if (const int e = atxm_grid(nw, mpad, ncols, &grid, &per_part)) return e;
  atxm_bf16_kernel<<<grid, kThreads, kTxSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint4*>(v2),
      static_cast<float*>(out), nw, mpad, 3 * group_cols(ncols), per_part);
  return (int)cudaGetLastError();
}

}  // extern "C"
