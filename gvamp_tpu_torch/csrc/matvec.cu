// Packed-genotype products of the PyTorch port, written by hand for Hopper
// (sm_90a), apart from the five digit products axm_i8a, atxm_i8a, axm_i8,
// atxm_i8 and axm_i8s, whose tensor-core kernels are in fragments.cu, the
// bf16-split products axm_bf16 and atxm_bf16 (bf16_split.cu), the fused
// dual Grams gram_aat_i8a and gram_aat_i8 (gram_aat.cu) and the fused
// primal Grams gram_i8a and gram_i8 (gram_prim.cu).  Bound
// through a plain C interface (ctypes, see gvamp_tpu_torch/ops/_build.py);
// the wrappers are in gvamp_tpu_torch/ops/matvec.py, beside the plain
// PyTorch versions the kernels are checked against.
//
// Layout (gvamp_tpu/ops/layout.py): words are uint32[Nw, Mpad], word-major,
// 16 samples per word.  Byte b of word-row i holds the four 2-bit codes of
// planar rows (k, 4i+b), k = bit pair.  The SWAR decode of plane k turns a
// word into a u32 whose byte b is the dosage {2,0,1,0}[code] of row 4i+b,
// which is exactly the byte order of four int8 digits packed into one
// int32.
//
// The kernels here are the f32 products of one right-hand-side column, atx,
// atx_a and ax (the digit products, which contract radix-127 int8 digits
// exactly in int32, are in fragments.cu; the bf16-split products, on bf16
// tensor cores, in bf16_split.cu).  They convert no byte to float: they
// look up sums of the right-hand side, built per word row (atx, atx_a) or
// per marker pair (ax) into shared memory, with a nibble of the words as
// the index.  Each block writes its own partial rows, which the wrapper
// sums in a fixed order, so the results do not depend on scheduling.
//
// Every launch returns cudaGetLastError(), and the wrapper raises on a
// non-zero code.  A kernel allocates nothing: the wrapper passes the
// outputs.  Indices are 64-bit: a full-size matrix holds more than 2^31
// words.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "mma.cuh"
#include "swar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks to aim for: several waves of 132 SMs at 8 resident blocks each
constexpr int64_t kTargetBlocks = 132 * 8 * 4;

// Split `n` rows (or quads) into bands so that `other` blocks times the band
// count reaches kTargetBlocks; returns the band length, a multiple of `unit`.
int64_t band_length(int64_t n, int64_t other, int64_t unit) {
  const int64_t max_bands = cdiv(n, unit);
  int64_t bands = cdiv(kTargetBlocks, other > 0 ? other : 1);
  if (bands < 1) bands = 1;
  if (bands > max_bands) bands = max_bands;
  return cdiv(cdiv(n, bands), unit) * unit;
}

// The f32 sum of four values in the fixed tree (x0 + x1) + (x2 + x3).
__device__ __forceinline__ float tree4(const float* x) {
  return __fadd_rn(__fadd_rn(x[0], x[1]), __fadd_rn(x[2], x[3]));
}

// --------------------------------------------------------------------------
// atx:   (av[m], bv[m]) = sum_{k, p} (a_k, b_k)[m, p] * v[k, p] in f32
// atx_a: av[m] alone
//
// One template on the plane count: atx_kernel<true> replaces atx_pallas /
// _atx_kernel (gvamp_tpu/ops/matvec.py:266, 287), which runs once at load
// for the completeness check (GenoBed.geno_complete); atx_kernel<false>
// replaces atx_a_pallas / _atx_a_kernel (gvamp_tpu/ops/matvec.py:1523-1540),
// atx without the b-side, which the caller takes as sum(v) on complete
// genotypes.
// Bound on this card: one read of the packed bytes (3.21 ms at config B).
// A loop that turns every decoded byte into a float spends 16 conversions
// per word and plane on a pipe of 16 per clock and SM: near 11 ms per
// plane at config B, the pace of the loop this design replaced.
// Design: no conversion per element.  Each byte b of word row i holds
// planes 0-3 of person 4i+b, its low nibble planes 0 and 1, its high
// nibble planes 2 and 3.  For each word row of a tile of kAtxRows the
// block builds in shared memory the a-side pair tables
//   T[r][2b + h][c] = dose(c & 3) v[2h][4i+b] + dose(c >> 2) v[2h+1][4i+b]
// for the 16 nibbles c (dose = {2, 0, 1, 0}[code], one f32 rounding), 128
// floats per word row, so that a word's a-side product is 8 table lookups.
// The nibble times 4 is byte b of (w << 2) & 0x3C3C3C3C (h = 0) or of
// (w >> 2) & 0x3C3C3C3C (h = 1); one __byte_perm puts it under the row's
// table offset (a multiple of 256), so a lookup is one permute and one
// shared load, with the table's place in the row an immediate offset.
// The two-plane form adds the b-side tables
//   Tb[r][b][c] = (c0 v[0][4i+b] + c1 v[1][4i+b])
//                 + (c2 v[2][4i+b] + c3 v[3][4i+b])
// over the 16 values c of the non-missing bits c_k of person 4i+b's four
// codes (64 more floats per word row, 48 KB double-buffered).  The bits are
// the low bits of swar_b_fields(w), gathered into the index times 4 by two
// shifts and masks: 4 lookups per word, 12 in all.  A warp's lanes look up
// one 16-entry table at once, which lies in 16 banks: no bank conflict.  A
// thread takes 4 markers with one 16-byte load per word row (a warp reads
// 512 contiguous bytes of each row); per word and side the lookups meet in
// a fixed f32 tree (a-side ((T00 + T01) + (T10 + T11)) + ((T20 + T21) +
// (T30 + T31)), Tbh: byte b, nibble h; b-side (Tb0 + Tb1) + (Tb2 + Tb3))
// and one double add: the word-row sums meet in double (an f32 running sum
// over 64 rows errs 7.6e-7 of the largest entry on Gaussian v, beyond the
// 5e-7 that gvamp_tpu_torch/tools/kernel_check.py holds every kernel to).
// The tables are double-buffered: the block builds tile t+1's while it
// reads tile t's, one barrier per tile.  Row bands of whole tiles spread
// over gridDim.y and write their own partial rows; the wrapper sums the
// partials in a fixed order.  On dyadic v (multiples of 1/8) every table
// entry and sum is exact, so the result equals the plain version's bit
// for bit; on v = 1 the b-side counts the non-missing calls exactly.
// --------------------------------------------------------------------------
constexpr int kAtxRows = 32;                 // word rows per table tile
constexpr int kAtxTable = 128;               // a-side floats per word row
constexpr int kAtxTableAB = kAtxTable + 64;  // with the b-side's 4 x 16
constexpr int kAtxMarkers = 4 * kThreads;    // markers per block

template <bool kBoth>
constexpr int kAtxTableFloats = kBoth ? kAtxTableAB : kAtxTable;

// Tile rows [0, rows) from word row i0: entry (r, f) of the tables, f =
// 16 j + c: j < 8 the a-side's table 2b + h, j >= 8 the b-side's of byte
// j - 8.
template <bool kBoth>
__device__ __forceinline__ void atx_table(
    const float* __restrict__ v, int64_t nb, int64_t i0, int rows,
    float (*tab)[kAtxTableFloats<kBoth>]) {
  constexpr int kTable = kAtxTableFloats<kBoth>;
  for (int e = threadIdx.x; e < rows * kTable; e += kThreads) {
    const int r = e / kTable, f = e % kTable, j = f / 16, c = f % 16;
    const int64_t p0 = 4 * (i0 + r);
    float x;
    if (j < 8) {
      const int b = j >> 1, h = j & 1;
      const float v0 = __ldg(v + 2 * h * nb + p0 + b);
      const float v1 = __ldg(v + (2 * h + 1) * nb + p0 + b);
      // dose {2, 0, 1, 0}[code] of the nibble's two codes
      const float d0 = (c & 1) ? 0.f : ((c & 2) ? 1.f : 2.f);
      const float d1 = (c & 4) ? 0.f : ((c & 8) ? 1.f : 2.f);
      x = __fadd_rn(__fmul_rn(d0, v0), __fmul_rn(d1, v1));
    } else {
      const int64_t p = p0 + (j - 8);
      const float s01 = __fadd_rn((c & 1) ? __ldg(v + p) : 0.f,
                                  (c & 2) ? __ldg(v + nb + p) : 0.f);
      const float s23 = __fadd_rn((c & 4) ? __ldg(v + 2 * nb + p) : 0.f,
                                  (c & 8) ? __ldg(v + 3 * nb + p) : 0.f);
      x = __fadd_rn(s01, s23);
    }
    tab[r][f] = x;
  }
}

// The a-side product of one word against its row's tables at byte offset
// `off` of the tile (a multiple of 256): 8 lookups, summed in a fixed tree.
__device__ __forceinline__ float atx_a_word(uint32_t w, uint32_t off,
                                            const char* tab) {
  const uint32_t lo = (w << 2) & 0x3C3C3C3Cu;  // 4 x nibble 0 of each byte
  const uint32_t hi = (w >> 2) & 0x3C3C3C3Cu;  // 4 x nibble 1
  float t[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // off with its low byte replaced by byte b of lo / hi
    const uint32_t i_lo = __byte_perm(lo, off, 0x7650 + b);
    const uint32_t i_hi = __byte_perm(hi, off, 0x7650 + b);
    t[b] = __fadd_rn(
        *reinterpret_cast<const float*>(tab + i_lo + 64 * (2 * b)),
        *reinterpret_cast<const float*>(tab + i_hi + 64 * (2 * b + 1)));
  }
  return tree4(t);
}

// The b-side product of one word: byte b of x is 4 times the index c_0 +
// 2 c_1 + 4 c_2 + 8 c_3 of its non-missing bits; 4 lookups, a fixed tree.
__device__ __forceinline__ float atx_b_word(uint32_t w, uint32_t off,
                                            const char* tab) {
  uint32_t x = swar_b_fields(w);     // c_k at bit 2k of each byte
  x = (x | (x >> 1)) & 0x33333333u;  // c_0, c_1 at bits 0, 1; c_2, c_3 at 4, 5
  x = ((x << 2) | x) & 0x3C3C3C3Cu;  // c_0 .. c_3 at bits 2-5
  float t[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    t[b] = *reinterpret_cast<const float*>(
        tab + __byte_perm(x, off, 0x7650 + b) + 4 * kAtxTable + 64 * b);
  return tree4(t);
}

template <bool kBoth>
__global__ void __launch_bounds__(kThreads)
atx_kernel(const uint32_t* __restrict__ words,
           const float* __restrict__ v,  // [4, 4*Nw]
           float* __restrict__ out,      // [1 + kBoth, bands, Mpad]
           int64_t nw, int64_t mpad, int64_t rows_per_band) {
  constexpr int kTable = kAtxTableFloats<kBoth>;
  __shared__ __align__(1024) float tab[2][kAtxRows][kTable];
  const int64_t m = (int64_t)blockIdx.x * kAtxMarkers + 4 * threadIdx.x;
  const bool live = m < mpad;  // Mpad is a multiple of 4
  const int64_t nb = 4 * nw;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_band;
  const int64_t r_end = imin(nw, r_begin + rows_per_band);
  const int tiles = (int)((r_end - r_begin + kAtxRows - 1) / kAtxRows);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  double accb[4] = {0.0, 0.0, 0.0, 0.0};
  atx_table<kBoth>(v, nb, r_begin, (int)imin(kAtxRows, r_end - r_begin),
                   tab[0]);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int64_t t0 = r_begin + (int64_t)t * kAtxRows;
    // the next tile's tables into the other buffer, whose last readers
    // passed the barrier that closed tile t-1
    if (t + 1 < tiles)
      atx_table<kBoth>(v, nb, t0 + kAtxRows,
                       (int)imin(kAtxRows, r_end - t0 - kAtxRows),
                       tab[(t + 1) & 1]);
    if (live) {
      const int rows = (int)imin(kAtxRows, r_end - t0);
      const uint4* col = reinterpret_cast<const uint4*>(words + t0 * mpad + m);
      const int64_t stride = mpad / 4;  // uint4 per word row
      const char* tb = reinterpret_cast<const char*>(tab[t & 1]);
      // one word: its sides' trees into the double sums of marker q
      auto word = [&](uint32_t w, uint32_t off, int q) {
        acc[q] += (double)atx_a_word(w, off, tb);
        if constexpr (kBoth) accb[q] += (double)atx_b_word(w, off, tb);
      };
      int r = 0;
      for (; r + 4 <= rows; r += 4) {
        uint4 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = __ldg(col + (r + u) * stride);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t off = (uint32_t)(r + u) * (4 * kTable);
          word(x[u].x, off, 0);
          word(x[u].y, off, 1);
          word(x[u].z, off, 2);
          word(x[u].w, off, 3);
        }
      }
      for (; r < rows; ++r) {
        const uint4 x = __ldg(col + r * stride);
        const uint32_t off = (uint32_t)r * (4 * kTable);
        word(x.x, off, 0);
        word(x.y, off, 1);
        word(x.z, off, 2);
        word(x.w, off, 3);
      }
    }
    __syncthreads();
  }
  if (live) {
    *reinterpret_cast<float4*>(out + (int64_t)blockIdx.y * mpad + m) =
        make_float4((float)acc[0], (float)acc[1], (float)acc[2],
                    (float)acc[3]);
    if constexpr (kBoth)
      *reinterpret_cast<float4*>(
          out + ((int64_t)gridDim.y + blockIdx.y) * mpad + m) =
          make_float4((float)accb[0], (float)accb[1], (float)accb[2],
                      (float)accb[3]);
  }
}

int64_t atx_rows_per_band(int64_t nw, int64_t mpad) {
  return band_length(nw, cdiv(mpad, kAtxMarkers), kAtxRows);
}

template <bool kBoth>
int atx_launch(const void* words, const void* v, void* out, int64_t nw,
               int64_t mpad, void* stream) {
  if (nw <= 0 || mpad <= 0 || mpad % 4 != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = atx_rows_per_band(nw, mpad);
  const dim3 grid((unsigned)cdiv(mpad, kAtxMarkers), (unsigned)cdiv(nw, rows),
                  1);
  atx_kernel<kBoth><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(v),
      static_cast<float*>(out), nw, mpad, rows);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// ax: z[k][p] = sum_m a_k[m, p] * w[m] - b_k[m, p] * u[m] in f32
//
// Replaces ax_pallas / _ax_kernel (gvamp_tpu/ops/matvec.py:225-263).  It
// runs twice at set-up, for the people statistics of the dual solve
// (GenoBed.compute_people_statistics).  Bound on this card: one read of
// the packed bytes (0.20 ms at config X); a loop that converts each
// decoded byte and multiplies it spends 32 conversions and 32 FMAs per
// word, the pace of the loop this design replaced.
// Design: the sum runs over markers, so the tables are per marker pair and
// serve every word row.  Per marker t_m[code] = a w - b u = {2w - u, 0,
// w - u, -u}[code] (one f32 rounding), per pair (m, m+1) the table
//   T[c] = t_m[c & 3] + t_{m+1}[c >> 2]
// over the 16 nibbles c.  Two words of a row give the 16 codes of a pair:
//   (w_m & 0x33333333) | ((w_{m+1} << 2) & 0xCCCCCCCC)
// holds in byte b the nibbles of planes 0 (low) and 2 (high) of person
// 4i+b, ((w_m >> 2) & 0x33333333) | (w_{m+1} & 0xCCCCCCCC) those of planes
// 1 and 3; the nibble times 4 goes under the tables' shared-memory address
// by one __byte_perm and the pair's place is the load's immediate offset,
// so a lookup is one permute and one shared load: 8 per word, no
// conversion.  A block takes kAxRows = 16 word rows, two lanes of each
// warp per row; its 8 warps take the steps of kAxStep = 32 markers (128
// bytes of a row) of the block's marker band in turn.  Lane (r, h) loads
// the 16-byte pieces 2q + h (q = 0..3) of row r's step, so one load of the
// warp reads 32 contiguous bytes of each of 16 rows (reading 16 bytes of
// each of 32 rows per load ran 17% slower), and it loads the next step's
// words and pairs while it looks up this step's.  The two lanes of a row
// look up two tables at once, which lie in the two halves of the banks
// (bit 6 of the address, set in the index for h = 1): no bank conflict.
// Each warp builds its own step's 16 tables (lane l the 8 entries 8(l & 1)
// .. of pair l >> 1; double-buffered per warp: one __syncwarp per step).
// Per output (plane k, byte b) a lane's 8 lookups of a step meet in a
// fixed f32 tree, ((T0 + T1) + (T2 + T3)) + ((T4 + T5) + (T6 + T7)), then
// in a double running sum; at the end the sums of a row's 16 lanes (8
// warps x 2) meet in double in (warp, h) order through shared memory (the
// tables' space, half the outputs at a time) and round once to the block's
// f32 partial row.  The marker bands are sized so that the blocks fill the
// card once (two per SM) where the rows leave room, and no shorter than
// kAxMinBand markers, which keeps the partial rows below 0.4% of the
// words' bytes; the wrapper sums them in a fixed order.  Words beyond Mpad
// read as code 01 (missing), whose entry is 0.  On dyadic w and u every
// entry and sum is exact, so the result equals the plain version's bit for
// bit.
// --------------------------------------------------------------------------
constexpr int kAxPairs = 8;                   // marker pairs per lane and step
constexpr int kAxStep = 4 * kAxPairs;         // markers per step of a row
constexpr int kAxTable = 256;                 // floats per table buffer
constexpr int kAxRows = 16;                   // word rows per block
constexpr int kAxBlocksPerSm = 2;
constexpr int64_t kAxResident = 132 * kAxBlocksPerSm;
constexpr int64_t kAxMinBand = 4096;          // markers
constexpr uint32_t kMissingWord = 0x55555555u;  // 16 codes 01
// a buffer holds a step's 16 tables; after the loop the buffers hold half
// the lanes' sums
static_assert(32 * kAxPairs <= kAxTable && kThreads == 8 * 32 &&
                  kWarps * 2 * kAxTable * sizeof(float) ==
                      8 * kWarps * 32 * sizeof(double),
              "ax_kernel's buffers");

// One step's operands of a lane: its 16 words (lane-local pair j is words
// 2j, 2j + 1) and the (w, u) of the pair whose tables it builds.
struct AxStep {
  uint32_t x[2 * kAxPairs];
  float2 w, u;
};

// Lane (r, h) = (lane >> 1, lane & 1): the 16-byte pieces 2q + h of its
// row's step from marker m0 (words past Mpad read as code 01) and the
// (w, u) of the step's pair p = lane >> 1 (zero past Mpad; a pair lies
// whole below Mpad, a multiple of 4).  Nothing is loaded for a step at or
// past the band's end.
__device__ __forceinline__ void ax_load(const uint32_t* __restrict__ wrow,
                                        const float2* __restrict__ w2,
                                        const float2* __restrict__ u2,
                                        int64_t m0, int64_t m_end,
                                        int64_t mpad, int lane, AxStep& st) {
  if (m0 >= m_end) return;
  const int h = lane & 1;
  const uint4* src = reinterpret_cast<const uint4*>(wrow + m0) + h;
  const bool whole = m0 + kAxStep <= mpad;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 y = whole || m0 + 4 * (2 * q + h) < mpad
                        ? __ldg(src + 2 * q)
                        : make_uint4(kMissingWord, kMissingWord, kMissingWord,
                                     kMissingWord);
    st.x[4 * q] = y.x;
    st.x[4 * q + 1] = y.y;
    st.x[4 * q + 2] = y.z;
    st.x[4 * q + 3] = y.w;
  }
  const int64_t m = m0 + 2 * (lane >> 1);
  st.w = st.u = make_float2(0.f, 0.f);
  if (m < mpad) {
    st.w = __ldg(w2 + m / 2);
    st.u = __ldg(u2 + m / 2);
  }
}

// The f32 at shared-window address a + kOff: one shared load with an
// immediate offset.
template <int kOff>
__device__ __forceinline__ float lds_at(uint32_t a) {
  float f;
  asm volatile("ld.shared.f32 %0, [%1+%2];"
               : "=f"(f) : "r"(a), "n"(kOff) : "memory");
  return f;
}

// Output (plane k, byte kB) of one step: the lane's 8 lookups, lane-local
// pair j at 128 j bytes past the step's tables (h by bit 6 of idx), in a
// fixed tree.
template <int kB, int... kJ>
__device__ __forceinline__ float ax_output(const uint32_t* idx, uint32_t off,
                                           std::integer_sequence<int, kJ...>) {
  const float f[kAxPairs] = {
      lds_at<128 * kJ>(__byte_perm(idx[kJ], off, 0x7650 + kB))...};
  return __fadd_rn(tree4(f), tree4(f + 4));
}

// One step of a warp: its tables into the buffer at shared-window address
// `off` (a multiple of 1024; `buf` is its generic address), then the
// lookups of each output (plane k, byte b) into the lane's double sums.
// Lane l builds entries 8 hh .. 8 hh + 7 of pair p = l >> 1, hh = l & 1
// (c & 3 runs over 0-3, c >> 2 over 2 hh, 2 hh + 1), at the place of pair
// p's lane-local index j = 2 (p >> 2) + (p & 1) and half (p >> 1) & 1.
__device__ __forceinline__ void ax_step(const AxStep& st, int lane,
                                        uint32_t off, float* buf,
                                        double acc[16]) {
  const float2 w = st.w, u = st.u;
  const float t0[4] = {__fsub_rn(__fmul_rn(2.f, w.x), u.x), 0.f,
                       __fsub_rn(w.x, u.x), -u.x};
  const int hh = lane & 1;
  const float s0 =
      hh ? __fsub_rn(w.y, u.y) : __fsub_rn(__fmul_rn(2.f, w.y), u.y);
  const float s1 = hh ? -u.y : 0.f;
  const int p = lane >> 1;
  float* dst = buf + 32 * (2 * (p >> 2) + (p & 1)) + 16 * ((p >> 1) & 1) +
               8 * hh;
  reinterpret_cast<float4*>(dst)[0] =
      make_float4(__fadd_rn(t0[0], s0), __fadd_rn(t0[1], s0),
                  __fadd_rn(t0[2], s0), __fadd_rn(t0[3], s0));
  reinterpret_cast<float4*>(dst)[1] =
      make_float4(__fadd_rn(t0[0], s1), __fadd_rn(t0[1], s1),
                  __fadd_rn(t0[2], s1), __fadd_rn(t0[3], s1));
  __syncwarp();
  const uint32_t hbit = hh ? 0x40404040u : 0u;  // this lane's half
  constexpr auto pairs = std::make_integer_sequence<int, kAxPairs>{};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // byte b of idx[j]: 4 x the nibble (code_m + 4 code_{m+1}) of plane k,
    // person 4i+b, lane-local pair j, and the lane's half
    uint32_t idx[kAxPairs];
#pragma unroll
    for (int j = 0; j < kAxPairs; ++j) {
      const uint32_t a = st.x[2 * j], c = st.x[2 * j + 1];
      const uint32_t g = (k & 1)
          ? ((a >> 2) & 0x33333333u) | (c & 0xCCCCCCCCu)
          : (a & 0x33333333u) | ((c << 2) & 0xCCCCCCCCu);
      idx[j] = ((k < 2 ? g << 2 : g >> 2) & 0x3C3C3C3Cu) | hbit;
    }
    acc[4 * k] += (double)ax_output<0>(idx, off, pairs);
    acc[4 * k + 1] += (double)ax_output<1>(idx, off, pairs);
    acc[4 * k + 2] += (double)ax_output<2>(idx, off, pairs);
    acc[4 * k + 3] += (double)ax_output<3>(idx, off, pairs);
  }
}

__global__ void __launch_bounds__(kThreads, kAxBlocksPerSm)
ax_kernel(const uint32_t* __restrict__ words,
          const float2* __restrict__ w2,  // [Mpad / 2]
          const float2* __restrict__ u2,  // [Mpad / 2]
          float* __restrict__ out,        // [bands, 4, 4*Nw]
          int64_t nw, int64_t mpad, int64_t markers_per_band) {
  __shared__ __align__(1024) float tab[kWarps][2][kAxTable];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(tab);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)blockIdx.x * kAxRows;
  // rows past Nw write nothing
  const int64_t row = imin(row0 + (lane >> 1), nw - 1);
  const int64_t m_begin = (int64_t)blockIdx.y * markers_per_band;
  const int64_t m_end = imin(mpad, m_begin + markers_per_band);
  const uint32_t* wrow = words + row * mpad;
  const uint32_t off0 = base + (uint32_t)(2 * warp) * 4 * kAxTable;
  constexpr int64_t kStride = kWarps * kAxStep;
  double acc[16];  // [k * 4 + b]
#pragma unroll
  for (int o = 0; o < 16; ++o) acc[o] = 0.0;
  // two steps per pass, each loading the other's operands a step ahead
  AxStep sa, sb;
  int64_t m0 = m_begin + warp * kAxStep;
  ax_load(wrow, w2, u2, m0, m_end, mpad, lane, sa);
  for (; m0 < m_end; m0 += 2 * kStride) {
    ax_load(wrow, w2, u2, m0 + kStride, m_end, mpad, lane, sb);
    ax_step(sa, lane, off0, tab[warp][0], acc);
    if (m0 + kStride >= m_end) break;
    ax_load(wrow, w2, u2, m0 + 2 * kStride, m_end, mpad, lane, sa);
    ax_step(sb, lane, off0 + 4 * kAxTable, tab[warp][1], acc);
  }
  double* red = reinterpret_cast<double*>(tab);  // [8][kWarps][32]
  const int64_t nb = 4 * nw;
  float* part = out + (int64_t)blockIdx.y * 4 * nb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __syncthreads();  // every warp is done with the tables or the last half
#pragma unroll
    for (int o = 0; o < 8; ++o)
      red[(o * kWarps + warp) * 32 + lane] = acc[8 * half + o];
    __syncthreads();
    // thread (o, r): output 8 half + o of row row0 + r, (warp, h) in order
    if (threadIdx.x < 8 * kAxRows) {
      const int o = threadIdx.x / kAxRows, r = threadIdx.x % kAxRows;
      double sum = 0.0;
#pragma unroll
      for (int g = 0; g < kWarps; ++g)
        sum += red[(o * kWarps + g) * 32 + 2 * r] +
               red[(o * kWarps + g) * 32 + 2 * r + 1];
      const int kb = 8 * half + o;
      if (row0 + r < nw)
        part[(kb >> 2) * nb + 4 * (row0 + r) + (kb & 3)] = (float)sum;
    }
  }
}

int64_t ax_markers_per_band(int64_t nw, int64_t mpad) {
  // one wave where the rows leave room
  int64_t bands = kAxResident / cdiv(nw, kAxRows);
  bands = imin(bands, mpad / kAxMinBand);
  if (bands < 1) bands = 1;
  return cdiv(cdiv(mpad, bands), kAxStep) * kAxStep;
}

}  // namespace

extern "C" {

// number of row bands the atx and atx_a launches use: the wrappers size
// their partial outputs [2, bands, Mpad] and [bands, Mpad] with it
int64_t gvamp_atx_parts(int64_t nw, int64_t mpad) {
  return cdiv(nw, atx_rows_per_band(nw, mpad));
}

int gvamp_atx(const void* words, const void* v, void* out, int64_t nw,
              int64_t mpad, void* stream) {
  return atx_launch<true>(words, v, out, nw, mpad, stream);
}

int gvamp_atx_a(const void* words, const void* v, void* out, int64_t nw,
                int64_t mpad, void* stream) {
  return atx_launch<false>(words, v, out, nw, mpad, stream);
}

// number of marker bands the ax launch uses: the wrapper sizes its partial
// output [bands, 4, 4*Nw] with it
int64_t gvamp_ax_parts(int64_t nw, int64_t mpad) {
  return cdiv(mpad, ax_markers_per_band(nw, mpad));
}

int gvamp_ax(const void* words, const void* w, const void* u, void* out,
             int64_t nw, int64_t mpad, void* stream) {
  if (nw <= 0 || mpad <= 0 || mpad % 4 != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t band = ax_markers_per_band(nw, mpad);
  const dim3 grid((unsigned)cdiv(nw, kAxRows), (unsigned)cdiv(mpad, band),
                  1);
  ax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float2*>(w),
      static_cast<const float2*>(u), static_cast<float*>(out), nw, mpad, band);
  return (int)cudaGetLastError();
}

}  // extern "C"
