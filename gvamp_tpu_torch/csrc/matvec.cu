// Packed-genotype products of the PyTorch port, written by hand for Hopper
// (sm_90a), apart from the five digit products axm_i8a, atxm_i8a, axm_i8,
// atxm_i8 and axm_i8s, whose tensor-core kernels are in fragments.cu, the
// fused dual Grams gram_aat_i8a and gram_aat_i8 (gram_aat.cu) and the
// fused primal Grams gram_i8a and gram_i8 (gram_prim.cu).  Bound
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
// The kernels here are f32 products of one or a few right-hand-side
// columns (the digit products, which contract radix-127 int8 digits
// exactly in int32, are in fragments.cu).  Each block writes its own
// partial rows, which the wrapper sums in a fixed order, so the results do
// not depend on scheduling.
//
// Every launch returns cudaGetLastError(), and the wrapper raises on a
// non-zero code.  A kernel allocates nothing: the wrapper passes the
// outputs.  Indices are 64-bit: a full-size matrix holds more than 2^31
// words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "swar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;   // word rows of right-hand side per smem tile
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

// --------------------------------------------------------------------------
// atx: (av[m], bv[m]) = sum_{k, p} (a_k, b_k)[m, p] * v[k, p] in f32
//
// Replaces atx_pallas / _atx_kernel (gvamp_tpu/ops/matvec.py:266, 287).  It
// runs once at load, for the completeness check (GenoBed.geno_complete).
// Bound on this card: one read of the packed bytes, 32 float FMAs per word
// and their 32 byte-to-float conversions, which a pipe of 16 per clock and
// SM sets the pace of (atx_a below is the design without them).
// Design: one thread per marker column (coalesced word reads), the planar
// vector of a band of rows in shared memory.  Row bands spread over
// gridDim.y; each band writes its own partial row and the wrapper sums the
// partials in a fixed order, so the f32 result does not depend on
// scheduling.  Each word row's 16 products are summed in f32 and the row
// sums in double: one long f32 running sum over a band of 64 rows already
// errs 7.6e-7 of the largest entry on Gaussian v (an emulation of this
// order against float64), beyond the 5e-7 that the kernel check
// (gvamp_tpu_torch/tools/kernel_check.py) holds every kernel to.
// --------------------------------------------------------------------------
__device__ __forceinline__ float byte_f(uint32_t x, int j) {
  return (float)((x >> (8 * j)) & 0xffu);
}

__global__ void __launch_bounds__(kThreads)
atx_kernel(const uint32_t* __restrict__ words,
           const float* __restrict__ v,  // [4, 4*Nw]
           float* __restrict__ out,      // [2, bands, Mpad]
           int64_t nw, int64_t mpad, int64_t rows_per_band) {
  __shared__ float sv[4][4 * kTileRows];
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nb = 4 * nw;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_band;
  const int64_t r_end = imin(nw, r_begin + rows_per_band);
  double av = 0.0, bv = 0.0;
  for (int64_t t0 = r_begin; t0 < r_end; t0 += kTileRows) {
    const int rows = (int)imin((int64_t)kTileRows, r_end - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < 4 * 4 * kTileRows; idx += kThreads) {
      const int k = idx / (4 * kTileRows);
      const int p = idx % (4 * kTileRows);
      sv[k][p] = p < 4 * rows ? v[k * nb + 4 * t0 + p] : 0.f;
    }
    __syncthreads();
    if (m < mpad) {
      const uint32_t* col = words + t0 * mpad + m;
      for (int r = 0; r < rows; ++r) {
        const uint32_t w = __ldg(col + (int64_t)r * mpad);
        float ta = 0.f, tb = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t a = swar_a(w, k);
          const uint32_t b = swar_b(w, k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float vv = sv[k][4 * r + j];
            ta = fmaf(byte_f(a, j), vv, ta);
            tb = fmaf(byte_f(b, j), vv, tb);
          }
        }
        av += (double)ta;
        bv += (double)tb;
      }
    }
  }
  if (m < mpad) {
    const int64_t bands = gridDim.y;
    out[(int64_t)blockIdx.y * mpad + m] = (float)av;
    out[(bands + blockIdx.y) * mpad + m] = (float)bv;
  }
}

int64_t atx_rows_per_band(int64_t nw, int64_t mpad) {
  return band_length(nw, cdiv(mpad, kThreads), kTileRows);
}

// --------------------------------------------------------------------------
// atx_a: av[m] = sum_{k, p} a_k[m, p] * v[k, p] in f32
//
// Replaces atx_a_pallas / _atx_a_kernel (gvamp_tpu/ops/matvec.py:1523-1540):
// atx without the b-side, which the caller takes as sum(v) on complete
// genotypes.  Bound on this card: one read of the packed bytes (3.21 ms at
// config B).  atx's loop spends 16 byte-to-float conversions per word on
// the a-side alone, a pipe of 16 per clock and SM: near 11 ms at config B.
// Design: no conversion per element.  Each byte b of word row i holds
// planes 0-3 of person 4i+b, its low nibble planes 0 and 1, its high
// nibble planes 2 and 3.  For each word row of a tile of kAtxRows the
// block builds in shared memory the pair table
//   T[r][2b + h][c] = dose(c & 3) v[2h][4i+b] + dose(c >> 2) v[2h+1][4i+b]
// for the 16 nibbles c (dose = {2, 0, 1, 0}[code], one f32 rounding), 128
// floats per word row, so that a word's a-side product is 8 table lookups.
// The nibble times 4 is byte b of (w << 2) & 0x3C3C3C3C (h = 0) or of
// (w >> 2) & 0x3C3C3C3C (h = 1); one __byte_perm puts it under the row's
// table offset (a multiple of 512), so a lookup is one permute and one
// shared load, with the table's place in the row an immediate offset.  A
// warp's lanes look up one 16-entry table at once, which lies in 16
// banks: no bank conflict.  A thread takes 4 markers with one 16-byte
// load per word row (a warp reads 512 contiguous bytes of each row); per
// word 8 loads from shared memory, 7 f32 adds in a fixed tree, ((T00 +
// T01) + (T10 + T11)) + ((T20 + T21) + (T30 + T31)) (Tbh: byte b, nibble
// h), and one double add: the word-row sums meet in double, as in atx
// (an f32 running sum over 64 rows errs 7.6e-7 of the largest entry).  The
// tables are double-buffered: the block builds tile t+1's while it reads
// tile t's, one barrier per tile.  Row bands of whole tiles spread over
// gridDim.y and write their own partial rows; the wrapper sums the
// partials in a fixed order.  On dyadic v (multiples of 1/8) every table
// entry and sum is exact, so the result equals the plain version's bit
// for bit.
// --------------------------------------------------------------------------
constexpr int kAtxRows = 32;  // word rows per table tile
constexpr int kAtxTable = 128;  // floats per word row: 8 nibbles x 16
constexpr int kAtxMarkers = 4 * kThreads;  // markers per block

// Tile rows [0, rows) from word row i0: entry (r, j = 2b + h, c) of T.
__device__ __forceinline__ void atx_a_table(const float* __restrict__ v,
                                            int64_t nb, int64_t i0, int rows,
                                            float (*tab)[kAtxTable]) {
  for (int e = threadIdx.x; e < rows * kAtxTable; e += kThreads) {
    const int r = e / kAtxTable, j = (e / 16) % 8, c = e % 16;
    const int b = j >> 1, h = j & 1;
    const int64_t p = 4 * (i0 + r) + b;
    const float v0 = __ldg(v + 2 * h * nb + p);
    const float v1 = __ldg(v + (2 * h + 1) * nb + p);
    // dose {2, 0, 1, 0}[code] of the nibble's two codes
    const float d0 = (c & 1) ? 0.f : ((c & 2) ? 1.f : 2.f);
    const float d1 = (c & 4) ? 0.f : ((c & 8) ? 1.f : 2.f);
    tab[r][j * 16 + c] = __fadd_rn(__fmul_rn(d0, v0), __fmul_rn(d1, v1));
  }
}

// The a-side product of one word against its row's tables at byte offset
// `off` of the tile (a multiple of 512): 8 lookups, summed in a fixed tree.
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
  return __fadd_rn(__fadd_rn(t[0], t[1]), __fadd_rn(t[2], t[3]));
}

__global__ void __launch_bounds__(kThreads)
atx_a_kernel(const uint32_t* __restrict__ words,
             const float* __restrict__ v,  // [4, 4*Nw]
             float* __restrict__ out,      // [bands, Mpad]
             int64_t nw, int64_t mpad, int64_t rows_per_band) {
  __shared__ __align__(512) float tab[2][kAtxRows][kAtxTable];
  const int64_t m = (int64_t)blockIdx.x * kAtxMarkers + 4 * threadIdx.x;
  const bool live = m < mpad;  // Mpad is a multiple of 4
  const int64_t nb = 4 * nw;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_band;
  const int64_t r_end = imin(nw, r_begin + rows_per_band);
  const int tiles = (int)((r_end - r_begin + kAtxRows - 1) / kAtxRows);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  atx_a_table(v, nb, r_begin, (int)imin(kAtxRows, r_end - r_begin), tab[0]);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int64_t t0 = r_begin + (int64_t)t * kAtxRows;
    // the next tile's tables into the other buffer, whose last readers
    // passed the barrier that closed tile t-1
    if (t + 1 < tiles)
      atx_a_table(v, nb, t0 + kAtxRows,
                  (int)imin(kAtxRows, r_end - t0 - kAtxRows),
                  tab[(t + 1) & 1]);
    if (live) {
      const int rows = (int)imin(kAtxRows, r_end - t0);
      const uint4* col = reinterpret_cast<const uint4*>(words + t0 * mpad + m);
      const int64_t stride = mpad / 4;  // uint4 per word row
      const char* tb = reinterpret_cast<const char*>(tab[t & 1]);
      int r = 0;
      for (; r + 4 <= rows; r += 4) {
        uint4 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = __ldg(col + (r + u) * stride);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t off = (uint32_t)(r + u) * (4 * kAtxTable);
          acc[0] += (double)atx_a_word(x[u].x, off, tb);
          acc[1] += (double)atx_a_word(x[u].y, off, tb);
          acc[2] += (double)atx_a_word(x[u].z, off, tb);
          acc[3] += (double)atx_a_word(x[u].w, off, tb);
        }
      }
      for (; r < rows; ++r) {
        const uint4 x = __ldg(col + r * stride);
        const uint32_t off = (uint32_t)r * (4 * kAtxTable);
        acc[0] += (double)atx_a_word(x.x, off, tb);
        acc[1] += (double)atx_a_word(x.y, off, tb);
        acc[2] += (double)atx_a_word(x.z, off, tb);
        acc[3] += (double)atx_a_word(x.w, off, tb);
      }
    }
    __syncthreads();
  }
  if (live)
    *reinterpret_cast<float4*>(out + (int64_t)blockIdx.y * mpad + m) =
        make_float4((float)acc[0], (float)acc[1], (float)acc[2],
                    (float)acc[3]);
}

int64_t atx_a_rows_per_band(int64_t nw, int64_t mpad) {
  return band_length(nw, cdiv(mpad, kAtxMarkers), kAtxRows);
}

// --------------------------------------------------------------------------
// ax: z[k][p] = sum_m a_k[m, p] * w[m] - b_k[m, p] * u[m] in f32
//
// Replaces ax_pallas / _ax_kernel (gvamp_tpu/ops/matvec.py:225-263).  It
// runs twice at set-up, for the people statistics of the dual solve
// (GenoBed.compute_people_statistics).  Bound on this card: one read of
// the packed bytes and 32 float FMAs (with their byte-to-float
// conversions) per word, so the conversions, not HBM, set its pace.
// Design: one warp per word row, 16-byte loads of four marker words, the
// __byte_perm transpose (transpose_quad), lanes striding over the marker
// quads of a band; each lane keeps one f32 sum per (plane k, byte b) and the
// warp sums them with a fixed shuffle tree.  Marker bands spread over
// gridDim.y and write their own partial rows; the wrapper sums the
// partials in a fixed order, so the result does not depend on scheduling.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ax_kernel(const uint32_t* __restrict__ words,
          const float4* __restrict__ w,  // [Mpad / 4]
          const float4* __restrict__ u,  // [Mpad / 4]
          float* __restrict__ out,       // [bands, 4, 4*Nw]
          int64_t nw, int64_t mpad, int64_t quads_per_band) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= nw) return;  // the kernel has no __syncthreads
  const int64_t q_begin = (int64_t)blockIdx.y * quads_per_band;
  const int64_t q_end = imin(mpad / 4, q_begin + quads_per_band);
  float acc[16];  // [k * 4 + b]
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  const uint4* wrow = reinterpret_cast<const uint4*>(words + row * mpad);
  for (int64_t q = q_begin + lane; q < q_end; q += 32) {
    uint32_t y[4];
    transpose_quad(__ldg(wrow + q), y);
    const float4 wv = __ldg(w + q);
    const float4 uv = __ldg(u + q);
    const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
    const float nu[4] = {-uv.x, -uv.y, -uv.z, -uv.w};
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t a = swar_a(y[b], k);
        const uint32_t nm = swar_b(y[b], k);
        float s = acc[k * 4 + b];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s = fmaf((float)((a >> (8 * j)) & 0xffu), ww[j], s);
          s = fmaf((float)((nm >> (8 * j)) & 0xffu), nu[j], s);
        }
        acc[k * 4 + b] = s;
      }
  }
  const int64_t nb = 4 * nw;
  float* o = out + (int64_t)blockIdx.y * 4 * nb;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) o[(j / 4) * nb + 4 * row + j % 4] = v;
  }
}

int64_t ax_quads_per_band(int64_t nw, int64_t mpad) {
  return band_length(mpad / 4, cdiv(nw, kWarps), 32);
}

// --------------------------------------------------------------------------
// The bf16-split products.  The wrapper splits each f32 right-hand side x
// into three bf16 parts hi, mid and lo (x ~= hi + mid + lo; _split_hi_lo in
// ops/matvec.py, as gvamp_tpu/ops/matvec.py:115-132).  A decoded a in
// {0,1,2} or b in {0,1} times a bf16 value is exact in f32, so a product
// per part with f32 sums is the function of the TPU's bf16 x bf16 -> f32
// MXU dots; only the order of the f32 sums differs.  Each part keeps its
// own sums, and the parts meet as (hi + mid) + lo, as the TPU kernels add
// them.  The kernels read the parts' bf16 bits; bf16 -> f32 is a shift.
// --------------------------------------------------------------------------
constexpr int kParts = 3;

__device__ __forceinline__ float bf16_low(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_high(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// --------------------------------------------------------------------------
// axm_bf16: z[c][k][p] = sum over parts, (hi + mid) + lo, of
//   sum_m a_k[m, p] * w_part[c][m] - b_k[m, p] * u_part[c][m]
//
// Replaces axm_pallas / _axm_kernel (gvamp_tpu/ops/matvec.py:319-373).
// Bound on this card: one read of the packed bytes per column, then 2 * 3
// float FMAs per decoded byte (a-side and b-side, three parts) and the
// byte conversions: CUDA cores, not HBM, set its pace.
// Design: ax_kernel's (one warp per word row, 16-byte loads of four marker
// words, the __byte_perm transpose, lanes striding over the marker quads of
// a band); one column per gridDim.z, so a lane keeps 16 * 3 f32 sums (plane
// k, byte b, part) and re-reads the words per column.  The four markers'
// parts of w and u are one 8-byte load each.  The 8 products of a quad for
// one sum meet in a local sum before they join the lane's running sum,
// which keeps the long running sums' rounding down.  A shuffle tree sums
// the lanes, the parts meet as (hi + mid) + lo, and each marker band writes
// its own partial rows; the wrapper sums the partials in a fixed order.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
axm_bf16_kernel(const uint32_t* __restrict__ words,
                const uint2* __restrict__ w2,  // bf16 [3, B, Mpad] as uint2 quads
                const uint2* __restrict__ u2,  // bf16 [3, B, Mpad]
                float* __restrict__ out,       // [bands, B, 4, 4*Nw]
                int64_t nw, int64_t mpad, int64_t ncols,
                int64_t quads_per_band) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= nw) return;  // the kernel has no __syncthreads
  const int64_t c = blockIdx.z;
  const int64_t nq = mpad / 4;
  const int64_t q_begin = (int64_t)blockIdx.y * quads_per_band;
  const int64_t q_end = imin(nq, q_begin + quads_per_band);
  float acc[16][kParts];  // [k * 4 + b][part]
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int p = 0; p < kParts; ++p) acc[j][p] = 0.f;
  const uint4* wrow = reinterpret_cast<const uint4*>(words + row * mpad);
  for (int64_t q = q_begin + lane; q < q_end; q += 32) {
    uint32_t y[4];
    transpose_quad(__ldg(wrow + q), y);
    float ww[kParts][4], nu[kParts][4];
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const uint2 x = __ldg(w2 + (p * ncols + c) * nq + q);
      const uint2 xu = __ldg(u2 + (p * ncols + c) * nq + q);
      ww[p][0] = bf16_low(x.x);
      ww[p][1] = bf16_high(x.x);
      ww[p][2] = bf16_low(x.y);
      ww[p][3] = bf16_high(x.y);
      nu[p][0] = -bf16_low(xu.x);
      nu[p][1] = -bf16_high(xu.x);
      nu[p][2] = -bf16_low(xu.y);
      nu[p][3] = -bf16_high(xu.y);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t a = swar_a(y[b], k);
        const uint32_t nm = swar_b(y[b], k);
        float t[kParts] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float fa = byte_f(a, j);
          const float fb = byte_f(nm, j);
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            t[p] = fmaf(fa, ww[p][j], t[p]);
            t[p] = fmaf(fb, nu[p][j], t[p]);
          }
        }
#pragma unroll
        for (int p = 0; p < kParts; ++p) acc[k * 4 + b][p] += t[p];
      }
  }
  const int64_t nb = 4 * nw;
  float* o = out + ((int64_t)blockIdx.y * ncols + c) * 4 * nb;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float s[kParts];
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      s[p] = acc[j][p];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[p] += __shfl_down_sync(0xffffffffu, s[p], off);
    }
    if (lane == 0) o[(j / 4) * nb + 4 * row + j % 4] = (s[0] + s[1]) + s[2];
  }
}

int64_t axm_bf16_quads_per_band(int64_t nw, int64_t mpad, int64_t ncols) {
  return band_length(mpad / 4, cdiv(nw, kWarps) * ncols, 32);
}

// --------------------------------------------------------------------------
// atxm_bf16: (av, bv)[c][m] = sum over parts, (hi + mid) + lo, of
//   sum_{k, p} (a_k, b_k)[m, p] * v_part[k, p, c]
//
// Replaces atxm_pallas / _atxm_kernel (gvamp_tpu/ops/matvec.py:376-435).
// Bound on this card: one read of the packed bytes per group of CG
// columns, then 2 * 3 * CG float FMAs per decoded byte (both planes, three
// parts) and their operands from shared memory.
// Design: atx's (one thread per marker column, the band's planar V parts in
// shared memory as f32, row bands over gridDim.y writing their own partial
// rows, summed by the wrapper in a fixed order).  2 sides x 3 parts x 64
// columns would be too many sums for registers, so a block takes a group
// of CG columns (gridDim.z walks the groups and re-reads the words); each
// thread keeps 2 * 3 * CG sums.  As in atx, a word row's products meet in
// f32 and the row sums in double.  The shared tile holds kBfTileRows word
// rows: 4 planes x 4 * 64 samples x 3 * CG floats (24 KB at CG = 2).
// --------------------------------------------------------------------------
constexpr int kBfTileRows = 64;

int atxm_bf16_group(int64_t ncols) { return ncols == 1 ? 1 : 2; }

template <int CG>
__global__ void __launch_bounds__(kThreads)
atxm_bf16_kernel(const uint32_t* __restrict__ words,
                 const uint16_t* __restrict__ v2,  // bf16 [4, Nb, 3 * B]
                 float* __restrict__ out,          // [2, bands, B, Mpad]
                 int64_t nw, int64_t mpad, int64_t ncols,
                 int64_t rows_per_band) {
  constexpr int E = kParts * CG;  // sums per side: [part][column]
  __shared__ float sv[4][4 * kBfTileRows][E];
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nb = 4 * nw;
  const int64_t c0 = (int64_t)blockIdx.z * CG;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_band;
  const int64_t r_end = imin(nw, r_begin + rows_per_band);
  double acc_a[E], acc_b[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc_a[e] = acc_b[e] = 0.0;
  for (int64_t t0 = r_begin; t0 < r_end; t0 += kBfTileRows) {
    const int rows = (int)imin((int64_t)kBfTileRows, r_end - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < 4 * 4 * kBfTileRows * E; idx += kThreads) {
      const int k = idx / (4 * kBfTileRows * E);
      const int s = (idx / E) % (4 * kBfTileRows);
      const int e = idx % E;
      const int64_t col = c0 + e % CG;
      float v = 0.f;
      if (s < 4 * rows && col < ncols)
        v = __uint_as_float(
            (uint32_t)v2[(k * nb + 4 * t0 + s) * kParts * ncols + (e / CG) * ncols + col]
            << 16);
      sv[k][s][e] = v;
    }
    __syncthreads();
    if (m < mpad) {
      const uint32_t* colw = words + t0 * mpad + m;
      for (int r = 0; r < rows; ++r) {
        const uint32_t w = __ldg(colw + (int64_t)r * mpad);
        float ta[E], tb[E];
#pragma unroll
        for (int e = 0; e < E; ++e) ta[e] = tb[e] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t a = swar_a(w, k);
          const uint32_t b = swar_b(w, k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float fa = byte_f(a, j);
            const float fb = byte_f(b, j);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float vv = sv[k][4 * r + j][e];
              ta[e] = fmaf(fa, vv, ta[e]);
              tb[e] = fmaf(fb, vv, tb[e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc_a[e] += (double)ta[e];
          acc_b[e] += (double)tb[e];
        }
      }
    }
  }
  if (m >= mpad) return;  // after the last __syncthreads of the block
  const int64_t bands = gridDim.y;
#pragma unroll
  for (int cc = 0; cc < CG; ++cc) {
    if (c0 + cc >= ncols) continue;
    const float za = ((float)acc_a[cc] + (float)acc_a[CG + cc]) + (float)acc_a[2 * CG + cc];
    const float zb = ((float)acc_b[cc] + (float)acc_b[CG + cc]) + (float)acc_b[2 * CG + cc];
    out[((int64_t)blockIdx.y * ncols + c0 + cc) * mpad + m] = za;
    out[((bands + blockIdx.y) * ncols + c0 + cc) * mpad + m] = zb;
  }
}

int64_t atxm_bf16_rows_per_band(int64_t nw, int64_t mpad, int64_t ncols) {
  const int64_t groups = cdiv(ncols, atxm_bf16_group(ncols));
  return band_length(nw, cdiv(mpad, kThreads) * groups, kBfTileRows);
}

}  // namespace

extern "C" {

// number of row bands the atx launch uses: the wrapper sizes its partial
// output [2, bands, Mpad] with it
int64_t gvamp_atx_parts(int64_t nw, int64_t mpad) {
  return cdiv(nw, atx_rows_per_band(nw, mpad));
}

int gvamp_atx(const void* words, const void* v, void* out, int64_t nw,
              int64_t mpad, void* stream) {
  const int64_t rows = atx_rows_per_band(nw, mpad);
  const dim3 grid((unsigned)cdiv(mpad, kThreads), (unsigned)cdiv(nw, rows), 1);
  atx_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(v),
      static_cast<float*>(out), nw, mpad, rows);
  return (int)cudaGetLastError();
}

// number of marker bands the ax launch uses: the wrapper sizes its partial
// output [bands, 4, 4*Nw] with it
int64_t gvamp_ax_parts(int64_t nw, int64_t mpad) {
  return cdiv(mpad / 4, ax_quads_per_band(nw, mpad));
}

int gvamp_ax(const void* words, const void* w, const void* u, void* out,
             int64_t nw, int64_t mpad, void* stream) {
  const int64_t quads = ax_quads_per_band(nw, mpad);
  const dim3 grid((unsigned)cdiv(nw, kWarps), (unsigned)cdiv(mpad / 4, quads), 1);
  ax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float4*>(w),
      static_cast<const float4*>(u), static_cast<float*>(out), nw, mpad, quads);
  return (int)cudaGetLastError();
}

// number of row bands the atx_a launch uses: the wrapper sizes its partial
// output [bands, Mpad] with it
int64_t gvamp_atx_a_parts(int64_t nw, int64_t mpad) {
  return cdiv(nw, atx_a_rows_per_band(nw, mpad));
}

int gvamp_atx_a(const void* words, const void* v, void* out, int64_t nw,
                int64_t mpad, void* stream) {
  if (nw <= 0 || mpad <= 0 || mpad % 4 != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = atx_a_rows_per_band(nw, mpad);
  const dim3 grid((unsigned)cdiv(mpad, kAtxMarkers), (unsigned)cdiv(nw, rows),
                  1);
  atx_a_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(v),
      static_cast<float*>(out), nw, mpad, rows);
  return (int)cudaGetLastError();
}

// number of marker bands the axm_bf16 launch uses: the wrapper sizes its
// partial output [bands, B, 4, 4*Nw] with it
int64_t gvamp_axm_bf16_parts(int64_t nw, int64_t mpad, int64_t ncols) {
  return cdiv(mpad / 4, axm_bf16_quads_per_band(nw, mpad, ncols));
}

int gvamp_axm_bf16(const void* words, const void* w2, const void* u2,
                   void* out, int64_t nw, int64_t mpad, int64_t ncols,
                   void* stream) {
  const int64_t quads = axm_bf16_quads_per_band(nw, mpad, ncols);
  const dim3 grid((unsigned)cdiv(nw, kWarps), (unsigned)cdiv(mpad / 4, quads),
                  (unsigned)ncols);
  axm_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint2*>(w2),
      static_cast<const uint2*>(u2), static_cast<float*>(out), nw, mpad, ncols,
      quads);
  return (int)cudaGetLastError();
}

// number of row bands the atxm_bf16 launch uses: the wrapper sizes its
// partial output [2, bands, B, Mpad] with it
int64_t gvamp_atxm_bf16_parts(int64_t nw, int64_t mpad, int64_t ncols) {
  return cdiv(nw, atxm_bf16_rows_per_band(nw, mpad, ncols));
}

int gvamp_atxm_bf16(const void* words, const void* v2, void* out, int64_t nw,
                    int64_t mpad, int64_t ncols, void* stream) {
  const int64_t rows = atxm_bf16_rows_per_band(nw, mpad, ncols);
  const int cg = atxm_bf16_group(ncols);
  const dim3 grid((unsigned)cdiv(mpad, kThreads), (unsigned)cdiv(nw, rows),
                  (unsigned)cdiv(ncols, cg));
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* v = static_cast<const uint16_t*>(v2);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (cg == 1)
    atxm_bf16_kernel<1><<<grid, kThreads, 0, s>>>(w, v, o, nw, mpad, ncols, rows);
  else
    atxm_bf16_kernel<2><<<grid, kThreads, 0, s>>>(w, v, o, nw, mpad, ncols, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
