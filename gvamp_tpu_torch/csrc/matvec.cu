// Packed-genotype products of the PyTorch port, written by hand for Hopper
// (sm_90a).  Bound through a plain C interface (ctypes, see
// gvamp_tpu_torch/ops/_build.py); the wrappers are in
// gvamp_tpu_torch/ops/matvec.py, beside the plain PyTorch versions the
// kernels are checked against.
//
// Layout (gvamp_tpu/ops/layout.py): words are uint32[Nw, Mpad], word-major,
// 16 samples per word.  Byte b of word-row i holds the four 2-bit codes of
// planar rows (k, 4i+b), k = bit pair.  The SWAR decode of plane k turns a
// word into a u32 whose byte b is the dosage {2,0,1,0}[code] of row 4i+b,
// which is exactly the byte order of four int8 digits packed into one
// int32, so each product step is one __dp4a.
//
// The digit contract (gvamp_tpu/ops/matvec.py:441-512): right-hand sides
// arrive as radix-127 int8 digits, quantised and later folded back to f32
// by the wrapper.  The kernels are pure integer contractions.  |sum| is at
// most 254 * K for a contraction of length K, which the wrappers keep below
// 2^31; integer addition is exact in any order, so the atomics below leave
// the results deterministic.
//
// Every launch returns cudaGetLastError(), and the wrapper raises on a
// non-zero code.  A kernel allocates nothing: the wrapper passes zeroed
// outputs.  Indices are 64-bit: a full-size matrix holds more than 2^31
// words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM1 = 0x01010101u;
constexpr uint32_t kM3 = 0x03030303u;
constexpr int kThreads = 256;
constexpr int kTileRows = 256;   // word rows of right-hand side per smem tile
constexpr int kTileQuads = 256;  // marker quads of digits per smem tile
constexpr int kWarps = kThreads / 32;
// blocks to aim for: several waves of 132 SMs at 8 resident blocks each
constexpr int64_t kTargetBlocks = 132 * 8 * 4;

__device__ __forceinline__ uint32_t swar_a(uint32_t w, int k) {
  const uint32_t c = (w >> (2 * k)) & kM3;
  const uint32_t lo = c & kM1;
  const uint32_t hi = (c >> 1) & kM1;
  const uint32_t notlo = lo ^ kM1;
  return (notlo << 1) - (hi & notlo);
}

__device__ __forceinline__ uint32_t swar_b(uint32_t w, int k) {
  const uint32_t c = (w >> (2 * k)) & kM3;
  return ((c >> 1) & kM1) | ((c & kM1) ^ kM1);
}

// Four neighbouring marker words (one 16-byte load) -> y[b] whose byte j is
// byte b of marker word j: the SWAR decode of y[b] then holds the dosages
// of planar row (k, 4i+b) for four markers, the int8x4 layout of __dp4a.
__device__ __forceinline__ void transpose_quad(uint4 x, uint32_t y[4]) {
  const uint32_t t0 = __byte_perm(x.x, x.y, 0x5140);
  const uint32_t t1 = __byte_perm(x.x, x.y, 0x7362);
  const uint32_t t2 = __byte_perm(x.z, x.w, 0x5140);
  const uint32_t t3 = __byte_perm(x.z, x.w, 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// Sum v over the warp's 32 lanes; lane 0 holds the total.
__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

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
// atxm_i8a: av[d][m] = sum_{k, p} a_k[m, p] * vdig[k][d][p]
//
// Replaces atxm_i8a_pallas / _atxm_i8a_kernel (gvamp_tpu/ops/matvec.py:1560,
// 1581).  Bound on this card: one pass reads all 4*Nw*Mpad packed bytes
// (10.74 GB at N=327,680 x M=131,072) and does 4*DT dp4a per word, so it
// is bound by packed bytes at small D and by the integer pipe as D grows.
// Design: one thread per marker column, so that a warp reads 128
// consecutive bytes of a word row; the digit words of a band of rows are
// the same for every thread and sit in shared memory (broadcast reads).
// Row bands spread over gridDim.y and meet in int32 atomicAdd; digit groups
// of DT rows spread over gridDim.z.
// --------------------------------------------------------------------------
template <int DT>
__global__ void __launch_bounds__(kThreads)
atxm_i8a_kernel(const uint32_t* __restrict__ words,
                const int32_t* __restrict__ vdig,  // int32 view [4, D, Nw]
                int32_t* __restrict__ out,         // [D, Mpad]
                int64_t nw, int64_t mpad, int64_t d_total,
                int64_t rows_per_band) {
  __shared__ int32_t sdig[4][DT][kTileRows];
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t d0 = (int64_t)blockIdx.z * DT;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_band;
  const int64_t r_end = imin(nw, r_begin + rows_per_band);

  int32_t acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = 0;

  for (int64_t t0 = r_begin; t0 < r_end; t0 += kTileRows) {
    const int rows = (int)imin((int64_t)kTileRows, r_end - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < 4 * DT * kTileRows; idx += kThreads) {
      const int k = idx / (DT * kTileRows);
      const int d = (idx / kTileRows) % DT;
      const int r = idx % kTileRows;
      int32_t v = 0;
      if (r < rows && d0 + d < d_total)
        v = vdig[((int64_t)k * d_total + d0 + d) * nw + t0 + r];
      sdig[k][d][r] = v;
    }
    __syncthreads();
    if (m < mpad) {
      const uint32_t* col = words + t0 * mpad + m;
      for (int r = 0; r < rows; ++r) {
        const uint32_t w = __ldg(col + (int64_t)r * mpad);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int a = (int)swar_a(w, k);
#pragma unroll
          for (int d = 0; d < DT; ++d) acc[d] = __dp4a(a, sdig[k][d][r], acc[d]);
        }
      }
    }
  }
  if (m < mpad) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      if (d0 + d < d_total) atomicAdd(out + (d0 + d) * mpad + m, acc[d]);
  }
}

// --------------------------------------------------------------------------
// axm_i8a: zt[d][k][p] = sum_m a_k[m, p] * wdig[d][m]
//
// Replaces axm_i8a_pallas / _axm_i8a_kernel and _axm_i8a_wide_kernel
// (gvamp_tpu/ops/matvec.py:755-841; the TPU's orientation switch at D > 64
// has no counterpart here).  Bound on this card: as atxm_i8a, one read of
// every packed byte per digit group; the contraction runs along the fast
// (marker) axis, so the sum crosses threads.
// Design: one warp per word row.  A lane loads four neighbouring marker
// words as one 16-byte load and transposes their bytes with __byte_perm, so
// that byte j of y_b is byte b of marker 4q+j; the SWAR decode of y_b then
// gives the dosages of row (k, 4i+b) for four markers, which one __dp4a
// multiplies with the packed digits of those markers.  The digits of a
// marker tile are shared by the block's warps through shared memory.  Each
// lane keeps 16*DT int32 sums; a warp-shuffle reduction and one atomicAdd
// per sum finish the row.  Marker bands spread over gridDim.y, digit groups
// over gridDim.z.
// --------------------------------------------------------------------------
constexpr int kAxmDT = 4;

__global__ void __launch_bounds__(kThreads)
axm_i8a_kernel(const uint32_t* __restrict__ words,
               const int32_t* __restrict__ wdig,  // int32 view [D, Mpad/4]
               int32_t* __restrict__ out,         // [D, 4, 4*Nw]
               int64_t nw, int64_t mpad, int64_t d_total,
               int64_t quads_per_band) {
  constexpr int DT = kAxmDT;
  __shared__ int32_t sw[DT][kTileQuads];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t nq = mpad / 4;
  const int64_t q_begin = (int64_t)blockIdx.y * quads_per_band;
  const int64_t q_end = imin(nq, q_begin + quads_per_band);
  const int64_t d0 = (int64_t)blockIdx.z * DT;

  int32_t acc[DT][16];  // [d][k * 4 + b]
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[d][j] = 0;

  const uint4* wrow =
      reinterpret_cast<const uint4*>(words + (row < nw ? row : 0) * mpad);
  for (int64_t qt = q_begin; qt < q_end; qt += kTileQuads) {
    const int nqt = (int)imin((int64_t)kTileQuads, q_end - qt);
    __syncthreads();
    for (int idx = threadIdx.x; idx < DT * kTileQuads; idx += kThreads) {
      const int d = idx / kTileQuads;
      const int q = idx % kTileQuads;
      int32_t v = 0;
      if (q < nqt && d0 + d < d_total) v = wdig[(d0 + d) * nq + qt + q];
      sw[d][q] = v;
    }
    __syncthreads();
    if (row < nw) {
      for (int q = lane; q < nqt; q += 32) {
        uint32_t y[4];
        transpose_quad(__ldg(wrow + qt + q), y);
        int32_t wd[DT];
#pragma unroll
        for (int d = 0; d < DT; ++d) wd[d] = sw[d][q];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int a = (int)swar_a(y[b], k);
#pragma unroll
            for (int d = 0; d < DT; ++d)
              acc[d][k * 4 + b] = __dp4a(a, wd[d], acc[d][k * 4 + b]);
          }
      }
    }
  }
  if (row >= nw) return;  // after the last __syncthreads of the block
  const int64_t nb = 4 * nw;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int32_t v = warp_sum(acc[d][j]);
      if (lane == 0 && d0 + d < d_total) {
        const int k = j / 4, b = j % 4;
        atomicAdd(out + ((d0 + d) * 4 + k) * nb + 4 * row + b, v);
      }
    }
  }
}

// --------------------------------------------------------------------------
// atxm_i8: (av, bv)[d][m] = sum_{k, p} (a_k, b_k)[m, p] * vdig[k][d][p]
//
// Replaces atxm_i8_pallas / _atxm_i8_kernel (gvamp_tpu/ops/matvec.py:651-677,
// 704), the transpose product on genotypes with missing calls.  Bound on
// this card: the same one read of the packed bytes as atxm_i8a, but twice
// the __dp4a work per word (8*DT: the dosage plane a and the non-missing
// plane b, each against every digit row), so it sits further toward the
// integer pipe than atxm_i8a: 10.8 ms against atxm_i8a's 8.4 ms over the
// 10.74 GB of config B at B=1 (NVIDIA H100 80GB HBM3, 700 W).  ptxas: 48
// (DT=4) and 64 (DT=8) registers, no spill.
// Design: atxm_i8a's (one thread per marker column, the digit words of a
// row band in shared memory, row bands over gridDim.y meeting in int32
// atomicAdd, digit groups of DT rows over gridDim.z); each word is decoded
// into both planes once, and both accumulator arrays run against the SAME
// digit words, as the TPU kernel feeds one vt to both dots.
// --------------------------------------------------------------------------
template <int DT>
__global__ void __launch_bounds__(kThreads)
atxm_i8_kernel(const uint32_t* __restrict__ words,
               const int32_t* __restrict__ vdig,  // int32 view [4, D, Nw]
               int32_t* __restrict__ out_a,       // [D, Mpad]
               int32_t* __restrict__ out_b,       // [D, Mpad]
               int64_t nw, int64_t mpad, int64_t d_total,
               int64_t rows_per_band) {
  __shared__ int32_t sdig[4][DT][kTileRows];
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t d0 = (int64_t)blockIdx.z * DT;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_band;
  const int64_t r_end = imin(nw, r_begin + rows_per_band);

  int32_t acc_a[DT], acc_b[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc_a[d] = acc_b[d] = 0;

  for (int64_t t0 = r_begin; t0 < r_end; t0 += kTileRows) {
    const int rows = (int)imin((int64_t)kTileRows, r_end - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < 4 * DT * kTileRows; idx += kThreads) {
      const int k = idx / (DT * kTileRows);
      const int d = (idx / kTileRows) % DT;
      const int r = idx % kTileRows;
      int32_t v = 0;
      if (r < rows && d0 + d < d_total)
        v = vdig[((int64_t)k * d_total + d0 + d) * nw + t0 + r];
      sdig[k][d][r] = v;
    }
    __syncthreads();
    if (m < mpad) {
      const uint32_t* col = words + t0 * mpad + m;
      for (int r = 0; r < rows; ++r) {
        const uint32_t w = __ldg(col + (int64_t)r * mpad);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int a = (int)swar_a(w, k);
          const int b = (int)swar_b(w, k);
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            const int32_t v = sdig[k][d][r];
            acc_a[d] = __dp4a(a, v, acc_a[d]);
            acc_b[d] = __dp4a(b, v, acc_b[d]);
          }
        }
      }
    }
  }
  if (m < mpad) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      if (d0 + d < d_total) {
        atomicAdd(out_a + (d0 + d) * mpad + m, acc_a[d]);
        atomicAdd(out_b + (d0 + d) * mpad + m, acc_b[d]);
      }
  }
}

// --------------------------------------------------------------------------
// axm_i8: (za, zb)[d][k][p] = sum_m (a_k[m, p] * wdig[d][m],
//                                   b_k[m, p] * udig[d][m])
//
// Replaces axm_i8_pallas / _axm_i8_kernel (gvamp_tpu/ops/matvec.py:514-536,
// 539), the forward product on genotypes with missing calls.  W and U carry
// separate digit scales, so the a-plane and the b-plane products stay
// apart (the wrapper folds each with its own scales and subtracts).
// Bound on this card: one read of the packed bytes per group of DT digit
// rows, plus the byte transposes, two SWAR decodes and 2*16*DT __dp4a per
// 16-byte load.
// Design: axm_i8a's (one warp per word row, the 16-byte load and the
// __byte_perm transpose, digits of a marker tile in shared memory, a warp
// reduction and one atomicAdd per sum); two digit tiles and two sets of
// lane sums.  Registers bound the digit group: each lane keeps 2*16*DT
// int32 sums, and DT = kAxmI8DT = 2 holds them at 64, as axm_i8a's DT = 4
// does for its one plane (ptxas: 100 registers, no spill).  The price:
// the words are read once per two digit rows, so B=1 (D=4) reads them
// twice: 19.4 ms over the 10.74 GB of config B, as axm_i8a takes at B=2
// (NVIDIA H100 80GB HBM3, 700 W).
// --------------------------------------------------------------------------
constexpr int kAxmI8DT = 2;

__global__ void __launch_bounds__(kThreads)
axm_i8_kernel(const uint32_t* __restrict__ words,
              const int32_t* __restrict__ wdig,  // int32 view [D, Mpad/4]
              const int32_t* __restrict__ udig,  // int32 view [D, Mpad/4]
              int32_t* __restrict__ out_a,       // [D, 4, 4*Nw]
              int32_t* __restrict__ out_b,       // [D, 4, 4*Nw]
              int64_t nw, int64_t mpad, int64_t d_total,
              int64_t quads_per_band) {
  constexpr int DT = kAxmI8DT;
  __shared__ int32_t sw[DT][kTileQuads];
  __shared__ int32_t su[DT][kTileQuads];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t nq = mpad / 4;
  const int64_t q_begin = (int64_t)blockIdx.y * quads_per_band;
  const int64_t q_end = imin(nq, q_begin + quads_per_band);
  const int64_t d0 = (int64_t)blockIdx.z * DT;

  int32_t acc_a[DT][16], acc_b[DT][16];  // [d][k * 4 + b]
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc_a[d][j] = acc_b[d][j] = 0;

  const uint4* wrow =
      reinterpret_cast<const uint4*>(words + (row < nw ? row : 0) * mpad);
  for (int64_t qt = q_begin; qt < q_end; qt += kTileQuads) {
    const int nqt = (int)imin((int64_t)kTileQuads, q_end - qt);
    __syncthreads();
    for (int idx = threadIdx.x; idx < DT * kTileQuads; idx += kThreads) {
      const int d = idx / kTileQuads;
      const int q = idx % kTileQuads;
      int32_t w = 0, u = 0;
      if (q < nqt && d0 + d < d_total) {
        w = wdig[(d0 + d) * nq + qt + q];
        u = udig[(d0 + d) * nq + qt + q];
      }
      sw[d][q] = w;
      su[d][q] = u;
    }
    __syncthreads();
    if (row < nw) {
      for (int q = lane; q < nqt; q += 32) {
        uint32_t y[4];
        transpose_quad(__ldg(wrow + qt + q), y);
        int32_t wd[DT], ud[DT];
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          wd[d] = sw[d][q];
          ud[d] = su[d][q];
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int a = (int)swar_a(y[b], k);
            const int nm = (int)swar_b(y[b], k);
#pragma unroll
            for (int d = 0; d < DT; ++d) {
              acc_a[d][k * 4 + b] = __dp4a(a, wd[d], acc_a[d][k * 4 + b]);
              acc_b[d][k * 4 + b] = __dp4a(nm, ud[d], acc_b[d][k * 4 + b]);
            }
          }
      }
    }
  }
  if (row >= nw) return;  // after the last __syncthreads of the block
  const int64_t nb = 4 * nw;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int32_t va = warp_sum(acc_a[d][j]);
      const int32_t vb = warp_sum(acc_b[d][j]);
      if (lane == 0 && d0 + d < d_total) {
        const int64_t o = ((d0 + d) * 4 + j / 4) * nb + 4 * row + j % 4;
        atomicAdd(out_a + o, va);
        atomicAdd(out_b + o, vb);
      }
    }
  }
}

// --------------------------------------------------------------------------
// atx: (av[m], bv[m]) = sum_{k, p} (a_k, b_k)[m, p] * v[k, p] in f32
//
// Replaces atx_pallas / _atx_kernel (gvamp_tpu/ops/matvec.py:266, 287).  It
// runs once at load, for the completeness check (GenoBed.geno_complete).
// Bound on this card: one read of the packed bytes, 32 float FMAs per word.
// Design: one thread per marker column (coalesced word reads), the planar
// vector of a band of rows in shared memory.  Row bands spread over
// gridDim.y; each band writes its own partial row and the wrapper sums the
// partials in a fixed order, so the f32 result does not depend on
// scheduling.
// --------------------------------------------------------------------------
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
  float av = 0.f, bv = 0.f;
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
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t a = swar_a(w, k);
          const uint32_t b = swar_b(w, k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float vv = sv[k][4 * r + j];
            av = fmaf((float)((a >> (8 * j)) & 0xffu), vv, av);
            bv = fmaf((float)((b >> (8 * j)) & 0xffu), vv, bv);
          }
        }
      }
    }
  }
  if (m < mpad) {
    const int64_t bands = gridDim.y;
    out[(int64_t)blockIdx.y * mpad + m] = av;
    out[(bands + blockIdx.y) * mpad + m] = bv;
  }
}

int64_t atx_rows_per_band(int64_t nw, int64_t mpad) {
  return band_length(nw, cdiv(mpad, kThreads), kTileRows);
}

}  // namespace

extern "C" {

int gvamp_atxm_i8a(const void* words, const void* vdig, void* out, int64_t nw,
                   int64_t mpad, int64_t d_total, void* stream) {
  const int64_t nx = cdiv(mpad, kThreads);
  const bool narrow = d_total <= 4;
  const int64_t nz = cdiv(d_total, narrow ? 4 : 8);
  const int64_t rows = band_length(nw, nx * nz, kTileRows);
  const dim3 grid((unsigned)nx, (unsigned)cdiv(nw, rows), (unsigned)nz);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* v = static_cast<const int32_t*>(vdig);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (narrow)
    atxm_i8a_kernel<4><<<grid, kThreads, 0, s>>>(w, v, o, nw, mpad, d_total, rows);
  else
    atxm_i8a_kernel<8><<<grid, kThreads, 0, s>>>(w, v, o, nw, mpad, d_total, rows);
  return (int)cudaGetLastError();
}

int gvamp_axm_i8a(const void* words, const void* wdig, void* out, int64_t nw,
                  int64_t mpad, int64_t d_total, void* stream) {
  const int64_t nx = cdiv(nw, kWarps);
  const int64_t nz = cdiv(d_total, kAxmDT);
  const int64_t quads = band_length(mpad / 4, nx * nz, kTileQuads);
  const dim3 grid((unsigned)nx, (unsigned)cdiv(mpad / 4, quads), (unsigned)nz);
  axm_i8a_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(wdig),
      static_cast<int32_t*>(out), nw, mpad, d_total, quads);
  return (int)cudaGetLastError();
}

int gvamp_atxm_i8(const void* words, const void* vdig, void* out_a,
                  void* out_b, int64_t nw, int64_t mpad, int64_t d_total,
                  void* stream) {
  const int64_t nx = cdiv(mpad, kThreads);
  const bool narrow = d_total <= 4;
  const int64_t nz = cdiv(d_total, narrow ? 4 : 8);
  const int64_t rows = band_length(nw, nx * nz, kTileRows);
  const dim3 grid((unsigned)nx, (unsigned)cdiv(nw, rows), (unsigned)nz);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* v = static_cast<const int32_t*>(vdig);
  auto* oa = static_cast<int32_t*>(out_a);
  auto* ob = static_cast<int32_t*>(out_b);
  auto s = static_cast<cudaStream_t>(stream);
  if (narrow)
    atxm_i8_kernel<4><<<grid, kThreads, 0, s>>>(w, v, oa, ob, nw, mpad, d_total, rows);
  else
    atxm_i8_kernel<8><<<grid, kThreads, 0, s>>>(w, v, oa, ob, nw, mpad, d_total, rows);
  return (int)cudaGetLastError();
}

int gvamp_axm_i8(const void* words, const void* wdig, const void* udig,
                 void* out_a, void* out_b, int64_t nw, int64_t mpad,
                 int64_t d_total, void* stream) {
  const int64_t nx = cdiv(nw, kWarps);
  const int64_t nz = cdiv(d_total, kAxmI8DT);
  const int64_t quads = band_length(mpad / 4, nx * nz, kTileQuads);
  const dim3 grid((unsigned)nx, (unsigned)cdiv(mpad / 4, quads), (unsigned)nz);
  axm_i8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(wdig),
      static_cast<const int32_t*>(udig), static_cast<int32_t*>(out_a),
      static_cast<int32_t*>(out_b), nw, mpad, d_total, quads);
  return (int)cudaGetLastError();
}

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

}  // extern "C"
