// The statistics pass of the PyTorch port, written by hand for Hopper
// (sm_90a): the integer counts S_a, S_b and S_aa of every marker over a
// phenotype-NA support, in one streaming read of the packed words.  Bound
// through the plain C interface of gvamp_tpu_torch/ops/_build.py; the
// wrapper (marker_counts) and its plain PyTorch version are in
// gvamp_tpu_torch/ops/matvec.py, and gvamp_tpu_torch/data.py turns the
// counts into mave and msig.  It replaces no Pallas kernel: the JAX
// package's pass (_marker_stats_kernel, gvamp_tpu/data.py:84-151) is XLA
// code, which decodes and sums in floats with a compensated chain; the
// counts are integers, so they are exact and need no chain.
//
// Bound on this card: one read of the words (bytes).  Per word the kernel
// spends a shift, three logic ops, three popcounts and three adds, well
// under the integer pipes' rate at the read's pace.
//
// Layout (gvamp_tpu/ops/layout.py): words are uint32[Nw, Mpad], word-major,
// 16 samples per word; the 2-bit field at bits 8j+2k, 8j+2k+1 of word row i
// holds the code of planar slot (k, 4i+j).  The wrapper turns the 0/1 NA
// indicator into one mask word per word row with bit 8j+2k set where slot
// (k, 4i+j) is not NA: the low bit of each field, in the words' own order.
//
// Per word w and mask m (low field bits only), with hi = w >> 1 putting
// each field's high bit on its low bit:
//   n2 = popc(m & ~w & ~hi)   code 00, dosage 2
//   n1 = popc(m & ~w &  hi)   code 10, dosage 1
//   nb = popc(m & (~w | hi))  codes 00, 10, 11: not missing
// so S_a += 2 n2 + n1, S_aa += 4 n2 + n1 and S_b += nb.  Only the low bit
// of each field of a term survives the mask, so no term needs the field
// masks of a decode.
//
// A thread owns 4 consecutive markers (one 16-byte load a row) and walks a
// slice of word rows; the row's mask word is one broadcast load.  The
// slices of one marker meet in atomicAdd on an output the wrapper zeroed:
// integer additions, exact and in any order, so the counts do not depend
// on the grid.  Bounds checks, not divisors, cover a ragged last slice of
// rows and the markers past the last block, so the kernel takes any Nw and
// any width that the words' 16-byte rows allow (a multiple of 4, as every
// kernel of the port takes: the loader pads Mpad to 512s, a mesh slab is
// Mpad / K of it).  Every launch returns cudaGetLastError(); indices are
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "swar.cuh"

namespace {

constexpr int kCountThreads = 256;

__device__ __forceinline__ void count_word(uint32_t w, uint32_t m,
                                           uint32_t& n2, uint32_t& n1,
                                           uint32_t& nb) {
  const uint32_t hi = w >> 1;
  n2 += __popc(m & ~w & ~hi);
  n1 += __popc(m & ~w & hi);
  nb += __popc(m & (~w | hi));
}

// out[0, c] += S_a, out[1, c] += S_b, out[2, c] += S_aa over the rows
// [blockIdx.y * rows, (blockIdx.y + 1) * rows) of this thread's markers
// c .. c + 3
__global__ void __launch_bounds__(kCountThreads)
    marker_counts_kernel(const uint32_t* __restrict__ words,
                         const uint32_t* __restrict__ mask,
                         int32_t* __restrict__ out, int64_t nw, int64_t m,
                         int64_t rows) {
  const int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (c >= m) return;
  const int64_t r0 = (int64_t)blockIdx.y * rows;
  const int64_t r1 = imin(nw, r0 + rows);
  uint32_t n2[4] = {0u, 0u, 0u, 0u}, n1[4] = {0u, 0u, 0u, 0u},
           nb[4] = {0u, 0u, 0u, 0u};
  const uint32_t* p = words + r0 * m + c;
#pragma unroll 4
  for (int64_t r = r0; r < r1; ++r, p += m) {
    const uint32_t mk = __ldg(mask + r) & kM5;
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    count_word(x.x, mk, n2[0], n1[0], nb[0]);
    count_word(x.y, mk, n2[1], n1[1], nb[1]);
    count_word(x.z, mk, n2[2], n1[2], nb[2]);
    count_word(x.w, mk, n2[3], n1[3], nb[3]);
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    atomicAdd(out + c + v, (int32_t)(2u * n2[v] + n1[v]));
    atomicAdd(out + m + c + v, (int32_t)nb[v]);
    atomicAdd(out + 2 * m + c + v, (int32_t)(4u * n2[v] + n1[v]));
  }
}

}  // namespace

extern "C" {

// counts: int32[3, m] zeroed by the caller, rows S_a, S_b, S_aa; words:
// uint32[nw, m] contiguous and 16-byte aligned, m a multiple of 4; mask:
// one word per row.  The row slices: enough to fill the card's resident
// blocks kDotWaves times over the column blocks (mma.cuh).
int gvamp_marker_counts(const void* words, const void* mask, void* counts,
                        int64_t nw, int64_t m, void* stream) {
  if (nw < 0 || m < 0 || m % 4) return (int)cudaErrorInvalidValue;
  if (nw == 0 || m == 0) return 0;
  int64_t target = 0;
  const int err = dot_target(marker_counts_kernel, kCountThreads, 0, &target);
  if (err) return err;
  const int64_t cols = cdiv(m / 4, kCountThreads);
  const int64_t rows = part_length(nw, cols, target);
  const dim3 grid((unsigned)cols, (unsigned)cdiv(nw, rows));
  marker_counts_kernel<<<grid, kCountThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(mask),
      static_cast<int32_t*>(counts), nw, m, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
