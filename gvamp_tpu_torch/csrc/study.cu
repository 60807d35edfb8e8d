// Study kernels of the PyTorch port, written by hand for Hopper (sm_90a):
// the rungs of the stream-ceiling ladder between "read the packed words"
// and the product kernels of matvec.cu.  Bound through the same plain C
// interface (gvamp_tpu_torch/ops/_build.py); the wrappers and their plain
// PyTorch versions are in gvamp_tpu_torch/ops/study.py, and the tools that
// run them are gvamp_tpu_torch/tools/bench_stream.py and bench_variants.py.
//
// Every kernel here is an integer sum of the words (or of their decode),
// mod 2^32.  Addition mod 2^32 is associative and commutative, so the
// results equal the plain versions bit for bit whatever the grid, the
// threads per block, the load width or the order of the atomics.  Sums are
// taken in uint32 and the wrapper reads them as int32.
//
// Bound on this card: each kernel reads every packed word once (4*Nw*Mpad
// bytes, 10.74 GB at config B) and writes a small output, so bytes bound
// all four.  v1_decode_a adds the SWAR a-decode of all four planes per
// word (about 41 integer operations), which the rung exists to measure.
//
// The launches take `threads` per block and `load_bytes` per load (4, 8 or
// 16), the two things the H100 tile sweep of bench_stream varies.  Each
// grid aims at kWaves waves of resident blocks on the card's SMs (the SM
// count is read from the device): where the output alone gives fewer
// blocks, the columns are split over gridDim.y and the parts meet in
// atomicAdd on an output the wrapper zeroed.  The wrappers launch nothing
// for an empty matrix.  Every launcher returns cudaGetLastError(); indices
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swar.cuh"

namespace {

// resident waves of blocks each grid aims at
constexpr int64_t kWaves = 2;
// resident threads per SM on Hopper
constexpr int64_t kThreadsPerSm = 2048;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// V consecutive words (4*V bytes, aligned to that) in one load through the
// read-only path.
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t w[V]) {
  if constexpr (V == 1) {
    w[0] = __ldg(p);
  } else if constexpr (V == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  }
}

// The a-plane (dosage) decode of all four bit pairs, added as u32 byte
// lanes: each lane is at most 4 * 2 = 8, so no carry crosses a lane.
__device__ __forceinline__ uint32_t decode_a(uint32_t w) {
  return swar_a(w, 0) + swar_a(w, 1) + swar_a(w, 2) + swar_a(w, 3);
}

// Blocks the grid should reach on this device: kWaves waves of resident
// blocks of `threads` threads on every SM.  Returns a CUDA error code.
int target_blocks(int64_t threads, int64_t* target) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *target = kWaves * sms * (kThreadsPerSm / threads);
  return 0;
}

// Split `n` units of work into parts so that `blocks` blocks times the part
// count reaches the target (at most `n` parts); returns units per part.
int64_t part_length(int64_t n, int64_t blocks, int64_t target) {
  int64_t parts = cdiv(target, blocks > 0 ? blocks : 1);
  if (parts < 1) parts = 1;
  if (parts > n) parts = n;
  if (parts > 65535) parts = 65535;  // gridDim.y
  return n > 0 ? cdiv(n, parts) : 1;
}

bool valid_shape(int64_t threads, int64_t load_bytes) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0 &&
         (load_bytes == 4 || load_bytes == 8 || load_bytes == 16);
}

// --------------------------------------------------------------------------
// stream: out[r, c] = sum_j words[r, j*tm + c] mod 2^32, int32[Nw, tm]
//
// Replaces `stream` / _stream_kernel (tools/bench_stream.py:23, 33): one add
// per word, no cross-lane reduction.  A thread owns one row r and V
// consecutive columns c of the tile and walks the Mpad/tm tiles of its row,
// so a warp's loads along a row are coalesced; the loop is unrolled to keep
// several loads in flight.  Consecutive threads take consecutive column
// groups, so a warp reads 32*4*V contiguous bytes of one row where tm/V
// >= 32.  Unlike the TPU grid (Nw//tnw x Mm//tm, which drops the rows and
// columns past the last full tile), every row is summed; tm divides Mpad.
// --------------------------------------------------------------------------
template <int V>
__global__ void stream_kernel(const uint32_t* __restrict__ words,
                              uint32_t* __restrict__ out, int64_t nw,
                              int64_t mpad, int64_t tm,
                              int64_t tiles_per_part) {
  const int64_t groups = tm / V;  // column groups per row of the tile
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nw * groups) return;
  const int64_t r = g / groups;
  const int64_t c = (g % groups) * V;
  const int64_t j0 = (int64_t)blockIdx.y * tiles_per_part;
  const int64_t j1 = imin(mpad / tm, j0 + tiles_per_part);
  const uint32_t* p = words + r * mpad + c;
  uint32_t acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0u;
#pragma unroll 4
  for (int64_t j = j0; j < j1; ++j) {
    uint32_t w[V];
    load_words<V>(p + j * tm, w);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += w[v];
  }
  uint32_t* o = out + r * tm + c;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (gridDim.y == 1)
      o[v] = acc[v];
    else
      atomicAdd(o + v, acc[v]);
  }
}

template <int V>
int launch_stream(const uint32_t* words, uint32_t* out, int64_t nw,
                  int64_t mpad, int64_t tm, int64_t threads,
                  cudaStream_t s) {
  int64_t target = 0;
  if (const int err = target_blocks(threads, &target)) return err;
  const int64_t blocks = cdiv(nw * (tm / V), threads);
  const int64_t tiles = mpad / tm;
  const int64_t per_part = part_length(tiles, blocks, target);
  const dim3 grid((unsigned)blocks, (unsigned)cdiv(tiles, per_part));
  stream_kernel<V><<<grid, (unsigned)threads, 0, s>>>(words, out, nw, mpad,
                                                       tm, per_part);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// row_sum: out[r] = sum_m f(words[r, m]) mod 2^32, int32[1, Nw], with f the
// identity (stream_sum, v0_stream) or decode_a (v1_decode_a)
//
// Replaces `stream_sum` / _stream_sum_kernel (tools/bench_stream.py:50, 59),
// `v0_stream` / _v0_kernel (tools/bench_variants.py:70, 78) and
// `v1_decode_a` / _v1_kernel (tools/bench_variants.py:90, 103).  One block
// row per word row (gridDim.x), the row's vectors split over gridDim.y where
// Nw alone gives too few blocks.  Each thread strides along its part of the
// row with V-word loads (a block reads threads*4*V contiguous bytes per
// step), sums in a register, reduces over its warp with __shfl_xor_sync,
// and lane 0 adds the warp's sum into the zeroed out[r].
// --------------------------------------------------------------------------
template <int V, bool kDecode>
__global__ void row_sum_kernel(const uint32_t* __restrict__ words,
                               uint32_t* __restrict__ out, int64_t mpad,
                               int64_t vecs_per_part) {
  const int64_t r = blockIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * vecs_per_part;
  const int64_t i1 = imin(mpad / V, i0 + vecs_per_part);
  const uint32_t* row = words + r * mpad;
  uint32_t acc = 0u;
#pragma unroll 4
  for (int64_t i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    uint32_t w[V];
    load_words<V>(row + i * V, w);
#pragma unroll
    for (int v = 0; v < V; ++v) acc += kDecode ? decode_a(w[v]) : w[v];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(out + r, acc);
}

template <int V, bool kDecode>
int launch_row_sum(const uint32_t* words, uint32_t* out, int64_t nw,
                   int64_t mpad, int64_t threads, cudaStream_t s) {
  int64_t target = 0;
  if (const int err = target_blocks(threads, &target)) return err;
  const int64_t vecs = mpad / V;
  // parts of at least one block's step, so that no thread idles throughout
  const int64_t steps = part_length(cdiv(vecs, threads), nw, target);
  const int64_t per_part = steps * threads;
  const dim3 grid((unsigned)nw, (unsigned)cdiv(vecs, per_part));
  row_sum_kernel<V, kDecode><<<grid, (unsigned)threads, 0, s>>>(
      words, out, mpad, per_part);
  return (int)cudaGetLastError();
}

template <bool kDecode>
int row_sum(const void* words, void* out, int64_t nw, int64_t mpad,
            int64_t threads, int64_t load_bytes, void* stream) {
  if (!valid_shape(threads, load_bytes) || mpad % (load_bytes / 4) != 0)
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (load_bytes == 4) return launch_row_sum<1, kDecode>(w, o, nw, mpad, threads, s);
  if (load_bytes == 8) return launch_row_sum<2, kDecode>(w, o, nw, mpad, threads, s);
  return launch_row_sum<4, kDecode>(w, o, nw, mpad, threads, s);
}

}  // namespace

extern "C" {

int gvamp_study_stream(const void* words, void* out, int64_t nw, int64_t mpad,
                       int64_t tm, int64_t threads, int64_t load_bytes,
                       void* stream) {
  const int64_t v = load_bytes / 4;
  if (!valid_shape(threads, load_bytes) || tm <= 0 || tm % v != 0 ||
      mpad % tm != 0)
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (v == 1) return launch_stream<1>(w, o, nw, mpad, tm, threads, s);
  if (v == 2) return launch_stream<2>(w, o, nw, mpad, tm, threads, s);
  return launch_stream<4>(w, o, nw, mpad, tm, threads, s);
}

// stream_sum and v0_stream (at bench_variants' launch configuration)
int gvamp_study_stream_sum(const void* words, void* out, int64_t nw,
                           int64_t mpad, int64_t threads, int64_t load_bytes,
                           void* stream) {
  return row_sum<false>(words, out, nw, mpad, threads, load_bytes, stream);
}

int gvamp_study_v1_decode_a(const void* words, void* out, int64_t nw,
                            int64_t mpad, int64_t threads, int64_t load_bytes,
                            void* stream) {
  return row_sum<true>(words, out, nw, mpad, threads, load_bytes, stream);
}

}  // extern "C"
