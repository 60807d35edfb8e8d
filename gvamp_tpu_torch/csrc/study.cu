// Study kernels of the PyTorch port, written by hand for Hopper (sm_90a):
// the rungs of the kernel-variant ladder between "read the packed words"
// and the product kernels of matvec.cu.  Bound through the same plain C
// interface (gvamp_tpu_torch/ops/_build.py); the wrappers and their plain
// PyTorch versions are in gvamp_tpu_torch/ops/study.py, and the tools that
// run them are gvamp_tpu_torch/tools/bench_stream.py, bench_variants.py
// and bench_round2.py.
//
// Every kernel here is an integer sum of the words (or of their decode),
// mod 2^32, or an exact int32 contraction of the decode against int8
// digits.  Integer addition is associative and commutative, so the results
// equal the plain versions bit for bit whatever the grid, the threads per
// block, the load width or the order of the atomics.  Row sums are taken in
// uint32 and the wrapper reads them as int32.
//
// Bound on this card: each kernel reads every packed word once (4*Nw*Mpad
// bytes, 10.74 GB at config B) and writes a small output, so bytes bound
// all of them.  v1_decode_a adds the SWAR a-decode of all four planes per
// word (22 integer instructions per word in its SASS on an H100),
// v2_decode_ab the b-decode too, v3_bitcast the split of the decoded
// bytes into byte rows; v5_dot1 stages the decode in shared memory and
// contracts it on the tensor cores (stage_dot below), and v7_i8decode (on
// byte rows) and v8_atxm_vt take the tensor-core fragments straight from
// the decode in registers (i8decode, atxm_vt below).  v6_fused_ab, both
// planes against one digit scale, has a source of its own (fused_ab.cu).
//
// The row sums take `threads` per block and `load_bytes` per load (4, 8 or
// 16), the two things the H100 tile sweep of bench_stream varies.  Each
// grid aims at kWaves waves of resident blocks on the card's SMs (the SM
// count is read from the device): where the output alone gives fewer
// blocks, the columns are split over gridDim.y and the parts meet in
// atomicAdd on an output the wrapper zeroed.  The wrappers launch nothing
// for an empty matrix.  Every launcher returns cudaGetLastError(); indices
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "swar.cuh"

namespace {

// resident waves of blocks each grid aims at
constexpr int64_t kWaves = 2;
// resident threads per SM on Hopper
constexpr int64_t kThreadsPerSm = 2048;

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

// The a-plane plus the b-plane (non-missing indicator) decode of all four
// bit pairs, as u32 byte lanes: each lane is at most 4 * (2 + 1) = 12.
__device__ __forceinline__ uint32_t decode_ab(uint32_t w) {
  uint32_t x = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) x += swar_a(w, k) + swar_b(w, k);
  return x;
}

// What a row sum adds per word: the word itself, or one of the decodes.
enum Decode { kIdentity, kDecodeA, kDecodeAB };

template <Decode D>
__device__ __forceinline__ uint32_t decode(uint32_t w) {
  if constexpr (D == kDecodeA) return decode_a(w);
  else if constexpr (D == kDecodeAB) return decode_ab(w);
  else return w;
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
// row_sum: out[L*r + l] = sum_m f(words[r, m]) mod 2^32, with f the
// identity (stream_sum, v0_stream), decode_a (v1_decode_a) or decode_ab
// (v2_decode_ab) and L = 1, or f = byte l of decode_a and L = 4
// (v3_bitcast: byte l of word row r is byte row 4r+l)
//
// Replaces `stream_sum` / _stream_sum_kernel (tools/bench_stream.py:50, 59),
// `v0_stream` / _v0_kernel (tools/bench_variants.py:70, 78), `v1_decode_a`
// / _v1_kernel (:90, 103), `v2_decode_ab` / _v2_kernel (:113, 126) and
// `v3_bitcast` / _v3_kernel (:138, 152).  One block row per word row
// (gridDim.x), the row's vectors split over gridDim.y where Nw alone gives
// too few blocks.  Each thread strides along its part of the row with
// V-word loads (a block reads threads*4*V contiguous bytes per step), sums
// in L registers, reduces each over its warp with __shfl_xor_sync, and
// lane 0 adds the warp's sums into the zeroed out.  v3's four byte sums are
// kept apart (at most 8*Mpad each) rather than packed, so no lane carries.
// --------------------------------------------------------------------------
template <int V, Decode D, int L>
__global__ void row_sum_kernel(const uint32_t* __restrict__ words,
                               uint32_t* __restrict__ out, int64_t mpad,
                               int64_t vecs_per_part) {
  const int64_t r = blockIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * vecs_per_part;
  const int64_t i1 = imin(mpad / V, i0 + vecs_per_part);
  const uint32_t* row = words + r * mpad;
  uint32_t acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = 0u;
#pragma unroll 4
  for (int64_t i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    uint32_t w[V];
    load_words<V>(row + i * V, w);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint32_t x = decode<D>(w[v]);
      if constexpr (L == 1) {
        acc[0] += x;
      } else {
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] += (x >> (8 * l)) & 0xFFu;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[l] += __shfl_xor_sync(0xffffffffu, acc[l], off);
    if ((threadIdx.x & 31) == 0) atomicAdd(out + r * L + l, acc[l]);
  }
}

template <int V, Decode D, int L>
int launch_row_sum(const uint32_t* words, uint32_t* out, int64_t nw,
                   int64_t mpad, int64_t threads, cudaStream_t s) {
  int64_t target = 0;
  if (const int err = target_blocks(threads, &target)) return err;
  const int64_t vecs = mpad / V;
  // parts of at least one block's step, so that no thread idles throughout
  const int64_t steps = part_length(cdiv(vecs, threads), nw, target);
  const int64_t per_part = steps * threads;
  const dim3 grid((unsigned)nw, (unsigned)cdiv(vecs, per_part));
  row_sum_kernel<V, D, L><<<grid, (unsigned)threads, 0, s>>>(
      words, out, mpad, per_part);
  return (int)cudaGetLastError();
}

template <Decode D, int L = 1>
int row_sum(const void* words, void* out, int64_t nw, int64_t mpad,
            int64_t threads, int64_t load_bytes, void* stream) {
  if (!valid_shape(threads, load_bytes) || mpad % (load_bytes / 4) != 0)
    return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (load_bytes == 4) return launch_row_sum<1, D, L>(w, o, nw, mpad, threads, s);
  if (load_bytes == 8) return launch_row_sum<2, D, L>(w, o, nw, mpad, threads, s);
  return launch_row_sum<4, D, L>(w, o, nw, mpad, threads, s);
}

// --------------------------------------------------------------------------
// stage_dot: zt[d][k][p] = sum_m a_k[m, p] * wdig[d][m]  (v5_dot1)
//
// Replaces `v5_dot1` / _v5_kernel (tools/bench_variants.py:164, 179) with
// the contract of axm_i8a (fragments.cu): int32[D, 4, 4*Nw], digit rows
// int8[D, Mpad], |sum| <= 254*Mpad, which the wrapper keeps below 2^31.
//
// Bound on this card: the one read of the packed words, as for the row
// sums.  The contraction (2*16*Nw*Mpad*D int8 operations) takes the tensor
// cores about a ninth of the read's time at D = 8; the decode and the
// staging's shared-memory traffic (32 bytes per word) are what this rung
// measures.
//
// Design, the H100 counterpart of the TPU rung's VMEM scratch and one MXU
// dot per tile.  A block owns kDotTnw word rows and walks marker tiles of
// kDotTm.  Per tile, (a) every thread loads word quads (16 bytes, four
// neighbouring markers of one row), transposes their bytes with
// __byte_perm and decodes each plane k, so that one u32 holds the dosages
// of planar row (k, 4i+b) for four consecutive markers, and stores it into
// the shared int8 scratch sa[k][4i+b][markers]; the tile's digit rows go
// to sw beside it.  (b) One contraction of the whole stacked scratch
// (16*kDotTnw rows x kDotTm) against the digit rows (kDotTm x 8) runs as
// mma.sync m16n8k32 s8 x s8 -> s32, each warp owning a fixed set of 16-row
// groups whose int32 sums stay in registers across the tiles.  The scratch
// rows are padded by 4 words so that the fragment loads hit 32 banks.  The
// next tile's words and digits are loaded while the current one is
// contracted.  Tiles of 16 word rows x 128 markers keep a block's shared
// memory near 38 KB, so that five or six blocks share an SM and hide each
// other's barriers and load latency.  A block handles 8 digit rows (the
// mma's n; gridDim.z takes the rest, and digit rows past D are zero);
// marker tiles split over gridDim.y, and the parts meet in atomicAdd on
// the zeroed output.  Word rows past Nw and markers past Mpad are staged
// as the missing code (a = 0) against zero digits; rows past Nw are never
// written.
// --------------------------------------------------------------------------
constexpr int kDotThreads = 256;
constexpr int kDotWarps = kDotThreads / 32;
constexpr int kDotTm = 128;       // markers per tile
constexpr int kDotQuads = kDotTm / 4;
constexpr int kDotN = 8;          // digit rows per block: the mma's n
// one warp loads each digit row, one lane each quad of a tile row
static_assert(kDotWarps == kDotN && kDotQuads == 32, "stage_dot layout");
constexpr int kDotPad = 4;        // words of padding per scratch row

constexpr int kDotTnw = 16;                      // word rows per block
constexpr int kDotRows = 16 * kDotTnw;           // 4 planes x 4*kDotTnw
constexpr int kDotStride = kDotQuads + kDotPad;  // scratch row, words
constexpr int kDotGroupsPerWarp = kDotRows / 16 / kDotWarps;
constexpr int kDotQuadsPerThread = kDotTnw * kDotQuads / kDotThreads;
constexpr int kDotSmem = (kDotRows + kDotN) * kDotStride * 4;  // bytes

__global__ void __launch_bounds__(kDotThreads)
stage_dot_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ wdig,   // int32 view [D, Mpad/4]
                 int32_t* __restrict__ out,          // [D, 4, 4*Nw]
                 int64_t nw, int64_t mpad, int64_t d_total,
                 int64_t tiles_per_part) {
  extern __shared__ int32_t smem[];
  int32_t* sa = smem;                          // [kDotRows][kDotStride]
  int32_t* sw = smem + kDotRows * kDotStride;  // [kDotN][kDotStride] digits
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group, thread
  const int64_t r0 = (int64_t)blockIdx.x * kDotTnw;
  const int64_t nq = mpad / 4;
  const int64_t tiles = (nq + kDotQuads - 1) / kDotQuads;
  const int64_t j0 = (int64_t)blockIdx.y * tiles_per_part;
  const int64_t j1 = imin(tiles, j0 + tiles_per_part);
  const int64_t d = (int64_t)blockIdx.z * kDotN + warp;  // digit row loaded

  int32_t acc[kDotGroupsPerWarp][4];
#pragma unroll
  for (int h = 0; h < kDotGroupsPerWarp; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[h][c] = 0;

  // A thread stages quad `lane` of word rows warp + 8s of every tile, so a
  // warp reads 512 contiguous bytes of one row and stores 32 consecutive
  // scratch words; each warp loads digit row `warp` of the block's eight.
  const int64_t rows_left = nw - r0 - warp;
  const uint4* src =
      reinterpret_cast<const uint4*>(words + imin(r0 + warp, nw - 1) * mpad);
  const int64_t row_step = kDotWarps * nq;  // uint4 per kDotWarps rows
  int32_t* dst = sa + 4 * warp * kDotStride + lane;
  const bool live_d = d < d_total;
  uint4 x[kDotQuadsPerThread];
  int32_t wq = 0;  // this lane's digit quad of row d
  auto load = [&](int64_t j) {
    const int64_t q = j * kDotQuads + lane;
#pragma unroll
    for (int s = 0; s < kDotQuadsPerThread; ++s)
      x[s] = kDotWarps * s < rows_left && q < nq
                 ? __ldg(src + s * row_step + q)
                 : make_uint4(0x55555555u, 0x55555555u, 0x55555555u,
                              0x55555555u);
    wq = live_d && q < nq ? __ldg(wdig + d * nq + q) : 0;
  };
  if (j0 < j1) load(j0);
  for (int64_t j = j0; j < j1; ++j) {
    // (a) the decode of all four planes into the scratch, the digit rows
#pragma unroll
    for (int s = 0; s < kDotQuadsPerThread; ++s) {
      uint32_t y[4];
      transpose_quad(x[s], y);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          dst[(k * 4 * kDotTnw + 4 * kDotWarps * s + b) * kDotStride] =
              (int32_t)swar_a(y[b], k);
    }
    sw[warp * kDotStride + lane] = wq;
    __syncthreads();
    if (j + 1 < j1) load(j + 1);  // in flight during the contraction
    // (b) one contraction of the stacked scratch against the digit rows
#pragma unroll
    for (int ks = 0; ks < kDotTm / 32; ++ks) {
      const int32_t* bw = sw + g * kDotStride + ks * 8 + t;
      const uint32_t b0 = (uint32_t)bw[0], b1 = (uint32_t)bw[4];
#pragma unroll
      for (int h = 0; h < kDotGroupsPerWarp; ++h) {
        const int32_t* aw =
            sa + ((warp * kDotGroupsPerWarp + h) * 16 + g) * kDotStride +
            ks * 8 + t;
        const uint32_t a[4] = {(uint32_t)aw[0], (uint32_t)aw[8 * kDotStride],
                               (uint32_t)aw[4],
                               (uint32_t)aw[8 * kDotStride + 4]};
        mma_s8(acc[h], a, b0, b1);
      }
    }
    __syncthreads();
  }
  // acc[h][2*half + c] is scratch row (group h) + g + 8*half, digit row
  // blockIdx.z*8 + 2t + c
  const int64_t nb = 4 * nw;
#pragma unroll
  for (int h = 0; h < kDotGroupsPerWarp; ++h)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (warp * kDotGroupsPerWarp + h) * 16 + g + 8 * half;
      const int k = r / (4 * kDotTnw);
      const int64_t p = 4 * r0 + r % (4 * kDotTnw);
      if (p >= nb) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t dc = (int64_t)blockIdx.z * kDotN + 2 * t + c;
        if (dc < d_total)
          atomicAdd(out + (dc * 4 + k) * nb + p, acc[h][2 * half + c]);
      }
    }
}

int stage_dot(const void* words, const void* wdig, void* out, int64_t nw,
              int64_t mpad, int64_t d_total, void* stream) {
  if (nw <= 0 || mpad <= 0 || mpad % 4 != 0 || d_total <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDotSmem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's unified memory that can be shared, so that the most
  // blocks fit
  err = cudaFuncSetAttribute(stage_dot_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int64_t target = 0;
  if (const int e =
          dot_target(stage_dot_kernel, kDotThreads, kDotSmem, &target))
    return e;
  const int64_t tiles = cdiv(mpad / 4, kDotQuads);
  const int64_t rows = cdiv(nw, kDotTnw), groups = cdiv(d_total, kDotN);
  const int64_t per_part = part_length(tiles, rows * groups, target);
  const dim3 grid((unsigned)rows, (unsigned)cdiv(tiles, per_part),
                  (unsigned)groups);
  stage_dot_kernel<<<grid, kDotThreads, kDotSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(wdig),
      static_cast<int32_t*>(out), nw, mpad, d_total, per_part);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// i8decode: zt[d][k][p] = sum_m a_k(bytes8[p, m]) * wdig[d][m]
//
// Replaces `v7_i8decode` / _v7_kernel (tools/bench_variants.py:277, 296,
// and the same body at tools/bench_round2.py:83, 102) with axm_i8a's
// contract: the words pre-expanded to byte rows int8[4*Nw, Mpad] (row 4i+b
// is byte b of word row i), digit rows int8[D, Mpad], int32[D, 4, 4*Nw]
// out, |sum| <= 254*Mpad (the wrapper keeps it below 2^31).
//
// Bound on this card: the one read of the bytes (the 4*Nw*Mpad bytes of
// the words), as for axm_i8a; the contraction takes the tensor cores about
// a ninth of it at D = 8.
//
// Design: tensor-core fragments straight from the SWAR decode, with no
// shared memory, no barrier and no byte transpose.  A u32 of one byte row
// holds four neighbouring markers of one person row; its a-decode for
// plane k is four int8 dosages along the contraction axis, which is one
// .b32 register of an m16n8k32 A fragment (row major), and the same u32
// of a digit row is one register of the B fragment.  A warp owns 16 byte
// rows (the mma's m) x 8 digit rows (n) and walks the markers kI8Chunk =
// 128 at a time: lane (g, t) loads 32 bytes at markers m0+32t of byte rows
// r0+g and r0+g+8 and of digit row d0+g, so each row of the warp is read
// 128 contiguous bytes per step.  Contraction index 4t+j of the k-step
// (l, s) is marker 32t+16l+8s+j and index 16+4t+j marker 32t+16l+8s+4+j,
// in both fragments, so the mma sums the same products as in marker
// order.  Each plane keeps its own
// C fragment in registers (16 int32).  The warps of a block own
// consecutive row groups at the same markers, so they share the digit
// loads in L1.  Marker chunks split over gridDim.y, digit rows over
// gridDim.z; the parts meet in atomicAdd on the zeroed output.  Rows past
// 4*Nw and digit rows past D read the last valid row again (their sums
// are never written).  Whole chunks load unmasked; markers past Mpad occur
// only in the last chunk, whose masked step loads them as zero bytes (the
// zero digits cancel whatever a zero byte decodes to).  The 128-byte row
// segments matter: with 64 bytes per row and step (one 16-byte load per
// row and lane) the same kernel ran at 1.7 times the read at config B on
// an H100 (chip_smoke.py phase 3s), as slow as the staged v5_dot1.  kVec:
// 16-byte loads where Mpad is a multiple of 16 (every row aligned), else
// 4-byte loads.
// --------------------------------------------------------------------------
constexpr int kI8Threads = 256;
constexpr int kI8Warps = kI8Threads / 32;
constexpr int kI8Rows = 16 * kI8Warps;  // byte rows per block
constexpr int kI8Loads = 2;  // 16-byte loads per row and lane in a step
constexpr int kI8Chunk = 64 * kI8Loads;  // markers per step

// 16 bytes of one byte row (or digit row) at markers m..m+15: one 16-byte
// load (kVec) or four 4-byte loads; with kMasked, bytes past Mpad read as
// zero.
template <bool kVec, bool kMasked>
__device__ __forceinline__ uint4 load_bytes16(const uint8_t* row, int64_t m,
                                              int64_t mpad) {
  if constexpr (kVec) {
    if (kMasked && m >= mpad) return zero4();
    return __ldg(reinterpret_cast<const uint4*>(row + m));
  } else {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = kMasked && m + 4 * q >= mpad
                 ? 0u
                 : __ldg(reinterpret_cast<const uint32_t*>(row + m + 4 * q));
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// One step of kI8Chunk markers from marker m0 of one warp's rows: lane
// (g, t) loads kI8Loads x 16 bytes at m0+32t of byte rows g and g+8 and of
// digit row g (the row pointers carry the 32t), decodes them and
// contracts them into acc[plane], two k-steps per 16 bytes.
template <bool kVec, bool kMasked>
__device__ __forceinline__ void i8decode_step(const uint8_t* row0,
                                              const uint8_t* row1,
                                              const uint8_t* rowd, int64_t m,
                                              int64_t mpad,
                                              int32_t acc[4][4]) {
  uint4 x0[kI8Loads], x1[kI8Loads], w[kI8Loads];
#pragma unroll
  for (int l = 0; l < kI8Loads; ++l) {
    x0[l] = load_bytes16<kVec, kMasked>(row0, m + 16 * l, mpad);
    x1[l] = load_bytes16<kVec, kMasked>(row1, m + 16 * l, mpad);
    w[l] = load_bytes16<kVec, kMasked>(rowd, m + 16 * l, mpad);
  }
#pragma unroll
  for (int l = 0; l < kI8Loads; ++l) {
    // the decoded fields of row g's and row g+8's four words
    const uint32_t f0[4] = {swar_a_fields(x0[l].x), swar_a_fields(x0[l].y),
                            swar_a_fields(x0[l].z), swar_a_fields(x0[l].w)};
    const uint32_t f1[4] = {swar_a_fields(x1[l].x), swar_a_fields(x1[l].y),
                            swar_a_fields(x1[l].z), swar_a_fields(x1[l].w)};
    const uint32_t dw[4] = {w[l].x, w[l].y, w[l].z, w[l].w};
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // a0 (row g), a1 (row g+8), a2 and a3 (the same, 4 markers on)
        const uint32_t a[4] = {plane(f0[2 * s], k), plane(f1[2 * s], k),
                               plane(f0[2 * s + 1], k),
                               plane(f1[2 * s + 1], k)};
        mma_s8(acc[k], a, dw[2 * s], dw[2 * s + 1]);
      }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kI8Threads)
i8decode_kernel(const uint8_t* __restrict__ bytes8,  // [N8, Mpad]
                const uint8_t* __restrict__ wdig,    // [D, Mpad]
                int32_t* __restrict__ out,           // [D, 4, N8]
                int64_t n8, int64_t mpad, int64_t d_total,
                int64_t chunks_per_part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group, thread
  const int64_t r0 = (int64_t)blockIdx.x * kI8Rows + 16 * warp;
  if (r0 >= n8) return;  // no barrier in this kernel
  const int64_t d0 = (int64_t)blockIdx.z * 8;
  const int64_t chunks = (mpad + kI8Chunk - 1) / kI8Chunk;
  const int64_t j0 = (int64_t)blockIdx.y * chunks_per_part;
  const int64_t j1 = imin(chunks, j0 + chunks_per_part);
  // rows past 4*Nw and digit rows past D read the last one again: their
  // sums are never written
  const int64_t lane_m = kI8Chunk / 4 * t;  // this lane's first marker
  const uint8_t* row0 = bytes8 + imin(r0 + g, n8 - 1) * mpad + lane_m;
  const uint8_t* row1 = bytes8 + imin(r0 + g + 8, n8 - 1) * mpad + lane_m;
  const uint8_t* rowd = wdig + imin(d0 + g, d_total - 1) * mpad + lane_m;
  const int64_t lane_mpad = mpad - lane_m;  // markers past Mpad, per lane

  int32_t acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[k][c] = 0;

  // whole chunks with unmasked loads, so that the compiler issues the
  // loads of the unrolled steps together; then the partial last chunk
  const int64_t jf = imin(j1, mpad / kI8Chunk);
#pragma unroll 2
  for (int64_t j = j0; j < jf; ++j)
    i8decode_step<kVec, false>(row0, row1, rowd, j * kI8Chunk, lane_mpad,
                               acc);
  if (jf < j1)
    i8decode_step<kVec, true>(row0, row1, rowd, jf * kI8Chunk, lane_mpad,
                              acc);
  // acc[k][2*half + c] is byte row r0 + g + 8*half, digit row d0 + 2t + c
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t p = r0 + g + 8 * half;
    if (p >= n8) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int64_t d = d0 + 2 * t + c;
      if (d >= d_total) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int32_t* o = out + (d * 4 + k) * n8 + p;
        if (gridDim.y == 1)
          *o = acc[k][2 * half + c];
        else
          atomicAdd(o, acc[k][2 * half + c]);
      }
    }
  }
}

template <bool kVec>
int launch_i8decode(const uint8_t* bytes8, const uint8_t* wdig, int32_t* out,
                    int64_t n8, int64_t mpad, int64_t d_total,
                    cudaStream_t s) {
  auto kernel = i8decode_kernel<kVec>;
  int64_t target = 0;
  if (const int e = dot_target(kernel, kI8Threads, 0, &target)) return e;
  const int64_t rows = cdiv(n8, kI8Rows), groups = cdiv(d_total, 8);
  const int64_t chunks = cdiv(mpad, kI8Chunk);
  const int64_t per_part = part_length(chunks, rows * groups, target);
  const dim3 grid((unsigned)rows, (unsigned)cdiv(chunks, per_part),
                  (unsigned)groups);
  kernel<<<grid, kI8Threads, 0, s>>>(bytes8, wdig, out, n8, mpad, d_total,
                                     per_part);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// atxm_vt: av[d][m] = sum_k sum_p a_k[p, m] * vdig[k][d][p]
//
// Replaces `v8_atxm_vt` / _v8_kernel (tools/bench_round2.py:40, 58) with
// atxm_i8a's contract: words int32[Nw, Mpad], the digits of V transposed to
// int8[4, D, 4*Nw] (matvec._quant_digits_t), int32[D, Mpad] out,
// |sum| <= 254*16*Nw (the wrapper keeps it below 2^31).
//
// Bound on this card: the one read of the words, as for atxm_i8a.
//
// Design: the contraction runs over people, with the markers as the mma's
// m.  One word of one marker, decoded for plane k, holds the a-plane values
// of people 4i..4i+3 in byte order: one .b32 register of an m16n8k32 A
// fragment (row = marker, column = person), with no transpose; four
// consecutive people of one digit row are one aligned u32 of the
// [4, D, 4*Nw] digits: one register of the B fragment.  A warp owns 64
// markers (four m tiles) x 8 digit rows and walks the word rows 8 at a
// time (32 people of every plane per mma): lane (g, t) loads 16 bytes at
// each of markers m0+32l+4g (l = 0, 1) of word rows i0+t and i0+t+4, so
// each of the warp's 8 word rows is read in 128-byte segments; m tile
// (l, h) takes markers m0+32l+4g+2h (fragment row g) and m0+32l+4g+2h+1
// (row g+8).  For plane k, b0 and b1 are the u32 of digit row d0+g at
// people 4(i0+t) and 4(i0+t+4), shared by the four tiles, so a step loads
// 32 bytes of digits per lane for 128 bytes of words.  The four planes
// accumulate into the same C fragments (16 int32).  The warps
// of a block walk the same word rows, so they share the digit loads in
// L1.  Word-row steps split over gridDim.y, digit rows over gridDim.z; the
// parts meet in atomicAdd on the zeroed output.  Markers past Mpad (Mpad
// is a multiple of 4, so a 16-byte load is all in or all out) and digit
// rows past D read the last valid ones again and are not written.  Whole
// steps load unmasked, as in i8decode; word rows past Nw occur only in the
// last step, whose masked step loads them as zero words against zero
// digits.
// --------------------------------------------------------------------------
constexpr int kVtThreads = 256;
constexpr int kVtLoads = 2;  // 16-byte loads per word row and lane in a step
constexpr int kVtWarpMarkers = 32 * kVtLoads;
constexpr int kVtMarkers = kVtWarpMarkers * (kVtThreads / 32);  // per block

// One step of 8 word rows (32 people of every plane) from word row 8*st:
// lane (g, t) loads its markers' words (16 bytes at each of wp[l]) of rows
// 8st+t and 8st+t+4, and for each plane the digits of those people in its
// digit row, and contracts them into the m tiles' C fragments.  With
// kMasked, word rows past Nw load as zero words against zero digits.
template <bool kMasked>
__device__ __forceinline__ void atxm_vt_step(const uint32_t* const wp[],
                                             const uint8_t* vp,
                                             int64_t plane_bytes, int64_t nw,
                                             int64_t mpad, int64_t st,
                                             int32_t acc[][4]) {
  const int t = threadIdx.x & 3;
  const int64_t ia = 8 * st + t, ib = ia + 4;  // word rows of a0/a1, a2/a3
  const bool la = !kMasked || ia < nw, lb = !kMasked || ib < nw;
  uint4 xa[kVtLoads], xb[kVtLoads];
#pragma unroll
  for (int l = 0; l < kVtLoads; ++l) {
    xa[l] = la ? __ldg(reinterpret_cast<const uint4*>(wp[l] + ia * mpad))
               : zero4();
    xb[l] = lb ? __ldg(reinterpret_cast<const uint4*>(wp[l] + ib * mpad))
               : zero4();
  }
  // the decoded fields of the markers' words in rows ia and ib
  uint32_t fa[kVtLoads][4], fb[kVtLoads][4];
#pragma unroll
  for (int l = 0; l < kVtLoads; ++l) {
    const uint32_t wa[4] = {xa[l].x, xa[l].y, xa[l].z, xa[l].w};
    const uint32_t wb[4] = {xb[l].x, xb[l].y, xb[l].z, xb[l].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      fa[l][q] = swar_a_fields(wa[q]);
      fb[l][q] = swar_a_fields(wb[q]);
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
    for (int l = 0; l < kVtLoads; ++l)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a[4] = {plane(fa[l][2 * h], k),
                               plane(fa[l][2 * h + 1], k),
                               plane(fb[l][2 * h], k),
                               plane(fb[l][2 * h + 1], k)};
        mma_s8(acc[2 * l + h], a, b0, b1);
      }
  }
}

__global__ void __launch_bounds__(kVtThreads)
atxm_vt_kernel(const uint32_t* __restrict__ words,  // [Nw, Mpad]
               const uint8_t* __restrict__ vdig,    // [4, D, 4*Nw]
               int32_t* __restrict__ out,           // [D, Mpad]
               int64_t nw, int64_t mpad, int64_t d_total,
               int64_t steps_per_part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t m0 =
      (int64_t)blockIdx.x * kVtMarkers + (int64_t)kVtWarpMarkers * warp;
  if (m0 >= mpad) return;  // no barrier in this kernel
  const int64_t d0 = (int64_t)blockIdx.z * 8;
  const int64_t nb = 4 * nw;
  const int64_t steps = (nw + 7) / 8;
  const int64_t i_lo = (int64_t)blockIdx.y * steps_per_part;
  const int64_t i_hi = imin(steps, i_lo + steps_per_part);
  // this lane's markers m0+32l+4g..+3; markers past Mpad and digit rows
  // past D read the last valid ones again: their sums are never written
  const uint32_t* wp[kVtLoads];
#pragma unroll
  for (int l = 0; l < kVtLoads; ++l)
    wp[l] = words + imin(m0 + 32 * l + 4 * g, mpad - 4);
  // digit row d0+g of plane 0; plane k is k*D*Nb bytes on
  const uint8_t* vp = vdig + imin(d0 + g, d_total - 1) * nb;
  const int64_t plane_bytes = d_total * nb;

  int32_t acc[2 * kVtLoads][4];
#pragma unroll
  for (int h = 0; h < 2 * kVtLoads; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[h][c] = 0;

  // whole steps with unmasked loads, then the partial last step
  const int64_t sf = imin(i_hi, nw / 8);
#pragma unroll 2
  for (int64_t st = i_lo; st < sf; ++st)
    atxm_vt_step<false>(wp, vp, plane_bytes, nw, mpad, st, acc);
  if (sf < i_hi) atxm_vt_step<true>(wp, vp, plane_bytes, nw, mpad, sf, acc);
  // acc[2l + h][2*half + c] is marker m0 + 32l + 4g + 2h + half, digit row
  // d0 + 2t + c
#pragma unroll
  for (int lh = 0; lh < 2 * kVtLoads; ++lh)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + 32 * (lh / 2) + 4 * g + 2 * (lh % 2) + half;
      if (m >= mpad) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t d = d0 + 2 * t + c;
        if (d >= d_total) continue;
        int32_t* o = out + d * mpad + m;
        if (gridDim.y == 1)
          *o = acc[lh][2 * half + c];
        else
          atomicAdd(o, acc[lh][2 * half + c]);
      }
    }
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
  return row_sum<kIdentity>(words, out, nw, mpad, threads, load_bytes,
                            stream);
}

int gvamp_study_v1_decode_a(const void* words, void* out, int64_t nw,
                            int64_t mpad, int64_t threads, int64_t load_bytes,
                            void* stream) {
  return row_sum<kDecodeA>(words, out, nw, mpad, threads, load_bytes, stream);
}

int gvamp_study_v2_decode_ab(const void* words, void* out, int64_t nw,
                             int64_t mpad, int64_t threads,
                             int64_t load_bytes, void* stream) {
  return row_sum<kDecodeAB>(words, out, nw, mpad, threads, load_bytes,
                            stream);
}

// out is int32[1, 4*Nw]
int gvamp_study_v3_bitcast(const void* words, void* out, int64_t nw,
                           int64_t mpad, int64_t threads, int64_t load_bytes,
                           void* stream) {
  return row_sum<kDecodeA, 4>(words, out, nw, mpad, threads, load_bytes,
                              stream);
}

int gvamp_study_v5_dot1(const void* words, const void* wdig, void* out,
                        int64_t nw, int64_t mpad, int64_t d_total,
                        void* stream) {
  return stage_dot(words, wdig, out, nw, mpad, d_total, stream);
}

// bytes8 int8[N8, Mpad] (N8 = 4*Nw), wdig int8[D, Mpad], out int32[D, 4, N8]
// (v7_i8decode and bench_round2's v7_i8decode)
int gvamp_study_i8decode(const void* bytes8, const void* wdig, void* out,
                         int64_t n8, int64_t mpad, int64_t d_total,
                         void* stream) {
  if (n8 <= 0 || mpad <= 0 || mpad % 4 != 0 || d_total <= 0)
    return (int)cudaErrorInvalidValue;
  const auto* b = static_cast<const uint8_t*>(bytes8);
  const auto* w = static_cast<const uint8_t*>(wdig);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = mpad % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_i8decode<true>(b, w, o, n8, mpad, d_total, s)
             : launch_i8decode<false>(b, w, o, n8, mpad, d_total, s);
}

// words int32[Nw, Mpad], vdig int8[4, D, 4*Nw], out int32[D, Mpad]
int gvamp_study_v8_atxm_vt(const void* words, const void* vdig, void* out,
                           int64_t nw, int64_t mpad, int64_t d_total,
                           void* stream) {
  if (nw <= 0 || mpad <= 0 || mpad % 4 != 0 || d_total <= 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int64_t target = 0;
  if (const int e = dot_target(atxm_vt_kernel, kVtThreads, 0, &target))
    return e;
  const int64_t cols = cdiv(mpad, kVtMarkers), groups = cdiv(d_total, 8);
  const int64_t steps = cdiv(nw, 8);
  const int64_t per_part = part_length(steps, cols * groups, target);
  const dim3 grid((unsigned)cols, (unsigned)cdiv(steps, per_part),
                  (unsigned)groups);
  atxm_vt_kernel<<<grid, kVtThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint8_t*>(vdig),
      static_cast<int32_t*>(out), nw, mpad, d_total, per_part);
  return (int)cudaGetLastError();
}

}  // extern "C"
