// The mma.sync of the port's tensor-core kernels: int8 (study.cu,
// fragments.cu, gram_aat.cu, gram_prim.cu) and bf16 (bf16_split.cu); the
// integer and grid helpers of every source, and the f32 fold of the fused
// Grams' digit sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// c += a * b on the tensor cores: m16n8k32, int8 x int8 -> int32, exact.
// Lane (g, t) = (lane / 4, lane % 4) holds A rows g (a[0], a[2]) and g+8
// (a[1], a[3]) at contraction indices 4t..4t+3 (a[0], a[1]) and
// 16+4t..16+4t+3 (a[2], a[3]); B column g at 4t.. (b0) and 16+4t.. (b1);
// C rows g (c[0], c[1]) and g+8 (c[2], c[3]) at columns 2t and 2t+1.
__device__ __forceinline__ void mma_s8(int32_t c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with A unsigned (u8 x s8 -> s32): for A values up to 255, such
// as the decoded planes at the top of their bytes (swar.cuh, plane64).
__device__ __forceinline__ void mma_u8s8(int32_t c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b on the tensor cores: m16n8k16, bf16 x bf16 -> f32.  Lane (g,
// t) holds A rows g (a[0], a[2]) and g+8 (a[1], a[3]) at contraction
// indices 2t, 2t+1 (a[0], a[1]) and 2t+8, 2t+9 (a[2], a[3]), two bf16 per
// register, the lower index in the low half; B column g at 2t, 2t+1 (b0)
// and 2t+8, 2t+9 (b1); C rows g (c[0], c[1]) and g+8 (c[2], c[3]) at
// columns 2t and 2t+1.  Products of bf16 values are exact in f32; how the
// tensor cores add them to c is not IEEE round-to-nearest (bf16_split.cu
// keeps its chains short for that).  With kZero, c is written, not read:
// the first mma of a chain.
template <bool kZero = false>
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kZero) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// t[0] s0 + t[1] s1 + t[2] s2 + t[3] s3, left to right, each step rounded
// to nearest (no FMA contraction), as the plain versions' separate torch
// ops round: the digit fold of the fused Grams (gram_prim.cu, gram_aat.cu)
__device__ __forceinline__ float fold4(const int32_t t[4], const float s[4]) {
  float acc = __fmul_rn((float)t[0], s[0]);
#pragma unroll
  for (int d = 1; d < 4; ++d) acc = __fadd_rn(acc, __fmul_rn((float)t[d], s[d]));
  return acc;
}

// Split `n` units of work into parts so that `blocks` blocks times the part
// count reaches the target (at most `n` parts); returns units per part.
inline int64_t part_length(int64_t n, int64_t blocks, int64_t target) {
  int64_t parts = cdiv(target, blocks > 0 ? blocks : 1);
  if (parts < 1) parts = 1;
  if (parts > n) parts = n;
  if (parts > 65535) parts = 65535;  // gridDim.y
  return n > 0 ? cdiv(n, parts) : 1;
}

// resident waves of blocks a tensor-core grid aims at: enough that the
// last wave's share of the work stays small
constexpr int64_t kDotWaves = 8;

// Blocks a tensor-core grid should reach: kDotWaves waves of the blocks of
// `kernel` that fit an SM at once on this device.  Returns a CUDA error.
template <typename Kernel>
int dot_target(Kernel kernel, int threads, int smem, int64_t* target) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *target = kDotWaves * sms * per_sm;
  return 0;
}

}  // namespace
