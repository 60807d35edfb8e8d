// The SWAR decode of packed genotype words, shared by every kernel of the
// port (matvec.cu, study.cu) so that all of them decode with the same code.
//
// A word holds 16 samples as 2-bit codes; byte b of word-row i holds the
// codes of planar rows (k, 4i+b), k = bit pair.  swar_a(w, k) turns plane k
// into a u32 whose byte b is the dosage a = {2,0,1,0}[code] of row 4i+b;
// swar_b(w, k) gives the non-missing indicator b = {1,0,1,1}[code] the same
// way (gvamp_tpu/ops/matvec.py, _swar).

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kM1 = 0x01010101u;
constexpr uint32_t kM3 = 0x03030303u;

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

}  // namespace
