// The SWAR decode of packed genotype words, shared by every kernel of the
// port (matvec.cu, study.cu, fragments.cu, bf16_split.cu and the fused
// Grams) so that all of them decode with the same code.
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
constexpr uint32_t kM5 = 0x55555555u;

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

// The a-plane decode of all four bit pairs of a word at once.  Each 2-bit
// field of w (low bit lo, high bit hi) becomes 2*(1-lo) - hi*(1-lo), in
// {0, 1, 2}, in place: no field borrows from the next, so one subtraction
// decodes all sixteen codes, and plane(a, k), the field at bit 2k of every
// byte (a shift and a mask), equals swar_a(w, k).
__device__ __forceinline__ uint32_t swar_a_fields(uint32_t w) {
  const uint32_t notlo = ~w & kM5;
  return (notlo << 1) - ((w >> 1) & notlo);
}

// The b-plane decode of all four bit pairs at once: hi | (1-lo) in the low
// bit of each field, 0 in the high bit, so plane(b, k) equals swar_b(w, k).
__device__ __forceinline__ uint32_t swar_b_fields(uint32_t w) {
  return (~w | (w >> 1)) & kM5;
}

// Plane k of decoded fields: byte b holds the field at bits 2k, 2k+1 of
// byte b, one int8 value per byte.
__device__ __forceinline__ uint32_t plane(uint32_t fields, int k) {
  return (fields >> (2 * k)) & kM3;
}

// Plane k of decoded fields moved to the top two bits of each byte: byte b
// holds 64 times the field, a u8 in {0, 64, 128}.  A left shift and a mask
// (only the mask for k = 3): cheaper on the integer pipe than plane(),
// whose right shift has no counterpart on the multiply-add pipe.
__device__ __forceinline__ uint32_t plane64(uint32_t fields, int k) {
  return (fields << (6 - 2 * k)) & 0xC0C0C0C0u;
}

// Four neighbouring marker words (one 16-byte load) -> y[b] whose byte j is
// byte b of marker word j: the decode of y[b] then holds the values of
// planar row (k, 4i+b) for four consecutive markers, in the int8x4 order of
// a __dp4a operand or of one register of an mma fragment.
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

}  // namespace
