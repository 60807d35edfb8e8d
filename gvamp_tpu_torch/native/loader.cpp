// Native data-loader: PLINK .bed slab -> planar word-major uint32 matrix.
//
// The TPU-native replacement for the reference's C++/MPI-IO genotype loader
// (read_genotype_data, data.cpp:201-234 + the marker-major byte layout the
// AVX kernels consume).  Our device kernels consume uint32[n_words, Mpad]
// word-major tiles (gvamp_tpu/ops/layout.py); producing that layout from a
// marker-major .bed is a large blocked transpose, which numpy does
// single-threaded and out-of-cache.  This library does it with OpenMP +
// cache-blocked tiles, reading the file slab with positioned reads.
//
// Layout contract (must match PlanarLayout.pack_words, layout.py:114-132):
//   * each marker row is mbytes = ceil(N/4) bytes, padded with 0x55 bytes
//     (four PLINK "01" missing codes) out to 4*n_words bytes;
//   * the tail byte's unused 2-bit codes (sample index >= N) are forced to
//     the missing code 01;
//   * out[w * Mpad + m] = little-endian uint32 of bytes [4w, 4w+4) of
//     marker m; marker columns beyond M are all-0x55 words.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC loader.cpp -o ...
// Exposed via ctypes (gvamp_tpu/native/__init__.py); no pybind11 needed.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>

#include <fcntl.h>
#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint8_t kPadByte = 0x55;
constexpr int64_t kTileM = 64;     // markers per tile
constexpr int64_t kTileW = 512;    // words per tile (2 KiB of a marker row)

// Fix the tail byte of one marker row in place (codes for n >= N -> 01).
inline void fix_tail(uint8_t* row, int64_t mbytes, int64_t N) {
  const int tail = static_cast<int>(N % 4);
  if (tail == 0) return;
  const uint8_t keep = static_cast<uint8_t>((1u << (2 * tail)) - 1u);
  row[mbytes - 1] =
      (row[mbytes - 1] & keep) | (kPadByte & static_cast<uint8_t>(~keep));
}

// Transpose one padded marker-major slab tile into the word-major output.
void transpose_block(const uint8_t* bed, int64_t M, int64_t mbytes,
                     uint32_t* out, int64_t n_words, int64_t Mpad,
                     int64_t m0, int64_t m1, int64_t w0, int64_t w1) {
  for (int64_t m = m0; m < m1; ++m) {
    const uint8_t* row = bed + m * mbytes;
    for (int64_t w = w0; w < w1; ++w) {
      uint32_t v;
      const int64_t b = 4 * w;
      if (b + 4 <= mbytes) {
        std::memcpy(&v, row + b, 4);
      } else {
        uint8_t tmp[4] = {kPadByte, kPadByte, kPadByte, kPadByte};
        for (int64_t k = b; k < mbytes; ++k) tmp[k - b] = row[k];
        std::memcpy(&v, tmp, 4);
      }
      out[w * Mpad + m] = v;
    }
  }
}

}  // namespace

extern "C" {

// bed: uint8[M, mbytes] marker-major slab (will NOT be modified).
// out: uint32[n_words, Mpad] pre-allocated; fully overwritten.
// Returns 0 on success.
int gvamp_bed_to_words(const uint8_t* bed, int64_t M, int64_t mbytes,
                       int64_t N, uint32_t* out, int64_t n_words,
                       int64_t Mpad) {
  if (4 * n_words < mbytes || Mpad < M) return 1;

  // Pad columns beyond M with all-missing words.
  const uint32_t pad_word = 0x55555555u;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t w = 0; w < n_words; ++w)
    for (int64_t m = M; m < Mpad; ++m) out[w * Mpad + m] = pad_word;

  const int tail = static_cast<int>(N % 4);
  const uint8_t keep = static_cast<uint8_t>((1u << (2 * tail)) - 1u);
  const uint8_t pad_bits = kPadByte & static_cast<uint8_t>(~keep);

  const int64_t n_tiles_m = (M + kTileM - 1) / kTileM;
  const int64_t n_tiles_w = (n_words + kTileW - 1) / kTileW;
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int64_t tm = 0; tm < n_tiles_m; ++tm)
    for (int64_t tw = 0; tw < n_tiles_w; ++tw) {
      const int64_t m0 = tm * kTileM, m1 = std::min(M, m0 + kTileM);
      const int64_t w0 = tw * kTileW, w1 = std::min(n_words, w0 + kTileW);
      transpose_block(bed, M, mbytes, out, n_words, Mpad, m0, m1, w0, w1);
    }

  // Tail-code masking on the word containing the last real byte.
  if (tail != 0) {
    const int64_t j = (N + 3) / 4 - 1;  // last real byte index
    const int64_t w = j / 4;
    const int shift = 8 * static_cast<int>(j % 4);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t m = 0; m < M; ++m) {
      uint32_t v = out[w * Mpad + m];
      uint8_t byte = static_cast<uint8_t>((v >> shift) & 0xFFu);
      byte = (byte & keep) | pad_bits;
      v = (v & ~(0xFFu << shift)) | (static_cast<uint32_t>(byte) << shift);
      out[w * Mpad + m] = v;
    }
  }
  return 0;
}

// Read markers [S, S+M) of a .bed file (3-byte header + marker-major rows,
// reference read_genotype_data data.cpp:201-234) straight into the planar
// word-major layout.  Parallel positioned reads, no intermediate slab copy
// beyond one tile row-band per thread.
int gvamp_read_bed_words(const char* path, int64_t N, int64_t M, int64_t S,
                         uint32_t* out, int64_t n_words, int64_t Mpad) {
  const int64_t mbytes = (N + 3) / 4;
  if (4 * n_words < mbytes || Mpad < M) return 1;
  const int fd = open(path, O_RDONLY);
  if (fd < 0) return 2;

  int rc = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    uint8_t* band = new uint8_t[kTileM * mbytes];
    const int64_t n_bands = (M + kTileM - 1) / kTileM;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int64_t tb = 0; tb < n_bands; ++tb) {
      const int64_t m0 = tb * kTileM, m1 = std::min(M, m0 + kTileM);
      const int64_t off = 3 + (S + m0) * mbytes;
      int64_t want = (m1 - m0) * mbytes, got = 0;
      while (got < want) {
        const ssize_t r = pread(fd, band + got, want - got, off + got);
        if (r <= 0) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
          rc = 3;
          break;
        }
        got += r;
      }
      if (got == want)
        for (int64_t tw = 0; tw < (n_words + kTileW - 1) / kTileW; ++tw) {
          const int64_t w0 = tw * kTileW;
          const int64_t w1 = std::min(n_words, w0 + kTileW);
          // band is a local slab starting at marker m0: adjust out pointer
          transpose_block(band, m1 - m0, mbytes, out + m0, n_words, Mpad,
                          0, m1 - m0, w0, w1);
        }
    }
    delete[] band;
  }
  close(fd);
  if (rc) return rc;

  // Column padding + tail masking via the in-memory entry point invariants.
  const uint32_t pad_word = 0x55555555u;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t w = 0; w < n_words; ++w)
    for (int64_t m = M; m < Mpad; ++m) out[w * Mpad + m] = pad_word;

  const int tail = static_cast<int>(N % 4);
  if (tail != 0) {
    const uint8_t keep = static_cast<uint8_t>((1u << (2 * tail)) - 1u);
    const uint8_t pad_bits = kPadByte & static_cast<uint8_t>(~keep);
    const int64_t j = mbytes - 1;
    const int64_t w = j / 4;
    const int shift = 8 * static_cast<int>(j % 4);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t m = 0; m < M; ++m) {
      uint32_t v = out[w * Mpad + m];
      uint8_t byte = static_cast<uint8_t>((v >> shift) & 0xFFu);
      byte = (byte & keep) | pad_bits;
      v = (v & ~(0xFFu << shift)) | (static_cast<uint32_t>(byte) << shift);
      out[w * Mpad + m] = v;
    }
  }
  return 0;
}

int gvamp_native_version() { return 1; }

}  // extern "C"
