"""Planar N-axis layout for packed 2-bit genotype kernels.

A verbatim copy of ``gvamp_tpu/ops/layout.py`` (numpy only): importing the
original pulls in ``gvamp_tpu.ops.matvec`` and with it JAX, which the
PyTorch port must not need.  Both packages therefore share one word layout
and one padding rule, so every N-vector compares index for index.

The reference keeps the PLINK ``.bed`` bytes marker-major and decodes byte
``j`` into individuals ``4j+k`` through 1024-entry lookup tables
(reference: dotp_lut.hpp:3, data.cpp:728-801).  Gathered LUTs are hostile to
the TPU VPU, so this framework instead fixes a *planar* permutation of the N
axis under which arithmetic 2-bit decode produces contiguous vector lanes:

  * packed bytes are viewed as little-endian ``uint32`` words
    (16 genotypes / word);
  * SWAR decode ``(word >> 2k) & 0x03030303`` extracts, in one VPU op, the
    codes of the four individuals occupying bit-pair ``k`` of the word's four
    bytes;
  * bitcasting the resulting u32 lanes to four u8 lanes yields a dense int8
    tile whose column order is exactly the planar order below.

Planar order: individual ``n`` with ``w = n // 16``, ``b = (n % 16) // 4``,
``k = n % 4`` lives in plane ``k`` at byte-position ``p = 4w + b``; flattened
planar index is ``k * Nb + p`` where ``Nb = 4 * Nw`` and ``Nw`` is the padded
per-marker word count.  All dense N-vectors (phenotype, z, p1, ...) are stored
in planar order internally; conversion happens only at file I/O boundaries.

Padding: byte value 0x55 encodes four PLINK "01" missing codes, so padded
tail bytes decode to (value 0, indicator 0) and contribute nothing — the same
trick the reference uses with its ``mask4`` NA nibbles (data.cpp:92-98).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# One .bed byte packs 4 genotypes; one u32 word packs 16.
GENOS_PER_BYTE = 4
GENOS_PER_WORD = 16
PAD_BYTE = 0x55  # four 2-bit "01" missing codes

# PLINK 2-bit code -> additive dosage ("a" table, reference dotp_lut.hpp:3)
CODE_TO_DOSAGE = np.array([2.0, 0.0, 1.0, 0.0])
# PLINK 2-bit code -> non-missing indicator ("b" table, dotp_lut.hpp:1030)
CODE_TO_NONMISS = np.array([1.0, 0.0, 1.0, 1.0])


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PlanarLayout:
    """Geometry of the planar N-axis for a given sample count ``N``.

    ``word_align`` controls padding of the per-marker word count so the
    byte-position axis (``Nb = 4 * n_words``) hits TPU lane tiling
    (``Nb`` multiple of 128 lanes -> ``word_align`` multiple of 32).
    """

    N: int
    n_words: int  # padded u32 words per marker
    word_align: int = 32

    @property
    def n_bytes(self) -> int:  # byte-positions per plane (Nb)
        return 4 * self.n_words

    @property
    def n_planar(self) -> int:  # total planar positions (>= N)
        return 16 * self.n_words

    @property
    def mbytes(self) -> int:  # unpadded .bed bytes per marker
        return (self.N + 3) // 4

    @classmethod
    def create(cls, N: int, word_align: int = 32) -> "PlanarLayout":
        mbytes = (N + 3) // 4
        n_words = _round_up(max((mbytes + 3) // 4, 1), word_align)
        return cls(N=N, n_words=n_words, word_align=word_align)

    # ---- permutation tables -------------------------------------------------

    def planar_to_orig(self) -> np.ndarray:
        """int64[4, Nb]: original individual index per planar slot (-1 = pad)."""
        k = np.arange(4)[:, None]
        p = np.arange(self.n_bytes)[None, :]
        w, b = p // 4, p % 4
        n = 16 * w + 4 * b + k
        return np.where(n < self.N, n, -1)

    def orig_to_planar(self) -> np.ndarray:
        """int64[N]: flattened planar index of each original individual."""
        n = np.arange(self.N)
        w, r = n // 16, n % 16
        b, k = r // 4, r % 4
        return k * self.n_bytes + (4 * w + b)

    # ---- vector conversion --------------------------------------------------

    def planarize(self, v: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """[N] (or [..., N]) original-order vector -> [..., 4, Nb] planar."""
        v = np.asarray(v)
        out = np.full(v.shape[:-1] + (4 * self.n_bytes,), fill, dtype=v.dtype)
        out[..., self.orig_to_planar()] = v
        return out.reshape(v.shape[:-1] + (4, self.n_bytes))

    def deplanarize(self, vp: np.ndarray) -> np.ndarray:
        """[..., 4, Nb] planar -> [..., N] original order."""
        vp = np.asarray(vp)
        flat = vp.reshape(vp.shape[:-2] + (4 * self.n_bytes,))
        return flat[..., self.orig_to_planar()]

    # ---- packed genotype conversion -----------------------------------------

    def pack_words(self, bed_bytes: np.ndarray) -> np.ndarray:
        """uint8[M, mbytes] .bed rows -> uint32[M, n_words] little-endian words.

        Pads with 0x55 (all-missing) so padded individuals vanish in decode.
        """
        M = bed_bytes.shape[0]
        padded = np.full((M, 4 * self.n_words), PAD_BYTE, dtype=np.uint8)
        padded[:, : bed_bytes.shape[1]] = bed_bytes
        # tail of the last real byte may contain garbage codes for n >= N;
        # PLINK writers emit 00 there. Mask them to the missing code so the
        # (value, indicator) decode zeroes them exactly, mirroring the
        # reference's mask4 tail-bit clearing (data.cpp:92-98).
        tail = self.N % 4
        if tail and bed_bytes.shape[1] >= self.mbytes:
            j = self.mbytes - 1
            keep_mask = np.uint8((1 << (2 * tail)) - 1)
            pad_bits = np.uint8(PAD_BYTE) & np.uint8(~keep_mask & 0xFF)
            padded[:, j] = (padded[:, j] & keep_mask) | pad_bits
        return np.ascontiguousarray(padded).view("<u4").reshape(M, self.n_words)

    def words_to_bytes(self, words: np.ndarray) -> np.ndarray:
        """uint32[M, n_words] -> uint8[M, mbytes] (drops padding)."""
        by = np.ascontiguousarray(words).view(np.uint8).reshape(words.shape[0], -1)
        return by[:, : self.mbytes]

    def dense_from_words(self, words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Decode to dense float64 (dosage[M, N], nonmiss[M, N]) — test oracle."""
        by = self.words_to_bytes(words)
        M = by.shape[0]
        codes = np.zeros((M, self.mbytes * 4), dtype=np.uint8)
        for k in range(4):
            codes[:, k::4] = (by >> (2 * k)) & 3
        codes = codes[:, : self.N]
        return CODE_TO_DOSAGE[codes], CODE_TO_NONMISS[codes]
