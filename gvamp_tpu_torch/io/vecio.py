"""Sharded estimate-vector I/O, bit-compatible with the reference formats.

The reference dumps every iteration's estimates as raw float64 ``.bin`` files
where rank ``r`` writes its ``M_r`` doubles at byte offset ``8 * S_r``
(mpi_store_vec_to_file, utilities.cpp:293-301), and reads them back the same
way.  Text vectors are one ``%g`` value per line (store_vec_to_file,
utilities.cpp:179-187).  We keep both layouts so estimates interchange with
the reference tooling, but do plain seek-based I/O per host shard.
"""

from __future__ import annotations

import numpy as np


def write_bin_shard(path: str, vec: np.ndarray, s_offset: int, create: bool = True) -> None:
    """Write float64 shard at element offset ``s_offset`` (8-byte stride)."""
    mode = "r+b"
    try:
        f = open(path, mode)
    except FileNotFoundError:
        if not create:
            raise
        f = open(path, "w+b")
    with f:
        f.seek(8 * s_offset)
        np.asarray(vec, dtype="<f8").tofile(f)


def read_bin_shard(path: str, m: int, s_offset: int) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(8 * s_offset)
        out = np.fromfile(f, dtype="<f8", count=m)
    if out.size != m:
        raise ValueError(f"{path}: wanted {m} doubles at offset {s_offset}, got {out.size}")
    return out


def write_txt(path: str, vec: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(vec).ravel():
            f.write(f"{v:g}\n")


def read_txt_shard(path: str, m: int, s_offset: int) -> np.ndarray:
    """Whitespace-separated text vector; returns elements [S, S+M).

    Reference read_vec_from_file (utilities.cpp:157-176) streams values and
    keeps the [S, S+M) window.
    """
    vals = []
    count = 0
    with open(path) as f:
        for line in f:
            for tok in line.split():
                if s_offset <= count < s_offset + m:
                    vals.append(float(tok))
                count += 1
                if count >= s_offset + m:
                    return np.asarray(vals, dtype=np.float64)
    return np.asarray(vals, dtype=np.float64)


def read_estimate(path: str, m: int, s_offset: int) -> np.ndarray:
    """Dispatch on extension like the reference (main_real.cpp:154-159)."""
    if path.endswith(".bin"):
        return read_bin_shard(path, m, s_offset)
    return read_txt_shard(path, m, s_offset)
