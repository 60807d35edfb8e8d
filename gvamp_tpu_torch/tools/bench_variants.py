"""Kernel-variant ladder: where does the packed-product time go?  The
counterpart of ``tools/bench_variants.py``.

    python3 -m gvamp_tpu_torch.tools.bench_variants [NW] [M] [REPS]
                                                    [--device cuda|cpu]

On NW x M random int32 words (default 6,400 x 65,536, 1.68 GB packed) it
times, with CUDA events (the median of REPS calls after a warm-up), the
rungs between "read the words" and the product kernels, and prints ms and
packed GB/s:

  v0_stream      load each word, one add, a row reduction  -> read ceiling
  v1_decode_a    + the SWAR a-decode of all 4 planes        -> decode cost
  v4_dot         = axm_i8a at B=2 (decode + int8 products)  -> the a-only
                                                               product
  ref axm_i8     axm_i8 at B=2 with U = 0.01 W              -> the general
                                                               product

The rungs run at one launch configuration (256 threads per block, 16-byte
loads; the TPU tool's TNW=256, TM=512 tiles have no counterpart).  Rungs
v2_decode_ab, v3_bitcast, v5_dot1 and v6_fused_ab come with the next slice
of the port, v7_i8decode with the one after.  ``--device cpu`` runs the
plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def run(device, nw: int, m: int, reps: int) -> None:
    """Prints one row of ms and packed GB/s per rung."""
    from gvamp_tpu_torch.ops import matvec, study
    from gvamp_tpu_torch.tools.common import card_line, random_words, timer
    time_ms = timer(device)
    print(card_line(device), flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    words = random_words(gen, nw, m, device)
    packed_gb = 4 * nw * m / 1e9
    print(f"packed = {packed_gb:.2f} GB  (NW={nw}, M={m})  threads="
          f"{study.VARIANT_THREADS} load={study.VARIANT_LOAD_BYTES}B",
          flush=True)
    rng = np.random.default_rng(0)
    W2 = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32)
                          ).to(device)
    U2 = W2 * 0.01

    def rec(name, fn):
        ms = time_ms(fn, reps)
        print(f"{name:30s} {ms:9.3f} ms  {packed_gb / (ms / 1e3):8.1f} GB/s",
              flush=True)

    rec("v0_stream", lambda: study.v0_stream(words))
    rec("v1_decode_a", lambda: study.v1_decode_a(words))
    rec("v4_dot (=axm_i8a B=2)", lambda: matvec.axm_i8a(words, W2))
    rec("ref axm_i8 B=2", lambda: matvec.axm_i8(words, W2, U2))
    print(f"after: {card_line(device)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nw", nargs="?", type=int, default=6400,
                    help="word rows (16 samples each)")
    ap.add_argument("m", nargs="?", type=int, default=65536, help="markers")
    ap.add_argument("reps", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    from gvamp_tpu_torch.tools.common import need_device
    dev = need_device(args.device, "bench_variants")
    run(dev, args.nw, args.m, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
