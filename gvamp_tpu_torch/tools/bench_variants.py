"""Kernel-variant ladder: where does the packed-product time go?  The
counterpart of ``tools/bench_variants.py``.

    python3 -m gvamp_tpu_torch.tools.bench_variants [NW] [M] [REPS]
                                                    [--device cuda|cpu]

On NW x M random int32 words (default 6,400 x 65,536, 1.68 GB packed) it
times, with CUDA events (the median of REPS calls after a warm-up), the
rungs between "read the words" and the product kernels, in the JAX tool's
order, and prints ms and packed GB/s:

  v0_stream      load each word, one add, a row reduction  -> read ceiling
  v1_decode_a    + the SWAR a-decode of all 4 planes        -> decode cost
  v2_decode_ab   + the b-decode too                         -> full decode
  v3_bitcast     the a-decode summed per byte row           -> relayout cost
  v4_dot         = axm_i8a at B=2 (decode + int8 products)  -> the a-only
                                                               product
  v5_dot1        A_a W at B=2, the planes staged in shared  -> staging and
                 memory, one tensor-core contraction           tensor cores
  v6_fused_ab    A_a W - A_b U at B=2, [a8 | b8] against    -> both planes
                 [w8; -u8] under one joint scale               in one sum
  v7_i8decode    A_a W at B=2 from the words expanded to    -> fragments
                 int8 byte rows, the mma fragments taken       without
                 straight from their decode                    staging
  ref axm_i8     axm_i8 at B=2 with U = 0.01 W              -> the general
                                                               product

Before it times a rung, the tool holds the rung's result on its words
against the rung's plain version (ops/study.py, ops/matvec.py), bit for
bit, and v7's (on ``study.expand_words`` of the tool's words, made once
before it) against ``axm_i8a`` on those words too.  v6's row label
carries its error against axm_i8 (relative to the largest entry; the two
quantise W and U differently, so about 1e-7).  The tool returns 1 if a
rung differs from its plain version, v7 from axm_i8a, or v6's error is
above V6_TOL.  The row-sum rungs run at one launch configuration (256
threads per block, 16-byte loads; the TPU tool's TNW=256, TM=512 tiles
have no counterpart).  ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# v6_fused_ab against axm_i8, relative to the largest entry: both are
# exact integer products of 4-digit radix-127 quantisations (about 127^-4
# of the largest |W| per term), folded in f32
V6_TOL = 1e-6


def run(device, nw: int, m: int, reps: int) -> list[str]:
    """Prints one row of ms and packed GB/s per rung; returns the faults
    found (a rung unequal to its plain version, v6 above V6_TOL)."""
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
    faults = []

    def rec(name, fn, plain, against=None, same_as=None):
        """Holds fn's result against plain's, bit for bit (and against
        ``same_as``'s (label, fn), given; given ``against``, measures its
        error against that), then times fn."""
        got = fn()
        if not torch.equal(got, plain()):
            faults.append(f"{name}: differs from its plain version")
        if same_as is not None and not torch.equal(got, same_as[1]()):
            faults.append(f"{name}: differs from {same_as[0]}")
        if against is not None:
            z = against()
            err = float((got - z).abs().max() / z.abs().max())
            name = f"{name} (err={err:.1e})"
            if not err <= V6_TOL:
                faults.append(f"{name}: {err:.3e} from axm_i8, above "
                              f"{V6_TOL:g}")
            del z
        del got
        ms = time_ms(fn, reps)
        print(f"{name:30s} {ms:9.3f} ms  {packed_gb / (ms / 1e3):8.1f} GB/s",
              flush=True)

    rec("v0_stream", lambda: study.v0_stream(words),
        lambda: study.v0_stream_ref(words))
    rec("v1_decode_a", lambda: study.v1_decode_a(words),
        lambda: study.v1_decode_a_ref(words))
    rec("v2_decode_ab", lambda: study.v2_decode_ab(words),
        lambda: study.v2_decode_ab_ref(words))
    rec("v3_bitcast", lambda: study.v3_bitcast(words),
        lambda: study.v3_bitcast_ref(words))
    rec("v4_dot (=axm_i8a B=2)", lambda: matvec.axm_i8a(words, W2),
        lambda: matvec.axm_i8a_ref(words, W2))
    rec("v5_dot1 (stacked)", lambda: study.v5_dot1(words, W2),
        lambda: study.v5_dot1_ref(words, W2))
    rec("v6_fused_ab", lambda: study.v6_fused_ab(words, W2, U2),
        lambda: study.v6_fused_ab_ref(words, W2, U2),
        against=lambda: matvec.axm_i8(words, W2, U2))
    bytes8 = study.expand_words(words)
    rec("v7_i8decode B=2", lambda: study.v7_i8decode(bytes8, W2),
        lambda: study.v7_i8decode_ref(bytes8, W2),
        same_as=("axm_i8a", lambda: matvec.axm_i8a(words, W2)))
    del bytes8
    rec("ref axm_i8 B=2", lambda: matvec.axm_i8(words, W2, U2),
        lambda: matvec.axm_i8_ref(words, W2, U2))
    if not faults:
        print("every rung equal to its plain version", flush=True)
    print(f"after: {card_line(device)}", flush=True)
    return faults


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
    faults = run(dev, args.nw, args.m, args.reps)
    for f in faults:
        print(f"FAULT {f}")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
