"""Round-2 kernel candidates against the product kernels: the counterpart
of ``tools/bench_round2.py``.

    python3 -m gvamp_tpu_torch.tools.bench_round2 [NW] [M] [REPS]
                                                  [--device cuda|cpu]

On NW x M random int32 words (default 6,400 x 65,536, 1.68 GB packed) it
first holds, on the tool's own words, ``v8_atxm_vt`` (A_a^T V with V's
digits transposed to [4, D, 4*Nw], the contraction over people) bit for
bit against ``atxm_i8a`` and its plain version, and ``v7_i8decode`` (A_a W
from the words expanded to int8 byte rows by ``study.expand_words``) on
those byte rows against ``axm_i8a`` on the words and its plain version.
Then it times, with CUDA events (the median of REPS calls after a
warm-up), at B = 2:

  atxm_i8a B=2 (prod)    the library transpose product
  v8_atxm_vt B=2         its contract, fragments straight from the words
  axm_i8a B=2 (prod)     the library forward product
  v7_i8decode B=2        its contract from the byte rows, on the checked
                         bytes

and prints ms and packed GB/s, with the card's name, power limit and
clocks before and after.  Unlike the JAX tool, v7 is checked at the timed
shape (the JAX tool checks it on a 256 x 2,048 slice, because XLA's u8
transpose is slow at GB scale) and timed on those same bytes, not on
random ones.  The JAX tool's burst-marginal timer and its K have no
counterpart.  It prints ``FAULT ...`` and returns 1 on any mismatch.
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def run(device, nw: int, m: int, reps: int) -> list[str]:
    """Checks, then prints one row of ms and packed GB/s per kernel;
    returns the faults found."""
    from gvamp_tpu_torch.ops import matvec, study
    from gvamp_tpu_torch.tools.common import card_line, random_words, timer
    time_ms = timer(device)
    print(card_line(device), flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    words = random_words(gen, nw, m, device)
    packed_gb = 4 * nw * m / 1e9
    print(f"packed = {packed_gb:.2f} GB  (NW={nw}, M={m})", flush=True)
    rng = np.random.default_rng(0)
    W2 = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32)
                          ).to(device)
    V2 = torch.from_numpy(rng.standard_normal((4, 4 * nw, 2)).astype(
        np.float32)).to(device)
    faults = []

    def check(name, got, *wants):
        for label, want in wants:
            if not torch.equal(got, want()):
                faults.append(f"{name}: differs from {label}")

    check("v8_atxm_vt", study.v8_atxm_vt(words, V2),
          ("atxm_i8a", lambda: matvec.atxm_i8a(words, V2)),
          ("its plain version", lambda: study.v8_atxm_vt_ref(words, V2)))
    bytes8 = study.expand_words(words)
    check("v7_i8decode", study.v7_i8decode_round2(bytes8, W2),
          ("axm_i8a", lambda: matvec.axm_i8a(words, W2)),
          ("its plain version",
           lambda: study.v7_i8decode_round2_ref(bytes8, W2)))
    print("v8_atxm_vt equal to atxm_i8a, v7_i8decode to axm_i8a" if not faults
          else "v8_atxm_vt / v7_i8decode differ", flush=True)

    for name, fn in (
            ("atxm_i8a B=2 (prod)", lambda: matvec.atxm_i8a(words, V2)),
            ("v8_atxm_vt B=2", lambda: study.v8_atxm_vt(words, V2)),
            ("axm_i8a B=2 (prod)", lambda: matvec.axm_i8a(words, W2)),
            ("v7_i8decode B=2", lambda: study.v7_i8decode_round2(bytes8,
                                                                 W2))):
        ms = time_ms(fn, reps)
        print(f"{name:28s} {ms:9.3f} ms  {packed_gb / (ms / 1e3):8.1f} GB/s",
              flush=True)
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
    dev = need_device(args.device, "bench_round2")
    faults = run(dev, args.nw, args.m, args.reps)
    for f in faults:
        print(f"FAULT {f}")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
