"""``v6_fused_ab`` beside ``axm_i8s``, the engines' product of the same
contract, at the widths that its wgmma kernel reads the words once for.

    python3 -m gvamp_tpu_torch.tools.bench_fused_ab [N] [M] [REPS]
                                                    [--widths 2,16,64]
                                                    [--rounds 3]
                                                    [--device cuda|cpu]

On config Bm's words (default N = 327,680 people x M = 131,072 markers,
10.74 GB packed, about 1.56% of the calls missing; ``common.synth_words``
from seed 0, as ``chip_smoke.py`` draws them) it holds ``v6_fused_ab``
bit for bit against ``axm_i8s`` at each width B (one quantisation of W and
-U, one int32 sum, one fold: the two must agree exactly), then times the
two in turns over ROUNDS rounds (the median of REPS calls each, CUDA
events, after a warm-up) and prints one line per width: each round's ms of
both, and the bound (``common.bound``).  The same file runs against
another tree's package, for example a parent unpacked with ``git archive``
with this file copied into its ``gvamp_tpu_torch/tools/``: it uses only
the two wrappers, ``synth_words``, the timers and the bound.  It prints
``FAULT ...`` and returns 1 on a mismatch.  ``--device cpu`` runs the
plain versions (at a small N and M).
"""

from __future__ import annotations

import argparse
import sys

import torch


def run(device, n: int, m: int, reps: int, widths, rounds: int) -> list[str]:
    """Checks and times each width; returns the faults found."""
    from gvamp_tpu_torch.ops import matvec, study
    from gvamp_tpu_torch.tools.common import (bound, card_line, synth_words,
                                              timer)
    time_ms = timer(device)
    print(card_line(device), flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    words = synth_words(gen, True, n, m, device)
    nw = words.shape[0]
    print(f"packed = {4 * nw * m / 1e9:.2f} GB  (N={n}, M={m})", flush=True)
    faults = []
    for B in widths:
        gw = torch.Generator(device=device)
        gw.manual_seed(100 + B)
        W = torch.randn((m, B), generator=gw, device=device)
        U = torch.randn((m, B), generator=gw, device=device) * 3
        if not torch.equal(study.v6_fused_ab(words, W, U),
                           matvec.axm_i8s(words, W, U)):
            faults.append(f"v6_fused_ab B={B}: differs from axm_i8s")
            continue
        v6, i8s = zip(*[(time_ms(lambda: study.v6_fused_ab(words, W, U), reps),
                         time_ms(lambda: matvec.axm_i8s(words, W, U), reps))
                        for _ in range(rounds)])
        b_ms, b_by = bound("v6_fused_ab", nw, m, B)
        print(f"B={B:<3d} v6_fused_ab {' '.join(f'{t:.3f}' for t in v6)} ms, "
              f"axm_i8s {' '.join(f'{t:.3f}' for t in i8s)} ms (in turns, "
              f"equal bit for bit); bound {b_ms:.3f} ms by {b_by}",
              flush=True)
    print(f"after: {card_line(device)}", flush=True)
    return faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=327_680,
                    help="people (16 per word row)")
    ap.add_argument("m", nargs="?", type=int, default=131_072,
                    help="markers")
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--widths", default="2,16,64",
                    help="comma-separated B (right-hand-side columns)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    from gvamp_tpu_torch.tools.common import need_device
    dev = need_device(args.device, "bench_fused_ab")
    widths = [int(b) for b in args.widths.split(",")]
    faults = run(dev, args.n, args.m, args.reps, widths, args.rounds)
    for f in faults:
        print(f"FAULT {f}")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
