"""Stream-ceiling study: how fast can the card read the packed words?  The
counterpart of ``tools/bench_stream.py``.

    python3 -m gvamp_tpu_torch.tools.bench_stream [NW] [M] [REPS]
                                                  [--device cuda|cpu]

On NW x M random int32 words (default 6,400 x 65,536, 1.68 GB packed) it
prints ms (the median CUDA-event time of REPS calls after a warm-up),
packed GB/s (the words' bytes over the time) and the share of the H100's
nominal 3.35 TB/s for:

* ``torch.sum`` over the whole matrix (the counterpart of ``xla_sum``, the
  HBM reference, not a kernel of the port) and the per-row
  ``words.sum(1, dtype=torch.int32)``;
* ``stream`` (``ops/study.py``, one add per word into an Nw x 512 output,
  ``study.STREAM_TM``; skipped where 512 does not divide M) and
  ``stream_sum`` (each row's sum) over the H100 counterpart of the TPU
  tile sweep (``tools/bench_stream.py:97-111``): threads per block
  {128, 256, 512, 1024} x bytes per load {4, 8, 16}.

The TPU's dimension semantics (the JAX tool's ``sem`` argument) have no
counterpart: CUDA blocks run in no order.  The header and the last line
give the card's name, power limit and current SM and memory clocks, since
kernel times move between calls with the clocks.  ``--device cpu`` runs the
plain versions (every sweep row is then the same PyTorch call).
"""

from __future__ import annotations

import argparse
import sys

import torch


def run(device, nw: int, m: int, reps: int) -> None:
    """Prints one row of ms, packed GB/s and share of the nominal HBM rate
    per measurement."""
    from gvamp_tpu_torch.ops import study
    from gvamp_tpu_torch.tools.common import (HBM_BYTES_PER_S, card_line,
                                              random_words, timer)
    time_ms = timer(device)
    tm = study.STREAM_TM
    print(card_line(device), flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    words = random_words(gen, nw, m, device)
    packed = 4 * nw * m
    print(f"packed = {packed / 1e9:.2f} GB  (NW={nw}, M={m}, TM={tm})",
          flush=True)

    def rec(name, fn):
        ms = time_ms(fn, reps)
        rate = packed / (ms / 1e3)
        print(f"{name:40s} {ms:9.3f} ms  {rate / 1e9:8.1f} GB/s  "
              f"{rate / HBM_BYTES_PER_S:6.1%} of 3.35 TB/s", flush=True)

    rec("torch.sum (whole matrix)", lambda: words.sum(dtype=torch.int32))
    rec("torch.sum per row", lambda: words.sum(1, dtype=torch.int32))
    if m % tm:
        print(f"stream: skipped, TM={tm} does not divide M={m}", flush=True)
    else:
        for threads in study.THREADS:
            for nb in study.LOAD_BYTES:
                rec(f"stream threads={threads} load={nb}B",
                    lambda: study.stream(words, tm, threads, nb))
    for threads in study.THREADS:
        for nb in study.LOAD_BYTES:
            rec(f"stream_sum threads={threads} load={nb}B",
                lambda: study.stream_sum(words, threads, nb))
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
    dev = need_device(args.device, "bench_stream")
    run(dev, args.nw, args.m, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
