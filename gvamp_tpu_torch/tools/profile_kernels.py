"""Per-kernel time and packed bandwidth of the port's product kernels: the
counterpart of ``tools/profile_kernels.py``.

    python3 -m gvamp_tpu_torch.tools.profile_kernels [NW] [M] [REPS]
                                                     [--device cuda|cpu]

Times each kernel through its wrapper on random words (default NW=6,400 x
M=65,536, 1.68 GB packed) with CUDA events (the median of REPS calls after
a warm-up) and prints ms and packed GB/s, the bytes of the words over the
time: ``axm_i8``, ``axm_i8a``, ``atxm_i8`` and ``atxm_i8a`` at B = 1, 2
and 4, then ``ax``, ``atx`` and ``atx_a`` at B = 1.  The JAX tool's tile
sweep (``tools/profile_kernels.py:81-93``) has no counterpart: the port's
kernels take no tile arguments (``csrc/matvec.cu`` and ``fragments.cu``
fix their grids).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def profile(device, nw: int, m: int, reps: int) -> None:
    """Prints ms and packed GB/s of every kernel of the profile."""
    from gvamp_tpu_torch.ops import matvec
    from gvamp_tpu_torch.tools.common import random_words, timer
    time_ms = timer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    words = random_words(gen, nw, m, device)
    packed_gb = 4 * nw * m / 1e9
    print(f"packed = {packed_gb:.2f} GB  (NW={nw}, M={m}, N={16 * nw})",
          flush=True)
    rng = np.random.default_rng(0)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)

    def rec(name, fn):
        ms = time_ms(fn, reps)
        print(f"{name:34s} {ms:9.3f} ms   {packed_gb / (ms / 1e3):8.1f} GB/s",
              flush=True)

    for B in (1, 2, 4):
        W = t(rng.standard_normal((m, B)))
        U = W * 0.01
        V = t(rng.standard_normal((4, 4 * nw, B)))
        rec(f"axm_i8 B={B}", lambda: matvec.axm_i8(words, W, U))
        rec(f"axm_i8a B={B} (a-only)", lambda: matvec.axm_i8a(words, W))
        rec(f"atxm_i8 B={B}", lambda: matvec.atxm_i8(words, V))
        rec(f"atxm_i8a B={B} (a-only)", lambda: matvec.atxm_i8a(words, V))
    w1 = t(rng.standard_normal(m))
    u1 = w1 * 0.01
    v1 = t(rng.standard_normal((4, 4 * nw)))
    rec("ax (f32, B=1)", lambda: matvec.ax(words, w1, u1))
    rec("atx (f32, B=1)", lambda: matvec.atx(words, v1))
    rec("atx_a (f32, B=1, a-only)", lambda: matvec.atx_a(words, v1))


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
    dev = need_device(args.device, "profile_kernels")
    if dev.type == "cuda":
        print(f"device {torch.cuda.get_device_name(dev)}", flush=True)
    profile(dev, args.nw, args.m, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
