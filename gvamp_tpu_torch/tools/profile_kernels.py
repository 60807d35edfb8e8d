"""Per-kernel time and packed bandwidth of the port's product kernels: the
counterpart of ``tools/profile_kernels.py``.

    python3 -m gvamp_tpu_torch.tools.profile_kernels [NW] [M] [REPS]
                                                     [--device cuda|cpu]

Times each kernel through its wrapper on random words (default NW=6,400 x
M=65,536, 1.68 GB packed) with CUDA events (the median of REPS calls after
a warm-up) and prints ms and packed GB/s, the bytes of the words over the
time: ``axm_i8``, ``axm_i8a``, ``atxm_i8`` and ``atxm_i8a`` at each width
of ``WIDTHS``, then ``ax``, ``atx`` and ``atx_a`` at B = 1.  On the card
each of the four digit products is also timed as its bare launch: the
digits quantised and the int32 outputs zeroed once, outside the timed
region, as the wrapper makes them; the first launch is folded and must
equal the wrapper's result bit for bit (exit 1 if not).  The difference
is the wrapper's own share: quantisation, zeroing and fold.  The JAX
tool's tile sweep (``tools/profile_kernels.py:81-93``) has no counterpart:
the port's kernels take no tile arguments (``csrc/matvec.cu`` and
``fragments.cu`` fix their grids).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# the digit products of csrc/fragments.cu, whose bare launch is timed
DIGIT_PRODUCTS = ("axm_i8", "axm_i8a", "atxm_i8", "atxm_i8a")
# their widths: the JAX tool's (tools/profile_kernels.py:68), then LOCO's
# over 22 chromosomes (ops/pvals.py), the widest call of the engines
WIDTHS = (1, 2, 4, 22)


def bare_launch(name: str, words, W, U, V):
    """(launch, fold) for the digit product ``name`` on the operands its
    wrapper would make from (W, U) or V: ``launch()`` launches the kernel
    alone on digits quantised and outputs zeroed here; ``fold()`` turns the
    outputs, after one launch, into the wrapper's result."""
    from gvamp_tpu_torch.ops import _build, matvec
    nw, m = words.shape
    both = name in ("axm_i8", "atxm_i8")
    if name.startswith("atxm"):
        v8, s0 = matvec._quant_digits_t(V)
        D, digs, shape = v8.shape[1], (v8,), (v8.shape[1], m)
    else:
        w8t, ws = matvec._quant_rows(W)
        digs = (w8t,)
        if both:
            u8t, us = matvec._quant_rows(U)
            digs = (w8t, u8t)
        D, shape = w8t.shape[0], (w8t.shape[0], 4, 4 * nw)
    outs = [torch.zeros(shape, dtype=torch.int32, device=words.device)
            for _ in range(1 + both)]
    fn = getattr(_build.library(), f"gvamp_{name}")
    args = [words.data_ptr(), *(t.data_ptr() for t in (*digs, *outs)), nw, m,
            D]

    def launch():
        matvec._launch(name, fn, words.device, *args)

    def fold():
        if name.startswith("atxm"):
            r = tuple(matvec._fold_digits_t(o, s0, V.shape[2]) for o in outs)
            return r if both else r[0]
        za = matvec._fold_digits_zt(outs[0], ws, W.shape[1])
        return za - matvec._fold_digits_zt(outs[1], us, W.shape[1]) if both \
            else za

    return launch, fold


def profile(device, nw: int, m: int, reps: int) -> int:
    """Prints ms and packed GB/s of every kernel of the profile; returns 1
    if a bare launch differs from its wrapper, else 0."""
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
    faults = 0

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)

    def rec(name, fn):
        ms = time_ms(fn, reps)
        print(f"{name:34s} {ms:9.3f} ms   {packed_gb / (ms / 1e3):8.1f} GB/s",
              flush=True)
        return ms

    for B in WIDTHS:
        W = t(rng.standard_normal((m, B)))
        U = W * 0.01
        V = t(rng.standard_normal((4, 4 * nw, B)))
        wrappers = {"axm_i8": lambda: matvec.axm_i8(words, W, U),
                    "axm_i8a": lambda: matvec.axm_i8a(words, W),
                    "atxm_i8": lambda: matvec.atxm_i8(words, V),
                    "atxm_i8a": lambda: matvec.atxm_i8a(words, V)}
        for name in DIGIT_PRODUCTS:
            label = f"{name} B={B}" + (" (a-only)" * name.endswith("a"))
            ms = rec(label, wrappers[name])
            if device.type != "cuda":
                continue
            launch, fold = bare_launch(name, words, W, U, V)
            launch()
            got, want = fold(), wrappers[name]()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                print(f"FAULT {name} B={B}: the bare launch differs from "
                      f"the wrapper", flush=True)
                faults += 1
            del got, want
            bare = rec(f"{name} B={B} kernel alone", launch)
            print(f"{name} B={B}: wrapper's own share {ms - bare:.3f} ms "
                  f"({(ms - bare) / ms:.1%} of {ms:.3f} ms)", flush=True)
    w1 = t(rng.standard_normal(m))
    u1 = w1 * 0.01
    v1 = t(rng.standard_normal((4, 4 * nw)))
    rec("ax (f32, B=1)", lambda: matvec.ax(words, w1, u1))
    rec("atx (f32, B=1)", lambda: matvec.atx(words, v1))
    rec("atx_a (f32, B=1, a-only)", lambda: matvec.atx_a(words, v1))
    return 1 if faults else 0


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
    from gvamp_tpu_torch.tools.common import card_line, need_device
    dev = need_device(args.device, "profile_kernels")
    print(card_line(dev), flush=True)
    return profile(dev, args.nw, args.m, args.reps)


if __name__ == "__main__":
    sys.exit(main())
