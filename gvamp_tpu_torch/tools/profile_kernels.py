"""Per-kernel time and packed bandwidth of the port's product kernels: the
counterpart of ``tools/profile_kernels.py``.

    python3 -m gvamp_tpu_torch.tools.profile_kernels [NW] [M] [REPS]
                                                     [--device cuda|cpu]

Times each kernel through its wrapper on random words (default NW=6,400 x
M=65,536, 1.68 GB packed) with CUDA events (the median of REPS calls after
a warm-up) and prints ms and packed GB/s, the bytes of the words over the
time: ``axm_i8``, ``axm_i8a``, ``atxm_i8`` and ``atxm_i8a`` at each width
of ``WIDTHS`` and, where the words take them (NW up to
``matvec.GRAM_AAT_MAX_NW``, M whole 64-marker stripes: config X's shape
is ``320 524288``), the fused dual Grams ``gram_aat_i8`` and
``gram_aat_i8a`` there too, and where the words take those
(``matvec.gram_fits``: NW whole 16-row bands, M up to 135,168 on 132 SMs;
config B's shape is ``20480 131072``), the fused primal Grams ``gram_i8``
and ``gram_i8a``, then ``ax``, ``atx`` and ``atx_a`` at B = 1.  On the
card each of these products is also timed as its bare launch: its
operands made once, outside the timed region, as the wrapper makes them
(the digits quantised, the int32 outputs zeroed; for the dual Grams V's
digits and scales, colsum(V) and the partial buffer; for the primal ones
W's (and -U's) digit rows and scales, the mask, the scratch and the
zeroed outputs; for ``ax``, ``atx`` and ``atx_a`` the partial rows); the
first launch is finished as the wrapper finishes it (the fold; for the
dual Grams the sum over the stripe groups and colsum(mave W); for the
primal ones colsum(z); for the single-vector products the sum of the
partial rows) and must equal the
wrapper's result bit for bit (exit 1 if not).  The difference is the
wrapper's own share.  The JAX tool's tile sweep
(``tools/profile_kernels.py:81-93``) has no counterpart: the port's
kernels take no tile arguments (``csrc/matvec.cu``, ``fragments.cu``,
``gram_aat.cu`` and ``gram_prim.cu`` fix their grids).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# the digit products of csrc/fragments.cu, the fused dual Grams of
# csrc/gram_aat.cu and the fused primal Grams of csrc/gram_prim.cu, whose
# bare launch is timed
DIGIT_PRODUCTS = ("axm_i8", "axm_i8a", "atxm_i8", "atxm_i8a")
DUAL_GRAMS = ("gram_aat_i8", "gram_aat_i8a")
PRIMAL_GRAMS = ("gram_i8", "gram_i8a")
# their widths: the JAX tool's (tools/profile_kernels.py:68), then LOCO's
# over 22 chromosomes (ops/pvals.py), the widest call of the engines
WIDTHS = (1, 2, 4, 22)


def bare_launch(name: str, words, W, U, V, mave=None, msig2=None, na=None,
                cu=None):
    """(launch, fold) for the digit product or fused Gram ``name`` on the
    operands its wrapper would make from (W, U) or V (and mave, msig2; for
    the primal Grams the mask na and colsum_u cu): ``launch()`` launches
    the kernel alone on operands made here; ``fold()`` turns the outputs,
    after one launch, into the wrapper's result."""
    from gvamp_tpu_torch.ops import _build, matvec
    if name in DUAL_GRAMS:
        fn, args, finish = matvec.gram_aat_launch(name, words, V, mave, msig2)
        return (lambda: matvec._launch(name, fn, words.device, *args)), finish
    if name in PRIMAL_GRAMS:
        fn, args, finish = matvec.gram_launch(
            name, words, W, na, U if name == "gram_i8" else cu)
        return (lambda: matvec._launch(name, fn, words.device, *args)), finish
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

    names = DIGIT_PRODUCTS
    if matvec.gram_aat_fits(nw, m):
        names += DUAL_GRAMS
        mave = t(rng.uniform(0, 2, m))
        msig2 = t(rng.uniform(0.5, 2, m))
    else:
        print(f"{' and '.join(DUAL_GRAMS)}: not timed, NW={nw} exceeds "
              f"GRAM_AAT_MAX_NW={matvec.GRAM_AAT_MAX_NW} or M={m} is not "
              f"whole {matvec.GRAM_AAT_STRIPE}-marker stripes (config X: "
              f"320 524288)", flush=True)
        mave = msig2 = None
    if matvec.gram_fits(words):
        names += PRIMAL_GRAMS
    else:
        print(f"{' and '.join(PRIMAL_GRAMS)}: not timed, NW={nw} is not "
              f"whole {matvec.GRAM_BAND_NW}-row bands or M={m} gives a block "
              f"more than GRAM_MAX_QUADS={matvec.GRAM_MAX_QUADS} quads "
              f"(config B: 20480 131072)", flush=True)
    na = t(rng.random((4, 4 * nw)) > 0.1)

    def rec(name, fn):
        ms = time_ms(fn, reps)
        print(f"{name:34s} {ms:9.3f} ms   {packed_gb / (ms / 1e3):8.1f} GB/s",
              flush=True)
        return ms

    def beside_bare(label, wrapper, bare):
        """Times ``wrapper`` and, on the card, the bare launch of
        ``bare()`` = (launch, fold) beside it; returns 1 if the bare
        launch's folded result differs from the wrapper's, else 0."""
        ms = rec(label, wrapper)
        if device.type != "cuda":
            return 0
        launch, fold = bare()
        launch()
        got, want = fold(), wrapper()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        fault = not all(torch.equal(g, w) for g, w in zip(got, want))
        if fault:
            print(f"FAULT {label}: the bare launch differs from the wrapper",
                  flush=True)
        del got, want
        ms_bare = rec(f"{label} kernel alone", launch)
        print(f"{label}: wrapper's own share {ms - ms_bare:.3f} ms "
              f"({(ms - ms_bare) / ms:.1%} of {ms:.3f} ms)", flush=True)
        return int(fault)

    for B in WIDTHS:
        W = t(rng.standard_normal((m, B)))
        U = W * 0.01
        V = t(rng.standard_normal((4, 4 * nw, B)))
        cu = t(rng.standard_normal(B))
        wrappers = {"axm_i8": lambda: matvec.axm_i8(words, W, U),
                    "axm_i8a": lambda: matvec.axm_i8a(words, W),
                    "atxm_i8": lambda: matvec.atxm_i8(words, V),
                    "atxm_i8a": lambda: matvec.atxm_i8a(words, V),
                    "gram_aat_i8": lambda: matvec.gram_aat_i8(
                        words, V, mave, msig2),
                    "gram_aat_i8a": lambda: matvec.gram_aat_i8a(
                        words, V, mave, msig2),
                    "gram_i8": lambda: matvec.gram_i8(words, W, U, na),
                    "gram_i8a": lambda: matvec.gram_i8a(words, W, na, cu)}
        for name in names:
            faults += beside_bare(
                f"{name} B={B}" + (" (a-only)" * name.endswith("a")),
                wrappers[name],
                lambda: bare_launch(name, words, W, U, V, mave, msig2, na,
                                    cu))
    w1 = t(rng.standard_normal(m))
    u1 = w1 * 0.01
    v1 = t(rng.standard_normal((4, 4 * nw)))
    singles = {"ax (f32, B=1)": ("ax", lambda: matvec.ax(words, w1, u1),
                                 lambda: matvec.ax_launch(words, w1, u1)),
               "atx (f32, B=1)": ("atx", lambda: matvec.atx(words, v1),
                                  lambda: matvec.atx_launch("atx", words,
                                                            v1)),
               "atx_a (f32, B=1, a-only)": (
                   "atx_a", lambda: matvec.atx_a(words, v1),
                   lambda: matvec.atx_launch("atx_a", words, v1))}
    for label, (name, wrapper, operands) in singles.items():
        faults += beside_bare(label, wrapper,
                              lambda: single_launch(name, words, operands))
    return 1 if faults else 0


def single_launch(name: str, words, operands):
    """(launch, fold) for the single-vector product ``name`` from
    ``operands()`` = (kernel, arguments, finish) of its launch helper."""
    from gvamp_tpu_torch.ops import matvec
    fn, args, finish = operands()
    return (lambda: matvec._launch(name, fn, words.device, *args)), finish


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
