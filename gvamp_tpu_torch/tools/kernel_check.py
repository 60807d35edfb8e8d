"""Accuracy check of the port's product kernels against a float64 numpy
oracle, on the card: the counterpart of ``tools/tpu_check.py``.

    python3 -m gvamp_tpu_torch.tools.kernel_check [--device cuda|cpu]

Run it on the card after any edit of ``gvamp_tpu_torch/csrc/matvec.cu``,
``fragments.cu`` or ``gram_aat.cu``.
``chip_smoke.py`` holds each kernel bit for bit against its plain version;
this holds the kernels and their plain versions alike against the exact
products, at the sizes and tolerance of ``tools/tpu_check.py``: random
words at Nw=64 x Mpad=2,048, B=3 Gaussian right-hand sides, relative error
at most TOL.  A bf16-split kernel that lost its mid and lo parts would err
by about 1e-3 there.  Then the constant-sign M=131,072 case through
``axm_i8a`` (the digit error grows with M on one-signed inputs), then
``bench_gram.correctness``: the fused Grams and ``axm_i8s`` against their
two-pass forms.

Prints one ``ok`` / ``FAIL`` line per check and returns 1 on any failure.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TOL = 5e-7


def _oracle(words_np: np.ndarray, W, U, V):
    """float64 (A_a W - A_b U, A_a W, A_a^T V, A_b^T V) of uint32 words."""
    nw, m = words_np.shape
    by = words_np.T.copy().view(np.uint8).reshape(m, 4 * nw)
    B = W.shape[1]
    z = np.zeros((4, 4 * nw, B))
    za = np.zeros((4, 4 * nw, B))
    ra = np.zeros((m, B))
    rb = np.zeros((m, B))
    for k in range(4):
        code = (by >> (2 * k)) & 3
        a = np.select([code == 0, code == 2], [2.0, 1.0], 0.0)
        b = (code != 1).astype(np.float64)
        za[k] = a.T @ W.astype(np.float64)
        z[k] = za[k] - b.T @ U.astype(np.float64)
        ra += a @ V[k].astype(np.float64)
        rb += b @ V[k].astype(np.float64)
    return z, za, ra, rb


def _rel(x, ref) -> float:
    x = x.detach().cpu().numpy().astype(np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def checks(device) -> dict:
    """{check name: relative error against the float64 oracle}."""
    from gvamp_tpu_torch.ops import matvec
    rng = np.random.default_rng(0)
    nw, m, B = 64, 2048, 3
    words_np = rng.integers(0, 2**32, size=(nw, m),
                            dtype=np.uint64).astype(np.uint32)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 0.1).astype(np.float32)
    V = rng.standard_normal((4, 4 * nw, B)).astype(np.float32)
    z64, za64, ra64, rb64 = _oracle(words_np, W, U, V)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    words = t(words_np.view(np.int32))
    tW, tU, tV = t(W), t(U), t(V)
    out = {
        "ax": _rel(matvec.ax(words, tW[:, 0], tU[:, 0]), z64[..., 0]),
        "atx_a": _rel(matvec.atx_a(words, tV[..., 0]), ra64[:, 0]),
        "axm_i8a": _rel(matvec.axm_i8a(words, tW), za64),
        "atxm_i8a": _rel(matvec.atxm_i8a(words, tV), ra64),
        "axm_i8": _rel(matvec.axm_i8(words, tW, tU), z64),
        "axm_i8s": _rel(matvec.axm_i8s(words, tW, tU), z64),
        "axm_bf16": _rel(matvec.axm_bf16(words, tW, tU), z64),
    }
    for name, fn, arg, ref in (
            ("atx", matvec.atx, tV[..., 0], (ra64[:, 0], rb64[:, 0])),
            ("atxm_i8", matvec.atxm_i8, tV, (ra64, rb64)),
            ("atxm_bf16", matvec.atxm_bf16, tV, (ra64, rb64))):
        av, bv = fn(words, arg)
        out[name] = max(_rel(av, ref[0]), _rel(bv, ref[1]))

    # a constant-sign right-hand side at the production contraction length:
    # the radix-127 digit error is O(M colmax / 127^4) in the worst case
    mbig = 131_072
    wb_np = rng.integers(0, 2**32, size=(8, mbig),
                         dtype=np.uint64).astype(np.uint32)
    wbig = np.abs(rng.standard_normal((mbig, 2))).astype(np.float32)
    _, zb64, _, _ = _oracle(wb_np, wbig, wbig, np.zeros((4, 32, 2)))
    out["axm_i8a (M=131,072, one sign)"] = _rel(
        matvec.axm_i8a(t(wb_np.view(np.int32)), t(wbig)), zb64)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    from gvamp_tpu_torch.tools import bench_gram
    from gvamp_tpu_torch.tools.common import need_device
    dev = need_device(args.device, "kernel_check")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"kernel check on {name} (tolerance {TOL:g} relative to float64)",
          flush=True)
    res = checks(dev)
    for k, v in res.items():
        print(f"{'FAIL' if v > TOL else 'ok  '} {k:32s} relerr {v:.3g}",
              flush=True)
    if any(v > TOL for v in res.values()):
        return 1
    if not bench_gram.correctness(dev):
        return 1
    print("all kernels within the tolerance of the float64 oracle", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
