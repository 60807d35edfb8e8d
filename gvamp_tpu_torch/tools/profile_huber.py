"""Where a Huber iteration's time goes, and how exact the SLQ nodes are.

    python3 -m gvamp_tpu_torch.tools.profile_huber [N] [M] [ITERS]
        [--deflate-k K ...] [--device cuda|cpu]

Synthesises N x M complete genotypes (``common.synth_words``, seed 0;
default config B, N=327,680 x M=131,072), bench.py's prior (1,000 causal,
h2 = 0.5) and tools/bench_huber.py's heavy-tailed phenotype
A (sqrt(N) beta) + 0.5 t(3), then runs ITERS iterations (default 10) of
``robust.infer`` with ``RobustConfig(rho=0.15, stab_gamma=1.0)`` for each
``--deflate-k`` (default 0 and 128) and prints the seconds spent in each
part: the CG solve, its warm start, the re-estimation loop's g1 / g1d and
EM prior updates, em_deltaH's grid search on the device, and the rest
(em_deltaH's draw on the CPU and its transfer among it, which are timed
apart afterwards).  Each timed part is bracketed by a device
synchronisation, so the parts add up to the iterations' wall time and
that wall time is somewhat above an untimed run's.  The iterations' time
is that of the program's ``iteration`` and ``fetch`` spans
(``gvamp_tpu_torch.trace``): the run goes under ``torch.profiler``,
tracing the card's activity (the CPU's on the CPU).

Then it measures the SLQ quadrature's nodes: 32 Lanczos steps of the
Gram from the probe on the device, the tridiagonal's eigendecomposition
in float32 on the device and on the CPU against float64, and the
relative error each gives u^T (A^T A + I)^{-1} u.  Returns 0.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np
import torch


def _timed(acc, cnt, name, fn, sync):
    def wrapped(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sync()
        acc[name] += time.perf_counter() - t0
        cnt[name] += 1
        return out
    return wrapped


def split(geno, beta, vars_t, probs_t, n_it, deflate_k, sync) -> None:
    """One run of n_it Huber iterations with each part timed."""
    from torch.profiler import ProfilerActivity, profile

    from gvamp_tpu_torch import cg, robust, trace
    acc, cnt = collections.defaultdict(float), collections.Counter()
    parts = {"update_prior": (robust, "EM prior update"),
             "g1": (robust, "g1"), "g1d": (robust, "g1d"),
             "em_deltaH": (robust, "em_deltaH grid (device)"),
             "solve_block": (cg, "CG solve"),
             "tracked_warm_start_fwd": (cg, "CG warm start")}
    saved = {n: getattr(mod, n) for n, (mod, _) in parts.items()}
    for n, (mod, label) in parts.items():
        setattr(mod, n, _timed(acc, cnt, label, saved[n], sync))
    act = (ProfilerActivity.CUDA if geno.device.type == "cuda"
           else ProfilerActivity.CPU)
    trace.clear()
    try:
        cfg = robust.RobustConfig(max_iter=n_it, rho=0.15, stab_gamma=1.0,
                                  stop_criteria_thr=0.0, deflate_k=deflate_k)
        with profile(activities=[act]):
            _, _, hist = robust.infer(geno, cfg, probs_t, vars_t,
                                      verbose=False)
    finally:
        for n, (mod, _) in parts.items():
            setattr(mod, n, saved[n])
    wall = sum(s.end_ns - s.start_ns for s in trace.spans()
               if s.name in ("iteration", "fetch")) / 1e9
    trace.clear()
    print(f"deflate_k={deflate_k}: {len(hist)} iterations {wall:.3f} s, CG "
          f"{[h['cg_iters'] for h in hist]}, host syncs "
          f"{[h['host_syncs'] for h in hist]}", flush=True)
    for name, t in sorted(acc.items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {t:8.3f} s ({t / wall:6.1%}) over {cnt[name]} "
              f"calls", flush=True)
    print(f"  {'rest':24s} {wall - sum(acc.values()):8.3f} s", flush=True)


def draw_times(geno, mc: int = 100, reps: int = 3) -> None:
    """em_deltaH's draw [mc, 4 Nb] on the CPU and its transfer."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    n = geno.y_planar.numel()
    for _ in range(reps):
        t0 = time.perf_counter()
        eps = torch.randn((mc, n), generator=gen, dtype=geno.dtype)
        t1 = time.perf_counter()
        eps = eps.to(geno.device)
        if geno.device.type == "cuda":
            torch.cuda.synchronize()
        print(f"draw [{mc}, {n}] on the CPU {t1 - t0:.3f} s, to the device "
              f"{time.perf_counter() - t1:.3f} s", flush=True)


def slq_nodes(geno, k: int = 32) -> None:
    """The SLQ tridiagonal's eigendecomposition in float32 on the device
    and on the CPU against float64."""
    from gvamp_tpu_torch import linear, probit, slq
    mult, op = probit._gram_mult(geno), geno.op
    bern = linear.make_bern_probe(geno, 1, 1)
    a, b, u = slq.lanczos_block(lambda X: mult(op, X), bern, k)
    T = slq._tridiag(a.T, b.T).cpu()
    lam64, S64 = torch.linalg.eigh(T.double())
    quad = (u.cpu().double() * (torch.square(S64[:, 0, :])
                                / (lam64 + 1.0)).sum(-1))
    for where in sorted({geno.device.type, "cpu"}):
        lam, S = torch.linalg.eigh(T.float().to(where))
        lam, w = lam.cpu().double(), torch.square(S[:, 0, :]).cpu().double()
        q = u.cpu().double() * (w / (lam + 1.0)).sum(-1)
        print(f"SLQ eigh float32 on {where}: max|lam - float64| "
              f"{float((lam - lam64).abs().max()):.2e}, max|wts - float64| "
              f"{float((w - torch.square(S64[:, 0, :])).abs().max()):.2e}; "
              f"quadrature relative error "
              f"{float(((q - quad) / quad).abs().max()):.2e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=327_680,
                    help="people (N)")
    ap.add_argument("m", nargs="?", type=int, default=131_072,
                    help="markers (M)")
    ap.add_argument("iters", nargs="?", type=int, default=10)
    ap.add_argument("--deflate-k", type=int, nargs="+", default=[0, 128])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    from gvamp_tpu_torch import sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.tools.common import card_line, need_device, \
        synth_words
    dev = need_device(args.device, "profile_huber")
    print(card_line(dev), flush=True)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

        def sync():
            torch.cuda.synchronize()
    else:
        def sync():
            pass
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    words = synth_words(gen, False, args.n, args.m, device=dev)
    geno = GenoBed.from_device_words(words, np.zeros(args.n), N=args.n,
                                     M=args.m, standardize_phen=False)
    rng = np.random.default_rng(0)
    vars_t, probs_t = sim.two_group_prior(args.m, min(1000, args.m // 8),
                                          0.5)
    beta = sim.simulate_mixture(rng, args.m, vars_t, probs_t)
    g = geno.deplanarize(geno.ax(geno.pad_m(beta * np.sqrt(args.n))))
    geno.set_phen(g[: args.n] + rng.standard_t(3.0, args.n) * 0.5)
    for k in args.deflate_k:
        split(geno, beta, vars_t, probs_t, args.iters, k, sync)
    draw_times(geno)
    slq_nodes(geno)
    return 0


if __name__ == "__main__":
    sys.exit(main())
