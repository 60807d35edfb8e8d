"""Smoke run of the PyTorch port (gvamp_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py                  # every phase, ~100 s on an H100
    python3 chip_smoke.py --kernels-only   # phases 1-3: build and check

Phases, each of which raises on failure (exit code != 0):

1. environment: torch / CUDA / nvcc / triton versions and the card's name
   and power limit; TF32 off for every float32 product;
2. build the CUDA kernels (gvamp_tpu_torch/csrc/matvec.cu) with nvcc;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at small shapes and on the whole config-B matrix at B = 1 and 2;
   CUDA-event times of both;
4. the linear VAMP main path at config B of bench.py (N=327,680 x
   M=131,072, complete genotypes, 10.74 GB of packed words on the card):
   load, phenotype simulation and 10 iterations of linear.infer, with the
   kernels' launch counters proving the path ran through them;
5. the same small problem on the card and on the CPU (plain versions),
   which must agree to the f32 tolerances of tests/test_torch_linear.py;
6. the CLI (`--run-mode infere --model linear`) on a small .bed/.phen.

The last two lines of standard output are one JSON object with the
kernels' numbers and one with the device; before them, the nvidia-smi
name and power limit.  The script needs a CUDA device: without one it
exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# config B of bench.py:39-42: N=327,680 (20,480 words of 16 samples),
# M=131,072 markers -> 10.74 GB packed
CFG_B_N, CFG_B_M = 327_680, 131_072
CFG_B_ITERS = 10
# the JAX package's kernel each CUDA kernel replaces (def line of the wrapper)
REPLACES = {"axm_i8a": "gvamp_tpu/ops/matvec.py:797",
            "atxm_i8a": "gvamp_tpu/ops/matvec.py:1581",
            "atx": "gvamp_tpu/ops/matvec.py:287"}
SOURCE = "gvamp_tpu_torch/csrc/matvec.cu"
SHAPES = [(32, 512, 1), (64, 1024, 2), (96, 1536, 5), (32, 2048, 17),
          (64, 512, 70)]
SLICE_M = 2048
# corr(x_hat, beta) and R2_train_1 after 10 iterations at config B; set from
# the first H100 run of this script (0.99590 and 0.44236, PERF.md) with
# room for f32 rounding and a different card, not for a different algorithm
CORR_MIN = 0.99
R2_RANGE = (0.40, 0.50)


def log(msg=""):
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_environment():
    log("== phase 1: environment")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card only")
    from gvamp_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    log(f"nvidia-smi: {smi_line()}")
    log(f"device: {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn {torch.backends.cudnn.allow_tf32}")


def phase_build():
    log("== phase 2: build")
    from gvamp_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.library()._name
    log(f"kernels: {path} ready in {time.perf_counter() - t0:.2f} s")
    if _build.BUILD_INFO:
        log(f"nvcc: {_build.BUILD_INFO['command']}")
        log(f"nvcc build {_build.BUILD_INFO['seconds']:.2f} s; ptxas:")
        log(_build.BUILD_INFO["log"].strip())


def random_words(gen, nw, m, device="cuda"):
    return torch.randint(-2**31, 2**31, (nw, m), dtype=torch.int32,
                         generator=gen, device=device)


def compare(name, label, got, want) -> float:
    """max |got - want| over the paired outputs; raises unless they are
    equal bit for bit."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} {label}: kernel differs from its plain "
                             f"version (max |diff| {err:.3e})")
    return err


def check_kernels(words, B, gen, label, count=None, with_atx=True, reps=5):
    """Each kernel against its plain version on ``words``; returns
    {name: (max_abs_err, ms, plain_ms)}.

    axm_i8a / atxm_i8a: both sides share the quantisation and the fold on
    this device and their integer products are exact, so they must be
    equal bit for bit.  atx: a dyadic v (multiples of 1/8) keeps every f32
    partial sum exact in any order, so it must be equal too.  With v = 1,
    atx's bv counts each marker's non-missing calls: it must equal the
    plain version's count and, where given, ``count``."""
    from gvamp_tpu_torch.ops import matvec
    nw, m = words.shape
    dev = words.device
    W = torch.randn((m, B), generator=gen, device=dev)
    V = torch.randn((4, 4 * nw, B), generator=gen, device=dev)
    cases = [("axm_i8a", matvec.axm_i8a, matvec.axm_i8a_ref, W),
             ("atxm_i8a", matvec.atxm_i8a, matvec.atxm_i8a_ref, V)]
    if with_atx:
        v = torch.randint(0, 9, (4, 4 * nw), generator=gen,
                          device=dev).float() / 8
        cases.append(("atx", matvec.atx, matvec.atx_ref, v))
    out = {}
    for name, fn, ref, arg in cases:
        got, want = fn(words, arg), ref(words, arg)
        if name != "atx":
            got, want = (got,), (want,)
        err = compare(name, f"{label} B={B}", got, want)
        del got, want
        out[name] = (err, cuda_ms(lambda: fn(words, arg), reps),
                     cuda_ms(lambda: ref(words, arg), min(reps, 3)))
    if with_atx:
        ones = torch.ones((4, 4 * nw), device=dev)
        bv1, rbv1 = matvec.atx(words, ones)[1], matvec.atx_ref(words, ones)[1]
        if not torch.equal(bv1, rbv1) or (
                count is not None and not bool((bv1 == count).all())):
            raise AssertionError(f"atx {label}: bv differs from the "
                                 f"non-missing count")
    torch.cuda.synchronize()
    for name, (e, t, p) in out.items():
        gbs = 4 * nw * m / (t * 1e6)
        log(f"  {label:>22s} B={B:<3d} {name:9s} equal  max|err|={e:.3e}  "
            f"kernel {t:8.3f} ms ({gbs:7.1f} GB/s packed)  plain {p:8.3f} ms")
    return out


def phase_kernels_small(gen):
    log("== phase 3a: kernels vs plain versions, small shapes")
    for nw, m, B in SHAPES:
        check_kernels(random_words(gen, nw, m), B, gen, f"Nw={nw} Mpad={m}")


def synth_config_b(gen):
    """Config-B words on the card, in column chunks (a single randint of
    10.74 GB would need 8x that in int64 temporaries).  Every "01"
    (missing) code is remapped to "11", as bench.py:70-79 does, so the
    genotypes are complete."""
    from gvamp_tpu_torch.ops.layout import PlanarLayout
    nw = PlanarLayout.create(CFG_B_N).n_words
    words = torch.empty((nw, CFG_B_M), dtype=torch.int32, device="cuda")
    chunk = 4096
    for c in range(0, CFG_B_M, chunk):
        raw = random_words(gen, nw, chunk)
        lo = raw & 0x55555555
        hi = (raw >> 1) & 0x55555555
        words[:, c:c + chunk] = raw | ((lo & ~hi) << 1)
    torch.cuda.synchronize()
    return words


def phase_kernels_config_b(words, gen):
    """The kernels on a 2,048-marker slice (launch-bound) and on the whole
    config-B matrix at the main path's widths B = 1 and 2, where every row
    band spans many shared-memory tiles.  The plain versions decode
    _REF_BLOCK markers at a time, so they run beside the 10.74 GB of words.
    Returns {B: check_kernels result} of the whole matrix."""
    log("== phase 3b: kernels vs plain versions, config-B words")
    sl = words[:, :SLICE_M].contiguous()
    for B in (1, 2):
        check_kernels(sl, B, gen, f"config B, {SLICE_M} markers")
    del sl
    nw, m = words.shape
    # complete genotypes: every marker has 16 * Nw non-missing calls
    full = {B: check_kernels(words, B, gen, f"config B full {nw}x{m}",
                             count=16 * nw, with_atx=B == 1, reps=3)
            for B in (1, 2)}
    torch.cuda.empty_cache()
    return full


def phase_main_path(words):
    log("== phase 4: linear VAMP main path at config B")
    from gvamp_tpu import sim as npsim
    from gvamp_tpu_torch import linear, sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import matvec
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    t0 = time.perf_counter()
    geno = GenoBed.from_device_words(words, np.zeros(CFG_B_N), N=CFG_B_N,
                                     M=CFG_B_M, standardize_phen=False)
    torch.cuda.synchronize()
    t_stats = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not geno.geno_complete:
        raise AssertionError("config-B words are not complete")
    t_complete = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    vars_t, probs_t = npsim.two_group_prior(CFG_B_M, 1000, 0.5)
    beta = npsim.simulate_mixture(rng, CFG_B_M, vars_t, probs_t)
    t0 = time.perf_counter()
    geno.set_phen(sim.simulate_linear_phenotype(geno, beta, 2.0, rng))
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    cfg = linear.VampConfig(max_iter=CFG_B_ITERS, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0)
    t0 = time.perf_counter()
    x_hat, _, hist = linear.infer(geno, cfg, probs_t, vars_t)
    t_infer = time.perf_counter() - t0
    launches = dict(matvec.LAUNCHES)
    t_iters = sum(h["wall_ms"] for h in hist) / 1e3
    log(f"  set-up: statistics {t_stats:.2f} s, completeness {t_complete:.3f} s, "
        f"phenotype simulation + statistics {t_sim:.2f} s, infer set-up "
        f"(SLQ basis, A^T y, A u) {t_infer - t_iters:.2f} s")
    log("  it      gam1        gam2        gamw     alpha1    alpha2   "
        "R2_train_1  cg   wall_ms  syncs")
    for h in hist:
        log(f"  {h['it']:2d} {float(h['gam1']):11.5g} {float(h['gam2']):11.5g} "
            f"{float(h['gamw']):11.5g} {float(h['alpha1']):9.4g} "
            f"{float(h['alpha2']):9.4g} {float(h['R2_train_1']):10.5f} "
            f"{h['cg_iters']:4d} {h['wall_ms']:9.2f} {h['host_syncs']:5d}")
    steady = [h["wall_ms"] for h in hist[2:]]
    log(f"  steady-state (it 3-{len(hist)}) median {np.median(steady):.2f} ms/it;"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches on the main path: {launches}")
    corr = float(np.corrcoef(x_hat, beta)[0, 1])
    r2 = [float(h["R2_train_1"]) for h in hist]
    log(f"  corr(x_hat, beta) = {corr:.5f}; R2_train_1 {r2[1]:.4f} -> {r2[-1]:.4f}")
    keys = ("gam1", "gam2", "gamw", "alpha1", "alpha2", "R2_train_1")
    if not (np.isfinite(x_hat).all() and all(
            np.isfinite(float(h[k])) for h in hist for k in keys)):
        raise AssertionError("non-finite values on the main path")
    if len(hist) != CFG_B_ITERS:
        raise AssertionError(f"{len(hist)} iterations, expected {CFG_B_ITERS}")
    rising = all(b > a for a, b in zip(r2[1:], r2[2:]))
    if not (rising and R2_RANGE[0] < r2[-1] < R2_RANGE[1]):
        raise AssertionError(f"R2_train_1 {r2} does not rise toward h2 = 0.5")
    if corr < CORR_MIN:
        raise AssertionError(f"corr(x_hat, beta) {corr:.4f} < {CORR_MIN}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")
    return launches


def small_problem(tmp, seed, N, M):
    """A simulated complete-genotype .bed in ``tmp`` and its truth."""
    from gvamp_tpu import sim as npsim
    from gvamp_tpu.io import plink
    rng = np.random.default_rng(seed)
    bed = os.path.join(tmp, "d.bed")
    plink.write_bed(bed, npsim.random_genotypes(rng, M, N))
    vars_t, probs_t = npsim.two_group_prior(M, 40, 0.5)
    beta = npsim.simulate_mixture(rng, M, vars_t, probs_t)
    return bed, beta, vars_t, probs_t, rng


def phase_card_vs_cpu():
    log("== phase 5: card vs CPU, N=2000 x M=4096, 6 iterations")
    from gvamp_tpu_torch import linear, sim
    from gvamp_tpu_torch.data import GenoBed
    N, M = 2000, 4096
    cfg = linear.VampConfig(max_iter=6, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0, seed=5)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        bed, beta, vars_t, probs_t, rng = small_problem(tmp, 3, N, M)
        y = None
        for dev in ("cuda", "cpu"):
            g = GenoBed.from_files(bed, None, N=N, Mt=M, device=dev,
                                   standardize_phen=False)
            if y is None:
                y = sim.simulate_linear_phenotype(g, beta, 2.0, rng)
            g.set_phen(y)
            t0 = time.perf_counter()
            out[dev] = linear.infer(g, cfg, probs_t, vars_t, verbose=False)
            log(f"  {dev}: {time.perf_counter() - t0:.2f} s")
    (x_c, _, h_c), (x_p, _, h_p) = out["cuda"], out["cpu"]
    dx = float(np.abs(x_c - x_p).max() / np.abs(x_p).max())
    log(f"  max|x1 card - x1 cpu| / max|x1| = {dx:.3e} (limit 5e-5)")
    if not dx < 5e-5:
        raise AssertionError("card and CPU x1 disagree")
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        a, b = float(h_c[-1][k]), float(h_p[-1][k])
        log(f"  {k}: card {a:.7g} cpu {b:.7g} rel {abs(a - b) / abs(b):.3e} "
            f"(limit 2e-4)")
        if not abs(a - b) <= 2e-4 * abs(b):
            raise AssertionError(f"card and CPU {k} disagree")
    log(f"  cg_iters card {[h['cg_iters'] for h in h_c]} "
        f"cpu {[h['cg_iters'] for h in h_p]}")


def phase_cli():
    log("== phase 6: CLI infere on a small .bed/.phen")
    from gvamp_tpu.io import plink, vecio
    from gvamp_tpu_torch import cli, linear, sim
    from gvamp_tpu_torch.data import GenoBed
    N, M = 1500, 2048
    n_it = 4
    with tempfile.TemporaryDirectory() as tmp:
        bed, beta, vars_t, probs_t, rng = small_problem(tmp, 4, N, M)
        phen = os.path.join(tmp, "d.phen")
        g = GenoBed.from_files(bed, None, N=N, Mt=M, device="cuda",
                               standardize_phen=False)
        plink.write_phen(phen, sim.simulate_linear_phenotype(g, beta, 2.0, rng))
        args = ["--device", "cuda", "--run-mode", "infere", "--model",
                "linear", "--bed-file", bed, "--phen-files", phen,
                "--N", str(N), "--Mt", str(M), "--iterations", str(n_it),
                "--probs", ",".join(map(str, probs_t)),
                "--vars", ",".join(map(str, vars_t)), "--verbosity", "0",
                "--out-dir", os.path.join(tmp, "out"), "--out-name", "run"]
        cli.main(args)
        pre = os.path.join(tmp, "out", "run")
        names = [f"{pre}{s}" for it in range(1, n_it + 1)
                 for s in (f"_it_{it}.bin", f"_r1_it_{it}.bin",
                           f"_r2_it_{it}.bin", f"_it_{it}_x2_hat.bin",
                           f"_z1_it_{it}.csv")]
        missing = [n for n in names if not os.path.getsize(n)]
        if missing:
            raise AssertionError(f"CLI dumps missing: {missing}")
        g = GenoBed.from_files(bed, phen, N=N, Mt=M, device="cuda")
        x_lib, _, _ = linear.infer(g, linear.VampConfig(max_iter=n_it),
                                   probs_t, vars_t, verbose=False)
        dump = vecio.read_bin_shard(f"{pre}_it_{n_it}.bin", M, 0)
        d = float(np.abs(dump - x_lib).max() / np.abs(x_lib).max())
        log(f"  {len(names)} dumps written; max|dump - library x1| / max|x1| "
            f"= {d:.3e}")
        if not d < 1e-6:
            raise AssertionError("CLI dump differs from the library run")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks on small shapes")
    args = ap.parse_args(argv)
    phase_environment()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    phase_kernels_small(gen)
    if args.kernels_only:
        log("kernels-only run: phases 1-3a passed")
        return
    words = synth_config_b(gen)
    full = phase_kernels_config_b(words, gen)
    nw, m = words.shape
    launches = phase_main_path(words)
    del words
    torch.cuda.empty_cache()
    phase_card_vs_cpu()
    phase_cli()
    # times of the whole config-B matrix at B = 1; the error is the largest
    # over both widths
    kernels = [{"name": n, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[n], "launches": launches[n],
                "max_abs_err": max(r[n][0] for r in full.values() if n in r),
                "ms": full[1][n][1], "plain_ms": full[1][n][2],
                "shape": f"Nw={nw} Mpad={m} B=1"} for n in REPLACES]
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
