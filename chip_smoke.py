"""Smoke run of the PyTorch port (gvamp_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3a: build and check
    python3 chip_smoke.py --single-vector  # phase 1, the build, phase 3v
    python3 chip_smoke.py --bf16-split     # phase 1, the build, phase 3w
    python3 chip_smoke.py --options        # the build, 3r, 4q at B, 4r, 5q, 6q
    python3 chip_smoke.py --modes          # the build, 4, 4c, 4m, 4v, 4d, 5v, 6v
    python3 chip_smoke.py --mesh           # the build, 4, 8b, 8x, 8c, 8d, 8n

Phases, each of which raises on failure (exit code != 0):

1. environment: torch / CUDA / nvcc / triton versions and the card's name
   and power limit; TF32 off for every float32 product;
2. build the CUDA kernels (gvamp_tpu_torch/csrc/matvec.cu, fragments.cu,
   bf16_split.cu, gram_aat.cu, gram_prim.cu, study.cu, fused_ab.cu and
   counts.cu, one nvcc each, started together); the ptxas
   report must show no spill store in any instantiation of any kernel;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   with CUDA-event times of both: (a) all twenty-five at small shapes (the
   fused primal Grams with both mask forms and B above their column
   chunks; the bf16-split products (csrc/bf16_split.cu's bf16 tensor-core
   chains), atx and atx_a (csrc/matvec.cu's tables) also on Gaussian
   inputs against float64 within kernel_check.TOL; the study kernels of
   ops/study.py also at Nw=300 and Mpad not a multiple of 512, the row
   sums stream_sum and stream at every threads x bytes-per-load
   configuration of bench_stream's sweep, v1_decode_a, v2_decode_ab and
   v3_bitcast on words of one code against their exact sums, v5_dot1,
   v6_fused_ab, v7_i8decode (both keys) and v8_atxm_vt at B = 1, 2 and 5
   and each shape's B, v7 also against axm_i8a on the words its byte rows
   were expanded from; the five digit products of fragments.cu, axm_i8a,
   atxm_i8a, axm_i8, atxm_i8 and axm_i8s, also at the edges of their
   grids, FRAGMENT_SHAPES: Nw = 7 and 300, Mpad = 8 and 1,000, B up to
   22, the four of the engines also at deflation's width, B = 128 (Nw =
   300, DEFLATE_SHAPES), and the bf16-split products there too (also
   against float64); the
   fused dual Grams of gram_aat.cu at theirs, GRAM_AAT_SHAPES: Nw = 7, 300
   and 822 (the route's edge), Mpad of one stripe and with a short last
   group of stripes, B up to 5; the fused primal Grams of gram_prim.cu at
   theirs, GRAM_PRIM_SHAPES: one band and fewer bands than the tile ring,
   a short last block, Mpad 135,168 (the route's edge on 132 SMs), B from
   1 to 5 and 70),
   (b) the a-only kernels, atx, atx_a and the bf16-split products on the
   whole config-B matrix at B = 1 and 2 (the bf16 ones, atx and atx_a
   also on Gaussian inputs against their plain versions within
   BF16_PLAIN_TOL),
   and axm_i8a and atxm_i8a at B = 22 (LOCO's width on complete
   genotypes, 11 digit groups), and the statistics pass's count kernel
   (marker_counts, csrc/counts.cu) on the whole matrix over a random NA
   support, its counts equal to marker_counts_ref's and timed for the
   kernels line,
   (c) the general kernels, axm_i8s and the bf16-split products on the
   whole config-Bm matrix at B = 1 and 2, and axm_i8 and axm_i8s at
   B = 22, and the count kernel there as in (b);
   in (b) and (c) each plain version runs once on the whole matrix, at
   B = 1 (its one call timed), and the launches on the whole matrix at
   B = 2 and 22 and on Gaussian inputs are held against it on a band,
   the last 1,024 word rows of a forward product's output or the last
   8,192 markers of a transposed one's, at the full contraction length;
   (d) the fused dual Grams on the whole config-X matrix (gram_aat_i8a)
   and config-Xm matrix (gram_aat_i8) at B = 1 (their plain versions on
   the whole matrix) and at 2 and 5 (on 65,536 of its markers, every word
   row), timed beside their two-pass composition, and ax there (dyadic
   inputs bit for bit, the statistics' real inputs to a stated
   tolerance);
   (v) with --single-vector and nothing else: atx and atx_a on the whole
   config-B matrix and ax on the config-X one, checked as in (b) and (d)
   and timed, for comparing two trees in turns;
   (w) with --bf16-split and nothing else: axm_bf16 and atxm_bf16 at B =
   1 and 2 on the whole config-B and config-Bm matrices, checked as in (b)
   and (c) (dyadic inputs bit for bit, Gaussian inputs within
   BF16_PLAIN_TOL of their plain versions) and timed, for comparing two
   trees in turns, and on config B their error against float64 at the
   full contraction length printed beside the plain versions';
   (e) the fused primal Grams on the whole config-B matrix (gram_i8a) and
   config-Bm matrix (gram_i8) at B = 1 and 2 (the plain version on the
   whole matrix at B = 1, on its last 8,192 markers at B = 2), timed
   through the wrapper
   and as the bare launch beside their two-pass composition, with packed
   GB/s and the bound;
   (s) the study kernels (stream, stream_sum, v0_stream, v1_decode_a,
   v2_decode_ab, v3_bitcast, and at B = 2 v5_dot1, v7_i8decode under both
   keys on the matrix's byte rows, a second 10.74 GB buffer freed before
   3e, and v8_atxm_vt) on the whole config-B matrix and v6_fused_ab on
   the whole config-Bm matrix (B = 2, its plain version on the whole
   matrix; B = 16 and 64 on a band; each B also against axm_i8s and timed
   in turns with it over three rounds), timed beside their plain versions
   and, for the first three, the one PyTorch call that computes the same
   sum (torch.sum, in turns with the kernel over five rounds);
   (r) axm_i8a, atxm_i8a, axm_i8 and atxm_i8 at B = 2 on --red's window of
   the config-B and config-Bm matrices (2,048 of 20,480 word rows, a row
   view of the words) at a start inside and at the last legal one, bit
   for bit against their plain versions on the same window and timed
   beside their bound, then the engine's windowed products
   (GenoBed.window_fns_multi) timed around them;
4. the linear VAMP main path at config B of bench.py (N=327,680 x
   M=131,072, complete genotypes, 10.74 GB of packed words on the card):
   load, phenotype simulation and 10 iterations of linear.infer, with the
   launch counters proving that the path ran through the a-only kernels
   and that its statistics passes ran through the count kernel;
   4f. the same problem with GVAMP_FUSED_GRAM=1: every CG product through
   gram_i8a and the explicit noise pass, against the two-pass run;
   4p. probit at config B: a binary phenotype (probit_var = 1 - h2 = 0.5),
   10 iterations two-pass and 10 through the fused Gram;
   4m. the missing-genotype path at config Bm (the same shape, about 1.56%
   of calls missing): 10 iterations, then LOO and LOCO p-values over 22
   chromosomes, through the general kernels and not the a-only ones, then
   4f there through gram_i8;
   4x. the dual (XXT) path at config X (N=5,120 x M=524,288, 671 MB) and
   Xm (1.56% missing), 10 iterations each through the fused dual Gram
   (ax twice for the people statistics), the X problem again under
   GVAMP_NO_FUSED_GRAM=1 (the same trajectory) and in primal mode;
   4h. the Huber engine (robust.infer) at config B on a heavy-tailed
   phenotype (tools/bench_huber.py's: y = A (sqrt(N) beta) + 0.5 t(3)),
   RobustConfig(rho=0.15, stab_gamma=1.0), 10 iterations with SLQ, then
   10 with deflate_k=128 after timing top_eigs alone (9 Gram passes at B =
   128), each iteration's ms, CG count, host syncs, deltaH, tau1 / tau2
   and corr(x_hat, beta) printed, the launch counters proving that the CG
   ran axm_i8a / atxm_i8a and no other product kernel; then 5 iterations
   at config Bm through axm_i8 / atxm_i8;
   4q. the probe path (use_slq=False: the Onsager term from one Hutchinson
   probe column riding the block CG) at config B on phase 4's problem, 10
   iterations, and the dual probe path at config X (inside phase 4x);
   4r. --red at config B and Bm, 10 iterations each: every CG pass on the
   window, counted by wrapping window_fns_multi against the launch
   counters;
   4c. cross-validation at config B on phase 4's instance: 10 iterations
   with use_cross_val (98% of the people train, 2% held out re-damp x1
   while their R2 falls), each iteration's cv_r2, rho_cross, retries,
   host syncs and ms, the median beside phase 4's, corr(x_hat, beta),
   the launches (axm_i8a / atxm_i8a only);
   4v. the run modes' work at full width on phase 4m's container: the
   last 3 estimates of 4m's run written to a temporary directory and
   read back as a series, scored (each R2 against 4m's R2_train_1), their
   LOO p-values in one pass (the last one's file against 4m's loo_pvals)
   and LOCO for the last one (against 4m's loco_pvals), and the matrix
   prediction (against 4m's A x1), each timed, the launches on axm_i8;
   4d. the dense methylation path (GenoDense, --type-data meth) at N=8,192
   x M=485,577 (the HumanMethylation450 array's probes, 15.9 GB of
   float32): X drawn on the card and standardised per probe, its float64
   statistics, bench.py's phenotype, 10 linear iterations through
   torch.matmul; statistics seconds, ms per iteration, corr(x_hat, beta)
   and the peak memory; freed before the next phase;
   4n. the p-value moments at N=327,680 against a float64 oracle;
   4t. the multi-trait engines (gvamp_tpu_torch/multi.py) at config B on
   phase 4's words: T = 8 linear traits (bench.py's recipe, one seed and
   h2 per trait, 0-5% NA phenotypes) for 10 iterations two-pass and 3
   under GVAMP_FUSED_GRAM=1 (held against the two-pass run's third), T = 4
   binary traits for 10 and T = 2 Huber traits for 5, each printing its T
   statistics passes, the set-up left (probe, A_t^T y_t, SLQ basis), each
   iteration's ms, CG count per trait and host syncs, every trait's
   corr(x_hat, beta), the peak memory and the launch counters, which must
   show the CG on axm_i8a / atxm_i8a (gram_i8a fused) and nothing of the
   two-plane form or the tools; 4tm: T = 4 linear traits at config Bm on
   phase 4m's words, 3 iterations through axm_i8 / atxm_i8, then 3
   through gram_i8 held against them;
5. the same small problem on the card and on the CPU (plain versions),
   complete and with 2% missing calls (then with LOO and LOCO p-values),
   primal and dual, linear with the fused primal Gram, and probit
   (complete; 2% missing with 2 covariates, two-pass and fused), which must
   agree to the f32 tolerances of tests/test_torch_{linear,probit}.py;
   5h. the Huber engine likewise (N=2,000 x M=4,096, complete, 2% missing
   and complete with deflate_k=8, 6 iterations): finite, the same deltaH
   grid point at every iteration, and x1 and the scalars within
   HUBER_CARD_CPU_XTOL / _RTOL at the iterations before the JAX package's
   own float32-against-float64 spread grows (tests/huber_spread.py);
   5t. the multi-trait engines likewise, T = 3 (linear complete and with
   2% missing calls at N=2,000 x M=4,096, probit with 2 covariates at
   N=6,000 x M=2,048, Huber at N=1,500 x M=300), within the f32
   tolerances of tests/test_torch_multi*.py (MULTI_CARD_CPU);
   5q. the same on the probe path and under red: linear primal (2%
   missing) and dual (complete) with use_slq=False, red complete and with 2%
   missing (the same window starts on both sides), probit (2% missing, 2
   covariates) and Huber (complete) with use_slq=False, and the T = 3
   linear multi-trait run with use_slq=False, with the limits of phases 5,
   5h and 5t, probe_iters printed on both sides;
   5v. the same for the run modes' engines: cross-validated linear,
   complete and with 2% missing calls (cv_r2 and rho_cross within phase
   5's limits too, each side's rejected tries printed, the card's run on
   axm_i8a / atxm_i8a or axm_i8 / atxm_i8), the dense linear engine
   (N=2,000 x M=4,096), and state_evolution from the same draws within
   1e-6;
6. the CLI (`--run-mode infere --model linear --store-pvals 1` with a
   .bim) on the flagship recipe of the README's port section, then with
   `--use-XXT-denoiser 1` (6x) and as `--model bin_class --cov-file --C 2`
   on a binary phenotype (6p); 6r: for `--model robust`, linear and
   bin_class, 3 iterations with `--checkpoint`, then `--run-mode restart
   --resume` for 3 more, whose iteration-6 dump must equal a 6-iteration
   run's bit for bit, and the linear `restart --estimate-file`; 6t: the
   multi-trait CLI (three --phen-files per model on the flagship
   genotypes): linear with `--store-pvals 1` and a .bim (each trait's
   `_phen{t}` dumps, LOO / LOCO p-values and LOCO predictors), then the 3
   + 3 `--checkpoint` / `restart --resume` of each model, every trait's
   iteration-6 dump equal bit for bit to a 6-iteration run's; 6q: the
   flagship linear CLI with --sync-every 3 (bit for bit against single
   steps at 4 iterations), --phase-timers 1, --store-pip 1, --profile-dir
   (the trace names the port's kernels) and --use-slq 0 with --checkpoint
   and restart --resume (bit for bit against 6 iterations in one run);
   6v: the run modes through the CLI on the flagship files and a test
   set of 400 other people: sim, infere with --use-cross-val 1
   --state-evo 1, test over its dumped series (the R2 at the last
   iteration against the CPU's float64 score within 1e-5), both,
   pvals-calc with a .bim, predict_single and predict --predict-format
   matrix, then --type-data meth on a small .meth file; every output
   file checked for presence and shape;
7. the port's tools on the card, each of whose ``main([])`` must return 0:
   the kernel check against float64 (gvamp_tpu_torch.tools.kernel_check,
   with the fused Grams' correctness), the fused-Gram study (bench_gram),
   the kernel profile (profile_kernels), the stream-ceiling sweep
   (bench_stream, at its default 1.68 GB and again at config B's 10.74 GB)
   the nine-rung variant ladder (bench_variants, which holds every rung
   bit for bit against its plain version on the tool's own words and
   shape, v7_i8decode also against axm_i8a, and fails if one differs or
   v6_fused_ab strays from axm_i8) and the round-2 candidates
   (bench_round2: v8_atxm_vt against atxm_i8a and v7_i8decode against
   axm_i8a, bit for bit at the timed shape).  No engine path launches
   axm_bf16, atxm_bf16, axm_i8s, atx_a or the eleven study kernels
   (phases 4-6 fail if one does); their launches in the kernels line are
   those of this phase.
8. the marker mesh (gvamp_tpu_torch/dist.py), both shards of a 2-shard
   mesh on the one card (the JAX package's mesh with two devices):
   8b. config B on 2 shards: the slabs split from phase 4's words, the
   statistics equal to phase 4's bit for bit, phase 4's phenotype, 10
   linear iterations within phase 4's CORR_MIN / R2_RANGE; axm_i8a and
   atxm_i8a launched twice per product call (the mesh's call counter),
   atx twice at load, the host syncs of every iteration those of phase
   4's beside its CG count, the largest x1 difference to phase 4
   relative to max|x1| and the median ms per iteration beside phase 4's;
   8x. the dual path at config X on 2 shards: 10 iterations within phase
   4x's X_CORR_MIN / X_R2_RANGE, gram_aat_i8a twice per call, ax four
   times (the people statistics' two calls);
   8c. card against CPU on 2 shards (phase 5's problem and limits,
   complete and with 2% missing calls, the latter with its LOO / LOCO
   p-values);
   8d. the CLI with --distributed 1 --n-processes 1 at phase 6's
   flagship size: a real NCCL process group of one rank (its backend and
   world size printed), whose dumps, histories and p-value files equal
   those of the same run without --distributed bit for bit;
   8n. two NCCL ranks of one card each against one process with
   --devices 2, where two or more cards are visible; otherwise the phase
   prints that it did not run and why.  Phases 8b and 8x run after
   phases 4 and 4x, 8c after phase 5v, 8d and 8n after phase 6v.

The last two lines of standard output are one JSON object with the
kernels' numbers (each with its bound on the card) and one with the
device; before them, the nvidia-smi name and power limit.  The script
needs a CUDA device: without one it exits non-zero and prints no result.
It imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gvamp_tpu_torch.tools import bench_gram, kernel_check  # noqa: E402
from gvamp_tpu_torch.tools.common import (  # noqa: E402
    STUDY_KERNELS, STUDY_PRODUCTS, bound, cuda_ms, random_words, smi,
    synth_words)

# config B of bench.py:39-42: N=327,680 (20,480 words of 16 samples),
# M=131,072 markers -> 10.74 GB packed
CFG_B_N, CFG_B_M = 327_680, 131_072
CFG_B_ITERS = 10
# config X of bench.py:282-299, the dual (N << M) regime: N=5,120 (320
# words) x M=524,288 -> 671 MB packed; Xm the same with ~1.56% missing
CFG_X_N, CFG_X_M = 5_120, 524_288
# the JAX package's kernel each CUDA kernel replaces (def line of the wrapper)
REPLACES = {"axm_i8a": "gvamp_tpu/ops/matvec.py:797",
            "atxm_i8a": "gvamp_tpu/ops/matvec.py:1581",
            "axm_i8": "gvamp_tpu/ops/matvec.py:539",
            "atxm_i8": "gvamp_tpu/ops/matvec.py:704",
            "atx": "gvamp_tpu/ops/matvec.py:287",
            "ax": "gvamp_tpu/ops/matvec.py:241",
            "gram_aat_i8a": "gvamp_tpu/ops/matvec.py:1400",
            "gram_aat_i8": "gvamp_tpu/ops/matvec.py:1467",
            "gram_i8a": "gvamp_tpu/ops/matvec.py:963",
            "gram_i8": "gvamp_tpu/ops/matvec.py:1133",
            "axm_bf16": "gvamp_tpu/ops/matvec.py:342",
            "atxm_bf16": "gvamp_tpu/ops/matvec.py:403",
            "axm_i8s": "gvamp_tpu/ops/matvec.py:618",
            "atx_a": "gvamp_tpu/ops/matvec.py:1540",
            "stream": "tools/bench_stream.py:33",
            "stream_sum": "tools/bench_stream.py:59",
            "v0_stream": "tools/bench_variants.py:78",
            "v1_decode_a": "tools/bench_variants.py:103",
            "v2_decode_ab": "tools/bench_variants.py:126",
            "v3_bitcast": "tools/bench_variants.py:152",
            "v5_dot1": "tools/bench_variants.py:179",
            "v6_fused_ab": "tools/bench_variants.py:215",
            "v7_i8decode": "tools/bench_variants.py:296",
            "v8_atxm_vt": "tools/bench_round2.py:58",
            "v7_i8decode_round2": "tools/bench_round2.py:102"}
KERNELS = tuple(REPLACES)
# the study kernels (ops/study.py, csrc/study.cu) that the study tools run:
# the row sums, and the staged products of the library's contracts
STUDY = STUDY_KERNELS + tuple(STUDY_PRODUCTS)
# the product kernels (gvamp_tpu_torch/ops/matvec.py)
PRODUCT_KERNELS = tuple(n for n in KERNELS if n not in STUDY)
# the statistics pass's count kernel, launched by every load and set_phen;
# it replaces XLA code of the JAX package, not a Pallas kernel, so it has a
# row on the kernels line but none in REPLACES
COUNT_KERNEL = "marker_counts"
COUNT_SOURCE = "gvamp_tpu_torch/csrc/counts.cu"
COUNT_REPLACES = "gvamp_tpu/data.py:85"
# each kernel's entries in the ptxas report: a pattern that the mangled
# names of every instantiation match (default "<name>_kernel"); the
# fragment products, the dual Grams (gram_aat.cu), the primal ones
# (gram_prim.cu) and atx / atx_a (matvec.cu) one instantiation of their
# template each, by the forward loop's form <kForm> (0 one plane, 1 two
# planes, 2 two planes in one sum) or the plane count <kBoth> /
# <kGeneral>; the row sums one per bytes per load, named by <V, Decode,
# lanes>
PTXAS_ENTRY = {"atx": "atx_kernelILb1E",
               "atx_a": "atx_kernelILb0E",
               "axm_i8a": "axm_i8_kernelILi0E",
               "atxm_i8a": "atxm_i8_kernelILb0E",
               "axm_i8": "axm_i8_kernelILi1E",
               "atxm_i8": "atxm_i8_kernelILb1E",
               "axm_i8s": "axm_i8_kernelILi2E",
               "gram_aat_i8a": "gram_aat_kernelILb0E",
               "gram_aat_i8": "gram_aat_kernelILb1E",
               "gram_i8a": "gram_prim_kernelILb0E",
               "gram_i8": "gram_prim_kernelILb1E",
               "stream_sum": r"row_sum_kernelILi\d+EL\w*DecodeE0ELi1E",
               "v0_stream": r"row_sum_kernelILi\d+EL\w*DecodeE0ELi1E",
               "v1_decode_a": r"row_sum_kernelILi\d+EL\w*DecodeE1ELi1E",
               "v2_decode_ab": r"row_sum_kernelILi\d+EL\w*DecodeE2ELi1E",
               "v3_bitcast": r"row_sum_kernelILi\d+EL\w*DecodeE1ELi4E",
               "v5_dot1": "stage_dot_kernel",
               "v6_fused_ab": "fused_ab_kernel",
               "v7_i8decode": "i8decode_kernel",
               "v7_i8decode_round2": "i8decode_kernel",
               "v8_atxm_vt": "atxm_vt_kernel"}
SOURCE = "gvamp_tpu_torch/csrc/matvec.cu"
STUDY_SOURCE = "gvamp_tpu_torch/csrc/study.cu"
# v6_fused_ab's wgmma kernel, one instantiation per digit group width N
FUSED_AB_SOURCE = "gvamp_tpu_torch/csrc/fused_ab.cu"
# the fused dual Grams: one template, gram_aat_kernel<kBoth>, instantiated
# for one plane (gram_aat_i8a) and for two (gram_aat_i8)
GRAM_AAT_KERNELS = ("gram_aat_i8a", "gram_aat_i8")
GRAM_AAT_SOURCE = "gvamp_tpu_torch/csrc/gram_aat.cu"
# the fused primal Grams: one template, gram_prim_kernel<kGeneral>,
# instantiated for one plane (gram_i8a) and for two (gram_i8)
GRAM_PRIM_KERNELS = ("gram_i8a", "gram_i8")
GRAM_PRIM_SOURCE = "gvamp_tpu_torch/csrc/gram_prim.cu"
# the products whose mma fragments come straight from the decode: one
# template per direction (csrc/fragments.cu), instantiated for one plane
# (complete genotypes), for two (missing calls) and, forward, for two
# planes in one sum (axm_i8s)
FRAGMENT_KERNELS = ("axm_i8a", "atxm_i8a", "axm_i8", "atxm_i8", "axm_i8s")
FRAGMENT_SOURCE = "gvamp_tpu_torch/csrc/fragments.cu"
# the bf16-split products on bf16 tensor cores, their A fragments the
# decoded fields masked to one plane
BF16_KERNELS = ("axm_bf16", "atxm_bf16")
BF16_SOURCE = "gvamp_tpu_torch/csrc/bf16_split.cu"
SHAPES = [(32, 512, 1), (64, 1024, 2), (96, 1536, 5), (32, 2048, 17),
          (64, 512, 70)]
# the edges of the fragment kernels' grids beyond SHAPES, checked for those
# kernels only (the fused primal Grams refuse Nw not a multiple of 32, the
# dual ones Mpad not a multiple of 64): Nw not a multiple of 8 (7) or of a
# block's rows (300), Mpad below one step (8) and not a multiple of one
# (1,000), and B = 22 (LOCO's width, 11 digit groups over gridDim.z)
FRAGMENT_SHAPES = [(7, 8, 22), (7, 1000, 1), (300, 8, 2), (300, 1000, 22),
                   (300, 1000, 1)]
# the edges of the fused dual Grams' grid beyond SHAPES: Nw not a multiple
# of 8 (7, 300; one masked step and one warp at 7), Nw = 822 (the route's
# edge, the largest shared memory), Mpad of one stripe (64) and with a
# short last group of stripes (576: 8 + 1, 704: 8 + 3, 1,216: 8 + 8 + 3),
# B = 1 to 5 (one to three groups of two columns)
GRAM_AAT_SHAPES = [(7, 64, 1), (7, 704, 5), (300, 576, 2), (300, 1216, 3),
                   (822, 704, 5), (822, 64, 2)]
# the edges of the fused primal Grams' design beyond SHAPES, on the card's
# SMs (132 on an H100): one band (Nw = 16) and two, fewer than the ring of
# three band tiles; Mpad 1,004 and 4,204, whose last block has a short
# quad range (1 quad of 2, 3 of 8); Mpad 135,168, the route's edge (256
# quads per block), and 135,156 (the last block 253 quads); B from 1 to 5
# (one to three digit groups; above 2 av is read and written per band)
# and 70, above both column chunks
GRAM_PRIM_SHAPES = [(16, 512, 1), (32, 1004, 2), (48, 4204, 3),
                    (32, 2048, 4), (16, 135_168, 5), (32, 135_156, 2),
                    (64, 512, 70)]
# deflation's width: the digit products that top_eigs runs at B =
# deflate_k (128 in phase 4h), on a FRAGMENT_SHAPES entry
DEFLATE_KERNELS = ("axm_i8a", "atxm_i8a", "axm_i8", "atxm_i8")
DEFLATE_SHAPES = [(300, 1000, 128)]
SLICE_M = 2048
# corr(x_hat, beta) and R2_train_1 after 10 iterations at config B and at
# config Bm; set from the first H100 runs of this script (config B 0.99590
# and 0.44236, config Bm 0.99594 and 0.44155, PERF.md) with room for f32
# rounding and a different card, not for a different algorithm
CORR_MIN = 0.99
R2_RANGE = (0.40, 0.50)
# config Bm: LOCO over 22 chromosomes of contiguous marker blocks
BM_CHROMS = 22
# p-values at config Bm (LOO and LOCO): the median p of the ~1,000 causal
# markers must lie far below the nulls' (first run: 4e-33 and 6e-85, null
# median 0.50), and the share of the ~130,000 null markers below 0.05
# near 0.05 (binomial sd 0.0006; first run 0.0506 and 0.0509)
CAUSAL_MEDIAN_P_MAX = 1e-10
NULL_SHARE_RANGE = (0.04, 0.06)
# card vs CPU p-values on 2% missing calls: |dlog10 p| relative to
# max(1, |log10 p|), as x1 itself differs by up to 5e-5 between them
# (first run 1.9e-5)
CARD_CPU_LOG10P_TOL = 2e-4


# the script's start, for the elapsed time on each phase's header line
T_START = time.perf_counter()


def log(msg=""):
    if msg.startswith("== "):
        msg = f"{msg}  [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


def clocked(infer, *args, callbacks=None, **kw):
    """``infer(*args, **kw)`` (an engine's) with a clock among its
    callbacks: each history entry gets ``host_ms``, the host time of its
    chunk split evenly over the chunk's iterations, stamped after each
    chunk's metrics fetch (which waits for the card).  The clock starts at
    the call, so iteration 1's ``host_ms`` holds the engine's set-up."""
    stamps = [time.perf_counter()]
    its = []

    def stamp(it, *_):
        stamps.append(time.perf_counter())
        its.append(it)

    out = infer(*args, callbacks=list(callbacks or []) + [stamp], **kw)
    hist = out[2]
    sizes = ([len(hist) - (its[-1] - its[0])]
             + [b - a for a, b in zip(its, its[1:])])
    ms = [(t1 - t0) * 1e3 / k
          for t0, t1, k in zip(stamps, stamps[1:], sizes) for _ in range(k)]
    for h, v in zip(hist, ms):
        h["host_ms"] = v
    return out


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
    log(f"nvidia-smi: {smi()}")
    log(f"device: {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn {torch.backends.cudnn.allow_tf32}")


def ptxas_report(text: str) -> dict:
    """{mangled kernel name: (registers, spill-store bytes)} from the
    ``nvcc -Xptxas -v`` log."""
    out = {}
    for part in text.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out[name] = (int(regs.group(1)) if regs else -1,
                     int(spill.group(1)) if spill else -1)
    return out


def phase_build():
    """Build the kernels; every kernel of the library must compile with
    no spill stores (ptxas report)."""
    log("== phase 2: build")
    from gvamp_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.library()._name
    log(f"kernels: {path} ready in {time.perf_counter() - t0:.2f} s")
    if not _build.BUILD_INFO:
        log("library from an earlier build: no ptxas report in this run")
        return
    log(f"nvcc: {_build.BUILD_INFO['command']}")
    log(f"nvcc build {_build.BUILD_INFO['seconds']:.2f} s; ptxas:")
    log(_build.BUILD_INFO["log"].strip())
    check_ptxas(ptxas_report(_build.BUILD_INFO["log"]))


def check_ptxas(report: dict) -> None:
    """Every instantiation of each kernel in the ptxas report (its mangled
    names matching PTXAS_ENTRY) must show no spill store."""
    for kernel in KERNELS:
        entry = PTXAS_ENTRY.get(kernel, f"{kernel}_kernel")
        hits = {n: r for n, r in report.items() if re.search(entry, n)}
        if not hits:
            raise AssertionError(f"ptxas reported no entry for {kernel}")
        for n, (regs, spill) in hits.items():
            log(f"  {kernel:12s} {regs:3d} registers, {spill} bytes spill "
                f"stores ({n})")
            if spill != 0:
                raise AssertionError(f"{n}: {spill} bytes of spill stores")


def compare(name, label, got, want) -> float:
    """max |got - want| over the paired outputs; raises unless they are
    equal bit for bit."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} {label}: kernel differs from its plain "
                             f"version (max |diff| {err:.3e})")
    return err


# the bands of a whole matrix on which a launch there is held against its
# plain version: the last BAND_ROWS word rows of a forward product's output
# [4, Nb, B] (those slots read only those rows), the last BAND_COLS
# markers of a transposed product's [Mpad, B] (those entries read only
# those markers); the full contraction length either way
BAND_ROWS = 1024
BAND_COLS = 8192
FORWARD_KERNELS = ("axm_i8a", "axm_i8", "axm_i8s", "axm_bf16",
                   "v6_fused_ab")
TRANSPOSED_KERNELS = ("atxm_i8a", "atxm_i8", "atxm_bf16", "atx", "atx_a")


def band_words(words, name):
    """(the words the plain version reads for ``name``'s band, the slice of
    the kernel's output that it must equal)."""
    nw, m = words.shape
    if name in FORWARD_KERNELS:
        r0 = nw - BAND_ROWS
        return words[r0:], (slice(None), slice(4 * r0, 4 * nw))
    c0 = m - BAND_COLS
    return words[:, c0:].contiguous(), (slice(c0, m),)


def timed_once(fn):
    """(CUDA-event ms of one call of ``fn``, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def check_kernels(words, B, gen, label, names=PRODUCT_KERNELS, count=None,
                  reps=5, plain_reps=3, band=False):
    """Each kernel of ``names`` against its plain version on ``words``;
    returns {name: (max_abs_err, ms, plain_ms)}.

    The digit kernels: both sides share the quantisation and the fold on
    this device and their integer products are exact, so they must be
    equal bit for bit.  The fused dual Grams fold and requantise each
    stripe inside the kernel with the plain version's roundings and sum
    the stripes with the same torch.sum: equal bit for bit too.  atx, atx_a,
    ax and the bf16-split products: dyadic inputs (multiples of 1/8 in
    [0, 1], exact in the bf16 hi part, so mid = lo = 0) keep every f32
    partial sum exact in any order, so they must be equal too.  With
    v = 1, atx's bv counts each marker's non-missing calls: it must equal
    the plain version's count and, where given, ``count``.  The study
    products (v5_dot1, v6_fused_ab, v7_i8decode on the words' byte rows,
    made here only for it, and v8_atxm_vt) share the digit contract, and
    v7 must equal axm_i8a on the words too.

    ``plain_reps`` 0 times the plain version's one comparison call instead
    of timing it again (a whole matrix's plain version takes seconds a
    call).  With ``band`` each kernel runs on the whole matrix and the
    plain version on its band only (``band_words``; plain_ms None)."""
    from gvamp_tpu_torch.ops import matvec, study
    nw, m = words.shape
    dev = words.device
    W = torch.randn((m, B), generator=gen, device=dev)
    U = torch.randn((m, B), generator=gen, device=dev) * 3
    V = torch.randn((4, 4 * nw, B), generator=gen, device=dev)

    def dyadic(*shape):
        return torch.randint(0, 9, shape, generator=gen,
                             device=dev).float() / 8

    v = dyadic(4, 4 * nw)
    w8, u8 = dyadic(m), dyadic(m)
    W8, U8, V8 = dyadic(m, B), dyadic(m, B), dyadic(4, 4 * nw, B)
    mave = torch.rand((m,), generator=gen, device=dev) * 2
    msig2 = torch.rand((m,), generator=gen, device=dev) * 1.5 + 0.5
    # the fused primal Grams take one mask for every column or one per
    # column: odd B gives gram_i8a the first and gram_i8 the second
    na_all = (torch.rand((4, 4 * nw), generator=gen, device=dev) > 0.1).float()
    na_col = (torch.rand((4, 4 * nw, B), generator=gen, device=dev)
              > 0.1).float()
    na_a, na_g = (na_all, na_col) if B % 2 else (na_col, na_all)
    cu = torch.randn((B,), generator=gen, device=dev)
    bytes8 = (study.expand_words(words)
              if any(n.startswith("v7_") for n in names) else None)

    def cases(g):
        return {
            "axm_i8a": (lambda: matvec.axm_i8a(g, W),
                        lambda: matvec.axm_i8a_ref(g, W)),
            "atxm_i8a": (lambda: matvec.atxm_i8a(g, V),
                         lambda: matvec.atxm_i8a_ref(g, V)),
            "axm_i8": (lambda: matvec.axm_i8(g, W, U),
                       lambda: matvec.axm_i8_ref(g, W, U)),
            "atxm_i8": (lambda: matvec.atxm_i8(g, V),
                        lambda: matvec.atxm_i8_ref(g, V)),
            "atx": (lambda: matvec.atx(g, v),
                    lambda: matvec.atx_ref(g, v)),
            "ax": (lambda: matvec.ax(g, w8, u8),
                   lambda: matvec.ax_ref(g, w8, u8)),
            "gram_aat_i8a": (lambda: matvec.gram_aat_i8a(g, V, mave, msig2),
                             lambda: matvec.gram_aat_i8a_ref(g, V, mave,
                                                             msig2)),
            "gram_aat_i8": (lambda: matvec.gram_aat_i8(g, V, mave, msig2),
                            lambda: matvec.gram_aat_i8_ref(g, V, mave,
                                                           msig2)),
            "gram_i8a": (lambda: matvec.gram_i8a(g, W, na_a, cu),
                         lambda: matvec.gram_i8a_ref(g, W, na_a, cu)),
            "gram_i8": (lambda: matvec.gram_i8(g, W, U, na_g),
                        lambda: matvec.gram_i8_ref(g, W, U, na_g)),
            "axm_bf16": (lambda: matvec.axm_bf16(g, W8, U8),
                         lambda: matvec.axm_bf16_ref(g, W8, U8)),
            "atxm_bf16": (lambda: matvec.atxm_bf16(g, V8),
                          lambda: matvec.atxm_bf16_ref(g, V8)),
            "axm_i8s": (lambda: matvec.axm_i8s(g, W, U),
                        lambda: matvec.axm_i8s_ref(g, W, U)),
            "atx_a": (lambda: matvec.atx_a(g, v),
                      lambda: matvec.atx_a_ref(g, v)),
            "v5_dot1": (lambda: study.v5_dot1(g, W),
                        lambda: study.v5_dot1_ref(g, W)),
            "v6_fused_ab": (lambda: study.v6_fused_ab(g, W, U),
                            lambda: study.v6_fused_ab_ref(g, W, U)),
            "v7_i8decode": (lambda: study.v7_i8decode(bytes8, W),
                            lambda: study.v7_i8decode_ref(bytes8, W)),
            "v7_i8decode_round2": (
                lambda: study.v7_i8decode_round2(bytes8, W),
                lambda: study.v7_i8decode_round2_ref(bytes8, W)),
            "v8_atxm_vt": (lambda: study.v8_atxm_vt(g, V),
                           lambda: study.v8_atxm_vt_ref(g, V))}

    whole = cases(words)
    out = {}
    for name in names:
        fn, ref = whole[name]
        got = fn()
        if isinstance(got, torch.Tensor):
            got = (got,)
        plain = None
        if band:
            g, sl = band_words(words, name)
            want = cases(g)[name][1]()
            got = tuple(x[sl] for x in got)
        elif plain_reps:
            want = ref()
            plain = cuda_ms(ref, plain_reps)
        else:
            plain, want = timed_once(ref)
        if isinstance(want, torch.Tensor):
            want = (want,)
        err = compare(name, f"{label} B={B}" + " band" * band, got, want)
        if name.startswith("v7_"):
            compare(name, f"{label} B={B} against axm_i8a", got,
                    (matvec.axm_i8a(words, W),))
        del got, want
        out[name] = (err, cuda_ms(fn, reps), plain)
    if "atx" in names:
        ones = torch.ones((4, 4 * nw), device=dev)
        bv1 = matvec.atx(words, ones)[1]
        if band:
            g, sl = band_words(words, "atx")
            bv1, rbv1 = bv1[sl], matvec.atx_ref(g, ones)[1]
        else:
            rbv1 = matvec.atx_ref(words, ones)[1]
        if not torch.equal(bv1, rbv1) or (
                count is not None and not bool((bv1 == count).all())):
            raise AssertionError(f"atx {label}: bv differs from the "
                                 f"non-missing count")
    torch.cuda.synchronize()
    for name, (e, t, p) in out.items():
        gbs = 4 * nw * m / (t * 1e6)
        where = (f"band of {BAND_ROWS} word rows" if name in FORWARD_KERNELS
                 else f"band of {BAND_COLS} markers") if band else "equal"
        log(f"  {label:>22s} B={B:<3d} {name:12s} {where}  max|err|={e:.3e}  "
            f"kernel {t:8.3f} ms ({gbs:7.1f} GB/s packed)"
            + (f"  plain {p:8.3f} ms" if p is not None else ""))
    return out


# the f32 kernels that the dyadic checks hold bit for bit, on Gaussian
# inputs: within kernel_check.TOL of float64 at the small shapes (a bf16
# part lost would err ~1e-3), and
# within BF16_PLAIN_TOL of their plain versions on the whole config-B matrix
# (f32 sums of the same exact terms in other orders; relative to the
# largest entry).  BF16_PLAIN_TOL was set from the first H100 run: axm_bf16
# 6.7e-7 (B=1) and 8.8e-7 (B=2), atxm_bf16 4.2e-7, atx_a 8.4e-8 (PERF.md),
# with room for other summation orders on another card; atx, whose a-side
# is atx_a's and whose b-side sums the same way, joined them later
GAUSSIAN_KERNELS = ("atx", "atx_a", "axm_bf16", "atxm_bf16")
BF16_PLAIN_TOL = 5e-6


def check_gaussian(words, B, gen, label, against, tol,
                   names=GAUSSIAN_KERNELS, band=False) -> dict:
    """Each kernel of ``names`` on Gaussian inputs against ``against``:
    "float64" (the dense plain products in float64) or "plain" (the f32
    plain version); raises beyond ``tol`` of the largest entry.  With
    ``band`` the kernel runs on the whole matrix and the other side on its
    band (``band_words``).  Returns {name: relative error}."""
    from gvamp_tpu_torch.ops import matvec
    nw, m = words.shape
    dev = words.device
    W = torch.randn((m, B), generator=gen, device=dev)
    U = torch.randn((m, B), generator=gen, device=dev) * 0.1
    V = torch.randn((4, 4 * nw, B), generator=gen, device=dev)
    f64 = against == "float64"

    def cases(g):
        return {
            "atx": (lambda: matvec.atx(g, V[..., 0]),
                    lambda: matvec.atx_ref(g, V[..., 0],
                                           torch.float64 if f64 else
                                           torch.float32)),
            "atx_a": (lambda: (matvec.atx_a(g, V[..., 0]),),
                      lambda: (matvec.atx_ref(g, V[..., 0], torch.float64)[0]
                               if f64 else matvec.atx_a_ref(g, V[..., 0]),)),
            "axm_bf16": (lambda: (matvec.axm_bf16(g, W, U),),
                         lambda: (matvec.axm_ref(g, W, U, torch.float64)
                                  if f64 else matvec.axm_bf16_ref(g, W, U),)),
            "atxm_bf16": (lambda: matvec.atxm_bf16(g, V),
                          lambda: (matvec.atxm_ref(g, V, torch.float64)
                                   if f64 else matvec.atxm_bf16_ref(g, V)))}

    whole = cases(words)
    out = {}
    for name in names:
        got = whole[name][0]()
        if band:
            g, sl = band_words(words, name)
            got, want = tuple(x[sl] for x in got), cases(g)[name][1]()
        else:
            want = whole[name][1]()
        err = max(float((g.double() - w.double()).abs().max()
                        / w.double().abs().max()) for g, w in zip(got, want))
        del got, want
        log(f"  {label:>22s} B={B:<3d} {name:12s} Gaussian: max|kernel - "
            f"{against}| / max = {err:.3e} (limit {tol:g})"
            + " on its band" * band)
        if not err <= tol:
            raise AssertionError(f"{name} {label} B={B}: {err:.3e} from the "
                                 f"{against} version on Gaussian inputs")
        out[name] = err
    return out


def phase_kernels_small(gen, study_gen):
    log("== phase 3a: kernels vs plain versions, small shapes")
    for nw, m, B in SHAPES:
        words = random_words(gen, nw, m)
        label = f"Nw={nw} Mpad={m}"
        check_kernels(words, B, gen, label)
        check_gaussian(words, B, gen, label, "float64", kernel_check.TOL)
    for nw, m in [(nw, m) for nw, m, _ in SHAPES] + STUDY_SHAPES:
        check_study_sweep(random_words(gen, nw, m), f"Nw={nw} Mpad={m}")
    check_study_products(study_gen)
    check_study_codes()
    # a generator of their own, so that the draws of ``gen`` stay those the
    # engine phases' limits were set on
    edge_gen = torch.Generator(device="cuda")
    edge_gen.manual_seed(2)
    for nw, m, B in FRAGMENT_SHAPES:
        check_kernels(random_words(edge_gen, nw, m), B, edge_gen,
                      f"Nw={nw} Mpad={m}", names=FRAGMENT_KERNELS)
    for nw, m, B in GRAM_AAT_SHAPES:
        check_kernels(random_words(edge_gen, nw, m), B, edge_gen,
                      f"Nw={nw} Mpad={m}", names=GRAM_AAT_KERNELS)
    for nw, m, B in GRAM_PRIM_SHAPES:
        check_kernels(random_words(edge_gen, nw, m), B, edge_gen,
                      f"Nw={nw} Mpad={m}", names=GRAM_PRIM_KERNELS,
                      plain_reps=1)
    # the bf16-split products at the edges of their grids too: a last step
    # reaching past Mpad (8, 1,000), row groups past Nw (7, 300), 11 column
    # groups (B = 22)
    for nw, m, B in FRAGMENT_SHAPES:
        words = random_words(edge_gen, nw, m)
        check_kernels(words, B, edge_gen, f"Nw={nw} Mpad={m}",
                      names=BF16_KERNELS)
        check_gaussian(words, B, edge_gen, f"Nw={nw} Mpad={m}", "float64",
                       kernel_check.TOL, names=BF16_KERNELS)
    # the digit products at deflation's width (top_eigs' Gram passes at
    # B = deflate_k): 64 digit groups over gridDim.z
    for nw, m, B in DEFLATE_SHAPES:
        check_kernels(random_words(edge_gen, nw, m), B, edge_gen,
                      f"Nw={nw} Mpad={m}", names=DEFLATE_KERNELS,
                      plain_reps=1)


# small shapes of the study kernels beyond SHAPES: rows past a multiple of
# 256 and Mpad not a multiple of 512 (where the JAX grids drop them), and
# the narrowest matrices
STUDY_SHAPES = [(300, 1000), (300, 8), (7, 8), (1, 4096)]


def check_study_sweep(words, label) -> None:
    """The study row sums against their plain versions, bit for bit:
    ``stream`` (at tm = gcd(Mpad, 512)) and ``stream_sum`` at every
    threads x bytes-per-load configuration of bench_stream's sweep that
    the shape takes, v0_stream to v3_bitcast at the ladder's one."""
    import math
    from gvamp_tpu_torch.ops import study
    nw, m = words.shape
    tm = math.gcd(m, study.STREAM_TM)
    want_rows = study.stream_sum_ref(words)
    want_stream = study.stream_ref(words, tm)
    runs = 0
    for threads in study.THREADS:
        for nb in study.LOAD_BYTES:
            if m % (nb // 4):
                continue
            conf = f"{label} threads={threads} load={nb}B"
            compare("stream_sum", conf,
                    (study.stream_sum(words, threads, nb),), (want_rows,))
            runs += 1
            if tm % (nb // 4) == 0:
                compare("stream", f"{label} tm={tm} threads={threads} "
                        f"load={nb}B", (study.stream(words, tm, threads, nb),),
                        (want_stream,))
                runs += 1
    compare("v0_stream", label, (study.v0_stream(words),), (want_rows,))
    for name in ("v1_decode_a", "v2_decode_ab", "v3_bitcast"):
        compare(name, label, (getattr(study, name)(words),),
                (getattr(study, f"{name}_ref")(words),))
    torch.cuda.synchronize()
    log(f"  {label:>22s} study row sums equal: {runs} stream / stream_sum "
        f"configurations (tm={tm}), v0_stream to v3_bitcast")


def check_study_products(gen) -> None:
    """v5_dot1, v6_fused_ab, v7_i8decode (both keys, on the words' byte
    rows) and v8_atxm_vt against their plain versions, bit for bit, on
    random words of every small shape (Nw=300 and Mpad=1000 among them: a
    part tile of rows and of markers, and byte rows that take v7's 4-byte
    loads) at B = 1, 2 and 5 (D = 4, 8 and 20: the mma's 8 digit rows
    padded and split over the grid) and at the shape's own B of SHAPES (B
    = 70: 280 digit rows, 35 blocks on the grid's z axis; v6_fused_ab's
    wgmma groups: D = 4 and 8 in one of 8 rows, 20 in one of 32, 68 in
    one of 128, 280 in two of 256); v7 also against axm_i8a on the
    words."""
    from gvamp_tpu_torch.ops import matvec, study
    widths = {(nw, m): B for nw, m, B in SHAPES}
    runs = 0
    for nw, m in [(nw, m) for nw, m, _ in SHAPES] + STUDY_SHAPES:
        words = random_words(gen, nw, m)
        bytes8 = study.expand_words(words)
        for B in sorted({1, 2, 5, widths.get((nw, m), 1)}):
            W = torch.randn((m, B), generator=gen, device="cuda")
            U = torch.randn((m, B), generator=gen, device="cuda") * 3
            V = torch.randn((4, 4 * nw, B), generator=gen, device="cuda")
            label = f"Nw={nw} Mpad={m} B={B}"
            compare("v5_dot1", label, (study.v5_dot1(words, W),),
                    (study.v5_dot1_ref(words, W),))
            compare("v6_fused_ab", label, (study.v6_fused_ab(words, W, U),),
                    (study.v6_fused_ab_ref(words, W, U),))
            for name in ("v7_i8decode", "v7_i8decode_round2"):
                z = getattr(study, name)(bytes8, W)
                compare(name, label, (z,),
                        (getattr(study, f"{name}_ref")(bytes8, W),))
                compare(name, f"{label} against axm_i8a", (z,),
                        (matvec.axm_i8a(words, W),))
            compare("v8_atxm_vt", label, (study.v8_atxm_vt(words, V),),
                    (study.v8_atxm_vt_ref(words, V),))
            runs += 5
    torch.cuda.synchronize()
    log(f"  v5_dot1 / v6_fused_ab / v7_i8decode (both keys) / v8_atxm_vt "
        f"equal to their plain versions: {runs} checks at B = 1, 2, 5 and "
        f"each shape's B; v7 equal to axm_i8a")


# words of one code and what the row sums give per word: code 00 decodes
# to a = 2, b = 1 in every lane of every plane, 10 to a = 1, b = 1, 01
# (missing) to a = b = 0, 11 to a = 0, b = 1; so per word 4 a and 4 (a + b)
# in each byte lane
CODE_LANES = ((0x00000000, 8, 12), (0xAAAAAAAA, 4, 8), (0x55555555, 0, 0),
              (0xFFFFFFFF, 0, 4))


def check_study_codes() -> None:
    """The decoding row sums on words of one code against their exact sums
    (CODE_LANES): v1_decode_a M x lane(a) x 0x01010101 per row,
    v2_decode_ab M x lane(a + b) x 0x01010101, v3_bitcast M x lane(a) per
    byte row; wrapped to int32."""
    from gvamp_tpu_torch.ops import study
    nw, m = 300, 4096 + 512

    def wrapped(x):
        x %= 1 << 32
        return x - (1 << 32) * (x >= 1 << 31)

    for word, a_lane, ab_lane in CODE_LANES:
        words = torch.full((nw, m), wrapped(word), dtype=torch.int32,
                           device="cuda")
        for name, got, exact in (
                ("v1_decode_a", study.v1_decode_a(words),
                 m * a_lane * 0x01010101),
                ("v2_decode_ab", study.v2_decode_ab(words),
                 m * ab_lane * 0x01010101),
                ("v3_bitcast", study.v3_bitcast(words), m * a_lane)):
            if not bool((got == wrapped(exact)).all()):
                raise AssertionError(f"{name} on words 0x{word:08X}: "
                                     f"{got[0, :4].tolist()}, expected "
                                     f"{wrapped(exact)}")
    log(f"  v1_decode_a, v2_decode_ab, v3_bitcast on words of one code: "
        f"exact at Nw={nw} Mpad={m}")


# rounds of a row sum and the torch.sum that computes the same sums, timed
# in turns (phase 3s)
SUM_ROUNDS = 5


def phase_study_config_b(words, gen) -> dict:
    """The study row sums on the whole config-B matrix at their default
    launch configuration, bit for bit against their plain versions, with
    CUDA-event times of the kernel, the plain version and the PyTorch call
    that computes the same sums (torch.sum, in turns with the kernel over
    SUM_ROUNDS rounds, each side's median kept, and whether the kernel
    loses or wins by more than the rounds' spread; none for the decoding
    ones: no PyTorch call reads packed words), then v5_dot1, v7_i8decode
    (both keys) and v8_atxm_vt at B = 2 (no PyTorch call either).  Returns
    {name: (max_abs_err, ms, plain_ms, library_ms)}."""
    log("== phase 3s: study kernels vs plain versions, config-B words")
    from gvamp_tpu_torch.ops import study
    nw, m = words.shape
    tm = study.STREAM_TM

    def rows():
        return words.sum(1, dtype=torch.int32)

    cases = {
        "stream": (lambda: study.stream(words), lambda: study.stream_ref(words),
                   lambda: words.view(nw, m // tm, tm).sum(
                       1, dtype=torch.int32)),
        "stream_sum": (lambda: study.stream_sum(words),
                       lambda: study.stream_sum_ref(words), rows),
        "v0_stream": (lambda: study.v0_stream(words),
                      lambda: study.v0_stream_ref(words), rows),
        "v1_decode_a": (lambda: study.v1_decode_a(words),
                        lambda: study.v1_decode_a_ref(words), None),
        "v2_decode_ab": (lambda: study.v2_decode_ab(words),
                         lambda: study.v2_decode_ab_ref(words), None),
        "v3_bitcast": (lambda: study.v3_bitcast(words),
                       lambda: study.v3_bitcast_ref(words), None)}
    out = {}
    for name, (fn, ref, lib) in cases.items():
        err = compare(name, f"config B full {nw}x{m}", (fn(),), (ref(),))
        plain = cuda_ms(ref, 3)
        if lib:
            # kernel and torch.sum in turns, SUM_ROUNDS rounds; the medians
            k_ms, l_ms = zip(*[(cuda_ms(fn, 5), cuda_ms(lib, 5))
                               for _ in range(SUM_ROUNDS)])
            ms, lib_ms = float(np.median(k_ms)), float(np.median(l_ms))
            log(f"  {name} in turns with torch.sum: kernel "
                f"{' '.join(f'{t:.3f}' for t in k_ms)} ms, torch.sum "
                f"{' '.join(f'{t:.3f}' for t in l_ms)} ms: "
                + ("loses" if min(k_ms) > max(l_ms) else "wins"
                   if max(k_ms) < min(l_ms) else "within the spread"))
        else:
            ms, lib_ms = cuda_ms(fn, 5), None
        out[name] = (err, ms, plain, lib_ms)
        log(f"  config B full {nw}x{m} {name:12s} equal  max|err|={err:.3e}  "
            f"kernel {ms:8.3f} ms ({4 * nw * m / (ms * 1e6):7.1f} GB/s "
            f"packed)  plain {plain:8.3f} ms  torch.sum "
            + (f"{lib_ms:8.3f} ms" if lib else "none"))
    out.update(phase_study_products(
        words, gen, ("v5_dot1", "v7_i8decode", "v7_i8decode_round2",
                     "v8_atxm_vt"), "config B"))
    return out


def phase_study_products(words, gen, names, config) -> dict:
    """The staged study products ``names`` at B = 2 on the whole matrix,
    bit for bit against their plain versions and timed beside them (the
    plain version's one comparison call; no PyTorch call computes them).  Returns {name: (max_abs_err, ms,
    plain_ms, None)}."""
    nw, m = words.shape
    res = check_kernels(words, 2, gen, f"{config} full {nw}x{m}",
                        names=names, reps=5, plain_reps=0)
    torch.cuda.empty_cache()
    return {n: (*r, None) for n, r in res.items()}


# v6_fused_ab's widths on config Bm (phase 3s): B = 2, the ladder's; 16 and
# 64 (D = 64 and 256 digit rows), which its wgmma kernel covers in one read
# of the words where axm_i8s reads them once per 8 digit rows; and the
# rounds in which the two run in turns
FUSED_AB_WIDTHS = (2, 16, 64)
FUSED_AB_ROUNDS = 3


def phase_study_fused_ab(words, gen) -> tuple:
    """v6_fused_ab on the whole config-Bm matrix at FUSED_AB_WIDTHS: bit
    for bit against its plain version (on the whole matrix at B = 2, its
    one call timed; on the band of the last BAND_ROWS word rows at 16 and
    64) and against axm_i8s on the whole matrix (the same contract: one
    quantisation, one int32 sum, one fold), then timed in turns with
    axm_i8s over FUSED_AB_ROUNDS rounds (CUDA events; each side's median
    kept) beside the bound.  Returns B = 2's (max_abs_err, ms, plain_ms,
    None) for the kernels line."""
    from gvamp_tpu_torch.ops import matvec, study
    log("== phase 3s: v6_fused_ab vs its plain version and axm_i8s, "
        "config-Bm words")
    nw, m = words.shape
    label = f"config Bm full {nw}x{m}"
    out = None
    for B in FUSED_AB_WIDTHS:
        res = check_kernels(words, B, gen, label, names=("v6_fused_ab",),
                            reps=1, plain_reps=0,
                            band=B != 2)["v6_fused_ab"]
        W = torch.randn((m, B), generator=gen, device=words.device)
        U = torch.randn((m, B), generator=gen, device=words.device) * 3
        compare("v6_fused_ab", f"{label} B={B} against axm_i8s",
                (study.v6_fused_ab(words, W, U),),
                (matvec.axm_i8s(words, W, U),))
        reps = 5 if B <= 16 else 2
        v6_ms, i8s_ms = zip(*[
            (cuda_ms(lambda: study.v6_fused_ab(words, W, U), reps),
             cuda_ms(lambda: matvec.axm_i8s(words, W, U), reps))
            for _ in range(FUSED_AB_ROUNDS)])
        ms = float(np.median(v6_ms))
        b_ms, b_by = bound("v6_fused_ab", nw, m, B)
        log(f"  {label} B={B:<3d} v6_fused_ab in turns with axm_i8s: "
            f"kernel {' '.join(f'{t:.3f}' for t in v6_ms)} ms, axm_i8s "
            f"{' '.join(f'{t:.3f}' for t in i8s_ms)} ms; median {ms:.3f} "
            f"against {float(np.median(i8s_ms)):.3f}; bound {b_ms:.3f} ms by "
            f"{b_by} ({b_ms / ms:.1%} of it)")
        if B == 2:
            out = (res[0], ms, res[2], None)
    torch.cuda.empty_cache()
    return out


def phase_kernels_config_b(words, gen):
    """The kernels on a 2,048-marker slice (launch-bound) and on the whole
    config-B matrix at the main path's widths B = 1 and 2, where every row
    band spans many shared-memory tiles: the a-only kernels, atx, atx_a and
    the bf16-split products, the last three also on Gaussian inputs; then
    the a-only kernels at B = 22 (LOCO's forward width on complete
    genotypes, the words read 11 times).  Each plain version runs once on
    the whole matrix, at B = 1; the launches at B = 2 and 22 and the
    Gaussian inputs are held against it on their bands (``band_words``).
    The plain versions decode _REF_BLOCK markers at a time, so they run
    beside the 10.74 GB of words.  Returns {B: check_kernels result} of
    the whole matrix."""
    log("== phase 3b: kernels vs plain versions, config-B words")
    sl = words[:, :SLICE_M].contiguous()
    # the fused dual Grams refuse N=327,680 (Nw above GRAM_AAT_MAX_NW), and
    # fn_gram_aat takes the two-pass form there
    names = tuple(n for n in PRODUCT_KERNELS if not n.startswith("gram_aat"))
    for B in (1, 2):
        check_kernels(sl, B, gen, f"config B, {SLICE_M} markers", names=names)
    del sl
    nw, m = words.shape
    # complete genotypes: every marker has 16 * Nw non-missing calls
    a_only = ("axm_i8a", "atxm_i8a")
    bf16 = ("axm_bf16", "atxm_bf16")
    label = f"config B full {nw}x{m}"
    # each plain version once on the whole matrix at B = 1 (its one call
    # timed); the wider launches against it on their bands
    full = {1: check_kernels(words, 1, gen, label,
                             names=a_only + bf16 + ("atx", "atx_a"),
                             count=16 * nw, reps=3, plain_reps=0),
            2: check_kernels(words, 2, gen, label, names=a_only + bf16,
                             reps=3, band=True)}
    check_gaussian(words, 1, gen, label, "plain", BF16_PLAIN_TOL,
                   names=bf16 + ("atx", "atx_a"), band=True)
    check_gaussian(words, 2, gen, label, "plain", BF16_PLAIN_TOL,
                   names=bf16, band=True)
    full[1][COUNT_KERNEL] = check_counts(words, label)
    # a generator of its own, so that the draws of ``gen`` stay those the
    # engine phases' limits were set on
    wide_gen = torch.Generator(device="cuda")
    wide_gen.manual_seed(3)
    full[BM_CHROMS] = check_kernels(words, BM_CHROMS, wide_gen, label,
                                    names=a_only, reps=3, band=True)
    torch.cuda.empty_cache()
    return full


def check_counts(words, label):
    """The count kernel (``matvec.marker_counts``) on the whole matrix
    against its plain version (``marker_counts_ref``, the same integer
    counts decoded in blocks of markers), equal exactly, over a random NA
    support with 3% of the slots out; returns (max_abs_err, CUDA-event ms
    of the wrapper, ms of the plain version) for the kernels line.  A
    generator of its own, so that the draws of the phases' ``gen`` stay
    those their limits were set on."""
    from gvamp_tpu_torch.ops import matvec
    nw, m = words.shape
    na_gen = torch.Generator(device="cuda")
    na_gen.manual_seed(4)
    na = (torch.rand((4, 4 * nw), generator=na_gen, device="cuda")
          < 0.97).to(torch.float32)
    plain, want = timed_once(lambda: matvec.marker_counts_ref(words, na))
    got = matvec.marker_counts(words, na)
    err = compare(COUNT_KERNEL, label, (got,), (want,))
    ms = cuda_ms(lambda: matvec.marker_counts(words, na), 5)
    log(f"  {label} {COUNT_KERNEL}: S_a, S_b, S_aa equal to the plain "
        f"version's; {ms:.3f} ms, plain {plain:.1f} ms")
    return err, ms, plain


def phase_kernels_config_bm(words, gen):
    """The general kernels, axm_i8s and the bf16-split products on the
    whole config-Bm matrix at B = 1 and 2 (the linear path's widths) and
    axm_i8 and axm_i8s at B = 22 (LOCO's forward product over 22
    chromosomes, the widest call of the path; 11 digit groups): each plain
    version once on the whole matrix at B = 1, the wider launches on their
    bands.  Returns {B: check_kernels result}."""
    log("== phase 3c: general kernels vs plain versions, config-Bm words")
    nw, m = words.shape
    general = ("axm_i8", "atxm_i8", "axm_i8s", "axm_bf16", "atxm_bf16")
    label = f"config Bm full {nw}x{m}"
    full = {1: check_kernels(words, 1, gen, label, names=general, reps=3,
                             plain_reps=0),
            2: check_kernels(words, 2, gen, label, names=general, reps=3,
                             band=True)}
    full[BM_CHROMS] = check_kernels(words, BM_CHROMS, gen, label,
                                    names=("axm_i8", "axm_i8s"), reps=3,
                                    band=True)
    check_counts(words, label)
    torch.cuda.empty_cache()
    return full


def make_problem(words, label, complete, n=CFG_B_N, m=CFG_B_M, mesh=None):
    """Load and phenotype simulation (bench.py:89-111's recipe: two-group
    prior, 1,000 causal markers, h2 = 0.5) on ``words`` (split over
    ``mesh`` where given); returns (geno, beta, vars_t, probs_t)."""
    from gvamp_tpu_torch import sim
    from gvamp_tpu_torch.data import GenoBed
    t0 = time.perf_counter()
    geno = GenoBed.from_device_words(words, np.zeros(n), N=n, M=m,
                                     standardize_phen=False, mesh=mesh)
    torch.cuda.synchronize()
    t_stats = time.perf_counter() - t0
    t0 = time.perf_counter()
    if geno.geno_complete != complete:
        raise AssertionError(f"{label}: geno_complete is "
                             f"{geno.geno_complete}, expected {complete}")
    t_complete = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    vars_t, probs_t = sim.two_group_prior(m, 1000, 0.5)
    beta = sim.simulate_mixture(rng, m, vars_t, probs_t)
    t0 = time.perf_counter()
    geno.set_phen(sim.simulate_linear_phenotype(geno, beta, 2.0, rng))
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    log(f"  set-up: statistics {t_stats:.2f} s, completeness {t_complete:.3f} s, "
        f"phenotype simulation + statistics {t_sim:.2f} s")
    return geno, beta, vars_t, probs_t


def run_linear(words, label, complete, corr_min, r2_range, callbacks=None):
    """Load, phenotype simulation and CFG_B_ITERS iterations of linear.infer
    at config-B settings on ``words``; returns (geno, state, problem) with
    problem = (beta, vars_t, probs_t, x_hat, history).  The caller resets
    and reads the launch counters around it."""
    geno, beta, vars_t, probs_t = make_problem(words, label, complete)
    x_hat, state, hist = run_infer(geno, beta, vars_t, probs_t, label,
                                   corr_min, r2_range, callbacks=callbacks)
    return geno, state, (beta, vars_t, probs_t, x_hat, hist)


def run_infer(geno, beta, vars_t, probs_t, label, corr_min, r2_range,
              use_xxt=False, callbacks=None):
    """CFG_B_ITERS iterations of linear.infer at bench.py's settings
    (VampConfig(rho=0.15, gam1_init=1e-8, gamw_init=2.0), dual with
    ``use_xxt``); prints the trajectory and checks it: finite, R2_train_1
    rising from iteration 2 into ``r2_range``, corr(x_hat, beta) >=
    ``corr_min``.  Returns (x_hat, state, history)."""
    from gvamp_tpu_torch import linear
    cfg = linear.VampConfig(max_iter=CFG_B_ITERS, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0, use_xxt=use_xxt)
    t0 = time.perf_counter()
    x_hat, state, hist = clocked(linear.infer, geno, cfg, probs_t, vars_t,
                                 callbacks=callbacks)
    t_infer = time.perf_counter() - t0
    what = ("people statistics, dual SLQ basis, A^T y, A u" if use_xxt
            else "SLQ basis, A^T y, A u")
    log(f"  infer {t_infer:.2f} s; iteration 1's host_ms holds the set-up "
        f"({what})")
    log("  it      gam1        gam2        gamw     alpha1    alpha2   "
        "R2_train_1  cg   host_ms  syncs")
    for h in hist:
        log(f"  {h['it']:2d} {float(h['gam1']):11.5g} {float(h['gam2']):11.5g} "
            f"{float(h['gamw']):11.5g} {float(h['alpha1']):9.4g} "
            f"{float(h['alpha2']):9.4g} {float(h['R2_train_1']):10.5f} "
            f"{h['cg_iters']:4d} {h['host_ms']:9.2f} {h['host_syncs']:5d}")
    steady = [h["host_ms"] for h in hist[2:]]
    log(f"  steady-state (it 3-{len(hist)}) median {np.median(steady):.2f} ms/it;"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    corr = float(np.corrcoef(x_hat, beta)[0, 1])
    r2 = [float(h["R2_train_1"]) for h in hist]
    log(f"  corr(x_hat, beta) = {corr:.5f}; R2_train_1 {r2[1]:.4f} -> {r2[-1]:.4f}")
    keys = ("gam1", "gam2", "gamw", "alpha1", "alpha2", "R2_train_1")
    if not (np.isfinite(x_hat).all() and all(
            np.isfinite(float(h[k])) for h in hist for k in keys)):
        raise AssertionError(f"{label}: non-finite values on the main path")
    if len(hist) != CFG_B_ITERS:
        raise AssertionError(f"{len(hist)} iterations, expected {CFG_B_ITERS}")
    rising = all(b > a for a, b in zip(r2[1:], r2[2:]))
    if not (rising and r2_range[0] < r2[-1] < r2_range[1]):
        raise AssertionError(f"{label}: R2_train_1 {r2} does not rise into "
                             f"{r2_range}")
    if corr < corr_min:
        raise AssertionError(f"{label}: corr(x_hat, beta) {corr:.4f} < "
                             f"{corr_min}")
    return x_hat, state, hist


def check_launches(label, launches, used, unused=()):
    log(f"  launches on the {label} path: {launches}")
    if min(launches[n] for n in used) <= 0:
        raise AssertionError(f"{label}: a kernel of {used} never launched: "
                             f"{launches}")
    if any(launches[n] for n in unused):
        raise AssertionError(f"{label}: a kernel of {unused} launched: "
                             f"{launches}")
    if not set(used) & set(TOOL_KERNELS):
        check_no_tool_launches(label, launches)


def check_no_tool_launches(label, launches):
    """An engine path launches none of the kernels that only the tools
    run (TOOL_KERNELS: the bf16-split products, axm_i8s, atx_a and the
    study kernels)."""
    if any(launches[n] for n in TOOL_KERNELS):
        raise AssertionError(f"{label}: a tool-only kernel of "
                             f"{TOOL_KERNELS} launched: {launches}")


def phase_main_path(words):
    """Returns (launches, geno, problem) of the two-pass run at config B."""
    log("== phase 4: linear VAMP main path at config B")
    from gvamp_tpu_torch.ops import matvec
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    geno, _, problem = run_linear(words, "config B", True, CORR_MIN,
                                  R2_RANGE)
    launches = dict(matvec.LAUNCHES)
    check_launches("config B", launches,
                   ("axm_i8a", "atxm_i8a", "atx", COUNT_KERNEL),
                   ("axm_i8", "atxm_i8", "gram_i8a", "gram_i8"))
    return launches, geno, problem


# the fused primal Gram against the two-pass form over 10 iterations (the
# same problem, probe and warm starts): z is quantised per 16-row band in
# one and per column in the other, both ~127^-4 fine; the tolerances of
# phase 4x (tests/test_xxt.py:95-99)
FUSED_XTOL, FUSED_RTOL = 5e-5, 2e-4


def compare_runs(label, run, ref, keys):
    """x_hat within FUSED_XTOL of max|x_hat| and the last iteration's
    ``keys`` within FUSED_RTOL between two runs (x_hat, history)."""
    (x_f, h_f), (x_t, h_t) = run, ref
    if len(h_f) != len(h_t):
        raise AssertionError(f"{label}: {len(h_f)} against {len(h_t)} "
                             f"iterations")
    dx = float(np.abs(x_f - x_t).max() / np.abs(x_t).max())
    log(f"  {label}: max|dx| / max|x| = {dx:.3e} (limit {FUSED_XTOL:g})")
    if not dx < FUSED_XTOL:
        raise AssertionError(f"{label}: x_hat differs")
    for k in keys:
        a, b = float(h_f[-1][k]), float(h_t[-1][k])
        log(f"  {k}: {a:.7g} against {b:.7g} rel {abs(a - b) / abs(b):.3e} "
            f"(limit {FUSED_RTOL:g})")
        if not abs(a - b) <= FUSED_RTOL * abs(b):
            raise AssertionError(f"{label}: {k} differs")


@contextlib.contextmanager
def fused_env(on=True):
    """GVAMP_FUSED_GRAM=1 (when ``on``) for the duration of a ``with``
    block; a failure inside still raises."""
    if on:
        os.environ["GVAMP_FUSED_GRAM"] = "1"
    try:
        yield
    finally:
        os.environ.pop("GVAMP_FUSED_GRAM", None)


def phase_fused_linear(label, geno, problem, complete):
    """The linear path of phase 4 / 4m again with GVAMP_FUSED_GRAM=1: every
    CG product through the fused primal Gram (gram_i8a, or gram_i8 with
    missing calls) and the explicit noise pass, against the two-pass run.
    Returns the launch counts."""
    log(f"== phase 4f: linear VAMP at {label} through the fused primal Gram")
    from gvamp_tpu_torch.ops import matvec
    beta, vars_t, probs_t, x_two, h_two = problem
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    with fused_env():
        if geno.fn_gram() is None:
            raise AssertionError(f"{label}: fn_gram refused the words")
        x_hat, _, hist = run_infer(geno, beta, vars_t, probs_t,
                                   f"{label} fused", CORR_MIN, R2_RANGE)
    launches = dict(matvec.LAUNCHES)
    a_only = ("axm_i8a", "atxm_i8a", "gram_i8a")
    general = ("axm_i8", "atxm_i8", "gram_i8")
    check_launches(f"{label} fused", launches,
                   a_only if complete else general,
                   general if complete else a_only)
    compare_runs(f"{label} fused against two-pass", (x_hat, hist),
                 (x_two, h_two), ("gam1", "gam2", "gamw", "alpha2"))
    for name, h in (("two-pass", h_two), ("fused", hist)):
        log(f"  {label} {name}: steady-state median "
            f"{np.median([x['host_ms'] for x in h[2:]]):.2f} ms/it, CG "
            f"{[x['cg_iters'] for x in h]}")
    return launches


# corr(x_hat, beta) after the probit runs at config B (binary phenotype,
# probit_var = 1 - h2 = 0.5): set from the first H100 run (0.99173 both
# two-pass and fused, PERF.md) with CORR_MIN's room for f32 rounding and a
# different card; the linear engine reads 0.9958 there with the
# continuous phenotype
PROBIT_CORR_MIN = 0.985


def run_probit(geno, beta, vars_t, probs_t, label, cfg):
    """probit.infer on ``geno`` (whose phenotype is binary); prints the
    trajectory and checks it is finite.  Returns (x_hat, history)."""
    from gvamp_tpu_torch import probit
    t0 = time.perf_counter()
    x_hat, _, hist = clocked(probit.infer, geno, cfg, probs_t, vars_t,
                             verbose=False)
    t_all = time.perf_counter() - t0
    log(f"  {label}: infer {t_all:.2f} s; iteration 1's host_ms holds the "
        f"set-up (SLQ basis, A^T y, A u)")
    log("  it      gam1        tau1        tau2     alpha2     beta1   "
        "cg   host_ms  syncs")
    for h in hist:
        log(f"  {h['it']:2d} {float(h['gam1']):11.5g} {float(h['tau1']):11.5g} "
            f"{float(h['tau2']):11.5g} {float(h['alpha2']):9.4g} "
            f"{float(h['beta1']):9.4g} {h['cg_iters']:4d} "
            f"{h['host_ms']:9.2f} {h['host_syncs']:5d}")
    corr = float(np.corrcoef(x_hat, beta)[0, 1])
    log(f"  steady-state median "
        f"{np.median([h['host_ms'] for h in hist[2:]]):.2f} ms/it; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"corr(x_hat, beta) = {corr:.5f} (floor {PROBIT_CORR_MIN})")
    keys = ("gam1", "gam2", "tau1", "tau2", "alpha2")
    if not (np.isfinite(x_hat).all() and all(
            np.isfinite(float(h[k])) for h in hist for k in keys)):
        raise AssertionError(f"{label}: non-finite values")
    if len(hist) < 5:
        raise AssertionError(f"{label}: stopped after {len(hist)} "
                             f"iterations")
    if corr < PROBIT_CORR_MIN:
        raise AssertionError(f"{label}: corr(x_hat, beta) {corr:.4f} < "
                             f"{PROBIT_CORR_MIN}")
    return x_hat, hist


def phase_probit_b(geno, problem):
    """Probit at config B: a binary phenotype from
    simulate_probit_phenotype (probit_var = 1 - h2 = 0.5) on the config-B
    container, 10 iterations two-pass (z2 tracked through the CG), then 10
    through the fused primal Gram (z2 from one forward pass).  Returns the
    launch counts of (two-pass, fused)."""
    log("== phase 4p: probit VAMP at config B, two-pass and fused")
    from gvamp_tpu_torch import probit, sim
    from gvamp_tpu_torch.ops import matvec
    beta, vars_t, probs_t = problem[:3]
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    y = sim.simulate_probit_phenotype(geno, beta, 0.5, rng)
    geno.set_phen(y)
    torch.cuda.synchronize()
    log(f"  binary phenotype: {y.mean():.4f} cases; simulation + "
        f"statistics {time.perf_counter() - t0:.2f} s")
    cfg = probit.ProbitConfig(max_iter=CFG_B_ITERS, probit_var=0.5)
    runs, counts = {}, {}
    for name in ("two-pass", "fused"):
        torch.cuda.reset_peak_memory_stats()
        matvec.reset_launches()
        with fused_env(name == "fused"):
            runs[name] = run_probit(geno, beta, vars_t, probs_t,
                                    f"config B probit {name}", cfg)
        counts[name] = dict(matvec.LAUNCHES)
    check_launches("config B probit two-pass", counts["two-pass"],
                   ("axm_i8a", "atxm_i8a"), ("gram_i8a", "gram_i8",
                                             "axm_i8", "atxm_i8"))
    check_launches("config B probit fused", counts["fused"],
                   ("gram_i8a", "axm_i8a", "atxm_i8a"),
                   ("gram_i8", "axm_i8", "atxm_i8"))
    compare_runs("config B probit fused against two-pass", runs["fused"],
                 runs["two-pass"], ("gam1", "gam2", "tau1", "tau2",
                                    "alpha2"))
    return counts["two-pass"], counts["fused"]


# Huber at config B and Bm (phase 4h): tools/bench_huber.py's phenotype
# (bench.py's prior, y = A (sqrt(N) beta) + 0.5 t(3)), RobustConfig(rho =
# 0.15, stab_gamma = 1.0) with SLQ, then with deflate_k = HUBER_DEFLATE_K
# (bench_huber's slq+d128).  HUBER_CORR_MIN, on corr(x_hat, beta) after
# the last iteration: the first H100 run read 0.8739 (SLQ) and 0.8745
# (deflated) at config B after 10 and 0.9249 at config Bm after 5 (the
# trajectory peaks at 0.994 at iteration 2, then falls as tau1 climbs);
# room for f32 rounding and another card, well above JAX's own test_robust
# floor (0.6 at N=1,500 x M=300)
HUBER_CORR_MIN = 0.85
HUBER_DEFLATE_K = 128
HUBER_BM_ITERS = 5
HUBER_KEYS = ("gam1", "gam2", "tau1", "tau2", "alpha2", "deltaH")


def huber_phenotype(geno, beta, rng):
    """y = A (sqrt(N) beta) + 0.5 t(3) on ``geno``'s device
    (tools/bench_huber.py's recipe)."""
    x = geno.pad_m(beta * np.sqrt(geno.N))
    g = geno.deplanarize(geno.ax(x))[: geno.N]
    return g + rng.standard_t(3.0, geno.N) * 0.5


def run_huber(geno, beta, vars_t, probs_t, label, cfg):
    """robust.infer on ``geno``; prints each iteration's host ms, CG count,
    host syncs, deltaH, tau1 / tau2 and corr(x_hat, beta), the set-up
    seconds and the peak memory, and checks that every value is finite and
    the last corr reaches HUBER_CORR_MIN.  Returns (x_hat, history)."""
    from gvamp_tpu_torch import robust
    corrs = []

    def corr_cb(it, state, m, g):
        x = state.x1[: g.M].cpu().numpy()
        corrs.append(float(np.corrcoef(x, beta)[0, 1]) if x.std() > 0
                     else 0.0)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x_hat, _, hist = clocked(robust.infer, geno, cfg, probs_t, vars_t,
                             verbose=False, callbacks=[corr_cb])
    t_all = time.perf_counter() - t0
    t_iters = sum(h["host_ms"] for h in hist[1:]) / 1e3
    what = "deflation basis, " if cfg.deflate_k else ""
    log(f"  {label}: infer {t_all:.2f} s, iteration 1's host_ms holds the "
        f"set-up ({what}SLQ basis, probe); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("  it    host_ms   cg  syncs    deltaH        tau1        tau2"
        "        gam1    alpha2    corr")
    for h, c in zip(hist, corrs):
        log(f"  {h['it']:2d} {h['host_ms']:10.2f} {h['cg_iters']:4d} "
            f"{h['host_syncs']:6d} {float(h['deltaH']):9.3g} "
            f"{float(h['tau1']):11.5g} {float(h['tau2']):11.5g} "
            f"{float(h['gam1']):11.5g} {float(h['alpha2']):9.4g} "
            f"{c:7.4f}")
    log(f"  {label}: iterations 2-{len(hist)} in {t_iters:.2f} s, median "
        f"{np.median([h['host_ms'] for h in hist[1:]]):.2f} ms/it, CG "
        f"{sum(h['cg_iters'] for h in hist)} in all")
    if not (np.isfinite(x_hat).all() and all(
            np.isfinite(float(h[k])) for h in hist for k in HUBER_KEYS)):
        raise AssertionError(f"{label}: non-finite values")
    if len(hist) != cfg.max_iter:
        raise AssertionError(f"{label}: {len(hist)} iterations, expected "
                             f"{cfg.max_iter}")
    if not corrs[-1] >= HUBER_CORR_MIN:
        raise AssertionError(f"{label}: corr(x_hat, beta) {corrs[-1]:.4f} < "
                             f"{HUBER_CORR_MIN}")
    return x_hat, hist


def phase_huber(geno, problem, label, complete, n_it, deflate_ks):
    """The Huber engine on ``geno`` (phase 4h): a heavy-tailed phenotype,
    n_it iterations for each deflate_k of ``deflate_ks``, each with the
    launch counters proving that its CG ran the a-only digit products
    (complete) or the general ones and no other product kernel; a deflated
    run first times top_eigs alone.  Returns {deflate_k: launch counts}."""
    log(f"== phase 4h: Huber VAMP at {label}, deflate_k {deflate_ks}")
    from gvamp_tpu_torch import linear, robust
    from gvamp_tpu_torch.ops import matvec
    beta, vars_t, probs_t = problem[:3]
    t0 = time.perf_counter()
    geno.set_phen(huber_phenotype(geno, beta, np.random.default_rng(3)))
    torch.cuda.synchronize()
    log(f"  heavy-tailed phenotype: simulation + statistics "
        f"{time.perf_counter() - t0:.2f} s")
    used = ("axm_i8a", "atxm_i8a") if complete else ("axm_i8", "atxm_i8")
    unused = tuple(n for n in PRODUCT_KERNELS if n not in used)
    counts = {}
    for k in deflate_ks:
        cfg = robust.RobustConfig(max_iter=n_it, rho=0.15, stab_gamma=1.0,
                                  stop_criteria_thr=0.0, deflate_k=k)
        name = f"{label} Huber" + (f" deflate_k={k}" if k else "")
        if k:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            V, lam = linear.make_deflation(geno, cfg)
            torch.cuda.synchronize()
            log(f"  top_eigs k={k} ({cfg.deflate_iters + 1} Gram passes at "
                f"B={k}): {time.perf_counter() - t0:.2f} s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"lam[0] {float(lam[0]):.6g}, lam[{k - 1}] "
                f"{float(lam[-1]):.6g}")
            del V, lam
        matvec.reset_launches()
        run_huber(geno, beta, vars_t, probs_t, name, cfg)
        counts[k] = dict(matvec.LAUNCHES)
        check_launches(name, counts[k], used, unused)
    return counts


def pvals_in_range(p) -> bool:
    """Finite p in [0, 1].  The float64 t-test, like the reference's,
    underflows to exactly 0 below ~1e-308 (t above ~40 at N=327,680)."""
    return bool(np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all())


def check_pvals(label, p, beta):
    """Finite p in [0, 1]; causal markers far below the null ones; the
    null markers' share below 0.05 near 0.05.  Returns the statistics."""
    if not pvals_in_range(p):
        raise AssertionError(f"{label}: p-values outside [0, 1]")
    causal = beta != 0
    med_causal = float(np.median(p[causal]))
    med_null = float(np.median(p[~causal]))
    share = float((p[~causal] < 0.05).mean())
    log(f"  {label}: median p causal {med_causal:.3e} (limit "
        f"{CAUSAL_MEDIAN_P_MAX:g}), null {med_null:.4f}; null share "
        f"p < 0.05 = {share:.5f} (limits {NULL_SHARE_RANGE}); "
        f"min p {float(p.min()):.3e}, {int((p == 0).sum())} underflowed to 0")
    if not med_causal < CAUSAL_MEDIAN_P_MAX:
        raise AssertionError(f"{label}: causal markers not below the nulls")
    if not NULL_SHARE_RANGE[0] < share < NULL_SHARE_RANGE[1]:
        raise AssertionError(f"{label}: null share {share} not near 0.05")
    return med_causal, share


def phase_config_bm(words):
    """The missing-genotype path at config Bm, with its LOO and LOCO
    p-values over 22 chromosomes; returns (launch counts, geno, problem,
    {ests: the last MODES_SERIES iterations' estimates, p_loo, p_loco, z1:
    the last A x1 in the sample order}) for phase 4v."""
    log("== phase 4m: linear VAMP and p-values at config Bm (missing calls)")
    from gvamp_tpu_torch.io import plink
    from gvamp_tpu_torch.ops import matvec, pvals
    nw, m = words.shape
    ones = torch.ones((4, 4 * nw), device=words.device)
    nonmiss = float(matvec.atx(words, ones)[1].sum())
    log(f"  missing calls: {1 - nonmiss / (CFG_B_N * m):.5%} "
        f"of {CFG_B_N} x {m}")
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    # the last MODES_SERIES iterations' estimates, the series of phase 4v
    ests = {}

    def keep(it, state, metrics, g):
        if it > CFG_B_ITERS - MODES_SERIES:
            ests[it] = state.x1[: g.M].cpu().numpy() / np.sqrt(g.N)

    geno, state, problem = run_linear(words, "config Bm", False, CORR_MIN,
                                      R2_RANGE, callbacks=[keep])
    beta = problem[0]
    chroms = 1 + np.arange(CFG_B_M) * BM_CHROMS // CFG_B_M
    with tempfile.TemporaryDirectory() as tmp:
        geno.bim_path = os.path.join(tmp, "bm.bim")
        plink.write_bim(geno.bim_path, chroms)
        t0 = time.perf_counter()
        p_loo = pvals.loo_pvals(geno, state.z1, state.x1)
        t_loo = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_loco = pvals.loco_pvals(geno, state.z1, state.x1,
                                  geno.chromosomes())
        t_loco = time.perf_counter() - t0
    launches = dict(matvec.LAUNCHES)
    log(f"  LOO p-values {t_loo:.2f} s, LOCO p-values ({BM_CHROMS} "
        f"chromosomes) {t_loco:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_pvals("LOO", p_loo, beta)
    check_pvals("LOCO", p_loco, beta)
    check_launches("config Bm", launches, ("axm_i8", "atxm_i8", "atx"),
                   ("axm_i8a", "atxm_i8a", "gram_i8a", "gram_i8"))
    return launches, geno, problem, dict(
        ests=ests, p_loo=p_loo, p_loco=p_loco,
        z1=geno.deplanarize(state.z1)[:geno.N])


# the fused primal Gram against its two-pass composition on the whole
# config-B / Bm matrix: z is quantised per 16-row band in one and per column
# in the other, both ~127^-4 fine, and the f32 sums run in other orders; a
# sanity bound on max|fused - two-pass| / max|two-pass|, as for the dual
B_TWO_PASS_TOL = 1e-4


def phase_kernels_gram(words, gen, complete):
    """The fused primal Gram on the whole matrix at B = 1 and 2: gram_i8a on
    config B, gram_i8 on config Bm, each bit-equal to its plain version (on
    the whole matrix at B = 1, on BAND_COLS markers at B = 2) and timed through its wrapper and as its bare launch (the operands made
    once by matvec.gram_launch; the first launch's result equal to the
    wrapper's bit for bit) beside its two-pass composition at the same B,
    with packed GB/s and the bound.  Returns {name: check_kernels numbers
    at B = 1, "name two-pass B=b": ms, "name bare B=b": ms}."""
    log(f"== phase 3e: fused primal Gram vs plain version, config "
        f"B{'' if complete else 'm'} words")
    from gvamp_tpu_torch.ops import matvec
    nw, m = words.shape
    name = "gram_i8a" if complete else "gram_i8"
    label = f"config B{'' if complete else 'm'} full {nw}x{m}"
    out = {}
    for B in (1, 2):
        # the plain version once on the whole matrix at B = 1; each output
        # entry reads every word, so B = 2 is held against it on the last
        # BAND_COLS markers, every band of word rows kept
        if B == 1:
            out.update(check_kernels(words, B, gen, label, names=(name,),
                                     reps=3, plain_reps=0))
        else:
            check_kernels(words[:, -BAND_COLS:].contiguous(), B, gen,
                          f"config B{'' if complete else 'm'} "
                          f"{nw}x{BAND_COLS}", names=(name,), reps=3,
                          plain_reps=0)
        W = torch.randn((m, B), generator=gen, device="cuda")
        U = torch.randn((m, B), generator=gen, device="cuda") * 3
        na = (torch.rand((4, 4 * nw), generator=gen, device="cuda")
              > 0.02).float()
        cu = torch.randn((B,), generator=gen, device="cuda")
        if complete:
            def fn():
                return matvec.gram_i8a(words, W, na, cu)
        else:
            def fn():
                return matvec.gram_i8(words, W, U, na)

        def comp():
            return (bench_gram.comp_a(words, W, na, cu) if complete
                    else bench_gram.comp_m(words, W, U, na))

        got, want = fn(), comp()
        diff = max(float((g - w).abs().max() / w.abs().max())
                   for g, w in zip(got, want))
        kern, args, finish = matvec.gram_launch(name, words, W, na,
                                                cu if complete else U)

        def bare():
            matvec._launch(name, kern, words.device, *args)

        bare()
        if not all(torch.equal(g, w) for g, w in zip(finish(), got)):
            raise AssertionError(f"{name}: the bare launch differs from the "
                                 f"wrapper")
        del got, want
        t_two = cuda_ms(comp, 3)
        t_fused = cuda_ms(fn, 3)
        t_bare = cuda_ms(bare, 3)
        b_ms, b_by = bound(name, nw, m, B)
        log(f"  {label:>22s} B={B:<3d} {name} {t_fused:8.3f} ms "
            f"({4 * nw * m / (t_fused * 1e6):7.1f} GB/s packed, bound "
            f"{b_ms:.3f} ms by {b_by}; bare launch {t_bare:8.3f} ms) against "
            f"two-pass {t_two:8.3f} ms ({t_two / t_fused:.2f}x); "
            f"max|fused - two-pass| / max = {diff:.2e} (limit "
            f"{B_TWO_PASS_TOL:g})")
        if not diff < B_TWO_PASS_TOL:
            raise AssertionError(f"{name}: fused and two-pass differ")
        out[f"{name} two-pass B={B}"] = t_two
        out[f"{name} bare B={B}"] = t_bare
    torch.cuda.empty_cache()
    return out


# the fused dual Gram against its two-pass composition at config X: W is
# quantised per 64-marker stripe in one and per column in the other, both
# ~127^-4 fine, and the f32 sums run in other orders; a sanity bound on
# max|fused - two-pass| / max|two-pass|, not a bit-equality check
X_TWO_PASS_TOL = 1e-4
# ax on the people statistics' real inputs (w = msig, u = mave msig) against
# its plain version: f32 sums of the same products in other orders, within
# a few ulps of the largest sum of |terms| (tests/test_torch_matvec.py)
AX_REAL_TOL = 1e-6


# the marker band of phase 3d's launches at B = 2 and 5: an eighth of
# config X's markers, every word row
X_BAND_COLS = 65_536


def phase_kernels_config_x(words, words_m, gen):
    """The fused dual Grams on the whole config-X matrix (gram_aat_i8a,
    complete) and config-Xm matrix (gram_aat_i8, 1.56% missing) at B = 1, 2
    and 5, each beside its two-pass composition at the same B (the plain
    version on the whole matrix at B = 1, on X_BAND_COLS markers at B = 2
    and 5); ax on config X with dyadic inputs (bit for bit) and with the
    statistics' real inputs (AX_REAL_TOL).  Returns {name: check_kernels
    numbers at B = 1}."""
    log("== phase 3d: dual kernels vs plain versions, config-X words")
    from gvamp_tpu_torch.ops import matvec
    nw, m = words.shape
    out = {}
    for w, name, complete in ((words, "gram_aat_i8a", True),
                              (words_m, "gram_aat_i8", False)):
        label = f"config X{'' if complete else 'm'} full {nw}x{m}"
        for B in (1, 2, 5):
            # the plain version once on the whole matrix at B = 1; each
            # output slot reads every marker, so the wider launches are
            # held against it on a band of X_BAND_COLS markers, all the
            # word rows (the stripe cache's dimension) kept
            if B == 1:
                out.update(check_kernels(w, B, gen, label, names=(name,),
                                         reps=5, plain_reps=0))
            else:
                check_kernels(w[:, :X_BAND_COLS].contiguous(), B, gen,
                              f"config X{'' if complete else 'm'} "
                              f"{nw}x{X_BAND_COLS}", names=(name,), reps=5,
                              plain_reps=0)
            V = torch.randn((4, 4 * nw, B), generator=gen, device="cuda")
            mave = torch.rand((m,), generator=gen, device="cuda") * 2
            msig2 = torch.rand((m,), generator=gen, device="cuda") * 1.5 + 0.5
            fused = getattr(matvec, name)

            def fn():
                return fused(w, V, mave, msig2)

            def comp():
                return (bench_gram.comp_aat_a if complete
                        else bench_gram.comp_aat)(w, V, mave, msig2)

            zf, zt = fn(), comp()
            diff = float((zf - zt).abs().max() / zt.abs().max())
            t_two = cuda_ms(comp)
            t_fused = cuda_ms(fn)
            log(f"  {label:>22s} B={B:<3d} {name} {t_fused:8.3f} ms against "
                f"two-pass {t_two:8.3f} ms ({t_two / t_fused:.2f}x); "
                f"max|fused - two-pass| / max = {diff:.2e} (limit "
                f"{X_TWO_PASS_TOL:g})")
            if not diff < X_TWO_PASS_TOL:
                raise AssertionError(f"{name}: fused and two-pass differ")
            out[f"{name} two-pass B={B}"] = t_two
    out.update(check_kernels(words, 1, gen, f"config X full {nw}x{m}",
                             names=("ax",), reps=5, plain_reps=0))
    check_ax_real(words, gen)
    torch.cuda.empty_cache()
    return out


def check_ax_real(words, gen) -> None:
    """ax on the people statistics' real inputs (w = msig, u = mave msig)
    against its plain version, within AX_REAL_TOL of the largest sum of
    |terms|."""
    from gvamp_tpu_torch.ops import matvec
    m = words.shape[1]
    msig = torch.rand((m,), generator=gen, device="cuda") * 1.5 + 0.5
    mave = torch.rand((m,), generator=gen, device="cuda") * 2
    got = matvec.ax(words, msig, mave * msig)
    want = matvec.ax_ref(words, msig, mave * msig)
    terms = matvec.ax_ref(words, msig, -mave * msig, torch.float64)
    err = float((got - want).abs().max() / terms.abs().max())
    log(f"  ax on statistics-like inputs: max|kernel - plain| / max sum "
        f"|terms| = {err:.2e} (limit {AX_REAL_TOL:g})")
    if not err <= AX_REAL_TOL:
        raise AssertionError("ax differs from its plain version")


def phase_single_vector() -> None:
    """atx and atx_a on the whole config-B matrix and ax on the config-X
    one, each against its plain version as the full run checks them (bit
    for bit on dyadic inputs, atx's bv on v = 1 against the non-missing
    count, atx and atx_a on Gaussian v within BF16_PLAIN_TOL, ax on the
    statistics' inputs within AX_REAL_TOL) and timed through the wrapper,
    on instances of their own seed.  It uses only functions that every
    tree of the port since PR 14 has, so a copy of this file in another
    tree (a parent unpacked with git archive) times that tree's kernels:
    run it in the two trees in turns."""
    log("== phase 3v: the single-vector products, config-B and config-X "
        "words")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    words = synth_words(gen, False, CFG_B_N, CFG_B_M)
    nw, m = words.shape
    label = f"config B full {nw}x{m}"
    check_kernels(words, 1, gen, label, names=("atx", "atx_a"),
                  count=16 * nw, reps=9, plain_reps=1)
    check_gaussian(words, 1, gen, label, "plain", BF16_PLAIN_TOL,
                   names=("atx", "atx_a"))
    del words
    torch.cuda.empty_cache()
    words = synth_words(gen, False, CFG_X_N, CFG_X_M)
    nw, m = words.shape
    check_kernels(words, 1, gen, f"config X full {nw}x{m}", names=("ax",),
                  reps=9, plain_reps=1)
    check_ax_real(words, gen)


def bf16_float64_slices(words, B, gen, label) -> None:
    """The bf16-split products on the whole matrix against float64 on a
    slice of their outputs (the first 64 word rows' people for axm_bf16,
    the first 1,024 markers for atxm_bf16), Gaussian inputs: their error
    at the full contraction length, printed beside the plain versions'
    (kernel_check holds the small shapes to its limit)."""
    from gvamp_tpu_torch.ops import matvec
    nw, m = words.shape
    dev = words.device
    W = torch.randn((m, B), generator=gen, device=dev)
    U = torch.randn((m, B), generator=gen, device=dev) * 0.1
    V = torch.randn((4, 4 * nw, B), generator=gen, device=dev)
    rows, cols = words[:64].contiguous(), words[:, :1024].contiguous()

    def rel(x, ref):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    z64 = matvec.axm_ref(rows, W, U, torch.float64)
    fw = (rel(matvec.axm_bf16(words, W, U)[:, :256], z64),
          rel(matvec.axm_bf16_ref(rows, W, U), z64))
    r64 = matvec.atxm_ref(cols, V, torch.float64)
    tx = (max(rel(x[:1024], r) for x, r in zip(matvec.atxm_bf16(words, V),
                                                 r64)),
          max(rel(x, r) for x, r in zip(matvec.atxm_bf16_ref(cols, V), r64)))
    log(f"  {label:>22s} B={B:<3d} against float64 at the full contraction "
        f"length: axm_bf16 {fw[0]:.3e} (plain {fw[1]:.3e}), atxm_bf16 "
        f"{tx[0]:.3e} (plain {tx[1]:.3e})")


def phase_bf16_split() -> None:
    """axm_bf16 and atxm_bf16 at B = 1 and 2 on the whole config-B and
    config-Bm matrices, each against its plain version as the full run
    checks them (bit for bit on dyadic inputs, within BF16_PLAIN_TOL on
    Gaussian inputs) and timed through the wrapper, on instances of their
    own seed; on config B also against float64 at the full contraction
    length (bf16_float64_slices, a measurement, no limit).  It uses only
    functions that every tree of the port since PR 5 has, so a copy of this
    file in another tree (a parent unpacked with git archive) times that
    tree's kernels: run it in the two trees in turns."""
    log("== phase 3w: the bf16-split products, config-B and config-Bm words")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for missing in (False, True):
        words = synth_words(gen, missing, CFG_B_N, CFG_B_M)
        nw, m = words.shape
        label = f"config {'Bm' if missing else 'B'} full {nw}x{m}"
        for B in (1, 2):
            check_kernels(words, B, gen, label, names=BF16_KERNELS, reps=9,
                          plain_reps=1)
            check_gaussian(words, B, gen, label, "plain", BF16_PLAIN_TOL,
                           names=BF16_KERNELS)
            if not missing:
                bf16_float64_slices(words, B, gen, label)
        del words
        torch.cuda.empty_cache()


# corr(x_hat, beta) and R2_train_1 after 10 dual iterations at config X and
# at config Xm; set from the first H100 run of this phase (X 0.38174 and
# 0.5568 in dual, dual two-pass and primal mode alike, Xm 0.35720 and
# 0.5984, PERF.md) with CORR_MIN's room for f32 rounding and a different
# card, not for a different algorithm.  N/M = 0.01 leaves the 1,000
# effects poorly determined, hence the low correlation.
X_CORR_MIN = 0.35
X_R2_RANGE = (0.50, 0.65)
# fused dual Gram against GVAMP_NO_FUSED_GRAM=1 at config X: the tolerances
# of tests/test_xxt.py:95-99
X_FUSED_XTOL, X_FUSED_RTOL = 5e-5, 2e-4


def log_setup_split(geno, label):
    """The dual set-up pieces timed apart (people statistics with its two
    ax launches, the dual SLQ basis of slq_k fused Gram passes), outside
    the launch-counted run."""
    from gvamp_tpu_torch import linear, probit
    cfg = linear.VampConfig(use_xxt=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    linear.xxt_diag_base(geno)
    torch.cuda.synchronize()
    t_people = time.perf_counter() - t0
    z_bern = geno.axm(linear.make_bern_probe(geno, cfg.seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probit.make_slq_basis_dual(geno, cfg, z_bern)
    torch.cuda.synchronize()
    log(f"  {label} dual set-up apart: people statistics "
        f"{t_people * 1e3:.2f} ms, dual SLQ basis ({cfg.slq_k} Gram passes) "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")


def phase_dual_x(words, words_m):
    """Dual mode (use_xxt) at config X (complete) and Xm (missing calls),
    10 iterations each, through the fused dual Gram, with the launch
    counters; the X problem again under GVAMP_NO_FUSED_GRAM=1 (the same
    trajectory within X_FUSED_*), in primal mode (iteration medians and
    CG counts side by side) and on the dual probe path (phase 4q).
    Returns (launches at X, launches at Xm, launches of the X probe
    path)."""
    log("== phase 4x: dual (XXT) mode at config X and Xm, primal at X")
    from gvamp_tpu_torch.ops import matvec
    geno, beta, vars_t, probs_t = make_problem(words, "config X", True,
                                               CFG_X_N, CFG_X_M)
    log_setup_split(geno, "config X")
    runs = {}
    for name, xxt, env in (("dual", True, None), ("dual two-pass", True, "1"),
                           ("primal", False, None)):
        log(f"  -- config X {name}")
        if env:
            os.environ["GVAMP_NO_FUSED_GRAM"] = env
        torch.cuda.reset_peak_memory_stats()
        matvec.reset_launches()
        try:
            x_hat, _, hist = run_infer(geno, beta, vars_t, probs_t,
                                       f"config X {name}", X_CORR_MIN,
                                       X_R2_RANGE, use_xxt=xxt)
        finally:
            os.environ.pop("GVAMP_NO_FUSED_GRAM", None)
        runs[name] = (x_hat, hist, dict(matvec.LAUNCHES))
    launches = runs["dual"][2]
    check_launches("config X dual", launches, ("gram_aat_i8a", "ax"),
                   ("gram_aat_i8", "axm_i8", "atxm_i8"))
    check_launches("config X dual two-pass", runs["dual two-pass"][2],
                   ("axm_i8a", "atxm_i8a", "ax"),
                   ("gram_aat_i8a", "gram_aat_i8"))
    check_launches("config X primal", runs["primal"][2],
                   ("axm_i8a", "atxm_i8a"), ("gram_aat_i8a", "ax"))
    for n in ("dual", "dual two-pass"):
        if runs[n][2]["ax"] != 2:
            raise AssertionError(f"config X {n}: ax launched "
                                 f"{runs[n][2]['ax']} times, expected 2")
    (x_f, h_f, _), (x_t, h_t, _) = runs["dual"], runs["dual two-pass"]
    dx = float(np.abs(x_f - x_t).max() / np.abs(x_t).max())
    log(f"  fused vs two-pass: max|dx| / max|x| = {dx:.3e} (limit "
        f"{X_FUSED_XTOL:g})")
    if not dx < X_FUSED_XTOL:
        raise AssertionError("config X: fused and two-pass x_hat differ")
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        a, b = float(h_f[-1][k]), float(h_t[-1][k])
        log(f"  {k}: fused {a:.7g} two-pass {b:.7g} rel "
            f"{abs(a - b) / abs(b):.3e} (limit {X_FUSED_RTOL:g})")
        if not abs(a - b) <= X_FUSED_RTOL * abs(b):
            raise AssertionError(f"config X: fused and two-pass {k} differ")
    for n, (_, h, _) in runs.items():
        log(f"  config X {n}: steady-state median "
            f"{np.median([x['host_ms'] for x in h[2:]]):.2f} ms/it, CG "
            f"{[x['cg_iters'] for x in h]}")
    launches_q = phase_probe_dual_x(geno, beta, vars_t, probs_t)
    del geno
    torch.cuda.empty_cache()

    log("  -- config Xm dual (missing calls)")
    geno, beta, vars_t, probs_t = make_problem(words_m, "config Xm", False,
                                               CFG_X_N, CFG_X_M)
    log_setup_split(geno, "config Xm")
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    run_infer(geno, beta, vars_t, probs_t, "config Xm dual", X_CORR_MIN,
              X_R2_RANGE, use_xxt=True)
    launches_m = dict(matvec.LAUNCHES)
    check_launches("config Xm dual", launches_m, ("gram_aat_i8", "ax"),
                   ("gram_aat_i8a", "axm_i8a", "atxm_i8a"))
    if launches_m["ax"] != 2:
        raise AssertionError(f"config Xm: ax launched {launches_m['ax']} "
                             f"times, expected 2")
    return launches, launches_m, launches_q


def bed_bytes(codes):
    """PLINK .bed rows uint8[M, ceil(N/4)] of 2-bit codes [M, N]."""
    M, N = codes.shape
    by = np.zeros((M, (N + 3) // 4), dtype=np.uint8)
    for k in range(4):
        by[:, : (N - k + 3) // 4] |= codes[:, k::4] << (2 * k)
    return by


def phase_moments_biobank():
    """Marker statistics and LOO p-values at N=327,680 against an
    all-float64 numpy oracle: the recipe of tests/test_pvals.py:133-176
    (near-constant markers, 1% missing calls, 2% NA phenotype)."""
    log("== phase 4n: moments at biobank N (N=327,680 x M=64) vs float64")
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import pvals
    rng = np.random.default_rng(42)
    N, M = 327_680, 64
    f2 = np.concatenate([np.full(4, 0.999), rng.uniform(0.05, 0.95, M - 4)])
    u = rng.random((M, N))
    codes = np.where(u < f2[:, None], 0,
                     np.where(u < (f2 + (1 - f2) / 2)[:, None], 2, 3)
                     ).astype(np.uint8)
    codes[rng.random((M, N)) < 0.01] = 1
    y = rng.normal(2.0, 3.0, size=N)
    y[rng.random(N) < 0.02] = np.nan
    t0 = time.perf_counter()
    geno = GenoBed.from_arrays(bed_bytes(codes), y, N=N, device="cuda")
    p32 = pvals.loo_pvals(geno, torch.zeros_like(geno.y_planar),
                          torch.zeros(geno.Mpad, device="cuda"))
    t_dev = time.perf_counter() - t0
    # float64 oracle (tests/helpers.py DenseOracle, data.cpp:446-483)
    a = np.array([2.0, 0.0, 1.0, 0.0])[codes]
    mask = np.array([1.0, 0.0, 1.0, 1.0])[codes] * (~np.isnan(y))[None, :]
    nonas = int((~np.isnan(y)).sum())
    avg = np.nanmean(y)
    ys = np.where(np.isnan(y), 0.0, y * np.sqrt((nonas - 1)
                                                / np.nansum((y - avg) ** 2)))
    cnt = mask.sum(1)
    mave = (a * mask).sum(1) / cnt
    value = (a - mave[:, None]) * mask
    sumsqr = (value**2).sum(1)
    msig = 1.0 / np.sqrt(sumsqr / (nonas - 1))
    value *= msig[:, None]
    p64 = pvals._reg1d_pvals(value.sum(1), (value**2).sum(1), value @ ys,
                             mask @ ys, mask @ ys**2, cnt)
    gm = geno.mave.cpu().numpy()[:M].astype(np.float64)
    gs = geno.msig.cpu().numpy()[:M].astype(np.float64)
    checks = [("mave", gm, mave, 2e-6, 1e-7), ("msig[:4]", gs[:4], msig[:4],
                                                 5e-4, 0.0),
              ("msig[4:]", gs[4:], msig[4:], 2e-5, 0.0)]
    for name, got, want, rtol, atol in checks:
        err = float((np.abs(got - want) / np.abs(want)).max())
        log(f"  {name}: max rel err {err:.3e} (limit rtol {rtol:g}, "
            f"atol {atol:g})")
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)
    dlog = float(np.abs(np.log10(p32) - np.log10(p64)).max())
    log(f"  LOO p at x1 = 0: max |dlog10 p| {dlog:.3e} (limit 2e-3); card "
        f"load + statistics + p-values {t_dev:.2f} s")
    if not dlog <= 2e-3:
        raise AssertionError("biobank-N p-values differ from float64")


def small_problem(tmp, seed, N, M, miss_rate=0.0):
    """A simulated .bed in ``tmp`` and its truth."""
    from gvamp_tpu_torch import sim
    from gvamp_tpu_torch.io import plink
    rng = np.random.default_rng(seed)
    bed = os.path.join(tmp, "d.bed")
    plink.write_bed(bed, sim.random_genotypes(rng, M, N,
                                              miss_rate=miss_rate))
    vars_t, probs_t = sim.two_group_prior(M, 40, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    return bed, beta, vars_t, probs_t, rng


def phase_card_vs_cpu(miss_rate, use_xxt=False, fused=False, use_slq=True,
                      red=False, cross_val=False, shards=1):
    """The linear engine on the card and on the CPU (plain versions) from
    the same data and probe: phase 5, with use_slq=False (the probe
    path) or red=True (the same window starts, drawn on the host) phase
    5q, with cross_val=True (cv_r2 and rho_cross held too, the damping
    tuner's decisions printed) phase 5v, with ``shards`` > 1 (a marker
    mesh of that many shards on each side) phase 8c."""
    label = "complete" if miss_rate == 0 else f"{miss_rate:.0%} missing"
    label += ", dual (XXT)" if use_xxt else ""
    label += ", fused primal Gram" if fused else ""
    label += ", use_slq=False" if not use_slq else ""
    label += ", red" if red else ""
    label += ", cross-validation" if cross_val else ""
    label += f", {shards} shards" if shards > 1 else ""
    phase = ("8c" if shards > 1 else "5v" if cross_val
             else "5" if use_slq and not red else "5q")
    log(f"== phase {phase}: card vs CPU, N=2000 x M=4096, 6 iterations, "
        f"{label}")
    from gvamp_tpu_torch import dist, linear, sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import matvec, pvals
    N, M = 2000, 4096
    cfg = linear.VampConfig(max_iter=6, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0, seed=5, use_xxt=use_xxt,
                            use_slq=use_slq, red=red,
                            use_cross_val=cross_val)
    if use_xxt:
        gram = "gram_aat_i8a" if miss_rate == 0 else "gram_aat_i8"
    else:
        gram = "gram_i8a" if miss_rate == 0 else "gram_i8"
    chroms = 1 + np.arange(M) * 4 // M
    out = {}
    with tempfile.TemporaryDirectory() as tmp, fused_env(fused):
        bed, beta, vars_t, probs_t, rng = small_problem(tmp, 3, N, M,
                                                        miss_rate)
        y = None
        for dev in ("cuda", "cpu"):
            g = GenoBed.from_files(
                bed, None, N=N, Mt=M, device=dev, standardize_phen=False,
                mesh=dist.Mesh(shards, dev) if shards > 1 else None)
            if g.geno_complete != (miss_rate == 0):
                raise AssertionError(f"{dev}: geno_complete is wrong")
            if y is None:
                y = sim.simulate_linear_phenotype(g, beta, 2.0, rng)
            g.set_phen(y)
            t0 = time.perf_counter()
            matvec.reset_launches()
            if g.mesh is not None:
                g.mesh.calls.clear()
            x, state, hist = linear.infer(g, cfg, probs_t, vars_t,
                                          verbose=False)
            if dev == "cuda" and shards > 1:
                check_mesh_launches(
                    f"card, {label}", g.mesh, dict(matvec.LAUNCHES),
                    ("axm_i8a", "atxm_i8a") if miss_rate == 0
                    else ("axm_i8", "atxm_i8"))
            if dev == "cuda" and (use_xxt or fused) and \
                    not matvec.LAUNCHES[gram]:
                raise AssertionError(f"the card's run did not launch "
                                     f"{gram}: {matvec.LAUNCHES}")
            if dev == "cuda" and cross_val:
                check_launches(f"card, {label}", dict(matvec.LAUNCHES),
                               ("axm_i8a", "atxm_i8a") if miss_rate == 0
                               else ("axm_i8", "atxm_i8"))
            check_no_tool_launches(f"card vs CPU, {dev}", matvec.LAUNCHES)
            p = None
            if miss_rate and not use_xxt and not fused and phase in ("5",
                                                                      "8c"):
                p = (pvals.loo_pvals(g, state.z1, state.x1),
                     pvals.loco_pvals(g, state.z1, state.x1, chroms))
            out[dev] = x, hist, p
            log(f"  {dev}: {time.perf_counter() - t0:.2f} s")
    (x_c, h_c, p_c), (x_p, h_p, p_p) = out["cuda"], out["cpu"]
    out = {dev: (x, None, h) for dev, (x, h, _) in out.items()}
    log(f"  probe_iters card {[h['probe_iters'] for h in h_c]} cpu "
        f"{[h['probe_iters'] for h in h_p]}"
        + (f"; window starts card {[h['red_sbw'] for h in h_c]} cpu "
           f"{[h['red_sbw'] for h in h_p]}" if red else ""))
    if red and [h["red_sbw"] for h in h_c] != [h["red_sbw"] for h in h_p]:
        raise AssertionError("card and CPU drew other window starts")
    if cross_val:
        log(f"  retries card {retries(h_c, cfg.rho)} cpu "
            f"{retries(h_p, cfg.rho)}; cv_r2 card "
            f"{[round(float(h['cv_r2']), 6) for h in h_c]} cpu "
            f"{[round(float(h['cv_r2']), 6) for h in h_p]}")
    compare_card_cpu(label, out["cuda"], out["cpu"],
                     ("gam1", "gam2", "gamw", "alpha2")
                     + ("cv_r2", "rho_cross") * cross_val)
    log(f"  cg_iters card {[h['cg_iters'] for h in h_c]} "
        f"cpu {[h['cg_iters'] for h in h_p]}")
    if p_c is not None:
        for name, pc, pp in zip(("LOO", "LOCO"), p_c, p_p):
            lc, lp = np.log10(pc), np.log10(pp)
            d = float((np.abs(lc - lp) / np.maximum(1.0, -lp)).max())
            log(f"  {name}: max |dlog10 p| / max(1, |log10 p|) = {d:.3e} "
                f"(limit {CARD_CPU_LOG10P_TOL:g}); min p {float(pp.min()):.3e}")
            if not d <= CARD_CPU_LOG10P_TOL:
                raise AssertionError(f"card and CPU {name} p-values disagree")


# probit card vs CPU, wider than the f32 tolerances of
# tests/test_torch_probit.py (1e-4, 5e-4; port against JAX, both on the
# CPU): iteration 1's Onsager term clips at 1 - 100 eps(f32) (alpha2 =
# 0.9999881), and r1 = (x2 - alpha2 r2) / (1 - alpha2) multiplies the two
# devices' f32 rounding differences (other summation orders, CUDA's libm)
# by about 1e5; the trajectories then agree to 4e-6 at iteration 1 and
# 3.8e-4 at iteration 2 (gam1), and x1 to 8.2e-5 (complete) and 1.2e-4
# (2% missing, 2 covariates) of max|x1| after 6 (first H100 run)
PROBIT_CARD_CPU_XTOL, PROBIT_CARD_CPU_RTOL = 5e-4, 1e-3


def phase_card_vs_cpu_probit(miss_rate, n_cov, fused=False, use_slq=True):
    """The probit engine on the card and on the CPU (plain versions) from
    the same data, probe and initial p1 (PROBIT_CARD_CPU_*).  N=6,000 x
    M=2,048 (M/N 0.34): the probit solves are better conditioned than at
    the linear phase's N=2,000 x M=4,096, where the two devices' rounding
    noise grows to 5.1e-4 of max|x1| (first H100 run).  use_slq=False:
    phase 5q, the probe path."""
    label = "complete" if miss_rate == 0 else f"{miss_rate:.0%} missing"
    label += f", {n_cov} covariates" if n_cov else ""
    label += ", fused primal Gram" if fused else ""
    label += ", use_slq=False" if not use_slq else ""
    log(f"== phase {'5' if use_slq else '5q'}: probit card vs CPU, N=6000 x "
        f"M=2048, 6 iterations, {label}")
    from gvamp_tpu_torch import probit, sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import matvec
    N, M = 6000, 2048
    cfg = probit.ProbitConfig(max_iter=6, rho=0.3, probit_var=0.5, seed=5,
                              use_slq=use_slq)
    gram = "gram_i8a" if miss_rate == 0 else "gram_i8"
    out = {}
    with tempfile.TemporaryDirectory() as tmp, fused_env(fused):
        bed, beta, vars_t, probs_t, rng = small_problem(tmp, 4, N, M,
                                                        miss_rate)
        covs = rng.normal(size=(N, n_cov)) if n_cov else None
        eff = np.linspace(0.3, -0.3, n_cov) if n_cov else None
        y = None
        for dev in ("cuda", "cpu"):
            g = GenoBed.from_files(bed, None, N=N, Mt=M, device=dev,
                                   standardize_phen=False)
            g.covs = covs
            if y is None:
                y = sim.simulate_probit_phenotype(g, beta, 0.5, rng, eff)
            g.set_phen(y)
            t0 = time.perf_counter()
            matvec.reset_launches()
            x, _, hist = probit.infer(g, cfg, probs_t, vars_t, verbose=False)
            if dev == "cuda" and fused and not matvec.LAUNCHES[gram]:
                raise AssertionError(f"the card's run did not launch "
                                     f"{gram}: {matvec.LAUNCHES}")
            check_no_tool_launches(f"card vs CPU probit, {dev}",
                                   matvec.LAUNCHES)
            out[dev] = x, hist
            log(f"  {dev}: {time.perf_counter() - t0:.2f} s")
    (x_c, h_c), (x_p, h_p) = out["cuda"], out["cpu"]
    keys = ("gam1", "gam2", "tau1", "tau2", "alpha2")
    for dev, h in (("card", h_c), ("cpu", h_p)):
        for x in h:
            log(f"  {dev} it {x['it']}: " + " ".join(
                f"{k}={float(x[k]):.7g}" for k in keys)
                + f" cg={x['cg_iters']}")
    dx = float(np.abs(x_c - x_p).max() / np.abs(x_p).max())
    log(f"  max|x1 card - x1 cpu| / max|x1| = {dx:.3e} (limit "
        f"{PROBIT_CARD_CPU_XTOL:g}); corr(x_hat, beta) "
        f"{float(np.corrcoef(x_c, beta)[0, 1]):.5f}")
    if not dx < PROBIT_CARD_CPU_XTOL:
        raise AssertionError("card and CPU probit x1 disagree")
    for k in keys:
        a, b = float(h_c[-1][k]), float(h_p[-1][k])
        log(f"  {k}: card {a:.7g} cpu {b:.7g} rel {abs(a - b) / abs(b):.3e} "
            f"(limit {PROBIT_CARD_CPU_RTOL:g})")
        if not abs(a - b) <= PROBIT_CARD_CPU_RTOL * abs(b):
            raise AssertionError(f"card and CPU probit {k} disagree")
    if n_cov:
        ec, ep = np.asarray(h_c[-1]["cov_eff"]), np.asarray(h_p[-1]["cov_eff"])
        log(f"  cov_eff card {ec} cpu {ep} (truth {eff})")
        if not np.allclose(ec, ep, rtol=PROBIT_CARD_CPU_RTOL,
                           atol=PROBIT_CARD_CPU_RTOL):
            raise AssertionError("card and CPU covariate effects disagree")
    log(f"  cg_iters card {[h['cg_iters'] for h in h_c]} "
        f"cpu {[h['cg_iters'] for h in h_p]}")


# Huber card vs CPU (phase 5h): N=2,000 x M=4,096 (M > N), where the
# Huber dynamics themselves are unstable.  On these problems the JAX
# package's own float32 run is within 1.6e-6 of max|x1| of its float64 run
# at iterations 1-2 and its scalars within 1.9e-6 at iteration 1; from
# there alpha2 meets its clip at 1 - 100 eps of the dtype, and from
# iteration 3 x1 is 0.2-1.2 off, tau1 at GAMMA_MIN (tests/huber_spread.py).
# So x1 is held to HUBER_CARD_CPU_XTOL at iterations 1-2 and the scalars to
# HUBER_CARD_CPU_RTOL at iteration 1, ten times those spreads; at every
# iteration deltaH must pick the same grid point on both sides and every
# value must be finite; the later differences are printed.  First H100
# run (after slq.nodes_weights moved to float64): the scalars within
# 1.1e-6 at iteration 1, x1 within 6.1e-7 at iteration 2, and 1.1e-3 to
# 3.8e-3 from iteration 3 on
HUBER_CARD_CPU_XTOL, HUBER_CARD_CPU_RTOL = 2e-5, 2e-5
HUBER_CARD_CPU_X_ITERS, HUBER_CARD_CPU_S_ITERS = 2, 1
HUBER_CARD_CPU_CASES = [(0.0, 0), (0.02, 0), (0.0, 8)]


def phase_card_vs_cpu_huber(miss_rate, deflate_k, use_slq=True):
    """The Huber engine on the card and on the CPU (plain versions) from
    the same data, probe, deflation start block and Monte-Carlo draws (all
    from CPU generators): N=2,000 x M=4,096, f32, 6 iterations; with
    use_slq=False phase 5q, the probe path."""
    label = "complete" if miss_rate == 0 else f"{miss_rate:.0%} missing"
    label += f", deflate_k={deflate_k}" if deflate_k else ""
    label += ", use_slq=False" if not use_slq else ""
    log(f"== phase {'5h' if use_slq else '5q'}: Huber card vs CPU, N=2000 x "
        f"M=4096, 6 iterations, {label}")
    from gvamp_tpu_torch import robust
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import matvec
    N, M = 2000, 4096
    cfg = robust.RobustConfig(max_iter=6, rho=0.3, seed=5,
                              stop_criteria_thr=0.0, deflate_k=deflate_k,
                              use_slq=use_slq)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        bed, beta, vars_t, probs_t, rng = small_problem(tmp, 6, N, M,
                                                        miss_rate)
        y = None
        for dev in ("cuda", "cpu"):
            g = GenoBed.from_files(bed, None, N=N, Mt=M, device=dev,
                                   standardize_phen=False)
            if y is None:
                y = huber_phenotype(g, beta, rng)
            g.set_phen(y)
            t0 = time.perf_counter()
            matvec.reset_launches()
            xs = []
            x, _, hist = robust.infer(
                g, cfg, probs_t, vars_t, verbose=False,
                callbacks=[lambda it, s, m, g_: xs.append(
                    s.x1.double().cpu().numpy())])
            check_no_tool_launches(f"Huber card vs CPU, {dev}",
                                   matvec.LAUNCHES)
            out[dev] = x, hist, xs
            log(f"  {dev}: {time.perf_counter() - t0:.2f} s")
    (x_c, h_c, xs_c), (x_p, h_p, xs_p) = out["cuda"], out["cpu"]
    scalars = ("gam1", "gam2", "tau1", "tau2", "alpha2")
    for dev, h in (("card", h_c), ("cpu", h_p)):
        for x in h:
            log(f"  {dev} it {x['it']}: " + " ".join(
                f"{k}={float(x[k]):.7g}" for k in HUBER_KEYS)
                + f" cg={x['cg_iters']}")
    if not all(np.isfinite(v).all() for v in (x_c, x_p)) or not all(
            np.isfinite(float(x[k])) for h in (h_c, h_p) for x in h
            for k in HUBER_KEYS):
        raise AssertionError("non-finite Huber values")
    d_c = [float(h["deltaH"]) for h in h_c]
    d_p = [float(h["deltaH"]) for h in h_p]
    log(f"  deltaH per iteration: card {d_c}, cpu {d_p}")
    if d_c != d_p:
        raise AssertionError(f"card and CPU pick different deltaH grid "
                             f"points: {d_c} against {d_p}")
    for i, (a, b) in enumerate(zip(xs_c, xs_p)):
        dx = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        rel = {k: abs(float(h_c[i][k]) - float(h_p[i][k]))
               / abs(float(h_p[i][k])) for k in scalars}
        held_x = i < HUBER_CARD_CPU_X_ITERS
        held_s = i < HUBER_CARD_CPU_S_ITERS
        log(f"  it {i + 1}: max|x1 card - x1 cpu| / max|x1| = {dx:.3e}"
            + (f" (limit {HUBER_CARD_CPU_XTOL:g})" if held_x else "")
            + "; relative " + ", ".join(f"{k} {v:.2e}"
                                        for k, v in rel.items())
            + (f" (limit {HUBER_CARD_CPU_RTOL:g})" if held_s else ""))
        if (held_x and not dx <= HUBER_CARD_CPU_XTOL) or (
                held_s and not max(rel.values()) <= HUBER_CARD_CPU_RTOL):
            raise AssertionError(f"card and CPU Huber runs disagree at "
                                 f"iteration {i + 1}")
    log(f"  corr(x_hat, beta) card {float(np.corrcoef(x_c, beta)[0, 1]):.5f}"
        f" cpu {float(np.corrcoef(x_p, beta)[0, 1]):.5f}; cg_iters card "
        f"{[h['cg_iters'] for h in h_c]} cpu {[h['cg_iters'] for h in h_p]}")


def flagship_files(tmp, N, M):
    """The flagship data of the README's port section in ``tmp``: N x M with
    2% missing calls, a .bim over 4 chromosomes and a simulated phenotype;
    returns (bed, phen, bim, beta)."""
    from gvamp_tpu_torch import sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.io import plink
    rng = np.random.default_rng(42)
    bed, phen, bim = (os.path.join(tmp, f"demo.{e}")
                      for e in ("bed", "phen", "bim"))
    plink.write_bed(bed, sim.random_genotypes(rng, M, N, miss_rate=0.02))
    plink.write_bim(bim, np.repeat(np.arange(1, 5), M // 4))
    g = GenoBed.from_files(bed, None, N=N, Mt=M, device="cuda",
                           standardize_phen=False)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    plink.write_phen(phen, sim.simulate_linear_phenotype(
        g, beta, 1 / (1 - 0.8), rng))
    return bed, phen, bim, beta


def phase_cli():
    """The flagship flow of the README's port section on the card: 2%
    missing calls, --store-pvals 1 and a .bim over 4 chromosomes."""
    log("== phase 6: CLI infere with --store-pvals 1 and a .bim, 2% missing")
    from gvamp_tpu_torch.io import vecio
    from gvamp_tpu_torch import cli, linear
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import matvec, pvals
    N, M, n_it = 800, 240, 8
    with tempfile.TemporaryDirectory() as tmp:
        bed, phen, bim, beta = flagship_files(tmp, N, M)
        args = flagship_cli_args(bed, phen, bim, N, M,
                                 os.path.join(tmp, "out"), "demo", n_it,
                                 pvals=True)
        matvec.reset_launches()
        cli.main(args)
        check_no_tool_launches("CLI linear", matvec.LAUNCHES)
        pre = os.path.join(tmp, "out", "demo")
        names = [f"{pre}{s}" for it in range(1, n_it + 1)
                 for s in (f"_it_{it}.bin", f"_r1_it_{it}.bin",
                           f"_r2_it_{it}.bin", f"_it_{it}_x2_hat.bin",
                           f"_z1_it_{it}.csv")]
        names += [f"{pre}_pvals.bin", f"{pre}_pvals_LOCO.bin"]
        names += [f"{pre}_LOCO_chr_{ch}.csv" for ch in range(1, 5)]
        missing = [n for n in names if not os.path.getsize(n)]
        if missing:
            raise AssertionError(f"CLI outputs missing: {missing}")
        g = GenoBed.from_files(bed, phen, N=N, Mt=M, device="cuda",
                               bim_path=bim)
        if g.geno_complete:
            raise AssertionError("the flagship data has no missing calls")
        x_lib, state, _ = linear.infer(
            g, linear.VampConfig(max_iter=n_it, rho=0.3), [0.95, 0.05],
            [0.0, 0.0667], verbose=False)
        dump = vecio.read_bin_shard(f"{pre}_it_{n_it}.bin", M, 0)
        d = float(np.abs(dump - x_lib).max() / np.abs(x_lib).max())
        p_file = vecio.read_bin_shard(f"{pre}_pvals.bin", M, 0)
        p_lib = pvals.loo_pvals(g, state.z1, state.x1)
        p_loco = vecio.read_bin_shard(f"{pre}_pvals_LOCO.bin", M, 0)
        preds = [np.loadtxt(f"{pre}_LOCO_chr_{ch}.csv") for ch in range(1, 5)]
    corr = float(np.corrcoef(dump, beta)[0, 1])
    causal = beta != 0
    med = float(np.median(p_file[causal]))
    log(f"  {len(names)} files written; max|dump - library x1| / max|x1| "
        f"= {d:.3e}; corr(x_hat, beta) {corr:.5f} (limit 0.95); median "
        f"causal LOO p {med:.3e} (limit 1e-6); _pvals.bin equal to the "
        f"library loo_pvals: {np.array_equal(p_file, p_lib)}")
    if not d < 1e-6:
        raise AssertionError("CLI dump differs from the library run")
    if not (corr > 0.95 and med < 1e-6):
        raise AssertionError("the flagship flow missed its expectations")
    if not np.array_equal(p_file, p_lib):
        raise AssertionError("_pvals.bin differs from a library loo_pvals")
    if not (pvals_in_range(p_file) and pvals_in_range(p_loco)):
        raise AssertionError("p-value files outside [0, 1]")
    if not all(pr.shape[0] >= N and np.isfinite(pr).all() for pr in preds):
        raise AssertionError("LOCO predictor files malformed")


def phase_cli_xxt():
    """The flagship recipe with --use-XXT-denoiser 1: the dual solve through
    the CLI on the card, its dump equal to a library dual run."""
    log("== phase 6x: CLI infere with --use-XXT-denoiser 1, 2% missing")
    from gvamp_tpu_torch.io import vecio
    from gvamp_tpu_torch import cli, linear
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import matvec
    N, M, n_it = 800, 240, 8
    with tempfile.TemporaryDirectory() as tmp:
        bed, phen, _, beta = flagship_files(tmp, N, M)
        matvec.reset_launches()
        cli.main(["--device", "cuda", "--run-mode", "infere", "--model",
                  "linear", "--bed-file", bed, "--phen-files", phen,
                  "--N", str(N), "--Mt", str(M), "--iterations", str(n_it),
                  "--rho", "0.3", "--probs", "0.95,0.05", "--vars",
                  "0.0,0.0667", "--use-XXT-denoiser", "1", "--verbosity",
                  "0", "--out-dir", os.path.join(tmp, "out"), "--out-name",
                  "dual"])
        launches = dict(matvec.LAUNCHES)
        check_no_tool_launches("CLI dual", launches)
        pre = os.path.join(tmp, "out", "dual")
        dump = vecio.read_bin_shard(f"{pre}_it_{n_it}.bin", M, 0)
        g = GenoBed.from_files(bed, phen, N=N, Mt=M, device="cuda")
        x_lib, _, _ = linear.infer(
            g, linear.VampConfig(max_iter=n_it, rho=0.3, use_xxt=True),
            [0.95, 0.05], [0.0, 0.0667], verbose=False)
    d = float(np.abs(dump - x_lib).max() / np.abs(x_lib).max())
    corr = float(np.corrcoef(dump, beta)[0, 1])
    log(f"  launches {launches}; max|dump - library x1| / max|x1| = {d:.3e};"
        f" corr(x_hat, beta) {corr:.5f} (limit 0.95)")
    if not launches["gram_aat_i8"] or launches["gram_aat_i8a"]:
        raise AssertionError("the dual CLI run did not take gram_aat_i8")
    if not (d < 1e-6 and corr > 0.95):
        raise AssertionError("the dual CLI flow missed its expectations")


def phase_cli_probit():
    """--model bin_class with --cov-file / --C 2 through the CLI on the card
    (the flagship genotypes, 2% missing calls, a binary phenotype with two
    covariates): the _probit_ dumps, the estimate equal to a library run."""
    log("== phase 6p: CLI infere --model bin_class --cov-file --C 2, 2% "
        "missing")
    from gvamp_tpu_torch import cli, probit, sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.io import plink, vecio
    from gvamp_tpu_torch.ops import matvec
    N, M, n_it = 800, 240, 8
    pv = 0.2
    with tempfile.TemporaryDirectory() as tmp:
        bed, _, _, beta = flagship_files(tmp, N, M)
        phen, cov = os.path.join(tmp, "cc.phen"), os.path.join(tmp, "c.cov")
        rng = np.random.default_rng(7)
        covs = rng.normal(size=(N, 2))
        plink.write_covariates(cov, covs)
        g = GenoBed.from_files(bed, None, N=N, Mt=M, device="cuda",
                               standardize_phen=False)
        g.covs = covs
        plink.write_phen(phen, sim.simulate_probit_phenotype(
            g, beta, pv, rng, np.array([0.4, -0.4])))
        matvec.reset_launches()
        cli.main(["--device", "cuda", "--run-mode", "infere", "--model",
                  "bin_class", "--bed-file", bed, "--phen-files", phen,
                  "--cov-file", cov, "--C", "2", "--probit-var", str(pv),
                  "--N", str(N), "--Mt", str(M), "--iterations", str(n_it),
                  "--rho", "0.3", "--probs", "0.95,0.05", "--vars",
                  "0.0,0.0667", "--verbosity", "0", "--out-dir",
                  os.path.join(tmp, "out"), "--out-name", "cc"])
        launches = dict(matvec.LAUNCHES)
        check_no_tool_launches("CLI bin_class", launches)
        pre = os.path.join(tmp, "out", "cc")
        names = [f"{pre}{s}" for it in range(1, n_it + 1)
                 for s in (f"_probit_it_{it}.bin", f"_probit_r1_it_{it}.bin",
                           f"_probit_z1_it_{it}.csv",
                           f"_probit_p1_it_{it}.csv")]
        missing = [n for n in names if not os.path.getsize(n)]
        if missing:
            raise AssertionError(f"CLI outputs missing: {missing}")
        dump = vecio.read_bin_shard(f"{pre}_probit_it_{n_it}.bin", M, 0)
        g = GenoBed.from_files(bed, phen, N=N, Mt=M, device="cuda",
                               standardize_phen=False)
        g.read_covariates(cov, 2)
        x_lib, state, _ = probit.infer(
            g, probit.ProbitConfig(max_iter=n_it, rho=0.3, probit_var=pv),
            [0.95, 0.05], [0.0, 0.0667], verbose=False)
    d = float(np.abs(dump - x_lib).max() / np.abs(x_lib).max())
    corr = float(np.corrcoef(dump, beta)[0, 1])
    log(f"  {len(names)} files written; launches {launches}; max|dump - "
        f"library x1| / max|x1| = {d:.3e}; corr(x_hat, beta) {corr:.5f} "
        f"(limit 0.8); covariate effects {state.cov_eff.tolist()} (truth "
        f"[0.4, -0.4])")
    if not launches["axm_i8"] or launches["axm_i8a"]:
        raise AssertionError("the probit CLI run did not take the general "
                             "kernels")
    if not (d < 1e-6 and corr > 0.8):
        raise AssertionError("the probit CLI flow missed its expectations")


def phase_cli_restart():
    """--checkpoint and --run-mode restart through the CLI on the card, on
    the flagship genotypes (2% missing calls): for --model robust, linear
    and bin_class, 3 iterations with --checkpoint, then restart --resume for
    3 more, whose iteration-6 dump must equal a 6-iteration run's bit for
    bit; then the linear estimate-file restart (r1 from the 3-iteration
    dump, --gam1-init / --gamw-init), its dump equal to a library run."""
    log("== phase 6r: CLI --checkpoint and --run-mode restart, 2% missing")
    from gvamp_tpu_torch import cli, linear, sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.io import plink, vecio
    from gvamp_tpu_torch.ops import matvec
    N, M = 800, 240
    prior = ["--probs", "0.95,0.05", "--vars", "0.0,0.0667"]
    with tempfile.TemporaryDirectory() as tmp:
        bed, phen, _, beta = flagship_files(tmp, N, M)
        g = GenoBed.from_files(bed, None, N=N, Mt=M, device="cuda",
                               standardize_phen=False)
        rng = np.random.default_rng(8)
        phens = {"linear": phen,
                 "robust": os.path.join(tmp, "robust.phen"),
                 "bin_class": os.path.join(tmp, "cc.phen")}
        plink.write_phen(phens["robust"], huber_phenotype(g, beta, rng))
        plink.write_phen(phens["bin_class"], sim.simulate_probit_phenotype(
            g, beta, 0.2, rng))
        out = os.path.join(tmp, "out")
        ck = os.path.join(tmp, "ck.npz")
        for model in ("robust", "linear", "bin_class"):
            base = ["--device", "cuda", "--model", model, "--bed-file", bed,
                    "--phen-files", phens[model], "--N", str(N), "--Mt",
                    str(M), "--rho", "0.3", "--stop-criteria-thr", "0",
                    "--verbosity", "0", "--out-dir", out] + prior
            if model == "bin_class":
                base += ["--probit-var", "0.2"]
            matvec.reset_launches()
            cli.main(["--run-mode", "infere", "--iterations", "6",
                      "--out-name", f"{model}_full"] + base)
            cli.main(["--run-mode", "infere", "--iterations", "3",
                      "--checkpoint", ck, "--out-name", f"{model}_part"]
                     + base)
            t0 = time.perf_counter()
            cli.main(["--run-mode", "restart", "--resume", ck,
                      "--iterations", "3", "--out-name", f"{model}_part"]
                     + base)
            t_resume = time.perf_counter() - t0
            launches = dict(matvec.LAUNCHES)
            check_launches(f"CLI {model} restart", launches,
                           ("axm_i8", "atxm_i8"), ("axm_i8a", "atxm_i8a"))
            tag = cli._TAGS[model]
            full = vecio.read_bin_shard(
                os.path.join(out, f"{model}_full{tag}_it_6.bin"), M, 0)
            part = vecio.read_bin_shard(
                os.path.join(out, f"{model}_part{tag}_it_6.bin"), M, 0)
            d = float(np.abs(part - full).max())
            log(f"  {model}: resumed run {t_resume:.2f} s; iteration-6 dump "
                f"of 3 + checkpoint + 3 against 6 in one run: max|diff| "
                f"{d:.3e}, equal: {np.array_equal(part, full)}; corr(x_hat, "
                f"beta) {float(np.corrcoef(full, beta)[0, 1]):.5f}")
            if not (np.isfinite(full).all() and np.array_equal(part, full)):
                raise AssertionError(f"CLI {model}: the resumed run differs "
                                     f"from the uninterrupted one")
        est = os.path.join(out, "linear_part_it_3.bin")
        cli.main(["--device", "cuda", "--run-mode", "restart",
                  "--estimate-file", est, "--gam1-init", "0.5",
                  "--gamw-init", "1.7", "--model", "linear", "--bed-file",
                  bed, "--phen-files", phen, "--N", str(N), "--Mt", str(M),
                  "--rho", "0.3", "--iterations", "3", "--verbosity", "0",
                  "--out-dir", out, "--out-name", "re"] + prior)
        dump = vecio.read_bin_shard(os.path.join(out, "re_it_3.bin"), M, 0)
        g = GenoBed.from_files(bed, phen, N=N, Mt=M, device="cuda")
        x_lib, _, _ = linear.infer(
            g, linear.VampConfig(max_iter=3, rho=0.3, gam1_init=0.5,
                                 gamw_init=1.7), [0.95, 0.05], [0.0, 0.0667],
            verbose=False, r1_init=vecio.read_estimate(est, M, 0))
    d = float(np.abs(dump - x_lib).max() / np.abs(x_lib).max())
    log(f"  linear restart from an estimate file: max|dump - library x1| / "
        f"max|x1| = {d:.3e}; corr(x_hat, beta) "
        f"{float(np.corrcoef(dump, beta)[0, 1]):.5f}")
    if not (np.isfinite(dump).all() and d < 1e-6):
        raise AssertionError("the estimate-file restart differs from the "
                             "library run")


# --------------------------------------------------------------------------
# multi-trait runs (phases 4t, 4tm, 5t, 6t)
# --------------------------------------------------------------------------

# The traits of phases 4t / 4tm: bench.py:89-111's recipe (two-group prior,
# 1,000 causal markers) with one seed and h2 per trait, and 0-5% NA
# phenotypes spread over the linear traits; the engine's prior is that of
# h2 = 0.5 for every trait.  MULTI_CORR_MIN, on every trait's corr(x_hat,
# beta) after its run, set before the first H100 run of these phases below
# the single-trait readings at config B (linear 0.9958, probit 0.99173,
# Huber 0.8739 after 10 iterations; PERF.md), with room for the traits of
# lower h2 and for the shorter runs
MULTI_H2 = (0.5, 0.3, 0.7, 0.4, 0.6, 0.35, 0.65, 0.45)
MULTI_NA_MAX = 0.05
MULTI_CORR_MIN = {"linear": 0.9, "bin_class": 0.9, "robust": 0.8}
MULTI_SCALARS = {"linear": ("gam1", "gam2", "gamw", "alpha2"),
                 "bin_class": ("gam1", "gam2", "tau1", "tau2", "alpha2"),
                 "robust": ("gam1", "gam2", "tau1", "tau2", "alpha2")}


def multi_traits(geno, model, T, seed, na_max=0.0):
    """T phenotypes of ``model`` on ``geno``: trait t draws its effects
    from the two-group prior of h2 = MULTI_H2[t] and, for the linear
    model, loses a share na_max * t / (T - 1) of its phenotypes to NA.
    Returns (ys, betas)."""
    from gvamp_tpu_torch import sim
    rng = np.random.default_rng(seed)
    n, m = geno.N, geno.M
    ys, betas = [], []
    for t in range(T):
        h2 = MULTI_H2[t % len(MULTI_H2)]
        vars_t, probs_t = sim.two_group_prior(m, 1000, h2)
        beta = sim.simulate_mixture(rng, m, vars_t, probs_t)
        if model == "linear":
            y = sim.simulate_linear_phenotype(geno, beta, 1 / (1 - h2), rng)
            n_na = int(na_max * t / max(T - 1, 1) * n)
            y[rng.choice(n, n_na, replace=False)] = np.nan
        elif model == "bin_class":
            y = sim.simulate_probit_phenotype(geno, beta, 1 - h2, rng)
        else:
            y = huber_phenotype(geno, beta, rng)
        ys.append(y)
        betas.append(beta)
    return ys, betas


def build_multi(geno, ys, model, label):
    """MultiPhen.build with its T statistics passes timed."""
    from gvamp_tpu_torch import multi
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mp = multi.MultiPhen.build(geno, ys, standardize=model != "bin_class")
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    nas = [int(geno.N - n) for n in mp.nonas]
    log(f"  {label}: {mp.T} statistics passes {t:.2f} s ({t / mp.T:.2f} s "
        f"each); NA phenotypes per trait {nas}")
    return mp


def multi_cfg(model, n_it):
    """bench.py's settings (rho 0.15, gam1 1e-8, gamw 2) for the linear
    model, phase 4p's for probit and phase 4h's for Huber."""
    from gvamp_tpu_torch import linear, probit, robust
    if model == "linear":
        return linear.VampConfig(max_iter=n_it, rho=0.15, gam1_init=1e-8,
                                 gamw_init=2.0)
    if model == "bin_class":
        return probit.ProbitConfig(max_iter=n_it, probit_var=0.5)
    return robust.RobustConfig(max_iter=n_it, rho=0.15, stab_gamma=1.0,
                               stop_criteria_thr=0.0)


def run_multi(mp, model, cfg, prior, betas, label, x1_at=None):
    """One multi-trait run: the set-up left after the statistics (probe,
    A_t^T y_t, the T*P-column SLQ basis), each iteration's ms, CG count per
    trait and host syncs, each trait's corr(x_hat, beta), the peak memory
    and the launch counts; checks that every value is finite, that the run
    went on past iteration 5 or to its end, and every corr against
    MULTI_CORR_MIN.  ``prior`` is the engine's (probs, vars) for every
    trait; ``x1_at`` keeps x1 and the metrics of that iteration.  Returns
    (x_hat, history, launches, kept)."""
    from gvamp_tpu_torch import multi
    from gvamp_tpu_torch.ops import matvec
    run = {"linear": multi.infer, "bin_class": multi.infer_probit,
           "robust": multi.infer_huber}[model]
    kept = {}

    def keep(it, state, m, g):
        if it == x1_at:
            kept.update(x1=state.x1[: g.M].double().cpu().numpy(), m=m)

    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    t0 = time.perf_counter()
    x_hat, _, hist = clocked(run, mp, cfg, *prior, verbose=False,
                             callbacks=[keep])
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = dict(matvec.LAUNCHES)
    t_iters = sum(h["host_ms"] for h in hist[1:]) / 1e3
    log(f"  {label}: infer {t_all:.2f} s, iteration 1's host_ms holds the "
        f"set-up (probe, A_t^T y_t, SLQ basis at {mp.T * cfg.n_probes} "
        f"columns); iterations 2-{len(hist)} in {t_iters:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    extra = {"linear": "R2_train_1", "bin_class": "beta1",
             "robust": "deltaH"}[model]
    log(f"  it    host_ms  syncs  cg per trait / {extra} per trait")
    for h in hist:
        log(f"  {h['it']:2d} {h['host_ms']:10.2f} {h['host_syncs']:6d}  "
            f"{' '.join(f'{c:2d}' for c in h['cg_iters'])} / "
            + " ".join(f"{float(v):.4g}" for v in h[extra]))
    corrs = [float(np.corrcoef(x_hat[:, t], b)[0, 1])
             for t, b in enumerate(betas)]
    log(f"  corr(x_hat_t, beta_t): {' '.join(f'{c:.5f}' for c in corrs)} "
        f"(floor {MULTI_CORR_MIN[model]}); median "
        f"{np.median([h['host_ms'] for h in hist[2:]] or [0]):.2f} ms/it "
        f"from iteration 3; stopped {hist[-1]['stopped'].tolist()}")
    keys = MULTI_SCALARS[model]
    if not (np.isfinite(x_hat).all() and all(
            np.isfinite(h[k]).all() for h in hist for k in keys)):
        raise AssertionError(f"{label}: non-finite values")
    if len(hist) < min(cfg.max_iter, 5):
        raise AssertionError(f"{label}: stopped after {len(hist)} "
                             f"iterations")
    if not min(corrs) >= MULTI_CORR_MIN[model]:
        raise AssertionError(f"{label}: corr(x_hat, beta) {corrs} below "
                             f"{MULTI_CORR_MIN[model]}")
    return x_hat, hist, launches, kept


def multi_fused(mp, prior, betas, kept, label, complete):
    """The linear multi-trait run again for 3 iterations under
    GVAMP_FUSED_GRAM=1 (every CG product through gram_i8a, or gram_i8 with
    missing calls, with per-trait [4, Nb, B] NA masks), held against the
    two-pass run's third iteration ``kept``: x1 within FUSED_XTOL of
    max|x1|, the scalars within FUSED_RTOL.  Returns the launch counts."""
    a_only = ("axm_i8a", "atxm_i8a", "gram_i8a")
    general = ("axm_i8", "atxm_i8", "gram_i8")
    with fused_env():
        if mp.fn_gram() is None:
            raise AssertionError(f"{label}: the multi fn_gram refused the "
                                 f"words")
        x_f, h_f, launches, _ = run_multi(
            mp, "linear", multi_cfg("linear", 3), prior, betas,
            f"{label} fused")
    check_launches(f"{label} fused", launches,
                   a_only if complete else general,
                   general if complete else a_only)
    x3 = x_f * np.sqrt(mp.geno.N)
    dx = float(np.abs(x3 - kept["x1"]).max() / np.abs(kept["x1"]).max())
    log(f"  fused against two-pass at iteration 3: max|dx| / max|x| = "
        f"{dx:.3e} (limit {FUSED_XTOL:g})")
    if not dx < FUSED_XTOL:
        raise AssertionError(f"{label}: the fused run differs")
    for k in MULTI_SCALARS["linear"]:
        a, b = np.asarray(h_f[-1][k]), np.asarray(kept["m"][k])
        r = float(np.abs(a - b).max() / np.abs(b).min())
        log(f"  {k}: max relative difference {r:.3e} (limit {FUSED_RTOL:g})")
        if not r <= FUSED_RTOL:
            raise AssertionError(f"{label}: fused {k} differs")
    return launches


def phase_multi_b(geno):
    """Phase 4t: the multi-trait engines at config B on phase 4's words
    (complete genotypes): T = 8 linear traits for 10 iterations two-pass,
    then 3 under GVAMP_FUSED_GRAM=1 held against the two-pass run's third
    iteration; T = 4 binary traits for 10 iterations; T = 2 Huber traits
    for 5.  Each run's CG must launch axm_i8a / atxm_i8a (gram_i8a in the
    fused one) and no kernel of the two-plane form or of the tools.
    Returns {run: launch counts}."""
    from gvamp_tpu_torch import sim
    log("== phase 4t: multi-trait engines at config B (complete genotypes)")
    vars_t, probs_t = sim.two_group_prior(geno.M, 1000, 0.5)
    prior = (probs_t, vars_t)
    general = ("axm_i8", "atxm_i8", "gram_i8")
    counts = {}
    ys, betas = multi_traits(geno, "linear", 8, 11, MULTI_NA_MAX)
    mp = build_multi(geno, ys, "linear", "linear T=8")
    _, _, counts["linear"], kept = run_multi(
        mp, "linear", multi_cfg("linear", CFG_B_ITERS), prior, betas,
        "config B linear T=8 two-pass", x1_at=3)
    check_launches("config B linear T=8", counts["linear"],
                   ("axm_i8a", "atxm_i8a"), general + ("gram_i8a",))
    counts["linear fused"] = multi_fused(mp, prior, betas, kept,
                                         "config B linear T=8", True)
    for model, T, n_it, seed in (("bin_class", 4, CFG_B_ITERS, 12),
                                 ("robust", 2, 5, 13)):
        ys, betas = multi_traits(geno, model, T, seed)
        mp = build_multi(geno, ys, model, f"{model} T={T}")
        _, _, counts[model], _ = run_multi(
            mp, model, multi_cfg(model, n_it), prior, betas,
            f"config B {model} T={T}")
        check_launches(f"config B {model} T={T}", counts[model],
                       ("axm_i8a", "atxm_i8a"), general + ("gram_i8a",))
    return counts


def phase_multi_bm(geno):
    """Phase 4tm: T = 4 linear traits at config Bm on phase 4m's words
    (missing calls), 3 iterations through axm_i8 / atxm_i8 and no kernel
    of the one-plane form, then 3 through gram_i8 (held against the
    two-pass run).  Returns {run: launch counts}."""
    from gvamp_tpu_torch import sim
    log("== phase 4tm: multi-trait linear engine at config Bm (missing "
        "calls)")
    vars_t, probs_t = sim.two_group_prior(geno.M, 1000, 0.5)
    prior = (probs_t, vars_t)
    ys, betas = multi_traits(geno, "linear", 4, 14, MULTI_NA_MAX)
    mp = build_multi(geno, ys, "linear", "linear T=4")
    _, _, launches, kept = run_multi(mp, "linear", multi_cfg("linear", 3),
                                     prior, betas, "config Bm linear T=4",
                                     x1_at=3)
    check_launches("config Bm linear T=4", launches, ("axm_i8", "atxm_i8"),
                   ("axm_i8a", "atxm_i8a", "gram_i8a", "gram_i8"))
    return {"linear at Bm": launches,
            "linear fused at Bm": multi_fused(mp, prior, betas, kept,
                                              "config Bm linear T=4", False)}


# Card against CPU for the multi-trait engines (phase 5t), at the f32
# tolerances of tests/test_torch_multi*.py (port against JAX on the CPU):
# per model the limit on max|dx1| / max|x1| after the run, the relative
# limit on the scalars, and the iterations at which they are held.
# Huber: x1 at every iteration, deltaH equal at every iteration, the
# scalars at iterations 1-2: at iteration 3 alpha2 falls to 4e-5-6e-4,
# where the SLQ quadrature of 1 / (tau2 lam + gam2) at tau2 in the
# thousands rests on the smallest Ritz values, which the card's and the
# CPU's float32 Lanczos runs (other summation orders) place apart, and gam1
# = gam2 (1 - alpha2) / alpha2 carries it: the first H100 run read the
# scalars within 2.5e-6 at iterations 1-2, then alpha2 3.1e-5 and gam1
# 1.35e-4 apart at iteration 3, x1 within 2.2e-6 (PERF.md); the port's own
# float32 run is within 6.5e-7 of its float64 run there
MULTI_CARD_CPU = {"linear": (5e-5, 2e-4, 6), "bin_class": (1e-4, 5e-4, 6),
                  "robust": (1e-4, 1e-4, 2)}


def phase_card_vs_cpu_multi(model, miss_rate, use_slq=True):
    """Phase 5t: T = 3 traits of ``model`` on the card and on the CPU (the
    plain versions) from the same data and probe (and, for Huber, the
    same generator): linear at N=2,000 x M=4,096 (complete and 2% missing
    calls), probit with 2 covariates at N=6,000 x M=2,048, and Huber at
    N=1,500 x M=300 with 20 causal markers at h2 = 0.9, the stable recipe
    of tests/test_torch_multi_zmodel.py (at N=6,000 x M=2,048 with 40 two
    traits meet the clip by iteration 2, where the card's gam1 came out 45
    times the CPU's on the first H100 run, PERF.md).  use_slq=False: phase
    5q, T*P probe columns in the joint CG."""
    from gvamp_tpu_torch import multi, sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import matvec
    N, M = {"linear": (2000, 4096), "bin_class": (6000, 2048),
            "robust": (1500, 300)}[model]
    n_it = 6 if model != "robust" else 4
    label = (f"{model}, " + ("complete" if miss_rate == 0
                             else f"{miss_rate:.0%} missing")
             + (", 2 covariates" if model == "bin_class" else "")
             + (", use_slq=False" if not use_slq else ""))
    log(f"== phase {'5t' if use_slq else '5q'}: multi-trait card vs CPU, "
        f"T=3, N={N} x M={M}, {n_it} iterations, {label}")
    cfg = {"linear": multi_cfg("linear", n_it), "bin_class":
           multi_cfg("bin_class", n_it), "robust":
           multi_cfg("robust", n_it)}[model]
    cfg = dataclasses.replace(cfg, rho=0.3, seed=5, use_slq=use_slq)
    run = {"linear": multi.infer, "bin_class": multi.infer_probit,
           "robust": multi.infer_huber}[model]
    xtol, rtol, held = MULTI_CARD_CPU[model]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        bed, beta0, vars_t, probs_t, rng = small_problem(tmp, 9, N, M,
                                                         miss_rate)
        if model == "robust":
            vars_t, probs_t = sim.two_group_prior(M, 20, 0.9)
            beta0 = sim.simulate_mixture(rng, M, vars_t, probs_t)
        covs = rng.normal(size=(N, 2)) if model == "bin_class" else None
        ys = None
        for dev in ("cuda", "cpu"):
            g = GenoBed.from_files(bed, None, N=N, Mt=M, device=dev,
                                   standardize_phen=False)
            g.covs = covs
            if ys is None:
                betas = [beta0] + [sim.simulate_mixture(rng, M, vars_t,
                                                        probs_t)
                                   for _ in range(2)]
                ys = []
                for t, b in enumerate(betas):
                    if model == "linear":
                        y = sim.simulate_linear_phenotype(g, b, 2.0, rng)
                    elif model == "bin_class":
                        y = sim.simulate_probit_phenotype(
                            g, b, 0.5, rng, np.array([0.3, -0.3]))
                    else:
                        y = huber_phenotype(g, b, rng)
                    if t == 1:
                        y[rng.choice(N, N // 50, replace=False)] = np.nan
                    ys.append(y)
            mp = multi.MultiPhen.build(g, ys,
                                       standardize=model != "bin_class")
            xs = []
            t0 = time.perf_counter()
            matvec.reset_launches()
            x, _, hist = run(mp, cfg, probs_t, vars_t, verbose=False,
                             callbacks=[lambda it, s, m, g_: xs.append(
                                 s.x1.double().cpu().numpy())])
            check_no_tool_launches(f"multi card vs CPU, {dev}",
                                   matvec.LAUNCHES)
            out[dev] = x, hist, xs
            log(f"  {dev}: {time.perf_counter() - t0:.2f} s")
    (x_c, h_c, xs_c), (x_p, h_p, xs_p) = out["cuda"], out["cpu"]
    if not all(np.isfinite(v).all() for v in (x_c, x_p)):
        raise AssertionError("multi card vs CPU: non-finite x1")
    for i, (a, b) in enumerate(zip(xs_c, xs_p)):
        dx = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        rel = {k: float(np.abs(h_c[i][k] - h_p[i][k]).max()
                        / np.abs(h_p[i][k]).min())
               for k in MULTI_SCALARS[model]}
        held_x = model == "robust" or i == len(xs_p) - 1
        log(f"  it {i + 1}: max|x1 card - x1 cpu| / max|x1| = {dx:.3e}"
            + (f" (limit {xtol:g})" if held_x else "") + "; relative "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + (f" (limit {rtol:g})" if i < held else "")
            + f"; cg card {h_c[i]['cg_iters'].tolist()} cpu "
            f"{h_p[i]['cg_iters'].tolist()}")
        if (held_x and not dx <= xtol) or (
                i < held and not max(rel.values()) <= rtol):
            raise AssertionError(f"multi card vs CPU ({label}) disagree at "
                                 f"iteration {i + 1}")
        if model == "robust" and not np.array_equal(h_c[i]["deltaH"],
                                                    h_p[i]["deltaH"]):
            raise AssertionError(f"multi Huber: deltaH differs at "
                                 f"iteration {i + 1}")
    if model == "bin_class":
        ec, ep = h_c[-1]["cov_eff"], h_p[-1]["cov_eff"]
        log(f"  cov_eff card {ec.tolist()} cpu {ep.tolist()}")
        if not np.allclose(ec, ep, rtol=rtol, atol=rtol):
            raise AssertionError("multi card vs CPU: covariate effects differ")
    log("  corr(x_hat_t, beta_t) card "
        + " ".join(f"{float(np.corrcoef(x_c[:, t], b)[0, 1]):.5f}"
                   for t, b in enumerate(betas)))


def phase_cli_multi():
    """Phase 6t: the multi-trait CLI on the card on the flagship genotypes
    (2% missing calls), three traits per model: --model linear with
    --store-pvals 1 and a .bim (each trait's dumps, LOO / LOCO p-values and
    LOCO predictors), then for linear, bin_class and robust 3 iterations
    with --checkpoint and restart --resume for 3 more, every trait's
    iteration-6 dump equal bit for bit to a 6-iteration run's."""
    log("== phase 6t: multi-trait CLI, --store-pvals 1 and 3 + 3 restarts, "
        "2% missing")
    from gvamp_tpu_torch import cli, sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.io import plink, vecio
    from gvamp_tpu_torch.ops import matvec
    N, M, T = 800, 240, 3
    prior = ["--probs", "0.95,0.05", "--vars", "0.0,0.0667"]
    with tempfile.TemporaryDirectory() as tmp:
        bed, phen, bim, beta = flagship_files(tmp, N, M)
        g = GenoBed.from_files(bed, None, N=N, Mt=M, device="cuda",
                               standardize_phen=False)
        rng = np.random.default_rng(9)
        vars_t, probs_t = sim.two_group_prior(M, 12, 0.8)
        betas = [beta] + [sim.simulate_mixture(rng, M, vars_t, probs_t)
                          for _ in range(T - 1)]
        phens = {m: [] for m in ("linear", "bin_class", "robust")}
        for t, b in enumerate(betas):
            ys = {"linear": sim.simulate_linear_phenotype(g, b, 5.0, rng),
                  "bin_class": sim.simulate_probit_phenotype(g, b, 0.2, rng),
                  "robust": huber_phenotype(g, b, rng)}
            if t == 1:
                ys["linear"][rng.choice(N, 30, replace=False)] = np.nan
            for model, y in ys.items():
                phens[model].append(os.path.join(tmp, f"{model}{t}.phen"))
                plink.write_phen(phens[model][-1], y)
        out = os.path.join(tmp, "out")
        ck = os.path.join(tmp, "ck.npz")
        for model in ("linear", "bin_class", "robust"):
            base = ["--device", "cuda", "--model", model, "--bed-file", bed,
                    "--bim-file", bim, "--phen-files", ",".join(phens[model]),
                    "--N", str(N), "--Mt", str(M), "--rho", "0.3",
                    "--stop-criteria-thr", "0", "--verbosity", "0",
                    "--out-dir", out] + prior
            if model == "bin_class":
                base += ["--probit-var", "0.2"]
            matvec.reset_launches()
            t0 = time.perf_counter()
            cli.main(["--run-mode", "infere", "--iterations", "6",
                      "--out-name", f"{model}_full"] + base
                     + (["--store-pvals", "1"] if model == "linear" else []))
            t_full = time.perf_counter() - t0
            cli.main(["--run-mode", "infere", "--iterations", "3",
                      "--checkpoint", ck, "--out-name", f"{model}_part"]
                     + base)
            cli.main(["--run-mode", "restart", "--resume", ck,
                      "--iterations", "3", "--out-name", f"{model}_part"]
                     + base)
            check_launches(f"CLI multi {model}", dict(matvec.LAUNCHES),
                           ("axm_i8", "atxm_i8"), ("axm_i8a", "atxm_i8a"))
            tag = cli._TAGS[model]
            same, corrs = [], []
            for t in range(T):
                full = vecio.read_bin_shard(
                    os.path.join(out, f"{model}_full_phen{t}{tag}_it_6.bin"),
                    M, 0)
                part = vecio.read_bin_shard(
                    os.path.join(out, f"{model}_part_phen{t}{tag}_it_6.bin"),
                    M, 0)
                if not np.isfinite(full).all():
                    raise AssertionError(f"CLI multi {model}: non-finite")
                same.append(bool(np.array_equal(part, full)))
                corrs.append(float(np.corrcoef(full, betas[t])[0, 1]))
            log(f"  {model}: 6 iterations {t_full:.2f} s; iteration-6 dumps "
                f"of 3 + checkpoint + 3 equal to 6 in one run: {same}; "
                f"corr(x_hat_t, beta_t) {' '.join(f'{c:.5f}' for c in corrs)}")
            if not all(same):
                raise AssertionError(f"CLI multi {model}: the resumed run "
                                     f"differs from the uninterrupted one")
        pre = os.path.join(out, "linear_full")
        for t in range(T):
            p_loo = vecio.read_bin_shard(f"{pre}_phen{t}_pvals.bin", M, 0)
            p_loco = vecio.read_bin_shard(f"{pre}_phen{t}_pvals_LOCO.bin",
                                          M, 0)
            preds = [np.loadtxt(f"{pre}_phen{t}_LOCO_chr_{ch}.csv")
                     for ch in range(1, 5)]
            causal = betas[t] != 0
            log(f"  linear trait {t}: median causal LOO p "
                f"{float(np.median(p_loo[causal])):.3e}, null "
                f"{float(np.median(p_loo[~causal])):.4f}; LOCO "
                f"{float(np.median(p_loco[causal])):.3e}")
            if not (pvals_in_range(p_loo) and pvals_in_range(p_loco)):
                raise AssertionError("multi p-value files outside [0, 1]")
            if not np.median(p_loo[causal]) < np.median(p_loo[~causal]):
                raise AssertionError("multi LOO: causal markers not below "
                                     "the nulls")
            if not all(pr.shape[0] >= N and np.isfinite(pr).all()
                       for pr in preds):
                raise AssertionError("multi LOCO predictor files malformed")


# --------------------------------------------------------------------------
# the probe path, --red and the driver options (phases 3r, 4q, 4r, 6q)
# --------------------------------------------------------------------------

# the window starts of phase 3r: one inside (word row 4,384 at config B)
# and the last legal one, Nw - lbw
WINDOW_START = 32 * 137


def phase_kernels_window(words, label):
    """Phase 3r: the four engine digit products at B = 2 (the red solve's
    width at P = 1) on --red's window of ``words``,
    linear.red_window_words(Nw) word rows (2,048 of config B's 20,480) at
    WINDOW_START and at the last legal start: each bit for bit against its
    plain version on the same window, timed with CUDA events beside its
    bound on the window's shape, and beside the engine's windowed product
    (GenoBed.window_fns_multi, the wrapper's statistics and masks around
    the same kernel).  Its own generator, so that ``gen``'s draws stay
    those the engine phases' limits were set on."""
    from gvamp_tpu_torch import linear
    from gvamp_tpu_torch.data import GenoBed
    log(f"== phase 3r: digit products on --red's window, {label} words")
    nw, m = words.shape
    lbw = linear.red_window_words(nw)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    geno = GenoBed.from_device_words(
        words, np.zeros(16 * nw), N=16 * nw, M=m, standardize_phen=False,
        mave=np.full(m, 1.0, np.float32), msig=np.full(m, 0.5, np.float32))
    out = {}
    for sbw in (WINDOW_START, nw - lbw):
        win = words[sbw:sbw + lbw]
        res = check_kernels(win, 2, gen, f"{label} rows {sbw}+{lbw}",
                            names=DEFLATE_KERNELS, reps=5, plain_reps=1)
        for name, (err, ms, plain) in res.items():
            b_ms, b_by = bound(name, lbw, m, 2)
            log(f"    {name:9s} window {sbw}+{lbw}: {ms:.3f} ms, bound "
                f"{b_ms:.3f} ms by {b_by} ({b_ms / ms:.1%} of it)")
        out[sbw] = res
    axm_w, atxm_w = geno.window_fns_multi(lbw)
    X = torch.randn((m, 2), generator=gen, device="cuda")
    V = torch.randn((4, 4 * lbw, 2), generator=gen, device="cuda")
    t_f = cuda_ms(lambda: axm_w(geno.op, X, WINDOW_START))
    t_t = cuda_ms(lambda: atxm_w(geno.op, V, WINDOW_START))
    log(f"  window_fns_multi ({'a-only' if geno.geno_complete else 'general'}"
        f" route) B=2 at rows {WINDOW_START}+{lbw}: forward {t_f:.3f} ms, "
        f"transpose {t_t:.3f} ms (the wrapper's work around the kernel "
        f"included)")
    del geno
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def counted_windows(geno):
    """Count the engine's windowed passes on ``geno`` (its
    window_fns_multi wrapped for the block), beside the kernels' own
    launch counters."""
    calls = {"axm_w": 0, "atxm_w": 0}
    real = geno.window_fns_multi

    def wrapped(lbw):
        axm_w, atxm_w = real(lbw)

        def fwd(op, X, sbw):
            calls["axm_w"] += 1
            return axm_w(op, X, sbw)

        def tr(op, V, sbw):
            calls["atxm_w"] += 1
            return atxm_w(op, V, sbw)

        return fwd, tr

    geno.window_fns_multi = wrapped
    try:
        yield calls
    finally:
        del geno.window_fns_multi


def run_option(geno, beta, label, corr_min, prior, n_it=CFG_B_ITERS,
               **cfg_kw):
    """``n_it`` iterations of linear.infer at bench.py's settings with
    ``cfg_kw`` (use_slq=False, red=True, use_xxt=True): each iteration's
    ms, CG and probe iterations, host syncs and (under red) window start
    printed, then the steady-state median and corr(x_hat, beta); finite
    values and corr >= ``corr_min`` checked.  Returns (x_hat, history)."""
    from gvamp_tpu_torch import linear
    vars_t, probs_t = prior
    cfg = linear.VampConfig(max_iter=n_it, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0, **cfg_kw)
    t0 = time.perf_counter()
    x_hat, _, hist = clocked(linear.infer, geno, cfg, probs_t, vars_t,
                             verbose=False)
    t_all = time.perf_counter() - t0
    log(f"  {label}: infer {t_all:.2f} s, iteration 1's host_ms holds the "
        f"set-up (A^T y, A u" + (", no SLQ basis" if not cfg.use_slq
                                 or cfg.red else ", SLQ basis") + ")")
    log("  it    host_ms  cg  probe  syncs  window      gam1      gamw    "
        "alpha2  R2_train_1")
    for h in hist:
        log(f"  {h['it']:2d} {h['host_ms']:10.2f} {h['cg_iters']:3d} "
            f"{h['probe_iters']:6d} {h['host_syncs']:6d} "
            f"{str(h.get('red_sbw', '-')):>7s} {float(h['gam1']):9.4g} "
            f"{float(h['gamw']):9.4g} {float(h['alpha2']):9.4g} "
            f"{float(h['R2_train_1']):10.5f}")
    corr = float(np.corrcoef(x_hat, beta)[0, 1])
    med = float(np.median([h["host_ms"] for h in hist[2:]]))
    log(f"  {label}: steady-state (it 3-{len(hist)}) median {med:.2f} ms/it;"
        f" corr(x_hat, beta) {corr:.5f} (limit {corr_min}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    keys = ("gam1", "gam2", "gamw", "alpha2", "R2_train_1")
    if len(hist) != n_it or not (np.isfinite(x_hat).all() and all(
            np.isfinite(float(h[k])) for h in hist for k in keys)):
        raise AssertionError(f"{label}: non-finite values or a short run")
    if corr < corr_min:
        raise AssertionError(f"{label}: corr(x_hat, beta) {corr:.4f} < "
                             f"{corr_min}")
    return x_hat, hist


# corr(x_hat, beta) after 10 iterations of the probe path (phase 4q) and
# of --red (phase 4r) at config B / Bm, and of the dual probe path at
# config X: the probe path's limits are the SLQ path's CORR_MIN and
# X_CORR_MIN (the Hutchinson estimate is the SLQ quadrature's Monte-Carlo
# twin; the first H100 run gave the same corr as SLQ's at B, 0.99571);
# red's from the first H100 run (0.96179 at B, 0.96101 at Bm on
# --options' instances, PERF.md), with room for another instance
PROBE_CORR_MIN = CORR_MIN
RED_CORR_MIN = 0.9


def phase_probe_b(geno, problem):
    """Phase 4q at config B: the linear engine with use_slq=False, the
    Onsager term from one Hutchinson probe column riding the block CG, on
    phase 4's loaded problem; its launches must show the a-only kernels and
    nothing else.  Returns the launch counts."""
    log("== phase 4q: the probe path (use_slq=False) at config B")
    from gvamp_tpu_torch.ops import matvec
    beta, vars_t, probs_t = problem[:3]
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    run_option(geno, beta, "config B probe path", PROBE_CORR_MIN,
               (vars_t, probs_t), use_slq=False)
    launches = dict(matvec.LAUNCHES)
    check_launches("config B probe", launches, ("axm_i8a", "atxm_i8a"),
                   ("axm_i8", "atxm_i8", "gram_i8a", "gram_i8"))
    return launches


def phase_red(geno, problem, label, complete):
    """Phase 4r: --red (linear, 10 iterations) on ``geno``'s loaded
    problem: each iteration solves on a window of a tenth of the sample
    word rows.  The launch counters and the windowed-pass counts show that
    every pass but the set-up's A^T y and A u and each iteration's
    full-data noise pass [x2, x1] ran on the window, 2 + n passes each way
    per iteration for n CG iterations, through the route's digit products
    and no tool-only kernel.  Returns the launch counts."""
    log(f"== phase 4r: --red at {label}")
    from gvamp_tpu_torch.ops import matvec
    beta, vars_t, probs_t = problem[:3]
    fwd, tr = ("axm_i8a", "atxm_i8a") if complete else ("axm_i8", "atxm_i8")
    other = ("axm_i8", "atxm_i8") if complete else ("axm_i8a", "atxm_i8a")
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    with counted_windows(geno) as calls:
        _, hist = run_option(geno, beta, f"{label} red", RED_CORR_MIN,
                             (vars_t, probs_t), red=True)
    launches = dict(matvec.LAUNCHES)
    check_launches(f"{label} red", launches, (fwd, tr),
                   other + ("gram_i8a", "gram_i8"))
    loops = [max(h["cg_iters"], h["probe_iters"]) for h in hist]
    want = sum(2 + n for n in loops)
    log(f"  windowed passes: forward {calls['axm_w']}, transpose "
        f"{calls['atxm_w']} (2 + CG loop {loops} each per iteration: "
        f"{want}); {fwd} launches {launches[fwd]}, {tr} {launches[tr]}; "
        f"window starts {[h['red_sbw'] for h in hist]}")
    if not (calls["axm_w"] == calls["atxm_w"] == want
            and launches[tr] == want + 1
            and launches[fwd] == want + 1 + len(hist)):
        raise AssertionError(f"{label} red: a CG pass left the window: "
                             f"{calls}, {launches}")
    return launches


def phase_probe_dual_x(geno, beta, vars_t, probs_t):
    """Phase 4q at config X: the dual solve with use_slq=False, its probe
    column z_u = A u riding the N-space block CG through the fused dual
    Gram, held to X_CORR_MIN.  Returns the launch counts."""
    log("== phase 4q: the dual probe path (use_xxt, use_slq=False) at "
        "config X")
    from gvamp_tpu_torch.ops import matvec
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    run_option(geno, beta, "config X dual probe path", X_CORR_MIN,
               (vars_t, probs_t), use_xxt=True, use_slq=False)
    launches = dict(matvec.LAUNCHES)
    check_launches("config X dual probe", launches,
                   ("gram_aat_i8a", "ax"), ("gram_aat_i8", "axm_i8",
                                            "atxm_i8"))
    return launches


def flagship_cli_args(bed, phen, bim, N, M, out, name, n_it, pvals=False):
    """The flagship linear CLI run, the stopping test off; ``pvals`` adds
    ``--run-mode infere --store-pvals 1`` (phase 6's recipe)."""
    return (["--device", "cuda", "--model", "linear", "--bed-file", bed,
             "--phen-files", phen, "--bim-file", bim, "--N", str(N), "--Mt",
             str(M), "--iterations", str(n_it), "--rho", "0.3",
             "--stop-criteria-thr", "0", "--probs", "0.95,0.05", "--vars",
             "0.0,0.0667", "--verbosity", "0", "--out-dir", out,
             "--out-name", name]
            + (["--run-mode", "infere", "--store-pvals", "1"] if pvals
               else []))


# the names of the port's CUDA kernels in a profiler trace (csrc/)
KERNEL_SYMBOLS = ("axm_i8_kernel", "atxm_i8_kernel", "atx_kernel",
                  "ax_kernel", "gram_aat_kernel", "gram_prim_kernel")


def phase_cli_options():
    """Phase 6q: the driver and probe-path flags through the CLI on the
    card, on the flagship genotypes (2% missing calls): --sync-every 3
    against --sync-every 1 at 4 iterations (3 does not divide it, the
    stopping test off), bit for bit; --phase-timers 1 (one line of the
    five phase times per iteration, the estimate equal to the untimed
    run's); --store-pip 1 (values in [0, 1], the causal markers' median
    above the nulls'); --profile-dir (a Chrome trace naming the port's
    kernels); and --use-slq 0 with --checkpoint at 3 iterations, then
    restart --resume for 3 more, equal bit for bit to 6 in one run."""
    log("== phase 6q: CLI --sync-every, --phase-timers, --store-pip, "
        "--profile-dir, --use-slq 0 with restart")
    import io
    from gvamp_tpu_torch import cli
    from gvamp_tpu_torch.io import vecio
    from gvamp_tpu_torch.ops import matvec
    N, M = 800, 240
    with tempfile.TemporaryDirectory() as tmp:
        bed, phen, bim, beta = flagship_files(tmp, N, M)
        out = os.path.join(tmp, "out")

        def args(name, n_it, *extra):
            return (["--run-mode", "infere"]
                    + flagship_cli_args(bed, phen, bim, N, M, out, name,
                                        n_it) + list(extra))

        def dump(name, it):
            return vecio.read_bin_shard(os.path.join(out, f"{name}_it_{it}"
                                                          f".bin"), M, 0)

        matvec.reset_launches()
        cli.main(args("one", 4))
        cli.main(args("three", 4, "--sync-every", "3"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(args("timed", 4, "--phase-timers", "1", "--verbosity",
                          "1"))
        phase_lines = [ln for ln in buf.getvalue().splitlines()
                       if "lmmse_cg=" in ln]
        cli.main(args("pip", 4, "--store-pip", "1"))
        prof = os.path.join(tmp, "prof")
        cli.main(args("prof", 2, "--profile-dir", prof))
        ck = os.path.join(tmp, "ck.npz")
        cli.main(args("slq0", 6, "--use-slq", "0"))
        cli.main(args("part", 3, "--use-slq", "0", "--checkpoint", ck))
        cli.main(["--run-mode", "restart", "--resume", ck]
                 + flagship_cli_args(bed, phen, bim, N, M, out, "part", 3))
        check_no_tool_launches("CLI options", matvec.LAUNCHES)
        one, three, timed = dump("one", 4), dump("three", 4), dump("timed", 4)
        early = [os.path.exists(os.path.join(out, f"three_it_{i}.bin"))
                 for i in (1, 2, 3)]
        pip = vecio.read_bin_shard(os.path.join(out, "pip_pip.bin"), M, 0)
        with open(os.path.join(prof, "trace.json")) as f:
            trace = f.read()
        full, part = dump("slq0", 6), dump("part", 6)
    log(f"  --sync-every 3 against 1 at 4 iterations: equal "
        f"{np.array_equal(three, one)}; dumps at iterations 1-3 {early}")
    if not (np.array_equal(three, one) and early == [False, False, True]):
        raise AssertionError("--sync-every 3 differs from single steps or "
                             "dumped inside a chunk")
    log(f"  --phase-timers: {len(phase_lines)} phase lines, first "
        f"{phase_lines[0].strip() if phase_lines else None}; estimate equal "
        f"to the untimed run: {np.array_equal(timed, one)}")
    names = ("denoise", "z1_project", "lmmse_cg", "noise_em", "finish")
    if not (len(phase_lines) == 4 and all(f"{n}=" in phase_lines[0]
                                          for n in names)
            and np.array_equal(timed, one)):
        raise AssertionError("--phase-timers missed its lines or changed "
                             "the run")
    causal = beta != 0
    log(f"  --store-pip: pip in [{pip.min():.3g}, {pip.max():.3g}], median "
        f"causal {np.median(pip[causal]):.3g}, null "
        f"{np.median(pip[~causal]):.3g}")
    if not (np.all((pip >= 0) & (pip <= 1))
            and np.median(pip[causal]) > np.median(pip[~causal])):
        raise AssertionError("--store-pip values out of [0, 1] or not "
                             "higher on the causal markers")
    found = [s for s in KERNEL_SYMBOLS if s in trace]
    log(f"  --profile-dir: trace.json {len(trace)} bytes, kernels named "
        f"{found}")
    if not found:
        raise AssertionError("the profiler trace names none of the port's "
                             "kernels")
    log(f"  --use-slq 0: 3 + checkpoint + restart --resume 3 against 6 in "
        f"one run: equal {np.array_equal(part, full)}; corr(x_hat, beta) "
        f"{float(np.corrcoef(full, beta)[0, 1]):.5f}")
    if not (np.isfinite(full).all() and np.array_equal(part, full)):
        raise AssertionError("the probe-path resume differs from the "
                             "uninterrupted run")


def phase_options_alone():
    """--options: phases 3r, 4q at config B, 4r, 5q and 6q on instances of
    their own (the configurations drawn one after the other from one
    generator), with an SLQ run beside the probe run at B for comparison
    in one call.  The dual probe path at config X runs only in the full
    run, on the instance X_CORR_MIN was set on (phase 4x)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    words = synth_words(gen, False, CFG_B_N, CFG_B_M)
    phase_kernels_window(words, "config B")
    geno, beta, vars_t, probs_t = make_problem(words, "config B", True)
    log("== the SLQ path at config B, beside phase 4q")
    run_option(geno, beta, "config B SLQ", CORR_MIN, (vars_t, probs_t))
    phase_probe_b(geno, (beta, vars_t, probs_t))
    phase_red(geno, (beta, vars_t, probs_t), "config B", True)
    del words, geno
    torch.cuda.empty_cache()
    words = synth_words(gen, True, CFG_B_N, CFG_B_M)
    phase_kernels_window(words, "config Bm")
    geno, beta, vars_t, probs_t = make_problem(words, "config Bm", False)
    phase_red(geno, (beta, vars_t, probs_t), "config Bm", False)
    del words, geno
    torch.cuda.empty_cache()
    phase_card_vs_cpu_options()
    phase_cli_options()


def phase_card_vs_cpu_options():
    """Phase 5q: the linear primal (2% missing) and dual (complete) probe
    paths, red complete and with 2% missing calls, probit (2% missing, 2
    covariates) and Huber (complete) on the probe path, and the T = 3
    linear multi-trait run on it, card against CPU."""
    phase_card_vs_cpu(0.02, use_slq=False)
    phase_card_vs_cpu(0.0, use_xxt=True, use_slq=False)
    phase_card_vs_cpu(0.0, red=True)
    phase_card_vs_cpu(0.02, red=True)
    phase_card_vs_cpu_probit(0.02, 2, use_slq=False)
    phase_card_vs_cpu_huber(0.0, 0, use_slq=False)
    phase_card_vs_cpu_multi("linear", 0.0, use_slq=False)


# --------------------------------------------------------------------------
# the run modes, cross-validation and the dense path (phases 4c, 4v, 4d,
# 5v, 6v)
# --------------------------------------------------------------------------

# phase 4c, cross-validated infere at config B on phase 4's instance: the
# training window is 98% of the people, so corr(x_hat, beta) stays near the
# full fit's 0.996 (PERF.md); set before the first H100 run of this phase
CV_CORR_MIN = 0.98
# phase 4v: the estimates of phase 4m's last iterations that the run modes
# score, test and predict from
MODES_SERIES = 3
# phase 4v: each score against phase 4m's R2_train_1 at the same iteration:
# 1 - |y - A x|^2 / (N var(y)) against 1 - |y - A x|^2 / |y|^2, y not
# centred (mean ~0: the denominators differ by about N mean(y)^2, a share
# ~1/N of them)
SCORE_R2_TOL = 1e-3
# phase 4d: the dense methylation path, N = 8,192 people x the 485,577
# probes of the Illumina HumanMethylation450 array; X standard normal per
# probe, bench.py's phenotype recipe (1,000 causal probes, h2 = 0.5).
# N / M = 0.017 leaves the effects poorly determined (config X, N / M =
# 0.01, reads 0.38), so the floor only catches a broken product
DENSE_N, DENSE_M = 8192, 485_577
DENSE_CORR_MIN = 0.2
# phase 5v: state_evolution from the same draws on the card and the CPU,
# float32 (tests/test_torch_crossval.py holds it against JAX within 1e-6)
SE_CARD_CPU_TOL = 1e-6


def retries(hist, rho0):
    """Each iteration's rejected tries of the damping tuner: rho_cross =
    rho 0.9^k, rho the previous iteration's (``rho0`` at iteration 1)."""
    out, rho = [], rho0
    for h in hist:
        out.append(int(round(np.log(float(h["rho_cross"]) / rho)
                             / np.log(0.9))))
        rho = float(h["rho"])
    return out


def phase_cross_val_b(geno, problem):
    """Phase 4c: 10 cross-validated iterations (use_cross_val: 98% of the
    people train, 2% are held out to re-damp x1 while their R2 falls) on
    phase 4's instance; each iteration's cv_r2, rho_cross, retries, host
    syncs and ms, the median beside phase 4's, corr(x_hat, beta) and the
    launches, which must show the a-only kernels and nothing else."""
    log("== phase 4c: cross-validated linear VAMP at config B")
    from gvamp_tpu_torch import linear
    from gvamp_tpu_torch.ops import matvec
    beta, vars_t, probs_t, _, hist4 = problem
    cfg = linear.VampConfig(max_iter=CFG_B_ITERS, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0, use_cross_val=True)
    matvec.reset_launches()
    t0 = time.perf_counter()
    x_hat, _, hist = clocked(linear.infer, geno, cfg, probs_t, vars_t,
                             verbose=False)
    t_infer = time.perf_counter() - t0
    launches = dict(matvec.LAUNCHES)
    log(f"  set-up and {len(hist)} iterations {t_infer:.2f} s")
    log("  it     cv_r2  rho_cross  retries  R2_train_1  cg   host_ms  syncs")
    for h, k in zip(hist, retries(hist, cfg.rho)):
        log(f"  {h['it']:2d} {float(h['cv_r2']):9.5f} "
            f"{float(h['rho_cross']):10.5f} {k:8d} "
            f"{float(h['R2_train_1']):11.5f} {h['cg_iters']:4d} "
            f"{h['host_ms']:9.2f} {h['host_syncs']:6d}")
    med = float(np.median([h["host_ms"] for h in hist[2:]]))
    med4 = float(np.median([h["host_ms"] for h in hist4[2:]]))
    corr = float(np.corrcoef(x_hat, beta)[0, 1])
    log(f"  steady-state median {med:.2f} ms/it against phase 4's "
        f"{med4:.2f}; corr(x_hat, beta) = {corr:.5f} (limit {CV_CORR_MIN})")
    if not (np.isfinite(x_hat).all() and all(
            np.isfinite(float(h["cv_r2"])) for h in hist)):
        raise AssertionError("cross-validation: non-finite values")
    if not corr >= CV_CORR_MIN:
        raise AssertionError(f"cross-validation: corr {corr:.4f}")
    check_launches("config B cross-validation", launches,
                   ("axm_i8a", "atxm_i8a"),
                   ("axm_i8", "atxm_i8", "gram_i8a", "gram_i8"))
    return launches


def phase_modes_bm(geno, problem, run_bm):
    """Phase 4v: the run modes' work at full width on phase 4m's container
    (config Bm, built in memory): the last MODES_SERIES estimates of its
    run written to a temporary directory and read back as a series
    (cli._estimate_series), then scored (cli.score_series, each R2 within
    SCORE_R2_TOL of 4m's R2_train_1 at that iteration), pvals-calc's LOO
    over all of them in one pass (the last estimate's file equal to 4m's
    loo_pvals within CARD_CPU_LOG10P_TOL) and LOCO for the last one (the
    same against 4m's loco_pvals), and the matrix prediction (its last
    column against 4m's A x1); the seconds of each, and the launches,
    which must show axm_i8 and nothing of the tools."""
    log("== phase 4v: the run modes at config Bm on phase 4m's container")
    from gvamp_tpu_torch import cli
    from gvamp_tpu_torch.io import vecio
    from gvamp_tpu_torch.ops import matvec
    hist = problem[4]
    its = sorted(run_bm["ests"])
    matvec.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for it in its:
            vecio.write_bin_shard(os.path.join(tmp, f"bm_it_{it}.bin"),
                                  run_bm["ests"][it], 0)
        opt = argparse.Namespace(test_iter_range=(its[0], its[-1]),
                                 estimate_file=os.path.join(
                                     tmp, f"bm_it_{its[0]}.bin"))
        series = list(cli._estimate_series(opt, geno.M, geno.S))
        ests = [e for _, e in series]
        t0 = time.perf_counter()
        scores = []
        for it, est in series:
            with contextlib.redirect_stdout(io.StringIO()):
                scores.append(cli.score_series(geno, [(it, est)])[0])
        t_score = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_loo, _ = cli.pvals_series(geno, ests)
        torch.cuda.synchronize()
        t_loo = time.perf_counter() - t0
        path = os.path.join(tmp, f"bm_it_{its[-1]}_pvals.bin")
        vecio.write_bin_shard(path, p_loo[-1], 0)
        p_file = vecio.read_bin_shard(path, geno.M, 0)
        t0 = time.perf_counter()
        _, p_loco = cli.pvals_series(geno, ests[-1:], loo=False,
                                     chroms=1 + np.arange(CFG_B_M)
                                     * BM_CHROMS // CFG_B_M)
        t_loco = time.perf_counter() - t0
        t0 = time.perf_counter()
        zs = cli.predict_series(geno, ests)
        t_pred = time.perf_counter() - t0
    launches = dict(matvec.LAUNCHES)
    log(f"  series of {len(series)} estimates (iterations {its}): scoring "
        f"{t_score:.2f} s, LOO over the series {t_loo:.2f} s, LOCO for it "
        f"{its[-1]} {t_loco:.2f} s, matrix prediction {t_pred:.2f} s")
    for it, sc in zip(its, scores):
        r2 = float(hist[it - 1]["R2_train_1"])
        log(f"  it {it}: score {sc:.6f}, R2_train_1 {r2:.6f} (limit "
            f"{SCORE_R2_TOL:g})")
        if not abs(sc - r2) < SCORE_R2_TOL:
            raise AssertionError(f"run-mode score at it {it} is off")
    tiny = np.finfo(np.float64).tiny  # p-values that underflowed to 0
    for name, got, want in (("LOO", p_file, run_bm["p_loo"]),
                            ("LOCO", p_loco[0], run_bm["p_loco"])):
        lg, lw = (np.log10(np.maximum(p, tiny)) for p in (got, want))
        d = float((np.abs(lg - lw) / np.maximum(1.0, -lw)).max())
        log(f"  {name} of it {its[-1]} against phase 4m's: max |dlog10 p| / "
            f"max(1, |log10 p|) = {d:.3e} (limit {CARD_CPU_LOG10P_TOL:g})")
        if not (pvals_in_range(got) and d <= CARD_CPU_LOG10P_TOL):
            raise AssertionError(f"pvals-calc {name} differs from phase 4m")
    z = run_bm["z1"]
    dz = float(np.abs(zs[:, -1] - z).max() / np.abs(z).max())
    log(f"  prediction [{zs.shape[0]}, {zs.shape[1]}]: last column against "
        f"phase 4m's A x1: max|diff| / max = {dz:.3e} (limit 1e-6)")
    if not (zs.shape == (CFG_B_N, len(series)) and dz < 1e-6):
        raise AssertionError("the matrix prediction is off")
    check_launches("run modes at config Bm", launches, ("axm_i8",),
                   ("axm_i8a", "atxm_i8a", "gram_i8a", "gram_i8"))
    return launches


def phase_dense():
    """Phase 4d: the dense methylation path at DENSE_N x DENSE_M (Mpad
    485,584, 15.9 GB of float32 on the card): X drawn on the card from a
    seeded generator and standardised per probe, GenoDense.from_device (no
    host copy), bench.py's phenotype on that X, then 10 linear iterations;
    the statistics' seconds, each iteration's ms, corr(x_hat, beta) and
    the peak memory.  No kernel of the port runs here: the products are
    torch.matmul, as JAX's are plain XLA.  X is freed at the end."""
    log(f"== phase 4d: dense methylation path, N={DENSE_N} x M={DENSE_M}")
    from gvamp_tpu_torch import linear, sim
    from gvamp_tpu_torch.data import GenoDense
    from gvamp_tpu_torch.ops import matvec
    N, M = DENSE_N, DENSE_M
    Mpad = (M + 7) // 8 * 8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X = torch.zeros((Mpad, N), device="cuda")
    for lo in range(0, M, 16_384):
        x = torch.randn((min(M, lo + 16_384) - lo, N), generator=gen,
                        device="cuda")
        X[lo:lo + x.shape[0]] = ((x - x.mean(dim=1, keepdim=True))
                                 / x.std(dim=1, keepdim=True))
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    geno = GenoDense.from_device(X, np.zeros(N), N=N, M=M,
                                 standardize_phen=False)
    torch.cuda.synchronize()
    t_stats = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    vars_t, probs_t = sim.two_group_prior(M, 1000, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    t0 = time.perf_counter()
    geno.set_phen(sim.simulate_linear_phenotype(geno, beta, 2.0, rng))
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    log(f"  X drawn and standardised {t_draw:.2f} s ({Mpad * N * 4 / 1e9:.2f}"
        f" GB); statistics {t_stats:.2f} s; phenotype + statistics "
        f"{t_sim:.2f} s")
    matvec.reset_launches()
    cfg = linear.VampConfig(max_iter=CFG_B_ITERS, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0)
    t0 = time.perf_counter()
    x_hat, _, hist = clocked(linear.infer, geno, cfg, probs_t, vars_t,
                             verbose=False)
    t_infer = time.perf_counter() - t0
    log(f"  infer {t_infer:.2f} s; iteration 1's host_ms holds the set-up "
        f"(SLQ basis, A^T y, A u)")
    for h in hist:
        log(f"  {h['it']:2d} gam1 {float(h['gam1']):11.5g} gamw "
            f"{float(h['gamw']):9.5g} R2_train_1 {float(h['R2_train_1']):8.5f}"
            f" cg {h['cg_iters']:3d} {h['host_ms']:9.2f} ms "
            f"{h['host_syncs']:3d} syncs")
    corr = float(np.corrcoef(x_hat, beta)[0, 1])
    log(f"  steady-state median "
        f"{np.median([h['host_ms'] for h in hist[2:]]):.2f} ms/it; corr("
        f"x_hat, beta) = {corr:.5f} (limit {DENSE_CORR_MIN}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (np.isfinite(x_hat).all() and len(hist) == CFG_B_ITERS
            and corr >= DENSE_CORR_MIN):
        raise AssertionError("the dense path missed its expectations")
    if any(matvec.LAUNCHES.values()):
        raise AssertionError(f"the dense path launched a packed kernel: "
                             f"{matvec.LAUNCHES}")
    del X, geno
    torch.cuda.empty_cache()


def phase_card_vs_cpu_dense():
    """Phase 5v: the linear engine on a dense matrix (N=2000 x M=4096,
    standard normal) on the card and on the CPU, 6 iterations, x1 within
    5e-5 and the scalars within 2e-4 (phase 5's limits)."""
    log("== phase 5v: dense card vs CPU, N=2000 x M=4096, 6 iterations")
    from gvamp_tpu_torch import linear, sim
    from gvamp_tpu_torch.data import GenoDense
    N, M = 2000, 4096
    rng = np.random.default_rng(7)
    X = rng.standard_normal((M, N))
    vars_t, probs_t = sim.two_group_prior(M, 40, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    cfg = linear.VampConfig(max_iter=6, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0, seed=5)
    out, y = {}, None
    for dev in ("cuda", "cpu"):
        g = GenoDense.from_arrays(X, np.zeros(N), N=N, device=dev,
                                  standardize_phen=False)
        if y is None:
            y = sim.simulate_linear_phenotype(g, beta, 2.0, rng)
        g.set_phen(y)
        t0 = time.perf_counter()
        out[dev] = linear.infer(g, cfg, probs_t, vars_t, verbose=False)
        log(f"  {dev}: {time.perf_counter() - t0:.2f} s")
    compare_card_cpu("dense", out["cuda"], out["cpu"])


def compare_card_cpu(label, card, cpu, keys=("gam1", "gam2", "gamw",
                                              "alpha2")):
    """x1 within 5e-5 of max|x1| and the last iteration's ``keys`` within
    2e-4 (phase 5's limits) between a card run and a CPU run, each
    (x, state, history)."""
    (x_c, _, h_c), (x_p, _, h_p) = card, cpu
    dx = float(np.abs(x_c - x_p).max() / np.abs(x_p).max())
    log(f"  {label}: max|x1 card - x1 cpu| / max|x1| = {dx:.3e} (limit 5e-5)")
    if not dx < 5e-5:
        raise AssertionError(f"{label}: card and CPU x1 disagree")
    for k in keys:
        a, b = float(h_c[-1][k]), float(h_p[-1][k])
        log(f"  {k}: card {a:.7g} cpu {b:.7g} rel {abs(a - b) / abs(b):.3e} "
            f"(limit 2e-4)")
        if not abs(a - b) <= 2e-4 * abs(b):
            raise AssertionError(f"{label}: card and CPU {k} disagree")


def phase_state_evo_card_vs_cpu():
    """Phase 5v: linear.state_evolution_from_draws on the card and on the
    CPU from the same draws (float32, Mt = 131,072 Monte-Carlo samples,
    a two-component prior and its neighbour), within SE_CARD_CPU_TOL."""
    log("== phase 5v: state_evolution card vs CPU, float32")
    from gvamp_tpu_torch import linear
    from gvamp_tpu_torch.prior import Prior
    n_mc = CFG_B_M
    pr = (Prior(torch.tensor([0.99, 0.01]), torch.tensor([0.0, 50.0])),
          Prior(torch.tensor([0.98, 0.02]), torch.tensor([0.0, 30.0])))
    draws = linear.state_evolution_draws(3, 2, pr[0], pr[1], n_mc)
    res = {}
    for dev in ("cuda", "cpu"):
        p0, p1 = (Prior(p.probs.to(dev), p.vars.to(dev)) for p in pr)
        res[dev] = [float(v) for v in linear.state_evolution_from_draws(
            *(d.to(dev) for d in draws), p0, 4.0, 0.3, p1, 2.5)]
    d = max(abs(a - b) / abs(b) for a, b in zip(res["cuda"], res["cpu"]))
    log(f"  (alpha1, eta1, gam2) card {res['cuda']} cpu {res['cpu']}: max "
        f"rel diff {d:.3e} (limit {SE_CARD_CPU_TOL:g})")
    if not d <= SE_CARD_CPU_TOL:
        raise AssertionError("state_evolution: card and CPU disagree")


def flagship_test_files(tmp, N, M, beta):
    """A test set for the flagship data: N other people, the same markers
    and truth, 2% missing calls; returns (bed, phen)."""
    from gvamp_tpu_torch import sim
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.io import plink
    rng = np.random.default_rng(43)
    bed, phen = (os.path.join(tmp, f"test.{e}") for e in ("bed", "phen"))
    plink.write_bed(bed, sim.random_genotypes(rng, M, N, miss_rate=0.02))
    g = GenoBed.from_files(bed, None, N=N, Mt=M, device="cuda",
                           standardize_phen=False)
    plink.write_phen(phen, sim.simulate_linear_phenotype(
        g, beta, 1 / (1 - 0.8), rng))
    return bed, phen


def cli_lines(argv) -> list:
    """The lines a CLI run prints, and its return value."""
    from gvamp_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    return buf.getvalue().splitlines(), out


def phase_cli_modes():
    """Phase 6v: the run modes through the CLI on the card, on the flagship
    files and a test set of 400 other people: sim; infere with
    --use-cross-val 1 --state-evo 1 and its dumps; test over the dumped
    series, its R2 at the last iteration against the library's float64
    score on the CPU within 1e-5; both; pvals-calc with a .bim over the
    series; predict_single and predict --predict-format matrix; then
    --run-mode infere --type-data meth on a small .meth file.  Every output
    file is checked for presence and shape, and no tool-only kernel may
    launch."""
    log("== phase 6v: CLI run modes (sim, cross-validated infere with "
        "--state-evo, test, both, pvals-calc, predict), --type-data meth")
    from gvamp_tpu_torch import cli, sim
    from gvamp_tpu_torch.data import GenoBed, GenoDense
    from gvamp_tpu_torch.io import plink, vecio
    from gvamp_tpu_torch.ops import matvec
    N, M, NT, n_it = 800, 240, 400, 6
    matvec.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        bed, phen, bim, beta = flagship_files(tmp, N, M)
        tbed, tphen = flagship_test_files(tmp, NT, M, beta)
        out = os.path.join(tmp, "out")
        pre = os.path.join(out, "")
        base = ["--device", "cuda", "--N", str(N), "--Mt", str(M),
                "--probs", "0.95,0.05", "--vars", "0.0,0.0667", "--rho",
                "0.3", "--verbosity", "0", "--out-dir", out]
        test = ["--bed-file-test", tbed, "--phen-files-test", tphen,
                "--N-test", str(NT), "--Mt-test", str(M)]
        t0 = time.perf_counter()
        cli_lines(base + ["--run-mode", "sim", "--bed-file", bed,
                          "--iterations", "3", "--h2", "0.8", "--CV", "12",
                          "--out-name", "sim"])
        bt = vecio.read_bin_shard(pre + "sim_beta_true.bin", M, 0)
        ys = np.loadtxt(pre + "sim_y.txt")
        xs = vecio.read_bin_shard(pre + "sim_it_3.bin", M, 0)
        log(f"  sim: beta_true {bt.shape}, y {ys.shape}, corr(x_3, beta) "
            f"{np.corrcoef(xs, bt)[0, 1]:.4f}")
        if not (ys.shape[0] >= N and np.isfinite(xs).all()):
            raise AssertionError("sim outputs malformed")
        lines, _ = cli_lines(base + ["--run-mode", "infere", "--bed-file",
                                     bed, "--phen-files", phen, "--bim-file",
                                     bim, "--iterations", str(n_it),
                                     "--use-cross-val", "1", "--state-evo",
                                     "1", "--out-name", "cv"])
        se = [ln for ln in lines if re.match(r"\s+it \d+: alpha1 ", ln)]
        log("  " + "\n  ".join(se))
        if len(se) != n_it - 1:
            raise AssertionError(f"--state-evo printed {len(se)} lines")
        names = [f"{pre}cv{suf}" for it in range(1, n_it + 1)
                 for suf in (f"_it_{it}.bin", f"_r1_it_{it}.bin",
                             f"_r2_it_{it}.bin", f"_it_{it}_x2_hat.bin",
                             f"_z1_it_{it}.csv")]
        names += [f"{pre}cv_{h}.csv" for h in ("gam1s", "gam2s", "R2trains")]
        missing = [n for n in names if not os.path.getsize(n)]
        if missing:
            raise AssertionError(f"infere outputs missing: {missing}")
        dumps = [vecio.read_bin_shard(f"{pre}cv_it_{it}.bin", M, 0)
                 for it in range(1, n_it + 1)]
        log(f"  infere --use-cross-val: corr(x_{n_it}, beta) "
            f"{np.corrcoef(dumps[-1], beta)[0, 1]:.5f}")
        lines, best = cli_lines(base + test + [
            "--run-mode", "test", "--estimate-file", pre + "cv_it_2.bin",
            "--test-iter-range", f"2,{n_it}", "--out-name", "t"])
        r2_last = float(re.search(r"R2 = (\S+)", [
            ln for ln in lines if ln.startswith(f"it {n_it}:")][0]).group(1))
        g = GenoBed.from_files(tbed, tphen, N=NT, Mt=M, device="cpu",
                               dtype=torch.float64)
        with contextlib.redirect_stdout(io.StringIO()):
            r2_lib = cli.score_series(g, [(n_it, dumps[-1])])[0]
        log(f"  test: {lines[-1]}; R2 at it {n_it} {r2_last:.6f} against "
            f"the CPU float64 score {r2_lib:.6f} (limit 1e-5)")
        if not abs(r2_last - r2_lib) <= 1e-5:
            raise AssertionError("test mode's R2 differs from the library's")
        lines, r2_both = cli_lines(base + test + [
            "--run-mode", "both", "--bed-file", bed, "--phen-files", phen,
            "--iterations", str(n_it), "--out-name", "b"])
        log(f"  both: {lines[-1]}")
        if not np.isfinite(r2_both):
            raise AssertionError("both mode's R2 is not finite")
        cli_lines(base + ["--run-mode", "pvals-calc", "--bed-file", bed,
                          "--phen-files", phen, "--bim-file", bim,
                          "--estimate-file", pre + "cv_it_4.bin",
                          "--test-iter-range", f"4,{n_it}",
                          "--out-name", "p"])
        for it in range(4, n_it + 1):
            for suf in ("_pvals.bin", "_pvals_LOCO.bin"):
                p = vecio.read_bin_shard(f"{pre}p_it_{it}{suf}", M, 0)
                if not pvals_in_range(p):
                    raise AssertionError(f"pvals-calc {suf} out of range")
            for ch in range(1, 5):
                pred = np.loadtxt(f"{pre}p_it_{it}_LOCO_chr_{ch}.csv")
                if pred.shape[0] < N:
                    raise AssertionError("pvals-calc predictor malformed")
        cli_lines(base + test + ["--run-mode", "predict_single",
                                 "--estimate-file", pre + f"cv_it_{n_it}.bin",
                                 "--out-name", "ps"])
        ps = np.loadtxt(pre + "ps_predict.csv")
        for it in (n_it - 1, n_it):
            vecio.write_bin_shard(f"{pre}gtemp_{it}_{it}_gibbs_est.bin",
                                  dumps[it - 1], 0)
        # the Gibbs-named series relative to the working directory: the
        # extension is taken after the path's first dot, which the
        # temporary directory's name may hold (ROADMAP.md Queue 3)
        with contextlib.chdir(out):
            cli_lines(base + test + [
                "--run-mode", "predict", "--estimate-file",
                f"gtemp_{n_it - 1}_{n_it - 1}_gibbs_est.bin",
                "--test-iter-range", f"{n_it - 1},{n_it}", "--predict-format",
                "matrix", "--out-name", "pm"])
        pm = np.loadtxt(pre + "pm_predict_matrix.csv", delimiter=",")
        # predict_single's CSV holds 6 significant digits ("%g")
        dp = float(np.abs(pm[:, -1] - ps[:NT]).max() / np.abs(ps).max())
        log(f"  pvals-calc: LOO, LOCO and 4 predictors for it 4-{n_it}; "
            f"predict_single {ps.shape}, predict matrix {pm.shape}, its "
            f"last column against predict_single {dp:.2e} (limit 1e-5)")
        if not (ps.shape[0] >= NT and pm.shape == (NT, 2) and dp < 1e-5):
            raise AssertionError("predict outputs malformed")
        # --type-data meth: the recipe of tests/test_cli.py:251-281
        rng = np.random.default_rng(33)
        Nm, Mm = 300, 96
        X = rng.standard_normal((Mm, Nm))
        meth = os.path.join(tmp, "m.meth")
        plink.write_meth(meth, X)
        gd = GenoDense.from_arrays(X, np.zeros(Nm), N=Nm, device="cuda",
                                   standardize_phen=False)
        vars_t, probs_t = sim.two_group_prior(Mm, 8, 0.8)
        bm = sim.simulate_mixture(rng, Mm, vars_t, probs_t)
        plink.write_phen(os.path.join(tmp, "m.phen"),
                         sim.simulate_linear_phenotype(gd, bm, 5.0, rng))
        cli_lines(["--device", "cuda", "--run-mode", "infere",
                   "--type-data", "meth", "--bed-file", meth,
                   "--phen-files", os.path.join(tmp, "m.phen"), "--N",
                   str(Nm), "--Mt", str(Mm), "--iterations", "6", "--rho",
                   "0.3", "--vars", ",".join(map(str, vars_t)), "--probs",
                   ",".join(map(str, probs_t)), "--verbosity", "0",
                   "--out-dir", out, "--out-name", "meth"])
        xm = vecio.read_bin_shard(pre + "meth_it_6.bin", Mm, 0)
        cm = float(np.corrcoef(xm, bm)[0, 1])
        log(f"  --type-data meth: corr(x_6, beta) {cm:.5f} (limit 0.9, "
            f"tests/test_cli.py's)")
        if not cm > 0.9:
            raise AssertionError("the meth run missed its expectation")
    log(f"  phase 6v in {time.perf_counter() - t0:.2f} s")
    check_no_tool_launches("CLI run modes", matvec.LAUNCHES)


def phase_modes_alone():
    """--modes: phases 4c, 4v, 4d, 5v and 6v on instances of their own
    (configs B and Bm drawn one after the other from one generator): the
    SLQ run at config B beside 4c, phase 4m at config Bm before 4v."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    words = synth_words(gen, False, CFG_B_N, CFG_B_M)
    _, geno, problem = phase_main_path(words)
    phase_cross_val_b(geno, problem)
    del words, geno
    torch.cuda.empty_cache()
    words = synth_words(gen, True, CFG_B_N, CFG_B_M)
    _, geno, problem, run_bm = phase_config_bm(words)
    phase_modes_bm(geno, problem, run_bm)
    del words, geno
    torch.cuda.empty_cache()
    phase_dense()
    phase_card_vs_cpu_modes()
    phase_cli_modes()


def phase_mesh_alone():
    """--mesh: phase 4 and the mesh phases 8b, 8x, 8c, 8d and 8n (config X
    drawn after config B from one generator)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    words = synth_words(gen, False, CFG_B_N, CFG_B_M)
    _, geno, problem = phase_main_path(words)
    phase_mesh_b(words, geno, problem)
    del words, geno
    torch.cuda.empty_cache()
    words = synth_words(gen, False, CFG_X_N, CFG_X_M)
    phase_mesh_x(words)
    del words
    torch.cuda.empty_cache()
    for miss_rate in (0.0, 0.02):
        phase_card_vs_cpu(miss_rate, shards=MESH_SHARDS)
    phase_cli_distributed()
    phase_nccl_two_ranks()


def phase_card_vs_cpu_modes():
    """Phase 5v: cross-validated linear, complete and with 2% missing
    calls, the dense linear engine, and state_evolution, card against
    CPU."""
    phase_card_vs_cpu(0.0, cross_val=True)
    phase_card_vs_cpu(0.02, cross_val=True)
    phase_card_vs_cpu_dense()
    phase_state_evo_card_vs_cpu()


# --------------------------------------------------------------------------
# phase 8: the marker mesh
# --------------------------------------------------------------------------

MESH_SHARDS = 2


def check_mesh_launches(label, mesh, launches, used, unused=()):
    """Every kernel of ``used`` launched, once per slab of each call of its
    wrapper over the mesh (``mesh.calls``), and none of ``unused``."""
    check_launches(label, launches, used, unused)
    log(f"  calls over the {mesh.n_local} slabs: "
        + ", ".join(f"{n} {mesh.calls.get(n, 0)}" for n in used))
    for n in used:
        if launches[n] != mesh.n_local * mesh.calls.get(n, 0):
            raise AssertionError(
                f"{label}: {n} launched {launches[n]} times for "
                f"{mesh.calls.get(n, 0)} calls over {mesh.n_local} slabs")


def phase_mesh_b(words, geno1, problem):
    """Phase 8b: config B on a 2-shard mesh beside phase 4's run (``geno1``,
    ``problem``) on the same words and phenotype.  Returns the launches of
    its 10 iterations."""
    log(f"== phase 8b: config B on a {MESH_SHARDS}-shard marker mesh, both "
        f"slabs on the card")
    from gvamp_tpu_torch import dist
    from gvamp_tpu_torch.data import GenoBed
    from gvamp_tpu_torch.ops import matvec
    beta, vars_t, probs_t, x1, hist1 = problem
    n, m = CFG_B_N, CFG_B_M
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    mesh = dist.Mesh(MESH_SHARDS, "cuda")
    t0 = time.perf_counter()
    geno = GenoBed.from_device_words(words, np.zeros(n), N=n, M=m,
                                     standardize_phen=False, mesh=mesh)
    complete = geno.geno_complete
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    load = dict(matvec.LAUNCHES)
    log(f"  {mesh}: slabs {[tuple(g.shape) for g in geno.words]}; split, "
        f"statistics and completeness {t_load:.2f} s; atx launched "
        f"{load['atx']} times at load")
    if complete is not True or load["atx"] != MESH_SHARDS:
        raise AssertionError(f"config B, {MESH_SHARDS} shards: complete "
                             f"{complete}, atx launched {load['atx']} times")
    geno.set_phen(geno1.deplanarize(geno1.y_planar)[:n])
    same = [bool(torch.equal(a, b)) for a, b in
            ((geno.mave, geno1.mave), (geno.msig, geno1.msig),
             (geno.y_planar, geno1.y_planar))]
    log(f"  mave, msig, phenotype equal to phase 4's bit for bit: {same}")
    if not all(same):
        raise AssertionError("the mesh's statistics differ from phase 4's")
    matvec.reset_launches()
    mesh.calls.clear()
    x_hat, _, hist = run_infer(geno, beta, vars_t, probs_t,
                               f"config B, {MESH_SHARDS} shards", CORR_MIN,
                               R2_RANGE)
    launches = dict(matvec.LAUNCHES)
    check_mesh_launches(f"config B, {MESH_SHARDS} shards", mesh, launches,
                        ("axm_i8a", "atxm_i8a"),
                        ("axm_i8", "atxm_i8", "gram_i8a", "gram_i8", "atx"))
    dx = float(np.abs(x_hat - x1).max() / np.abs(x1).max())
    med, med1 = (np.median([h["host_ms"] for h in hh[2:]])
                 for hh in (hist, hist1))
    log(f"  against phase 4: max|x1 - x1(phase 4)| / max|x1| = {dx:.3e}; "
        f"median {med:.2f} ms/it (phase 4: {med1:.2f}); CG "
        f"{[h['cg_iters'] for h in hist]} (phase 4: "
        f"{[h['cg_iters'] for h in hist1]}); host syncs "
        f"{[h['host_syncs'] for h in hist]} (phase 4: "
        f"{[h['host_syncs'] for h in hist1]})")
    # a mesh adds no host sync: where the CG counts are the same, so are
    # the syncs, and otherwise they differ by the CG's exit tests alone
    for h, h1 in zip(hist, hist1):
        if h["host_syncs"] - h["cg_iters"] != h1["host_syncs"] - h1[
                "cg_iters"]:
            raise AssertionError(f"config B, {MESH_SHARDS} shards: iteration "
                                 f"{h['it']} took {h['host_syncs']} host "
                                 f"syncs, phase 4 {h1['host_syncs']}")
    del geno
    torch.cuda.empty_cache()
    return launches


def phase_mesh_x(words):
    """Phase 8x: the dual path at config X on a 2-shard mesh, through the
    fused dual Gram per slab.  Returns the launches of its run."""
    log(f"== phase 8x: dual (XXT) mode at config X on a {MESH_SHARDS}-shard "
        f"marker mesh")
    from gvamp_tpu_torch import dist
    from gvamp_tpu_torch.ops import matvec
    mesh = dist.Mesh(MESH_SHARDS, "cuda")
    geno, beta, vars_t, probs_t = make_problem(
        words, f"config X, {MESH_SHARDS} shards", True, CFG_X_N, CFG_X_M,
        mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    matvec.reset_launches()
    mesh.calls.clear()
    run_infer(geno, beta, vars_t, probs_t,
              f"config X dual, {MESH_SHARDS} shards", X_CORR_MIN, X_R2_RANGE,
              use_xxt=True)
    launches = dict(matvec.LAUNCHES)
    check_mesh_launches(f"config X dual, {MESH_SHARDS} shards", mesh,
                        launches, ("gram_aat_i8a", "ax"),
                        ("gram_aat_i8", "axm_i8", "atxm_i8"))
    if launches["ax"] != 2 * MESH_SHARDS:
        raise AssertionError(f"config X, {MESH_SHARDS} shards: ax launched "
                             f"{launches['ax']} times, expected "
                             f"{2 * MESH_SHARDS}")
    del geno
    torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def outputs(out, name) -> dict:
    """{suffix: bytes} of every file a CLI run wrote as ``name``."""
    return {f[len(name):]: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out)) if f.startswith(name + "_")}


def phase_cli_distributed():
    """Phase 8d: --distributed 1 --n-processes 1 through the CLI on the
    card: one NCCL rank, whose collectives are copies, writes what the run
    without --distributed writes."""
    log("== phase 8d: CLI --distributed 1 --n-processes 1 on the card "
        "(NCCL)")
    from gvamp_tpu_torch import cli
    from gvamp_tpu_torch.ops import matvec
    N, M, n_it = 800, 240, 8
    with tempfile.TemporaryDirectory() as tmp:
        bed, phen, bim, _ = flagship_files(tmp, N, M)
        out = os.path.join(tmp, "out")
        cli.main(flagship_cli_args(bed, phen, bim, N, M, out, "plain", n_it,
                                   pvals=True))
        matvec.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(flagship_cli_args(bed, phen, bim, N, M, out, "nccl",
                                       n_it, pvals=True)
                     + ["--distributed", "1", "--coordinator",
                        f"localhost:{free_port()}", "--n-processes", "1",
                        "--process-id", "0"])
        t_run = time.perf_counter() - t0
        check_no_tool_launches("CLI --distributed 1", matvec.LAUNCHES)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("replicated:")]
        plain, nccl = outputs(out, "plain"), outputs(out, "nccl")
    log(f"  {lines[0] if lines else 'no replication line'}; {t_run:.2f} s; "
        f"process group left: {torch.distributed.is_initialized()}")
    if not lines or not lines[0].endswith("over 1 processes (nccl)"):
        raise AssertionError(f"the run did not report one NCCL rank: {lines}")
    diff = [k for k in plain if plain[k] != nccl.get(k)]
    log(f"  {len(plain)} files; equal to the run without --distributed bit "
        f"for bit: {not diff and plain.keys() == nccl.keys()}")
    if diff or plain.keys() != nccl.keys() or len(plain) < 5 * n_it:
        raise AssertionError(f"--distributed 1 differs in {diff}")


def phase_nccl_two_ranks():
    """Phase 8n: two NCCL ranks, one card each, through the CLI against
    one process with --devices 2, where two cards are visible."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"== phase 8n did not run: {n_cards} CUDA device visible; NCCL "
            f"puts one rank on a card (two ranks on one card fail with "
            f"'Duplicate GPU detected'), so two ranks need two cards")
        return
    log(f"== phase 8n: two NCCL ranks on cards 0 and 1 against one process "
        f"with --devices 2")
    from gvamp_tpu_torch import cli
    N, M, n_it = 800, 240, 8
    with tempfile.TemporaryDirectory() as tmp:
        bed, phen, bim, _ = flagship_files(tmp, N, M)
        out = os.path.join(tmp, "out")
        cli.main(flagship_cli_args(bed, phen, bim, N, M, out, "one", n_it,
                                   pvals=True) + ["--devices", "2"])
        port = free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gvamp_tpu_torch.cli"]
            + flagship_cli_args(bed, phen, bim, N, M, out, "two", n_it,
                                pvals=True)
            + ["--distributed", "1", "--coordinator", f"localhost:{port}",
               "--n-processes", "2", "--process-id", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for i in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"an NCCL rank failed:\n{o[-3000:]}")
        one, two = outputs(out, "one"), outputs(out, "two")
    same = [k for k in one if one[k] == two.get(k)]
    log(f"  {len(same)} of {len(one)} files equal bit for bit")
    # the estimates within 1e-6 of their largest entry: the ranks' partials
    # meet in NCCL's order, one process's in shard order
    for k in one:
        if k.endswith(".bin") and "pvals" not in k:
            a, b = (np.frombuffer(v, np.float64) for v in (one[k],
                                                            two.get(k, b"")))
            if a.shape != b.shape or not (
                    np.abs(a - b).max() <= 1e-6 * np.abs(a).max()):
                raise AssertionError(f"two NCCL ranks differ in {k}")


# the kernels that only the tools launch (phase 7), and the tools
TOOL_KERNELS = ("axm_bf16", "atxm_bf16", "axm_i8s", "atx_a") + STUDY
TOOLS = ("kernel_check", "bench_gram", "profile_kernels", "bench_stream",
         "bench_variants", "bench_round2")
# runs beyond each tool's defaults: the stream ceiling at config B's shape
TOOL_EXTRA_ARGV = {"bench_stream": ([str(CFG_B_N // 16), str(CFG_B_M), "4"],)}


def phase_tools():
    """The port's tools on the card, each through ``main([])`` at its
    defaults (and with TOOL_EXTRA_ARGV); each must return 0 (kernel_check:
    every product kernel within 5e-7 of float64, then the fused Grams'
    correctness; bench_gram: the correctness again, then the timing).
    Returns the launch counts of the runs."""
    log("== phase 7: the port's tools on the card")
    import importlib
    from gvamp_tpu_torch.ops import matvec
    matvec.reset_launches()
    for name in TOOLS:
        for argv in ([], *TOOL_EXTRA_ARGV.get(name, ())):
            log(f"  -- python3 -m gvamp_tpu_torch.tools.{name} "
                f"{' '.join(argv)}")
            t0 = time.perf_counter()
            rc = importlib.import_module(
                f"gvamp_tpu_torch.tools.{name}").main(argv)
            torch.cuda.synchronize()
            log(f"  {name}: exit code {rc} in {time.perf_counter() - t0:.2f} "
                f"s")
            if rc != 0:
                raise AssertionError(f"{name} returned {rc}")
            torch.cuda.empty_cache()
    launches = dict(matvec.LAUNCHES)
    check_launches("tools", launches, TOOL_KERNELS)
    return launches


def kernel_rows(numbers):
    """The kernels line: one row per kernel from ``numbers`` = {name: (err,
    ms, plain_ms, launches, (nw, m, B), library_ms)}, with its bound on
    that shape.  library_ms is None where no PyTorch call computes the
    kernel's function: none takes the packed 2-bit words to a product, and
    none decodes them (v1_decode_a to v3_bitcast); torch.sum computes the
    plain sums of stream, stream_sum and v0_stream."""
    rows = []
    for n in KERNELS + (COUNT_KERNEL,):
        err, ms, plain, launches, (nw, m, B), lib_ms = numbers[n]
        b_ms, b_by = bound(n, nw, m, B)
        log(f"  {n:12s} Nw={nw} Mpad={m} B={B}: {ms:9.3f} ms, bound "
            f"{b_ms:.3f} ms by {b_by} ({b_ms / ms:.1%} of it), plain "
            f"{plain:9.2f} ms, PyTorch call "
            + (f"{lib_ms:.3f} ms" if lib_ms is not None else "none")
            + f", {launches} launches on its path")
        rows.append({
            "name": n, "route": "cuda",
            "source": (FUSED_AB_SOURCE if n == "v6_fused_ab" else
                       COUNT_SOURCE if n == COUNT_KERNEL else
                       STUDY_SOURCE if n in STUDY else FRAGMENT_SOURCE
                       if n in FRAGMENT_KERNELS else BF16_SOURCE
                       if n in BF16_KERNELS else GRAM_AAT_SOURCE
                       if n in GRAM_AAT_KERNELS else GRAM_PRIM_SOURCE
                       if n in GRAM_PRIM_KERNELS else SOURCE),
            "replaces": REPLACES.get(n, COUNT_REPLACES),
            "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"Nw={nw} Mpad={m} B={B}"})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks on small shapes")
    ap.add_argument("--single-vector", action="store_true",
                    help="only build and phase 3v: atx and atx_a at config "
                         "B, ax at config X, checked and timed")
    ap.add_argument("--bf16-split", action="store_true",
                    help="only build and phase 3w: axm_bf16 and atxm_bf16 "
                         "at configs B and Bm, checked and timed")
    ap.add_argument("--options", action="store_true",
                    help="only build and the phases of the engine options "
                         "(3r, 4q at config B, 4r, 5q, 6q), the SLQ run "
                         "beside the probe run")
    ap.add_argument("--modes", action="store_true",
                    help="only build and the phases of the run modes, "
                         "cross-validation and the dense path (4c, 4v, 4d, "
                         "5v, 6v), phases 4 and 4m beside them")
    ap.add_argument("--mesh", action="store_true",
                    help="only build, phase 4 and the marker mesh's phases "
                         "(8b, 8x, 8c, 8d, 8n)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    phase_environment()
    if args.single_vector:
        from gvamp_tpu_torch.ops import _build
        log(f"kernels: {_build.library()._name}")
        phase_single_vector()
        log(f"single-vector run: phase 3v passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return
    if args.bf16_split:
        from gvamp_tpu_torch.ops import _build
        log(f"kernels: {_build.library()._name}")
        phase_bf16_split()
        log(f"bf16-split run: phase 3w passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return
    phase_build()
    if args.options:
        phase_options_alone()
        log(f"options run: phases 3r, 4q at config B, 4r, 5q and 6q "
            f"passed in {time.perf_counter() - t_start:.1f} s")
        return
    if args.modes:
        phase_modes_alone()
        log(f"modes run: phases 4, 4c, 4m, 4v, 4d, 5v and 6v passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return
    if args.mesh:
        phase_mesh_alone()
        log(f"mesh run: phases 4, 8b, 8x, 8c, 8d and 8n passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the staged study products draw from their own generator, so that the
    # configurations drawn from ``gen`` stay the instances the engine
    # phases' limits were set on
    study_gen = torch.Generator(device="cuda")
    study_gen.manual_seed(1)
    phase_kernels_small(gen, study_gen)
    if args.kernels_only:
        log("kernels-only run: phases 1-3a passed")
        return
    # config B: the a-only kernels, the fused a-only Gram, linear two-pass
    # and fused, probit two-pass and fused
    words = synth_words(gen, False, CFG_B_N, CFG_B_M)
    nw, m = words.shape
    full = phase_kernels_config_b(words, gen)
    full_s = phase_study_config_b(words, study_gen)
    full_g = phase_kernels_gram(words, gen, True)
    phase_kernels_window(words, "config B")
    launches, geno, problem = phase_main_path(words)
    launches_mesh = {f"config B, {MESH_SHARDS} shards (phase 8b)":
                     phase_mesh_b(words, geno, problem)}
    launches_v = {"cross-validation at config B (phase 4c)":
                  phase_cross_val_b(geno, problem)}
    launches_q = {"config B probe path": phase_probe_b(geno, problem),
                  "config B red": phase_red(geno, problem, "config B", True)}
    launches_f = phase_fused_linear("config B", geno, problem, True)
    launches_p, launches_pf = phase_probit_b(geno, problem)
    launches_h = phase_huber(geno, problem, "config B", True, CFG_B_ITERS,
                             (0, HUBER_DEFLATE_K))
    launches_t = phase_multi_b(geno)
    del words, geno
    torch.cuda.empty_cache()
    # config Bm: the general kernels, the fused general Gram, p-values
    words = synth_words(gen, True, CFG_B_N, CFG_B_M)
    full_m = phase_kernels_config_bm(words, gen)
    full_s["v6_fused_ab"] = phase_study_fused_ab(words, study_gen)
    full_gm = phase_kernels_gram(words, gen, False)
    phase_kernels_window(words, "config Bm")
    launches_m, geno, problem, run_bm = phase_config_bm(words)
    launches_v["run modes at config Bm (phase 4v)"] = phase_modes_bm(
        geno, problem, run_bm)
    launches_q["config Bm red"] = phase_red(geno, problem, "config Bm",
                                            False)
    launches_mf = phase_fused_linear("config Bm", geno, problem, False)
    launches_hm = phase_huber(geno, problem, "config Bm", False,
                              HUBER_BM_ITERS, (0,))
    launches_t.update(phase_multi_bm(geno))
    del words, geno
    torch.cuda.empty_cache()
    words = synth_words(gen, False, CFG_X_N, CFG_X_M)
    words_m = synth_words(gen, True, CFG_X_N, CFG_X_M)
    nwx, mx = words.shape
    full_x = phase_kernels_config_x(words, words_m, gen)
    launches_x, launches_xm, launches_q["config X dual probe path"] = \
        phase_dual_x(words, words_m)
    launches_mesh[f"config X dual, {MESH_SHARDS} shards (phase 8x)"] = \
        phase_mesh_x(words)
    del words, words_m
    torch.cuda.empty_cache()
    phase_dense()
    phase_moments_biobank()
    for use_xxt in (False, True):
        phase_card_vs_cpu(0.0, use_xxt)
        phase_card_vs_cpu(0.02, use_xxt)
    phase_card_vs_cpu(0.0, fused=True)
    phase_card_vs_cpu_probit(0.0, 0)
    phase_card_vs_cpu_probit(0.02, 2)
    phase_card_vs_cpu_probit(0.02, 2, fused=True)
    for miss_rate, deflate_k in HUBER_CARD_CPU_CASES:
        phase_card_vs_cpu_huber(miss_rate, deflate_k)
    for model, miss_rate in (("linear", 0.0), ("linear", 0.02),
                             ("bin_class", 0.0), ("robust", 0.0)):
        phase_card_vs_cpu_multi(model, miss_rate)
    phase_card_vs_cpu_options()
    phase_card_vs_cpu_modes()
    for miss_rate in (0.0, 0.02):
        phase_card_vs_cpu(miss_rate, shards=MESH_SHARDS)
    phase_cli()
    phase_cli_xxt()
    phase_cli_probit()
    phase_cli_restart()
    phase_cli_multi()
    phase_cli_options()
    phase_cli_modes()
    phase_cli_distributed()
    phase_nccl_two_ranks()
    launches_tools = phase_tools()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    # times at B = 1 on the whole matrix of the path that runs the kernel:
    # config B (a-only, atx, atx_a, the bf16-split products, gram_i8a), Bm
    # (general, axm_i8s, gram_i8), X (ax, gram_aat_i8a), Xm (gram_aat_i8);
    # the error is the largest over every width checked there (each check
    # raises unless it is 0); launches are those of that path's run: the
    # linear runs of phases 4 / 4m (4f for the fused primal Grams), the dual
    # runs of phase 4x and, for the kernels only the tools launch, phase 7;
    # the study kernels at config B (phase 3s; the products at B = 2,
    # v6_fused_ab on config Bm), the only rows with a PyTorch call's time
    launches.update({n: launches_tools[n] for n in TOOL_KERNELS})
    launches_m["axm_i8s"] = launches_tools["axm_i8s"]
    numbers = {}
    for n in KERNELS:
        if n in STUDY:
            err, ms, plain, lib_ms = full_s[n]
            B = 2 if n in STUDY_PRODUCTS else 1
            numbers[n] = (err, ms, plain, launches[n], (nw, m, B), lib_ms)
            continue
        if n in ("ax", "gram_aat_i8a", "gram_aat_i8"):
            counts = launches_xm if n == "gram_aat_i8" else launches_x
            numbers[n] = (*full_x[n], counts[n], (nwx, mx, 1), None)
            continue
        if n in ("gram_i8a", "gram_i8"):
            res, counts = ((full_g, launches_f) if n == "gram_i8a"
                           else (full_gm, launches_mf))
            numbers[n] = (*res[n], counts[n], (nw, m, 1), None)
            continue
        runs, counts = ((full_m, launches_m)
                        if n in ("axm_i8", "atxm_i8", "axm_i8s")
                        else (full, launches))
        err = max(r[n][0] for r in runs.values() if n in r)
        numbers[n] = (err, runs[1][n][1], runs[1][n][2], counts[n],
                      (nw, m, 1), None)
    # the count kernel on the whole config-B matrix (phase 3b), launched by
    # phase 4's load and set_phen
    numbers[COUNT_KERNEL] = (*full[1][COUNT_KERNEL], launches[COUNT_KERNEL],
                             (nw, m, 1), None)
    log("kernels against their bounds (NVIDIA H100 SXM peaks: 3.35 TB/s "
        "HBM, 1,979 TOP/s int8, 989 TFLOP/s bf16, 67 TFLOP/s f32):")
    kernels = kernel_rows(numbers)
    log(f"probit at config B: launches two-pass {launches_p}, fused "
        f"{launches_pf}")
    for label, counts in (("config B", launches_h), ("config Bm",
                                                     launches_hm)):
        for k, c in counts.items():
            log(f"Huber at {label}, deflate_k={k}: launches "
                + ", ".join(f"{n} {c[n]}" for n in DEFLATE_KERNELS))
    for run, c in launches_t.items():
        log(f"multi-trait {run} (phases 4t / 4tm): launches "
            + ", ".join(f"{n} {c[n]}" for n in DEFLATE_KERNELS
                        + GRAM_PRIM_KERNELS))
    for run, c in launches_q.items():
        log(f"{run} (phases 4q / 4r): launches "
            + ", ".join(f"{n} {c[n]}" for n in PRODUCT_KERNELS if c[n]))
    for run, c in launches_v.items():
        log(f"{run}: launches "
            + ", ".join(f"{n} {c[n]}" for n in PRODUCT_KERNELS if c[n]))
    for run, c in launches_mesh.items():
        log(f"marker mesh, {run}: launches "
            + ", ".join(f"{n} {c[n]}" for n in PRODUCT_KERNELS if c[n]))
    log(smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
