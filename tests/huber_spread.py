"""The JAX package's own f32-against-f64 spread of the Huber engine on the
problems of chip_smoke.py's phase 5h, which sets its card-against-CPU
tolerances from it.

Run from the repository root on the CPU (JAX's f32 path runs its Pallas
kernels in interpret mode, a few minutes):

    JAX_PLATFORMS=cpu python tests/huber_spread.py

For each case (N=2,000 x M=4,096, 6 iterations; complete, 2% missing,
complete with deflate_k=8) it builds phase 5h's data with the same
recipe and seeds, runs gvamp_tpu.robust.infer in float32 and in float64
with the same Monte-Carlo draws (float64 draws cast to the engine dtype,
through a wrapper of em_deltaH in this script) and a float32 probe in the
float32 run (the dtype it has without x64), and prints per iteration
max|x1_f32 - x1_f64| / max|x1_f64|, deltaH's grid index on both sides
and the scalars' relative spread.  Nothing in the JAX package is
edited; the wrappers live in this process only.
"""

import os
import sys

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gvamp_tpu import linear as jlinear  # noqa: E402
from gvamp_tpu import robust as jrobust  # noqa: E402
from gvamp_tpu import sim  # noqa: E402
from gvamp_tpu.data import GenoBed  # noqa: E402
from gvamp_tpu.io import plink  # noqa: E402

# phase 5h of chip_smoke.py: the problem, the engine settings, the cases
N, M, N_IT = 2000, 4096, 6
CASES = [(0.0, 0), (0.02, 0), (0.0, 8)]
SEED = 6
CFG = dict(max_iter=N_IT, rho=0.3, seed=5, stop_criteria_thr=0.0)


def huber_problem(seed, n, m, miss_rate):
    """Phase 5h's data: small_problem's genotypes and truth (two-group
    prior, 40 causal, h2 0.5) and y = A (sqrt(N) beta) + 0.5 t(3)."""
    rng = np.random.default_rng(seed)
    codes = sim.random_genotypes(rng, m, n, miss_rate=miss_rate)
    vars_t, probs_t = sim.two_group_prior(m, 40, 0.5)
    beta = sim.simulate_mixture(rng, m, vars_t, probs_t)
    return codes, beta, vars_t, probs_t, rng


def main():
    orig_em = jrobust.em_deltaH
    orig_bern = jlinear.make_bern_probe

    def em_f64_draws(key, p1, *a, **kw):
        # the same draws in both dtypes: float64 normals cast to p1's dtype
        num_mc = kw.get("num_mc", 100)
        eps = jax.random.normal(key, (num_mc,) + p1.shape, jnp.float64)
        n = jnp.sum(a[2])
        z = p1[None, :] + eps.astype(p1.dtype) / jnp.sqrt(a[0])
        gridj = jnp.asarray(jrobust.DELTA_GRID, p1.dtype)
        losses = jax.vmap(lambda d: jnp.sum(
            jrobust.huber_loss(z, d, a[1][None, :]) * a[2][None, :])
            / (num_mc * n))(gridj)
        return gridj[jnp.argmin(losses)]

    jrobust.em_deltaH = em_f64_draws
    jrobust.make_bern_probe = (lambda g, seed, n=1:
                               orig_bern(g, seed, n).astype(g.dtype))
    tmp = os.environ.get("TMPDIR", "/tmp")
    for miss, dk in CASES:
        codes, beta, vars_t, probs_t, rng = huber_problem(SEED, N, M, miss)
        bed = os.path.join(tmp, "huber_spread.bed")
        plink.write_bed(bed, codes)
        runs = {}
        y = None
        for dt, backend in ((jnp.float64, "xla"), (jnp.float32, "pallas")):
            g = GenoBed.from_files(bed, None, N=N, Mt=M, dtype=dt,
                                   backend=backend, standardize_phen=False)
            if y is None:
                x = g.pad_m(beta * np.sqrt(N))
                y = (np.asarray(g.deplanarize(g.ax(jnp.asarray(x))))[:N]
                     + rng.standard_t(3.0, N) * 0.5)
            g.set_phen(y)
            xs = []
            cfg = jrobust.RobustConfig(deflate_k=dk, **CFG)
            _, _, hist = jrobust.infer(
                g, cfg, probs_t, vars_t, verbose=False,
                callbacks=[lambda it, s, m_, g_: xs.append(
                    np.asarray(s.x1, np.float64))])
            runs[dt] = xs, hist
        (x64, h64), (x32, h32) = runs[jnp.float64], runs[jnp.float32]
        dx = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
              for a, b in zip(x32, x64)]
        print(f"case miss={miss} deflate_k={dk}")
        print("  max|x1 f32 - x1 f64| / max|x1 f64| per iteration: "
              + " ".join(f"{d:.3e}" for d in dx))
        grid = jrobust.DELTA_GRID
        for name, h in (("f64", h64), ("f32", h32)):
            print(f"  deltaH grid index {name} " + str([int(np.argmin(
                np.abs(grid - float(x["deltaH"])))) for x in h]))
        print(f"  cg f64 {[int(h['cg_iters']) for h in h64]} "
              f"f32 {[int(h['cg_iters']) for h in h32]}")
        for k in ("gam1", "gam2", "tau1", "tau2", "alpha2"):
            print(f"  {k} relative spread per iteration: " + " ".join(
                f"{abs(float(a[k]) - float(b[k])) / abs(float(b[k])):.3e}"
                for a, b in zip(h32, h64)))
        print(f"  corr(x1 f64, beta) "
              f"{np.corrcoef(x64[-1][:M], beta)[0, 1]:.5f}", flush=True)
    jrobust.em_deltaH = orig_em
    jrobust.make_bern_probe = orig_bern


if __name__ == "__main__":
    main()
