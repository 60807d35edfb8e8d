"""Driver of the ``fit`` and ``gwas`` mixes: one trait through the port.

A trait is what a user pays for on the card: ``GenoBed.set_phen`` (the
statistics pass over the trait's NA support), ``linear.infer`` until the
stop threshold or the iteration cap, and, where the mix asks for them, the
LOCO p-values (``ops.pvals.loco_pvals``) on the final estimate.  Each call
runs inside a benchmark span of its layer.  The driver keeps, for the
check after the window, what the fit produced: its states after the last
but one and the last iteration, its A u of the probe, A^T y of the trait
and SLQ quadrature (set-up of the fit, ``linear.make_aux``), and the
p-values.
"""

from __future__ import annotations

import numpy as np
import torch

from gvamp_tpu_torch import linear
from gvamp_tpu_torch.data import GenoBed
from gvamp_tpu_torch.ops import matvec, pvals
from gvamp_tpu_torch.sync import SYNCS

from gvbench import yardstick


class Driver:
    def __init__(self, config: dict, traffic: dict, words: torch.Tensor,
                 recorder: yardstick.Recorder):
        self.config, self.traffic, self.words = config, traffic, words
        self.rec = recorder
        self.N, self.M = int(config["N"]), int(config["M"])
        run = config["run"]
        self.vcfg = linear.VampConfig(
            max_iter=int(run["max_iter"]), rho=float(run["rho"]),
            stop_criteria_thr=float(run["stop_thr"]),
            gam1_init=float(run["gam1_init"]),
            gamw_init=float(run["gamw_init"]),
            auto_var_max_iter=int(run["auto_var_max_iter"]),
            revar_tol=float(run["revar_tol"]),
            em_max_iter=int(run["em_max_iter"]),
            em_err_thr=float(run["em_err_thr"]),
            cg_err_tol=float(run["cg_err_tol"]),
            cg_max_iter=int(run["cg_max_iter"]), slq_k=int(run["slq_k"]))
        self.probs, self.vars = yardstick.upstream_prior(self.N, self.M)
        self.chroms = (yardstick.chromosomes(config)
                       if traffic.get("pvals") == "loco" else None)
        self.kept = []
        self._aux = None

    def setup(self):
        """The container (one statistics pass), the completeness check and
        one warm call of each product at the widths the traits use."""
        self.geno = GenoBed.from_device_words(
            self.words, np.zeros(self.N), N=self.N, M=self.M, S=0,
            standardize_phen=False)
        complete = self.geno.geno_complete
        if complete != (not self.config["missing"]):
            raise RuntimeError(f"completeness check read {complete}")
        axm, atxm = self.geno.fns_multi()
        op = self.geno.op
        widths = [1, 2] + ([len(np.unique(self.chroms))]
                           if self.chroms is not None else [])
        for b in widths:
            x = torch.ones((self.geno.Mpad, b), device=self.words.device)
            atxm(op, axm(op, x))
        self.rec.sync()
        # keep the products that each fit's set-up makes
        make_aux = self._make_aux = linear.make_aux

        def kept_aux(*args, **kw):
            self._aux = make_aux(*args, **kw)
            return self._aux

        linear.make_aux = kept_aux

    def run_trait(self, y: np.ndarray, probe: np.ndarray) -> None:
        rec = self.rec
        with rec.span("data"):
            self.geno.set_phen(y)
        states = {}

        def keep(it, state, metrics, geno):
            states["prev"] = states.get("last")
            states["last"] = state

        s0 = SYNCS["count"]
        with rec.span("engine"):
            _, state, hist = linear.infer(self.geno, self.vcfg, self.probs,
                                          self.vars, bern=probe,
                                          callbacks=[keep], verbose=False)
        rec.count("host_syncs", SYNCS["count"] - s0)
        rec.count("iterations", len(hist))
        rec.count("cg_iters", sum(int(h["cg_iters"]) for h in hist))
        p = None
        if self.chroms is not None:
            # a traced run's trace of the moments pass, some 400,000
            # small kernels, would not be read within the run: the traced
            # window ends before the p-values (``loco_s`` is a host span)
            rec.stop_trace()
            with rec.span("pvals"):
                p = pvals.loco_pvals(self.geno, state.z1, state.x1,
                                     self.chroms)
        if states["prev"] is None:
            raise RuntimeError("the fit stopped after its first iteration")
        aux = self._aux
        self.kept.append(dict(prev=states["prev"], last=state,
                              iters=len(hist), aty=aux.aty,
                              z_probe=aux.z_bern, slq=aux.slq, pvals=p))

    def close(self):
        """Drop the program's container (the words stay: they are the
        benchmark's) and restore ``linear.make_aux``."""
        self.geno = None
        self._aux = None
        linear.make_aux = self._make_aux

    @staticmethod
    def products_module():
        return matvec
