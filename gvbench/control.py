"""Readings that the limits of ``gvbench/limits/<cell>.json`` are set
from, at the cell's own size, several seeds in one process:

    python3 -m gvbench.control --workload <cell> --seeds 1,2,3 --seconds 10 [--control 1]

For each seed one run of the cell (its set-up, a short window of whole
traits, the reference's check), one JSON line with every number the
reference works out, compared or not, for the program and, with
``--control 1``, for the control: the reference itself in the program's
place with every product's vector operands rounded to TF32.
The lower reading of a number is the largest the program gives over the
seeds, the upper the smallest the control gives.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gvbench import run as bench_run
from gvbench import yardstick


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = yardstick.bench_spec()
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = bench_run.run(spec, args.workload, seed, args.seconds, False,
                            "cuda", control=bool(args.control))
        line = {"seed": seed, "attempted": out["attempted"],
                "program": {k: max(p[k] for p in out["per_trait_checks"])
                            for k in out["per_trait_checks"][0]},
                "per_trait": out["per_trait_checks"],
                "stages_s": out["stages_s"]}
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        if args.control:
            line["control"] = out["control_checks"]
            for k, v in out["control_checks"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper or None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
