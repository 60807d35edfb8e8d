"""The benchmark of gvamp_tpu_torch: one run of one cell.

    python3 -m gvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Set-up makes the packed words on the card
from the seed, hands them to the program (one statistics pass, the
completeness check, one warm call of each product) and makes the first
trait's phenotype and probe.  The window then runs whole traits back to
back through the cell's driver and closes at the end of the first trait
that ends at or after ``--seconds``; its clock stops while the benchmark
makes a later trait's inputs.  After it the plain reference judges every
trait of the window.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last: each number compared
beside its limit); the same numbers end standard error.

With ``--trace 1`` the window is one trait, run under ``torch.profiler``
(the device's activity) with the products' calls noted, and the metrics
are the cell's per-layer ones.  A driver may end the traced window
before the trait ends (``Recorder.stop_trace``).
A run needs a CUDA card: without one, or with fewer cards than the cell
asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from gvbench import yardstick  # noqa: E402


def end_to_end(spec: dict, wl: dict, values: dict) -> dict:
    out = {}
    for m in spec["end_to_end"]:
        if wl["name"] in m.get("workloads", [wl["name"]]):
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(spec: dict, wl: dict, record: dict) -> dict:
    """Each per-layer metric of the cell, read by its own module
    ``gvbench.metrics.<name>``; one that finds nothing to read is left
    out."""
    out = {}
    for m in spec["per_layer"]:
        if wl["name"] not in m.get("workloads", [wl["name"]]):
            continue
        mod = importlib.import_module(
            "gvbench.metrics." + m["name"].replace(".", "_"))
        value = mod.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float = None,
        here: str = yardstick.HERE, control: bool = False) -> dict:
    """One run of ``workload``; returns the result line's object.  ``here``
    is the folder that holds the data files (the tests pass a copy).  With
    ``control`` the control's numbers follow under ``control_checks``
    (``gvbench.control``; the benchmark's own runs never compute them)."""
    t_start = time.perf_counter() if t_start is None else t_start
    wl, config, traffic, limits = yardstick.cell(spec, workload, here)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    n, m = int(config["N"]), int(config["M"])
    rec = yardstick.Recorder(dev)
    stamps = [("start", t_start)]

    def stamp(name):
        rec.sync()
        stamps.append((name, time.perf_counter()))
        print(f"[gvbench] {name} done at {stamps[-1][1] - t_start:.3f} s",
              file=sys.stderr, flush=True)

    words = yardstick.make_words(seed, n, m, bool(config["missing"]), dev,
                                 *yardstick.layout(config))
    stamp("words")
    driver = importlib.import_module("gvbench.drivers." + traffic["driver"])
    drv = driver.Driver(config, traffic, words, rec)
    drv.setup()
    stamp("program_setup")
    # the first trait's inputs; each later one is made inside the window
    # with the window's clock stopped, so the benchmark's own input
    # generation is never timed
    inputs = [yardstick.make_trait(seed, 0, words, n, m, traffic)]
    stamp("traits_made")
    if trace:
        # the device's activity only: the host's spans are the benchmark's
        # own, so the trace stays small enough to read within the run
        undo = yardstick.wrap_products(drv.products_module(), rec, n, m)
        if cuda:
            rec.profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            rec.profiler.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    paused = 0.0
    with rec.span("window"):
        t = 0
        while True:
            if t == len(inputs):
                rec.sync()
                p0 = time.perf_counter()
                inputs.append(yardstick.make_trait(seed, t, words, n, m,
                                                   traffic))
                rec.sync()
                paused += time.perf_counter() - p0
            with rec.span("trait"):
                drv.run_trait(*inputs[t])
            t += 1
            # a traced run profiles one whole trait: the profiler's trace of
            # a longer window takes minutes to read
            if trace or time.perf_counter() - t0 - paused >= seconds:
                break
    window_s = time.perf_counter() - t0 - paused
    stamp("window")
    reduced = None
    if trace:
        undo()
        rec.stop_trace()
        stamp("profiler_stop")
        reduced = yardstick.reduce_trace(
            rec.device, rec,
            (rec.ranges[-1][0], rec.traced_until or rec.ranges[-1][1]))
        stamp("trace_read")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    values = {"trait_s": window_s / t, "peak_mem_gib": peak / 2**30,
              "setup_s": setup_s}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        record = dict(spans=rec.spans, counters=rec.counters, calls=rec.calls,
                      traits=t, trace=reduced)
        metrics = per_layer(spec, wl, record)
        device_info.update(busy_s=reduced["busy_s"],
                           window_s=reduced["window_s"])
    else:
        metrics = end_to_end(spec, wl, values)
    # the program's state goes before the reference runs; the words are
    # the benchmark's input and stay for it
    kept, chroms = drv.kept, drv.chroms
    drv.close()
    drv = None
    if cuda:
        torch.cuda.empty_cache()
    reference = importlib.import_module("gvbench.reference."
                                        + traffic["driver"])
    per_trait = reference.check(words, config, inputs[:t], kept,
                                chroms=chroms)
    stamp("reference")
    if control:
        ctrl = reference.check(words, config, inputs[:t], kept,
                               chroms=chroms, control=True)
        stamp("control")
    numbers = {k: max(p[k] for p in per_trait) for k in limits}
    failed = sum(not all(p[k] <= limits[k] for k in limits)
                 for p in per_trait)
    out = {"correct": failed == 0, "attempted": t, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["per_trait_checks"] = per_trait
    if control:
        out["control_checks"] = {k: max(p[k] for p in ctrl) for k in ctrl[0]}
    out["stages_s"] = {b[0]: b[1] - a[1] for a, b in zip(stamps, stamps[1:])}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = yardstick.bench_spec()
    wl = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if wl is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(wl["chips"])):
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run(spec, args.workload, args.seed, args.seconds,
              bool(args.trace), "cuda", T_START)
    found = yardstick.forbidden_modules(sys.modules)
    if found:
        print("loaded in the measuring process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
