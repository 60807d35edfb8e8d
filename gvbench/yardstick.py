"""The benchmark's own measuring pieces, kept apart from the program.

Nothing here imports ``gvamp_tpu_torch`` (or JAX): the packed words and
the traits are made from the seed by the benchmark's own recipe, the
card's peaks and each product's least time are the benchmark's own
arithmetic, and the spans, counters and the profiler's trace are reduced
here.  A driver hands what it made to the program; the reference reads
the same inputs.

Word layout (the PLINK .bed bytes as little-endian int32 words, word-major
[Nw, Mpad]): person ``n`` lies in word row ``n // 16``, byte ``(n % 16) //
4``, bit pair ``n % 4``; code 00 is dosage 2, 10 dosage 1, 11 dosage 0 and
01 a missing call.  Pad people and pad markers hold 01.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

# ---------------------------------------------------------------- files


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def data_file(kind: str, name: str, here: str = HERE) -> str:
    """``gvbench/<kind>/<name>.json``: a configuration, a traffic mix or a
    cell's limits, found by its name."""
    path = os.path.join(here, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def cell(spec: dict, workload: str, here: str = HERE):
    """(workload entry, configuration, traffic, limits) of one cell."""
    wl = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = load_json(os.path.join(os.path.dirname(here), conf["file"]))
    traffic = load_json(data_file("traffic", wl["traffic"], here))
    limits = load_json(data_file("limits", workload, here))
    return wl, config, traffic, limits


# ---------------------------------------------------------------- sizes


def n_words(n: int) -> int:
    """Word rows per marker: 16 people a word, padded to 32 rows."""
    words = math.ceil(math.ceil(n / 4) / 4)
    return math.ceil(words / 32) * 32


# ---------------------------------------------------------------- inputs

WORDS_CHUNK = 4096  # columns drawn per call: bounds the temporaries
_PAIRS_LO = 0x55555555


def _random_words(gen, nw, w, device):
    return torch.randint(-2**31, 2**31, (nw, w), dtype=torch.int32,
                         generator=gen, device=device)


def _signed(v: int) -> int:
    """A 32-bit pattern as the int32 value with those bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def n_markers(m: int) -> int:
    """Padded markers of one card's share: M rounded up to 512, as
    ``GenoBed.from_files`` lays them out (``marker_align``)."""
    return math.ceil(m / 512) * 512


def layout(config: dict):
    """(Nw, Mpad) of a configuration: the word rows and padded markers it
    states, which have to be those the program's loader gives its N and M
    (``n_words``, ``n_markers``), so that a cell runs the layout a user's
    cohort has."""
    nw, mpad = int(config["Nw"]), int(config["Mpad"])
    n, m = int(config["N"]), int(config["M"])
    if (nw, mpad) != (n_words(n), n_markers(m)):
        raise ValueError(f"layout Nw={nw}, Mpad={mpad} is not the loader's "
                         f"for N={n}, M={m}: Nw={n_words(n)}, "
                         f"Mpad={n_markers(m)}")
    return nw, mpad


def make_words(seed: int, n: int, m: int, miss: bool, device,
               nw: int, mp: int) -> torch.Tensor:
    """int32[Nw, Mpad] words from ``seed`` (``tools/common.synth_words``'s
    recipe): uniformly random codes with every missing code 01 turned into
    11, except that with ``miss`` the AND of four more random words keeps
    one in sixteen of them, so 1.5625% of the calls stay missing.  Pad
    people and pad markers are set to 01."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    words = torch.empty((nw, mp), dtype=torch.int32, device=device)
    for c in range(0, mp, WORDS_CHUNK):
        w = min(WORDS_CHUNK, mp - c)
        raw = _random_words(gen, nw, w, device)
        lo = raw & _PAIRS_LO
        hi = (raw >> 1) & _PAIRS_LO
        is01 = lo & ~hi
        if miss:
            keep = torch.full_like(raw, _PAIRS_LO)
            for _ in range(4):
                keep &= _random_words(gen, nw, w, device)
            is01 = is01 & ~keep
        words[:, c:c + w] = raw | (is01 << 1)
    words[:, m:] = _PAIRS_LO
    # people n >= N in the last word rows: their bit pairs set to 01
    row0 = n // 16
    for r in range(row0, nw):
        clear, fill = 0, 0
        for q in range(16):
            if 16 * r + q >= n:
                shift = 8 * ((q % 16) // 4) + 2 * (q % 4)
                clear |= 3 << shift
                fill |= 1 << shift
        if clear:
            words[r] = (words[r] & _signed(~clear & 0xFFFFFFFF)) | _signed(fill)
    return words


def decode_cols(words_cols: torch.Tensor, n: int):
    """(a, b) float32 [N, C] in person order for a few columns of words
    [Nw, C]: dosage and non-missing indicator."""
    nw, c = words_cols.shape
    shifts = torch.tensor([8 * (q // 4) + 2 * (q % 4) for q in range(16)],
                          dtype=torch.int32, device=words_cols.device)
    code = (words_cols[:, None, :] >> shifts[None, :, None]) & 3
    code = code.reshape(16 * nw, c)[:n]
    lo, hi = code & 1, code >> 1
    a = ((1 - lo) * (2 - hi)).to(torch.float32)
    b = (1 - lo * (1 - hi)).to(torch.float32)
    return a, b


def make_trait(seed: int, t: int, words: torch.Tensor, n: int, m: int,
               traffic: dict):
    """Trait ``t`` of seed ``seed`` (``bench.py:89-111``'s recipe): y =
    sum over ``causal`` markers drawn without replacement of the
    standardised genotype times beta ~ N(0, h2 / causal), plus N(0, 1 - h2)
    noise, then a share of the people set to NA (NaN).  h2 and the NA
    share are the traffic's lists in turn, so that every seed runs the same
    traits in the same order.  Also the probe of the Onsager trace:
    +-1/sqrt(M) on the real markers.  Returns float64 y [N] and the probe
    [Mpad, 1]."""
    h2 = float(traffic["h2"][t % len(traffic["h2"])])
    na_share = float(traffic["na_share"][t % len(traffic["na_share"])])
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, t])
    causal = int(traffic["causal"])
    idx = np.sort(rng.choice(m, size=causal, replace=False))
    beta = rng.standard_normal(causal) * math.sqrt(h2 / causal)
    g = torch.zeros(n, dtype=torch.float64, device=words.device)
    for lo in range(0, causal, 256):
        sel = torch.as_tensor(idx[lo:lo + 256], device=words.device)
        a, b = decode_cols(words[:, sel], n)
        a, b = a.double(), b.double()
        cnt = b.sum(dim=0)
        mean = a.sum(dim=0) / cnt
        sd = torch.sqrt(((a - mean) * b).square().sum(dim=0) / (cnt - 1))
        std = (a - mean) * b / sd
        g += std @ torch.as_tensor(beta[lo:lo + 256], device=words.device)
    y = g.cpu().numpy() + rng.standard_normal(n) * math.sqrt(1.0 - h2)
    n_na = int(round(na_share * n))
    if n_na:
        y[rng.choice(n, size=n_na, replace=False)] = np.nan
    probe = np.zeros((words.shape[1], 1))
    probe[:m, 0] = (rng.integers(0, 2, m) * 2 - 1) / math.sqrt(m)
    return y, probe


def upstream_prior(n: int, mt: int):
    """The reference gVAMP's default 23-component prior
    (utilities.cpp:91-140): user-scale probs and vars."""
    num_mix = 23
    p1 = min(50000.0 / mt, 1.0) / (2.0 - 1.0 / 2.0**21)
    probs = [1.0 - 50000.0 / mt] + [p1 / 2.0**i for i in range(num_mix - 1)]
    ratio = 10.0 ** (math.log10(1e2 / 1e-5) / (num_mix - 2))
    vars_ = [0.0] + [1e-5 * ratio**i for i in range(num_mix - 1)]
    return np.asarray(probs), np.asarray(vars_) / n


def chromosomes(config: dict) -> np.ndarray:
    """int32[M] chromosome of each marker of this card's share: the
    deployment's markers in genome order, autosome ``c`` holding its share
    of ``lengths`` (``chrom_rule``)."""
    rule = config["chrom_rule"]
    lengths = np.asarray(rule["lengths"], np.float64)
    total = int(config["Mt_deployment"])
    bounds = np.round(np.cumsum(lengths) / lengths.sum() * total)
    glob = int(config["S"]) + np.arange(int(config["M"]))
    return (np.searchsorted(bounds, glob, side="right") + 1).astype(np.int32)


# ---------------------------------------------------------------- peaks

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

# packed-matrix products: f32 columns read and written per right-hand side
# (forward: W, or W and U; transposed: the planar V in, av or av and bv out)
PRODUCTS = {"axm_i8a": ("m", 1, "n", 1), "atxm_i8a": ("n", 1, "m", 1),
            "axm_i8": ("m", 2, "n", 1), "atxm_i8": ("n", 1, "m", 2)}


def least_seconds(name: str, nw: int, mpad: int, n: int, m: int,
                  b: int) -> float:
    """The least time the card could take for one product call: the packed
    words read once and each f32 column in and out once at the HBM rate,
    against 2 N M B multiply-adds at the int8 tensor-core rate; the larger
    of the two."""
    side_in, k_in, side_out, k_out = PRODUCTS[name]
    length = {"m": mpad, "n": 16 * nw}
    nbytes = (4 * nw * mpad + 4 * b * (k_in * length[side_in]
                                      + k_out * length[side_out]))
    return max(nbytes / HBM_BYTES_PER_S, 2.0 * n * m * b / INT8_OPS_PER_S)


# ---------------------------------------------------------------- record

# the main kernel of each product, as the profiler names it (demangled or
# not): one launch per call
PRODUCT_KERNELS = {"axm_i8a": r"\baxm_i8_kernel(<0>|ILi0E)",
                   "axm_i8": r"\baxm_i8_kernel(<1>|ILi1E)",
                   "atxm_i8a": r"\batxm_i8_kernel(<false>|ILb0E)",
                   "atxm_i8": r"\batxm_i8_kernel(<true>|ILb1E)"}


class Recorder:
    """The run's spans (host clock, each ended by a synchronise: seconds
    by name, and every occurrence's host range in ``time.time_ns``, the
    profiler's clock), counters and product calls."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.spans: dict = {}
        self.ranges: list = []   # (start_ns, end_ns, name)
        self.counters: dict = {}
        self.calls: list = []    # (name, nw, mpad, n, m, b), while traced
        self.profiler = None     # the running torch.profiler, if any
        self.traced_until = None  # time_ns where the trace was stopped
        self.device = []         # the trace's device activity, once stopped

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def span(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        self.sync()
        self.ranges.append((w0, time.time_ns(), name))
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def count(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def stop_trace(self):
        """End the traced window here: stop the profiler and keep its
        device activity.  A driver calls it before a pass whose trace could
        not be read within the run; the harness at the window's end."""
        if self.profiler is not None:
            self.sync()
            self.traced_until = time.time_ns()
            self.profiler.__exit__(None, None, None)
            self.device = device_events(
                self.profiler.profiler.kineto_results.events())
            self.profiler = None


def wrap_products(module, recorder: Recorder, n: int, m: int):
    """Replace the packed-matrix products of ``module`` (the program's
    ``ops.matvec``) by wrappers that note each traced call's widths and
    every call's host range; returns the undo."""
    saved = {}
    for name in PRODUCTS:
        fn = getattr(module, name)
        saved[name] = fn

        def wrapped(words, X, *rest, _fn=fn, _name=name):
            nw, mpad = words.shape
            if recorder.traced_until is None:
                recorder.calls.append((_name, nw, mpad, n, m, X.shape[-1]))
            w0 = time.time_ns()
            try:
                return _fn(words, X, *rest)
            finally:
                recorder.ranges.append((w0, time.time_ns(),
                                        "product:" + _name))

        setattr(module, name, wrapped)

    def undo():
        for name, fn in saved.items():
            setattr(module, name, fn)

    return undo


# ---------------------------------------------------------------- trace


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_events(events) -> list:
    """(start_ns, end_ns, name) of the device's activity (kernels, copies,
    sets) among the profiler's events (``kineto_results.events()``)."""
    out = []
    for e in events:
        if str(e.device_type()).split(".")[-1] == "CPU":
            continue
        out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return out


def reduce_trace(device: list, recorder: Recorder, window: tuple) -> dict:
    """From the device's activity over the traced window (``window``, host
    range in ns): its busy seconds, the product kernels' device seconds
    paired in order with the calls (``product_s``: one per call, or None
    where the counts disagree), the device operations that took most time
    and the idle gaps, summed by the innermost benchmark span open on the
    host when each began."""
    w0, w1 = window
    busy = _merge([(s, e) for s, e, _ in device])
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict = {}
    for s, e, name in device:
        by_name.setdefault(name, []).append((s, e))
    by_op = {name: sum(e - s for s, e in iv) for name, iv in by_name.items()}
    kernels = {k: sorted(iv for name, ivs in by_name.items()
                         if re.search(pat, name) for iv in ivs)
               for k, pat in PRODUCT_KERNELS.items()}
    calls = {k: [c for c in recorder.calls if c[0] == k] for k in kernels}
    product_s = None
    if all(len(kernels[k]) == len(calls[k]) for k in kernels):
        product_s = [(c, (e - s) / 1e9) for k in kernels
                     for c, (s, e) in zip(calls[k], kernels[k])]
    # idle gaps within the window, each under the innermost span open at
    # its start (spans nest, so a stack swept along the gaps finds it)
    gaps: dict = {}
    ordered = sorted(recorder.ranges, key=lambda r: (r[0], -r[1]))
    stack, j, prev = [], 0, w0
    for s, e in [b for b in busy if b[1] > w0] + [[w1, w1]]:
        s = min(s, w1)
        if s > prev:
            while j < len(ordered) and ordered[j][0] <= prev:
                while stack and stack[-1][1] <= ordered[j][0]:
                    stack.pop()
                stack.append(ordered[j])
                j += 1
            while stack and stack[-1][1] <= prev:
                stack.pop()
            label = stack[-1][2] if stack else "none"
            gaps[label] = gaps.get(label, 0) + (s - prev)
        prev = max(prev, e)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "product_s": product_s,
        "device_ops": [[k, v / 1e9] for k, v in top],
        "idle_gaps": [[k, v / 1e9] for k, v in top_gaps],
    }


# ---------------------------------------------------------------- checks

FORBIDDEN = ("jax", "jaxlib", "flax", "gvamp_tpu")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``gvamp_tpu_torch`` is not ``gvamp_tpu``)."""
    return sorted({name for name in modules
                   if name.split(".")[0] in FORBIDDEN})
