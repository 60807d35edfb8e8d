"""The port's program spans (``gvamp_tpu_torch.trace``): nothing recorded
and the same numbers without a profiler; under one, every span site of the
layer table recorded and nested, on the profiler's own clock; the
``--profile-dir`` trace with the spans beside the profiler's events.  The
card test (``card``: ``python -m pytest --noconftest tests/test_torch_trace.py
-m card -s`` on the card) places each product span's kernel on the device
timeline."""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist
from torch.profiler import ProfilerActivity, profile

from gvamp_tpu_torch import cli, dist, linear, multi, probit, robust, sim, trace
from gvamp_tpu_torch.data import GenoBed
from gvamp_tpu_torch.io import plink
from gvamp_tpu_torch.ops import matvec, pvals
from gvamp_tpu_torch.sync import SYNCS
from tests_shim import make_bed_bytes

torch.set_num_threads(1)

SEED, N, M, CV, H2 = 31, 500, 320, 20, 0.6
CHROMS = np.repeat(np.arange(1, 5), M // 4)
CFG = dict(rho=0.3, gam1_init=1e-8, gamw_init=2.0, seed=5,
           stop_criteria_thr=0.0)
PHASES = {"linear": ["denoise", "z1_project", "lmmse_cg", "noise_em",
                     "finish"],
          "probit": ["denoise_x", "denoise_z", "lmmse_cg", "lmmse_z_finish"],
          "robust": ["denoise_x", "denoise_z", "lmmse_cg", "lmmse_z_finish"]}
# the sites one linear trait reaches: the statistics pass, the engine, the
# solver, the products and the p-values
TRAIT_SITES = {"marker_stats", "infer",
               "iteration", "fetch", "host_bool", "host_values",
               "prior.update", "prior.em", "prior.merge", "cg.warm_start",
               "cg.solve", "slq.build", "slq.quad", "product", "pvals.loco",
               "pvals.loo", "pvals.predictor", "pvals.moments",
               "pvals.tests"} | set(PHASES["linear"])


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def problem():
    """2% missing calls (the two-plane products), a linear phenotype."""
    rng = np.random.default_rng(SEED)
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.02)
    vars_t, probs_t = sim.two_group_prior(M, CV, H2)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    g = GenoBed.from_arrays(make_bed_bytes(codes), np.zeros(N), N=N,
                            standardize_phen=False, device="cpu")
    y = sim.simulate_linear_phenotype(g, beta, 1 / (1 - H2), rng)
    return codes, y, beta, vars_t, probs_t


def _geno(codes, **kw):
    return GenoBed.from_arrays(make_bed_bytes(codes), np.zeros(N), N=N,
                               standardize_phen=False, device="cpu", **kw)


def _trait(g, problem, n_it=3):
    """One trait as the benchmark's gwas mix runs it, then the LOO
    p-values: (estimate, history, LOCO and LOO p-values)."""
    _, y, _, vars_t, probs_t = problem
    g.set_phen(y)
    x, state, hist = linear.infer(g, linear.VampConfig(max_iter=n_it, **CFG),
                                  probs_t, vars_t, verbose=False)
    p_loco = pvals.loco_pvals(g, state.z1, state.x1, CHROMS)
    p_loo = pvals.loo_pvals(g, state.z1, state.x1)
    return x, hist, p_loco, p_loo


def _children(records, i):
    return [s for s in records if s.parent == i]


def test_no_profiler_no_record_and_the_same_numbers(problem):
    """Without a profiler the store stays empty and every span is the one
    shared no-op; under ``torch.profiler`` (CPU activity) the trait gives
    the same estimate, history and p-values bit for bit."""
    trace.clear()
    assert trace.span("a", it=1) is trace.span("b")
    off = _trait(_geno(problem[0]), problem)
    assert trace.spans() == [] and trace.ranges() == []
    with _cpu_profile():
        on = _trait(_geno(problem[0]), problem)
    assert trace.spans()
    np.testing.assert_array_equal(on[0], off[0])
    for a, b in zip(on[1], off[1]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    np.testing.assert_array_equal(on[2], off[2])
    np.testing.assert_array_equal(on[3], off[3])
    trace.clear()


@pytest.fixture(scope="module")
def traced(problem):
    """One trait under the profiler: (records, history, SYNCS change)."""
    g = _geno(problem[0])
    trace.clear()
    s0 = SYNCS["count"]
    with _cpu_profile():
        _, hist, _, _ = _trait(g, problem)
    out = trace.spans(), hist, SYNCS["count"] - s0
    trace.clear()
    return out


def test_every_site_records_nested(traced):
    """Every site one trait reaches records, each closed span inside its
    parent and in its parent's sequence; the top-level spans (the
    statistics pass, the fit, the two p-value calls) each take their own
    sequence number.  The statistics pass is one span with its path and
    the words' shape, and no span inside."""
    records, _, _ = traced
    assert {s.name for s in records} == TRAIT_SITES
    for s in records:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = records[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s
            assert s.seq == p.seq
    tops = [s for s in records if s.parent < 0]
    assert [s.name for s in tops] == ["marker_stats", "infer", "pvals.loco",
                                      "pvals.loo"]
    assert len({s.seq for s in tops}) == 4
    assert tops[0].attrs == {"path": "plain", "markers": 512,
                             "word_rows": 32}
    assert _children(records, tops[0].index) == []
    assert [s.name for s in _children(records, tops[2].index)] == [
        "pvals.predictor", "pvals.moments", "pvals.tests"]


def test_ranges_are_the_spans(problem):
    """``ranges()`` gives (start_ns, end_ns, name) of every closed span,
    the form a trace reader's host ranges take; ``clear()`` empties it."""
    trace.clear()
    with _cpu_profile():
        with trace.span("outer"):
            _geno(problem[0])
        open_span = trace.span("open")
        open_span.__enter__()
    assert trace.ranges() == [(s.start_ns, s.end_ns, s.name)
                              for s in trace.spans()[:-1]]
    assert trace.spans()[-1] is open_span and trace.ranges()[0][2] == "outer"
    open_span.__exit__(None, None, None)
    trace.clear()
    assert trace.spans() == [] and trace.ranges() == []


def test_one_iteration_span_per_history_entry(traced):
    """One ``iteration`` span per history entry, numbered as the entry,
    each holding the linear engine's five phases in order; the solver's
    spans sit in ``lmmse_cg`` and the prior update in ``denoise``."""
    records, hist, _ = traced
    its = [s for s in records if s.name == "iteration"]
    assert [s.attrs["it"] for s in its] == [h["it"] for h in hist]
    for s in its:
        phases = _children(records, s.index)
        assert [p.name for p in phases] == PHASES["linear"]
        kids = {c.name for p in phases for c in _children(records, p.index)}
        assert {"cg.solve", "cg.warm_start", "prior.update"} <= kids
    solves = [s for s in records if s.name == "cg.solve"]
    assert all(records[s.parent].name == "lmmse_cg" for s in solves)
    assert [s.attrs["steps"] for s in solves] == [h["cg_iters"]
                                                  for h in hist]
    assert len([s for s in records if s.name == "fetch"]) == len(hist)


def test_sync_spans_equal_the_counter(traced):
    """Each counted sync is one ``host_bool`` or ``host_values`` span, and
    each span's sync count is the counter's change over it."""
    records, hist, n_syncs = traced
    reads = [s for s in records if s.name in ("host_bool", "host_values")]
    assert len(reads) == n_syncs > 0
    assert all(s.syncs == 1 for s in reads)
    its = [s for s in records if s.name == "iteration"]
    fetch = [s for s in records if s.name == "fetch"]
    assert [s.syncs + f.syncs for s, f in zip(its, fetch)] == [
        h["host_syncs"] for h in hist]


@pytest.mark.parametrize("name,B", [("axm_i8", 3), ("atxm_i8", 5),
                                    ("axm_i8a", 2), ("atxm_i8a", 7),
                                    ("axm_i8s", 4), ("atx", 1), ("ax", 1),
                                    ("atx_a", 1)])
def test_product_spans_carry_the_widths(problem, name, B):
    """A product wrapper called at width B is one ``product`` span with
    its name and B (the single-vector products: B = 1)."""
    g = _geno(problem[0])
    words = g.words
    nw, m = words.shape
    gen = torch.Generator().manual_seed(B)
    col = torch.randn((m, B), generator=gen)
    planar = torch.randn((4, 4 * nw, B), generator=gen)
    args = {"axm_i8": (col, col), "axm_i8a": (col,), "axm_i8s": (col, col),
            "atxm_i8": (planar,), "atxm_i8a": (planar,),
            "atx": (planar[..., 0],), "atx_a": (planar[..., 0],),
            "ax": (col[:, 0], col[:, 0])}[name]
    trace.clear()
    with _cpu_profile():
        getattr(matvec, name)(words, *args)
    rec = trace.spans()
    trace.clear()
    assert [(s.name, s.attrs) for s in rec] == [("product",
                                                {"name": name, "B": B})]


@pytest.mark.parametrize("engine", ["probit", "robust", "multi"])
def test_other_engines_record_their_phases(problem, engine):
    """The probit and Huber engines: ``infer`` and one ``iteration`` per
    history entry holding their own phase names; the multi-trait engine
    (no phases): ``infer`` and its iterations."""
    codes, y, beta, vars_t, probs_t = problem
    g = _geno(codes)
    rng = np.random.default_rng(7)
    if engine == "probit":
        g.set_phen(sim.simulate_probit_phenotype(g, beta, 1.0, rng))
        run = lambda: probit.infer(  # noqa: E731
            g, probit.ProbitConfig(max_iter=2, rho=0.3, seed=2,
                                   probit_var=1.0), probs_t, vars_t,
            verbose=False)
    elif engine == "robust":
        g.set_phen(y + rng.standard_t(3.0, N) * 0.3)
        run = lambda: robust.infer(  # noqa: E731
            g, robust.RobustConfig(max_iter=2, rho=0.3, seed=5), probs_t,
            vars_t, verbose=False)
    else:
        mp = multi.MultiPhen.build(g, [y, y + rng.standard_normal(N)])
        run = lambda: multi.infer(  # noqa: E731
            mp, linear.VampConfig(max_iter=2, **CFG), probs_t, vars_t,
            verbose=False)
    trace.clear()
    with _cpu_profile():
        _, _, hist = run()
    rec = trace.spans()
    trace.clear()
    top = [s for s in rec if s.parent < 0]
    assert [(s.name, s.attrs) for s in top] == [("infer",
                                                {"engine": engine})]
    its = [s for s in rec if s.name == "iteration"]
    assert [s.attrs["it"] for s in its] == [h["it"] for h in hist]
    for s in its:
        assert [c.name for c in _children(rec, s.index)
                if c.name in PHASES.get(engine, ())] == PHASES.get(engine, [])


def test_phase_timers_record_the_same_spans(problem):
    """``phase_timers``: the phases are still spans under a profiler, and
    the step's phase_ms entries are the spans' times."""
    _, y, _, vars_t, probs_t = problem
    g = _geno(problem[0])
    g.set_phen(y)
    trace.clear()
    with _cpu_profile():
        _, _, hist = linear.infer(g, linear.VampConfig(max_iter=2, **CFG),
                                  probs_t, vars_t, verbose=False,
                                  phase_timers=True)
    rec = trace.spans()
    trace.clear()
    its = [s for s in rec if s.name == "iteration"]
    for s, h in zip(its, hist):
        phases = _children(rec, s.index)
        assert [p.name for p in phases] == PHASES["linear"]
        for p in phases:
            assert h[f"phase_ms_{p.name}"] == p.ms


def test_mesh_collectives_record_their_bytes(problem, tmp_path):
    """A two-shard mesh: its statistics pass all-gathers per slab
    (``all_gather``) and a forward product sums the shards
    (``all_reduce``), each with its bytes; in a process group the
    replication check is an ``all_gather`` too."""
    codes = problem[0]
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                             world_size=1, rank=0)
    try:
        mesh = dist.Mesh(2, "cpu")
        trace.clear()
        with _cpu_profile():
            g = _geno(codes, mesh=mesh)
            g.ax(g.pad_m(np.ones(M)))
            mesh.assert_replicated(g.mave)
        rec = trace.spans()
        trace.clear()
    finally:
        tdist.destroy_process_group()
    names = [s.name for s in rec]
    assert "all_reduce" in names and "all_gather" in names
    assert names.count("marker_stats") == 2
    assert names[-1] == "all_gather" and rec[-1].attrs["bytes"] == 8
    assert all(s.attrs["bytes"] > 0 for s in rec
               if s.name in ("all_reduce", "all_gather"))


def test_spans_on_the_profilers_clock():
    """A span around torch ops contains the profiler's own CPU events of
    those ops: both read ``time.time_ns``."""
    trace.clear()
    with _cpu_profile() as prof:
        with trace.span("outer") as sp:
            x = torch.ones(1000)
            for _ in range(5):
                x = x * 1.5 + 1.0
    trace.clear()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() in ("aten::mul", "aten::add")]
    assert len(ops) == 10
    for e in ops:
        assert sp.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= sp.end_ns


def test_profile_dir_writes_the_spans(tmp_path, capsys):
    """--profile-dir on the CPU: trace.json holds the program's spans as
    complete events on a row of their own, inside the range of the
    profiler's CPU events, and the run prints one line per span name."""
    rng = np.random.default_rng(3)
    codes = sim.random_genotypes(rng, M, N)
    bed, phen = str(tmp_path / "d.bed"), str(tmp_path / "d.phen")
    plink.write_bed(bed, codes)
    plink.write_phen(phen, rng.standard_normal(N))
    prof = str(tmp_path / "prof")
    cli.main(["--run-mode", "infere", "--model", "linear", "--device", "cpu",
              "--bed-file", bed, "--phen-files", phen, "--N", str(N),
              "--Mt", str(M), "--iterations", "2", "--probs", "0.9,0.1",
              "--vars", "0.0,0.01", "--out-dir", str(tmp_path / "out"),
              "--out-name", "p", "--profile-dir", prof])
    out = capsys.readouterr().out
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program"]
    others = [e for e in events if e.get("ph") == "X"
              and e.get("cat") != "program"]
    assert {e["name"] for e in mine} >= {"marker_stats", "infer",
                                         "iteration", "product", "cg.solve"}
    assert len({e["pid"] for e in mine}) == 1
    assert mine[0]["pid"] not in {e["pid"] for e in others}
    lo = min(e["ts"] for e in others)
    hi = max(e["ts"] + e["dur"] for e in others)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in mine)
    infer = [e for e in mine if e["name"] == "infer"][0]
    inside = [e for e in others if e["name"] == "aten::mul"
              and infer["ts"] <= e["ts"] <= infer["ts"] + infer["dur"]]
    assert inside
    lines = {ln.split()[0]: ln.split() for ln in out.splitlines()
             if ln.split()}
    assert lines["iteration"][1] == "2" and lines["infer"][1] == "1"
    assert trace.spans() == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test places kernels on the card's "
                    "timeline")


@pytest.mark.card
def test_product_kernels_start_inside_their_spans(card):
    """On the card, under the benchmark's profiler (device activity
    only): each ``product`` span's kernel starts after the span's start on
    the device timeline, no device event carries a span's name, and the
    offsets are printed."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, m = 65_536, 8_192
    words = torch.randint(-2**31, 2**31 - 1, (n // 16, m), generator=gen,
                          dtype=torch.int32, device="cuda")
    W = torch.randn((m, 2), generator=gen, device="cuda")
    V = torch.randn((4, n // 4, 2), generator=gen, device="cuda")
    matvec.atxm_i8(words, V)
    matvec.axm_i8(words, W, W)
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            matvec.axm_i8(words, W, W)
            matvec.atxm_i8(words, V)
        torch.cuda.synchronize()
    rec = trace.spans()
    trace.clear()
    dev = [(e.start_ns(), e.name()) for e in
           prof.profiler.kineto_results.events()
           if str(e.device_type()).split(".")[-1] != "CPU"]
    names = {s.name for s in rec}
    assert not [d for d in dev if d[1] in names]
    assert [s.attrs["name"] for s in rec] == ["axm_i8", "atxm_i8"] * 5
    for want in ("axm_i8", "atxm_i8"):
        spans = [s for s in rec if s.attrs["name"] == want]
        kern = sorted(t for t, nm in dev if f"{want}_kernel" in nm)
        assert len(kern) == len(spans)
        for s, t in zip(spans, kern):
            print(f"{want}: kernel starts {(t - s.start_ns) / 1e3:.1f} us "
                  f"after its span's start, span {s.ms * 1e3:.1f} us")
            assert t >= s.start_ns
