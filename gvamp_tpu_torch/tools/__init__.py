"""The port's tools: the kernel check, the fused-Gram study, the kernel
profile, the stream-ceiling studies and the round-2 candidates
(counterparts of ``tools/tpu_check.py``, ``tools/bench_gram.py``,
``tools/profile_kernels.py``, ``tools/bench_stream.py``,
``tools/bench_variants.py`` and ``tools/bench_round2.py``), ``v6_fused_ab``
beside ``axm_i8s`` (``bench_fused_ab``, which has no JAX counterpart), and
the helpers they share with ``chip_smoke.py`` (``common``).

Each tool is a module with ``main(argv=None)`` that returns an exit code:

    python3 -m gvamp_tpu_torch.tools.kernel_check [--device cuda|cpu]
    python3 -m gvamp_tpu_torch.tools.bench_gram [NW] [M] [--device ...]
    python3 -m gvamp_tpu_torch.tools.profile_kernels [NW] [M] [REPS] [...]
    python3 -m gvamp_tpu_torch.tools.bench_stream [NW] [M] [REPS] [...]
    python3 -m gvamp_tpu_torch.tools.bench_variants [NW] [M] [REPS] [...]
    python3 -m gvamp_tpu_torch.tools.bench_round2 [NW] [M] [REPS] [...]
    python3 -m gvamp_tpu_torch.tools.bench_fused_ab [N] [M] [REPS] [...]

They run on the card unless ``--device cpu`` is given; importing one does
nothing.
"""
