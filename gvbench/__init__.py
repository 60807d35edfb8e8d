"""gvbench: the benchmark of gvamp_tpu_torch on an NVIDIA H100.

``python3 -m gvbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  See README.md."""
