"""flowbench: the benchmark of flow_supervisor_tpu_torch on one NVIDIA H100.

    python -m flowbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose ``runner`` names the code
in ``runners/`` that runs it); ``workloads/<cell>.json`` holds the cell's
correctness limits, and each per-layer metric is a reader in
``metrics/<metric>.py``. Everything is found by name, so a cell, a model or
a metric is added by adding files and entries.
"""
