"""kvbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 kvbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` through the port's
wall-clock ``LiveEngine`` on one card and prints one JSON result line.
Configurations (``configs/<name>.json``), traffic mixes
(``traffic/<mix>.json``), metrics (``metrics/<metric>.py``), references
(``reference/<arch>.py``) and correctness limits (``limits/<cell>.json``)
are files found by name, so a new cell needs no edit of a file here.
Nothing in this package imports JAX or the JAX package ``repro``.
"""
