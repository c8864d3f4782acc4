"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Every
configuration, traffic mix, cell and per-layer metric is a file of its
own under this folder, found by the name ``BENCHMARK.json`` gives it
(:mod:`perfbench.registry`).
"""
