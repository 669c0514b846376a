"""Benchmark of the PyTorch and CUDA port (``src/repro_torch``) on NVIDIA cards.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON line. Everything is found by name:
``workloads/<cell>.json`` names a configuration (``configs/``) and a
traffic mix (``traffic/``), the mix names a layout (``layouts/``), and
``BENCHMARK.json`` names the per-layer metrics (``metrics/``). The counts
of work (``flops.py``), the traffic generator (``synth.py``), the weights
(``weights.py``) and the plain reference (``reference/``) are the
yardstick and import nothing of the port.
"""
