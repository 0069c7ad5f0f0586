"""snapbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

Run one cell with ``python3 snapbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``BENCHMARK.json``
there names the cells, and every configuration, traffic mix, per-layer
metric and layer map is a file of its own under this folder.
"""
