"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command
(``python3 portbench/run.py --workload <cell> ...``) serves a cell of
``BENCHMARK.json`` on one H100 and prints one JSON line of its metrics."""
