"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell a run.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one entry of ``BENCHMARK.json``'s ``workloads``; ``README.md`` says how
the harness finds a cell's configuration, traffic mix and metric readers by
name.  Nothing here imports JAX or the JAX package ``repro``.
"""
