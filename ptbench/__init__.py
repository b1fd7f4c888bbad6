"""ptbench: the benchmark of tpu_pathtracer_torch on an NVIDIA H100.

`python -m ptbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json (`run.py`).  Nothing here imports JAX or
the JAX package; `reference/` imports nothing of the program either.
"""
