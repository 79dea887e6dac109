"""sdrbench: the benchmark of pysdr_tpu_torch on one NVIDIA H100.

`python3 sdrbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once (harness.py). Configurations
(configs/), traffic mixes (traffic/), a cell's limits (checks/),
capture formats (captures/), metric readers (metrics/), reference chain
kinds (chains/) and RF station kinds (stations/) are files found by name
(registry.py). The plain reference that decides `correct` is
reference.py with chains/; it imports nothing of the program.
"""
