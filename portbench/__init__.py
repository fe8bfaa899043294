"""The benchmark of rootba_tpu_torch on one NVIDIA H100: whole BAL
solves, from the BAL text file to the solution in host memory.

`python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json from the root of a
checkout and prints one JSON line. Everything that measures or judges
the program lives here and imports nothing of it: the twin generator
and BAL writer (twin.py), the plain reference (references/), the
peaks and kernel counts (roofline.py) and the trace reduction
(trace.py).
"""
