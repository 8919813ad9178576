"""The benchmark of ``latice_tpu_torch`` on an NVIDIA H100.

One cell per process: ``python3 -m port_bench.run --workload <name> --seed
<n> --seconds <s> --trace <0|1>``. Everything that measures (traffic
generation, the plain reference, the comparison that decides ``correct``,
the peaks, operation and byte counts, the reading of the profiler) lives in
this folder; from the program it takes only the system under test, its
counters and its kernel names. Nothing here imports JAX or the JAX package.
"""
