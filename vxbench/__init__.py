"""The benchmark of vxtpu_torch on one NVIDIA H100.

``python3 vxbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that measures (the traffic generator, the trace
reduction, the peaks and bounds, the plain references and the comparison
that decides ``correct``) lives here, so that a change to the program
cannot move it. Nothing here imports jax, jaxlib or the JAX package.
"""
