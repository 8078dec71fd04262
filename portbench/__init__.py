"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an NVIDIA H100.

One cell, one run, one process: ``python3 -m portbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout. The
cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json``; each is a file of its own under this folder (see
``README.md``). Nothing here imports JAX or the JAX package ``repro``;
``reference/`` imports nothing of ``repro_torch`` either.
"""
