"""The benchmark of the PyTorch and CUDA port (``consensuscruncher_tpu_torch``).

``python cctbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; see ``cctbench/README.md``.
"""
