"""The benchmark of the PyTorch port (``pnnp_tpu_torch``) on NVIDIA GPUs.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. See
``portbench/harness.py`` for how cells, traffic mixes, drivers, limits and
metric readers are found by name.
"""
