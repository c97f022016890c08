"""The benchmark of adaptersis_tpu_torch: `python -m benchmark.run --workload <cell> ...`."""
