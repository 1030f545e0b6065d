"""The benchmark of lotus_tpu_torch: ``python3 perfbench/run.py --help``."""
