"""Compute core of the port: flat search, k-means, IVF build/load/rescore,
and the grouped IVF probe with its CUDA kernel (``ops/ivf_probe.py``)."""
