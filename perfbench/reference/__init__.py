"""Plain PyTorch / NumPy references the benchmark holds the program to.

Nothing here imports ``jax``, ``lotus_tpu`` or ``lotus_tpu_torch``: the
references take the benchmark's own inputs and work out again whatever the
program derives from them.  f32 matrix products run with TF32 off.
"""
