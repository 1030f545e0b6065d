"""lotus_tpu_torch: the PyTorch/CUDA port of lotus_tpu's retrieval engine.

A second package beside ``lotus_tpu`` (the JAX reference).  It imports
``torch`` and numpy only: no jax, no pandas and no ``lotus_tpu``, so it runs
on a machine that has neither.  Its stores satisfy the same ``VS`` contract,
so ``lotus_tpu.settings.configure(vs=TorchVS(...))`` puts it behind the
pandas semantic operators where both packages are installed.

f32 scoring runs at full precision (no TF32), as the reference's
``Precision.HIGHEST`` does (``lotus_tpu/ops/flat.py:50-57``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from lotus_tpu_torch.types import RMOutput  # noqa: E402
from lotus_tpu_torch.vector_store import VS, TorchVS  # noqa: E402

__all__ = ["RMOutput", "VS", "TorchVS"]
