"""Vector stores of the port: the device-resident ``TorchVS``."""

from lotus_tpu_torch.vector_store.vs import VS
from lotus_tpu_torch.vector_store.torch_vs import TorchVS

__all__ = ["VS", "TorchVS"]
