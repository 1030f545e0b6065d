"""Mistral as ``nn.Module``s, under Hugging Face's names (an RM only: the
Flax sequence-classification auto class does not map the type).

The forward is Flax Mistral's
(``transformers/models/mistral/modeling_flax_mistral.py``): Llama's
skeleton (``llama.py``) without attention biases (``:239-242``), with
the causal mask banded by the sliding window as Flax bands it:
``triu(causal, k=-(sliding_window or 0))`` (``:242-243``), so query i sees
keys i - sliding_window .. i, and a ``null`` window (Mistral-7B-v0.2 and
v0.3) leaves each token only itself.  ``rope_theta`` is stored by Flax and
never used: rotary runs at base 10000.  The modules are Llama's, read
under this config.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from lotus_tpu_torch.models.llama import LlamaConfig


@dataclass(frozen=True)
class MistralConfig(LlamaConfig):
    """The fields of a Mistral ``config.json`` the forward reads (the
    defaults are ``transformers``' ``MistralConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("mistral",)

    intermediate_size: int = 14336
    num_key_value_heads: int | None = 8
    max_position_embeddings: int = 4096 * 32
    rms_norm_eps: float = 1e-6
    sliding_window: int | None = 4096

    @property
    def qkv_bias(self) -> bool:
        return False

    def allowed(self, s: int, device: torch.device) -> torch.Tensor:
        """(s, s) bool: causal, and no further back than the window (the
        diagonal alone without one)."""
        return super().allowed(s, device).triu(-(self.sliding_window or 0))
