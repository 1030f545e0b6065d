"""Gemma as ``nn.Module``s, under Hugging Face's names (an RM only: the Flax
sequence-classification auto class does not map the type).

The forward is Flax Gemma's (``transformers/models/gemma/modeling_flax_gemma.py``):
Llama's skeleton (``llama.py``) with four differences:

- RMSNorm scales by ``1 + weight`` (``:163``);
- the token embeddings are multiplied by ``hidden_size ** 0.5`` (``:631``);
- the MLP's activation is ``hidden_activation``, and
  ``gelu_pytorch_tanh`` (the tanh GELU) where it is unset, whatever
  ``hidden_act`` says (``:352-363``);
- each head is ``head_dim`` wide, from the config, not hidden / heads
  (gemma-2b: 8 heads of 256 over a 2048-wide stream, one KV head).

The modules are Llama's, read under this config.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

from lotus_tpu_torch.models.llama import LlamaConfig


@dataclass(frozen=True)
class GemmaConfig(LlamaConfig):
    """The fields of a Gemma ``config.json`` the forward reads (the defaults
    are ``transformers``' ``GemmaConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("gemma",)
    activation_key: ClassVar[str] = "hidden_activation"
    norm_offset: ClassVar[float] = 1.0
    embedding_scale: ClassVar[bool] = True

    vocab_size: int = 256000
    hidden_size: int = 3072
    intermediate_size: int = 24576
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int | None = 16
    head_dim: int = 256
    hidden_activation: str = "gelu_pytorch_tanh"
    max_position_embeddings: int = 8192

    @classmethod
    def from_dict(cls, cfg: dict):
        """An unset (``null``) ``hidden_activation`` is the tanh GELU."""
        return super().from_dict({**cfg, "hidden_activation": cfg.get("hidden_activation") or "gelu_pytorch_tanh"})

    @property
    def head_size(self) -> int:
        return self.head_dim
