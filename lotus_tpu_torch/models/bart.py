"""BART as ``nn.Module``s, under Hugging Face's names: the encoder-decoder
and the sequence classifier, and the skeleton the other encoder-decoder
families (``mbart.py``, ``pegasus.py``, ``blenderbot.py``,
``blenderbot_small.py``) run under their own layouts.

The forward is Flax BART's (``transformers/models/bart/modeling_flax_bart.py``),
which ``JaxSentenceEncoderRM`` and ``JaxCrossEncoderReranker`` run as XLA
when called with ids and mask only:

- the decoder's inputs are the ids shifted one to the right behind
  ``decoder_start_token_id`` (``shift_tokens_right``, ``:220``), its mask
  all ones, so its self-attention is causal only; its cross-attention uses
  the encoder's mask (``:1206-1211``);
- the token embeddings (``shared``, tied to both stacks) are scaled by
  sqrt(d_model) under ``scale_embedding``; learned positions are read from
  row ``position_ids + 2`` (``:710``, ``:735``, ``:805``) and
  ``layernorm_embedding`` follows their sum;
- per layer q/k/v/out projections with the query scaled by 1/sqrt(head
  size), an additive bias of ``finfo(dtype).min`` where a mask is 0,
  softmax, and the ``fc1`` / ``activation_function`` / ``fc2`` block; every
  LayerNorm at eps 1e-5, after each residual (post-LN);
- ``BartModel``'s output is the decoder's last hidden state, which the RM
  mean-pools under the encoder's mask;
- ``BartForSequenceClassification`` sums the decoder states at every
  position where ``input_ids == eos_token_id``, in the hidden dtype, and
  applies ``classification_head`` (dense, tanh, ``out_proj``).  Flax keeps
  only the last ``<eos>`` of a row when the mask is concrete
  (``:1599-1613``), but under the reference's ``jax.jit`` it is a tracer
  and that step is skipped: the reference, and so the port, sums the states
  at every ``</s>``.

Flax builds the decoder's causal mask at ``max_position_embeddings``
(``:263``), so a longer sequence fails to broadcast; the port raises
``ValueError`` there too (``check_length``), before it runs anything.

A family's layout is its config's class variables: ``pre_norm`` (LayerNorm
before each block, and a final ``layer_norm`` over each stack),
``embedding_norm`` (``layernorm_embedding``) and ``position_offset`` (the
first row of the learned position table, or None for sinusoidal positions).
Plain ``nn.Linear``, ``torch.matmul`` and ``softmax``: no fused attention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch
from torch import nn

from lotus_tpu_torch.models.bert import ACTIVATIONS, BertSelfAttention, EncoderConfig, mask_bias

LAYER_NORM_EPS = 1e-5  # fixed in the reference's modules, not read from the config


@dataclass(frozen=True)
class BartConfig(EncoderConfig):
    """The fields of a BART ``config.json`` the forward reads (the defaults
    are ``transformers``' ``BartConfig``'s); ``hidden_size`` is ``d_model``,
    as ``attribute_map`` makes it."""

    model_types: ClassVar[tuple[str, ...]] = ("bart",)
    activation_key: ClassVar[str] = "activation_function"
    pre_norm: ClassVar[bool] = False
    embedding_norm: ClassVar[bool] = True
    position_offset: ClassVar[int | None] = 2

    vocab_size: int = 50265
    max_position_embeddings: int = 1024
    d_model: int = 1024
    encoder_layers: int = 12
    encoder_ffn_dim: int = 4096
    encoder_attention_heads: int = 16
    decoder_layers: int = 12
    decoder_ffn_dim: int = 4096
    decoder_attention_heads: int = 16
    activation_function: str = "gelu"
    scale_embedding: bool = False
    pad_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int | None = 2
    num_labels: int = 3

    @property
    def hidden_size(self) -> int:
        return self.d_model


def check_length(cfg: BartConfig, seq_len: int) -> None:
    """The reference's decoder builds its causal mask at
    ``max_position_embeddings`` and fails on a longer sequence."""
    if seq_len > cfg.max_position_embeddings:
        raise ValueError(f"a {seq_len}-token bucket is longer than max_position_embeddings "
                         f"{cfg.max_position_embeddings}: the reference's decoder builds its causal mask at "
                         f"{cfg.max_position_embeddings} positions and fails to broadcast it; cut max_seq_length "
                         f"to {cfg.max_position_embeddings}")


def shift_tokens_right(input_ids: torch.Tensor, start: int) -> torch.Tensor:
    """BART's decoder inputs: ``start``, then the ids but the last."""
    first = torch.full_like(input_ids[:, :1], start)
    return torch.cat([first, input_ids[:, :-1]], dim=1)


def causal_bias(s: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(1, 1, s, s): 0 on and below the diagonal, ``finfo(dtype).min`` above."""
    bias = torch.full((s, s), torch.finfo(dtype).min, dtype=dtype, device=device)
    return bias.triu(1)[None, None]


class BartAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(width, width) for _ in range(4))

    def forward(self, x: torch.Tensor, kv: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """``x`` attends to ``kv`` (itself, or the encoder's states)."""
        h = x.shape[-1]

        def split(t):  # (b, s, h) -> (b, heads, s, head size)
            return t.view(t.shape[0], t.shape[1], self.heads, h // self.heads).transpose(1, 2)

        ctx = BertSelfAttention.attend(split(self.q_proj(x)), split(self.k_proj(kv)), split(self.v_proj(kv)), bias)
        return self.out_proj(BertSelfAttention.merge(ctx))


class BartEncoderLayer(nn.Module):
    def __init__(self, cfg: BartConfig, heads: int | None = None, ffn: int | None = None):
        super().__init__()
        d = cfg.d_model
        self.pre_norm = cfg.pre_norm
        self.self_attn = BartAttention(d, heads or cfg.encoder_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=LAYER_NORM_EPS)
        self.fc1 = nn.Linear(d, ffn or cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(ffn or cfg.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=LAYER_NORM_EPS)
        self.act = ACTIVATIONS[cfg.activation_function]

    def residual(self, x: torch.Tensor, norm: nn.LayerNorm, block) -> torch.Tensor:
        """``x + block(norm(x))`` pre-LN, ``norm(x + block(x))`` post-LN."""
        return x + block(norm(x)) if self.pre_norm else norm(x + block(x))

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.residual(x, self.final_layer_norm, lambda h: self.fc2(self.act(self.fc1(h))))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.residual(x, self.self_attn_layer_norm, lambda h: self.self_attn(h, h, bias))
        return self.feed_forward(x)


class BartDecoderLayer(BartEncoderLayer):
    def __init__(self, cfg: BartConfig):
        super().__init__(cfg, cfg.decoder_attention_heads, cfg.decoder_ffn_dim)
        self.encoder_attn = BartAttention(cfg.d_model, cfg.decoder_attention_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, memory: torch.Tensor,
                cross_bias: torch.Tensor) -> torch.Tensor:
        x = self.residual(x, self.self_attn_layer_norm, lambda h: self.self_attn(h, h, bias))
        x = self.residual(x, self.encoder_attn_layer_norm, lambda h: self.encoder_attn(h, memory, cross_bias))
        return self.feed_forward(x)


class BartStack(nn.Module):
    """What the encoder and the decoder share: the positions, the
    embedding's scale and norms, the layers and the final norm."""

    layer_cls: ClassVar[type[nn.Module]] = BartEncoderLayer
    layers_key: ClassVar[str] = "encoder_layers"

    def __init__(self, cfg: BartConfig):
        super().__init__()
        self.config = cfg
        d = cfg.d_model
        self.scale = math.sqrt(d) if cfg.scale_embedding else 1.0
        if cfg.position_offset is not None:
            self.embed_positions = nn.Embedding(cfg.max_position_embeddings + cfg.position_offset, d)
        if cfg.embedding_norm:
            self.layernorm_embedding = nn.LayerNorm(d, eps=LAYER_NORM_EPS)
        self.layers = nn.ModuleList(self.layer_cls(cfg) for _ in range(getattr(cfg, self.layers_key)))
        if cfg.pre_norm:
            self.layer_norm = nn.LayerNorm(d, eps=LAYER_NORM_EPS)

    def positions(self, s: int, like: torch.Tensor) -> torch.Tensor:
        """(s, d): the position rows of 0 .. s-1 (``like``, the token
        embedding table, gives a computed table its device and dtype)."""
        off = self.config.position_offset
        return self.embed_positions.weight[off : off + s]

    def embed(self, embed_tokens: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
        x = embed_tokens(ids) * self.scale + self.positions(ids.shape[1], embed_tokens.weight)
        return self.layernorm_embedding(x) if self.config.embedding_norm else x

    def finish(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(x) if self.config.pre_norm else x


class BartEncoder(BartStack):
    def forward(self, ids: torch.Tensor, bias: torch.Tensor, embed_tokens: nn.Embedding) -> torch.Tensor:
        x = self.embed(embed_tokens, ids)
        for layer in self.layers:
            x = layer(x, bias)
        return self.finish(x)


class BartDecoder(BartStack):
    layer_cls = BartDecoderLayer
    layers_key = "decoder_layers"

    def forward(self, ids: torch.Tensor, memory: torch.Tensor, cross_bias: torch.Tensor,
                embed_tokens: nn.Embedding) -> torch.Tensor:
        x = self.embed(embed_tokens, ids)
        bias = causal_bias(ids.shape[1], x.dtype, x.device)
        for layer in self.layers:
            x = layer(x, bias, memory, cross_bias)
        return self.finish(x)


def _tie_embeddings(module: "BartModel", state: dict, prefix: str, *_) -> None:
    """``encoder.embed_tokens`` and ``decoder.embed_tokens`` are ``shared``:
    a checkpoint may carry any of the three; only ``shared`` is loaded, and
    one that differs from it raises (the reference would drop it unread)."""
    names = [prefix + f"{s}.embed_tokens.weight" for s in ("encoder", "decoder")]
    tied = [state.pop(name, None) for name in names]
    if prefix + "shared.weight" not in state:
        found = [t for t in tied if t is not None]
        if found:
            state[prefix + "shared.weight"] = found[0]
    shared = state.get(prefix + "shared.weight")
    for name, t in zip(names, tied):
        if t is not None and not torch.equal(t, shared):
            raise ValueError(f"the checkpoint's {name} differs from {prefix}shared.weight: the reference builds one "
                             f"shared embedding for both stacks and cannot tie them")


class BartModel(nn.Module):
    """The encoder-decoder: ``forward`` gives the decoder's last hidden
    state (b, s, d_model) for the encoder's ids and mask."""

    base_model_prefix = "model"
    encoder_cls: ClassVar[type[nn.Module]] = BartEncoder
    decoder_cls: ClassVar[type[nn.Module]] = BartDecoder

    def __init__(self, cfg: BartConfig):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = self.encoder_cls(cfg)
        self.decoder = self.decoder_cls(cfg)
        self.register_load_state_dict_pre_hook(_tie_embeddings)

    def decoder_inputs(self, input_ids: torch.Tensor) -> torch.Tensor:
        return shift_tokens_right(input_ids, self.config.decoder_start_token_id)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        check_length(self.config, input_ids.shape[1])
        bias = mask_bias(attention_mask, self.shared.weight.dtype)
        memory = self.encoder(input_ids, bias, self.shared)
        return self.decoder(self.decoder_inputs(input_ids), memory, bias, self.shared)


class BartClassificationHead(nn.Module):
    def __init__(self, cfg: BartConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.d_model, cfg.d_model)
        self.out_proj = nn.Linear(cfg.d_model, cfg.num_labels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(torch.tanh(self.dense(x)))


class BartForSequenceClassification(nn.Module):
    """The encoder-decoder and ``classification_head`` over the sum of the
    decoder states at every ``</s>``: ``forward`` gives the logits
    (b, num_labels)."""

    base_model_prefix = "model"
    model_cls: ClassVar[type[nn.Module]] = BartModel

    def __init__(self, cfg: BartConfig):
        super().__init__()
        self.config = cfg
        self.model = self.model_cls(cfg)
        self.classification_head = BartClassificationHead(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        hidden = self.model(input_ids, attention_mask)
        eos = (input_ids == self.config.eos_token_id).to(hidden.dtype)[:, :, None]
        return self.classification_head((hidden * eos).sum(dim=1))
