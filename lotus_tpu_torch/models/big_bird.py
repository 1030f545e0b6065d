"""BigBird as ``nn.Module``s, under Hugging Face's names.

The forward is Flax BigBird's in eval mode
(``transformers/models/big_bird/modeling_flax_big_bird.py``): BERT's
embeddings, the word embeddings scaled by sqrt(hidden) with
``rescale_embeddings`` (``:223-238``), positions 0, 1, ... ; BERT's layers
with ``hidden_act`` (``gelu_new`` in the published configs); the pooler
``pooler`` (a dense) and tanh on ``[CLS]``; the sequence classifier
``dense``, ``hidden_act`` and ``out_proj`` on token 0 (``:2068-2091``).

``attention_type`` "original_full" is BERT's self-attention.
"block_sparse" is ``bigbird_block_sparse_attention`` (``:525-867``) as the
reference runs it under ``train=False``, with the sequence cut into blocks
of ``block_size``:

- the first and last query blocks attend to every key;
- the second (second-last) attends to key blocks 0, 1, 2 and the last (0
  and the last three), then ``num_random_blocks`` "random" blocks;
- each middle block attends to key block 0, its three-block band, the
  random blocks and the last block, in one softmax;
- scores are scaled by 1/sqrt(head size) after the product, masked keys
  take -10000 (not ``finfo.min``), and masked query rows are zeroed after.

The random blocks are not random here: with ``deterministic`` (eval) both
of the reference's planners return zeros (``:989-992``, ``:1094-1098``; the
second is called without ``deterministic`` and defaults to it), so every
query block's ``num_random_blocks`` random blocks are key block 0 again,
masked by block 0's mask.  Unlike torch's ``BigBirdModel``, Flax does not
switch to full attention on short inputs: a length that is not a multiple
of ``block_size`` or holds fewer than 4 blocks fails in the reference, and
raises ``ValueError`` here.  Plain ``torch.matmul``, gathers and
``softmax``: the reference runs this as XLA, with no Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch
from torch import nn

from lotus_tpu_torch.models.bert import (
    ACTIVATIONS, BertConfig, BertEmbeddings, BertEncoder, BertModel, BertSelfAttention, mask_bias,
)
from lotus_tpu_torch.models.roberta import RobertaClassificationHead

MASK_PENALTY = -10000.0  # the block-sparse path's additive mask (attn_mask_penalty)
MIN_BLOCKS = 4  # fewer query blocks fail in the reference


@dataclass(frozen=True)
class BigBirdConfig(BertConfig):
    """The fields of a BigBird ``config.json`` the forward reads (the
    defaults are ``transformers``' ``BigBirdConfig``'s)."""

    model_types: ClassVar[tuple[str, ...]] = ("big_bird",)
    vocab_size: int = 50358
    hidden_act: str = "gelu_new"
    max_position_embeddings: int = 4096
    attention_type: str = "block_sparse"
    use_bias: bool = True
    rescale_embeddings: bool = False
    block_size: int = 64
    num_random_blocks: int = 3

    def __post_init__(self):
        if self.attention_type not in ("original_full", "block_sparse"):
            raise NotImplementedError(f"attention_type {self.attention_type!r}: BigBird runs 'original_full' or "
                                      f"'block_sparse'")


def check_blocks(seq_len: int, block: int) -> None:
    """Raise where the reference's block-sparse attention fails."""
    if seq_len % block or seq_len // block < MIN_BLOCKS:
        raise ValueError(f"BigBird block_sparse: sequence length {seq_len} with block_size {block} is not a multiple "
                         f"of the block size with at least {MIN_BLOCKS} blocks, as the reference needs (it fails "
                         f"there too; original_full runs any length)")


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, block: int,
                           n_rand: int) -> torch.Tensor:
    """Flax's eval-mode ``bigbird_block_sparse_attention``: q, k, v (b,
    heads, s, d), ``mask`` (b, s) of 0 / 1 in their dtype; the context
    (b, heads, s, d)."""
    b, h, s, d = q.shape
    check_blocks(s, block)
    nb = s // block
    scale = 1.0 / math.sqrt(d)
    bm = mask.view(b, nb, block)  # the blocked mask
    to_mask = mask.view(b, 1, 1, s)
    # The "random" blocks: zeros under deterministic, in every row and head.
    rand = torch.zeros((nb - 2, n_rand), dtype=torch.long, device=q.device)
    rand_mask = torch.einsum("blq,blk->blqk", bm[:, 1:-1], bm[:, rand].reshape(b, nb - 2, n_rand * block))[:, None]
    band_mask = torch.einsum("blq,blk->blqk", bm[:, 2:-2], torch.cat([bm[:, 1:-3], bm[:, 2:-2], bm[:, 3:-1]], 2))
    bq, bk, bv = (t.view(b, h, nb, block, d) for t in (q, k, v))
    gk, gv = (t[:, :, rand].reshape(b, h, nb - 2, n_rand * block, d) for t in (bk, bv))

    def attend(query, keys, values, keep):
        scores = torch.matmul(query, keys.transpose(-1, -2)) * scale + (1.0 - keep) * MASK_PENALTY
        return torch.matmul(torch.softmax(scores, dim=-1), values)

    def edge(row, blocks, seq_keep):
        """The second (row 0) or second-last (row -1) query block: four key
        blocks, then the row's random blocks."""
        keys = torch.cat([bk[:, :, j] for j in blocks] + [gk[:, :, row]], 2)
        values = torch.cat([bv[:, :, j] for j in blocks] + [gv[:, :, row]], 2)
        seq_keep = torch.cat([seq_keep, q.new_ones((b, 1, 1, n_rand * block))], 3)
        rand_keep = torch.cat([q.new_ones((b, 1, block, 4 * block)), rand_mask[:, :, row]], 3)
        return attend(bq[:, :, 1 if row == 0 else -2], keys, values, torch.minimum(seq_keep, rand_keep))

    first = attend(bq[:, :, 0], k, v, to_mask)
    second = edge(0, (0, 1, 2, -1), torch.cat([to_mask[..., : 3 * block], to_mask[..., -block:]], 3))
    second_last = edge(-1, (0, -3, -2, -1), torch.cat([to_mask[..., :block], to_mask[..., -3 * block :]], 3))
    last = attend(bq[:, :, -1], k, v, to_mask)

    # The middle blocks: key block 0, the band, the random blocks and the
    # last block under one softmax.
    mq = bq[:, :, 2:-2]
    band_k = torch.cat([bk[:, :, 1:-3], bk[:, :, 2:-2], bk[:, :, 3:-1]], 3)
    band_v = torch.cat([bv[:, :, 1:-3], bv[:, :, 2:-2], bv[:, :, 3:-1]], 3)
    first_k, last_k = bk[:, :, :1], bk[:, :, -1:]
    scores = torch.cat([
        torch.matmul(mq, first_k.transpose(-1, -2)) * scale + (1.0 - to_mask[..., None, :block]) * MASK_PENALTY,
        torch.matmul(mq, band_k.transpose(-1, -2)) * scale + (1.0 - band_mask[:, None]) * MASK_PENALTY,
        torch.matmul(mq, gk[:, :, 1:-1].transpose(-1, -2)) * scale + (1.0 - rand_mask[:, :, 1:-1]) * MASK_PENALTY,
        torch.matmul(mq, last_k.transpose(-1, -2)) * scale + (1.0 - to_mask[..., None, -block:]) * MASK_PENALTY,
    ], dim=-1)
    w = torch.softmax(scores, dim=-1)
    middle = (torch.matmul(w[..., block : 4 * block], band_v)
              + torch.matmul(w[..., 4 * block : -block], gv[:, :, 1:-1])
              + torch.matmul(w[..., :block], bv[:, :, :1])
              + torch.matmul(w[..., -block:], bv[:, :, -1:]))
    out = torch.cat([first[:, :, None], second[:, :, None], middle, second_last[:, :, None], last[:, :, None]], 2)
    return out.reshape(b, h, s, d) * mask.view(b, 1, s, 1)


class BigBirdBlockSparseAttention(BertSelfAttention):
    """q/k/v (with biases unless ``use_bias`` is off) and
    ``block_sparse_attention``; reads the 0 / 1 attention mask."""

    def __init__(self, cfg: BigBirdConfig):
        super().__init__(cfg, bias=cfg.use_bias)
        self.block, self.n_rand = cfg.block_size, cfg.num_random_blocks

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.merge(block_sparse_attention(*self.heads_of(x), mask, self.block, self.n_rand))


class BigBirdEmbeddings(BertEmbeddings):
    def __init__(self, cfg: BigBirdConfig):
        super().__init__(cfg)
        self.rescale = math.sqrt(cfg.hidden_size) if cfg.rescale_embeddings else None

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids)
        if self.rescale is not None:
            x = x * self.rescale
        x = x + self.token_type_embeddings(token_type_ids) + self.position_embeddings(positions)
        return self.LayerNorm(x)


def big_bird_encoder(cfg: BigBirdConfig) -> BertEncoder:
    sparse = cfg.attention_type == "block_sparse"
    return BertEncoder(cfg, BigBirdBlockSparseAttention if sparse else BertSelfAttention)


class BigBirdModel(BertModel):
    """The encoder: ``forward`` gives the last hidden state (b, s, hidden).
    ``add_pooling_layer=False`` leaves out ``pooler``."""

    base_model_prefix = "bert"
    embeddings_cls = BigBirdEmbeddings
    encoder_cls = staticmethod(big_bird_encoder)

    def __init__(self, cfg: BigBirdConfig, add_pooling_layer: bool = True):
        super().__init__(cfg, add_pooling_layer=False)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size) if add_pooling_layer else None

    def attention_input(self, attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.config.attention_type == "block_sparse":
            return attention_mask.to(dtype)
        return mask_bias(attention_mask, dtype)


class BigBirdForSequenceClassification(nn.Module):
    """The encoder (with the pooler the reference's module carries and does
    not read) and ``BigBirdClassificationHead``: ``forward`` gives the
    logits (b, num_labels)."""

    base_model_prefix = "bert"

    def __init__(self, cfg: BigBirdConfig):
        super().__init__()
        self.config = cfg
        self.bert = BigBirdModel(cfg)
        self.classifier = RobertaClassificationHead(cfg, ACTIVATIONS[cfg.hidden_act])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        return self.classifier(self.bert(input_ids, attention_mask, token_type_ids))
