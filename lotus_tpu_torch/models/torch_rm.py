"""Sentence-embedding RM on the card: an encoder (BERT, RoBERTa, XLM-R,
DistilBERT, ELECTRA, ALBERT, RoFormer, BigBird or RoBERTa-PreLayerNorm) in
PyTorch.

The port of ``JaxSentenceEncoderRM`` (``lotus_tpu/models/flax_rm.py:32-127``),
which fills the role of the reference's ``SentenceTransformersRM``.  It
reads a local checkpoint directory with the port's own tokenizer and
checkpoint reader (``auto.load_tokenizer``, ``auto.load_encoder``), and
calls the encoder with ids and mask only, as the reference does (so token
types are the family's default: 0, but 1 for ELECTRA; DistilBERT has
none).  BigBird's block-sparse attention fails, as the reference's does,
on a bucket that is not whole blocks or holds fewer than 4
(``big_bird.check_blocks``).  It keeps the
reference's buckets: the batch pads to ``max_batch_size`` with ``""`` and
the tokens to the next power of two of at least 16, capped at
``max_seq_length``, so padding rows ride an all-zero attention mask and are
sliced off after pooling.  One tokenizer pass truncated to
``max_seq_length`` and padded to the bucket gives the ids the reference's
two passes give.  Pooling is the reference's: mean over the mask in the
hidden dtype (count clipped at 1e-9) or ``[CLS]``, cast to f32, optionally
L2-normalised (norm clipped at 1e-12).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from lotus_tpu_torch.models.auto import load_encoder, load_tokenizer
from lotus_tpu_torch.models.rm import RM
from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer
from lotus_tpu_torch.ops.ivf import default_device

MIN_SEQ_BUCKET = 16


def seq_bucket(longest: int, max_seq_length: int) -> int:
    """The next power of two of at least ``MIN_SEQ_BUCKET`` tokens that
    holds ``longest``, capped at ``max_seq_length``."""
    b = MIN_SEQ_BUCKET
    while b < longest:
        b *= 2
    return min(b, max_seq_length)


def bucketed_batches(tokenizer: JsonTokenizer, texts: Sequence[str], pairs: Sequence[str] | None,
                     batch_size: int, max_seq_length: int,
                     device: torch.device) -> Iterator[tuple[int, torch.Tensor, torch.Tensor]]:
    """(real rows, input ids, attention mask) on ``device`` for each batch of
    ``batch_size`` texts (or text pairs), padded with ``""`` to
    ``batch_size`` rows and to the sequence bucket."""
    for lo in range(0, len(texts), batch_size):
        batch = [str(t) for t in texts[lo : lo + batch_size]]
        n = len(batch)
        batch += [""] * (batch_size - n)
        second = None if pairs is None else [str(t) for t in pairs[lo : lo + batch_size]] + [""] * (batch_size - n)
        enc = tokenizer.encode(batch, second, max_length=max_seq_length)
        ids, mask = tokenizer.pad(enc, seq_bucket(max(map(len, enc)), max_seq_length))
        yield (n, torch.from_numpy(ids).to(device, non_blocking=True),
               torch.from_numpy(mask).to(device, non_blocking=True))


class TorchSentenceEncoderRM(RM):
    """Encoder embeddings on the card (or on the CPU with ``device="cpu"``).

    ``model`` is a local checkpoint directory of a family ``load_encoder``
    runs (``config.json``; ``tokenizer.json``, ``vocab.txt`` or
    ``vocab.json`` + ``merges.txt``; ``model.safetensors``,
    ``pytorch_model.bin`` or ``flax_model.msgpack``).
    ``dtype`` (a torch dtype, f32 by default) holds the parameters and runs
    the forward; outputs are always float32.  ``device=None`` takes the card
    and raises without one.
    """

    def __init__(
        self,
        model: str = "intfloat/e5-base-v2",
        max_batch_size: int = 64,
        normalize_embeddings: bool = True,
        pooling: str = "mean",
        max_seq_length: int = 512,
        dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
    ):
        if pooling not in ("mean", "cls"):
            raise ValueError(f"pooling must be 'mean' or 'cls', got {pooling!r}")
        self.device = torch.device(device) if device is not None else default_device()
        self.model_name = model
        self.max_batch_size = int(max_batch_size)
        self.normalize_embeddings = normalize_embeddings
        self.pooling = pooling
        self.max_seq_length = int(max_seq_length)
        self.encoder = load_encoder(model).to(self.device, dtype or torch.float32)
        self.tokenizer = load_tokenizer(model)

    def _pool(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.pooling == "mean":
            m = mask[:, :, None].to(hidden.dtype)
            emb = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
        else:
            emb = hidden[:, 0]
        emb = emb.float()
        if self.normalize_embeddings:
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-12)
        return emb

    def _embed(self, docs: list[str]) -> np.ndarray:
        out = []
        with torch.inference_mode():
            # Batches are queued without waiting: the host tokenizes the next
            # batch while the card encodes this one.
            for n, ids, mask in bucketed_batches(self.tokenizer, docs, None, self.max_batch_size,
                                                 self.max_seq_length, self.device):
                out.append(self._pool(self.encoder(ids, mask), mask)[:n])
        if not out:
            return np.zeros((0, self.encoder.config.hidden_size), np.float32)
        return torch.cat(out).cpu().numpy()
