"""Sentence-embedding RM on the card: an encoder, an encoder-decoder or a
decoder of any family ``checkpoint.FAMILIES`` lists, in PyTorch.

The port of ``JaxSentenceEncoderRM`` (``lotus_tpu/models/flax_rm.py:32-127``),
which fills the role of the reference's ``SentenceTransformersRM``.  It
reads a local checkpoint directory with the port's own tokenizer and
checkpoint reader (``auto.load_tokenizer``, ``auto.load_encoder``), and
calls the model with ids and mask only, as the reference does (so token
types are the family's default: 0, but 1 for ELECTRA; DistilBERT and the
encoder-decoders and decoders have none).  An encoder-decoder's hidden
states are its decoder's, run on the shifted ids (``bart.py``); a decoder's
are its causal states at positions ``arange(seq)`` whatever the padding,
which Llama's and Gemma's tokenizers put on the left (so ``[CLS]`` pooling
takes a padded row's first pad, as in the reference); BLOOM's ALiBi counts
positions from each row's first real token.  A tokenizer without
a pad token raises ``ValueError`` when a batch pads, as the reference's
``padding=True`` does, and so does an id past the model's vocabulary (a
GPT-SW3 pad token its ``spiece.model`` lacks, added past it), where the
reference's embeddings are NaN.  Where the reference
fails on a bucket, the port raises before it runs the bucket: BigBird's
block-sparse attention on one that is not whole blocks or holds fewer than
4 (``big_bird.check_blocks``), an encoder-decoder on one longer than its
``max_position_embeddings``, a decoder on one longer than its positions
(``bart.check_length``).  It keeps the
reference's buckets: the batch pads to ``max_batch_size`` with ``""`` and
the tokens to the next power of two of at least 16, capped at
``max_seq_length``, so padding rows ride an all-zero attention mask and are
sliced off after pooling.  One tokenizer pass truncated to
``max_seq_length`` and padded to the bucket gives the ids the reference's
two passes give.  Pooling is the reference's: mean over the mask in the
hidden dtype (count clipped at 1e-9) or ``[CLS]``, cast to f32, optionally
L2-normalised (norm clipped at 1e-12).  A call opens the span ``rm.call``
over ``rm.tokenize`` (a batch's tokens) and ``rm.forward`` (its forward and
pooling) for ``lotus_tpu_torch.profiling``.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch
from torch import nn

from lotus_tpu_torch import profiling
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
                     batch_size: int, max_seq_length: int, device: torch.device,
                     vocab_size: int | None = None) -> Iterator[tuple[int, torch.Tensor, torch.Tensor]]:
    """(real rows, input ids, attention mask) on ``device`` for each batch of
    ``batch_size`` texts (or text pairs), padded with ``""`` to
    ``batch_size`` rows and to the sequence bucket.  An id past
    ``vocab_size`` raises ``ValueError`` before the batch leaves the host."""
    for lo in range(0, len(texts), batch_size):
        batch = [str(t) for t in texts[lo : lo + batch_size]]
        n = len(batch)
        batch += [""] * (batch_size - n)
        second = None if pairs is None else [str(t) for t in pairs[lo : lo + batch_size]] + [""] * (batch_size - n)
        enc = tokenizer.encode(batch, second, max_length=max_seq_length)
        ids, mask = tokenizer.pad(enc, seq_bucket(max(map(len, enc)), max_seq_length))
        if vocab_size is not None and ids.size and ids.max() >= vocab_size:
            raise ValueError(f"token id {ids.max()} lies outside the model's {vocab_size}-entry vocabulary (a pad or "
                             f"added token the checkpoint has no row for): the reference's Flax embedding gathers NaN "
                             f"for it, so its embeddings are not finite")
        yield (n, torch.from_numpy(ids).to(device, non_blocking=True),
               torch.from_numpy(mask).to(device, non_blocking=True))


class TorchSentenceEncoderRM(RM):
    """Encoder embeddings on the card (or on the CPU with ``device="cpu"``).

    ``model`` is a local checkpoint directory of a family ``load_encoder``
    runs (``config.json``; ``tokenizer.json``, ``vocab.txt`` or
    ``vocab.json`` + ``merges.txt``; ``model.safetensors``,
    ``pytorch_model.bin``, either sharded, or ``flax_model.msgpack``).
    ``dtype`` (a torch dtype, f32 by default) holds the parameters and runs
    the forward, each tensor placed on the device as it is read; outputs are
    always float32.  ``device=None`` takes the card
    and raises without one.  ``encoder``, a family's module already built
    on the device (a model made there rather than read from files), takes
    the place of ``model``'s weights; the tokenizer is still ``model``'s, and
    every call runs the same path.
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
        encoder: nn.Module | None = None,
    ):
        if pooling not in ("mean", "cls"):
            raise ValueError(f"pooling must be 'mean' or 'cls', got {pooling!r}")
        self.device = torch.device(device) if device is not None else default_device()
        self.model_name = model
        self.max_batch_size = int(max_batch_size)
        self.normalize_embeddings = normalize_embeddings
        self.pooling = pooling
        self.max_seq_length = int(max_seq_length)
        self.encoder = (load_encoder(model, dtype=dtype or torch.float32, device=self.device) if encoder is None
                        else encoder.eval())
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
        with profiling.annotate("rm.call", docs=len(docs)), torch.inference_mode():
            # Batches are queued without waiting: the host tokenizes the next
            # batch while the card encodes this one.
            batches = bucketed_batches(self.tokenizer, docs, None, self.max_batch_size, self.max_seq_length,
                                       self.device, self.encoder.config.vocab_size)
            while True:
                with profiling.annotate("rm.tokenize"):
                    batch = next(batches, None)
                if batch is None:
                    break
                n, ids, mask = batch
                with profiling.annotate("rm.forward", tokens=ids.numel()):
                    out.append(self._pool(self.encoder(ids, mask), mask)[:n])
            if not out:
                return np.zeros((0, self.encoder.config.hidden_size), np.float32)
            return torch.cat(out).cpu().numpy()
