"""Cross-encoder reranker on the card: a family's sequence classifier
(BERT, RoBERTa, XLM-R, DistilBERT, ELECTRA, ALBERT, RoFormer, BigBird or
RoBERTa-PreLayerNorm) in PyTorch.

The port of ``JaxCrossEncoderReranker``
(``lotus_tpu/models/flax_reranker.py:27-107``), which fills the role of the
reference's ``CrossEncoderReranker``.  (query, doc) pairs are encoded by the
tokenizer's template (``[CLS] query [SEP] doc [SEP]``, ``<s> query </s></s>
doc </s>``), cut ``longest_first`` to ``max_seq_length``, and batched in
``TorchSentenceEncoderRM``'s buckets.
Scores follow sentence-transformers' ``CrossEncoder``: a one-logit head
scores directly, a head of more logits by the last (positive) one.
"""

from __future__ import annotations

import numpy as np
import torch

from lotus_tpu_torch.models.auto import load_encoder, load_tokenizer
from lotus_tpu_torch.models.reranker import Reranker
from lotus_tpu_torch.models.torch_rm import bucketed_batches
from lotus_tpu_torch.ops.ivf import default_device
from lotus_tpu_torch.types import RerankerOutput


class TorchCrossEncoderReranker(Reranker):
    """A cross-encoder on the card (or on the CPU with
    ``device="cpu"``); ``model`` is a local checkpoint directory, ``dtype``
    a torch dtype (f32 by default), and scores are float32."""

    def __init__(
        self,
        model: str = "mixedbread-ai/mxbai-rerank-large-v1",
        max_batch_size: int = 64,
        max_seq_length: int = 512,
        dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = torch.device(device) if device is not None else default_device()
        self.model_name = model
        self.max_batch_size = int(max_batch_size)
        self.max_seq_length = int(max_seq_length)
        self.model = load_encoder(model, classifier=True).to(self.device, dtype or torch.float32)
        self.tokenizer = load_tokenizer(model)

    def score_pairs(self, query: str, docs: list[str]) -> np.ndarray:
        """Raw cross-encoder scores for (query, doc) pairs, one per doc."""
        scores = []
        with torch.inference_mode():
            for n, ids, mask in bucketed_batches(self.tokenizer, [query] * len(docs), docs, self.max_batch_size,
                                                 self.max_seq_length, self.device):
                # No token_type_ids, as the reference passes none: it passes
                # only input_ids and attention_mask (flax_reranker.py:96-100).
                # Flax BERT, RoBERTa, ALBERT, RoFormer, BigBird and
                # RoBERTa-PreLayerNorm then zero them and Flax ELECTRA sets
                # them all to 1 (ElectraModel.absent_token_type), where
                # sentence-transformers' CrossEncoder gives the doc segment 1;
                # DistilBERT has no segments.
                logits = self.model(ids, mask).float()
                scores.append((logits[:, 0] if logits.shape[-1] == 1 else logits[:, -1])[:n])
        return torch.cat(scores).cpu().numpy() if scores else np.zeros((0,), np.float32)

    def __call__(self, query: str, docs: list[str], K: int) -> RerankerOutput:
        scores = self.score_pairs(query, docs)
        order = np.argsort(-scores, kind="stable")[:K]
        return RerankerOutput(indices=[int(i) for i in order])
