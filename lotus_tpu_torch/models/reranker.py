"""Reranker interface (``lotus_tpu/models/reranker.py:10-15``)."""

from __future__ import annotations

from abc import ABC, abstractmethod

from lotus_tpu_torch.types import RerankerOutput


class Reranker(ABC):
    """Abstract reranker: reorder documents for a query."""

    @abstractmethod
    def __call__(self, query: str, docs: list[str], K: int) -> RerankerOutput:
        """Return the indices of the top-K docs, best first."""
