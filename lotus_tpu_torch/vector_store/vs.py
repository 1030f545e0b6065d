"""Vector-store contract (``lotus_tpu/vector_store/vs.py``).

The same four methods, so the semantic operators are store-agnostic:
``index``, ``load_index``, ``__call__(query_vectors, K, ids=None) ->
RMOutput`` and ``get_vectors_from_index``.
"""

from __future__ import annotations

import abc
from typing import Any

import numpy as np

from lotus_tpu_torch.types import RMOutput


class VS(abc.ABC):
    """Abstract vector store. Implementation: TorchVS (device-resident Flat/IVF)."""

    index_dir: str | None

    def __init__(self) -> None:
        self.index_dir = None

    @abc.abstractmethod
    def index(self, docs: list[str], embeddings: np.ndarray, index_dir: str, **kwargs: Any) -> None:
        """Build an index over ``embeddings`` and persist it under ``index_dir``."""

    @abc.abstractmethod
    def load_index(self, index_dir: str) -> None:
        """Load (or prepare to lazily load) a persisted index."""

    @abc.abstractmethod
    def __call__(self, query_vectors: np.ndarray, K: int, ids: list[int] | None = None, **kwargs: Any) -> RMOutput:
        """Nearest-neighbour search: (B, d) queries -> RMOutput with (B, K)
        distances and row indices (-1 = no hit).

        ``ids`` restricts the search to a subset of row positions.
        """

    @abc.abstractmethod
    def get_vectors_from_index(self, index_dir: str, ids: list[int]) -> np.ndarray:
        """Fetch stored vectors for the given row positions."""
