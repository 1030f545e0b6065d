"""Retrieval (embedding) model interface: the port's copy of
``lotus_tpu/models/rm.py:16-46``, without pandas.

``_embed(docs) -> (n, d) float array`` plus query-format coercion.
"""

from __future__ import annotations

import abc
from typing import Any

import numpy as np


def as_query_matrix(rm: "RM", queries: Any) -> np.ndarray:
    """Coerce whatever the caller passed into an (nq, d) vector matrix.

    Accepted forms, in the order they are recognised: a pre-computed ndarray
    (returned untouched), a list of texts, anything with ``tolist`` (a pandas
    Series, embedded row-wise), or a bare str/scalar (a one-element batch).
    """
    if isinstance(queries, np.ndarray):
        return queries
    if isinstance(queries, list):
        batch = queries
    elif hasattr(queries, "tolist"):
        batch = queries.tolist()
        if not isinstance(batch, list):  # a numpy scalar
            batch = [batch]
    else:
        batch = [queries]
    return rm._embed(batch)


class RM(abc.ABC):
    """Embedding-model base: subclasses supply ``_embed`` only."""

    @abc.abstractmethod
    def _embed(self, docs: list[str]) -> np.ndarray:
        """Embed ``docs`` into an (num_docs, dim) float array."""

    def __call__(self, docs: list[str]) -> np.ndarray:
        return self._embed(docs)

    # Reference-compatible name; the logic lives in as_query_matrix above.
    def convert_query_to_query_vector(self, queries: Any) -> np.ndarray:
        return as_query_matrix(self, queries)
