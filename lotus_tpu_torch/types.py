"""Result types of the port (``lotus_tpu/types.py:195-208``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RMOutput:
    """K-NN search payload: per-query scores and row positions.

    Indices are row positions in the indexed collection; ``-1`` marks a
    missing / padded hit (same contract as ``lotus_tpu.types.RMOutput``).
    """

    distances: list[list[float]]
    indices: list[list[int]]


@dataclass
class RerankerOutput:
    """A reranker's order: indices into the docs it was given, best first
    (``lotus_tpu.types.RerankerOutput``)."""

    indices: list[int]
