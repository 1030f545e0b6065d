"""The k-means ``cluster()`` factory of the port: the counterpart of
``lotus_tpu/utils.py:21-75``, on the port's k-means (``ops/kmeans.py``).

- ``cluster_vectors`` clusters an array of vectors on a torch device;
- ``cluster(col_name, ncentroids, vs=...)`` is the DataFrame factory with the
  reference's contract and error messages: its function reads the column's
  index directory from ``df.attrs["index_dirs"]``, loads it into ``vs`` and
  clusters the vectors ``vs.get_vectors_from_index`` returns for
  ``df.index``;
- ``bind_cluster(vs)`` gives the factory with the reference's signature
  ``(col_name, ncentroids)``.  The port cannot read ``lotus_tpu.settings``,
  so the store is passed in.  Where both packages are installed::

      lotus_tpu.utils.cluster = lotus_tpu_torch.utils.bind_cluster(vs)

  puts it behind ``sem_cluster_by``, which looks ``cluster`` up at each call
  (``lotus_tpu/sem_ops/sem_cluster_by.py:30``); ``sem_partition_by`` takes
  ``bind_cluster(vs)(col_name, ncentroids)`` as its partition function.

Nothing here imports pandas: the factory reads a DataFrame's ``columns``,
``attrs`` and ``index`` only.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from lotus_tpu_torch.ops.kmeans import KMeansResult, kmeans_fit


def cluster_vectors(
    vecs: Any,
    ncentroids: int,
    niter: int = 20,
    *,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> KMeansResult:
    """k-means over ``vecs`` (an (n, d) array or tensor) as the reference's
    ``cluster()`` runs it: squared l2, k-means++ seeding, ``niter`` Lloyd
    iterations, f32 without TF32.  ``device`` defaults to the GPU
    (``default_device``); ``generator`` (on that device) to one seeded with
    0.  ``.assignments`` is the cluster id of every row."""
    from lotus_tpu_torch.ops.ivf import default_device

    dev = torch.device(device) if device is not None else default_device()
    x = torch.as_tensor(vecs, dtype=torch.float32, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return kmeans_fit(x, ncentroids, iters=niter, generator=generator)


def cluster(col_name: str, ncentroids: int, *, vs: Any) -> Callable[..., list[int]]:
    """Return a function that clusters a DataFrame column's indexed vectors
    on ``vs`` (a ``TorchVS``), with ``lotus_tpu.utils.cluster``'s contract:
    ``ret(df, niter=20, verbose=False, method="kmeans")`` gives a cluster id
    per row of ``df``."""

    def ret(df: Any, niter: int = 20, verbose: bool = False, method: str = "kmeans") -> list[int]:
        if col_name not in df.columns:
            raise ValueError(f"Column {col_name} not found in DataFrame")
        if ncentroids > len(df):
            raise ValueError(
                f"Number of centroids must be less than number of documents. {ncentroids} > {len(df)}"
            )
        try:
            col_index_dir = df.attrs["index_dirs"][col_name]
        except KeyError:
            raise ValueError(f"Index directory for column {col_name} not found in DataFrame")
        if vs.index_dir != col_index_dir:
            vs.load_index(col_index_dir)
        # df integer index positions are vector row ids, as in the reference.
        vec_set = vs.get_vectors_from_index(col_index_dir, df.index.tolist())
        return cluster_vectors(vec_set, ncentroids, niter, device=vs.device).assignments.cpu().tolist()

    return ret


def bind_cluster(vs: Any) -> Callable[[str, int], Callable[..., list[int]]]:
    """``cluster`` bound to ``vs``: a ``(col_name, ncentroids)`` factory with
    the signature of ``lotus_tpu.utils.cluster``."""
    return functools.partial(cluster, vs=vs)
