"""``lotus_tpu_torch.utils`` (the port's ``cluster()``) against
``lotus_tpu.utils.cluster``, and the k-means++ seeding's distances.

The two packages seed k-means with different random numbers, so the
assignments are held to the reference's Lloyd iterations
(``lotus_tpu.ops.kmeans._kmeans_iterate`` then ``kmeans_assign``) started
from the same numpy centroids, which the port's seeding is patched to give.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import lotus_tpu
from lotus_tpu.models import HashRM
from lotus_tpu.ops import kmeans as jk
from lotus_tpu.vector_store import TpuVS
from lotus_tpu_torch import TorchVS
from lotus_tpu_torch.ops import kmeans as tk
from lotus_tpu_torch.ops.kmeans import DEFAULT_BLOCK_ROWS, pp_distances
from lotus_tpu_torch.utils import bind_cluster, cluster_vectors


def _blobs(seed, n=3000, d=24, c=10):
    rng = np.random.default_rng(seed)
    centers = 4 * rng.standard_normal((c, d)).astype(np.float32)
    return centers[rng.integers(0, c, n)] + rng.standard_normal((n, d)).astype(np.float32), rng


@pytest.mark.parametrize("k,niter", [(10, 20), (16, 5)])
def test_cluster_vectors_matches_reference_from_same_init(monkeypatch, k, niter):
    x, rng = _blobs(k)
    init = x[rng.choice(len(x), k, replace=False)].copy()
    jc, _ = jk._kmeans_iterate(jnp.asarray(x), jnp.asarray(init), jnp.int32(len(x)), k, "l2",
                               DEFAULT_BLOCK_ROWS, niter, False)
    want, _ = jk.kmeans_assign(jnp.asarray(x), jc, metric="l2")
    monkeypatch.setattr(tk, "_kmeanspp_init", lambda sub, kk, gen: torch.from_numpy(init))
    got = cluster_vectors(x, k, niter, device="cpu")
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want))


def test_cluster_vectors_seeds_on_its_own():
    x, _ = _blobs(3)
    a = cluster_vectors(x, 10, 10, device="cpu").assignments
    b = cluster_vectors(torch.from_numpy(x), 10, 10, device="cpu").assignments
    assert torch.equal(a, b) and a.shape == (len(x),) and torch.unique(a).numel() == 10


def _indexed_df(tmp_path, texts):
    """A frame whose column is indexed in a directory both stores can load."""
    rm = HashRM(dim=32)
    index_dir = str(tmp_path / "idx")
    TorchVS(device="cpu").index(texts, np.asarray(rm(texts)), index_dir)
    df = pd.DataFrame({"t": texts})
    df.attrs["index_dirs"] = {"t": index_dir}
    return df, rm


_TEXTS = ["alpha beta", "alpha gamma", "delta epsilon", "delta zeta", "eta theta"]


@pytest.mark.parametrize("case", ["column", "ncentroids", "index_dir"])
def test_factory_errors_match_reference(tmp_path, case):
    df, rm = _indexed_df(tmp_path, _TEXTS)
    col, k = ("nope", 2) if case == "column" else ("t", 9) if case == "ncentroids" else ("t", 2)
    if case == "index_dir":
        df.attrs["index_dirs"] = {}
    lotus_tpu.settings.configure(rm=rm, vs=TpuVS())
    try:
        with pytest.raises(ValueError) as ref:
            lotus_tpu.utils.cluster(col, k)(df)
    finally:
        lotus_tpu.settings.configure(rm=None, vs=None)
    with pytest.raises(ValueError) as port:
        bind_cluster(TorchVS(device="cpu"))(col, k)(df)
    assert str(port.value) == str(ref.value)


def test_factory_clusters_the_indexed_vectors(tmp_path):
    """The factory loads the column's index into the store, reads the rows of
    ``df.index`` and clusters them as ``cluster_vectors`` does."""
    df, rm = _indexed_df(tmp_path, _TEXTS)
    sub = df.iloc[[0, 1, 3, 4]]
    vs = TorchVS(device="cpu")
    got = bind_cluster(vs)("t", 2)(sub, niter=5)
    want = cluster_vectors(np.asarray(rm([_TEXTS[i] for i in (0, 1, 3, 4)])), 2, 5, device="cpu")
    assert vs.index_dir == df.attrs["index_dirs"]["t"]
    assert got == want.assignments.tolist()


def test_pp_distances_match_the_direct_form():
    """||x||^2 - 2 x.c + ||c||^2 against sum((x - c)^2): within a few f32
    ulps of ||x||^2 + ||c||^2 (the cancellation of the expanded form), and
    clamped at 0."""
    x, _ = _blobs(4, n=2048, d=64)
    xt = torch.from_numpy(x)
    x_sq = torch.sum(xt * xt, dim=-1)
    for c in (xt[7], xt[100] + 0.5, torch.zeros(64)):
        got = pp_distances(xt, x_sq, c)
        want = torch.sum((xt - c[None, :]) ** 2, dim=-1)
        scale = x_sq + torch.dot(c, c)
        assert (got >= 0).all()
        assert ((got - want).abs() <= 8 * torch.finfo(torch.float32).eps * scale).all()
    assert float(pp_distances(xt, x_sq, xt[7])[7]) <= 8 * torch.finfo(torch.float32).eps * float(2 * x_sq[7])
