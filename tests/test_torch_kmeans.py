"""``lotus_tpu_torch.ops.kmeans`` against ``lotus_tpu.ops.kmeans``.

The two packages draw different random numbers, so Lloyd's iterations are
compared from the same numpy initial centroids (within 1e-4: the cluster
sums accumulate in another order), and assignments agree except where the
best two centroids are within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lotus_tpu.ops import kmeans as jk
from lotus_tpu_torch.ops import kmeans as tk


def _blobs(seed, n=4096, d=32, c=12):
    rng = np.random.default_rng(seed)
    centers = 3 * rng.standard_normal((c, d)).astype(np.float32)
    x = centers[rng.integers(0, c, n)] + rng.standard_normal((n, d)).astype(np.float32)
    return x, rng


@pytest.mark.parametrize("metric,spherical", [("l2", False), ("l2", True), ("ip", True)])
def test_lloyd_iterations_match_from_same_init(metric, spherical):
    x, rng = _blobs(0)
    k = 16
    init = x[rng.choice(len(x), k, replace=False)].copy()
    init[3] = init[2]  # a duplicate start leaves one cluster empty: it keeps its centroid
    jc, js = jk._kmeans_iterate(jnp.asarray(x), jnp.asarray(init), jnp.int32(len(x)), k, metric, 1024, 6, spherical)
    tc, ts = tk._kmeans_iterate(torch.from_numpy(x), torch.from_numpy(init), len(x), k, metric, 1024, 6, spherical)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_assignments_match_except_near_ties(metric):
    x, rng = _blobs(1)
    cents = x[rng.choice(len(x), 24, replace=False)]
    ja, jd = jk.kmeans_assign(jnp.asarray(x), jnp.asarray(cents), metric=metric, block_rows=1000)
    ta, td = tk.kmeans_assign(torch.from_numpy(x), torch.from_numpy(cents), metric=metric, block_rows=1000)
    j1, j2, jm = jk.kmeans_assign_top2(jnp.asarray(x), jnp.asarray(cents), metric=metric, block_rows=1024)
    t1, t2, tm = tk.kmeans_assign_top2(torch.from_numpy(x), torch.from_numpy(cents), metric=metric, block_rows=1024)
    clear = np.asarray(jm) > 1e-5
    np.testing.assert_array_equal(ta.numpy()[clear], np.asarray(ja)[clear])
    np.testing.assert_array_equal(t1.numpy()[clear], np.asarray(j1)[clear])
    np.testing.assert_array_equal(t2.numpy()[clear], np.asarray(j2)[clear])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-3, atol=1e-3)


def test_kmeanspp_seeding_spreads_over_the_clusters():
    """D^2 seeding picks k distinct points, no cluster ends empty, and fits
    as tightly as the reference does."""
    x, _ = _blobs(2, c=12)
    init = tk._kmeanspp_init(torch.from_numpy(x), 12, torch.Generator().manual_seed(0))
    assert torch.unique(init, dim=0).shape[0] == 12
    res = tk.kmeans_fit(torch.from_numpy(x), 12, iters=10, generator=torch.Generator().manual_seed(0))
    counts = torch.bincount(res.assignments.long(), minlength=12)
    assert (counts > 0).all(), counts
    # Same quality as the reference's fits on these blobs: mean inertia over
    # five seeds each within 10% (one seed can split a blob and merge two).
    ours = [float(tk.kmeans_fit(torch.from_numpy(x), 12, iters=10,
                                generator=torch.Generator().manual_seed(s)).inertia) for s in range(5)]
    ref = [float(jk.kmeans_fit(jnp.asarray(x), 12, iters=10, key=jax.random.PRNGKey(s)).inertia)
           for s in range(5)]
    assert np.mean(ours) <= 1.1 * np.mean(ref), (ours, ref)


def test_kmeans_fit_subsamples_and_validates():
    x, _ = _blobs(3, n=2048)
    res = tk.kmeans_fit(torch.from_numpy(x), 8, iters=3, max_points=512, init="random", spherical=True)
    assert res.centroids.shape == (8, 32) and res.assignments.shape == (2048,)
    np.testing.assert_allclose(np.linalg.norm(res.centroids.numpy(), axis=1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError):
        tk.kmeans_fit(torch.from_numpy(x[:4]), 8)
    with pytest.raises(ValueError):
        tk.kmeans_fit(torch.from_numpy(x), 8, init="nope")
