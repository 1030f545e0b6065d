"""``lotus_tpu_torch.ops.flat`` against ``lotus_tpu.ops.flat`` on the same inputs.

Scores agree within 1e-5 (f32, and int8, whose integer dot is exact) or 2e-2
(bf16, which the two frameworks round at other places); the id sets agree
wherever the k-th and (k+1)-th reference scores differ by more than that.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lotus_tpu.ops.flat import flat_rescore as jax_rescore
from lotus_tpu.ops.flat import flat_search as jax_flat
from lotus_tpu.ops.quant import quantize_rows as jax_quant
from lotus_tpu_torch.ops.flat import flat_rescore, flat_search
from lotus_tpu_torch.ops.quant import quantize_rows

_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 1e-5}


def _data(seed, n, d=48, b=9):
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((n, d)).astype(np.float32)
    xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    xq = xb[rng.integers(0, n, b)] + 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.random(n) < 0.6
    return xb, xq, valid


def _stores(xb, dtype):
    if dtype == "int8":
        q, s = jax_quant(jnp.asarray(xb))
        return (q, {"xb_scales": s}), (torch.from_numpy(np.array(q)), {"xb_scales": torch.from_numpy(np.array(s))})
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (jnp.asarray(xb, dtype=jdt), {}), (torch.from_numpy(xb).to(tdt), {})


@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("masked", [False, True])
def test_flat_search_matches_reference(metric, dtype, masked):
    n, k = 4096, 10
    xb, xq, valid = _data(len(metric) * 7 + len(dtype) * 3 + masked, n)
    (jxb, jkw), (txb, tkw) = _stores(xb, dtype)
    if metric == "l2" and dtype == "int8":
        norms = (np.asarray(jxb, np.float32) ** 2).sum(1) * np.asarray(jkw["xb_scales"]) ** 2
        jkw["xb_norms_sq"], tkw["xb_norms_sq"] = jnp.asarray(norms), torch.from_numpy(norms)
    jv = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    # block_rows 1024 runs the blocked running top-k (4 blocks).
    jd, ji = jax_flat(jxb, jnp.asarray(xq), k + 1, metric=metric, valid=jv, block_rows=1024, **jkw)
    td, ti = flat_search(txb, torch.from_numpy(xq), k + 1, metric=metric, valid=tv, block_rows=1024, approx=True, **tkw)
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    tol = _TOL[dtype]
    np.testing.assert_allclose(td, jd, rtol=tol, atol=tol)
    if masked:
        assert valid[ti[ti >= 0]].all()
    sign = -1 if metric == "l2" else 1
    for q in range(len(xq)):
        if sign * (jd[q, k - 1] - jd[q, k]) > tol:
            assert set(ti[q, :k]) == set(ji[q, :k]), q


def test_flat_search_pads_and_counts_rows():
    xb, xq, _ = _data(7, 3000)
    jd, ji = jax_flat(jnp.asarray(xb), jnp.asarray(xq), 5, n_rows=2500, block_rows=1024)
    td, ti = flat_search(torch.from_numpy(xb), torch.from_numpy(xq), 5, n_rows=2500, block_rows=1024)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert (ti.numpy() < 2500).all()
    # k beyond the collection: -1 ids past the last row.
    _, ti = flat_search(torch.from_numpy(xb[:3]), torch.from_numpy(xq[0]), 5)
    assert ti.tolist()[3:] == [-1, -1]


def test_flat_rescore_matches_reference():
    xb, xq, _ = _data(8, 2048)
    q, s = quantize_rows(torch.from_numpy(xb))
    rng = np.random.default_rng(9)
    cand = rng.integers(0, 2048, (len(xq), 32)).astype(np.int32)
    cand[:, -2:] = -1
    jd, ji = jax_rescore(jnp.asarray(q.numpy()), jnp.asarray(xq), jnp.asarray(cand), 10,
                         xb_scales=jnp.asarray(s.numpy()))
    td, ti = flat_rescore(q, torch.from_numpy(xq), torch.from_numpy(cand), 10, xb_scales=s)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)
