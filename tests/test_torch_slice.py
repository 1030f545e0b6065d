"""The port's main path end to end on the CPU, at the CPU shape of ``bench.py``:
``synth_ivf_device_build`` then ``ivf_search_grouped_probe`` (K1's plain
version) against the build's own exact f32 oracle, which must equal a numpy
brute force over the same corpus."""

import numpy as np
import pytest
import torch

from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk, synth_ivf_device_build
from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

CFG = dict(n=2**15, d=64, nlist=64, n_clusters=48, chunk=2**13, queries_b=256, gt_queries=256, k=10)


@pytest.fixture(scope="module")
def built():
    return synth_ivf_device_build(**CFG, seed=0, device="cpu")


def test_oracle_equals_numpy_brute_force(built):
    centers = corpus_centers(0, CFG["n_clusters"], CFG["d"], torch.device("cpu"))
    corpus = np.concatenate([
        gen_chunk(0, c, centers, CFG["chunk"], 2.5).numpy() for c in range(CFG["n"] // CFG["chunk"])
    ])
    xq = built["queries"][: CFG["gt_queries"]].numpy()
    scores = xq.astype(np.float64) @ corpus.T.astype(np.float64)
    gt = built["gt"]
    for q in range(gt.shape[0]):
        ref = np.argsort(-scores[q])[: CFG["k"]]
        if set(ref) != set(gt[q]):  # only a near-tie at the k-th place may differ
            kth = np.sort(scores[q])[::-1][CFG["k"] - 1]
            assert np.allclose(np.sort(scores[q, gt[q]]), np.sort(scores[q, ref]), atol=1e-5), q
            assert abs(scores[q, gt[q]].min() - kth) < 1e-5, q


@pytest.mark.parametrize("int8_queries", [True, False])
def test_grouped_probe_recall(built, int8_queries):
    state, gt = built["state"], built["gt"]
    assert state["ivf_vectors"].dtype == torch.int8 and state["ivf_vectors"].shape[0] % 1024 == 0
    dists, ids = ivf_search_grouped_probe(
        state, built["queries"], 10, nprobe=16, metric="ip", rescore=24,
        int8_queries=int8_queries, query_chunk=128,
    )
    assert tuple(ids.shape) == (CFG["queries_b"], 10) and torch.isfinite(dists).all()
    got = ids[: gt.shape[0]].numpy()
    recall = np.mean([len(set(got[i]) & set(gt[i])) / 10 for i in range(gt.shape[0])])
    assert recall >= 0.95, recall
