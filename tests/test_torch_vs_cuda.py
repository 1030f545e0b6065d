"""``TorchVS``, the window probe and the serving tier on the card: what only
the card shows of the store's paths (the kernels a store call launches,
counted by their wrappers, and the device memory the window probe holds),
and row shards served by ``ShardServer`` threads over card stores.  What the
paths return is held to the reference on the CPU by
``test_torch_vs_gate.py``, ``test_torch_autotune.py``,
``test_torch_window_probe.py`` and ``test_torch_serving_port.py``.

These tests need an NVIDIA GPU and skip without one; they import only
torch and the port:

    python -m pytest --noconftest -m cuda tests/test_torch_vs_cuda.py
"""

import numpy as np
import pytest
import torch

from lotus_tpu_torch import TorchVS, native
from lotus_tpu_torch.ops.bench_data import corpus_centers, gen_chunk, synth_ivf_device_build
from lotus_tpu_torch.ops.flat_scan import scan_fold
from lotus_tpu_torch.ops.io import read_meta, write_meta
from lotus_tpu_torch.ops.ivf import DEFAULT_GATHER_BUDGET_BYTES, ivf_search, plan_window_probe, save_ivf_state
from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe, pool_select, probe_fold
from lotus_tpu_torch.serving import SearchFrontEnd, ShardClient, ShardServer, vs_search_fn

K, RESCORE, NPROBE = 10, 24, 208
# The window probe's transient peak may pass its gather budget by this much:
# the coarse ranking, the candidates' rescoring and the allocator's rounding.
PEAK_MARGIN = 256 << 20


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels' launches and device memory exist only there")
    return torch.device("cuda")


def _corpus(dev, seed: int, n: int, d: int, nq: int = 256):
    """``n`` seeded unit rows of depth ``d`` on 1,024 clusters, ``nq`` unit
    queries near seeded rows, and their exact f32 top-K ids."""
    rows = gen_chunk(seed, 0, corpus_centers(seed, 1024, d, dev), n, 2.5)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = rows[torch.randint(0, n, (nq,), generator=g, device=dev)] + 0.05 * torch.randn((nq, d), generator=g,
                                                                                       device=dev)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    gt = torch.topk(q @ rows.T, K, dim=1).indices.tolist()
    return rows.cpu().numpy(), q.cpu().numpy(), gt


def _recall(ids, gt) -> float:
    return sum(len(set(a) & set(b)) for a, b in zip(ids, gt)) / (K * len(gt))


def _transient_peak(fn):
    """``fn()`` once: its result and the most it allocated at once beyond
    what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


@pytest.mark.cuda
def test_window_probe_peak_stays_within_its_budget_on_gpu():
    """The window probe (``ops/ivf.py::ivf_search``) over a store of config
    4's per-list shape (2,560 rows and 16 clusters a list, block-aligned at
    1,024, residual int8 with the int4 refinement) at config 4's setting
    (nprobe 208, rescore 24), in config 4's regime: one query a step, its
    208 slots in one.  At B 1, 16 and 64 (the batch that crashed the
    reference's worker) each call's transient peak stays within the gather
    budget plus PEAK_MARGIN; under a 1 GiB budget B 16 cuts each query's
    slots into groups, returns the same top-10 sets and stays within 1 GiB
    plus the margin."""
    dev = _card()
    built = synth_ivf_device_build(n=655_360, d=768, nlist=256, n_clusters=4096, chunk=2**17, queries_b=64,
                                   gt_queries=16, block_align=1024, device=dev)
    state, xq = built["state"], built["queries"]
    window, budget = int(state["meta"]["probe_window"]), DEFAULT_GATHER_BUDGET_BYTES
    qc, group, _ = plan_window_probe(64, NPROBE, window, 768, torch.int8, budget)
    assert (qc, group) == (1, NPROBE), f"window {window}: not config 4's regime"

    def search(b, **kw):
        return ivf_search(state, xq[:b], K, nprobe=NPROBE, metric="ip", rescore=RESCORE, **kw)

    for b in (1, 16, 64):
        _, peak = _transient_peak(lambda: search(b))
        assert peak <= budget + PEAK_MARGIN, f"window probe B={b}: transient peak {peak} past the budget"
    split_budget = 1 << 30
    _, group, _ = plan_window_probe(16, NPROBE, window, 768, torch.int8, split_budget)
    (_, got), peak = _transient_peak(lambda: search(16, gather_budget_bytes=split_budget))
    _, want = search(16)
    assert group < NPROBE and all(set(x) == set(y) for x, y in zip(got.tolist(), want.tolist())), \
        "the slot-grouped window probe changed the top-k sets"
    assert peak <= split_budget + PEAK_MARGIN, f"slot-grouped window probe: transient peak {peak}"


@pytest.mark.cuda
def test_ivf_store_serves_and_calibrates_through_k1_on_gpu(tmp_path):
    """A block-aligned residual int8 IVF store (131,072 x 768, nlist 128,
    rescore 24) serves a search without ids through K1, and one with ids
    returning only allowed ids; ``calibrate_nprobe(0.95, k=10, nq=256,
    oracle="exact")`` walks its ladder through K1 in the grouped regime; a
    fresh store adopts the persisted entry without launching K1; an entry
    whose grouped regime was dropped sends B 1 to the window probe and B 256
    to the exhaustive scan, with no K1 launch."""
    dev = _card()
    emb, qs, _ = _corpus(dev, 7, 131_072, 768)
    index_dir = str(tmp_path / "idx")
    store_kw = dict(index_type="ivf", device_dtype="int8", int8_refine=True, rescore=RESCORE, nlist=128)
    vs = TorchVS(**store_kw)
    vs.index([], emb, index_dir)
    assert int(read_meta(index_dir)["block_align"]) >= 512, "the store came out unaligned: no K1 route"
    before = probe_fold.launches
    vs(qs, K)
    assert probe_fold.launches > before, "TorchVS did not reach K1"
    allowed = sorted(np.random.default_rng(3).permutation(len(emb))[:1000].tolist())
    sub = vs(qs[:4], K, ids=allowed)
    assert set(np.asarray(sub.indices).ravel().tolist()) <= set(allowed) | {-1}, "an id outside ids came back"

    before = probe_fold.launches
    cal = vs.calibrate_nprobe(0.95, k=K, nq=256, oracle="exact")
    assert probe_fold.launches > before, "calibration did not launch K1"
    assert cal["regimes"] == ["pallas"] and not cal["target_unreachable"], cal
    fresh = TorchVS(recall_target=0.95, **store_kw)
    fresh.load_index(index_dir)
    before = probe_fold.launches
    adopted = fresh.calibrate_nprobe(0.95, k=K, oracle="exact")
    assert probe_fold.launches == before and adopted["nprobe"] == cal["nprobe"] == fresh.nprobe, adopted

    disk = read_meta(index_dir)
    disk["calibration"][f"0.95@{K}"] = {**disk["calibration"][f"0.95@{K}/exact"], "regimes_dropped": ["pallas"]}
    write_meta(index_dir, disk)
    dropped = TorchVS(recall_target=0.95, **store_kw)
    dropped.load_index(index_dir)
    before = probe_fold.launches
    dropped(qs[:1], K), dropped(qs, K)
    assert dropped.stats["routes"] == {"grouped_probe": 0, "window_probe": 1, "scan": 1}, dropped.stats
    assert probe_fold.launches == before, "a dropped grouped regime launched K1"


@pytest.mark.cuda
@pytest.mark.parametrize("kind,d,kw", [
    ("K1", 768, dict(index_type="ivf", device_dtype="float16", nlist=128)),
    ("K1", 770, dict(index_type="ivf", device_dtype="int8", int8_refine=True, rescore=RESCORE, nlist=128)),
    ("K2", 768, dict(index_type="flat", device_dtype="float16", scan="pallas")),
    ("K2", 768, dict(index_type="flat", device_dtype="bfloat16", approx=True)),
    ("K2", 768, dict(index_type="flat", device_dtype="int8", scan="pallas")),
], ids=["f16_ivf", "int8_ivf_d770", "f16_flat_pallas", "bf16_flat_approx", "int8_flat_pallas"])
def test_store_reaches_its_kernel_on_gpu(tmp_path, kind, d, kw):
    """Each store type through ``TorchVS`` without ids over 131,072 seeded
    rows launches its kernel and reaches recall@10 0.95 against exact f32:
    an f16 IVF store (K1, f32 queries on f16 rows), a residual int8 IVF
    store at d 770 (K1's int8 dot with a ragged last word), and Flat stores
    through K2 (f16 rows under ``scan="pallas"``, bf16 with ``approx``,
    int8 under ``scan="pallas"``).  A Flat store's search with ids launches
    no K2 and returns only allowed ids."""
    dev = _card()
    emb, qs, gt = _corpus(dev, 17, 131_072, d)
    fold = probe_fold if kind == "K1" else scan_fold
    vs = TorchVS(device=dev, **kw)
    vs.index([], emb, str(tmp_path / "idx"))
    before = fold.launches
    out = vs(qs, K)
    assert fold.launches > before, f"{kw}: TorchVS did not launch {kind}"
    assert _recall(out.indices, gt) >= 0.95
    if kind == "K2":
        allowed = sorted(np.random.default_rng(3).permutation(len(emb))[:1000].tolist())
        before = scan_fold.launches
        sub = vs(qs[:4], K, ids=allowed)
        assert scan_fold.launches == before, "an ids-restricted search launched K2"
        assert set(np.asarray(sub.indices).ravel().tolist()) <= set(allowed) | {-1}


@pytest.mark.cuda
def test_row_shards_serve_through_k1_on_gpu(tmp_path):
    """The served path at a card size: two row shards of one seeded corpus
    (``synth_ivf_device_build(first_chunk=...)``, 262,144 x 768 rows each,
    nlist 64, block-aligned at 1,024) saved as built, each loaded by a
    ``TorchVS`` on the card (int8 with the int4 refinement, int8 queries,
    nprobe 16, rescore 24) and served by a ``ShardServer`` thread with its id
    offset.  The front end's search over 256 queries launches K1 and K3;
    each shard answers as the grouped probe on its own card state does (ids
    equal, distances within 1e-6), and the front end's merge equals the
    plain merge of those answers."""
    dev = _card()
    chunk, nprobe = 2**17, 16
    cfg = dict(n=2 * chunk, d=768, nlist=64, n_clusters=1024, chunk=chunk, queries_b=256, gt_queries=16, k=K,
               block_align=1024, seed=5, device=dev)
    store_kw = dict(index_type="ivf", device_dtype="int8", int8_refine=True, nprobe=nprobe, rescore=RESCORE,
                    int8_queries=True, device=dev)
    servers, want, queries = [], [], None
    try:
        for h in range(2):
            built = synth_ivf_device_build(**cfg, first_chunk=2 * h)
            queries = built["queries"] if queries is None else queries
            assert torch.equal(built["queries"], queries)  # the whole corpus's queries
            save_ivf_state(str(tmp_path / f"s{h}"), built["state"])
            vs = TorchVS(**store_kw)
            vs.load_index(str(tmp_path / f"s{h}"))
            s, i = ivf_search_grouped_probe(built["state"], queries, K, nprobe=nprobe, metric="ip", rescore=RESCORE,
                                            int8_queries=True)
            want.append((s.cpu().numpy(), i.cpu().numpy() + h * 2 * chunk))
            servers.append(ShardServer(vs_search_fn(vs, id_offset=h * 2 * chunk)).start())
            del built
        xq = queries.cpu().numpy()
        k1, k3 = probe_fold.launches, pool_select.launches
        with SearchFrontEnd([s.address for s in servers], timeout=120.0) as fe:
            dists, ids = fe.search(xq, K)
        assert probe_fold.launches > k1 and pool_select.launches > k3, "the shards did not serve through K1 and K3"
        for h, server in enumerate(servers):
            client = ShardClient(server.address, timeout=120.0)
            got_d, got_i = client.search(xq, K)
            client.close()
            np.testing.assert_array_equal(got_i, want[h][1])
            np.testing.assert_allclose(got_d, want[h][0], atol=1e-6)
    finally:
        for s in servers:
            s.stop()
    plain_d, plain_i = native.topk_merge_batch_reference(np.stack([w[0] for w in want], 1),
                                                         np.stack([w[1] for w in want], 1), K)
    np.testing.assert_array_equal(ids, plain_i)
    np.testing.assert_allclose(dists, plain_d, atol=1e-6)
    assert ids.min() >= 0 and ids.max() < 4 * chunk


def _topic_docs(words: list[str], n: int, seed: int, topics: int = 64, per_topic: int = 40) -> list[str]:
    """``n`` seeded texts of 8-48 words, the ``j``-th on topic ``j % topics``:
    nine words in ten from that topic's ``per_topic`` words, the rest from
    all of ``words``."""
    rng = np.random.default_rng(seed)
    vocab = np.array(words)
    pools = vocab[rng.permutation(len(words))[: topics * per_topic]].reshape(topics, per_topic)
    docs = []
    for j in range(n):
        m = int(rng.integers(8, 49))
        on = rng.random(m) < 0.9
        docs.append(" ".join(np.where(on, rng.choice(pools[j % topics], m), rng.choice(vocab, m))))
    return docs


@pytest.mark.cuda
def test_text_store_reaches_k1_on_gpu(tmp_path):
    """The text-to-IVF-store path: a seeded BERT at e5-base-v2's widths (768,
    12 heads, cut to 2 layers; ``torch_card_files``) embeds 8,192 seeded
    texts on the card in bf16, ``TorchVS(index_type="ivf", nlist=16,
    device_dtype="int8")`` stores them block-aligned, and 256 other texts'
    embeddings searched without ids (nprobe 8 of the 16 lists) launch K1
    and reach recall@5 0.95 against exact f32 on the same embeddings (0.968
    on the CPU in bf16; the texts' embeddings crowd, mean cosine 0.94)."""
    from torch_card_files import seeded_words, write_checkpoint, write_wordpiece

    from lotus_tpu_torch.models import TorchSentenceEncoderRM

    dev = _card()
    k, n, nq = 5, 8192, 256
    words = seeded_words(25, 4000)
    model = str(tmp_path / "model")
    vocab_size = write_wordpiece(model, words)
    write_checkpoint(model, dict(model_type="bert", vocab_size=vocab_size, hidden_size=768, num_hidden_layers=2,
                                 num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512),
                     seed=25)
    rm = TorchSentenceEncoderRM(model=model, max_seq_length=512, dtype=torch.bfloat16, device=dev)
    right = rm(_topic_docs(words, n, 26))
    left = rm(_topic_docs(words, nq, 27))
    index_dir = str(tmp_path / "idx")
    vs = TorchVS(index_type="ivf", nlist=16, nprobe=8, device_dtype="int8", device=dev)
    vs.index([], right, index_dir)
    assert int(read_meta(index_dir)["block_align"]) >= 512, "the text store came out unaligned: no K1 route"
    before = probe_fold.launches
    out = vs(left, k)
    assert probe_fold.launches > before, "the text store did not launch K1"
    gt = torch.topk(torch.from_numpy(left) @ torch.from_numpy(right).T, k, dim=1).indices.tolist()
    recall = sum(len(set(a) & set(b)) for a, b in zip(out.indices, gt)) / (k * nq)
    assert recall >= 0.95, f"the text store through K1: recall@{k} {recall}"
