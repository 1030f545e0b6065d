"""``lotus_tpu_torch.ops.ivf`` against ``lotus_tpu.ops.ivf``: block-aligned
layout, load-time quantization (bit for bit), exact rescoring, and index
directories that one package writes and the other loads."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lotus_tpu.ops import ivf as jivf
from lotus_tpu.ops.pallas_ivf import ivf_search_pallas
from lotus_tpu_torch.ops import ivf as tivf
from lotus_tpu_torch.ops.ivf_probe import ivf_search_grouped_probe

_JT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


def _corpus(seed, n=6144, d=32, c=8, spread=0.2):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32)
    emb = centers[rng.integers(0, c, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True), rng


def _assert_states_equal(js, ts):
    assert set(ts) - {"meta"} == set(js) - {"meta"}
    for name, ref in js.items():
        if name == "meta":
            assert ts.get("meta", {}).get("encoding") == ref.get("encoding")
            continue
        got = ts[name]
        assert got.device.type == "cpu"
        if got.dtype == torch.bfloat16:
            got, ref = got.float(), np.asarray(ref, np.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=name)


def test_plan_block_aligned_layout_identical():
    rng = np.random.default_rng(0)
    assign = rng.integers(0, 7, 3000).astype(np.int32)
    assign[assign == 3] = 2  # an empty list
    row_of_entry = np.concatenate([np.arange(2500), rng.integers(0, 2500, 500)]).astype(np.int32)
    for roe in (None, row_of_entry):
        ref = jivf.plan_block_aligned_layout(assign, 7, 512, roe)
        got = tivf.plan_block_aligned_layout(assign, 7, 512, roe)
        assert ref.keys() == got.keys()
        for key in ref:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize(
    "metric,dtype,encoding,refine",
    [
        ("ip", torch.int8, "residual_int8", True),
        ("ip", torch.int8, None, True),
        ("l2", torch.int8, None, False),
        ("ip", torch.bfloat16, None, False),
        ("cosine", torch.float32, None, False),
    ],
)
def test_load_ivf_state_identical(tmp_path, metric, dtype, encoding, refine):
    emb, _ = _corpus(1)
    idx = str(tmp_path / "idx")
    meta = {"kind": "ivf", "metric": metric, **jivf.build_ivf(idx, emb, nlist=6, metric=metric, block_align=512)}
    if encoding:
        meta["encoding"] = encoding
    js = jivf.load_ivf_state(idx, meta, _JT[dtype], refine_int4=refine)
    ts = tivf.load_ivf_state(idx, meta, dtype, refine_int4=refine, device="cpu")
    _assert_states_equal(js, ts)


def test_residual_downgrade_rule_matches(tmp_path):
    """Unclustered rows sit as far from their centroid as from the origin: both
    packages fall back from residual to plain int8 and say so in meta."""
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((4096, 32)).astype(np.float32)
    idx = str(tmp_path / "flatish")
    meta = {"kind": "ivf", "metric": "ip", "encoding": "residual_int8",
            **jivf.build_ivf(idx, emb, nlist=4, metric="ip", block_align=512)}
    js = jivf.load_ivf_state(idx, meta, jnp.int8)
    ts = tivf.load_ivf_state(idx, meta, torch.int8, device="cpu")
    assert js["meta"]["encoding"] == ts["meta"]["encoding"] == "int8"
    _assert_states_equal(js, ts)


def test_rescore_and_position_maps_match(tmp_path):
    emb, rng = _corpus(3)
    idx = str(tmp_path / "rs")
    meta = {"kind": "ivf", "metric": "ip", "encoding": "residual_int8",
            **jivf.build_ivf(idx, emb, nlist=6, metric="ip", block_align=512)}
    js = jivf.load_ivf_state(idx, meta, jnp.int8, refine_int4=True)
    js.setdefault("meta", meta)
    ts = tivf.load_ivf_state(idx, meta, torch.int8, refine_int4=True, device="cpu")
    ts.setdefault("meta", meta)
    np.testing.assert_array_equal(tivf.ensure_inv_perm(ts).numpy(), np.asarray(jivf.ensure_inv_perm(js)))
    np.testing.assert_array_equal(tivf.ensure_pos_list(ts).numpy(), np.asarray(jivf.ensure_pos_list(js)))
    xq = emb[:12] + 0.05 * rng.standard_normal((12, emb.shape[1])).astype(np.float32)
    cand = rng.integers(0, len(emb), (12, 40)).astype(np.int32)
    cand[:, -3:] = -1
    jd, ji = jivf.rescore_candidates(js, jnp.asarray(xq), jnp.asarray(cand), 10)
    td, ti = tivf.rescore_candidates(ts, torch.from_numpy(xq), torch.from_numpy(cand), 10)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_load(tmp_path, writer):
    """A directory written by either package's build_ivf loads in the other
    to the same arrays, and both probes return the same rescored ids."""
    emb, rng = _corpus(4, n=8192)
    idx = str(tmp_path / writer)
    build = jivf.build_ivf if writer == "jax" else tivf.build_ivf
    kw = {} if writer == "jax" else {"device": "cpu"}
    meta = {"kind": "ivf", "metric": "ip", "encoding": "residual_int8",
            **build(idx, emb, nlist=8, metric="ip", block_align=1024, **kw)}
    sizes = np.load(f"{idx}/ivf_list_size.npy")
    row_ids = np.load(f"{idx}/ivf_row_ids.npy")
    assert sizes.sum() == len(emb) and np.array_equal(np.sort(row_ids[row_ids >= 0]), np.arange(len(emb)))
    js = jivf.load_ivf_state(idx, meta, jnp.int8, refine_int4=True)
    js.setdefault("meta", meta)
    ts = tivf.load_ivf_state(idx, meta, torch.int8, refine_int4=True, device="cpu")
    ts.setdefault("meta", meta)
    _assert_states_equal(js, ts)
    xq = emb[:8] + 0.02 * rng.standard_normal((8, emb.shape[1])).astype(np.float32)
    _, ji = ivf_search_pallas(js, jnp.asarray(xq), 5, nprobe=8, metric="ip", interpret=True, rescore=32)
    _, ti = ivf_search_grouped_probe(ts, torch.from_numpy(xq), 5, nprobe=8, metric="ip", rescore=32)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)


def test_torch_build_matches_reference_layout_rules(tmp_path):
    emb, _ = _corpus(5, n=5000)
    meta = tivf.build_ivf(str(tmp_path / "t"), emb, nlist=4, metric="l2", block_align=512, device="cpu")
    assert meta["block_align"] == 512 and meta["probe_window"] % 512 == 0
    starts = np.load(str(tmp_path / "t" / "ivf_list_start.npy"))
    assert (starts % 512 == 0).all()
    spilled = tivf.build_ivf(str(tmp_path / "s"), emb, nlist=4, metric="ip", block_align=512,
                             spill_frac=0.1, device="cpu")
    assert spilled["spill_frac"] == 0.1
    assert np.load(str(tmp_path / "s" / "ivf_list_size.npy")).sum() > len(emb)
    with pytest.raises(ValueError):
        tivf.build_ivf(str(tmp_path / "x"), emb, nlist=4, metric="ip", spill_frac=0.1, device="cpu")


def test_index_io_matches_reference(tmp_path):
    """The port's copy of the index-directory I/O reads what the reference
    writes and writes what it reads, and rejects a newer format alike."""
    from lotus_tpu.ops import io as jio
    from lotus_tpu_torch.ops import io as tio

    assert (tio.FORMAT_VERSION, tio.META_FILE) == (jio.FORMAT_VERSION, jio.META_FILE)
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    for writer, reader, name in ((jio, tio, "a"), (tio, jio, "b")):
        d = str(tmp_path / name)
        writer.write_meta(d, {"kind": "flat", "dim": 4})
        writer.write_array(d, "vectors", arr)
        assert reader.read_meta(d) == {"kind": "flat", "dim": 4, "format_version": 1}
        np.testing.assert_array_equal(reader.read_array(d, "vectors"), arr)
        np.testing.assert_array_equal(reader.read_array(d, "vectors", mmap=False), arr)
    d = str(tmp_path / "future")
    jio.write_meta(d, {})
    import json

    with open(f"{d}/meta.json", "w") as f:
        json.dump({"format_version": 2}, f)
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="format_version"):
            mod.read_meta(d)
        with pytest.raises(FileNotFoundError):
            mod.read_meta(str(tmp_path / "missing"))
