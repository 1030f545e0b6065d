"""K2's plain PyTorch version (``lotus_tpu_torch.ops.flat_scan``) held to the
Pallas flat scan (``lotus_tpu.ops.pallas_flat``, run with ``interpret=True``)
on the same numpy inputs.

``k = 256`` returns the whole candidate pool (2 x 128 lanes), sorted.  The
int8-query pool is integer arithmetic followed by single f32 multiplies (and
adds), so it must agree bit for bit; the bf16 variants sum in another order
and agree within a tolerance.  The port scans an unpadded store where the
reference needs rows padded to 1024 and queries to 256.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lotus_tpu.ops.pallas_flat as pflat
from lotus_tpu.ops.ivf import build_ivf as jax_build_ivf
from lotus_tpu.ops.ivf import load_ivf_state as jax_load
from lotus_tpu.ops.quant import quantize_rows as jax_quantize
from lotus_tpu.vector_store import TpuVS
from lotus_tpu_torch import TorchVS
from lotus_tpu_torch.ops import flat_scan as tscan
from lotus_tpu_torch.ops.ivf import load_ivf_state as torch_load
from lotus_tpu_torch.ops.quant import quantize_rows as torch_quantize

_JAX = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _data(seed, n=3072, d=64, b=300, centers=0):
    rng = np.random.default_rng(seed)
    if centers:
        c = rng.standard_normal((centers, d)).astype(np.float32)
        xb = c[rng.integers(0, centers, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    else:
        xb = rng.standard_normal((n, d)).astype(np.float32)
    xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    xq = xb[rng.integers(0, n, b)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    return xb, xq / np.linalg.norm(xq, axis=1, keepdims=True), rng


def _exact_scale(xq):
    """Rows with max |x| = 127/128, so the int8 query scale is exactly 2**-7
    in both packages (under ``jit`` XLA turns ``absmax / 127`` into a
    multiply by the reciprocal, one ulp off the division in some rows)."""
    c = np.float32(0.9921875)
    out = np.clip(xq * (c / np.abs(xq).max(axis=1, keepdims=True)), -c, c).astype(np.float32)
    top = np.abs(out).argmax(axis=1)
    out[np.arange(len(out)), top] = np.copysign(c, out[np.arange(len(out)), top])
    return out


def _assert_pool_bitwise(ref, got):
    (rs, ri), (gs, gi) = [tuple(np.asarray(a) for a in p) for p in (ref, got)]
    np.testing.assert_array_equal(rs.view(np.int32), gs.view(np.int32))
    for q in range(rs.shape[0]):
        assert sorted(zip(rs[q].tolist(), ri[q].tolist())) == sorted(zip(gs[q].tolist(), gi[q].tolist())), q


def _assert_pool_close(ref, got, tol, min_overlap=0.99):
    """Sorted pools within ``tol`` (absolute and relative) and at least
    ``min_overlap`` of the live ids shared: a near-tie inside a lane may
    swap its two rows when the sums run in another order."""
    (rs, ri), (gs, gi) = [tuple(np.asarray(a) for a in p) for p in (ref, got)]
    np.testing.assert_allclose(gs, rs, rtol=tol, atol=tol)
    shared = sum(len(set(r[r >= 0].tolist()) & set(g[g >= 0].tolist())) for r, g in zip(ri, gi))
    assert shared >= min_overlap * (ri >= 0).sum(), shared / (ri >= 0).sum()


@pytest.mark.parametrize("n_rows", [3072, 2500])
def test_int8_query_pool_bitwise(n_rows):
    """The whole 256-candidate pool, int8 x int8: the reference scans a
    1024-padded store with ``n_rows`` masking its tail; the port scans the
    unpadded ``n_rows`` rows."""
    xb, xq, _ = _data(0)
    xq = _exact_scale(xq)
    j8, js = jax_quantize(jnp.asarray(xb))
    t8, ts = torch_quantize(torch.from_numpy(xb))
    ref = pflat.flat_search_pallas(j8, jnp.asarray(xq), 256, n_rows=n_rows, xb_scales=js, interpret=True)
    got = tscan.flat_search_pallas(t8[:n_rows], torch.from_numpy(xq), 256, xb_scales=ts[:n_rows])
    assert int(np.asarray(ref[1]).max()) < n_rows and int(got[1].max()) < n_rows
    _assert_pool_bitwise(ref, got)


@pytest.mark.parametrize("store", ["bfloat16", "float32", "int8_bf16_queries", "float16"])
def test_float_variants_pool_close(store):
    """bf16 products are exact in f32; only the order of the f32 sums
    differs (64 terms of magnitude <= 1: well under 1e-5).  f32 and f16
    stores round to bf16 first in both packages (``pallas_flat.py:74``)."""
    xb, xq, _ = _data(1, n=2048, d=48, b=200)
    if store == "int8_bf16_queries":
        j8, js = jax_quantize(jnp.asarray(xb))
        t8, ts = torch_quantize(torch.from_numpy(xb))
        ref = pflat.flat_search_pallas(j8, jnp.asarray(xq), 256, xb_scales=js, int8_queries=False,
                                       interpret=True)
        got = tscan.flat_search_pallas(t8, torch.from_numpy(xq), 256, xb_scales=ts, int8_queries=False)
    else:
        dt = getattr(torch, store)
        ref = pflat.flat_search_pallas(jnp.asarray(xb, _JAX[dt]), jnp.asarray(xq), 256, interpret=True)
        got = tscan.flat_search_pallas(torch.from_numpy(xb).to(dt), torch.from_numpy(xq), 256)
    _assert_pool_close(ref, got, 1e-5)


_I8, _BF, _F32, _F16 = torch.int8, torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize(
    "qdt,xdt,d,loader",
    [
        (_BF, _F16, 768, "tma+convert"),   # f16 store: rounded to bf16 in shared memory
        (_BF, _F16, 66, "register"),
        (_BF, _F32, 768, "tma+convert"),
        (_BF, _I8, 768, "tma+convert"),
        (_BF, _BF, 768, "tma"),
        (_I8, _I8, 768, "tma"),
        (_I8, _I8, 770, "register"),
    ],
)
def test_kernel_variant_accepts(qdt, xdt, d, loader):
    assert tscan.kernel_variant(qdt, xdt, d) == loader


@pytest.mark.parametrize("qdt,xdt", [(_I8, _F16), (_I8, _BF), (_F32, _F32), (_F16, _F16), (_F32, _F16)])
def test_kernel_variant_rejects_what_k2_lacks(qdt, xdt):
    with pytest.raises(ValueError, match="scan_fold"):
        tscan.kernel_variant(qdt, xdt, 64)


@pytest.mark.parametrize("blk", [512, 1024])
def test_bias_and_row_mask_planes(blk):
    """``_flat_pallas_impl`` with a (n_blocks, B) bias plane and a row mask
    (the residual IVF scan's inputs) against ``scan_fold``, int8 x int8.

    The port rounds ``dot * scale`` and then ``+ bias`` separately, as the
    kernel's ``__fmul_rn`` / ``__fadd_rn`` do: its scores equal that numpy
    arithmetic bit for bit.  XLA on the CPU contracts the two into one FMA
    in interpret mode, so the reference differs from it in the last bit of
    some scores: held within 1e-6 (a few ulps at |score| <= 4), same ids.
    """
    xb, xq, rng = _data(2, n=2048, d=32, b=256)
    n_blocks = 2048 // blk
    bias = rng.standard_normal((n_blocks, 256)).astype(np.float32)
    mask = (rng.random(2048) > 0.3).astype(np.int8)
    j8, js = jax_quantize(jnp.asarray(xb))
    jq8, _ = jax_quantize(jnp.asarray(xq))
    ref = pflat._flat_pallas_impl(j8, jq8, 2000, js, None, 256, True, bias_blocks=jnp.asarray(bias),
                                  row_mask=jnp.asarray(mask), blk=blk)
    t8, ts = torch_quantize(torch.from_numpy(xb))
    tq8, _ = torch_quantize(torch.from_numpy(xq))
    pool = tscan.scan_fold(tq8, t8, 2000, ts, torch.from_numpy(bias), torch.from_numpy(mask), blk=blk)
    gs, gi = (a.numpy() for a in tscan._pool_topk(pool, None, 256))
    live = gi >= 0
    assert not np.isin(gi, np.nonzero(mask[:2000] == 0)[0]).any() and gi.max() < 2000
    dot = (tq8.numpy().astype(np.int32) @ t8.numpy().astype(np.int32).T).astype(np.float32)
    sep = dot * ts.numpy()[None, :] + bias[np.arange(2048) // blk].T
    np.testing.assert_array_equal(gs[live].view(np.int32), np.take_along_axis(sep, np.maximum(gi, 0), 1)[live].view(np.int32))
    rs, ri = np.asarray(ref[0]), np.asarray(ref[1])
    np.testing.assert_allclose(gs, rs, rtol=1e-6, atol=1e-6)
    for q in range(256):
        assert set(ri[q].tolist()) == set(gi[q].tolist()), q


def test_fold_keeps_sequential_tie_order(monkeypatch):
    """The plain version equals a row-by-row fold with a strict '>' (ties to
    the earlier row, masked rows never enter), across its row blocks."""
    monkeypatch.setattr(tscan, "REF_BLOCK_ROWS", 256)
    rng = np.random.default_rng(3)
    n, d = 1000, 4
    xb = rng.integers(-1, 2, (n, d)).astype(np.int8)  # few distinct scores: many ties
    xq = rng.integers(-1, 2, (3, d)).astype(np.int8)
    mask = (rng.random(n) > 0.2).astype(np.int8)
    best_s, best_i, sec_s, sec_i = tscan.scan_fold(
        torch.from_numpy(xq), torch.from_numpy(xb), 950, torch.ones(n), None, torch.from_numpy(mask))
    s = xq.astype(np.float32) @ xb.T.astype(np.float32)
    for q in range(3):
        for lane in range(tscan.NL):
            want = [tscan.MASK_SCORE, -1, tscan.MASK_SCORE, -1]
            for r in range(lane, 950, tscan.NL):
                v = s[q, r] if mask[r] else tscan.MASK_SCORE
                if v > want[0]:
                    want = [v, r, want[0], want[1]]
                elif v > want[2]:
                    want[2:] = [v, r]
            got = [float(best_s[q, lane]), int(best_i[q, lane]), float(sec_s[q, lane]), int(sec_i[q, lane])]
            assert got == [np.float32(want[0]), want[1], np.float32(want[2]), want[3]], (q, lane)


def _ivf_stores(tmp_path, emb, encoding):
    idx_dir = str(tmp_path / "ivf")
    meta = {"kind": "ivf", "metric": "ip",
            **jax_build_ivf(idx_dir, emb, nlist=8, metric="ip", block_align=512)}
    if encoding:
        meta["encoding"] = encoding
    js = jax_load(idx_dir, meta, jnp.int8)
    js.setdefault("meta", meta)
    ts = torch_load(idx_dir, meta, torch.int8, device="cpu")
    ts.setdefault("meta", meta)
    assert js["meta"].get("encoding") == ts["meta"].get("encoding")
    return js, ts


@pytest.mark.parametrize("encoding", ["residual_int8", None])
def test_ivf_residual_scan_matches_reference(tmp_path, encoding):
    """The exhaustive scan of a 512-aligned IVF store: residual int8 (bf16
    queries, the exact q.c bias per block) and plain int8 (int8 queries).
    Rescored top-10 sets equal; the unrescored pools agree within 1e-5 (the
    bias and the bf16 sums are f32 sums taken in another order)."""
    xb, _, rng = _data(4, n=6000, d=32, b=1, centers=8)
    js, ts = _ivf_stores(tmp_path, xb, encoding)
    assert (js["meta"].get("encoding") == "residual_int8") == (encoding is not None)
    xq = _exact_scale(xb[rng.integers(0, 6000, 40)] + 0.02 * rng.standard_normal((40, 32)).astype(np.float32))
    jd, ji = pflat.ivf_residual_scan(js, jnp.asarray(xq), 10, rescore=64, interpret=True)
    td, ti = tscan.ivf_residual_scan(ts, torch.from_numpy(xq), 10, rescore=64)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    for q in range(40):
        assert set(ti[q].tolist()) == set(np.asarray(ji)[q].tolist()), q
    rs, ri = pflat.ivf_residual_scan(js, jnp.asarray(xq), 64, rescore=None, interpret=True)
    gs, gi = tscan.ivf_residual_scan(ts, torch.from_numpy(xq), 64, rescore=None)
    assert set(gi.numpy().ravel().tolist()) <= set(range(6000)) | {-1}
    _assert_pool_close((rs, ri), (gs, gi), 1e-5)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _same_top10(ref10, ref11, got, tol):
    """Top-10 sets equal, except where the reference's 10th and 11th scores
    lie within ``tol`` (a near-tie the other summation order may flip)."""
    r11 = np.asarray(ref11.distances)
    for q, (r, g) in enumerate(zip(ref10.indices, got.indices)):
        if r11[q, 9] - r11[q, 10] > tol:
            assert set(r) == set(g), q


@pytest.mark.parametrize(
    "kw",
    [
        dict(device_dtype="int8", scan="pallas"),              # int8 x int8, rescore 32
        dict(device_dtype="bfloat16", scan="auto", approx=True),  # bf16, B >= 256
    ],
)
def test_store_k2_route_matches_reference(tmp_path, monkeypatch, kw):
    """``TorchVS`` serves a Flat search without ids through K2 where
    ``TpuVS`` (Pallas in interpret mode) takes its K2, with the same top-10
    sets; a search with ids takes the masked XLA-style scan in both."""
    xb, xq, rng = _data(5, n=4096, d=32, b=256, centers=16)
    idx = str(tmp_path / "flat")
    ref = TpuVS(index_type="flat", **kw)
    ref.index([], xb, idx)
    ref._pallas_interpret = True
    port = TorchVS(index_type="flat", device="cpu", **kw)
    port.load_index(idx)
    ref_calls = _spy(monkeypatch, pflat, "flat_search_pallas")
    port_calls = _spy(monkeypatch, tscan, "scan_fold")
    r10, r11, p10 = ref(xq, 10), ref(xq, 11), port(xq, 10)
    assert len(ref_calls) == 2 and len(port_calls) == 1
    _same_top10(r10, r11, p10, 1e-4 if kw["device_dtype"] == "int8" else 1e-3)
    ids = sorted(rng.choice(4096, 500, replace=False).tolist())
    out = port(xq[:8], 10, ids=ids)
    assert len(port_calls) == 1 and set(np.asarray(out.indices).ravel()) <= set(ids)
