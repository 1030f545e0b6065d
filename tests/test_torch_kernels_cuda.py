"""K1 and K2 on the card against their plain PyTorch versions, variant by
variant.

These tests need an NVIDIA GPU and the CUDA toolkit (a CUDA kernel has no
CPU mode) and skip without them.  The file imports torch only, so it also
runs on a machine without JAX:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from lotus_tpu_torch.ops import ivf_probe as tprobe


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,metric,int8_dot,packed",
    [
        (torch.int8, "ip", True, True),
        (torch.bfloat16, "ip", False, True),
        (torch.int8, "ip", False, True),
        (torch.float32, "ip", False, False),
        (torch.bfloat16, "l2", False, False),
        (torch.int8, "ip", True, False),
    ],
)
def test_kernel_matches_plain_version_on_gpu(dtype, metric, int8_dot, packed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 has no CPU mode")
    g = torch.Generator().manual_seed(0)
    d, bl, nlist = 64, 1024, 6
    sizes = torch.tensor([3000, 0, 1024, 17, 2100, 900], dtype=torch.int32)
    padded = torch.clamp((sizes + bl - 1) // bl, min=1) * bl
    starts = (torch.cumsum(padded, 0) - padded).to(torch.int32)
    rows = int(padded.sum())
    xf = torch.randn((rows, d), generator=g)
    x = torch.randint(-127, 128, (rows, d), generator=g, dtype=torch.int8) if dtype == torch.int8 else xf.to(dtype)
    chunk_list = torch.tensor([0, 2, 2, 3, 4, 5, 1, -1, -1], dtype=torch.int32)
    if int8_dot:
        q = torch.randint(-127, 128, ((len(chunk_list) - 1) * 128, d), generator=g, dtype=torch.int8)
    else:
        q = torch.randn(((len(chunk_list) - 1) * 128, d), generator=g).to(
            torch.float32 if dtype == torch.float32 else torch.bfloat16)
    scales = torch.rand(rows, generator=g) + 0.5 if dtype == torch.int8 else None
    norms = torch.rand(rows, generator=g) if metric == "l2" else None
    args = (q, x, scales, norms, chunk_list, starts, sizes)
    ref_s, ref_i = tprobe.probe_fold_reference(*args, bl=bl, int8_dot=int8_dot, l2=metric == "l2", packed=packed)
    cuda_args = [None if t is None else t.cuda() for t in args]
    got_s, got_i = tprobe.probe_fold(*cuda_args, bl=bl, int8_dot=int8_dot, l2=metric == "l2", packed=packed)
    torch.cuda.synchronize()
    if int8_dot:  # exact integer dot products: bit for bit, ids included
        torch.testing.assert_close(got_s.cpu().view(torch.int32), ref_s.view(torch.int32), rtol=0, atol=0)
        if not packed:
            torch.testing.assert_close(got_i.cpu(), ref_i, rtol=0, atol=0)
        return
    # Float sums run in another order; packed scores keep ~10 mantissa bits.
    tol = 2e-3 if packed else 1e-4
    got, ref = got_s.cpu(), ref_s
    if packed:
        got = (got.view(torch.int32) & ~tprobe._LOCAL_MASK).view(torch.float32)
        ref = (ref.view(torch.int32) & ~tprobe._LOCAL_MASK).view(torch.float32)
    torch.testing.assert_close(got, ref, rtol=tol, atol=1e-3)


_I8, _BF, _F16 = torch.int8, torch.bfloat16, torch.float16


@pytest.mark.cuda
@pytest.mark.parametrize(
    "qdt,xdt,d,sizes,chunks,l2,packed,top1,route,query",
    [
        # lists probed by several chunks, at the config-4 depth
        (_I8, _I8, 768, [3000, 64, 2100], [0, 0, 0, 1, 2, 2, -1], False, True, False, "wgmma+tma", "resident"),
        # a window past 8192 rows (unpacked; the ids are storage rows)
        (_I8, _I8, 64, [12283, 9000, 8193], [0, 1, 2, 0, -1], False, False, False, "wgmma+tma", "resident"),
        # ternary rows and unit scales: scores tie, the earlier row wins
        ("ternary", _I8, 64, [5000, 2048], [0, 1, 0, -1], False, False, False, "wgmma+tma", "resident"),
        # depths TMA cannot take: the CUDA cores
        (_I8, _I8, 772, [3000, 17], [0, 1, 0, -1], False, True, False, "cuda-cores", "resident"),
        (_BF, _BF, 100, [3000, 17], [0, 1, -1], False, False, False, "cuda-cores", "resident"),
        # a deep store: the query tile streams with the ring
        (_I8, _I8, 1536, [2100, 700], [0, 1, 0, -1], False, True, False, "wgmma+tma", "streamed"),
        (_BF, _BF, 1536, [2100, 700], [0, 1, -1], False, False, False, "wgmma+tma", "streamed"),
        # bf16 queries on int8 rows (converted in shared memory), with l2
        (_BF, _I8, 768, [3000, 500], [0, 1, 1, -1], True, False, False, "wgmma+tma+convert", "streamed"),
        (_BF, _I8, 256, [3000, 500], [0, 1, -1], False, True, False, "wgmma+tma+convert", "resident"),
        # the top-1 fold
        (_I8, _I8, 768, [3000, 64, 2100], [0, 0, 1, 2, -1], False, True, True, "wgmma+tma", "resident"),
        (_I8, _I8, 64, [12283, 9000], [0, 1, 0, -1], False, False, True, "wgmma+tma", "resident"),
        (_BF, _BF, 768, [3000, 500], [0, 1, -1], True, False, True, "wgmma+tma", "streamed"),
        (torch.float32, torch.float32, 64, [3000, 500], [0, 1, -1], False, True, True, "cuda-cores", "resident"),
        # f16 rows under f32 queries (an f16 store): converted to f32 in the loader
        (torch.float32, _F16, 768, [3000, 500], [0, 1, 0, -1], False, False, False, "cuda-cores", "resident"),
        (torch.float32, _F16, 768, [3000, 500], [0, 1, -1], False, True, False, "cuda-cores", "resident"),
        (torch.float32, _F16, 770, [3000, 17], [0, 1, -1], True, False, True, "cuda-cores", "resident"),
        # the int8 dot at d % 4 != 0: a ragged last word, bit for bit
        (_I8, _I8, 66, [3000, 17], [0, 1, 0, -1], False, True, False, "cuda-cores", "resident"),
        (_I8, _I8, 770, [3000, 500], [0, 1, -1], False, False, False, "cuda-cores", "resident"),
        (_I8, _I8, 66, [12283, 9000], [0, 1, -1], False, False, True, "cuda-cores", "resident"),
    ],
)
def test_probe_fold_edges_on_gpu(qdt, xdt, d, sizes, chunks, l2, packed, top1, route, query):
    """K1's redesign at its edges, each against the plain version: the int8
    dot bit for bit with ids, the float variants as above; and the route the
    wrapper reports (tensor cores or CUDA cores, query tile resident or
    streamed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 has no CPU mode")
    g = torch.Generator().manual_seed(5)
    ternary = qdt == "ternary"
    qdt = _I8 if ternary else qdt
    int8_dot = qdt == _I8
    bl = 1024
    sizes = torch.tensor(sizes, dtype=torch.int32)
    padded = torch.clamp((sizes + bl - 1) // bl, min=1) * bl
    starts = (torch.cumsum(padded, 0) - padded).to(torch.int32)
    rows = int(padded.sum())
    chunk_list = torch.tensor(chunks, dtype=torch.int32)
    nq = (len(chunks) - 1) * tprobe.QU

    def values(dtype, n):
        if ternary:
            return torch.randint(-1, 2, (n, d), generator=g, dtype=_I8)
        if dtype == _I8:
            return torch.randint(-127, 128, (n, d), generator=g, dtype=_I8)
        return torch.randn((n, d), generator=g).to(dtype)

    q, x = values(qdt, nq), values(xdt, rows)
    scales = None
    if xdt == _I8:
        scales = torch.ones(rows) if ternary else torch.rand(rows, generator=g) + 0.5
    norms = torch.rand(rows, generator=g) if l2 else None
    args = (q, x, scales, norms, chunk_list, starts, sizes)
    kw = dict(bl=bl, int8_dot=int8_dot, l2=l2, packed=packed, top1=top1)
    ref_s, ref_i = tprobe.probe_fold_reference(*args, **kw)
    got_s, got_i = tprobe.probe_fold(*[None if t is None else t.cuda() for t in args], **kw)
    torch.cuda.synchronize()
    assert (tprobe.probe_fold.last_plan["route"], tprobe.probe_fold.last_plan["query"]) == (route, query)
    assert tprobe.kernel_variant(q.dtype, x.dtype, d, int8_dot=int8_dot, l2=l2) == route
    assert got_s.shape == (len(chunks), tprobe.QU, tprobe.ncand(top1))
    if ternary:  # the ties are there: many lanes hold equal best and second scores
        assert int((ref_s[:, :, :64] == ref_s[:, :, 64:]).sum()) > ref_s.numel() // 8
    if int8_dot:
        torch.testing.assert_close(got_s.cpu().view(torch.int32), ref_s.view(torch.int32), rtol=0, atol=0)
        if not packed:
            torch.testing.assert_close(got_i.cpu(), ref_i, rtol=0, atol=0)
        return
    tol = 2e-3 if packed else 1e-4
    got, ref = got_s.cpu(), ref_s
    if packed:
        got = (got.view(torch.int32) & ~tprobe._LOCAL_MASK).view(torch.float32)
        ref = (ref.view(torch.int32) & ~tprobe._LOCAL_MASK).view(torch.float32)
    torch.testing.assert_close(got, ref, rtol=tol, atol=1e-3)
    if not packed:  # the best id of every lane whose best lies clear of its second
        sec = tprobe.probe_fold_reference(*args, **{**kw, "top1": False})[0][:, :, 64:]
        best = ref[:, :, :64]
        clear = ((best - sec).abs() > 1e-2 * (1 + best.abs())) & (best > -1e38)
        assert torch.equal(got_i.cpu()[:, :, :64][clear], ref_i[:, :, :64][clear])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "qdt,xdt,d,blk",
    [
        (torch.int8, torch.int8, 64, None),           # the int8 dot, store through TMA
        (torch.int8, torch.int8, 70, 512),            # depth not a multiple of 16 (register loader); bias + row mask
        (torch.int8, torch.int8, 70, 1024),
        (torch.bfloat16, torch.int8, 64, 512),        # int8 store, bf16 queries (residual scan)
        (torch.bfloat16, torch.int8, 64, 1024),
        (torch.bfloat16, torch.bfloat16, 70, None),   # bf16 store
        (torch.bfloat16, torch.float32, 33, None),    # f32 store rounded to bf16
    ],
)
def test_scan_fold_matches_plain_version_on_gpu(qdt, xdt, d, blk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K2 has no CPU mode")
    from lotus_tpu_torch.ops import flat_scan as tscan

    g = torch.Generator().manual_seed(1)
    b, n, n_valid = 150, 5000, 4700  # B not a multiple of 64; a ragged, masked row tail

    def values(dtype, rows):
        if dtype == torch.int8:
            return torch.randint(-127, 128, (rows, d), generator=g, dtype=torch.int8)
        return torch.randn((rows, d), generator=g).to(dtype)

    q, x = values(qdt, b), values(xdt, n)
    scales = torch.rand(n, generator=g) + 0.5 if xdt == torch.int8 else None
    bias = torch.randn((-(-n // blk), b), generator=g) if blk else None
    mask = (torch.rand(n, generator=g) > 0.3).to(torch.int8) if blk else None
    args = (q, x, n_valid, scales, bias, mask)
    ref = tscan.scan_fold_reference(*args, blk=blk or tscan.BLK)
    got = tscan.scan_fold(*[t.cuda() if isinstance(t, torch.Tensor) else t for t in args], blk=blk or tscan.BLK)
    torch.cuda.synchronize()
    _hold_scan(got, ref, exact=qdt == torch.int8)


def _hold_scan(got, ref, *, exact):
    """K2's pool against its plain version's: bit for bit with ids for the
    int8 dot, else within the float tolerance with equal best ids in clear
    lanes."""
    (gs, gi, gs2, gi2), (rs, ri, rs2, ri2) = [[t.cpu() for t in p] for p in (got, ref)]
    if exact:  # exact integer dot, single f32 multiply and add: bit for bit
        for a, e in ((gs, rs), (gs2, rs2)):
            torch.testing.assert_close(a.view(torch.int32), e.view(torch.int32), rtol=0, atol=0)
        torch.testing.assert_close(gi, ri, rtol=0, atol=0)
        torch.testing.assert_close(gi2, ri2, rtol=0, atol=0)
        return
    # bf16 products are exact; the f32 sums run in another order.
    torch.testing.assert_close(gs, rs, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gs2, rs2, rtol=1e-4, atol=1e-4)
    clear = (rs - rs2).abs() > 1e-3  # a lane's two rows may swap only on a near-tie
    assert torch.equal(gi[clear], ri[clear])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "qdt,xdt,d,b,n,n_valid,ternary,loader",
    [
        (torch.bfloat16, torch.bfloat16, 768, 150, 3000, 3000, False, "tma"),  # the main depth, TMA
        (torch.int8, torch.int8, 768, 150, 3000, 3000, False, "tma"),  # the last tile 22 of 64 queries
        (torch.int8, torch.int8, 768, 65, 3000, 2917, False, "tma"),  # a tile of one query
        (torch.bfloat16, torch.bfloat16, 768, 1, 3000, 2917, False, "tma"),  # a lone query
        (torch.bfloat16, torch.int8, 768, 70, 3000, 2917, False, "tma+convert"),  # residual-scan pair
        (torch.bfloat16, torch.float32, 768, 70, 3000, 2917, False, "tma+convert"),  # f32 rows rounded
        (torch.bfloat16, torch.float16, 768, 150, 3000, 2917, False, "tma+convert"),  # f16 rows rounded
        (torch.int8, torch.int8, 64, 150, 5000, 1000 + 37, True, "tma"),  # ties across splits
        (torch.int8, torch.int8, 70, 150, 5000, 4999, True, "register"),
    ],
)
def test_scan_fold_edges_on_gpu(qdt, xdt, d, b, n, n_valid, ternary, loader):
    """The redesign's edges: d 768 through TMA in bf16 and int8 and through
    the converting loader (int8 rows, and f32 rows rounded to bf16), query tiles that run past B (B 150 and 65: the
    last 64-query tile holds 22 queries or one; its other rows load zeros
    and write nothing), an n_valid inside a 128-row slice (so inside a ring
    stage of two depth chunks), and an int8 store of values in {-1, 0, 1}
    without scales, whose scores tie across the 128-row splits the plan gives
    at this size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K2 has no CPU mode")
    from lotus_tpu_torch.ops import flat_scan as tscan

    g = torch.Generator().manual_seed(2)

    def values(dtype, rows):
        if ternary:
            return torch.randint(-1, 2, (rows, d), generator=g, dtype=torch.int8)
        if dtype == torch.int8:
            return torch.randint(-127, 128, (rows, d), generator=g, dtype=torch.int8)
        return torch.randn((rows, d), generator=g).to(dtype)

    q, x = values(qdt, b), values(xdt, n)
    scales = torch.rand(n, generator=g) + 0.5 if xdt == torch.int8 and not ternary else None
    args = (q, x, n_valid, scales)
    ref = tscan.scan_fold_reference(*args)
    got = tscan.scan_fold(*[t.cuda() if isinstance(t, torch.Tensor) else t for t in args])
    torch.cuda.synchronize()
    assert tscan.scan_fold.last_plan["loader"] == loader == tscan.kernel_variant(qdt, xdt, d)
    if ternary:  # the ties are there: many lanes hold equal best and second scores
        assert int((ref[0] == ref[2]).sum()) > b * tscan.NL // 16
    _hold_scan(got, ref, exact=qdt == torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "qdt,xdt,d,loader,query",
    [
        (torch.bfloat16, torch.int8, 70, "register", "resident"),  # int8 -> bf16 one value at a time
        (torch.bfloat16, torch.int8, 200, "register", "resident"),  # 8-byte vectors, then a scalar tail
        (torch.bfloat16, torch.float32, 68, "register", "resident"),  # a bf16 query row of 136 bytes
        (torch.bfloat16, torch.bfloat16, 1280, "tma", "resident"),  # the deepest resident bf16 tile
        (torch.bfloat16, torch.bfloat16, 1536, "tma", "streamed"),  # text-embedding-3-small's d
        (torch.bfloat16, torch.int8, 1536, "tma+convert", "streamed"),
        (torch.bfloat16, torch.float32, 1536, "tma+convert", "streamed"),
        (torch.bfloat16, torch.float16, 1536, "tma+convert", "streamed"),
        (torch.bfloat16, torch.float16, 70, "register", "resident"),  # f16 -> bf16 one value at a time
        (torch.bfloat16, torch.bfloat16, 1540, "register", "streamed"),
        (torch.int8, torch.int8, 3072, "tma", "streamed"),
        (torch.int8, torch.int8, 2600, "register", "streamed"),
    ],
)
def test_scan_fold_loaders_and_depths_on_gpu(qdt, xdt, d, loader, query):
    """Each store loader at the depths that pick it, and depths whose query
    tile does not fit in shared memory beside two ring stages, so that its
    depth chunks stream with the store's; with scales, bias and row mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K2 has no CPU mode")
    from lotus_tpu_torch.ops import flat_scan as tscan

    g = torch.Generator().manual_seed(3)
    b, n, n_valid, blk = 150, 3000, 2917, 512

    def values(dtype, rows):
        if dtype == torch.int8:
            return torch.randint(-127, 128, (rows, d), generator=g, dtype=torch.int8)
        return torch.randn((rows, d), generator=g).to(dtype)

    q, x = values(qdt, b), values(xdt, n)
    scales = torch.rand(n, generator=g) + 0.5 if xdt == torch.int8 else None
    bias = torch.randn((-(-n // blk), b), generator=g)
    mask = (torch.rand(n, generator=g) > 0.3).to(torch.int8)
    args = (q, x, n_valid, scales, bias, mask)
    ref = tscan.scan_fold_reference(*args, blk=blk)
    got = tscan.scan_fold(*[t.cuda() if isinstance(t, torch.Tensor) else t for t in args], blk=blk)
    torch.cuda.synchronize()
    assert (tscan.scan_fold.last_plan["loader"], tscan.scan_fold.last_plan["query"]) == (loader, query)
    _hold_scan(got, ref, exact=qdt == torch.int8)
