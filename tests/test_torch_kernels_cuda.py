"""K1, K2, K3, K4 and K5 on the card against their plain PyTorch versions,
variant by variant, the grouped probe's slices free of host
synchronisation, and DeepSeek-V2's layers, whose MoE combine is K4.

These tests need an NVIDIA GPU and the CUDA toolkit (a CUDA kernel has no
CPU mode) and skip without them.  The file imports torch only, so it also
runs on a machine without JAX:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch
from torch_layout import LAYOUT_CASES, assert_layout, numpy_layout, synth_layout
from torch_pool import assert_finish, numpy_finish, synth_pool

from lotus_tpu_torch.ops import ivf_probe as tprobe
from lotus_tpu_torch.ops.common import MASK_SCORE


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


_POOL_ARGS = ("cand_pk", "cand_idx", "padpos", "probe_lists", "list_start", "list_size", "probe_bias", "q_scales")
# (case, synth_pool arguments, k, spilled); k_out = min(2k if spilled else k, the pool)
_K3_CASES = [
    # the config-4 slice: K1's packed top-2 output, residual bias, int8 query scales
    ("config4_slice", dict(b=2048, nprobe=208, nlist=4096), 24, False),
    # a pool of 512 KB a query, far past shared memory
    ("nprobe_1024", dict(b=96, nprobe=1024, nlist=2048), 24, False),
    ("spilled_2k", dict(b=256, nprobe=64, nlist=512, packed=False, bias=False, scale=False), 24, True),
    ("kc64", dict(b=256, nprobe=32, nlist=256, kc=64, packed=False, bias=False, scale=False), 10, False),
    ("kc64_packed_bias", dict(b=256, nprobe=32, nlist=256, kc=64, scale=False), 10, False),
    # k past the pool: k_out is the whole pool, padded after
    ("k_out_whole_pool", dict(b=64, nprobe=3, nlist=32, kc=64), 300, False),
    # fewer pairs than k_out: no bound from the pairs' maxima
    ("fewer_pairs_than_k_out", dict(b=64, nprobe=8, nlist=64, kc=64), 24, True),
    ("all_lists_empty", dict(b=64, nprobe=16, nlist=256, all_empty_query=True), 24, False),
    ("empty_and_owned", dict(b=256, nprobe=64, nlist=512, empty=20, zeroed=40), 24, False),
    # scores rounded to quarters: ties across pairs and at the head's end
    ("ties", dict(b=256, nprobe=64, nlist=512, packed=False, bias=False, scale=False, ties=True), 24, False),
    # 23 pairs of a query far above the rest: the candidate list overflows and t rises
    ("crowded", dict(b=64, nprobe=208, nlist=1024, packed=False, bias=False, scale=False, crowded=23), 24, False),
    # tables past shared memory, so each block keeps them in the device-memory workspace:
    # 9,000 pairs a query; k_out past 16,384 with fewer pairs than k_out; both at once
    ("nprobe_9000", dict(b=24, nprobe=9000, nlist=9216, scale=False), 24, False),
    ("k_out_20000", dict(b=16, nprobe=256, nlist=512, packed=False, bias=False, scale=False), 20000, False),
    ("k_out_17000_nprobe_20000", dict(b=4, nprobe=20000, nlist=20480, kc=64), 17000, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,kw,k,spilled", _K3_CASES, ids=[c[0] for c in _K3_CASES])
def test_pool_select_matches_plain_version_on_gpu(case, kw, k, spilled):
    """K3 against ``pool_select_reference`` on the same inputs on the card:
    scores bit for bit; rows above MASK_SCORE / 2 those of the pool's stable
    descending order (earlier candidates first among equal scores), so the
    plain version's rows agree as sets wherever its ``torch.topk`` may order
    ties otherwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K3 has no CPU mode")
    inp = synth_pool(31, device="cuda", **kw)
    args = tuple(inp[n] for n in _POOL_ARGS)
    packed = kw.get("packed", True)
    kc = inp["cand_pk"].shape[-1]
    k_out = min(2 * k if spilled else k, kw["nprobe"] * kc)
    opts = dict(k_out=k_out, packed=packed, n_rows=inp["n_rows"])
    launches = tprobe.pool_select.launches
    got_s, got_r = tprobe.pool_select(*args, **opts)
    assert tprobe.pool_select.launches == launches + 1
    ref_s, ref_r = tprobe.pool_select_reference(*args, **opts)
    pool_s, pool_r = tprobe.pool_candidates(*args, packed=packed, n_rows=inp["n_rows"])
    stable = torch.sort(pool_s, dim=1, descending=True, stable=True).indices[:, :k_out]
    want_r = torch.gather(pool_r, 1, stable)
    torch.cuda.synchronize()
    got_s, got_r, ref_s, ref_r, want_r = (t.cpu() for t in (got_s, got_r, ref_s, ref_r, want_r))
    assert torch.equal(got_s.view(torch.int32), ref_s.view(torch.int32))
    live = got_s > MASK_SCORE / 2
    assert torch.equal(torch.where(live, got_r, 0), torch.where(live, want_r, 0))
    # The plain version's (score, row) pairs above each query's last score.
    bits = got_s.view(torch.int32)
    above = live & (bits != bits[:, -1:])
    pairs = [(bits.long() << 32) | r.long() for r in (got_r, ref_r)]
    held = [torch.sort(torch.where(above, p, torch.full_like(p, -1)), dim=1).values for p in pairs]
    assert torch.equal(held[0], held[1])
    if case == "all_lists_empty":
        assert not live[0].any() and live[1:, 0].all()
    if spilled or k_out < k:
        rng = np.random.default_rng(32)
        row_ids = torch.from_numpy(rng.integers(0, inp["n_rows"] // 2, inp["n_rows"]).astype(np.int32))
        last_scale = inp["q_scales"].cpu() if inp["q_scales"] is not None and inp["probe_bias"] is None else None
        got = tprobe.finish_pool(got_s.cuda(), got_r.cuda(), row_ids.cuda(), k, spilled=spilled,
                                 q_scales=None if last_scale is None else last_scale.cuda())
        want = numpy_finish(got_s, got_r, row_ids, k, spilled=spilled, q_scales=last_scale)
        assert_finish(tuple(t.cpu() for t in got), want, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case,b,nlist,nprobe,d,extra", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
def test_probe_layout_matches_plain_version_on_gpu(case, b, nlist, nprobe, d, extra, dtype):
    """K5 against ``probe_layout_reference`` on the same card tensors, and
    both against the stage's definition: the chunk table, each pair's slot,
    the block counts and every row of a live chunk bit for bit; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K5 has no CPU mode")
    args = synth_layout(11, b=b, nlist=nlist, nprobe=nprobe, d=d, dtype=dtype, device="cuda", **extra)
    launches = tprobe.probe_layout.launches
    got = tprobe.probe_layout(*args, 1024)
    assert tprobe.probe_layout.launches == launches + 1
    ref = tprobe.probe_layout_reference(*args, 1024)
    torch.cuda.synchronize()
    want = numpy_layout(*args)
    assert_layout(ref, want)
    assert_layout(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["lowered_histogram_bound", "past_2_30_cells"])
def test_probe_layout_past_the_histogram_on_gpu(monkeypatch, regime):
    """Past ``HIST_MAX_CELLS`` the plain version groups pairs by an argsort,
    which K5 equals bit for bit: once with the bound lowered to this batch's
    cells, and once on a batch of more than 2**30 (b, nlist) cells, whose bit
    table (256 MB with its counts) K5 indexes in 64 bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K5 has no CPU mode")
    if regime == "lowered_histogram_bound":
        b, nlist, nprobe = 600, 256, 24
        args = synth_layout(13, b=b, nlist=nlist, nprobe=nprobe, d=768, dtype=torch.int8, device="cuda")
        monkeypatch.setattr(tprobe, "HIST_MAX_CELLS", b * nlist - 1)
    else:
        # Two distinct lists a query, drawn without a (b, nlist) matrix.
        b, nlist, d = (1 << 20) + 40, 1024, 16
        rng = np.random.default_rng(13)
        first = rng.integers(0, nlist, b)
        lists = np.stack([first, (first + rng.integers(1, nlist, b)) % nlist], 1).astype(np.int32)
        xq = rng.integers(-127, 128, (b, d)).astype(np.int8)
        sizes = rng.integers(0, 8192, nlist).astype(np.int32)
        args = tuple(torch.from_numpy(a).cuda() for a in (lists, xq, sizes))
        assert b * nlist > tprobe.HIST_MAX_CELLS and b * nlist > 1 << 30
    launches = tprobe.probe_layout.launches
    got = tprobe.probe_layout(*args, 1024)
    ref = tprobe.probe_layout_reference(*args, 1024)
    torch.cuda.synchronize()
    assert tprobe.probe_layout.launches == launches + 1
    want = numpy_layout(*args)
    assert_layout(got, want)
    assert_layout(ref, want)


@pytest.mark.cuda
def test_probe_layout_dead_rows_are_never_read_on_gpu():
    """K5 leaves the rows of dead chunks unwritten: filled with garbage, K1's
    output on them equals K1's output on the plain version's units (zeros
    there) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g = torch.Generator().manual_seed(17)
    d, bl, nlist, b, nprobe = 64, 1024, 6, 300, 3
    sizes = torch.tensor([3000, 0, 1024, 17, 2100, 900], dtype=torch.int32)
    padded = torch.clamp((sizes + bl - 1) // bl, min=1) * bl
    starts = (torch.cumsum(padded, 0) - padded).to(torch.int32)
    rows = int(padded.sum())
    x = torch.randint(-127, 128, (rows, d), generator=g, dtype=torch.int8).cuda()
    scales = (torch.rand(rows, generator=g) + 0.5).cuda()
    lists = torch.argsort(torch.rand((b, nlist), generator=g), dim=1)[:, :nprobe].to(torch.int32).cuda()
    xq = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8).cuda()
    starts, sizes = starts.cuda(), sizes.cuda()
    units, chunk_list, _, _ = tprobe.probe_layout(lists, xq, sizes, bl)
    ref_units, ref_chunk_list, _, _ = tprobe.probe_layout_reference(lists, xq, sizes, bl)
    dead = torch.repeat_interleave(chunk_list[:-1] < 0, tprobe.QU)
    assert int(dead.sum()) >= tprobe.QU and torch.equal(chunk_list, ref_chunk_list)
    units[dead] = torch.randint(-127, 128, (int(dead.sum()), d), dtype=torch.int8, device="cuda")
    kw = dict(bl=bl, int8_dot=True, l2=False, packed=True)
    got_s, _ = tprobe.probe_fold(units, x, scales, None, chunk_list, starts, sizes, **kw)
    ref_s, _ = tprobe.probe_fold(ref_units, x, scales, None, chunk_list, starts, sizes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_s.view(torch.int32), ref_s.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["lists_on_cpu", "int64_lists", "f64_queries", "rows_not_b", "strided_queries",
                                   "flat_lists"])
def test_probe_layout_refuses_what_it_cannot_read_on_gpu(fault):
    """K5 reads contiguous int32 lists and sizes beside contiguous (b, d)
    queries of a type K1 takes, all on the queries' card: the wrapper
    refuses anything else and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    lists, xq, sizes = synth_layout(19, b=64, nlist=32, nprobe=8, d=64, dtype=torch.bfloat16, device="cuda")
    if fault == "lists_on_cpu":
        lists = lists.cpu()
    if fault == "int64_lists":
        lists = lists.long()
    if fault == "f64_queries":
        xq = xq.double()
    if fault == "rows_not_b":
        xq = xq[:-1]
    if fault == "strided_queries":
        xq = torch.cat([xq, xq], 1)[:, ::2]
    if fault == "flat_lists":
        lists = lists.reshape(-1)
    launches = tprobe.probe_layout.launches
    with pytest.raises(ValueError, match="probe_layout"):
        tprobe.probe_layout(lists, xq, sizes, 1024)
    assert tprobe.probe_layout.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("spill_frac", [0.0, 0.2])
def test_grouped_probe_slices_make_no_sync_on_gpu(monkeypatch, spill_frac):
    """A search's slices queue their launches without waiting for the card:
    under ``torch.cuda.set_sync_debug_mode("error")`` nothing in a whole
    slice synchronises, the layout included; K5 and K3 (never their plain
    versions) run once a slice; and the answers equal those of the same
    search through the plain layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build

    built = synth_ivf_device_build(n=131072, d=64, nlist=64, n_clusters=512, chunk=32768, queries_b=1024,
                                   gt_queries=1, k=10, spill_frac=spill_frac, device="cuda", seed=3)
    state, xq = built["state"], built["queries"]
    kw = dict(nprobe=16, int8_queries=True, rescore=24, query_chunk=512)
    tprobe.ivf_search_grouped_probe(state, xq, 10, **kw)  # builds the kernels, caches the state's tables
    with monkeypatch.context() as m:
        m.setattr(tprobe, "probe_layout", tprobe.probe_layout_reference)
        want = tprobe.ivf_search_grouped_probe(state, xq, 10, **kw)
    torch.cuda.synchronize()

    def refuse(name):
        def plain(*a, **k):
            raise AssertionError(f"a CUDA tensor reached {name}")

        return plain

    monkeypatch.setattr(tprobe, "pool_select_reference", refuse("pool_select_reference"))
    monkeypatch.setattr(tprobe, "probe_layout_reference", refuse("probe_layout_reference"))
    launches = tprobe.pool_select.launches, tprobe.probe_layout.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tprobe.ivf_search_grouped_probe(state, xq, 10, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (tprobe.pool_select.launches, tprobe.probe_layout.launches) == (launches[0] + 2, launches[1] + 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _deepseek_v2_two_layers():
    """DeepSeek-V2-Lite at its published widths over two layers (the dense
    first layer and one MoE layer), bf16 on the card with the benchmark's
    seeded weights, and four right-padded texts of 512, 300, 177 and 64
    tokens in one batch."""
    import json
    from pathlib import Path

    from perfbench.reference import deepseek_v2 as ref

    from lotus_tpu_torch.models.checkpoint import fit_state_dict
    from lotus_tpu_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Model

    root = Path(__file__).resolve().parent.parent
    cfg = dict(json.loads((root / "perfbench" / "configs" / "dsv2_lite.json").read_text()), num_hidden_layers=2)
    seed, dev = 2**31 + 20, torch.device("cuda")
    with torch.device("meta"):
        model = DeepseekV2Model(DeepseekV2Config.from_dict(cfg))
    weights = {"model." + k: v for k, v in ref.model_weights(cfg, seed, dev, torch.bfloat16).items()}
    model = fit_state_dict(model, weights).eval()
    lens = [512, 300, 177, 64]
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg["vocab_size"], (len(lens), 512), generator=g, device=dev)
    mask = (torch.arange(512, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]).long()
    return cfg, seed, model, ids, mask, lens


@pytest.mark.cuda
def test_deepseek_v2_layers_match_reference_on_gpu():
    """The port's dense and MoE layers in bf16 against the plain f32
    reference on the card: within 0.06 of each text's largest hidden value
    (bf16 over two layers read 0.016-0.020 on the CPU) and 0.02 in the
    pooled, normalised embedding (0.0058-0.0068 on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from perfbench.reference import deepseek_v2 as ref

    cfg, seed, model, ids, mask, lens = _deepseek_v2_two_layers()
    with torch.inference_mode():
        out = model(ids, mask).float()
    plain = ref.PlainDeepseekV2(cfg, seed, ids.device).hidden([ids[r, :n].tolist() for r, n in enumerate(lens)])
    for r, (n, p) in enumerate(zip(lens, plain)):
        assert float((out[r, :n] - p).abs().max() / p.abs().max()) <= 0.06
        e, f = out[r, :n].mean(0), p.mean(0)
        assert float(torch.linalg.vector_norm(e / e.norm() - f / f.norm())) <= 0.02


@pytest.mark.cuda
def test_deepseek_v2_forward_makes_no_sync_on_gpu():
    """The whole forward, routing and grouped GEMMs included, queues its
    work without waiting for the card, under
    ``torch.cuda.set_sync_debug_mode("error")``; so does it with a profiler
    running, when the spans record events and the MoE counters add up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from torch.profiler import ProfilerActivity, profile

    from lotus_tpu_torch import profiling

    _, _, model, ids, mask, lens = _deepseek_v2_two_layers()
    with torch.inference_mode():
        want = model(ids, mask)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model(ids, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("error")
            try:
                with profiling.annotate("rm.forward"):
                    model(ids, mask)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    assert int(profiling.counter_totals()["moe.pairs"][1].sum()) == ids.numel() * 6
    assert profiling.span_totals()["moe.experts"].device_s > 0


# (name, tokens, slots, hidden, held experts of 64 or None for all, shared rows)
_K4_CASES = [
    # the passage join's MoE layer: 64 x 512 tokens, top-6 of 64 experts, hidden 2,048
    ("cell", 32768, 6, 2048, None, True),
    # a quarter of the experts held, the rows past the held count NaN
    ("cell_held_subset_nan", 32768, 6, 2048, (16, 32), True),
    # narrow rows, several tokens a block, the tokens not a multiple of them
    ("narrow_ragged_tokens", 1001, 6, 64, None, True),
    # a row of more vectors than a block has threads
    ("wide_rows", 333, 6, 2056, (0, 40), True),
    ("top_1_no_shared", 999, 1, 2048, None, False),
    # more slots than a thread keeps in flight
    ("k_10", 517, 10, 136, (8, 56), True),
]


def _k4_inputs(t, k, hidden, held, shared, dtype, seed=5):
    """A layer's routed pairs on the card as ``DeepseekV2MoE.route`` orders
    them (64 experts, pairs to experts outside ``held`` last), the rows in
    that order with those past the held count NaN."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    first, end = held or (0, 64)
    local = torch.randint(0, 64, (t * k,), generator=g, device=dev) - first
    n = end - first
    group = torch.where((local >= 0) & (local < n), local, n)
    order = torch.argsort(group, stable=True)
    offsets = torch.cumsum(torch.bincount(group, minlength=n + 1)[:n], 0).to(torch.int32)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=dev))
    out = torch.randn(t * k, hidden, generator=g, device=dev).to(dtype)
    out[int(offsets[-1]):] = float("nan")
    weights = torch.rand(t, k, generator=g, device=dev)
    rows = torch.randn(t, hidden, generator=g, device=dev).to(dtype) if shared else None
    return out, inv, weights, offsets, rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
@pytest.mark.parametrize("case,t,k,hidden,held,shared", _K4_CASES, ids=[c[0] for c in _K4_CASES])
def test_moe_combine_matches_plain_version_on_gpu(case, t, k, hidden, held, shared, dtype):
    """K4 against ``moe_combine_reference`` on the same inputs on the card,
    within one rounding of the row type relative to the terms' magnitudes
    (the f32 sum's order may differ); no NaN of a row past the held count
    reaches the output; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K4 has no CPU mode")
    from lotus_tpu_torch.ops.moe_combine import moe_combine, moe_combine_reference

    out, inv, weights, offsets, rows = _k4_inputs(t, k, hidden, held, shared, dtype)
    launches = moe_combine.launches
    got = moe_combine(out, inv, weights, offsets, rows)
    assert moe_combine.launches == launches + 1
    want = moe_combine_reference(out, inv, weights, offsets, rows)
    magnitude = moe_combine_reference(out.abs(), inv, weights, offsets, None if rows is None else rows.abs())
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (t, hidden) and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    assert bool((err <= torch.finfo(dtype).eps * magnitude.float()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["hidden_tail", "misaligned_rows", "int32_inverse", "requires_grad"])
def test_moe_combine_refuses_what_it_cannot_read_on_gpu(fault):
    """K4 reads 16-byte vectors of int64-indexed rows and has no backward:
    the wrapper refuses a row width with a tail, rows not 16-byte aligned,
    an int32 inverse and, with grad enabled, rows that require grad, and
    launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lotus_tpu_torch.ops.moe_combine import moe_combine

    out, inv, weights, offsets, rows = _k4_inputs(300, 6, 2050 if fault == "hidden_tail" else 2048, None, True,
                                                  torch.bfloat16)
    if fault == "misaligned_rows":
        base = torch.empty(out.numel() + 1, dtype=out.dtype, device=out.device)
        out = base[1:].view(out.shape).copy_(out)
    if fault == "int32_inverse":
        inv = inv.to(torch.int32)
    if fault == "requires_grad":
        out.requires_grad_()
    launches = moe_combine.launches
    with pytest.raises(ValueError, match="16-byte|int64|backward"):
        moe_combine(out, inv, weights, offsets, rows)
    assert moe_combine.launches == launches


@pytest.mark.cuda
def test_deepseek_v2_moe_layers_launch_k4_on_gpu(monkeypatch):
    """Every MoE layer call on the card launches K4 once (never the plain
    version), and its ``moe.combine`` span reads the kernel's route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from torch.profiler import ProfilerActivity, profile

    from lotus_tpu_torch import profiling
    from lotus_tpu_torch.models.deepseek_v2 import DeepseekV2MoE
    from lotus_tpu_torch.ops import moe_combine as combine

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached moe_combine_reference")

    monkeypatch.setattr(combine, "moe_combine_reference", plain)
    _, _, model, ids, mask, _ = _deepseek_v2_two_layers()
    moe_layers = sum(isinstance(m, DeepseekV2MoE) for m in model.modules())
    assert moe_layers == 1
    launches = combine.moe_combine.launches
    with torch.inference_mode():
        model(ids, mask)  # no profiler: the spans are off, K4 launches all the same
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            model(ids, mask)
    assert combine.moe_combine.launches == launches + 2 * moe_layers
    routes = [r["attrs"]["route"] for r in profiling.span_records() if r["name"] == "moe.combine"]
    assert routes == ["kernel"] * moe_layers
