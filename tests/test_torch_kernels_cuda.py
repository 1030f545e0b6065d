"""K1, K2 and K3 on the card against their plain PyTorch versions, variant
by variant, and the grouped probe's slices free of host synchronisation.

These tests need an NVIDIA GPU and the CUDA toolkit (a CUDA kernel has no
CPU mode) and skip without them.  The file imports torch only, so it also
runs on a machine without JAX:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch
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
@pytest.mark.parametrize("spill_frac", [0.0, 0.2])
def test_grouped_probe_slices_sync_only_in_probe_layout_on_gpu(monkeypatch, spill_frac):
    """A search's slices queue their launches without waiting for the card:
    under ``torch.cuda.set_sync_debug_mode("error")`` nothing synchronises
    but ``probe_layout`` (its histogram's ``hist[q_ids, l_flat] = 1`` copies
    a host scalar), which runs with the mode off, and K3 (never the plain
    version) runs once a slice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from lotus_tpu_torch.ops.bench_data import synth_ivf_device_build

    built = synth_ivf_device_build(n=131072, d=64, nlist=64, n_clusters=512, chunk=32768, queries_b=1024,
                                   gt_queries=1, k=10, spill_frac=spill_frac, device="cuda", seed=3)
    state, xq = built["state"], built["queries"]
    kw = dict(nprobe=16, int8_queries=True, rescore=24, query_chunk=512)
    want = tprobe.ivf_search_grouped_probe(state, xq, 10, **kw)  # builds the kernels, caches the state's tables
    torch.cuda.synchronize()

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached pool_select_reference")

    layout = tprobe.probe_layout

    def layout_unchecked(*a, **k):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return layout(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(tprobe, "pool_select_reference", plain)
    monkeypatch.setattr(tprobe, "probe_layout", layout_unchecked)
    launches = tprobe.pool_select.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tprobe.ivf_search_grouped_probe(state, xq, 10, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tprobe.pool_select.launches == launches + 2
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
