"""Synthetic inputs of the grouped probe's pool stage (K3, ``pool_select``)
and a plain numpy build of every query's pool, shared by the CPU tests
(``test_torch_ivf_probe.py``) and the card's (``test_torch_kernels_cuda.py``).

``synth_pool`` makes what ``_grouped_probe`` hands the stage: K1's output
(seeded scores, a tenth of the lanes masked, packed with random 13-bit ids
or beside random storage rows), each pair's row in it, distinct probed lists
per query, block-aligned list starts, residual biases and int8 query scales.
Imports torch and numpy only, so the card's tests run without JAX.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from lotus_tpu_torch.ops.common import MASK_SCORE, NO_HIT

LOCAL_MASK = (1 << 13) - 1
QU = 128


def synth_pool(seed, *, b, nprobe, nlist, kc=128, packed=True, bias=True, scale=True, empty=0, zeroed=0,
               all_empty_query=False, ties=False, crowded=0, device="cpu"):
    """The stage's inputs as a dict of tensors on ``device`` (``n_rows`` an int).

    ``empty`` lists have size 0 and K1 wrote MASK_SCORE rows for their pairs;
    ``zeroed`` lists have size 0 but rows of scores (the sizes zeroed after
    K1 ran), so only the stage's own masking hides them; ``all_empty_query``
    gives query 0's lists size 0; ``ties`` rounds every score to a quarter,
    so scores tie across pairs; the first ``crowded`` pairs of every query
    score 200 above the rest and the next 8 pairs 100 above, so with
    ``crowded`` = k - 1 all the crowded pairs' candidates, more than a
    block's list holds, beat the k-th best pair maximum.
    """
    rng = np.random.default_rng(seed)
    probe_lists = np.argsort(rng.random((b, nlist)), axis=1)[:, :nprobe].astype(np.int32)
    sizes = rng.integers(1, 8192, nlist).astype(np.int32)
    dead = rng.choice(nlist, empty + zeroed, replace=False)
    sizes[dead[:empty]] = 0
    if all_empty_query:
        sizes[probe_lists[0]] = 0
    padded = np.maximum((sizes + 1023) // 1024, 1) * 1024
    starts = (np.cumsum(padded) - padded).astype(np.int32)
    n_rows = int(padded.sum())
    p = b * nprobe
    rows_total = (p // QU + 2) * QU  # spare rows, as K1's grid has dead chunks
    padpos = rng.permutation(rows_total)[:p].astype(np.int64)
    vals = rng.standard_normal((rows_total, kc)).astype(np.float32)
    if ties:
        vals = (np.round(vals * 4) / 4).astype(np.float32)
    if crowded:
        pairs = padpos.reshape(b, nprobe)
        vals[pairs[:, :crowded].reshape(-1)] += np.float32(200.0)
        vals[pairs[:, crowded : crowded + 8].reshape(-1)] += np.float32(100.0)
    masked = rng.random((rows_total, kc)) < 0.1
    vals[masked] = MASK_SCORE
    if packed:
        local = rng.integers(0, LOCAL_MASK + 1, (rows_total, kc)).astype(np.int32)
        bits = (vals.view(np.int32) & ~LOCAL_MASK) | local
        cand = np.where(masked, vals, bits.view(np.float32))
        cand_idx = None
    else:
        cand = vals
        cand_idx = rng.integers(0, n_rows, (rows_total, kc)).astype(np.int32)
    k1_dead = sizes[probe_lists.reshape(-1)] == 0
    cand[padpos[k1_dead]] = MASK_SCORE
    if zeroed:
        sizes[dead[empty:]] = 0
    out = {
        "cand_pk": cand.reshape(rows_total // QU, QU, kc),
        "cand_idx": None if cand_idx is None else cand_idx.reshape(rows_total // QU, QU, kc),
        "padpos": padpos,
        "probe_lists": probe_lists,
        "list_start": starts,
        "list_size": sizes,
        "probe_bias": rng.standard_normal((b, nprobe)).astype(np.float32) if bias else None,
        "q_scales": (rng.random(b) + 0.5).astype(np.float32) if scale else None,
    }
    out = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in out.items()}
    out["n_rows"] = n_rows
    return out


def numpy_pool(inp, *, packed):
    """Every query's pool in pair order, built query by query in numpy:
    ``(scores, rows)``, each (b, nprobe * kc)."""
    a = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in inp.items()}
    cand = a["cand_pk"].reshape(-1, a["cand_pk"].shape[-1])
    kc = cand.shape[1]
    b, nprobe = a["probe_lists"].shape
    scores = np.empty((b, nprobe * kc), np.float32)
    rows = np.empty((b, nprobe * kc), np.int32)
    mask = np.float32(MASK_SCORE)
    for q in range(b):
        for j in range(nprobe):
            lst = a["probe_lists"][q, j]
            pos = a["padpos"][q * nprobe + j]
            raw = cand[pos] if a["list_size"][lst] > 0 else np.full(kc, mask, np.float32)
            if packed:
                bits = raw.view(np.int32)
                s = (bits & ~LOCAL_MASK).view(np.float32)
                r = np.minimum(a["list_start"][lst] + (bits & LOCAL_MASK), a["n_rows"] - 1)
            else:
                s = raw.copy()
                r = a["cand_idx"].reshape(-1, kc)[pos]
            if a["probe_bias"] is not None:
                dead = s <= np.float32(MASK_SCORE / 2)
                if a["q_scales"] is not None:
                    with np.errstate(over="ignore"):  # masked scores overflow, then turn MASK_SCORE
                        s = (s * a["q_scales"][q]).astype(np.float32)
                s = np.where(dead, mask, (s + a["probe_bias"][q, j]).astype(np.float32))
            scores[q, j * kc : (j + 1) * kc] = s
            rows[q, j * kc : (j + 1) * kc] = r
    return scores, rows


def order_keys(scores):
    """f32 scores as unsigned keys that order as the scores do (the radix map)."""
    u = np.ascontiguousarray(scores, np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def stable_head(scores, rows, k_out):
    """The first ``k_out`` of each query's pool by descending score, earlier
    pool positions first among equal scores."""
    order = np.argsort(~order_keys(scores), axis=1, kind="stable")[:, :k_out]
    return np.take_along_axis(scores, order, 1), np.take_along_axis(rows, order, 1)


def assert_head(got_s, got_r, pool_s, pool_r):
    """``got`` is a pool's top-k in some order of ties: its scores equal the
    stable head's bit for bit; above MASK_SCORE / 2 its (score, row) pairs
    equal the stable head's above the head's last score, and at that score
    they are candidates of the pool with that score."""
    got_s, got_r = np.asarray(got_s), np.asarray(got_r)
    exp_s, exp_r = stable_head(pool_s, pool_r, got_s.shape[1])
    np.testing.assert_array_equal(got_s.view(np.int32), exp_s.view(np.int32))
    for q in range(got_s.shape[0]):
        bits, live = got_s[q].view(np.int32), got_s[q] > MASK_SCORE / 2
        last = bits[-1]
        above = live & (bits != last)
        assert sorted(zip(bits[above], got_r[q][above])) == sorted(zip(bits[above], exp_r[q][above])), q
        at = live & (bits == last)
        if at.any():
            pool_at = Counter(pool_r[q][pool_s[q].view(np.int32) == last].tolist())
            assert not Counter(got_r[q][at].tolist()) - pool_at, q


def numpy_finish(top_s, top_rows, row_ids, k, *, spilled, q_scales):
    """``finish_pool`` query by query: ids, the dedup (each id's first, best
    copy) or the padding, then the scale.  Returns each query's live
    (score bits, id, row) triples, at most k of them."""
    top_s, top_rows, row_ids = (np.asarray(x) for x in (top_s, top_rows, row_ids))
    out = []
    for q in range(top_s.shape[0]):
        seen, keep = set(), []
        for s, r in zip(top_s[q], top_rows[q]):
            if s <= MASK_SCORE / 2:
                continue
            i = int(row_ids[r])
            if spilled and i in seen:
                continue
            seen.add(i)
            if q_scales is not None:
                s = np.float32(s * np.asarray(q_scales)[q])
            keep.append((np.float32(s).view(np.int32).item(), i, int(r)))
        out.append(keep[:k])
    return out


def assert_finish(got, expected, k):
    """``finish_pool``'s output against ``numpy_finish``'s triples: the live
    triples equal, the rest MASK_SCORE and NO_HIT, k wide."""
    s, i, r = (np.asarray(x) for x in got)
    assert s.shape == (len(expected), k) and i.shape == s.shape and r.shape == s.shape
    for q, keep in enumerate(expected):
        live = i[q] != NO_HIT
        triples = list(zip(s[q][live].view(np.int32).tolist(), i[q][live].tolist(), r[q][live].tolist()))
        assert sorted(triples) == sorted(keep), q
        assert (s[q][~live] <= MASK_SCORE / 2).all(), q
