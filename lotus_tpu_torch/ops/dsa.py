"""DeepSeek Sparse Attention (DSA) in plain PyTorch: the lightning indexer's
scores and top-k selection, and latent attention over each query's selected
keys (``models/deepseek_v32.py``).

For a sequence's index queries q (s, H, d), one index key k (s, d) a token
and head weights w (s, H) (the scales folded in), the index score of query t
and key u <= t is I(t, u) = sum_h w[t, h] ReLU(q[t, h] . k[u]).
``index_topk`` computes it in f32 (half-precision operands multiplied and
summed in f32) in blocks of queries, each block over the keys up to its last
query only, so the (s x H x s) products are never held at once, and keeps
each query's top ``min(topk, t + 1)`` keys.

``sparse_attention`` runs latent attention in its absorbed form over them:
each head's nope query through the head's key up-projection (``W_UK``)
beside its rope query, the softmax scale folded in, scores the selected
keys' normed latent rows and rotated rope keys (rank + rope wide, shared by
the heads), gathered once a block of queries; the softmax in f32 over the
selection alone; the probabilities times the gathered latent rows, then each
head's value up-projection (``W_UV``).  Per selected (query, key) pair the
absorbed form does 2 x heads x (rank + rope + rank) operations where the
non-absorbed one does 2 x heads x (nope + rope + v): 3.4 times as many at
DeepSeek-V3.2's widths, for a key read as its rank + rope values instead of
heads x (nope + rope + v).

Neither makes a host synchronisation.
"""

from __future__ import annotations

import torch

# The f32 products (queries x heads x keys) one block of index scores holds: 2 GiB.
INDEX_BLOCK_CELLS = 1 << 29
# The (query, selected key) pairs one block of sparse attention gathers.
ATTN_BLOCK_PAIRS = 1 << 20


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched 3-D) with an f32 result: half-precision
    operands multiplied and summed in f32 (cuBLAS's f32 output on the card;
    f32 copies of the operands, the same products, on the CPU)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def query_block(per_query: int, total: int, cap: int) -> int:
    """The largest power of two of queries, at most ``total``'s next power of
    two, whose block holds at most ``cap`` cells at ``per_query`` a query
    (at least one query)."""
    n = 1
    while n < total and 2 * n * per_query <= cap:
        n *= 2
    return n


def causal_selections(s: int, topk: int) -> int:
    """sum over t < s of min(topk, t + 1): the (query, key) pairs a sequence
    of ``s`` tokens attends to."""
    return s * (s + 1) // 2 if s <= topk else topk * (topk + 1) // 2 + (s - topk) * topk


def index_scores(q: torch.Tensor, k: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(m, H, d) index queries, (n, d) keys and (m, H) f32 head weights: the
    (m, n) f32 scores sum_h w[:, h] ReLU(q[:, h] . k)."""
    m, heads, d = q.shape
    logits = f32_matmul(q.reshape(m * heads, d), k.T).relu_()
    return torch.bmm(w[:, None], logits.view(m, heads, -1)).squeeze(1)


def index_topk(q: torch.Tensor, k: torch.Tensor, w: torch.Tensor, topk: int) -> torch.Tensor:
    """(b, s, H, d) index queries ``q``, (b, s, d) keys ``k`` and (b, s, H)
    f32 head weights ``w``: the (b, s, min(topk, s)) int64 selection.  Row t
    holds, in no order, the ``min(topk, t + 1)`` keys u <= t with the largest
    I(t, u); where t + 1 < topk the rest of the row holds later positions,
    which ``sparse_attention`` masks."""
    b, s, heads, _ = q.shape
    kk = min(topk, s)
    out = torch.empty(b, s, kk, dtype=torch.int64, device=q.device)
    n = query_block(heads * s, s, INDEX_BLOCK_CELLS)
    future = torch.ones(n, n, dtype=torch.bool, device=q.device).triu_(1)
    for r in range(b):
        for lo in range(0, s, n):
            hi = min(lo + n, s)
            m = hi - lo
            scores = index_scores(q[r, lo:hi], k[r, :hi], w[r, lo:hi])
            scores[:, lo:].masked_fill_(future[:m, :m], float("-inf"))
            take = min(kk, hi)
            out[r, lo:hi, :take] = torch.topk(scores, take, dim=-1, sorted=False).indices
            if take < kk:
                out[r, lo:hi, take:] = torch.arange(take, kk, device=q.device)
    return out


def sparse_attention(q_nope: torch.Tensor, q_pe: torch.Tensor, kv: torch.Tensor, idx: torch.Tensor,
                     w_uk: torch.Tensor, w_uv: torch.Tensor, scale: float) -> torch.Tensor:
    """Latent attention of (b, s, h, nope) ``q_nope`` and rotated (b, s, h,
    rope) ``q_pe`` over the keys ``idx`` selects (``index_topk``'s) of (b, s,
    rank + rope) ``kv`` (each token's normed latent, then its rotated rope
    key), with (h, nope, rank) ``w_uk`` and (h, rank, v) ``w_uv`` the heads'
    key and value up-projections and ``scale`` the softmax scale: (b, s, h,
    v) in ``q_nope``'s dtype."""
    b, s, heads, _ = q_nope.shape
    rank, kk = w_uk.shape[-1], idx.shape[-1]
    width = kv.shape[-1]
    out = torch.empty(b, s, heads, w_uv.shape[-1], dtype=q_nope.dtype, device=q_nope.device)
    n = query_block(kk, s, ATTN_BLOCK_PAIRS)
    for r in range(b):
        for lo in range(0, s, n):
            hi = min(lo + n, s)
            m = hi - lo
            absorbed = f32_matmul(q_nope[r, lo:hi].transpose(0, 1), w_uk).transpose(0, 1)  # (m, h, rank)
            query = torch.cat((absorbed, q_pe[r, lo:hi].float()), dim=-1).mul_(scale).to(q_nope.dtype)
            sel = idx[r, lo:hi]
            keys = kv[r].index_select(0, sel.reshape(-1)).view(m, kk, width)
            scores = f32_matmul(query, keys.transpose(1, 2))  # (m, h, kk)
            if lo + 1 < kk:  # a row t with t + 1 < kk: its selection's tail is later positions
                later = sel > torch.arange(lo, hi, device=sel.device)[:, None]
                scores.masked_fill_(later[:, None], float("-inf"))
            probs = torch.softmax(scores, dim=-1).to(q_nope.dtype)
            latent = torch.bmm(probs, keys[..., :rank])  # (m, h, rank)
            out[r, lo:hi] = torch.bmm(latent.transpose(0, 1), w_uv).transpose(0, 1)
    return out
