"""KDA's recurrence (Kimi Delta Attention: a gated delta rule with a decay
per key channel) in chunks, in plain PyTorch operations.

For each (batch, head), token t, with ``q_t``, ``k_t`` (d_k, L2-normalised),
``v_t`` (d_v), the log decay ``g_t`` <= 0 (d_k) and the write strength
``beta_t`` in (0, 1), from S_0 = 0 in f32::

    S_t = diag(exp(g_t)) S_{t-1}
    S_t = S_t + beta_t k_t (v_t - S_t^T k_t)^T
    o_t = S_t^T q_t / sqrt(d_k)

``kda_scan`` computes the same outputs a chunk of ``CHUNK`` tokens at a
time (the WY form of the delta rule, as ``fla``'s ``chunk_kda`` has it).
Inside a chunk, with G_r the cumulative log decay from the chunk's start to
row r (per channel, non-increasing), the rows' pseudo-values solve

    (I + A) U = diag(beta) (V - (K * exp(G)) S),
    A[r, i] = beta_r sum_c k_r[c] k_i[c] exp(G_r[c] - G_i[c])   (i < r),

and the outputs are O = (Q * exp(G)) S + P U with P[r, i] = sum_c q_r[c]
k_i[c] exp(G_r[c] - G_i[c]) (i <= r); the state moves on as S' =
diag(exp(G_C)) S + (K * exp(G_C - G))^T U.  One triangular solve a chunk
(all chunks at once, as the inverse times the right-hand sides), then a
loop over the chunks of three batched products (the only sequential part),
then the outputs in one batched product.  ``scan_chunks`` takes its inputs
in chunk tiles with the channels first, (chunks, batch x heads, d, CHUNK),
the layout a causal convolution over channels-first projections slices into
without a transposing copy (``from_channels``); ``kda_scan`` takes (b, t,
heads, d).

Keeping the exponents bounded.  exp(G_r) and exp(G_C - G_r) are at most 1.
A and P need exp(G_r - G_i) for i <= r, which no single reference point can
split into a row factor and a column factor in f32 once a channel decays by
more than f32's range (about e^88) inside the chunk.  So ``scan_chunks``
splits it in f64 at the chunk's middle row m, exp(G_r - G_m) exp(G_m - G_i),
with each token's log decay floored at -21 (``PAIR_FLOOR``), so that no
factor passes e^672, inside f64's range (e^709) and above its smallest
normal; the same floored sums, in f64, give every other decay of the chunk.
A floor changes only a decay below e^-21 = 7.6e-10 into another below it,
under f32's resolution of the terms it is summed with; every other decay is
exact.  Every exponent is finite, so no decay, however strong, gives inf or
NaN where the token recurrence gives none.

Right padding needs nothing: a sequence's pads come after its real tokens
and cannot reach them.  A sequence not a whole number of chunks is padded
at its end, which no real token reaches either, and cut off again.  The state
is f32, every other product runs in f32, and nothing waits for the device.
"""

from __future__ import annotations

import torch

CHUNK = 64  # rows a chunk
PAIR_FLOOR = -21.0  # each token's log decay, floored for the chunk's decays


def from_channels(y: torch.Tensor, t: int, heads: int) -> torch.Tensor:
    """(b, heads x d, t') channels-first (columns past ``t`` unread) ->
    (chunks, b x heads, d, CHUNK) f32, zero past ``t``."""
    b, c = y.shape[:2]
    n = -(-t // CHUNK)
    y = y[..., :t]
    if n * CHUNK != t:
        y = torch.nn.functional.pad(y, (0, n * CHUNK - t))
    y = y.unflatten(-1, (n, CHUNK)).unflatten(1, (heads, c // heads)).permute(3, 0, 1, 2, 4)
    return y.to(torch.float32, memory_format=torch.contiguous_format).flatten(1, 2)


def from_rows(x: torch.Tensor) -> torch.Tensor:
    """(b, t, heads, d) -> (chunks, b x heads, d, CHUNK) f32, zero past t."""
    b, t, h, d = x.shape
    return from_channels(x.permute(0, 2, 3, 1).reshape(b, h * d, t), t, h)


def to_rows(o: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """(chunks, b x heads, CHUNK, d) -> (b, t, heads, d)."""
    n, bh, c, d = o.shape
    return o.view(n, b, bh // b, c, d).permute(1, 0, 3, 2, 4).reshape(b, n * c, bh // b, d)[:, :t]


def scan_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor
                ) -> torch.Tensor:
    """The recurrence over chunk tiles: ``q``, ``k`` (L2-normalised), ``v``
    and the log decays ``g`` (chunks, B, d, CHUNK) f32, ``beta`` (chunks, B,
    1, CHUNK); returns the outputs (chunks, B, CHUNK, d_v) f32."""
    n, bh, dk, c = k.shape
    scale = dk**-0.5
    # the cumulative sums along each channel's row, as a product with a triangle of ones
    G = g.clamp(min=PAIR_FLOOR).double() @ torch.ones(c, c, dtype=torch.float64, device=g.device).triu_()
    # A and P's pairs, split about row C / 2 - 1 in f64
    e = (G - G[..., c // 2 - 1 : c // 2]).exp_()
    cols = k / e
    A = torch.tril(torch.mul(k, e).mT @ cols, -1).float().mul_(beta.mT)
    P = torch.tril(torch.mul(q, e).mT @ cols).float().mul_(scale)
    del e, cols
    eye = torch.eye(c, device=k.device)
    T = torch.linalg.solve_triangular(A.add_(eye), eye.expand_as(A), upper=False, unitriangular=True).mul_(beta)
    del A
    eg = torch.exp(G).float()
    w = T @ (k * eg).mT  # (n, bh, C, dk)
    u0 = T @ v.mT  # (n, bh, C, dv)
    del T
    last = G[..., -1:]
    k_out = (k * torch.exp(last - G).float())  # (n, bh, dk, C)
    decay = torch.exp(last).float()  # (n, bh, dk, 1)
    del G
    states = k.new_empty((n + 1, bh, dk, v.shape[-2]))
    states[0].zero_()
    u = torch.empty_like(u0)
    for i in range(n):
        torch.baddbmm(u0[i], w[i], states[i], alpha=-1, out=u[i])
        torch.mul(states[i], decay[i], out=states[i + 1])
        states[i + 1].baddbmm_(k_out[i], u[i])
    return torch.baddbmm((P @ u).flatten(0, 1), eg.mul_(q).mT.flatten(0, 1), states[:n].flatten(0, 1),
                         alpha=scale).view(n, bh, c, -1)


def kda_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The recurrence's outputs for (b, t, h, d_k) ``q`` and ``k``
    (L2-normalised), (b, t, h, d_v) ``v``, (b, t, h, d_k) log decays ``g``
    and (b, t, h) ``beta``; returns (b, t, h, d_v) f32."""
    b, t = k.shape[:2]
    o = scan_chunks(from_rows(q), from_rows(k), from_rows(v), from_rows(g), from_rows(beta.unsqueeze(-1)))
    return to_rows(o, b, t)
