"""KDA's recurrence (Kimi Delta Attention: a gated delta rule with a decay
per key channel) in chunks: K6 (``csrc/kda_scan.cu``) and its plain PyTorch
version.

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
diag(exp(G_C)) S + (K * exp(G_C - G))^T U.  ``scan_chunks`` takes its inputs
in chunk tiles with the channels first, (chunks, batch x heads, d, CHUNK),
the layout a causal convolution over channels-first projections slices into
without a transposing copy (``from_channels``); ``kda_scan`` takes (b, t,
heads, d).

On CUDA tensors ``scan_chunks`` launches K6 (d_k = d_v = 128, the
published head size) or raises: a chunk stage, every tile at once (the
pairs, the triangular solve, the chunk's decays), then a state stage that
keeps each sequence's state on chip across its chunks.  K6 forms every
decay between two tokens as a product of the tokens' own decays, each at
most 1, so f32 loses nothing to a difference of long sums (the kernel's
source says how the pairs are split).  On the CPU ``scan_chunks_reference``
runs: one triangular solve a chunk (all chunks at once, as the inverse times
the right-hand sides), then a loop over the chunks of three batched products,
then the outputs in one batched product.

Keeping the exponents bounded in the plain version.  exp(G_r) and exp(G_C -
G_r) are at most 1.  A and P need exp(G_r - G_i) for i <= r, which no single
reference point can split into a row factor and a column factor in f32 once
a channel decays by more than f32's range (about e^88) inside the chunk.  So
``scan_chunks_reference`` splits it in f64 at the chunk's middle row m,
exp(G_r - G_m) exp(G_m - G_i), with each token's log decay floored at -21
(``PAIR_FLOOR``, K6's floor too), so that no factor passes e^672, inside
f64's range (e^709) and above its smallest normal; the same floored sums, in
f64, give every other decay of the chunk.  A floor changes only a decay
below e^-21 = 7.6e-10 into another below it, under f32's resolution of the
terms it is summed with; every other decay is exact.  Every exponent is
finite, so no decay, however strong, gives inf or NaN where the token
recurrence gives none.

Right padding needs nothing: a sequence's pads come after its real tokens
and cannot reach them.  A sequence not a whole number of chunks is padded
at its end, which no real token reaches either, and cut off again.  The state
is f32, every other product runs in f32, and nothing waits for the device.
"""

from __future__ import annotations

import torch

CHUNK = 64  # rows a chunk
PAIR_FLOOR = -21.0  # each token's log decay, floored for the chunk's decays
K6_HEAD_DIM = 128  # d_k and d_v that K6 takes
K6_LAUNCHES = 2  # kernels a ``scan_chunks`` call on the card launches: the chunk stage, the state stage


def from_channels(y: torch.Tensor, t: int, heads: int) -> torch.Tensor:
    """(b, heads x d, t') channels-first (columns past ``t`` unread) ->
    contiguous (chunks, b x heads, d, CHUNK) f32, zero past ``t``: always
    a copy, whatever ``y``'s type, as K6 reads the tiles in that layout."""
    b, c = y.shape[:2]
    n = -(-t // CHUNK)
    y = y[..., :t]
    if n * CHUNK != t:
        y = torch.nn.functional.pad(y, (0, n * CHUNK - t))
    y = y.unflatten(-1, (n, CHUNK)).unflatten(1, (heads, c // heads)).permute(3, 0, 1, 2, 4)
    return y.to(torch.float32, memory_format=torch.contiguous_format, copy=True).flatten(1, 2)


def from_rows(x: torch.Tensor) -> torch.Tensor:
    """(b, t, heads, d) -> (chunks, b x heads, d, CHUNK) f32, zero past t."""
    b, t, h, d = x.shape
    return from_channels(x.permute(0, 2, 3, 1).reshape(b, h * d, t), t, h)


def to_rows(o: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """(chunks, b x heads, CHUNK, d) -> (b, t, heads, d)."""
    n, bh, c, d = o.shape
    return o.view(n, b, bh // b, c, d).permute(1, 0, 3, 2, 4).reshape(b, n * c, bh // b, d)[:, :t]


def scan_chunks_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of K6, any head size: the recurrence over chunk
    tiles, ``q``, ``k`` (L2-normalised), ``v`` and the log decays ``g``
    (chunks, B, d, CHUNK) f32, ``beta`` (chunks, B, 1, CHUNK); returns the
    outputs (chunks, B, CHUNK, d_v) f32."""
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


def check_k6_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor
                  ) -> tuple[int, int]:
    """What K6 takes, checked before a launch: ``q``, ``k``, ``v`` and ``g``
    contiguous (chunks, B, 128, CHUNK) f32 tiles and ``beta`` a contiguous
    (chunks, B, 1, CHUNK) f32 tile, all on ``k``'s device and 16-byte
    aligned.  Returns (chunks, B); raises ValueError otherwise."""
    if k.ndim != 4:
        raise ValueError(f"scan_chunks: k must be (chunks, B, d_k, {CHUNK}) tiles, not {tuple(k.shape)}")
    n, bh = k.shape[:2]
    tile = (n, bh, K6_HEAD_DIM, CHUNK)
    for name, x, shape in (("q", q, tile), ("k", k, tile), ("v", v, tile), ("g", g, tile),
                           ("beta", beta, (n, bh, 1, CHUNK))):
        if x.dtype != torch.float32 or x.device != k.device:
            raise ValueError(f"scan_chunks: {name} must be f32 on {k.device}, not {x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"scan_chunks: K6 takes {name} as {shape} (d_k = d_v = {K6_HEAD_DIM}, "
                             f"chunks of {CHUNK}), not {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"scan_chunks: {name} must be contiguous and 16-byte aligned")
    return n, bh


def scan_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor
                ) -> torch.Tensor:
    """K6's wrapper, the recurrence over chunk tiles: ``q``, ``k``
    (L2-normalised), ``v`` and the log decays ``g`` (chunks, B, d, CHUNK)
    f32, ``beta`` (chunks, B, 1, CHUNK); returns the outputs (chunks, B,
    CHUNK, d_v) f32.  On CUDA tensors it launches K6 (``check_k6_args``
    says what it takes) or raises; only tensors on the CPU take
    ``scan_chunks_reference``.  K6 has no backward, so with grad enabled it
    refuses an input that requires grad rather than drop its gradient."""
    if not k.is_cuda:
        return scan_chunks_reference(q, k, v, g, beta)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, g, beta)):
        raise ValueError("scan_chunks: K6 has no backward; run the forward under torch.no_grad or inference_mode")
    n, bh = check_k6_args(q, k, v, g, beta)
    out = torch.empty((n, bh, CHUNK, K6_HEAD_DIM), dtype=torch.float32, device=k.device)
    if n * bh == 0:
        return out
    from lotus_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    workspace = torch.empty(lib.lotus_kda_scan_workspace(n * bh), dtype=torch.uint8, device=k.device)
    code = lib.lotus_kda_scan(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), beta.data_ptr(),
                              workspace.data_ptr(), out.data_ptr(), n, bh,
                              torch.cuda.current_stream(k.device).cuda_stream)
    _kernels.check(code, "kda scan launch")
    scan_chunks.launches += K6_LAUNCHES
    return out


scan_chunks.launches = 0  # K6's kernel launches in this process (K6_LAUNCHES a KDA layer call on the card)


def kda_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The recurrence's outputs for (b, t, h, d_k) ``q`` and ``k``
    (L2-normalised), (b, t, h, d_v) ``v``, (b, t, h, d_k) log decays ``g``
    and (b, t, h) ``beta``; returns (b, t, h, d_v) f32."""
    b, t = k.shape[:2]
    o = scan_chunks(from_rows(q), from_rows(k), from_rows(v), from_rows(g), from_rows(beta.unsqueeze(-1)))
    return to_rows(o, b, t)
