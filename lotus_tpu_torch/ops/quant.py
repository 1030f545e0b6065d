"""Symmetric int8 quantization for the vector store (``lotus_tpu/ops/quant.py:15-69``).

Per-row symmetric quantization: x_q = round(x * 127 / max|x_row|), rounding
half to even like ``jnp.round`` and ``np.rint``, so both packages quantize
bit for bit alike.  Inner products factor exactly:
q . x = (qscale * rowscale) * (q_q . x_q).
"""

from __future__ import annotations

import torch


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: returns (values int8, scales f32).

    ``scales`` are the dequantization factors: x ~ values * scales[:, None].
    Zero rows get scale 0 (and quantize to zeros).
    """
    x32 = x.float()
    absmax = torch.amax(torch.abs(x32), dim=-1)
    scale = absmax / 127.0
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)), torch.zeros_like(scale))
    q = torch.clamp(torch.round(x32 * inv[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_refinement_int4(resid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int4 of a quantization residual, nibble-packed.

    Returns (packed (n, d//2) int8 with even dims in the low nibble, scales f32).
    """
    r32 = resid.float()
    absmax = torch.amax(torch.abs(r32), dim=-1)
    scale = absmax / 7.0
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)), torch.zeros_like(scale))
    q = torch.clamp(torch.round(r32 * inv[:, None]), -7, 7).to(torch.int8)
    lo = q[:, 0::2] & 0xF
    hi = q[:, 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., d//2) nibble-packed int4 -> (..., d) int8 values in [-8, 7]."""
    u = packed.view(torch.uint8)
    lo = (u & 0xF).to(torch.int8)
    hi = ((u >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def exact_int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, d) int8 x (N, d) int8 -> (B, N) exact integer dot products, as float.

    CUDA has no integer matmul in plain torch, so the product runs in f32
    when every partial sum stays below 2**24 (|a.b| <= 127**2 * d, so
    d < 1040) and is therefore exact in any order; wider rows use f64.
    """
    ft = torch.float32 if 127 * 127 * a.shape[-1] < (1 << 24) else torch.float64
    return a.to(ft) @ b.to(ft).T


def int8_scores(
    xq_q: torch.Tensor, q_scale: torch.Tensor, xb_q: torch.Tensor, b_scale: torch.Tensor
) -> torch.Tensor:
    """(B, d) int8 x (N, d) int8 -> (B, N) f32 inner products."""
    acc = exact_int8_dot(xq_q, xb_q).float()
    return acc * q_scale[:, None] * b_scale[None, :]
