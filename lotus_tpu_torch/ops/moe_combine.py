"""The MoE layer's combine: K4 (``csrc/moe_combine.cu``) and its plain
PyTorch version.

After the routed experts' second grouped GEMM, each token's ``k`` expert
rows lie in the pairs' order sorted by expert.  The combine gathers them
back through ``inv`` (each pair's place in that order), weights them by the
routing weights and sums them in f32, adds the shared experts' row and
rounds once to the rows' type.  Only the held pairs' rows are read: a
layer that holds some of the experts leaves the rows past the held count
unwritten.
"""

from __future__ import annotations

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def moe_combine_reference(
    out: torch.Tensor,
    inv: torch.Tensor,
    weights: torch.Tensor,
    offsets: torch.Tensor,
    shared: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K4, with its arithmetic: for each slot j =
    0..k-1 in turn, the f32 sum gets the weight times the slot's row (held
    rows only), then the shared row, then one cast to ``out``'s type."""
    t, k = weights.shape
    held = inv.view(t, k) < offsets[-1]
    acc = torch.zeros((t, out.shape[1]), dtype=torch.float32, device=out.device)
    for j in range(k):
        rows = torch.where(held[:, j, None], out[inv.view(t, k)[:, j]].float(), 0.0)
        acc = acc + weights[:, j, None] * rows
    if shared is not None:
        acc = acc + shared.float()
    return acc.to(out.dtype)


def moe_combine(
    out: torch.Tensor,
    inv: torch.Tensor,
    weights: torch.Tensor,
    offsets: torch.Tensor,
    shared: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4's wrapper: (t, hidden) in ``out``'s type.  On CUDA tensors it
    launches the kernel (or raises); only tensors on the CPU take
    ``moe_combine_reference``.  K4 has no backward, so with grad enabled it
    refuses an input that requires grad rather than drop its gradient.

    ``out``: (t * k, hidden) f32, bf16 or f16 rows in the sorted pair order,
    16-byte aligned, each row a whole number of 16-byte vectors (the kernel
    reads nothing narrower); ``inv``: (t * k,) int64, pair u * k + j's row
    of ``out``;
    ``weights``: (t, k) f32; ``offsets``: the held experts' int32 end
    offsets, whose last is the held rows' count (read on the card);
    ``shared``: (t, hidden) of ``out``'s type, or None.
    """
    if not out.is_cuda:
        return moe_combine_reference(out, inv, weights, offsets, shared)
    from lotus_tpu_torch.ops import _kernels

    dev = out.device
    t, k = weights.shape
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (out, weights, shared)):
        raise ValueError("moe_combine: K4 has no backward; run the forward under torch.no_grad or inference_mode")
    if out.dtype not in _DTYPE_CODE or out.ndim != 2 or out.shape[0] != t * k or not out.is_contiguous():
        raise ValueError(f"moe_combine: out must be a contiguous ({t * k}, hidden) f32, bf16 or f16 tensor")
    hidden = out.shape[1]
    checks = (
        ("inv", inv, torch.int64, (t * k,)),
        ("weights", weights, torch.float32, (t, k)),
        ("offsets", offsets, torch.int32, (offsets.numel(),)),
        ("shared", shared, out.dtype, (t, hidden)),
    )
    for name, x, dtype, shape in checks:
        if x is not None and (x.device != dev or x.dtype != dtype or x.shape != shape or not x.is_contiguous()):
            raise ValueError(f"moe_combine: {name} must be a contiguous {shape} {dtype} tensor on {dev}")
    if offsets.numel() == 0:
        raise ValueError("moe_combine: offsets is empty (the layer holds no expert)")
    vec = 16 // out.element_size()
    if hidden % vec or out.data_ptr() % 16 or (shared is not None and shared.data_ptr() % 16):
        raise ValueError(f"moe_combine: rows must be 16-byte aligned and hold a multiple of {vec} {out.dtype} values")
    y = torch.empty((t, hidden), dtype=out.dtype, device=dev)
    code = _kernels.lib().lotus_moe_combine(
        out.data_ptr(), inv.data_ptr(), weights.data_ptr(), offsets[-1:].data_ptr(),
        None if shared is None else shared.data_ptr(), y.data_ptr(), t, k, hidden, _DTYPE_CODE[out.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(code, "moe_combine launch")
    moe_combine.launches += 1
    return y


moe_combine.launches = 0  # K4 launches in this process (one an MoE layer call on the card)
