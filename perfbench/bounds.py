"""The table of peaks and the arithmetic of least times, frozen inside the
benchmark.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.
``k1_bound`` is copied from ``chip_smoke.py::k1_bound`` and
``bert_flops`` from ``chip_smoke.py::encode_split`` / ``forward_weights``
(2 x non-embedding parameters a token, plus 4 * L * h a scored
(query, key) pair), so that a later change to the program cannot move them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

QU = 128  # K1's query slots per chunk (ops/ivf_probe.py's design)
NBK = 64  # K1's lanes per 512 storage rows


def rows64(sizes, lists) -> float:
    """Live rows of ``lists``, in whole 64-row slices."""
    return float((((sizes[lists].double() + 63) // 64) * 64).sum())


def k1_bound(chunk_list, sizes, *, d: int, row_elem: int, unit_elem: int, int8_rows: bool, int8_dot: bool,
             packed: bool, top1: bool = False) -> dict:
    """K1's least time for one launch: the larger of its bytes (each probed
    list's live rows, whole 64-row slices, and their scales read once; the
    live chunks' query tiles; the whole output written) over HBM's rate and
    its operations (2 * 128 * d per live row of every live chunk) over the
    dense tensor-core rate (int8 for the int8 dot, else bf16).  Returns
    seconds, which bound it and the operations."""
    import torch

    live = chunk_list[chunk_list >= 0].long()
    row_bytes = d * row_elem + (4 if int8_rows else 0)
    ncand = NBK if top1 else 2 * NBK
    out_bytes = chunk_list.numel() * QU * ncand * (4 if packed else 8)
    q_bytes = live.numel() * QU * d * unit_elem
    need = rows64(sizes, torch.unique(live)) * row_bytes + q_bytes + out_bytes
    ops = 2.0 * QU * d * rows64(sizes, live)
    t_bytes = need / HBM_BYTES_PER_S
    t_ops = ops / (INT8_OPS_PER_S if int8_dot else BF16_OPS_PER_S)
    return {"s": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations", "ops": ops,
            "live_lists": torch.unique(live)}


def bert_weights_per_token(cfg: dict) -> int:
    """The parameters a BERT token's forward multiplies by: every
    non-embedding one but the pooler (which an embedding model does not run)."""
    h, f, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    per_layer = 4 * (h * h + h) + (h * f + f) + (f * h + h) + 4 * h
    return layers * per_layer


def bert_flops(cfg: dict, real_tokens: float, sum_sq_lens: float) -> float:
    """Model operations of BERT forwards over texts of ``real_tokens`` real
    tokens in all, their lengths' squares summing to ``sum_sq_lens``: 2 x
    weights a token, plus 4 * L * h a scored (query, key) pair, each text
    attending over its own tokens."""
    return (2.0 * bert_weights_per_token(cfg) * real_tokens
            + 4.0 * cfg["num_hidden_layers"] * cfg["hidden_size"] * sum_sq_lens)
