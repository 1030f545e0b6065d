"""Exact f32 inner-product top-k over rows made chunk by chunk, and the
int4 control's quantized rows."""

from __future__ import annotations

import torch


def f32_exact() -> None:
    """Full f32 products on the card: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class RunningTopK:
    """Exact top-k of ``q`` (m, d) f32 over row chunks added one at a time,
    ``q_block`` queries a product."""

    def __init__(self, q: torch.Tensor, k: int, q_block: int = 256):
        f32_exact()
        self.q, self.k, self.q_block = q, k, q_block
        self.scores = torch.full((q.shape[0], k), float("-inf"), device=q.device)
        self.ids = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)

    def add(self, first: int, rows: torch.Tensor) -> None:
        """Rows ``first ..`` of the corpus."""
        for lo in range(0, self.q.shape[0], self.q_block):
            s = self.q[lo : lo + self.q_block] @ rows.T
            ts, ti = torch.topk(s, min(self.k, rows.shape[0]), dim=1)
            cat_s = torch.cat([self.scores[lo : lo + self.q_block], ts], 1)
            cat_i = torch.cat([self.ids[lo : lo + self.q_block], ti + first], 1)
            top, pos = torch.topk(cat_s, self.k, dim=1)
            self.scores[lo : lo + self.q_block] = top
            self.ids[lo : lo + self.q_block] = torch.gather(cat_i, 1, pos)


def int4_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int4 (levels -7..7) of ``x``, dequantized to f32:
    the control's store, one precision below the configuration's int8."""
    scale = torch.amax(x.abs(), dim=1, keepdim=True).clamp(min=1e-30) / 7.0
    return torch.clamp(torch.round(x / scale), -7, 7) * scale
