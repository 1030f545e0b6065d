"""A plain BERT encoder with mean pooling and L2 normalisation, in f32 with
TF32 off, over texts grouped by their exact token count (so no padding and
no mask), and the same forward with every linear layer's inputs and weights
rounded to fp8 (e4m3, each row scaled to its largest value, per token and
per output row): the control, one precision below the configuration's
bf16.  (Rounded to int8 the same way, the control's gaps came within 3x of
bf16's: see PERF.md.)"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.topk import f32_exact


FP8_MAX = 448.0  # float8_e4m3fn's largest value


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """fp8 e4m3 along the last axis, each row scaled to its largest value,
    dequantized to f32."""
    scale = torch.amax(x.abs(), dim=-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class PlainBert:
    def __init__(self, cfg: dict, weights: dict[str, torch.Tensor], device: torch.device, fp8: bool = False):
        self.cfg, self.fp8 = cfg, fp8
        self.w = {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}
        if fp8:
            self.w = {k: (_fp8(v) if v.ndim == 2 and k.startswith("encoder.") else v) for k, v in self.w.items()}
        self.device = device

    def _linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.fp8:
            x = _fp8(x)
        return x @ self.w[name + ".weight"].T + self.w[name + ".bias"]

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".weight"], self.w[name + ".bias"],
                            eps=self.cfg["layer_norm_eps"])

    def hidden(self, ids: torch.Tensor) -> torch.Tensor:
        """Last hidden states of (b, s) ids, every token real."""
        b, s = ids.shape
        w, heads = self.w, self.cfg["num_attention_heads"]
        x = (w["embeddings.word_embeddings.weight"][ids] + w["embeddings.token_type_embeddings.weight"][0]
             + w["embeddings.position_embeddings.weight"][:s])
        x = self._ln(x, "embeddings.LayerNorm")
        h = x.shape[-1]
        for i in range(self.cfg["num_hidden_layers"]):
            p = f"encoder.layer.{i}."
            q, k, v = (self._linear(x, p + "attention.self." + n).view(b, s, heads, h // heads).transpose(1, 2)
                       for n in ("query", "key", "value"))
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(h // heads), dim=-1)
            ctx = (att @ v).transpose(1, 2).reshape(b, s, h)
            x = self._ln(self._linear(ctx, p + "attention.output.dense") + x, p + "attention.output.LayerNorm")
            inner = F.gelu(self._linear(x, p + "intermediate.dense"))
            x = self._ln(self._linear(inner, p + "output.dense") + x, p + "output.LayerNorm")
        return x

    def embed(self, token_ids: list[list[int]], max_rows: int = 512) -> np.ndarray:
        """Mean-pooled, L2-normalised embeddings (n, h) f32 of texts given
        as token ids, in blocks of equal length."""
        f32_exact()
        out = np.zeros((len(token_ids), self.cfg["hidden_size"]), np.float32)
        by_len: dict[int, list[int]] = {}
        for i, t in enumerate(token_ids):
            by_len.setdefault(len(t), []).append(i)
        with torch.inference_mode():
            for length, rows in sorted(by_len.items()):
                step = max(1, min(max_rows, (1 << 16) // length))
                for lo in range(0, len(rows), step):
                    part = rows[lo : lo + step]
                    ids = torch.tensor([token_ids[r] for r in part], dtype=torch.int64, device=self.device)
                    e = self.hidden(ids).mean(dim=1)
                    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp(min=1e-12)
                    out[part] = e.cpu().numpy()
        return out
