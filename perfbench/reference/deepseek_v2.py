"""A plain DeepSeek-V2 forward in f32 with TF32 off, mean pooling and L2
normalisation, and the seeded weights it shares with the program.

It follows the published remote code (``modeling_deepseek.py`` of
``deepseek-ai/DeepSeek-V2-Lite``): RMSNorm in f32; latent attention with the
rope part de-interleaved (``view(..., d / 2, 2).transpose``) and rotated by
``rotate_half`` at YaRN's frequencies, the one rope key shared by every
head, softmax scale ``(nope + rope)^-0.5 * mscale(factor,
mscale_all_dim)^2``; a dense SwiGLU MLP in the first
``first_k_dense_replace`` layers, then the gate in f32, softmax, greedy
top-k, each routed expert run on its own tokens one expert at a time, the
outputs weighted and summed, plus the shared experts.

Departures, each the same arithmetic: every text runs at its own length,
with no padding and no mask but the causal one, and attention one text at a
time; the per-token parts (projections, norms, MLPs, experts) run over the
tokens of every text at once.  ``transformers``' native
``DeepseekV2Attention`` (4.57) leaves the mscale^2 out of its scale; this
reference keeps the remote code's, which the published model was trained
with.  ``fp8`` rounds every linear layer's inputs and weights per row to
fp8 e4m3, the router and the experts included: the control, one precision
below the configuration's bf16.

Weights (``layer_weights``): per layer, every matrix from one N(0, 0.02)
draw on the device from its own seed, rounded to the served dtype; norm
weights 1.  So any layer can be remade alone, and the judge holds one
layer's f32 weights at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.bert import _fp8
from perfbench.reference.topk import f32_exact

INIT_STD = 0.02


def weight_seed(seed: int, part: int) -> int:
    """The draw of part 0 (the embedding) or layer ``part - 1``."""
    return int(np.random.SeedSequence([seed % (1 << 63), 7, part]).generate_state(1, np.uint64)[0] >> 1)


def is_moe(cfg: dict, i: int) -> bool:
    return (cfg.get("n_routed_experts") is not None and i >= cfg.get("first_k_dense_replace", 0)
            and i % cfg.get("moe_layer_freq", 1) == 0)


def layer_shapes(cfg: dict, i: int) -> dict[str, tuple[int, ...]]:
    """Layer ``i``'s parameters by their checkpoint names under
    ``layers.<i>.`` (``nn.Linear`` weights are (out, in))."""
    if cfg.get("attention_bias") or cfg.get("q_lora_rank") is not None:
        raise NotImplementedError("the reference runs latent attention without biases or a query LoRA")
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    s: dict[str, tuple[int, ...]] = {"input_layernorm.weight": (h,), "post_attention_layernorm.weight": (h,)}
    s["self_attn.q_proj.weight"] = (heads * (nope + rope), h)
    s["self_attn.kv_a_proj_with_mqa.weight"] = (rank + rope, h)
    s["self_attn.kv_a_layernorm.weight"] = (rank,)
    s["self_attn.kv_b_proj.weight"] = (heads * (nope + v), rank)
    s["self_attn.o_proj.weight"] = (h, heads * v)
    if is_moe(cfg, i):
        w = cfg["moe_intermediate_size"]
        s["mlp.gate.weight"] = (cfg["n_routed_experts"], h)
        for e in range(cfg["n_routed_experts"]):
            s[f"mlp.experts.{e}.gate_proj.weight"] = s[f"mlp.experts.{e}.up_proj.weight"] = (w, h)
            s[f"mlp.experts.{e}.down_proj.weight"] = (h, w)
        if cfg.get("n_shared_experts"):
            ws = w * cfg["n_shared_experts"]
            s["mlp.shared_experts.gate_proj.weight"] = s["mlp.shared_experts.up_proj.weight"] = (ws, h)
            s["mlp.shared_experts.down_proj.weight"] = (h, ws)
    else:
        f = cfg["intermediate_size"]
        s["mlp.gate_proj.weight"] = s["mlp.up_proj.weight"] = (f, h)
        s["mlp.down_proj.weight"] = (h, f)
    return s


def _draw(shapes: dict[str, tuple[int, ...]], seed: int, device: torch.device, dtype: torch.dtype
          ) -> dict[str, torch.Tensor]:
    mats = [n for n, s in shapes.items() if len(s) == 2]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = (INIT_STD * torch.randn(sum(math.prod(shapes[n]) for n in mats), generator=g, device=device)).to(dtype)
    out, off = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            out[name] = flat[off : off + math.prod(shape)].view(shape)
            off += math.prod(shape)
        else:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
    return out


def embedding_weights(cfg: dict, seed: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """``embed_tokens.weight`` and the final ``norm.weight``."""
    return _draw({"embed_tokens.weight": (cfg["vocab_size"], cfg["hidden_size"]), "norm.weight": (cfg["hidden_size"],)},
                 weight_seed(seed, 0), device, dtype)


def layer_weights(cfg: dict, seed: int, i: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Layer ``i``'s weights, named as ``layer_shapes`` names them."""
    return _draw(layer_shapes(cfg, i), weight_seed(seed, i + 1), device, dtype)


def model_weights(cfg: dict, seed: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every weight under ``DeepseekV2Model``'s names (small models only)."""
    out = embedding_weights(cfg, seed, device, dtype)
    for i in range(cfg["num_hidden_layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer_weights(cfg, seed, i, device, dtype).items()})
    return out


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_cos_sin(cfg: dict, seq: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The remote code's ``DeepseekV2YarnRotaryEmbedding`` (or the plain
    rotary embedding without ``rope_scaling``): (seq, rope dim) f32 tables of
    ``cat(freqs, freqs)``."""
    dim, base, rs = cfg["qk_rope_head_dim"], cfg.get("rope_theta", 10000.0), cfg.get("rope_scaling")
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    inv_freq, mscale = freq_extra, 1.0
    if rs:
        factor = rs["factor"]
        freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))

        def find_dim(rot: float) -> float:
            return (dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi))) / (2 * math.log(base))

        low = max(math.floor(find_dim(rs.get("beta_fast", 32))), 0)
        high = min(math.ceil(find_dim(rs.get("beta_slow", 1))), dim - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low), 0, 1)
        inv_freq_mask = 1.0 - ramp
        inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
        mscale = yarn_get_mscale(factor, rs.get("mscale", 1)) / yarn_get_mscale(factor, rs.get("mscale_all_dim", 0))
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim", 0):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The remote code's ``apply_rotary_pos_emb`` on (..., s, d): pairs
    de-interleaved, then ``x * cos + rotate_half(x) * sin``."""
    *lead, s, d = x.shape
    x = x.view(*lead, s, d // 2, 2).transpose(-1, -2).reshape(*lead, s, d)
    return x * cos + rotate_half(x) * sin


class PlainDeepseekV2:
    """The forward over texts given as token ids (every id real), weights
    remade from ``seed`` one layer at a time on ``device``."""

    def __init__(self, cfg: dict, seed: int, device: torch.device, dtype: torch.dtype = torch.bfloat16,
                 fp8: bool = False):
        self.cfg, self.seed, self.device, self.dtype, self.fp8 = cfg, seed, device, dtype, fp8

    def _weights(self, raw: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        w = {k: v.float() for k, v in raw.items()}
        if self.fp8:
            w = {k: _fp8(v) if v.ndim == 2 else v for k, v in w.items()}
        return w

    def _linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fp8(x) if self.fp8 else x) @ w.T

    def _rms(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return w * (x * torch.rsqrt(var + self.cfg.get("rms_norm_eps", 1e-6)))

    def _mlp(self, x: torch.Tensor, w: dict[str, torch.Tensor], p: str) -> torch.Tensor:
        gate = self._linear(x, w[p + "gate_proj.weight"])
        return self._linear(F.silu(gate) * self._linear(x, w[p + "up_proj.weight"]), w[p + "down_proj.weight"])

    def attention(self, x: torch.Tensor, w: dict[str, torch.Tensor]) -> torch.Tensor:
        """One text's attention, (s, hidden) -> (s, hidden)."""
        cfg = self.cfg
        s, heads = x.shape[0], cfg["num_attention_heads"]
        nope, rope, vd, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
        q = self._linear(x, w["self_attn.q_proj.weight"]).view(s, heads, nope + rope).transpose(0, 1)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        ckv = self._linear(x, w["self_attn.kv_a_proj_with_mqa.weight"])
        latent, k_pe = ckv[:, :rank], ckv[:, rank:]
        kv = self._linear(self._rms(latent, w["self_attn.kv_a_layernorm.weight"]), w["self_attn.kv_b_proj.weight"])
        kv = kv.view(s, heads, nope + vd).transpose(0, 1)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        cos, sin = rope_cos_sin(cfg, s, x.device)
        q_pe, k_pe = apply_rope(q_pe, cos, sin), apply_rope(k_pe[None], cos, sin)
        query = torch.cat((q_nope, q_pe), dim=-1)
        key = torch.cat((k_nope, k_pe.expand(heads, s, rope)), dim=-1)
        scores = query @ key.transpose(-1, -2) * softmax_scale(cfg)
        scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=x.device).tril(), float("-inf"))
        ctx = torch.softmax(scores, dim=-1) @ v
        return self._linear(ctx.transpose(0, 1).reshape(s, heads * vd), w["self_attn.o_proj.weight"])

    def moe(self, x: torch.Tensor, w: dict[str, torch.Tensor]) -> torch.Tensor:
        """The routed experts, one at a time over their tokens, plus the
        shared experts, (t, hidden) -> (t, hidden)."""
        cfg = self.cfg
        k = cfg["num_experts_per_tok"]
        scores = torch.softmax(self._linear(x, w["mlp.gate.weight"]), dim=-1)
        top_w, top_i = torch.topk(scores, k, dim=-1)
        if cfg.get("norm_topk_prob"):
            top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
        top_w = top_w * cfg.get("routed_scaling_factor", 1.0)
        flat = top_i.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=cfg["n_routed_experts"]).tolist()
        y = torch.zeros_like(x)
        start = 0
        for e, c in enumerate(counts):
            pairs = order[start : start + c]
            start += c
            if c:
                tokens = pairs // k
                out = self._mlp(x[tokens], w, f"mlp.experts.{e}.")
                y.index_add_(0, tokens, out * top_w.reshape(-1)[pairs, None])
        if cfg.get("n_shared_experts"):
            y = y + self._mlp(x, w, "mlp.shared_experts.")
        return y

    def hidden(self, token_ids: list[list[int]]) -> list[torch.Tensor]:
        """Each text's last hidden states (its length, hidden), f32."""
        f32_exact()
        cfg = self.cfg
        lens = [len(t) for t in token_ids]
        with torch.inference_mode():
            emb = self._weights(embedding_weights(cfg, self.seed, self.device, self.dtype))
            ids = torch.tensor([i for t in token_ids for i in t], dtype=torch.int64, device=self.device)
            x = emb["embed_tokens.weight"][ids]
            for i in range(cfg["num_hidden_layers"]):
                w = self._weights(layer_weights(cfg, self.seed, i, self.device, self.dtype))
                normed = self._rms(x, w["input_layernorm.weight"])
                x = x + torch.cat([self.attention(part, w) for part in normed.split(lens)])
                normed = self._rms(x, w["post_attention_layernorm.weight"])
                x = x + (self.moe(normed, w) if is_moe(cfg, i) else self._mlp(normed, w, "mlp."))
                del w
            x = self._rms(x, emb["norm.weight"])
        return list(x.split(lens))

    def embed(self, token_ids: list[list[int]]) -> np.ndarray:
        """Mean-pooled, L2-normalised embeddings (n, hidden) f32."""
        out = torch.stack([h.mean(dim=0) for h in self.hidden(token_ids)])
        out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp(min=1e-12)
        return out.cpu().numpy()
