"""A plain Kimi-Linear forward in f32 with TF32 off, mean pooling and L2
normalisation, and the seeded weights it shares with the program.

It follows the published description (``modeling_kimi.py`` of
``moonshotai/Kimi-Linear-48B-A3B-Instruct``; its KDA layer is ``fla``'s
``KimiDeltaAttention``), for token t and head h:

- KDA: q, k, v = ``q_proj`` / ``k_proj`` / ``v_proj`` of x, each through its
  depthwise causal convolution of 4 taps (no bias), then SiLU; q and k
  divided by sqrt(sum x^2 + 1e-6); decay g_t = -exp(A_log[h]) *
  softplus(f_b_proj(f_a_proj(x_t)) + dt_bias), one per key channel;
  beta_t = sigmoid(b_proj(x_t)); from S_0 = 0, token by token,
  S_t = diag(exp(g_t)) S_{t-1}, S_t += beta_t k_t (v_t - S_t^T k_t)^T,
  o_t = S_t^T q_t / sqrt(d_k); the output RMSNorm per head times
  sigmoid(g_b_proj(g_a_proj(x_t))), then ``o_proj``;
- latent attention without positions (``mla_use_nope``): DeepSeek-V2's
  projections, the 64-wide shared key part concatenated unrotated, causal
  softmax at (nope + rope)^-0.5;
- the dense SwiGLU MLP of the first layer; then the router: sigmoid of the
  f32 logits, the experts chosen by top-k of the scores plus
  ``e_score_correction_bias`` (one group, as ``transformers``'
  ``DeepseekV3TopkRouter`` with ``n_group`` 1), the chosen experts'
  uncorrected scores renormalised (+1e-20) and times
  ``routed_scaling_factor``; each routed expert run on its own tokens one
  expert at a time, plus the shared expert.

Departures, each the same arithmetic: every text runs at its own length,
with no padding; KDA runs all texts as one batch, a text's state held past
its end (no decay, no write), and the convolutions as sums of shifted rows;
latent attention runs one text at a time in blocks of query rows; the
per-token parts run over the tokens of every text at once.  Only the held
experts (``num_experts``, the chip's share of ``router_experts``) have
weights: pairs routed to the others add nothing, as on one chip of the
expert-parallel deployment.  ``fp8`` rounds every linear layer's inputs and
weights per row to fp8 e4m3 (the KDA projections, the router and the experts
included; the recurrence and the convolutions stay f32): the control, one
precision below the configuration's bf16.

Weights (``layer_weights``): per layer, every matrix from one N(0, 0.02)
draw (``deepseek_v2._draw``), norm weights 1; from a second draw of the
layer's own seed: the convolution taps U(-0.5, 0.5) (``nn.Conv1d``'s
default for 4 taps), ``A_log`` = log U(1, 16), ``dt_bias`` the inverse
softplus of dt drawn log-uniform in [0.001, 0.1] (``fla``'s
initialisation), ``e_score_correction_bias`` N(0, 0.05); each rounded to
the served dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import deepseek_v2 as dsv2
from perfbench.reference.topk import f32_exact

L2_EPS = 1e-6
QUERY_BLOCK = 1024  # query rows a block of latent attention
BIAS_STD = 0.05


def is_kda(cfg: dict, i: int) -> bool:
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg.get("first_k_dense_replace", 0) and i % cfg.get("moe_layer_freq", 1) == 0


def router_experts(cfg: dict) -> int:
    """The router's outputs: ``router_experts``, or every expert."""
    return cfg.get("router_experts", cfg["num_experts"])


def layer_shapes(cfg: dict, i: int) -> tuple[dict[str, tuple[int, ...]], dict[str, tuple[int, ...]]]:
    """Layer ``i``'s parameters by their checkpoint names under
    ``layers.<i>.``: (the matrices and norms of the normal draw, the
    parameters of the second draw)."""
    h = cfg["hidden_size"]
    s: dict[str, tuple[int, ...]] = {"input_layernorm.weight": (h,), "post_attention_layernorm.weight": (h,)}
    extra: dict[str, tuple[int, ...]] = {}
    if is_kda(cfg, i):
        lac = cfg["linear_attn_config"]
        heads, d, taps = lac["num_heads"], lac["head_dim"], lac["short_conv_kernel_size"]
        for p in "qkv":
            s[f"self_attn.{p}_proj.weight"] = (heads * d, h)
            extra[f"self_attn.{p}_conv1d.weight"] = (heads * d, 1, taps)
        s["self_attn.f_a_proj.weight"] = s["self_attn.g_a_proj.weight"] = (d, h)
        s["self_attn.f_b_proj.weight"] = s["self_attn.g_b_proj.weight"] = (heads * d, d)
        s["self_attn.b_proj.weight"] = (heads, h)
        s["self_attn.o_norm.weight"] = (d,)
        s["self_attn.o_proj.weight"] = (h, heads * d)
        extra["self_attn.A_log"] = (heads,)
        extra["self_attn.dt_bias"] = (heads * d,)
    else:
        heads = cfg["num_attention_heads"]
        nope, rope, v, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
        s["self_attn.q_proj.weight"] = (heads * (nope + rope), h)
        s["self_attn.kv_a_proj_with_mqa.weight"] = (rank + rope, h)
        s["self_attn.kv_a_layernorm.weight"] = (rank,)
        s["self_attn.kv_b_proj.weight"] = (heads * (nope + v), rank)
        s["self_attn.o_proj.weight"] = (h, heads * v)
    if is_moe(cfg, i):
        w = cfg["moe_intermediate_size"]
        s["mlp.gate.weight"] = (router_experts(cfg), h)
        extra["mlp.gate.e_score_correction_bias"] = (router_experts(cfg),)
        for e in range(cfg["num_experts"]):
            s[f"mlp.experts.{e}.gate_proj.weight"] = s[f"mlp.experts.{e}.up_proj.weight"] = (w, h)
            s[f"mlp.experts.{e}.down_proj.weight"] = (h, w)
        ws = w * cfg["num_shared_experts"]
        s["mlp.shared_experts.gate_proj.weight"] = s["mlp.shared_experts.up_proj.weight"] = (ws, h)
        s["mlp.shared_experts.down_proj.weight"] = (h, ws)
    else:
        f = cfg["intermediate_size"]
        s["mlp.gate_proj.weight"] = s["mlp.up_proj.weight"] = (f, h)
        s["mlp.down_proj.weight"] = (h, f)
    return s, extra


def _second_draw(shapes: dict[str, tuple[int, ...]], seed: int, device: torch.device, dtype: torch.dtype
                 ) -> dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        u = torch.rand(shape, generator=g, device=device)
        if name.endswith("conv1d.weight"):
            x = u - 0.5
        elif name.endswith("A_log"):
            x = torch.log(1 + 15 * u)
        elif name.endswith("dt_bias"):
            dt = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3)) * u)
            x = dt + torch.log(-torch.expm1(-dt))
        else:
            x = BIAS_STD * torch.randn(shape, generator=g, device=device)
        out[name] = x.to(dtype)
    return out


def layer_weights(cfg: dict, seed: int, i: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Layer ``i``'s weights, named as ``layer_shapes`` names them."""
    shapes, extra = layer_shapes(cfg, i)
    part = dsv2.weight_seed(seed, i + 1)
    return {**dsv2._draw(shapes, part, device, dtype), **_second_draw(extra, part ^ 1, device, dtype)}


def model_weights(cfg: dict, seed: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every weight under ``KimiLinearModel``'s names (small models only)."""
    out = dsv2.embedding_weights(cfg, seed, device, dtype)
    for i in range(cfg["num_hidden_layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer_weights(cfg, seed, i, device, dtype).items()})
    return out


def kda_recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor
                   ) -> torch.Tensor:
    """The recurrence token by token for (n, t, h, d_k) ``q``, ``k``, ``g``,
    (n, t, h, d_v) ``v`` and (n, t, h) ``beta``, from a zero f32 state:
    (n, t, h, d_v) f32."""
    n, t, h, dk = k.shape
    dv = v.shape[-1]
    q, k, v, g, beta = (x.float() for x in (q, k, v, g, beta))
    q = q * dk**-0.5
    state = torch.zeros(n * h, dk, dv, dtype=torch.float32, device=k.device)
    out = torch.empty(n, t, h, dv, dtype=torch.float32, device=k.device)
    for i in range(t):
        k_i = k[:, i].reshape(n * h, 1, dk)
        state = state * torch.exp(g[:, i]).reshape(n * h, dk, 1)
        delta = (v[:, i].reshape(n * h, 1, dv) - k_i @ state) * beta[:, i].reshape(n * h, 1, 1)
        state = state + k_i.mT @ delta
        out[:, i] = (q[:, i].reshape(n * h, 1, dk) @ state).view(n, h, dv)
    return out


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, t, c) ``x`` by (c, 1, taps) ``w``: out[t] = sum_j w[:, j] x[t - taps + 1 + j],
    zero before each row's start."""
    taps, t = w.shape[-1], x.shape[1]
    padded = F.pad(x, (0, 0, taps - 1, 0))
    return sum(w[:, 0, j] * padded[:, j : j + t] for j in range(taps))


class PlainKimiLinear(dsv2.PlainDeepseekV2):
    """The forward over texts given as token ids (every id real), weights
    remade from ``seed`` one layer at a time on ``device``."""

    def _pad(self, x: torch.Tensor, lens: list[int]) -> torch.Tensor:
        """(tokens, c) of every text in turn -> (texts, longest, c), zeros after each text."""
        out = x.new_zeros((len(lens), max(lens), x.shape[-1]))
        for r, part in enumerate(x.split(lens)):
            out[r, : len(part)] = part
        return out

    def kda(self, x: torch.Tensor, w: dict[str, torch.Tensor], lens: list[int]) -> torch.Tensor:
        """Every text's KDA layer at once, (tokens, hidden) -> (tokens, hidden)."""
        lac = self.cfg["linear_attn_config"]
        h, d = lac["num_heads"], lac["head_dim"]
        n, t = len(lens), max(lens)
        p = "self_attn."

        def branch(name: str) -> torch.Tensor:
            y = self._pad(self._linear(x, w[f"{p}{name}_proj.weight"]), lens)
            y = causal_conv(y, w[f"{p}{name}_conv1d.weight"])
            return F.silu(y).view(n, t, h, d)

        def l2(y: torch.Tensor) -> torch.Tensor:
            return y / torch.sqrt(y.pow(2).sum(-1, keepdim=True) + L2_EPS)

        q, k, v = l2(branch("q")), l2(branch("k")), branch("v")
        f = self._linear(self._linear(x, w[p + "f_a_proj.weight"]), w[p + "f_b_proj.weight"]) + w[p + "dt_bias"]
        g = -torch.exp(w[p + "A_log"]).view(h, 1) * F.softplus(f.view(-1, h, d))
        # no decay and no write past a text's end: its state is held
        g = self._pad(g.flatten(1), lens).view(n, t, h, d)
        beta = self._pad(torch.sigmoid(self._linear(x, w[p + "b_proj.weight"])), lens)
        o = kda_recurrence(q, k, v, g, beta)
        o = torch.cat([o[r, :m] for r, m in enumerate(lens)]).view(-1, h, d)
        eps = self.cfg.get("rms_norm_eps", 1e-6)
        o = o / torch.sqrt(o.pow(2).mean(-1, keepdim=True) + eps) * w[p + "o_norm.weight"]
        gate = self._linear(self._linear(x, w[p + "g_a_proj.weight"]), w[p + "g_b_proj.weight"])
        o = o * torch.sigmoid(gate).view(-1, h, d)
        return self._linear(o.reshape(-1, h * d), w[p + "o_proj.weight"])

    def attention(self, x: torch.Tensor, w: dict[str, torch.Tensor]) -> torch.Tensor:
        """One text's latent attention without positions, (s, hidden) -> (s, hidden)."""
        cfg = self.cfg
        s, heads = x.shape[0], cfg["num_attention_heads"]
        nope, rope, vd, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
        query = self._linear(x, w["self_attn.q_proj.weight"]).view(s, heads, nope + rope).transpose(0, 1)
        ckv = self._linear(x, w["self_attn.kv_a_proj_with_mqa.weight"])
        latent, k_pe = ckv[:, :rank], ckv[:, rank:]
        kv = self._linear(self._rms(latent, w["self_attn.kv_a_layernorm.weight"]), w["self_attn.kv_b_proj.weight"])
        kv = kv.view(s, heads, nope + vd).transpose(0, 1)
        key = torch.cat((kv[..., :nope], k_pe[None].expand(heads, s, rope)), dim=-1)
        value = kv[..., nope:]
        scale = (nope + rope) ** -0.5
        ctx = torch.empty(heads, s, vd, dtype=x.dtype, device=x.device)
        for lo in range(0, s, QUERY_BLOCK):
            hi = min(lo + QUERY_BLOCK, s)
            scores = query[:, lo:hi] @ key[:, :hi].transpose(-1, -2) * scale
            allowed = torch.arange(hi, device=x.device)[None] <= torch.arange(lo, hi, device=x.device)[:, None]
            scores = scores.masked_fill(~allowed, float("-inf"))
            ctx[:, lo:hi] = torch.softmax(scores, dim=-1) @ value[:, :hi]
        return self._linear(ctx.transpose(0, 1).reshape(s, heads * vd), w["self_attn.o_proj.weight"])

    def route(self, x: torch.Tensor, w: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """The sigmoid router: each token's (t, k) chosen experts and their weights."""
        cfg = self.cfg
        scores = torch.sigmoid(self._linear(x, w["mlp.gate.weight"]))
        top_i = torch.topk(scores + w["mlp.gate.e_score_correction_bias"], cfg["num_experts_per_token"], dim=-1).indices
        top_w = scores.gather(1, top_i)
        if cfg.get("moe_renormalize"):
            top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
        return top_i, top_w * cfg.get("routed_scaling_factor", 1.0)

    def moe(self, x: torch.Tensor, w: dict[str, torch.Tensor]) -> torch.Tensor:
        """The router, the held routed experts one at a time over their
        tokens, plus the shared expert, (t, hidden) -> (t, hidden)."""
        k = self.cfg["num_experts_per_token"]
        top_i, top_w = self.route(x, w)
        y = torch.zeros_like(x)
        flat = top_i.reshape(-1)
        for e in range(self.cfg["num_experts"]):
            pairs = torch.nonzero(flat == e).flatten()
            if len(pairs):
                tokens = pairs // k
                y.index_add_(0, tokens, self._mlp(x[tokens], w, f"mlp.experts.{e}.") * top_w.reshape(-1)[pairs, None])
        return y + self._mlp(x, w, "mlp.shared_experts.")

    def hidden(self, token_ids: list[list[int]]) -> list[torch.Tensor]:
        """Each text's last hidden states (its length, hidden), f32."""
        f32_exact()
        cfg = self.cfg
        lens = [len(t) for t in token_ids]
        with torch.inference_mode():
            emb = self._weights(dsv2.embedding_weights(cfg, self.seed, self.device, self.dtype))
            ids = torch.tensor([i for t in token_ids for i in t], dtype=torch.int64, device=self.device)
            x = emb["embed_tokens.weight"][ids]
            for i in range(cfg["num_hidden_layers"]):
                w = self._weights(layer_weights(cfg, self.seed, i, self.device, self.dtype))
                normed = self._rms(x, w["input_layernorm.weight"])
                if is_kda(cfg, i):
                    x = x + self.kda(normed, w, lens)
                else:
                    x = x + torch.cat([self.attention(part, w) for part in normed.split(lens)])
                normed = self._rms(x, w["post_attention_layernorm.weight"])
                x = x + (self.moe(normed, w) if is_moe(cfg, i) else self._mlp(normed, w, "mlp."))
                del w
            x = self._rms(x, emb["norm.weight"])
        return list(x.split(lens))

