"""The arithmetic of Kimi-Linear's operations and of its KDA recurrence's
least time, frozen inside the benchmark (peaks from ``bounds.py``).

A token's forward multiplies by every non-routed parameter it reaches:
each KDA layer's projections (q, k, v, the decay's and the gate's two each,
beta, the output) and norms, each latent attention layer's (without a query
LoRA), the dense MLP of the leading layer, and in each MoE layer the gate,
the shared expert and ``num_experts_per_token`` x ``num_experts`` /
``router_experts`` routed experts (the held share of its pairs);
``lm_head`` is not run.  A scored causal (query, key) pair of latent
attention costs ``bounds_moe.pair_flops`` a layer.  A (token, head) of the
KDA recurrence costs ``recurrence_flops``: the decay of the state (d_k d_v),
S^T k, the rank-1 write and S^T q (2 d_k d_v each); its convolutions
(2 x taps a channel) are counted with the weights' operations.
"""

from __future__ import annotations

from perfbench import bounds, bounds_moe


def kda_layers(cfg: dict) -> int:
    return len(cfg["linear_attn_config"]["kda_layers"])


def mla_layers(cfg: dict) -> int:
    return len(cfg["linear_attn_config"]["full_attn_layers"])


def weights_per_token(cfg: dict) -> float:
    """The parameters one token's forward multiplies by, the routed experts
    counted at the held share of a token's pairs."""
    h = cfg["hidden_size"]
    lac = cfg["linear_attn_config"]
    heads, d, taps = lac["num_heads"], lac["head_dim"], lac["short_conv_kernel_size"]
    width = heads * d
    kda = 4 * h * width + 2 * (h * d + d * width) + h * heads + 3 * width * taps + d + 2 * h
    mh, nope, rope, v, rank = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                               cfg["v_head_dim"], cfg["kv_lora_rank"])
    mla = h * mh * (nope + rope) + h * (rank + rope) + rank + rank * mh * (nope + v) + mh * v * h + 2 * h
    router = cfg.get("router_experts", cfg["num_experts"])
    routed = cfg["num_experts_per_token"] * cfg["num_experts"] / router
    moe = router * h + (routed + cfg["num_shared_experts"]) * bounds_moe.expert_params(cfg)
    dense = 3 * h * cfg["intermediate_size"]
    first = cfg.get("first_k_dense_replace", 0)
    layers = cfg["num_hidden_layers"]
    return h + kda_layers(cfg) * kda + mla_layers(cfg) * mla + first * dense + (layers - first) * moe


def recurrence_flops(cfg: dict) -> int:
    """Operations of the recurrence for one (token, head)."""
    d = cfg["linear_attn_config"]["head_dim"]
    return 7 * d * d


def kimi_flops(cfg: dict, real_tokens: float, causal_pairs: float) -> float:
    """Model operations of forwards over texts of ``real_tokens`` real
    tokens in all and ``causal_pairs`` scored (query, key) pairs (n (n + 1)
    / 2 a text of n tokens)."""
    heads = cfg["linear_attn_config"]["num_heads"]
    return (2.0 * weights_per_token(cfg) * real_tokens
            + bounds_moe.pair_flops(cfg) * mla_layers(cfg) * causal_pairs
            + recurrence_flops(cfg) * heads * kda_layers(cfg) * real_tokens)


def scan_least_s(cfg: dict, pairs: float) -> dict:
    """The recurrence's least time over ``pairs`` (token, head) pairs,
    whatever implements it: the larger of its bytes (q, k, v and o in bf16,
    g in f32 and beta in f32, each once) at HBM's rate and its operations
    at the bf16 peak."""
    d = cfg["linear_attn_config"]["head_dim"]
    nbytes = (4 * 2 * d + 4 * d + 4) * pairs
    ops = recurrence_flops(cfg) * pairs
    t_ops, t_bytes = ops / bounds.BF16_OPS_PER_S, nbytes / bounds.HBM_BYTES_PER_S
    return {"s": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes", "ops": ops,
            "bytes": nbytes}
