"""The arithmetic of DeepSeek-V2's operations and of its routed experts'
least time, frozen inside the benchmark (peaks from ``bounds.py``).

A token's forward multiplies by every non-embedding parameter it reaches:
each layer's latent attention (without a query LoRA) and norms, the dense
MLP of the leading layers, and in each MoE layer the gate,
``num_experts_per_tok`` routed experts and the shared experts (``lm_head``
is not run).  A scored causal
(query, key) pair costs 2 x (nope + rope) x heads for the score and 2 x v x
heads for the value, a layer.
"""

from __future__ import annotations

from perfbench import bounds


def _moe(cfg: dict, i: int) -> bool:
    return (cfg.get("n_routed_experts") is not None and i >= cfg.get("first_k_dense_replace", 0)
            and i % cfg.get("moe_layer_freq", 1) == 0)


def expert_params(cfg: dict) -> int:
    """One routed expert's SwiGLU weights."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def weights_per_token(cfg: dict) -> int:
    """The parameters one token's forward multiplies by."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    attn = h * heads * (nope + rope) + h * (rank + rope) + rank + rank * heads * (nope + v) + heads * v * h + 2 * h
    total = h  # the final norm
    for i in range(cfg["num_hidden_layers"]):
        if _moe(cfg, i):
            mlp = (cfg["n_routed_experts"] * h + cfg["num_experts_per_tok"] * expert_params(cfg)
                   + (cfg.get("n_shared_experts") or 0) * expert_params(cfg))
        else:
            mlp = 3 * h * cfg["intermediate_size"]
        total += attn + mlp
    return total


def pair_flops(cfg: dict) -> int:
    """Operations of one scored causal (query, key) pair in one layer."""
    heads = cfg["num_attention_heads"]
    return 2 * heads * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) + 2 * heads * cfg["v_head_dim"]


def dsv2_flops(cfg: dict, real_tokens: float, causal_pairs: float) -> float:
    """Model operations of forwards over texts of ``real_tokens`` real tokens
    in all and ``causal_pairs`` scored (query, key) pairs (n (n + 1) / 2 a
    text of n tokens)."""
    return 2.0 * weights_per_token(cfg) * real_tokens + pair_flops(cfg) * cfg["num_hidden_layers"] * causal_pairs


def experts_least_s(cfg: dict, pairs: float, experts_used: float) -> dict:
    """The routed experts' least time for ``pairs`` (token, expert) pairs
    over calls that used ``experts_used`` experts in all: the larger of the
    operations (2 x 3 x hidden x width a pair) at the bf16 peak and the bytes
    (each used expert's bf16 weights once a call, each pair's bf16 row in
    and out) at HBM's rate."""
    ops = 2.0 * expert_params(cfg) * pairs
    nbytes = 2.0 * expert_params(cfg) * experts_used + 2 * 2.0 * cfg["hidden_size"] * pairs
    t_ops, t_bytes = ops / bounds.BF16_OPS_PER_S, nbytes / bounds.HBM_BYTES_PER_S
    return {"s": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes", "ops": ops,
            "bytes": nbytes}
