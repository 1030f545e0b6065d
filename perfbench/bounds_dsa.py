"""The arithmetic of DeepSeek-V3.2's operations and of DeepSeek Sparse
Attention's least times, frozen inside the benchmark (peaks from
``bounds.py``).  They read the same work whatever implements a stage.

A token's forward multiplies by every parameter it reaches but the
embedding's: each layer's latent attention with its query LoRA and norms,
the indexer's projections and key norm, the dense MLP of the leading layers,
and in each MoE layer the gate, the shared expert and
``num_experts_per_tok`` x ``n_routed_experts`` / ``router_experts`` routed
experts (the held share of its pairs); ``lm_head`` and the
multi-token-prediction layer are not run.  A scored causal (query, key) pair
costs 2 x index heads x index dim in the indexer, a layer; a selected pair 2
x heads x (nope + rope + v) in attention's non-absorbed form, the least work
(the absorbed form does 2 x heads x (rank + rope + rank), 3.4 times as much
at the published widths, so a design that runs it reads at most about 29% of
``attn_least_s``).
"""

from __future__ import annotations

from perfbench import bounds, bounds_moe


def is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg.get("first_k_dense_replace", 0) and i % cfg.get("moe_layer_freq", 1) == 0


def weights_per_token(cfg: dict) -> float:
    """The parameters one token's forward multiplies by, the routed experts
    counted at the held share of a token's pairs."""
    h, heads, qr = cfg["hidden_size"], cfg["num_attention_heads"], cfg["q_lora_rank"]
    nope, rope, v, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    ih, idim = cfg["index_n_heads"], cfg["index_head_dim"]
    attn = (h * qr + qr + qr * heads * (nope + rope) + h * (rank + rope) + rank + rank * heads * (nope + v)
            + heads * v * h + 2 * h)
    indexer = qr * ih * idim + h * idim + 2 * idim + h * ih
    router = cfg.get("router_experts", cfg["n_routed_experts"])
    routed = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / router
    moe = router * h + (routed + cfg["n_shared_experts"]) * bounds_moe.expert_params(cfg)
    dense = 3 * h * cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"]
    return h + layers * (attn + indexer) + sum(moe if is_moe(cfg, i) else dense for i in range(layers))


def index_pair_flops(cfg: dict) -> int:
    """Operations of one scored causal (query, key) pair in one layer's indexer."""
    return 2 * cfg["index_n_heads"] * cfg["index_head_dim"]


def attn_pair_flops(cfg: dict) -> int:
    """Operations of one selected (query, key) pair in one layer's attention,
    the non-absorbed form."""
    return 2 * cfg["num_attention_heads"] * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])


def dsv32_flops(cfg: dict, real_tokens: float, scored_pairs: float, selected_pairs: float) -> float:
    """Model operations of forwards over texts of ``real_tokens`` real tokens
    in all, ``scored_pairs`` causal (query, key) pairs (n (n + 1) / 2 a text
    of n tokens) and ``selected_pairs`` selected ones, every layer."""
    layers = cfg["num_hidden_layers"]
    return (2.0 * weights_per_token(cfg) * real_tokens
            + layers * (index_pair_flops(cfg) * scored_pairs + attn_pair_flops(cfg) * selected_pairs))


def _least(ops: float, nbytes: float) -> dict:
    t_ops, t_bytes = ops / bounds.BF16_OPS_PER_S, nbytes / bounds.HBM_BYTES_PER_S
    return {"s": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes", "ops": ops,
            "bytes": nbytes}


def index_least_s(cfg: dict, scored: float, queries: float, selected: float) -> dict:
    """The indexer's least time for ``scored`` causal pairs over ``queries``
    query rows that select ``selected`` pairs: the larger of its operations
    at the bf16 peak and its bytes (the bf16 index queries and keys, the f32
    head weights and the int32 selection, each once) at HBM's rate."""
    ih, idim = cfg["index_n_heads"], cfg["index_head_dim"]
    return _least(index_pair_flops(cfg) * scored, queries * (2 * ih * idim + 2 * idim + 4 * ih) + 4 * selected)


def attn_least_s(cfg: dict, selected: float, queries: float) -> dict:
    """Sparse attention's least time for ``selected`` pairs over ``queries``
    query rows: the larger of its operations (the non-absorbed form) at the
    bf16 peak and its bytes (each row's bf16 latent and rope key, its
    queries and its outputs, once) at HBM's rate."""
    heads = cfg["num_attention_heads"]
    nope, rope, v, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    row = 2 * (rank + rope) + 2 * heads * (nope + rope) + 2 * heads * v
    return _least(attn_pair_flops(cfg) * selected, queries * row)
