"""Every family ``checkpoint.FAMILIES`` lists, on the card against the CPU:
the RM's embeddings in f32 within ``F32_TOL`` and bf16 on the card against
f32 on the card at least ``BF16_MIN_COS``, and every family with a
sequence classifier as a 1-label reranker, its f32 scores within
``RERANK_TOL * (1 + |s|)``.  What the CPU tests hold to the reference is the
CPU forward; these hold the card's to it.

Each checkpoint is written here without ``transformers`` (the card machine
has none, ``torch_card_files.py``): 2 layers of 2 heads at each family's
published head width and layout (GQA, rotary and local windows, ALiBi,
block-sparse attention, pre-LN), seeded weights, a WordPiece vocabulary,
and GPT-SW3's and Marian's sentencepiece files.  The documents fall in four
sequence buckets, a batch each (BigBird's in its 256- and 512-token ones,
where its block-sparse attention runs).  DeepSeek-V2, Kimi-Linear and
DeepSeek-V3.2 are left out: their layers are held to the plain reference on
the card in ``test_torch_kernels_cuda.py``, ``test_torch_kimi_linear_cuda.py``
and ``test_torch_deepseek_v32_cuda.py``.  These tests need an NVIDIA GPU and
skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_families_cuda.py
"""

import numpy as np
import pytest
import torch
from torch_card_files import (
    seeded_docs, seeded_words, spm_tokenizer_files, write_checkpoint, write_files, write_wordpiece,
)

from lotus_tpu_torch.models import TorchCrossEncoderReranker, TorchSentenceEncoderRM
from lotus_tpu_torch.models.checkpoint import FAMILIES

WORDS = seeded_words(7, 2000)
# WordPiece ids: [PAD] 0, [CLS] 2, [SEP] 3; the encoder-decoders end and
# start on [SEP], the sentencepiece vocabularies on their own pieces.
_ENC = dict(num_hidden_layers=2, num_attention_heads=2, hidden_size=128, intermediate_size=256)
_S2S = dict(d_model=128, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_ffn_dim=256, decoder_ffn_dim=256, pad_token_id=0, eos_token_id=3, decoder_start_token_id=3)
_ROBERTA = dict(_ENC, max_position_embeddings=514, type_vocab_size=1, pad_token_id=0)
# The limits at this size, from the readings of every family on an H100:
# the card's f32 embeddings differ from the CPU's by 1.2e-7 at most, and by
# 6.8e-6 to 1.6e-4 with TF32 matmuls allowed; the rerankers' scores by
# 4.6e-6 * (1 + |s|) at most, and by 1.3e-5 to 1.2e-4 under TF32; bf16
# embeddings keep a cosine of 0.99996 with f32.  So the f32 and reranker
# limits pass f32 and fail a TF32 path in every family.
F32_TOL, RERANK_TOL, BF16_MIN_COS = 1e-6, 1e-5, 0.9999
# model_type -> (config without vocab_size, max_seq_length).
CASES = {
    "bert": (dict(_ENC, max_position_embeddings=512), 512),
    "roberta": (_ROBERTA, 512),
    "xlm-roberta": (_ROBERTA, 512),
    "distilbert": (dict(n_layers=2, n_heads=2, dim=128, hidden_dim=256), 512),
    "electra": (dict(_ENC, embedding_size=128), 512),
    "albert": (dict(_ENC, embedding_size=128, num_hidden_groups=1, inner_group_num=1, hidden_act="gelu_new"), 512),
    "roformer": (dict(_ENC, max_position_embeddings=1536), 512),
    "big_bird": (dict(_ENC, attention_type="block_sparse", block_size=64, num_random_blocks=3,
                      max_position_embeddings=4096, hidden_act="gelu_new"), 4096),
    "roberta-prelayernorm": (_ROBERTA, 512),
    "bart": (dict(_S2S, max_position_embeddings=1024), 512),
    "mbart": (dict(_S2S, max_position_embeddings=1024, scale_embedding=True), 512),
    "pegasus": (dict(_S2S, max_position_embeddings=1024, scale_embedding=True, activation_function="relu"), 512),
    "blenderbot": (dict(_S2S, max_position_embeddings=128, scale_embedding=True), 128),
    "blenderbot-small": (dict(_S2S, max_position_embeddings=512, scale_embedding=True), 512),
    "gpt2": (dict(n_embd=128, n_layer=2, n_head=2, n_positions=1024), 512),
    "gpt_neo": (dict(hidden_size=256, num_layers=2, num_heads=2, max_position_embeddings=2048, window_size=256,
                     attention_types=[[["global", "local"], 1]]), 512),
    "gptj": (dict(n_embd=512, n_layer=2, n_head=2, rotary_dim=64, n_positions=2048), 512),
    "llama": (dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
                   num_key_value_heads=2, max_position_embeddings=4096, rms_norm_eps=1e-5), 512),
    "mistral": (dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
                     num_key_value_heads=1, max_position_embeddings=32768, rms_norm_eps=1e-5, sliding_window=4096),
                512),
    "gemma": (dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
                   num_key_value_heads=1, head_dim=256, max_position_embeddings=8192), 512),
    "bloom": (dict(hidden_size=128, n_layer=2, n_head=2), 512),
    "xglm": (dict(d_model=128, num_layers=2, attention_heads=2, ffn_dim=256, max_position_embeddings=2048), 512),
    "gpt-sw3": (dict(n_embd=128, n_layer=2, n_head=2, n_positions=2048, activation_function="gelu"), 512),
    "marian": (dict(_S2S, max_position_embeddings=512, scale_embedding=True, activation_function="swish",
                    eos_token_id=0), 512),
}
SPM_SIZE = 4000  # GPT-SW3's and Marian's sentencepiece vocabularies
RERANKERS = [t for t, (_, _, seq_cls) in FAMILIES.items() if seq_cls is not None]


def _checkpoint(path, model_type: str, classifier: bool = False) -> tuple[str, int]:
    """A seeded ``model_type`` checkpoint in ``path``; returns it and its
    max_seq_length."""
    config, seq = CASES[model_type]
    config = dict(config, model_type=model_type)
    if model_type in ("gpt-sw3", "marian"):
        write_files(str(path), spm_tokenizer_files(WORDS, model_type, SPM_SIZE))
        config["vocab_size"] = SPM_SIZE
        if model_type == "marian":
            config.update(pad_token_id=SPM_SIZE - 1, decoder_start_token_id=SPM_SIZE - 1)
    else:
        config["vocab_size"] = write_wordpiece(str(path), WORDS)
    write_checkpoint(str(path), config, classifier=classifier, seed=sum(map(ord, model_type)))
    return str(path), seq


def _docs(model_type: str) -> list[str]:
    """16 documents in four sequence buckets; BigBird's 8 in two."""
    if model_type == "big_bird":
        return seeded_docs(WORDS, [(150, 230), (300, 480)], 4, 11)
    return seeded_docs(WORDS, [(3, 10), (11, 24), (25, 50), (51, 100)], 4, 11)


def test_every_family_has_a_card_case():
    """Every family but the three with card tests of their own
    (``test_torch_kernels_cuda.py``'s DeepSeek-V2 layers,
    ``test_torch_kimi_linear_cuda.py``, ``test_torch_deepseek_v32_cuda.py``)."""
    assert sorted(CASES) == sorted(t for t in FAMILIES if t not in ("deepseek_v2", "kimi_linear", "deepseek_v32"))


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", sorted(CASES))
def test_rm_on_the_card_matches_the_cpu_on_gpu(tmp_path, model_type):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this holds the card's forward to the CPU's")
    path, seq = _checkpoint(tmp_path, model_type)
    docs = _docs(model_type)
    kw = dict(model=path, max_batch_size=4, max_seq_length=seq)
    got = TorchSentenceEncoderRM(device="cuda", **kw)(docs)
    want = TorchSentenceEncoderRM(device="cpu", **kw)(docs)
    bf16 = TorchSentenceEncoderRM(device="cuda", dtype=torch.bfloat16, **kw)(docs)
    assert got.shape == want.shape and bool(np.isfinite(got).all())
    err = float(np.abs(got - want).max())
    assert err <= F32_TOL, f"{model_type}: the card's embeddings differ from the CPU's by {err}"
    cos = float(np.sum(bf16 * got, axis=1).min())
    assert cos >= BF16_MIN_COS, f"{model_type}: bf16 embeddings drift from f32 (cosine {cos})"


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", RERANKERS)
def test_reranker_on_the_card_matches_the_cpu_on_gpu(tmp_path, model_type):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: this holds the card's forward to the CPU's")
    path, seq = _checkpoint(tmp_path, model_type, classifier=True)
    docs = _docs(model_type)
    queries = seeded_docs(WORDS, [(3, 9)], 4, 12)
    share = len(docs) // len(queries)
    kw = dict(model=path, max_batch_size=4, max_seq_length=seq)
    got, want = (np.concatenate([rr.score_pairs(q, docs[i * share : (i + 1) * share]) for i, q in enumerate(queries)])
                 for rr in (TorchCrossEncoderReranker(device="cuda", **kw),
                            TorchCrossEncoderReranker(device="cpu", **kw)))
    assert bool(np.isfinite(got).all())
    assert bool((np.abs(got - want) <= RERANK_TOL * (1 + np.abs(want))).all()), \
        f"{model_type}: the card's scores differ from the CPU's by {float(np.abs(got - want).max())}"
