"""Which model types the JAX package's models actually run: every type that
``FlaxAutoModel`` (and, for the reranker, ``FlaxAutoModelForSequenceClassification``)
maps and the port does not, as a tiny seeded checkpoint (width 32, 2
layers) with a WordPiece tokenizer, through ``JaxSentenceEncoderRM._embed``
and ``JaxCrossEncoderReranker.score_pairs`` on the CPU.  Prints one line a
type and class: ``runs`` with the output's shape, or the error the
reference raises.  Not a test (pytest does not collect it): it records
what a later slice could port.

    JAX_PLATFORMS=cpu python tests/reference_model_types.py [type ...]
"""

from __future__ import annotations

import os
import sys
import tempfile
import traceback
import warnings

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import transformers  # noqa: E402
from transformers.models.auto import modeling_flax_auto  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_torch_checkpoints import seeded_vocab  # noqa: E402

from lotus_tpu.models import JaxCrossEncoderReranker, JaxSentenceEncoderRM  # noqa: E402
from lotus_tpu_torch.models import FAMILIES  # noqa: E402

# Small values for whichever of these fields a type's config has.
TINY = {
    "hidden_size": 32, "d_model": 32, "n_embd": 32, "embed_dim": 32, "projection_dim": 32,
    "num_hidden_layers": 2, "n_layer": 2, "num_layers": 2, "encoder_layers": 2, "decoder_layers": 2,
    "num_decoder_layers": 2, "num_attention_heads": 2, "n_head": 2, "num_heads": 2, "encoder_attention_heads": 2,
    "decoder_attention_heads": 2, "num_key_value_heads": 1, "intermediate_size": 64, "encoder_ffn_dim": 64,
    "decoder_ffn_dim": 64, "d_ff": 64, "d_kv": 16, "n_inner": 64, "head_dim": 16, "rotary_dim": 8,
    "max_position_embeddings": 128, "n_positions": 128, "attention_types": [[["global", "local"], 1]],
    "image_size": 32, "patch_size": 8, "hidden_sizes": [8, 16], "depths": [1, 1], "embedding_size": 8,
    "num_mel_bins": 16, "max_source_positions": 64, "max_target_positions": 64, "conv_dim": (8, 8),
    "conv_stride": (5, 2), "conv_kernel": (10, 3), "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 2,
}
TEXTS = ["hello world", "the cat sat on the mat", "", "a b c"]


def tiny_config(model_type: str, vocab_size: int):
    base = transformers.AutoConfig.for_model(model_type)
    kw = {k: v for k, v in TINY.items() if hasattr(base, k)}
    if hasattr(base, "vocab_size"):
        kw["vocab_size"] = vocab_size
    for sub in ("text_config", "vision_config"):
        if getattr(base, sub, None) is not None:
            kw[sub] = {k: v for k, v in TINY.items() if hasattr(getattr(base, sub), k)}
    return transformers.AutoConfig.for_model(model_type, **kw)


def check(model_type: str, vocab: list[str], root: str) -> list[str]:
    lines = []
    d = os.path.join(root, model_type)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    transformers.BertTokenizerFast(vocab_file=os.path.join(d, "vocab.txt")).save_pretrained(d)
    kinds = [("RM", transformers.FlaxAutoModel, None)]
    if model_type in modeling_flax_auto.FLAX_MODEL_FOR_SEQUENCE_CLASSIFICATION_MAPPING_NAMES:
        kinds.append(("reranker", transformers.FlaxAutoModelForSequenceClassification, 1))
    for kind, auto, labels in kinds:
        try:
            cfg = tiny_config(model_type, len(vocab))
            if labels:
                cfg.num_labels = labels
            auto.from_config(cfg).save_pretrained(d)
            if kind == "RM":
                out = JaxSentenceEncoderRM(model=d, max_batch_size=2, max_seq_length=64)._embed(TEXTS)
            else:
                out = JaxCrossEncoderReranker(model=d, max_batch_size=2, max_seq_length=64).score_pairs("cat", TEXTS)
            ok = bool(np.isfinite(out).all())
            lines.append(f"{model_type:24s} {kind:8s} runs: output {out.shape}, finite {ok}")
        except Exception as e:  # the reference's failure is the record
            where = traceback.extract_tb(e.__traceback__)[-1]
            lines.append(f"{model_type:24s} {kind:8s} fails: {type(e).__name__}: {str(e).splitlines()[0][:150]} "
                         f"({os.path.basename(where.filename)}:{where.lineno})")
    return lines


def main(types: list[str]) -> None:
    warnings.filterwarnings("ignore")
    transformers.logging.set_verbosity_error()
    vocab = seeded_vocab(0)
    types = types or [t for t in modeling_flax_auto.FLAX_MODEL_MAPPING_NAMES if t not in FAMILIES]
    with tempfile.TemporaryDirectory() as root:
        for t in types:
            for line in check(t, vocab, root):
                print(line, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
