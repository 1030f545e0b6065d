"""The port's counterparts of ``FlaxAutoModel``,
``FlaxAutoModelForSequenceClassification`` and ``AutoTokenizer`` for a
local checkpoint directory.

``load_encoder`` dispatches on ``config.json``'s ``model_type`` to the
families in ``checkpoint.FAMILIES`` (bert, roberta, xlm-roberta,
distilbert, electra); any other type (albert, roformer, big_bird,
roberta-prelayernorm, deberta-v2, ...) raises ``NotImplementedError``
naming it.  ``load_tokenizer`` reads ``tokenizer.json`` first, then
``vocab.txt`` (WordPiece), then ``vocab.json`` + ``merges.txt``
(byte-level BPE).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from lotus_tpu_torch.models.checkpoint import fit_state_dict, load_state_dict, new_module, read_config
from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer


def load_encoder(model_dir: str, classifier: bool = False) -> nn.Module:
    """The encoder (without a pooler) or, with ``classifier``, the sequence
    classifier of a checkpoint directory, in f32 on the CPU."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"{model_dir!r} is not a checkpoint directory: the port reads local files and "
                                f"downloads nothing")
    config = read_config(model_dir)
    state = {k: t.float() if t.is_floating_point() else t for k, t in load_state_dict(model_dir).items()}
    with torch.device("meta"):  # no initialisation: the checkpoint's tensors become the parameters
        module = new_module(config, classifier)
    return fit_state_dict(module, state).eval()


def load_tokenizer(model_dir: str) -> JsonTokenizer:
    """The tokenizer of a checkpoint directory: ``tokenizer.json``, else
    ``vocab.txt``, else ``vocab.json`` and ``merges.txt``."""
    def has(*names: str) -> bool:
        return all(os.path.exists(os.path.join(model_dir, n)) for n in names)

    if has("tokenizer.json"):
        return JsonTokenizer.from_dir(model_dir)
    if has("vocab.txt"):
        return JsonTokenizer.from_vocab_txt(model_dir)
    if has("vocab.json", "merges.txt"):
        return JsonTokenizer.from_vocab_merges(model_dir)
    raise FileNotFoundError(f"{model_dir}: no tokenizer.json, vocab.txt, or vocab.json with merges.txt")
