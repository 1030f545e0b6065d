"""The port's counterparts of ``FlaxAutoModel``,
``FlaxAutoModelForSequenceClassification`` and ``AutoTokenizer`` for a
local checkpoint directory.

``load_encoder`` dispatches on ``config.json``'s ``model_type`` to the
families in ``checkpoint.FAMILIES``, which lists them with their sequence
classifiers (a family without one runs as an encoder only, where a
classifier raises ``ValueError`` as the reference's auto class does); any
other type raises ``NotImplementedError`` naming it: of the types ``FlaxAutoModel``
maps, t5 and its kin, and the vision and audio models, which fail in the
reference's classes.  It places each
tensor on the target device as it is read, and casts the model there: a 7B
checkpoint never sits whole on the host.
``load_tokenizer`` builds the class ``AutoTokenizer`` would
(``tokenizer_json.read_tokenizer_config``): the slow-only classes first,
Blenderbot-Small's from ``vocab.json`` and ``merges.txt``
(``blenderbot_small_tokenizer.py``), GPT-SW3's from ``spiece.model``
(``gpt_sw3_tokenizer.py``) and Marian's from ``source.spm`` and
``vocab.json`` (``marian_tokenizer.py``), each sentencepiece model read by
the port (``sentencepiece.py``); for any other class ``tokenizer.json`` first, then ``vocab.txt``
(WordPiece), then ``vocab.json`` + ``merges.txt`` (byte-level BPE); a
directory whose tokenizer is RoFormer's jieba one is refused
(``tokenizer_json``).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from lotus_tpu_torch.models.blenderbot_small_tokenizer import BlenderbotSmallTokenizer
from lotus_tpu_torch.models.checkpoint import fit_state_dict, iter_state_dict, new_module, read_config
from lotus_tpu_torch.models.gpt_sw3_tokenizer import GPTSw3Tokenizer
from lotus_tpu_torch.models.marian_tokenizer import MarianTokenizer
from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer, read_tokenizer_config

# The slow-only tokenizer classes, which AutoTokenizer builds whatever else the
# directory holds, by the class tokenizer_config.json (or the model type) names.
SLOW_TOKENIZERS = {"BlenderbotSmallTokenizer": BlenderbotSmallTokenizer, "GPTSw3Tokenizer": GPTSw3Tokenizer,
                   "MarianTokenizer": MarianTokenizer}


def load_encoder(model_dir: str, classifier: bool = False, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cpu") -> nn.Module:
    """The encoder (without a pooler) or, with ``classifier``, the sequence
    classifier of a checkpoint directory, in ``dtype`` on ``device``: each
    tensor goes to ``device`` in its file's dtype as it is read, and the
    parameters are cast to ``dtype`` there, one at a time."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"{model_dir!r} is not a checkpoint directory: the port reads local files and "
                                f"downloads nothing")
    config = read_config(model_dir)
    state = {k: t.to(device) for k, t in iter_state_dict(model_dir)}
    with torch.device("meta"):  # no initialisation: the checkpoint's tensors become the parameters
        module = new_module(config, classifier)
    module = fit_state_dict(module, state)
    del state  # the parameters hold the only references, so each cast frees its source
    return module.to(dtype=dtype).eval()


def load_tokenizer(model_dir: str) -> JsonTokenizer:
    """The tokenizer of a checkpoint directory: a slow-only class where
    ``AutoTokenizer`` would build one (``SLOW_TOKENIZERS``), else
    ``tokenizer.json``, else ``vocab.txt``, else ``vocab.json`` and
    ``merges.txt``."""
    def has(*names: str) -> bool:
        return all(os.path.exists(os.path.join(model_dir, n)) for n in names)

    slow = SLOW_TOKENIZERS.get(read_tokenizer_config(model_dir).get("tokenizer_class"))
    if slow is not None:
        return slow.from_dir(model_dir)
    if has("tokenizer.json"):
        return JsonTokenizer.from_dir(model_dir)
    if has("vocab.txt"):
        return JsonTokenizer.from_vocab_txt(model_dir)
    if has("vocab.json", "merges.txt"):
        return JsonTokenizer.from_vocab_merges(model_dir)
    raise FileNotFoundError(f"{model_dir}: no tokenizer.json, vocab.txt, or vocab.json with merges.txt")
