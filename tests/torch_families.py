"""Tiny checkpoints of the encoder families past BERT (RoBERTa, XLM-RoBERTa,
DistilBERT, ELECTRA, ALBERT, RoFormer, BigBird, RoBERTa-PreLayerNorm) and
their tokenizers, for the port's model tests, written with ``transformers``
and ``tokenizers`` (offline: every vocabulary, merge, score and weight is
made here from a seed).

- ``write_bpe_files``: a byte-level BPE ``vocab.json`` / ``merges.txt``
  trained by ``tokenizers`` on seeded text;
- ``unigram_tokenizer``: a ``tokenizers.Tokenizer`` over a seeded Unigram
  vocabulary whose scores repeat (ties), with the normalizer, ``Metaspace``
  and template ``XLMRobertaConverter`` gives XLM-R, the ``Precompiled``
  step a charsmap of ``CHARSMAP`` (``charsmap.build_charsmap``);
- ``albert_tokenizer``: ``AlbertConverter``'s pipeline (``NFKD``,
  ``StripAccents``, ``Lowercase``, the charsmap, Unigram, ``[CLS] $A [SEP]
  $B:1 [SEP]:1``) over a seeded Unigram vocabulary in ALBERT's layout;
- ``spm_bpe_tokenizer``: ``BigBirdConverter``'s (``SpmConverter``'s
  normalizer, ``Metaspace``, the same template) over a sentencepiece-style
  BPE (``fuse_unk``) trained by ``tokenizers`` on seeded text;
- ``write_family``: a checkpoint directory saved with ``save_pretrained``
  (weights and tokenizer) for one family.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

import transformers
from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, processors

from test_torch_checkpoints import seeded_vocab

from lotus_tpu_torch.models.charsmap import build_charsmap

FAMILIES = ("roberta", "xlm-roberta", "distilbert", "electra", "albert", "roformer", "big_bird",
            "roberta-prelayernorm")
LETTERS = list("abcdefghijklmnopqrstuvwxyz") + ["é", "ü", "ß", "ñ"]

# The charsmap the tests build: full-width letters, circled digits, the
# ideographic space, a multi-character replacement and a multi-character key.
CHARSMAP = {
    "\uff21": "A", "\uff22": "B", "\uff41": "a", "\uff42": "b", "\uff3a": "Z",  # full-width letters
    "\u2460": "1", "\u2461": "2", "\u2469": "10",  # circled digits
    "\u3000": " ", "\u337f": "\u682a\u5f0f\u4f1a\u793e", "\ufb01": "fi",  # U+3000, a multi-character replacement
    "e\u0301": "\u00e9", "\u00a0": " ", "\t": " ",  # a multi-character key
}


def seeded_words(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(LETTERS, rng.integers(1, 8))) for _ in range(n)]


def seeded_texts(seed: int, n: int, words: list[str], lo: int = 0, hi: int = 30) -> list[str]:
    rng = np.random.default_rng(seed)
    extra = ["Hello,", "WORLD!", "don't", "it's", "they'll", "12", "3.5", "日本", "①②", "Ａｂ", "ét", "😀",
             "<mask>", "a\tb", "x\ny", "  ", "naïve", "㍿", "ﬁne", " "]
    pool = words + extra
    return [" ".join(rng.choice(pool, rng.integers(lo, hi + 1))) for _ in range(n)]


def write_bpe_files(path: str, seed: int = 0, vocab_size: int = 600) -> None:
    """A byte-level BPE ``vocab.json`` / ``merges.txt`` with RoBERTa's special
    tokens, trained by ``tokenizers`` on seeded text."""
    from tokenizers import ByteLevelBPETokenizer

    os.makedirs(path, exist_ok=True)
    bpe = ByteLevelBPETokenizer()
    corpus = seeded_texts(seed, 400, seeded_words(seed, 300), 3, 20)
    bpe.train_from_iterator(corpus, vocab_size=vocab_size, min_frequency=2,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"], show_progress=False)
    bpe.save_model(path)


XLMR_SPECIALS = (("<s>", "<pad>", "</s>", "<unk>"), ("<mask>",))
ALBERT_SPECIALS = (("<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"), ())


def unigram_vocab(seed: int, n_words: int = 300,
                  specials: tuple[tuple[str, ...], tuple[str, ...]] = XLMR_SPECIALS) -> list[tuple[str, float]]:
    """``specials[0]``, the pieces, ``specials[1]`` (XLM-R's layout by
    default: ``<s>`` ``<pad>`` ``</s>`` ``<unk>`` first, ``<mask>`` last) over
    seeded ``▁`` words, word pieces and single characters, with scores on a
    0.5 grid so that paths tie; a few characters have no piece (they are
    unknown)."""
    rng = np.random.default_rng(seed)
    words = seeded_words(seed, n_words)
    pieces: dict[str, float] = {}
    for w in words:
        pieces.setdefault("▁" + w, -float(rng.integers(4, 24)) / 2)
        if len(w) > 2:
            k = int(rng.integers(1, len(w)))
            pieces.setdefault(w[:k], -float(rng.integers(6, 24)) / 2)
            pieces.setdefault(w[k:], -float(rng.integers(6, 24)) / 2)
    for c in [*LETTERS[:-2], *"▁,.!'0123456789AHLOWDR", "日", "株", "式", "会", "社"]:
        pieces.setdefault(c, -float(rng.integers(16, 30)) / 2)
    return [*((t, 0.0) for t in specials[0]), *pieces.items(), *((t, 0.0) for t in specials[1])]


def unigram_tokenizer(seed: int = 0, blob: bytes | None = None) -> Tokenizer:
    """XLM-R's fast tokenizer as ``XLMRobertaConverter`` builds it, over a
    seeded Unigram vocabulary: ``Replace`` of ````` and ``''``, the
    ``Precompiled`` charsmap, ``Replace(" {2,}", " ")``, ``Metaspace``
    (always), and ``<s> $A </s>`` / ``<s> $A </s> </s> $B </s>``."""
    vocab = unigram_vocab(seed)
    tok = Tokenizer(models.Unigram(vocab, unk_id=3, byte_fallback=False))
    steps = [normalizers.Replace("``", '"'), normalizers.Replace("''", '"')]
    if blob is not None:
        steps.append(normalizers.Precompiled(blob))
    tok.normalizer = normalizers.Sequence([*steps, normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    return tok


def _cls_sep_template(tok: Tokenizer) -> processors.TemplateProcessing:
    """ALBERT's and BigBird's template: ``[CLS] $A [SEP]`` and the pair's
    second segment with type id 1."""
    return processors.TemplateProcessing(
        single="[CLS]:0 $A:0 [SEP]:0", pair="[CLS]:0 $A:0 [SEP]:0 $B:1 [SEP]:1",
        special_tokens=[(t, tok.token_to_id(t)) for t in ("[CLS]", "[SEP]")])


def albert_tokenizer(seed: int = 0, blob: bytes | None = None) -> Tokenizer:
    """ALBERT's fast tokenizer as ``AlbertConverter`` builds it (``keep_accents``
    false, ``do_lower_case`` true): ``Replace`` of ````` and ``''``, ``NFKD``,
    ``StripAccents``, ``Lowercase``, the ``Precompiled`` charsmap,
    ``Replace(" {2,}", " ")``, ``Metaspace`` (always), Unigram over a seeded
    vocabulary in ALBERT's layout (``<pad> <unk> [CLS] [SEP] [MASK]``)."""
    tok = Tokenizer(models.Unigram(unigram_vocab(seed, specials=ALBERT_SPECIALS), unk_id=1, byte_fallback=False))
    steps = [normalizers.Replace("``", '"'), normalizers.Replace("''", '"'), normalizers.NFKD(),
             normalizers.StripAccents(), normalizers.Lowercase()]
    if blob is not None:
        steps.append(normalizers.Precompiled(blob))
    tok.normalizer = normalizers.Sequence([*steps, normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.post_processor = _cls_sep_template(tok)
    return tok


def spm_bpe_tokenizer(seed: int = 0, blob: bytes | None = None, vocab_size: int = 500) -> Tokenizer:
    """BigBird's fast tokenizer as ``BigBirdConverter`` builds it from a
    sentencepiece BPE model: ``BPE`` with ``<unk>`` and ``fuse_unk`` (no byte
    fallback), ``SpmConverter``'s normalizer (the ``Precompiled`` charsmap,
    ``Strip`` on the right, ``Replace(" {2,}", "▁")``), ``Metaspace``
    (always) and the ``[CLS]`` / ``[SEP]`` template; the merges are trained
    by ``tokenizers`` on seeded text."""
    from tokenizers import trainers

    specials = ["<pad>", "<s>", "</s>", "<unk>", "[CLS]", "[SEP]", "[MASK]"]
    steps = [normalizers.Precompiled(blob)] if blob is not None else []
    norm = normalizers.Sequence([*steps, normalizers.Strip(left=False, right=True),
                                 normalizers.Replace(Regex(" {2,}"), "▁")])
    meta = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    trainee = Tokenizer(models.BPE(unk_token="<unk>"))
    trainee.normalizer, trainee.pre_tokenizer = norm, meta
    corpus = seeded_texts(seed, 400, seeded_words(seed, 300), 3, 20)
    trainee.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=vocab_size, min_frequency=2,
                                                            special_tokens=specials, show_progress=False))
    trained = json.loads(trainee.to_str())["model"]
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in trained["merges"]]
    tok = Tokenizer(models.BPE(trained["vocab"], merges, unk_token="<unk>", fuse_unk=True, byte_fallback=False))
    tok.normalizer, tok.pre_tokenizer = norm, meta
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.post_processor = _cls_sep_template(tok)
    return tok


def write_tokenizer(path: str, family: str, seed: int = 0) -> "transformers.PreTrainedTokenizerFast":
    """The family's fast tokenizer, saved in ``path`` (``tokenizer.json``
    and the files ``save_pretrained`` writes beside it).  Returns it."""
    os.makedirs(path, exist_ok=True)
    if family in ("roberta", "roberta-prelayernorm"):
        write_bpe_files(path, seed)
        tok = transformers.RobertaTokenizerFast(vocab_file=os.path.join(path, "vocab.json"),
                                                merges_file=os.path.join(path, "merges.txt"))
    elif family == "xlm-roberta":
        tok = transformers.XLMRobertaTokenizerFast(tokenizer_object=unigram_tokenizer(seed, build_charsmap(CHARSMAP)))
    elif family == "albert":
        tok = transformers.AlbertTokenizerFast(tokenizer_object=albert_tokenizer(seed, build_charsmap(CHARSMAP)))
    elif family == "big_bird":
        tok = transformers.BigBirdTokenizerFast(tokenizer_object=spm_bpe_tokenizer(seed, build_charsmap(CHARSMAP)))
    else:  # WordPiece; RoFormer's as a BertTokenizer, since its own cuts with jieba
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(seeded_vocab(seed)) + "\n")
        cls = {"distilbert": transformers.DistilBertTokenizerFast, "electra": transformers.ElectraTokenizerFast,
               "bert": transformers.BertTokenizerFast, "roformer": transformers.BertTokenizerFast}[family]
        tok = cls(vocab_file=os.path.join(path, "vocab.txt"))
    tok.save_pretrained(path)
    return tok


def family_config(family: str, vocab_size: int, *, num_labels: int | None = None, init_range: float = 0.02,
                  max_position_embeddings: int = 128, **kw):
    """A tiny config (width 32, 2 layers, 2 heads) of ``family``; BigBird's
    attention is ``original_full`` unless ``kw`` says otherwise."""
    labels = {} if num_labels is None else {"num_labels": num_labels}
    if family == "distilbert":
        return transformers.DistilBertConfig(vocab_size=vocab_size, dim=32, n_layers=2, n_heads=2, hidden_dim=64,
                                             max_position_embeddings=max_position_embeddings,
                                             initializer_range=init_range, **labels, **kw)
    common = dict(vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=64, initializer_range=init_range, **labels)
    common.update({k: kw.pop(k) for k in list(kw) if k in common})
    if family == "electra":
        return transformers.ElectraConfig(max_position_embeddings=max_position_embeddings,
                                          embedding_size=kw.pop("embedding_size", 32), **common, **kw)
    if family == "albert":
        return transformers.AlbertConfig(max_position_embeddings=max_position_embeddings,
                                         embedding_size=kw.pop("embedding_size", 16), **common, **kw)
    if family == "roformer":
        return transformers.RoFormerConfig(max_position_embeddings=max_position_embeddings, **common, **kw)
    if family == "big_bird":
        return transformers.BigBirdConfig(max_position_embeddings=max_position_embeddings,
                                          attention_type=kw.pop("attention_type", "original_full"), **common, **kw)
    cls = {"roberta": transformers.RobertaConfig, "xlm-roberta": transformers.XLMRobertaConfig,
           "roberta-prelayernorm": transformers.RobertaPreLayerNormConfig}[family]
    # pad_token_id 1: positions start at 2, so a bucket of n tokens reaches n + 1.
    return cls(max_position_embeddings=max_position_embeddings + 2, type_vocab_size=1, pad_token_id=1,
               bos_token_id=0, eos_token_id=2, **common, **kw)


def write_family(path: str, family: str, *, num_labels: int | None = None, seed: int = 0, init_range: float = 0.02,
                 **cfg_kw):
    """A ``family`` checkpoint in ``path``: its tokenizer, and a base model
    (or with ``num_labels`` a sequence classifier) drawn with weights of
    standard deviation ``init_range``, saved with ``save_pretrained``.
    Returns the torch model."""
    tok = write_tokenizer(path, family, seed)
    cfg = family_config(family, len(tok), num_labels=num_labels, init_range=init_range, **cfg_kw)
    auto = transformers.AutoModel if num_labels is None else transformers.AutoModelForSequenceClassification
    torch.manual_seed(seed)
    model = auto.from_config(cfg).eval()
    model.save_pretrained(path)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        assert json.load(f)["model_type"] == family
    return model
