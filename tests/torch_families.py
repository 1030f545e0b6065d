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
  (weights and tokenizer) for one family;
- the encoder-decoder families (``SEQ2SEQ``, kept out of ``FAMILIES`` so
  that the files parametrised over it do not grow): ``write_seq2seq`` and
  ``write_seq2seq_tokenizer`` (BART's and Blenderbot's byte-level BPE,
  mBART's and Pegasus's Unigram in their converters' layouts,
  Blenderbot-Small's slow BPE files, ``blenderbot_small_files``);
- the decoder-only families (``DECODERS``, kept out of ``FAMILIES`` too):
  ``write_decoder`` and ``write_decoder_tokenizer`` (GPT-2's byte-level BPE
  with ``<|endoftext|>``; ``sp_bpe_tokenizer``, the sentencepiece BPE with
  byte fallback that ``LlamaConverter`` and ``GemmaConverter`` build, over
  seeded merges); BLOOM's and XGLM's (``ALIBI_DECODERS``, their own files'):
  ``write_alibi_decoder``, ``bloom_tokenizer`` (byte-level BPE behind
  BLOOM's ``Split`` on a ``Regex``) and ``xglm_tokenizer`` (``XGLMConverter``'s
  Unigram, ``</s> $A``);
- GPT-SW3 and Marian (their own files'): ``spm_proto`` (a seeded
  sentencepiece ``ModelProto``, Unigram or BPE), ``converted`` (its
  ``SpmConverter`` conversion), ``write_gpt_sw3`` (``spiece.model``),
  ``write_marian`` (``source.spm`` and ``vocab.json``) and ``twin`` (the
  same checkpoint with a ``tokenizer.json`` the reference can read).
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


ROBERTA_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")


def write_bpe_files(path: str, seed: int = 0, vocab_size: int = 600,
                    specials: tuple[str, ...] = ROBERTA_SPECIALS) -> None:
    """A byte-level BPE ``vocab.json`` / ``merges.txt`` with ``specials``
    (RoBERTa's by default) first, trained by ``tokenizers`` on seeded text."""
    from tokenizers import ByteLevelBPETokenizer

    os.makedirs(path, exist_ok=True)
    bpe = ByteLevelBPETokenizer()
    corpus = seeded_texts(seed, 400, seeded_words(seed, 300), 3, 20)
    bpe.train_from_iterator(corpus, vocab_size=vocab_size, min_frequency=2, special_tokens=list(specials),
                            show_progress=False)
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


# ---- the encoder-decoder families ------------------------------------------------

SEQ2SEQ = ("bart", "mbart", "pegasus", "blenderbot", "blenderbot-small")
SEQ2SEQ_CLASSIFIERS = ("bart", "mbart")  # the types FlaxAutoModelForSequenceClassification maps
# MBartConverter's language codes (FAIRSEQ_LANGUAGE_CODES), after the pieces.
MBART_LANGS = ("ar_AR", "cs_CZ", "de_DE", "en_XX", "es_XX", "et_EE", "fi_FI", "fr_XX", "gu_IN", "hi_IN", "it_IT",
               "ja_XX", "kk_KZ", "ko_KR", "lt_LT", "lv_LV", "my_MM", "ne_NP", "nl_XX", "ro_RO", "ru_RU", "si_LK",
               "tr_TR", "vi_VN", "zh_CN")
PEGASUS_HEAD = ("<pad>", "</s>", "<mask_1>", "<mask_2>", *(f"<unk_{i}>" for i in range(2, 103)), "<unk>")


def spm_unigram(vocab: list[tuple[str, float]], unk: str, blob: bytes | None, template: processors.TemplateProcessing,
                whitespace_split: bool = False) -> Tokenizer:
    """A Unigram tokenizer as ``SpmConverter`` builds one: the ``Precompiled``
    charsmap, ``Strip`` on the right, ``Replace(" {2,}", "▁")``, ``Metaspace``
    (always; after ``WhitespaceSplit`` for Pegasus) and ``template``."""
    tok = Tokenizer(models.Unigram(vocab, unk_id=[t for t, _ in vocab].index(unk), byte_fallback=False))
    steps = [normalizers.Precompiled(blob)] if blob is not None else []
    tok.normalizer = normalizers.Sequence([*steps, normalizers.Strip(left=False, right=True),
                                           normalizers.Replace(Regex(" {2,}"), "▁")])
    meta = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(), meta]) if whitespace_split else meta
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.post_processor = template
    return tok


def mbart_tokenizer(seed: int = 0, blob: bytes | None = None) -> Tokenizer:
    """mBART's fast tokenizer as ``MBartConverter`` builds it over a seeded
    Unigram vocabulary (``<s> <pad> </s> <unk>``, the pieces, the language
    codes, ``<mask>``), with the file's template ``$A </s> en_XX``."""
    vocab = unigram_vocab(seed, specials=(("<s>", "<pad>", "</s>", "<unk>"), (*MBART_LANGS, "<mask>")))
    ids = {t: i for i, (t, _) in enumerate(vocab)}
    template = processors.TemplateProcessing(single="$A </s> en_XX", pair="$A $B </s> en_XX",
                                             special_tokens=[("</s>", ids["</s>"]), ("en_XX", ids["en_XX"])])
    return spm_unigram(vocab, "<unk>", blob, template)


def pegasus_tokenizer(seed: int = 0, blob: bytes | None = None) -> Tokenizer:
    """Pegasus's fast tokenizer as ``PegasusConverter`` builds it over a
    seeded Unigram vocabulary (``<pad> </s> <mask_1> <mask_2>``,
    ``<unk_2>`` .. ``<unk_102>``, ``<unk>``, the pieces), ``WhitespaceSplit``
    before ``Metaspace``, and ``$A </s>`` / ``$A $B </s>``."""
    vocab = unigram_vocab(seed, specials=(PEGASUS_HEAD, ()))
    template = processors.TemplateProcessing(single="$A </s>", pair="$A $B </s>", special_tokens=[("</s>", 1)])
    return spm_unigram(vocab, "<unk>", blob, template, whitespace_split=True)


def blenderbot_small_files(path: str, seed: int = 0, vocab_size: int = 400) -> None:
    """Blenderbot-Small's ``vocab.json`` / ``merges.txt``: BPE merges with
    ``</w>`` trained by ``tokenizers`` on seeded lowercase words, the
    vocabulary in the slow tokenizer's form (a piece that ends a word
    without ``</w>``, any other with ``@@``), with ``__null__``,
    ``__start__``, ``__end__``, ``__unk__`` first and ``__newln__``."""
    from tokenizers import trainers

    trainee = Tokenizer(models.BPE(unk_token="__unk__", end_of_word_suffix="</w>"))
    trainee.normalizer = normalizers.Lowercase()
    trainee.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                                     pre_tokenizers.Punctuation(behavior="isolated")])
    corpus = seeded_texts(seed, 400, seeded_words(seed, 300), 3, 20)
    trainee.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=vocab_size, min_frequency=2,
                                                            end_of_word_suffix="</w>", show_progress=False))
    trained = json.loads(trainee.to_str())["model"]
    vocab = {t: i for i, t in enumerate(("__null__", "__start__", "__end__", "__unk__", "__newln__"))}
    for t in trained["vocab"]:
        vocab.setdefault(t[:-4] if t.endswith("</w>") else t + "@@", len(vocab))
    for c in LETTERS + list(".,!?()'"):  # single characters stand alone
        vocab.setdefault(c, len(vocab))
    merges = [m.split(" ", 1) if isinstance(m, str) else m for m in trained["merges"]]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def write_seq2seq_tokenizer(path: str, family: str, seed: int = 0, **kw):
    """The family's tokenizer as ``AutoTokenizer`` builds it, saved in
    ``path`` (``kw`` go to its class: ``src_lang`` for mBART,
    ``add_prefix_space`` for Blenderbot).  Blenderbot-Small's is the slow
    tokenizer, its ``tokenizer_config.json`` left without a class, as
    ``AutoTokenizer`` (4.57) fails to convert it to the fast class that a
    named class sends it to.  Returns it."""
    os.makedirs(path, exist_ok=True)
    blob = build_charsmap(CHARSMAP)
    if family in ("bart", "blenderbot"):
        write_bpe_files(path, seed)
        cls = transformers.BartTokenizerFast if family == "bart" else transformers.BlenderbotTokenizerFast
        tok = cls(vocab_file=os.path.join(path, "vocab.json"), merges_file=os.path.join(path, "merges.txt"), **kw)
    elif family == "mbart":
        tok = transformers.MBartTokenizerFast(tokenizer_object=mbart_tokenizer(seed, blob), **kw)
    elif family == "pegasus":
        tok = transformers.PegasusTokenizerFast(tokenizer_object=pegasus_tokenizer(seed, blob), **kw)
    else:
        blenderbot_small_files(path, seed)
        tok = transformers.BlenderbotSmallTokenizer(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"))
    tok.save_pretrained(path)
    if family == "blenderbot-small":
        cfg_path = os.path.join(path, "tokenizer_config.json")
        with open(cfg_path, encoding="utf-8") as f:
            cfg = json.load(f)
        cfg.pop("tokenizer_class")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
    return tok


def seq2seq_config(family: str, vocab_size: int, *, num_labels: int | None = None, init_std: float = 0.02,
                   max_position_embeddings: int = 128, **kw):
    """A tiny config (width 32, 2 + 2 layers, 2 heads, FFN 64) of
    ``family``, with the published models' layout flags: ``scale_embedding``
    for mBART, Pegasus and both Blenderbots, ReLU for Pegasus."""
    cls = {"bart": transformers.BartConfig, "mbart": transformers.MBartConfig, "pegasus": transformers.PegasusConfig,
           "blenderbot": transformers.BlenderbotConfig,
           "blenderbot-small": transformers.BlenderbotSmallConfig}[family]
    ids = {"bart": (1, 0, 2, 2), "mbart": (1, 0, 2, None), "pegasus": (0, None, 1, 0), "blenderbot": (0, 1, 2, 1),
           "blenderbot-small": (0, 1, 2, 1)}[family]
    fields = dict(vocab_size=vocab_size, d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
                  decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64, init_std=init_std,
                  max_position_embeddings=max_position_embeddings, scale_embedding=family != "bart",
                  activation_function="relu" if family == "pegasus" else "gelu",
                  **dict(zip(("pad_token_id", "bos_token_id", "eos_token_id", "decoder_start_token_id"), ids)))
    if num_labels is not None:
        fields["num_labels"] = num_labels
    fields.update(kw)
    return cls(**fields)


def write_seq2seq(path: str, family: str, *, num_labels: int | None = None, seed: int = 0, init_std: float = 0.02,
                  tokenizer_kw: dict | None = None, **cfg_kw):
    """A ``family`` checkpoint in ``path``: its tokenizer, and the
    encoder-decoder (or with ``num_labels`` the sequence classifier) drawn
    with weights of standard deviation ``init_std``, saved with
    ``save_pretrained`` (``model.safetensors``, which keeps ``shared`` of the
    tied embeddings).  Returns the torch model."""
    tok = write_seq2seq_tokenizer(path, family, seed, **(tokenizer_kw or {}))
    cfg = seq2seq_config(family, len(tok), num_labels=num_labels, init_std=init_std, **cfg_kw)
    auto = transformers.AutoModel if num_labels is None else transformers.AutoModelForSequenceClassification
    torch.manual_seed(seed)
    model = auto.from_config(cfg).eval()
    model.save_pretrained(path)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        assert json.load(f)["model_type"] == family
    return model


# ---- the decoder-only families ---------------------------------------------------

DECODERS = ("gpt2", "gpt_neo", "gptj", "llama", "mistral", "gemma")
GPT2_EOS = "<|endoftext|>"
SP_SPECIALS = {"llama": ("<unk>", "<s>", "</s>"), "gemma": ("<pad>", "<eos>", "<bos>", "<unk>")}


def sp_bpe_tokenizer(seed: int = 0, flavor: str = "llama", vocab_size: int = 500,
                     missing_bytes: tuple[int, ...] = (), legacy: bool = True) -> Tokenizer:
    """A sentencepiece BPE with byte fallback as ``LlamaConverter``
    (``flavor`` llama: ``<unk> <s> </s>``, the normalizer ``Prepend("▁")``,
    ``Replace(" ", "▁")`` and no pre-tokenizer; with ``legacy`` False no
    normalizer and ``Metaspace`` (first, unsplit)) or ``GemmaConverter``
    (``gemma``: ``<pad> <eos> <bos> <unk>``, ``Replace(" ", "▁")``,
    ``Split(" ", merged_with_previous)``) writes it: the specials, the 256
    ``<0xXX>`` byte tokens but ``missing_bytes``, then pieces and merges
    trained by ``tokenizers`` on seeded text within ``▁`` words, over an
    alphabet cut to 40 characters (so accents, CJK and emoji fall back to
    bytes); ``<unk>`` fused."""
    from tokenizers import trainers

    specials = SP_SPECIALS[flavor]
    if flavor == "gemma":
        norm, pre = normalizers.Replace(" ", "▁"), pre_tokenizers.Split(" ", "merged_with_previous")
    elif legacy:
        norm, pre = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")]), None
    else:
        norm, pre = None, pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first", split=False)
    trainee = Tokenizer(models.BPE(unk_token="<unk>"))
    trainee.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    trainee.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="never", split=True)
    corpus = seeded_texts(seed, 400, seeded_words(seed, 300), 3, 20)
    trainee.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=vocab_size, min_frequency=2, limit_alphabet=40,
                                                            special_tokens=list(specials), show_progress=False))
    trained = json.loads(trainee.to_str())["model"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        if b not in missing_bytes:
            vocab[f"<0x{b:02X}>"] = len(vocab)
    for t in trained["vocab"]:
        vocab.setdefault(t, len(vocab))
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in trained["merges"]]
    tok = Tokenizer(models.BPE(vocab, merges, unk_token="<unk>", fuse_unk=True, byte_fallback=True))
    if norm is not None:
        tok.normalizer = norm
    if pre is not None:
        tok.pre_tokenizer = pre
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse()])
    return tok


def write_decoder_tokenizer(path: str, family: str, seed: int = 0, pad: str | None = "default", **kw):
    """The family's tokenizer as ``AutoTokenizer`` builds it, saved in
    ``path``: ``GPT2TokenizerFast`` over seeded byte-level BPE files with
    ``<|endoftext|>`` for gpt2, gpt_neo and gptj; ``LlamaTokenizerFast`` over
    ``sp_bpe_tokenizer`` for llama and mistral; ``GemmaTokenizerFast`` over
    its gemma flavor.  ``pad`` is the pad token: by default ``<|endoftext|>``,
    ``</s>`` (as fine-tuned embedders set it) and Gemma's own ``<pad>``;
    None leaves none, as GPT-2's, Llama-2's and Mistral's published
    tokenizers have none.  ``kw`` go to the class (``add_bos_token``,
    ``add_eos_token``, ``padding_side``).  Returns it."""
    os.makedirs(path, exist_ok=True)
    if family in ("gpt2", "gpt_neo", "gptj"):
        write_bpe_files(path, seed, specials=(GPT2_EOS,))
        pad = GPT2_EOS if pad == "default" else pad
        tok = transformers.GPT2TokenizerFast(vocab_file=os.path.join(path, "vocab.json"),
                                             merges_file=os.path.join(path, "merges.txt"), pad_token=pad, **kw)
    elif family == "gemma":
        pad = "<pad>" if pad == "default" else pad
        tok = transformers.GemmaTokenizerFast(tokenizer_object=sp_bpe_tokenizer(seed, "gemma"), pad_token=pad, **kw)
    else:
        pad = "</s>" if pad == "default" else pad
        legacy = kw.pop("legacy", True)
        tok = transformers.LlamaTokenizerFast(tokenizer_object=sp_bpe_tokenizer(seed, "llama", legacy=legacy),
                                              pad_token=pad, legacy=legacy, **kw)
    tok.save_pretrained(path)
    return tok


def decoder_config(family: str, vocab_size: int, *, init_range: float = 0.02, max_position_embeddings: int = 128,
                   **kw):
    """A tiny config of ``family``: width 32, 2 layers, 4 heads, FFN 64,
    128 positions; Llama's and Mistral's 2 KV heads, Gemma's one KV head of
    ``head_dim`` 16 (not 32 / 4) and its ``hidden_activation`` unset;
    GPT-Neo's global and local layers with a 4-token window; GPT-J's
    ``rotary_dim`` 4 of 8."""
    pos = max_position_embeddings
    if family == "gpt2":
        fields = dict(n_positions=pos, n_embd=32, n_layer=2, n_head=4, n_inner=64)
    elif family == "gpt_neo":
        fields = dict(max_position_embeddings=pos, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                      attention_types=[[["global", "local"], 1]], window_size=4)
    elif family == "gptj":
        fields = dict(n_positions=pos, n_embd=32, n_layer=2, n_head=4, n_inner=64, rotary_dim=4)
    else:
        fields = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=pos, bos_token_id=1, eos_token_id=2)
        if family == "gemma":
            fields.update(num_key_value_heads=1, head_dim=16, hidden_activation=None, pad_token_id=0,
                          bos_token_id=2, eos_token_id=1)
    fields.update(kw)
    cls = {"gpt2": transformers.GPT2Config, "gpt_neo": transformers.GPTNeoConfig, "gptj": transformers.GPTJConfig,
           "llama": transformers.LlamaConfig, "mistral": transformers.MistralConfig,
           "gemma": transformers.GemmaConfig}[family]
    return cls(vocab_size=vocab_size, initializer_range=init_range, **fields)


def write_decoder(path: str, family: str, *, seed: int = 0, init_range: float = 0.02,
                  tokenizer_kw: dict | None = None, **cfg_kw):
    """A ``family`` checkpoint in ``path``: its tokenizer and the base model
    drawn with weights of standard deviation ``init_range`` (norm weights
    too, so Gemma's 1 + weight is not 1), saved with ``save_pretrained``
    (``model.safetensors``).  Returns the torch model."""
    tok = write_decoder_tokenizer(path, family, seed, **(tokenizer_kw or {}))
    cfg = decoder_config(family, len(tok), init_range=init_range, **cfg_kw)
    torch.manual_seed(seed)
    model = transformers.AutoModel.from_config(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "ln_" in name:
                p.normal_(1.0 if family != "gemma" and name.endswith("weight") else 0.0, init_range)
    model.save_pretrained(path)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        assert json.load(f)["model_type"] == family
    return model


# ---- BLOOM and XGLM --------------------------------------------------------------

ALIBI_DECODERS = ("bloom", "xglm")
# BLOOM's pre-tokenizer pattern, as its tokenizer.json writes it (Oniguruma's syntax).
BLOOM_SPLIT = " ?[^(\\s|[.,!?…。，、।۔،])]+"
BLOOM_SPECIALS = ("<unk>", "<s>", "</s>", "<pad>")
XGLM_MADEUP = tuple(f"<madeupword{i}>" for i in range(7))


def bloom_tokenizer(seed: int = 0, vocab_size: int = 600) -> Tokenizer:
    """BLOOM's ``tokenizer.json`` layout over byte-level BPE trained by
    ``tokenizers`` on seeded text: no normalizer, ``Split`` on
    ``BLOOM_SPLIT`` (isolated) then ``ByteLevel`` without its own regex,
    ``<unk> <s> </s> <pad>`` first, no unknown token, and the ``ByteLevel``
    post-processor (which adds nothing)."""
    from tokenizers import trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(BLOOM_SPLIT), "isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.decoder = decoders.ByteLevel()
    corpus = seeded_texts(seed, 400, seeded_words(seed, 300), 3, 20)
    tok.train_from_iterator(corpus, trainers.BpeTrainer(vocab_size=vocab_size, min_frequency=2,
                                                        special_tokens=list(BLOOM_SPECIALS), show_progress=False,
                                                        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return tok


def xglm_tokenizer(seed: int = 0, blob: bytes | None = None) -> Tokenizer:
    """XGLM's fast tokenizer as ``XGLMConverter`` builds it over a seeded
    Unigram vocabulary: ``<s> <pad> </s> <unk>``, the pieces, the seven
    ``<madeupwordN>``; ``SpmConverter``'s normalizer and ``Metaspace``; the
    template ``</s> $A`` / ``</s> $A </s> </s> $B``."""
    vocab = unigram_vocab(seed, specials=(("<s>", "<pad>", "</s>", "<unk>"), XGLM_MADEUP))
    template = processors.TemplateProcessing(single="</s> $A", pair="</s> $A </s> </s> $B",
                                             special_tokens=[("<s>", 0), ("</s>", 2)])
    return spm_unigram(vocab, "<unk>", blob, template)


def write_alibi_decoder_tokenizer(path: str, family: str, seed: int = 0, pad: str | None = "<pad>", **kw):
    """The family's tokenizer as ``AutoTokenizer`` builds it, saved in
    ``path``: ``BloomTokenizerFast`` over ``bloom_tokenizer``, padding on
    the left as BLOOM's ``tokenizer_config.json`` says, or
    ``XGLMTokenizerFast`` over ``xglm_tokenizer``; ``pad`` None leaves no
    pad token.  ``kw`` go to the class.  Returns it."""
    os.makedirs(path, exist_ok=True)
    if family == "bloom":
        tok = transformers.BloomTokenizerFast(tokenizer_object=bloom_tokenizer(seed), pad_token=pad, unk_token="<unk>",
                                              bos_token="<s>", eos_token="</s>", **{"padding_side": "left", **kw})
    else:
        tok = transformers.XGLMTokenizerFast(tokenizer_object=xglm_tokenizer(seed, build_charsmap(CHARSMAP)),
                                             pad_token=pad, **kw)
    tok.save_pretrained(path)
    return tok


def alibi_decoder_config(family: str, vocab_size: int, *, init_range: float = 0.02,
                         max_position_embeddings: int = 128, **kw):
    """A tiny config of ``family``: width 32, 2 layers, 4 heads; XGLM's FFN
    64 and 128 positions."""
    if family == "bloom":
        fields = dict(hidden_size=32, n_layer=2, n_head=4, initializer_range=init_range, pad_token_id=3,
                      bos_token_id=1, eos_token_id=2)
        cls = transformers.BloomConfig
    else:
        fields = dict(d_model=32, num_layers=2, attention_heads=4, ffn_dim=64, init_std=init_range,
                      max_position_embeddings=max_position_embeddings)
        cls = transformers.XGLMConfig
    fields.update(kw)
    return cls(vocab_size=vocab_size, **fields)


def write_alibi_decoder(path: str, family: str, *, seed: int = 0, init_range: float = 0.02,
                        tokenizer_kw: dict | None = None, causal_lm: bool = False, **cfg_kw):
    """A ``family`` checkpoint in ``path``: its tokenizer and the base model
    (or, with ``causal_lm``, the ``*ForCausalLM`` whose names carry the
    family's prefix) drawn from a seed with weights of standard deviation
    ``init_range`` (LayerNorms too, around 1 and 0), saved with
    ``save_pretrained`` (``model.safetensors``).  Returns the torch model."""
    tok = write_alibi_decoder_tokenizer(path, family, seed, **(tokenizer_kw or {}))
    cfg = alibi_decoder_config(family, len(tok), init_range=init_range, **cfg_kw)
    torch.manual_seed(seed)
    auto = transformers.AutoModelForCausalLM if causal_lm else transformers.AutoModel
    model = auto.from_config(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or "ln_f" in name:
                p.normal_(1.0 if name.endswith("weight") else 0.0, init_range)
            elif name.endswith("bias"):
                p.normal_(0.0, init_range)
    model.save_pretrained(path)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        assert json.load(f)["model_type"] == family
    return model


# ---- GPT-SW3 and Marian: sentencepiece .model files ------------------------------

SPM_CHARS = "abcdefghijklmnopqrstuvwxyzéüßñ,.!'0123456789AHLOWDR"


def spm_proto(seed: int = 0, model_type: str = "unigram", *, head: tuple[tuple[str, int], ...] = (),
              byte_fallback: bool = False, blob: bytes | None = None, user: tuple[str, ...] = (), n_words: int = 200,
              **normalizer):
    """A seeded sentencepiece ``ModelProto`` (``transformers``'
    ``sentencepiece_model_pb2_new``): the ``head`` pieces (piece, type),
    the 256 ``<0xNN>`` byte pieces under ``byte_fallback``, the ``user``
    pieces (USER_DEFINED), then seeded words.  A Unigram holds ``▁`` + each
    word and two halves of the longer ones, at distinct seeded scores; a BPE
    every prefix of ``▁`` + each word and one inner pair, scored by rank (the
    earlier the higher).  Then every character of the pieces and
    ``SPM_CHARS`` at the lowest scores.  ``blob`` is the charsmap;
    ``normalizer`` sets NormalizerSpec fields."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    rng = np.random.default_rng(seed)
    m = pb.ModelProto()

    def add(piece: str, score: float, kind: int = 1) -> None:
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind

    for piece, kind in head:
        add(piece, 0.0, kind)
    if byte_fallback:
        for b in range(256):
            add(f"<0x{b:02X}>", 0.0, 6)
    for piece in user:
        add(piece, 0.0, 4)
    taken = {p.piece for p in m.pieces}
    pieces: dict[str, float] = {}
    for w in seeded_words(seed, n_words):
        if model_type == "unigram":
            pieces.setdefault("▁" + w, -float(rng.uniform(3, 12)))
            if len(w) > 2:
                k = int(rng.integers(1, len(w)))
                pieces.setdefault(w[:k], -float(rng.uniform(6, 12)))
                pieces.setdefault(w[k:], -float(rng.uniform(6, 12)))
        else:
            form = "▁" + w
            for k in range(2, len(form) + 1):
                pieces.setdefault(form[:k], 0.0)
            if len(w) > 3:
                pieces.setdefault(w[1:3], 0.0)
    pieces = {p: s for p, s in pieces.items() if p not in taken}
    chars = [c for c in dict.fromkeys("".join(pieces) + SPM_CHARS + "▁") if c not in pieces and c not in taken]
    if model_type == "bpe":
        pieces = {p: -float(i) for i, p in enumerate(pieces)}
    low = min(pieces.values(), default=0.0)
    for piece, score in pieces.items():
        add(piece, score)
    for i, c in enumerate(chars):
        add(c, low - 1.0 - i * 0.125 if model_type == "bpe" else -float(rng.uniform(13, 16)))
    m.trainer_spec.model_type = 2 if model_type == "bpe" else 1
    m.trainer_spec.byte_fallback = byte_fallback
    kinds = [p.type for p in m.pieces]
    m.trainer_spec.unk_id = kinds.index(2) if 2 in kinds else 0
    if blob is not None:
        m.normalizer_spec.precompiled_charsmap = blob
    for k, v in normalizer.items():
        setattr(m.normalizer_spec, k, v)
    return m


class _Extractor:
    """``SentencePieceExtractor`` without ``sentencepiece``: the vocabulary
    in id order and ``generate_merges`` over the scores."""

    def __init__(self, path: str):
        self.path = path

    def extract(self, vocab_scores=None):
        from transformers.convert_slow_tokenizer import generate_merges

        vocab = {p: i for i, (p, _) in enumerate(vocab_scores)}
        return vocab, generate_merges(vocab, vocab_scores)


def converted(proto) -> Tokenizer:
    """``SpmConverter``'s ``tokenizers`` conversion of ``proto`` (its BPE
    merges from ``generate_merges``, as ``SentencePieceExtractor`` makes
    them)."""
    import tempfile
    import types

    from transformers.convert_slow_tokenizer import SpmConverter

    class Converter(SpmConverter):
        SpmExtractor = _Extractor

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sp.model")
        with open(path, "wb") as f:
            f.write(proto.SerializeToString())
        return Converter(types.SimpleNamespace(vocab_file=path)).converted()


GPT_SW3_HEAD = (("<unk>", 2), ("<pad>", 3), ("<s>", 3), ("<|endoftext|>", 3))


def gpt_sw3_config(vocab_size: int, model_type: str = "gpt-sw3", **kw):
    """A tiny GPT-SW3 config (GPT-2's: width 32, 2 layers, 4 heads, FFN 64,
    128 positions, exact GELU as the published ones), ``model_type``
    ``gpt-sw3`` or ``gpt2`` (the published files say ``gpt2``)."""
    fields = dict(n_positions=128, n_embd=32, n_layer=2, n_head=4, n_inner=64, activation_function="gelu",
                  initializer_range=0.2, pad_token_id=1, bos_token_id=2, eos_token_id=3)
    fields.update(kw)
    cfg = transformers.GPT2Config(vocab_size=vocab_size, **fields)
    cfg.model_type = model_type
    return cfg


def write_gpt_sw3(path: str, *, seed: int = 0, model_type: str = "gpt-sw3", proto=None, tokenizer_config=None,
                  **cfg_kw) -> str:
    """A GPT-SW3 directory: ``spiece.model`` (a seeded BPE with byte
    fallback and GPT-SW3's four special pieces first, unless ``proto``),
    ``tokenizer_config.json`` naming ``GPTSw3Tokenizer``, and GPT-2 weights
    of std 0.2 (LayerNorms around 1 and 0) saved with ``save_pretrained``,
    ``config.json``'s ``model_type`` set to ``model_type``."""
    proto = proto or spm_proto(seed, "bpe", head=GPT_SW3_HEAD, byte_fallback=True, remove_extra_whitespaces=False)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "spiece.model"), "wb") as f:
        f.write(proto.SerializeToString())
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"tokenizer_class": "GPTSw3Tokenizer", "do_lower_case": False, "remove_space": False,
                   "keep_accents": True, **(tokenizer_config or {})}, f)
    torch.manual_seed(seed)
    model = transformers.GPT2Model(gpt_sw3_config(len(proto.pieces), model_type, **cfg_kw)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "ln_" in name:
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.2)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.2)
    model.save_pretrained(path)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump({**cfg, "model_type": model_type}, f)
    return path


MARIAN_HEAD = (("<unk>", 2), ("<s>", 3), ("</s>", 3))


def marian_vocab(proto) -> dict[str, int]:
    """A ``vocab.json`` for ``proto`` in opus-mt's layout: ``</s>`` 0,
    ``<unk>`` 1, the other pieces in a seeded order, ``<pad>`` last (the
    ``pad_token_id`` and ``decoder_start_token_id``)."""
    rest = [p.piece for p in proto.pieces if p.piece not in ("</s>", "<unk>", "<s>")]
    order = np.random.default_rng(len(rest)).permutation(len(rest))
    return {t: i for i, t in enumerate(["</s>", "<unk>", *(rest[j] for j in order), "<pad>"])}


def marian_config(vocab_size: int, **kw):
    """A tiny Marian config in opus-mt's layout (width 32, 2 + 2 layers, 2
    heads, FFN 64, 128 positions, ``swish``, ``scale_embedding``, pad and
    decoder start the last id, eos 0)."""
    fields = dict(d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
                  decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64, init_std=0.2,
                  max_position_embeddings=128, scale_embedding=True, activation_function="swish",
                  pad_token_id=vocab_size - 1, decoder_start_token_id=vocab_size - 1, eos_token_id=0,
                  bos_token_id=0, forced_eos_token_id=0)
    fields.update(kw)
    return transformers.MarianConfig(vocab_size=vocab_size, **fields)


def write_marian(path: str, *, seed: int = 0, proto=None, **cfg_kw) -> str:
    """An opus-mt-style directory: ``source.spm`` and ``target.spm`` (a
    seeded Unigram with the ``CHARSMAP`` charsmap, unless ``proto``),
    ``vocab.json`` (``marian_vocab``), ``tokenizer_config.json`` naming
    ``MarianTokenizer``, and Marian weights of std 0.2 (LayerNorms around 1
    and 0) saved with ``save_pretrained``."""
    proto = proto or spm_proto(seed, "unigram", head=MARIAN_HEAD, blob=build_charsmap(CHARSMAP))
    vocab = marian_vocab(proto)
    os.makedirs(path, exist_ok=True)
    for name in ("source.spm", "target.spm"):
        with open(os.path.join(path, name), "wb") as f:
            f.write(proto.SerializeToString())
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"tokenizer_class": "MarianTokenizer", "source_lang": "en", "target_lang": "de"}, f)
    torch.manual_seed(seed)
    model = transformers.MarianModel(marian_config(len(vocab), **cfg_kw)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.2)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.2)
    model.save_pretrained(path)
    return path


def twin(path: str, out: str) -> str:
    """``path``'s checkpoint with its sentencepiece tokenizer converted to
    the ``tokenizer.json`` a fast tokenizer would read, for the reference
    (whose slow classes need ``sentencepiece``): ``SpmConverter``'s
    pipeline over ``spiece.model`` (GPT-SW3's special tokens; no template)
    or over ``source.spm`` with ``vocab.json``'s ids and the ``$A </s>``
    template (Marian's); ``tokenizer_config.json`` names
    ``PreTrainedTokenizerFast``."""
    import shutil

    from transformers.utils import sentencepiece_model_pb2_new as pb

    shutil.copytree(path, out, ignore=shutil.ignore_patterns("*.spm", "*.model", "vocab.json",
                                                             "tokenizer_config.json"))
    marian = os.path.exists(os.path.join(path, "source.spm"))
    proto = pb.ModelProto()
    with open(os.path.join(path, "source.spm" if marian else "spiece.model"), "rb") as f:
        proto.ParseFromString(f.read())
    spec = json.loads(converted(proto).to_str())
    if marian:
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        scores = {p.piece: p.score for p in proto.pieces}
        spec["model"]["vocab"] = [[t, scores.get(t, 0.0)] for t in vocab]
        spec["model"]["unk_id"] = vocab["<unk>"]
        spec["added_tokens"] = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
                                 "rstrip": False, "normalized": False, "special": True}
                                for t in ("</s>", "<unk>", "<pad>")]
        spec["post_processor"] = {"type": "TemplateProcessing",
                                  "single": [{"Sequence": {"id": "A", "type_id": 0}},
                                             {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                                  "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                                           {"Sequence": {"id": "B", "type_id": 0}},
                                           {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                                  "special_tokens": {"</s>": {"id": "</s>", "ids": [vocab["</s>"]],
                                                             "tokens": ["</s>"]}}}
        config = {"pad_token": "<pad>", "eos_token": "</s>", "unk_token": "<unk>"}
    else:
        config = {"pad_token": "<pad>", "eos_token": "<|endoftext|>", "unk_token": "<unk>", "bos_token": "<s>"}
    with open(os.path.join(out, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(out, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", **config}, f)
    return out
