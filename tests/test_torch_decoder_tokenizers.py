"""The decoder families' tokenizers in the port (``tokenizer_json.py``,
``bpe.py``) against ``AutoTokenizer``'s fast classes, id for id:

- GPT-2's byte-level BPE (``GPT2TokenizerFast``, ``<|endoftext|>``);
  Llama's sentencepiece BPE with byte fallback in both of
  ``LlamaConverter``'s layouts (legacy: ``Prepend("▁")`` and
  ``Replace(" ", "▁")``, no pre-tokenizer; not legacy: ``Metaspace``
  first, unsplit) and Gemma's (``Replace``, ``Split(" ",
  merged_with_previous)``): texts, pairs, a ``max_length`` cut, and
  padding on the class's side (left for Llama and Gemma) or the side
  ``tokenizer_config.json`` names;
- the template ``LlamaTokenizerFast`` and ``GemmaTokenizerFast`` rebuild
  at load time from ``add_bos_token`` / ``add_eos_token``, not the file's;
- byte fallback where the vocabulary lacks some ``<0xXX>`` tokens (the
  unknown token, fused), and Gemma's ``Split`` on a space merged with the
  previous piece where spaces remain, each against the ``tokenizers``
  library;
- the refusals: any other ``Split`` (another behaviour, on a string or on a
  ``Regex``; inverted) and ``LlamaTokenizerFast`` with
  ``add_prefix_space`` (which rebuilds from the sentencepiece model) raise
  ``NotImplementedError``.
"""

import json
import os

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")

from tokenizers import Regex, Tokenizer, models, pre_tokenizers  # noqa: E402
from torch_families import seeded_texts, seeded_words, sp_bpe_tokenizer, write_decoder_tokenizer  # noqa: E402

from lotus_tpu_torch.models import load_tokenizer  # noqa: E402
from lotus_tpu_torch.models.tokenizer_json import JsonTokenizer  # noqa: E402

TEXTS = seeded_texts(7, 40, seeded_words(0, 200), 0, 30) + [
    "", " ", "Hello, WORLD!", "don't stop (now)?", "it's  two\nlines\n\nand\ttabs", "  leading and trailing  ",
    "ＡＢ ① ㍿ ﬁne", "<s> inside </s>", "<bos> and <eos> <pad>", "<|endoftext|> twice<|endoftext|>",
    "MiXeD CaSe 😀 naïve", "日本語 中文 ́ é"]
# name -> (family, class keywords, tokenizer_config.json fields written after save_pretrained)
CASES = {
    "gpt2": ("gpt2", {}, {}),
    "llama-legacy": ("llama", {}, {}),
    "llama-metaspace": ("llama", {"legacy": False}, {}),
    "llama-right": ("llama", {}, {"padding_side": "right"}),
    "llama-rebuilt": ("llama", {}, {"add_bos_token": False, "add_eos_token": True}),
    "gemma": ("gemma", {}, {}),
    "gemma-rebuilt": ("gemma", {}, {"add_eos_token": True}),
}


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    out = {}
    for name, (family, kw, fields) in CASES.items():
        d = str(tmp_path_factory.mktemp(f"tok-{name}"))
        write_decoder_tokenizer(d, family, 0, **kw)
        with open(os.path.join(d, "config.json"), "w", encoding="utf-8") as f:
            json.dump({"model_type": family}, f)
        path = os.path.join(d, "tokenizer_config.json")
        with open(path, encoding="utf-8") as f:
            cfg = json.load(f)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({**cfg, **fields}, f)
        out[name] = d
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_tokenizer_ids_match_auto_tokenizer(tokenizer_dirs, name):
    d = tokenizer_dirs[name]
    ref = transformers.AutoTokenizer.from_pretrained(d)
    port = load_tokenizer(d)
    assert port.encode(TEXTS) == ref(TEXTS)["input_ids"]
    assert port.encode(TEXTS, max_length=12) == ref(TEXTS, truncation=True, max_length=12)["input_ids"]
    second = TEXTS[::-1]
    want = ref(TEXTS, second, truncation=True, max_length=24)["input_ids"]
    assert port.encode(TEXTS, second, max_length=24) == want
    assert port.padding_side == ref.padding_side == ("left" if name in ("llama-legacy", "llama-metaspace",
                                                                        "llama-rebuilt", "gemma", "gemma-rebuilt")
                                                     else "right")
    ids, mask = port.pad(port.encode(TEXTS, max_length=40), 40)
    enc = ref(TEXTS, padding="max_length", truncation=True, max_length=40)
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])
    got = port(TEXTS[:8], TEXTS[8:16], max_length=32, padding=True)
    enc = ref(TEXTS[:8], TEXTS[8:16], truncation=True, max_length=32, padding=True, return_token_type_ids=True)
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(got[key], enc[key])


@pytest.mark.parametrize("name", ["llama-rebuilt", "gemma-rebuilt"])
def test_template_rebuilt_from_flags(tokenizer_dirs, name):
    """The file's template has the class defaults' tokens (bos only); the
    flags in ``tokenizer_config.json`` rebuild it, and the port follows
    them."""
    d = tokenizer_dirs[name]
    with open(os.path.join(d, "tokenizer.json"), encoding="utf-8") as f:
        single = json.load(f)["post_processor"]["single"]
    assert [part for part in single if "SpecialToken" in part][0]["SpecialToken"]["id"] in ("<s>", "<bos>")
    ref = transformers.AutoTokenizer.from_pretrained(d)
    ids = load_tokenizer(d).encode(["hello world"], ["again"])[0]
    assert ids == ref("hello world", "again")["input_ids"]
    assert ids[-1] == ref.eos_token_id and ids.count(ref.eos_token_id) == 2
    assert (ref.bos_token_id in ids) == (name == "gemma-rebuilt")


def test_byte_fallback_with_missing_bytes():
    """A character whose bytes all have ``<0xXX>`` tokens becomes them; one
    with a byte missing becomes the unknown token, fused with its
    neighbours; as the ``tokenizers`` library's BPE does."""
    missing = ("Ω".encode()[0], "Ж".encode()[-1])
    tok = sp_bpe_tokenizer(1, "llama", missing_bytes=missing)
    port = JsonTokenizer(json.loads(tok.to_str()))
    texts = TEXTS + ["ΩЖ罕", "xΩ ЖΩ罕罕 日本", "\x00\x01 é", "aΩ罕Жb"]
    assert [port.tokenize(t) for t in texts] == [tok.encode(t, add_special_tokens=False).ids for t in texts]
    vocab = tok.get_vocab()
    assert port.tokenize("ΩЖ").count(vocab["<unk>"]) == 1  # fused
    assert [vocab[f"<0x{b:02X}>"] for b in "罕".encode()] == port.tokenize("罕")[-3:]


def test_split_merged_with_previous():
    """Gemma's ``Split(" ", merged_with_previous)`` on text whose spaces the
    normalizer leaves: each space joins the word before it; a leading one,
    or one after another, stands alone."""
    vocab = {c: i for i, c in enumerate(sorted(set("".join(TEXTS)) | {"<unk>"}))}
    tok = Tokenizer(models.BPE(vocab, [], unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Split(" ", "merged_with_previous")
    port = JsonTokenizer(json.loads(tok.to_str()))
    for t in TEXTS + ["a  b    c      d", "    x", "y    ", " ", "   "]:
        assert [w for w, _ in port.pre_tokenize((t, True))] == [w for w, _ in tok.pre_tokenizer.pre_tokenize_str(t)], t
        assert port.tokenize(t) == tok.encode(t, add_special_tokens=False).ids, t


@pytest.mark.parametrize("split", [("  ", "isolated", False), (" ", "merged_with_previous", True),
                                   (" ", "removed", False), ("regex", "removed", False)])
def test_other_splits_are_refused(split):
    pattern, behavior, invert = split
    tok = sp_bpe_tokenizer(0, "gemma")
    tok.pre_tokenizer = pre_tokenizers.Split(Regex(r"\d+") if pattern == "regex" else pattern, behavior,
                                             invert=invert)
    with pytest.raises(NotImplementedError, match="Split"):
        JsonTokenizer(json.loads(tok.to_str()))


def test_add_prefix_space_is_refused(tmp_path):
    d = str(tmp_path)
    write_decoder_tokenizer(d, "llama", 0)
    path = os.path.join(d, "tokenizer_config.json")
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({**cfg, "add_prefix_space": False}, f)
    with pytest.raises(NotImplementedError, match="add_prefix_space"):
        load_tokenizer(d)
