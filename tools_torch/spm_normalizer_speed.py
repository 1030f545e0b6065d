#!/usr/bin/env python3
"""The host time of the sentencepiece tokenizers with and without the
normalizer's joined-text path (``SentencePieceEncoder.normalize``: where no
charsmap value or user-defined piece holds two spaces, the whitespace rules
act on the whole text and ASCII text maps through ``str.translate``; else
the chunk loop, ``_chunks`` / ``_whitespace``, one charsmap lookup a
character).

    python3 tools_torch/spm_normalizer_speed.py

On ``chip_smoke.py``'s phase-32 corpora and seeded files: GPT-SW3's
64,000-piece ``spiece.model`` over 4,096 docs of 8-48 words, and
opus-mt-en-de's 58,101-entry ``source.spm`` + ``vocab.json`` over 4,096
passages of 150-300 words.  Each tokenizer is loaded afresh (an empty word
memo, as an ingest starts) and ``encode`` is timed over the whole corpus,
in turns: joined, chunks, joined, chunks.  Prints microseconds a word,
checks the two paths give the same ids, and names the machine's card
where ``nvidia-smi`` reads one.  Host only: needs no GPU.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

from lotus_tpu_torch.models import load_tokenizer  # noqa: E402


def corpora(words: list[str], vocab: list[str]) -> dict:
    """(tokenizer files, texts) a model, as phases 32b and 32c make them."""
    sw3 = chip_smoke.spm_tokenizer_files(words, "gpt-sw3", 64_000)
    d = write(REPO / "build" / "spm_speed" / "gpt-sw3", sw3)
    pieces = load_tokenizer(str(d)).vocab
    whole = [w for w in words if "▁" + w in pieces]
    marian = chip_smoke.spm_tokenizer_files(words, "marian", 58_101)
    return {"gpt-sw3 (spiece.model)": (d, chip_smoke.synth_texts(whole, 4096, 8, 48, 341, per_topic=5)),
            "opus-mt-en-de (source.spm)": (write(REPO / "build" / "spm_speed" / "marian", marian),
                                           chip_smoke.synth_texts(vocab, 4096, 150, 300, 56, per_topic=chip_smoke.K))}


def write(path: Path, files: dict) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    for name, obj in files.items():
        if isinstance(obj, bytes):
            (path / name).write_bytes(obj)
        else:
            (path / name).write_text(json.dumps(obj), encoding="utf-8")
    return path


def timed(path: Path, texts: list[str], joined: bool) -> tuple[float, list[list[int]]]:
    tok = load_tokenizer(str(path))
    if not joined:
        tok.sp._joined_ok = False  # every text through the chunk loop
    t0 = time.perf_counter()
    ids = tok.encode(texts)
    return time.perf_counter() - t0, ids


def main() -> None:
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = ""
    print(f"host: {os.cpu_count()} CPUs; card: {card or 'none'}")
    vocab = chip_smoke.smoke_vocab()
    words = [w for w in vocab if w.isalpha() and not w.startswith("[")]
    for label, (path, texts) in corpora(words, vocab).items():
        n_words = sum(len(t.split()) for t in texts)
        got = {True: [], False: []}
        want = None
        for joined in (True, False, True, False):
            seconds, ids = timed(path, texts, joined)
            want = want or ids
            assert ids == want, f"{label}: the two paths disagree"
            got[joined].append(1e6 * seconds / n_words)
        print(f"{label}: {len(texts):,} texts, {n_words:,} words; us a word joined "
              f"{' / '.join(f'{t:.3f}' for t in got[True])}, chunk loop {' / '.join(f'{t:.3f}' for t in got[False])}")
    shutil.rmtree(REPO / "build" / "spm_speed", ignore_errors=True)


if __name__ == "__main__":
    main()
