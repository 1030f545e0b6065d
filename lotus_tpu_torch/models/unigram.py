"""The sentencepiece Unigram model, as the ``tokenizers`` library runs it
(``models.Unigram``: XLM-RoBERTa's tokenizer model).

A word (the ``Metaspace`` pre-tokenizer's, ``▁`` in front) is cut by Viterbi
over the pieces' log-probabilities: at each character boundary, left to
right, every piece that starts there, shortest first (a set of every
piece's prefixes ends the search early), offers the best score so far plus
its own, and a candidate replaces the node it reaches only when
it scores strictly higher, so the first of equal paths stays.  A position
where no one-character piece starts offers the unknown token at the
lowest piece score minus 10.  Walking back from the end, consecutive unknown
characters fuse into one token where ``fuse_unk`` (the library's default).
Each piece's id is its row in the vocabulary; a fused or unknown string the
vocabulary lacks is the unknown id.  A piece given as None keeps its row but
is never matched (sentencepiece's CONTROL, UNUSED and BYTE pieces).
"""

from __future__ import annotations

UNK_PENALTY = 10.0  # sentencepiece's kUnkPenalty


class Unigram:
    """The model over ``vocab``, a list of (piece, score) in id order; the
    unknown token scores ``min_score`` (the lowest piece score by default)
    minus 10."""

    def __init__(self, vocab: list[tuple[str | None, float]], unk_id: int | None = None, *,
                 byte_fallback: bool = False, fuse_unk: bool = True, min_score: float | None = None):
        if byte_fallback:
            raise NotImplementedError("Unigram byte_fallback: the port's Unigram has no byte fallback")
        if not vocab:
            raise ValueError("a Unigram model needs a vocabulary")
        self.ids = {piece: i for i, (piece, _) in enumerate(vocab) if piece is not None}
        self.scores = [float(score) for _, score in vocab]
        self.unk_id = unk_id
        self.fuse_unk = fuse_unk
        self.max_len = max(map(len, self.ids), default=1)
        self.unk_score = (min(self.scores) if min_score is None else min_score) - UNK_PENALTY
        self._prefixes: set[str] | None = None  # every prefix of every piece, made at first use

    def pieces(self, word: str) -> list[str]:
        """The best segmentation of ``word``, unknown runs fused."""
        n = len(word)
        ids, scores, unk = self.ids, self.scores, self.unk_id
        if self._prefixes is None:
            self._prefixes = {p[:i] for p in ids for i in range(1, len(p) + 1)}
        prefixes = self._prefixes
        best = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        node = [-1] * (n + 1)  # the id of the best piece ending here (unk_id for an unknown character)
        for s in range(n):
            here = best[s]
            single = False
            for end in range(s + 1, min(n, s + self.max_len) + 1):
                sub = word[s:end]
                if sub not in prefixes:  # no longer piece starts here either
                    break
                i = ids.get(sub)
                if i is None:
                    continue
                cand = here + scores[i]
                if start[end] < 0 or cand > best[end]:
                    best[end], start[end], node[end] = cand, s, i
                single = single or end == s + 1
            if not single:
                cand = here + self.unk_score
                if start[s + 1] < 0 or cand > best[s + 1]:
                    best[s + 1], start[s + 1], node[s + 1] = cand, s, unk
        out: list[str] = []
        run = ""  # unknown pieces being fused, walking back
        end = n
        while end > 0:
            s = start[end]
            if self.fuse_unk and unk is not None and node[end] == unk:
                run = word[s:end] + run
            else:
                if run:
                    out.append(run)
                    run = ""
                out.append(word[s:end])
            end = s
        if run:
            out.append(run)
        return out[::-1]

    def __call__(self, word: str) -> list[int]:
        """The ids of one pre-tokenized word."""
        got = []
        for piece in self.pieces(word):
            i = self.ids.get(piece, self.unk_id)
            if i is None:
                raise ValueError(f"{piece!r} is not in the vocabulary and the model has no unknown id")
            got.append(i)
        return got
