"""The ``Precompiled`` normalizer: sentencepiece's ``precompiled_charsmap``,
which XLM-RoBERTa's (and ALBERT's) ``tokenizer.json`` carries in base64.

The blob holds a 4-byte little-endian trie size, a darts-clone double array
of that many bytes (32-bit units over the UTF-8 bytes of the keys), and
the replacement strings, each ended by a NUL; a key's value is the offset
of its replacement.  Normalizing follows the ``tokenizers`` library: the
text is cut into extended grapheme clusters; a cluster shorter than 6 UTF-8
bytes is looked up whole, and the first key that is a prefix of its bytes
(the shortest) replaces the whole cluster; otherwise each of its characters
is looked up alone and kept where no key matches.  sentencepiece itself
(``sentencepiece.py``) takes the longest key at each position instead
(``Charsmap.longest``).

Grapheme clusters follow Unicode's UAX #29 rules (CR LF, controls, Hangul
syllable sequences, extending and spacing marks, ZWJ emoji sequences,
regional-indicator pairs) on properties read from ``unicodedata``'s general
categories, with Extended_Pictographic taken as the emoji blocks.  Every
ASCII character but a line feed after a carriage return begins a cluster,
so ASCII text is mapped through a table and only the non-ASCII runs (each
with the character before it) are clustered.  ``build_charsmap`` writes such a blob for a
small mapping (for tests and seeded checkpoints; real ones come from
sentencepiece).
"""

from __future__ import annotations

import re
import struct
import unicodedata

MAX_WHOLE_BYTES = 6  # a cluster this long or longer is looked up char by char
_NON_ASCII_RUN = re.compile(r"[^\x00-\x7f]+")

# Grapheme_Cluster_Break classes, as small ints.
OTHER, CR, LF, CONTROL, EXTEND, ZWJ, SPACING, RI, L, V, T, LV, LVT, PICT = range(14)


def _break_class(c: str) -> int:
    cp = ord(c)
    if cp == 0x0D:
        return CR
    if cp == 0x0A:
        return LF
    if cp == 0x200D:
        return ZWJ
    if cp == 0x200C or 0xFF9E <= cp <= 0xFF9F or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F:
        return EXTEND
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return RI
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return T
    if 0xAC00 <= cp <= 0xD7A3:
        return LV if (cp - 0xAC00) % 28 == 0 else LVT
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me"):
        return EXTEND
    if cat == "Mc":
        return SPACING
    if cat in ("Cc", "Zl", "Zp", "Cs") or (cat == "Cf" and not 0x0600 <= cp <= 0x0605):
        return CONTROL
    if (0x1F000 <= cp <= 0x1FAFF or 0x2600 <= cp <= 0x27BF or 0x2B00 <= cp <= 0x2BFF or 0x2190 <= cp <= 0x21FF
            or 0x2300 <= cp <= 0x23FF or cp in (0xA9, 0xAE, 0x203C, 0x2049, 0x2122, 0x2139, 0x3030, 0x303D)):
        return PICT
    return OTHER


def _joins(prev: int, cur: int, pict_zwj: bool, ri_odd: bool) -> bool:
    """Whether there is no grapheme break between a character of class
    ``prev`` and one of class ``cur``."""
    if prev == CR and cur == LF:
        return True
    if prev in (CR, LF, CONTROL) or cur in (CR, LF, CONTROL):
        return False
    if prev == L and cur in (L, V, LV, LVT):
        return True
    if prev in (LV, V) and cur in (V, T):
        return True
    if prev in (LVT, T) and cur == T:
        return True
    if cur in (EXTEND, ZWJ, SPACING):
        return True
    if prev == ZWJ and cur == PICT and pict_zwj:
        return True
    return prev == RI and cur == RI and ri_odd


def graphemes(text: str) -> list[str]:
    """``text`` cut into extended grapheme clusters."""
    out: list[str] = []
    begin = 0
    prev = -1
    pict = False  # within ExtPict Extend* (ZWJ)?
    ri_run = 0  # regional indicators in a row
    for i, c in enumerate(text):
        cur = _break_class(c)
        if i and not _joins(prev, cur, pict and prev == ZWJ, ri_run % 2 == 1):
            out.append(text[begin:i])
            begin = i
        if cur == PICT:
            pict = True
        elif not (pict and cur in (EXTEND, ZWJ)):
            pict = False
        ri_run = ri_run + 1 if cur == RI else 0
        prev = cur
    if begin < len(text):
        out.append(text[begin:])
    return out


class Charsmap:
    """A ``precompiled_charsmap`` blob, ready to normalize text."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError(f"a precompiled charsmap of {len(blob)} bytes has no trie size")
        (size,) = struct.unpack_from("<I", blob)
        if size % 4 or 4 + size > len(blob):
            raise ValueError(f"a precompiled charsmap of {len(blob)} bytes cannot hold a {size}-byte trie")
        self.units = list(struct.unpack_from(f"<{size // 4}I", blob, 4))
        self.strings = blob[4 + size :]
        self._memo: dict[str, str] = {}
        self._ascii = {c: got for c in range(1, 128) if (got := self._lookup(chr(c))) is not None}

    def _lookup(self, key: str) -> str | None:
        """The replacement of the shortest key that is a prefix of ``key``'s
        UTF-8 bytes (darts-clone's common-prefix search), else None."""
        units = self.units
        unit = units[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for byte in key.encode("utf-8"):
            if byte == 0:
                return None
            pos ^= byte
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != byte:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                return self._value(units[pos] & ((1 << 31) - 1))
        return None

    def _value(self, at: int) -> str:
        end = self.strings.find(b"\0", at)
        return self.strings[at : end if end >= 0 else len(self.strings)].decode("utf-8")

    def longest(self, text: str, at: int) -> tuple[int, str] | None:
        """sentencepiece's lookup (``normalizer.cc``, ``NormalizePrefix``):
        the longest key that is a prefix of ``text[at:]``, as (its length in
        characters, its replacement), else None."""
        units = self.units
        unit = units[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        found = None
        for k in range(at, len(text)):
            for byte in text[k].encode("utf-8"):
                pos ^= byte
                if byte == 0 or pos >= len(units):
                    return found
                unit = units[pos]
                if unit & ((1 << 31) | 0xFF) != byte:
                    return found
                pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                found = (k - at + 1, self._value(units[pos] & ((1 << 31) - 1)))
        return found

    def ascii_table(self) -> dict[int, str] | None:
        """The replacement of each ASCII character as ``longest`` finds it,
        for ``str.translate``, where no key of two or more characters begins
        with two ASCII characters (so ASCII text maps character by
        character); else None."""
        units = self.units
        table = {}
        for c in range(1, 128):
            got = self.longest(chr(c), 0)
            if got is not None:
                table[c] = got[1]
            unit = units[0]
            pos = (unit >> 10) << ((unit & (1 << 9)) >> 6) ^ c
            if pos >= len(units) or units[pos] & ((1 << 31) | 0xFF) != c:
                continue
            base = pos ^ ((units[pos] >> 10) << ((units[pos] & (1 << 9)) >> 6))
            if any(base ^ b < len(units) and units[base ^ b] & ((1 << 31) | 0xFF) == b for b in range(1, 128)):
                return None
        return table

    def _cluster(self, g: str) -> str:
        got = self._memo.get(g)
        if got is None:
            whole = self._lookup(g) if len(g.encode("utf-8")) < MAX_WHOLE_BYTES else None
            got = whole if whole is not None else "".join(
                c if (r := self._lookup(c)) is None else r for c in g)
            self._memo[g] = got
        return got

    def normalize(self, text: str) -> str:
        if "\r" in text:
            return "".join(map(self._cluster, graphemes(text)))
        if text.isascii():
            return text.translate(self._ascii)
        # Every ASCII character but LF after CR begins a cluster, so only the
        # non-ASCII runs, each with the character before it, need clustering.
        out, done = [], 0
        for m in _NON_ASCII_RUN.finditer(text):
            start = m.start() - 1 if m.start() > done else m.start()
            out += [text[done:start].translate(self._ascii), *map(self._cluster, graphemes(text[start : m.end()]))]
            done = m.end()
        out.append(text[done:].translate(self._ascii))
        return "".join(out)


def build_charsmap(mapping: dict[str, str]) -> bytes:
    """A ``precompiled_charsmap`` blob for ``mapping`` (key -> replacement):
    the trie size, a darts-clone double array over the keys' UTF-8 bytes,
    each node's children in a fresh 256-unit block (a unit holds its label,
    its has-leaf bit and the offset to its block; the leaf unit, at the
    block's base, holds the value with bit 31 set), and the NUL-ended
    replacements the values point at."""
    strings = bytearray()
    root: dict = {}
    for key, value in sorted(mapping.items()):
        node = root
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = len(strings)
        strings += value.encode("utf-8") + b"\0"
    units = [0] * 256

    def place(node: dict, pos: int) -> None:
        base = len(units)
        units.extend([0] * 256)
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("the mapping is too large for this builder's unextended offsets")
        units[pos] |= (offset << 10) | ((None in node) << 8)
        if None in node:
            units[base] = (1 << 31) | node[None]
        for b, child in node.items():
            if b is not None:
                units[base ^ b] = b
                place(child, base ^ b)

    place(root, 0)
    return struct.pack(f"<I{len(units)}I", 4 * len(units), *units) + bytes(strings)
