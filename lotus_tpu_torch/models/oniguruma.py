"""The regular expressions of ``tokenizer.json`` files, read as the
``tokenizers`` library's engine (Oniguruma, Ruby syntax) reads them and
written for Python's ``re``, with no ``regex`` package.

The two engines read some patterns differently, and Python refuses some
that Oniguruma takes.  ``translate`` parses the subset these files use and
rewrites what differs:

- a class nested in a class is a union in Oniguruma (BLOOM's
  ``[^(\\s|[.,!?…])]`` is "not ``(``, white space, ``|``, ``.``, ..., or
  ``)``"), which Python cannot parse: the nested class is flattened into
  its parent;
- ``\\s`` is Unicode's White_Space (``bpe.WHITE_SPACE``), so U+001C-U+001F
  are not white space, as they are for Python's ``\\s``; ``\\S`` is its
  complement;
- ``(``, ``)``, ``|`` and ``[`` inside a class are literal in Oniguruma and
  are escaped for Python.

What it reads: literal characters and escaped punctuation, ``\\t`` ``\\n``
``\\r`` ``\\f`` ``\\v`` ``\\a`` ``\\e``, ``\\xHH``, ``\\x{H...}``, ``\\uHHHH``,
``.``, ``\\s`` / ``\\S``, classes (negated, with ranges and nested
classes), groups ``(...)`` / ``(?:...)``, lookahead ``(?=...)`` /
``(?!...)``, alternation and the greedy or lazy quantifiers ``*``, ``+``,
``?``, ``{n}``, ``{n,}``, ``{,m}``, ``{n,m}``.  Anything else (anchors, whose
Ruby meaning is per line; ``\\d``, ``\\w``, ``\\p{..}``, ``\\b`` and the other
classes and assertions, whose Unicode sets differ between the engines;
lookbehind, backreferences, named groups, inline options, possessive
quantifiers, class intersection, POSIX brackets) raises
``NotImplementedError`` naming the construct.  A pattern that can match
the empty string is refused too: the engines step past an empty match
differently, so the pieces would differ.
"""

from __future__ import annotations

import re

from lotus_tpu_torch.models.bpe import WHITE_SPACE

_CONTROL = {"t": "\t", "n": "\n", "r": "\r", "f": "\f", "v": "\v", "a": "\a", "e": "\x1b"}
_CLASS_SPECIAL = set("\\]^-[")  # escaped inside a Python class
_QUANTIFIER = re.compile(r"\{(\d*)(,?)(\d*)\}")
_HEX = re.compile(r"x\{([0-9a-fA-F]{1,8})\}|x([0-9a-fA-F]{1,2})")
_UNICODE = re.compile(r"u([0-9a-fA-F]{4})")


class _Parser:
    """A recursive-descent reader of one pattern: each ``parse_*`` returns
    the Python text of what it read and whether it can match the empty
    string."""

    def __init__(self, pattern: str):
        self.src = pattern
        self.at = 0

    def refuse(self, what: str):
        raise NotImplementedError(f"regex {self.src!r}: {what} at position {self.at} is not translated to Python's "
                                  f"re (the port reads literals, classes, groups, lookahead, alternation and "
                                  f"quantifiers, \\s and \\S)")

    def peek(self, n: int = 1) -> str:
        return self.src[self.at : self.at + n]

    def parse_alternation(self) -> tuple[str, bool]:
        branches = [self.parse_sequence()]
        while self.peek() == "|":
            self.at += 1
            branches.append(self.parse_sequence())
        return "|".join(b for b, _ in branches), any(e for _, e in branches)

    def parse_sequence(self) -> tuple[str, bool]:
        out, empty = [], True
        while self.at < len(self.src) and self.peek() not in "|)":
            atom, atom_empty = self.parse_quantified()
            out.append(atom)
            empty = empty and atom_empty
        return "".join(out), empty

    def parse_quantified(self) -> tuple[str, bool]:
        atom, empty = self.parse_atom()
        c = self.peek()
        if c in ("*", "+", "?"):
            self.at += 1
            quant, low = c, 0 if c != "+" else 1
        elif c == "{" and (m := _QUANTIFIER.match(self.src, self.at)) and (m.group(1) or m.group(3)):
            self.at = m.end()
            quant, low = m.group(), int(m.group(1) or 0)
        else:
            return atom, empty
        if self.peek() == "+":
            self.refuse("a possessive quantifier")
        if self.peek() == "?":  # lazy
            self.at += 1
            quant += "?"
        return atom + quant, empty or low == 0

    def parse_escape(self) -> str | None:
        """The character of an escape that stands for one (the backslash
        read), else None with the position left on the escaped letter."""
        c = self.peek()
        if not c:
            self.refuse("a trailing backslash")
        if c in _CONTROL:
            self.at += 1
            return _CONTROL[c]
        if c == "x":
            m = _HEX.match(self.src, self.at)
            if m is None:
                self.refuse("a malformed \\x escape")
            self.at = m.end()
            return chr(int(m.group(1) or m.group(2), 16))
        if c == "u":
            m = _UNICODE.match(self.src, self.at)
            if m is None:
                self.refuse("a malformed \\u escape")
            self.at = m.end()
            return chr(int(m.group(1), 16))
        if not c.isalnum():
            self.at += 1
            return c
        return None

    def parse_atom(self) -> tuple[str, bool]:
        c = self.peek()
        if c == "(":
            return self.parse_group()
        if c == "[":
            self.at += 1
            body, negated = self.parse_class()
            return f"[{'^' if negated else ''}{body}]", False
        if c == ".":
            self.at += 1
            return ".", False
        if c == "\\":
            self.at += 1
            ch = self.parse_escape()
            if ch is not None:
                return re.escape(ch), False
            letter = self.peek()
            if letter in ("s", "S"):
                self.at += 1
                return f"[{'^' if letter == 'S' else ''}{WHITE_SPACE}]", False
            self.refuse(f"the escape \\{letter}")
        if c in ("^", "$"):
            self.refuse(f"the anchor {c!r} (per line in Oniguruma's Ruby syntax)")
        if c in ("*", "+", "?", "{"):
            self.refuse(f"a quantifier {c!r} with nothing to repeat")
        self.at += 1
        return re.escape(c), False

    def parse_group(self) -> tuple[str, bool]:
        self.at += 1
        if self.peek() == "?":
            kind = self.peek(2)
            if kind not in ("?:", "?=", "?!"):
                self.refuse(f"the group '({self.peek(3)}'")
            self.at += 2
            body, empty = self.parse_alternation()
            head = "(" + kind
            empty = empty or kind != "?:"  # a lookahead matches no characters
        else:
            body, empty = self.parse_alternation()
            head = "("
        if self.peek() != ")":
            self.refuse("an unclosed group")
        self.at += 1
        return f"{head}{body})", empty

    def class_char(self) -> str | None:
        """One character of a class (a literal or a one-character escape),
        or None where the next item is not one."""
        c = self.peek()
        if c == "\\":
            self.at += 1
            ch = self.parse_escape()
            if ch is None:
                self.at -= 1
            return ch
        if c in ("", "[", "]"):
            return None
        if c == "&" and self.peek(2) == "&":
            self.refuse("class intersection '&&'")
        self.at += 1
        return c

    def parse_class(self) -> tuple[str, bool]:
        """A class body after its ``[``, through its ``]``: the Python class
        body (nested classes flattened into it) and whether it is negated."""
        negated = self.peek() == "^"
        if negated:
            self.at += 1
        if self.peek() == "]":
            self.refuse("a class that opens with ']'")
        parts = []
        while True:
            c = self.peek()
            if not c:
                self.refuse("an unclosed class")
            if c == "]":
                self.at += 1
                return "".join(parts), negated
            if c == "[":
                if self.peek(2) == "[:":
                    self.refuse("a POSIX bracket")
                self.at += 1
                inner, inner_negated = self.parse_class()
                if inner_negated:
                    self.refuse("a negated class inside a class")
                parts.append(inner)
                continue
            if c == "\\" and self.peek(2) in ("\\s", "\\S"):
                if self.peek(2) == "\\S":
                    self.refuse("\\S inside a class")
                self.at += 2
                parts.append(WHITE_SPACE)
                continue
            lo = self.class_char()
            if lo is None:
                self.refuse(f"the class item {self.peek(2)!r}")
            if self.peek() == "-" and self.peek(2) != "-]" and len(self.peek(2)) == 2:
                self.at += 1
                hi = self.class_char()
                if hi is None:
                    self.refuse("a range whose end is not one character")
                if ord(hi) < ord(lo):
                    self.refuse(f"the empty range {lo!r}-{hi!r}")
                parts.append(f"{_class_escape(lo)}-{_class_escape(hi)}")
            else:
                parts.append(_class_escape(lo))


def _class_escape(ch: str) -> str:
    return "\\" + ch if ch in _CLASS_SPECIAL else ch


def translate(pattern: str) -> str:
    """The Python ``re`` pattern that matches what Oniguruma matches for
    ``pattern`` (see the module's docstring); raises
    ``NotImplementedError`` for what it does not translate."""
    parser = _Parser(pattern)
    out, empty = parser.parse_alternation()
    if parser.at != len(pattern):
        parser.refuse("an unbalanced ')'")
    if empty:
        raise NotImplementedError(f"regex {pattern!r} can match the empty string: Oniguruma and Python's re step "
                                  f"past an empty match differently, so the port does not translate it")
    return out
