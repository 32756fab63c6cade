"""Lexer for the `.bop` schema language (§5).

Token kinds: IDENT, NUMBER, STRING, BYTES, DOC (/// comments), RAWBLOCK
([[ ... ]] bodies for decorator validate/export), punctuation. `//` and
`/* */` comments are discarded (§5.3).  Files must be valid UTF-8 (§5.1).

Copied unchanged from the JAX package's ``core/lexer.py``: both
packages' compilers must accept and refuse the same text, with the same
messages.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .types import SchemaError


class LexError(SchemaError):
    pass


@dataclasses.dataclass
class Token:
    kind: str          # IDENT NUMBER STRING BYTES DOC RAWBLOCK PUNCT EOF
    value: object
    line: int
    col: int

    def __repr__(self):
        return f"{self.kind}({self.value!r})@{self.line}:{self.col}"


PUNCT = ("[[", "]]", "{", "}", "[", "]", "(", ")", ":", ";", "=", ",", ".",
         "@", "#", "!", "?")

KEYWORDS = frozenset({
    "edition", "package", "import", "enum", "struct", "message", "union",
    "service", "const", "mut", "local", "export", "stream", "with", "true",
    "false", "inf", "nan", "map",
})


def lex(src: str, *, filename: str = "<schema>") -> List[Token]:
    if isinstance(src, bytes):
        try:
            src = src.decode("utf-8")
        except UnicodeDecodeError as e:
            raise LexError(f"{filename}: not valid UTF-8: {e}") from None
    toks: List[Token] = []
    i, line, col = 0, 1, 1
    n = len(src)

    def err(msg: str):
        raise LexError(f"{filename}:{line}:{col}: {msg}")

    def advance(k: int = 1):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and src[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = src[i]
        # whitespace
        if c in " \t\r\n":
            advance()
            continue
        # comments
        if src.startswith("///", i):
            j = src.find("\n", i)
            j = n if j == -1 else j
            toks.append(Token("DOC", src[i + 3:j].strip(), line, col))
            advance(j - i)
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            advance((n if j == -1 else j) - i)
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j == -1:
                err("unterminated block comment")
            advance(j + 2 - i)
            continue
        # raw lua blocks
        if src.startswith("[[", i):
            j = src.find("]]", i + 2)
            if j == -1:
                err("unterminated [[ block")
            toks.append(Token("RAWBLOCK", src[i + 2:j], line, col))
            advance(j + 2 - i)
            continue
        # byte strings: b"..."
        if c == "b" and i + 1 < n and src[i + 1] in "\"'":
            start_line, start_col = line, col
            advance()
            s = _lex_string(src, i, err)
            toks.append(Token("BYTES", _unescape(s.body, err, binary=True),
                              start_line, start_col))
            advance(s.length)
            continue
        # strings
        if c in "\"'":
            start_line, start_col = line, col
            s = _lex_string(src, i, err)
            toks.append(Token("STRING", _unescape(s.body, err, binary=False),
                              start_line, start_col))
            advance(s.length)
            continue
        # numbers (incl. hex, scientific, leading -)
        if c.isdigit() or (c in "+-" and i + 1 < n
                           and (src[i + 1].isdigit() or src[i + 1] == ".")) \
                or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            start_line, start_col = line, col
            j = i
            if src[j] in "+-":
                j += 1
            if src.startswith("0x", j) or src.startswith("0X", j):
                j += 2
                while j < n and src[j] in "0123456789abcdefABCDEF_":
                    j += 1
                text = src[i:j]
                val = int(text.replace("_", ""), 16)
            else:
                while j < n and (src[j].isdigit() or src[j] in "._eE+-"):
                    # stop '+-' unless right after e/E
                    if src[j] in "+-" and src[j - 1] not in "eE":
                        break
                    j += 1
                text = src[i:j].replace("_", "")
                val = float(text) if any(ch in text for ch in ".eE") \
                    else int(text)
            toks.append(Token("NUMBER", val, start_line, start_col))
            advance(j - i)
            continue
        # negative inf: handled by parser via '-' + ident? keep simple: -inf
        if c == "-" and src.startswith("-inf", i):
            toks.append(Token("NUMBER", float("-inf"), line, col))
            advance(4)
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            if word == "inf":
                toks.append(Token("NUMBER", float("inf"), line, col))
            elif word == "nan":
                toks.append(Token("NUMBER", float("nan"), line, col))
            elif word in ("true", "false"):
                toks.append(Token("BOOLLIT", word == "true", line, col))
            else:
                toks.append(Token("IDENT", word, line, col))
            advance(j - i)
            continue
        # punctuation (longest match first)
        for p in PUNCT:
            if src.startswith(p, i):
                toks.append(Token("PUNCT", p, line, col))
                advance(len(p))
                break
        else:
            err(f"unexpected character {c!r}")
    toks.append(Token("EOF", None, line, col))
    return toks


@dataclasses.dataclass
class _Str:
    body: str
    length: int


def _lex_string(src: str, i: int, err) -> _Str:
    quote = src[i]
    j = i + 1
    n = len(src)
    out = []
    while j < n:
        c = src[j]
        if c == "\\":
            if j + 1 >= n:
                err("unterminated escape")
            out.append(src[j:j + 2])
            j += 2
            # \u{...} — consume to closing brace
            if out[-1] == "\\u" and j < n and src[j] == "{":
                k = src.find("}", j)
                if k == -1:
                    err("unterminated \\u{...}")
                out[-1] = src[j - 2:k + 1]
                j = k + 1
            continue
        if c == quote:
            # doubled quote = literal quote (§5.4)
            if j + 1 < n and src[j + 1] == quote:
                out.append(c)
                j += 2
                continue
            return _Str("".join(out), j + 1 - i)
        out.append(c)  # literal newlines allowed (§5.4)
        j += 1
    err("unterminated string")
    raise AssertionError


_SIMPLE_ESCAPES = {"\\\\": "\\", "\\n": "\n", "\\r": "\r", "\\t": "\t",
                   "\\0": "\0", '\\"': '"', "\\'": "'"}


def _unescape(body: str, err, *, binary: bool):
    out: List[str] = []
    i = 0
    n = len(body)
    while i < n:
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        # find which escape
        two = body[i:i + 2]
        if two in _SIMPLE_ESCAPES:
            out.append(_SIMPLE_ESCAPES[two])
            i += 2
            continue
        if two == "\\x" and binary:
            hexpart = body[i + 2:i + 4]
            out.append(chr(int(hexpart, 16)))
            i += 4
            continue
        if two == "\\u":
            if body[i + 2] != "{":
                err("\\u requires {...}")
            k = body.find("}", i)
            cp = int(body[i + 3:k], 16)
            out.append(chr(cp))
            i = k + 1
            continue
        err(f"unknown escape {two!r}")
    s = "".join(out)
    if binary:
        return s.encode("latin-1")
    return s
