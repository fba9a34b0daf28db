"""A compact TypeScript/JavaScript tokenizer.

The declaration scanner (:mod:`semantic_merge_tpu_torch.frontend.scanner`) only
needs token boundaries, not a full grammar: identifiers/keywords,
numbers, string/template/regex literals, and punctuation, each with
source offsets. Comments and whitespace are skipped but two pieces of
trivia metadata are kept because the indexing semantics depend on them:

- ``prev_end``: the end offset of the previous token. The reference
  addresses declarations by their *full start* — the TS parser's
  ``node.pos``, which equals the end of the preceding token (leading
  trivia belongs to the node; reference ``workers/ts/src/sast.ts:66``
  embeds ``n.pos`` into the addressId). Tracking ``prev_end`` lets the
  scanner reproduce that offset exactly.
- ``nl_before``: whether a line terminator precedes the token, needed
  for the scanner's ASI heuristics when counting members.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

# Longest-match-first operator table. Only boundaries matter to the
# scanner, but multi-char operators must not be split (``=>`` vs ``=``,
# ``...`` vs ``.``), and ``/`` needs regex disambiguation.
_OPERATORS = [
    ">>>=", "...", "===", "!==", "**=", "<<=", ">>=", ">>>", "&&=", "||=", "??=",
    "=>", "==", "!=", "<=", ">=", "&&", "||", "??", "?.", "++", "--", "+=", "-=",
    "*=", "/=", "%=", "&=", "|=", "^=", "<<", ">>", "**",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/", "%",
    "&", "|", "^", "!", "~", "?", ":", "=", ".", "@", "#",
]

IDENT = "ident"
NUMBER = "number"
STRING = "string"
TEMPLATE = "template"
REGEX = "regex"
PUNCT = "punct"

# After these identifier-like tokens a ``/`` begins a regex literal, not
# a division (they end a statement/expression context, not an operand).
_REGEX_ALLOWED_KEYWORDS = {
    "return", "typeof", "instanceof", "in", "of", "new", "delete", "void",
    "throw", "case", "do", "else", "yield", "await",
}

_IDENT_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_$")
_IDENT_PART = _IDENT_START | set("0123456789")


@dataclass
class Token:
    type: str
    text: str
    start: int
    end: int
    prev_end: int
    nl_before: bool


class TokenizeError(ValueError):
    pass


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    i = 0
    n = len(text)
    prev_end = 0
    nl_before = False
    while i < n:
        c = text[i]
        if c in " \t\r\f\v":
            i += 1
            continue
        if c == "\n":
            nl_before = True
            i += 1
            continue
        if c == "/" and i + 1 < n:
            if text[i + 1] == "/":
                j = text.find("\n", i)
                i = n if j < 0 else j
                continue
            if text[i + 1] == "*":
                j = text.find("*/", i + 2)
                if j < 0:
                    i = n
                    continue
                if "\n" in text[i:j]:
                    nl_before = True
                i = j + 2
                continue
        start = i
        if c in _IDENT_START:
            while i < n and text[i] in _IDENT_PART:
                i += 1
            tok = Token(IDENT, text[start:i], start, i, prev_end, nl_before)
        elif c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            while i < n and (text[i].isalnum() or text[i] in "._"):
                i += 1
            tok = Token(NUMBER, text[start:i], start, i, prev_end, nl_before)
        elif c in "'\"":
            i = _scan_string(text, i, c)
            tok = Token(STRING, text[start:i], start, i, prev_end, nl_before)
        elif c == "`":
            i = _scan_template(text, i)
            tok = Token(TEMPLATE, text[start:i], start, i, prev_end, nl_before)
        elif c == "/" and _regex_allowed(toks):
            i = _scan_regex(text, i)
            tok = Token(REGEX, text[start:i], start, i, prev_end, nl_before)
        else:
            op = _match_operator(text, i)
            if op is None:
                # Unknown byte (e.g. stray unicode): skip it rather than fail;
                # the scanner only needs declaration-shaped structure.
                i += 1
                continue
            i += len(op)
            tok = Token(PUNCT, op, start, i, prev_end, nl_before)
        toks.append(tok)
        prev_end = tok.end
        nl_before = False
    return toks


def _match_operator(text: str, i: int) -> str | None:
    for op in _OPERATORS:
        if text.startswith(op, i):
            return op
    return None


def _regex_allowed(toks: List[Token]) -> bool:
    if not toks:
        return True
    prev = toks[-1]
    if prev.type in (NUMBER, STRING, TEMPLATE, REGEX):
        return False
    if prev.type == IDENT:
        return prev.text in _REGEX_ALLOWED_KEYWORDS
    return prev.text not in (")", "]", "}", "++", "--")


def _scan_string(text: str, i: int, quote: str) -> int:
    n = len(text)
    i += 1
    while i < n:
        c = text[i]
        if c == "\\":
            i += 2
            continue
        if c == quote or c == "\n":
            return i + 1
        i += 1
    return n


def _scan_regex(text: str, i: int) -> int:
    n = len(text)
    i += 1
    in_class = False
    while i < n:
        c = text[i]
        if c == "\\":
            i += 2
            continue
        if c == "[":
            in_class = True
        elif c == "]":
            in_class = False
        elif c == "/" and not in_class:
            i += 1
            while i < n and text[i] in _IDENT_PART:
                i += 1
            return i
        elif c == "\n":
            return i
        i += 1
    return n


def _scan_template(text: str, i: int) -> int:
    """Scan a template literal starting at the backtick; returns the end
    offset. Substitutions ``${...}`` may nest strings, templates, and
    braces arbitrarily."""
    n = len(text)
    i += 1
    while i < n:
        c = text[i]
        if c == "\\":
            i += 2
            continue
        if c == "`":
            return i + 1
        if c == "$" and i + 1 < n and text[i + 1] == "{":
            i = _scan_substitution(text, i + 2)
            continue
        i += 1
    return n


def _scan_substitution(text: str, i: int) -> int:
    n = len(text)
    depth = 1
    while i < n:
        c = text[i]
        if c == "\\":
            i += 2
            continue
        if c in "'\"":
            i = _scan_string(text, i, c)
            continue
        if c == "`":
            i = _scan_template(text, i)
            continue
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    return n
