"""C-family (Java / C#) declaration scanner — the port's copy of the JAX
package's ``frontend/cfamily.py``.

A token-level structural indexer for the two languages, producing the
same :class:`~semantic_merge_tpu_torch.frontend.scanner.DeclNode`
records the TypeScript frontend produces, so the downstream pipeline —
the device diff, lift, the device compose, conflicts, the applier — is
shared across languages. Plain Python on the port's own tokenizer: there
is no native scanner and no decl cache for these languages (nor in the
JAX package).

Indexing scheme (mirrors the TS scheme so cross-language behaviour is
uniform):

- Indexed kinds: type declarations (``class`` / ``interface`` /
  ``enum`` / ``record`` / ``struct`` / ``@interface``), methods and
  constructors, fields, and C# properties — at any nesting depth.
- ``addressId = <file>::<name>::<pos>`` with ``pos`` the declaration's
  full start (the end offset of the token preceding its first token,
  annotations/attributes/modifiers included) — the same ``node.pos``
  semantics as the TS frontend (reference ``workers/ts/src/sast.ts:66``).
- ``symbolId`` = first 16 hex of sha256 over a **name-free** structural
  signature: methods → ``fn(<paramTypes>)-><retType>``; constructors →
  ``ctor(<paramTypes>)``; classes → ``class{N}`` (N = direct member
  count); interfaces → ``iface{N}``; enums → ``enum{N}`` (constant
  count); records → ``record{N}`` (component count); structs →
  ``struct{N}``; fields → ``vars{N}`` (declarator count); properties →
  ``prop:<type>``. Same-shape declarations therefore collide exactly as
  they do in the TS frontend (last-wins map semantics downstream): every
  ``fn()->void`` and every one-declarator field of a snapshot shares one
  symbol id.

The tokenizer is shared with the TS frontend — Java/C# token structure
is close enough (strings, comments, operators); constructs the TS
tokenizer over-recognizes (regex/template literals) cannot appear in
valid Java/C# sources in positions that change declaration boundaries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..core.ids import symbol_id_from_signature
from .scanner import DeclNode, normalize_path
from .tokenizer import IDENT, NUMBER, STRING, Token, tokenize

KIND_TYPE = {
    "class": "ClassDeclaration",
    "interface": "InterfaceDeclaration",
    "enum": "EnumDeclaration",
    "record": "RecordDeclaration",
    "struct": "StructDeclaration",
}
KIND_METHOD = "MethodDeclaration"
KIND_CTOR = "ConstructorDeclaration"
KIND_FIELD = "FieldDeclaration"
KIND_PROPERTY = "PropertyDeclaration"

_SIG_PREFIX = {
    "ClassDeclaration": "class",
    "InterfaceDeclaration": "iface",
    "EnumDeclaration": "enum",
    "RecordDeclaration": "record",
    "StructDeclaration": "struct",
}


@dataclass(frozen=True)
class LanguageSpec:
    name: str
    extensions: frozenset
    type_keywords: frozenset          # keywords that open a type declaration
    modifiers: frozenset              # skipped when finding decl heads
    control_keywords: frozenset       # never method names
    has_properties: bool              # C# `T Name { get; set; }`
    namespace_keywords: frozenset     # bodies to recurse straight into


JAVA = LanguageSpec(
    name="java",
    extensions=frozenset({".java"}),
    type_keywords=frozenset({"class", "interface", "enum", "record"}),
    modifiers=frozenset({
        "public", "protected", "private", "static", "final", "abstract",
        "synchronized", "native", "strictfp", "transient", "volatile",
        "default", "sealed", "non-sealed",
    }),
    control_keywords=frozenset({
        "if", "while", "for", "switch", "catch", "return", "throw", "new",
        "do", "else", "try", "finally", "assert", "synchronized", "super",
        "this", "yield",
    }),
    has_properties=False,
    namespace_keywords=frozenset(),
)

CSHARP = LanguageSpec(
    name="cs",
    extensions=frozenset({".cs"}),
    type_keywords=frozenset({"class", "interface", "enum", "record", "struct"}),
    modifiers=frozenset({
        "public", "protected", "private", "internal", "static", "readonly",
        "sealed", "abstract", "virtual", "override", "async", "partial",
        "extern", "unsafe", "new", "volatile", "const", "required", "ref",
    }),
    control_keywords=frozenset({
        "if", "while", "for", "foreach", "switch", "catch", "return",
        "throw", "do", "else", "try", "finally", "using", "lock", "base",
        "this", "new", "nameof", "typeof", "default", "checked", "unchecked",
    }),
    has_properties=True,
    namespace_keywords=frozenset({"namespace"}),
)


def scan_snapshot_cfamily(files, spec: LanguageSpec) -> List[DeclNode]:
    """Index every file of a snapshot with the given language spec."""
    nodes: List[DeclNode] = []
    for f in files:
        nodes.extend(scan_file_cfamily(f["path"], f["content"], spec))
    return nodes


def scan_file_cfamily(path: str, content: str, spec: LanguageSpec) -> List[DeclNode]:
    toks = tokenize(content)
    nodes: List[DeclNode] = []
    _scan_region(normalize_path(path), toks, 0, len(toks), spec, None, nodes)
    return nodes


# ---------------------------------------------------------------------------
# region / body scanning


def _matching(toks: List[Token], i: int, open_t: str, close_t: str) -> int:
    """Index of the token closing the ``open_t`` at *i* (or last index)."""
    depth = 0
    n = len(toks)
    while i < n:
        if toks[i].text == open_t:
            depth += 1
        elif toks[i].text == close_t:
            depth -= 1
            if depth == 0:
                return i
        i += 1
    return n - 1


def _scan_region(path: str, toks: List[Token], lo: int, hi: int,
                 spec: LanguageSpec, enclosing: Optional[str],
                 nodes: List[DeclNode]) -> int:
    """Scan ``[lo, hi)`` for declarations; returns the member count of
    the region (the N of the enclosing type's signature)."""
    members = 0
    i = lo
    seg_start = lo  # first token of the current member/statement head
    while i < hi:
        t = toks[i]
        text = t.text
        if text in ("}", ")"):
            i += 1
            seg_start = i
            continue
        if t.type == IDENT and text in spec.namespace_keywords:
            # `namespace X { ... }` (or C# file-scoped `namespace X;`):
            # recurse straight into the body; namespaces are not indexed.
            j = i + 1
            while j < hi and toks[j].text not in ("{", ";"):
                j += 1
            if j < hi and toks[j].text == "{":
                close = _matching(toks, j, "{", "}")
                _scan_region(path, toks, j + 1, close, spec, None, nodes)
                i = close + 1
            else:
                i = j + 1
            seg_start = i
            continue
        if t.type == IDENT and text == "non" and i + 2 < hi \
                and toks[i + 1].text == "-" and toks[i + 2].text == "sealed":
            # Java `non-sealed` tokenizes as three tokens.
            i += 3
            continue
        if t.type == IDENT and text in spec.type_keywords and _is_type_decl(toks, i, hi):
            i = _scan_type_decl(path, toks, seg_start, i, hi, spec, nodes)
            members += 1
            seg_start = i
            continue
        if (text == "@" and i + 1 < hi and toks[i + 1].text == "interface"
                and i + 2 < hi and toks[i + 2].type == IDENT):
            # Java annotation type — indexed as an interface.
            i = _scan_type_decl(path, toks, seg_start, i + 1, hi, spec, nodes,
                                kind_override="InterfaceDeclaration")
            members += 1
            seg_start = i
            continue
        if t.type == IDENT and text in spec.modifiers:
            # Walk over decl modifiers token-wise so a following type
            # keyword is still seen; seg_start stays at the decl's first
            # token (full-start semantics).
            i += 1
            continue
        if text == "@" and i + 1 < hi and toks[i + 1].type == IDENT:
            # Annotation before a declaration head: @Foo, @a.b.Foo(...)
            i += 2
            while i + 1 < hi and toks[i].text == ".":
                i += 2
            if i < hi and toks[i].text == "(":
                i = _matching(toks, i, "(", ")") + 1
            continue
        if enclosing is not None:
            member, i = _scan_member(path, toks, seg_start, i, hi, spec, enclosing, nodes)
            if member is not None:
                nodes.append(member)
                members += 1
            seg_start = i
            continue
        # File/namespace scope, not a type decl head: skip the statement
        # (package/import/using directives, attributes, top-level code).
        if text == "{":
            i = _matching(toks, i, "{", "}") + 1
        elif text == "[" and spec.has_properties:
            i = _matching(toks, i, "[", "]") + 1  # C# attribute
        else:
            while i < hi and toks[i].text not in (";", "{"):
                i += 1
            if i < hi and toks[i].text == "{":
                continue  # let the block skip above handle it
            i += 1
        seg_start = i
    return members


def _is_type_decl(toks: List[Token], i: int, hi: int) -> bool:
    """``class``/``enum``/... followed by an identifier — and not used as
    an identifier itself (``record`` is contextual in both languages)."""
    if i + 1 >= hi or toks[i + 1].type != IDENT:
        return False
    if i > 0 and toks[i - 1].text in (".", "::", "?."):
        return False
    return True


def _full_start(toks: List[Token], seg_start: int) -> int:
    return toks[seg_start].prev_end if seg_start < len(toks) else 0


# ---------------------------------------------------------------------------
# type declarations


def _scan_type_decl(path: str, toks: List[Token], seg_start: int, i: int,
                    hi: int, spec: LanguageSpec, nodes: List[DeclNode],
                    kind_override: str | None = None) -> int:
    keyword = toks[i].text
    if keyword == "record" and i + 2 < hi and toks[i + 1].text in ("struct", "class") \
            and toks[i + 2].type == IDENT:
        # C# `record struct P` / `record class P` — name after both keywords.
        i += 1
    kind = kind_override or KIND_TYPE[keyword]
    name = toks[i + 1].text
    pos = _full_start(toks, seg_start)
    j = i + 2
    j = _skip_generics(toks, j, hi)
    record_components = None
    if j < hi and toks[j].text == "(":  # record header (Java / C# record)
        close = _matching(toks, j, "(", ")")
        record_components = _count_top_level_commas(toks, j + 1, close) if close > j + 1 else 0
        j = close + 1
    # extends / implements / permits / where / primary-ctor base — skip to body.
    while j < hi and toks[j].text not in ("{", ";"):
        j += 1
    end = toks[j].end if j < hi else (toks[hi - 1].end if hi else 0)
    body_members = 0
    if j < hi and toks[j].text == "{":
        close = _matching(toks, j, "{", "}")
        end = toks[close].end
        if kind == "EnumDeclaration":
            body_members = _scan_enum_body(path, toks, j, close, spec, name, nodes)
        else:
            body_members = _scan_region(path, toks, j + 1, close, spec, name, nodes)
        j = close + 1
    else:
        j = min(j + 1, hi)

    if kind == "EnumDeclaration":
        n = body_members  # constant count
    elif record_components is not None:
        n = record_components
    else:
        n = body_members
    sig = f"{_SIG_PREFIX[kind]}{{{n}}}"
    nodes.insert(_insert_at(nodes, pos, path), DeclNode(
        symbolId=symbol_id_from_signature(sig),
        addressId=f"{path}::{name}::{pos}",
        kind=kind, name=name, file=path, pos=pos,
        end=end, signature=sig,
    ))
    return j


def _insert_at(nodes: List[DeclNode], pos: int, path: str) -> int:
    """Document-order insertion point: parents list before their members,
    matching the TS frontend's pre-order listing. Members of this file
    scanned before the parent (the parent's record is built after its
    body) slot after it by position."""
    k = len(nodes)
    while k > 0 and nodes[k - 1].file == path and nodes[k - 1].pos > pos:
        k -= 1
    return k


def _scan_enum_body(path: str, toks: List[Token], i_open: int, i_close: int,
                    spec: LanguageSpec, name: str, nodes: List[DeclNode]) -> int:
    """Count the constants; index any members after the ``;``."""
    i = i_open + 1
    constants = 0
    expect_const = True
    while i < i_close:
        t = toks[i]
        if t.text == ";":
            _scan_region(path, toks, i + 1, i_close, spec, name, nodes)
            break
        if t.text == ",":
            expect_const = True
            i += 1
            continue
        if expect_const and t.type == IDENT:
            constants += 1
            expect_const = False
            i += 1
            continue
        if t.text == "(":
            i = _matching(toks, i, "(", ")") + 1
            continue
        if t.text == "{":  # constant body (Java) — skip
            i = _matching(toks, i, "{", "}") + 1
            continue
        if t.text == "=":  # C# explicit value — skip to , or ;
            while i < i_close and toks[i].text not in (",", ";"):
                i += 1
            continue
        i += 1
    return constants


# ---------------------------------------------------------------------------
# members (methods / constructors / fields / properties)


def _scan_member(path: str, toks: List[Token], seg_start: int, i: int, hi: int,
                 spec: LanguageSpec, enclosing: str,
                 nodes: List[DeclNode]) -> Tuple[Optional[DeclNode], int]:
    """Parse one member whose head starts at ``seg_start``; *i* is the
    current cursor (== seg_start on entry for a fresh member)."""
    # Skip leading annotations/attributes and modifiers to the head's
    # type-and-name part.
    j = seg_start
    j = _skip_decorations(toks, j, hi, spec)
    if j >= hi or toks[j].text in ("}", ";"):
        return None, min(j + 1, hi) if j < hi and toks[j].text == ";" else max(j, i + 1)
    if toks[j].text == "{":
        # Initializer block (static { ... } already had its modifier skipped).
        return None, _matching(toks, j, "{", "}") + 1
    # Walk to the decisive token at angle/bracket depth 0.
    head_start = j
    k = j
    angle = 0
    while k < hi:
        text = toks[k].text
        if text == "<":
            angle += 1
        elif text in (">", ">>", ">>>"):
            angle = max(0, angle - text.count(">"))
        elif angle == 0 and text in ("(", "=", ";", "{", "}", "=>"):
            break
        k += 1
    if k >= hi:
        return None, hi
    decisive = toks[k].text
    pos = _full_start(toks, seg_start)

    if decisive == "(":
        name_tok = toks[k - 1] if k - 1 >= head_start else None
        if (name_tok is None or name_tok.type != IDENT
                or name_tok.text in spec.control_keywords):
            # Not a member head (e.g. stray code) — skip the parens.
            return None, _matching(toks, k, "(", ")") + 1
        close = _matching(toks, k, "(", ")")
        params = _render_param_types(toks, k + 1, close, spec)
        ret = _render_type(toks, head_start, k - 1, spec)
        is_ctor = name_tok.text == enclosing and ret == ""
        # Skip throws-clause / where-clause / C# expression body to the
        # body or terminator.
        m = close + 1
        while m < hi and toks[m].text not in ("{", ";", "=>"):
            m += 1
        end = toks[close].end
        if m < hi and toks[m].text == "{":
            body_close = _matching(toks, m, "{", "}")
            end = toks[body_close].end
            m = body_close + 1
        elif m < hi and toks[m].text == "=>":
            while m < hi and toks[m].text != ";":
                m += 1
            end = toks[min(m, hi - 1)].end
            m += 1
        elif m < hi:
            end = toks[m].end
            m += 1
        if is_ctor:
            sig = f"ctor({params})"
            kind = KIND_CTOR
        else:
            sig = f"fn({params})->{ret or 'void'}"
            kind = KIND_METHOD
        return DeclNode(
            symbolId=symbol_id_from_signature(sig),
            addressId=f"{path}::{name_tok.text}::{pos}",
            kind=kind, name=name_tok.text, file=path, pos=pos,
            end=end, signature=sig,
        ), m

    if decisive == "{" and spec.has_properties:
        name_tok = toks[k - 1] if k - 1 > head_start else None
        if name_tok is not None and name_tok.type == IDENT:
            close = _matching(toks, k, "{", "}")
            ptype = _render_type(toks, head_start, k - 1, spec)
            m = close + 1
            # C# property initializer: `{ get; set; } = value;`
            if m < hi and toks[m].text == "=":
                while m < hi and toks[m].text != ";":
                    m += 1
                m += 1
            sig = f"prop:{ptype or 'var'}"
            return DeclNode(
                symbolId=symbol_id_from_signature(sig),
                addressId=f"{path}::{name_tok.text}::{pos}",
                kind=KIND_PROPERTY, name=name_tok.text, file=path, pos=pos,
                end=toks[close].end, signature=sig,
            ), m
        return None, _matching(toks, k, "{", "}") + 1
    if decisive == "{":
        return None, _matching(toks, k, "{", "}") + 1

    if decisive == "=>" and spec.has_properties:
        # C# expression-bodied property: `public int X => expr;`
        name_tok = toks[k - 1] if k - 1 > head_start else None
        if name_tok is not None and name_tok.type == IDENT:
            ptype = _render_type(toks, head_start, k - 1, spec)
            m = k
            while m < hi and toks[m].text != ";":
                if toks[m].text == "{":
                    m = _matching(toks, m, "{", "}")
                m += 1
            sig = f"prop:{ptype or 'var'}"
            return DeclNode(
                symbolId=symbol_id_from_signature(sig),
                addressId=f"{path}::{name_tok.text}::{pos}",
                kind=KIND_PROPERTY, name=name_tok.text, file=path, pos=pos,
                end=toks[min(m, hi - 1)].end, signature=sig,
            ), m + 1

    if decisive in ("=", ";"):
        # Field declaration: `<type> a = ..., b;` — count declarators.
        # Legacy array suffix (`int a[];`) puts brackets between the
        # name and the decisive token — but only *empty* `[]` pairs walk
        # back, so `arr[idx] = val;` stays a bare statement, not a field.
        name_at = k - 1
        while (name_at - 1 >= head_start and toks[name_at].text == "]"
               and toks[name_at - 1].text == "["):
            name_at -= 2
        name_tok = toks[name_at] if name_at >= head_start else None
        if name_tok is None or name_tok.type != IDENT or name_at == head_start:
            # No type+name pair — a bare statement; skip it.
            m = k
            while m < hi and toks[m].text != ";":
                if toks[m].text == "{":
                    m = _matching(toks, m, "{", "}")
                m += 1
            return None, m + 1
        count = 1
        m = k
        last_end = toks[k - 1].end
        while m < hi:
            text = toks[m].text
            if text in ("(", "[", "{"):
                m = _matching(toks, m, text, {"(": ")", "[": "]", "{": "}"}[text])
                last_end = toks[m].end
            elif text == ",":
                # A declarator comma is followed by `name` then
                # `=`/`,`/`;`/`[` — commas inside generic arguments
                # (`Map<String,Integer>`) fail this lookahead.
                if (m + 1 < hi and toks[m + 1].type == IDENT
                        and m + 2 < hi and toks[m + 2].text in ("=", ",", ";", "[")):
                    count += 1
            elif text == ";":
                last_end = toks[m].end
                break
            else:
                last_end = toks[m].end
            m += 1
        sig = f"vars{{{count}}}"
        return DeclNode(
            symbolId=symbol_id_from_signature(sig),
            addressId=f"{path}::{name_tok.text}::{pos}",
            kind=KIND_FIELD, name=name_tok.text, file=path, pos=pos,
            end=last_end, signature=sig,
        ), min(m + 1, hi)

    return None, k + 1


def _skip_decorations(toks: List[Token], j: int, hi: int,
                      spec: LanguageSpec) -> int:
    """Skip annotations (``@Foo``, ``@Foo(...)``), C# attributes
    (``[Foo]``), and modifier keywords before a member head."""
    while j < hi:
        t = toks[j]
        if t.text == "@" and j + 1 < hi and toks[j + 1].type == IDENT:
            j += 2
            while j < hi and toks[j].text == ".":
                j += 2
            if j < hi and toks[j].text == "(":
                j = _matching(toks, j, "(", ")") + 1
            continue
        if t.text == "[" and spec.has_properties:
            j = _matching(toks, j, "[", "]") + 1
            continue
        if t.type == IDENT and t.text in spec.modifiers:
            # `new` is a C# modifier only right before a member head —
            # but also an expression keyword; in head position both skip.
            j += 1
            continue
        if t.type == IDENT and t.text == "non" and j + 2 < hi \
                and toks[j + 1].text == "-" and toks[j + 2].text == "sealed":
            j += 3
            continue
        break
    return j


def _skip_generics(toks: List[Token], j: int, hi: int) -> int:
    if j < hi and toks[j].text == "<":
        depth = 0
        while j < hi:
            text = toks[j].text
            if text == "<":
                depth += 1
            elif text in (">", ">>", ">>>"):
                depth -= text.count(">")
                if depth <= 0:
                    return j + 1
            j += 1
    return j


def _count_top_level_commas(toks: List[Token], lo: int, hi: int) -> int:
    if lo >= hi:
        return 0
    depth = 0
    count = 1
    for m in range(lo, hi):
        text = toks[m].text
        if text in ("(", "[", "<", "{"):
            depth += 1
        elif text in (")", "]", "}", ">"):
            depth -= 1
        elif text == "," and depth == 0:
            count += 1
    return count


# ---------------------------------------------------------------------------
# signature rendering (name-free types)


def _render_type(toks: List[Token], lo: int, hi: int, spec: LanguageSpec) -> str:
    """Render tokens ``[lo, hi)`` as a canonical type string: modifier
    keywords dropped, single spaces only between adjacent word tokens."""
    parts: List[str] = []
    prev_word = False
    for m in range(lo, hi):
        t = toks[m]
        if t.type == IDENT and t.text in spec.modifiers:
            continue
        word = t.type in (IDENT, NUMBER, STRING)
        if word and prev_word:
            parts.append(" ")
        parts.append(t.text)
        prev_word = word
    return "".join(parts)


def _render_param_types(toks: List[Token], lo: int, hi: int,
                        spec: LanguageSpec) -> str:
    """Comma-joined parameter *types* (names stripped): each top-level
    comma segment renders without its final identifier. Varargs dots and
    array brackets stay; parameter annotations/attributes drop."""
    if lo >= hi:
        return ""
    segments: List[Tuple[int, int]] = []
    depth = 0
    start = lo
    for m in range(lo, hi):
        text = toks[m].text
        if text in ("(", "[", "<", "{"):
            depth += 1
        elif text in (")", "]", "}", ">"):
            depth -= 1
        elif text == "," and depth == 0:
            segments.append((start, m))
            start = m + 1
    segments.append((start, hi))

    rendered = []
    for s_lo, s_hi in segments:
        s_lo = _skip_decorations(toks, s_lo, s_hi, spec)
        # Default value `= expr` truncates the segment.
        cut = s_hi
        d = 0
        for m in range(s_lo, s_hi):
            text = toks[m].text
            if text in ("(", "[", "<", "{"):
                d += 1
            elif text in (")", "]", "}", ">"):
                d -= 1
            elif text == "=" and d == 0:
                cut = m
                break
        # The trailing identifier is the parameter name (legacy Java
        # array suffix `a[]` keeps the brackets with the type).
        name_idx = None
        trailing = cut
        while trailing - 1 >= s_lo and toks[trailing - 1].text in ("[", "]"):
            trailing -= 1
        if trailing - 1 >= s_lo and toks[trailing - 1].type == IDENT:
            prev = toks[trailing - 2] if trailing - 2 >= s_lo else None
            if prev is not None and (prev.type == IDENT or prev.text in
                                     (">", "]", "?", "...", "*")):
                name_idx = trailing - 1
        if name_idx is not None:
            body = _render_type(toks, s_lo, name_idx, spec)
            suffix = _render_type(toks, trailing, cut, spec) if trailing < cut else ""
            rendered.append(body + suffix)
        else:
            rendered.append(_render_type(toks, s_lo, cut, spec))
    return ",".join(r for r in rendered if r)
