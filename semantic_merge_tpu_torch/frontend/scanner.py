"""TypeScript/JavaScript declaration scanner (parse + index).

The JAX package's ``frontend/scanner.py``: :func:`scan_snapshot_py`,
the pure-Python scan and semantic oracle, and :func:`scan_snapshot` /
:func:`scan_snapshot_keyed`, which scan with the C++ library
(:mod:`semantic_merge_tpu_torch.frontend.native`) through the per-file
decl cache (:mod:`semantic_merge_tpu_torch.frontend.declcache`). Node
lists are identical by construction.

This replaces the reference's Node.js worker parse/index stage
(reference ``workers/ts/src/sast.ts``) with a dependency-free host
implementation. Indexing semantics reproduced:

- The five indexed declaration kinds, found at *any* nesting depth
  (the reference walks every AST child recursively, reference
  ``workers/ts/src/sast.ts:44-60``): ``FunctionDeclaration``,
  ``ClassDeclaration``, ``InterfaceDeclaration``, ``EnumDeclaration``,
  ``VariableStatement``.
- Pre-order listing: declarations appear in document order of their
  first token, parents before nested children.
- ``addressId = <file>::<name|anon>::<pos>`` where ``pos`` is the
  declaration's *full start* — the end offset of the token preceding
  the declaration's first token (modifiers included), matching the TS
  parser's ``node.pos`` (reference ``workers/ts/src/sast.ts:65-67``).
- ``symbolId`` = first 16 hex chars of sha256 over a name-free
  structural signature (reference ``workers/ts/src/sast.ts:73-96``):
  functions → ``fn(<paramTypes>)-><retType>``; classes → ``class{N}``;
  interfaces → ``iface{N}``; enums → ``enum{N}``; variable statements
  → ``vars{N}``.
- Function expressions / class expressions / arrow functions are *not*
  indexed (they are not declaration statements), and ``var/let/const``
  inside ``for (...)`` heads are not VariableStatements.

Type-annotation rendering emulates ``checker.typeToString`` as the
reference configures it: the in-memory compiler host loads **no
default library** (``readFile`` returns ``""`` for anything outside the
snapshot, reference ``workers/ts/src/sast.ts:19-22``), so identifiers
that do not resolve to a type declared *in the snapshot* display as
``any``; annotated primitives display as written; ``T[]`` renders the
element type; unions/intersections are spaced ``A | B`` / ``A & B``.
Missing annotations are ``any`` (reference ``workers/ts/src/sast.ts:78,82``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Hashable, List, Sequence

from ..core.ids import symbol_id_from_signature
from .tokenizer import IDENT, PUNCT, Token, tokenize

if TYPE_CHECKING:
    from .declcache import DeclCache

KIND_FUNCTION = "FunctionDeclaration"
KIND_CLASS = "ClassDeclaration"
KIND_INTERFACE = "InterfaceDeclaration"
KIND_ENUM = "EnumDeclaration"
KIND_VARS = "VariableStatement"

# Tokens after which ``function``/``class`` begin an *expression*, not a
# declaration statement.
_EXPRESSION_PREV = {
    "=", "(", "[", ",", ":", "?", "!", "&", "|", "+", "-", "*", "/", "%",
    "<", ">", "=>", "==", "===", "!=", "!==", "&&", "||", "??", "...",
    "+=", "-=", "*=", "/=", "??=", "&&=", "||=", ".", "?.",
}
_EXPRESSION_PREV_IDENTS = {
    "return", "typeof", "new", "delete", "void", "in", "of", "instanceof",
    "yield", "await", "case", "do", "throw", "extends", "default",
}

_DECL_MODIFIERS = {"export", "default", "declare", "async", "abstract", "public", "private", "protected"}

_PRIMITIVE_TYPES = {
    "string", "number", "boolean", "any", "unknown", "never", "void", "object",
    "undefined", "null", "bigint", "symbol", "this", "true", "false",
}


@dataclass(slots=True)
class DeclNode:
    """One indexed declaration — the unit the differ joins on.

    Mirrors the reference's ``NodeInfo`` record
    (reference ``workers/ts/src/sast.ts:4-10``).
    """

    symbolId: str
    addressId: str
    kind: str
    name: str | None
    file: str
    pos: int
    end: int
    signature: str

    def to_dict(self) -> dict:
        return {
            "symbolId": self.symbolId,
            "addressId": self.addressId,
            "kind": self.kind,
            "name": self.name,
            "range": {"file": self.file, "start": self.pos, "end": self.end},
        }


def normalize_path(p: str) -> str:
    """Path normalization, identical to the reference's
    (reference ``workers/ts/src/sast.ts:98-100``)."""
    p = p.replace("\\", "/")
    if p.startswith("./"):
        p = p[2:]
    if p.startswith("/"):
        p = p[1:]
    return p


@dataclass
class ScanStats:
    """What the scans of one call did: the files whose decl nodes the
    C++ library and the Python scanner produced, and the decl cache's
    hits and misses (types and decls lookups alike)."""

    native_files: int = 0
    python_files: int = 0
    hits: int = 0
    misses: int = 0

    @property
    def scanner(self) -> str:
        """``"native"``, ``"python"``, both joined by ``+``, or
        ``"cache"`` when every file came from the cache."""
        ran = [name for name, n in (("native", self.native_files),
                                    ("python", self.python_files)) if n]
        return "+".join(ran) or "cache"


def scan_snapshot(files: Sequence[dict], **kwargs) -> List[DeclNode]:
    """Index every file of a snapshot (``[{path, content}, ...]``):
    :func:`scan_snapshot_keyed`'s nodes, flattened in file order."""
    return [n for _, nodes in scan_snapshot_keyed(files, **kwargs) for n in nodes]


def scan_snapshot_keyed(files: Sequence[dict], *, cache: DeclCache | None = None,
                        native: bool = True, stats: ScanStats | None = None
                        ) -> List[tuple[Hashable, List[DeclNode]]]:
    """The snapshot's decl nodes grouped per file, each group tagged
    with its decl-cache key ``("decls", path, content-hash,
    declared-set-hash)``.

    Two passes, as :func:`scan_snapshot_py`: the type names declared
    anywhere in the snapshot, then each file against that set, both
    through ``cache`` (a
    :class:`~semantic_merge_tpu_torch.frontend.declcache.DeclCache`;
    ``None`` is the process-wide one). With ``native`` the C++ library
    scans every file the cache misses, unless the snapshot is not
    ASCII-safe; without it the Python scanner does. ``stats`` collects
    what ran. A failure is a
    :class:`~semantic_merge_tpu_torch.errors.ParseFault`, a native
    library that cannot be built included (a
    :class:`~semantic_merge_tpu_torch.errors.NativeBuildFault`), and so
    is what the ``scan`` fault-injection stage raises."""
    from ..errors import ParseFault
    from ..utils import faults
    from .declcache import global_cache
    cache = global_cache() if cache is None else cache
    stats = stats if stats is not None else ScanStats()
    hits0, misses0 = cache.hits, cache.misses
    try:
        faults.check("scan")
        keyed = _scan_snapshot_cached(files, cache, native, stats)
    except ParseFault:
        raise
    except Exception as exc:
        raise ParseFault(f"snapshot scan failed: {exc}", stage="scan",
                         cause=type(exc).__name__) from exc
    stats.hits += cache.hits - hits0
    stats.misses += cache.misses - misses0
    return keyed


# A file path that cannot collide with real snapshot paths carries the
# synthetic type declarations when a cache-miss subset scans natively
# (its nodes are filtered out of the result).
_SYNTH_PATH = "__semmerge_synthetic_decls__.d.ts"


def _scan_snapshot_cached(files: Sequence[dict], cache, native: bool, stats: ScanStats
                          ) -> List[tuple[Hashable, List[DeclNode]]]:
    from . import native as native_lib
    from .declcache import content_hash, declared_hash

    # Pass 1: the global declared-type-name set, from per-file cached
    # name sets (key: the content hash alone; names do not depend on
    # other files). Misses go through the native tokenizer in one batch.
    hashes: List[str] = []
    toks_for: Dict[int, List[Token]] = {}
    name_sets: List[frozenset | None] = []
    type_miss: List[int] = []
    for idx, f in enumerate(files):
        h = content_hash(f["content"])
        hashes.append(h)
        names = cache.get(("types", h))
        if names is None:
            type_miss.append(idx)
        name_sets.append(names)

    if native and files and len(type_miss) == len(files):
        # Fully cold (nothing cached for any content): one combined
        # native pass yields names and nodes together, with no second
        # tokenize and no synthetic-decls file.
        combined = native_lib.try_scan_with_names(files)
        if combined is not None:
            per_file_names, nodes = combined
            stats.native_files += len(files)
            declared = set().union(*per_file_names) if per_file_names else set()
            dh = declared_hash(declared)
            by_file: Dict[str, List[DeclNode]] = {}
            for n in nodes:
                by_file.setdefault(n.file, []).append(n)
            keyed = []
            for idx, f in enumerate(files):
                path = normalize_path(f["path"])
                key = ("decls", path, hashes[idx], dh)
                cache.put(("types", hashes[idx]), per_file_names[idx])
                cache.put(key, by_file.get(path, []))
                keyed.append((key, by_file.get(path, [])))
            return keyed

    if type_miss:
        native_names = (native_lib.try_type_names([files[i] for i in type_miss])
                        if native else None)
        for j, idx in enumerate(type_miss):
            if native_names is not None:
                names = native_names[j]
            else:
                toks = tokenize(files[idx]["content"])
                toks_for[idx] = toks
                names = frozenset(_collect_type_names(toks))
            cache.put(("types", hashes[idx]), names)
            name_sets[idx] = names
    declared: set[str] = set().union(*name_sets) if name_sets else set()
    dh = declared_hash(declared)

    # Pass 2: per-file decl nodes keyed by (path, content, declared set).
    get = cache.get
    keys = [("decls", normalize_path(f["path"]), h, dh) for f, h in zip(files, hashes)]
    out_slots: List[List[DeclNode] | None] = [get(k) for k in keys]
    miss_idx = [i for i, v in enumerate(out_slots) if v is None]

    if miss_idx:
        scanned = _scan_subset([files[i] for i in miss_idx], declared,
                               [toks_for.get(i) for i in miss_idx], native, stats)
        for slot, nodes in zip(miss_idx, scanned):
            out_slots[slot] = nodes
            cache.put(keys[slot], nodes)

    return [(k, v or []) for k, v in zip(keys, out_slots)]


def _scan_subset(files: Sequence[dict], declared: set[str],
                 toks: Sequence[List[Token] | None], native: bool,
                 stats: ScanStats) -> List[List[DeclNode]]:
    """Scan a subset of a snapshot against a *global* declared set;
    returns per-file node lists in input order."""
    # Native path: prepend a synthetic file declaring every global type
    # name, so the library's internally computed declared set equals the
    # full snapshot's; its nodes are dropped from the result.
    if native and not any(normalize_path(f["path"]) == _SYNTH_PATH for f in files):
        from . import native as native_lib
        synth_names = sorted(n for n in declared if n.isascii())
        if len(synth_names) == len(declared):
            synth = {"path": _SYNTH_PATH,
                     "content": "".join(f"interface {n} {{}}\n" for n in synth_names)}
            nodes = native_lib.try_scan_snapshot([synth, *files])
            if nodes is not None:
                stats.native_files += len(files)
                by_file: Dict[str, List[DeclNode]] = {}
                for n in nodes:
                    if n.file != _SYNTH_PATH:
                        by_file.setdefault(n.file, []).append(n)
                return [by_file.get(normalize_path(f["path"]), []) for f in files]

    stats.python_files += len(files)
    out: List[List[DeclNode]] = []
    for f, t in zip(files, toks):
        if t is None:
            t = tokenize(f["content"])
        out.append(_scan_tokens(normalize_path(f["path"]), t, declared))
    return out


def scan_snapshot_py(files: Sequence[dict]) -> List[DeclNode]:
    """The pure-Python snapshot scan (oracle path)."""
    declared = set()
    tokens_by_file: List[tuple[str, List[Token]]] = []
    for f in files:
        path = normalize_path(f["path"])
        toks = tokenize(f["content"])
        tokens_by_file.append((path, toks))
        declared |= _collect_type_names(toks)
    nodes: List[DeclNode] = []
    for path, toks in tokens_by_file:
        nodes.extend(_scan_tokens(path, toks, declared))
    return nodes


# ---------------------------------------------------------------------------
# Pass 1: declared type names


def _collect_type_names(toks: List[Token]) -> set[str]:
    """Names introduced by class / interface / enum / type-alias
    declarations — the names a type annotation can resolve to."""
    names = set()
    for i, t in enumerate(toks):
        if t.type != IDENT or i + 1 >= len(toks):
            continue
        nxt = toks[i + 1]
        if t.text in ("class", "interface", "enum", "type") and nxt.type == IDENT:
            if t.text == "type" and (i + 2 >= len(toks) or toks[i + 2].text not in ("=", "<")):
                continue
            if _is_expression_position(toks, i) and t.text in ("class",):
                continue
            names.add(nxt.text)
    return names


# ---------------------------------------------------------------------------
# Pass 2: declaration scan


def _scan_tokens(path: str, toks: List[Token], declared: set[str]) -> List[DeclNode]:
    nodes: List[DeclNode] = []
    n = len(toks)
    for i in range(n):
        t = toks[i]
        if t.type != IDENT:
            continue
        word = t.text
        if word == "function":
            node = _scan_function(path, toks, i, declared)
        elif word == "class":
            node = _scan_braced_decl(path, toks, i, KIND_CLASS)
        elif word == "interface":
            node = _scan_braced_decl(path, toks, i, KIND_INTERFACE)
        elif word == "enum":
            node = _scan_braced_decl(path, toks, i, KIND_ENUM)
        elif word in ("var", "let", "const"):
            node = _scan_var_statement(path, toks, i)
        else:
            node = None
        if node is not None:
            nodes.append(node)
    return nodes


def _is_expression_position(toks: List[Token], i: int) -> bool:
    """True when the construct whose head keyword is at index *i* sits in
    expression position (→ function/class *expression*, not indexed)."""
    j = i - 1
    # Walk back over the construct's own modifiers; they are part of the
    # declaration node, so the expression/statement test applies before them.
    while j >= 0 and toks[j].type == IDENT and toks[j].text in _DECL_MODIFIERS:
        # ``export default function`` is a declaration, but ``x = default`` is
        # not valid — treating default/export as transparent is safe.
        j -= 1
    if j < 0:
        return False
    prev = toks[j]
    if prev.type == PUNCT:
        return prev.text in _EXPRESSION_PREV
    if prev.type == IDENT:
        return prev.text in _EXPRESSION_PREV_IDENTS
    return True  # literal directly before => malformed/expression-ish; skip


def _full_start(toks: List[Token], i: int) -> int:
    """The declaration's ``pos``: walk back over modifier tokens — and
    decorators, which TS parses as part of the declaration node (a
    ``@dec class C`` node's span starts at the decorator) — to the
    first token of the declaration node, then take the preceding
    token's end offset (0 at file start) — TS ``node.pos`` semantics."""
    j = i
    while j - 1 >= 0:
        prev = toks[j - 1]
        if prev.type == IDENT and prev.text in _DECL_MODIFIERS:
            j -= 1
            continue
        # Decorator: ``@ Name``, ``@ ns.Name``, or either with a call
        # ``(...)`` — immediately before the declaration head / its
        # modifiers.
        if prev.text == ")":
            k = j - 1
            depth = 0
            while k >= 0:
                if toks[k].text == ")":
                    depth += 1
                elif toks[k].text == "(":
                    depth -= 1
                    if depth == 0:
                        break
                k -= 1
            start = _decorator_start(toks, k)
            if start is not None:
                j = start
                continue
        if prev.type == IDENT:
            start = _decorator_start(toks, j)
            if start is not None:
                j = start
                continue
        break
    return toks[j].prev_end


def _decorator_start(toks: List[Token], j: int) -> int | None:
    """Index of the ``@`` starting a (possibly dotted) decorator name
    that ends just before *j* — ``@Name`` / ``@ns.sub.Name`` — or
    ``None`` if tokens before *j* are not a decorator name."""
    t = j - 1
    if t < 0 or toks[t].type != IDENT:
        return None
    while t - 2 >= 0 and toks[t - 1].text == "." and toks[t - 2].type == IDENT:
        t -= 2
    if t - 1 >= 0 and toks[t - 1].text == "@":
        return t - 1
    return None


def _skip_type_params(toks: List[Token], i: int) -> int:
    """Skip ``<...>`` starting at *i* (if present); returns index after."""
    return _type_param_names(toks, i)[1]


def _type_param_names(toks: List[Token], i: int) -> tuple:
    """``(names, index_after)`` for a ``<T, U extends X = Y>`` list at
    *i* (empty names if absent). Type parameters resolve *lexically* —
    the reference checker renders a type-parameter reference by its
    name regardless of the missing default lib
    (``checker.typeToString`` of a TypeParameter prints the parameter
    name; reference ``workers/ts/src/sast.ts:78-83``) — so the
    signature renderers must treat these names as in-scope types."""
    names: list = []
    if i < len(toks) and toks[i].text == "<":
        depth = 0
        expecting = False
        while i < len(toks):
            t = toks[i].text
            if t == "<":
                depth += 1
                if depth == 1:
                    expecting = True
            elif t in (">", ">>", ">>>"):
                depth -= t.count(">")
                if depth <= 0:
                    return names, i + 1
            elif depth == 1 and t == ",":
                expecting = True
            elif (expecting and depth == 1 and toks[i].type == IDENT
                    and t not in ("const", "in", "out")):
                names.append(t)
                expecting = False
            i += 1
    return names, i


def _matching_brace(toks: List[Token], i: int) -> int:
    """Index of the ``}`` matching the ``{`` at *i* (or last token)."""
    depth = 0
    n = len(toks)
    while i < n:
        if toks[i].text == "{":
            depth += 1
        elif toks[i].text == "}":
            depth -= 1
            if depth == 0:
                return i
        i += 1
    return n - 1


def _scan_function(path: str, toks: List[Token], i: int, declared: set[str]) -> DeclNode | None:
    if _is_expression_position(toks, i):
        return None
    n = len(toks)
    j = i + 1
    if j < n and toks[j].text == "*":  # generator
        j += 1
    name = None
    if j < n and toks[j].type == IDENT:
        name = toks[j].text
        j += 1
    tp_names, j = _type_param_names(toks, j)
    if j >= n or toks[j].text != "(":
        return None
    if name is None and not _has_default_modifier(toks, i):
        # A nameless ``function (`` in statement position is not a valid
        # declaration unless it is ``export default function``.
        return None
    # The decl's own type parameters are lexically in scope for its
    # param/return annotations and render by name (checker semantics).
    local = declared | set(tp_names) if tp_names else declared
    params_start = j
    params_end = _matching_paren(toks, params_start)
    param_types = _parse_param_types(toks[params_start + 1 : params_end], local)
    # Return type: ``: T`` after the parameter list, up to ``{`` or ``;``.
    k = params_end + 1
    ret_type = "any"
    if k < n and toks[k].text == ":":
        type_toks, k = _collect_type_tokens(toks, k + 1, stop={"{", ";"})
        ret_type = _render_type(type_toks, local)
    # Body or overload signature end.
    if k < n and toks[k].text == "{":
        end_idx = _matching_brace(toks, k)
    elif k < n and toks[k].text == ";":
        end_idx = k
    else:
        end_idx = params_end
    sig = f"fn({','.join(param_types)})->{ret_type}"
    return _mk_node(path, toks, i, end_idx, KIND_FUNCTION, name, sig)


def _has_default_modifier(toks: List[Token], i: int) -> bool:
    j = i - 1
    while j >= 0 and toks[j].type == IDENT and toks[j].text in _DECL_MODIFIERS:
        if toks[j].text == "default":
            return True
        j -= 1
    return False


def _matching_paren(toks: List[Token], i: int) -> int:
    depth = 0
    n = len(toks)
    while i < n:
        if toks[i].text == "(":
            depth += 1
        elif toks[i].text == ")":
            depth -= 1
            if depth == 0:
                return i
        i += 1
    return n - 1


def _parse_param_types(param_toks: List[Token], declared: set[str]) -> List[str]:
    """Each parameter's displayed type: the annotation after ``:`` at the
    parameter's top level (before any ``=`` default), else ``any``."""
    if not param_toks:
        return []
    params: List[List[Token]] = [[]]
    depth = 0
    for t in param_toks:
        if t.text in ("(", "[", "{", "<"):
            depth += 1
        elif t.text in (")", "]", "}", ">"):
            depth -= 1
        if t.text == "," and depth == 0:
            params.append([])
        else:
            params[-1].append(t)
    types = []
    for ptoks in params:
        if not ptoks:
            continue
        ann = _annotation_of(ptoks)
        types.append(_render_type(ann, declared) if ann else "any")
    return types


def _annotation_of(ptoks: List[Token]) -> List[Token]:
    """Tokens of the ``: type`` annotation within one parameter."""
    depth = 0
    start = None
    for idx, t in enumerate(ptoks):
        if t.text in ("(", "[", "{", "<"):
            depth += 1
        elif t.text in (")", "]", "}", ">"):
            depth -= 1
        elif depth == 0 and t.text == ":" and start is None:
            start = idx + 1
        elif depth == 0 and t.text == "=" and start is not None:
            return ptoks[start:idx]
        elif depth == 0 and t.text == "=" and start is None:
            return []
    return ptoks[start:] if start is not None else []


#: A depth-0 ``{`` after one of these tokens continues the type (an
#: object-literal type is expected there); after anything else it opens
#: the declaration body.
_TYPE_EXPECTED_AFTER = {":", "|", "&", "(", ",", "<", "=>", "extends", "keyof",
                        "readonly", "?"}


def _collect_type_tokens(toks: List[Token], i: int, stop: set[str]) -> tuple[List[Token], int]:
    """Collect annotation tokens from *i* until a depth-0 stop token.

    ``{`` is positional: directly after ``:`` / ``|`` / ``&`` / ``(`` /
    ``,`` / ``<`` it begins an object-literal *type* (``): { ok:
    boolean } {``); after a completed type atom it is the declaration
    body and stops collection — the distinction ``tsc``'s parser makes
    grammatically."""
    out: List[Token] = []
    depth = 0
    n = len(toks)
    expecting = True  # start of annotation: a type is expected
    while i < n:
        t = toks[i]
        if depth == 0 and t.text in stop and not (t.text == "{" and expecting):
            break
        if t.text in ("(", "[", "<", "{"):
            depth += 1
        elif t.text in (")", "]", ">", "}"):
            if depth == 0:
                break
            depth -= 1
        expecting = t.text in _TYPE_EXPECTED_AFTER
        out.append(t)
        i += 1
    return out, i


# --- type display (typeToString emulation) ---------------------------------


def _render_type(type_toks: List[Token], declared: set[str]) -> str:
    if not type_toks:
        return "any"
    return _render_type_text([t.text for t in type_toks], declared)


def _render_type_text(parts: List[str], declared: set[str]) -> str:
    """Render a type annotation the way the reference's checker displays
    it with no default library loaded: in-snapshot type references keep
    their name, unresolved references collapse to ``any``, primitives as
    written, ``T[]`` arrays, `` | `` / `` & `` spacing."""
    if not parts:  # e.g. a trailing comma's empty tuple element
        return "any"
    # Union / intersection at top level.
    for op in ("|", "&"):
        pieces = _split_top(parts, op)
        if len(pieces) > 1:
            rendered = [_render_type_text(p, declared) for p in pieces]
            return f" {op} ".join(rendered)
    # Trailing [] — array type.
    if len(parts) >= 2 and parts[-1] == "]" and parts[-2] == "[":
        elem = _render_type_text(parts[:-2], declared)
        if " | " in elem or " & " in elem:
            return f"({elem})[]"
        return f"{elem}[]"
    # Parenthesized.
    if parts and parts[0] == "(" and _split_top(parts, "|") == [parts]:
        if parts[-1] == ")":
            return _render_type_text(parts[1:-1], declared)
    if len(parts) == 1:
        name = parts[0]
        if name in _PRIMITIVE_TYPES or name.lstrip("-").isdigit() or name[:1] in "'\"`":
            return name
        return name if name in declared else "any"
    # Generic reference ``Name<...>`` — unresolved without a default lib
    # (including Array/Promise), so it displays as ``any`` unless declared.
    if parts[0] not in _PRIMITIVE_TYPES and len(parts) >= 2 and parts[1] == "<":
        return parts[0] if parts[0] in declared else "any"
    # Qualified name ``Ns.Thing``: namespaces are not indexed decl kinds,
    # so the reference's no-default-lib checker cannot resolve the root
    # — it displays ``any`` (e.g. ``JSX.Element`` in a bare snapshot).
    if (len(parts) >= 3 and len(parts) % 2 == 1
            and all(p == "." for p in parts[1::2])
            and all(p.isidentifier() for p in parts[::2])):
        return "any"
    # Tuple type ``[A, B]``: render element-wise like the checker
    # (a trailing comma's empty element drops, as tsc displays it).
    if parts[0] == "[" and parts[-1] == "]":
        inner = parts[1:-1]
        if inner:
            elems = [_render_type_text(p, declared)
                     for p in _split_top(inner, ",") if p]
            return f"[{', '.join(elems)}]"
    # Literal object type, function type, …: not reproduced
    # structurally; display as written with checker-style punctuation
    # spacing (no space before ``:,;.)]>``, none after ``([<.``).
    out: List[str] = []
    for p in parts:
        if out and (p in (",", ";", ":", ")", "]", ">", ".")
                    or out[-1][-1] in "([<."):
            out[-1] += p
        else:
            out.append(p)
    return " ".join(out)


def _split_top(parts: List[str], sep: str) -> List[List[str]]:
    out: List[List[str]] = [[]]
    depth = 0
    for p in parts:
        if p in ("(", "[", "{", "<"):
            depth += 1
        elif p in (")", "]", "}", ">"):
            depth -= 1
        if p == sep and depth == 0:
            out.append([])
        else:
            out[-1].append(p)
    return out


# --- braced declarations (class / interface / enum) -------------------------


def _scan_braced_decl(path: str, toks: List[Token], i: int, kind: str) -> DeclNode | None:
    if _is_expression_position(toks, i):
        return None
    n = len(toks)
    j = i + 1
    name = None
    if j < n and toks[j].type == IDENT and toks[j].text not in ("extends", "implements"):
        name = toks[j].text
        j += 1
    if name is None and kind in (KIND_INTERFACE, KIND_ENUM):
        return None  # interface/enum require a name; bare word was an identifier
    j = _skip_type_params(toks, j)
    # Heritage clauses up to the body brace.
    while j < n and toks[j].text != "{":
        if toks[j].text in (";", ")"):
            return None
        j += 1
    if j >= n:
        return None
    body_start = j
    body_end = _matching_brace(toks, body_start)
    if kind == KIND_CLASS:
        count = _count_class_members(toks, body_start, body_end)
        sig = f"class{{{count}}}"
    elif kind == KIND_INTERFACE:
        count = _count_interface_members(toks, body_start, body_end)
        sig = f"iface{{{count}}}"
    else:
        count = _count_enum_members(toks, body_start, body_end)
        sig = f"enum{{{count}}}"
    start_i = i
    # ``const enum``: the const modifier is part of the declaration.
    if kind == KIND_ENUM and i - 1 >= 0 and toks[i - 1].text == "const":
        start_i = i - 1
    return _mk_node(path, toks, start_i, body_end, kind, name, sig)


def _count_class_members(toks: List[Token], body_start: int, body_end: int) -> int:
    """Count class members the way ``ClassDeclaration.members.length``
    does: methods/accessors/constructors (body or overload signature),
    properties, index signatures, static blocks, and bare ``;`` members
    (SemicolonClassElement)."""
    count = 0
    i = body_start + 1
    while i < body_end:
        t = toks[i]
        if t.text == ";":
            count += 1  # SemicolonClassElement
            i += 1
            continue
        # One member: scan to its end.
        count += 1
        i = _member_end(toks, i, body_end, allow_method_body=True)
    return count


def _count_interface_members(toks: List[Token], body_start: int, body_end: int) -> int:
    count = 0
    i = body_start + 1
    while i < body_end:
        if toks[i].text in (";", ","):
            i += 1
            continue
        count += 1
        i = _member_end(toks, i, body_end, allow_method_body=False)
    return count


def _member_end(toks: List[Token], i: int, body_end: int, allow_method_body: bool) -> int:
    """Scan one class/interface member starting at *i*; return the index
    just past it."""
    depth = 0
    seen_eq = False
    n = body_end
    start = i  # the ASI check must not fire on the member's own first token
    while i < n:
        t = toks[i]
        if t.text in ("(", "["):
            depth += 1
        elif t.text in (")", "]"):
            depth -= 1
        elif t.text == "{":
            if depth == 0 and not seen_eq and allow_method_body:
                return _matching_brace(toks, i) + 1  # method/accessor/static body
            depth += 1
        elif t.text == "}":
            depth -= 1
        elif depth == 0:
            if t.text == "=":
                seen_eq = True
            elif t.text in (";", ","):
                return i + 1
            elif t.nl_before and i > start and _asi_break(toks[i - 1], t):
                return i
        i += 1
    return n


def _asi_break(prev: Token, cur: Token) -> bool:
    """Heuristic ASI boundary between two members on separate lines."""
    if prev.type == PUNCT and prev.text not in (")", "]", "}"):
        return False
    if cur.type == PUNCT and cur.text not in ("[", "@", "#"):
        return False
    if prev.type == IDENT and prev.text in ("get", "set", "static", "readonly", "public",
                                            "private", "protected", "abstract", "async", "new"):
        return False
    return True


def _count_enum_members(toks: List[Token], body_start: int, body_end: int) -> int:
    count = 0
    depth = 0
    has_content = False
    for i in range(body_start + 1, body_end):
        t = toks[i]
        if t.text in ("(", "[", "{"):
            depth += 1
        elif t.text in (")", "]", "}"):
            depth -= 1
        elif t.text == "," and depth == 0:
            if has_content:
                count += 1
            has_content = False
            continue
        if depth == 0 and t.text != ",":
            has_content = True
    if has_content:
        count += 1
    return count


# --- variable statements -----------------------------------------------------


def _scan_var_statement(path: str, toks: List[Token], i: int) -> DeclNode | None:
    n = len(toks)
    t = toks[i]
    # ``const enum`` is an EnumDeclaration (handled by the enum scan).
    if i + 1 < n and toks[i + 1].text == "enum":
        return None
    # Must be followed by a binding (identifier or destructuring pattern).
    if i + 1 >= n or not (toks[i + 1].type == IDENT or toks[i + 1].text in ("[", "{")):
        return None
    if toks[i + 1].type == IDENT and toks[i + 1].text in ("in", "of", "instanceof"):
        return None
    # Inside a ``for (...)`` head → VariableDeclarationList, not a statement.
    j = i - 1
    if j >= 0 and toks[j].text == "(" and j - 1 >= 0 and toks[j - 1].type == IDENT \
            and toks[j - 1].text in ("for", "await"):
        return None
    if _is_expression_position(toks, i):
        return None
    # Scan declarators until ``;`` / block close / ASI at depth 0.
    depth = 0
    declarators = 1
    k = i + 1
    end_idx = i
    while k < n:
        t2 = toks[k]
        if t2.text in ("(", "[", "{"):
            depth += 1
        elif t2.text in (")", "]"):
            depth -= 1
            if depth < 0:
                break
        elif t2.text == "}":
            depth -= 1
            if depth < 0:
                break
        elif depth == 0:
            if t2.text == ";":
                end_idx = k
                break
            if t2.text == ",":
                declarators += 1
            elif t2.nl_before and _var_asi_break(toks[k - 1], t2):
                break
            # ``for`` heads already excluded; ``of``/``in`` end the list
            elif t2.type == IDENT and t2.text in ("of", "in") and toks[k - 1].type == IDENT:
                return None
        end_idx = k
        k += 1
    sig = f"vars{{{declarators}}}"
    # VariableStatement nodes have no ``.name`` → addressId uses "anon"
    # (reference ``workers/ts/src/sast.ts:52,66``).
    return _mk_node(path, toks, i, end_idx, KIND_VARS, None, sig)


def _var_asi_break(prev: Token, cur: Token) -> bool:
    if prev.type == PUNCT and prev.text not in (")", "]", "}"):
        return False
    if cur.type == PUNCT and cur.text in ("+", "-", "*", "/", ".", "?.", "=", "(", "[", "`"):
        return False
    if cur.type == IDENT and cur.text in ("instanceof", "in", "of", "as"):
        return False
    return True


# ---------------------------------------------------------------------------


def _mk_node(path: str, toks: List[Token], start_i: int, end_i: int,
             kind: str, name: str | None, sig: str) -> DeclNode:
    pos = _full_start(toks, start_i)
    end = toks[min(end_i, len(toks) - 1)].end
    address = f"{path}::{name if name is not None else 'anon'}::{pos}"
    return DeclNode(
        symbolId=symbol_id_from_signature(sig),
        addressId=address,
        kind=kind,
        name=name,
        file=path,
        pos=pos,
        end=end,
        signature=sig,
    )
