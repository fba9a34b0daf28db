"""Diff records, changeSignature refinement and op lifting.

A copy of the JAX package's ``core/difflift.py``: the join itself runs
on the device (:mod:`semantic_merge_tpu_torch.ops.diff`); the statement
ops (:func:`lift_statements`: ``editStmtBlock`` and the
``extractMethod`` / ``inlineMethod`` markers) run here on the host, as
they do there.
Together with the device join it reproduces the reference worker's
diff/lift stage exactly
(reference ``workers/ts/src/diff.ts:5-31`` and
``workers/ts/src/lift.ts:11-66``), with the nondeterministic identity
fields (uuid4 ids, wall-clock timestamps) replaced by the seeded scheme
from :mod:`semantic_merge_tpu_torch.core.ids`.

Diff semantics (parity-critical quirks included):

- Both node lists collapse into symbolId-keyed maps with JS ``Map``
  semantics: iteration follows *first* insertion order, but a duplicate
  symbolId keeps the *last* node (coarse signatures like ``class{2}``
  collide by design; reference ``implementation.md:1309`` acknowledges
  last-wins).
- Per base symbol, in map order: absent on the side → ``delete``;
  differing addressId → ``move``; differing non-null names → ``rename``
  (a symbol can emit both move and rename).
- Per side *list* entry (not map — duplicates emit repeatedly): symbolId
  absent in base → ``add``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..frontend.scanner import DeclNode
from .ids import EPOCH_ISO, deterministic_op_id, stable_hash_hex
from .ops import Op, Target


@dataclass
class Diff:
    kind: str  # "rename" | "move" | "add" | "delete" | "changeSig"
    a: DeclNode | None = None
    b: DeclNode | None = None


def refine_signature_changes(diffs: List[Diff], sources=None,
                             matcher=None) -> List[Diff]:
    """Fold residual ``delete``+``add`` pairs into ``changeSig`` diffs.

    Editing a function's parameter or return types changes its
    structural symbolId, so the exact-key join reports the decl as
    deleted-and-re-added; the ``changeSig`` diff kind exists so such
    edits can merge as one signature change instead. This pass produces
    it: a deleted base decl and an added side decl that share
    ``(file, name, kind)`` (names non-null) are the same declaration
    with a changed signature.

    With ``matcher`` (an
    :class:`semantic_merge_tpu_torch.models.signature.EmbeddingSignatureMatcher`)
    and ``sources`` (a :func:`source_maps` pair), a second pass scores
    the *residual* deletes/adds — declarations that were renamed AND
    retyped, which no key can pair — by embedding similarity.

    Deterministic pairing: the k-th delete with a given key pairs with
    the k-th add with that key; model pairs break ties by score then
    stream position. The ``changeSig`` takes the delete's position in
    the stream; the paired add is dropped (later op ids re-index, which
    is why this pass must run identically in every backend — it is
    opt-in precisely because parity-with-reference mode must keep the
    delete+add shape).
    """
    # Pass 1: pair each eligible delete (stream order) with the next
    # unconsumed eligible add sharing its key.
    pending_adds: Dict[tuple, List[int]] = {}
    for idx, d in enumerate(diffs):
        if d.kind == "add" and d.b is not None and d.b.name:
            pending_adds.setdefault((d.b.file, d.b.name, d.b.kind), []).append(idx)
    paired: Dict[int, int] = {}  # delete idx -> add idx
    consumed: set = set()
    for idx, d in enumerate(diffs):
        if d.kind == "delete" and d.a is not None and d.a.name:
            queue = pending_adds.get((d.a.file, d.a.name, d.a.kind))
            if queue:
                add_idx = queue.pop(0)
                paired[idx] = add_idx
                consumed.add(add_idx)

    # Pass 1b: model-scored pairing of the residuals.
    if matcher is not None and sources is not None:
        base_map, side_map = sources
        # Candidates are keyed by (kind, file): a changeSignature op's
        # structured-apply spans are base offsets in the delete's file,
        # so a cross-file pair could never materialize correctly — a
        # decl moved AND retyped stays delete+add.
        res_del: List[int] = []
        del_items: List[tuple] = []
        for idx, d in enumerate(diffs):
            if (d.kind == "delete" and idx not in paired
                    and d.a is not None and d.a.name):
                src = base_map.get(d.a.file)
                if src is not None:
                    res_del.append(idx)
                    del_items.append(((d.a.kind, d.a.file),
                                      src[d.a.pos:d.a.end]))
        res_add: List[int] = []
        add_items: List[tuple] = []
        for idx, d in enumerate(diffs):
            if (d.kind == "add" and idx not in consumed
                    and d.b is not None and d.b.name):
                src = side_map.get(d.b.file)
                if src is not None:
                    res_add.append(idx)
                    add_items.append(((d.b.kind, d.b.file),
                                      src[d.b.pos:d.b.end]))
        for di, aj in matcher.pair(del_items, add_items):
            paired[res_del[di]] = res_add[aj]
            consumed.add(res_add[aj])

    # Pass 2: rebuild the stream.
    out: List[Diff] = []
    for idx, d in enumerate(diffs):
        if idx in paired:
            out.append(Diff("changeSig", a=d.a, b=diffs[paired[idx]].b))
        elif idx not in consumed:
            out.append(d)
    return out


def source_maps(base_files, side_files) -> tuple:
    """(base, side) path→content maps for structured-apply payloads."""
    from ..frontend.scanner import normalize_path
    return ({normalize_path(f["path"]): f["content"] for f in base_files},
            {normalize_path(f["path"]): f["content"] for f in side_files})


def _decl_payload(d: Diff, sources) -> Dict | None:
    """Structured-apply payload for an op's ``effects``.

    Spans are *base-content* offsets (``pos`` is the decl's full start,
    ``end`` its last token), texts are side-content slices — exactly
    what the applier needs to splice without re-parsing. This is the
    designed-but-unbuilt worker ``applyOps`` stage (reference
    ``implementation.md:1258,1339``), opt-in because it extends the
    reference's op JSON shape.
    """
    if sources is None:
        return None
    base_map, side_map = sources
    if d.kind == "add" and d.b is not None:
        src = side_map.get(d.b.file)
        if src is not None:
            return {"text": src[d.b.pos:d.b.end]}
    elif d.kind == "delete" and d.a is not None:
        return {"start": d.a.pos, "end": d.a.end}
    elif d.kind == "changeSig" and d.a is not None and d.b is not None:
        src = side_map.get(d.b.file)
        if src is not None:
            return {"start": d.a.pos, "end": d.a.end,
                    "text": src[d.b.pos:d.b.end]}
    return None


def lift(base_rev: str, diffs: List[Diff], *, seed: str = "0",
         timestamp: str = EPOCH_ISO, sources=None) -> List[Op]:
    """Diff records → Op records.

    Op ids are deterministic: a function of the seed, the diff content,
    and the diff's position in the stream — the same inputs yield
    bit-identical op logs from any backend. With ``sources`` (a
    :func:`source_maps` pair), add/delete/changeSig ops carry
    structured-apply payloads in ``effects["decl"]``.
    """
    ops: List[Op] = []
    for idx, d in enumerate(diffs):
        prov = {"rev": base_rev, "timestamp": timestamp}
        payload = _decl_payload(d, sources)
        if d.kind == "rename" and d.a and d.b:
            ops.append(Op.new(
                "renameSymbol",
                Target(symbolId=d.a.symbolId, addressId=d.a.addressId),
                params={"oldName": d.a.name, "newName": d.b.name, "file": d.b.file},
                guards={"exists": True, "addressMatch": d.a.addressId},
                effects={"summary": f"rename {d.a.name}→{d.b.name}"},
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "renameSymbol", d),
            ))
        elif d.kind == "move" and d.a and d.b:
            ops.append(Op.new(
                "moveDecl",
                Target(symbolId=d.a.symbolId, addressId=d.a.addressId),
                params={
                    "oldAddress": d.a.addressId,
                    "newAddress": d.b.addressId,
                    "oldFile": d.a.file,
                    "newFile": d.b.file,
                },
                guards={"exists": True, "addressMatch": d.a.addressId},
                effects={"summary": f"move {d.a.addressId}→{d.b.addressId}"},
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "moveDecl", d),
            ))
        elif d.kind == "changeSig" and d.a and d.b:
            effects = {"summary":
                       f"changeSignature {d.a.name}: {d.a.signature}→{d.b.signature}"}
            if payload is not None:
                effects["decl"] = payload
            ops.append(Op.new(
                "changeSignature",
                Target(symbolId=d.a.symbolId, addressId=d.a.addressId),
                params={
                    "name": d.a.name,
                    "file": d.b.file,
                    "oldSignature": d.a.signature,
                    "newSignature": d.b.signature,
                    "oldAddress": d.a.addressId,
                    "newAddress": d.b.addressId,
                    "newSymbolId": d.b.symbolId,
                },
                guards={"exists": True, "addressMatch": d.a.addressId},
                effects=effects,
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "changeSignature", d),
            ))
        elif d.kind == "add" and d.b:
            effects = {"summary": "add decl"}
            if payload is not None:
                effects["decl"] = payload
            ops.append(Op.new(
                "addDecl",
                Target(symbolId=d.b.symbolId, addressId=d.b.addressId),
                params={"file": d.b.file},
                guards={},
                effects=effects,
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "addDecl", d),
            ))
        elif d.kind == "delete" and d.a:
            effects = {"summary": "delete decl"}
            if payload is not None:
                effects["decl"] = payload
            ops.append(Op.new(
                "deleteDecl",
                Target(symbolId=d.a.symbolId, addressId=d.a.addressId),
                params={"file": d.a.file},
                guards={},
                effects=effects,
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "deleteDecl", d),
            ))
    return ops


def statement_edits(base_nodes: List[DeclNode], side_nodes: List[DeclNode],
                    sources, *, base_rev: str, seed: str,
                    timestamp: str = EPOCH_ISO, start_idx: int = 0) -> List[Op]:
    """``editStmtBlock`` ops: identity-stable decls whose body changed.

    The reference *schemas* statement-level edits (its requirements
    gate two [CFR-002] conflict categories on them, reference
    ``requirements.md:97-98``; design sketch at
    ``architecture.md:160``) but extracts none. This pass implements
    the capability: a declaration present in base and side under the
    same ``(symbolId, name, file)`` key whose full-span source text
    (``pos..end``, leading trivia included per the full-start span
    contract) differs emits one ``editStmtBlock`` op carrying old/new
    body text + 64-bit body hashes — enough for the applier to splice
    and for ``semrebase`` to replay. Matching by name+file (not
    addressId) tolerates the position shifts earlier edits in the same
    file cause; a decl that was renamed or moved AND body-edited stays
    outside this pass's reach (the rename/move op already records the
    change). Key collisions (same signature, name, file) keep the last
    occurrence, matching the differ's JS-``Map`` semantics.

    Op ids continue the lift stream's index sequence (``start_idx`` =
    number of lifted ops), so ids stay deterministic functions of
    (seed, rev, stream position, content). Opt-in: parity mode must
    keep the reference's observable op vocabulary, so this runs only
    under ``--statement-ops`` / ``[engine] statement_ops`` / strict
    conflict mode.
    """
    base_map, side_map = sources
    by_key: Dict[tuple, DeclNode] = {}
    for n in base_nodes:
        by_key[(n.symbolId, n.name, n.file)] = n  # last wins, Map quirk
    ops: List[Op] = []
    idx = start_idx
    prov = {"rev": base_rev, "timestamp": timestamp}
    for b in side_nodes:
        a = by_key.get((b.symbolId, b.name, b.file))
        if a is None:
            continue
        src_a = base_map.get(a.file)
        src_b = side_map.get(b.file)
        if src_a is None or src_b is None:
            continue
        old = src_a[a.pos:a.end]
        new = src_b[b.pos:b.end]
        if old == new:
            continue
        ops.append(Op.new(
            "editStmtBlock",
            Target(symbolId=a.symbolId, addressId=a.addressId),
            params={"file": b.file,
                    "oldBodyHash": stable_hash_hex(old, n_hex=16),
                    "newBodyHash": stable_hash_hex(new, n_hex=16),
                    "oldBody": old, "newBody": new},
            guards={"exists": True, "addressMatch": a.addressId},
            effects={"summary": f"edit body of {a.name}"},
            provenance=prov,
            op_id=deterministic_op_id(seed, base_rev, idx, "editStmtBlock",
                                      a.symbolId, a.addressId, b.addressId),
        ))
        idx += 1
    return ops


def _decl_block(text: str) -> str:
    """The whitespace-normalized statement block of a declaration's
    source text: everything between the first ``{`` and the last ``}``,
    collapsed to single spaces. Empty when the decl has no braced body
    (``declare``/arrow-less vars) or the block is blank — callers skip
    those."""
    lo = text.find("{")
    hi = text.rfind("}")
    if lo < 0 or hi <= lo:
        return ""
    return " ".join(text[lo + 1:hi].split())


_IDENT_CHARS = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_$")

#: Minimum normalized-block size for motion evidence: at least this
#: many statements (``;`` count) or strictly more characters. A
#: trivial shared block — the bare ``return null;`` class — occurs in
#: unrelated declarations by coincidence, and since ``blockHash`` is
#: content-only, opposite-side trivial "motions" join into a false
#: ExtractVsInline strict-mode abort of a clean merge.
_MIN_MOTION_STMTS = 2
_MIN_MOTION_CHARS = 15


def _block_significant(block: str) -> bool:
    """Whether a normalized block is big enough to be motion evidence."""
    return (len(block) > _MIN_MOTION_CHARS
            or block.count(";") >= _MIN_MOTION_STMTS)


def _block_in(block: str, text: str) -> bool:
    """True when ``block`` occurs in ``text`` at identifier boundaries:
    a raw substring check would let ``x + 1;`` "match" inside
    ``max + 1;`` and mint a motion for code that never moved. Both
    strings are already whitespace-normalized."""
    start = 0
    while True:
        i = text.find(block, start)
        if i < 0:
            return False
        before_ok = i == 0 or (text[i - 1] not in _IDENT_CHARS
                               or block[0] not in _IDENT_CHARS)
        j = i + len(block)
        after_ok = j >= len(text) or (text[j] not in _IDENT_CHARS
                                      or block[-1] not in _IDENT_CHARS)
        if before_ok and after_ok:
            return True
        start = i + 1


def body_motions(diffs, stmt_ops: List[Op], sources,
                 *, base_rev: str, seed: str,
                 timestamp: str = EPOCH_ISO, start_idx: int = 0) -> List[Op]:
    """``extractMethod`` / ``inlineMethod`` ops: statement-block motion
    between declarations.

    The reference names extract/inline in its op vocabulary and gates a
    [CFR-002] conflict category on them (reference
    ``requirements.md:52,98``) but its worker emits neither. This pass
    detects the motions from the already-lifted evidence:

    - **extract** — an added declaration N whose braced body appears
      (whitespace-normalized) in the OLD body of a body-edited
      declaration D but not in its NEW body: N's statements left D.
    - **inline** — a deleted declaration N whose body appears in a
      body-edited D's NEW body but not its OLD body: N's statements
      landed in D.

    Emitted ops are *markers*: the companion ``editStmtBlock`` /
    ``addDecl`` / ``deleteDecl`` ops still carry the text-level change
    (the applier skips unknown-to-it types by contract), so the markers
    add the semantic identity of the motion — the join key
    (``blockHash`` over the normalized block) the strict conflict
    detector and [RES-004] dedup need — without double-applying
    anything. One motion per added/deleted decl (first matching edit in
    stream order wins); ids continue the statement stream's index
    sequence, keeping the whole op stream a deterministic function of
    (seed, rev, content).

    Blocks below the minimum size (:func:`_block_significant`) are not
    motion evidence; and the edit bodies are pre-indexed by a cheap
    fingerprint — each body normalized exactly once, a length bucket
    (a block cannot occur in a body shorter than itself), and one
    NUL-joined haystack of every body so the common no-motion candidate
    is rejected by a single C-speed substring scan instead of
    per-edit boundary-aware scans (O(adds×edits×body) before)."""
    base_map, side_map = sources
    edits = [op for op in stmt_ops if op.type == "editStmtBlock"]
    ops: List[Op] = []
    idx = start_idx
    if not edits:
        return ops
    prov = {"rev": base_rev, "timestamp": timestamp}
    norm_old = [" ".join(str(e.params.get("oldBody", "")).split())
                for e in edits]
    norm_new = [" ".join(str(e.params.get("newBody", "")).split())
                for e in edits]
    max_body = max(map(len, norm_old + norm_new))
    # '\x00' never survives whitespace normalization of source text, so
    # a block cannot falsely match across two bodies' boundary.
    haystack = "\x00".join(norm_old + norm_new)
    for d in diffs:
        if d.kind == "add" and d.b is not None:
            node, src = d.b, side_map.get(d.b.file)
        elif d.kind == "delete" and d.a is not None:
            node, src = d.a, base_map.get(d.a.file)
        else:
            continue
        if src is None:
            continue
        block = _decl_block(src[node.pos:node.end])
        if not block or not _block_significant(block):
            continue
        if len(block) > max_body or block not in haystack:
            continue  # no body contains the block — no scan needed
        for e, old, new in zip(edits, norm_old, norm_new):
            if d.kind == "add" and _block_in(block, old) \
                    and not _block_in(block, new):
                ops.append(Op.new(
                    "extractMethod",
                    Target(symbolId=e.target.symbolId,
                           addressId=e.target.addressId),
                    params={"file": node.file, "newName": node.name,
                            "newAddress": node.addressId,
                            "newSymbol": node.symbolId,
                            "fromFile": str(e.params.get("file", "")),
                            "blockHash": stable_hash_hex(block, n_hex=16)},
                    guards={"exists": True},
                    effects={"summary": f"extract {node.name}"},
                    provenance=prov,
                    op_id=deterministic_op_id(
                        seed, base_rev, idx, "extractMethod",
                        e.target.symbolId, node.addressId, block),
                ))
            elif d.kind == "delete" and _block_in(block, new) \
                    and not _block_in(block, old):
                ops.append(Op.new(
                    "inlineMethod",
                    Target(symbolId=e.target.symbolId,
                           addressId=e.target.addressId),
                    params={"file": str(e.params.get("file", "")),
                            "methodName": node.name,
                            "oldAddress": node.addressId,
                            "oldSymbol": node.symbolId,
                            "blockHash": stable_hash_hex(block, n_hex=16)},
                    guards={"exists": True},
                    effects={"summary": f"inline {node.name}"},
                    provenance=prov,
                    op_id=deterministic_op_id(
                        seed, base_rev, idx, "inlineMethod",
                        e.target.symbolId, node.addressId, block),
                ))
            else:
                continue
            idx += 1
            break
    return ops


def lift_statements(diffs, base_nodes, side_nodes, sources, files_pair,
                    *, base_rev: str, seed: str, side: str,
                    timestamp: str = EPOCH_ISO) -> List[Op]:
    """The statement-op tail of one side's lifted stream — the single
    place that owns the seed/side and start-index conventions every
    backend must share (op ids continue the lift sequence, so a
    convention drift would silently fork ids between backends).
    ``sources`` reuses an already-built :func:`source_maps` pair;
    ``files_pair`` builds one lazily otherwise."""
    sm = sources or source_maps(*files_pair)
    stmt = statement_edits(base_nodes, side_nodes, sm, base_rev=base_rev,
                           seed=f"{seed}/{side}", timestamp=timestamp,
                           start_idx=len(diffs))
    return stmt + body_motions(diffs, stmt, sm,
                               base_rev=base_rev, seed=f"{seed}/{side}",
                               timestamp=timestamp,
                               start_idx=len(diffs) + len(stmt))


def _op_id(seed: str, rev: str, idx: int, op_type: str, d: Diff) -> str:
    a_addr = d.a.addressId if d.a else ""
    b_addr = d.b.addressId if d.b else ""
    sym = (d.a or d.b).symbolId  # type: ignore[union-attr]
    return deterministic_op_id(seed, rev, idx, op_type, sym, a_addr, b_addr)
