"""TypeScript backend on the GPU — the port's semantic diff and merge.

The counterpart of the JAX package's ``TpuTSBackend``
(``backends/ts_tpu.py``), single device. The host scans the snapshots
and interns them into the backend's one id space; then, as in the JAX
package. The scan (:func:`~semantic_merge_tpu_torch.frontend.scanner.scan_snapshot`)
runs the C++ scanner through the per-file decl cache, so the three
snapshots of one merge scan their shared files once.

- **The fused path** (the default): :meth:`diff` without
  changeSignature, structured apply and statement ops, and :meth:`merge`
  without the latter two and unless the changeSignature refinement could
  rewrite an op stream (:func:`_changesig_candidates`),
  run :class:`~semantic_merge_tpu_torch.ops.fused.FusedMergeEngine` —
  the diff join, op ids by SHA-256 on the device and the compose in one
  device pass — and return columnar views
  (:mod:`semantic_merge_tpu_torch.ops.oplog_view`). The merge builds its
  symbol maps while the device works.
- **The two-program path**: the device diff join
  (:mod:`semantic_merge_tpu_torch.ops.diff`; both sides of a merge in
  one call) decodes back into ``Diff`` records, the changeSignature
  refinement runs (with the embedding matcher, whose encoder runs on the
  device), :func:`semantic_merge_tpu_torch.core.difflift.lift` mints the
  op logs (with decl payloads under structured apply), the statement ops
  follow (:func:`~semantic_merge_tpu_torch.core.difflift.lift_statements`),
  and a merge composes them on the device
  (:mod:`semantic_merge_tpu_torch.ops.compose`). It also takes a merge
  whose fused capacity retries run out.

Both paths give op logs, composed stream and conflicts byte-identical to
the JAX package's: same scan, same enumeration order, same
deterministic ids, same composition.

Warm residency (``service/residency.py``, on inside the merge service):
every backend of the process adopts one shared interner
(:func:`shared_interner`), so encoded snapshots stay valid across the
requests' backends; a snapshot annotated with its tree
(``frontend/snapshot.py::annotate_residency``, the base of a merge or a
diff) is served from the residency cache when resident — no scan, no
encode — under its identity ``(interner token, per-file decl-cache
keys)``, which also keys the fused engine's device decl columns, so a
repeat base ships no bytes to the card either.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from ..core.difflift import (Diff, lift, lift_statements, refine_signature_changes,
                             source_maps)
from ..core.encode import Interner, encode_decls_keyed
from ..core.ids import EPOCH_ISO
from ..core.ops import Op
from ..device import resolve_device
from ..frontend.declcache import DeclCache, global_cache
from ..frontend.scanner import DeclNode, ScanStats, scan_snapshot_keyed
from ..frontend.snapshot import TS_EXTENSIONS, Snapshot, filter_files
from ..obs import device as obs_device
from ..obs import spans as obs_spans
from ..ops.compose import compose_oplogs_device
from ..ops.fused import FusedMergeEngine
from ..ops.diff import (KIND_ADD, KIND_DELETE, KIND_MOVE, KIND_RENAME,
                        DiffOpsTensor, diff_lift_device, diff_lift_device_pair)
from .base import BuildAndDiffResult, register_backend, symbol_map


#: The process-shared interner of warm residency (see the module
#: docstring); replaced only by the growth guard
#: (:meth:`TorchTSBackend._maybe_reset_interner`).
_SHARED_INTERNER: Interner | None = None
_SHARED_LOCK = threading.Lock()
#: Interned strings past which a long-lived process starts a new id
#: space (the JAX package's guard).
INTERNER_RESET_SIZE = 4_000_000


def shared_interner() -> Interner:
    """The process-shared interner, made on first use."""
    global _SHARED_INTERNER
    with _SHARED_LOCK:
        if _SHARED_INTERNER is None:
            it = Interner()
            it.shared = True
            _SHARED_INTERNER = it
        return _SHARED_INTERNER


def reset_shared_interner(old: Interner | None = None) -> Interner:
    """Replace the process-shared interner, unless ``old`` is given and
    another caller replaced it already (the growth guard; tests), and
    return the current one: every identity and resident entry of the
    old one goes stale."""
    global _SHARED_INTERNER
    with _SHARED_LOCK:
        if old is None or _SHARED_INTERNER is old:
            it = Interner()
            it.shared = True
            _SHARED_INTERNER = it
        return _SHARED_INTERNER


def ts_files(snap: Snapshot):
    """The TS/JS subset of a snapshot — the exact file set the reference
    bridge snapshots (reference ``semmerge/lang/ts/bridge.py:75``)."""
    return filter_files(snap, TS_EXTENSIONS)


class DeviceDiffBackend:
    """The two-program path every engine of the port shares: the device
    diff join of both sides in one call, decoded back into ``Diff``
    records, the changeSignature refinement (with the embedding matcher,
    whose encoder runs on the device), the lift, the statement ops, and
    the compose on the device. A subclass gives ``extensions`` (the files
    it owns; :meth:`_files` filters a snapshot to them) and its scan
    (``_scan_encode``); ``phases`` holds the seconds of each phase of the
    last call."""

    extensions: frozenset = frozenset()

    def __init__(self, device: str | None = None) -> None:
        self.device = resolve_device(device)
        obs_device.note_device(self.device)
        self.phases: Dict[str, float | int | str] = {}
        self.path: str | None = None

    def _files(self, snap: Snapshot):
        return filter_files(snap, self.extensions)

    def _diff_two_program(self, base, right, base_nodes, right_nodes, base_t, right_t, clock,
                          *, base_rev, seed, timestamp, change_signature, structured_apply,
                          signature_matcher, statement_ops) -> List[Op]:
        """:meth:`diff` on the two-program path, after the scan."""
        self.path = "two-program"
        t = diff_lift_device(base_t, right_t, self.device)
        clock.lap("device_diff")
        diffs = decode_diffs(t, base_t, right_t, base_nodes, right_nodes)
        clock.lap("decode")
        return self._lift_side(diffs, base, right, base_nodes, right_nodes, clock, side="R",
                               base_rev=base_rev, seed=seed, timestamp=timestamp,
                               change_signature=change_signature,
                               structured_apply=structured_apply,
                               signature_matcher=signature_matcher,
                               statement_ops=statement_ops)

    def _lift_side(self, diffs, base, side_snap, base_nodes, side_nodes, clock, *, side,
                   base_rev, seed, timestamp, change_signature, structured_apply,
                   signature_matcher, statement_ops) -> List[Op]:
        """One side's op log from its decoded diffs (``ts_tpu.py``
        ``build_and_diff``): the changeSignature refinement, the lift
        with seed ``seed + "/" + side`` (carrying decl payloads under
        structured apply), then the statement ops, whose ids continue
        the lift's index."""
        want_sources = structured_apply or (change_signature and signature_matcher is not None)
        files = (self._files(base), self._files(side_snap))
        sources = source_maps(*files) if want_sources else None
        if change_signature:
            diffs = refine_signature_changes(diffs, sources, signature_matcher)
            clock.lap("refine")
        stmt: List[Op] = []
        if statement_ops:
            stmt = lift_statements(diffs, base_nodes, side_nodes, sources, files,
                                   base_rev=base_rev, seed=seed, side=side,
                                   timestamp=timestamp)
            clock.lap("statements")
        ops = lift(base_rev, diffs, seed=f"{seed}/{side}", timestamp=timestamp,
                   sources=sources if structured_apply else None)
        clock.lap("lift")
        return ops + stmt

    def build_and_diff(self, base: Snapshot, left: Snapshot, right: Snapshot,
                       *, base_rev: str = "base", seed: str = "0",
                       timestamp: str | None = None,
                       change_signature: bool = False,
                       structured_apply: bool = False,
                       signature_matcher=None,
                       statement_ops: bool = False) -> BuildAndDiffResult:
        """Both sides' op logs: the three snapshots scanned and interned
        into one id space, both diffs in one device call, then each side
        as :meth:`_lift_side` makes it, with sides ``"L"`` and ``"R"``."""
        clock = _PhaseClock(self.phases)
        snaps = (base, left, right)
        nodes, tensors = self._scan_encode(snaps, clock)
        return self._diff_lift(snaps, nodes, tensors, clock, base_rev=base_rev, seed=seed,
                               timestamp=timestamp, change_signature=change_signature,
                               structured_apply=structured_apply,
                               signature_matcher=signature_matcher,
                               statement_ops=statement_ops)

    def _diff_lift(self, snaps, nodes, tensors, clock, *, base_rev, seed, timestamp,
                   change_signature, structured_apply, signature_matcher,
                   statement_ops) -> BuildAndDiffResult:
        """:meth:`build_and_diff` after the scan."""
        self.path = "two-program"
        ts = timestamp or EPOCH_ISO
        base, left, right = snaps
        base_t, left_t, right_t = tensors
        t_l, t_r = diff_lift_device_pair(base_t, left_t, right_t, self.device)
        clock.lap("device_diff")
        diffs_l = decode_diffs(t_l, base_t, left_t, nodes[0], nodes[1])
        diffs_r = decode_diffs(t_r, base_t, right_t, nodes[0], nodes[2])
        clock.lap("decode")
        kw = dict(base_rev=base_rev, seed=seed, timestamp=ts,
                  change_signature=change_signature, structured_apply=structured_apply,
                  signature_matcher=signature_matcher, statement_ops=statement_ops)
        return BuildAndDiffResult(
            op_log_left=self._lift_side(diffs_l, base, left, nodes[0], nodes[1], clock,
                                        side="L", **kw),
            op_log_right=self._lift_side(diffs_r, base, right, nodes[0], nodes[2], clock,
                                         side="R", **kw),
            symbol_maps={key: symbol_map(n)
                         for key, n in zip(("base", "left", "right"), nodes)},
        )

    def compose(self, delta_a: List[Op], delta_b: List[Op]):
        """The two op logs composed on the backend's device:
        ``(composed ops, conflicts)``."""
        return compose_oplogs_device(delta_a, delta_b, self.device)

    def close(self) -> None:
        """Nothing to release (the JAX backends' ``close``)."""


class TorchTSBackend(DeviceDiffBackend):
    """``device``: ``None``/``"cuda"`` for the card, ``"cpu"`` only when
    asked for. ``host_workers``: the fused path's host-tail workers
    (``[engine] host_workers``; ``None`` = auto). ``native_scan``: scan
    with the C++ library (the default) or, when false, the Python
    scanner; ``decl_cache``: the decl cache to scan through (``None``,
    the default, is the process-wide one). ``phases`` holds the seconds
    each phase of the last :meth:`diff`, :meth:`build_and_diff` or
    :meth:`merge` took, which scanner ran (``scanner``) and the decl
    cache's hits and misses in that call; ``path`` says which path it
    took (``"fused"`` or ``"two-program"``). The interner and the fused
    engine live as long as the backend."""

    name = "torch"
    #: The files this backend's semantic pipeline owns; the merge's text
    #: layer merges every other file (``runtime/textmerge.py``).
    extensions = frozenset(TS_EXTENSIONS)
    #: The applier resolves the merge's ``reorderImports`` lists in one
    #: batched device program for this engine (``ops/crdt.py``; a
    #: capability of this class only, so the C-family engines sharing
    #: :class:`DeviceDiffBackend` keep the host RGA, as in the JAX
    #: package).
    device_crdt = True

    def __init__(self, device: str | None = None,
                 host_workers: int | None = None, *, native_scan: bool = True,
                 decl_cache: DeclCache | None = None) -> None:
        super().__init__(device)
        self.host_workers = host_workers
        self.native_scan = native_scan
        self.decl_cache = decl_cache
        from ..service import residency
        self._interner = shared_interner() if residency.residency_enabled() else Interner()
        self._fused: FusedMergeEngine | None = None
        #: The identities of the last call's snapshots (``None`` where a
        #: file had no stable decl-cache key).
        self._keys: tuple = ()

    def _fused_engine(self) -> FusedMergeEngine:
        if self._fused is None or self._fused.interner is not self._interner:
            self._fused = FusedMergeEngine(self._interner, self.device,
                                           host_workers=self.host_workers)
        return self._fused

    def _maybe_reset_interner(self) -> None:
        """Unbounded-growth guard for long-lived processes, run between
        calls (never between the scans of one merge, which must share an
        id space): a new id space past :data:`INTERNER_RESET_SIZE`
        strings; the new token makes every cached identity stale."""
        if len(self._interner.strings) <= INTERNER_RESET_SIZE:
            return
        if self._interner.shared:
            self._interner = reset_shared_interner(self._interner)
        else:
            self._interner = Interner()

    def _scan_encode(self, snaps, clock):
        """Scan and encode ``snaps`` into the backend's id space: the
        decl node lists and their tensors; ``self._keys`` gets their
        identities. The encode caches each file's columns in the scan's
        decl cache (:func:`~semantic_merge_tpu_torch.core.encode.
        encode_decls_keyed`, as ``ts_tpu.py`` does). A snapshot resident
        in the warm residency cache skips both (span ``residency.hit``);
        an annotated one that is not becomes resident (span
        ``residency.encode_delta``). Phases ``scan`` and ``encode``,
        ``residency_hits``."""
        from ..service import residency
        self._maybe_reset_interner()
        tok = self._interner.token
        enabled = residency.residency_enabled()
        res_keys = [residency.resident_key(s) if enabled else None for s in snaps]
        hits = []
        for key in res_keys:
            entry = None
            if key is not None:
                t0 = time.perf_counter()
                entry = residency.cache().lookup(key, token=tok)
                if entry is not None:
                    obs_spans.record("residency.hit", time.perf_counter() - t0,
                                     layer="frontend", t_start=t0,
                                     repo=key[0] or "synthetic")
            hits.append(entry)
        stats = ScanStats()
        keyed = [None if hit is not None else
                 scan_snapshot_keyed(ts_files(snap), cache=self.decl_cache,
                                     native=self.native_scan, stats=stats)
                 for snap, hit in zip(snaps, hits)]
        clock.lap("scan")
        self.phases.update(scanner=stats.scanner, decl_cache_hits=stats.hits,
                           decl_cache_misses=stats.misses,
                           residency_hits=sum(h is not None for h in hits))
        cache = self.decl_cache if self.decl_cache is not None else global_cache()
        nodes, tensors, idents = [], [], []
        for res_key, hit, kn in zip(res_keys, hits, keyed):
            if hit is not None:
                nodes.append(hit.nodes)
                tensors.append(hit.t)
                idents.append(hit.identity)
                continue
            t0 = time.perf_counter()
            t, flat = encode_decls_keyed(kn, self._interner, cache)
            keys = tuple(k for k, _ in kn)
            ident = (tok, keys) if all(k is not None for k in keys) else None
            if res_key is not None:
                obs_spans.record("residency.encode_delta", time.perf_counter() - t0,
                                 layer="frontend", t_start=t0,
                                 repo=res_key[0] or "synthetic")
                residency.cache().put(res_key, t, flat, ident)
            nodes.append(flat)
            tensors.append(t)
            idents.append(ident)
        clock.lap("encode")
        self._keys = tuple(idents)
        return nodes, tensors

    def diff(self, base: Snapshot, right: Snapshot,
             *, base_rev: str = "base", seed: str = "0",
             timestamp: str | None = None,
             change_signature: bool = False,
             structured_apply: bool = False,
             signature_matcher=None,
             statement_ops: bool = False) -> List[Op]:
        """The op log from ``base`` to ``right``: the fused engine's
        :class:`~semantic_merge_tpu_torch.ops.oplog_view.OpStreamView`
        without changeSignature, structured apply and statement ops
        (``ts_tpu.py`` ``diff``), else (and when the fused capacity
        retries run out) a list from the two-program path."""
        ts = timestamp or EPOCH_ISO
        clock = _PhaseClock(self.phases)
        (base_nodes, right_nodes), (base_t, right_t) = self._scan_encode(
            (base, right), clock)
        if not (change_signature or structured_apply or statement_ops):
            engine = self._fused_engine()
            view = engine.diff(base_t, base_nodes, right_t, right_nodes,
                               seed=seed, base_rev=base_rev, timestamp=ts,
                               keys=self._keys)
            clock.lap("fused")
            self.phases.update(engine.phases)
            if view is not None:
                self.path = "fused"
                return view
        return self._diff_two_program(base, right, base_nodes, right_nodes, base_t, right_t,
                                      clock, base_rev=base_rev, seed=seed, timestamp=ts,
                                      change_signature=change_signature,
                                      structured_apply=structured_apply,
                                      signature_matcher=signature_matcher,
                                      statement_ops=statement_ops)

    def merge(self, base: Snapshot, left: Snapshot, right: Snapshot,
              *, base_rev: str = "base", seed: str = "0",
              timestamp: str | None = None,
              change_signature: bool = False,
              structured_apply: bool = False,
              signature_matcher=None,
              statement_ops: bool = False):
        """Full three-way merge. Returns ``(BuildAndDiffResult, composed
        ops, conflicts)``.

        The fused engine runs first (``ts_tpu.py`` ``merge``): its op
        logs are :class:`~semantic_merge_tpu_torch.ops.oplog_view.
        OpStreamView`s and its composed stream a column-backed
        :class:`~semantic_merge_tpu_torch.ops.oplog_view.ComposedOpView`
        for the columnar applier. With changeSignature, a side whose
        rows hold a foldable delete+add pair would be rewritten by the
        refinement, so that merge — like one whose capacity retries run
        out — takes the two-program path on the same scan: the steps of
        :meth:`build_and_diff`, then :meth:`compose`. With structured
        apply or statement ops the fused engine does not run at all.

        Spans as ``ts_tpu.py`` emits them: ``scan_encode`` (layer
        ``frontend``), ``fused_merge``, and on the two-program path
        ``build_and_diff`` and ``compose`` (layer ``backend``). The JAX
        backend re-scans inside its ``build_and_diff`` (decl-cache
        hits); this one reuses the scan, so that span holds no ``scan``."""
        ts = timestamp or EPOCH_ISO
        clock = _PhaseClock(self.phases)
        snaps = (base, left, right)
        with obs_spans.span("scan_encode", layer="frontend"):
            nodes, tensors = self._scan_encode(snaps, clock)
        base_t, left_t, right_t = tensors
        maps: Dict[str, List[dict]] = {}

        def build_symbol_maps():
            maps.update(zip(("base", "left", "right"), map(symbol_map, nodes)))

        fused = None
        if not (structured_apply or statement_ops):
            engine = self._fused_engine()
            with obs_spans.span("fused_merge", layer="backend", backend=self.name):
                fused = engine.merge(base_t, nodes[0], left_t, nodes[1], right_t, nodes[2],
                                     seed=seed, base_rev=base_rev, timestamp=ts,
                                     overlap_work=build_symbol_maps, keys=self._keys)
            clock.lap("fused")
            self.phases.update(engine.phases)
        if fused is not None:
            ops_l, ops_r, composed, conflicts = fused
            if not (change_signature
                    and (_changesig_candidates(ops_l, signature_matcher)
                         or _changesig_candidates(ops_r, signature_matcher))):
                self.path = "fused"
                return BuildAndDiffResult(ops_l, ops_r, maps), composed, conflicts
        with obs_spans.span("build_and_diff", layer="backend", backend=self.name):
            result = self._diff_lift(snaps, nodes, tensors, clock, base_rev=base_rev,
                                     seed=seed, timestamp=timestamp,
                                     change_signature=change_signature,
                                     structured_apply=structured_apply,
                                     signature_matcher=signature_matcher,
                                     statement_ops=statement_ops)
        with obs_spans.span("compose", layer="backend", backend=self.name):
            composed, conflicts = self.compose(result.op_log_left, result.op_log_right)
        clock.lap("compose")
        self.path = "two-program"
        return result, composed, conflicts


class _PhaseClock:
    def __init__(self, phases: Dict[str, float]) -> None:
        phases.clear()
        self._phases = phases
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        """Adds the seconds since the last lap to phase ``name``."""
        now = time.perf_counter()
        self._phases[name] = self._phases.get(name, 0.0) + now - self._t
        self._t = now


def _changesig_candidates(view, matcher) -> bool:
    """Could ``refine_signature_changes`` rewrite this fused op stream?
    Its exact-key pass pairs a deleted and an added decl sharing
    ``(file, name, kind)``; with a model ``matcher`` the residual pass
    keys by ``(kind, file)``, so any delete+add pair at all counts.
    ``view`` is an ``OpStreamView``; only its delete and add rows' nodes
    are read."""
    del_rows = np.nonzero(view.kind == KIND_DELETE)[0]
    add_rows = np.nonzero(view.kind == KIND_ADD)[0]
    if not len(del_rows) or not len(add_rows):
        return False
    if matcher is not None:
        return True
    dels = {(a.file, a.name, a.kind)
            for a in map(view.base_nodes.__getitem__, view.a_slot[del_rows].tolist())
            if a.name}
    return any(b.name and (b.file, b.name, b.kind) in dels
               for b in map(view.side_nodes.__getitem__, view.b_slot[add_rows].tolist()))


def decode_diffs(t: DiffOpsTensor, base_t, side_t,
                 base_nodes: List[DeclNode],
                 side_nodes: List[DeclNode]) -> List[Diff]:
    """Device op stream → ``Diff`` records.

    Rows carry interned addressIds; the full node data (kind, signature
    — needed by lift and by changeSignature refinement) is recovered by
    addressId lookup. addressIds embed ``file::name::pos`` so they are
    unique per node within a snapshot (reference
    ``workers/ts/src/sast.ts:65-67``); under Map last-wins collisions
    the device join already selected the surviving occurrence's address.
    """
    base_by_id: Dict[int, DeclNode] = dict(zip(base_t.addr.tolist(), base_nodes))
    side_by_id: Dict[int, DeclNode] = dict(zip(side_t.addr.tolist(), side_nodes))
    kinds = {KIND_RENAME: "rename", KIND_MOVE: "move",
             KIND_ADD: "add", KIND_DELETE: "delete"}
    n = t.n_ops
    bget, sget = base_by_id.get, side_by_id.get
    return [Diff(kinds[k], a=bget(a), b=sget(b))
            for k, a, b in zip(t.kind[:n].tolist(), t.a_addr[:n].tolist(),
                               t.b_addr[:n].tolist())]


#: The JAX package's four names of its TypeScript engines, which give the
#: same bytes there: each is this engine on the device it is given.
for _name in ("tpu", "ts_tpu", "host", "ts_host"):
    register_backend(_name, TorchTSBackend)
