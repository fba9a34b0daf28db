"""TypeScript backend on the GPU — the port's semantic diff and merge.

The counterpart of the JAX package's ``TpuTSBackend``
(``backends/ts_tpu.py``), single device. The host scans the snapshots
and interns them into the backend's one id space; then, as in the JAX
package:

- **The fused path** (the default): :meth:`diff` without
  changeSignature, and :meth:`merge` unless the changeSignature
  refinement could rewrite an op stream (:func:`_changesig_candidates`),
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
  op logs, and a merge composes them on the device
  (:mod:`semantic_merge_tpu_torch.ops.compose`). It also takes a merge
  whose fused capacity retries run out.

Both paths give op logs, composed stream and conflicts byte-identical to
the JAX package's: same scan, same enumeration order, same
deterministic ids, same composition.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ..core.difflift import Diff, lift, refine_signature_changes, source_maps
from ..core.encode import Interner, encode_decls
from ..core.ids import EPOCH_ISO
from ..core.ops import Op
from ..device import resolve_device
from ..frontend.scanner import DeclNode, scan_snapshot_py
from ..frontend.snapshot import TS_EXTENSIONS, Snapshot, filter_files
from ..ops.compose import compose_oplogs_device
from ..ops.fused import FusedMergeEngine
from ..ops.diff import (KIND_ADD, KIND_DELETE, KIND_MOVE, KIND_RENAME,
                        DiffOpsTensor, diff_lift_device, diff_lift_device_pair)


def ts_files(snap: Snapshot):
    """The TS/JS subset of a snapshot — the exact file set the reference
    bridge snapshots (reference ``semmerge/lang/ts/bridge.py:75``)."""
    return filter_files(snap, TS_EXTENSIONS)


@dataclass
class BuildAndDiffResult:
    """Both sides' op logs of a three-way merge (the JAX package's
    ``backends/base.py::BuildAndDiffResult``; reference worker protocol
    ``workers/ts/src/protocol.ts:15-27``)."""

    op_log_left: List[Op]
    op_log_right: List[Op]
    symbol_maps: Dict[str, List[dict]]
    diagnostics: List[object] = field(default_factory=list)


def symbol_map(nodes) -> List[dict]:
    """SymbolMaps payload entry (reference ``workers/ts/src/index.ts:30-35``)."""
    return [{"symbolId": n.symbolId, "addressId": n.addressId} for n in nodes]


class TorchTSBackend:
    """``device``: ``None``/``"cuda"`` for the card, ``"cpu"`` only when
    asked for. ``host_workers``: the fused path's host-tail workers
    (``[engine] host_workers``; ``None`` = auto). ``phases`` holds the
    seconds each phase of the last :meth:`diff` or :meth:`merge` took,
    and ``path`` which path it took (``"fused"`` or ``"two-program"``).
    The interner and the fused engine live as long as the backend."""

    name = "torch"
    #: The files this backend's semantic pipeline owns; the merge's text
    #: layer merges every other file (``runtime/textmerge.py``).
    extensions = frozenset(TS_EXTENSIONS)

    def __init__(self, device: str | None = None,
                 host_workers: int | None = None) -> None:
        self.device = resolve_device(device)
        self.host_workers = host_workers
        self.phases: Dict[str, float] = {}
        self.path: str | None = None
        self._interner = Interner()
        self._fused: FusedMergeEngine | None = None

    def _fused_engine(self) -> FusedMergeEngine:
        if self._fused is None:
            self._fused = FusedMergeEngine(self._interner, self.device,
                                           host_workers=self.host_workers)
        return self._fused

    def _scan_encode(self, snaps, clock):
        nodes = [scan_snapshot_py(ts_files(snap)) for snap in snaps]
        clock.lap("scan")
        tensors = [encode_decls(n, self._interner) for n in nodes]
        clock.lap("encode")
        return nodes, tensors

    def diff(self, base: Snapshot, right: Snapshot,
             *, base_rev: str = "base", seed: str = "0",
             timestamp: str | None = None,
             change_signature: bool = False,
             signature_matcher=None) -> List[Op]:
        """The op log from ``base`` to ``right``: the fused engine's
        :class:`~semantic_merge_tpu_torch.ops.oplog_view.OpStreamView`
        without changeSignature, else (and when the fused capacity
        retries run out) a list from the two-program path."""
        ts = timestamp or EPOCH_ISO
        clock = _PhaseClock(self.phases)
        (base_nodes, right_nodes), (base_t, right_t) = self._scan_encode(
            (base, right), clock)
        if not change_signature:
            engine = self._fused_engine()
            view = engine.diff(base_t, base_nodes, right_t, right_nodes,
                               seed=seed, base_rev=base_rev, timestamp=ts)
            clock.lap("fused")
            self.phases.update(engine.phases)
            if view is not None:
                self.path = "fused"
                return view
        self.path = "two-program"
        t = diff_lift_device(base_t, right_t, self.device)
        clock.lap("device_diff")
        diffs = decode_diffs(t, base_t, right_t, base_nodes, right_nodes)
        clock.lap("decode")
        if change_signature:
            sources = (source_maps(ts_files(base), ts_files(right))
                       if signature_matcher is not None else None)
            diffs = refine_signature_changes(diffs, sources, signature_matcher)
            clock.lap("refine")
        ops = lift(base_rev, diffs, seed=seed + "/R", timestamp=ts)
        clock.lap("lift")
        return ops

    def build_and_diff(self, base: Snapshot, left: Snapshot, right: Snapshot,
                       *, base_rev: str = "base", seed: str = "0",
                       timestamp: str | None = None,
                       change_signature: bool = False,
                       signature_matcher=None) -> BuildAndDiffResult:
        """Both sides' op logs: the three snapshots scanned and interned
        into one id space, both diffs in one device call, each side
        refined with the matcher, lifted with seeds ``seed + "/L"`` and
        ``seed + "/R"``."""
        clock = _PhaseClock(self.phases)
        snaps = (base, left, right)
        nodes, tensors = self._scan_encode(snaps, clock)
        return self._diff_lift(snaps, nodes, tensors, clock, base_rev=base_rev, seed=seed,
                               timestamp=timestamp, change_signature=change_signature,
                               signature_matcher=signature_matcher)

    def _diff_lift(self, snaps, nodes, tensors, clock, *, base_rev, seed, timestamp,
                   change_signature, signature_matcher) -> BuildAndDiffResult:
        """:meth:`build_and_diff` after the scan."""
        ts = timestamp or EPOCH_ISO
        base, left, right = snaps
        base_t, left_t, right_t = tensors
        t_l, t_r = diff_lift_device_pair(base_t, left_t, right_t, self.device)
        clock.lap("device_diff")
        diffs_l = decode_diffs(t_l, base_t, left_t, nodes[0], nodes[1])
        diffs_r = decode_diffs(t_r, base_t, right_t, nodes[0], nodes[2])
        clock.lap("decode")
        if change_signature:
            want = signature_matcher is not None
            src_l = source_maps(ts_files(base), ts_files(left)) if want else None
            src_r = source_maps(ts_files(base), ts_files(right)) if want else None
            diffs_l = refine_signature_changes(diffs_l, src_l, signature_matcher)
            diffs_r = refine_signature_changes(diffs_r, src_r, signature_matcher)
            clock.lap("refine")
        result = BuildAndDiffResult(
            op_log_left=lift(base_rev, diffs_l, seed=seed + "/L", timestamp=ts),
            op_log_right=lift(base_rev, diffs_r, seed=seed + "/R", timestamp=ts),
            symbol_maps={key: symbol_map(n)
                         for key, n in zip(("base", "left", "right"), nodes)},
        )
        clock.lap("lift")
        return result

    def compose(self, delta_a: List[Op], delta_b: List[Op]):
        """The two op logs composed on the backend's device:
        ``(composed ops, conflicts)``."""
        return compose_oplogs_device(delta_a, delta_b, self.device)

    def merge(self, base: Snapshot, left: Snapshot, right: Snapshot,
              *, base_rev: str = "base", seed: str = "0",
              timestamp: str | None = None,
              change_signature: bool = False,
              signature_matcher=None):
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
        :meth:`build_and_diff`, then :meth:`compose`."""
        ts = timestamp or EPOCH_ISO
        clock = _PhaseClock(self.phases)
        snaps = (base, left, right)
        nodes, tensors = self._scan_encode(snaps, clock)
        base_t, left_t, right_t = tensors
        maps: Dict[str, List[dict]] = {}

        def build_symbol_maps():
            maps.update(zip(("base", "left", "right"), map(symbol_map, nodes)))

        engine = self._fused_engine()
        fused = engine.merge(base_t, nodes[0], left_t, nodes[1], right_t, nodes[2],
                             seed=seed, base_rev=base_rev, timestamp=ts,
                             overlap_work=build_symbol_maps)
        clock.lap("fused")
        self.phases.update(engine.phases)
        if fused is not None:
            ops_l, ops_r, composed, conflicts = fused
            if not (change_signature
                    and (_changesig_candidates(ops_l, signature_matcher)
                         or _changesig_candidates(ops_r, signature_matcher))):
                self.path = "fused"
                return BuildAndDiffResult(ops_l, ops_r, maps), composed, conflicts
        result = self._diff_lift(snaps, nodes, tensors, clock, base_rev=base_rev, seed=seed,
                                 timestamp=timestamp, change_signature=change_signature,
                                 signature_matcher=signature_matcher)
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
        now = time.perf_counter()
        self._phases[name] = now - self._t
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
