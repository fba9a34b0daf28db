"""TypeScript backend on the GPU — the port's semantic diff and merge.

The counterpart of the two-program branch of the JAX package's
``TpuTSBackend`` (``backends/ts_tpu.py``): the host scans and interns the
snapshots, the device runs the diff join
(:mod:`semantic_merge_tpu_torch.ops.diff`; both sides of a merge in one
call), the op stream decodes back into ``Diff`` records, the optional
changeSignature refinement runs (with the embedding matcher, whose
encoder runs on the device), and the shared
:func:`semantic_merge_tpu_torch.core.difflift.lift` mints the op logs.
A merge then composes the two logs on the device
(:mod:`semantic_merge_tpu_torch.ops.compose`). Op logs, composed stream
and conflicts are byte-identical to the JAX package's by construction:
same scan, same enumeration order, same deterministic ids, same
composition. The JAX package's fused one-program engine gives the same
output; it is not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

from ..core.difflift import Diff, lift, refine_signature_changes, source_maps
from ..core.encode import Interner, encode_decls
from ..core.ids import EPOCH_ISO
from ..core.ops import Op
from ..device import resolve_device
from ..frontend.scanner import DeclNode, scan_snapshot_py
from ..frontend.snapshot import TS_EXTENSIONS, Snapshot, filter_files
from ..ops.compose import compose_oplogs_device
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
    asked for. ``phases`` holds the seconds each phase of the last
    :meth:`diff` or :meth:`merge` took."""

    name = "torch"
    #: The files this backend's semantic pipeline owns; the merge's text
    #: layer merges every other file (``runtime/textmerge.py``).
    extensions = frozenset(TS_EXTENSIONS)

    def __init__(self, device: str | None = None) -> None:
        self.device = resolve_device(device)
        self.phases: Dict[str, float] = {}

    def diff(self, base: Snapshot, right: Snapshot,
             *, base_rev: str = "base", seed: str = "0",
             timestamp: str | None = None,
             change_signature: bool = False,
             signature_matcher=None) -> List[Op]:
        ts = timestamp or EPOCH_ISO
        clock = _PhaseClock(self.phases)
        interner = Interner()
        base_nodes = scan_snapshot_py(ts_files(base))
        right_nodes = scan_snapshot_py(ts_files(right))
        clock.lap("scan")
        base_t = encode_decls(base_nodes, interner)
        right_t = encode_decls(right_nodes, interner)
        clock.lap("encode")
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
        ts = timestamp or EPOCH_ISO
        clock = _PhaseClock(self.phases)
        interner = Interner()
        nodes = [scan_snapshot_py(ts_files(snap)) for snap in (base, left, right)]
        clock.lap("scan")
        base_t, left_t, right_t = (encode_decls(n, interner) for n in nodes)
        clock.lap("encode")
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
        """Full three-way merge: :meth:`build_and_diff`, then
        :meth:`compose`. Returns ``(BuildAndDiffResult, composed ops,
        conflicts)``."""
        result = self.build_and_diff(base, left, right, base_rev=base_rev, seed=seed,
                                     timestamp=timestamp,
                                     change_signature=change_signature,
                                     signature_matcher=signature_matcher)
        t0 = time.perf_counter()
        composed, conflicts = self.compose(result.op_log_left, result.op_log_right)
        self.phases["compose"] = time.perf_counter() - t0
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
