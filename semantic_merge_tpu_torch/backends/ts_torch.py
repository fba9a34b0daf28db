"""TypeScript backend on the GPU — the port's semantic diff.

The counterpart of the two-program branch of the JAX package's
``TpuTSBackend.diff`` (``backends/ts_tpu.py``): the host scans and
interns both snapshots, the device runs the diff join
(:mod:`semantic_merge_tpu_torch.ops.diff`), the op stream decodes back
into ``Diff`` records, the optional changeSignature refinement runs
(with the embedding matcher, whose encoder runs on the device), and the
shared :func:`semantic_merge_tpu_torch.core.difflift.lift` mints the op
log. The op log is byte-identical to the JAX package's by construction:
same scan, same enumeration order, same deterministic ids. The JAX
package's fused one-program engine gives the same op log; it is not
ported yet.
"""
from __future__ import annotations

import time
from typing import Dict, List

from ..core.difflift import Diff, lift, refine_signature_changes, source_maps
from ..core.encode import Interner, encode_decls
from ..core.ids import EPOCH_ISO
from ..core.ops import Op
from ..device import resolve_device
from ..frontend.scanner import DeclNode, scan_snapshot_py
from ..frontend.snapshot import TS_EXTENSIONS, Snapshot, filter_files
from ..ops.diff import (KIND_ADD, KIND_DELETE, KIND_MOVE, KIND_RENAME,
                        DiffOpsTensor, diff_lift_device)


def ts_files(snap: Snapshot):
    """The TS/JS subset of a snapshot — the exact file set the reference
    bridge snapshots (reference ``semmerge/lang/ts/bridge.py:75``)."""
    return filter_files(snap, TS_EXTENSIONS)


class TorchTSBackend:
    """``device``: ``None``/``"cuda"`` for the card, ``"cpu"`` only when
    asked for. ``phases`` holds the seconds each phase of the last
    :meth:`diff` took."""

    name = "torch"

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
