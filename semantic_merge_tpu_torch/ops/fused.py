"""The fused merge: diff, op identity and compose in one device pass.

The port of the JAX package's ``ops/fused.py`` (single device). The
two-program path (:mod:`.diff` then :mod:`.compose`) fetches the diff
rows, builds ``Op`` objects, hashes their ids one ``hashlib`` call at a
time and ships an encoding back. This module keeps everything between
the scan and the final decode on the card:

1. **diff** both sides against base with the join plan of :mod:`.diff`,
   emitting compact ``(kind, base slot, side slot)`` rows (slots index
   the scanned decl lists, so the host builds ops without any string
   round trip);
2. **op identity** — each op's fixed 51-byte id payload ((seed, rev)
   prefix digest ‖ index ‖ type code ‖ three 80-bit string digests, see
   :func:`semantic_merge_tpu_torch.core.ids.deterministic_op_id`) is
   assembled from a device-resident digest table and hashed in one
   SHA-256 block per row by the CUDA kernel behind
   :func:`semantic_merge_tpu_torch.ops.sha256.sha256_device`;
3. **id tiebreaks from the digest words** — UUID-shaped hex ids order
   exactly like their leading 128 digest bits, so the canonical sort
   takes the four uint32 words as its trailing keys;
4. **compose** — one canonical sort of both sides, the DivergentRename
   candidate precheck and the segmented chain scans of :mod:`.compose`,
   on columns derived from the diff rows (the scan's interner ids are
   the compose's equality ids);
5. a **split fetch**: ``head`` (op rows and digest words) first, then
   ``mid`` (canonical permutations and composed-stream references), and
   ``chains`` (the chain overrides) only when the composed view is read.

Conflicts are handled speculatively: the device runs the parallel
candidate join only. Without candidates the fetched result is final;
with them the host replays the reference's cursor walk on the rename
rows (:func:`.oplog_view.cursor_walk_conflicts_renames_only`) and patches
the few affected symbols.

torch has no multi-key sort: the seven-key canonical order (precedence,
timestamp rank, side, four digest words) is a chain of stable sorts,
least significant first, over int64 keys that each pack two of them
(:func:`_canonical_order`). Where JAX scatters with ``mode="drop"``,
this module scatters into a buffer with one extra sink column, as
:mod:`.diff` does. The host tail (chain decode, op materialization) runs
in row-range shards over a worker pool (:class:`TailPipeline`).

Replaces the hot path of reference ``workers/ts/src/diff.ts:5-31``,
``workers/ts/src/lift.ts:11-66`` and ``semmerge/compose.py:51-112``.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.conflict import Conflict, divergent_rename_conflict
from ..core.encode import (NULL_ID, PAD_ID, DeclTensor, Interner, bucket_size,
                           pad_to, shard_ranges)
from ..core.ids import op_id_prefix_digest, value_digest10
from ..core.ops import dumps_canonical
from ..utils import faults
from .compose import _PAD_PREC, _rename_candidates_cols, _seg_last_valid
from .diff import KIND_ADD, KIND_DELETE, KIND_MOVE, KIND_RENAME, _diff_plan
from .oplog_view import (ComposedOpView, OpStreamView, _get_fields,
                         cursor_walk_conflicts_renames_only)
from .sha256 import sha256_device

#: OP_PRECEDENCE of each KIND_* code (core/ops.py).
_PREC_BY_KIND = (11, 10, 30, 31)

#: Byte length of the fixed op-id payload (core.ids.deterministic_op_id):
#: prefix digest 16 + index 4 + type code 1 + three 10-byte digests.
_ID_PAYLOAD_LEN = 51


# --------------------------------------------------------------------------
# Host-tail pipeline: sharded chain decode and op materialization
# --------------------------------------------------------------------------

def resolve_host_workers(configured: Optional[int] = None) -> int:
    """Worker count of the host-tail pipeline: ``[engine] host_workers``
    (``configured``), else ``min(8, cpu_count)``; at least 1. Output
    does not depend on it."""
    if configured:
        return max(1, int(configured))
    return min(8, os.cpu_count() or 1)


_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0


def _host_pool(workers: int) -> ThreadPoolExecutor:
    """The process-shared tail worker pool, resized on demand."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None or _pool_size != workers:
            if _pool is not None:
                _pool.shutdown(wait=False)
            _pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="semmerge-tail")
            _pool_size = workers
        return _pool


class _Immediate:
    """Future-shaped thunk run at ``result()`` — the inline mode of
    :meth:`TailPlan.submit_materialize`."""

    __slots__ = ("_fn", "_val", "_done")

    def __init__(self, fn) -> None:
        self._fn = fn
        self._val = None
        self._done = False

    def result(self):
        if not self._done:
            self._val = self._fn()
            self._done = True
            self._fn = None
        return self._val


class _OnceCell:
    """Thread-safe memoized thunk: shards share one chains fetch."""

    __slots__ = ("_fn", "_lock", "_val", "_done")

    def __init__(self, fn) -> None:
        self._fn = fn
        self._lock = threading.Lock()
        self._val = None
        self._done = False

    def get(self):
        if self._done:
            return self._val
        with self._lock:
            if not self._done:
                self._val = self._fn()
                self._done = True
                self._fn = None
        return self._val


#: Rows of one host-tail shard.
TAIL_SHARD_ROWS = 8192


class TailPipeline:
    """Worker pool and shard geometry for the fused path's host tail.

    ``shard_rows`` (default :data:`TAIL_SHARD_ROWS`) bounds a shard;
    shard results join in shard order, so output is identical for every
    worker count. ``eager_overlap`` (more than one worker and more
    than one core) pre-submits shard decodes when the merge returns;
    otherwise shards run lazily, inline, in order."""

    __slots__ = ("workers", "shard_rows", "eager_overlap")

    def __init__(self, workers: Optional[int] = None,
                 shard_rows: int = TAIL_SHARD_ROWS) -> None:
        self.workers = workers if workers else resolve_host_workers()
        self.shard_rows = shard_rows
        self.eager_overlap = self.workers > 1 and (os.cpu_count() or 1) > 1

    def submit(self, fn, *args):
        return _host_pool(self.workers).submit(fn, *args)


class TailPlan:
    """Shard plan of ONE merge's composed stream: the row ranges, the
    chain-decode function ``decode_fn(lo, hi) -> (addr, file, name)``
    and its memoized per-shard results. Driven eagerly
    (:meth:`prefetch`) or lazily (first access); a queued decode that
    has not started is cancelled and computed inline by its consumer, so
    consumers never wait behind their own pool."""

    def __init__(self, pipeline: TailPipeline, n: int, decode_fn) -> None:
        self.pipeline = pipeline
        self.ranges = shard_ranges(n, pipeline.shard_rows)
        self._decode_fn = decode_fn
        self._lock = threading.Lock()
        self._decoded: Dict[Tuple[int, int], object] = {}

    def prefetch(self) -> None:
        """Submit every shard's chain decode to the pool now."""
        with self._lock:
            for r in self.ranges:
                if r not in self._decoded:
                    self._decoded[r] = self.pipeline.submit(self._decode_fn, *r)

    def shard_overrides(self, lo: int, hi: int):
        """One shard's decoded chain overrides ``(addr, file, name)``:
        cached, claimed from a pool future, or computed inline."""
        key = (lo, hi)
        with self._lock:
            ent = self._decoded.get(key)
        if isinstance(ent, tuple):
            return ent
        if ent is not None and not ent.cancel():
            out = ent.result()
        else:
            out = self._decode_fn(lo, hi)
        with self._lock:
            self._decoded[key] = out
        return out

    def submit_materialize(self, lo: int, hi: int, build_fn):
        """One shard's ops, ``build_fn(lo, hi, overrides)``: a pool job
        under ``eager_overlap``, else an inline thunk."""
        def run():
            return build_fn(lo, hi, self.shard_overrides(lo, hi))
        if not self.pipeline.eager_overlap:
            return _Immediate(run)
        return self.pipeline.submit(run)

    def decode_all(self) -> Tuple[list, list, list]:
        """Every shard's overrides, concatenated in shard order."""
        addr: list = []
        file: list = []
        name: list = []
        for lo, hi in self.ranges:
            a, f, nm = self.shard_overrides(lo, hi)
            addr.extend(a)
            file.extend(f)
            name.extend(nm)
        return addr, file, name


def _h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array (a copy on the CPU too)."""
    return torch.tensor(np.ascontiguousarray(arr), device=device)


class DeviceStrings:
    """Device-resident table of one 10-byte ``value_digest10`` per
    interned string: uint8 ``[cap, 10]``. Append-only like the interner,
    so a later merge ships only the new strings' rows (a slice copy into
    the device buffer); a capacity growth ships it whole once."""

    def __init__(self, interner: Interner, device: torch.device) -> None:
        self.interner = interner
        self.device = device
        self.cap = 1024
        self._host = np.zeros((self.cap, 10), dtype=np.uint8)
        self._n_hashed = 0
        self._dev: Optional[torch.Tensor] = None
        self._n_dev = 0

    def sync(self) -> torch.Tensor:
        """The device table, up to date with the interner (rows past the
        interned count are zeros, never gathered by valid ids)."""
        strings = self.interner.strings
        n = len(strings)
        cap = self.cap
        while n > cap:
            cap *= 2
        if cap != self.cap:
            grown = np.zeros((cap, 10), dtype=np.uint8)
            grown[:self._n_hashed] = self._host[:self._n_hashed]
            self._host, self.cap = grown, cap
            self._dev = None
        for i in range(self._n_hashed, n):
            self._host[i] = np.frombuffer(value_digest10(strings[i]), np.uint8)
        self._n_hashed = max(self._n_hashed, n)
        if self._dev is None:
            self._dev = _h2d(self._host, self.device)
        elif n > self._n_dev:
            self._dev[self._n_dev:n] = _h2d(self._host[self._n_dev:n], self.device)
        self._n_dev = n
        return self._dev


# --------------------------------------------------------------------------
# The device program
# --------------------------------------------------------------------------

def _emit_slots(plan, C: int):
    """Scatter the diff plan into ``(kind, a_slot, b_slot)`` rows of
    capacity ``C``; rows past ``C`` land in the sink column (the
    overflow flag tells the host to retry with a larger capacity).
    Returns the three int32 ``[C]`` columns and the op count."""
    bl, s_repr = plan["bl"], plan["s_repr"]
    dev = bl.device
    nb, ns = bl.shape[0], plan["is_add"].shape[0]
    out = torch.full((3, C + 1), NULL_ID, dtype=torch.int32, device=dev)

    def scat(posn, mask, vals):
        posn = torch.where(mask & (posn < C), posn, C)
        out[:, posn] = torch.stack(vals)

    def const(n, value):
        return torch.full((n,), value, dtype=torch.int32, device=dev)

    bl32, s32 = bl.to(torch.int32), s_repr.to(torch.int32)
    scat(plan["base_off"], plan["is_delete"], [const(nb, KIND_DELETE), bl32, const(nb, NULL_ID)])
    scat(plan["base_off"], plan["is_move"], [const(nb, KIND_MOVE), bl32, s32])
    scat(plan["base_off"] + plan["is_move"].long(), plan["is_rename"],
         [const(nb, KIND_RENAME), bl32, s32])
    scat(plan["add_off"], plan["is_add"],
         [const(ns, KIND_ADD), const(ns, NULL_ID),
          torch.arange(ns, dtype=torch.int32, device=dev)])
    return out[0, :C], out[1, :C], out[2, :C], plan["n_ops"]


def _op_id_words(kind, a_slot, b_slot, b_cols, s_cols, hash_tab, pre_digest,
                 C: int) -> torch.Tensor:
    """Each op's id payload, hashed: int32 ``[C, 4]`` digest words.

    Layout (``core.ids.deterministic_op_id``): the 16-byte (seed, rev)
    prefix digest ‖ op index be32 ‖ type code ‖ the 10-byte digests of
    symbolId, base addressId and side addressId gathered from
    ``hash_tab`` (zeros for an absent value, ``value_digest10("")``).
    51 bytes always, so the SHA runs one compression per row. Device
    kind codes 0-3 equal the ``OP_TYPES`` type codes by construction."""
    b_sym, b_addr = b_cols[0], b_cols[1]
    s_sym, s_addr = s_cols[0], s_cols[1]
    a_sl = a_slot.long().clamp(0, b_sym.shape[0] - 1)
    b_sl = b_slot.long().clamp(0, s_sym.shape[0] - 1)
    is_add = kind == KIND_ADD
    valid = kind >= 0
    sym_id = torch.where(is_add, s_sym[b_sl], b_sym[a_sl])
    a_id = torch.where(valid & ~is_add, b_addr[a_sl], NULL_ID)
    b_id = torch.where((kind == KIND_MOVE) | (kind == KIND_RENAME) | is_add,
                       s_addr[b_sl], NULL_ID)
    cap = hash_tab.shape[0]
    dev = kind.device

    def hrows(sid):
        row = hash_tab[sid.long().clamp(0, cap - 1)]
        return torch.where((sid >= 0)[:, None], row, 0)

    idx = torch.arange(C, device=dev)
    idx_be = (torch.stack([idx >> 24, idx >> 16, idx >> 8, idx], dim=1) & 0xFF).to(torch.uint8)
    msg = torch.cat([
        pre_digest[None, :].expand(C, 16),
        idx_be,
        kind.clamp(0, 3).to(torch.uint8)[:, None],
        hrows(sym_id), hrows(a_id), hrows(b_id),
        torch.zeros((C, 64 - _ID_PAYLOAD_LEN), dtype=torch.uint8, device=dev),
    ], dim=1).contiguous()
    lens = torch.full((C,), _ID_PAYLOAD_LEN, dtype=torch.int32, device=dev)
    return sha256_device(msg, lens, n_words=4)


def _precedence(kind: torch.Tensor) -> torch.Tensor:
    """``_PREC_BY_KIND[kind]`` as int64, computed on the device (a
    table shipped from the host would stall the host on the copy)."""
    prec = torch.full_like(kind, _PREC_BY_KIND[KIND_DELETE], dtype=torch.long)
    for k in (KIND_RENAME, KIND_MOVE, KIND_ADD):
        prec = torch.where(kind == k, _PREC_BY_KIND[k], prec)
    return prec


def _compose_cols(kind, a_slot, b_slot, words, b_cols, s_cols, C: int) -> Dict[str, torch.Tensor]:
    """The composer's columns, int64, straight from the diff rows.
    ``idw`` holds the four digest words as unsigned values; invalid rows
    carry ``0xFFFFFFFF`` words and the padding precedence, so they sort
    last."""
    b_sym, b_file = b_cols[0], b_cols[3]
    s_sym, s_addr, s_name, s_file = s_cols[0], s_cols[1], s_cols[2], s_cols[3]
    a_sl = a_slot.long().clamp(0, b_sym.shape[0] - 1)
    b_sl = b_slot.long().clamp(0, s_sym.shape[0] - 1)
    valid = kind >= 0
    is_add, is_ren, is_mv = kind == KIND_ADD, kind == KIND_RENAME, kind == KIND_MOVE
    sym_id = torch.where(is_add, s_sym[b_sl], b_sym[a_sl]).long()
    idw = torch.where(valid[:, None], words.long() & 0xFFFFFFFF, 0xFFFFFFFF)
    return {
        "prec": torch.where(valid, _precedence(kind), _PAD_PREC),
        "ts_rank": torch.where(valid, 0, NULL_ID).long(),  # one shared timestamp
        "idw": idw,
        "is_rename": (is_ren & valid).long(),
        "is_move": (is_mv & valid).long(),
        "sym": torch.where(valid, sym_id, int(PAD_ID)),
        # newName doubles as the rename chain value on the fused path.
        "new_name": torch.where(is_ren, s_name[b_sl], NULL_ID).long(),
        "new_addr": torch.where(is_mv, s_addr[b_sl], NULL_ID).long(),
        "chain_file": torch.where(valid, torch.where(kind == KIND_DELETE, b_file[a_sl],
                                                     s_file[b_sl]), NULL_ID).long(),
        "op_index": torch.where(valid, torch.arange(C, device=kind.device), NULL_ID),
    }


def _canonical_order(prec, ts_rank, side, idw) -> torch.Tensor:
    """The stable permutation sorting rows by ``(prec, ts_rank, side,
    idw[:, 0], idw[:, 1], idw[:, 2], idw[:, 3])``: three stable sorts,
    least significant pair first. ``idw`` holds unsigned 32-bit words in
    int64; each pair packs as ``(hi - 2**31) * 2**32 + lo`` so that
    signed int64 order is unsigned order. ``prec`` in ``[0, 2**30]``,
    ``ts_rank`` in ``[-1, 2**31 - 2]``, ``side`` 0 or 1."""
    def pair(hi, lo):
        return (hi - 2**31) * 2**32 + lo

    order = torch.sort(pair(idw[:, 2], idw[:, 3]), stable=True).indices
    for key in (pair(idw[:, 0], idw[:, 1]),
                prec.long() * 2**32 + (ts_rank.long() + 1) * 2 + side.long()):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _merge_scan_spec(m, side_m, C: int):
    """Segmented chain scans and compact ``side << 30 | op_index``
    references over rows already in composed order: the stable symbol
    grouping keeps composed order inside each symbol's segment."""
    total = 2 * C
    opidx = m["op_index"]
    live = opidx != NULL_ID
    move_live = (m["is_move"] == 1) & live
    contrib = torch.stack([
        torch.where(move_live & (m["new_addr"] != NULL_ID), m["new_addr"], NULL_ID),
        torch.where(move_live & (m["chain_file"] != NULL_ID), m["chain_file"], NULL_ID),
        torch.where((m["is_rename"] == 1) & live, m["new_name"], NULL_ID),
    ])
    seg_order = torch.sort(m["sym"], stable=True).indices
    chains_seg = _seg_last_valid(m["sym"][seg_order], contrib[:, seg_order])
    chains = torch.empty_like(chains_seg)
    chains[:, seg_order] = chains_seg
    pos = torch.where(live, torch.cumsum(live.long(), 0) - 1, total)
    packed = (side_m << 30) | torch.where(opidx >= 0, opidx, 0)
    out = torch.full((4, total + 1), NULL_ID, dtype=torch.long, device=opidx.device)
    out[:, pos] = torch.cat([packed[None], chains])
    return live.sum(), out[:, :total]


def _compose_and_pack(kL, aL, bL, wL, nopsL, kR, aR, bR, wR, nopsR,
                      b_cols, l_cols, r_cols, C: int):
    """Compose columns, the one canonical sort, the candidate precheck,
    the speculative chain scans, and the split packing: int32
    ``head = [8 scalars, kL, aL, bL, wL0..3, kR, aR, bR, wR0..3]``,
    ``mid = [A's canonical permutation, B's, composed refs]``,
    ``chains = [chain addr, chain file, chain name]``."""
    dev = kL.device
    colsL = _compose_cols(kL, aL, bL, wL, b_cols, l_cols, C)
    colsR = _compose_cols(kR, aR, bR, wR, b_cols, r_cols, C)

    def cat(name):
        return torch.cat([colsL[name], colsR[name]])

    # ONE canonical sort: sorting the concatenation by (prec, ts, side,
    # id words) gives the composed order, and its restriction to one
    # side IS that side's canonical order.
    side = torch.cat([torch.zeros(C, dtype=torch.long, device=dev),
                      torch.ones(C, dtype=torch.long, device=dev)])
    order = _canonical_order(cat("prec"), cat("ts_rank"), side, cat("idw"))
    m = {k: cat(k)[order] for k in ("sym", "is_rename", "is_move", "new_name",
                                    "new_addr", "chain_file", "op_index")}
    side_m = side[order]

    # Stable partition of the composed rows into [A canonical | B canonical].
    is_a = side_m == 0
    ppos = torch.where(is_a, torch.cumsum(is_a.long(), 0) - 1,
                       C + torch.cumsum((~is_a).long(), 0) - 1)

    def part(v):
        out = torch.zeros(2 * C, dtype=v.dtype, device=dev)
        out[ppos] = v
        return out

    canon = {k: part(m[k]) for k in ("is_rename", "sym", "new_name", "op_index")}
    a = tuple(canon[k][:C] for k in ("is_rename", "sym", "new_name"))
    b = tuple(canon[k][C:] for k in ("is_rename", "sym", "new_name"))
    has_cand = _rename_candidates_cols(a, nopsL, b, nopsR)

    n_out, scan = _merge_scan_spec(m, side_m, C)
    overflow = (nopsL > C) | (nopsR > C)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    scalars = torch.stack([nopsL.long(), nopsR.long(), n_out, has_cand.long(),
                           overflow.long(), zero, zero, zero]).to(torch.int32)
    head = torch.cat([scalars, kL, aL, bL, *wL.unbind(1), kR, aR, bR, *wR.unbind(1)])
    mid = torch.cat([canon["op_index"], scan[0]]).to(torch.int32)
    chains = scan[1:].reshape(-1).to(torch.int32)
    return head, mid, chains


def _fused_merge_program(b_cols, l_cols, r_cols, hash_tab, dig_l, dig_r, C: int):
    """Both diffs, both sides' op ids and the compose on the device:
    ``(head, mid, chains)`` (see :func:`_compose_and_pack`)."""
    nb, nl, nr = b_cols.shape[1], l_cols.shape[1], r_cols.shape[1]
    planL = _diff_plan(b_cols[0], b_cols[1], b_cols[2], l_cols[0], l_cols[1], l_cols[2], nb, nl)
    planR = _diff_plan(b_cols[0], b_cols[1], b_cols[2], r_cols[0], r_cols[1], r_cols[2], nb, nr)
    kL, aL, bL, nopsL = _emit_slots(planL, C)
    kR, aR, bR, nopsR = _emit_slots(planR, C)
    wL = _op_id_words(kL, aL, bL, b_cols, l_cols, hash_tab, dig_l, C)
    wR = _op_id_words(kR, aR, bR, b_cols, r_cols, hash_tab, dig_r, C)
    return _compose_and_pack(kL, aL, bL, wL, nopsL, kR, aR, bR, wR, nopsR,
                             b_cols, l_cols, r_cols, C)


def _fused_diff_program(b_cols, s_cols, hash_tab, dig, C: int) -> torch.Tensor:
    """The two-way variant (``semdiff``): diff join and op identity, one
    int32 buffer ``[n_ops, overflow, 6 zeros, kind, a_slot, b_slot,
    w0..w3]``."""
    nb, ns = b_cols.shape[1], s_cols.shape[1]
    plan = _diff_plan(b_cols[0], b_cols[1], b_cols[2], s_cols[0], s_cols[1], s_cols[2], nb, ns)
    k, a, b, n_ops = _emit_slots(plan, C)
    w = _op_id_words(k, a, b, b_cols, s_cols, hash_tab, dig, C)
    scalars = torch.zeros(8, dtype=torch.int32, device=k.device)
    scalars[0] = n_ops
    scalars[1] = n_ops > C
    return torch.cat([scalars, k, a, b, *w.unbind(1)])


# --------------------------------------------------------------------------
# The engine: device state, fetch, host decode
# --------------------------------------------------------------------------

class FusedMergeEngine:
    """Owns the fused path's device state: the string digest table, the
    device renderer, and the learned op capacity hint that sizes the
    output (256 on a cold engine, as in the JAX package). ``phases``
    holds the seconds of the last call's ``fused``, ``materialize`` and
    ``render`` steps."""

    def __init__(self, interner: Interner, device: torch.device,
                 host_workers: Optional[int] = None) -> None:
        self.interner = interner
        self.device = device
        self._tail = TailPipeline(resolve_host_workers(host_workers))
        self.strings = DeviceStrings(interner, device)
        self._renderer = None
        #: Per-snapshot field lists for the views and the applier.
        self._fields: "OrderedDict" = OrderedDict()
        self._cap_hint = 256
        self.phases: Dict[str, float] = {}

    def _device_decl(self, t: DeclTensor) -> torch.Tensor:
        """int32 ``[4, bucket]`` (sym, addr, name, file) on the device."""
        bucket = bucket_size(max(t.n, 1))
        null = np.int32(NULL_ID)
        return _h2d(np.stack([pad_to(t.sym, bucket, PAD_ID), pad_to(t.addr, bucket, null),
                              pad_to(t.name, bucket, null), pad_to(t.file, bucket, null)]),
                    self.device)

    def _digest(self, seed: str, rev: str) -> torch.Tensor:
        return _h2d(np.frombuffer(op_id_prefix_digest(seed, rev), np.uint8), self.device)

    def diff(self, base_t: DeclTensor, base_nodes, side_t: DeclTensor, side_nodes,
             *, seed: str, base_rev: str, timestamp: str) -> Optional[OpStreamView]:
        """The two-way fused diff (``semdiff``): one device pass, one
        fetch, op ids hashed on the device; ``None`` when the capacity
        retries run out (the caller takes the two-program path)."""
        t0 = time.perf_counter()
        hash_tab = self.strings.sync()
        dig = self._digest(seed + "/R", base_rev)
        dev_b = self._device_decl(base_t)
        dev_s = self._device_decl(side_t)
        for _attempt in range(4):
            C = bucket_size(max(self._cap_hint, 8))
            flat = _fused_diff_program(dev_b, dev_s, hash_tab, dig, C).cpu().numpy()
            n_ops = int(flat[0])
            if not flat[1]:
                break
            self._cap_hint = n_ops
        else:
            return None
        self.phases = {"fused": time.perf_counter() - t0}
        t0 = time.perf_counter()
        cols = [flat[8 + i * C:8 + (i + 1) * C][:n_ops] for i in range(7)]
        view = OpStreamView(cols[0], cols[1], cols[2], np.stack(cols[3:7], axis=1),
                            base_nodes, side_nodes,
                            {"rev": base_rev, "timestamp": timestamp},
                            field_cache=self._fields)
        self.phases["materialize"] = time.perf_counter() - t0
        return view

    def merge(self, base_t: DeclTensor, base_nodes, left_t: DeclTensor, left_nodes,
              right_t: DeclTensor, right_nodes,
              *, seed: str, base_rev: str, timestamp: str, overlap_work=None
              ) -> Optional[Tuple[OpStreamView, OpStreamView, ComposedOpView, List[Conflict]]]:
        """The one-pass merge: ``(A's view, B's view, composed view,
        conflicts)``, or ``None`` when the capacity retries run out (the
        caller takes the two-program path).

        ``overlap_work`` (a no-argument callable) runs on the host while
        the device works, before the first fetch. The host tail is
        sharded (:class:`TailPlan`): chain decode and op materialization
        run per row range, pre-submitted to the worker pool when it has
        more than one worker and core. The op logs render on the device
        when eligible (:mod:`.render`). The ``kernel`` fault-injection
        stage fires before the dispatch."""
        faults.check("kernel")
        t0 = time.perf_counter()
        hash_tab = self.strings.sync()
        dig_l = self._digest(seed + "/L", base_rev)
        dig_r = self._digest(seed + "/R", base_rev)
        dev_b = self._device_decl(base_t)
        dev_l = self._device_decl(left_t)
        dev_r = self._device_decl(right_t)
        for _attempt in range(4):
            C = bucket_size(max(self._cap_hint, 8))
            head_dev, mid_dev, chains_dev = _fused_merge_program(
                dev_b, dev_l, dev_r, hash_tab, dig_l, dig_r, C)
            if overlap_work is not None:
                overlap_work()  # rides along with the device's work
                overlap_work = None
                for nodes in (base_nodes, left_nodes, right_nodes):
                    _get_fields(self._fields, nodes)
            flat = head_dev.cpu().numpy()
            n_l, n_r = int(flat[0]), int(flat[1])
            if not flat[4]:
                break
            self._cap_hint = max(n_l, n_r)
        else:
            return None
        n_out, has_cand = int(flat[2]), bool(flat[3])
        self.phases = {"fused": time.perf_counter() - t0}

        t0 = time.perf_counter()
        cols = [flat[8 + i * C:8 + (i + 1) * C] for i in range(14)]
        kL, aL, bL, wL = cols[0], cols[1], cols[2], np.stack(cols[3:7], axis=1)
        kR, aR, bR, wR = cols[7], cols[8], cols[9], np.stack(cols[10:14], axis=1)
        prov = {"rev": base_rev, "timestamp": timestamp}
        ops_l = OpStreamView(kL[:n_l], aL[:n_l], bL[:n_l], wL[:n_l], base_nodes,
                             left_nodes, prov, field_cache=self._fields)
        ops_r = OpStreamView(kR[:n_r], aR[:n_r], bR[:n_r], wR[:n_r], base_nodes,
                             right_nodes, prov, field_cache=self._fields)
        materialize = time.perf_counter() - t0

        t0 = time.perf_counter()
        self._dispatch_renders(ops_l, ops_r, (dev_b, dev_l, dev_r),
                               (base_t, left_t, right_t), dumps_canonical(prov))
        self.phases["render"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        fm = mid_dev.cpu().numpy()
        perm_l, perm_r, ref = fm[:C], fm[C:2 * C], fm[2 * C:]
        refs = ref[:n_out]
        sides = (refs >> 30).astype(np.int32)
        idxs = (refs & ((1 << 30) - 1)).astype(np.int32)
        conflicts: List[Conflict] = []
        keep = None
        ctx_rows: List[int] = []
        ctx_vals: List[object] = []
        if has_cand:
            conflicts, keep, ctx_rows, ctx_vals = self._conflict_walk(
                ops_l, ops_r, perm_l[:n_l], perm_r[:n_r], sides, idxs,
                (base_t, left_t, right_t))
            if keep is not None:
                sides, idxs = sides[keep], idxs[keep]
        interner = self.interner  # not `self`: an unread view must not pin the engine
        ctx_row_arr = np.asarray(ctx_rows, np.int64)

        def fetch_chains():
            fc = chains_dev.cpu().numpy()
            tbl = interner.object_table()
            return fc[:n_out], fc[2 * C:2 * C + n_out], fc[4 * C:4 * C + n_out], tbl

        chains_cell = _OnceCell(fetch_chains)

        def decode_rows(lo, hi):
            """One shard's chain overrides: object-array gathers over the
            shard's rows (NULL_ID wraps to the table's trailing None) and
            the shard's rename-context writes."""
            c_addr, c_file, c_name, tbl = chains_cell.get()
            rows = slice(lo, hi) if keep is None else keep[lo:hi]
            addr_o = tbl[c_addr[rows]].tolist()
            file_o = tbl[c_file[rows]].tolist()
            name_o = tbl[c_name[rows]].tolist()
            if len(ctx_row_arr):
                j0, j1 = np.searchsorted(ctx_row_arr, (lo, hi))
                for j in range(int(j0), int(j1)):
                    name_o[int(ctx_row_arr[j]) - lo] = ctx_vals[j]
            return addr_o, file_o, name_o

        plan = TailPlan(self._tail, int(len(sides)), decode_rows)
        composed = ComposedOpView.pipelined(sides, idxs, plan, ops_l, ops_r)
        if self._tail.eager_overlap:
            plan.prefetch()
        self.phases["materialize"] = materialize + time.perf_counter() - t0
        return ops_l, ops_r, composed, conflicts

    def _dispatch_renders(self, ops_l, ops_r, decl_dev, decl_host, prov_json: str) -> None:
        """Launch both streams' device renders (eligibility as in the
        JAX package: ``render_posture`` and at least ``_min_rows``
        rows); a failure raises."""
        from .render import DeviceRenderer, render_posture
        posture = render_posture()
        if posture == "off":
            return
        if self._renderer is None:
            self._renderer = DeviceRenderer(self.interner, self.device)
        if not self._renderer.eligible(max(len(ops_l), len(ops_r)), posture=posture):
            return
        dev_b, dev_l, dev_r = decl_dev
        base_t, left_t, right_t = decl_host
        for view, dev_s, side_t in ((ops_l, dev_l, left_t), (ops_r, dev_r, right_t)):
            view.render = self._renderer.dispatch(
                view.kind, view.a_slot, view.b_slot, view.words, dev_b, dev_s,
                base_t, side_t, prov_json, require=posture == "require")

    def _conflict_walk(self, ops_l, ops_r, p_l, p_r, sides, idxs, decl_host):
        """The host half of a merge whose precheck found candidates: the
        reference's DivergentRename walk on the rename rows of the two
        canonical streams, then the composed stream patched columnar-ly —
        dropped renames leave it, and the rename chains of the affected
        symbols replay in composed order as ``(final row, value)``
        writes (drops are always renames, so the device's addr/file
        chains stay exact). Returns ``(conflicts, keep, ctx rows, ctx
        values)``; ``keep`` is ``None`` when nothing is dropped."""
        base_t, left_t, right_t = decl_host
        n_l, n_r = len(ops_l), len(ops_r)

        def raw_cols(view, side_t):
            a_cl = np.maximum(view.a_slot, 0)
            b_cl = np.maximum(view.b_slot, 0)
            sym = np.where(view.kind == KIND_ADD, side_t.sym[b_cl], base_t.sym[a_cl])
            name = np.where(view.kind == KIND_RENAME, side_t.name[b_cl], NULL_ID)
            return sym, name

        sym_l, name_l = raw_cols(ops_l, left_t)
        sym_r, name_r = raw_cols(ops_r, right_t)
        ren_l = np.nonzero(ops_l.kind[p_l] == KIND_RENAME)[0]
        ren_r = np.nonzero(ops_r.kind[p_r] == KIND_RENAME)[0]
        pairs, da, db = cursor_walk_conflicts_renames_only(
            ren_l, sym_l[p_l][ren_l], name_l[p_l][ren_l],
            ren_r, sym_r[p_r][ren_r], name_r[p_r][ren_r],
            prec_rename=_PREC_BY_KIND[KIND_RENAME])
        conflicts = [divergent_rename_conflict(ops_l[int(p_l[ia])], ops_r[int(p_r[ib])])
                     for ia, ib in pairs]
        if not pairs:
            return conflicts, None, [], []
        dropped_l = np.asarray(sorted(int(p_l[i]) for i in da))
        dropped_r = np.asarray(sorted(int(p_r[j]) for j in db))
        drop = (((sides == 0) & np.isin(idxs, dropped_l))
                | ((sides == 1) & np.isin(idxs, dropped_r)))
        il = np.minimum(idxs, max(n_l - 1, 0))
        ir = np.minimum(idxs, max(n_r - 1, 0))
        sym_row = np.where(sides == 0, sym_l[il], sym_r[ir])
        affected = np.asarray(sorted({int(sym_l[i]) for i in dropped_l.tolist()}
                                     | {int(sym_r[j]) for j in dropped_r.tolist()}))
        kind_row = np.where(sides == 0, ops_l.kind[il], ops_r.kind[ir])
        name_row = np.where(sides == 0, name_l[il], name_r[ir])
        table = self.interner.object_table()
        ctx: Dict[int, object] = {}
        ctx_rows: List[int] = []
        ctx_vals: List[object] = []
        for i in np.nonzero(np.isin(sym_row, affected) & ~drop)[0].tolist():
            sym = int(sym_row[i])
            if kind_row[i] == KIND_RENAME:
                ctx[sym] = table[name_row[i]]
            ctx_rows.append(i)
            ctx_vals.append(ctx.get(sym))
        keep = np.nonzero(~drop)[0]
        # Affected rows are all kept: their final positions are their
        # ranks within `keep`.
        ctx_rows = np.searchsorted(keep, np.asarray(ctx_rows, np.int64)).tolist()
        return conflicts, keep, ctx_rows, ctx_vals
