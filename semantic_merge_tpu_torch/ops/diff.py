"""Batched declaration diff + lift on the device, in PyTorch.

The port of the JAX package's ``ops/diff.py``: the reference worker's
``diffNodes`` hash-map join and ``lift`` loop (reference
``workers/ts/src/diff.ts:5-31``, ``workers/ts/src/lift.ts:11-66``) as a
sort-join over interned int32 ids. Data-parallel over decl slots, no
Python loops, padded shapes.

JS ``Map`` semantics are reproduced exactly:

- iteration order = first-occurrence order (a slot "emits" only if it
  is the first slot with its symbol id);
- duplicate keys keep the *last* value (per-slot data is gathered from
  the last occurrence via a right-searchsorted into the stable
  sort-by-symbol order);
- the side list's ``add`` loop walks raw slots, so duplicate unseen
  symbols emit repeatedly (reference ``workers/ts/src/diff.ts:24-28``).

Emission layout (one op stream, the reference's enumeration): per base
symbol in map order — ``delete`` *or* (``move`` then ``rename``) —
followed by per-side-slot ``add`` ops.

Where JAX scatters with ``.at[].set(mode="drop")``, this module scatters
into an ``m + 1`` buffer whose last row is a sink for dropped rows, then
slices the sink off. Index arithmetic runs in int64 (torch's index
type); the fetched matrix is int32, like the JAX program's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.encode import NULL_ID, PAD_ID, DeclTensor, bucket_size, pad_to

KIND_RENAME = 0
KIND_MOVE = 1
KIND_ADD = 2
KIND_DELETE = 3


@dataclass
class DiffOpsTensor:
    """Device-lifted op stream (struct of arrays, padded, on the host).

    ``kind`` is ``-1`` on padding rows. ``a_*`` columns describe the
    base-side node, ``b_*`` the side node; ``NULL_ID`` where absent.
    Row order is exactly the reference's diff enumeration, so row index
    == the deterministic-id sequence number.
    """

    kind: np.ndarray
    sym: np.ndarray
    a_addr: np.ndarray
    a_name: np.ndarray
    a_file: np.ndarray
    b_addr: np.ndarray
    b_name: np.ndarray
    b_file: np.ndarray
    n_ops: int


def _occurrence_bounds(sym, order, sorted_sym, n_pad):
    """For each slot: the first and last slot index holding its symbol."""
    left = torch.searchsorted(sorted_sym, sym)
    right = torch.searchsorted(sorted_sym, sym, right=True) - 1
    left = left.clamp(0, n_pad - 1)
    right = right.clamp(0, n_pad - 1)
    return order[left], order[right]


def _diff_plan(b_sym, b_addr, b_name, s_sym, s_addr, s_name, nb: int, ns: int):
    """The parallel join: which slots emit which diff kinds, at which
    positions of the op stream, with node data taken from which slots."""
    idx_b = torch.arange(nb, device=b_sym.device)
    b_valid = b_sym != int(PAD_ID)
    s_valid = s_sym != int(PAD_ID)

    # Stable sort by symbol: ties keep slot order, so right-1 = last occurrence.
    b_order = torch.argsort(b_sym, stable=True)
    s_order = torch.argsort(s_sym, stable=True)
    b_sorted = b_sym[b_order]
    s_sorted = s_sym[s_order]

    b_first, b_last = _occurrence_bounds(b_sym, b_order, b_sorted, nb)

    # Side representative (Map last-wins) for each base symbol.
    pos = torch.searchsorted(s_sorted, b_sym, right=True) - 1
    pos_c = pos.clamp(0, ns - 1)
    found = (pos >= 0) & (s_sorted[pos_c] == b_sym) & b_valid
    s_repr = s_order[pos_c]

    # Base-map emission: only the first occurrence emits; data from last.
    emits = b_valid & (idx_b == b_first)
    bl = b_last
    b_addr_l = b_addr[bl]
    b_name_l = b_name[bl]
    s_addr_r = s_addr[s_repr]
    s_name_r = s_name[s_repr]

    is_delete = emits & ~found
    is_move = emits & found & (b_addr_l != s_addr_r)
    is_rename = (emits & found & (b_name_l != NULL_ID) & (s_name_r != NULL_ID)
                 & (b_name_l != s_name_r))

    # Adds: every raw side slot whose symbol is absent from base.
    in_base = torch.searchsorted(b_sorted, s_sym)
    in_base_c = in_base.clamp(0, nb - 1)
    present = b_sorted[in_base_c] == s_sym
    is_add = s_valid & ~present

    # Emission positions: per base slot `delete ? 1 : move+rename`,
    # move before rename within a slot, adds after all base emissions.
    base_count = torch.where(is_delete, 1, is_move.long() + is_rename.long())
    base_off = torch.cumsum(base_count, 0) - base_count
    total_base = base_count.sum()
    add_count = is_add.long()
    add_off = total_base + torch.cumsum(add_count, 0) - add_count
    n_ops = total_base + add_count.sum()
    return {
        "is_delete": is_delete, "is_move": is_move, "is_rename": is_rename,
        "is_add": is_add, "base_off": base_off, "add_off": add_off,
        "n_ops": n_ops, "bl": bl, "s_repr": s_repr,
    }


def _diff_lift_core(b_cols, s_cols, nb: int, ns: int):
    """``b_cols``/``s_cols``: (4, n) int32 device tensors of padded
    (sym, addr, name, file). Returns the (9, 2·nb + ns) int32 stacked
    op stream: rows 0-7 are the columns, row 8 is ``n_ops`` broadcast."""
    b_sym, b_addr, b_name, b_file = b_cols
    s_sym, s_addr, s_name, s_file = s_cols
    plan = _diff_plan(b_sym, b_addr, b_name, s_sym, s_addr, s_name, nb, ns)
    is_delete, is_move, is_rename, is_add = (
        plan["is_delete"], plan["is_move"], plan["is_rename"], plan["is_add"])
    base_off, add_off = plan["base_off"], plan["add_off"]
    bl, s_repr = plan["bl"], plan["s_repr"]
    b_addr_l = b_addr[bl]
    b_name_l = b_name[bl]
    b_file_l = b_file[bl]
    s_addr_r = s_addr[s_repr]
    s_name_r = s_name[s_repr]
    s_file_r = s_file[s_repr]

    m = 2 * nb + ns  # static output capacity
    dev = b_sym.device
    # Rows: kind, sym, a_addr, a_name, a_file, b_addr, b_name, b_file;
    # column m is the sink that absorbs every masked-out row.
    out = torch.full((8, m + 1), NULL_ID, dtype=torch.int32, device=dev)

    def scatter(posn, mask, values):
        posn = torch.where(mask, posn, m)
        out[:, posn] = torch.stack(values)

    def const(n, value):
        return torch.full((n,), value, dtype=torch.int32, device=dev)

    scatter(base_off, is_delete,
            [const(nb, KIND_DELETE), b_sym, b_addr_l, b_name_l, b_file_l,
             const(nb, NULL_ID), const(nb, NULL_ID), const(nb, NULL_ID)])
    scatter(base_off, is_move,
            [const(nb, KIND_MOVE), b_sym, b_addr_l, b_name_l, b_file_l,
             s_addr_r, s_name_r, s_file_r])
    scatter(base_off + is_move.long(), is_rename,
            [const(nb, KIND_RENAME), b_sym, b_addr_l, b_name_l, b_file_l,
             s_addr_r, s_name_r, s_file_r])
    scatter(add_off, is_add,
            [const(ns, KIND_ADD), s_sym, const(ns, NULL_ID), const(ns, NULL_ID),
             const(ns, NULL_ID), s_addr, s_name, s_file])

    n_row = plan["n_ops"].to(torch.int32).expand(1, m)
    return torch.cat([out[:, :m], n_row], dim=0)


def _decode_stacked(out: np.ndarray) -> DiffOpsTensor:
    (kind, sym, a_addr, a_name, a_file, b_addr, b_name, b_file) = out[:8]
    return DiffOpsTensor(
        kind=kind, sym=sym, a_addr=a_addr, a_name=a_name, a_file=a_file,
        b_addr=b_addr, b_name=b_name, b_file=b_file, n_ops=int(out[8, 0]),
    )


def _padded_cols(t: DeclTensor, size: int) -> np.ndarray:
    return np.stack([pad_to(t.sym, size, PAD_ID), pad_to(t.addr, size, NULL_ID),
                     pad_to(t.name, size, NULL_ID), pad_to(t.file, size, NULL_ID)])


def diff_lift_device(base: DeclTensor, side: DeclTensor,
                     device: torch.device) -> DiffOpsTensor:
    """Run the diff+lift join for one (base, side) pair on ``device``:
    one host→device copy per side, one device→host fetch."""
    nb = bucket_size(max(base.n, 1))
    ns = bucket_size(max(side.n, 1))
    b_cols = torch.from_numpy(_padded_cols(base, nb)).to(device)
    s_cols = torch.from_numpy(_padded_cols(side, ns)).to(device)
    out = _diff_lift_core(b_cols, s_cols, nb, ns)
    return _decode_stacked(out.cpu().numpy())


def diff_lift_device_pair(base: DeclTensor, left: DeclTensor, right: DeclTensor,
                          device: torch.device) -> tuple[DiffOpsTensor, DiffOpsTensor]:
    """Both sides of a three-way merge against base in one device call:
    each side through :func:`_diff_lift_core`, the two outputs padded to
    one width (``NULL_ID``) and stacked, one device→host fetch."""
    nb = bucket_size(max(base.n, 1))
    nl = bucket_size(max(left.n, 1))
    nr = bucket_size(max(right.n, 1))
    b_cols = torch.from_numpy(_padded_cols(base, nb)).to(device)
    l_cols = torch.from_numpy(_padded_cols(left, nl)).to(device)
    r_cols = torch.from_numpy(_padded_cols(right, nr)).to(device)
    out_l = _diff_lift_core(b_cols, l_cols, nb, nl)
    out_r = _diff_lift_core(b_cols, r_cols, nb, nr)
    m = max(out_l.shape[1], out_r.shape[1])

    def pad(a):
        return torch.nn.functional.pad(a, (0, m - a.shape[1]), value=NULL_ID)

    out = torch.stack([pad(out_l), pad(out_r)]).cpu().numpy()
    return _decode_stacked(out[0]), _decode_stacked(out[1])
