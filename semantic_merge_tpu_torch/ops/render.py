"""Device-side op-log rendering — serialization as one gather.

The port of the JAX package's ``ops/render.py``. An op-log row is a
fixed *segment program* over data the device already holds: the row
template's literals (per kind, fixed once the provenance JSON is), the
snapshot's field strings (symbolId, addressId, name, file — resident as
interned-id columns in the fused engine's decl tables) and the op id, a
hex rendering of digest words the device computed. So every interned
string's escaped JSON body lives in an append-only device blob
(:class:`EscapedStrings`), and :func:`_render_program` expands each
row's segments — literal, field or uuid — into per-byte source offsets
over one byte pool ``template ‖ escaped bodies ‖ uuid36(words)`` and
gathers them into a fixed-width ``uint8 [n, W]`` buffer, in chunks of
4,096 rows: a batched ``torch.searchsorted`` over each row's segment
ends, then a gather. The host makes one device→host copy and a
mask-concat. The bytes equal ``OpStreamView._json_rows``'s, and so
``dumps_canonical([op.to_dict() ...])``'s.

Posture (``SEMMERGE_DEVICE_RENDER``): ``off`` never renders; ``auto``
(default) renders streams of at least ``SEMMERGE_RENDER_MIN_ROWS``
(4,096) rows whose rows are at most ``SEMMERGE_RENDER_MAX_WIDTH``
(4,096) bytes wide; ``require`` renders any non-empty stream and raises
on a wider one. Unlike the JAX package's ``auto``, a render that was
launched and fails is never re-done on the host: it raises
:class:`~semantic_merge_tpu_torch.errors.KernelFault`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.encode import Interner, bucket_size, encode_decls, pad_to
from ..core.ops import dumps_canonical
from ..errors import KernelFault
from .oplog_view import _TMPL_ADD, _TMPL_DELETE, _TMPL_MOVE, _TMPL_RENAME, _esc_body

ENV_POSTURE = "SEMMERGE_DEVICE_RENDER"
ENV_MIN_ROWS = "SEMMERGE_RENDER_MIN_ROWS"
ENV_MAX_WIDTH = "SEMMERGE_RENDER_MAX_WIDTH"

#: Below this row count the host serializer is cheaper (``auto`` only).
DEFAULT_MIN_ROWS = 4096
#: Rows wider than this make the fixed-width buffer a memory hazard.
DEFAULT_MAX_WIDTH = 4096

#: Segment selector codes of the per-kind spec tables.
_SEL_PAD, _SEL_LIT, _SEL_UUID = 0, 1, 2
#: Field codes 3.. index the stacked per-row field ids: base sym, addr,
#: name, side sym, addr, name, side file, base file.
(_F_BSYM, _F_BADDR, _F_BNAME,
 _F_SSYM, _F_SADDR, _F_SNAME, _F_SFILE, _F_BFILE) = range(3, 11)

#: Per-kind field sequences in template ``%s`` order (after the leading
#: uuid slot), matching ``OpStreamView._json_rows``. KIND_RENAME=0,
#: MOVE=1, ADD=2, DELETE=3.
_KIND_FIELDS = (
    (_F_BSYM, _F_BADDR, _F_BNAME, _F_SNAME, _F_SFILE,
     _F_BADDR, _F_BNAME, _F_SNAME),                          # rename
    (_F_BSYM, _F_BADDR, _F_BADDR, _F_SADDR, _F_BFILE, _F_SFILE,
     _F_BADDR, _F_BADDR, _F_SADDR),                          # move
    (_F_SSYM, _F_SADDR, _F_SFILE),                           # add
    (_F_BSYM, _F_BADDR, _F_BFILE),                           # delete
)
_KIND_TMPLS = (_TMPL_RENAME, _TMPL_MOVE, _TMPL_ADD, _TMPL_DELETE)

#: Segments per row: the literals interleaved with the uuid and fields.
_S = max(2 * len(f) + 3 for f in _KIND_FIELDS)

#: Rows render in chunks so the [chunk, W] int64 offsets stay bounded.
_CHUNK = 4096


def render_posture() -> str:
    """``off`` / ``auto`` / ``require`` from ``SEMMERGE_DEVICE_RENDER``
    (unknown values read as ``auto``)."""
    raw = os.environ.get(ENV_POSTURE, "auto").strip().lower()
    if raw in ("off", "0", "no", "false"):
        return "off"
    if raw in ("require", "required"):
        return "require"
    return "auto"


def _min_rows() -> int:
    try:
        return int(os.environ.get(ENV_MIN_ROWS, DEFAULT_MIN_ROWS))
    except ValueError:
        return DEFAULT_MIN_ROWS


def _max_width() -> int:
    try:
        return int(os.environ.get(ENV_MAX_WIDTH, DEFAULT_MAX_WIDTH))
    except ValueError:
        return DEFAULT_MAX_WIDTH


class EscapedStrings:
    """Device-resident escaped-JSON-body table of an interner: a uint8
    blob of every string's ``_esc_body`` UTF-8 bytes and int32 offset
    and length rows. Append-only like the interner, so a later merge
    ships only the new strings (slice copies into the device buffers);
    a capacity growth ships the whole table once."""

    def __init__(self, interner: Interner, device: torch.device) -> None:
        self.interner = interner
        self.device = device
        self.blob_cap = 4096
        self.id_cap = 1024
        self._blob = np.zeros(self.blob_cap, np.uint8)
        self._offs = np.zeros(self.id_cap, np.int32)
        self._lens = np.zeros(self.id_cap, np.int32)
        self._n = 0          # ids escaped into the host arrays
        self._blob_n = 0     # blob bytes used
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        self._n_dev = 0
        self._blob_dev_n = 0

    def lens_host(self) -> np.ndarray:
        return self._lens

    def _append_host(self, n: int) -> None:
        strings = self.interner.strings
        if n > self.id_cap:
            cap = self.id_cap
            while n > cap:
                cap *= 2
            offs = np.zeros(cap, np.int32)
            lens = np.zeros(cap, np.int32)
            offs[:self._n] = self._offs[:self._n]
            lens[:self._n] = self._lens[:self._n]
            self._offs, self._lens, self.id_cap = offs, lens, cap
            self._dev = None
        bodies = [_esc_body(s).encode("utf-8") for s in strings[self._n:n]]
        end = self._blob_n + sum(map(len, bodies))
        if end > self.blob_cap:
            cap = self.blob_cap
            while end > cap:
                cap *= 2
            blob = np.zeros(cap, np.uint8)
            blob[:self._blob_n] = self._blob[:self._blob_n]
            self._blob, self.blob_cap = blob, cap
            self._dev = None
        lens = np.fromiter(map(len, bodies), np.int64, count=len(bodies))
        self._lens[self._n:n] = lens
        self._offs[self._n:n] = self._blob_n + np.cumsum(lens) - lens
        if end > self._blob_n:
            self._blob[self._blob_n:end] = np.frombuffer(b"".join(bodies), np.uint8)
        self._blob_n = end
        self._n = n

    def sync(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The device ``(blob, offs, lens)``, up to date with the
        interner (rows past the interned count are never gathered)."""
        n = len(self.interner.strings)
        if n > self._n:
            self._append_host(n)
        if self._dev is None:
            self._dev = tuple(torch.tensor(a, device=self.device)
                              for a in (self._blob, self._offs, self._lens))
        elif n > self._n_dev:
            blob, offs, lens = self._dev
            blob[self._blob_dev_n:self._blob_n] = torch.tensor(
                self._blob[self._blob_dev_n:self._blob_n], device=self.device)
            offs[self._n_dev:n] = torch.tensor(self._offs[self._n_dev:n], device=self.device)
            lens[self._n_dev:n] = torch.tensor(self._lens[self._n_dev:n], device=self.device)
        self._n_dev, self._blob_dev_n = n, self._blob_n
        return self._dev


class _KindSpec:
    """Per-provenance static render spec: the template blob plus the
    ``[4, S]`` selector / literal-offset / literal-length tables the
    device program gathers by kind."""

    __slots__ = ("blob", "sel", "lit", "litlen", "lit_total")

    def __init__(self, prov_json: str) -> None:
        blob = bytearray()
        sel = np.zeros((4, _S), np.int64)
        lit = np.zeros((4, _S), np.int64)
        litlen = np.zeros((4, _S), np.int64)
        self.lit_total = np.zeros(4, np.int64)
        for k, (tmpl, fields) in enumerate(zip(_KIND_TMPLS, _KIND_FIELDS)):
            lits = tmpl.split("%s")
            # Slot 0 is the uuid, the others the field sequence. The
            # closing literal carries the provenance, the row's closing
            # brace and the row separator.
            lits[-1] = lits[-1] + prov_json + "}" + ","
            segs: List[Tuple[int, int, int]] = []
            for si, text in enumerate(lits):
                enc = text.encode("utf-8")
                segs.append((_SEL_LIT, len(blob), len(enc)))
                blob.extend(enc)
                self.lit_total[k] += len(enc)
                if si == 0:
                    segs.append((_SEL_UUID, 0, 36))
                elif si <= len(fields):
                    segs.append((fields[si - 1], 0, 0))
            for si, (s, o, ln) in enumerate(segs):
                sel[k, si], lit[k, si], litlen[k, si] = s, o, ln
        padded = np.zeros(bucket_size(max(len(blob), 1), minimum=256), np.uint8)
        padded[:len(blob)] = np.frombuffer(bytes(blob), np.uint8)
        self.blob = padded
        self.sel, self.lit, self.litlen = sel, lit, litlen


def _uuid36_dev(words: torch.Tensor) -> torch.Tensor:
    """Digest words int32 ``[n, 4]`` → UUID-shaped ASCII uint8
    ``[n, 36]``: the device twin of ``oplog_view.format_ids`` (hex
    digits 8-4-4-4-12, dashes between)."""
    n = words.shape[0]
    u = words.long() & 0xFFFFFFFF
    shifts = 24 - 8 * torch.arange(4, device=words.device)
    byts = ((u[:, :, None] >> shifts) & 0xFF).reshape(n, 16)
    nib = torch.stack([byts >> 4, byts & 0xF], dim=-1).reshape(n, 32)
    hexd = (nib + 48 + torch.where(nib > 9, 39, 0)).to(torch.uint8)
    dash = torch.full((n, 1), ord("-"), dtype=torch.uint8, device=words.device)
    return torch.cat([hexd[:, 0:8], dash, hexd[:, 8:12], dash, hexd[:, 12:16], dash,
                      hexd[:, 16:20], dash, hexd[:, 20:32]], dim=1)


def _render_program(kind, a_slot, b_slot, words, bcols, scols, sel_tab, lit_tab,
                    litlen_tab, esc_blob, esc_offs, esc_lens, tmpl_blob, W: int):
    """Expand each row's segment spec into per-byte pool offsets and
    gather: uint8 ``[n, W]``, zero past each row's length. Pool layout:
    template literals ‖ escaped string bodies ‖ 36 uuid bytes per row."""
    n = kind.shape[0]
    dev = kind.device
    tmpl_cap, esc_cap = tmpl_blob.shape[0], esc_blob.shape[0]
    pool = torch.cat([tmpl_blob, esc_blob, _uuid36_dev(words).reshape(-1)])
    pool_max = pool.shape[0] - 1

    kind_c = kind.long().clamp(0, 3)
    a = a_slot.long().clamp(0, bcols.shape[1] - 1)
    b = b_slot.long().clamp(0, scols.shape[1] - 1)
    field_ids = torch.stack(
        [bcols[0][a], bcols[1][a], bcols[2][a], scols[0][b], scols[1][b], scols[2][b],
         scols[3][b], bcols[3][a]], dim=1).long().clamp(0, esc_offs.shape[0] - 1)
    sel, lit, litlen = sel_tab[kind_c], lit_tab[kind_c], litlen_tab[kind_c]
    fid = field_ids.gather(1, (sel - 3).clamp(0, 7))
    f_off = esc_offs.long()[fid] + tmpl_cap
    f_len = esc_lens.long()[fid]
    row36 = torch.arange(n, device=dev) * 36 + (tmpl_cap + esc_cap)
    seg_off = torch.where(sel == _SEL_LIT, lit,
                          torch.where(sel == _SEL_UUID, row36[:, None], f_off))
    seg_len = torch.where(sel == _SEL_LIT, litlen,
                          torch.where(sel == _SEL_UUID, 36,
                                      torch.where(sel >= 3, f_len, 0)))
    out = torch.empty((n, W), dtype=torch.uint8, device=dev)
    j = torch.arange(W, device=dev)
    for lo in range(0, n, _CHUNK):
        c_off, c_len = seg_off[lo:lo + _CHUNK], seg_len[lo:lo + _CHUNK]
        ends = torch.cumsum(c_len, dim=1)
        starts = ends - c_len
        k = torch.searchsorted(ends, j.expand(ends.shape[0], W).contiguous(),
                               right=True).clamp(0, _S - 1)
        src = c_off.gather(1, k) + (j[None, :] - starts.gather(1, k))
        valid = j[None, :] < ends[:, -1:]
        out[lo:lo + _CHUNK] = torch.where(valid, pool[src.clamp(0, pool_max)], 0)
    return out


class RenderedStream:
    """One stream's device render: the device buffer and the host-side
    row lengths. :meth:`json_bytes` makes the one device→host copy and
    the mask-concat; :meth:`row_bytes` backs the composed view's
    spliced serialization. A failed fetch raises ``KernelFault``."""

    __slots__ = ("_buf_dev", "lens", "n", "W", "_buf", "_rows")

    def __init__(self, buf_dev: torch.Tensor, lens: np.ndarray, n: int, W: int) -> None:
        self._buf_dev = buf_dev
        self.lens = lens
        self.n = n
        self.W = W
        self._buf: Optional[np.ndarray] = None
        self._rows: Optional[List[bytes]] = None

    def _fetch(self) -> np.ndarray:
        if self._buf is None:
            try:
                self._buf = self._buf_dev.cpu().numpy()
            except Exception as exc:
                raise KernelFault(f"device render fetch failed: {exc}", stage="render",
                                  cause=type(exc).__name__) from exc
            self._buf_dev = None
        return self._buf

    def json_bytes(self) -> bytes:
        """The full ``[...]`` payload."""
        buf = self._fetch()
        mask = np.arange(self.W) < self.lens[:, None]
        # Every row's closing literal carries the separator comma.
        return b"[" + buf[:self.n][mask].tobytes()[:-1] + b"]"

    def row_bytes(self) -> List[bytes]:
        """Per-row JSON bytes, without the separator comma."""
        if self._rows is None:
            buf = self._fetch()
            self._rows = [buf[i, :ln - 1].tobytes()
                          for i, ln in enumerate(self.lens.tolist())]
        return self._rows


class DeviceRenderer:
    """Per-engine render dispatcher: the :class:`EscapedStrings` table
    and a cache of per-provenance :class:`_KindSpec`."""

    def __init__(self, interner: Interner, device: torch.device) -> None:
        self.interner = interner
        self.device = device
        self.esc = EscapedStrings(interner, device)
        self._spec_cache: Dict[str, _KindSpec] = {}

    def eligible(self, n: int, *, posture: Optional[str] = None) -> bool:
        posture = posture or render_posture()
        if posture == "off" or n <= 0:
            return False
        return posture == "require" or n >= _min_rows()

    def _spec(self, prov_json: str) -> _KindSpec:
        spec = self._spec_cache.get(prov_json)
        if spec is None:
            spec = self._spec_cache[prov_json] = _KindSpec(prov_json)
            if len(self._spec_cache) > 8:
                self._spec_cache.pop(next(iter(self._spec_cache)))
        return spec

    def _row_lens(self, spec: _KindSpec, kind, a_slot, b_slot, base_t, side_t) -> np.ndarray:
        """Each row's byte length on the host (the device program finds
        the same from the same inputs): the literals, 36 for the uuid,
        and the kind's field-body lengths."""
        lens_tab = self.esc.lens_host()
        kc = np.clip(kind, 0, 3).astype(np.int64)
        a = np.clip(a_slot, 0, max(base_t.n - 1, 0))
        b = np.clip(b_slot, 0, max(side_t.n - 1, 0))
        max_id = len(lens_tab) - 1

        def flen(col, slot):
            if not len(col):
                return np.zeros(len(slot), np.int64)
            return lens_tab[np.clip(col[slot], 0, max_id)].astype(np.int64)

        bsym, baddr, bname, bfile = (flen(c, a) for c in (base_t.sym, base_t.addr,
                                                          base_t.name, base_t.file))
        ssym, saddr, sname, sfile = (flen(c, b) for c in (side_t.sym, side_t.addr,
                                                          side_t.name, side_t.file))
        per_kind = np.stack([
            bsym + 2 * baddr + 2 * bname + 2 * sname + sfile,   # rename
            bsym + 4 * baddr + 2 * saddr + bfile + sfile,       # move
            ssym + saddr + sfile,                               # add
            bsym + baddr + bfile,                               # delete
        ])
        return spec.lit_total[kc] + 36 + per_kind[kc, np.arange(len(kind))]

    def dispatch(self, kind: np.ndarray, a_slot: np.ndarray, b_slot: np.ndarray,
                 words: np.ndarray, bcols_dev: torch.Tensor, scols_dev: torch.Tensor,
                 base_t, side_t, prov_json: str, *, require: bool = False
                 ) -> Optional[RenderedStream]:
        """Launch one stream's render. ``bcols_dev``/``scols_dev`` are
        the ``[4, bucket]`` device decl tables, ``base_t``/``side_t`` the
        matching host ``DeclTensor``s. ``None`` for an empty stream or,
        unless ``require``, rows wider than the width guard."""
        n = int(kind.shape[0])
        if n == 0:
            return None
        esc_blob, esc_offs, esc_lens = self.esc.sync()
        spec = self._spec(prov_json)
        lens = self._row_lens(spec, kind, a_slot, b_slot, base_t, side_t)
        W = bucket_size(int(lens.max()), minimum=64)
        if W > _max_width():
            if require:
                raise KernelFault(f"row width {W} exceeds {ENV_MAX_WIDTH}={_max_width()}",
                                  stage="render", cause="width")
            return None
        n_pad = bucket_size(n, minimum=64)
        dev = self.device

        def col(arr, fill):
            return torch.tensor(pad_to(np.asarray(arr, np.int32), n_pad, np.int32(fill)),
                                device=dev)

        w_p = np.zeros((n_pad, 4), np.int32)
        w_p[:n] = words
        buf = _render_program(
            col(kind, 3), col(a_slot, -1), col(b_slot, -1), torch.tensor(w_p, device=dev),
            bcols_dev, scols_dev, torch.tensor(spec.sel, device=dev),
            torch.tensor(spec.lit, device=dev), torch.tensor(spec.litlen, device=dev),
            esc_blob, esc_offs, esc_lens, torch.tensor(spec.blob, device=dev), W=W)
        return RenderedStream(buf, lens, n, W)


def render_view(view, device: torch.device | str) -> Optional[RenderedStream]:
    """Render an :class:`~.oplog_view.OpStreamView`'s op log on
    ``device`` from its own node lists (a fresh interner and decl
    tables), whatever its size: the on-card check and the tests use it
    to hold the render against ``_json_rows``."""
    device = torch.device(device)
    interner = Interner()
    base_t = encode_decls(view.base_nodes, interner)
    side_t = encode_decls(view.side_nodes, interner)

    def table(t):
        bucket = bucket_size(max(t.n, 1))
        return torch.tensor(np.stack([pad_to(c, bucket, np.int32(-1))
                                      for c in (t.sym, t.addr, t.name, t.file)]),
                            device=device)

    return DeviceRenderer(interner, device).dispatch(
        view.kind, view.a_slot, view.b_slot, view.words, table(base_t), table(side_t),
        base_t, side_t, dumps_canonical(view.prov), require=True)
