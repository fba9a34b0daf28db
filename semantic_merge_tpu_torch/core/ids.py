"""Deterministic identity scheme.

The reference extractor mints ``crypto.randomUUID()`` op ids and
wall-clock ISO timestamps (reference ``workers/ts/src/lift.ts:5-9``),
which makes its op logs nondeterministic and breaks its own
byte-identical-output requirement (reference ``requirements.md:163``
[NFR-DET-001]) — the compose sort key includes both fields (reference
``semmerge/compose.py:16-18``).

Here every id is a pure function of ``(seed, content, sequence number)``:

- op ids are UUID-formatted hex derived from SHA-256, so they are
  drop-in-compatible with consumers that slice them like UUIDs (the
  conflict id uses ``op.id[:8]``, reference ``semmerge/conflict.py:38``);
- timestamps are the source revision's commit time (or the epoch), not
  wall clock.

Any backend (host CPU oracle, TPU device path, a future native worker)
that derives ops from the same inputs with the same seed produces
bit-identical op logs — the parity property the BASELINE north star
demands.
"""
from __future__ import annotations

import functools
import hashlib

from .ops import OP_TYPES

EPOCH_ISO = "1970-01-01T00:00:00Z"


def stable_hash_hex(*parts, n_hex: int = 64) -> str:
    """SHA-256 over the ``|``-joined string forms of *parts*."""
    payload = "|".join(str(p) for p in parts)
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:n_hex]


#: Stable 1-byte code per schema op type (OP_TYPES is schema-ordered and
#: append-only). The device diff kinds 0-3 coincide with the first four.
_TYPE_CODE = {t: i for i, t in enumerate(OP_TYPES)}
# Load-bearing: the device hashes clip(kind, 0, 3) straight into the id
# payload (ops/fused._op_id_words), so the KIND_* codes MUST stay equal
# to these type codes — reordering OP_TYPES would silently fork ids.
# Checked unconditionally (not `assert`): `python -O` must not strip it.
if [_TYPE_CODE[t] for t in
        ("renameSymbol", "moveDecl", "addDecl", "deleteDecl")] != [0, 1, 2, 3]:
    raise AssertionError(
        "OP_TYPES order changed: device KIND_* codes no longer match the "
        "first four op-type codes; op ids would silently fork")


@functools.lru_cache(maxsize=4096)
def op_id_prefix_digest(seed: str, rev: str) -> bytes:
    """16-byte digest of the (seed, rev) pair — the per-merge-side
    constant prefix of every op-id payload.

    Length-prefixing the seed makes the encoding injective: the v1
    ``f"{seed}|{rev}"`` form collided ("a|b","c") with ("a","b|c").
    This is id scheme v2 (changes every op id vs v1; nothing pins v1
    hex values — parity is host↔device, and both call this)."""
    seed_b = seed.encode("utf-8")
    payload = len(seed_b).to_bytes(4, "big") + seed_b + rev.encode("utf-8")
    return hashlib.sha256(payload).digest()[:16]


@functools.lru_cache(maxsize=262144)
def value_digest10(s: str) -> bytes:
    """80-bit value hash of a string (``b"\\0"*10`` for the empty
    string / absent value). Cached: symbol/address/file strings repeat
    across the tens of thousands of ops of a large merge, and the
    device path ships exactly these digests in its hash table."""
    if not s:
        return b"\0" * 10
    return hashlib.sha256(s.encode("utf-8")).digest()[:10]


def deterministic_op_id(seed: str, rev: str = "", idx: int = 0,
                        op_type: str = "", sym: str = "",
                        a_addr: str = "", b_addr: str = "") -> str:
    """A UUID-shaped (8-4-4-4-12) deterministic id.

    SHA-256 over ONE fixed 51-byte payload: ``prefix_digest(seed, rev)
    (16) ‖ idx be32 (4) ‖ type code (1) ‖ h80(sym) ‖ h80(aAddr) ‖
    h80(bAddr)``. Fixed width keeps the device twin to a single SHA
    block with no byte-assembly gathers (the variable-length ASCII
    payload of the v1 scheme was ~2/3 of the fused kernel's compute);
    the 80-bit string digests keep collision odds negligible at
    repo-scale string counts. Identity properties are unchanged: ids
    are pure functions of (seed, rev, index, type, symbol, addresses).
    """
    payload = (op_id_prefix_digest(seed, rev)
               + int(idx).to_bytes(4, "big")
               + bytes([_TYPE_CODE.get(op_type, 255)])
               + value_digest10(sym) + value_digest10(a_addr)
               + value_digest10(b_addr))
    h = hashlib.sha256(payload).hexdigest()[:32]
    return f"{h[0:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"


def symbol_id_from_signature(sig: str) -> str:
    """SymbolId = first 16 hex chars of sha256(structural signature).

    Identical to the reference's scheme (reference
    ``workers/ts/src/sast.ts:69-71,96``); exactly 64 bits, so device code
    can carry symbol ids losslessly as int64 lanes.
    """
    return hashlib.sha256(sig.encode("utf-8")).hexdigest()[:16]
