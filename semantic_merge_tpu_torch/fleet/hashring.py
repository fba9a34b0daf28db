"""Rendezvous (highest-random-weight) hashing for repo → member
affinity, the JAX package's ``fleet/hashring.py`` (the same scores, so
both packages give every key the same owner).

Every (key, member) pair gets an independent 64-bit score (blake2b); a
key's owner is the highest-scoring member, and removing a member only
promotes the runner-up for the keys it owned — every other key's
ranking is untouched. The full descending ranking doubles as the
failover order and the hedge-target order.

Keys are canonicalized request working directories (:func:`repo_key`),
so per-repo state — the inplace lockfile, the decl cache, warm
residency — concentrates on one member across requests and failovers.
Pure stdlib.
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Sequence


def repo_key(cwd: str) -> str:
    """Canonical affinity key for a request working directory: every
    spelling of one directory (symlinks, ``..``) hashes identically. The
    request cwd, not the git toplevel: the router stays git-free."""
    try:
        return os.path.realpath(cwd or ".")
    except OSError:
        return os.path.normpath(cwd or ".")


def _score(key: str, member: str) -> int:
    digest = hashlib.blake2b(
        key.encode("utf-8", "surrogateescape") + b"\x00" +
        member.encode("utf-8", "surrogateescape"),
        digest_size=8).digest()
    return int.from_bytes(digest, "big")


def rank(key: str, members: Sequence[str]) -> List[str]:
    """Members ranked best-first for ``key``: ``[0]`` is the owner,
    ``[1]`` the failover / hedge target; ties break on the member id so
    the order is total."""
    return sorted(members, key=lambda m: (_score(key, m), m), reverse=True)


def owner(key: str, members: Sequence[str]) -> str:
    """The owning member for ``key`` (raises on an empty fleet)."""
    if not members:
        raise ValueError("rendezvous rank over an empty member set")
    return max(members, key=lambda m: (_score(key, m), m))


def moved_keys(keys: Sequence[str], before: Sequence[str],
               after: Sequence[str]) -> List[str]:
    """Keys whose owner changes between two member sets (the router's
    ``fleet_rehash_moves_total``)."""
    if not before or not after:
        return list(keys) if (before or after) else []
    return [k for k in keys if owner(k, before) != owner(k, after)]
