"""Decl source → model token ids.

Reuses the frontend tokenizer (the same one the scanner indexes with,
:mod:`semantic_merge_tpu_torch.frontend.tokenizer`) so model features see
exactly the token stream the differ saw. Identifiers and literals hash
into a fixed vocabulary (stable across runs — plain fnv1a, no Python
``hash`` randomization); punctuation and keywords get reserved ids so
structural tokens never collide with names.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..frontend.tokenizer import tokenize

PAD = 0
_RESERVED = 2  # PAD + UNK

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def _fnv1a(text: str) -> int:
    h = _FNV_OFFSET
    for byte in text.encode("utf-8"):
        h = np.uint64((int(h) ^ byte) * int(_FNV_PRIME) & 0xFFFFFFFFFFFFFFFF)
    return int(h)


def encode_source(content: str, vocab: int, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """One decl's source text → (ids (max_len,), mask (max_len,))."""
    ids = np.zeros((max_len,), np.int32)
    mask = np.zeros((max_len,), bool)
    toks = tokenize(content)
    for i, tok in enumerate(toks[:max_len]):
        ids[i] = _RESERVED + _fnv1a(f"{tok.type}:{tok.text}") % (vocab - _RESERVED)
        mask[i] = True
    return ids, mask


def encode_batch(sources: Sequence[str], vocab: int, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Batch of decl sources → (B, max_len) ids + mask arrays."""
    ids = np.zeros((len(sources), max_len), np.int32)
    mask = np.zeros((len(sources), max_len), bool)
    for i, src in enumerate(sources):
        ids[i], mask[i] = encode_source(src, vocab, max_len)
    return ids, mask
