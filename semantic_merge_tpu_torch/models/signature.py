"""Embedding-scored changeSignature pairing — the matcher in the product.

The port of the JAX package's ``models/signature.py``. The exact-key
refinement pass
(:func:`semantic_merge_tpu_torch.core.difflift.refine_signature_changes`)
recovers pairs that kept their ``(file, name, kind)``; this module
recovers declarations that were renamed *and* retyped by scoring the
residual (deleted, added) candidates with the matcher's embeddings and
accepting cosine matches above a threshold.

Deterministic by construction: parameters come from the matcher
checkpoint in ``ckpt_dir`` when one exists or from the seeded
initializer, candidate order is stream order, and ties break by
``(score desc, delete idx, add idx)`` with the scores compared in numpy
on the host, exactly as the JAX package does. Unlike the JAX package, a
failure to build or launch the encoder's kernel raises: it never
degrades to exact-key pairing.

In a merge sharded over several ranks the matcher runs on the engine
mesh (``mesh``), as the JAX package embeds under ``build_mesh()``: every
rank holds its shards of the encoder, embeds its ``dp`` block of the
candidate rows (padded to a multiple of ``dp``), and the embeddings are
gathered on every rank, so each rank pairs the same candidates. The
pairings, and so the op logs, are the one-device matcher's.
"""
from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.encode import bucket_size
from ..device import resolve_device
from .encoder import Encoder
from .features import encode_batch
from .matcher import MatcherConfig, embed_global, load_matcher_checkpoint, shard_state

logger = logging.getLogger(__name__)


class EmbeddingSignatureMatcher:
    """Scores residual delete/add decl pairs by embedding similarity.

    Lazy: the encoder is built (and its kernel compiled) on first use,
    so constructing the matcher costs nothing if no residual candidates
    appear. ``device`` is resolved at construction: CUDA unless
    ``"cpu"`` is asked for; with ``mesh``, the mesh's device (every rank
    of the mesh then calls :meth:`pair` and :meth:`embed_texts` together).
    """

    def __init__(self, threshold: float = 0.85, ckpt_dir: str | None = None,
                 seed: int = 0, seq_len: int = 64,
                 max_candidates: int = 512,
                 allow_untrained: bool = False,
                 cfg: MatcherConfig | None = None,
                 device: str | torch.device | None = None, mesh=None) -> None:
        self.threshold = threshold
        #: Optional MatcherConfig override (default: the product
        #: config) — must match the checkpoint's shapes.
        self._cfg_override = cfg
        self.ckpt_dir = ckpt_dir
        self.seed = seed
        self.seq_len = seq_len
        self.max_candidates = max_candidates
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(str(device) if device is not None else None)
        #: Whether parameters came from a checkpoint. Scoring with
        #: seeded-random parameters produces deterministic but
        #: semantically arbitrary pairings, so the product path refuses
        #: it unless ``allow_untrained`` opts in (tests, evaluation).
        self.trained = False
        self.allow_untrained = allow_untrained
        self.encoder: Encoder | None = None

    def _ensure(self) -> Encoder:
        if self.encoder is not None:
            return self.encoder
        cfg = (self._cfg_override or MatcherConfig()).encoder
        loaded = load_matcher_checkpoint(self.ckpt_dir) if self.ckpt_dir else None
        if loaded is not None:
            ckpt_cfg, state = loaded
            if self._cfg_override is not None and ckpt_cfg != cfg:
                raise ValueError(f"matcher checkpoint in {self.ckpt_dir} has config "
                                 f"{ckpt_cfg}, expected {cfg}")
            encoder = Encoder(ckpt_cfg, mesh=self.mesh)
            encoder.load_state_dict(shard_state(state, self.mesh) if self.mesh else state)
            self.trained = True
        else:
            encoder = Encoder(cfg, generator=torch.Generator().manual_seed(self.seed),
                              mesh=self.mesh)
        self.encoder = encoder.to(self.device).eval()
        return self.encoder

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Decl sources → (len(texts), D) f32 unit embeddings, computed
        in a batch padded to ``bucket_size``."""
        encoder = self._ensure()
        ids, mask = encode_batch(list(texts), encoder.cfg.vocab, self.seq_len)
        pad = bucket_size(max(len(texts), 1))  # stable padded shapes
        if self.mesh is not None:
            dp = self.mesh.axis_size("dp")
            pad = -(-pad // dp) * dp
        ids = np.pad(ids, ((0, pad - len(texts)), (0, 0)))
        mask = np.pad(mask, ((0, pad - len(texts)), (0, 0)))
        with torch.inference_mode():
            z = embed_global(encoder, torch.from_numpy(ids).long().to(self.device),
                             torch.from_numpy(mask).to(self.device))
        return z.cpu().numpy()[:len(texts)]

    def pair(self, deletes: List[Tuple[object, str]],
             adds: List[Tuple[object, str]]) -> List[Tuple[int, int]]:
        """``deletes``/``adds`` are ``(routing_key, source_text)`` in
        stream order — the routing key is any equatable value (the
        differ passes ``(kind, file)``); only candidates with equal
        keys may pair. Returns matched ``(delete_idx, add_idx)`` pairs
        with cosine similarity above the threshold, each side consumed
        at most once, ties broken by score then stream position."""
        if not deletes or not adds:
            return []
        if (len(deletes) > self.max_candidates
                or len(adds) > self.max_candidates):
            logger.warning("signature matcher: %d/%d residual candidates "
                           "exceed cap %d; skipping model pairing",
                           len(deletes), len(adds), self.max_candidates)
            return []
        self._ensure()
        if not self.trained and not self.allow_untrained:
            logger.warning(
                "signature matcher has NO trained checkpoint (ckpt_dir=%r): "
                "refusing to score with seeded-random parameters; only "
                "exact-key pairs will be used. Train one with 'python -m "
                "semantic_merge_tpu_torch train-matcher --ckpt-dir DIR' and set "
                "[engine] matcher_ckpt_dir.", self.ckpt_dir)
            return []
        zd = self.embed_texts([t for _, t in deletes])
        za = self.embed_texts([t for _, t in adds])
        scores = zd @ za.T  # cosine: embeddings are L2-normalized
        candidates = []
        for i, (dk, _) in enumerate(deletes):
            for j, (ak, _) in enumerate(adds):
                if dk == ak and scores[i, j] >= self.threshold:
                    candidates.append((-float(scores[i, j]), i, j))
        candidates.sort()
        used_d: set = set()
        used_a: set = set()
        out: List[Tuple[int, int]] = []
        for _, i, j in candidates:
            if i in used_d or j in used_a:
                continue
            used_d.add(i)
            used_a.add(j)
            out.append((i, j))
        out.sort()
        return out
