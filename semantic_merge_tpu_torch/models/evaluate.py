"""Held-out matcher evaluation — pairing precision/recall.

The port of the JAX package's ``models/evaluate.py``. The signature
matcher's product job is pairing a deleted declaration with its
renamed+retyped twin among distractors
(:mod:`semantic_merge_tpu_torch.models.signature`). This harness
measures exactly that, on a held-out synthetic set drawn from the same
generator the training loop uses (``models.training.synth_pair``) with a
disjoint seed: ``n`` true (delete, add) pairs are shuffled into one
candidate pool and the matcher's predicted pairing is scored against the
known correspondence.

Reported per run: predicted-pair count, precision (correct predicted /
predicted), recall (correct predicted / n), at the matcher's configured
threshold. ``train-matcher --eval`` prints this after training.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def evaluate_matcher(matcher, n: int = 48, seed: int = 991) -> Dict:
    """Score ``matcher`` on ``n`` held-out pairs; returns the metrics
    dict. The matcher must be willing to score (trained, or
    ``allow_untrained=True``) — a refusal scores as zero recall, which
    is itself the honest number for the product's degraded mode."""
    from .training import synth_pair

    rng = np.random.RandomState(seed)
    pairs = [synth_pair(rng) for _ in range(n)]
    perm = rng.permutation(n)
    # One shared routing key: every candidate is admissible, the
    # embedding alone must discriminate.
    deletes = [(("function", "eval.ts"), src) for src, _ in pairs]
    adds = [(("function", "eval.ts"), pairs[j][1]) for j in perm]
    truth = {(int(j), k) for k, j in enumerate(perm)}
    got = matcher.pair(deletes, adds)
    correct = sum(1 for p in got if (int(p[0]), int(p[1])) in truth)
    return {
        "n": n,
        "predicted": len(got),
        "correct": correct,
        "precision": round(correct / len(got), 3) if got else 0.0,
        "recall": round(correct / n, 3),
        "threshold": matcher.threshold,
        "trained": bool(getattr(matcher, "trained", False)),
    }
