"""Java language backend (the JAX package's ``backends/java.py``): the
C-family engine (:mod:`semantic_merge_tpu_torch.backends.cfamily`) with
the Java :class:`~semantic_merge_tpu_torch.frontend.cfamily.LanguageSpec`,
registered as ``java``."""
from __future__ import annotations

from ..frontend.cfamily import JAVA
from .base import register_backend
from .cfamily import CFamilyBackend


class JavaBackend(CFamilyBackend):
    name = "java"
    spec = JAVA


register_backend("java", JavaBackend)
