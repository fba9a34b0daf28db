"""C# language backend (the JAX package's ``backends/cs.py``): the
C-family engine (:mod:`semantic_merge_tpu_torch.backends.cfamily`) with
the C# :class:`~semantic_merge_tpu_torch.frontend.cfamily.LanguageSpec`
(namespaces, properties, structs, attributes, expression-bodied members),
registered as ``cs`` and ``csharp``."""
from __future__ import annotations

from ..frontend.cfamily import CSHARP
from .base import register_backend
from .cfamily import CFamilyBackend


class CSharpBackend(CFamilyBackend):
    name = "cs"
    spec = CSHARP


register_backend("cs", CSharpBackend)
register_backend("csharp", CSharpBackend)
