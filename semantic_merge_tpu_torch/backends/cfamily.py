"""Shared backend body of the C-family (Java and C#) engines — the port's
counterpart of the JAX package's ``backends/cfamily.py``.

Java and C# differ only in their :class:`LanguageSpec`. The scan is the
C-family scanner (:mod:`semantic_merge_tpu_torch.frontend.cfamily`,
plain Python: no native scanner and no decl cache, as in the JAX
package), interned into a new id space per call; from there the backend
takes the port's two-program path on its device
(:class:`~semantic_merge_tpu_torch.backends.ts_torch.DeviceDiffBackend`):
the device diff join, the changeSignature refinement (the embedding
matcher's encoder and ``flash_chunk`` on the card), the lift, the
statement ops, and the compose on the device. The JAX backend diffs and
composes on the host (``core/difflift.py::diff_nodes``,
``host_compose``); the JAX package holds its device diff and compose to
those, and the port's tests hold this backend's op logs, composed stream
and conflicts to the JAX backend's, byte for byte.

No fused engine and no ``merge`` method: a merge runs
``build_and_diff`` then ``compose`` (``backends/base.py::run_merge``),
with the JAX spans. The scan never reads the warm residency cache,
whose keys (repository, tree, scope) do not name the language.
"""
from __future__ import annotations

from typing import List

from ..core.encode import Interner, encode_decls
from ..core.ids import EPOCH_ISO
from ..core.ops import Op
from ..errors import fault_boundary
from ..frontend.cfamily import LanguageSpec, scan_snapshot_cfamily
from ..frontend.snapshot import Snapshot
from .ts_torch import DeviceDiffBackend, _PhaseClock


class CFamilyBackend(DeviceDiffBackend):
    """Backend over the C-family scanner; subclasses set ``spec`` and
    ``name``. ``host_workers`` is accepted for the registry and unused
    (no fused engine)."""

    spec: LanguageSpec

    def __init__(self, device: str | None = None, host_workers: int | None = None) -> None:
        super().__init__(device)

    @property
    def extensions(self) -> frozenset:
        return self.spec.extensions

    def _scan_encode(self, snaps, clock):
        """Scan each snapshot's files of this language and encode the
        decls into one new id space. Phases ``scan`` and ``encode``. A
        scan that fails raises :class:`~semantic_merge_tpu_torch.errors.
        ParseFault`."""
        with fault_boundary("scan"):
            nodes = [scan_snapshot_cfamily(self._files(s), self.spec) for s in snaps]
        clock.lap("scan")
        interner = Interner()
        tensors = [encode_decls(n, interner) for n in nodes]
        clock.lap("encode")
        return nodes, tensors

    def diff(self, base: Snapshot, right: Snapshot,
             *, base_rev: str = "base", seed: str = "0",
             timestamp: str | None = None,
             change_signature: bool = False,
             structured_apply: bool = False,
             signature_matcher=None,
             statement_ops: bool = False) -> List[Op]:
        """The op log from ``base`` to ``right`` on the two-program path."""
        clock = _PhaseClock(self.phases)
        (base_nodes, right_nodes), (base_t, right_t) = self._scan_encode((base, right), clock)
        return self._diff_two_program(base, right, base_nodes, right_nodes, base_t, right_t,
                                      clock, base_rev=base_rev, seed=seed,
                                      timestamp=timestamp or EPOCH_ISO,
                                      change_signature=change_signature,
                                      structured_apply=structured_apply,
                                      signature_matcher=signature_matcher,
                                      statement_ops=statement_ops)
