"""The port's keyed encode cache against the flat encode and the JAX
package's ``encode_decls_keyed``.

- ``core/encode.py::encode_decls_keyed`` over the per-file scan groups of
  seeded snapshots gives the tensor of ``encode_decls`` over the flat
  node list under the same interner, the same flat list, and the JAX
  function's ids (each package's interner fed the same groups).
- A second encode of the same groups hits the cache (no new interned
  string, no cache miss) and gives identical columns; a new interner
  (another token, as after the growth guard's reset) never reads the
  old entries, and its ids equal a cold encode's.
- ``TorchTSBackend`` now encodes through the cache: a warm merge of one
  backend gives the op logs, composed stream and conflicts of a cold
  backend (and of one with no cache hits at all).
"""
import numpy as np
import pytest

from semantic_merge_tpu.core.encode import Interner as JaxInterner
from semantic_merge_tpu.core.encode import encode_decls_keyed as jax_encode_keyed
from semantic_merge_tpu.frontend.declcache import DeclCache as JaxDeclCache
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend, ts_files
from semantic_merge_tpu_torch.core.encode import Interner, encode_decls, encode_decls_keyed
from semantic_merge_tpu_torch.frontend.declcache import DeclCache
from semantic_merge_tpu_torch.frontend.scanner import scan_snapshot_keyed
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot

from test_torch_strict import KW, _dicts, _files, seeded_trees


def _cols(t):
    return [t.sym.tolist(), t.addr.tolist(), t.name.tolist(), t.file.tolist(), t.n]


def _groups(seed):
    cache = DeclCache()
    return [scan_snapshot_keyed(ts_files(Snapshot(files=_files(tree))), cache=cache)
            for tree in seeded_trees(seed)]


@pytest.mark.parametrize("seed", range(3))
def test_keyed_equals_flat_and_the_jax_encode(seed):
    groups = _groups(seed)
    keyed_it, flat_it, jax_it = Interner(), Interner(), JaxInterner()
    cache, jax_cache = DeclCache(), JaxDeclCache()
    for keyed in groups:
        t, flat = encode_decls_keyed(keyed, keyed_it, cache)
        assert flat == [n for _, nodes in keyed for n in nodes]
        assert _cols(t) == _cols(encode_decls(flat, flat_it))
        jt, jflat = jax_encode_keyed(keyed, jax_it, jax_cache)
        assert _cols(t) == _cols(jt) and len(jflat) == len(flat)
        for col in (t.sym, t.addr, t.name, t.file):
            assert col.dtype == np.int32
    assert keyed_it.strings == flat_it.strings == jax_it.strings


def test_a_repeat_hits_and_a_new_interner_misses():
    keyed = _groups(1)[0]
    it, cache = Interner(), DeclCache()
    first, _ = encode_decls_keyed(keyed, it, cache)
    strings, misses = len(it.strings), cache.misses
    second, _ = encode_decls_keyed(keyed, it, cache)
    assert _cols(second) == _cols(first)
    assert len(it.strings) == strings and cache.misses == misses
    assert cache.hits >= sum(1 for _, nodes in keyed if nodes)
    # A reset interner: another token, so no entry of the old one is read.
    fresh = Interner()
    fresh.intern("a string the old id space never saw")
    hits = cache.hits
    third, _ = encode_decls_keyed(keyed, fresh, cache)
    assert cache.hits == hits
    cold = Interner()
    cold.intern("a string the old id space never saw")
    assert _cols(third) == _cols(encode_decls([n for _, ns in keyed for n in ns], cold))
    assert _cols(third) != _cols(first)


def test_no_cache_and_empty_groups():
    keyed = _groups(2)[0]
    t, flat = encode_decls_keyed(keyed, Interner())
    assert _cols(t) == _cols(encode_decls(flat, Interner()))
    empty, nothing = encode_decls_keyed([], Interner(), DeclCache())
    assert empty.n == 0 and nothing == []


@pytest.mark.parametrize("seed", range(2))
def test_backend_merges_through_the_cache_with_cold_bytes(seed):
    snaps = [Snapshot(files=_files(t)) for t in seeded_trees(seed)]
    cache = DeclCache()
    warm = TorchTSBackend(device="cpu", decl_cache=cache)
    first = warm.merge(*snaps, **KW)
    hits = cache.hits
    second = warm.merge(*snaps, **KW)
    assert cache.hits > hits
    cold = TorchTSBackend(device="cpu", decl_cache=DeclCache()).merge(*snaps, **KW)
    for res in (first, second):
        assert _dicts(res[0].op_log_left) == _dicts(cold[0].op_log_left)
        assert _dicts(res[0].op_log_right) == _dicts(cold[0].op_log_right)
        assert _dicts(res[1]) == _dicts(cold[1]) and _dicts(res[2]) == _dicts(cold[2])
