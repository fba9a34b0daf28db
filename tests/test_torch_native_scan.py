"""The port's native scanner and decl cache against the JAX package's
Python scanner.

- ``native.try_scan_snapshot`` (the port's own copy of the C++ library,
  built into ``semantic_merge_tpu_torch/frontend/_build/``) equals the
  JAX ``scan_snapshot_py`` ``DeclNode`` for ``DeclNode`` (``to_dict()``
  and ``signature``) on every case of ``tests/golden/`` and
  ``tests/test_native_frontend.py::CASES``, on ``bench.synth_repo``
  snapshots and on seeded random snapshots.
- A non-ASCII snapshot is refused by the library and scanned in Python,
  with equal results.
- Keyed scans through a cache, cold and warm, give equal nodes; a merge
  with a warm cache gives the bytes of a cold one and of the Python
  scanner's.
- A library that cannot be built raises ``ParseFault`` and never scans
  in Python.

Skipped only where no C++ compiler is on ``PATH``.
"""
import json
import pathlib
import shutil

import numpy as np
import pytest

from semantic_merge_tpu.frontend.scanner import scan_snapshot_py as jax_scan
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
from semantic_merge_tpu_torch.errors import ParseFault
from semantic_merge_tpu_torch.frontend import native
from semantic_merge_tpu_torch.frontend.declcache import DeclCache
from semantic_merge_tpu_torch.frontend.scanner import (ScanStats, scan_snapshot,
                                                        scan_snapshot_keyed)
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot

from test_native_frontend import CASES
from test_torch_strict import KW, _dicts, _files, seeded_trees

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler (g++) on PATH")

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _golden_cases():
    return sorted(p.stem for p in GOLDEN.glob("*.json"))


def _golden_files(name):
    return json.loads((GOLDEN / f"{name}.json").read_text())["files"]


def _assert_equal(got, want):
    assert [n.to_dict() for n in got] == [n.to_dict() for n in want]
    assert [n.signature for n in got] == [n.signature for n in want]


@pytest.mark.parametrize("name", _golden_cases())
def test_native_scan_equals_jax_python_scan_golden(name):
    files = _golden_files(name)
    got = native.try_scan_snapshot(files)
    assert got is not None
    _assert_equal(got, jax_scan(files))


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_scan_equals_jax_python_scan_cases(name):
    files = [{"path": f"{name}.ts", "content": CASES[name]}]
    _assert_equal(native.try_scan_snapshot(files), jax_scan(files))


def test_native_scan_all_cases_one_snapshot():
    files = [{"path": f"src/{name}.ts", "content": src} for name, src in sorted(CASES.items())]
    _assert_equal(native.try_scan_snapshot(files), jax_scan(files))


@pytest.mark.parametrize("divergent", [False, True])
def test_native_scan_equals_jax_python_scan_synth_repo(divergent):
    import bench
    for snap in bench.synth_repo(48, 4, divergent=divergent):
        _assert_equal(native.try_scan_snapshot(snap.files), jax_scan(snap.files))


@pytest.mark.parametrize("seed", range(4))
def test_native_scan_equals_jax_python_scan_seeded(seed):
    for tree in seeded_trees(seed):
        files = _files(tree)
        _assert_equal(native.try_scan_snapshot(files), jax_scan(files))
        stats = ScanStats()
        _assert_equal(scan_snapshot(files, cache=DeclCache(), stats=stats), jax_scan(files))
        assert stats.scanner == "native"


NON_ASCII = [{"path": "u.ts", "content": "const s = 'héllo';\n"
              "export interface Ünï { a: number }\n"
              "function f(x: number, u: Ünï): number { return x; }\n"},
             {"path": "v.ts", "content": "export function g(y: string): string { return y; }\n"}]


@pytest.mark.parametrize("cache", ["cold", "warm"])
def test_non_ascii_snapshot_is_scanned_in_python(cache):
    """Cold, the combined native pass refuses the snapshot; warm with
    the ASCII file alone, the subset rescan against the non-ASCII
    declared set does."""
    assert native.try_scan_snapshot(NON_ASCII) is None
    assert native.try_scan_with_names(NON_ASCII) is None
    decls = DeclCache()
    if cache == "warm":
        scan_snapshot(NON_ASCII[1:], cache=decls)
    stats = ScanStats()
    got = scan_snapshot(NON_ASCII, cache=decls, stats=stats)
    _assert_equal(got, jax_scan(NON_ASCII))
    assert stats.scanner == "python" and stats.python_files == len(NON_ASCII)
    assert stats.hits == (1 if cache == "warm" else 0)  # v.ts's type names


@pytest.mark.parametrize("seed", range(3))
def test_keyed_scans_warm_and_cold_are_equal(seed):
    base, side, other = (_files(t) for t in seeded_trees(seed))
    warm = DeclCache()
    stats = ScanStats()
    keyed = [scan_snapshot_keyed(files, cache=warm, stats=stats)
             for files in (base, side, other)]
    assert stats.hits > 0 and stats.misses > 0  # the sides share base's files
    for files, got in zip((base, side, other), keyed):
        cold = scan_snapshot_keyed(files, cache=DeclCache())
        assert [(k, [n.to_dict() for n in ns]) for k, ns in got] == \
            [(k, [n.to_dict() for n in ns]) for k, ns in cold]
        _assert_equal([n for _, ns in got for n in ns], jax_scan(files))
        python = scan_snapshot_keyed(files, cache=DeclCache(), native=False)
        assert [k for k, _ in python] == [k for k, _ in got]
    again = ScanStats()
    scan_snapshot_keyed(side, cache=warm, stats=again)
    assert again.scanner == "cache" and again.misses == 0


def test_cold_scan_of_a_subset_uses_the_synthetic_decls_file():
    """A warm cache whose declared-name set changed rescans the missed
    files natively against the full set (the synthetic-decls file)."""
    files = [{"path": "a.ts", "content": "export interface Foo { a: number }\n"},
             {"path": "b.ts", "content": "export function f(x: Foo): Foo { return x; }\n"}]
    cache = DeclCache()
    scan_snapshot_keyed(files[1:], cache=cache)  # Foo is undeclared: any
    stats = ScanStats()
    got = scan_snapshot(files, cache=cache, stats=stats)
    _assert_equal(got, jax_scan(files))
    assert stats.native_files == 2 and stats.hits == 1  # b.ts's type names
    assert "Foo" in got[-1].signature


@pytest.mark.parametrize("seed", range(2))
def test_merge_with_warm_cache_equals_cold(seed):
    snaps = [Snapshot(files=_files(t)) for t in seeded_trees(seed)]
    kw = dict(KW, statement_ops=True)
    cache = DeclCache()
    warm = TorchTSBackend(device="cpu", decl_cache=cache)
    first = warm.merge(*snaps, **kw)
    second = warm.merge(*snaps, **kw)
    assert warm.phases["scanner"] == "cache" and warm.phases["decl_cache_misses"] == 0
    cold = TorchTSBackend(device="cpu", decl_cache=DeclCache()).merge(*snaps, **kw)
    python = TorchTSBackend(device="cpu", native_scan=False,
                            decl_cache=DeclCache()).merge(*snaps, **kw)
    for res in (first, second, python):
        assert _dicts(res[0].op_log_left) == _dicts(cold[0].op_log_left)
        assert _dicts(res[0].op_log_right) == _dicts(cold[0].op_log_right)
        assert _dicts(res[1]) == _dicts(cold[1]) and _dicts(res[2]) == _dicts(cold[2])


def test_fused_merge_records_the_native_scan():
    snaps = [Snapshot(files=_files(t)) for t in seeded_trees(5)]
    backend = TorchTSBackend(device="cpu", decl_cache=DeclCache())
    backend.merge(*snaps, **KW)
    assert backend.path == "fused" and backend.phases["scanner"] == "native"
    assert backend.phases["decl_cache_hits"] > 0 and backend.phases["decl_cache_misses"] > 0


def test_memory_cap_bounds_the_cache(tmp_path, monkeypatch):
    """``[core] memory_cap_mb`` reaches the process-wide cache (half of
    it, as the JAX CLI applies it), and the LRU evicts past the cap."""
    from semantic_merge_tpu_torch.cli import _load_config
    from semantic_merge_tpu_torch.frontend import declcache
    monkeypatch.setattr(declcache, "_GLOBAL", None)
    (tmp_path / ".semmerge.toml").write_text("[core]\nmemory_cap_mb = 6\n")
    monkeypatch.chdir(tmp_path)
    assert _load_config("semdiff").core.memory_cap_mb == 6
    assert declcache.global_cache().cap_bytes == 3 * 1024 * 1024
    cache = DeclCache(cap_mb=1)
    for k in range(4):
        cache.put(k, "x", size=400 * 1024)
    assert cache.evictions == 2 and cache.get(0) is None and cache.get(1) is None
    assert cache.get(3) == "x" and (cache.hits, cache.misses) == (1, 2)


def _fresh_native(monkeypatch, tmp_path):
    """The native module as a process that has not loaded the library,
    building into ``tmp_path``."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")


@pytest.mark.parametrize("fault", ["no_compiler", "broken_source"])
def test_failed_native_build_raises_parse_fault(monkeypatch, tmp_path, fault):
    _fresh_native(monkeypatch, tmp_path)
    if fault == "no_compiler":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
    else:
        broken = tmp_path / "semmerge_native.cpp"
        broken.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SOURCE", broken)
    files = _files(seeded_trees(0)[0])
    warm = DeclCache()  # all but the first file: the subset path
    scan_snapshot(files[1:], cache=warm, native=False)
    called = []
    monkeypatch.setattr("semantic_merge_tpu_torch.frontend.scanner._scan_tokens",
                        lambda *a: called.append(a) or [])
    for cache in (DeclCache(), warm):
        with pytest.raises(ParseFault):
            scan_snapshot(files, cache=cache)
    assert not native.available()
    assert called == []  # never scanned in Python instead
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_build_is_keyed_by_the_source_and_renamed_into_place(monkeypatch, tmp_path):
    _fresh_native(monkeypatch, tmp_path)
    path = native.library_path()
    assert path.parent == tmp_path / "_build" and not path.exists()
    assert native.build() > 0 and path.is_file()
    assert native.build() == 0.0
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [path.name]
    files = [{"path": "a.ts", "content": "export function f(x: number): number { return x; }\n"}]
    _assert_equal(native.try_scan_snapshot(files), jax_scan(files))
    assert pathlib.Path(native._lib._name) == path


@pytest.mark.parametrize("seed", range(2))
def test_native_scan_equals_jax_in_any_file_order(seed):
    rs = np.random.RandomState(seed)
    files = _files(seeded_trees(seed)[0])
    order = rs.permutation(len(files))
    shuffled = [files[i] for i in order]
    _assert_equal(native.try_scan_snapshot(shuffled), jax_scan(shuffled))
