"""``SEMMERGE_CACHE=0`` turns the decl cache off, as in the JAX package.

- ``global_cache()`` is ``None`` under ``SEMMERGE_CACHE=0`` (or
  ``off``), a ``DeclCache`` otherwise, in both packages; ``configure``
  and the scanner take ``None`` (an uncached scan: every key ``None``,
  the same nodes as a cached scan).
- A traced ``semmerge --inplace`` with the cache off writes the JAX
  CLI's trace counter keys — no ``decl_cache_hits`` or
  ``decl_cache_misses`` — and, with it on, both packages' keys hold the
  two counters; the merged tree is the same either way.
"""
import gc
import json
import os
import shutil
import subprocess
import sys

import pytest

from semantic_merge_tpu.frontend import declcache as jax_declcache
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.frontend import declcache, scanner
from semantic_merge_tpu_torch.obs import flight, metrics

from test_torch_merge import REPO_ROOT, _make_repo, _tree_bytes

FOO = "export function foo(n: number): number {\n  return n;\n}\n"
EXTRA = "export function extra(s: string): string { return s; }\n"
MERGE = ["semmerge", "basebr", "branch-a", "branch-b", "--inplace", "--trace"]
TRACE = ".semmerge-trace.json"
DECL_COUNTERS = {"decl_cache_hits", "decl_cache_misses"}


@pytest.mark.parametrize("value,enabled", [("0", False), ("off", False), (" OFF ", False),
                                           ("1", True), ("", True), (None, True)])
def test_global_cache_follows_the_switch(monkeypatch, value, enabled):
    monkeypatch.setattr(declcache, "_GLOBAL", None)
    if value is None:
        monkeypatch.delenv("SEMMERGE_CACHE", raising=False)
    else:
        monkeypatch.setenv("SEMMERGE_CACHE", value)
    assert declcache.enabled() == jax_declcache.enabled() == enabled
    cache = declcache.global_cache()
    assert (cache is not None) == enabled
    assert isinstance(cache, declcache.DeclCache) or cache is None
    declcache.configure(64)  # takes the disabled cache too


def test_uncached_scan_keys_nothing_and_scans_the_same(monkeypatch):
    files = [{"path": "src/a.ts", "content": FOO}, {"path": "src/b.ts", "content": EXTRA}]
    cached = scanner.scan_snapshot_keyed(files, cache=declcache.DeclCache(), native=False)
    monkeypatch.setenv("SEMMERGE_CACHE", "0")
    stats = scanner.ScanStats()
    uncached = scanner.scan_snapshot_keyed(files, native=False, stats=stats)
    assert [k for k, _ in uncached] == [None, None]
    assert [[(n.symbolId, n.addressId) for n in v] for _, v in uncached] == \
        [[(n.symbolId, n.addressId) for n in v] for _, v in cached]
    assert (stats.hits, stats.misses) == (0, 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("declcache")
    origin = work / "origin"
    _make_repo(origin, {"src/util.ts": FOO}, {"src/util.ts": FOO.replace("foo", "bar")},
               {"src/extra.ts": EXTRA})
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off")
    roots, procs = {}, {}
    for switch in ("off", "on"):
        for side in ("jax", "port"):
            roots[switch, side] = work / f"{switch}-{side}"
            shutil.copytree(origin, roots[switch, side])
        extra = {"SEMMERGE_CACHE": "0"} if switch == "off" else {}
        procs[switch] = subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu", *MERGE], cwd=roots[switch, "jax"],
            env=dict(env, **extra), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
    out = {}
    threshold = gc.get_threshold()
    try:
        for switch in ("off", "on"):
            with pytest.MonkeyPatch.context() as mp:
                mp.chdir(roots[switch, "port"])
                for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
                    mp.delenv(key)
                mp.setenv("SEMMERGE_DAEMON", "off")
                if switch == "off":
                    mp.setenv("SEMMERGE_CACHE", "0")
                mp.setattr(declcache, "_GLOBAL", None)  # a new process's empty cache
                metrics.REGISTRY.reset()
                flight.reset()
                out[switch, "port"] = cli.main([*MERGE, "--device", "cpu"])
        for switch, proc in procs.items():
            _, stderr = proc.communicate(timeout=300)
            out[switch, "jax"] = proc.returncode
            assert proc.returncode == 0, stderr
    finally:
        gc.unfreeze()
        gc.set_threshold(*threshold)
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["roots"] = roots
    return out


def _counters(runs, switch, side):
    return json.loads((runs["roots"][switch, side] / TRACE).read_text())["counters"]


@pytest.mark.parametrize("switch", ["off", "on"])
def test_trace_counter_keys_equal_the_jax_clis(runs, switch):
    port, jax_counters = _counters(runs, switch, "port"), _counters(runs, switch, "jax")
    assert runs[switch, "port"] == runs[switch, "jax"] == 0
    assert set(port) == set(jax_counters)
    assert bool(DECL_COUNTERS & set(port)) == (switch == "on")
    if switch == "on":
        assert DECL_COUNTERS <= set(port)


def test_the_switch_changes_no_output_byte(runs):
    def tree(key):
        return {k: v for k, v in _tree_bytes(runs["roots"][key]).items()
                if not k.startswith(".semmerge-")}

    assert tree(("off", "port")) == tree(("on", "port")) == tree(("off", "jax"))
