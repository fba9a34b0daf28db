"""ctypes bindings for the C++ declaration scanner (``semmerge_native.cpp``).

The scanner half of the JAX package's ``frontend/native.py``. The
library tokenizes and indexes a snapshot in C++ and returns the same
``DeclNode`` lists as the Python scanner
(:func:`semantic_merge_tpu_torch.frontend.scanner.scan_snapshot_py`, the
semantic oracle) on ASCII sources. It *refuses* a snapshot that is not
ASCII (or holds a NUL): the Python scanner counts offsets in code
points, the C++ one in bytes, so such a snapshot is the Python
scanner's, by the reference's own semantics. That refusal is the only
way a scan reaches the Python scanner from here.

The source sits beside this module, so the port stands alone. It is
compiled with ``g++`` the first time a process needs it
(:data:`CXX_FLAGS`, as the JAX package's ``native/Makefile`` builds
it) into ``_build/``, named by a hash of the source and the flags; the
compiler writes a temporary name that is then renamed, so processes
that build at once never load a half-written library. A library that
cannot be built or loaded, or whose ABI differs, raises
:class:`~semantic_merge_tpu_torch.errors.NativeBuildFault` (a
``ParseFault``, exit 10, that the CLI never degrades): the scan never
falls back to Python because the library is missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Sequence

from ..errors import NativeBuildFault, ParseFault
from .scanner import DeclNode

FRONTEND_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = FRONTEND_DIR / "semmerge_native.cpp"
BUILD_DIR = FRONTEND_DIR / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-pthread", "-shared"]
_ABI_VERSION = 4

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_lock = threading.Lock()


def library_path() -> pathlib.Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"libsemmerge_native-{digest}.so"


def build() -> float:
    """Compile the library unless the current one exists; returns the
    seconds the compile took (0.0 when nothing was built). Raises
    :class:`NativeBuildFault` when there is no ``g++`` or it fails."""
    out = library_path()
    if out.is_file():
        return 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildFault("native scanner: no C++ compiler (g++) on PATH",
                               stage="scan", cause="no-compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeBuildFault(f"native scanner: g++ exit {proc.returncode}\n"
                                   f"{proc.stdout[-2000:]}", stage="scan", cause="build")
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise NativeBuildFault(f"native scanner: build failed: {exc}", stage="scan",
                               cause=type(exc).__name__) from exc
    finally:
        tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; a failure raises
    :class:`NativeBuildFault`, now and on every later call."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeBuildFault(_error, stage="scan", cause="native")
        try:
            build()
            lib = ctypes.CDLL(str(library_path()))
            lib.smn_abi_version.restype = ctypes.c_int
            if lib.smn_abi_version() != _ABI_VERSION:
                raise NativeBuildFault(f"native scanner ABI {lib.smn_abi_version()} != "
                                       f"expected {_ABI_VERSION}", stage="scan", cause="abi")
        except ParseFault as exc:
            _error = str(exc)
            raise
        except OSError as exc:
            _error = f"native scanner: load failed: {exc}"
            raise NativeBuildFault(_error, stage="scan", cause="load") from exc
        for fn in (lib.smn_scan_snapshot, lib.smn_scan_with_names):
            fn.restype = ctypes.c_void_p
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                           ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
        lib.smn_type_names.restype = ctypes.c_void_p
        lib.smn_type_names.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
        lib.smn_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads in this process."""
    try:
        _load()
    except ParseFault:
        return False
    return True


def _ascii_arrays(files: Sequence[dict]):
    """Marshal a snapshot into ctypes arrays, or ``None`` when the
    content is not ASCII/NUL-safe (code-point vs byte offsets would
    diverge; ``c_char_p`` is NUL-terminated so C would see a prefix)."""
    paths: List[bytes] = []
    contents: List[bytes] = []
    for f in files:
        content = f["content"]
        if not content.isascii() or not f["path"].isascii():
            return None
        if "\x00" in content or "\x00" in f["path"]:
            return None
        paths.append(f["path"].encode("ascii"))
        contents.append(content.encode("ascii"))
    n = len(files)
    return (ctypes.c_char_p * n)(*paths), (ctypes.c_char_p * n)(*contents), n


def _call(lib, fn, *args):
    """The library's JSON answer, freed after reading."""
    ptr = fn(*args)
    if not ptr:
        raise ParseFault("native scanner returned no result", stage="scan",
                         cause="native")
    try:
        return json.loads(ctypes.string_at(ptr))
    finally:
        lib.smn_free(ptr)


def _nodes(records) -> List[DeclNode]:
    return [DeclNode(symbolId=r["symbolId"], addressId=r["addressId"], kind=r["kind"],
                     name=r["name"], file=r["file"], pos=r["pos"], end=r["end"],
                     signature=r["signature"])
            for r in records]


def try_type_names(files: Sequence[dict]) -> Optional[List[frozenset]]:
    """Per-file declared type names (pass 1 of the scan); ``None`` when
    the snapshot is not ASCII-safe."""
    lib = _load()
    arrays = _ascii_arrays(files)
    if arrays is None:
        return None
    _, content_arr, n = arrays
    return [frozenset(names) for names in _call(lib, lib.smn_type_names, content_arr, n)]


def try_scan_with_names(files: Sequence[dict]):
    """One pass returning ``(per_file_name_sets, nodes)``, the cold path
    of the cached scan; ``None`` when the snapshot is not ASCII-safe."""
    lib = _load()
    arrays = _ascii_arrays(files)
    if arrays is None:
        return None
    payload = _call(lib, lib.smn_scan_with_names, *arrays)
    return [frozenset(ns) for ns in payload["names"]], _nodes(payload["nodes"])


def try_scan_snapshot(files: Sequence[dict]) -> Optional[List[DeclNode]]:
    """The snapshot's decl nodes; ``None`` when it is not ASCII-safe."""
    lib = _load()
    arrays = _ascii_arrays(files)
    if arrays is None:
        return None
    return _nodes(_call(lib, lib.smn_scan_snapshot, *arrays))
