"""ctypes bindings for the C++ declaration scanner and op-log
serializer (``semmerge_native.cpp``), and the C op factory
(``opfactory.c``).

The port of the JAX package's ``frontend/native.py``. The
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

The same library renders an op stream's canonical JSON from its columns
(:func:`try_oplog_json_bytes`, ``smn_oplog_json``), and the op factory,
a CPython extension, builds ``Op`` objects from them
(:func:`load_opfactory`); the columnar views
(:mod:`semantic_merge_tpu_torch.ops.oplog_view`) use both. The factory
is built the same way, at first use, with ``g++`` against the running
interpreter's headers (``sysconfig``). ``SEMMERGE_NATIVE=0`` selects
the views' Python serializer and op builder instead (as in the JAX
package); the scan is native whatever it says.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from typing import List, Optional, Sequence

from ..errors import NativeBuildFault, ParseFault
from ..obs import device as obs_device
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
    :class:`NativeBuildFault` when there is no ``g++`` or it fails.
    Counted in the device block's build metrics (kernel
    ``native_scanner``: a hit reuses the library, a miss builds it)."""
    out = library_path()
    if out.is_file():
        obs_device.record_build("native_scanner", False)
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
    seconds = time.perf_counter() - t0
    obs_device.record_build("native_scanner", True, seconds)
    return seconds


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
        lib.smn_oplog_json.restype = ctypes.c_void_p
        lib.smn_oplog_json.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 4,
                                       ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
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


def native_ops_enabled() -> bool:
    """Whether the op-log views use the native serializer and op factory
    (``SEMMERGE_NATIVE`` is not ``0``)."""
    return os.environ.get("SEMMERGE_NATIVE", "auto").strip().lower() != "0"


def try_oplog_json_bytes(n: int, kind, a_slot, b_slot, words,
                         base_blob: bytes, base_offs,
                         side_blob: bytes, side_offs,
                         prov_json: str) -> Optional[bytes]:
    """An op stream's canonical JSON (UTF-8 bytes) rendered from its
    columns by ``smn_oplog_json``; ``None`` under ``SEMMERGE_NATIVE=0``
    (the caller's Python serializer runs). Arrays must be C-contiguous
    int32 (columns) and int64 (table offsets). A library that cannot be
    built or loaded raises :class:`NativeBuildFault`."""
    if not native_ops_enabled():
        return None
    lib = _load()
    out_len = ctypes.c_int64(0)
    ptr = lib.smn_oplog_json(
        n, kind.ctypes.data, a_slot.ctypes.data, b_slot.ctypes.data, words.ctypes.data,
        base_blob, base_offs.ctypes.data, side_blob, side_offs.ctypes.data,
        prov_json.encode("utf-8"), ctypes.byref(out_len))
    if not ptr:
        raise ParseFault("native op-log serializer returned no result", stage="emit",
                         cause="native")
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.smn_free(ptr)


OPFACTORY_SOURCE = FRONTEND_DIR / "opfactory.c"
OPFACTORY_FLAGS = ["-O2", "-fPIC", "-shared"]
#: The extension's module name (its ``PyInit_`` symbol).
_OPFACTORY_MODULE = "semmerge_opfactory"

_opfactory = None
_opfactory_error: Optional[str] = None
_opfactory_lock = threading.Lock()


def _python_include() -> str:
    return sysconfig.get_paths()["include"]


def opfactory_path() -> pathlib.Path:
    """Where the op factory built from the current source, flags and
    interpreter lives."""
    key = b"\0".join([OPFACTORY_SOURCE.read_bytes(), " ".join(OPFACTORY_FLAGS).encode(),
                      _python_include().encode(), sys.version.encode(),
                      str(sysconfig.get_config_var("EXT_SUFFIX")).encode()])
    return BUILD_DIR / f"{_OPFACTORY_MODULE}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_opfactory() -> float:
    """Compile the op factory unless the current one exists (as
    :func:`build`: a temporary name, then a rename); returns the
    compile's seconds (0.0 when nothing was built). Raises
    :class:`NativeBuildFault` when there is no ``g++``, no
    ``Python.h``, or the compile fails. Counted as kernel
    ``opfactory`` in the build metrics."""
    out = opfactory_path()
    if out.is_file():
        obs_device.record_build("opfactory", False)
        return 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildFault("op factory: no C++ compiler (g++) on PATH",
                               stage="scan", cause="no-compiler")
    include = _python_include()
    if not (pathlib.Path(include) / "Python.h").is_file():
        raise NativeBuildFault(f"op factory: no Python.h under {include}",
                               stage="scan", cause="no-headers")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *OPFACTORY_FLAGS, f"-I{include}", "-o", str(tmp),
                               str(OPFACTORY_SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeBuildFault(f"op factory: g++ exit {proc.returncode}\n"
                                   f"{proc.stdout[-2000:]}", stage="scan", cause="build")
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise NativeBuildFault(f"op factory: build failed: {exc}", stage="scan",
                               cause=type(exc).__name__) from exc
    finally:
        tmp.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    obs_device.record_build("opfactory", True, seconds)
    return seconds


def load_opfactory():
    """The C op factory (``opfactory.c``: ``stream_ops`` and
    ``composed_ops``), built first if needed; ``None`` under
    ``SEMMERGE_NATIVE=0``. A factory that cannot be built or loaded
    raises :class:`NativeBuildFault`, now and on every later call."""
    global _opfactory, _opfactory_error
    if not native_ops_enabled():
        return None
    with _opfactory_lock:
        if _opfactory is not None:
            return _opfactory
        if _opfactory_error is not None:
            raise NativeBuildFault(_opfactory_error, stage="scan", cause="native")
        try:
            build_opfactory()
            import importlib.util
            spec = importlib.util.spec_from_file_location(_OPFACTORY_MODULE,
                                                          str(opfactory_path()))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ParseFault as exc:
            _opfactory_error = str(exc)
            raise
        except Exception as exc:  # ImportError, OSError: a library that does not load
            _opfactory_error = f"op factory: load failed: {exc}"
            raise NativeBuildFault(_opfactory_error, stage="scan", cause="load") from exc
        _opfactory = mod
        return mod
