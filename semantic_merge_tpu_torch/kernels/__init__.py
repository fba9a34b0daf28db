"""Hand-written CUDA kernels: build, load and count launches.

Each kernel is one ``.cu`` file in this directory with a plain C entry
point. It is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library the first time a process needs it, and loaded with ``ctypes``;
pointers and the stream are passed as integers. Libraries land in
``_build/`` beside the sources, named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time, and nothing needs a GPU until a
kernel is built.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a
wrapper adds one where it launches its kernel and nowhere else, and
notes the launch's shape in ``LAUNCH_SHAPES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Tuple

KERNEL_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Kernel name → the number of launches its wrapper made.
LAUNCHES: Dict[str, int] = {"flash_chunk": 0, "sha256": 0}

#: Kernel name → {launch shape → launches}, recorded beside the count.
LAUNCH_SHAPES: Dict[str, Dict[Tuple[int, ...], int]] = {"flash_chunk": {}, "sha256": {}}

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


def toolkit_tool(tool: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): under
    ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``), else on PATH."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = pathlib.Path(cuda_home) / "bin" / tool
    found = str(candidate) if candidate.is_file() else shutil.which(tool)
    if found is None:
        raise KernelBuildError(f"{tool} not found (set CUDA_HOME or put it on PATH)")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where kernel ``name``'s library for the current source lives."""
    source = (KERNEL_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile kernel ``name`` unless its current library exists, and
    return what ``nvcc`` printed (``ptxas -v``: registers, spills,
    shared memory), or ``""`` when nothing was built."""
    return build_all([name])[name]


def build_all(names) -> Dict[str, str]:
    """Compile every kernel of ``names`` whose current library is
    missing, one ``nvcc`` per source, all started together; returns
    ``{name: what nvcc printed}`` (``""`` where nothing was built)."""
    logs: Dict[str, str] = {}
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            logs[name] = ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [toolkit_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
             str(KERNEL_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        logs[name] = log
    if failed:
        raise KernelBuildError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
