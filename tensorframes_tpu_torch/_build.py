"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``_build/`` beside this file (listed in
``.gitignore``), or in ``<dir>/kernels/`` when the persistent compile
cache is configured (``compile_cache.py``, ``TFS_COMPILE_CACHE``), named
by a hash of its source, of every header it
includes from ``csrc/`` (``#include "..."``, followed recursively) and of
the flags, so a changed source or header rebuilds and an unchanged one
loads at once.  Builds happen at
first use — never at import — and a failed build raises with nvcc's
output.  ``build_all`` starts one ``nvcc`` per source, all at once.

The compile counters of ``observability`` count this module's work: each
``nvcc`` run is one ``backend_compiles`` and one
``persistent_cache_misses``; each library ``load`` finds already built
in ``_build/`` is one ``persistent_cache_hits``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from . import compile_cache, observability

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("flash_fwd", "flash_bwd", "flash_ring")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """Where the libraries are built and loaded from: the compile cache's
    ``kernels/`` when one is configured, else ``BUILD_DIR``."""
    cached = compile_cache.subdir("kernels")
    return Path(cached) if cached is not None else BUILD_DIR


def cuda_bin(tool: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH, else in
    ``$CUDA_HOME/bin`` (``/usr/local/cuda`` by default)."""
    found = shutil.which(tool)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / tool
    if not path.exists():
        raise RuntimeError(
            f"{tool} not found (looked on PATH and in $CUDA_HOME/bin); the "
            f"port's CUDA kernels are built from source on the machine with "
            f"the card"
        )
    return str(path)


_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every local header it includes, directly or
    through another header, sorted by path."""
    found: List[Path] = []
    todo = [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            dep = path.parent / inc
            if dep.exists():
                todo.append(dep)
    return sorted(found)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    so = library_path(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cuda_bin("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    observability.note_backend_compile()
    observability.note_persistent_cache(hit=False)
    proc.tmp, proc.so = tmp, so
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if proc.tmp.exists():
            proc.tmp.unlink()
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    proc.so.with_suffix(".log").write_text(log)
    os.replace(proc.tmp, proc.so)  # atomic: a reader never sees half a file


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build every named source that is not built yet, in parallel."""
    names = list(names)
    procs = {n: _start(n) for n in names}
    try:
        for n, p in procs.items():
            if p is not None:
                _finish(n, p)
    finally:
        for p in procs.values():
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) of the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if library_path(name).exists():
            observability.note_persistent_cache(hit=True)
        so = build_all([name])[name]
        lib = _loaded[name] = ctypes.CDLL(str(so))
    return lib


def cuda_error_string(lib: ctypes.CDLL, code: int) -> str:
    """cudaGetErrorString, through a kernel library's C interface (each
    exports ``tfs_cuda_error_string``)."""
    fn = lib.tfs_cuda_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    return fn(code).decode()
