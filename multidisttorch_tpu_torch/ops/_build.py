"""Build the port's native libraries and load them with ``ctypes``.

Each source under ``ops/csrc/`` has a plain C interface and is compiled on
its own with ``nvcc`` into a shared library for ``sm_90a`` (Hopper). Nothing
here includes PyTorch's headers, so a build takes seconds. The host C++
sources (:data:`HOST_SOURCES`: the data feed's gatherer,
``data/csrc/fastloader.cpp``) are compiled with ``g++`` and the JAX
package's ``csrc/Makefile`` flags. The libraries go to
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
source, of every header beside it that it includes, and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded (``MDT_KERNEL_BUILD_DIR`` names another directory). A library that
``compile/cache.py`` quarantines is moved out of the directory, so the
next :func:`load` rebuilds it from its source. Builds happen at first use, never at import: :func:`build_all`
starts one compiler per source, all together, and waits for them;
:func:`build` builds one source, and :func:`load` returns the loaded library.

The ``ctypes`` signatures live beside the kernels' wrappers (``ops/elbo.py``,
``ops/attention.py``):
every pointer and the stream as ``c_void_p``, and every entry returns
``cudaGetLastError()`` as an ``int``. The gatherer's live in
``data/native.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# ``MDT_KERNEL_BUILD_DIR`` moves the libraries elsewhere (the cold-start
# bench's cold child builds into an empty directory of its own).
BUILD_DIR = Path(os.environ.get("MDT_KERNEL_BUILD_DIR") or
                 Path(__file__).resolve().parents[2] / "build" / "torch_kernels")

# Kernel library name -> its source under csrc/.
SOURCES = {"elbo": "elbo.cu", "flash_attention": "flash_attention.cu"}
# Host library name -> its source, compiled with g++.
HOST_SOURCES = {"fastloader": Path(__file__).resolve().parents[1] / "data" / "csrc" / "fastloader.cpp"}

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall"]

_loaded: dict[str, ctypes.CDLL] = {}
# name -> what ptxas said about registers, shared memory and spills.
ptxas_reports: dict[str, str] = {}
# name -> the seconds its compiler ran, for every library built here.
build_seconds: dict[str, float] = {}
# One build at a time in the process: threads (the compile farm's workers)
# that need a library together must not write one private output name.
_BUILD_LOCK = threading.RLock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source at first use and need "
        "the CUDA toolkit"
    )


def find_cxx() -> str:
    """Path of ``g++`` on ``PATH``; raises if there is none."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host libraries are built from source at first use")
    return cxx


def _source(name: str) -> Path:
    return HOST_SOURCES[name] if name in HOST_SOURCES else CSRC_DIR / SOURCES[name]


def _flags(name: str) -> list[str]:
    return HOST_CXX_FLAGS if name in HOST_SOURCES else ARCH_FLAGS + NVCC_FLAGS


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(name: str) -> list[Path]:
    """The source of library ``name`` and every file beside it that it
    includes with ``#include "..."``, directly or through another."""
    seen: list[Path] = []
    todo = [_source(name)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.is_file():
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in _sources_of(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> list[Path]:
    """Build the libraries ``names`` (all of :data:`SOURCES` and
    :data:`HOST_SOURCES` by default) that are not built yet, with one
    compiler per source, all started together; returns their paths in
    order."""
    names = [*SOURCES, *HOST_SOURCES] if names is None else list(names)
    with _BUILD_LOCK:
        return _build_all(names)


def _build_all(names: list) -> list[Path]:
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        # A private output name, renamed into place: concurrent builders (two
        # ranks of one group on one host) never load a half-written library.
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        compiler = find_cxx() if name in HOST_SOURCES else find_nvcc()
        cmd = [compiler, *_flags(name), "-o", str(tmp), str(_source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, cmd, proc, t0 in jobs:
        log = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0
        if name not in HOST_SOURCES:
            ptxas_reports[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("native library build failed:\n" + "\n".join(failed))
    return [library_path(name) for name in names]


def build(name: str) -> Path:
    """Build library ``name`` unless it is built already; returns its
    path."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _BUILD_LOCK:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
