"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``ops/csrc/`` has a plain C interface and is compiled on
its own into a shared library for ``sm_90a`` (Hopper). Nothing here includes
PyTorch's headers, so a build takes seconds. The libraries go to
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
source, of every header under ``csrc/`` that it includes, and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. Builds happen at first use, never at import: :func:`build_all`
starts one ``nvcc`` per source, all together, and waits for them;
:func:`build` builds one source, and :func:`load` returns the loaded library.

The ``ctypes`` signatures live beside the kernels' wrappers (``ops/elbo.py``,
``ops/attention.py``):
every pointer and the stream as ``c_void_p``, and every entry returns
``cudaGetLastError()`` as an ``int``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Kernel library name -> its source under csrc/.
SOURCES = {"elbo": "elbo.cu", "flash_attention": "flash_attention.cu"}

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
# name -> what ptxas said about registers, shared memory and spills.
ptxas_reports: dict[str, str] = {}


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(name: str) -> list[Path]:
    """The source of library ``name`` and every file under ``csrc/`` that
    it includes with ``#include "..."``, directly or through another."""
    seen: list[Path] = []
    todo = [CSRC_DIR / SOURCES[name]]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC_DIR / inc.decode()
            if dep.is_file():
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in _sources_of(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> list[Path]:
    """Build the kernel libraries ``names`` (all of :data:`SOURCES` by
    default) that are not built yet, with one ``nvcc`` per source, all
    started together; returns their paths in order."""
    names = list(SOURCES) if names is None else list(names)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        # A private output name, renamed into place: concurrent builders (two
        # ranks of one group on one host) never load a half-written library.
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc))
    failed = []
    for name, out, tmp, cmd, proc in jobs:
        ptxas_reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)}\n{ptxas_reports[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return [library_path(name) for name in names]


def build(name: str) -> Path:
    """Build kernel library ``name`` with ``nvcc`` unless it is built
    already; returns its path."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
