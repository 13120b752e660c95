"""The kernel-library quarantine: a built library is trusted per run.

Counterpart of ``multidisttorch_tpu/compile/cache.py``. The JAX package's
persistent artifact is XLA's executable cache; the port's is the set of
libraries ``ops/_build.py`` builds into ``build/torch_kernels/`` (named by
``library_path``: a hash of the source, its headers and the flags) and
loads with ``ctypes``. A library that a crash tore, that rotted on disk, or
that came from nobody knows where would be loaded without a question:
``load`` checks the name, not the bytes. This module puts the JAX
package's two mechanical defences in front of it:

1. **CRC32 sidecars** (:func:`seal_cache`, :func:`scan_cache`), in the
   JAX package's plain-JSON format (``{"crc32": ..., "nbytes": ...}`` in
   ``<library>.mdtcrc``): sealing records each library's CRC32 and length;
   the scan checks each library against its sidecar and moves a torn
   (``size_mismatch``), corrupt (``crc_mismatch``), unsealed or
   unreadable one into ``quarantine/``.
2. **A subprocess canary** (:func:`canary_quarantine`): before the trial
   process loads a library, a child process that may crash loads it and
   holds its kernels against their plain versions (the ELBO pair and its
   lanes pair, the flash forward, the gatherer against numpy's indexing).
   A crash, a hang or a disagreement quarantines the library.

A quarantined library is gone from the build directory, so the next
``ops/_build.py::load`` **rebuilds it from its source**; nothing falls back
to a plain version of a kernel. The JAX package's third layer, the XLA:CPU
policy gate that keeps deserialized CPU executables out of the trial
process even after a passed canary, has no counterpart: the port's
libraries are native code built on this machine, and a library that
passed its canary is what the next ``load`` would build anyway.
:func:`enable_quarantined_cache` runs scan and canary and points the
builder at the directory; :func:`cache_probe` reports without moving
anything.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Callable, Optional

from multidisttorch_tpu_torch.telemetry.events import get_bus

SIDECAR_SUFFIX = ".mdtcrc"
QUARANTINE_DIR = "quarantine"

# How an enable attempt resolved (the JAX package's names; its
# ``quarantined_only`` CPU gate has no counterpart).
ENABLED = "enabled"
CANARY_MISMATCH = "canary_mismatch"
CANARY_CRASHED = "canary_crashed"
CANARY_TIMEOUT = "canary_timeout"
SCAN_ONLY = "scan_only"

CANARY_TIMEOUT_S = int(os.environ.get("MDT_CACHE_CANARY_TIMEOUT_S", "120"))

_LIBRARY = re.compile(r"^lib(?P<name>[a-z_]+)_[0-9a-f]{16}\.so$")
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def _emit(kind: str, **data) -> None:
    bus = get_bus()
    if bus is not None:
        bus.emit(kind, **data)


def default_cache_dir() -> str:
    """The builder's directory (``ops/_build.py::BUILD_DIR``)."""
    from multidisttorch_tpu_torch.ops import _build

    return str(_build.BUILD_DIR)


def library_name(entry: str) -> Optional[str]:
    """The library an entry's file name holds (``libelbo_<hash>.so`` ->
    ``elbo``), or None for another file."""
    m = _LIBRARY.match(entry)
    return m.group("name") if m else None


# -- sidecars -----------------------------------------------------------------


def _is_entry(name: str) -> bool:
    """Files the quarantine seals: all but sidecars and a builder's private
    ``.tmp`` output (renamed into place when the build ends)."""
    return not name.endswith(SIDECAR_SUFFIX) and not name.endswith(".tmp")


def _entries(cache_dir: str) -> list[str]:
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return []
    return sorted(n for n in names if _is_entry(n) and os.path.isfile(os.path.join(cache_dir, n)))


def _crc_file(path: str) -> tuple[int, int]:
    """CRC32 and length of a file, read in chunks."""
    crc = n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return crc, n


def seal_cache(cache_dir: str, *, only: Optional[set] = None) -> dict:
    """Write or refresh the sidecar of every entry (of ``only``, given): run
    it after the builder wrote the libraries, since only sealed entries
    pass the next :func:`scan_cache`."""
    sealed = refreshed = 0
    for name in _entries(cache_dir):
        if only is not None and name not in only:
            continue
        path = os.path.join(cache_dir, name)
        try:
            crc, n = _crc_file(path)
            rec = {"crc32": crc, "nbytes": n}
            side = path + SIDECAR_SUFFIX
            prev = None
            if os.path.exists(side):
                try:
                    with open(side) as f:
                        prev = json.load(f)
                except (OSError, json.JSONDecodeError):
                    prev = None
            if prev == rec:
                continue
            tmp = side + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, side)
            if prev is None:
                sealed += 1
            else:
                refreshed += 1
        except OSError:
            continue
    return {"entries": len(_entries(cache_dir)), "sealed": sealed, "refreshed": refreshed}


def _quarantine(cache_dir: str, name: str) -> None:
    qdir = os.path.join(cache_dir, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    src = os.path.join(cache_dir, name)
    shutil.move(src, os.path.join(qdir, name))
    side = src + SIDECAR_SUFFIX
    if os.path.exists(side):
        shutil.move(side, os.path.join(qdir, name + SIDECAR_SUFFIX))


def scan_cache(cache_dir: str, *, quarantine: bool = True) -> dict:
    """Check every entry against its sidecar and move the failures aside:
    ``unsealed`` (no sidecar), ``sidecar_unreadable``, ``unreadable``,
    ``size_mismatch`` (a torn write) or ``crc_mismatch`` (corruption).
    The builder sees a moved library as not built, and builds it."""
    checked = ok = 0
    rejected: list[dict] = []
    for name in _entries(cache_dir):
        path = os.path.join(cache_dir, name)
        checked += 1
        reason = None
        side = path + SIDECAR_SUFFIX
        if not os.path.exists(side):
            reason = "unsealed"
        else:
            try:
                with open(side) as f:
                    rec = json.load(f)
                want_crc, want_n = int(rec["crc32"]), int(rec["nbytes"])
            except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError):
                reason = "sidecar_unreadable"
            if reason is None:
                try:
                    crc, n = _crc_file(path)
                except OSError:
                    reason = "unreadable"
                if reason is None:
                    if n != want_n:
                        reason = "size_mismatch"
                    elif crc != want_crc:
                        reason = "crc_mismatch"
        if reason is None:
            ok += 1
            continue
        rejected.append({"entry": name, "reason": reason})
        if quarantine:
            try:
                _quarantine(cache_dir, name)
            except OSError:
                pass
    report = {"checked": checked, "ok": ok, "rejected": rejected,
              "quarantined": len(rejected) if quarantine else 0}
    _emit("cache_scan", dir=cache_dir, checked=checked, ok=ok, quarantined=report["quarantined"])
    return report


# -- the canary -----------------------------------------------------------------


def _check_library(name: str) -> dict:
    """In the canary child, with library ``name`` already loaded: its
    kernels against their plain versions on small inputs. Returns
    ``{"match": bool, "max_err": float}``; the tolerances are a canary's
    (a wrong or garbled kernel, not the last bits)."""
    import numpy as np
    import torch

    if name == "fastloader":
        from multidisttorch_tpu_torch.data.native import NativeBatchGatherer

        rng = np.random.default_rng(0)
        images = rng.random((97, 13), dtype=np.float32)
        perm = rng.permutation(97)
        g = NativeBatchGatherer(images)
        g.start_epoch(perm, 16)
        got, _ = g.next_batch()
        g.close()
        err = float(np.abs(got - images[perm[:16]]).max())
        return {"match": err == 0.0, "max_err": err}
    if not torch.cuda.is_available():
        raise RuntimeError(f"the {name} canary needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    errs = []
    if name == "elbo":
        from multidisttorch_tpu_torch.ops import elbo

        for lanes in (None, 2):
            lead = () if lanes is None else (lanes,)
            logits, mu, logvar = rand(*lead, 64, 784), rand(*lead, 64, 20), rand(*lead, 64, 20, scale=0.1)
            x = torch.rand(*lead, 64, 784, generator=gen).to(dev)
            if lanes is None:
                pairs = [(elbo.elbo_fwd_cuda(logits, x, mu, logvar, 2.0), elbo.elbo_fwd_plain(logits, x, mu, logvar, 2.0))]
                g = torch.ones((), device=dev)
                got = elbo.elbo_bwd_cuda(logits, x, mu, logvar, 2.0, g)
                ref = elbo.elbo_bwd_plain(logits, x, mu, logvar, 2.0, g)
            else:
                beta = torch.tensor([1.0, 3.0], device=dev)
                pairs = [(elbo.elbo_fwd_lanes_cuda(logits, x, mu, logvar, beta),
                          elbo.elbo_fwd_lanes_plain(logits, x, mu, logvar, beta))]
                g = torch.ones(2, device=dev)
                got = elbo.elbo_bwd_lanes_cuda(logits, x, mu, logvar, beta, g)
                ref = elbo.elbo_bwd_lanes_plain(logits, x, mu, logvar, beta, g)
            pairs += list(zip(got, ref))
            for a, b in pairs:
                errs.append(float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-30)))
    elif name == "flash_attention":
        from multidisttorch_tpu_torch.ops import attention

        q, k, v = (rand(2, 128, 64).to(torch.bfloat16) for _ in range(3))
        for force in (False, True):
            o, lse = attention.flash_fwd_cuda(q, k, v, 0.125, True, _force_simt=force)
            ro, rlse = attention.flash_fwd_plain(q, k, v, 0.125, True)
            errs.append(float((o.float() - ro.float()).abs().max()))
            errs.append(float((lse - rlse).abs().max()))
    else:
        raise ValueError(f"no canary for library {name!r}")
    torch.cuda.synchronize()
    err = max(errs)
    return {"match": err <= 2e-2, "max_err": err}


def _canary_child_main(argv: list[str]) -> int:
    """``python -c ... <library path> <name>``: load the library as the
    builder would have, check it, print one ``CANARY|{...}`` line."""
    import ctypes

    path, name = argv
    from multidisttorch_tpu_torch.ops import _build

    _build._loaded[name] = ctypes.CDLL(path)
    rec = _check_library(name)
    print("CANARY|" + json.dumps(rec))
    return 0


_CANARY_CODE = ("import sys; from multidisttorch_tpu_torch.compile.cache import _canary_child_main; "
                "sys.exit(_canary_child_main(sys.argv[1:]))")


def _run_canary_child(path: str, name: str, timeout_s: float) -> dict:
    """One bounded child that may crash: load ``path`` and check it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_PACKAGE_ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, "-c", _CANARY_CODE, path, name], capture_output=True, text=True,
                           timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return {"ok": False, "timeout": True, "error": f"canary child for {name} blocked past {timeout_s}s",
                "elapsed_s": round(time.perf_counter() - t0, 2)}
    rec = None
    for line in p.stdout.splitlines():
        if line.startswith("CANARY|"):
            rec = json.loads(line[len("CANARY|"):])
    if p.returncode != 0 or rec is None:
        return {"ok": False, "timeout": False, "rc": p.returncode,
                "error": f"canary child for {name} died rc={p.returncode}", "stderr_tail": p.stderr[-400:],
                "elapsed_s": round(time.perf_counter() - t0, 2)}
    return {"ok": True, "match": bool(rec["match"]), "max_err": rec["max_err"],
            "elapsed_s": round(time.perf_counter() - t0, 2)}


def canary_quarantine(cache_dir: str, *, timeout_s: float = CANARY_TIMEOUT_S, runner: Optional[Callable] = None,
                      evict_on_failure: bool = True) -> dict:
    """One canary child per library in ``cache_dir``, all started together:
    ``{"passed": bool,
    "verdict": "passed" or the first failure's kind, "libraries": {entry:
    record}, "evicted": n}``. A library whose child crashed, hung or
    disagreed is quarantined (``evict_on_failure``). ``runner(path, name,
    timeout_s)`` replaces the child in tests."""
    from concurrent.futures import ThreadPoolExecutor

    run = runner or _run_canary_child
    out: dict = {"passed": True, "verdict": "passed", "libraries": {}, "evicted": 0}
    libs = [(entry, library_name(entry)) for entry in _entries(cache_dir) if library_name(entry) is not None]
    # The children start together: each pays its interpreter's start alone.
    with ThreadPoolExecutor(max(1, len(libs))) as pool:
        recs = list(pool.map(lambda lib: run(os.path.join(cache_dir, lib[0]), lib[1], timeout_s), libs))
    for (entry, _), rec in zip(libs, recs):
        out["libraries"][entry] = rec
        if rec.get("ok") and rec.get("match"):
            continue
        verdict = (CANARY_TIMEOUT if rec.get("timeout") else CANARY_CRASHED) if not rec.get("ok") else CANARY_MISMATCH
        if out["passed"]:
            out["passed"], out["verdict"] = False, verdict
        if evict_on_failure:
            try:
                _quarantine(cache_dir, entry)
                out["evicted"] += 1
            except OSError:
                pass
    return out


# -- the safe opt-in ----------------------------------------------------------------


def cache_probe(cache_dir: Optional[str] = None, *, canary: bool = True, timeout_s: float = CANARY_TIMEOUT_S,
                runner: Optional[Callable] = None) -> dict:
    """The scan's report and (optionally) the canary's, moving nothing."""
    cache_dir = cache_dir or default_cache_dir()
    out: dict = {"cache_dir": cache_dir, "scan": scan_cache(cache_dir, quarantine=False)}
    if canary:
        out["canary"] = canary_quarantine(cache_dir, timeout_s=timeout_s, runner=runner, evict_on_failure=False)
        out["usable"] = bool(out["canary"]["passed"])
    else:
        out["canary"] = None
        out["usable"] = False
    return out


def enable_quarantined_cache(cache_dir: Optional[str] = None, *, scan: bool = True, canary: bool = True,
                             timeout_s: float = CANARY_TIMEOUT_S, runner: Optional[Callable] = None) -> dict:
    """Scan, canary, then point the builder at ``cache_dir``: the
    libraries left there are loaded as they are, and any that the scan or
    the canary quarantined is rebuilt from its source at its first use.
    The verdict is ``enabled`` after a passed canary, else the canary's
    failure (the builder is pointed at the directory all the same: what is
    left in it passed), or ``scan_only`` without a canary."""
    from multidisttorch_tpu_torch.ops import _build

    cache_dir = cache_dir or default_cache_dir()
    out: dict = {"cache_dir": cache_dir, "enabled": False}
    if scan:
        out["scan"] = scan_cache(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_DIR = Path(cache_dir)
    if not canary:
        out["verdict"] = SCAN_ONLY
        _emit("cache_quarantined", dir=cache_dir, reason=SCAN_ONLY)
        return out
    can = canary_quarantine(cache_dir, timeout_s=timeout_s, runner=runner)
    out["canary"] = can
    _emit("cache_canary", dir=cache_dir, verdict=can["verdict"], passed=can["passed"], evicted=can["evicted"])
    if not can["passed"]:
        out["verdict"] = can["verdict"]
        _emit("cache_quarantined", dir=cache_dir, reason=can["verdict"])
        return out
    out["enabled"] = True
    out["verdict"] = ENABLED
    _emit("cache_enabled", dir=cache_dir)
    return out
