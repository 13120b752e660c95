"""The process-lifetime program registry: one capture per program.

Counterpart of ``multidisttorch_tpu/compile/registry.py``'s
``ExecutableRegistry``, with the JAX package's names, states and events.
An entry holds a **program slot** (``compile/programs.py``) in place of
an executable: the state, generators and captured graphs of one key. Every
slot is built through :meth:`ExecutableRegistry.compile_now`: timed,
emitted as ``compile_start`` / ``compile_end``, and coalesced (a second
caller waits on the entry's condition for the first). A farm's build
captures there too, on scratch state; an inline build's first trial warms
up and captures at its first chunk, as a per-trial step does, and the
graphs stay in the slot. The next admission with the same
key (a seed replica, a retry, the next item on that group, a refilled
stacked bucket) takes the slot (:meth:`take`, a ``cache_hit``) and replays
its graphs.

A slot serves one trial at a time: :meth:`take` hands it to an owner and
:meth:`give_back` returns it, at the trial's end and on every failure
path. An owner may take its own slot again (the fused PBT run books a
``cache_hit`` per generation that way); another owner finds it busy and
gets None.

Ownership between the farm and the driver is the JAX package's: a farm
job starts ``PENDING``; a worker moves it to ``COMPILING`` ("warming up
and capturing" here); the driver's admission takes a ``READY`` slot,
waits cooperatively on a ``COMPILING`` one, or ``claim()``s a still
``PENDING`` job and captures inline. ``FAILED`` is terminal and sticky:
an admission that finds its key ``FAILED`` builds the trial's own
per-trial graphs (the path a ``model_builder`` family takes), which
capture inline and raise if the capture fails. Nothing falls back to an
eager loop or to a plain version of a kernel.

The books: the capture's warm-up and capture seconds go to the metrics
registry through ``telemetry.metrics.record_capture`` under the slot's
label (``compile_count`` / ``compile_seconds``, one book for the registry
and for per-trial graphs), and the registry adds the JAX registry's
counters for the rest (``compiles{source=}``, ``compile_cache_hits``,
``compile_coalesced``, ``compile_failures``,
``compile_registry_evictions``).

Size bound: at most ``MDT_REGISTRY_MAX_PROGRAMS`` (default 512) entries;
beyond it the least recently used terminal entries that no trial holds
are dropped, and an evicted slot frees its graphs and their pools.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Optional

from multidisttorch_tpu_torch.compile.programs import program_label
from multidisttorch_tpu_torch.telemetry.events import get_bus
from multidisttorch_tpu_torch.telemetry.metrics import get_registry as _metrics

PENDING = "pending"
COMPILING = "compiling"
READY = "ready"
FAILED = "failed"
CLAIMED = "claimed"

# How the slot came to exist: the ``source`` of compile events.
SOURCE_PRECOMPILE = "precompile"
SOURCE_INLINE = "inline"


def _max_programs() -> int:
    return int(os.environ.get("MDT_REGISTRY_MAX_PROGRAMS", "512"))


class Entry:
    """One program's lifecycle record; changed under the registry's lock."""

    __slots__ = ("key", "label", "status", "source", "compiled", "avals", "compile_s", "error", "cond", "hits",
                 "seq", "owner")

    def __init__(self, key: tuple, lock: threading.RLock):
        self.key = key
        self.label = program_label(key)
        self.status = PENDING
        self.source: Optional[str] = None
        self.compiled = None  # the slot
        self.avals = None  # the slot's state signature
        self.compile_s: Optional[float] = None
        self.error: Optional[str] = None
        self.cond = threading.Condition(lock)
        self.hits = 0
        self.seq = 0
        self.owner: Any = None  # who holds the slot now


def _emit(kind: str, **data) -> None:
    bus = get_bus()
    if bus is not None:
        bus.emit(kind, **data)


def _count(name: str, by: float = 1.0, **labels) -> None:
    reg = _metrics()
    if reg is not None:
        reg.counter(name, **labels).inc(by)


def _free(slot) -> None:
    free = getattr(slot, "free", None)
    if free is not None:
        free()


class ExecutableRegistry:
    """The process-wide program key -> slot table."""

    def __init__(self, max_programs: Optional[int] = None):
        self._lock = threading.RLock()
        self._entries: dict[tuple, Entry] = {}
        self._seq = 0
        self.max_programs = _max_programs() if max_programs is None else max_programs
        self.evicted = 0

    # -- bookkeeping --------------------------------------------------

    def _touch(self, e: Entry) -> None:
        self._seq += 1
        e.seq = self._seq

    def _entry(self, key: tuple) -> Entry:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = Entry(key, self._lock)
            self._touch(e)
            self._maybe_evict()
        return e

    def _maybe_evict(self) -> None:
        # Under the lock. Only terminal entries that no trial holds go:
        # pending, claimed and capturing entries carry the farm's or the
        # driver's ownership (and waiters).
        if self.max_programs <= 0 or len(self._entries) <= self.max_programs:
            return
        victims = sorted((e for e in self._entries.values() if e.status in (READY, FAILED) and e.owner is None),
                         key=lambda e: e.seq)
        for e in victims:
            if len(self._entries) <= self.max_programs:
                break
            del self._entries[e.key]
            _free(e.compiled)
            e.compiled = None
            self.evicted += 1
            _count("compile_registry_evictions")

    def status(self, key: tuple) -> Optional[str]:
        with self._lock:
            e = self._entries.get(key)
            return e.status if e is not None else None

    def entry(self, key: tuple) -> Optional[Entry]:
        with self._lock:
            return self._entries.get(key)

    def schedule(self, key: tuple) -> bool:
        """A farm job: the entry, ``PENDING``. False when the key has an
        entry already (the farm submits each program once)."""
        with self._lock:
            if key in self._entries:
                return False
            self._entry(key)
            return True

    def release(self, key: tuple) -> bool:
        """Drop a still ``PENDING`` entry (a farm shutdown returning its
        queued jobs): the next admission claims and captures it inline."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.status == PENDING:
                del self._entries[key]
                return True
            return False

    def claim(self, key: tuple) -> bool:
        """The driver takes a queued job (or a program the farm never saw):
        True means the caller captures inline; a farm worker skips a
        ``CLAIMED`` entry."""
        with self._lock:
            e = self._entry(key)
            if e.status == PENDING:
                e.status = CLAIMED
                return True
            return e.status == CLAIMED

    def fail(self, key: tuple, error: str) -> None:
        """Mark a program ``FAILED`` for good (a builder that cannot even
        make the slot): waiters stop waiting, and every admission of the
        key takes the per-trial path."""
        with self._lock:
            e = self._entry(key)
            if e.status == READY:
                return
            e.status = FAILED
            e.error = error
            e.cond.notify_all()

    def begin(self, key: tuple, *, source: str) -> Optional[Entry]:
        """Move an entry to ``COMPILING`` (from pending, claimed or new);
        None when another caller owns it or it is terminal."""
        with self._lock:
            e = self._entry(key)
            if e.status in (READY, FAILED, COMPILING):
                return None
            e.status = COMPILING
            e.source = source
            return e

    def take(self, key: tuple, owner: Any = None) -> Optional[Any]:
        """A ``READY`` program's slot for ``owner``, else None; None too
        while another owner holds it. Counts the hit and emits
        ``cache_hit``."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.status != READY:
                return None
            if e.owner is not None and e.owner is not owner:
                return None
            e.owner = owner
            e.hits += 1
            self._touch(e)
            label, source, slot = e.label, e.source, e.compiled
        _emit("cache_hit", program=label, source=source)
        _count("compile_cache_hits", program=label)
        return slot

    def give_back(self, key: tuple, owner: Any = None) -> bool:
        """``owner`` is done with its slot (a trial's end or failure): the
        next admission of the key may take it. False when ``owner`` did
        not hold it."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.owner is None or e.owner is not owner:
                return False
            e.owner = None
            self._touch(e)
            self._maybe_evict()
            return True

    def avals(self, key: tuple):
        with self._lock:
            e = self._entries.get(key)
            return e.avals if e is not None else None

    # -- the one capture routine ----------------------------------------

    def compile_now(self, key: tuple, build: Callable[[], Any], *, source: str = SOURCE_INLINE,
                    owner: Any = None, wait_s: float = 600.0) -> Entry:
        """Build the key's slot, ``build()`` (its warm-up and capture
        included), unless it exists. One caller builds a key; a second
        waits on the entry's condition (at most ``wait_s``) and gets the
        same entry. Given an ``owner``, the slot the call built is that
        owner's (no hit is booked: it paid the capture). A failure is
        recorded ``FAILED`` with its text; the entry comes back either way:
        callers read ``status``."""
        with self._lock:
            e = self._entry(key)
            if e.status in (READY, FAILED):
                return e
            if e.status == COMPILING:
                _emit("precompile_coalesced", program=e.label)
                _count("compile_coalesced")
                deadline = time.monotonic() + wait_s
                while e.status == COMPILING:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    e.cond.wait(timeout=min(remaining, 1.0))
                return e
            e.status = COMPILING
            e.source = source
        _emit("compile_start", program=e.label, program_kind=key[0], source=source)
        t0 = time.perf_counter()
        slot = None
        error = None
        try:
            try:
                slot = build()
            except Exception as ex:  # noqa: BLE001 — recorded FAILED; the
                # admission takes the per-trial path, which raises on its own
                error = f"{type(ex).__name__}: {ex}"
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                e.compile_s = dt
                if slot is not None:
                    e.compiled = slot
                    signature = getattr(slot, "signature", None)
                    e.avals = signature() if signature is not None else None
                    e.status = READY
                    e.owner = owner
                else:
                    e.error = error or "capture interrupted"
                    e.status = FAILED
                self._touch(e)
                e.cond.notify_all()
        _emit("compile_end", program=e.label, program_kind=key[0], source=source, compile_s=round(dt, 4),
              ok=slot is not None, **({"error": error[:300]} if error else {}))
        _count("compiles", source=source)
        _count("compile_seconds_total", dt)
        if error:
            _count("compile_failures")
        return e

    def snapshot(self) -> dict:
        """Per program: status, source, seconds, hits, error and whether a
        trial holds it now."""
        with self._lock:
            return {
                e.label: {"status": e.status, "source": e.source, "compile_s": e.compile_s, "hits": e.hits,
                          "error": e.error, "held": e.owner is not None}
                for e in self._entries.values()
            }

    def reset(self) -> None:
        """Drop every entry and free every slot's graphs and pools (tests,
        and between sweeps: no trial may hold a slot then)."""
        with self._lock:
            entries, self._entries = self._entries, {}
        for e in entries.values():
            _free(e.compiled)
            e.compiled = None


_registry = ExecutableRegistry()


def get_executable_registry() -> ExecutableRegistry:
    """The process's registry. Always there: it emits only while telemetry
    is on, and costs a dict lookup otherwise."""
    return _registry
