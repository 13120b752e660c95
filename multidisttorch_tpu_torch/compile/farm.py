"""The precapture farm: a sweep's programs are captured off the host loop.

Counterpart of ``multidisttorch_tpu/compile/farm.py``'s
``PrecompilePool``. At ``run_hpo`` entry the driver knows every pending
config, so it knows every program the sweep will capture (the shape
bucket, the baked hypers and the group: ``compile/programs.py``). The farm
walks that plan once, predicting item *j*'s group as
``groups[j % len(groups)]`` (the driver's first pop order; a wrong guess
is a registry miss and an inline capture), and builds each program's slot
on worker threads through the registry's one capture routine: the slot's
state, its warm-up on scratch copies and its capture, on the slot's own
stream under ``capture_error_mode="thread_local"``, while the card runs
the graphs the driver's thread replays. A worker's warm-up and capture
hold the device gate (``train/steps.py::device_gate``), and the driver's
thread holds it for each turn of its host loop (``device_turn``): they
take turns on the host, and the card runs both; the slot's state and the
kernels' build are made outside it.

Admission then never captures on the host loop when the farm is on: a
trial whose program is still being captured waits cooperatively (other
groups keep stepping); one whose program the farm has not started
``claim()``s it and captures inline, as without the farm.

``shutdown()`` stops the workers between jobs and releases the queued
jobs' entries, so no admission waits for a worker that will not come; a
capture in flight finishes into the registry on its daemon thread.
``run_hpo`` shuts the farm down on every exit path.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from multidisttorch_tpu_torch.compile import programs as _programs
from multidisttorch_tpu_torch.compile.registry import (
    PENDING,
    SOURCE_PRECOMPILE,
    ExecutableRegistry,
    get_executable_registry,
)
from multidisttorch_tpu_torch.telemetry.events import get_bus
from multidisttorch_tpu_torch.telemetry.metrics import get_registry as _metrics


def default_workers() -> int:
    """``MDT_PRECOMPILE_WORKERS``, else one fewer than the CPUs, at most 4."""
    env = os.environ.get("MDT_PRECOMPILE_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, min(4, (os.cpu_count() or 2) - 1))


def _emit(kind: str, **data) -> None:
    bus = get_bus()
    if bus is not None:
        bus.emit(kind, **data)


class PrecompilePool:
    """Worker threads draining a deque of ``(key, builder)`` jobs into the
    registry; ``builder()`` returns the key's slot, captured."""

    def __init__(self, registry: Optional[ExecutableRegistry] = None, workers: Optional[int] = None):
        self.registry = registry or get_executable_registry()
        self.workers = workers or default_workers()
        self._jobs: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._threads: list[threading.Thread] = []
        self._shutdown = False
        self._in_flight = 0
        self.submitted = 0

    # -- job intake ---------------------------------------------------

    def submit(self, key: tuple, builder: Callable[[], object]) -> bool:
        """Queue one program, deduplicated on its registry entry (a key
        already scheduled, ready or claimed is skipped)."""
        if not self.registry.schedule(key):
            return False
        with self._lock:
            if self._shutdown:
                # The entry just made would otherwise stay PENDING and stall
                # an admission of this key for the whole wait.
                self.registry.release(key)
                return False
            self._jobs.append((key, builder))
            self.submitted += 1
            self._wake.notify()
            self._ensure_workers()
        _emit("precompile_scheduled", program=_programs.program_label(key), program_kind=key[0])
        return True

    def plan_sweep(self, items: Sequence[tuple], groups: Sequence, *, max_lanes: int = 8) -> int:
        """Submit the sweep's programs from the driver's work items
        (``("single"|"bucket", [(i, cfg), ...])``), item *j* on
        ``groups[j % len(groups)]``: each item's primary program, the chunk
        its first dispatch runs (the epoch's shorter tail is captured by
        the first trial that reaches it and stays in the slot)."""
        if not groups:
            return 0
        n = 0
        for j, (kind, members) in enumerate(items):
            g = groups[j % len(groups)]
            cfg = members[0][1]
            bucket = _programs.bucket_key_of(cfg)
            if kind == "bucket":
                lanes = min(len(members), max_lanes)
                key = _programs.stacked_key(g, cfg, bucket, lanes)
                builder = (lambda g=g, cfg=cfg, lanes=lanes, key=key:
                           _programs.build_stacked_slot(g, cfg, lanes, key))
            else:
                key = _programs.single_key(g, cfg, bucket)
                builder = lambda g=g, cfg=cfg, key=key: _programs.build_single_slot(g, cfg, key)  # noqa: E731
            if self.submit(key, builder):
                n += 1
        _emit("precompile_plan", jobs=n, items=len(items))
        reg = _metrics()
        if reg is not None:
            reg.counter("precompile_jobs").inc(n)
        return n

    # -- workers ------------------------------------------------------

    def _ensure_workers(self) -> None:
        # Under self._lock.
        while len(self._threads) < min(self.workers, len(self._jobs) or 1):
            t = threading.Thread(target=self._worker, name=f"mdt-precapture-{len(self._threads)}", daemon=True)
            self._threads.append(t)
            t.start()

    def _worker(self) -> None:
        while True:
            with self._lock:
                while not self._jobs and not self._shutdown:
                    self._wake.wait(timeout=1.0)
                if self._shutdown and not self._jobs:
                    return
                if not self._jobs:
                    continue
                key, builder = self._jobs.popleft()
                self._in_flight += 1
            try:
                # An admission may have claimed the job while it sat queued.
                if self.registry.status(key) != PENDING:
                    _emit("precompile_skipped", program=_programs.program_label(key))
                    continue
                e = self.registry.compile_now(key, builder, source=SOURCE_PRECOMPILE)
                if e.error is not None and e.source == SOURCE_PRECOMPILE:
                    _emit("precompile_failed", program=e.label, error=e.error[:300])
            finally:
                with self._lock:
                    self._in_flight -= 1
                    self._wake.notify_all()

    # -- lifecycle ----------------------------------------------------

    def shutdown(self, wait: bool = False, timeout_s: float = 30.0) -> None:
        """Stop taking jobs and drop the queued ones, releasing their
        entries so that an admission waiting on them claims its program
        itself; ``wait=True`` joins the workers (bounded)."""
        with self._lock:
            self._shutdown = True
            dropped = list(self._jobs)
            self._jobs.clear()
            self._wake.notify_all()
        for key, _ in dropped:
            self.registry.release(key)
        if dropped:
            _emit("precompile_dropped", jobs=len(dropped))
        if wait:
            for t in self._threads:
                t.join(timeout=timeout_s)

    def drain(self, timeout_s: float = 120.0) -> bool:
        """Wait until every queued job is captured; False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while self._jobs or self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._wake.wait(timeout=min(remaining, 0.5))
        return True
