"""Fault injection runtime: the hooks the driver threads through itself.

Counterpart of ``multidisttorch_tpu/faults/inject.py``. A
:class:`FaultInjector` interprets a :class:`~.plan.FaultPlan` at run time:
the same dueness, matching and fired-record file as the JAX package's, so
one plan fires the same ``(kind, trial, step)`` set in both packages. It is
host-side bookkeeping; no captured CUDA graph changes because of it (the
DIVERGE kind poisons a *batch*, whose NaN reaches the graph through its
static-input copy, so nothing is captured anew). Every fired fault is
recorded in :attr:`FaultInjector.fired` for the chaos report's recovery
accounting.

Hook sites (threaded by ``hpo/driver.py``):

- :meth:`step_hook`: before each train-chunk dispatch (per trial, the
  chunk's first step and its length): CRASH raises, PREEMPT raises, SLOW
  sleeps.
- :meth:`poison_batch`: wraps the chunk's device batch when a DIVERGE
  fault covers one of its steps (``train.steps.wrap_step_with_hooks``
  applies it). It returns a clone on the batch's device with the covered
  step's slice filled with NaN: a device op, with no host copy and no
  sync.
- :meth:`data_hook`: inside the trial's data iterator (``data/sampler.py``,
  on the consumer side): DATA_ERROR raises mid-epoch, where a real loader
  fault would.
- :meth:`checkpoint_hook`: after an epoch checkpoint write lands (on the
  background writer thread): CKPT_CORRUPT garbles the state file in place,
  the torn artifact ``restore_latest_valid`` must scan past.

Host-scoped kinds: HOST_LOST keeps its ``os._exit``. WEDGE needs the
membership heartbeat (ROADMAP A.11), and DAEMON_LOST and SHARD_SPLIT_LOST
the service fabric (A.12): each raises ``NotImplementedError`` naming its
item when it comes due.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from multidisttorch_tpu_torch.faults.plan import (
    CKPT_CORRUPT,
    CRASH,
    DAEMON_LOST,
    DATA_ERROR,
    DIVERGE,
    HOST_KINDS,
    HOST_LOST,
    PREEMPT,
    SHARD_SPLIT_LOST,
    SLOW,
    WEDGE,
    FaultPlan,
    FaultSpec,
)
from multidisttorch_tpu_torch.telemetry.events import get_bus

# Exit code of a simulated hard host loss (os._exit — no cleanup, no
# atexit, heartbeat dies mid-lease, exactly like SIGKILL/slice loss).
# Deliberately NOT cluster.PREEMPTION_EXIT_CODE: a lost host must read
# as LOST to the supervisor, not as a healthy preempted worker.
HOST_LOST_EXIT_CODE = 86


class InfraFault(RuntimeError):
    """Base of injected *infrastructure* failures — the retryable class."""


class InjectedCrash(InfraFault):
    """A worker raised mid-trial (the generic injected exception)."""


class HostPreemption(InfraFault):
    """Simulated host preemption. The driver does NOT absorb this into a
    per-trial failure: it propagates out of ``run_hpo`` (the 'driver
    died' half of the chaos protocol) and the harness restarts the sweep
    against the ledger."""


class DataFault(InfraFault):
    """The trial's data iterator failed mid-epoch."""


class FaultInjector:
    """Stateful interpreter of one :class:`FaultPlan` over one sweep.

    Single-threaded by design (the driver's scheduling loop is); fire
    counts persist across trial retries — with the default
    ``max_fires=1`` a retried trial passes the injection point cleanly,
    modeling a transient fault.
    """

    def __init__(
        self,
        plan: FaultPlan,
        *,
        host_slot: "Optional[int]" = None,
        fired_log: "Optional[str]" = None,
    ):
        import threading

        self.plan = plan
        self._fires: dict[int, int] = {}  # spec index -> times fired
        self.fired: list[dict] = []  # chronological record, for reports
        # Host-scoped faults (plan.HOST_KINDS): this process's stable
        # host slot in a multi-host world (None = single-controller, no
        # host faults ever fire) and its cumulative dispatched-step
        # counter across ALL trials — the firing clock for host kinds.
        self.host_slot = host_slot
        self._host_steps = 0
        # The shard-split handoff clock (SHARD_SPLIT_LOST): advanced by
        # split_step() once per durable handoff record, never by the
        # dispatch clock.
        self._split_steps = 0
        # Durable fired state for elastic restarts: an in-memory
        # injector dies with its host, but a one-shot fault must stay
        # one-shot when the supervisor relaunches the world. Every
        # _record appends (fsync'd — a host_lost os._exit follows
        # immediately) to this JSONL; on construction prior fires are
        # replayed into the dueness bookkeeping.
        self._fired_log = fired_log
        if fired_log is not None and os.path.exists(fired_log):
            with open(fired_log) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail from a dying host
                    idx = int(rec.get("spec_index", -1))
                    if idx >= 0:
                        self._fires[idx] = self._fires.get(idx, 0) + 1
        # The driver's scheduling loop is single-threaded, but the
        # checkpoint hook fires from the background writer thread —
        # bookkeeping mutations take this lock.
        self._lock = threading.Lock()

    # -- bookkeeping -------------------------------------------------

    def _due(self, spec_index: int, spec: FaultSpec) -> bool:
        return self._fires.get(spec_index, 0) < spec.max_fires

    def _record(self, spec_index: int, spec: FaultSpec, **ctx) -> None:
        with self._lock:
            self._fires[spec_index] = self._fires.get(spec_index, 0) + 1
            self.fired.append(
                {"kind": spec.kind, "trial_id": spec.trial_id, **ctx,
                 "ts": time.time()}
            )
            if self._fired_log is not None:
                os.makedirs(
                    os.path.dirname(self._fired_log) or ".", exist_ok=True
                )
                with open(self._fired_log, "a") as f:
                    f.write(
                        json.dumps(
                            {"spec_index": spec_index, "kind": spec.kind,
                             "trial_id": spec.trial_id, **ctx,
                             "ts": time.time()},
                            default=str,
                        )
                        + "\n"
                    )
                    f.flush()
                    os.fsync(f.fileno())
        # Telemetry seam: every fired fault tags itself into the event
        # stream, so a chaos run's trace self-documents its injections
        # next to the recovery they triggered.
        bus = get_bus()
        if bus is not None:
            bus.emit(
                "fault_injected",
                trial_id=spec.trial_id,
                step=ctx.get("step"),
                fault_kind=spec.kind,
                **{k: v for k, v in ctx.items() if k != "step"},
            )

    def _match(
        self,
        kinds,
        trial_id: int,
        *,
        step=None,
        n_steps: int = 1,
        **field_eq,
    ):
        """First due spec in PLAN ORDER whose kind is in ``kinds``, for
        ``trial_id``, whose ``spec.step`` falls in the dispatch window
        ``[step, step + n_steps)`` (when ``step`` given) and whose other
        fields equal ``field_eq``. The single matching scan every hook
        routes through — one copy of the window/dueness semantics."""
        for idx, spec in enumerate(self.plan.specs):
            if spec.kind not in kinds or spec.trial_id != trial_id:
                continue
            if not self._due(idx, spec):
                continue
            if step is not None and not (
                step <= spec.step < step + n_steps
            ):
                continue
            if not all(getattr(spec, k) == v for k, v in field_eq.items()):
                continue
            return idx, spec
        return None

    # -- hook sites --------------------------------------------------
    # All `fired` records carry step=spec.step — the fault's scheduled
    # point, not the dispatch-window start — so reports read uniformly.

    def _host_hook(self, n_steps: int) -> None:
        """Fire host-scoped faults (HOST_KINDS) keyed to this host's
        cumulative dispatched-step clock. HOST_LOST dies instantly
        (``os._exit``: SIGKILL semantics). WEDGE and DAEMON_LOST raise
        ``NotImplementedError`` naming the ROADMAP item that ports their
        seam (the membership heartbeat, the service fabric)."""
        if self.host_slot is None:
            return
        window_end = self._host_steps + n_steps
        self._host_steps = window_end
        for idx, spec in enumerate(self.plan.specs):
            if spec.kind not in HOST_KINDS or spec.host != self.host_slot:
                continue
            if spec.kind == SHARD_SPLIT_LOST:
                continue  # fires on the split-handoff clock, not this one
            if not self._due(idx, spec) or spec.step >= window_end:
                continue
            _require_ported(spec.kind)
            self._record(idx, spec, step=spec.step, host=self.host_slot)
            os._exit(HOST_LOST_EXIT_CODE)
            return  # unreachable live; tests monkeypatch os._exit

    def host_step(self, n_steps: int = 1) -> None:
        """Advance ONLY the host/replica cumulative-dispatch clock (the
        fabric replica's seam: it has no per-trial step hook — the
        shard services own those — but its daemon_lost fault must fire
        on real dispatch progress)."""
        self._host_hook(n_steps)

    def split_step(self, n_steps: int = 1) -> None:
        """Advance the replica's cumulative split-handoff clock. A due
        ``shard_split_lost`` fault raises ``NotImplementedError``: shard
        splits belong to the service fabric (ROADMAP A.12)."""
        if self.host_slot is None:
            return
        window_end = self._split_steps + n_steps
        self._split_steps = window_end
        for idx, spec in enumerate(self.plan.specs):
            if spec.kind != SHARD_SPLIT_LOST or spec.host != self.host_slot:
                continue
            if self._due(idx, spec) and spec.step < window_end:
                _require_ported(spec.kind)

    def step_hook(self, trial_id: int, step: int, n_steps: int = 1) -> None:
        """Called before dispatching ``n_steps`` optimizer steps starting
        at ``step`` for ``trial_id``. Raises for CRASH/PREEMPT whose
        step falls in the window; sleeps for SLOW (and keeps scanning —
        a straggler stall does not shadow a crash in the same window).
        Host-scoped faults (HOST_LOST/WEDGE) ride the same seam on
        their own cumulative-step clock."""
        self._host_hook(n_steps)
        while True:
            m = self._match(
                (CRASH, PREEMPT, SLOW), trial_id, step=step, n_steps=n_steps
            )
            if m is None:
                return
            idx, spec = m
            self._record(idx, spec, step=spec.step)
            if spec.kind == SLOW:
                time.sleep(spec.delay_s)
                continue
            if spec.kind == CRASH:
                raise InjectedCrash(
                    f"injected crash: trial {trial_id} at step {spec.step}"
                )
            raise HostPreemption(
                f"injected preemption: host lost while trial "
                f"{trial_id} was at step {spec.step}"
            )

    def diverge_covers(self, trial_id: int, step: int, n_steps: int = 1) -> bool:
        """Whether a DIVERGE fault is due inside the dispatch window."""
        return (
            self._match((DIVERGE,), trial_id, step=step, n_steps=n_steps)
            is not None
        )

    def poison_batch(
        self, trial_id: int, step: int, batch: torch.Tensor, n_steps: int = 1
    ) -> torch.Tensor:
        """NaN-fill the batch (or, in a ``(K, B, ...)`` chunk, the exact
        covered inner-step slice) feeding a DIVERGE-covered dispatch. The
        loss then goes non-finite through the *real* kernels and graph
        replay: detection and terminal classification are exercised end to
        end, not simulated.

        Returns a clone of ``batch`` on its device with the slice filled
        (``batch`` itself is left as it is): device ops only, no host copy
        and no sync."""
        m = self._match((DIVERGE,), trial_id, step=step, n_steps=n_steps)
        if m is None:
            return batch
        idx, spec = m
        self._record(idx, spec, step=spec.step)
        out = batch.clone()
        (out if n_steps == 1 else out[spec.step - step]).fill_(float("nan"))
        return out

    def data_hook(self, trial_id: int, step: int, n_steps: int = 1) -> None:
        """Called by the data iterator as it assembles the batch(es) for
        the dispatch starting at ``step``."""
        m = self._match((DATA_ERROR,), trial_id, step=step, n_steps=n_steps)
        if m is not None:
            idx, spec = m
            self._record(idx, spec, step=spec.step)
            raise DataFault(
                f"injected data-iterator failure: trial {trial_id} "
                f"at step {spec.step}"
            )

    def checkpoint_hook(
        self, trial_id: int, epoch: int, path: str
    ) -> Optional[str]:
        """Called after the epoch-``epoch`` checkpoint write for
        ``trial_id`` lands at ``path``. CKPT_CORRUPT overwrites the
        file's tail with garbage — a torn/rotted artifact whose CRC
        sidecar no longer matches. Returns the corrupted path (or None)."""
        m = self._match((CKPT_CORRUPT,), trial_id, epoch=epoch)
        if m is None:
            return None
        idx, spec = m
        self._record(idx, spec, epoch=epoch, path=path)
        corrupt_file(path)
        return path


# Host and service kinds whose seams are not ported yet: kind -> ROADMAP item.
_UNPORTED_KINDS = {
    WEDGE: "A.11 (elastic multi-host: parallel/membership.py's heartbeat and the wedge watchdog)",
    DAEMON_LOST: "A.12 (the service fabric's replicas)",
    SHARD_SPLIT_LOST: "A.12 (the service fabric's shard splits)",
}


def _require_ported(kind: str) -> None:
    item = _UNPORTED_KINDS.get(kind)
    if item is not None:
        raise NotImplementedError(f"fault kind {kind!r} is not ported yet: ROADMAP {item}")


def corrupt_file(path: str, *, keep_bytes: Optional[int] = None) -> None:
    """Garble a file in place: keep the first half (or ``keep_bytes``),
    replace the rest with 0xFF — the shape of a torn write or partial
    flush. Deterministic, so chaos runs are reproducible."""
    size = os.path.getsize(path)
    keep = size // 2 if keep_bytes is None else min(keep_bytes, size)
    with open(path, "r+b") as f:
        f.seek(keep)
        f.write(b"\xff" * (size - keep))
