"""Crash-safe sweep ledger: append-only JSONL attempt history.

A copy of ``multidisttorch_tpu/hpo/ledger.py``: the same file, records and
folds, so either package reads the other's ledger, and the same
``attempt_start``/``attempt_end`` bus events and goodput counters in the
metrics registry.

The driver's in-memory results die with the process; per-trial
checkpoints recover *weights* but not the sweep's control state (which
trials finished, which attempt a trial is on, what already diverged).
The ledger is that control state, durable: one JSON object per line,
appended and fsync'd at every attempt boundary, keyed by the trial's
**config hash** so a restarted ``run_hpo`` trusts a "completed" record
only when the configuration is byte-identical to what completed.

Crash model: an append either lands whole or tears the final line;
:func:`SweepLedger.load` skips undecodable lines, so a torn tail costs
at most the last event (which the restarted sweep then simply re-runs —
re-running a finished trial is wasteful but correct; *skipping* an
unfinished one would not be).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from typing import Optional

from multidisttorch_tpu_torch.hpo.supervision import SETTLED_STATUSES
from multidisttorch_tpu_torch.telemetry.events import get_bus
from multidisttorch_tpu_torch.telemetry.metrics import get_registry

try:  # POSIX file locking for the append/compact exclusion below
    import fcntl
except ImportError:  # non-POSIX host: degrade to unlocked (single-writer)
    fcntl = None  # type: ignore[assignment]

LEDGER_NAME = "sweep_ledger.jsonl"


def config_hash(cfg_dict: dict) -> str:
    """Deterministic hash of a trial's full config (sorted-key JSON).
    Every field participates — a completed record under epochs=1 must
    not satisfy a sweep asking for epochs=3."""
    blob = json.dumps(cfg_dict, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def wasted_steps(ev: dict) -> int:
    """Executed-but-wasted optimizer steps carried by ONE ledger event:
    a non-settled ``attempt_end``'s progress beyond its own resume
    point, or a ``compacted`` summary's carried total; 0 for anything
    else. The single copy of the goodput denominator's per-event fold —
    :meth:`SweepLedger.compact`, the chaos bench, and the multi-host
    drill all share it, so a new status or summary field name changes
    in one place."""
    if ev.get("event") == "compacted":
        return max(0, int(ev.get("wasted_steps", 0) or 0))
    if ev.get("event") != "attempt_end" or ev.get("status") not in (
        "retrying", "preempted", "failed",
    ):
        return 0
    s = ev.get("summary") or {}
    return max(
        0,
        int(s.get("steps_at_failure", 0) or 0)
        - int(s.get("resumed_from_step", 0) or 0),
    )


class SweepLedger:
    """Append-only JSONL event log under ``{out_dir}/sweep_ledger.jsonl``.

    ``enabled=False`` turns the whole ledger off (writes AND reads), so
    the driver can thread one object unconditionally. Multi-controller:
    only ``write=True`` (process 0) appends, but every process reads —
    skip decisions must be identical everywhere, over the shared
    filesystem the checkpoint/resume path already requires.
    """

    def __init__(
        self, out_dir: str, *, enabled: bool = True, write: bool = True
    ):
        self.path = os.path.join(out_dir, LEDGER_NAME)
        self.enabled = enabled
        self.write = write and enabled

    # -- writing -----------------------------------------------------

    @contextlib.contextmanager
    def _mutate_lock(self):
        """Exclusive advisory lock serializing every ledger MUTATION
        (appends and the compaction rewrite) within and across
        processes.

        Compaction is load → rewrite-to-tmp → ``os.replace``; an append
        racing that window lands on the snapshot file *after* the load
        but is then clobbered by the replace — the appended record is
        silently dropped (exactly the record a crash-recovery fold
        would need). The sweep service makes this race routine: its
        intake loop appends attempt records while the supervisor (or a
        ``ledger_view --compact`` operator) compacts between worlds.
        The lock lives on a sidecar (``.lock``) so the ledger file
        itself can still be atomically replaced; readers stay lock-free
        (the torn-tail-tolerant ``load`` never needed one)."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if fcntl is None:
            yield
            return
        fd = os.open(self.path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # closing drops the flock

    def append(self, event: dict) -> None:
        if not self.write:
            return
        line = json.dumps({**event, "ts": time.time()}, default=str)
        with self._mutate_lock(), open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    @staticmethod
    def _tag_fields(
        tenant: Optional[str], priority: Optional[int],
        submit_ts: Optional[float], trace: Optional[str] = None,
    ) -> dict:
        """Optional multi-tenant provenance (the sweep service's
        scheduling books key off these; ``trace`` is the submission's
        end-to-end trace id — docs/OBSERVABILITY.md "Tracing & SLOs").
        Absent tags serialize NOTHING — pre-service ledgers and
        single-tenant sweeps stay byte-identical, and old records
        parse unchanged."""
        out: dict = {}
        if tenant is not None:
            out["tenant"] = str(tenant)
        if priority is not None:
            out["priority"] = int(priority)
        if submit_ts is not None:
            out["submit_ts"] = float(submit_ts)
        if trace is not None:
            out["trace"] = str(trace)
        return out

    def attempt_start(
        self, trial_id: int, chash: str, attempt: int,
        *,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        submit_ts: Optional[float] = None,
        trace: Optional[str] = None,
    ) -> None:
        # Telemetry rides the ledger's call sites: every attempt boundary
        # of the driver (classic and stacked lanes) funnels through these
        # two methods, so emitting here, before the write gate, observes
        # attempts even when the ledger file itself is off.
        tags = self._tag_fields(tenant, priority, submit_ts, trace)
        bus = get_bus()
        if bus is not None:
            bus.emit("attempt_start", trial_id=trial_id, attempt=attempt, config_hash=chash, **tags)
        self.append(
            {
                "event": "attempt_start",
                "trial_id": trial_id,
                "config_hash": chash,
                "attempt": attempt,
                **tags,
            }
        )

    def attempt_end(
        self,
        trial_id: int,
        chash: str,
        attempt: int,
        status: str,
        *,
        error: str = "",
        summary: Optional[dict] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        submit_ts: Optional[float] = None,
        trace: Optional[str] = None,
    ) -> None:
        """``status``: completed | diverged | retrying | failed |
        preempted. ``summary`` (completed/diverged) carries enough to
        reconstruct the TrialResult on a ledger skip."""
        tags = self._tag_fields(tenant, priority, submit_ts, trace)
        bus = get_bus()
        if bus is not None:
            bus.emit("attempt_end", trial_id=trial_id, attempt=attempt, config_hash=chash, status=status,
                     error=error, summary=summary or {}, **tags)
        reg = get_registry()
        if reg is not None:
            # The goodput books, live: executed counts every attempt's
            # (end - resume) steps, useful counts settled outcomes only.
            reg.counter("attempts_total", status=status).inc()
            s = summary or {}
            done = int(s.get("steps", s.get("steps_at_failure", 0)) or 0)
            resumed = int(s.get("resumed_from_step", 0) or 0)
            reg.counter("executed_steps_total").inc(max(0, done - resumed))
            if status in SETTLED_STATUSES:
                reg.counter("useful_steps_total").inc(done)
            if status == "retrying":
                reg.counter("retries_total").inc()
        self.append(
            {
                "event": "attempt_end",
                "trial_id": trial_id,
                "config_hash": chash,
                "attempt": attempt,
                "status": status,
                "error": error,
                "summary": summary or {},
                **tags,
            }
        )

    # -- reading -----------------------------------------------------

    def load(self) -> list[dict]:
        """All decodable events, in append order. A torn final line
        (crash mid-append) is skipped, not fatal."""
        if not self.enabled or not os.path.exists(self.path):
            return []
        events = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail from a crash mid-append
        return events

    def finished(self) -> dict[str, dict]:
        """config_hash -> final attempt_end record, for every config
        whose outcome is settled (completed or diverged — the statuses a
        restarted sweep must NOT re-run). A later attempt_start for the
        same hash (a forced re-run) invalidates the earlier settlement."""
        done: dict[str, dict] = {}
        for ev in self.load():
            h = ev.get("config_hash")
            if not h:
                continue
            if (
                ev.get("event") == "attempt_end"
                and ev.get("status") in SETTLED_STATUSES
            ):
                done[h] = ev
            elif ev.get("event") == "attempt_start" and h in done:
                if ev.get("attempt", 0) > done[h].get("attempt", 0):
                    done.pop(h, None)
        return done

    def attempts(self) -> dict[str, int]:
        """config_hash -> number of attempt_start events seen (so a
        restarted driver continues the attempt numbering, keeping the
        ledger's history monotonic). ``compacted`` summary records
        (written by :meth:`compact`) carry forward the pre-compaction
        maximum."""
        counts: dict[str, int] = {}
        for ev in self.load():
            h = ev.get("config_hash")
            if not h:
                continue
            if ev.get("event") == "attempt_start":
                counts[h] = max(counts.get(h, 0), int(ev.get("attempt", 0)))
            elif (
                ev.get("event") == "compacted"
                and int(ev.get("attempts", 0)) > 0
            ):
                counts[h] = max(counts.get(h, 0), int(ev["attempts"]))
        return counts

    def infra_failures(self) -> dict[str, int]:
        """config_hash -> infra failures recorded so far ("retrying" /
        "failed" attempt_ends). The restarted driver seeds its retry
        budgets from this — preempted attempts deliberately do NOT
        count (RetryPolicy.should_retry's contract). ``compacted``
        summary records carry the failures whose individual events
        compaction dropped."""
        counts: dict[str, int] = {}
        for ev in self.load():
            h = ev.get("config_hash")
            if not h:
                continue
            if (
                ev.get("event") == "attempt_end"
                and ev.get("status") in ("retrying", "failed")
            ):
                counts[h] = counts.get(h, 0) + 1
            elif (
                ev.get("event") == "compacted"
                and int(ev.get("infra_failures", 0)) > 0
            ):
                # zero carries add nothing — and must not materialize
                # entries the un-compacted fold never had
                counts[h] = counts.get(h, 0) + int(ev["infra_failures"])
        return counts

    # -- compaction ---------------------------------------------------

    def compact(self) -> dict:
        """Atomically rewrite the ledger to its minimal equivalent
        state.

        A restart storm (elastic world shrinks, preemption loops,
        retry-heavy chaos runs) appends attempt history without bound —
        every restarted driver then re-folds the whole file. Compaction
        keeps, per config hash, exactly what the three restart folds
        (:meth:`finished`, :meth:`attempts`, :meth:`infra_failures`)
        need:

        - one ``compacted`` summary record carrying the attempt
          high-water mark and the infra-failure count of the DROPPED
          events,
        - the newest ``attempt_start`` and the newest ``attempt_end``
          verbatim, in their original relative order (so a settlement
          invalidated by a later re-run start stays invalidated).

        The rewrite lands via tmp + fsync + ``os.replace`` + dir fsync
        — a crash mid-compaction leaves the old ledger intact; a torn
        tail in the input is skipped by :meth:`load` like any other
        read. Returns ``{"lines_before", "lines_after", "hashes"}``
        (zeros when the ledger is disabled or this process is not the
        writer — compaction respects the same write gate as appends).
        """
        if not self.write or not os.path.exists(self.path):
            return {"lines_before": 0, "lines_after": 0, "hashes": 0}
        with self._mutate_lock():
            return self._compact_locked()

    def _compact_locked(self) -> dict:
        # Under _mutate_lock: no append can land between the load below
        # and the os.replace at the end, so the rewrite can never
        # clobber a record it did not fold (the race this lock exists
        # for — a live intake/attempt appender racing a between-worlds
        # compaction used to drop the appended line).
        events = self.load()
        per_hash: dict[str, dict] = {}
        other: list[dict] = []  # hash-less events survive verbatim
        for idx, ev in enumerate(events):
            h = ev.get("config_hash")
            if not h or ev.get("event") not in (
                "attempt_start", "attempt_end", "compacted"
            ):
                other.append(ev)
                continue
            rec = per_hash.setdefault(
                h,
                {
                    "first_idx": idx,
                    "trial_id": ev.get("trial_id"),
                    "start": None,
                    "end": None,
                    "attempts": 0,
                    "infra": 0,
                    "wasted": 0,
                },
            )
            if ev.get("event") == "attempt_start":
                rec["start"] = (idx, ev)
                rec["attempts"] = max(
                    rec["attempts"], int(ev.get("attempt", 0))
                )
            elif ev.get("event") == "attempt_end":
                rec["end"] = (idx, ev)
                if ev.get("status") in ("retrying", "failed"):
                    rec["infra"] += 1
                rec["wasted"] += wasted_steps(ev)
            else:  # an earlier compaction's summary folds in
                rec["attempts"] = max(
                    rec["attempts"], int(ev.get("attempts", 0))
                )
                rec["infra"] += int(ev.get("infra_failures", 0))
                rec["wasted"] += wasted_steps(ev)
        out: list[dict] = list(other)
        for h, rec in sorted(
            per_hash.items(), key=lambda kv: kv[1]["first_idx"]
        ):
            kept = [p for p in (rec["start"], rec["end"]) if p is not None]
            kept.sort(key=lambda p: p[0])  # original relative order
            # The summary counts only what is NOT kept verbatim, so the
            # infra_failures fold never double-counts the retained end.
            kept_infra = sum(
                1
                for _, ev in kept
                if ev.get("event") == "attempt_end"
                and ev.get("status") in ("retrying", "failed")
            )
            kept_wasted = sum(wasted_steps(ev) for _, ev in kept)
            out.append(
                {
                    "event": "compacted",
                    "config_hash": h,
                    "trial_id": rec["trial_id"],
                    "attempts": rec["attempts"],
                    "infra_failures": max(0, rec["infra"] - kept_infra),
                    # Executed-but-wasted steps of the DROPPED
                    # non-settled attempt_ends (goodput's denominator
                    # input — the chaos accounting must not lose wasted
                    # work to compaction).
                    "wasted_steps": max(0, rec["wasted"] - kept_wasted),
                    "ts": time.time(),
                }
            )
            out.extend(ev for _, ev in kept)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for ev in out:
                f.write(json.dumps(ev, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        try:  # durably record the rename (best-effort, like checkpoint.py)
            fd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass
        return {
            "lines_before": len(events),
            "lines_after": len(out),
            "hashes": len(per_hash),
        }
