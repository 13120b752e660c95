"""Durable submission intake: the sweep service's crash-safe queue.

The ledger (``hpo/ledger.py``) is a crash LOG — this module extends the
same JSONL machinery into an intake QUEUE with a two-stage durability
protocol, so that *every accepted submission survives a daemon restart*
(including ``kill -9`` mid-append — the acceptance drill in
``bench.py --service``):

1. **Client spool** (:class:`SweepClient`): each ``submit()`` lands one
   submission as its own file under ``{service_dir}/intake/``, written
   atomically (tmp + fsync + rename, the checkpoint layer's pattern).
   Many tenants submit concurrently with no shared-file coordination —
   rename is the commit point. A client killed mid-write leaves only a
   ``.tmp`` the daemon ignores.
2. **Daemon journal** (:class:`SubmissionQueue`): the single-writer
   daemon drains the spool into ``{service_dir}/queue.jsonl`` — one
   fsync'd JSON record per state transition (``submitted`` →
   ``admitted``/``rejected`` → ``placed`` → ``settled``, plus
   ``unplaced`` when a drain/defrag takes a trial off its submesh).
   The spool file is unlinked only AFTER its ``submitted`` record is
   durable, so a crash between the two replays the file and the
   journal's ``submission_id`` dedup makes the replay idempotent.

Crash model (the ledger's): an append either lands whole or tears the
final line; :func:`fold_queue` skips undecodable lines, so a torn tail
costs at most the last *transition* — never the submission itself (its
``submitted`` record, or failing that its spool file, is still there).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof

QUEUE_NAME = "queue.jsonl"
INTAKE_DIR = "intake"


def mint_trace_id() -> str:
    """A fresh end-to-end trace id (docs/OBSERVABILITY.md "Tracing &
    SLOs"). The ONE minting convention — ``SweepClient.submit`` calls
    it, ``telemetry/trace.py`` re-exports it."""
    return uuid.uuid4().hex[:16]


def default_trace_id(submission_id: str) -> str:
    """Deterministic trace id for records minted before tracing
    existed (re-exported by ``telemetry/trace.py`` — defined here so
    the queue layer derives it without importing telemetry)."""
    import hashlib

    h = hashlib.sha256(f"sub:{submission_id}".encode()).hexdigest()
    return "d" + h[:15]


def fsync_dir(path: str) -> None:
    """Flush a directory's entry table (``train/checkpoint.py``'s
    atomic-write discipline, duplicated here so the queue stays
    importable without jax): after ``os.replace`` lands a file, the
    RENAME itself is not durable until the directory is fsync'd — on
    ext4-ordered (and most journaling filesystems) a crash can roll
    the directory back and the committed file vanishes. Best-effort:
    some filesystems refuse O_RDONLY dir fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)

# Submission lifecycle states, in order. ``rejected`` is terminal like
# ``settled``; ``unplaced`` folds back to ``admitted`` (the trial is
# queued again — a drain or a defrag migration took it off its submesh).
# ``moved`` is terminal FOR THIS JOURNAL only: a shard split handoff or
# a cross-shard steal transferred the submission to another shard's
# intake, so its live record continues in the destination's journal
# (the fabric client's merged fold prefers the destination record —
# docs/SERVICE.md "Shard topology").
PENDING = "pending"        # submitted, not yet through admission
ADMITTED = "admitted"      # passed admission; waiting for a submesh
PLACED = "placed"          # running on a submesh
SETTLED = "settled"        # terminal trial outcome recorded
REJECTED = "rejected"      # admission verdict said no
MOVED = "moved"            # transferred to another shard (split/steal)

# Admission verdict for a submission spooled at a shard that no longer
# owns its tenant (the topology changed between the client's routing
# read and the daemon's drain). Terminal at THIS shard; the fabric
# client re-reads the topology and resubmits to the current owner,
# bounded to one retry.
REJECT_WRONG_SHARD = "rejected_wrong_shard"


@dataclass(frozen=True)
class Submission:
    """One tenant's ask: a trial config plus scheduling identity.

    ``config`` is the :class:`~multidisttorch_tpu_torch.hpo.driver.
    TrialConfig` field dict *without* ``trial_id`` (the service assigns
    trial ids at admission). ``size`` is the submesh footprint in
    slices (1 = smallest schedulable submesh; >1 asks for that many
    CONTIGUOUS slices — the large-shape case defrag exists for).
    ``priority`` is a lane: 0 is served strictly before 1, which is
    served strictly before 2 (fair-share applies *within* a lane).
    ``deadline_s`` (seconds from submission) EDF-orders the trial
    inside its tenant's fair share and arms deadline preemption of
    best-effort lanes within the anti-thrash budget (docs/SERVICE.md
    "Deadlines"); hits and misses are accounted in the books — the
    scheduler never kills an overdue trial."""

    submission_id: str
    tenant: str
    config: dict
    priority: int = 1
    size: int = 1
    deadline_s: Optional[float] = None
    submit_ts: float = 0.0
    # End-to-end trace id (docs/OBSERVABILITY.md "Tracing & SLOs"):
    # minted client-side at submit, rides the spool record and every
    # journal/ledger/telemetry record after it. Empty = an old client;
    # readers derive a deterministic fallback (``trace`` property).
    trace_id: str = ""
    # Transfer provenance (shard splits / work stealing): the shard
    # this submission was journaled ``moved`` out of, and why
    # ("split" | "steal"). A moved submission already passed admission
    # at its origin, so the destination re-admits it WITHOUT quota or
    # backpressure checks (a transfer must never turn an accepted
    # submission into a rejection) — and its tenant/priority/submit_ts
    # ride along unchanged, so fair-share vtime still charges the
    # ORIGIN tenant: stealing can't launder priority.
    moved_from: Optional[int] = None
    moved_kind: str = ""

    @property
    def trace(self) -> str:
        """The submission's trace id: explicit when minted, else the
        deterministic derivation every reader agrees on."""
        return self.trace_id or default_trace_id(self.submission_id)

    def to_dict(self) -> dict:
        d = {
            "submission_id": self.submission_id,
            "tenant": self.tenant,
            "config": dict(self.config),
            "priority": int(self.priority),
            "size": int(self.size),
            "submit_ts": float(self.submit_ts),
        }
        if self.deadline_s is not None:
            d["deadline_s"] = float(self.deadline_s)
        if self.trace_id:
            # Absent when unset: pre-trace records stay byte-identical.
            d["trace_id"] = self.trace_id
        if self.moved_from is not None:
            # Absent when unset: untransferred records stay identical.
            d["moved_from"] = int(self.moved_from)
            d["moved_kind"] = self.moved_kind
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Submission":
        return cls(
            submission_id=str(d["submission_id"]),
            tenant=str(d.get("tenant", "default")),
            config=dict(d.get("config") or {}),
            priority=int(d.get("priority", 1)),
            size=int(d.get("size", 1)),
            deadline_s=(
                float(d["deadline_s"])
                if d.get("deadline_s") is not None
                else None
            ),
            submit_ts=float(d.get("submit_ts", 0.0)),
            trace_id=str(d.get("trace_id", "") or ""),
            moved_from=(
                int(d["moved_from"])
                if d.get("moved_from") is not None
                else None
            ),
            moved_kind=str(d.get("moved_kind", "") or ""),
        )


def intake_dir(service_dir: str) -> str:
    return os.path.join(service_dir, INTAKE_DIR)


def queue_path(service_dir: str) -> str:
    return os.path.join(service_dir, QUEUE_NAME)


def spool_submission(service_dir: str, sub: Submission) -> str:
    """Durably land ``sub`` in ``service_dir``'s intake spool; returns
    the spool path. The ONE spool-write primitive: ``SweepClient.
    submit`` (fresh ids), the fabric client's wrong-shard resubmit
    (SAME id, new shard), and shard split/steal handoffs (same id +
    provenance) all commit through it — tmp + fsync + rename + dir
    fsync, idempotent per submission id (a re-run overwrites the same
    spool file with the same content, which the journal's id dedup
    absorbs)."""
    d = intake_dir(service_dir)
    os.makedirs(d, exist_ok=True)
    final = os.path.join(d, sub.submission_id + ".json")
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(sub.to_dict(), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)  # the commit point
    # Directory fsync AFTER the rename: without it the commit point
    # itself can vanish on a crash (the rename sits only in the page
    # cache). The call sequence — file fsync, rename, dir fsync — is
    # regression-tested (tests/test_fabric.py).
    fsync_dir(d)
    return final


class SweepClient:
    """Tenant-side submission API (file transport).

    The transport is the shared filesystem the checkpoint/ledger layers
    already require, so a client needs no daemon connection: ``submit``
    is durable the moment it returns (the rename landed), and the
    daemon picks it up on its next intake scan. ``status``/``wait``
    read the daemon's journal fold — the same fold the daemon itself
    recovers from, so client and daemon can never disagree about a
    submission's state."""

    def __init__(self, service_dir: str, *, tenant: str = "default"):
        self.service_dir = service_dir
        self.tenant = tenant

    def submit(
        self,
        config: dict,
        *,
        priority: int = 1,
        size: int = 1,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> str:
        """Durably submit one trial; returns the submission id."""
        if priority < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        ten = self.tenant if tenant is None else tenant
        sub = Submission(
            submission_id=f"{ten}-{uuid.uuid4().hex[:12]}",
            tenant=ten,
            config=dict(config),
            priority=priority,
            size=size,
            deadline_s=deadline_s,
            submit_ts=time.time(),
            # The trace id is minted HERE, at the very front door, so
            # the spool-wait phase (client commit -> daemon drain) is
            # inside the trace — a daemon-side mint could never see it.
            trace_id=mint_trace_id(),
        )
        spool_submission(self.service_dir, sub)
        # The full receipt (submission + trace id) for callers that
        # want more than the id — tools/sweep_submit.py prints both.
        self.last_submission = sub
        return sub.submission_id

    def status(self, submission_id: str) -> Optional[dict]:
        """This submission's folded state, or None if unknown. A spool
        file the daemon has not drained yet reports ``pending``.

        Order matters: the spool is checked BEFORE the journal is
        folded. The daemon unlinks a spool file only after its
        ``submitted`` record is durable, so a spool miss followed by a
        journal read cannot miss both — checking the journal first
        leaves a window where a mid-drain submission (append landed
        after our fold, unlink before our spool check) reads as
        unknown despite being durably committed."""
        p = os.path.join(
            intake_dir(self.service_dir), submission_id + ".json"
        )
        spooled = os.path.exists(p)
        rec = fold_queue(load_queue(self.service_dir)).get(submission_id)
        if rec is not None:
            return rec
        if spooled:
            return {"state": PENDING, "submission_id": submission_id}
        return None

    def wait(
        self,
        submission_ids,
        *,
        timeout_s: float = 300.0,
        poll_s: float = 0.25,
    ) -> dict[str, dict]:
        """Block until every submission reaches a terminal state
        (settled/rejected) or the deadline passes; returns the final
        fold per id (missing ids map to None-state dicts)."""
        ids = list(submission_ids)
        deadline = time.time() + timeout_s
        while True:
            folded = fold_queue(load_queue(self.service_dir))
            out = {
                s: folded.get(s, {"state": PENDING, "submission_id": s})
                for s in ids
            }
            if all(
                r["state"] in (SETTLED, REJECTED) for r in out.values()
            ):
                return out
            if time.time() > deadline:
                return out
            time.sleep(poll_s)


class SubmissionQueue:
    """Daemon-side durable journal (single writer — the daemon).

    Appends are fsync'd whole-line JSONL with the ledger's torn-tail
    read contract. The journal is append-only across daemon restarts
    (unlike the telemetry sink's truncate-per-run): the queue IS the
    service's control state, and a restarted daemon re-folds it to
    recover exactly where the previous incarnation died."""

    def __init__(
        self,
        service_dir: str,
        *,
        write: bool = True,
        fence=None,
        epoch: Optional[int] = None,
    ):
        self.service_dir = service_dir
        self.path = queue_path(service_dir)
        self.write = write
        # Shard fence (fabric): raises before any append once this
        # writer's shard lease was taken over — a stale daemon's
        # transitions must be REJECTED, never interleaved with the new
        # owner's journal.
        self._fence = fence
        # Fencing epoch of the writer (fabric replicas): stamped on
        # every record so an offline reader can see WHICH incarnation
        # wrote each transition — the trace layer's evidence that a
        # submission's spans are contiguous across a takeover. None
        # (plain single-controller service) serializes nothing.
        self.epoch = epoch
        # submission_id -> trace id, fed by drain_intake and the
        # recovery fold: every transition record rides the trace.
        self.trace_ids: dict[str, str] = {}
        self._tail_checked = False

    # -- journal ------------------------------------------------------

    def _terminate_torn_tail(self) -> None:
        """If the journal's previous writer died mid-append, the file
        ends without a newline. Appending straight onto that torn line
        would CONCATENATE the new record into it — one undecodable
        line swallowing BOTH records (found by the adoption-replay
        regression test). Checked once per writer: after our own
        appends the file always ends with a newline."""
        if self._tail_checked:
            return
        self._tail_checked = True
        try:
            with open(self.path, "rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                torn = f.read(1) != b"\n"
        except OSError:
            return  # no file yet: nothing to terminate
        if torn:
            with open(self.path, "a") as f:
                f.write("\n")

    def append(self, record: dict) -> None:
        if not self.write:
            return
        if self._fence is not None:
            self._fence()
        os.makedirs(self.service_dir, exist_ok=True)
        self._terminate_torn_tail()
        sid = record.get("submission_id") or (
            record.get("sub") or {}
        ).get("submission_id")
        trace = self.trace_ids.get(sid) if sid else None
        if trace:
            record = {**record, "trace": trace}
        if self.epoch is not None:
            record = {**record, "epoch": int(self.epoch)}
        line = json.dumps({**record, "ts": time.time()}, default=str)
        created = not os.path.exists(self.path)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        if created:
            # First-ever append CREATED the journal: the file's
            # directory entry needs the same durability as the record
            # (a crash must not vanish the whole queue).
            fsync_dir(self.service_dir)

    def load(self) -> list[dict]:
        return load_queue(self.service_dir)

    # -- intake drain -------------------------------------------------

    def drain_intake(self, *, known_ids: set) -> list[Submission]:
        """Journal every new spool file as ``submitted`` and unlink it.

        ``known_ids`` is the fold's id set — a spool file whose id is
        already journaled (crash landed between append and unlink) is
        unlinked without a duplicate record. Torn ``.tmp`` files and
        undecodable spool files are skipped (a client died mid-write;
        its submission never committed). Returns the newly accepted
        submissions in spool-name order (deterministic across
        restarts)."""
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        d = intake_dir(self.service_dir)
        if not os.path.isdir(d):
            if prof is not None:
                prof.note("intake_drain", _t)
            return []
        fresh: list[Submission] = []
        seen = 0
        for name in sorted(os.listdir(d)):
            seen += 1
            if not name.endswith(".json"):
                continue  # .tmp = a client mid-write (or dead mid-write)
            p = os.path.join(d, name)
            try:
                with open(p) as f:
                    sub = Submission.from_dict(json.load(f))
            except (OSError, json.JSONDecodeError, KeyError, ValueError):
                continue  # torn/garbled spool file: never committed
            if sub.submission_id not in known_ids:
                self.trace_ids[sub.submission_id] = sub.trace
                self.append({"event": "submitted", "sub": sub.to_dict()})
                known_ids.add(sub.submission_id)
                fresh.append(sub)
            try:
                os.unlink(p)  # AFTER the durable append — replay-safe
            except OSError:
                pass
        if prof is not None:
            # examined = spool entries iterated (torn/.tmp included);
            # mutated = submissions journaled fresh.
            prof.note("intake_drain", _t, examined=seen, mutated=len(fresh))
        return fresh

    # -- state transitions -------------------------------------------

    def admitted(
        self, sub_id: str, *, trial_id: int, chash: str, bucket: str
    ) -> None:
        self.append(
            {
                "event": "admitted",
                "submission_id": sub_id,
                "trial_id": trial_id,
                "config_hash": chash,
                "bucket": bucket,
            }
        )

    def rejected(self, sub_id: str, *, verdict: str, reason: str) -> None:
        self.append(
            {
                "event": "rejected",
                "submission_id": sub_id,
                "verdict": verdict,
                "reason": reason,
            }
        )

    def placed(
        self,
        sub_id: str,
        *,
        trial_id: int,
        start: int,
        size: int,
        lanes: int,
        stacked: bool,
        resumed: bool,
        blocks=None,
    ) -> None:
        rec = {
            "event": "placed",
            "submission_id": sub_id,
            "trial_id": trial_id,
            "start": start,
            "size": size,
            "lanes": lanes,
            "stacked": stacked,
            "resumed": resumed,
        }
        if blocks is not None:
            # Vector (MPMD pipelined) placement: the all-or-nothing
            # per-stage block list — evidence the bench's placement
            # gate reads. Absent for classic placements, so old
            # records parse byte-identically.
            rec["blocks"] = [[int(s), int(n)] for s, n in blocks]
        self.append(rec)

    def unplaced(self, sub_id: str, *, trial_id: int, reason: str) -> None:
        """The trial came off its submesh WITHOUT settling (graceful
        drain, defrag migration, infra retry): it is queued again."""
        self.append(
            {
                "event": "unplaced",
                "submission_id": sub_id,
                "trial_id": trial_id,
                "reason": reason,
            }
        )

    def moved(
        self, sub_id: str, *, to_shard: int, kind: str, trial_id=None
    ) -> None:
        """The submission was transferred to another shard's intake
        (``kind`` = "split" handoff or "steal" grant). Appended only
        AFTER the destination spool write is durable, so a crash
        between the two re-runs the transfer idempotently (the spool
        overwrite + the destination journal's id dedup absorb the
        replay) — the submission is never lost and, because a
        ``moved`` record is terminal at this shard, never runs twice."""
        rec = {
            "event": "moved",
            "submission_id": sub_id,
            "to_shard": int(to_shard),
            "kind": kind,
        }
        if trial_id is not None:
            rec["trial_id"] = int(trial_id)
        self.append(rec)

    def settled(
        self, sub_id: str, *, trial_id: int, status: str, error: str = ""
    ) -> None:
        self.append(
            {
                "event": "settled",
                "submission_id": sub_id,
                "trial_id": trial_id,
                "status": status,
                "error": error,
            }
        )


def load_queue(service_dir: str) -> list[dict]:
    """All decodable journal records, append order, torn tail skipped
    (the ledger's read contract — importable without jax)."""
    path = queue_path(service_dir)
    events: list[dict] = []
    try:
        f = open(path)
    except OSError:
        return events
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict):
                events.append(ev)
    return events


def read_jsonl_from(path: str, offset: int) -> tuple[list[dict], int]:
    """Decodable records from COMPLETE lines past byte ``offset``;
    returns ``(records, new_offset)``. A final line with no newline yet
    (a writer mid-append) is left for the next call — the incremental
    sibling of :func:`load_queue`, shared by the daemon's books fold so
    a long-lived service never re-reads its whole history per tick."""
    try:
        f = open(path, "rb")
    except OSError:
        return [], offset
    with f:
        f.seek(offset)
        buf = f.read()
    end = buf.rfind(b"\n")
    if end < 0:
        return [], offset
    records: list[dict] = []
    for raw in buf[:end].split(b"\n"):
        raw = raw.strip()
        if not raw:
            continue
        try:
            ev = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
        if isinstance(ev, dict):
            records.append(ev)
    return records, offset + end + 1


def fold_queue(events: list[dict]) -> dict[str, dict]:
    """submission_id -> folded lifecycle state.

    The ONE state-machine fold: the daemon's restart recovery, the
    client's ``status``/``wait``, ``tools/ledger_view.py --queue`` and
    the service books all read this, so none of them can disagree. Each
    value carries the submission's identity (tenant/priority/size/
    submit_ts/config), its current ``state``, the assigned
    ``trial_id``/``bucket`` once admitted, per-transition timestamps,
    and the terminal ``status`` once settled."""
    return fold_queue_into({}, events)


def fold_queue_into(
    out: dict[str, dict], events: list[dict]
) -> dict[str, dict]:
    """Incremental form of :func:`fold_queue`: fold ``events`` into an
    existing state (the daemon feeds newly-appended journal records
    through a persistent fold instead of re-folding history)."""
    for ev in events:
        kind = ev.get("event")
        if kind == "submitted":
            sub = ev.get("sub") or {}
            sid = sub.get("submission_id")
            if not sid:
                continue
            out[sid] = {
                "submission_id": sid,
                "state": PENDING,
                "trace_id": sub.get("trace_id") or default_trace_id(sid),
                "tenant": sub.get("tenant", "default"),
                "priority": int(sub.get("priority", 1)),
                "size": int(sub.get("size", 1)),
                "submit_ts": float(sub.get("submit_ts", 0.0)),
                "deadline_s": sub.get("deadline_s"),
                "config": sub.get("config") or {},
                "trial_id": None,
                "bucket": None,
                "status": None,
                "error": "",
                "ts": {"submitted": ev.get("ts")},
                "placements": 0,
            }
            if sub.get("moved_from") is not None:
                # Transfer provenance survives the fold so a restarted
                # DESTINATION daemon re-admits without quota checks.
                out[sid]["moved_from"] = int(sub["moved_from"])
                out[sid]["moved_kind"] = sub.get("moved_kind", "")
            continue
        sid = ev.get("submission_id")
        rec = out.get(sid)
        if rec is None:
            continue  # transition for a submission whose intro tore
        rec["ts"][str(kind)] = ev.get("ts")
        if kind == "admitted":
            rec["state"] = ADMITTED
            rec["trial_id"] = ev.get("trial_id")
            rec["bucket"] = ev.get("bucket")
            rec["config_hash"] = ev.get("config_hash")
        elif kind == "rejected":
            rec["state"] = REJECTED
            rec["status"] = ev.get("verdict", "rejected")
            rec["error"] = ev.get("reason", "")
        elif kind == "placed":
            rec["state"] = PLACED
            rec["placements"] = rec.get("placements", 0) + 1
            rec["last_placement"] = {
                k: ev.get(k)
                for k in ("start", "size", "lanes", "stacked", "resumed")
            }
        elif kind == "unplaced":
            rec["state"] = ADMITTED
            rec["unplaced_reason"] = ev.get("reason", "")
        elif kind == "moved":
            rec["state"] = MOVED
            rec["moved_to"] = ev.get("to_shard")
            rec["moved_kind"] = ev.get("kind", "")
        elif kind == "settled":
            rec["state"] = SETTLED
            rec["status"] = ev.get("status", "?")
            rec["error"] = ev.get("error", "") or ""
    return out


@dataclass
class QueueStats:
    """Counts-by-state rollup of a fold (the console header)."""

    by_state: dict = field(default_factory=dict)
    by_tenant: dict = field(default_factory=dict)

    @classmethod
    def of(cls, folded: dict[str, dict]) -> "QueueStats":
        s = cls()
        for rec in folded.values():
            s.by_state[rec["state"]] = s.by_state.get(rec["state"], 0) + 1
            t = s.by_tenant.setdefault(rec["tenant"], {})
            t[rec["state"]] = t.get(rec["state"], 0) + 1
        return s
