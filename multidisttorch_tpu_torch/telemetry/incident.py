"""Incident plane: black-box flight recorder, root-cause detection,
and cross-surface causal autopsy.

A copy of the JAX package's ``telemetry/incident.py`` (that module
imports nothing beyond the standard library at module level), with the
same taxonomy, rules, ledger records, bundle layout and report, so
either package folds and autopsies the other's incidents. One part is
not ported (ROADMAP A.12b): the autopsy's fabric surface, the lease,
steal and topology streams of a sharded service fabric. A root that
holds a fabric directory raises ``NotImplementedError``; on any other
root the report is the JAX package's, which has no fabric surface there
either. The fabric's triggers (``shard_fence_lost``, ``shard_adopted``,
``shard_split_resolved``, ``steal_grant``, ``steal_executed``) keep
their rules, so a stream the JAX fabric wrote classifies alike.

The durable books (lease streams, journals, trace shards,
SLO alerts, preflight verdicts, ckpt scan verdicts) record *what
happened*; nothing reads across them to say *why*. This module is that
reader, in three parts:

1. **Detection** — a CLOSED taxonomy of ten incident kinds
   (:data:`KINDS`), triggered at the seams that already classify the
   underlying conditions: supervision's ``failure_classified``,
   fabric's ``shard_fence_lost`` / ``shard_adopted`` /
   ``shard_split_resolved``, membership's ``host_lost``, preflight's
   ``preflight_verdict``, slo.py's ``slo_alert`` burn-rate edges, and
   the checkpoint store's ``ckpt_scan_reject``. The
   :class:`IncidentDetector` rides the event bus as a tap (armed by
   ``telemetry.configure``), dedups repeated triggers into one
   incident, suppresses flaps (a resolve immediately followed by a
   re-fire REOPENS the same incident instead of minting a new one),
   and correlates same-subject triggers into ONE causal chain: a
   takeover's ``shard_adopted`` echo never opens a second incident
   next to the ``shard_fence_lost`` that explains it, and a more
   specific verdict (``split_torn``) escalates a less specific open
   one (``replica_lost``) in place.

2. **Black-box flight ring** — :class:`FlightRing`, an always-on
   bounded in-memory ring of the last N events this host emitted.
   Same zero-cost-when-off contract as the rest of telemetry: module
   state is ``None`` until :func:`configure`; with telemetry off no
   ring exists and the bus tap is one attribute read. The ring is
   dumped to disk ONLY when an incident opens — the seconds *before*
   detection that the durable streams alone can't reconstruct
   (flushed-not-fsync'd sinks lose the tail exactly when it matters).

3. **Causal autopsy** — :func:`build_incident_report` walks the
   durable surfaces (merged event shards, sweep ledger, lease /
   topology / steal streams, submission span trees via
   ``build_submission_traces``, fired-fault ground truth, ctlprof
   books, anomaly captures) and assembles one cross-host causal
   timeline ending in the incident's taxonomy verdict with cited
   evidence records, exported as a bundle dir (report JSON, merged
   Perfetto slice, affected-trace list, flight-ring dump).

Durability: the incident ledger (``incidents.jsonl``) is CONTROL
state, not observability — appends are fsync'd (the sweep-ledger
discipline, not the event-sink one) and the reader tolerates a torn
tail. Bundle dumps publish atomically: written under
``<id>.partial`` and renamed into place, so a SIGKILL mid-dump leaves
a valid ledger plus a quarantined ``.partial`` directory that
:func:`sweep_partial_bundles` reports (never half a bundle that looks
whole).

Proved by ``service/incident_drill.py``: one scenario per fault family
the port runs replays through a telemetry scope of its own, and every
fault must produce EXACTLY ONE incident with the correct verdict, while
a no-fault soak must produce zero.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

# Module-level clock indirection (the ctlprof discipline): every clock
# read in this module goes through _clock so the zero-cost-off test can
# patch it with a raiser and prove the off path never tells time.
_clock = time.time

INCIDENTS_NAME = "incidents.jsonl"
BUNDLE_DIRNAME = "incidents"
# The JAX package's service/fabric.py FABRIC_DIRNAME: the directory a
# sharded service fabric keeps under its root.
FABRIC_DIRNAME = "fabric"

# -- the closed taxonomy ----------------------------------------------

REPLICA_LOST = "replica_lost"          # a replica/host vanished; its
                                       # shard was adopted (epoch bump)
FENCE_LOST = "fence_lost"              # a live owner lost its lease
WEDGED_COLLECTIVE = "wedged_collective"  # AgreementTimeout/Wedged-
                                       # Collective classified
SPLIT_TORN = "split_torn"              # mid-split crash resolved by an
                                       # adopter (commit or abort)
BACKEND_WEDGED = "backend_wedged"      # preflight: unusable backend
SLO_BURN = "slo_burn"                  # burn-rate alert firing
DIVERGENCE_STORM = "divergence_storm"  # >= storm_threshold distinct
                                       # trials diverged in a window
CKPT_INTEGRITY = "ckpt_integrity"      # checkpoint scan rejected a
                                       # corrupt/torn candidate
HOST_PREEMPTED = "host_preempted"      # preemption-class failure
STEAL_ANOMALY = "steal_anomaly"        # duplicate grant / transfer
                                       # without durable grant intent

KINDS = (
    REPLICA_LOST, FENCE_LOST, WEDGED_COLLECTIVE, SPLIT_TORN,
    BACKEND_WEDGED, SLO_BURN, DIVERGENCE_STORM, CKPT_INTEGRITY,
    HOST_PREEMPTED, STEAL_ANOMALY,
)

# Same-subject specificity: when two triggers name the SAME subject
# within the correlation window they are one causal chain, and the
# more specific verdict wins. A takeover reads as fence_lost when the
# fenced owner is alive to say so (its shard_fence_lost names the
# reason), as replica_lost when only the adoption echo exists; a
# split resolution after adoption is more specific than either.
_RANK = {
    REPLICA_LOST: 1,
    FENCE_LOST: 2,
    SPLIT_TORN: 3,
    STEAL_ANOMALY: 3,
}


def _rank(kind: str) -> int:
    return _RANK.get(kind, 2)


# -- flight ring ------------------------------------------------------


class FlightRing:
    """Bounded ring of the last ``maxlen`` event dicts this host saw.

    Append is a deque append under a lock — no clock read, no I/O, no
    allocation beyond the dict the bus already built for its sink.
    Dumped only when an incident fires (:meth:`dump`)."""

    def __init__(self, maxlen: int = 512):
        self.maxlen = int(maxlen)
        self._ring: deque = deque(maxlen=self.maxlen)
        self._lock = threading.Lock()
        self.noted = 0

    def note(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)
            self.noted += 1

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, path: str, *, host: Optional[int] = None) -> None:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(
                {
                    "maxlen": self.maxlen,
                    "noted": self.noted,
                    "host": host,
                    "events": snap,
                },
                f,
            )


# -- incidents --------------------------------------------------------

OPEN = "open"
RESOLVED = "resolved"
_MAX_EVIDENCE = 8


@dataclass
class Incident:
    """One detected incident: a deduped causal chain with a taxonomy
    verdict. ``count`` is triggers absorbed; ``flaps`` is
    resolve->re-fire reopen cycles."""

    id: str
    kind: str
    subject: str
    first_ts: float
    last_ts: float
    status: str = OPEN
    count: int = 1
    flaps: int = 0
    host: Optional[int] = None
    detail: dict = field(default_factory=dict)
    evidence: list = field(default_factory=list)
    resolved_ts: Optional[float] = None
    resolved_reason: Optional[str] = None

    def to_dict(self) -> dict:
        d = {
            "id": self.id,
            "kind": self.kind,
            "subject": self.subject,
            "status": self.status,
            "first_ts": self.first_ts,
            "last_ts": self.last_ts,
            "count": self.count,
            "flaps": self.flaps,
            "detail": self.detail,
            "evidence": self.evidence,
        }
        if self.host is not None:
            d["host"] = self.host
        if self.resolved_ts is not None:
            d["resolved_ts"] = self.resolved_ts
        if self.resolved_reason is not None:
            d["resolved_reason"] = self.resolved_reason
        return d


def _fsync_append(path: str, rec: dict) -> None:
    """Ledger-discipline append: one JSON line, flushed AND fsync'd —
    an incident record is control state (the CI gate and the flap
    books read it), so losing it to a crash is not acceptable the way
    losing an event-sink tail is."""
    with open(path, "a") as f:
        f.write(json.dumps(rec, default=str) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _repair_torn_tail(path: str) -> bool:
    """Newline-terminate a torn final line so the next append starts a
    FRESH line instead of gluing valid JSON onto garbage (the
    sweep-ledger re-arm discipline). Returns True when a repair was
    made."""
    try:
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return False
            f.seek(size - 1)
            if f.read(1) != b"\n":
                f.write(b"\n")
                return True
    except OSError:
        pass
    return False


def read_incident_records(path: str) -> tuple[list[dict], int]:
    """All decodable ledger records in append order plus the torn-line
    count (same contract as ``events.read_events_counting``)."""
    recs: list[dict] = []
    torn = 0
    try:
        f = open(path)
    except OSError:
        return recs, torn
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                torn += 1
                continue
            if isinstance(rec, dict) and rec.get("rec"):
                recs.append(rec)
            else:
                torn += 1
    return recs, torn


def fold_incidents(records: list[dict]) -> dict[str, dict]:
    """Fold a ledger's open/escalate/reopen/resolve records into the
    current per-incident state, keyed by id. Records replay in append
    order; unknown record kinds are skipped (forward compat)."""
    return fold_incidents_into({}, records)


def fold_incidents_into(
    out: dict[str, dict], records: list[dict]
) -> dict[str, dict]:
    """Incremental half of :func:`fold_incidents`: replay ``records``
    onto an existing fold in place (the live-console pattern — a
    follower keeps a byte offset into the ledger and feeds only the
    new complete lines, tools/sweep_top.py's ``ServiceFollow``)."""
    for rec in records:
        r = rec.get("rec")
        iid = rec.get("id")
        if not iid:
            continue
        if r == "open":
            out[iid] = {
                "id": iid,
                "kind": rec.get("kind"),
                "subject": rec.get("subject"),
                "status": OPEN,
                "first_ts": rec.get("ts"),
                "last_ts": rec.get("ts"),
                "count": int(rec.get("count", 1)),
                "flaps": 0,
                "detail": rec.get("detail") or {},
                "evidence": list(rec.get("evidence") or ()),
            }
            if rec.get("host") is not None:
                out[iid]["host"] = rec.get("host")
        elif iid in out:
            inc = out[iid]
            if r == "escalate":
                inc["kind"] = rec.get("kind", inc["kind"])
                inc["last_ts"] = rec.get("ts", inc["last_ts"])
                inc["count"] = int(rec.get("count", inc["count"]))
                for ev in rec.get("evidence") or ():
                    if len(inc["evidence"]) < _MAX_EVIDENCE:
                        inc["evidence"].append(ev)
            elif r == "reopen":
                inc["status"] = OPEN
                inc["flaps"] = int(rec.get("flaps", inc["flaps"] + 1))
                inc["count"] = int(rec.get("count", inc["count"]))
                inc["last_ts"] = rec.get("ts", inc["last_ts"])
                inc.pop("resolved_ts", None)
                inc.pop("resolved_reason", None)
            elif r == "resolve":
                inc["status"] = RESOLVED
                inc["count"] = int(rec.get("count", inc["count"]))
                inc["flaps"] = int(rec.get("flaps", inc["flaps"]))
                inc["resolved_ts"] = rec.get("ts")
                inc["resolved_reason"] = rec.get("reason")
                inc["last_ts"] = rec.get("ts", inc["last_ts"])
    return out


def discover_incident_ledgers(root: str) -> list[str]:
    """Every ``incidents.jsonl`` under ``root`` (fleet merge outputs
    excluded, mirroring ``trace.discover_event_shards``)."""
    out: list[str] = []
    for dirpath, dirnames, names in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "fleet"]
        if INCIDENTS_NAME in names:
            out.append(os.path.join(dirpath, INCIDENTS_NAME))
    return sorted(out)


def load_incidents(root: str) -> dict[str, dict]:
    """Folded incident state across every ledger under ``root``."""
    out: dict[str, dict] = {}
    for path in discover_incident_ledgers(root):
        recs, _torn = read_incident_records(path)
        for iid, inc in fold_incidents(recs).items():
            inc["ledger"] = path
            out[iid] = inc
    return out


# -- detector ---------------------------------------------------------


class IncidentDetector:
    """Classify the event stream into taxonomy incidents.

    Fed one event dict at a time (:meth:`observe` — the bus tap calls
    it for every emit; :func:`detect_incidents` replays a recorded
    stream through the same rules). State:

    - ``_open_by_subject`` — at most ONE open incident per subject;
      same-subject triggers within ``dedup_window_s`` are absorbed
      (count++) or escalate the verdict when strictly more specific.
    - ``_recent_resolved`` — a resolve followed by a re-fire of the
      same (kind, subject) within ``flap_window_s`` REOPENS the same
      incident (flaps++) instead of minting a new id: a flapping
      lease is one flapping incident, not a ledger flood.
    - divergence storm window and the steal grant book (the two
      stateful rules).

    Timestamps come from the events themselves (falling back to the
    module clock only for synthetic records without ``ts``), so
    offline replay is deterministic.
    """

    def __init__(
        self,
        out_dir: Optional[str] = None,
        *,
        host: Optional[int] = None,
        dedup_window_s: float = 300.0,
        flap_window_s: float = 60.0,
        quiet_resolve_s: Optional[float] = None,
        storm_threshold: int = 3,
        storm_window_s: float = 120.0,
        ring: Optional[FlightRing] = None,
        emit_events: bool = True,
    ):
        self.out_dir = out_dir
        self.host = host
        self.dedup_window_s = float(dedup_window_s)
        self.flap_window_s = float(flap_window_s)
        self.quiet_resolve_s = quiet_resolve_s
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self.ring = ring
        self.emit_events = emit_events
        self.ledger_path: Optional[str] = None
        self.bundle_dir: Optional[str] = None
        self.tail_repaired = False
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self.ledger_path = os.path.join(out_dir, INCIDENTS_NAME)
            self.bundle_dir = os.path.join(out_dir, BUNDLE_DIRNAME)
            if os.path.exists(self.ledger_path):
                # Re-arm over a crashed run: heal a torn tail BEFORE
                # the first append, and resume the id sequence past
                # every id already on record (ids are never recycled).
                self.tail_repaired = _repair_torn_tail(self.ledger_path)
        self._seq = 0
        self._lock = threading.RLock()
        self._open_by_subject: dict[str, Incident] = {}
        self._recent_resolved: dict[tuple, Incident] = {}
        self._diverged: deque = deque()  # (ts, trial_id)
        self._storm_open = False
        self._grants_seen: dict[tuple, int] = {}  # (victim, seq) -> n
        self._granted_pairs: set = set()  # (victim, thief)
        self.opened = 0
        self.absorbed = 0
        if self.ledger_path is not None:
            recs, _ = read_incident_records(self.ledger_path)
            for rec in recs:
                iid = str(rec.get("id", ""))
                if iid.startswith("inc-"):
                    try:
                        self._seq = max(self._seq, int(iid.split("-")[1]))
                    except (IndexError, ValueError):
                        pass

    # -- public -------------------------------------------------------

    def observe(self, ev: dict) -> Optional[Incident]:
        """Feed one event; returns the incident it opened/updated (or
        None). Never raises — detection is observability."""
        kind = ev.get("kind")
        if not isinstance(kind, str) or kind.startswith("incident"):
            return None  # our own emissions: break the tap recursion
        try:
            return self._observe(ev, kind)
        except Exception:  # noqa: BLE001 — never kill the emitter
            return None

    def open_incidents(self) -> list[Incident]:
        with self._lock:
            return list(self._open_by_subject.values())

    def resolve_subject(
        self, subject: str, *, reason: str, ts: Optional[float] = None
    ) -> Optional[Incident]:
        """Explicitly resolve the open incident on ``subject``."""
        with self._lock:
            inc = self._open_by_subject.get(subject)
            if inc is None:
                return None
            self._resolve(inc, _clock() if ts is None else ts, reason)
            return inc

    # -- internals ----------------------------------------------------

    def _observe(self, ev: dict, kind: str) -> Optional[Incident]:
        data = ev.get("data") or {}
        ts = float(ev.get("ts", 0.0)) or _clock()
        with self._lock:
            if self.quiet_resolve_s is not None:
                self._auto_resolve(ts)
            if kind == "slo_alert" and data.get("state") == "resolved":
                subj = f"slo:{data.get('slo')}:{data.get('label')}"
                inc = self._open_by_subject.get(subj)
                if inc is not None:
                    self._resolve(inc, ts, "slo_alert resolved")
                return None
            trig = self._classify(kind, ev, data, ts)
            if trig is None:
                return None
            inc_kind, subject, detail = trig
            return self._trigger(inc_kind, subject, detail, ev, ts)

    def _classify(
        self, kind: str, ev: dict, data: dict, ts: float
    ) -> Optional[tuple]:
        """Map one event to an incident trigger (kind, subject,
        detail) — or None when it is not incident-worthy."""
        if kind == "shard_fence_lost":
            return (
                FENCE_LOST,
                f"shard:{data.get('shard')}",
                {"reason": data.get("reason"),
                 "replica": data.get("replica")},
            )
        if kind == "shard_adopted":
            # epoch 1 is a FIRST claim (normal startup); epoch >= 2
            # means a previous incarnation held this shard and is
            # gone — the adoption is the takeover's visible echo.
            if int(data.get("epoch", 1)) >= 2:
                return (
                    REPLICA_LOST,
                    f"shard:{data.get('shard')}",
                    {"adopter": data.get("replica"),
                     "epoch": data.get("epoch"),
                     "replayed": data.get("replayed_submissions")},
                )
            return None
        if kind == "host_lost":
            return (
                REPLICA_LOST,
                f"host:{data.get('slot')}",
                {"stale_s": data.get("stale_s"),
                 "world_epoch": data.get("world_epoch")},
            )
        if kind == "shard_split_resolved":
            return (
                SPLIT_TORN,
                f"shard:{data.get('shard')}",
                {"child": data.get("child"),
                 "action": data.get("action"),
                 "resolver": data.get("replica")},
            )
        if kind == "failure_classified":
            exc = str(data.get("exc_type", ""))
            cls = data.get("failure_class")
            tid = ev.get("trial_id")
            if exc in ("WedgedCollective", "AgreementTimeout"):
                return (
                    WEDGED_COLLECTIVE,
                    f"trial:{tid if tid is not None else '?'}",
                    {"exc_type": exc, "error": data.get("error")},
                )
            if cls == "preemption":
                return (
                    HOST_PREEMPTED,
                    f"trial:{tid if tid is not None else '?'}",
                    {"exc_type": exc, "error": data.get("error")},
                )
            if cls == "divergence":
                return self._storm(tid, ts, data)
            return None
        if kind == "preflight_verdict":
            if data.get("usable") is False:
                return (
                    BACKEND_WEDGED,
                    f"backend:{data.get('platform', 'default')}",
                    {"verdict": data.get("verdict"),
                     "reason": data.get("reason")},
                )
            return None
        if kind == "slo_alert":
            if data.get("state") == "firing":
                detail = {"burn": data.get("burn"),
                          "compliance": data.get("compliance")}
                if data.get("exemplar") is not None:
                    detail["exemplar"] = data.get("exemplar")
                return (
                    SLO_BURN,
                    f"slo:{data.get('slo')}:{data.get('label')}",
                    detail,
                )
            return None
        if kind == "ckpt_scan_reject":
            path = str(data.get("path", ""))
            return (
                CKPT_INTEGRITY,
                f"ckpt:{os.path.dirname(path) or path}",
                {"path": path, "reason": data.get("reason")},
            )
        if kind == "steal_grant":
            victim = data.get("victim_shard")
            seq = data.get("seq")
            key = (victim, seq)
            n = self._grants_seen.get(key, 0) + 1
            self._grants_seen[key] = n
            self._granted_pairs.add((victim, data.get("thief_shard")))
            if n > 1:
                # The steal file is append-only and grants are keyed
                # by request seq: a SECOND grant for the same seq
                # means two incarnations both answered — fencing
                # failed somewhere.
                return (
                    STEAL_ANOMALY,
                    f"shard:{victim}",
                    {"why": "duplicate_grant", "seq": seq,
                     "grants": n},
                )
            return None
        if kind == "steal_executed":
            victim = data.get("victim_shard")
            pair = (victim, data.get("thief_shard"))
            if pair not in self._granted_pairs:
                # A transfer with no durable grant intent on record:
                # the exactly-once handoff proof is broken.
                return (
                    STEAL_ANOMALY,
                    f"shard:{victim}",
                    {"why": "executed_without_grant",
                     "thief_shard": data.get("thief_shard"),
                     "sub_ids": data.get("sub_ids")},
                )
            return None
        return None

    def _storm(self, tid, ts: float, data: dict) -> Optional[tuple]:
        """A single divergence is routine HPO attrition (terminal,
        not retried — docs/RESILIENCE.md); >= storm_threshold DISTINCT
        trials diverging within storm_window_s is a sweep-level signal
        (poisoned data shard, bad shared schedule) worth an incident."""
        while self._diverged and ts - self._diverged[0][0] > self.storm_window_s:
            self._diverged.popleft()
        self._diverged.append((ts, tid))
        distinct = {t for _, t in self._diverged}
        if len(distinct) >= self.storm_threshold:
            return (
                DIVERGENCE_STORM,
                "sweep",
                {"trials": sorted(
                    (t for t in distinct if t is not None),
                    key=str,
                ),
                    "window_s": self.storm_window_s},
            )
        return None

    def _trigger(
        self, kind: str, subject: str, detail: dict, ev: dict, ts: float
    ) -> Incident:
        inc = self._open_by_subject.get(subject)
        if inc is not None and ts - inc.last_ts <= self.dedup_window_s:
            inc.count += 1
            inc.last_ts = ts
            self.absorbed += 1
            if len(inc.evidence) < _MAX_EVIDENCE:
                inc.evidence.append(ev)
            if _rank(kind) > _rank(inc.kind):
                # Same causal chain, more specific verdict: escalate
                # in place (durable record keeps the history).
                inc.kind = kind
                inc.detail.update(detail)
                self._append(
                    {
                        "rec": "escalate",
                        "id": inc.id,
                        "kind": kind,
                        "ts": ts,
                        "count": inc.count,
                        "evidence": [ev],
                    }
                )
                self._emit_incident(inc, "escalated")
            return inc
        prev = self._recent_resolved.get((kind, subject))
        if (
            prev is not None
            and prev.resolved_ts is not None
            and ts - prev.resolved_ts <= self.flap_window_s
        ):
            prev.status = OPEN
            prev.flaps += 1
            prev.count += 1
            prev.last_ts = ts
            prev.resolved_ts = None
            prev.resolved_reason = None
            if len(prev.evidence) < _MAX_EVIDENCE:
                prev.evidence.append(ev)
            del self._recent_resolved[(kind, subject)]
            self._open_by_subject[subject] = prev
            self._append(
                {
                    "rec": "reopen",
                    "id": prev.id,
                    "ts": ts,
                    "flaps": prev.flaps,
                    "count": prev.count,
                }
            )
            self._emit_incident(prev, "reopened")
            return prev
        self._seq += 1
        inc = Incident(
            id=f"inc-{self._seq:04d}",
            kind=kind,
            subject=subject,
            first_ts=ts,
            last_ts=ts,
            host=self.host,
            detail=dict(detail),
            evidence=[ev],
        )
        self._open_by_subject[subject] = inc
        self.opened += 1
        self._append(
            {
                "rec": "open",
                "id": inc.id,
                "kind": kind,
                "subject": subject,
                "ts": ts,
                "host": self.host,
                "detail": inc.detail,
                "evidence": [ev],
            }
        )
        self._dump_bundle(inc, ev)
        self._emit_incident(inc, "opened")
        return inc

    def _resolve(self, inc: Incident, ts: float, reason: str) -> None:
        inc.status = RESOLVED
        inc.resolved_ts = ts
        inc.resolved_reason = reason
        self._open_by_subject.pop(inc.subject, None)
        self._recent_resolved[(inc.kind, inc.subject)] = inc
        self._append(
            {
                "rec": "resolve",
                "id": inc.id,
                "ts": ts,
                "reason": reason,
                "count": inc.count,
                "flaps": inc.flaps,
            }
        )
        self._emit_incident(inc, "resolved")

    def _auto_resolve(self, now: float) -> None:
        quiet = self.quiet_resolve_s
        if quiet is None:
            return
        for inc in list(self._open_by_subject.values()):
            if now - inc.last_ts > quiet:
                self._resolve(inc, now, f"quiet for > {quiet}s")

    def _append(self, rec: dict) -> None:
        if self.ledger_path is None:
            return
        try:
            _fsync_append(self.ledger_path, rec)
        except OSError:
            # Full disk degrades to in-memory incidents, never a
            # crashed sweep (the event-sink discipline).
            self.ledger_path = None

    def _emit_incident(self, inc: Incident, what: str) -> None:
        if not self.emit_events:
            return
        from multidisttorch_tpu_torch.telemetry.events import get_bus

        bus = get_bus()
        if bus is None:
            return
        # observe() ignores incident* kinds BEFORE taking the lock, so
        # this re-entrant emit (bus tap -> observe) cannot deadlock.
        bus.emit(
            "incident",
            incident_id=inc.id,
            incident_kind=inc.kind,
            subject=inc.subject,
            status=what,
            count=inc.count,
            flaps=inc.flaps,
        )

    def _dump_bundle(self, inc: Incident, ev: dict) -> None:
        """Black-box dump at fire time, atomically published: write
        under ``<id>.partial`` then rename. A SIGKILL mid-dump leaves
        the ``.partial`` dir for :func:`sweep_partial_bundles` to
        quarantine — never a half-bundle that looks whole."""
        if self.bundle_dir is None:
            return
        try:
            final = os.path.join(self.bundle_dir, inc.id)
            part = final + ".partial"
            os.makedirs(part, exist_ok=True)
            if self.ring is not None:
                self.ring.dump(
                    os.path.join(part, "flight_ring.json"),
                    host=self.host,
                )
            stall = os.environ.get("MDT_INCIDENT_DUMP_STALL")
            if stall:
                # Test seam (SIGKILL-mid-dump drill): hold the bundle
                # in its .partial state so the parent can kill us
                # between the ring dump and the publish rename.
                time.sleep(float(stall))
            with open(os.path.join(part, "trigger.json"), "w") as f:
                json.dump(
                    {"incident": inc.to_dict(), "trigger_event": ev}, f
                )
            os.replace(part, final)
        except OSError:
            pass


def detect_incidents(events: list[dict], **kw) -> dict[str, dict]:
    """Offline detection: replay a recorded event stream (ts-sorted)
    through the live rules. Returns folded incident state keyed by id
    — the post-hoc half of the same classifier the bus tap runs."""
    det = IncidentDetector(None, emit_events=False, **kw)
    for ev in sorted(events, key=lambda e: float(e.get("ts", 0.0))):
        det.observe(ev)
    out: dict[str, dict] = {}
    with det._lock:
        seen: dict[str, Incident] = {}
        for inc in det._open_by_subject.values():
            seen[inc.id] = inc
        for inc in det._recent_resolved.values():
            seen.setdefault(inc.id, inc)
        for iid in sorted(seen):
            out[iid] = seen[iid].to_dict()
    return out


def sweep_partial_bundles(out_dir: str) -> list[str]:
    """Quarantine torn bundle dumps: any ``*.partial`` under the
    bundle dir (a crash between dump and publish) is renamed to
    ``*.quarantined`` so readers can never mistake it for a whole
    bundle. Returns the quarantined paths."""
    bdir = os.path.join(out_dir, BUNDLE_DIRNAME)
    out: list[str] = []
    try:
        names = os.listdir(bdir)
    except OSError:
        return out
    for n in sorted(names):
        if not n.endswith(".partial"):
            continue
        src = os.path.join(bdir, n)
        dst = os.path.join(
            bdir, n[: -len(".partial")] + ".quarantined"
        )
        try:
            os.replace(src, dst)
            out.append(dst)
        except OSError:
            pass
    return out


# -- module state (zero-cost-when-off) --------------------------------

_ring: Optional[FlightRing] = None
_detector: Optional[IncidentDetector] = None


def get_flight_ring() -> Optional[FlightRing]:
    """The active flight ring, or None when telemetry is off."""
    return _ring


def get_detector() -> Optional[IncidentDetector]:
    """The active incident detector, or None when telemetry is off."""
    return _detector


def configure(
    out_dir: Optional[str] = None,
    *,
    host: Optional[int] = None,
    ring_max: int = 512,
    **detector_kw,
) -> Callable[[dict], None]:
    """Arm the flight ring + detector; returns the bus-tap callable
    (``telemetry.configure`` installs it on the bus). With
    ``out_dir=None`` detection runs in memory only (no ledger, no
    bundles) — the ring still records."""
    global _ring, _detector
    _ring = FlightRing(maxlen=ring_max)
    _detector = IncidentDetector(
        out_dir, host=host, ring=_ring, **detector_kw
    )
    return _tap


def disable() -> None:
    global _ring, _detector
    _ring = None
    _detector = None


def _tap(rec: dict) -> None:
    """The bus tap: every emitted event lands in the flight ring and
    the detector. Reads module state (not closure state) so a
    disable() mid-flight degrades to a no-op."""
    ring = _ring
    if ring is not None:
        ring.note(rec)
    det = _detector
    if det is not None:
        det.observe(rec)


# -- causal autopsy ---------------------------------------------------


def _surface(timeline: list, source: str, ts, rec: dict, **tags) -> None:
    try:
        ts = float(ts)
    except (TypeError, ValueError):
        return
    entry = {"ts": ts, "source": source, "rec": rec}
    entry.update({k: v for k, v in tags.items() if v is not None})
    timeline.append(entry)


def _read_jsonl_soft(path: str) -> list[dict]:
    out: list[dict] = []
    try:
        f = open(path)
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def _subject_ids(incident: dict) -> tuple[Optional[int], set]:
    """(shard, trial_ids) named by the incident's subject+evidence."""
    subject = str(incident.get("subject", ""))
    shard = None
    if subject.startswith("shard:"):
        try:
            shard = int(subject.split(":", 1)[1])
        except ValueError:
            pass
    trials: set = set()
    if subject.startswith("trial:"):
        try:
            trials.add(int(subject.split(":", 1)[1]))
        except ValueError:
            pass
    for ev in incident.get("evidence") or ():
        tid = ev.get("trial_id")
        if tid is not None:
            trials.add(tid)
        for t in (ev.get("data") or {}).get("trials") or ():
            trials.add(t)
    return shard, trials


# Event kinds always worth a timeline row when they land in the
# incident's window, subject match or not — they are the causal
# vocabulary of the recovery chain itself.
_CHAIN_KINDS = frozenset({
    "shard_fence_lost", "shard_adopted", "shard_claimed",
    "shard_released", "shard_split_begin", "shard_split_commit",
    "shard_split_abort", "shard_split_resolved", "steal_request",
    "steal_grant", "steal_executed", "failure_classified",
    "fault_injected", "host_lost", "world_shrunk", "world_grew",
    "preflight_verdict", "slo_alert", "ckpt_scan_reject",
    "incident", "incident_resolved",
})


def build_incident_report(
    root: str,
    incident,
    out_dir: Optional[str] = None,
    *,
    window_s: float = 120.0,
    max_timeline: int = 500,
) -> dict:
    """Cross-surface causal autopsy for one incident.

    ``incident`` is an incident id (looked up across the ledgers under
    ``root``) or an already-folded incident dict. Walks every durable
    surface best-effort — merged event shards, the sweep ledger, the
    subject shard's lease/steal streams and the topology log,
    submission span trees, fired-fault ground truth, ctlprof books,
    anomaly captures, the fire-time flight-ring dump — and assembles
    one ts-sorted causal timeline ending in the taxonomy verdict with
    its cited evidence. When ``out_dir`` is given (default: the
    incident's bundle dir when one exists) the report is exported as a
    bundle: ``report.json``, ``perfetto.json`` (one track per
    source), ``affected_traces.json``, plus whatever the fire-time
    dump already published."""
    from multidisttorch_tpu_torch.telemetry import trace as ttrace

    if isinstance(incident, str):
        folded = load_incidents(root)
        if incident not in folded:
            raise KeyError(
                f"incident {incident!r} not found under {root!r} "
                f"(known: {sorted(folded)})"
            )
        incident = folded[incident]
    inc = dict(incident)
    t_lo = float(inc.get("first_ts") or 0.0) - window_s
    t_hi = float(inc.get("last_ts") or inc.get("first_ts") or 0.0) + window_s
    shard, trials = _subject_ids(inc)
    surfaces: dict = {}
    timeline: list[dict] = []

    # 1) merged event shards (cross-host, ts-sorted). The trace-layer
    # discovery keys on telemetry/ subdirs (the run-dir layout); the
    # incident ledger lands NEXT TO its event sink by construction
    # (telemetry.configure shares out_dir), so shards beside each
    # discovered ledger are folded in too — pointing the autopsy at a
    # bare telemetry dir must not lose the stream that fed the
    # detector.
    try:
        events = ttrace.load_merged_events(root)
        seen_paths = {
            os.path.abspath(p)
            for p in ttrace.discover_event_shards(root)
        }
        from multidisttorch_tpu_torch.telemetry.events import read_events

        for led in discover_incident_ledgers(root):
            ldir = os.path.dirname(led)
            try:
                names = sorted(os.listdir(ldir))
            except OSError:
                continue
            for name in names:
                if not (
                    name.startswith("events") and name.endswith(".jsonl")
                ):
                    continue
                p = os.path.abspath(os.path.join(ldir, name))
                if p in seen_paths:
                    continue
                seen_paths.add(p)
                events.extend(read_events(p))
        events.sort(key=lambda e: float(e.get("ts", 0.0)))
    except Exception:  # noqa: BLE001 — every surface is best-effort
        events = []
    n_win = 0
    for ev in events:
        ts = float(ev.get("ts", 0.0))
        if ts < t_lo or ts > t_hi:
            continue
        n_win += 1
        relevant = ev.get("kind") in _CHAIN_KINDS
        if not relevant and trials and ev.get("trial_id") in trials:
            relevant = True
        if not relevant and shard is not None:
            d = ev.get("data") or {}
            if d.get("shard") == shard or d.get("victim_shard") == shard:
                relevant = True
        if relevant:
            _surface(
                timeline, "events", ts, ev, host=ev.get("host"),
            )
    surfaces["events"] = {
        "shards": len(ttrace.discover_event_shards(root)),
        "in_window": n_win,
    }

    # 2) sweep ledger (trial settlement ground truth)
    try:
        from multidisttorch_tpu_torch.hpo.ledger import LEDGER_NAME

        lrecs = _read_jsonl_soft(os.path.join(root, LEDGER_NAME))
        picked = 0
        for rec in lrecs:
            ts = rec.get("ts")
            tid = rec.get("trial_id")
            if ts is None:
                continue
            if (trials and tid in trials) or (
                not trials and t_lo <= float(ts) <= t_hi
            ):
                _surface(timeline, "ledger", ts, rec)
                picked += 1
        surfaces["ledger"] = {"records": len(lrecs), "cited": picked}
    except Exception:  # noqa: BLE001
        surfaces["ledger"] = {"records": 0, "cited": 0}

    # 3) fabric streams for the subject shard (lease, steal, topology):
    # the sharded fabric is ROADMAP A.12b, not ported. A root that holds
    # one raises rather than autopsying it without those surfaces.
    for sdir in {root, *ttrace.service_dirs_of(root)}:
        if os.path.isdir(os.path.join(sdir, FABRIC_DIRNAME)):
            raise NotImplementedError(
                f"{sdir!r} holds a service fabric: its lease, steal and "
                "topology surfaces are not ported (ROADMAP A.12b)"
            )

    # 4) submission span trees — affected = overlapping the window or
    # naming an involved trial
    affected: list[dict] = []
    try:
        traces = ttrace.build_submission_traces(root, events=events)
        for sid, tr in traces.items():
            spans = tr.get("spans") or []
            if not spans:
                continue
            s0 = min(float(s.get("start", 0.0)) for s in spans)
            ends = [s.get("end") for s in spans]
            s1 = max(
                (float(e) for e in ends if e is not None), default=s0
            )
            overlap = s0 <= t_hi and s1 >= t_lo
            named = trials and tr.get("trial_id") in trials
            if overlap or named:
                affected.append(
                    {
                        "submission_id": sid,
                        "trial_id": tr.get("trial_id"),
                        "tenant": tr.get("tenant"),
                        "start": s0,
                        "end": s1,
                        "spans": len(spans),
                        "open_spans": tr.get("open_spans"),
                        "fence_epochs": tr.get("fence_epochs"),
                    }
                )
        surfaces["traces"] = {
            "total": len(traces), "affected": len(affected),
        }
    except Exception:  # noqa: BLE001
        surfaces["traces"] = {"total": 0, "affected": 0}

    # 5) fired-fault ground truth (the chaos harness's durable log)
    try:
        from multidisttorch_tpu_torch.telemetry import fleet as tfleet

        fired = tfleet.fired_faults(root)
        for rec in fired:
            _surface(timeline, "fault", rec.get("ts"), rec)
        surfaces["fired_faults"] = {"records": len(fired)}
    except Exception:  # noqa: BLE001
        surfaces["fired_faults"] = {"records": 0}

    # 6) ctlprof books (worst control pass) + anomaly captures
    ctl_books = None
    for sdir in [root] + list(ttrace.service_dirs_of(root)):
        p = os.path.join(sdir, "service_books.json")
        try:
            with open(p) as f:
                books = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        ctl = books.get("ctl")
        if ctl:
            ctl_books = {"path": p, "worst_pass": ctl.get("worst_pass")}
            break
    surfaces["ctlprof"] = ctl_books or {}
    captures: list[str] = []
    for dirpath, _dn, names in os.walk(root):
        if os.path.basename(dirpath) == "anomaly_traces":
            captures.extend(os.path.join(dirpath, n) for n in names)
    surfaces["anomaly_captures"] = {"files": sorted(captures)}

    # 7) the fire-time flight-ring dump (bundle), if one was published
    ring_dump = None
    for led in discover_incident_ledgers(root):
        cand = os.path.join(
            os.path.dirname(led), BUNDLE_DIRNAME, str(inc.get("id", "")),
            "flight_ring.json",
        )
        if os.path.exists(cand):
            ring_dump = cand
            break
    surfaces["flight_ring"] = {"dump": ring_dump}

    timeline.sort(key=lambda e: e["ts"])
    if len(timeline) > max_timeline:
        # Keep the edges (the causal chain lives there) and note the
        # elision instead of silently truncating the middle.
        keep = max_timeline // 2
        elided = len(timeline) - 2 * keep
        timeline = timeline[:keep] + timeline[-keep:]
    else:
        elided = 0

    corroborated = sorted(
        k for k, v in surfaces.items()
        if any(bool(x) for x in v.values())
    ) if surfaces else []
    report = {
        "incident": inc,
        "verdict": inc.get("kind"),
        "subject": inc.get("subject"),
        "window": {"lo": t_lo, "hi": t_hi, "pad_s": window_s},
        "evidence": inc.get("evidence") or [],
        "surfaces": surfaces,
        "corroborating_surfaces": corroborated,
        "timeline": timeline,
        "timeline_elided": elided,
        "affected_traces": affected,
    }

    if out_dir is None and ring_dump is not None:
        out_dir = os.path.dirname(ring_dump)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        with open(os.path.join(out_dir, "perfetto.json"), "w") as f:
            json.dump(_perfetto_slice(inc, timeline), f)
        with open(
            os.path.join(out_dir, "affected_traces.json"), "w"
        ) as f:
            json.dump(affected, f, indent=1, default=str)
        report["bundle_dir"] = out_dir
    return report


def _perfetto_slice(inc: dict, timeline: list[dict]) -> dict:
    """The timeline as a Chrome/Perfetto trace: one thread track per
    surface, one instant event per record, plus one duration slice
    spanning the incident itself — drop it next to the exported
    submission traces and the causal chain lines up on the same
    clock (ms since the window start)."""
    if timeline:
        t0 = min(e["ts"] for e in timeline)
    else:
        t0 = float(inc.get("first_ts") or 0.0)
    sources = sorted({e["source"] for e in timeline})
    tids = {s: i + 2 for i, s in enumerate(sources)}
    evs: list[dict] = [
        {
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": f"incident {inc.get('id')}"},
        },
        {
            "name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
            "args": {"name": "incident"},
        },
    ]
    for s, tid in tids.items():
        evs.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": s},
        })
    first = float(inc.get("first_ts") or t0)
    last = float(inc.get("last_ts") or first)
    evs.append({
        "name": f"{inc.get('kind')} [{inc.get('subject')}]",
        "ph": "X", "pid": 1, "tid": 1,
        "ts": (first - t0) * 1e6,
        "dur": max((last - first) * 1e6, 1.0),
        "args": {"id": inc.get("id"), "count": inc.get("count"),
                 "flaps": inc.get("flaps")},
    })
    for e in timeline:
        rec = e["rec"]
        name = rec.get("kind") or rec.get("event") or rec.get(
            "state", e["source"]
        )
        evs.append({
            "name": str(name),
            "ph": "i", "s": "t", "pid": 1, "tid": tids[e["source"]],
            "ts": (e["ts"] - t0) * 1e6,
            "args": {
                k: v for k, v in rec.items()
                if isinstance(v, (str, int, float, bool))
            },
        })
    return {"traceEvents": evs, "displayTimeUnit": "ms"}
