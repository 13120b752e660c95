"""Fleet observability: merge per-host telemetry shards into one story.

A copy of ``multidisttorch_tpu/telemetry/fleet.py`` (that module imports no
jax, but its package does on import), folding the same files the same way,
so either package's merge reads the other's run directory alike. It reads
through the port's ``telemetry/export.py``, ``telemetry/events.py``,
``parallel/membership.py`` and ``hpo/supervision.py::SETTLED_STATUSES``.

A multi-host elastic sweep writes telemetry the only way a crashing fleet
safely can: every process appends to its own JSONL shard
(``{run_dir}/telemetry/w{epoch}/events*.jsonl`` per world, plus the
supervisor's ``sup/`` stream), flushed per event and torn-tail tolerant.
This module builds the one timeline a fleet question needs:

- **Shard discovery and merge** (:func:`merge_fleet`): every shard under
  ``{run_dir}/telemetry`` folded (undecodable lines skipped and counted per
  shard), ordered on a corrected global clock, written as
  ``telemetry/fleet/fleet_events.jsonl``. Events carry their writer's
  ``host`` / ``world`` bus tags (``telemetry/events.py``); untagged events
  are the supervisor's.
- **Clock skew** (:func:`skew_anchors` / :func:`skew_from_anchors`): each
  host's heartbeat lease record's wall ``ts`` is written as the filesystem
  stamps the file's mtime, so ``mtime - newest_lease.ts`` is that host's
  offset to the shared filesystem clock; the supervisor anchors through
  ``worlds.jsonl``. Offsets under ``min_skew_s`` (0.25 s, one heartbeat)
  clamp to zero, so a one-machine fleet merges as an identity. Each lease
  pairs ``ts`` with a monotonic ``mono``: a wall-clock step mid-run is
  reported (``wall_clock_steps``), not folded.
- **Fleet trace** (:func:`build_fleet_trace`): one Perfetto process per
  host plus the supervisor's, per-trial tracks, world spans from
  ``worlds.jsonl`` and flow arrows along each migrated trial's lineage.
- **Restart tax** (:func:`restart_tax_report`): per world transition,
  detect / drain / relaunch (the supervisor's live ``restart_tax`` event)
  joined with restore and first useful step from the workers' streams.
- **Fleet summary** (:func:`fleet_summary` / :func:`export_fleet`):
  per-host health, per-world goodput, migration lineage, preflight
  verdicts and the fired-fault cross-check, as ``fleet_summary.json``.

A live control-plane profiler (``telemetry/ctlprof.py``; the process is
the sweep service's daemon) adds its pass ring to the fleet trace as a
track of its own, as in the JAX package. Nothing here touches torch or a
device.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Optional

from multidisttorch_tpu_torch.hpo.supervision import SETTLED_STATUSES
from multidisttorch_tpu_torch.parallel import membership
from multidisttorch_tpu_torch.telemetry import export as _export

FLEET_DIRNAME = "fleet"
FLEET_EVENTS_NAME = "fleet_events.jsonl"
FLEET_TRACE_NAME = "fleet_trace.json"
FLEET_SUMMARY_NAME = "fleet_summary.json"

# One heartbeat interval: the fs-mtime anchor's noise floor. Offsets
# smaller than this are measurement noise on a healthy fleet (flush
# latency, fs timestamp granularity) — clamping them to zero keeps a
# same-clock merge bit-deterministic instead of jittering event order
# by microseconds of false correction.
DEFAULT_MIN_SKEW_S = 0.25

# A wall-vs-monotonic delta disagreement larger than this between two
# consecutive heartbeats is a wall-clock step, not drift.
WALL_STEP_THRESHOLD_S = 0.5

_SUP = "sup"  # skew-table key for the supervisor's (untagged) stream
_WORLD_DIR_RE = re.compile(r"^w(\d+)$")


def telemetry_root(run_dir: str) -> str:
    return os.path.join(run_dir, "telemetry")


def fleet_dir(run_dir: str) -> str:
    return os.path.join(telemetry_root(run_dir), FLEET_DIRNAME)


# --------------------------------------------------------------------
# shard discovery + torn-tolerant counting reads
# --------------------------------------------------------------------


def discover_shards(run_dir: str) -> list[str]:
    """Every per-process event shard under ``{run_dir}/telemetry``
    (``events*.jsonl``, any depth), deterministically ordered. The
    fleet output directory itself is excluded so re-merges never fold
    their own previous output back in."""
    root = telemetry_root(run_dir)
    out: list[str] = []
    skip = fleet_dir(run_dir)
    for dirpath, dirnames, names in os.walk(root):
        if os.path.abspath(dirpath) == os.path.abspath(skip):
            dirnames[:] = []
            continue
        for name in names:
            if name.startswith("events") and name.endswith(".jsonl"):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def read_shard(path: str) -> tuple[list[dict], int]:
    """All decodable events of one shard in append order, plus the
    count of skipped undecodable (torn/garbled) lines — the merge
    reports what it dropped instead of silently absorbing it. (The
    single-stream readers share the same implementation.)"""
    from multidisttorch_tpu_torch.telemetry.events import read_events_counting

    return read_events_counting(path)


# --------------------------------------------------------------------
# clock-skew anchors
# --------------------------------------------------------------------


def _anchor_of(path: str, newest_ts: Optional[float]) -> Optional[dict]:
    if newest_ts is None:
        return None
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return None
    return {
        "path": path,
        "mtime": mtime,
        "newest_ts": float(newest_ts),
        "offset_raw_s": mtime - float(newest_ts),
    }


def _wall_step_diagnostics(records: list[dict]) -> dict:
    """Scan a lease stream's paired (ts, mono) anchors for wall-clock
    steps: consecutive records whose wall delta disagrees with their
    monotonic delta."""
    steps = 0
    max_drift = 0.0
    prev = None
    for rec in records:
        ts, mono = rec.get("ts"), rec.get("mono")
        if ts is None or mono is None:
            prev = None
            continue
        if prev is not None:
            drift = abs(
                (float(ts) - prev[0]) - (float(mono) - prev[1])
            )
            max_drift = max(max_drift, drift)
            if drift > WALL_STEP_THRESHOLD_S:
                steps += 1
        prev = (float(ts), float(mono))
    return {
        "wall_clock_steps": steps,
        "max_wall_mono_drift_s": round(max_drift, 4),
    }


def skew_anchors(run_dir: str) -> dict:
    """Per-writer clock anchors: for every host slot, the lease file's
    ``(mtime, newest record ts)`` pair plus wall/mono step diagnostics;
    for the supervisor, the same pair off ``worlds.jsonl``. Keys are
    host slots (int) and ``"sup"``."""
    anchors: dict = {}
    view = membership.MembershipView(run_dir)
    for slot in view.slots():
        path = membership.lease_path(run_dir, slot)
        rec = membership.latest_lease(path)
        a = _anchor_of(path, rec.get("ts") if rec else None)
        if a is not None:
            a.update(_wall_step_diagnostics(membership.read_lease(path)))
            anchors[slot] = a
    worlds_path = os.path.join(
        membership.membership_dir(run_dir), membership.WORLDS_NAME
    )
    worlds = membership.read_lease(worlds_path)
    if worlds:
        a = _anchor_of(worlds_path, worlds[-1].get("ts"))
        if a is not None:
            anchors[_SUP] = a
    return anchors


def skew_from_anchors(
    offsets_raw: dict, *, min_skew_s: float = DEFAULT_MIN_SKEW_S
) -> dict:
    """Applied per-writer corrections from raw fs-clock offsets: each
    writer's events get ``ts + offset`` so every stream lands on the
    shared filesystem clock; sub-noise offsets clamp to zero. Pure —
    the determinism tests drive it with fabricated anchors."""
    return {
        key: (float(off) if abs(float(off)) >= min_skew_s else 0.0)
        for key, off in offsets_raw.items()
    }


# --------------------------------------------------------------------
# the merge
# --------------------------------------------------------------------


def merge_fleet(
    run_dir: str,
    *,
    min_skew_s: float = DEFAULT_MIN_SKEW_S,
    apply_skew: bool = True,
) -> dict:
    """Fold every telemetry shard under ``run_dir`` into one
    skew-corrected, deterministically ordered timeline.

    Returns ``{"events", "shards", "skew", "worlds", "expected_hosts",
    "hosts_seen", "all_hosts_traced", "torn_lines_total"}``. Events
    whose clock was corrected keep their original stamp in
    ``ts_raw``. Ties order by (host, shard path, shard index), so two
    merges of the same bytes produce the same bytes."""
    root = telemetry_root(run_dir)
    shards_info: list[dict] = []
    tagged: list[tuple[dict, str, int]] = []
    for path in discover_shards(run_dir):
        events, torn = read_shard(path)
        rel = os.path.relpath(path, root)
        # World fallback from the per-world shard directory (w{epoch})
        # for any event whose writer predates (or lost) its env tag.
        m = _WORLD_DIR_RE.match(os.path.basename(os.path.dirname(path)))
        dir_world = int(m.group(1)) if m else None
        hosts_in, worlds_in = set(), set()
        for idx, ev in enumerate(events):
            if ev.get("world") is None and dir_world is not None:
                ev = {**ev, "world": dir_world}
            if ev.get("host") is not None:
                hosts_in.add(int(ev["host"]))
            if ev.get("world") is not None:
                worlds_in.add(int(ev["world"]))
            tagged.append((ev, rel, idx))
        shards_info.append(
            {
                "shard": rel,
                "events": len(events),
                "torn_lines": torn,
                "hosts": sorted(hosts_in),
                "worlds": sorted(worlds_in),
            }
        )

    anchors = skew_anchors(run_dir)
    offsets = (
        skew_from_anchors(
            {k: a["offset_raw_s"] for k, a in anchors.items()},
            min_skew_s=min_skew_s,
        )
        if apply_skew
        else {}
    )
    sup_off = offsets.get(_SUP, 0.0)
    merged: list[tuple[float, int, str, int, dict]] = []
    for ev, rel, idx in tagged:
        host = ev.get("host")
        # An anchorless host (lease file lost) gets NO correction —
        # falling back to another writer's offset would shift a
        # possibly-aligned clock by an unrelated machine's skew.
        off = offsets.get(host, 0.0) if host is not None else sup_off
        ts = float(ev.get("ts", 0.0))
        if off:
            ev = {**ev, "ts": ts + off, "ts_raw": ts}
            ts = ts + off
        merged.append((ts, -1 if host is None else int(host), rel, idx, ev))
    merged.sort(key=lambda t: t[:4])
    events = [t[4] for t in merged]

    worlds = membership.world_history(run_dir)
    expected = sorted({h for w in worlds for h in w.get("hosts", [])})
    seen = sorted({int(e["host"]) for e in events if e.get("host") is not None})
    skew_table = {
        str(k): {
            **{
                kk: vv
                for kk, vv in a.items()
                if kk != "path"
            },
            "applied_offset_s": offsets.get(k, 0.0),
        }
        for k, a in anchors.items()
    }
    return {
        "events": events,
        "shards": shards_info,
        "skew": skew_table,
        "worlds": worlds,
        "expected_hosts": expected,
        "hosts_seen": seen,
        "all_hosts_traced": (
            set(expected).issubset(seen) if expected else None
        ),
        "torn_lines_total": sum(s["torn_lines"] for s in shards_info),
    }


# --------------------------------------------------------------------
# lineage, restart tax, per-world goodput
# --------------------------------------------------------------------

# Kinds that identify a trial's OWNING host in a world. Epoch-loop and
# checkpoint events only ever fire on the owner; attempt events weigh
# less because multi-controller peers can echo them for ledger-skipped
# trials.
_OWNER_KINDS = {
    "epoch": 10,
    "ckpt_save": 10,
    "ckpt_restore": 10,
    "attempt_start": 1,
    "attempt_end": 1,
}


def trial_lineage(events: list[dict]) -> dict[int, list[dict]]:
    """Per trial, the (world -> owning host) chain: which host carried
    the trial in each world epoch, by weighted vote over owner-grade
    events. The cross-migration lineage the fleet trace draws arrows
    for."""
    votes: dict[int, dict[int, dict[int, float]]] = {}
    spans: dict[tuple[int, int], list[float]] = {}
    for ev in events:
        tid, w, h = ev.get("trial_id"), ev.get("world"), ev.get("host")
        weight = _OWNER_KINDS.get(str(ev.get("kind")))
        if tid is None or w is None or h is None or weight is None:
            continue
        tid, w, h = int(tid), int(w), int(h)
        votes.setdefault(tid, {}).setdefault(w, {})
        votes[tid][w][h] = votes[tid][w].get(h, 0.0) + weight
        ts = float(ev.get("ts", 0.0))
        lo_hi = spans.setdefault((tid, w), [ts, ts])
        lo_hi[0] = min(lo_hi[0], ts)
        lo_hi[1] = max(lo_hi[1], ts)
    out: dict[int, list[dict]] = {}
    for tid, by_world in votes.items():
        chain = []
        for w in sorted(by_world):
            host = max(
                sorted(by_world[w]), key=lambda h: by_world[w][h]
            )
            lo, hi = spans[(tid, w)]
            chain.append(
                {
                    "world": w,
                    "host": host,
                    "first_ts": lo,
                    "last_ts": hi,
                }
            )
        out[tid] = chain
    return out


def migrated_trials(lineage: dict) -> list:
    """Trial ids whose OWNING HOST changed across worlds — THE
    definition of migration (a same-host resume in a new world is
    lineage, not migration). Every consumer (fleet console, bench
    gate, CI assert) reads it from ``fleet_summary.json`` so there is
    exactly one authority. Accepts int- or str-keyed lineage; returns
    the keys as given, numerically ordered."""
    return sorted(
        (
            tid
            for tid, chain in lineage.items()
            if len({c["host"] for c in chain}) > 1
        ),
        key=int,
    )


def per_world_books(events: list[dict]) -> dict:
    """Goodput fold per world epoch: useful (settled-attempt) vs
    executed optimizer steps off ``attempt_end`` summaries,
    deduplicated by (trial, attempt, status) so multi-controller
    echoes never inflate the denominator. Both sides count an
    attempt's OWN work (steps past its resume point), so a resumed
    trial's checkpointed prefix lands in the world that executed it
    and per-world goodput is <= 1 by construction. Work a killed host
    did past its last attempt_end is invisible to telemetry — the
    ledger-based drill goodput (``faults/harness.py``) is the
    authoritative acceptance number; this fold is the per-world
    breakdown. World ``None`` (an untagged single-host stream) folds
    under ``"untagged"``."""
    books: dict = {}
    seen: set = set()
    for ev in events:
        if ev.get("kind") != "attempt_end":
            continue
        key = (ev.get("trial_id"), ev.get("attempt"),
               (ev.get("data") or {}).get("status"))
        if key in seen:
            continue
        seen.add(key)
        w = ev.get("world")
        wkey = "untagged" if w is None else str(int(w))
        b = books.setdefault(
            wkey,
            {
                "attempt_ends": 0,
                "settled": 0,
                "useful_steps": 0,
                "executed_steps": 0,
                "hosts": set(),
            },
        )
        b["attempt_ends"] += 1
        if ev.get("host") is not None:
            b["hosts"].add(int(ev["host"]))
        data = ev.get("data") or {}
        s = data.get("summary") or {}
        done = int(s.get("steps", s.get("steps_at_failure", 0)) or 0)
        resumed = int(s.get("resumed_from_step", 0) or 0)
        work = max(0, done - resumed)
        b["executed_steps"] += work
        if data.get("status") in SETTLED_STATUSES:
            b["settled"] += 1
            b["useful_steps"] += work
    for b in books.values():
        b["hosts"] = sorted(b["hosts"])
        b["goodput"] = (
            round(b["useful_steps"] / b["executed_steps"], 4)
            if b["executed_steps"]
            else None
        )
    return books


def per_tenant_books(events: list[dict]) -> dict:
    """Goodput fold per TENANT off tenant-tagged ``attempt_end``
    events (the sweep service's ledger stamps tenant/priority/
    submit_ts provenance — hpo/ledger.py). Same dedup and own-work
    accounting as :func:`per_world_books`; empty on streams with no
    tenant tags, so pre-service fleet summaries gain no key noise."""
    books: dict = {}
    seen: set = set()
    for ev in events:
        if ev.get("kind") != "attempt_end":
            continue
        data = ev.get("data") or {}
        tenant = data.get("tenant")
        if tenant is None:
            continue
        key = (ev.get("trial_id"), ev.get("attempt"), data.get("status"))
        if key in seen:
            continue
        seen.add(key)
        b = books.setdefault(
            str(tenant),
            {
                "attempt_ends": 0,
                "settled": 0,
                "useful_steps": 0,
                "executed_steps": 0,
                "trials": set(),
            },
        )
        b["attempt_ends"] += 1
        if ev.get("trial_id") is not None:
            b["trials"].add(int(ev["trial_id"]))
        s = data.get("summary") or {}
        done = int(s.get("steps", s.get("steps_at_failure", 0)) or 0)
        resumed = int(s.get("resumed_from_step", 0) or 0)
        work = max(0, done - resumed)
        b["executed_steps"] += work
        if data.get("status") in SETTLED_STATUSES:
            b["settled"] += 1
            b["useful_steps"] += work
    for b in books.values():
        b["trials"] = len(b["trials"])
        b["goodput"] = (
            round(b["useful_steps"] / b["executed_steps"], 4)
            if b["executed_steps"]
            else None
        )
    return books


def restart_tax_report(events: list[dict]) -> list[dict]:
    """Per world transition, the wall cost of the restart, split into
    phases. The supervisor's ``restart_tax`` event (emitted the moment
    the replacement world finishes launching) carries the phases it
    can measure live — detect (victim's last heartbeat -> trigger),
    drain (teardown of the old world), relaunch (new world spawned).
    The merged timeline supplies the rest: restore (launch -> the new
    world's first checkpoint-restore or admitted attempt) and
    first_useful_step (launch -> the new world's first completed
    training epoch — step-level completion evidence only exists at the
    epoch sync)."""
    out = []
    for ev in events:
        if ev.get("kind") != "restart_tax":
            continue
        d = ev.get("data") or {}
        epoch = d.get("world_epoch")
        launch_ts = float(ev.get("ts", 0.0))
        restore_ts = None
        admitted_ts = None
        first_epoch_ts = None
        for ev2 in events:
            if ev2.get("world") is None or int(ev2["world"]) != epoch:
                continue
            ts2 = float(ev2.get("ts", 0.0))
            if ts2 < launch_ts:
                continue
            k = ev2.get("kind")
            if k in ("ckpt_restore", "ckpt_scan_restore"):
                restore_ts = ts2 if restore_ts is None else restore_ts
            elif k == "attempt_start":
                admitted_ts = ts2 if admitted_ts is None else admitted_ts
            elif k == "epoch":
                first_epoch_ts = (
                    ts2 if first_epoch_ts is None else first_epoch_ts
                )
        restore_anchor = restore_ts if restore_ts is not None else admitted_ts
        entry = {
            "world_epoch": epoch,
            "trigger": d.get("trigger"),
            "lost": d.get("lost"),
            "detect_s": d.get("detect_s"),
            "drain_s": d.get("drain_s"),
            "relaunch_s": d.get("relaunch_s"),
            "restore_s": (
                round(restore_anchor - launch_ts, 3)
                if restore_anchor is not None
                else None
            ),
            "first_useful_step_s": (
                round(first_epoch_ts - launch_ts, 3)
                if first_epoch_ts is not None
                else None
            ),
        }
        phases = [
            entry[k]
            for k in ("detect_s", "drain_s", "relaunch_s", "restore_s")
        ]
        entry["total_s"] = (
            round(sum(float(p) for p in phases), 3)
            if all(p is not None for p in phases)
            else None
        )
        out.append(entry)
    return out


# --------------------------------------------------------------------
# the fleet trace
# --------------------------------------------------------------------


def _host_pid(slot: int) -> int:
    return int(slot) + 2  # pid 1 = supervisor


def build_fleet_trace(
    merged: dict,
    *,
    lineage: Optional[dict] = None,
    ctl_events: Optional[list] = None,
) -> dict:
    """One Perfetto trace for the whole fleet: pid 1 is the supervisor
    (world-epoch spans ride its driver track), pid ``slot + 2`` is
    host ``slot`` with the usual per-trial tracks inside, and flow
    arrows connect each migrated trial's segments across worlds.
    ``lineage`` (from :func:`trial_lineage`) can be passed in to share
    one computation with :func:`fleet_summary`. ``ctl_events`` (from
    ``CtlProfiler.trace_events(pid=0)``) adds the control-plane track
    as pid 0 — its timestamps are relative to its own retained pass
    ring, a sidecar clock, not skew-corrected fleet time."""
    events = merged["events"]
    worlds = merged.get("worlds") or []
    hosts = sorted(
        set(merged.get("expected_hosts") or [])
        | set(merged.get("hosts_seen") or [])
    )
    names = {1: "supervisor"}
    names.update({_host_pid(h): f"host {h}" for h in hosts})

    all_ts = [float(ev.get("ts", 0.0)) for ev in events]
    all_ts.extend(float(w.get("ts", 0.0)) for w in worlds)
    t0 = min(all_ts) if all_ts else 0.0

    def pid_for(ev: dict) -> int:
        h = ev.get("host")
        return _host_pid(int(h)) if h is not None else 1

    trace = _export.build_trace(
        events, pid_for=pid_for, process_names=names, t0=t0
    )
    te = trace["traceEvents"]

    def us(ts: float) -> float:
        return round((float(ts) - t0) * 1e6, 1)

    last_ts = max(all_ts) if all_ts else 0.0
    for i, w in enumerate(worlds):
        start = float(w.get("ts", 0.0))
        end = (
            float(worlds[i + 1].get("ts", start))
            if i + 1 < len(worlds)
            else max(last_ts, start)
        )
        te.append(
            {
                "name": (
                    f"world {w.get('epoch')} "
                    f"({len(w.get('hosts', []))} hosts)"
                ),
                "cat": "world",
                "ph": "X",
                "pid": 1,
                "tid": 0,
                "ts": us(start),
                "dur": max(0.0, us(end) - us(start)),
                "args": {
                    "hosts": w.get("hosts"),
                    "lost": w.get("lost"),
                    "reason": w.get("reason"),
                },
            }
        )

    # Migration lineage: one flow id per trial, an s->f arrow per
    # MIGRATION hop — the owning host changed (``migrated_trials``'s
    # definition; a same-host resume in a new world is lineage, not
    # migration, and gets no arrow) — anchored at the segment
    # boundaries on the owning hosts' tracks.
    if lineage is None:
        lineage = trial_lineage(events)
    for tid, chain in sorted(lineage.items()):
        for a, b in zip(chain, chain[1:]):
            if a["host"] == b["host"]:
                continue
            flow = {
                "cat": "migration",
                "name": f"trial {tid} lineage",
                "id": 1000 + int(tid),
            }
            te.append(
                {
                    **flow,
                    "ph": "s",
                    "pid": _host_pid(a["host"]),
                    "tid": int(tid) + 1,
                    "ts": us(a["last_ts"]),
                }
            )
            te.append(
                {
                    **flow,
                    "ph": "f",
                    "bp": "e",
                    "pid": _host_pid(b["host"]),
                    "tid": int(tid) + 1,
                    "ts": us(b["first_ts"]),
                }
            )

    if ctl_events:
        te.extend(ctl_events)
    te.sort(key=lambda e: (e.get("ts", -1.0), e.get("dur", 0.0)))
    trace["otherData"]["hosts"] = hosts
    trace["otherData"]["worlds"] = len(worlds)
    if ctl_events:
        trace["otherData"]["ctl_track"] = "pid 0 (ring-relative clock)"
    return trace


# --------------------------------------------------------------------
# fired-fault cross-check + summary + export
# --------------------------------------------------------------------


def fired_faults(run_dir: str) -> list[dict]:
    """Ground truth of injected faults: the union of every host's
    durable fired-log (``membership/fired-*.jsonl``, written fsync'd
    BEFORE a host_lost dies)."""
    mdir = membership.membership_dir(run_dir)
    out: list[dict] = []
    try:
        names = sorted(os.listdir(mdir))
    except OSError:
        return out
    for name in names:
        if name.startswith("fired-") and name.endswith(".jsonl"):
            out.extend(membership.read_lease(os.path.join(mdir, name)))
    return out


def _fault_traced(rec: dict, events: list[dict]) -> bool:
    for ev in events:
        if ev.get("kind") != "fault_injected":
            continue
        data = ev.get("data") or {}
        if data.get("fault_kind") != rec.get("kind"):
            continue
        if ev.get("trial_id") != rec.get("trial_id"):
            continue
        if "host" in rec and data.get("host") not in (None, rec["host"]):
            continue
        return True
    return False


def fleet_summary(
    run_dir: str,
    *,
    merged: Optional[dict] = None,
    min_skew_s: float = DEFAULT_MIN_SKEW_S,
    now: Optional[Callable[[], float]] = None,
    lineage: Optional[dict] = None,
) -> dict:
    """The sweep-wide rollup the fleet console renders and the chaos-mh
    drill banks: hosts, worlds, per-world goodput, restart tax,
    migration lineage, preflight verdicts, fired-fault cross-check."""
    if merged is None:
        merged = merge_fleet(run_dir, min_skew_s=min_skew_s)
    events = merged["events"]
    if lineage is None:
        lineage = trial_lineage(events)
    t_now = (now or time.time)()

    # Seeded from the LEASES first, then filled from events: a host
    # that heartbeats but never got an event out (wedged before its
    # telemetry came up) is exactly the host an operator needs to see
    # in the health table — event-only seeding would hide it.
    leases = membership.MembershipView(run_dir).hosts()

    def _blank() -> dict:
        return {
            "events": 0,
            "first_ts": None,
            "last_ts": None,
            "worlds": set(),
        }

    hosts: dict = {int(h): _blank() for h in leases}
    for ev in events:
        h = ev.get("host")
        if h is None:
            continue
        h = int(h)
        rec = hosts.setdefault(h, _blank())
        rec["events"] += 1
        ts = float(ev.get("ts", 0.0))
        rec["first_ts"] = (
            ts if rec["first_ts"] is None else min(rec["first_ts"], ts)
        )
        rec["last_ts"] = (
            ts if rec["last_ts"] is None else max(rec["last_ts"], ts)
        )
        if ev.get("world") is not None:
            rec["worlds"].add(int(ev["world"]))
    skew_table = merged.get("skew") or {}
    for h, rec in hosts.items():
        rec["worlds"] = sorted(rec["worlds"])
        lease = leases.get(h)
        if lease is not None:
            rec["lease_status"] = lease.get("status")
            # Age on the corrected fleet clock: a host whose wall
            # clock is skewed off the shared fs clock must not read as
            # stale (or freshly-alive) just because of the skew — the
            # same correction the merge applies to its events.
            off = (skew_table.get(str(h)) or {}).get(
                "applied_offset_s", 0.0
            )
            rec["lease_age_s"] = round(
                t_now - (float(lease.get("ts", 0.0)) + off), 3
            )
            # Corrected lease timestamp so a renderer holding a CACHED
            # summary (the fleet console's follow loop skips re-merges
            # when no shard changed) can re-derive a CURRENT age —
            # lease_age_s above is frozen at summary-build time.
            rec["lease_ts_fleet"] = float(lease.get("ts", 0.0)) + off

    books = per_world_books(events)
    tenant_books = per_tenant_books(events)
    useful = sum(b["useful_steps"] for b in books.values())
    executed = sum(b["executed_steps"] for b in books.values())
    tax = restart_tax_report(events)
    fired = fired_faults(run_dir)
    kinds: dict[str, int] = {}
    for ev in events:
        k = str(ev.get("kind", "?"))
        kinds[k] = kinds.get(k, 0) + 1
    worlds = merged.get("worlds") or []
    return {
        "protocol": "fleet_v1",
        "run_dir": run_dir,
        "generated_ts": t_now,
        "events": len(events),
        "by_kind": dict(sorted(kinds.items())),
        "shards": merged["shards"],
        "torn_lines_total": merged["torn_lines_total"],
        "skew": merged["skew"],
        "hosts": {str(h): hosts[h] for h in sorted(hosts)},
        "expected_hosts": merged["expected_hosts"],
        "hosts_seen": merged["hosts_seen"],
        "all_hosts_traced": merged["all_hosts_traced"],
        "worlds": worlds,
        "world_transitions": max(0, len(worlds) - 1),
        "world_shrunk_traced": kinds.get("world_shrunk", 0) > 0,
        "per_world": books,
        "per_tenant": tenant_books,
        "useful_steps": useful,
        "executed_steps": executed,
        "goodput": round(useful / executed, 4) if executed else None,
        "restart_tax": tax,
        "lineage": {str(t): c for t, c in sorted(lineage.items())},
        "migrated_trials": [str(t) for t in migrated_trials(lineage)],
        "migrations": [
            {**(ev.get("data") or {}), "trial_id": ev.get("trial_id"),
             "ts": ev.get("ts")}
            for ev in events
            if ev.get("kind") == "trial_migrated"
        ],
        "preflight": [
            {**(ev.get("data") or {}), "ts": ev.get("ts")}
            for ev in events
            if ev.get("kind") == "preflight_verdict"
        ],
        "faults": {
            "fired": len(fired),
            "traced": kinds.get("fault_injected", 0),
            # Vacuously true when nothing fired (a fault-free sweep is
            # fine) — chaos gates must ALSO require fired >= 1, or a
            # missing fired-log silently passes them.
            "all_faults_traced": all(
                _fault_traced(rec, events) for rec in fired
            ),
        },
    }


def export_fleet(
    run_dir: str, *, min_skew_s: float = DEFAULT_MIN_SKEW_S
) -> dict:
    """Merge + write the three fleet artifacts under
    ``{run_dir}/telemetry/fleet/``: the merged event stream, the
    Perfetto fleet trace, and ``fleet_summary.json``. Returns the
    paths plus the summary."""
    merged = merge_fleet(run_dir, min_skew_s=min_skew_s)
    lineage = trial_lineage(merged["events"])  # one pass, two readers
    out_dir = fleet_dir(run_dir)
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "events": os.path.join(out_dir, FLEET_EVENTS_NAME),
        "trace": os.path.join(out_dir, FLEET_TRACE_NAME),
        "summary": os.path.join(out_dir, FLEET_SUMMARY_NAME),
    }
    with open(paths["events"], "w") as f:
        for ev in merged["events"]:
            f.write(json.dumps(ev, default=str) + "\n")
    # A live control-plane profiler (this process is the daemon) adds its
    # pass-ring track to the exported trace.
    from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof

    prof = _ctlprof.get_ctlprof()
    with open(paths["trace"], "w") as f:
        json.dump(build_fleet_trace(merged, lineage=lineage,
                                    ctl_events=prof.trace_events(pid=0) if prof is not None else None), f)
    summary = fleet_summary(run_dir, merged=merged, lineage=lineage)
    with open(paths["summary"], "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return {"paths": paths, "summary": summary}
