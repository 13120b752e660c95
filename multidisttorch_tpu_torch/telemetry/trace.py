"""End-to-end submission tracing: one causal span tree per submission.

The service fabric (PRs 9-12) answers "did my submission survive" from
durable files; this module answers "where did its 40 seconds go". A
**trace id** is minted at submit time (``service/queue.py``
``SweepClient.submit``) and rides the spool record; every durable
record a submission touches afterwards can be joined back to it —
journal state transitions, tenant-tagged ledger attempts,
compile-registry events (via the :func:`attribution` seam), dataset
prefetches, checkpoint saves, preemption/defrag/deadline events, and
fabric fence-epoch takeovers.

Reconstruction is **offline, from the durable files alone**
(:func:`build_submission_traces`): the submission-queue journal and the
sweep ledger are the authoritative skeleton (fsync'd, fenced,
torn-tail-tolerant), telemetry event shards enrich it when present
(flushed-not-fsync'd — losing the tail costs detail, never structure).
The result is one contiguous span tree per submission::

    submission <id>                       [submit .. settle]
      spool_wait                          [submit .. journal 'submitted']
      admission                           [submitted .. admitted/rejected]
      dataset_prefetch <spec>             [queued .. loaded]   (if any)
      queue_wait #1                       [admitted .. placed]
      placement #1 (slices a..b, epoch e) [placed .. unplaced/settled]
        attempt 1 -> <status>             [ledger attempt span]
          compile <program>               [registry span]      (if traced)
          epoch / ckpt_save / ...         [instants]
      queue_wait #2 (requeued: <reason>)  [unplaced .. placed]
      ...

Honesty rules (regression-tested in tests/test_trace.py):

- a span with no durable end record stays **open** (``end: null``) —
  a SIGKILLed daemon's in-flight placement reconstructs as an
  honestly-open span, never a fabricated end;
- a torn journal tail drops exactly the torn record (the shared
  torn-tolerant readers), never the submission;
- fabric failovers keep ONE tree: journal records carry the fencing
  epoch, so a submission served by two replicas across a takeover
  shows its spans tagged ``epoch 1`` then ``epoch 2`` with a
  ``fence_takeover`` instant at the seam — contiguous by construction,
  because both epochs append to the same fenced journal.

**Fleet-merge-aware**: pointed at a fabric root, the builder walks
every shard directory (journal + ledger per shard, trial-id joins kept
shard-local — trial ids collide across shards) and merges every
telemetry event shard under the root (``telemetry/**/events*.jsonl``,
the fleet discovery rule, ``fleet/`` merge output excluded).

Exports: span JSON (:func:`export_traces`) + a Perfetto/Chrome trace
(open spans rendered as unmatched ``B`` begins — Perfetto draws them
running to the end of the capture, which is exactly the truth), and
``tools/sweep_trace.py`` renders the per-submission latency-breakdown
table. No jax anywhere in this module.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from multidisttorch_tpu_torch.service import queue as squeue

SPANS_NAME = "submission_spans.json"
TRACE_NAME = "submission_trace.json"

# Both id conventions live in service/queue.py (the minting site, kept
# importable without telemetry); re-exported here as the telemetry-side
# names. ``default_trace_id`` covers records written before tracing
# existed — a pure function of the submission id, so every reader
# derives the same one.
mint_trace_id = squeue.mint_trace_id
default_trace_id = squeue.default_trace_id


def trace_of(rec: dict) -> str:
    """The trace id of a folded/submitted record: explicit when the
    client minted one, derived otherwise."""
    t = rec.get("trace_id") or (rec.get("sub") or {}).get("trace_id")
    if t:
        return str(t)
    sid = rec.get("submission_id") or (rec.get("sub") or {}).get(
        "submission_id", "?"
    )
    return default_trace_id(str(sid))


# --------------------------------------------------------------------
# attribution context (the compile-registry seam)
# --------------------------------------------------------------------
#
# The executable registry is program-keyed, not trial-keyed: one
# compile serves every same-program trial, so its events cannot know a
# trial id on their own. The service runtime sets an attribution
# around placement construction and each cooperative dispatch; the
# registry's emit seam reads it (only when a bus exists — the off path
# never touches the thread-local).

_tls = threading.local()


def make_attribution(pairs) -> dict:
    """Build a reusable attribution payload from ``(trial_id,
    trace_id)`` pairs (one per co-packed member). Built once per
    placement, assigned per dispatch — never rebuilt on the hot path."""
    pairs = list(pairs)
    return {
        "trial_ids": [int(t) for t, _ in pairs],
        "traces": [str(tr) for _, tr in pairs],
    }


def set_attribution(attr: Optional[dict]) -> None:
    _tls.attr = attr


def current_attribution() -> Optional[dict]:
    return getattr(_tls, "attr", None)


# --------------------------------------------------------------------
# span model
# --------------------------------------------------------------------


def _span(
    name: str,
    *,
    start: Optional[float],
    end: Optional[float] = None,
    parent: Optional[int] = None,
    kind: str = "span",
    **tags,
) -> dict:
    return {
        "name": name,
        "kind": kind,  # "span" | "instant"
        "start": start,
        "end": end,
        "parent": parent,
        "tags": {k: v for k, v in tags.items() if v is not None},
    }


def _close(span: dict, ts: float) -> None:
    if span["end"] is None:
        span["end"] = ts


def _add_span(tr: dict, span: dict) -> dict:
    """Append a span to a trace, assigning its stable index id (spans
    are never reordered — position IS identity)."""
    span["_idx"] = len(tr["spans"])
    tr["spans"].append(span)
    return span


# --------------------------------------------------------------------
# discovery
# --------------------------------------------------------------------


def service_dirs_of(root: str) -> list[str]:
    """The service directories under ``root``: the shard dirs of a
    fabric root, else ``root`` itself (a plain single-controller
    service dir)."""
    shards_root = os.path.join(root, "shards")
    if os.path.isdir(shards_root):
        out = sorted(
            os.path.join(shards_root, n)
            for n in os.listdir(shards_root)
            if n.startswith("shard-")
            and os.path.isdir(os.path.join(shards_root, n))
        )
        if out:
            return out
    return [root]


def discover_event_shards(root: str) -> list[str]:
    """Every telemetry event shard under ``root`` and its service
    dirs: ``events*.jsonl`` at any depth under any ``telemetry/`` dir
    (the fleet discovery rule), with ``fleet/`` merge outputs excluded
    so a re-build never folds a previous merge back in."""
    seen: set = set()
    out: list[str] = []
    roots = [root] + [d for d in service_dirs_of(root) if d != root]
    for r in roots:
        tel = os.path.join(r, "telemetry")
        if not os.path.isdir(tel):
            continue
        for dirpath, dirnames, names in os.walk(tel):
            if os.path.basename(dirpath) == "fleet":
                dirnames[:] = []
                continue
            for name in sorted(names):
                if name.startswith("events") and name.endswith(".jsonl"):
                    p = os.path.abspath(os.path.join(dirpath, name))
                    if p not in seen:
                        seen.add(p)
                        out.append(p)
    return out


def load_merged_events(root: str) -> list[dict]:
    """All decodable telemetry events under ``root``, merged across
    shards onto one timeline (torn tails skipped per shard — the
    single-stream read contract, fleet-shaped)."""
    from multidisttorch_tpu_torch.telemetry.events import read_events

    events: list[dict] = []
    for path in discover_event_shards(root):
        events.extend(read_events(path))
    events.sort(key=lambda e: float(e.get("ts", 0.0)))
    return events


# --------------------------------------------------------------------
# reconstruction
# --------------------------------------------------------------------

# Telemetry kinds attached (by trial id) as instants inside attempt /
# placement windows. Deliberately a closed list: unknown kinds never
# bloat a trace.
_TRIAL_INSTANTS = (
    "epoch",
    "ckpt_save",
    "ckpt_restore",
    "ckpt_scan_restore",
    "ckpt_scan_reject",
    "ckpt_scan_none",
    "lane_retire",
    "lane_refill",
    "pipeline_start",
    "pipeline_epoch",
)
# Trial-keyed events carrying a wall_s that render as SPANS (ending at
# the event's timestamp) inside the covering attempt — the checkpoint
# data plane's snapshot/persist split (docs/RESILIENCE.md): a drain's
# trace shows exactly how much of the preemption sat on the victim's
# critical path (snapshot) vs landed behind it (persist).
_TRIAL_PHASES = (
    "ckpt_snapshot",
    "ckpt_persist",
)
# Kinds attached by submission id as instants on the root span.
_SUB_INSTANTS = (
    "defrag_move",
    "preempt_victim",
    "deadline_hit",
    "deadline_miss",
    "submission_rejected",
)


def _journal_skeleton(sub_id: str, recs: list[dict]) -> dict:
    """Build one submission's span skeleton from its raw journal
    records (append order). Returns the trace dict with spans,
    placements (for later joins), and epoch bookkeeping."""
    spans: list[dict] = []
    sub_info: dict = {}
    submit_ts: Optional[float] = None
    root = _span(f"submission {sub_id}", start=None)
    root["_idx"] = 0
    spans.append(root)
    root_idx = 0
    admission: Optional[dict] = None
    queue_wait: Optional[dict] = None
    placement: Optional[dict] = None
    placements: list[dict] = []
    epochs: list[int] = []
    takeovers = 0
    status: Optional[str] = None
    state = "unknown"
    last_epoch: Optional[int] = None

    def add(span: dict) -> dict:
        # Spans are appended in chronological discovery order and NEVER
        # reordered, so a span's list position is its stable id —
        # ``_idx`` lets later joins parent by identity, not by value
        # equality (two instants can be value-equal).
        span["_idx"] = len(spans)
        spans.append(span)
        return span

    for rec in recs:
        kind = rec.get("event")
        try:
            ts = float(rec.get("ts"))
        except (TypeError, ValueError):
            continue
        epoch = rec.get("epoch")
        if epoch is not None:
            epoch = int(epoch)
            if epoch not in epochs:
                epochs.append(epoch)
            if last_epoch is not None and epoch != last_epoch:
                takeovers += 1
                add(
                    _span(
                        f"fence_takeover {last_epoch}->{epoch}",
                        start=ts,
                        end=ts,
                        parent=root_idx,
                        kind="instant",
                        from_epoch=last_epoch,
                        to_epoch=epoch,
                    )
                )
            last_epoch = epoch
        if kind == "submitted":
            sub_info = dict(rec.get("sub") or {})
            try:
                submit_ts = float(sub_info.get("submit_ts") or ts)
            except (TypeError, ValueError):
                submit_ts = ts
            if submit_ts <= 0 or submit_ts > ts:
                submit_ts = ts
            root["start"] = submit_ts
            add(
                _span(
                    "spool_wait",
                    start=submit_ts,
                    end=ts,
                    parent=root_idx,
                )
            )
            admission = add(
                _span("admission", start=ts, parent=root_idx, epoch=epoch)
            )
            state = squeue.PENDING
        elif kind == "admitted":
            if admission is not None:
                _close(admission, ts)
            queue_wait = add(
                _span(
                    "queue_wait",
                    start=ts,
                    parent=root_idx,
                    trial_id=rec.get("trial_id"),
                    bucket=rec.get("bucket"),
                    epoch=epoch,
                )
            )
            state = squeue.ADMITTED
        elif kind == "rejected":
            if admission is not None:
                _close(admission, ts)
            if queue_wait is not None:
                _close(queue_wait, ts)
            _close(root, ts)
            status = rec.get("verdict", "rejected")
            state = squeue.REJECTED
        elif kind == "placed":
            if queue_wait is not None:
                _close(queue_wait, ts)
                queue_wait = None
            if placement is not None:
                # Should not happen (a placed over a live placement);
                # close honestly at the new record rather than invent.
                _close(placement, ts)
            placement = add(
                _span(
                    f"placement #{len(placements) + 1}",
                    start=ts,
                    parent=root_idx,
                    start_slice=rec.get("start"),
                    size=rec.get("size"),
                    lanes=rec.get("lanes"),
                    stacked=rec.get("stacked"),
                    resumed=rec.get("resumed"),
                    blocks=rec.get("blocks"),
                    epoch=epoch,
                )
            )
            placements.append(placement)
            state = squeue.PLACED
        elif kind == "unplaced":
            if placement is not None:
                _close(placement, ts)
                placement["tags"]["unplaced_reason"] = rec.get("reason", "")
                placement = None
            if queue_wait is not None:
                # A setup-phase failure requeues WITHOUT ever having
                # journaled `placed`: the wait that was open ends here
                # (the next one starts below) — leaving it open would
                # leak an open span under a settled submission.
                _close(queue_wait, ts)
            queue_wait = add(
                _span(
                    "queue_wait",
                    start=ts,
                    parent=root_idx,
                    requeued=rec.get("reason", ""),
                    epoch=epoch,
                )
            )
            state = squeue.ADMITTED
        elif kind == "settled":
            if placement is not None:
                _close(placement, ts)
                placement = None
            if queue_wait is not None:
                _close(queue_wait, ts)
                queue_wait = None
            _close(root, ts)
            status = rec.get("status", "?")
            state = squeue.SETTLED
    if root["start"] is None and recs:
        # Torn intro: transitions survived but the 'submitted' record
        # tore — keep what the journal proves, flag the loss.
        try:
            root["start"] = float(recs[0].get("ts"))
        except (TypeError, ValueError):
            pass
    return {
        "submission_id": sub_id,
        "trace_id": trace_of({"submission_id": sub_id, "sub": sub_info}),
        "tenant": sub_info.get("tenant"),
        "state": state,
        "status": status,
        "trial_id": None,  # filled by the caller from the fold
        "intro_lost": not sub_info and bool(recs),
        "epochs": epochs,
        "epoch_takeovers": takeovers,
        "spans": spans,
        "_placements": placements,
        "orphans": [],
        "unattributed": 0,
    }


def _placement_for(tr: dict, ts: float) -> Optional[dict]:
    """The placement span an event at ``ts`` belongs to: the last
    placement starting at or before ``ts`` — unless that placement
    already CLOSED before ``ts``, in which case the next one (the
    ledger writes ``attempt_start`` just before the ``placed`` record
    lands, so a retry's first attempt must not attach to the previous,
    already-unplaced placement)."""
    placements = tr.get("_placements") or []
    best = None
    for p in placements:
        if p["start"] is not None and p["start"] <= ts:
            best = p
        else:
            if best is None or (
                best["end"] is not None and best["end"] < ts
            ):
                return p  # the pre-placed ledger-write case
            break
    return best


def _attempt_parent(tr: dict, start: float, end: Optional[float]):
    """Where an attempt interval belongs in the journal skeleton.

    1. The first placement the interval OVERLAPS (placement not closed
       before the attempt started, and started before the attempt
       ended). Handles the pre-placed ledger-write gap (attempt_start
       lands just before the `placed` record) AND the cross-epoch
       killed attempt (open interval overlaps its epoch's placement,
       not the adopter's later one).
    2. Else the queue_wait span covering the start — a SETUP-phase
       attempt that failed before any `placed` record existed.
    3. Else the root, if the attempt starts inside the submission's
       window; ``None`` (a true orphan) only outside it.
    """
    hi = end if end is not None else float("inf")
    for p in tr.get("_placements") or []:
        if p["start"] is None:
            continue
        closed_before = p["end"] is not None and p["end"] < start
        if not closed_before and p["start"] <= hi:
            return p
    covering = None
    for s in tr["spans"]:
        if s["name"] != "queue_wait" or s["kind"] != "span":
            continue
        if s["start"] is not None and s["start"] <= start and (
            s["end"] is None or start <= s["end"]
        ):
            covering = s
    if covering is not None:
        return covering
    root = tr["spans"][0] if tr["spans"] else None
    if (
        root is not None
        and root["start"] is not None
        and root["start"] <= start
        and (root["end"] is None or start <= root["end"])
    ):
        return root
    return None


def _attach_ledger(
    tr_by_trial: dict, ledger_recs: list[dict]
) -> None:
    """Fold one shard's ledger attempts into its traces as spans
    (attempt_start .. attempt_end) parented into the journal skeleton
    (see :func:`_attempt_parent`). An attempt with no end record stays
    open; an attempt falling OUTSIDE its submission's whole window is
    an orphan (the completeness gate's subject)."""
    # Pair starts/ends first: attachment needs the attempt's full
    # interval (an open interval overlaps differently than a closed
    # one), and ledger order guarantees start-before-end per attempt.
    attempts: dict[tuple, dict] = {}
    order: list[tuple] = []
    for rec in ledger_recs:
        kind = rec.get("event")
        if kind not in ("attempt_start", "attempt_end"):
            continue
        tid = rec.get("trial_id")
        if tid not in tr_by_trial:
            continue
        try:
            ts = float(rec.get("ts"))
        except (TypeError, ValueError):
            continue
        key = (tid, rec.get("attempt"))
        a = attempts.get(key)
        if kind == "attempt_start":
            if a is None:
                attempts[key] = {
                    "start": ts,
                    "end": None,
                    "rec": rec,
                    "end_rec": None,
                }
                order.append(key)
        else:
            if a is None:
                # Torn/compacted start: keep the outcome, never invent
                # a start — lands as an instant below.
                attempts[key] = {
                    "start": None,
                    "end": ts,
                    "rec": rec,
                    "end_rec": rec,
                }
                order.append(key)
            else:
                a["end"] = ts
                a["end_rec"] = rec
    for key in order:
        tid, attempt = key
        a = attempts[key]
        tr = tr_by_trial[tid]
        end_rec = a["end_rec"]
        status = (end_rec or {}).get("status")
        if a["start"] is None:
            parent = _attempt_parent(tr, a["end"], a["end"])
            _add_span(
                tr,
                _span(
                    f"attempt {attempt} -> {status or '?'}",
                    start=a["end"],
                    end=a["end"],
                    parent=parent["_idx"] if parent is not None else None,
                    kind="instant",
                    attempt=attempt,
                    trial_id=tid,
                    status=status,
                ),
            )
            continue
        parent = _attempt_parent(tr, a["start"], a["end"])
        name = (
            f"attempt {attempt} -> {status}"
            if end_rec is not None
            else f"attempt {attempt}"
        )
        span = _add_span(
            tr,
            _span(
                name,
                start=a["start"],
                end=a["end"],
                parent=parent["_idx"] if parent is not None else None,
                attempt=attempt,
                trial_id=tid,
                epoch=a["rec"].get("epoch"),
                trace=a["rec"].get("trace"),
                status=status,
            ),
        )
        err = (end_rec or {}).get("error")
        if err:
            span["tags"]["error"] = str(err)[:200]
        if parent is None:
            tr["orphans"].append(
                {
                    "span": span["_idx"],
                    "why": "attempt outside the submission's window",
                }
            )


_SPAN_RESERVED = {"name", "start", "end", "parent", "kind"}


def _event_tags(data: dict, *, exclude: tuple = ()) -> dict:
    """Event-data fields safe to pass as ``_span(**tags)``: scalars
    only, and keys colliding with span fields remapped (a
    ``preempt_victim``'s ``start`` is a SLICE index, not a timestamp —
    unremapped it shadows the span's own start)."""
    out = {}
    for k, v in data.items():
        if k in exclude or not isinstance(v, (str, int, float, bool)):
            continue
        if k in _SPAN_RESERVED:
            k = f"ev_{k}"
        out[k] = v
    return out


def _attempt_for(tr: dict, trial_id, ts: float) -> Optional[int]:
    """Index of the attempt span covering ``ts`` for this trial (open
    attempts cover everything after their start)."""
    best = None
    for i, s in enumerate(tr["spans"]):
        if s["tags"].get("trial_id") != trial_id:
            continue
        if not s["name"].startswith("attempt") or s["kind"] != "span":
            continue
        if s["start"] is not None and s["start"] <= ts and (
            s["end"] is None or ts <= s["end"]
        ):
            best = i
    return best


def _attach_events(
    traces: dict,
    tr_by_trial_per_shard: list[dict],
    tr_by_sub: dict,
    events: list[dict],
) -> None:
    """Enrich the journal/ledger skeleton with telemetry events:
    compile spans (via the attribution seam's ``traces`` tags),
    dataset prefetches (queued by submission, resolved by spec), and
    per-trial instants. A trial-keyed event whose trial id matches
    traces in MORE than one shard attaches only where a placement
    window covers it in exactly one — ambiguous events are counted
    ``unattributed``, never guessed."""
    tr_by_trace = {tr["trace_id"]: tr for tr in traces.values()}
    open_compiles: dict[str, list] = {}
    prefetch_queued: dict[str, list] = {}  # spec -> [(ts, tr)]
    for ev in events:
        kind = ev.get("kind")
        try:
            ts = float(ev.get("ts", 0.0))
        except (TypeError, ValueError):
            continue
        data = ev.get("data") or {}
        if kind == "dataset_prefetch_queued":
            tr = tr_by_sub.get(data.get("sub_id"))
            if tr is not None:
                prefetch_queued.setdefault(
                    str(data.get("spec")), []
                ).append((ts, tr))
            continue
        if kind == "dataset_prefetch_end":
            spec = str(data.get("spec"))
            for q_ts, tr in prefetch_queued.pop(spec, []):
                _add_span(
                    tr,
                    _span(
                        f"dataset_prefetch {spec}",
                        start=q_ts,
                        end=ts,
                        parent=0,
                        ok=data.get("ok"),
                        wall_s=data.get("wall_s"),
                    ),
                )
            continue
        if kind in ("compile_start", "compile_end", "cache_hit"):
            trace_tags = data.get("traces") or []
            program = str(data.get("program"))
            if kind == "compile_start":
                open_compiles.setdefault(program, []).append(
                    (ts, tuple(trace_tags))
                )
                continue
            if kind == "cache_hit":
                for t in trace_tags:
                    tr = tr_by_trace.get(t)
                    if tr is None:
                        continue
                    parent = _placement_for(tr, ts)
                    _add_span(
                        tr,
                        _span(
                            f"cache_hit {program}",
                            start=ts,
                            end=ts,
                            parent=(
                                parent["_idx"] if parent is not None else 0
                            ),
                            kind="instant",
                        ),
                    )
                continue
            # compile_end: close the oldest open compile of the program
            stack = open_compiles.get(program) or []
            start_ts, start_traces = (
                stack.pop(0) if stack else (None, tuple(trace_tags))
            )
            for t in sorted(set(start_traces) | set(trace_tags)):
                tr = tr_by_trace.get(t)
                if tr is None:
                    continue
                anchor = start_ts if start_ts is not None else ts
                parent = _placement_for(tr, anchor)
                _add_span(
                    tr,
                    _span(
                        f"compile {program}",
                        start=anchor,
                        end=ts,
                        parent=parent["_idx"] if parent is not None else 0,
                        compile_s=data.get("compile_s"),
                        source=data.get("source"),
                    ),
                )
            continue
        if kind in _SUB_INSTANTS:
            tr = tr_by_sub.get(data.get("sub_id"))
            if tr is not None:
                _add_span(
                    tr,
                    _span(
                        kind,
                        start=ts,
                        end=ts,
                        parent=0,
                        kind="instant",
                        **_event_tags(data, exclude=("sub_id",)),
                    ),
                )
            continue
        if kind in _TRIAL_INSTANTS or kind in _TRIAL_PHASES:
            tid = ev.get("trial_id")
            if tid is None:
                tid = data.get("trial_id")  # 0 is a valid trial id
            if tid is None:
                continue
            candidates = []
            for by_trial in tr_by_trial_per_shard:
                tr = by_trial.get(tid)
                if tr is None:
                    continue
                if _placement_for(tr, ts) is not None or _attempt_for(
                    tr, tid, ts
                ) is not None:
                    candidates.append(tr)
            if len(candidates) != 1:
                if candidates:
                    for tr in candidates:
                        tr["unattributed"] += 1
                continue
            tr = candidates[0]
            parent_idx = _attempt_for(tr, tid, ts)
            if parent_idx is None:
                p = _placement_for(tr, ts)
                parent_idx = p["_idx"] if p is not None else 0
            tags = _event_tags(data)
            name = kind
            if kind == "epoch" and ev.get("step") is not None:
                name = f"epoch@step {ev.get('step')}"
            if kind in _TRIAL_PHASES:
                # Phase span: wall_s wide, ending at the emit instant
                # (both events fire when their phase COMPLETES).
                try:
                    wall = max(0.0, float(data.get("wall_s") or 0.0))
                except (TypeError, ValueError):
                    wall = 0.0
                _add_span(
                    tr,
                    _span(
                        name,
                        start=ts - wall,
                        end=ts,
                        parent=parent_idx,
                        **tags,
                    ),
                )
                continue
            _add_span(
                tr,
                _span(
                    name,
                    start=ts,
                    end=ts,
                    parent=parent_idx,
                    kind="instant",
                    **tags,
                ),
            )


def build_submission_traces(
    root: str,
    *,
    include_events: bool = True,
    events: Optional[list[dict]] = None,
) -> dict[str, dict]:
    """Reconstruct every submission's span tree under ``root`` (a
    service dir or a fabric root). Returns ``{submission_id: trace}``;
    each trace carries its spans (index-parented, root first), fence
    epochs, orphan list, and open-span count. See the module
    docstring for the honesty rules."""
    traces: dict[str, dict] = {}
    tr_by_trial_per_shard: list[dict] = []
    for sdir in service_dirs_of(root):
        recs = squeue.load_queue(sdir)
        by_sub: dict[str, list[dict]] = {}
        for rec in recs:
            sid = rec.get("submission_id") or (rec.get("sub") or {}).get(
                "submission_id"
            )
            if sid:
                by_sub.setdefault(str(sid), []).append(rec)
        folded = squeue.fold_queue(recs)
        by_trial: dict = {}
        for sid, sub_recs in by_sub.items():
            tr = _journal_skeleton(sid, sub_recs)
            f = folded.get(sid) or {}
            tr["trial_id"] = f.get("trial_id")
            tr["shard_dir"] = sdir
            if f.get("trace_id"):
                tr["trace_id"] = f["trace_id"]
            traces[sid] = tr
            if tr["trial_id"] is not None:
                by_trial[int(tr["trial_id"])] = tr
        tr_by_trial_per_shard.append(by_trial)
        ledger_recs, _ = squeue.read_jsonl_from(
            os.path.join(sdir, "sweep_ledger.jsonl"), 0
        )
        _attach_ledger(by_trial, ledger_recs)
    if include_events:
        if events is None:
            events = load_merged_events(root)
        _attach_events(
            traces,
            tr_by_trial_per_shard,
            {sid: tr for sid, tr in traces.items()},
            events,
        )
    for tr in traces.values():
        tr.pop("_placements", None)
        for s in tr["spans"]:
            s.pop("_idx", None)
        tr["open_spans"] = sum(
            1
            for s in tr["spans"]
            if s["kind"] == "span" and s["end"] is None
        )
    return traces


def trace_completeness(
    traces: dict[str, dict], *, now: Optional[float] = None
) -> dict:
    """The trace-completeness gate (``bench.py --fabric``): every
    SETTLED/REJECTED submission must reconstruct with a closed root,
    every journal-skeleton span closed, zero orphan spans, and
    monotone span bounds. An open ATTEMPT span under a settled
    submission is NOT a failure — it is the honest trace of an attempt
    a SIGKILL interrupted (the ledger never wrote its end, and the
    builder never invents one); those are counted
    ``abandoned_attempt_spans``. Live submissions are reported (open
    spans are their honest state), never failed on."""
    settled = {
        sid: tr
        for sid, tr in traces.items()
        if tr["state"] in (squeue.SETTLED, squeue.REJECTED)
    }
    bad: list[dict] = []
    abandoned = 0
    for sid, tr in settled.items():
        problems = []
        root = tr["spans"][0] if tr["spans"] else None
        if root is None or root["start"] is None or root["end"] is None:
            problems.append("root not closed")
        open_skeleton = [
            s
            for s in tr["spans"]
            if s["kind"] == "span"
            and s["end"] is None
            and not s["name"].startswith("attempt")
        ]
        if open_skeleton:
            problems.append(
                f"{len(open_skeleton)} open non-attempt spans: "
                + ", ".join(s["name"] for s in open_skeleton[:4])
            )
        abandoned += sum(
            1
            for s in tr["spans"]
            if s["kind"] == "span"
            and s["end"] is None
            and s["name"].startswith("attempt")
        )
        if tr["orphans"]:
            problems.append(f"{len(tr['orphans'])} orphan spans")
        for s in tr["spans"]:
            if (
                s["start"] is not None
                and s["end"] is not None
                and s["end"] < s["start"]
            ):
                problems.append(f"span {s['name']!r} ends before start")
                break
        if tr.get("intro_lost"):
            problems.append("submitted record lost (torn intro)")
        if problems:
            bad.append({"submission_id": sid, "problems": problems})
    takeovers = sum(tr["epoch_takeovers"] for tr in traces.values())
    multi_epoch = sum(
        1 for tr in traces.values() if len(tr["epochs"]) >= 2
    )
    return {
        "submissions": len(traces),
        "settled": len(settled),
        "settled_complete": len(settled) - len(bad),
        "incomplete": bad,
        "orphan_spans": sum(len(tr["orphans"]) for tr in traces.values()),
        "abandoned_attempt_spans": abandoned,
        "open_spans_live": sum(
            tr["open_spans"]
            for tr in traces.values()
            if tr["state"] not in (squeue.SETTLED, squeue.REJECTED)
        ),
        "epoch_takeovers": takeovers,
        "multi_epoch_submissions": multi_epoch,
        "unattributed_events": sum(
            tr["unattributed"] for tr in traces.values()
        ),
        "complete": not bad,
    }


# --------------------------------------------------------------------
# rendering / export
# --------------------------------------------------------------------


def latency_breakdown(tr: dict) -> dict:
    """Fold one trace's spans into the phase table ``sweep_trace``
    renders: per-phase total seconds (queue waits and compiles summed
    across episodes) plus the raw span rows. Open phases report their
    elapsed-so-far as ``None`` end and are excluded from totals — a
    breakdown never fabricates an end."""
    phases: dict[str, float] = {}
    rows = []
    root = tr["spans"][0] if tr["spans"] else None
    t0 = root["start"] if root else None
    for s in tr["spans"]:
        dur = (
            s["end"] - s["start"]
            if s["start"] is not None and s["end"] is not None
            else None
        )
        key = s["name"].split(" ")[0].split("#")[0]
        if dur is not None and s["kind"] == "span" and key not in (
            "submission",
        ):
            phases[key] = phases.get(key, 0.0) + dur
        rows.append(
            {
                "name": s["name"],
                "kind": s["kind"],
                "at_s": (
                    round(s["start"] - t0, 4)
                    if s["start"] is not None and t0 is not None
                    else None
                ),
                "dur_s": round(dur, 4) if dur is not None else None,
                "open": s["kind"] == "span" and s["end"] is None,
                "tags": s["tags"],
            }
        )
    total = (
        root["end"] - root["start"]
        if root and root["start"] is not None and root["end"] is not None
        else None
    )
    return {
        "submission_id": tr["submission_id"],
        "trace_id": tr["trace_id"],
        "tenant": tr.get("tenant"),
        "state": tr["state"],
        "status": tr.get("status"),
        "total_s": round(total, 4) if total is not None else None,
        "epochs": tr["epochs"],
        "phase_totals_s": {
            k: round(v, 4) for k, v in sorted(phases.items())
        },
        "spans": rows,
    }


def build_perfetto(traces: dict[str, dict]) -> dict:
    """Chrome ``trace_event`` JSON over the submission span trees: one
    process ("service"), one thread per submission. Closed spans are
    self-contained ``X`` (complete) events — immune to the B/E
    stack-matching hazard at shared timestamps, where a sibling
    handoff (queue_wait ends exactly when placement begins, by
    construction at every ``placed`` record) would otherwise close the
    wrong span. An OPEN span emits an unmatched ``B`` — Perfetto draws
    it running to the end of the capture, which is the truth a SIGKILL
    leaves behind."""
    starts = [
        tr["spans"][0]["start"]
        for tr in traces.values()
        if tr["spans"] and tr["spans"][0]["start"] is not None
    ]
    t0 = min(starts) if starts else 0.0

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 1)

    out: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": "service"},
        }
    ]
    for tid, (sid, tr) in enumerate(sorted(traces.items()), start=1):
        out.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {
                    "name": f"{sid} [{tr['trace_id']}]",
                },
            }
        )
        marks: list[tuple] = []
        for seq, s in enumerate(tr["spans"]):
            if s["start"] is None:
                continue
            args = {**s["tags"], "trace_id": tr["trace_id"]}
            if s["kind"] == "instant":
                marks.append(
                    (
                        s["start"],
                        0.0,
                        seq,
                        {
                            "name": s["name"],
                            "cat": "instant",
                            "ph": "i",
                            "s": "t",
                            "pid": 1,
                            "tid": tid,
                            "ts": us(s["start"]),
                            "args": args,
                        },
                    )
                )
                continue
            if s["end"] is None:
                marks.append(
                    (
                        s["start"],
                        float("-inf"),  # open = longest: draw first
                        seq,
                        {
                            "name": s["name"],
                            "cat": "submission",
                            "ph": "B",
                            "pid": 1,
                            "tid": tid,
                            "ts": us(s["start"]),
                            "args": args,
                        },
                    )
                )
                continue
            marks.append(
                (
                    s["start"],
                    -(s["end"] - s["start"]),
                    seq,
                    {
                        "name": s["name"],
                        "cat": "submission",
                        "ph": "X",
                        "pid": 1,
                        "tid": tid,
                        "ts": us(s["start"]),
                        "dur": max(0.0, us(s["end"]) - us(s["start"])),
                        "args": args,
                    },
                )
            )
        # Start time, then LONGER span first at equal starts (the
        # viewer nests same-start X events outer-first by emit order).
        marks.sort(key=lambda m: (m[0], m[1], m[2]))
        out.extend(m[3] for m in marks)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "epoch_start_s": t0,
            "submissions": len(traces),
            "generator": "multidisttorch_tpu_torch.telemetry.trace",
        },
    }


def export_traces(root: str, out_dir: Optional[str] = None) -> dict:
    """Build + write the span JSON and the Perfetto trace under
    ``out_dir`` (default ``{root}/telemetry/traces``). Returns
    ``{"spans": path, "perfetto": path, "completeness": {...}}``."""
    traces = build_submission_traces(root)
    if out_dir is None:
        out_dir = os.path.join(root, "telemetry", "traces")
    os.makedirs(out_dir, exist_ok=True)
    spans_path = os.path.join(out_dir, SPANS_NAME)
    with open(spans_path, "w") as f:
        json.dump(
            {sid: tr for sid, tr in sorted(traces.items())},
            f,
            indent=1,
            default=str,
        )
    perfetto_path = os.path.join(out_dir, TRACE_NAME)
    with open(perfetto_path, "w") as f:
        json.dump(build_perfetto(traces), f, default=str)
    return {
        "spans": spans_path,
        "perfetto": perfetto_path,
        "completeness": trace_completeness(traces),
    }
