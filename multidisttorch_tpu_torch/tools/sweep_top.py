"""Live sweep console: tail the telemetry event JSONL and render
per-trial status, step rates, retries, and sweep goodput.

    python -m multidisttorch_tpu_torch.tools.sweep_top <telemetry-dir-or-events.jsonl> [--follow]
    python -m multidisttorch_tpu_torch.tools.sweep_top <run-dir> --fleet [--follow]

Works on a LIVE run (``--follow`` re-reads new lines each interval and
redraws — the sink is flushed per event, so a running sweep streams)
or on a finished one (one-shot render). It only reads the JSONL — it
never initializes CUDA or touches the card, so it can run next to a
live sweep.

The port's counterpart of the JAX package's ``tools/sweep_top.py``: the
same folds, text and ``--json``, over the files either package writes.
Not ported (ROADMAP A.12b): the fabric view (``--service`` over a fabric
root, :func:`fabric_panel`), which raises ``NotImplementedError``.

``--fleet`` turns the console into the FLEET view over an elastic
multi-host run directory (docs/OBSERVABILITY.md "Fleet"): every
per-host/per-world shard under ``{run_dir}/telemetry`` is merged on
the skew-corrected fleet clock (``telemetry/fleet.py``) and the render
adds per-host health (lease age vs the heartbeat deadline), the world
history with its shrink reasons, the restart-tax breakdown of every
world transition, and each migrated trial's lineage across worlds.

Enable telemetry on the sweep side with ``MDT_TELEMETRY=1
MDT_TELEMETRY_DIR=<dir>`` or ``telemetry.telemetry_run(<dir>)`` — see
docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from multidisttorch_tpu_torch.telemetry.console import (
    clear_screen,
    fmt_bytes,
    fmt_duration,
    fmt_mfu,
    fmt_rate,
    fmt_table,
    fmt_ts,
    host_health,
    status_glyph,
)
from multidisttorch_tpu_torch.telemetry.events import EVENTS_NAME
from multidisttorch_tpu_torch.telemetry.export import SweepFold


def resolve_events_path(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, EVENTS_NAME)
    return path


def live_mfu(state: SweepFold, tid: int, rate) -> "float | None":
    """Best-effort live MFU for one trial: its device_cost book's
    per-lane-step FLOPs x its own step rate over the submesh peak.
    None off-TPU (no peak) or before the cost book lands."""
    key = state.series_key_of(tid)
    book = state.device.get(key) if key else None
    if not book or not rate:
        return None
    flops = book.get("flops_per_lane_step")
    peak = book.get("peak_flops_per_chip")
    ndev = book.get("devices") or 1
    if not flops or not peak:
        return None
    return flops * rate / (peak * ndev)


def snapshot(state: SweepFold, path: str) -> dict:
    """Machine-readable one-shot fold of the event stream — the same
    accounting the rendered console shows, JSON-shaped so CI and
    scripts can consume it without screen-scraping (``--json``)."""
    return {
        "path": path,
        "events": state.events,
        "first_ts": state.first_ts,
        "last_ts": state.last_ts,
        "sweep": state.sweep,
        "done": state.done,
        "useful_steps": state.useful,
        "executed_steps": state.executed,
        "goodput": state.goodput,
        "anomalies": state.anomalies,
        "trials": {k: state.trials[k] for k in sorted(state.trials)},
        "device_books": {k: state.device[k] for k in sorted(state.device)},
        "compile_books": {
            k: state.compile_books[k] for k in sorted(state.compile_books)
        },
        "compiles": state.compiles,
        "compile_s_total": state.compile_s_total,
        "cache_hits": state.cache_hits,
        "precompile": dict(sorted(state.precompile.items())),
        "admissions": state.admissions,
        # Population view (hpo/pbt.py's pbt_* events): mode, K, and the
        # per-generation best/median loss, exploit count, and rank
        # churn — {} when the stream carries no PBT run.
        "pbt": state.pbt,
        # Input-stall books (docs/DATA.md): per-series wait seconds,
        # input-bound fraction, and host->device bytes/sec folded off
        # the stacked feed's input_wait events.
        "input": state.input,
    }


def input_frac(state: SweepFold, tid: int) -> "float | None":
    """Trial ``tid``'s input-bound fraction: its step series' (or its
    bucket's) folded input_wait book, None when the stream carries no
    input accounting."""
    t = state.trials.get(tid)
    keys = [f"trial-{tid}"]
    key = state.series_key_of(tid)
    if key:
        keys.append(key)
    if t and t.get("group") is not None:
        keys.append(f"bucket-g{t['group']}")
    for k in keys:
        book = state.input.get(k)
        if book and book.get("input_bound_frac") is not None:
            return book["input_bound_frac"]
    return None


def render(state: SweepFold, path: str) -> str:
    lines = []
    span = (
        (state.last_ts - state.first_ts)
        if state.first_ts is not None
        else None
    )
    head = [
        f"sweep_top  {path}",
        f"events {state.events}"
        + (f"  span {fmt_duration(span)}" if span is not None else "")
        + (f"  last {fmt_ts(state.last_ts)}" if state.last_ts else ""),
    ]
    if state.sweep:
        head.append(
            "configs {configs}  groups {groups}  stacked {stacked}".format(
                configs=state.sweep.get("configs", "?"),
                groups=state.sweep.get("groups", "?"),
                stacked=state.sweep.get("stacked", False),
            )
        )
    goodput = state.goodput
    head.append(
        "goodput "
        + (f"{goodput:.3f}" if goodput is not None else "-")
        + f"  (useful {state.useful} / executed {state.executed} steps)"
        + ("  [sweep finished]" if state.done else "")
    )
    lines.extend(head)
    lines.append("")
    rows = []
    for tid in sorted(state.trials):
        t = state.trials[tid]
        wall = (
            t["last_ts"] - t["first_ts"]
            if t["first_ts"] is not None and t["last_ts"] is not None
            else None
        )
        rate = t["step"] / wall if wall and t["step"] else None
        key = state.series_key_of(tid)
        book = state.device.get(key, {}) if key else {}
        in_frac = input_frac(state, tid)
        rows.append(
            [
                tid,
                status_glyph(t["status"]),
                t["attempts"] or "-",
                t["epoch"] or "-",
                t["step"] or "-",
                fmt_rate(rate, "/s") if rate else "-",
                f"{t['train_loss']:.4f}" if t["train_loss"] is not None
                else "-",
                f"{t['test_loss']:.4f}" if t["test_loss"] is not None
                else "-",
                t["retries"],
                t["faults"],
                t["lane"] if t["lane"] is not None else "-",
                f"{in_frac * 100:.1f}%" if in_frac is not None else "-",
                fmt_mfu(live_mfu(state, tid, rate)),
                fmt_bytes(book.get("peak_bytes")),
                # Analytic per-device optimizer bytes (memory books,
                # docs/PARALLEL.md): the ZeRO win, CPU included; "z"
                # marks the sharded-update mode.
                (
                    fmt_bytes(t["optimizer_state_bytes"])
                    + ("z" if t.get("zero_update") else "")
                    if t.get("optimizer_state_bytes") is not None
                    else "-"
                ),
                t.get("anomalies", 0) or "-",
                (
                    f"{t['admission_s']:.2f}s"
                    if t.get("admission_s") is not None
                    else "-"
                ),
                t.get("compile_outcome") or "-",
                fmt_duration(wall),
            ]
        )
    lines.append(
        fmt_table(
            rows,
            ["trial", "status", "att", "epoch", "steps", "step rate",
             "train loss", "test loss", "retries", "faults", "lane",
             "in%", "mfu", "peak mem", "opt mem", "anom", "admit",
             "compile", "wall"],
        )
    )
    if state.input:
        # Input-stall books (docs/DATA.md): how long each stacked feed
        # sat blocked on its host gather, and the host->device rate.
        lines.append("")
        irows = []
        for key in sorted(state.input):
            b = state.input[key]
            irows.append(
                [
                    key,
                    f"{b.get('wait_s', 0.0):.2f}s",
                    (
                        f"{b['input_bound_frac'] * 100:.1f}%"
                        if b.get("input_bound_frac") is not None
                        else "-"
                    ),
                    fmt_bytes(b.get("bytes")),
                    (
                        fmt_bytes(b["bytes_per_s"]) + "/s"
                        if b.get("bytes_per_s") is not None
                        else "-"
                    ),
                ]
            )
        lines.append(
            fmt_table(
                irows,
                ["input series", "wait", "in-bound", "bytes", "rate"],
            )
        )
    if state.compile_books:
        # Per-program compile books (docs/COMPILE.md): where the
        # sweep's compile-seconds went, how they were paid (farm
        # thread vs inline admission), and how often the registry
        # served an executable instead of XLA.
        lines.append("")
        lines.append(
            "compile  total {n} ({s:.2f}s)  registry hits {h}".format(
                n=state.compiles,
                s=state.compile_s_total,
                h=state.cache_hits,
            )
            + (
                "  farm " + " ".join(
                    f"{k}:{v}"
                    for k, v in sorted(state.precompile.items())
                )
                if state.precompile
                else ""
            )
        )
        crows = []
        for prog in sorted(state.compile_books):
            b = state.compile_books[prog]
            crows.append(
                [
                    prog,
                    b.get("source") or "-",
                    b["compiles"],
                    f"{b['compile_s']:.2f}s",
                    b["hits"],
                    "ok" if b.get("ok", True) else "FAILED",
                ]
            )
        lines.append(
            fmt_table(
                crows,
                ["program", "source", "compiles", "compile s",
                 "hits", "status"],
            )
        )
    if state.pbt.get("generations"):
        # Population view (docs/PBT.md): one row per PBT generation,
        # folded from the pbt_gen events either mode emits.
        lines.append("")
        lines.append(
            "population  mode {mode}  K={k}  exploits {x}".format(
                mode=state.pbt.get("mode", "?"),
                k=state.pbt.get("population", "?"),
                x=state.pbt.get("exploit_total", 0),
            )
        )
        prows = []
        gens = state.pbt["generations"]
        for g in sorted(gens):
            row = gens[g]
            prows.append(
                [
                    g,
                    row.get("best_lane", "-"),
                    (
                        f"{row['best_loss']:.4f}"
                        if row.get("best_loss") is not None
                        else "-"
                    ),
                    (
                        f"{row['median_loss']:.4f}"
                        if row.get("median_loss") is not None
                        else "-"
                    ),
                    row.get("exploit_count", 0),
                    (
                        f"{row['rank_churn']:.2f}"
                        if row.get("rank_churn") is not None
                        else "-"
                    ),
                    (
                        f"{row['lr_min']:.2e}/{row['lr_median']:.2e}"
                        f"/{row['lr_max']:.2e}"
                        if row.get("lr_min") is not None
                        else "-"
                    ),
                ]
            )
        lines.append(
            fmt_table(
                prows,
                ["gen", "best lane", "best loss", "median loss",
                 "exploits", "churn", "lr min/med/max"],
            )
        )
    return "\n".join(lines)


def fleet_state(run_dir: str) -> tuple[SweepFold, dict, bool]:
    """Merge the run's shards on the fleet clock and fold them: the
    SAME SweepFold the single-stream console uses (so the trial table
    reads identically), the fleet summary (hosts, worlds, tax,
    lineage), and the FLEET-level done verdict. A merged stream holds
    one sweep_end per controller, so the single-stream ``state.done``
    flips on the FIRST finished host while others still train — under
    a supervisor, done means the final world ended complete; without
    one (no world events), the single-stream flag is all there is."""
    from multidisttorch_tpu_torch.telemetry import fleet as _fleet

    merged = _fleet.merge_fleet(run_dir)
    summary = _fleet.fleet_summary(run_dir, merged=merged)
    state = SweepFold()
    supervised = done = False
    for ev in merged["events"]:
        state.feed(ev)
        if ev.get("kind") == "world_end":
            supervised = True
            if (ev.get("data") or {}).get("outcome") == "complete":
                done = True
        elif ev.get("kind") == "world_start":
            supervised = True
            done = False  # a new world reopens the sweep
    return state, summary, (done if supervised else state.done)


def render_fleet(
    state: SweepFold,
    summary: dict,
    run_dir: str,
    *,
    deadline_s: float = 3.0,
) -> str:
    lines = [
        f"sweep_top --fleet  {run_dir}",
        "events {events}  shards {shards}  torn {torn}  "
        "worlds {worlds}  goodput {gp}".format(
            events=summary["events"],
            shards=len(summary["shards"]),
            torn=summary["torn_lines_total"],
            worlds=len(summary["worlds"]),
            gp=(
                f"{summary['goodput']:.3f}"
                if summary["goodput"] is not None
                else "-"
            ),
        ),
        "",
        "hosts",
    ]
    rows = []
    import time as _time

    now = _time.time()
    for slot_s, h in sorted(
        summary["hosts"].items(), key=lambda kv: int(kv[0])
    ):
        # Age from the corrected lease timestamp at RENDER time — the
        # follow loop renders a cached summary between shard changes,
        # and a dead fleet (no shard ever changes again) must still age
        # toward STALE on screen. lease_age_s is the build-time value
        # kept for --json consumers.
        if h.get("lease_ts_fleet") is not None:
            age = round(now - h["lease_ts_fleet"], 3)
        else:
            age = h.get("lease_age_s")
        skew = (summary["skew"].get(slot_s) or {}).get(
            "applied_offset_s", 0.0
        )
        rows.append(
            [
                slot_s,
                host_health(h.get("lease_status"), age, deadline_s),
                fmt_duration(age) if age is not None else "-",
                h["events"],
                ",".join(str(w) for w in h.get("worlds", [])) or "-",
                fmt_duration(
                    (h["last_ts"] - h["first_ts"])
                    if h.get("first_ts") is not None
                    else None
                ),
                fmt_duration(now - h["last_ts"])
                if h.get("last_ts")
                else "-",
                f"{skew:+.3f}s" if skew else "-",
            ]
        )
    lines.append(
        fmt_table(
            rows,
            ["host", "health", "lease age", "events", "worlds", "span",
             "quiet", "skew"],
            indent="  ",
        )
    )
    lines.extend(["", "worlds"])
    wrows = [
        [
            w.get("epoch"),
            ",".join(str(h) for h in w.get("hosts", [])),
            ",".join(str(h) for h in w.get("lost", [])) or "-",
            w.get("reason") or "-",
            fmt_ts(w.get("ts")),
        ]
        for w in summary["worlds"]
    ]
    lines.append(
        fmt_table(
            wrows, ["epoch", "hosts", "lost", "reason", "formed"],
            indent="  ",
        )
    )
    if summary["restart_tax"]:
        lines.extend(["", "restart tax (per world transition)"])
        trows = []
        for t in summary["restart_tax"]:
            trows.append(
                [
                    t.get("world_epoch"),
                    t.get("trigger") or "-",
                    ",".join(str(h) for h in (t.get("lost") or [])) or "-",
                    fmt_duration(t.get("detect_s")),
                    fmt_duration(t.get("drain_s")),
                    fmt_duration(t.get("relaunch_s")),
                    fmt_duration(t.get("restore_s")),
                    fmt_duration(t.get("first_useful_step_s")),
                    fmt_duration(t.get("total_s")),
                ]
            )
        lines.append(
            fmt_table(
                trows,
                ["world", "trigger", "lost", "detect", "drain",
                 "relaunch", "restore", "first step", "total"],
                indent="  ",
            )
        )
    # fleet.migrated_trials (via the summary) is the one authority on
    # what counts as a migration vs mere lineage
    migrated = {
        tid: summary["lineage"][tid]
        for tid in summary.get("migrated_trials", [])
        if tid in summary["lineage"]
    }
    if migrated:
        lines.extend(["", "trial lineage (migrated trials)"])
        for tid, chain in sorted(migrated.items(), key=lambda kv: int(kv[0])):
            lines.append(
                f"  trial {tid}: "
                + " -> ".join(
                    f"w{c['world']}@h{c['host']}" for c in chain
                )
            )
    lines.append("")
    lines.append(render(state, run_dir))
    return "\n".join(lines)


def follow_lines(path: str, state: SweepFold, offset: int) -> int:
    """Feed decodable complete lines past ``offset``; returns the new
    offset. A torn tail (no trailing newline yet) is left for the next
    poll — the live analog of read_events' torn-tail tolerance."""
    try:
        with open(path) as f:
            f.seek(offset)
            chunk = f.read()
    except OSError:
        return offset
    if not chunk:
        return offset
    consumed = 0
    for line in chunk.splitlines(keepends=True):
        if not line.endswith("\n"):
            break  # torn tail: wait for the writer to finish the line
        consumed += len(line)
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(ev, dict):
            state.feed(ev)
    return offset + consumed


class ServiceFollow:
    """Incremental fold over a sweep SERVICE directory: the
    submission-queue journal and the telemetry events are read from
    persistent byte offsets across refreshes (complete lines only —
    the daemon-side pattern), so a console left following a long-lived
    daemon never re-parses its whole history per redraw. A file
    shorter than its offset (a rewrite under us) resets that fold."""

    def __init__(self, service_dir: str):
        self.service_dir = service_dir
        self.qfold: dict = {}
        self.qoffset = 0
        self.state = SweepFold()
        self.eoffset = 0
        # Incident ledger fold (telemetry/incident.py): same persistent
        # byte-offset discipline — the ledger is append-only, so new
        # complete lines replay onto the standing fold.
        self.ifold: dict = {}
        self.ioffset = 0

    def _guard_shrink(self, path: str, offset: int, reset) -> int:
        try:
            if os.path.getsize(path) < offset:
                reset()
                return 0
        except OSError:
            pass
        return offset

    def refresh(self):
        from multidisttorch_tpu_torch.service.queue import (
            fold_queue_into,
            queue_path,
            read_jsonl_from,
        )

        qp = queue_path(self.service_dir)
        self.qoffset = self._guard_shrink(
            qp, self.qoffset, self.qfold.clear
        )
        recs, self.qoffset = read_jsonl_from(qp, self.qoffset)
        fold_queue_into(self.qfold, recs)
        books = {}
        bpath = os.path.join(self.service_dir, "service_books.json")
        try:
            with open(bpath) as f:
                books = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
        epath = os.path.join(self.service_dir, "telemetry", EVENTS_NAME)
        if os.path.exists(epath):
            def reset_state():
                self.state = SweepFold()

            self.eoffset = self._guard_shrink(
                epath, self.eoffset, reset_state
            )
            self.eoffset = follow_lines(epath, self.state, self.eoffset)
        from multidisttorch_tpu_torch.telemetry import incident as tincident

        ipath = os.path.join(
            self.service_dir, "telemetry", tincident.INCIDENTS_NAME
        )
        self.ioffset = self._guard_shrink(
            ipath, self.ioffset, self.ifold.clear
        )
        irecs, self.ioffset = read_jsonl_from(ipath, self.ioffset)
        if irecs:
            tincident.fold_incidents_into(self.ifold, irecs)
        return self.qfold, books, self.state, self.ifold


def service_state(service_dir: str):
    """One-shot fold of a sweep SERVICE directory (the follow loop
    keeps a persistent :class:`ServiceFollow` instead)."""
    return ServiceFollow(service_dir).refresh()


def fabric_panel(service_dir: str, *, deadline_s: float = 3.0) -> str:
    """Shard + replica health over a fabric root: the sharded service
    fabric is not ported (ROADMAP A.12b)."""
    raise NotImplementedError(
        f"{service_dir!r}: the service fabric's panel is not ported "
        "(ROADMAP A.12b)"
    )


def render_slo_panel(slo: dict) -> str:
    """The SLO/error-budget scoreboard (docs/OBSERVABILITY.md
    "Tracing & SLOs"): one row per (objective, label) with compliance
    vs target, budget spent, and the multi-window burn rates — ALERT
    when both windows burn past their factors."""
    rows = []
    for name, evals in sorted((slo.get("slos") or {}).items()):
        for ev in evals:
            burn = ev.get("burn") or {}
            burn_s = " ".join(
                f"{w}s:{b['burn']}" for w, b in sorted(burn.items())
            )
            comp = ev.get("compliance")
            rows.append(
                [
                    name + (f"[{ev['label']}]" if ev.get("label") else ""),
                    f"{comp:.4f}" if comp is not None else "-",
                    f"{ev.get('objective'):.2f}",
                    f"{ev.get('budget_spent_frac', 0):.2f}",
                    burn_s or "-",
                    "ALERT" if ev.get("alerting") else (
                        "ok" if ev.get("met") else "MISS"
                    ),
                ]
            )
    head = "slo  " + ("(budget spent = error budget consumed, 1.0 = gone)")
    table = fmt_table(
        rows, ["objective", "compliance", "target", "spent", "burn", ""]
    )
    return head + "\n" + table


def _fmt_ctl_s(s) -> str:
    """Sub-millisecond-friendly duration for control-plane phase
    times (fmt_duration floors at ms; these are often microseconds)."""
    if s is None:
        return "-"
    s = float(s)
    if s < 1e-3:
        return f"{s * 1e6:.1f}us"
    if s < 1.0:
        return f"{s * 1e3:.2f}ms"
    return f"{s:.3f}s"


def render_ctl_panel(ctl: dict) -> str:
    """Control-plane flight books (docs/OBSERVABILITY.md
    "Control-plane books"): per-phase wall share, p50/p99 with the
    histogram's bucket-bound ceiling, and work-touched accounting —
    examined vs mutated, whose ratio exposes O(pool) scans that only
    changed O(1) entries."""
    passes = ctl.get("passes") or {}
    wt = ctl.get("work_touched") or {}
    eff = wt.get("scan_efficiency")
    head = (
        f"ctl  passes {passes.get('count', 0)}"
        f"  {fmt_rate(passes.get('per_s'))}"
        f"  pass p99 {_fmt_ctl_s(passes.get('p99_s'))}"
        f"  examined {wt.get('examined', 0)}"
        f"  mutated {wt.get('mutated', 0)}"
        f"  scan-eff {f'{eff:.4f}' if eff is not None else '-'}"
    )
    rows = []
    for name, b in (ctl.get("phases") or {}).items():
        bounds = (b.get("bucket_err") or {}).get("p99_s") or (None, None)
        p_eff = b.get("scan_efficiency")
        rows.append(
            [
                name,
                b.get("calls", 0),
                f"{100.0 * b.get('wall_frac', 0.0):.1f}%",
                _fmt_ctl_s(b.get("p50_s")),
                _fmt_ctl_s(b.get("p99_s")),
                (
                    f"<={_fmt_ctl_s(bounds[1])}"
                    if bounds[1] is not None
                    else "-"
                ),
                b.get("examined", 0),
                b.get("mutated", 0),
                f"{p_eff:.4f}" if isinstance(p_eff, float) else "-",
            ]
        )
    return head + "\n" + fmt_table(
        rows,
        [
            "phase", "calls", "wall", "p50", "p99", "p99-bound",
            "examined", "mutated", "eff",
        ],
    )


def render_incidents_panel(incidents: dict) -> str:
    """Root-cause scoreboard over the service's incident ledger
    (docs/INCIDENTS.md): open incidents first (newest activity on
    top), then the most recently resolved — verdict, subject, dedup
    count, flap count, age, and the trials cited in the evidence."""
    if not incidents:
        return ""
    now = time.time()

    def age(inc):
        ts = inc.get("last_ts")
        return fmt_duration(now - float(ts)) if ts else "-"

    def affected(inc):
        tids = sorted(
            {
                ev.get("trial_id")
                for ev in (inc.get("evidence") or ())
                if isinstance(ev, dict) and ev.get("trial_id") is not None
            },
            key=str,
        )
        if not tids:
            return "-"
        cell = ",".join(str(t) for t in tids[:4])
        return cell + ("…" if len(tids) > 4 else "")

    opens = [
        i for i in incidents.values() if i.get("status") == "open"
    ]
    closed = [
        i for i in incidents.values() if i.get("status") != "open"
    ]
    opens.sort(key=lambda i: -(i.get("last_ts") or 0.0))
    closed.sort(key=lambda i: -(i.get("last_ts") or 0.0))
    rows = []
    for inc in (opens + closed)[:8]:
        rows.append(
            [
                str(inc.get("id")),
                str(inc.get("kind")),
                str(inc.get("subject")),
                str(inc.get("status")),
                inc.get("count", 1),
                inc.get("flaps", 0),
                age(inc),
                affected(inc),
            ]
        )
    lines = [
        f"incidents  open {len(opens)}  resolved {len(closed)}",
        fmt_table(
            rows,
            ["incident", "verdict", "subject", "status", "count",
             "flaps", "age", "trials"],
        ),
        "",
    ]
    return "\n".join(lines)


def render_service(
    folded, books, state, service_dir: str, incidents=None
) -> str:
    """Tenant/queue panel over a service directory (docs/SERVICE.md):
    queue depth by state, per-tenant goodput + fair-share vs weight,
    scheduling-latency books, the fragmentation gauge, defrag +
    preemption accounting and the deadline scoreboard, then the
    per-trial table of whatever telemetry shows."""
    from multidisttorch_tpu_torch.service.queue import QueueStats

    now = time.time()
    lines = [f"sweep service  {service_dir}", ""]
    stats = QueueStats.of(folded)
    lines.append(
        "queue  "
        + (
            "  ".join(
                f"{s} {n}" for s, n in sorted(stats.by_state.items())
            )
            or "empty"
        )
    )
    frag = books.get("fragmentation") or {}
    if frag:
        lines.append(
            f"slices free {frag.get('free_slices')}  largest run "
            f"{frag.get('largest_free_run')}  fragmentation "
            f"{frag.get('now')} (max {frag.get('max')})"
        )
    dfr = books.get("defrag") or {}
    if dfr.get("events"):
        lines.append(
            f"defrag  events {dfr['events']}  moved slices "
            f"{dfr.get('moved_slices')}  unblocked "
            f"{len(dfr.get('unblocked') or [])}"
        )
    pre = books.get("preemption") or {}
    if pre.get("events"):
        lines.append(
            f"preempt  events {pre['events']}  evictions "
            f"{pre.get('evictions')}  slices "
            f"{pre.get('evicted_slices')}  unblocked "
            f"{len(pre.get('unblocked') or [])}"
        )
    ck = books.get("checkpoint") or {}
    if ck.get("saves") or ck.get("pending_persists"):
        # The checkpoint data plane (docs/RESILIENCE.md "Checkpoint
        # format v2"): delta ratio = bytes actually written / total
        # state bytes saved (1.0 = no dedup win), drain split =
        # slices-freed (snapshot) vs durable (persist) latency.
        dr = ck.get("delta_ratio")
        lines.append(
            f"ckpt  fmt {ck.get('format', '?')}  saves "
            f"{ck.get('saves', 0)}  written "
            f"{fmt_bytes(ck.get('bytes_written'))}"
            f"/{fmt_bytes(ck.get('bytes_total'))}"
            f"  delta {dr if dr is not None else '-'}"
            f"  ram-restores {ck.get('restores_ram', 0)}"
            + (
                f"  persisting {ck['pending_persists']}"
                if ck.get("pending_persists")
                else ""
            )
        )
        for label, key in (
            ("drain-snapshot", "drain_snapshot"),
            ("drain-persist", "drain_persist"),
        ):
            h = ck.get(key) or {}
            if h.get("count"):
                lines.append(
                    f"{label}  n {h['count']}  p50 "
                    f"{fmt_duration(h.get('p50_s'))}  p99 "
                    f"{fmt_duration(h.get('p99_s'))}  max "
                    f"{fmt_duration(h.get('max_s'))}"
                )
    dl = books.get("deadline") or {}
    if dl.get("hits") or dl.get("misses") or dl.get("pending"):
        lines.append(
            f"deadline  hits {dl.get('hits', 0)}  misses "
            f"{dl.get('misses', 0)}  hit-rate "
            f"{dl.get('hit_rate') if dl.get('hit_rate') is not None else '-'}"
            f"  pending {dl.get('pending', 0)}"
        )
    for label, key in (
        ("queue-wait", "queue_wait"),
        ("placement", "placement_latency"),
    ):
        h = books.get(key) or {}
        if h.get("count"):
            # p99 exemplar: the worst-offender submission behind the
            # percentile — `sweep_trace <dir> <id>` renders its trace.
            ex = h.get("p99_exemplar") or {}
            ex_s = f"  worst {ex['id']}" if ex.get("id") else ""
            lines.append(
                f"{label}  n {h['count']}  p50 "
                f"{fmt_duration(h.get('p50_s'))}  p99 "
                f"{fmt_duration(h.get('p99_s'))}  max "
                f"{fmt_duration(h.get('max_s'))}{ex_s}"
            )
    ctl = books.get("ctl") or {}
    if ctl.get("enabled"):
        lines.append("")
        lines.append(render_ctl_panel(ctl))
    slo = books.get("slo") or {}
    if slo.get("slos"):
        lines.append("")
        lines.append(render_slo_panel(slo))
    lines.append("")
    tenants = books.get("tenants") or {}
    fair = books.get("fair_share") or {}
    names = sorted(set(tenants) | set(fair) | set(stats.by_tenant))
    if names:
        rows = []
        for t in names:
            tb = tenants.get(t) or {}
            fb = fair.get(t) or {}
            by = stats.by_tenant.get(t) or {}
            rows.append(
                [
                    t,
                    fb.get("weight", "-"),
                    by.get("pending", 0) + by.get("admitted", 0),
                    by.get("placed", 0),
                    by.get("settled", 0),
                    tb.get("useful_steps", "-"),
                    tb.get("goodput") if tb.get("goodput") is not None
                    else "-",
                    fb.get("contended_share") if
                    fb.get("contended_share") is not None else "-",
                    fb.get("ratio_to_weight") if
                    fb.get("ratio_to_weight") is not None else "-",
                ]
            )
        lines.append(
            fmt_table(
                rows,
                ["tenant", "w", "queued", "run", "done", "useful",
                 "goodput", "share", "share/w"],
            )
        )
        lines.append("")
    # Waiting/running submissions, oldest first.
    live = [
        r for r in folded.values()
        if r["state"] in ("pending", "admitted", "placed")
    ]
    if live:
        rows = []
        for r in sorted(live, key=lambda r: r.get("submit_ts") or 0.0):
            # Deadline column: time remaining on the submission's tag
            # (negative = already overdue), "-" for best-effort.
            dl_s = r.get("deadline_s")
            if dl_s is not None and r.get("submit_ts"):
                remaining = r["submit_ts"] + float(dl_s) - now
                dl_cell = (
                    f"-{fmt_duration(-remaining)}"
                    if remaining < 0
                    else fmt_duration(remaining)
                )
            else:
                dl_cell = "-"
            rows.append(
                [
                    r["submission_id"][:24],
                    r.get("tenant", "?"),
                    r.get("priority", "-"),
                    r["state"],
                    r.get("size", 1),
                    fmt_duration(now - r["submit_ts"])
                    if r.get("submit_ts") else "-",
                    dl_cell,
                ]
            )
        lines.append(
            fmt_table(
                rows,
                ["submission", "tenant", "pri", "state", "size", "age",
                 "deadline"],
            )
        )
        lines.append("")
    if incidents:
        lines.append(render_incidents_panel(incidents))
    if state.trials:
        lines.append(render(state, service_dir))
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="live console over a sweep's telemetry event JSONL"
    )
    parser.add_argument(
        "path",
        help="telemetry dir (containing events.jsonl) or the JSONL "
        "file; with --fleet, the elastic RUN dir (containing "
        "telemetry/ and membership/)",
    )
    parser.add_argument(
        "-f", "--follow", action="store_true",
        help="keep tailing and redraw every --interval seconds",
    )
    parser.add_argument(
        "--fleet", action="store_true",
        help="fleet view over an elastic multi-host run dir: merge "
        "every per-host/per-world shard on the skew-corrected fleet "
        "clock and add host health, world history, restart tax, and "
        "migration lineage (docs/OBSERVABILITY.md \"Fleet\")",
    )
    parser.add_argument(
        "--service", action="store_true",
        help="tenant/queue view over a sweep SERVICE directory "
        "(docs/SERVICE.md): submission-queue depth by state, per-tenant "
        "goodput and fair-share vs weight, queue-wait/placement-latency "
        "books, the fragmentation gauge, defrag/preemption accounting "
        "and the deadline scoreboard, plus the usual per-trial table "
        "when telemetry is on (a FABRIC root is ROADMAP A.12b, not "
        "ported)",
    )
    parser.add_argument(
        "--deadline", type=float, default=3.0,
        help="heartbeat staleness (s) behind the fleet view's host "
        "health verdict — match the supervisor's --heartbeat-deadline",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="one-shot machine-readable snapshot of the fold (trials, "
        "goodput, device books) instead of the rendered console — for "
        "CI and scripts; mutually exclusive with --follow",
    )
    parser.add_argument("--interval", type=float, default=1.0)
    parser.add_argument(
        "--max-refreshes", type=int, default=0,
        help="stop after N redraws (0 = until interrupted/sweep end; "
        "mostly for tests)",
    )
    args = parser.parse_args(argv)
    if args.json and args.follow:
        parser.error("--json is one-shot; it cannot combine with --follow")

    if args.service:
        if not os.path.isdir(args.path):
            print(f"--service expects a service directory, got {args.path}",
                  file=sys.stderr)
            return 1

        # A fabric root (the JAX fabric's fabric/fabric.json): its shards
        # and panel are ROADMAP A.12b, not ported.
        if os.path.isfile(os.path.join(args.path, "fabric", "fabric.json")):
            raise NotImplementedError(
                f"{args.path!r} is a service fabric root: the fabric view "
                "is not ported (ROADMAP A.12b)"
            )
        shard_dirs = {None: args.path}

        def render_all(states) -> str:
            parts = []
            for k, (folded, books, state, incidents) in states.items():
                d = shard_dirs[k]
                parts.append(
                    render_service(
                        folded, books, state, d, incidents=incidents
                    )
                )
            return "\n".join(parts)

        def service_shot():
            states = {
                k: service_state(d) for k, d in shard_dirs.items()
            }
            if args.json:
                snap = {
                    "service_dir": args.path,
                    "shards": {},
                }
                for k, (
                    folded, books, state, incidents
                ) in states.items():
                    snap["shards"][str(k) if k is not None else "_"] = {
                        "queue": folded,
                        "books": books,
                        "incidents": incidents,
                        "trials": {
                            t: state.trials[t]
                            for t in sorted(state.trials)
                        },
                    }
                # Pre-fabric shape, kept for scripts: the single
                # service's fold at top level.
                snap.update(snap["shards"]["_"])
                print(json.dumps(snap, default=str))
            else:
                print(render_all(states))

        if not args.follow:
            service_shot()
            return 0
        refreshes = 0
        fols = {k: ServiceFollow(d) for k, d in shard_dirs.items()}
        try:
            while True:
                states = {k: f.refresh() for k, f in fols.items()}
                print(
                    clear_screen() + render_all(states),
                    flush=True,
                )
                refreshes += 1
                if args.max_refreshes and refreshes >= args.max_refreshes:
                    break
                time.sleep(args.interval)
        except KeyboardInterrupt:
            pass
        return 0

    if args.fleet:
        if not os.path.isdir(args.path):
            print(f"--fleet expects a run directory, got {args.path}",
                  file=sys.stderr)
            return 1

        def one_shot():
            state, summary, _done = fleet_state(args.path)
            if args.json:
                # The machine-readable fleet snapshot: the summary
                # (hosts/worlds/tax/lineage) plus the same per-trial
                # fold the single-stream --json emits.
                summary = dict(summary)
                summary["trials"] = {
                    k: state.trials[k] for k in sorted(state.trials)
                }
                print(json.dumps(summary, default=str))
            else:
                print(
                    render_fleet(
                        state, summary, args.path,
                        deadline_s=args.deadline,
                    )
                )
            return state

        if not args.follow:
            one_shot()
            return 0

        def fleet_sig():
            # Cheap change detector for the follow loop: (path, size,
            # mtime) of every shard plus the membership sideband. The
            # merge itself is O(total events) — append-only shards
            # mean an unchanged signature makes a re-merge pure waste,
            # so idle refreshes only re-render (lease ages still age).
            from multidisttorch_tpu_torch.telemetry import fleet as _fleet

            paths = _fleet.discover_shards(args.path)
            mdir = os.path.join(args.path, "membership")
            if os.path.isdir(mdir):
                paths = paths + [
                    os.path.join(mdir, n) for n in sorted(os.listdir(mdir))
                ]
            sig = []
            for p in paths:
                try:
                    st = os.stat(p)
                    sig.append((p, st.st_size, st.st_mtime))
                except OSError:
                    sig.append((p, -1, -1.0))
            return tuple(sig)

        refreshes = 0
        state = summary = None
        fleet_done = False
        last_sig = None
        try:
            while True:
                sig = fleet_sig()
                if state is None or sig != last_sig:
                    state, summary, fleet_done = fleet_state(args.path)
                    last_sig = sig
                print(
                    clear_screen()
                    + render_fleet(
                        state, summary, args.path,
                        deadline_s=args.deadline,
                    ),
                    flush=True,
                )
                refreshes += 1
                if fleet_done:
                    break
                if args.max_refreshes and refreshes >= args.max_refreshes:
                    break
                time.sleep(args.interval)
        except KeyboardInterrupt:
            pass
        return 0

    path = resolve_events_path(args.path)
    if not os.path.exists(path) and not args.follow:
        print(f"no event file at {path}", file=sys.stderr)
        return 1
    state = SweepFold()
    offset = follow_lines(path, state, 0)
    if args.json:
        print(json.dumps(snapshot(state, path), default=str))
        return 0
    if not args.follow:
        print(render(state, path))
        return 0
    refreshes = 0
    try:
        while True:
            print(clear_screen() + render(state, path), flush=True)
            refreshes += 1
            if state.done:
                break
            if args.max_refreshes and refreshes >= args.max_refreshes:
                break
            time.sleep(args.interval)
            offset = follow_lines(path, state, offset)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
