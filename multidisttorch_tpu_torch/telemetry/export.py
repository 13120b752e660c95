"""Exporters: Chrome/Perfetto trace, Prometheus text dump, run summary.

A copy of ``multidisttorch_tpu/telemetry/export.py``: one event stream
through either package gives the same trace, dump, summary and fold. The
one difference is the device books (MFU, roofline, memory watermarks):
their registry side is ROADMAP A.10's second part (``telemetry/device.py``),
so a live registry contributes none here, exactly as the JAX export reads
a registry that holds none. Books carried by ``device_cost`` /
``device_memory`` events (a stream the JAX package wrote) still fold, with
:func:`roofline_class` copied from the JAX package's ``device.py``.

The trace is built from the event stream (the JSONL sink or an
in-memory event list), so a whole sweep renders as ONE timeline:

- ``pid 1`` is the sweep; each trial gets its own track (``tid`` =
  ``trial_id + 1``, named ``trial {id}``); driver-scoped events (sweep
  start/end, bucket decisions) ride ``tid 0`` ("driver").
- ``attempt_start``/``attempt_end`` pairs become complete ("X") spans
  named ``attempt {n} -> {status}``; everything else is an instant
  ("i") event carrying its payload in ``args`` — injected faults,
  retries, lane retire/refill, checkpoint scan-backs, agreements all
  appear as tagged, clickable marks on their trial's track.

Timestamps are wall-clock seconds in the events; the trace uses
microseconds relative to the first event (Chrome's ``ts`` unit), and
the absolute epoch start rides in trace ``otherData``. Open with
https://ui.perfetto.dev or ``chrome://tracing``.

The Prometheus dump is the text exposition format (counters, gauges,
histograms with ``_bucket``/``_sum``/``_count``, step series as
derived gauges) — scrape-file shaped, parse-tested in
tests/test_telemetry.py and tests/test_torch_telemetry.py.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from multidisttorch_tpu_torch.hpo.supervision import SETTLED_STATUSES
from multidisttorch_tpu_torch.telemetry import events as _events
from multidisttorch_tpu_torch.telemetry import metrics as _metrics

TRACE_NAME = "trace.json"
PROM_NAME = "metrics.prom"
SUMMARY_NAME = "summary.json"

_DRIVER_TID = 0


def _tid(ev: dict) -> int:
    t = ev.get("trial_id")
    return _DRIVER_TID if t is None else int(t) + 1


def build_trace(
    events: list[dict],
    *,
    pid_for=None,
    process_names: Optional[dict] = None,
    t0: Optional[float] = None,
) -> dict:
    """Chrome ``trace_event`` JSON (dict form) from an event stream.

    By default everything rides one process (``pid 1``, "sweep") — the
    single-host shape, byte-stable vs pre-fleet traces. The fleet
    exporter (``telemetry/fleet.py``) passes ``pid_for`` (event -> pid,
    one process track per host) plus ``process_names`` (pid -> display
    name) and an explicit ``t0`` so world spans that precede the first
    event still land at non-negative trace time."""
    if t0 is None:
        if events:
            t0 = min(float(ev.get("ts", 0.0)) for ev in events)
        else:
            t0 = 0.0

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 1)

    if pid_for is None:
        pid_for = lambda ev: 1  # noqa: E731 — the single-process default
    names = {1: "sweep"} if process_names is None else dict(process_names)
    out: list[dict] = []
    named_pids: set = set()
    named_tids: set = set()

    def ensure_pid(pid: int) -> None:
        if pid in named_pids:
            return
        named_pids.add(pid)
        out.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": names.get(pid, f"process {pid}")},
            }
        )
        out.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": _DRIVER_TID,
                "args": {"name": "driver"},
            }
        )

    # Declared processes come first (supervisor track, every known
    # host) so the trace names them even when a host emitted nothing.
    for pid in sorted(names):
        ensure_pid(pid)
    if not names:
        ensure_pid(1)
    # attempt spans: (pid, trial_id, attempt) -> start event
    open_attempts: dict[tuple, dict] = {}
    for ev in sorted(events, key=lambda e: float(e.get("ts", 0.0))):
        kind = ev.get("kind", "?")
        ts = float(ev.get("ts", 0.0))
        tid = _tid(ev)
        pid = pid_for(ev)
        ensure_pid(pid)
        if tid != _DRIVER_TID and (pid, tid) not in named_tids:
            named_tids.add((pid, tid))
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": f"trial {tid - 1}"},
                }
            )
        args = {
            k: v
            for k, v in ev.items()
            if k not in ("kind", "ts", "data")
        }
        args.update(ev.get("data") or {})
        if kind == "device_memory":
            # Device-memory samples render as a Perfetto COUNTER track
            # per series (one line chart across the sweep), not as
            # instants — watermark shape is the whole point.
            data = ev.get("data") or {}
            series = {}
            if data.get("bytes_in_use") is not None:
                series["bytes_in_use"] = data["bytes_in_use"]
            if data.get("peak_bytes") is not None:
                series["peak_bytes"] = data["peak_bytes"]
            if series:
                out.append(
                    {
                        "name": f"device_memory[{data.get('key', '?')}]",
                        "ph": "C",
                        "pid": pid,
                        "ts": us(ts),
                        "args": series,
                    }
                )
            continue
        if kind == "attempt_start":
            open_attempts[(pid, ev.get("trial_id"), ev.get("attempt"))] = ev
            continue
        if kind == "attempt_end":
            key = (pid, ev.get("trial_id"), ev.get("attempt"))
            start = open_attempts.pop(key, None)
            status = (ev.get("data") or {}).get("status", "?")
            begin = float(start["ts"]) if start else ts
            out.append(
                {
                    "name": f"attempt {ev.get('attempt')} -> {status}",
                    "cat": "attempt",
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": us(begin),
                    "dur": max(0.0, us(ts) - us(begin)),
                    "args": args,
                }
            )
            continue
        out.append(
            {
                "name": kind,
                "cat": kind.split("_")[0],
                "ph": "i",
                "s": "t",
                "pid": pid,
                "tid": tid,
                "ts": us(ts),
                "args": args,
            }
        )
    # A crash can leave attempts open (e.g. preemption): render what we
    # know as zero-duration spans so the work still appears.
    for (pid, trial_id, attempt), start in open_attempts.items():
        out.append(
            {
                "name": f"attempt {attempt} -> (unclosed)",
                "cat": "attempt",
                "ph": "X",
                "pid": pid,
                "tid": _tid(start),
                "ts": us(float(start["ts"])),
                "dur": 0.0,
                "args": {},
            }
        )
    out.sort(key=lambda e: (e.get("ts", -1.0), e.get("dur", 0.0)))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"epoch_start_s": t0, "events": len(events)},
    }


def _prom_name(name: str) -> str:
    return "mdt_" + "".join(
        c if c.isalnum() or c == "_" else "_" for c in name
    )


def _prom_labels(labels) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def prometheus_dump(
    registry: Optional["_metrics.MetricsRegistry"] = None,
) -> str:
    """Prometheus text-exposition dump of the registry (or the active
    one). Histograms emit cumulative ``_bucket`` series plus
    ``_sum``/``_count``; step series emit derived rate gauges."""
    registry = registry or _metrics.get_registry()
    lines: list[str] = []
    if registry is None:
        return "# telemetry disabled\n"
    typed: set[str] = set()

    def head(name: str, mtype: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {mtype}")

    for kind, name, labels, obj in registry.series_items():
        if kind == "counter":
            n = _prom_name(name)
            head(n, "counter")
            lines.append(f"{n}{_prom_labels(labels)} {obj.value}")
        elif kind == "gauge":
            n = _prom_name(name)
            head(n, "gauge")
            lines.append(f"{n}{_prom_labels(labels)} {obj.value}")
        elif kind == "histogram":
            n = _prom_name(name)
            head(n, "histogram")
            cum = 0
            for bound, c in zip(obj.bounds, obj.counts):
                cum += c
                lb = dict(labels)
                lb["le"] = repr(float(bound))
                lines.append(
                    f"{n}_bucket{_prom_labels(tuple(sorted(lb.items())))} "
                    f"{cum}"
                )
            lb = dict(labels)
            lb["le"] = "+Inf"
            lines.append(
                f"{n}_bucket{_prom_labels(tuple(sorted(lb.items())))} "
                f"{obj.count}"
            )
            lines.append(f"{n}_sum{_prom_labels(labels)} {obj.sum}")
            lines.append(f"{n}_count{_prom_labels(labels)} {obj.count}")
        elif kind == "step_series":
            snap = obj.snapshot()
            for field in (
                "dispatches", "steps", "lane_steps", "total_s",
                "steps_per_s", "per_lane_steps_per_s",
                "wait_s", "input_bytes", "input_bound_frac",
                "input_bytes_per_s",
            ):
                if field in snap:
                    n = _prom_name(f"step_{field}")
                    head(n, "gauge")
                    lines.append(
                        f"{n}{_prom_labels(labels)} {snap[field]}"
                    )
    return "\n".join(lines) + "\n"


class SweepFold:
    """Incremental fold over an event stream: the ONE implementation of
    the attempt/retry/goodput accounting, shared by :func:`run_summary`
    (feeds a finished stream) and the live console
    (``tools/sweep_top.py`` feeds decodable lines as they land). Keeping
    a single fold is what guarantees the console, the summary JSON, and
    the chaos bench read the same numbers off the same events."""

    def __init__(self):
        self.trials: dict[int, dict] = {}
        self.by_kind: dict[str, int] = {}
        self.events = 0
        self.sweep: dict = {}
        self.first_ts: Optional[float] = None
        self.last_ts: Optional[float] = None
        self.useful = 0
        self.executed = 0
        # Goodput bookkeeping for streams where an attempt can die
        # WITHOUT an attempt_end (host_lost has SIGKILL semantics in a
        # merged fleet stream): per-trial step coverage so a killed
        # attempt's executed prefix — visible only as the next
        # attempt's resume point — still lands in `executed`, and
        # attempt_end echoes (one per controller in a merged
        # multi-controller stream) are counted once.
        self._covered: dict[int, int] = {}
        self._ended: set[tuple[int, int, str]] = set()
        # attempt_start timestamps by trial: first_dispatch - this =
        # the trial's admission latency (setup + compile).
        self._attempt_ts: dict[int, float] = {}
        self.done = False
        # Device books folded off device_cost / device_memory events,
        # keyed by step-series key ("trial-3" / "bucket-g0") — the live
        # console's copy of what the registry holds in-process.
        self.device: dict[str, dict] = {}
        self.anomalies = 0
        # Compile books (docs/COMPILE.md) folded off the compile
        # subsystem's events: per-program compile-seconds/source off
        # compile_end, registry hits off cache_hit, farm lifecycle off
        # precompile_*, per-trial admission latency off first_dispatch
        # joined with its attempt_start.
        self.compile_books: dict[str, dict] = {}
        self.cache_hits = 0
        self.compiles = 0
        self.compile_s_total = 0.0
        self.precompile: dict[str, int] = {}
        self.admissions: list[dict] = []
        # Population books folded off the pbt_* events (hpo/pbt.py):
        # mode/population once, one row per generation (best/median
        # loss, exploit count, rank churn, lr quantiles) — the console
        # and --json's population view.
        self.pbt: dict = {}
        # Fleet tags (host slot -> event count) — empty on an untagged
        # single-host stream; the fleet console folds a merged stream
        # through the same class.
        self.hosts: dict[int, int] = {}
        # Per-tenant books folded off tenant-tagged attempt events (the
        # sweep service's ledger stamps tenant/priority/submit_ts on
        # every attempt record — hpo/ledger.py): goodput and settle
        # accounting keyed by tenant. Empty on untagged streams.
        self.tenants: dict[str, dict] = {}
        # Input-stall books folded off input_wait events (one per
        # stacked round, cumulative): the post-hoc / console mirror of
        # the registry's StepSeries wait book (docs/DATA.md). Keyed by
        # step-series key ("bucket-g0").
        self.input: dict[str, dict] = {}

    def _trial(self, tid: int) -> dict:
        return self.trials.setdefault(
            tid,
            {
                "status": "in_flight",
                "attempts": 0,
                "epoch": 0,
                "step": 0,
                "train_loss": None,
                "test_loss": None,
                "retries": 0,
                "faults": 0,
                "lane_events": 0,
                "lane": None,
                "group": None,
                "anomalies": 0,
                "first_ts": None,
                "last_ts": None,
                "host": None,
                "world": None,
            },
        )

    def series_key_of(self, tid: int) -> Optional[str]:
        """The step-series key trial ``tid``'s device books live under:
        its own series when it ran classic, its bucket's when stacked."""
        t = self.trials.get(tid)
        if t is None:
            return None
        key = f"trial-{tid}"
        if key in self.device:
            return key
        if t.get("lane") is not None and t.get("group") is not None:
            bkey = f"bucket-g{t['group']}"
            if bkey in self.device:
                return bkey
        return None

    def feed(self, ev: dict) -> None:
        self.events += 1
        kind = ev.get("kind", "?")
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        ts = float(ev.get("ts", 0.0))
        if self.first_ts is None:
            self.first_ts = ts
        self.last_ts = ts
        if kind == "sweep_start":
            self.sweep = ev.get("data") or {}
        elif kind == "sweep_end":
            self.done = True
        if kind in ("device_cost", "device_memory"):
            data = ev.get("data") or {}
            key = data.get("key")
            if key:
                book = self.device.setdefault(key, {})
                if kind == "device_cost":
                    book.update(data)
                else:
                    for f in ("bytes_in_use", "peak_bytes"):
                        v = data.get(f)
                        if v is not None:
                            book[f] = max(book.get(f) or 0, int(v))
                    book["memory_source"] = data.get("source")
        if kind == "input_wait":
            data = ev.get("data") or {}
            key = data.get("key") or (
                f"bucket-g{ev.get('group_id')}"
                if ev.get("group_id") is not None
                else "?"
            )
            wall = float(data.get("wall_s") or 0.0)
            wait = float(data.get("wait_s") or 0.0)
            self.input[key] = {
                "wait_s": round(wait, 4),
                "bytes": int(data.get("bytes") or 0),
                "wall_s": round(wall, 4),
                "input_bound_frac": (
                    round(min(1.0, wait / wall), 4) if wall > 0 else None
                ),
                "bytes_per_s": (
                    round(int(data.get("bytes") or 0) / wall, 1)
                    if wall > 0
                    else None
                ),
            }
        if kind.startswith("anomaly_"):
            self.anomalies += 1
        if kind == "compile_end":
            data = ev.get("data") or {}
            prog = str(data.get("program", "?"))
            b = self.compile_books.setdefault(
                prog,
                {
                    "kind": data.get("program_kind"),
                    "source": data.get("source"),
                    "compiles": 0,
                    "compile_s": 0.0,
                    "hits": 0,
                    "ok": True,
                },
            )
            b["compiles"] += 1
            b["compile_s"] = round(
                b["compile_s"] + float(data.get("compile_s") or 0.0), 4
            )
            b["source"] = data.get("source", b["source"])
            if data.get("ok") is False:
                b["ok"] = False
                b["error"] = data.get("error")
            self.compiles += 1
            self.compile_s_total = round(
                self.compile_s_total + float(data.get("compile_s") or 0.0),
                4,
            )
        elif kind == "cache_hit":
            data = ev.get("data") or {}
            prog = str(data.get("program", "?"))
            if prog in self.compile_books:
                self.compile_books[prog]["hits"] += 1
            else:
                self.compile_books[prog] = {
                    "kind": None,
                    "source": data.get("source"),
                    "compiles": 0,
                    "compile_s": 0.0,
                    "hits": 1,
                    "ok": True,
                }
            self.cache_hits += 1
        elif kind.startswith("precompile_"):
            short = kind[len("precompile_"):]
            self.precompile[short] = self.precompile.get(short, 0) + 1
        elif kind == "pbt_gen":
            data = ev.get("data") or {}
            self.pbt["mode"] = data.get("mode", self.pbt.get("mode"))
            self.pbt["population"] = data.get(
                "population", self.pbt.get("population")
            )
            gens = self.pbt.setdefault("generations", {})
            gens[int(data.get("generation", len(gens)))] = {
                k: data.get(k)
                for k in (
                    "best_lane", "best_loss", "median_loss",
                    "exploit_count", "rank_churn", "lr_min", "lr_median",
                    "lr_max",
                )
            }
            self.pbt["exploit_total"] = self.pbt.get(
                "exploit_total", 0
            ) + int(data.get("exploit_count") or 0)
        elif kind == "pbt_exploit":
            data = ev.get("data") or {}
            self.pbt.setdefault("exploits", []).append(
                {
                    "generation": data.get("generation"),
                    "src": data.get("src"),
                    "dst": data.get("dst"),
                    "new_lr": data.get("new_lr"),
                }
            )
        elif kind == "first_dispatch" and ev.get("trial_id") is None:
            # The stacked bucket's admission (group-scoped; per-trial
            # first_dispatch falls through to the trial fold below).
            data = ev.get("data") or {}
            self.admissions.append(
                {
                    "trial_id": None,
                    "group": ev.get("group_id"),
                    "outcome": data.get("outcome"),
                    "wait_s": data.get("wait_s"),
                    "admission_s": None,
                    "program": data.get("program"),
                }
            )
        if ev.get("host") is not None:
            h = int(ev["host"])
            self.hosts[h] = self.hosts.get(h, 0) + 1
        tid = ev.get("trial_id")
        if tid is None or int(tid) < 0:
            # trial_id=-1 is the host-scoped fault sentinel
            # (faults/plan.py) — not a trial, so no table row.
            return
        t = self._trial(int(tid))
        t["last_ts"] = ts
        if t["first_ts"] is None:
            t["first_ts"] = ts
        if ev.get("lane") is not None:
            t["lane"] = ev["lane"]
        if ev.get("group_id") is not None:
            t["group"] = ev["group_id"]
        if ev.get("host") is not None:
            t["host"] = ev["host"]
        if ev.get("world") is not None:
            t["world"] = ev["world"]
        data = ev.get("data") or {}
        if kind == "optimizer_state":
            # Memory books (docs/PARALLEL.md): the analytic per-device
            # optimizer footprint — the ZeRO win's run_summary /
            # sweep_top surface, CPU included.
            if data.get("per_device_bytes") is not None:
                t["optimizer_state_bytes"] = int(data["per_device_bytes"])
            if data.get("zero_update"):
                t["zero_update"] = True
        elif kind == "pipeline_start":
            t["pipeline"] = {
                "stages": data.get("stages"),
                "microbatches": data.get("microbatches"),
                "stage_groups": data.get("stage_groups"),
                "analytic_bubble": data.get("analytic_bubble"),
            }
        elif kind == "pipeline_epoch":
            p = t.setdefault("pipeline", {})
            p["measured_bubble"] = data.get("measured_bubble")
            p["analytic_bubble"] = data.get("analytic_bubble")
            p["transfer_bytes"] = (
                int(p.get("transfer_bytes") or 0)
                + int(data.get("transfer_bytes") or 0)
            )
        if kind == "attempt_start":
            t["attempts"] = max(t["attempts"], int(ev.get("attempt") or 0))
            t["status"] = "in_flight"
            if data.get("tenant") is not None:
                t["tenant"] = data["tenant"]
            self._attempt_ts[int(tid)] = ts
        elif kind == "first_dispatch":
            start = self._attempt_ts.get(int(tid))
            t["admission_s"] = (
                round(ts - start, 4) if start is not None else None
            )
            t["compile_outcome"] = data.get("outcome")
            t["compile_program"] = data.get("program")
            self.admissions.append(
                {
                    "trial_id": int(tid),
                    "group": ev.get("group_id"),
                    "outcome": data.get("outcome"),
                    "wait_s": data.get("wait_s"),
                    "admission_s": t["admission_s"],
                    "program": data.get("program"),
                }
            )
        elif kind == "attempt_end":
            status = data.get("status", "?")
            key = (int(tid), int(ev.get("attempt") or 0), status)
            if key in self._ended:
                return
            self._ended.add(key)
            t["status"] = status
            if status == "retrying":
                t["retries"] += 1
            s = data.get("summary") or {}
            done = int(s.get("steps", s.get("steps_at_failure", 0)) or 0)
            resumed = int(s.get("resumed_from_step", 0) or 0)
            # `useful` counts a settled trial's full cumulative steps
            # (a recovered prefix WAS useful), so `executed` must cover
            # [0, done) at least once or goodput can read > 1: beyond
            # this attempt's own work, count any prefix executed by an
            # attempt that never reported (killed without attempt_end —
            # its work is visible only as this resume point).
            covered = self._covered.get(int(tid), 0)
            increment = max(0, done - resumed) + max(0, resumed - covered)
            self.executed += increment
            self._covered[int(tid)] = max(covered, done)
            if status in SETTLED_STATUSES:
                self.useful += done
            tenant = data.get("tenant")
            if tenant is not None:
                t["tenant"] = tenant
                tb = self.tenants.setdefault(
                    str(tenant),
                    {
                        "attempts": 0,
                        "settled": 0,
                        "useful_steps": 0,
                        "executed_steps": 0,
                        "trials": set(),
                    },
                )
                tb["attempts"] += 1
                tb["trials"].add(int(tid))
                tb["executed_steps"] += increment
                if status in SETTLED_STATUSES:
                    tb["settled"] += 1
                    tb["useful_steps"] += done
        elif kind == "epoch":
            t["epoch"] = int(data.get("epoch", t["epoch"]))
            t["step"] = int(ev.get("step") or t["step"])
            if data.get("avg_train_loss") is not None:
                t["train_loss"] = data["avg_train_loss"]
            if data.get("test_loss") is not None:
                t["test_loss"] = data["test_loss"]
        elif kind == "fault_injected":
            t["faults"] += 1
        elif kind.startswith("lane_"):
            t["lane_events"] += 1
        elif kind.startswith("anomaly_"):
            t["anomalies"] += 1

    @property
    def goodput(self) -> Optional[float]:
        return self.useful / self.executed if self.executed else None

    def tenant_books(self) -> dict[str, dict]:
        """JSON-shaped per-tenant rollup (trial sets become counts,
        goodput derived) — {} on streams with no tenant tags."""
        out = {}
        for tenant in sorted(self.tenants):
            b = self.tenants[tenant]
            out[tenant] = {
                "trials": len(b["trials"]),
                "attempts": b["attempts"],
                "settled": b["settled"],
                "useful_steps": b["useful_steps"],
                "executed_steps": b["executed_steps"],
                "goodput": (
                    round(b["useful_steps"] / b["executed_steps"], 4)
                    if b["executed_steps"]
                    else None
                ),
            }
        return out


COMPUTE_BOUND = "compute_bound"
BANDWIDTH_BOUND = "bandwidth_bound"


def roofline_class(
    flops: Optional[float],
    bytes_accessed: Optional[float],
    peak_flops: Optional[float],
    peak_bw: Optional[float],
) -> Optional[str]:
    """Roofline verdict (a copy of the JAX package's
    ``telemetry/device.py::roofline_class``): arithmetic intensity
    (FLOPs/byte) at or above the ridge point (peak FLOP/s over peak
    bytes/s) is compute-bound, below it bandwidth-bound. None when any
    input is unknown."""
    if not flops or not bytes_accessed or not peak_flops or not peak_bw:
        return None
    intensity = flops / bytes_accessed
    ridge = peak_flops / peak_bw
    return COMPUTE_BOUND if intensity >= ridge else BANDWIDTH_BOUND


def _attach_device_books(fold: SweepFold, registry) -> dict:
    """Join the registry's device books (MFU, roofline, watermarks —
    telemetry/device.py) with the event fold, and stamp every trial
    with its ``mfu`` / ``peak_memory_bytes`` verdict. The contract is
    EXPLICIT nulls: a trial whose MFU cannot be computed (no cost
    analysis on this backend, no known peak FLOP/s, no timings) gets
    ``mfu: null`` plus ``mfu_reason`` saying why — never a silently
    missing field, never a made-up number."""
    # The registry holds no device books in the port (ROADMAP A.10,
    # second part): the JAX package's empty-registry case.
    books: dict = {}
    # Post-hoc path (reading a finished run's JSONL, no live registry):
    # fold the event-carried books instead; event-carried cost-analysis
    # failure reasons also enrich the registry books.
    for key, eb in fold.device.items():
        if key in books:
            b = books[key]
            if b.get("mfu") is None and eb.get("reason"):
                b["mfu_reason"] = eb["reason"]
            if b.get("peak_memory_bytes") is None and eb.get("peak_bytes"):
                b["peak_memory_bytes"] = eb["peak_bytes"]
            b.setdefault("memory_source", eb.get("memory_source"))
        else:
            books[key] = {
                "key": key,
                "flops_per_step": eb.get("flops_per_lane_step"),
                "bytes_per_step": eb.get("bytes_per_lane_step"),
                "peak_flops_per_chip": eb.get("peak_flops_per_chip"),
                "devices": eb.get("devices"),
                "mfu": None,
                "mfu_reason": (
                    eb.get("reason")
                    or "no live metrics registry (post-hoc summary from "
                    "the event stream only — step timings not recorded)"
                ),
                "roofline": roofline_class(
                    eb.get("flops_per_lane_step"),
                    eb.get("bytes_per_lane_step"),
                    eb.get("peak_flops_per_chip"),
                    eb.get("peak_membw_per_chip"),
                ),
                "peak_memory_bytes": eb.get("peak_bytes"),
                "memory_source": eb.get("memory_source"),
            }
    for tid, t in fold.trials.items():
        key = f"trial-{tid}"
        if key not in books and t.get("group") is not None:
            bkey = f"bucket-g{t['group']}"
            if bkey in books:
                key = bkey
        book = books.get(key)
        if book is None:
            t["mfu"] = None
            t["mfu_reason"] = "no device books recorded for this trial"
            t["peak_memory_bytes"] = None
            t["roofline"] = None
            continue
        t["device_series"] = key
        t["mfu"] = book.get("mfu")
        if t["mfu"] is None:
            t["mfu_reason"] = book.get("mfu_reason")
        t["roofline"] = book.get("roofline")
        t["peak_memory_bytes"] = book.get("peak_memory_bytes")
    return books


def run_summary(
    events: list[dict],
    registry: Optional["_metrics.MetricsRegistry"] = None,
) -> dict:
    """Sweep-level rollup of an event stream (+ metrics snapshot when a
    registry is live): per-trial attempt/status/retry accounting, fault
    and lane-churn counts, the goodput ratio (useful/executed optimizer
    steps — the chaos bench's accounting, derived here from
    ``attempt_end`` summaries instead of the ledger file), and the
    device books — per-trial MFU (explicit null-with-reason where it
    cannot be computed), roofline class, and peak-memory watermarks."""
    registry = registry or _metrics.get_registry()
    fold = SweepFold()
    for ev in events:
        fold.feed(ev)
    books = _attach_device_books(fold, registry)
    out = {
        "events": fold.events,
        "by_kind": dict(sorted(fold.by_kind.items())),
        "trials": {k: fold.trials[k] for k in sorted(fold.trials)},
        "useful_steps": fold.useful,
        "executed_steps": fold.executed,
        "goodput": (
            round(fold.goodput, 4) if fold.goodput is not None else None
        ),
        "device_books": {k: books[k] for k in sorted(books)},
        "anomalies": fold.anomalies,
        # Compile books (docs/COMPILE.md): per-program compile-seconds
        # and registry hits, the farm's lifecycle counters, and every
        # admission's latency/outcome — the cold-start accounting the
        # coldstart bench and the console read.
        "compile": {
            "programs": {
                k: fold.compile_books[k]
                for k in sorted(fold.compile_books)
            },
            "compiles": fold.compiles,
            "compile_s_total": fold.compile_s_total,
            "cache_hits": fold.cache_hits,
            "precompile": dict(sorted(fold.precompile.items())),
            "admissions": fold.admissions,
        },
    }
    # Input-stall books (docs/DATA.md): the registry's wait book per
    # step series when live, else the event-carried fold — surfaced
    # top-level so the dataplane bench and console read one place.
    input_books: dict = {}
    if registry is not None:
        for key, snap in registry.step_series_snapshots().items():
            if snap.get("wait_s"):
                input_books[key] = {
                    "wait_s": round(snap["wait_s"], 4),
                    "bytes": snap.get("input_bytes", 0),
                    "input_bound_frac": (
                        round(snap["input_bound_frac"], 4)
                        if snap.get("input_bound_frac") is not None
                        else None
                    ),
                    "bytes_per_s": (
                        round(snap["input_bytes_per_s"], 1)
                        if snap.get("input_bytes_per_s") is not None
                        else None
                    ),
                }
    for key, book in fold.input.items():
        input_books.setdefault(key, book)
    if input_books:
        out["input"] = {k: input_books[k] for k in sorted(input_books)}
    if fold.pbt:
        out["pbt"] = fold.pbt
    if fold.tenants:
        # Per-tenant goodput (sweep-service streams whose ledger stamps
        # tenant provenance on attempt records) — absent otherwise so
        # pre-service summaries stay byte-identical.
        out["tenants"] = fold.tenant_books()
    if registry is not None:
        out["metrics"] = registry.snapshot()
    return out


def export_all(
    out_dir: str,
    events: Optional[list[dict]] = None,
    registry: Optional["_metrics.MetricsRegistry"] = None,
) -> dict:
    """Write trace + Prometheus dump + run summary under ``out_dir``
    (events default to ``out_dir``'s JSONL sink). Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    if events is None:
        events = _events.read_events(
            os.path.join(out_dir, _events.EVENTS_NAME)
        )
    paths = {
        "trace": os.path.join(out_dir, TRACE_NAME),
        "prometheus": os.path.join(out_dir, PROM_NAME),
        "summary": os.path.join(out_dir, SUMMARY_NAME),
        "events": os.path.join(out_dir, _events.EVENTS_NAME),
    }
    with open(paths["trace"], "w") as f:
        json.dump(build_trace(events), f)
    with open(paths["prometheus"], "w") as f:
        f.write(prometheus_dump(registry))
    with open(paths["summary"], "w") as f:
        json.dump(run_summary(events, registry), f, indent=2, default=str)
    return paths
