"""Control-plane flight books: always-on scheduler profiling with
work-touched accounting.

Every observability layer before this one (event bus, device books,
traces/SLOs) watches the *data plane*. The pure-Python control plane —
the daemon tick that drains intake, admits, fair-shares, bin-packs,
plans preemption/defrag, routes tenants, grants steals, folds journals,
and writes books — placed the 1M replay at ~11.1k submissions/s with
zero instrumentation. This module is the evidence layer ROADMAP item
4's incremental-index rebuild aims at and the harness that proves the
rebuild didn't regress.

Two books per phase:

- **wall**: per-call latency in a fine log-bucket histogram (8 buckets
  per decade, 30 ns .. 1 s — control-plane phases live far below the
  data plane's 10 us floor), with honest bucket-bound error bars.
- **work touched**: entries *examined* vs entries *placed/mutated* per
  call. Scan efficiency = mutated/examined is the O(pool)-vs-O(changed)
  tell: a bin-pack pass that examines 4 000 queue entries to place 3
  has efficiency 0.00075 and is exactly the scan the rebuild must turn
  into an indexed lookup.

Phase taxonomy is :data:`PHASES`; the seams live in
service/{queue,scheduler,defrag,topology,runtime,fabric,loadgen}.py.

**Zero-cost-when-off** (same contract as the event bus): module state
is ``None`` until :func:`configure`; every seam guards with ``prof =
get_ctlprof(); if prof is not None: ...``. With the profiler off, no
object is constructed and — because every clock read goes through the
module-level :data:`_clock` indirection — *no clock is ever read*
(regression-tested in tests/test_ctlprof.py by patching ``_clock`` with
a raiser). When on, the budget is the same <= 2% A/B bench.py enforces
for the rest of telemetry.

A sampling fallback (``MDT_CTLPROF_SAMPLE_HZ``) covers un-instrumented
daemon time: a daemon thread samples the armed thread's stack at the
requested rate and exports a collapsed-stack flame file
(flamegraph.pl / speedscope "collapsed" format).

Cross-round regression ledger: :func:`fold_ledger_round` appends one
record per banked profile to ``artifacts/ctlprof_ledger.jsonl`` and
stamps it with ``vs_prev_rounds`` drift flags (>20% throughput move vs
the prior median; per-phase wall-fraction shift > 0.10 absolute), so
every future scheduler change replays the zoo and sees its
control-plane cost delta next to its submissions/s.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from multidisttorch_tpu_torch.telemetry import metrics as _metrics

# Every clock read the profiler takes goes through this indirection so
# the zero-cost-off test can patch it with a raiser and prove the off
# path reads no clock. time.time is read exactly once, at configure.
_clock = time.perf_counter

# Fine log-spaced seconds: ~30 ns .. 1 s, 8 buckets per decade, so the
# bucket-bound error factor on any percentile is 10^(1/8) ~= 1.33x.
CTL_TIME_BUCKETS = tuple(
    round(10.0 ** (e / 8.0), 12) for e in range(-60, 1)
)

# The daemon tick's phase taxonomy (docs/OBSERVABILITY.md
# "Control-plane books"). Unknown names are accepted and lazily added;
# this tuple fixes books listing order and trace-track order.
PHASES = (
    "intake_drain",
    "admission",
    "fair_share_pick",
    "edf_insert",
    "bin_pack_scan",
    "preempt_window",
    "defrag_plan",
    "topo_route",
    "split_handoff",
    "steal_grant",
    "journal_fold",
    "ledger_fold",
    "books_write",
)

LEDGER_NAME = "ctlprof_ledger.jsonl"


class _Phase:
    """One phase's books. Hot-path writes are attribute adds plus one
    histogram observe (bisect + two float adds)."""

    __slots__ = (
        "name", "calls", "wall_s", "examined", "mutated", "hist",
        "worst_s", "worst_examined", "worst_mutated",
    )

    def __init__(self, name: str, hist):
        self.name = name
        self.calls = 0
        self.wall_s = 0.0
        self.examined = 0
        self.mutated = 0
        self.hist = hist
        self.worst_s = 0.0
        self.worst_examined = 0
        self.worst_mutated = 0


def _hist_block(h) -> dict:
    return {
        "p50_s": h.percentile(50),
        "p95_s": h.percentile(95),
        "p99_s": h.percentile(99),
        "bucket_err": {
            "p50_s": list(h.percentile_bounds(50)),
            "p95_s": list(h.percentile_bounds(95)),
            "p99_s": list(h.percentile_bounds(99)),
        },
    }


class CtlProfiler:
    """Per-phase wall + work-touched books and per-pass accounting.

    Seam shape (the two-guard pattern keeps the off path free)::

        prof = get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        ... the work ...
        if prof is not None:
            prof.note("bin_pack_scan", _t, examined=seen, mutated=placed)

    ``pass_begin``/``pass_end`` bracket one scheduler pass (one daemon
    ``tick()`` or one discrete-event scheduling pass); notes landing
    between them are attributed to the pass, feeding passes/s, the
    worst-pass capture, and the bounded ring behind the Perfetto
    control-plane track.
    """

    def __init__(self, *, registry=None, ring: int = 256):
        self._registry = registry
        self.created_ts = time.time()
        self._t_start = _clock()
        self.phases: dict = {}
        self.pass_hist = self._hist("ctl_pass_wall_s")
        self.passes = 0
        self.pass_wall_s = 0.0
        self.worst_pass: Optional[dict] = None
        self.ring: deque = deque(maxlen=max(1, int(ring)))
        self._pass_t0: Optional[float] = None
        self._pass_phases: Optional[list] = None
        self.sampler: Optional["StackSampler"] = None
        self.flame_path: Optional[str] = None

    def _hist(self, name: str, **labels):
        """Phase histograms are REGISTRY series when a metrics registry
        is active — the Prometheus dump and registry snapshot pick them
        up with zero mirroring cost — and standalone otherwise (the
        zoo arms ctlprof without full telemetry)."""
        reg = self._registry
        if reg is not None:
            return reg.histogram(name, bounds=CTL_TIME_BUCKETS, **labels)
        return _metrics.Histogram(CTL_TIME_BUCKETS)

    # ---- hot path -----------------------------------------------------

    def t0(self) -> float:
        return _clock()

    def note(
        self, name: str, t0: float, examined: int = 0, mutated: int = 0
    ) -> None:
        dt = _clock() - t0
        ph = self.phases.get(name)
        if ph is None:
            ph = self.phases[name] = _Phase(
                name, self._hist("ctl_phase_wall_s", phase=name)
            )
        ph.calls += 1
        ph.wall_s += dt
        ph.examined += examined
        ph.mutated += mutated
        ph.hist.observe(dt)
        if dt > ph.worst_s:
            ph.worst_s = dt
            ph.worst_examined = examined
            ph.worst_mutated = mutated
        pp = self._pass_phases
        if pp is not None:
            pp.append((name, t0, dt, examined, mutated))

    def pass_begin(self) -> None:
        self._pass_t0 = _clock()
        self._pass_phases = []

    def pass_end(self) -> None:
        t0 = self._pass_t0
        if t0 is None:
            return
        dt = _clock() - t0
        self._pass_t0 = None
        pp = self._pass_phases or []
        self._pass_phases = None
        self.passes += 1
        self.pass_wall_s += dt
        self.pass_hist.observe(dt)
        self.ring.append((t0, dt, pp))
        if self.worst_pass is None or dt > self.worst_pass["wall_s"]:
            agg: dict = {}
            for name, _pt0, pdt, ex, mu in pp:
                a = agg.get(name)
                if a is None:
                    a = agg[name] = {
                        "calls": 0, "wall_s": 0.0,
                        "examined": 0, "mutated": 0,
                    }
                a["calls"] += 1
                a["wall_s"] += pdt
                a["examined"] += ex
                a["mutated"] += mu
            self.worst_pass = {"wall_s": dt, "phases": agg}

    # ---- books --------------------------------------------------------

    def books(self) -> dict:
        """JSON-ready flight books: the ``ctl`` block of
        service_books.json and of every zoo scenario artifact."""
        up = _clock() - self._t_start
        total_wall = 0.0
        tot_examined = 0
        tot_mutated = 0
        for ph in self.phases.values():
            total_wall += ph.wall_s
            tot_examined += ph.examined
            tot_mutated += ph.mutated
        order = [n for n in PHASES if n in self.phases]
        order += sorted(set(self.phases) - set(PHASES))
        phases = {}
        for name in order:
            ph = self.phases[name]
            phases[name] = {
                "calls": ph.calls,
                "wall_s": ph.wall_s,
                "wall_frac": (
                    ph.wall_s / total_wall if total_wall > 0 else 0.0
                ),
                **_hist_block(ph.hist),
                "examined": ph.examined,
                "mutated": ph.mutated,
                "scan_efficiency": (
                    ph.mutated / ph.examined if ph.examined > 0 else None
                ),
                "worst_call": {
                    "wall_s": ph.worst_s,
                    "examined": ph.worst_examined,
                    "mutated": ph.worst_mutated,
                },
            }
        out = {
            "enabled": True,
            "uptime_s": up,
            "phases_wall_s": total_wall,
            "passes": {
                "count": self.passes,
                "wall_s": self.pass_wall_s,
                "per_s": self.passes / up if up > 0 else 0.0,
                **_hist_block(self.pass_hist),
                "worst": self.worst_pass,
            },
            "phases": phases,
            "work_touched": {
                "examined": tot_examined,
                "mutated": tot_mutated,
                "scan_efficiency": (
                    tot_mutated / tot_examined if tot_examined > 0 else None
                ),
            },
        }
        if self.sampler is not None:
            out["sampling"] = {
                "hz": self.sampler.hz,
                "samples": self.sampler.samples,
            }
        reg = self._registry
        if reg is not None:
            # Work counters mirrored at books cadence (not per-note) so
            # the Prometheus dump carries examined/mutated alongside
            # the registry-native wall histograms.
            for name, ph in self.phases.items():
                reg.counter(
                    "ctl_phase_calls_total", phase=name
                ).value = float(ph.calls)
                reg.counter(
                    "ctl_phase_examined_total", phase=name
                ).value = float(ph.examined)
                reg.counter(
                    "ctl_phase_mutated_total", phase=name
                ).value = float(ph.mutated)
            reg.counter("ctl_passes_total").value = float(self.passes)
        return out

    # ---- Perfetto track ----------------------------------------------

    def trace_events(
        self, *, pid: int = 0, process_name: str = "control-plane"
    ) -> list:
        """Chrome-trace events for the retained pass ring: one "ctl
        pass" track plus one track per phase, ts relative to the oldest
        retained pass. Merged into the fleet trace by
        telemetry/fleet.py and exported standalone by bench --zoo."""
        if not self.ring:
            return []
        base = self.ring[0][0]
        evs: list = [
            {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": process_name},
            }
        ]
        tids = {"pass": 0}
        for n in PHASES:
            tids.setdefault(n, len(tids))
        for t0, dt, pp in self.ring:
            evs.append({
                "name": "ctl_pass", "cat": "ctl", "ph": "X",
                "pid": pid, "tid": 0,
                "ts": round((t0 - base) * 1e6, 3),
                "dur": round(dt * 1e6, 3),
            })
            for name, pt0, pdt, ex, mu in pp:
                tid = tids.get(name)
                if tid is None:
                    tid = tids[name] = len(tids)
                evs.append({
                    "name": name, "cat": "ctl", "ph": "X",
                    "pid": pid, "tid": tid,
                    "ts": round((pt0 - base) * 1e6, 3),
                    "dur": round(pdt * 1e6, 3),
                    "args": {"examined": ex, "mutated": mu},
                })
        for name, tid in tids.items():
            evs.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": "ctl pass" if name == "pass" else name},
            })
        return evs


class StackSampler(threading.Thread):
    """Sampling fallback for un-instrumented daemon time: samples one
    target thread's stack via ``sys._current_frames()`` at ``hz`` and
    folds into collapsed-stack counts (flamegraph.pl format). Sampling
    cost is paid by THIS daemon thread, not the sampled one — the
    sampled thread only loses the GIL for the frame-walk instants, so
    overhead stays bounded at any reasonable rate (smoke-tested)."""

    def __init__(self, hz: float, target_tid: Optional[int] = None):
        super().__init__(name="mdt-ctlprof-sampler", daemon=True)
        self.hz = float(hz)
        self.target_tid = (
            target_tid if target_tid is not None else threading.get_ident()
        )
        self.counts: dict = {}
        self.samples = 0
        self._stop_ev = threading.Event()

    def run(self) -> None:
        period = 1.0 / max(self.hz, 1e-3)
        while not self._stop_ev.wait(period):
            frame = sys._current_frames().get(self.target_tid)
            if frame is None:
                continue
            parts = []
            depth = 0
            while frame is not None and depth < 64:
                code = frame.f_code
                parts.append(
                    f"{code.co_name} "
                    f"({os.path.basename(code.co_filename)}:{frame.f_lineno})"
                )
                frame = frame.f_back
                depth += 1
            key = ";".join(reversed(parts))
            self.counts[key] = self.counts.get(key, 0) + 1
            self.samples += 1

    def stop(self) -> None:
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout=2.0)

    def collapsed(self) -> list:
        """``stack;frames;leaf count`` lines, hottest first."""
        return [
            f"{k} {v}"
            for k, v in sorted(self.counts.items(), key=lambda kv: -kv[1])
        ]

    def write(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(self.collapsed()) + "\n")
        os.replace(tmp, path)


_prof: Optional[CtlProfiler] = None


def get_ctlprof() -> Optional[CtlProfiler]:
    """The active profiler, or ``None`` when off (the common case —
    seams must check before doing ANY work, including clock reads)."""
    return _prof


def configure(
    *,
    registry=None,
    ring: int = 256,
    sample_hz: Optional[float] = None,
    flame_path: Optional[str] = None,
) -> CtlProfiler:
    """Arm the control-plane profiler. ``registry=`` shares the wall
    histograms into an active metrics registry (telemetry.configure
    passes its own, so ``MDT_TELEMETRY=1`` arms ctlprof end to end);
    ``sample_hz`` defaults from ``MDT_CTLPROF_SAMPLE_HZ`` (0 = no
    sampler); ``flame_path`` is where the collapsed-stack flame file
    lands at :func:`disable`."""
    global _prof
    if sample_hz is None:
        raw = os.environ.get("MDT_CTLPROF_SAMPLE_HZ", "").strip()
        try:
            sample_hz = float(raw) if raw else 0.0
        except ValueError:
            sample_hz = 0.0
    prof = CtlProfiler(registry=registry, ring=ring)
    if sample_hz and sample_hz > 0:
        prof.sampler = StackSampler(sample_hz)
        prof.flame_path = flame_path
        prof.sampler.start()
    _prof = prof
    return prof


def disable() -> Optional[CtlProfiler]:
    """Disarm; returns the retired profiler so callers can take final
    books. Stops the sampler and writes the flame file when armed."""
    global _prof
    prof, _prof = _prof, None
    if prof is not None and prof.sampler is not None:
        prof.sampler.stop()
        if prof.flame_path:
            try:
                prof.sampler.write(prof.flame_path)
            except OSError:
                pass
    return prof


# ---- regression ledger ------------------------------------------------


def read_ledger(path: str) -> list:
    """All well-formed rounds (torn-tail tolerant, like every other
    JSONL reader in the repo)."""
    rows = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return rows


def ledger_phase_summary(books: dict) -> dict:
    """Compact per-phase summary for a ledger line: wall fraction, p99
    with its bucket bounds, scan efficiency."""
    out = {}
    for name, b in (books.get("phases") or {}).items():
        eff = b.get("scan_efficiency")
        out[name] = {
            "wall_frac": round(b.get("wall_frac", 0.0), 4),
            "p99_s": b.get("p99_s"),
            "p99_bounds_s": (b.get("bucket_err") or {}).get("p99_s"),
            "scan_efficiency": (
                round(eff, 6) if isinstance(eff, float) else eff
            ),
        }
    return out


def ledger_record(
    kind: str, scenario: str, books: dict, **extra
) -> dict:
    """One ledger line's canonical shape from a run's flight books:
    ``phase_wall_frac`` (what :func:`fold_ledger_round`'s drift check
    reads), the compact per-phase summary, the pass rate and overall
    scan efficiency. ``extra`` keys (throughput, SLO verdicts, stamps)
    ride alongside."""
    phases = books.get("phases") or {}
    rec = {
        "kind": kind,
        "scenario": scenario,
        "phase_wall_frac": {
            n: round(b.get("wall_frac", 0.0), 4)
            for n, b in phases.items()
        },
        "phases": ledger_phase_summary(books),
        "passes_per_s": (books.get("passes") or {}).get("per_s"),
        "scan_efficiency": (books.get("work_touched") or {}).get(
            "scan_efficiency"
        ),
    }
    rec.update(extra)
    return rec


def fold_ledger_round(
    path: str,
    record: dict,
    *,
    throughput_key: str = "submissions_per_wall_s",
    drift_ratio: float = 0.20,
    frac_shift: float = 0.10,
) -> dict:
    """Append one profiling round to the ledger with cross-round drift
    flags (the ``vs_prev_rounds`` pattern). Prior rounds are those
    sharing the record's ``(kind, scenario)``; flags: throughput moved
    >``drift_ratio`` off the prior median, or any phase's wall fraction
    shifted >``frac_shift`` absolute off its prior median. Flags are
    evidence for a human (or the next PR), not CI gates — wall ratios
    on shared runners are noisy."""
    prior = [
        r for r in read_ledger(path)
        if r.get("kind") == record.get("kind")
        and r.get("scenario") == record.get("scenario")
    ]
    vs: dict = {"prior_rounds": len(prior)}
    tp = record.get(throughput_key)
    prior_tp = [
        r.get(throughput_key) for r in prior
        if isinstance(r.get(throughput_key), (int, float))
    ]
    if isinstance(tp, (int, float)) and prior_tp:
        med = sorted(prior_tp)[len(prior_tp) // 2]
        vs["median_prior"] = med
        vs["ratio_to_median"] = (tp / med) if med else None
        vs["drift_exceeds_20pct"] = (
            bool(med) and abs(tp / med - 1.0) > drift_ratio
        )
    cur_frac = record.get("phase_wall_frac") or {}
    prior_fracs = [
        r.get("phase_wall_frac") for r in prior
        if isinstance(r.get("phase_wall_frac"), dict)
    ]
    if cur_frac and prior_fracs:
        shifted = {}
        for name, f in cur_frac.items():
            vals = sorted(pf.get(name, 0.0) for pf in prior_fracs)
            med = vals[len(vals) // 2]
            if abs(f - med) > frac_shift:
                shifted[name] = {
                    "now": round(f, 4), "median_prior": round(med, 4),
                }
        vs["phase_frac_shifts"] = shifted
        vs["phase_drift"] = bool(shifted)
    rec = dict(record)
    rec["vs_prev_rounds"] = vs
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec
