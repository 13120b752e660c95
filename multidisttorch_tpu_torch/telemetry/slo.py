"""Declarative SLOs with error budgets and multi-window burn-rate
alerts, for the sweep service fabric.

An :class:`SloSpec` states an objective over a good/bad event stream
("99% of placements land within 5 s", "90% of deadline-tagged
submissions hit"). The **error budget** is ``1 - objective``: the
fraction of events that may be bad before the SLO is violated. The
**burn rate** over a window is ``bad_fraction / budget`` — burn 1.0
spends the budget exactly at the sustainable pace, burn N spends it N
times too fast. Alerts use the standard multi-window rule (the SRE
workbook shape): page only when the burn exceeds a factor over BOTH a
short window (the problem is happening now) and a long window (it is
not a blip) — each spec carries its own ``(window_s, factor)`` pairs,
scaled to service time rather than 30-day months.

Three spec kinds:

- ``latency`` — each observation (queue wait, placement latency) is
  good iff ``value <= threshold_s``;
- ``event`` — the seam declares good/bad directly (deadline hit/miss);
- ``gauge_floor`` — a sampled value (per-tenant goodput) is good iff
  ``value >= floor`` at each evaluation; tracked per label (tenant).

The engine runs **live** in the daemon tick (fed at the existing
observation seams, evaluated at the books cadence, landing typed
``slo_*`` events and the ``slo`` block in ``service_books.json``) and
**offline** over banked full histograms (:func:`evaluate_histogram` —
exact, because ``service/loadgen.py`` banks every bucket, not three
percentile points). No jax anywhere in this module.
"""

from __future__ import annotations

import bisect
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

LATENCY = "latency"
EVENT = "event"
GAUGE_FLOOR = "gauge_floor"

# Default multi-window burn thresholds, in service time: the short
# window catches "burning now", the long window filters blips. The
# factors follow the fast/slow-burn split (a short-window burn must be
# much worse than sustainable to page).
DEFAULT_WINDOWS = ((60.0, 6.0), (600.0, 1.0))


@dataclass(frozen=True)
class SloSpec:
    """One service-level objective.

    ``objective`` is the target good fraction (0 < objective < 1);
    ``source`` names the observation stream the engine joins it to
    (``queue_wait`` / ``placement_latency`` / ``deadline`` /
    ``tenant_goodput`` by default — any string the feeder uses).
    ``threshold_s`` (latency kind) / ``floor`` (gauge kind) complete
    the good/bad rule. ``windows`` are ``(window_s, burn_factor)``
    pairs; the alert fires only when EVERY window's burn rate exceeds
    its factor."""

    name: str
    kind: str
    source: str
    objective: float
    threshold_s: Optional[float] = None
    floor: Optional[float] = None
    windows: tuple = DEFAULT_WINDOWS
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )
        if self.kind not in (LATENCY, EVENT, GAUGE_FLOOR):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == LATENCY and self.threshold_s is None:
            raise ValueError(f"latency SLO {self.name!r} needs threshold_s")
        if self.kind == GAUGE_FLOOR and self.floor is None:
            raise ValueError(f"gauge SLO {self.name!r} needs floor")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "kind": self.kind,
            "source": self.source,
            "objective": self.objective,
        }
        if self.threshold_s is not None:
            d["threshold_s"] = self.threshold_s
        if self.floor is not None:
            d["floor"] = self.floor
        d["windows"] = [list(w) for w in self.windows]
        if self.description:
            d["description"] = self.description
        return d


def default_service_slos() -> tuple[SloSpec, ...]:
    """The service fabric's standing objectives (docs/OBSERVABILITY.md
    "Tracing & SLOs"): thresholds sit on LATENCY_BUCKETS bounds so the
    offline histogram evaluation is exact."""
    return (
        SloSpec(
            name="placement_p99_5s",
            kind=LATENCY,
            source="placement_latency",
            threshold_s=5.0,
            objective=0.99,
            description="99% of placements reach their first step "
            "within 5 s of the placement decision",
        ),
        SloSpec(
            name="queue_wait_p95_60s",
            kind=LATENCY,
            source="queue_wait",
            threshold_s=60.0,
            objective=0.95,
            description="95% of submissions wait at most 60 s from "
            "submit to submesh",
        ),
        SloSpec(
            name="deadline_hit_rate",
            kind=EVENT,
            source="deadline",
            objective=0.90,
            description="90% of deadline-tagged submissions settle "
            "completed before their deadline",
        ),
        SloSpec(
            name="tenant_goodput_floor",
            kind=GAUGE_FLOOR,
            source="tenant_goodput",
            floor=0.8,
            objective=0.95,
            description="each tenant's goodput (useful/executed steps) "
            "stays >= 0.8 at 95% of evaluations",
        ),
    )


@dataclass
class _Tracker:
    """Bounded good/bad history for one (spec, label) pair."""

    spec: SloSpec
    label: Optional[str] = None
    good: int = 0
    bad: int = 0
    # (ts, good) ring bounded by the longest window's population (and
    # a hard cap — an SLO must never grow daemon memory unboundedly).
    events: deque = field(default_factory=lambda: deque(maxlen=65536))
    alerting: bool = False

    def observe(self, ts: float, ok: bool) -> None:
        if ok:
            self.good += 1
        else:
            self.bad += 1
        self.events.append((ts, ok))

    def _window_counts(self, now: float, window_s: float) -> tuple[int, int]:
        g = b = 0
        for ts, ok in reversed(self.events):
            if now - ts > window_s:
                break
            if ok:
                g += 1
            else:
                b += 1
        return g, b

    def evaluate(self, now: float) -> dict:
        spec = self.spec
        total = self.good + self.bad
        compliance = self.good / total if total else None
        budget = spec.budget
        burns = {}
        firing = total > 0
        for window_s, factor in spec.windows:
            g, b = self._window_counts(now, window_s)
            n = g + b
            burn = (b / n) / budget if n else 0.0
            burns[str(int(window_s))] = {
                "n": n,
                "bad": b,
                "burn": round(burn, 3),
                "factor": factor,
            }
            if not (n and burn >= factor):
                firing = False
        budget_spent = (
            (self.bad / total) / budget if total and budget > 0 else 0.0
        )
        return {
            "label": self.label,
            "total": total,
            "bad": self.bad,
            "compliance": (
                round(compliance, 5) if compliance is not None else None
            ),
            "objective": spec.objective,
            "met": compliance is None or compliance >= spec.objective,
            "budget_spent_frac": round(min(budget_spent, 99.0), 3),
            "burn": burns,
            "alerting": firing,
        }


class SloEngine:
    """Live SLO evaluation over the service's observation seams.

    Feed with :meth:`observe_latency` (histogram seams),
    :meth:`observe_event` (deadline verdicts), :meth:`observe_gauge`
    (per-tenant goodput samples at books cadence); :meth:`evaluate`
    returns the books block and emits edge-triggered ``slo_alert``
    events (state ``firing``/``resolved``) through the telemetry bus
    when one is configured — the engine itself never requires
    telemetry to be on."""

    def __init__(self, specs: Optional[tuple] = None):
        self.specs = tuple(
            specs if specs is not None else default_service_slos()
        )
        self._trackers: dict[tuple, _Tracker] = {}
        self._by_source: dict[str, list[SloSpec]] = {}
        # source -> metrics.Histogram carrying per-bucket worst-offender
        # exemplars (attach_exemplar): a FIRING slo_alert then names the
        # p99 bucket's worst trace id, so the alert links straight to
        # the submission behind the burn (sweep_trace --worst jumps
        # there). Nothing attached => the field is never serialized —
        # pre-exemplar streams stay byte-identical.
        self._exemplar_sources: dict[str, object] = {}
        for s in self.specs:
            self._by_source.setdefault(s.source, []).append(s)

    def _tracker(self, spec: SloSpec, label: Optional[str]) -> _Tracker:
        key = (spec.name, label)
        t = self._trackers.get(key)
        if t is None:
            t = self._trackers[key] = _Tracker(spec=spec, label=label)
        return t

    def watches(self, source: str) -> bool:
        return source in self._by_source

    def attach_exemplar(self, source: str, histogram) -> None:
        """Register the exemplar-carrying ``metrics.Histogram`` behind
        ``source``'s latency observations (the service attaches its
        ``queue_wait`` / ``placement_latency`` books). Firing alerts
        on that source then cite ``percentile_exemplar(99)``."""
        self._exemplar_sources[source] = histogram

    def observe_latency(
        self, source: str, value_s: float, *, ts: Optional[float] = None
    ) -> None:
        ts = time.time() if ts is None else ts
        for spec in self._by_source.get(source, ()):
            if spec.kind == LATENCY:
                self._tracker(spec, None).observe(
                    ts, value_s <= spec.threshold_s
                )

    def observe_event(
        self, source: str, ok: bool, *, ts: Optional[float] = None
    ) -> None:
        ts = time.time() if ts is None else ts
        for spec in self._by_source.get(source, ()):
            if spec.kind == EVENT:
                self._tracker(spec, None).observe(ts, bool(ok))

    def observe_gauge(
        self,
        source: str,
        value: Optional[float],
        *,
        label: Optional[str] = None,
        ts: Optional[float] = None,
    ) -> None:
        if value is None:
            return
        ts = time.time() if ts is None else ts
        for spec in self._by_source.get(source, ()):
            if spec.kind == GAUGE_FLOOR:
                self._tracker(spec, label).observe(
                    ts, float(value) >= spec.floor
                )

    def evaluate(self, *, now: Optional[float] = None) -> dict:
        """The books block: per-SLO evaluation (gauge specs one row
        per label), plus the flat alert list. Emits edge-triggered
        ``slo_alert`` events on firing/resolve transitions."""
        from multidisttorch_tpu_torch.telemetry.events import get_bus

        now = time.time() if now is None else now
        out: dict = {"specs": [s.to_dict() for s in self.specs], "slos": {}}
        alerts: list[dict] = []
        bus = get_bus()
        for (name, label), tracker in sorted(
            self._trackers.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))
        ):
            ev = tracker.evaluate(now)
            rows = out["slos"].setdefault(name, [])
            rows.append(ev)
            if ev["alerting"] != tracker.alerting:
                tracker.alerting = ev["alerting"]
                state = "firing" if ev["alerting"] else "resolved"
                if bus is not None:
                    extra = {}
                    if state == "firing":
                        h = self._exemplar_sources.get(
                            tracker.spec.source
                        )
                        if h is not None:
                            try:
                                ex = h.percentile_exemplar(99)
                            except Exception:  # noqa: BLE001
                                ex = None
                            if ex is not None:
                                extra["exemplar"] = ex
                    bus.emit(
                        "slo_alert",
                        slo=name,
                        label=label,
                        state=state,
                        compliance=ev["compliance"],
                        burn={
                            w: b["burn"] for w, b in ev["burn"].items()
                        },
                        **extra,
                    )
            if ev["alerting"]:
                alerts.append(
                    {"slo": name, "label": label, "burn": ev["burn"]}
                )
        out["alerts"] = alerts
        out["alerting"] = bool(alerts)
        return out


# --------------------------------------------------------------------
# offline (exact, histogram-backed)
# --------------------------------------------------------------------


def histogram_dict(hist) -> dict:
    """Serialize a ``telemetry.metrics.Histogram`` into the banked
    form offline evaluation reads (bounds + per-bucket counts — the
    FULL distribution, not three percentile points)."""
    return {
        "bounds": list(hist.bounds),
        "counts": list(hist.counts),
        "count": hist.count,
        "sum": hist.sum,
        "max": hist.max,
    }


def evaluate_histogram(spec: SloSpec, hist: dict) -> dict:
    """Exact offline evaluation of a latency SLO against a banked full
    histogram: observations in buckets whose upper bound is <= the
    threshold are good. ``exact`` is true iff the threshold sits on a
    bucket boundary (the default specs do, by construction); otherwise
    the verdict is the CONSERVATIVE one (the straddling bucket counts
    bad)."""
    if spec.kind != LATENCY:
        raise ValueError(f"histogram evaluation needs a latency SLO, "
                         f"got {spec.kind!r}")
    bounds = [float(b) for b in hist.get("bounds") or []]
    counts = [int(c) for c in hist.get("counts") or []]
    total = int(hist.get("count") or 0)
    if total == 0:
        return {
            "name": spec.name,
            "total": 0,
            "compliance": None,
            "met": True,
            "exact": True,
        }
    k = bisect.bisect_right(bounds, float(spec.threshold_s))
    good = sum(counts[:k])
    exact = (
        k > 0 and k <= len(bounds) and bounds[k - 1] == float(spec.threshold_s)
    ) or float(spec.threshold_s) in bounds
    compliance = good / total
    budget = spec.budget
    return {
        "name": spec.name,
        "threshold_s": spec.threshold_s,
        "objective": spec.objective,
        "total": total,
        "bad": total - good,
        "compliance": round(compliance, 6),
        "met": compliance >= spec.objective,
        "budget_spent_frac": round(
            ((total - good) / total) / budget, 4
        ) if budget > 0 else None,
        "exact": bool(exact),
    }


def evaluate_offline(
    specs,
    *,
    histograms: Optional[dict] = None,
    event_totals: Optional[dict] = None,
    gauges: Optional[dict] = None,
) -> dict:
    """Aggregate offline SLO evaluation — the loadgen/fabric artifact
    form. ``histograms`` maps source -> banked full histogram dict;
    ``event_totals`` maps source -> {"good": n, "bad": n};
    ``gauges`` maps source -> {label: value}."""
    out: dict = {"slos": {}, "met": True}
    for spec in specs:
        if spec.kind == LATENCY:
            h = (histograms or {}).get(spec.source)
            if h is None:
                continue
            ev = evaluate_histogram(spec, h)
        elif spec.kind == EVENT:
            t = (event_totals or {}).get(spec.source)
            if t is None:
                continue
            good, bad = int(t.get("good", 0)), int(t.get("bad", 0))
            total = good + bad
            compliance = good / total if total else None
            ev = {
                "name": spec.name,
                "objective": spec.objective,
                "total": total,
                "bad": bad,
                "compliance": (
                    round(compliance, 6) if compliance is not None else None
                ),
                "met": compliance is None or compliance >= spec.objective,
                "exact": True,
            }
        else:  # GAUGE_FLOOR: terminal values, one verdict per label
            g = (gauges or {}).get(spec.source)
            if g is None:
                continue
            rows = {
                str(label): {
                    "value": v,
                    "met": v is None or float(v) >= spec.floor,
                }
                for label, v in sorted(g.items())
            }
            ev = {
                "name": spec.name,
                "floor": spec.floor,
                "labels": rows,
                "met": all(r["met"] for r in rows.values()),
                "exact": True,
            }
        out["slos"][spec.name] = ev
        if not ev["met"]:
            out["met"] = False
    return out
