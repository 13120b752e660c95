"""Shared terminal formatting for the telemetry tools.

A copy of ``multidisttorch_tpu/telemetry/console.py``, for the port's
chaos drill report and any console over its event stream.

``tools/sweep_top.py`` (live sweep console) and ``tools/ledger_view.py``
(ledger dump) render through these helpers so the two read as one
family: same column alignment, same duration/rate formatting, same
status glyphs.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

STATUS_GLYPHS = {
    "completed": "ok",
    "resumed_complete": "ok*",
    "in_flight": "run",
    "retrying": "retry",
    "diverged": "DIV",
    "failed": "FAIL",
    "preempted": "PREEMPT",
}


def status_glyph(status: str) -> str:
    return STATUS_GLYPHS.get(status, status or "?")


def fmt_duration(s: Optional[float]) -> str:
    """Compact human duration: 950ms / 12.3s / 4m02s / 1h07m."""
    if s is None:
        return "-"
    s = float(s)
    if s < 1.0:
        return f"{s * 1e3:.0f}ms"
    if s < 60.0:
        return f"{s:.1f}s"
    if s < 3600.0:
        m, r = divmod(int(round(s)), 60)
        return f"{m}m{r:02d}s"
    h, r = divmod(int(round(s)), 3600)
    return f"{h}h{r // 60:02d}m"


def fmt_rate(v: Optional[float], unit: str = "/s") -> str:
    if v is None:
        return "-"
    if v >= 1000:
        return f"{v / 1000:.1f}k{unit}"
    if v >= 10:
        return f"{v:.0f}{unit}"
    return f"{v:.2f}{unit}"


def fmt_bytes(v: Optional[float]) -> str:
    """Compact byte count: 512B / 3.4KB / 120MB / 1.5GB."""
    if v is None:
        return "-"
    v = float(v)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if v < 1024.0 or unit == "TB":
            if unit == "B":
                return f"{v:.0f}B"
            return f"{v:.1f}{unit}" if v < 10 else f"{v:.0f}{unit}"
        v /= 1024.0
    return "-"


def fmt_mfu(v: Optional[float]) -> str:
    """MFU as a percent (the device books' utilization verdict)."""
    if v is None:
        return "-"
    return f"{v * 100:.1f}%"


def fmt_ts(ts: Optional[float]) -> str:
    if ts is None:
        return "-"
    return time.strftime("%H:%M:%S", time.localtime(float(ts)))


def fmt_table(
    rows: Sequence[Sequence], headers: Sequence[str], indent: str = ""
) -> str:
    """Fixed-width table: headers, a rule, one line per row. Everything
    is str()'d; column widths fit the widest cell."""
    cells = [[str(c) for c in row] for row in rows]
    widths = [
        max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
        for i, h in enumerate(headers)
    ]
    def line(vals):
        return indent + "  ".join(
            v.ljust(w) for v, w in zip(vals, widths)
        ).rstrip()

    out = [line(list(headers)), indent + "  ".join("-" * w for w in widths)]
    out.extend(line(r) for r in cells)
    return "\n".join(out)


def host_health(
    status: Optional[str],
    age_s: Optional[float],
    deadline_s: float = 3.0,
) -> str:
    """One-word host liveness verdict for the fleet console, from the
    newest lease record's status + age — the same staleness rule the
    supervisor applies (``membership.MembershipView.lost_hosts``)."""
    if status == "left":
        return "left"
    if status == "draining":
        return "drain"
    if age_s is None:
        return "?"
    return "STALE" if age_s > deadline_s else "up"


def clear_screen() -> str:
    """ANSI clear+home, for the --follow refresh loop."""
    return "\x1b[2J\x1b[H"
