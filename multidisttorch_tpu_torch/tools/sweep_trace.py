"""Per-submission latency breakdown over a sweep service directory.

    python -m multidisttorch_tpu_torch.tools.sweep_trace <service-dir-or-fabric-root>            # list
    python -m multidisttorch_tpu_torch.tools.sweep_trace <dir> <submission-id>                   # one
    python -m multidisttorch_tpu_torch.tools.sweep_trace <dir> --worst                           # p99 offender
    python -m multidisttorch_tpu_torch.tools.sweep_trace <dir> --export out/                     # bank files
    python -m multidisttorch_tpu_torch.tools.sweep_trace <dir> <submission-id> --json

Reconstructs one contiguous span tree per submission — offline, from
the durable files alone (queue journal + sweep ledger, telemetry event
shards when present; docs/OBSERVABILITY.md "Tracing & SLOs") — and
renders where the time went: spool wait, admission, fair-share queue,
dataset prefetch, compile wait, per-attempt train, settle. Fabric
roots are walked shard by shard; failover submissions show their spans
tagged with both fence epochs. ``--worst`` jumps straight from the
books' p99 exemplar (queue-wait / placement histograms) to the trace
behind it. Open spans (a SIGKILLed daemon's in-flight work) print as
``open`` — never a fabricated end.

The port's counterpart of the JAX package's ``tools/sweep_trace.py``: the same span trees, text and ``--json``, over
a service directory either package writes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from multidisttorch_tpu_torch.telemetry import trace as ttrace


def fmt_s(v) -> str:
    if v is None:
        return "open"
    if v < 0.001:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    if v < 120.0:
        return f"{v:.2f}s"
    return f"{v / 60.0:.1f}m"


def render_breakdown(bd: dict) -> str:
    lines = [
        f"submission {bd['submission_id']}  trace {bd['trace_id']}",
        f"tenant {bd.get('tenant') or '?'}  state {bd['state']}"
        + (f"/{bd['status']}" if bd.get("status") else "")
        + f"  total {fmt_s(bd['total_s'])}"
        + (
            f"  fence epochs {bd['epochs']}"
            if len(bd.get("epochs") or []) > 1
            else ""
        ),
        "",
        f"{'phase':<24}{'total':>10}",
    ]
    total = bd.get("total_s")
    for phase, v in bd["phase_totals_s"].items():
        pct = f"  {100.0 * v / total:5.1f}%" if total else ""
        lines.append(f"{phase:<24}{fmt_s(v):>10}{pct}")
    lines.append("")
    lines.append(f"{'at':>10}  {'dur':>9}  span")
    for row in bd["spans"]:
        at = f"+{row['at_s']:.3f}s" if row["at_s"] is not None else "?"
        dur = (
            fmt_s(row["dur_s"])
            if not row["open"]
            else "OPEN"
        )
        if row["kind"] == "instant":
            dur = "·"
        tag_bits = []
        # mode/persist_in_flight: the checkpoint drain's snapshot vs
        # background-persist split (docs/RESILIENCE.md).
        for k in (
            "status", "epoch", "requeued", "unplaced_reason",
            "mode", "persist_in_flight",
        ):
            if row["tags"].get(k) not in (None, ""):
                tag_bits.append(f"{k}={row['tags'][k]}")
        tags = ("  [" + ", ".join(tag_bits) + "]") if tag_bits else ""
        lines.append(f"{at:>10}  {dur:>9}  {row['name']}{tags}")
    return "\n".join(lines)


def worst_offenders(root: str) -> list[tuple[str, str, dict]]:
    """(histogram, submission id, exemplar) rows from every shard's
    service books — the percentile→trace jump."""
    out = []
    for sdir in ttrace.service_dirs_of(root):
        try:
            with open(os.path.join(sdir, "service_books.json")) as f:
                books = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        for key in ("queue_wait", "placement_latency"):
            ex = (books.get(key) or {}).get("p99_exemplar")
            if ex and ex.get("id"):
                out.append((key, str(ex["id"]), ex))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="per-submission trace/latency breakdown "
        "(docs/OBSERVABILITY.md)"
    )
    parser.add_argument("path", help="service dir or fabric root")
    parser.add_argument("submission", nargs="?", default=None)
    parser.add_argument(
        "--worst", action="store_true",
        help="render the books' p99 exemplar submissions (queue-wait "
        "and placement worst offenders)",
    )
    parser.add_argument(
        "--export", metavar="DIR", default=None,
        help="write submission_spans.json + the Perfetto trace",
    )
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    if args.export is not None:
        out = ttrace.export_traces(args.path, args.export)
        print(json.dumps(out, indent=1, default=str))
        return 0 if out["completeness"]["complete"] else 1

    traces = ttrace.build_submission_traces(args.path)
    if not traces:
        print(f"no submissions found under {args.path}", file=sys.stderr)
        return 1

    targets: list[str] = []
    if args.worst:
        rows = worst_offenders(args.path)
        if not rows:
            print(
                "no p99 exemplars in the books (no service_books.json, "
                "or histograms empty)",
                file=sys.stderr,
            )
            return 1
        for key, sid, ex in rows:
            print(
                f"# {key} p99 worst offender: {sid} "
                f"({fmt_s(ex.get('value_s'))})"
            )
            if sid in traces and sid not in targets:
                targets.append(sid)
    elif args.submission is not None:
        if args.submission not in traces:
            # Accept a trace id too.
            hit = [
                sid
                for sid, tr in traces.items()
                if tr["trace_id"] == args.submission
            ]
            if not hit:
                print(
                    f"unknown submission/trace id {args.submission!r}",
                    file=sys.stderr,
                )
                return 1
            targets = hit[:1]
        else:
            targets = [args.submission]
    else:
        # Listing: one row per submission, slowest first.
        rows = []
        for sid, tr in traces.items():
            bd = ttrace.latency_breakdown(tr)
            rows.append((bd["total_s"] if bd["total_s"] else -1.0, bd))
        rows.sort(key=lambda r: -(r[0] if r[0] is not None else -1.0))
        if args.json:
            print(
                json.dumps(
                    [bd for _, bd in rows], indent=1, default=str
                )
            )
            return 0
        comp = ttrace.trace_completeness(traces)
        print(
            f"{len(traces)} submissions  settled "
            f"{comp['settled']}  complete "
            f"{comp['settled_complete']}/{comp['settled']}  orphans "
            f"{comp['orphan_spans']}  takeovers "
            f"{comp['epoch_takeovers']}"
        )
        print(f"{'total':>9}  {'state':<10} {'tenant':<10} submission")
        for _, bd in rows:
            print(
                f"{fmt_s(bd['total_s']):>9}  "
                f"{(bd['status'] or bd['state']):<10} "
                f"{(bd.get('tenant') or '?'):<10} "
                f"{bd['submission_id']}  [{bd['trace_id']}]"
            )
        return 0

    outs = [ttrace.latency_breakdown(traces[sid]) for sid in targets]
    if args.json:
        print(json.dumps(outs if len(outs) > 1 else outs[0],
                         indent=1, default=str))
    else:
        for bd in outs:
            print(render_breakdown(bd))
            print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
