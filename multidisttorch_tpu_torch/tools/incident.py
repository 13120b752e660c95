"""Incident plane CLI: list, inspect, autopsy, resolve.

    python -m multidisttorch_tpu_torch.tools.incident <root>                        # list incidents
    python -m multidisttorch_tpu_torch.tools.incident <root> --json                 # machine form
    python -m multidisttorch_tpu_torch.tools.incident <root> show inc-0001          # one incident
    python -m multidisttorch_tpu_torch.tools.incident <root> report inc-0001        # causal autopsy
    python -m multidisttorch_tpu_torch.tools.incident <root> report inc-0001 --out autopsy/
    python -m multidisttorch_tpu_torch.tools.incident <root> resolve inc-0001 --reason "mitigated"
    python -m multidisttorch_tpu_torch.tools.incident <root> sweep                  # quarantine torn bundles

``<root>`` is any directory holding telemetry (a run dir, a service
dir, a fabric root): every ``incidents.jsonl`` below it is folded.
``report`` walks the durable surfaces (event shards, ledger, lease /
topology / steal streams, span trees, fired faults, ctlprof books,
anomaly captures) and exports the bundle — report JSON, merged Perfetto
slice, affected-trace list, next to the fire-time flight-ring dump.
``sweep`` renames ``*.partial`` bundle dirs (a crash between dump and
publish) to ``*.quarantined`` so nothing mistakes them for whole
bundles. docs/INCIDENTS.md is the verdict cookbook.

The port's counterpart of the JAX package's ``tools/incident.py``: the same folds, text and ``--json``, over the
incident ledgers either package writes. A root that holds a service
fabric is ROADMAP A.12b: ``report`` raises ``NotImplementedError`` there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from multidisttorch_tpu_torch.telemetry import incident as tincident


def fmt_age(ts, now=None) -> str:
    if ts is None:
        return "?"
    dt = (time.time() if now is None else now) - float(ts)
    if dt < 0:
        dt = 0.0
    if dt < 120:
        return f"{dt:.0f}s"
    if dt < 7200:
        return f"{dt / 60:.0f}m"
    return f"{dt / 3600:.1f}h"


def render_list(folded: dict) -> str:
    if not folded:
        return "no incidents on record"
    lines = [
        f"{'id':<10}{'kind':<18}{'subject':<22}{'status':<10}"
        f"{'count':>6}{'flaps':>6}  {'age':>6}"
    ]
    for iid in sorted(folded):
        inc = folded[iid]
        lines.append(
            f"{iid:<10}{str(inc.get('kind')):<18}"
            f"{str(inc.get('subject')):<22}{str(inc.get('status')):<10}"
            f"{inc.get('count', 1):>6}{inc.get('flaps', 0):>6}  "
            f"{fmt_age(inc.get('last_ts')):>6}"
        )
    return "\n".join(lines)


def render_show(inc: dict) -> str:
    lines = [
        f"{inc['id']}  {inc.get('kind')}  [{inc.get('subject')}]  "
        f"{inc.get('status')}",
        f"  first {inc.get('first_ts')}  last {inc.get('last_ts')}  "
        f"count {inc.get('count')}  flaps {inc.get('flaps')}",
    ]
    if inc.get("resolved_reason"):
        lines.append(f"  resolved: {inc['resolved_reason']}")
    if inc.get("detail"):
        lines.append(f"  detail: {json.dumps(inc['detail'], default=str)}")
    for ev in inc.get("evidence") or ():
        lines.append(
            f"  evidence: {ev.get('kind')} ts={ev.get('ts')} "
            f"{json.dumps(ev.get('data') or {}, default=str)[:140]}"
        )
    if inc.get("ledger"):
        lines.append(f"  ledger: {inc['ledger']}")
    return "\n".join(lines)


def _lookup(root: str, iid: str) -> dict:
    folded = tincident.load_incidents(root)
    if iid not in folded:
        raise SystemExit(
            f"unknown incident {iid!r}; known: {sorted(folded) or 'none'}"
        )
    return folded[iid]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="incident ledger viewer + causal autopsy",
    )
    parser.add_argument("root", help="run dir / service dir / fabric root")
    parser.add_argument(
        "cmd", nargs="?", default="list",
        choices=("list", "show", "report", "resolve", "sweep"),
    )
    parser.add_argument("incident", nargs="?", default=None)
    parser.add_argument("--out", default=None, help="report bundle dir")
    parser.add_argument(
        "--window", type=float, default=120.0,
        help="autopsy timeline pad seconds around the incident",
    )
    parser.add_argument("--reason", default="operator resolve")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    if args.cmd in ("show", "report", "resolve") and not args.incident:
        parser.error(f"{args.cmd} needs an incident id")

    if args.cmd == "list":
        folded = tincident.load_incidents(args.root)
        if args.json:
            print(json.dumps(folded, indent=1, default=str))
        else:
            print(render_list(folded))
        return 0

    if args.cmd == "show":
        inc = _lookup(args.root, args.incident)
        print(
            json.dumps(inc, indent=1, default=str)
            if args.json
            else render_show(inc)
        )
        return 0

    if args.cmd == "report":
        report = tincident.build_incident_report(
            args.root, args.incident, args.out, window_s=args.window
        )
        if args.json:
            print(json.dumps(report, indent=1, default=str))
        else:
            print(
                f"verdict: {report['verdict']}  "
                f"[{report['subject']}]"
            )
            print(
                "corroborating surfaces: "
                + (", ".join(report["corroborating_surfaces"]) or "none")
            )
            print(
                f"timeline: {len(report['timeline'])} records"
                + (
                    f" ({report['timeline_elided']} elided)"
                    if report.get("timeline_elided")
                    else ""
                )
            )
            print(f"affected traces: {len(report['affected_traces'])}")
            if report.get("bundle_dir"):
                print(f"bundle: {report['bundle_dir']}")
        return 0

    if args.cmd == "resolve":
        inc = _lookup(args.root, args.incident)
        if inc.get("status") == tincident.RESOLVED:
            print(f"{args.incident} already resolved")
            return 0
        ledger = inc.get("ledger")
        if not ledger:
            raise SystemExit(f"{args.incident} has no ledger on disk")
        tincident._fsync_append(
            ledger,
            {
                "rec": "resolve",
                "id": inc["id"],
                "ts": time.time(),
                "reason": args.reason,
                "count": inc.get("count", 1),
                "flaps": inc.get("flaps", 0),
            },
        )
        print(f"{args.incident} resolved: {args.reason}")
        return 0

    if args.cmd == "sweep":
        swept: list = []
        for led in tincident.discover_incident_ledgers(args.root):
            swept.extend(
                tincident.sweep_partial_bundles(os.path.dirname(led))
            )
        if args.json:
            print(json.dumps({"quarantined": swept}))
        else:
            for p in swept:
                print(f"quarantined {p}")
            print(f"{len(swept)} partial bundle(s) quarantined")
        return 0

    return 2


if __name__ == "__main__":
    raise SystemExit(main())
