"""Human-readable dump of a sweep ledger (``hpo/ledger.py``).

    python -m multidisttorch_tpu_torch.tools.ledger_view <out-dir-or-sweep_ledger.jsonl>

Shows, per config hash: the trial id, the full attempt history
(attempt number, status, error, executed steps), and whether the
config is SETTLED (completed/diverged under that exact config — a
restarted ``run_hpo(resume=True)`` will skip it) or IN-FLIGHT (an
``attempt_start`` with no matching end: the driver died mid-attempt).

Formatting is shared with ``tools/sweep_top.py`` via
``telemetry.console`` so the two tools read as one family.

The port's counterpart of the JAX package's ``tools/ledger_view.py``: the same fold, text and ``--json``, over a
ledger or queue journal either package writes.
"""

from __future__ import annotations

import argparse
import os
import sys

from multidisttorch_tpu_torch.telemetry.console import (
    fmt_duration,
    fmt_table,
    fmt_ts,
    status_glyph,
)

LEDGER_NAME = "sweep_ledger.jsonl"


def resolve_ledger_path(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, LEDGER_NAME)
    return path


def load_ledger(path: str) -> list[dict]:
    # Torn-tail-tolerant JSONL read — same contract as SweepLedger.load
    # but importable without jax (the ledger module pulls no heavy deps
    # either; reuse it).
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

    led = SweepLedger(os.path.dirname(path) or ".", enabled=True)
    led.path = path
    return led.load()


def fold(events: list[dict]) -> dict[str, dict]:
    """config_hash -> {trial_id, attempts: [...], settled, in_flight}."""
    out: dict[str, dict] = {}
    for ev in events:
        h = ev.get("config_hash")
        if not h or ev.get("event") not in ("attempt_start", "attempt_end"):
            continue  # compaction summaries etc. carry no attempt row
        rec = out.setdefault(
            h, {"trial_id": ev.get("trial_id"), "attempts": {}}
        )
        a = int(ev.get("attempt", 0))
        att = rec["attempts"].setdefault(
            a, {"attempt": a, "status": "in_flight", "error": "",
                "steps": None, "ts": ev.get("ts")}
        )
        if ev.get("event") == "attempt_end":
            att["status"] = ev.get("status", "?")
            att["error"] = ev.get("error", "") or ""
            att["ts"] = ev.get("ts")
            s = ev.get("summary") or {}
            steps = s.get("steps", s.get("steps_at_failure"))
            if steps is not None:
                att["steps"] = int(steps)
    for rec in out.values():
        atts = [rec["attempts"][k] for k in sorted(rec["attempts"])]
        rec["attempts"] = atts
        last = atts[-1] if atts else None
        rec["settled"] = bool(
            last and last["status"] in ("completed", "diverged")
        )
        rec["in_flight"] = bool(last and last["status"] == "in_flight")
    return out


def render(folded: dict[str, dict], path: str) -> str:
    lines = [f"sweep ledger  {path}", ""]
    settled = sum(1 for r in folded.values() if r["settled"])
    in_flight = sum(1 for r in folded.values() if r["in_flight"])
    lines.append(
        f"configs {len(folded)}  settled {settled}  in-flight {in_flight}"
        f"  other {len(folded) - settled - in_flight}"
    )
    lines.append("")
    rows = []
    for h, rec in sorted(
        folded.items(), key=lambda kv: (kv[1].get("trial_id") or 0, kv[0])
    ):
        history = " -> ".join(
            f"#{a['attempt']}:{status_glyph(a['status'])}"
            for a in rec["attempts"]
        )
        last = rec["attempts"][-1] if rec["attempts"] else {}
        rows.append(
            [
                rec.get("trial_id", "?"),
                h[:10],
                "SETTLED" if rec["settled"]
                else ("IN-FLIGHT" if rec["in_flight"] else "open"),
                len(rec["attempts"]),
                history,
                last.get("steps") if last.get("steps") is not None else "-",
                fmt_ts(last.get("ts")),
                (last.get("error") or "")[:48],
            ]
        )
    lines.append(
        fmt_table(
            rows,
            ["trial", "config", "state", "att", "history", "steps",
             "last", "error"],
        )
    )
    return "\n".join(lines)


def render_queue(folded: dict[str, dict], path: str) -> str:
    """Service-queue panel: every submission's lifecycle state with
    tenant, age, and shape bucket (docs/SERVICE.md)."""
    import time

    from multidisttorch_tpu_torch.service.queue import QueueStats

    now = time.time()
    stats = QueueStats.of(folded)
    lines = [f"service queue  {path}", ""]
    lines.append(
        "  ".join(
            f"{state} {n}"
            for state, n in sorted(stats.by_state.items())
        )
        or "empty"
    )
    lines.append("")
    rows = []
    order = {"placed": 0, "admitted": 1, "pending": 2, "settled": 3,
             "rejected": 4}
    for sid, rec in sorted(
        folded.items(),
        key=lambda kv: (
            order.get(kv[1]["state"], 9), kv[1].get("submit_ts") or 0.0
        ),
    ):
        age = (
            fmt_duration(now - rec["submit_ts"])
            if rec.get("submit_ts")
            else "-"
        )
        rows.append(
            [
                sid[:24],
                rec.get("tenant", "?"),
                rec.get("priority", "-"),
                rec["state"],
                rec.get("trial_id") if rec.get("trial_id") is not None
                else "-",
                rec.get("size", 1),
                (rec.get("bucket") or "-")[:24],
                age,
                (rec.get("status") or "")[:12],
                (rec.get("error") or "")[:32],
            ]
        )
    lines.append(
        fmt_table(
            rows,
            ["submission", "tenant", "pri", "state", "trial", "size",
             "bucket", "age", "status", "error"],
        )
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="human-readable sweep-ledger dump "
        "(attempt history per config hash, settled vs in-flight)"
    )
    parser.add_argument(
        "path",
        help="sweep out-dir (containing sweep_ledger.jsonl) or the file",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable snapshot of the same fold (per-config "
        "attempt history, settled/in-flight) instead of the rendered "
        "table — for CI and scripts",
    )
    parser.add_argument(
        "--compact", action="store_true",
        help="atomically rewrite the ledger to its minimal equivalent "
        "state first (SweepLedger.compact: latest attempt_start/_end "
        "per config hash + a summary record carrying the attempt and "
        "infra-failure counters) — restart storms grow the attempt "
        "history without bound; this caps it. Torn-tail safe; the "
        "restart folds (settled-skip, attempt numbering, retry "
        "budgets) are provably unchanged",
    )
    parser.add_argument(
        "--queue", action="store_true",
        help="render the sweep SERVICE's submission queue instead of "
        "the attempt ledger: pending/admitted/placed/settled "
        "submissions with tenant, age, and shape bucket "
        "(docs/SERVICE.md; reads {dir}/queue.jsonl)",
    )
    args = parser.parse_args(argv)
    if args.queue:
        from multidisttorch_tpu_torch.service.queue import (
            fold_queue,
            load_queue,
            queue_path,
        )

        service_dir = (
            args.path if os.path.isdir(args.path)
            else os.path.dirname(args.path) or "."
        )
        qpath = queue_path(service_dir)
        folded = fold_queue(load_queue(service_dir))
        if args.json:
            import json

            print(json.dumps(
                {"path": qpath, "by_submission": folded}, default=str
            ))
            return 0
        if not folded:
            print(f"no decodable queue records at {qpath}")
            return 0 if os.path.exists(qpath) else 1
        print(render_queue(folded, qpath))
        return 0
    path = resolve_ledger_path(args.path)
    if not os.path.exists(path):
        print(f"no ledger at {path}", file=sys.stderr)
        return 1
    if args.compact:
        from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

        led = SweepLedger(os.path.dirname(path) or ".", enabled=True)
        led.path = path
        stats = led.compact()
        print(
            f"compacted {path}: {stats['lines_before']} -> "
            f"{stats['lines_after']} lines over {stats['hashes']} "
            "configs",
            file=sys.stderr,
        )
    events = load_ledger(path)
    folded = fold(events)
    if args.json:
        import json

        print(
            json.dumps(
                {
                    "path": path,
                    "configs": len(folded),
                    "settled": sum(
                        1 for r in folded.values() if r["settled"]
                    ),
                    "in_flight": sum(
                        1 for r in folded.values() if r["in_flight"]
                    ),
                    "by_config": folded,
                },
                default=str,
            )
        )
        return 0
    if not events:
        print(f"ledger at {path} holds no decodable events")
        return 0
    print(render(folded, path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
