"""Submit trials to a running sweep service (docs/SERVICE.md); the port's
counterpart of the JAX package's submit tool, with the same flags.

    python -m multidisttorch_tpu_torch.examples.sweep_submit SERVICE_DIR --tenant alice \
        --lr 1e-3 --epochs 3 --hidden-dim 400 [--dataset REF] [--count 4] [--wait]

The transport is the durable file spool (``service/queue.py``): a
submission is committed the moment this command prints its id. The daemon
(``examples/sweep_service.py``) picks it up on its next intake scan, and a
daemon that is down picks it up when it starts. ``--wait`` blocks until
every submitted trial settles (or the deadline passes) and exits non-zero
if any failed. Submitting needs no card: it only writes the spool.
"""

from __future__ import annotations

import argparse
import json
import sys

from multidisttorch_tpu_torch.service.queue import SweepClient


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="submit trials to a sweep service directory"
    )
    parser.add_argument("service_dir")
    parser.add_argument("--tenant", default="default")
    parser.add_argument(
        "--priority", type=int, default=1,
        help="priority lane (0 served strictly before 1 before 2)",
    )
    parser.add_argument(
        "--size", type=int, default=1,
        help="submesh footprint in slices (contiguous; >1 = large-shape)",
    )
    parser.add_argument(
        "--deadline", type=float, default=None,
        help="deadline in seconds from submission: EDF-orders the "
        "trial inside your fair share and may checkpoint-drain "
        "preempt best-effort lanes within the anti-thrash budget "
        "(docs/SERVICE.md \"Deadlines\"); hits/misses land in the "
        "books — an overdue trial is never killed",
    )
    parser.add_argument(
        "--count", type=int, default=1,
        help="submit N copies with seeds seed, seed+1, ...",
    )
    parser.add_argument(
        "--wait", action="store_true",
        help="block until every submission settles; exit 1 on failures",
    )
    parser.add_argument("--wait-timeout", type=float, default=600.0)
    parser.add_argument("--json", action="store_true",
                        help="machine-readable submission receipt")
    # TrialConfig knobs (hpo/driver.py defaults apply when omitted).
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--beta", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hidden-dim", type=int, default=None)
    parser.add_argument("--latent-dim", type=int, default=None)
    parser.add_argument("--fused-steps", type=int, default=None)
    parser.add_argument(
        "--dataset", default=None,
        help="per-submission dataset reference (docs/DATA.md): "
        "'synthetic-mnist?rows=512&seed=3', 'file:<path>.npz', or "
        "'cas:<sha256>' — resolved against the service's "
        "content-addressed cache at admission; omitted = the "
        "service's shared dataset",
    )
    args = parser.parse_args(argv)

    cfg = {}
    for field, value in (
        ("epochs", args.epochs),
        ("batch_size", args.batch_size),
        ("lr", args.lr),
        ("beta", args.beta),
        ("hidden_dim", args.hidden_dim),
        ("latent_dim", args.latent_dim),
        ("fused_steps", args.fused_steps),
        ("dataset", args.dataset),
    ):
        if value is not None:
            cfg[field] = value

    client = SweepClient(args.service_dir, tenant=args.tenant)
    ids = []
    traces = {}
    for k in range(args.count):
        sid = client.submit(
            {**cfg, "seed": args.seed + k},
            priority=args.priority,
            size=args.size,
            deadline_s=args.deadline,
        )
        ids.append(sid)
        # The trace id minted with the submission, which joins its whole
        # lifecycle in the trace builder (telemetry/trace.py).
        traces[sid] = client.last_submission.trace_id
    if args.json:
        print(
            json.dumps(
                {
                    "submitted": ids,
                    "tenant": args.tenant,
                    "traces": traces,
                }
            )
        )
    else:
        for s in ids:
            print(f"{s}  trace={traces[s]}")
    if not args.wait:
        return 0
    final = client.wait(ids, timeout_s=args.wait_timeout)
    bad = {
        s: r
        for s, r in final.items()
        if r.get("status") not in ("completed", "diverged")
    }
    if args.json:
        print(json.dumps({"final": final}, default=str))
    else:
        for s, r in sorted(final.items()):
            print(f"{s}: {r.get('state')}/{r.get('status')}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
