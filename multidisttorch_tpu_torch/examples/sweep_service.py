"""The sweep service daemon CLI (docs/SERVICE.md); the port's counterpart of
``tools/sweep_service.py``, with the same flags and exit codes.

On the card (every visible card's slots):
    python -m multidisttorch_tpu_torch.examples.sweep_service SERVICE_DIR --slices 4 \
        --tenant-weight alice=2 --tenant-weight bob=1 --retry 2
On the CPU:
    python -m multidisttorch_tpu_torch.examples.sweep_service SERVICE_DIR --device cpu --slices 2

Runs :class:`~multidisttorch_tpu_torch.service.runtime.SweepService` over
the directory until stopped. All state is durable under the directory, so a
killed daemon (SIGKILL included) restarts with zero lost submissions.
``--slices`` is the number of device slots (``service/runtime.py``,
"Slots"): on one card, ``--slices 4`` is four slots on ``cuda:0``.

Signals follow ``run_hpo``'s drain contract: the first SIGTERM or SIGINT
drains (in-flight checkpoint writes land, live attempts are recorded
``preempted``, submissions are journaled ``unplaced`` and re-place on
restart, the books are written) and the process exits
``cluster.PREEMPTION_EXIT_CODE`` (75); a second signal kills at once. Under
the elastic supervisor (``examples/sweep_supervisor.py --hosts 1 -- python
-m multidisttorch_tpu_torch.examples.sweep_service ...``) that code means
"relaunch me". With ``MDT_HOST_SLOT`` set the daemon heartbeats a
membership lease, so a wedged daemon is found without a collective.

The daemon prints ``BOOT {...}`` once it is ready to serve: its device, the
process's age when this module started (``main_s``: the interpreter and
the package's import of torch) and when it is ready (``start_s``), the
imports after that, the device's start (CUDA's context and first
allocation on every slot's card) and the service's set-up; and
``LAUNCHES {...}`` when it stops: how many times it launched each ELBO
kernel and the seconds any kernel build of this process took.

``--fabric`` (the sharded service fabric) is ROADMAP A.12b and raises
``NotImplementedError``.
"""

import time

_T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402


def _parse_kv(pairs, cast, what):
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--{what} expects NAME=VALUE, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = cast(v)
    return out


def _process_age_s():
    """Seconds since this process started (Linux ``/proc``), else None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return round(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 3)


_AGE0 = _process_age_s()


def _print_launches() -> None:
    from multidisttorch_tpu_torch.ops import _build, elbo

    print("LAUNCHES " + json.dumps({**elbo.LAUNCHES, "build_seconds": dict(_build.build_seconds)}), flush=True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="persistent multi-tenant sweep daemon")
    parser.add_argument("service_dir")
    parser.add_argument("--slices", type=int, default=None,
                        help="device slots (default: one per visible card; a multiple of the card count "
                             "gives each card that many slots)")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                        help="train on the card (default) or the CPU")
    parser.add_argument("--max-lanes", type=int, default=4, help="stacked co-pack width per placement")
    parser.add_argument("--tenant-weight", action="append", metavar="NAME=W",
                        help="fair-share weight for a tenant (repeatable)")
    parser.add_argument("--tenant-quota", action="append", metavar="NAME=N",
                        help="max pending submissions per tenant (repeatable)")
    parser.add_argument("--max-total-pending", type=int, default=4096)
    parser.add_argument("--data-rows", type=int, default=512, help="rows of the service's training dataset")
    parser.add_argument("--starvation", type=float, default=3.0,
                        help="seconds a blocked trial waits before defragmentation is considered")
    parser.add_argument("--no-defrag", action="store_true")
    parser.add_argument("--retry", type=int, default=2, help="infra retry budget per trial (0 disables)")
    parser.add_argument("--precompile", action="store_true",
                        help="capture admitted trials' programs on the precapture farm before placement")
    parser.add_argument("--fabric", action="store_true", help="a service-fabric replica (ROADMAP A.12b)")
    parser.add_argument("--exit-when-drained", action="store_true",
                        help="exit once queue, spool and slots are idle (default: keep serving)")
    parser.add_argument("--idle-grace", type=float, default=1.0)
    parser.add_argument("--max-wall", type=float, default=None)
    parser.add_argument("--verbose", action="store_true")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fabric:
        raise NotImplementedError("--fabric (the sharded service fabric) is not ported yet: ROADMAP A.12b")

    # Telemetry and membership before the heavy imports: the daemon's
    # observability must exist even if the device's start wedges.
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.parallel import membership

    slot = os.environ.get("MDT_HOST_SLOT")
    if not telemetry.enabled():
        telemetry.configure(os.path.join(args.service_dir, "telemetry"))
    if slot is not None:
        membership.start_heartbeat(args.service_dir, int(slot),
                                   world_epoch=int(os.environ.get("MDT_WORLD_EPOCH", "0") or 0))

    import torch

    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy, exit_code_for
    from multidisttorch_tpu_torch.parallel.cluster import PREEMPTION_EXIT_CODE
    from multidisttorch_tpu_torch.service.runtime import SweepService, slots_for
    from multidisttorch_tpu_torch.service.scheduler import TenantPolicy

    t_imported = time.time()
    slots = slots_for(None, args.slices, args.device)
    for dev in sorted({str(d) for d in slots}):
        if dev.startswith("cuda"):
            # The device's start: its context and first allocation.
            torch.zeros(1, device=dev).add_(1).item()
    t_device = time.time()

    weights = _parse_kv(args.tenant_weight, float, "tenant-weight")
    quotas = _parse_kv(args.tenant_quota, int, "tenant-quota")
    policies = {
        name: TenantPolicy(weight=weights.get(name, 1.0), max_pending=quotas.get(name, 256))
        for name in set(weights) | set(quotas)
    }
    svc = SweepService(
        args.service_dir,
        devices=slots,
        max_lanes=args.max_lanes,
        policies=policies,
        max_total_pending=args.max_total_pending,
        data_rows=args.data_rows,
        starvation_s=args.starvation,
        defrag_enabled=not args.no_defrag,
        retry=RetryPolicy(max_retries=args.retry) if args.retry else None,
        verbose=args.verbose,
        precompile=args.precompile,
    )
    print("BOOT " + json.dumps({
        "device": sorted({str(d) for d in slots}), "slots": len(slots), "main_s": _AGE0,
        "start_s": _process_age_s(),
        "import_s": round(t_imported - _T0, 3), "device_start_s": round(t_device - t_imported, 3),
        "setup_s": round(time.time() - t_device, 3),
    }), flush=True)

    def on_signal(signum, frame):
        if svc._stop:  # the second signal: the operator means it
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        svc.stop()

    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(s, on_signal)
        except (ValueError, OSError):
            pass

    try:
        report = svc.serve(max_wall_s=args.max_wall, exit_when_drained=args.exit_when_drained,
                           idle_grace_s=args.idle_grace)
    except BaseException as e:  # noqa: BLE001 — the exit-code contract
        membership.stop_heartbeat()
        _print_launches()
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        print(f"sweep service died: {type(e).__name__}: {e}", file=sys.stderr)
        return exit_code_for(e)
    membership.stop_heartbeat()
    _print_launches()
    print(json.dumps({k: report[k] for k in ("outcome", "wall_s")} | {"settled": len(report["settled"])}),
          flush=True)
    if report["outcome"] == "preempted":
        return PREEMPTION_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
