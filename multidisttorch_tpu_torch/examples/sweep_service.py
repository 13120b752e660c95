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

``--fabric`` runs the process as one replica of the sharded service fabric
(``service/fabric.py``): it claims its home shard ``--replica`` of
``--n-shards`` (default ``MDT_HOST_SLOT``), renews its leases, and adopts a
peer's shard whose lease went stale past ``--lease-deadline``. Two replicas
over one directory, each on its own card's slots or both on one card:
    python -m multidisttorch_tpu_torch.examples.sweep_service DIR --fabric --replica 0 --n-shards 2 --slices 2
    python -m multidisttorch_tpu_torch.examples.sweep_service DIR --fabric --replica 1 --n-shards 2 --slices 2
(``--device cpu`` on the CPU.) Clients submit through
``service.fabric.FabricClient``. ``--fault-plan`` arms a FaultPlan against
the replica's dispatch clock (``daemon_lost`` SIGKILLs it), its fired log
at ``DIR/fabric/fired-<replica>.jsonl``. A fabric replica's telemetry goes
to ``DIR/telemetry/replica-<replica>/`` and it prints ``BOOT`` and
``LAUNCHES`` as the plain daemon does, and its report (adoptions, fences
lost, splits, steal grants, its longest turn and longest gap between
renewals beside the lease deadline) as its last line. ``--split-queue-depth``
splits an owned shard whose queue reaches that depth (at most one split per
``--split-min-interval`` seconds); ``--steal-threshold`` lets an idle shard
of this replica steal up to ``--steal-batch`` queued submissions from a
shard whose queue reaches that depth. Both are off by default: the topology
stays static. A due ``shard_split_lost`` of ``--fault-plan`` SIGKILLs the
replica between two records of a split's handoff.
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
    """The ELBO kernels' launch counts, the kernel builds' seconds, the
    device books' counted steps (one eager step per program new to the
    process when telemetry is on: ``single`` ones launch the single kernels
    once more, ``bucket`` ones the lane kernels), and what the process still
    holds: the program registry's slots and the card's allocated bytes."""
    import torch

    from multidisttorch_tpu_torch.compile.registry import get_executable_registry
    from multidisttorch_tpu_torch.ops import _build, elbo
    from multidisttorch_tpu_torch.telemetry import device as tdevice

    by_kind = tdevice.counted_steps()
    counted = {kind: by_kind.get(kind, 0) for kind in ("single", "bucket")}
    slots = get_executable_registry().snapshot()
    registry = {"programs": len(slots), "held": sum(1 for e in slots.values() if e["held"])}
    allocated = torch.cuda.memory_allocated() if torch.cuda.is_initialized() else 0
    print("LAUNCHES " + json.dumps({**elbo.LAUNCHES, "build_seconds": dict(_build.build_seconds),
                                    "counted_steps": counted, "registry": registry,
                                    "device_allocated_bytes": allocated}), flush=True)


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
    parser.add_argument("--fabric", action="store_true",
                        help="run as a service-fabric replica (shard leases, fenced ownership, orphan adoption)")
    parser.add_argument("--replica", type=int, default=None,
                        help="this replica's stable id (default: MDT_HOST_SLOT, else 0)")
    parser.add_argument("--n-shards", type=int, default=2,
                        help="fabric shard count (every replica and client must agree; the first writer pins it)")
    parser.add_argument("--lease-deadline", type=float, default=4.0,
                        help="seconds without a lease renewal before a shard counts orphaned and is adopted "
                             "(default 4.0: about twice the longest replica turn measured on an H100)")
    parser.add_argument("--turn-budget", type=float, default=None,
                        help="fabric: seconds of a replica turn after which the rest of its shards' ticks and "
                             "dispatches wait for the next turn (default: a quarter of --lease-deadline; 0: every "
                             "shard ticks in every turn)")
    parser.add_argument("--split-queue-depth", type=int, default=None,
                        help="fabric: split an owned shard whose queue depth reaches this (default: splits off, "
                             "static topology)")
    parser.add_argument("--split-min-interval", type=float, default=2.0,
                        help="fabric: seconds between split attempts")
    parser.add_argument("--steal-threshold", type=int, default=None,
                        help="fabric: steal queued work for an idle shard from a shard whose queue reaches this "
                             "depth (default: stealing off)")
    parser.add_argument("--steal-batch", type=int, default=2, help="fabric: most submissions per steal grant")
    parser.add_argument("--fault-plan", default=None,
                        help="arm a FaultPlan JSON against this replica's dispatch clock (daemon_lost) and its "
                             "split-handoff clock (shard_split_lost); fired log under SERVICE_DIR/fabric/")
    parser.add_argument("--exit-when-drained", action="store_true",
                        help="exit once queue, spool and slots are idle (default: keep serving)")
    parser.add_argument("--idle-grace", type=float, default=1.0)
    parser.add_argument("--max-wall", type=float, default=None)
    parser.add_argument("--verbose", action="store_true")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Telemetry and membership before the heavy imports: the daemon's
    # observability must exist even if the device's start wedges.
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.parallel import membership

    slot = os.environ.get("MDT_HOST_SLOT")
    replica = args.replica if args.replica is not None else int(slot or 0)
    if not telemetry.enabled():
        # One sink per fabric replica: two replicas over one root would
        # otherwise open and truncate the same events.jsonl.
        tel_dir = os.path.join(args.service_dir, "telemetry")
        telemetry.configure(os.path.join(tel_dir, f"replica-{replica}") if args.fabric else tel_dir)
    if slot is None and args.fabric:
        # A fabric replica always heartbeats its membership lease.
        slot = str(replica)
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
    weights = _parse_kv(args.tenant_weight, float, "tenant-weight")
    quotas = _parse_kv(args.tenant_quota, int, "tenant-quota")
    policies = {
        name: TenantPolicy(weight=weights.get(name, 1.0), max_pending=quotas.get(name, 256))
        for name in set(weights) | set(quotas)
    }
    svc_kwargs = dict(
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
    if args.fabric:
        from multidisttorch_tpu_torch.service.fabric import FabricReplica

        injector = None
        if args.fault_plan:
            from multidisttorch_tpu_torch.faults.inject import FaultInjector
            from multidisttorch_tpu_torch.faults.plan import FaultPlan

            with open(args.fault_plan) as f:
                plan = FaultPlan.from_json(f.read())
            injector = FaultInjector(plan, host_slot=replica,
                                     fired_log=os.path.join(args.service_dir, "fabric", f"fired-{replica}.jsonl"))
        svc = FabricReplica(args.service_dir, replica=replica, n_shards=args.n_shards,
                            lease_deadline_s=args.lease_deadline, injector=injector,
                            split_queue_depth=args.split_queue_depth, split_min_interval_s=args.split_min_interval,
                            steal_threshold=args.steal_threshold, steal_batch=args.steal_batch,
                            turn_budget_s=(args.lease_deadline / 4.0 if args.turn_budget is None
                                           else args.turn_budget), **svc_kwargs)
        # The device's start, before any claim (FabricReplica._warm_backend):
        # its context, first allocation, the kernels' library and cuBLAS.
        svc._warm_backend()
        t_device = time.time()
    else:
        for dev in sorted({str(d) for d in slots}):
            if dev.startswith("cuda"):
                # The device's start: its context and first allocation.
                torch.zeros(1, device=dev).add_(1).item()
        t_device = time.time()
        svc = SweepService(args.service_dir, **svc_kwargs)
    print("BOOT " + json.dumps({
        "device": sorted({str(d) for d in slots}), "slots": len(slots), "main_s": _AGE0,
        **({"replica": replica} if args.fabric else {}),
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
    print(json.dumps({k: v for k, v in report.items() if k not in ("settled", "books")}
                     | {"settled": len(report["settled"])}), flush=True)
    if report["outcome"] == "preempted":
        return PREEMPTION_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
