"""Elastic multi-host sweep supervisor: launch N worker hosts, detect a
lost or wedged host, and re-form a smaller world that finishes the sweep
against the ledger. The port's counterpart of ``tools/sweep_supervisor.py``
(the same constructor arguments, report keys, flags and events).

On the card (every worker process on this host's cards; one group each):
    python -m multidisttorch_tpu_torch.examples.sweep_supervisor --hosts 3 --run-dir out/sweep \
        -- python -m multidisttorch_tpu_torch.examples.elastic_worker chaos_sweep out/sweep
On the CPU (gloo):
    python -m multidisttorch_tpu_torch.examples.sweep_supervisor --hosts 3 --run-dir out/sweep \
        -- python -m multidisttorch_tpu_torch.examples.elastic_worker chaos_sweep out/sweep --device cpu

The loop rests on three contracts:

- **Membership** (``parallel/membership.py``): each worker heartbeats a
  lease file under ``{run_dir}/membership/``; a stale lease on a
  still-running process means "wedged", detected without a collective.
- **Exit codes**: a worker that dies because the *world* failed around
  it (preemption, ``WedgedCollective``, the SIGTERM drain) exits
  ``cluster.PREEMPTION_EXIT_CODE`` (75) and is re-admitted; any other
  non-zero exit (or a stale lease) marks the host slot lost.
- **Ledger-driven restart**: the relaunched world runs
  ``run_hpo(resume="scan")``: settled trials are skipped, in-flight trials
  resume from their last valid checkpoint. Between worlds the supervisor
  compacts the attempt history (``SweepLedger.compact``).

The supervisor is also a telemetry emitter: it opens its own event stream
under ``{run_dir}/telemetry/sup`` (unless the caller configured one), emits
``world_start`` / ``world_end`` around every world and measures the
**restart tax** of every shrink live (``detect``: the lost host's last
heartbeat to the trigger; ``drain``: the old world's teardown;
``relaunch``: the new world spawned) as a ``restart_tax`` event, which the
fleet merge (``telemetry/fleet.py``) completes with the restore and
first-useful-step phases from the workers' streams. With ``--preflight`` it
runs the port's backend preflight (``utils/preflight.py``) before the first
world: an unusable verdict aborts the launch instead of wedging N workers.
On exit it writes the merged fleet artifacts (``telemetry/fleet/``).

Worker environment per world: ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``
over the surviving slots (what ``parallel/cluster.py::detect_process_env``
reads first), ``MASTER_ADDR`` and a fresh ``MASTER_PORT`` per world (the
world's store; no TIME_WAIT collisions), ``MDT_HOST_SLOT`` (the stable host
identity across worlds), ``MDT_WORLD_EPOCH`` and ``MDT_ELASTIC_RUN_DIR``.
The worker processes of one machine share its cards (``LOCAL_RANK`` modulo
the visible cards); nothing on the drill's path forms an NCCL communicator,
so several ranks may share one card.

Service-fabric worlds (``examples/sweep_service.py --fabric`` replicas,
the JAX package's ``tools/sweep_service.py --fabric``, as the worker
command) need the sharded service fabric, which is not ported (ROADMAP
A.12b: the port's ``--fabric`` raises); the worker command is the
caller's, so the supervisor itself does not refuse one.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

from multidisttorch_tpu_torch.parallel.cluster import PREEMPTION_EXIT_CODE
from multidisttorch_tpu_torch.parallel.membership import MembershipView, emit_event, record_world


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ElasticSupervisor:
    """One sweep's supervision loop: worlds of worker processes, shrunk
    on host loss until the sweep completes (all workers exit 0) or no
    hosts remain.

    ``worker_argv`` is launched once per host per world; everything
    world-specific arrives via environment. ``boot_grace_s`` suppresses
    staleness verdicts while a freshly-launched worker is still
    bringing up its runtime (no lease yet, or an old world's lease): keep
    it above a worker's start (``import torch`` and CUDA's start take 8-9 s
    on an H100 host). ``devs_per_host`` reaches the worker as
    ``MH_DEVS_PER_PROC``; the port's worker trains one group per process
    on one device.
    """

    def __init__(
        self,
        worker_argv: list[str],
        run_dir: str,
        nhosts: int,
        *,
        devs_per_host: int = 2,
        heartbeat_deadline_s: float = 3.0,
        poll_s: float = 0.2,
        boot_grace_s: float = 60.0,
        drain_grace_s: float = 20.0,
        max_worlds: int = 8,
        world_timeout_s: float = 600.0,
        env_extra: Optional[dict] = None,
        compact_ledger: bool = True,
        log_dir: Optional[str] = None,
        preflight: bool = False,
        preflight_platform: Optional[str] = None,
        preflight_timeout_s: float = 60.0,
        export_fleet: bool = True,
    ):
        self.worker_argv = list(worker_argv)
        self.run_dir = run_dir
        self.nhosts = int(nhosts)
        self.devs_per_host = int(devs_per_host)
        self.heartbeat_deadline_s = float(heartbeat_deadline_s)
        self.poll_s = float(poll_s)
        self.boot_grace_s = float(boot_grace_s)
        self.drain_grace_s = float(drain_grace_s)
        self.max_worlds = int(max_worlds)
        self.world_timeout_s = float(world_timeout_s)
        self.env_extra = dict(env_extra or {})
        self.compact_ledger = compact_ledger
        self.log_dir = log_dir or os.path.join(run_dir, "logs")
        self.preflight = preflight
        self.preflight_platform = preflight_platform
        self.preflight_timeout_s = float(preflight_timeout_s)
        self.export_fleet = export_fleet
        self.view = MembershipView(run_dir)
        self.worlds: list[dict] = []  # report timeline
        self.restart_taxes: list[dict] = []  # live-measured phases
        self.preflight_report: Optional[dict] = None
        self.fleet: Optional[dict] = None  # exported artifact paths

    # -- world lifecycle ---------------------------------------------

    def _launch_world(self, epoch: int, slots: list[int]) -> dict:
        os.makedirs(self.log_dir, exist_ok=True)
        port = _free_port()
        procs: dict[int, dict] = {}
        for rank, slot in enumerate(sorted(slots)):
            env = dict(os.environ)
            env.update(
                WORLD_SIZE=str(len(slots)),
                RANK=str(rank),
                LOCAL_RANK=str(rank),
                MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port),
                MH_DEVS_PER_PROC=str(self.devs_per_host),
                MDT_HOST_SLOT=str(slot),
                MDT_WORLD_EPOCH=str(epoch),
                MDT_ELASTIC_RUN_DIR=self.run_dir,
                **self.env_extra,
            )
            log_path = os.path.join(self.log_dir, f"w{epoch}-h{slot}.log")
            log_f = open(log_path, "w")
            p = subprocess.Popen(
                self.worker_argv,
                env=env,
                stdout=log_f,
                stderr=subprocess.STDOUT,
                text=True,
            )
            procs[slot] = {
                "proc": p,
                "log": log_path,
                "log_f": log_f,
                "started": time.time(),
                "exit": None,
                "killed_by_us": False,
            }
        return procs

    def _poll_exits(self, procs: dict) -> None:
        for info in procs.values():
            if info["exit"] is None:
                rc = info["proc"].poll()
                if rc is not None:
                    info["exit"] = rc
                    info["log_f"].close()

    def _stale_slots(self, procs: dict, epoch: int) -> list[int]:
        """Running workers whose lease went stale — the wedge verdict.

        Epoch-aware: once a worker has beaten in THIS world, staleness
        applies immediately (a wedged host stops mid-run, long after
        boot). A worker with no current-world lease yet is judged only
        after the boot grace — its newest record may be a dead world's
        tail, not evidence about this one."""
        now = time.time()
        leases = self.view.hosts()
        stale = []
        for slot, info in procs.items():
            if info["exit"] is not None:
                continue
            rec = leases.get(slot)
            current = (
                rec is not None
                and int(rec.get("world_epoch", -1)) == epoch
                and rec.get("status") != "left"
            )
            if current:
                if now - float(rec.get("ts", 0.0)) > self.heartbeat_deadline_s:
                    stale.append(slot)
            elif now - info["started"] > self.boot_grace_s:
                stale.append(slot)
        return sorted(stale)

    def _shutdown_world(self, procs: dict) -> None:
        """Drain-then-kill every still-running worker: SIGTERM triggers
        run_hpo's graceful drain (pending checkpoints land, ledger
        records the preemption), SIGKILL reaps whatever ignores it."""
        running = [i for i in procs.values() if i["exit"] is None]
        for info in running:
            info["killed_by_us"] = True
            try:
                info["proc"].send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.time() + self.drain_grace_s
        while time.time() < deadline:
            self._poll_exits(procs)
            if all(i["exit"] is not None for i in procs.values()):
                break
            time.sleep(self.poll_s)
        for info in procs.values():
            if info["exit"] is None:
                try:
                    info["proc"].kill()
                except OSError:
                    pass
        for info in procs.values():
            if info["exit"] is None:
                try:
                    info["proc"].wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
                info["exit"] = info["proc"].poll()
                try:
                    info["log_f"].close()
                except OSError:
                    pass

    def _classify(self, procs: dict, stale: list[int]) -> dict:
        """Post-shutdown verdict per slot: LOST (hard exit or stale
        lease) vs SURVIVOR (exit 0, preemption exit, or killed by the
        supervisor's own drain)."""
        lost, survivors = [], []
        for slot, info in sorted(procs.items()):
            rc = info["exit"]
            if slot in stale:
                lost.append(slot)
            elif rc in (0, PREEMPTION_EXIT_CODE):
                survivors.append(slot)
            elif info["killed_by_us"]:
                survivors.append(slot)  # our own drain/kill, not a fault
            else:
                lost.append(slot)
        return {"lost": lost, "survivors": survivors}

    def _maybe_compact(self) -> Optional[dict]:
        if not self.compact_ledger:
            return None
        try:
            from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

            return SweepLedger(self.run_dir).compact()
        except Exception as e:  # noqa: BLE001 — compaction is best-effort
            return {"error": f"{type(e).__name__}: {e}"}

    def _run_preflight(self) -> None:
        """Probe the backend before forming a world: a wedged or absent
        backend becomes a classified abort instead of N workers hanging
        into the boot grace. Emits ``preflight_*`` telemetry."""
        from multidisttorch_tpu_torch.utils.preflight import run_preflight

        t = int(self.preflight_timeout_s)
        report = run_preflight(
            self.preflight_platform,
            init_timeout_s=t,
            retry_timeout_s=max(1, t // 2),
            canary_timeout_s=t,
        )
        self.preflight_report = report
        if not report["usable"]:
            raise RuntimeError(
                "supervisor: backend preflight verdict "
                f"{report['verdict']!r} ({report['verdict_reason']}) — "
                "refusing to form a world on a diagnosed-bad backend"
            )

    # -- the loop -----------------------------------------------------

    def run(self) -> dict:
        """Supervise the sweep. Opens a supervisor telemetry stream
        (``{run_dir}/telemetry/sup``) unless one is already configured,
        and ALWAYS lands the merged fleet artifacts on the way out —
        a failed sweep needs its fleet story more than a clean one."""
        from multidisttorch_tpu_torch import telemetry as _telemetry

        own_telemetry = not _telemetry.enabled()
        if own_telemetry:
            _telemetry.configure(
                os.path.join(self.run_dir, "telemetry", "sup")
            )
        report = None
        try:
            report = self._run()
            return report
        finally:
            if self.export_fleet:
                try:
                    from multidisttorch_tpu_torch.telemetry.fleet import export_fleet

                    self.fleet = export_fleet(self.run_dir)["paths"]
                except Exception as e:  # noqa: BLE001 — best-effort
                    self.fleet = {"error": f"{type(e).__name__}: {e}"}
                if report is not None:
                    report["fleet"] = self.fleet
            if own_telemetry:
                _telemetry.disable()

    def _run(self) -> dict:
        if self.preflight:
            self._run_preflight()
        slots = list(range(self.nhosts))
        epoch = 0
        pending_tax: Optional[dict] = None
        while True:
            if epoch >= self.max_worlds:
                raise RuntimeError(
                    f"supervisor: {epoch} worlds formed without sweep "
                    "completion — the fault rate is outrunning recovery"
                )
            t0 = time.time()
            if epoch == 0:
                record_world(self.run_dir, epoch=0, hosts=slots)
            procs = self._launch_world(epoch, slots)
            emit_event("world_start", epoch=epoch, hosts=list(slots))
            if pending_tax is not None:
                # Relaunch phase closes the moment the replacement
                # world's processes exist; the restore / first-useful-
                # step phases live in the WORKERS' streams — the fleet
                # merge (telemetry/fleet.py) joins them onto this event.
                pending_tax["relaunch_s"] = round(
                    time.time() - pending_tax.pop("_teardown_done"), 3
                )
                pending_tax["world_epoch"] = epoch
                emit_event("restart_tax", **pending_tax)
                self.restart_taxes.append(pending_tax)
                pending_tax = None
            trigger = None
            while trigger is None:
                self._poll_exits(procs)
                exits = {s: i["exit"] for s, i in procs.items()}
                if all(rc == 0 for rc in exits.values()):
                    trigger = ("complete", [])
                    break
                hard = [
                    s
                    for s, rc in exits.items()
                    if rc not in (None, 0, PREEMPTION_EXIT_CODE)
                ]
                preempted = [
                    s for s, rc in exits.items()
                    if rc == PREEMPTION_EXIT_CODE
                ]
                stale = self._stale_slots(procs, epoch)
                if hard or stale:
                    trigger = ("host_lost", sorted(set(hard) | set(stale)))
                elif preempted and all(
                    rc is not None for rc in exits.values()
                ):
                    # Everyone is down, nobody is lost: the world tore
                    # itself down cleanly (a drain, or a wedge whose
                    # victim recovered) — relaunch at full strength.
                    trigger = ("preempted", [])
                elif time.time() - t0 > self.world_timeout_s:
                    trigger = ("world_timeout", list(exits))
                else:
                    time.sleep(self.poll_s)
            kind, lost_now = trigger
            emit_event(
                "world_end",
                epoch=epoch,
                outcome=kind,
                exits={
                    str(s): i["exit"] for s, i in sorted(procs.items())
                },
                wall_s=round(time.time() - t0, 3),
            )
            if kind == "complete":
                self.worlds.append(
                    {
                        "epoch": epoch,
                        "hosts": slots,
                        "outcome": "complete",
                        "exits": {
                            s: i["exit"] for s, i in sorted(procs.items())
                        },
                        "logs": {
                            s: i["log"] for s, i in sorted(procs.items())
                        },
                        "wall_s": round(time.time() - t0, 3),
                    }
                )
                return self._report(success=True)
            if kind == "world_timeout":
                self._shutdown_world(procs)
                self.worlds.append(
                    {
                        "epoch": epoch,
                        "hosts": slots,
                        "outcome": "world_timeout",
                        "exits": {
                            s: i["exit"] for s, i in sorted(procs.items())
                        },
                    }
                )
                raise RuntimeError(
                    f"supervisor: world {epoch} exceeded "
                    f"{self.world_timeout_s:g}s without completing or "
                    "failing — a sync escaped its watchdog"
                )
            # host_lost or preempted: tear down, classify, re-form.
            # Restart-tax detect phase: the gap between the last
            # heartbeat any lost host managed and THIS trigger moment —
            # how long the fault existed before the supervisor saw it.
            trigger_ts = time.time()
            leases = self.view.hosts()
            victim_beats = [
                float(leases[s].get("ts", 0.0))
                for s in lost_now
                if s in leases
            ]
            detect_s = (
                round(trigger_ts - max(victim_beats), 3)
                if victim_beats
                else 0.0
            )
            stale = self._stale_slots(procs, epoch)
            drain_t0 = time.time()
            self._shutdown_world(procs)
            pending_tax = {
                "trigger": kind,
                "lost": sorted(lost_now),
                "detect_s": detect_s,
                "drain_s": round(time.time() - drain_t0, 3),
                "_teardown_done": time.time(),
            }
            verdict = self._classify(procs, sorted(set(lost_now) | set(stale)))
            for slot in verdict["lost"]:
                emit_event(
                    "host_lost",
                    slot=slot,
                    world_epoch=epoch,
                    exit=procs[slot]["exit"],
                    stale=slot in stale,
                )
            self.worlds.append(
                {
                    "epoch": epoch,
                    "hosts": slots,
                    "outcome": kind,
                    "lost": verdict["lost"],
                    "exits": {
                        s: i["exit"] for s, i in sorted(procs.items())
                    },
                    "logs": {s: i["log"] for s, i in sorted(procs.items())},
                    "wall_s": round(time.time() - t0, 3),
                }
            )
            slots = [s for s in slots if s not in verdict["lost"]]
            if not slots:
                raise RuntimeError(
                    "supervisor: every host slot lost; nothing left to "
                    "re-form a world from"
                )
            compact_stats = self._maybe_compact()
            record_world(
                self.run_dir,
                epoch=epoch + 1,
                hosts=slots,
                lost=verdict["lost"],
                reason=kind,
            )
            if compact_stats is not None:
                self.worlds[-1]["ledger_compaction"] = compact_stats
            epoch += 1

    def _report(self, *, success: bool) -> dict:
        all_lost = sorted(
            {s for w in self.worlds for s in w.get("lost", [])}
        )
        return {
            "success": success,
            "worlds": self.worlds,
            "worlds_formed": len(self.worlds),
            "hosts_initial": self.nhosts,
            "hosts_final": len(self.worlds[-1]["hosts"]),
            "hosts_lost": all_lost,
            "restart_tax": self.restart_taxes,
            "preflight": self.preflight_report,
            "run_dir": self.run_dir,
            "log_dir": self.log_dir,
        }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="elastic multi-host sweep supervisor (PyTorch/CUDA port); worker argv follows `--`"
    )
    parser.add_argument("--hosts", type=int, required=True)
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--devs-per-host", type=int, default=2)
    parser.add_argument("--heartbeat-deadline", type=float, default=3.0)
    parser.add_argument("--max-worlds", type=int, default=8)
    parser.add_argument("--world-timeout", type=float, default=600.0)
    parser.add_argument(
        "--no-compact", action="store_true",
        help="skip ledger compaction between worlds",
    )
    parser.add_argument(
        "--preflight", action="store_true",
        help="run the classified backend preflight (utils/preflight.py) before forming the first "
        "world; a non-usable verdict aborts the launch instead of wedging N workers",
    )
    parser.add_argument(
        "--preflight-platform", default=None,
        help="platform the preflight probes (default: default backend)",
    )
    parser.add_argument(
        "--preflight-timeout", type=float, default=60.0,
        help="per-stage preflight deadline in seconds",
    )
    parser.add_argument(
        "--no-fleet", action="store_true",
        help="skip merging the fleet artifacts "
        "(telemetry/fleet/) on exit",
    )
    parser.add_argument("worker", nargs=argparse.REMAINDER,
                        help="worker argv (prefix with --)")
    args = parser.parse_args(argv)
    worker = args.worker
    if worker and worker[0] == "--":
        worker = worker[1:]
    if not worker:
        parser.error("worker argv required after --")
    sup = ElasticSupervisor(
        worker,
        args.run_dir,
        args.hosts,
        devs_per_host=args.devs_per_host,
        heartbeat_deadline_s=args.heartbeat_deadline,
        max_worlds=args.max_worlds,
        world_timeout_s=args.world_timeout,
        compact_ledger=not args.no_compact,
        preflight=args.preflight,
        preflight_platform=args.preflight_platform,
        preflight_timeout_s=args.preflight_timeout,
        export_fleet=not args.no_fleet,
    )
    report = sup.run()
    print(json.dumps(report, indent=2))
    return 0 if report["success"] else 1


if __name__ == "__main__":
    sys.exit(main())
