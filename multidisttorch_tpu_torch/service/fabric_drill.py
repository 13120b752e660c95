"""The service fabric's acceptance drill; the port's counterpart of the JAX
package's ``service/fabric_drill.py``.

Phases (docs/SERVICE.md "Service fabric"):

1. **Failover** (:func:`run_failover_phase`): two real replica children
   (``python -m multidisttorch_tpu_torch.examples.sweep_service --fabric``)
   over a 2-shard fabric, each owning its home shard. Replica 1 is
   SIGKILLed with work settled AND placed on its shard (a run that finished
   early certifies nothing); replica 0 must observe the stale lease, claim
   the next fencing epoch, ADOPT the orphaned shard (journal replay),
   re-home its ever-placed trials through scan-back restore, and settle
   every submission. Gates: zero lost, adoption in the lease stream (two
   claimants, ascending epochs), re-homed trials present, every compared
   trial's final loss held to an undisturbed single service of the same
   configs, and the traces complete across both fence epochs.
2. **Deadline preemption** (:func:`run_deadline_phase`): an in-process
   service whose pool is full of best-effort work (durable checkpoints
   landed) receives a deadline-tagged trial that cannot fit: the
   best-effort trials are checkpoint-drain PREEMPTED, the deadline trial
   places and completes before its deadline, the victims resume and still
   complete, and the evictions respect the anti-thrash budget.
3. **daemon_lost chaos** (:func:`run_fabric_chaos`): the failover fabric
   with the kill from inside, a seeded ``daemon_lost`` fault on the
   victim's dispatch clock.
4. **Split chaos** (:func:`run_split_chaos`): a seeded ``shard_split_lost``
   fault SIGKILLs the SPLITTING replica between two durable handoff
   records; the survivor adopts the parent shard, closes the pending split
   (commit or abort) and settles every submission: zero lost, none
   double-owned. The survivor may steal meanwhile (``--steal-threshold``).
   Each trial's final loss is held to an undisturbed reference, joined over
   every live shard of the final topology.
5. **Steal** (:func:`run_steal_phase`): two in-process replicas ticked in
   turns, one shard backlogged and one idle, so a steal certainly happens;
   the stolen trial settles on the thief's shard under its origin tenant,
   bit-identical to its undisturbed run.
6. **Movable** (:func:`run_movable_phase`): a stacked bucket checkpoint-
   drained mid-flight, resumed and finished, held to its undisturbed run
   (bitwise on the CPU, by the parity rule on the card). Its pipelined arm
   waits for pipeline placements (ROADMAP A.14).
7. **Load generator** (:func:`run_loadgen_phase`): ``service/loadgen.py``'s
   discrete-event replay of ``MDT_FABRIC_LOADGEN_N`` submissions (default
   1,000,000) through the production scheduler on a virtual clock, under the
   control-plane profiler. Gates: zero lost, fair share within 10 %, a
   deadline hit rate of at least 0.9, p99 recorded, and the offline SLOs met
   and exact.
8. **Scenario zoo over the dynamic topology** (:func:`run_scenario_phase`):
   each fabric scenario of the load generator (``MDT_FABRIC_SCENARIO_N``
   submissions, default 20,000) replayed with splits and stealing against
   static routing on the same seeded workload. Both run on the host only.

**The parity rule** (:func:`_parity`). The reference buckets both
tenants' trials together; the fabric buckets each shard alone, and an
adopter re-buckets what it resumes, so a trial can run in lanes in one run
and alone in the other. On the CPU a stacked lane equals its unstacked run
exactly, and every compared trial is held bit-identical (the JAX drill's
gate). On the card the lane kernels agree with the single ones within rel
1e-3 (chip_smoke's phase 10), so a trial is held bit-identical where every
placement of both runs took the same kernel route (single, or the same
lane count) and within rel 1e-3 otherwise; the report counts each.

The drill runs on the card unless the caller asks for the CPU
(``device="cpu"``), and raises where CUDA is asked for and absent. On the
CPU its sizes are the JAX drill's; on the card the full-width 784-400-20
VAE at batch 128 in shape buckets of different ``fused_steps``
(``service/drill.py``'s card sizes). The children's environment names the
device (``--device``) and sets nothing for JAX.

Not ported (:data:`NOT_PORTED`): the movable drill's pipelined arm (ROADMAP
A.14).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

from multidisttorch_tpu_torch.service import fabric
from multidisttorch_tpu_torch.service import queue as squeue
from multidisttorch_tpu_torch.service import topology as stopo
from multidisttorch_tpu_torch.service.drill import _device, _log_records, _sizes

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Tenants chosen so the 2-shard CRC routing puts them on DIFFERENT shards
# (asserted at drill start).
TENANT_SHARD0 = "alpha"
TENANT_SHARD1 = "beta"

# The JAX drill's phases this port does not run yet: phase -> ROADMAP item.
NOT_PORTED = {
    "movable_pipelined": "A.14",
}

# The JAX drill's sizes (two shape buckets of a tiny VAE on 128 rows) and the
# card's (service/drill.py's): the full-width VAE, 50 batches an epoch.
CPU_SHAPES = ({"hidden_dim": 16}, {"hidden_dim": 24})
CARD_SHAPES = ({"fused_steps": 10}, {"fused_steps": 5})
CPU_DEADLINE_SHAPES = ({"hidden_dim": 16}, {"hidden_dim": 24}, {"hidden_dim": 40})
CARD_DEADLINE_SHAPES = ({"fused_steps": 10}, {"fused_steps": 5}, {"fused_steps": 8})

# Lease deadlines (s). The CPU keeps the JAX drill's 2.0. On the card a
# replica's longest turn, its start warmed before any claim, was 1.10-1.88 s
# (chip_smoke phase 23a on an H100 80GB HBM3 at 700 W); the deadline is about
# twice the worst of them. Its grace of 3 deadlines (12 s) is also the room a
# replica gives a peer whose start (python and torch's import, then the
# card's context, first allocation and the kernels' load: 10-23 s, two
# processes starting together) lags its own before it takes the peer's
# never-claimed home shard.
CPU_LEASE_DEADLINE_S = 2.0
CARD_LEASE_DEADLINE_S = 4.0

# The card's lane kernels against the single ones (chip_smoke phase 10).
CARD_LANE_RTOL = 1e-3


_read_jsonl = fabric._read_jsonl


def live_shards(service_dir: str) -> list[int]:
    """The live shards of the fabric's topology: the base shards, less each
    committed split's parent range, plus its child. The joins below read
    every one, so a trial that a split or a steal moved is found."""
    cfg = fabric.read_fabric_config(service_dir) or {"n_shards": 2}
    return stopo.load_topology(service_dir, n_base=int(cfg["n_shards"])).live_shards()


def _trial_key(rec: dict) -> tuple:
    return (rec.get("tenant"), (rec.get("config") or {}).get("seed"))


def _final_losses(service_dir: str) -> dict[tuple, float]:
    """(tenant, seed) -> final_train_loss of the COMPLETED attempt, joined
    across the queue journal (identity) and the sweep ledger (losses) of one
    service or shard directory."""
    folded = squeue.fold_queue(squeue.load_queue(service_dir))
    by_tid = {rec["trial_id"]: rec for rec in folded.values() if rec.get("trial_id") is not None}
    out: dict[tuple, float] = {}
    for ev in _read_jsonl(os.path.join(service_dir, "sweep_ledger.jsonl")):
        if ev.get("event") != "attempt_end" or ev.get("status") != "completed":
            continue
        rec = by_tid.get(ev.get("trial_id"))
        if rec is not None:
            out[_trial_key(rec)] = (ev.get("summary") or {}).get("final_train_loss")
    return out


def _routes(service_dir: str) -> dict[tuple, list]:
    """(tenant, seed) -> the kernel route of each of its placements, in
    journal order: ``"single"``, or ``"lanes<K>"`` for a stacked bucket of
    K lanes."""
    tenant_seed: dict[str, tuple] = {}
    out: dict[tuple, list] = {}
    for ev in squeue.load_queue(service_dir):
        if ev.get("event") == "submitted":
            sub = ev.get("sub") or {}
            tenant_seed[sub.get("submission_id")] = _trial_key(sub)
        elif ev.get("event") == "placed" and ev.get("submission_id") in tenant_seed:
            route = f"lanes{ev.get('lanes')}" if ev.get("stacked") else "single"
            out.setdefault(tenant_seed[ev["submission_id"]], []).append(route)
    return out


def _parity(got: dict, got_routes: dict, ref: dict, ref_routes: dict, exact_only: bool) -> dict:
    """The module docstring's parity rule over every trial both runs
    completed."""
    compared, exact, within, mismatched = 0, 0, 0, []
    for key, r in sorted(ref.items(), key=lambda kv: str(kv[0])):
        if key not in got:
            continue
        compared += 1
        same_route = len(set(got_routes.get(key, [])) | set(ref_routes.get(key, []))) == 1
        if exact_only or same_route:
            exact += 1
            ok = got[key] == r
        else:
            within += 1
            ok = abs(got[key] - r) <= CARD_LANE_RTOL * abs(r)
        if not ok:
            mismatched.append({"key": list(key), "got": got[key], "ref": r, "routes": got_routes.get(key),
                               "ref_routes": ref_routes.get(key), "held": "bitwise" if exact_only or same_route
                               else f"rel {CARD_LANE_RTOL}"})
    return {"compared": compared, "held_bitwise": exact, "held_within_rel": within,
            "rtol": None if exact_only else CARD_LANE_RTOL, "mismatched": mismatched,
            "ok": compared > 0 and not mismatched}


def _fabric_losses(service_dir: str) -> tuple[dict, dict]:
    """:func:`_final_losses` and :func:`_routes` over every live shard."""
    got, routes = {}, {}
    for k in live_shards(service_dir):
        got.update(_final_losses(fabric.shard_dir(service_dir, k)))
        for key, r in _routes(fabric.shard_dir(service_dir, k)).items():
            routes.setdefault(key, []).extend(r)
    return got, routes


def _spawn_replica(service_dir: str, replica: int, *, log_path: str, device: str, data_rows: int,
                   lease_deadline_s: float, turn_budget_s: Optional[float] = None, extra=()):
    """One replica child. Its environment names the device through
    ``--device`` and sets nothing for JAX; on the CPU it trains on one
    thread, as the in-process reference does, so lanes and single trials
    agree to the bit. ``turn_budget_s`` None keeps the CLI's default turn
    budget (a quarter of the lease deadline); 0 turns it off."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.pop("MDT_TELEMETRY", None)  # replicas configure their own
    env["MDT_HOST_SLOT"] = str(replica)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    argv = [
        sys.executable, "-m", "multidisttorch_tpu_torch.examples.sweep_service", service_dir,
        "--fabric",
        "--replica", str(replica),
        "--n-shards", "2",
        "--device", device,
        "--slices", "2",
        "--max-lanes", "2",
        "--data-rows", str(data_rows),
        "--retry", "2",
        "--lease-deadline", str(lease_deadline_s),
        "--exit-when-drained",
        "--idle-grace", "2.0",
        *(() if turn_budget_s is None else ("--turn-budget", str(turn_budget_s))),
        *extra,
    ]
    log_f = open(log_path, "a")
    proc = subprocess.Popen(argv, env=env, stdout=log_f, stderr=subprocess.STDOUT, text=True)
    return proc, log_f


def _stop(procs) -> None:
    """End every child still running, and close its log."""
    for p, f in procs:
        try:
            if p.poll() is None:
                p.terminate()
                p.wait(timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            p.kill()
            p.wait(timeout=60)
        f.close()


def _report_line(log_path: str) -> Optional[dict]:
    """A replica's serve report: the last JSON line of its log."""
    try:
        with open(log_path) as f:
            lines = [ln for ln in f if ln.startswith("{")]
    except OSError:
        return None
    try:
        return json.loads(lines[-1]) if lines else None
    except ValueError:
        return None


def _events(service_dir: str) -> list[dict]:
    """Every replica's telemetry events (one stream per replica)."""
    out = []
    for p in sorted(glob.glob(os.path.join(service_dir, "telemetry", "**", "events*.jsonl"), recursive=True)):
        out.extend(_read_jsonl(p))
    return out


def _claims(service_dir: str, shard: int) -> list[tuple]:
    """(epoch, replica) of every claim in the shard's lease stream."""
    return [(int(r.get("epoch", 0)), int(r.get("replica", -1)))
            for r in _read_jsonl(fabric.lease_file(service_dir, shard)) if r.get("status") == fabric.CLAIM]


def _lease_gaps(service_dir: str) -> dict[int, float]:
    """replica -> the longest gap between two consecutive lease records it
    wrote for one live shard at one epoch (claim, renewals, release): what
    its peers saw of its liveness."""
    out: dict[int, float] = {}
    for k in live_shards(service_dir):
        last: dict[tuple, float] = {}
        for r in _read_jsonl(fabric.lease_file(service_dir, k)):
            key = (int(r.get("replica", -1)), int(r.get("epoch", 0)))
            ts = float(r.get("ts", 0.0))
            if key in last:
                out[key[0]] = max(out.get(key[0], 0.0), ts - last[key])
            last[key] = ts
    return {rep: round(g, 4) for rep, g in sorted(out.items())}


def replica_steps(service_dir: str, replica: int) -> dict:
    """The optimizer steps one replica's shard services ran, from the
    ledgers and journals of every live shard: ``single``, the steps of its
    unstacked attempts
    (each a single-kernel launch pair), and ``bucket``, the steps of its
    stacked buckets (each one lane-kernel launch pair for all its lanes: a
    bucket's steps are its longest lane's). An attempt is the replica's when
    its fencing epoch is one the replica claimed on that shard."""
    out = {"single": 0, "bucket": 0}
    for k in live_shards(service_dir):
        epochs = {e for e, rep in _claims(service_dir, k) if rep == replica}
        sd = fabric.shard_dir(service_dir, k)
        attempts: dict[int, list] = {}
        for e in _read_jsonl(os.path.join(sd, "sweep_ledger.jsonl")):
            if e.get("event") != "attempt_end" or e.get("epoch") not in epochs:
                continue
            s = e.get("summary") or {}
            last = s.get("steps", s.get("steps_at_failure"))
            if last is None:
                continue
            n = int(last) - int(s.get("resumed_from_step") or 0)
            if s.get("stacked"):
                attempts.setdefault(e["trial_id"], []).append(n)
            else:
                out["single"] += n
        # A bucket is one run of consecutive stacked `placed` records at one
        # start slot and epoch; each member's next stacked attempt is its lane.
        bucket, prev = [], None
        buckets = []
        for ev in squeue.load_queue(sd):
            if ev.get("event") != "placed" or ev.get("epoch") not in epochs:
                continue
            key = (ev.get("start"), ev.get("epoch"), ev.get("lanes"))
            if not ev.get("stacked"):
                prev = None
                continue
            if key != prev:
                bucket = []
                buckets.append(bucket)
                prev = key
            bucket.append(ev.get("trial_id"))
        for members in buckets:
            lanes = [attempts[t].pop(0) for t in members if attempts.get(t)]
            out["bucket"] += max(lanes, default=0)
    return out


def run_failover_phase(
    work_dir: str,
    *,
    device: Optional[str] = None,
    base: Optional[dict] = None,
    shapes: Optional[tuple] = None,
    epochs: int = 3,
    data_rows: Optional[int] = None,
    lease_deadline_s: Optional[float] = None,
    turn_budget_s: Optional[float] = None,
    timeout_s: float = 600.0,
) -> dict:
    """Phase 1 (module docstring): 6 submissions per tenant, alternating two
    shape buckets; replica 1 SIGKILLed once its shard has settled and placed
    work; replica 0 adopts and finishes. Returns the gates' evidence, each
    replica's longest turn and lease gap beside the lease deadline, the
    detect-to-adopt and replay seconds, and the survivor's launch counts
    beside the steps its ledgers record."""
    assert fabric.shard_of(TENANT_SHARD0, 2) == 0
    assert fabric.shard_of(TENANT_SHARD1, 2) == 1
    device = _device(device)
    base, shapes, data_rows = _sizes(device, base, shapes, data_rows, CPU_SHAPES, CARD_SHAPES)
    if lease_deadline_s is None:
        lease_deadline_s = CPU_LEASE_DEADLINE_S if device == "cpu" else CARD_LEASE_DEADLINE_S
    base = dict(base, epochs=epochs)
    service_dir = os.path.join(work_dir, "fabric_service")
    shutil.rmtree(service_dir, ignore_errors=True)
    os.makedirs(service_dir, exist_ok=True)
    fabric.ensure_fabric_config(service_dir, 2)

    client = fabric.FabricClient(service_dir, n_shards=2)
    all_ids = []
    for tenant, seed0 in ((TENANT_SHARD0, 0), (TENANT_SHARD1, 100)):
        for i in range(6):
            all_ids.append(client.submit({**base, **shapes[i % 2], "seed": seed0 + i}, tenant=tenant))
    shard1_dir = fabric.shard_dir(service_dir, 1)

    logs = [os.path.join(work_dir, f"replica{r}.log") for r in (0, 1)]
    for log in logs:
        if os.path.exists(log):
            os.remove(log)
    spawn = dict(device=device, data_rows=data_rows, lease_deadline_s=lease_deadline_s, turn_budget_s=turn_budget_s)
    t_spawn = time.time()
    procs = [_spawn_replica(service_dir, r, log_path=logs[r], **spawn) for r in (0, 1)]
    (p0, _), (p1, _) = procs

    # The parity reference: the same configs, undisturbed, one service of
    # both tenants in this process, on a thread of its own while the
    # children run (its bits do not depend on what else shares the device).
    ref_dir = os.path.join(work_dir, "fabric_reference")
    ref: dict = {}

    ref_subs = [(tenant, {**base, **shapes[i % 2], "seed": seed0 + i})
                for tenant, seed0 in ((TENANT_SHARD0, 0), (TENANT_SHARD1, 100)) for i in range(6)]
    ref_thread = _reference_thread(ref, ref_dir, ref_subs, device=device, data_rows=data_rows, max_lanes=2)

    # Kill replica 1 once its shard has BOTH settled work (progress happened)
    # and placed work outstanding (the crash has something to orphan).
    kill_exercised = False
    killed_at: Optional[dict] = None
    t_kill = None
    try:
        while time.time() - t_spawn < timeout_s:
            states = [r["state"] for r in squeue.fold_queue(squeue.load_queue(shard1_dir)).values()]
            n_settled, n_placed = states.count(squeue.SETTLED), states.count(squeue.PLACED)
            owner = fabric.shard_owner(service_dir, 1)
            if n_settled >= 1 and n_placed >= 1 and owner is not None and int(owner.get("replica", -1)) == 1:
                killed_at = {"settled": n_settled, "placed": n_placed, "s_after_spawn": round(time.time() - t_spawn, 3)}
                break
            if p1.poll() is not None:
                break  # finished or died early: gated below
            time.sleep(0.1)
        if p1.poll() is None and killed_at is not None:
            p1.send_signal(signal.SIGKILL)
            t_kill = time.time()
            kill_exercised = True
        p1.wait(timeout=60)
        kill_exercised = kill_exercised and p1.returncode == -signal.SIGKILL

        # Replica 0 adopts shard 1 (stale lease -> next epoch) and runs
        # everything to completion; --exit-when-drained idles it out only
        # once BOTH shards are quiescent.
        final = client.wait(all_ids, timeout_s=timeout_s)
        p0.wait(timeout=120)
    finally:
        _stop(procs)
        ref_thread.join(timeout=timeout_s)
    wall_s = time.time() - t_spawn
    ref_losses = _join_reference(ref, ref_thread, timeout_s)

    states = {s: r.get("state") for s, r in final.items()}
    lost = sorted(s for s in all_ids if states.get(s) not in (squeue.SETTLED, squeue.REJECTED))
    statuses = {s: r.get("status") for s, r in final.items()}

    # Adoption evidence: the shard-1 lease stream shows replica 1's claim
    # AND replica 0's higher-epoch takeover.
    claims = _claims(service_dir, 1)
    epochs_seen = [e for e, _ in claims]
    adopted = {0, 1} <= {rep for _, rep in claims} and len(epochs_seen) >= 2 and epochs_seen == sorted(epochs_seen)

    # Re-homed trials: placed again after the kill, or journaled unplaced by
    # the adopter's recovery.
    folded1 = squeue.fold_queue(squeue.load_queue(shard1_dir))
    rehomed = sorted(sid for sid, rec in folded1.items()
                     if rec.get("placements", 0) >= 2 or rec.get("unplaced_reason") == "daemon restart recovery")

    got, got_routes = _fabric_losses(service_dir)
    parity = _parity(got, got_routes, ref_losses, _routes(ref_dir), exact_only=device == "cpu")
    rehomed_keys = {_trial_key(folded1.get(sid) or {}) for sid in rehomed}
    parity["rehomed_compared"] = sum(1 for k in rehomed_keys if k in ref_losses and k in got)

    # The adoption story as the replicas told it (telemetry).
    events = _events(service_dir)
    shard_events = {k: sum(1 for e in events if e.get("kind") == k)
                    for k in ("shard_claimed", "shard_adopted", "shard_fence_lost", "shard_released",
                              "replica_start", "replica_end")}
    adoption = next((e for e in events if e.get("kind") == "shard_adopted"
                     and (e.get("data") or {}).get("shard") == 1 and (e.get("data") or {}).get("replica") == 0),
                    None)
    turns: dict[int, dict] = {}
    for e in events:
        if e.get("kind") == "replica_turn":
            d = e.get("data") or {}
            turns[int(d["replica"])] = d

    # Trace completeness: every settled submission reconstructs, from the
    # durable shard journals and ledgers alone, as ONE contiguous span tree
    # with zero orphans, and the re-homed ones span BOTH fence epochs.
    from multidisttorch_tpu_torch.telemetry import trace as ttrace

    trace_export = ttrace.export_traces(service_dir, os.path.join(work_dir, "fabric_traces"))
    completeness = trace_export["completeness"]
    trace_block = {
        "completeness": completeness,
        "exported": {k: trace_export[k] for k in ("spans", "perfetto")},
        "rehomed_cross_epoch": bool(completeness["epoch_takeovers"] >= 1
                                    and completeness["multi_epoch_submissions"] >= 1),
    }
    survivor = _report_line(logs[0]) or {}
    launches = _log_records(logs[0], "LAUNCHES")
    return {
        "device": device,
        "submissions": len(all_ids),
        "kill_exercised": kill_exercised,
        "killed_at": killed_at,
        "replica_exits": [p0.returncode, p1.returncode],
        "lost_submissions": lost,
        "zero_lost": not lost,
        "statuses": dict(sorted(statuses.items())),
        "completed": sum(1 for v in statuses.values() if v == "completed"),
        "shard1_lease_claims": claims,
        "adoption_evident": adopted,
        "rehomed_submissions": rehomed,
        "rehomed_count": len(rehomed),
        "parity": parity,
        "shard_events": shard_events,
        "detect_to_adopt_s": (round(adoption["ts"] - t_kill, 3) if adoption is not None and t_kill else None),
        "replay_s": (adoption.get("data") or {}).get("replay_s") if adoption is not None else None,
        "lease_deadline_s": lease_deadline_s,
        "longest_turn_s": {rep: d.get("longest_turn_s") for rep, d in sorted(turns.items())},
        "longest_turn_parts": {rep: (d.get("turn"), d.get("parts")) for rep, d in sorted(turns.items())},
        "lease_gap_s": _lease_gaps(service_dir),
        "survivor": {k: survivor.get(k) for k in ("outcome", "adoptions", "fences_lost", "turns", "longest_turn_s",
                                                  "longest_unrenewed_s", "wall_s")},
        "survivor_launches": launches[-1] if launches else None,
        "survivor_steps": replica_steps(service_dir, 0),
        "boots": _log_records(logs[0], "BOOT") + _log_records(logs[1], "BOOT"),
        "trace": trace_block,
        "fabric_health": fabric.fabric_health(service_dir, lease_deadline_s=lease_deadline_s),
        "wall_s": round(wall_s, 3),
        "logs": logs,
    }


def _reference_losses(ref_dir: str, submissions, *, device: str, data_rows: int, max_lanes: int) -> dict:
    """Undisturbed single-service reference run of the SAME configs
    (``(tenant, config)`` pairs), in-process on two slots of the device (on
    the CPU on one thread, as the replicas are): the losses a fabric run is
    held to."""
    import torch

    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.service.runtime import SweepService

    os.makedirs(ref_dir, exist_ok=True)
    client = squeue.SweepClient(ref_dir)
    for tenant, cfg in submissions:
        client.submit(dict(cfg), tenant=tenant)
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    svc = SweepService(ref_dir, n_slices=2, max_lanes=max_lanes, data_rows=data_rows,
                       retry=RetryPolicy(max_retries=2), device=device)
    try:
        svc.serve(exit_when_drained=True, idle_grace_s=0.5, max_wall_s=600)
    finally:
        svc.close()
        torch.set_num_threads(threads)
    return _final_losses(ref_dir)


def _reference_thread(ref: dict, ref_dir: str, submissions, **kw) -> threading.Thread:
    """:func:`_reference_losses` on a thread of its own, started: its
    losses (or its error) land in ``ref``. Its bits do not depend on what
    else shares the device."""
    shutil.rmtree(ref_dir, ignore_errors=True)

    def reference() -> None:
        try:
            ref["losses"] = _reference_losses(ref_dir, submissions, **kw)
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            ref["error"] = e

    t = threading.Thread(target=reference, name="fabric-reference")
    t.start()
    return t


def _join_reference(ref: dict, thread: threading.Thread, timeout_s: float) -> dict:
    thread.join(timeout=timeout_s)
    if "error" in ref:
        raise ref["error"]
    if thread.is_alive():
        raise TimeoutError(f"the fabric drill's reference service ran past {timeout_s} s")
    return ref["losses"]


def run_fabric_chaos(work_dir: str, *, victim: int = 1, step: int = 12, seed: int = 0,
                     device: Optional[str] = None, data_rows: Optional[int] = None,
                     lease_deadline_s: Optional[float] = None, timeout_s: float = 600.0) -> dict:
    """The ``daemon_lost`` chaos drill: the failover phase's two-replica
    fabric, but the kill comes from INSIDE: a seeded
    :class:`~multidisttorch_tpu_torch.faults.plan.FaultPlan` whose
    ``daemon_lost`` spec SIGKILLs the victim replica when its cumulative
    dispatch clock reaches ``step`` (the fired record lands fsync'd before
    the kill). Both replicas are armed with the SAME plan; the spec's
    ``host`` names the victim."""
    from multidisttorch_tpu_torch.faults.plan import DAEMON_LOST, FaultPlan, FaultSpec

    device = _device(device)
    base, shapes, data_rows = _sizes(device, None, None, data_rows, CPU_SHAPES, CARD_SHAPES)
    if lease_deadline_s is None:
        lease_deadline_s = CPU_LEASE_DEADLINE_S if device == "cpu" else CARD_LEASE_DEADLINE_S
    service_dir = os.path.join(work_dir, "fabric_chaos")
    shutil.rmtree(service_dir, ignore_errors=True)
    os.makedirs(service_dir, exist_ok=True)
    fabric.ensure_fabric_config(service_dir, 2)
    plan = FaultPlan(specs=(FaultSpec(DAEMON_LOST, trial_id=-1, step=int(step), host=int(victim)),), seed=seed)
    plan_path = os.path.join(work_dir, "fabric_fault_plan.json")
    with open(plan_path, "w") as f:
        f.write(plan.to_json())

    base = dict(base, epochs=3)
    client = fabric.FabricClient(service_dir, n_shards=2)
    ids = []
    for i in range(5):
        ids.append(client.submit({**base, **shapes[0], "seed": i}, tenant=TENANT_SHARD0))
        ids.append(client.submit({**base, **shapes[1], "seed": 100 + i}, tenant=TENANT_SHARD1))
    logs = [os.path.join(work_dir, f"chaos_replica{rep}.log") for rep in (0, 1)]
    procs = [_spawn_replica(service_dir, rep, log_path=logs[rep], device=device, data_rows=data_rows,
                            lease_deadline_s=lease_deadline_s, extra=("--fault-plan", plan_path))
             for rep in (0, 1)]
    vproc = procs[victim][0]
    try:
        final = client.wait(ids, timeout_s=timeout_s)
        vproc.wait(timeout=120)
        for p, _ in procs:
            if p.poll() is None:
                p.wait(timeout=180)
    finally:
        _stop(procs)

    states = {s: r.get("state") for s, r in final.items()}
    lost = sorted(s for s in ids if states.get(s) not in (squeue.SETTLED, squeue.REJECTED))
    fired = [r for r in _read_jsonl(os.path.join(service_dir, "fabric", f"fired-{victim}.jsonl"))
             if r.get("kind") == DAEMON_LOST]
    claimants = {rep for _, rep in _claims(service_dir, victim)}
    survivor = 1 - victim
    return {
        "plan": json.loads(plan.to_json()),
        "device": device,
        "victim": victim,
        "victim_exit": vproc.returncode,
        "victim_sigkilled": vproc.returncode == -signal.SIGKILL,
        "fault_fired": len(fired) >= 1,
        "fired_records": fired,
        "lost_submissions": lost,
        "zero_lost": not lost,
        "completed": sum(1 for r in final.values() if r.get("status") == "completed"),
        "submissions": len(ids),
        "survivor_claimed_victims_shard": survivor in claimants and victim in claimants,
        "fabric_health": fabric.fabric_health(service_dir, lease_deadline_s=lease_deadline_s),
        "logs": logs,
        "ok": bool(vproc.returncode == -signal.SIGKILL and fired and not lost and survivor in claimants),
    }


def _pick_split_tenants(parent: int, n_give: int, n_keep: int) -> tuple[list[str], list[str]]:
    """Deterministic tenant names that route to ``parent`` under the 2-shard
    base topology, partitioned by which HALF of the parent's hash range a
    first split hands to the child: the drill knows, before any replica
    starts, which submissions the handoff will move."""
    topo = stopo.Topology(2)
    _keep, give = topo.split_halves(parent, topo.next_shard_id())
    gives: list[str] = []
    keeps: list[str] = []
    i = 0
    while len(gives) < n_give or len(keeps) < n_keep:
        t = f"split{i}"
        i += 1
        h = stopo.tenant_hash(t)
        if h % 2 != parent:
            continue
        (gives if give.matches(h, 2) else keeps).append(t)
    return gives[:n_give], keeps[:n_keep]


def run_split_chaos(work_dir: str, *, victim: int = 1, handoff_step: int = 2, seed: int = 0,
                    device: Optional[str] = None, data_rows: Optional[int] = None,
                    lease_deadline_s: Optional[float] = None, turn_budget_s: Optional[float] = None,
                    timeout_s: float = 600.0) -> dict:
    """The kill-mid-split chaos drill: a seeded ``shard_split_lost`` fault
    SIGKILLs the SPLITTING replica on its split-handoff clock, strictly
    between two durable ``moved`` records, with the topology's
    ``split_begin`` durable and its commit not: a pending split, a
    half-transferred queue, spool files already in the child's intake. The
    surviving replica adopts the orphaned parent shard, finds the evidence,
    COMPLETES the split (the idempotent transfer again, ``split_commit``,
    the child's service) and settles every submission: zero lost, none
    double-owned. The JAX drill's shape: 6 give-half and 2 keep-half tenants
    on the victim's shard, 2 on the survivor's, 2 epochs, one lane per
    placement; the victim splits at queue depth 4, the survivor may steal
    at depth 6. Beyond the JAX gates: every trial's final loss against an
    undisturbed reference (on a thread while the children run), joined by
    (tenant, seed) over every live shard; each replica's longest turn; the
    survivor's launch counts beside the steps its ledgers record over every
    shard it served."""
    from multidisttorch_tpu_torch.faults.plan import SHARD_SPLIT_LOST, FaultPlan, FaultSpec
    device = _device(device)
    base, shapes, data_rows = _sizes(device, None, None, data_rows, CPU_SHAPES, CARD_SHAPES)
    if lease_deadline_s is None:
        lease_deadline_s = CPU_LEASE_DEADLINE_S if device == "cpu" else CARD_LEASE_DEADLINE_S
    base = dict(base, epochs=2)
    service_dir = os.path.join(work_dir, "fabric_split")
    shutil.rmtree(service_dir, ignore_errors=True)
    os.makedirs(service_dir, exist_ok=True)
    fabric.ensure_fabric_config(service_dir, 2)
    plan = FaultPlan(specs=(FaultSpec(SHARD_SPLIT_LOST, trial_id=-1, step=int(handoff_step), host=int(victim)),),
                     seed=seed)
    plan_path = os.path.join(work_dir, "split_fault_plan.json")
    with open(plan_path, "w") as f:
        f.write(plan.to_json())

    # At kill time (after the 3rd handoff record) give-half work is both
    # already moved and still unmoved: the seam has meat on each side. Two
    # more on the survivor's home shard keep it serving while it adopts.
    gives, keeps = _pick_split_tenants(victim, 6, 2)
    survivor = 1 - victim
    surv_tenant = TENANT_SHARD0 if survivor == 0 else TENANT_SHARD1
    subs = ([(t, {**base, **shapes[0], "seed": i}) for i, t in enumerate(gives + keeps)]
            + [(surv_tenant, {**base, **shapes[1], "seed": 50 + i}) for i in range(2)])
    client = fabric.FabricClient(service_dir, n_shards=2)
    ids = [client.submit(dict(cfg), tenant=t) for t, cfg in subs]

    # Only the victim splits (its 8-deep backlog crosses depth 4 at once);
    # the survivor gets the steal option instead, and the gates hold however
    # that race lands.
    logs = [os.path.join(work_dir, f"split_replica{rep}.log") for rep in (0, 1)]
    for log in logs:
        if os.path.exists(log):
            os.remove(log)
    procs = []
    t_spawn = time.time()
    for rep in (0, 1):
        extra = (("--split-queue-depth", "4", "--split-min-interval", "0.25", "--fault-plan", plan_path)
                 if rep == victim else ("--steal-threshold", "6"))
        procs.append(_spawn_replica(service_dir, rep, log_path=logs[rep], device=device, data_rows=data_rows,
                                    lease_deadline_s=lease_deadline_s, turn_budget_s=turn_budget_s,
                                    extra=("--max-lanes", "1", *extra)))
    ref_dir = os.path.join(work_dir, "split_reference")
    ref: dict = {}
    ref_thread = _reference_thread(ref, ref_dir, subs, device=device, data_rows=data_rows, max_lanes=1)
    vproc = procs[victim][0]
    try:
        final = client.wait(ids, timeout_s=timeout_s)
        vproc.wait(timeout=120)
        for p, _ in procs:
            if p.poll() is None:
                p.wait(timeout=180)
    finally:
        _stop(procs)
        ref_thread.join(timeout=timeout_s)
    wall_s = time.time() - t_spawn
    ref_losses = _join_reference(ref, ref_thread, timeout_s)

    states = {s: r.get("state") for s, r in final.items()}
    lost = sorted(s for s in ids if states.get(s) not in (squeue.SETTLED, squeue.REJECTED))
    fired = [r for r in _read_jsonl(os.path.join(service_dir, "fabric", f"fired-{victim}.jsonl"))
             if r.get("kind") == SHARD_SPLIT_LOST]

    # The topology log is the drill's flight recorder: the victim's
    # split_begin is there, and the seam CLOSED (a commit, or an abort if
    # the kill beat every handoff record), nothing pending.
    topo_events = stopo.load_topology_events(service_dir)
    by_kind: dict[str, list] = {}
    for ev in topo_events:
        by_kind.setdefault(ev.get("event"), []).append(ev)
    topo = stopo.load_topology(service_dir, n_base=2)
    live = topo.live_shards()

    # No double ownership, from the durable journals alone: each submission
    # has at most one non-superseded record across the fabric.
    owners: dict[str, list[int]] = {}
    moved_split = 0
    for k in sorted(set(live) | {0, 1}):
        for sid, rec in squeue.fold_queue(squeue.load_queue(fabric.shard_dir(service_dir, k))).items():
            if rec.get("state") == squeue.MOVED and rec.get("moved_kind") == fabric.MOVE_SPLIT:
                moved_split += 1
            if not fabric.FabricClient._superseded(rec):
                owners.setdefault(sid, []).append(k)
    double_owned = sorted(sid for sid, ks in owners.items() if len(ks) > 1)
    unowned = sorted(s for s in ids if not owners.get(s))

    got, got_routes = _fabric_losses(service_dir)
    parity = _parity(got, got_routes, ref_losses, _routes(ref_dir), exact_only=True)
    events = _events(service_dir)
    turns: dict[int, dict] = {}
    for e in events:
        if e.get("kind") == "replica_turn":
            d = e.get("data") or {}
            turns[int(d["replica"])] = d
    adoption = next((e for e in events if e.get("kind") == "shard_adopted"
                     and (e.get("data") or {}).get("shard") == victim
                     and (e.get("data") or {}).get("replica") == survivor), None)
    kinds = ("shard_split_begin", "shard_split_commit", "shard_split_abort", "shard_split_resolved",
             "submission_moved", "steal_request", "steal_grant", "steal_executed", "shard_adopted")
    launches = _log_records(logs[survivor], "LAUNCHES")
    split_kill_exercised = bool(vproc.returncode == -signal.SIGKILL and fired)
    report = {
        "plan": json.loads(plan.to_json()),
        "device": device,
        "victim": victim,
        "victim_exit": vproc.returncode,
        "survivor_exit": procs[survivor][0].returncode,
        "split_kill_exercised": split_kill_exercised,
        "fired_records": fired,
        "submissions": len(ids),
        "give_tenants": gives,
        "keep_tenants": keeps,
        "lost_submissions": lost,
        "zero_lost": not lost,
        "completed": sum(1 for r in final.values() if r.get("status") == "completed"),
        "no_double_own": not double_owned and not unowned,
        "double_owned": double_owned,
        "unowned": unowned,
        "moved_split_records": moved_split,
        "topology": {
            "events": topo_events,
            "epoch": topo.epoch,
            "live_shards": live,
            "committed": bool(by_kind.get(stopo.SPLIT_COMMIT)),
            "aborted": bool(by_kind.get(stopo.SPLIT_ABORT)),
            "seam_closed": not topo.pending,
            "split_begun": bool(by_kind.get(stopo.SPLIT_BEGIN)),
        },
        "parity": parity,
        "event_counts": {k: sum(1 for e in events if e.get("kind") == k) for k in kinds},
        "detect_to_adopt_s": (round(adoption["ts"] - fired[0]["ts"], 3) if adoption is not None and fired
                              else None),
        "lease_deadline_s": lease_deadline_s,
        "longest_turn_s": {rep: d.get("longest_turn_s") for rep, d in sorted(turns.items())},
        "longest_turn_parts": {rep: (d.get("turn"), d.get("parts")) for rep, d in sorted(turns.items())},
        "lease_gap_s": _lease_gaps(service_dir),
        "survivor": _report_line(logs[survivor]) or {},
        "survivor_launches": launches[-1] if launches else None,
        "survivor_steps": replica_steps(service_dir, survivor),
        "boots": _log_records(logs[0], "BOOT") + _log_records(logs[1], "BOOT"),
        "fabric_health": fabric.fabric_health(service_dir, lease_deadline_s=lease_deadline_s),
        "wall_s": round(wall_s, 3),
        "logs": logs,
    }
    report["ok"] = bool(split_kill_exercised and not lost and report["no_double_own"]
                        and report["topology"]["split_begun"] and report["topology"]["seam_closed"]
                        and moved_split >= 1)
    return report


def run_steal_phase(work_dir: str, *, device: Optional[str] = None, data_rows: Optional[int] = None,
                    n_queued: int = 4, steal_threshold: int = 3, precompile: bool = True,
                    timeout_s: float = 300.0) -> dict:
    """A steal that certainly happens: two replicas in this process, ticked
    in turns. Replica 0's shard 0 (one slot) holds ``n_queued`` one-epoch
    trials of one tenant, each at its own learning rate; replica 1's shard
    1 is idle, so it asks and shard 0 grants one submission from its
    queue's tail. The stolen trial settles on shard 1 under its origin
    tenant, and every trial's final loss is held bit-identical to an
    undisturbed service of the same configs (one lane per placement both
    ways). With ``precompile`` shard 0 runs the precapture farm (each trial
    a program of its own), and the program the stolen trial's admission
    planned must be gone from the registry once the grant has run."""
    import torch

    from multidisttorch_tpu_torch.compile.registry import get_executable_registry
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.ops import elbo

    device = _device(device)
    base, shapes, data_rows = _sizes(device, None, None, data_rows, CPU_SHAPES, CARD_SHAPES)
    lease_deadline_s = CPU_LEASE_DEADLINE_S if device == "cpu" else CARD_LEASE_DEADLINE_S
    service_dir = os.path.join(work_dir, "fabric_steal")
    shutil.rmtree(service_dir, ignore_errors=True)
    os.makedirs(service_dir, exist_ok=True)
    subs = [(TENANT_SHARD0, {**base, **shapes[0], "epochs": 1, "seed": i, "lr": 1e-3 * (1 + i / 8)})
            for i in range(n_queued)]
    client = fabric.FabricClient(service_dir, n_shards=2)
    ids = [client.submit(dict(cfg), tenant=t) for t, cfg in subs]
    kw = dict(n_shards=2, lease_deadline_s=lease_deadline_s, steal_threshold=steal_threshold, steal_batch=1,
              steal_scan_every_s=0.0, n_slices=1, max_lanes=1, data_rows=data_rows,
              retry=RetryPolicy(max_retries=2), device=device)
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    launches0 = dict(elbo.LAUNCHES)
    reg = get_executable_registry()
    victim = fabric.FabricReplica(service_dir, replica=0, precompile=precompile, **kw)
    thief = fabric.FabricReplica(service_dir, replica=1, **kw)
    planned: dict = {}
    planned_status: dict = {}
    stolen_key_after_grant = "not granted"
    turns = 0
    final: dict = {}
    tail: list = []
    try:
        for r in (victim, thief):
            r._warm_backend()
        t0 = time.time()
        while time.time() - t0 < timeout_s:
            granted = victim.steals_granted
            if 0 in victim.services and victim.steals_granted == 0:
                tail = [e.sub_id for e in victim.services[0].sched.pending_entries()][-1:]
            victim.tick()
            if precompile and not planned and 0 in victim.services and victim.services[0]._warm_keys:
                # Shard 0 admitted its queue: let the farm capture what it
                # planned, so the grant meets a READY slot.
                svc0 = victim.services[0]
                svc0._farm.drain()
                planned = dict(svc0._warm_keys)
                planned_status = {t: reg.status(k) for t, k in planned.items()}
            if victim.steals_granted > granted and stolen_key_after_grant == "not granted":
                fold = squeue.fold_queue(squeue.load_queue(fabric.shard_dir(service_dir, 0)))
                tids = [rec.get("trial_id") for rec in fold.values() if rec.get("state") == squeue.MOVED]
                stolen_key_after_grant = [reg.status(planned[t]) for t in tids if t in planned]
            thief.tick()
            turns += 1
            final = client.wait(ids, timeout_s=0.0, poll_s=0.0)
            if all(r.get("state") == squeue.SETTLED for r in final.values()):
                break
    finally:
        for r in (victim, thief):
            r.drain(reason="steal drill end")
        torch.set_num_threads(threads)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = {k: v - launches0.get(k, 0) for k, v in elbo.LAUNCHES.items()}
    grants = [r for r in _read_jsonl(fabric.steal_file(service_dir, 0)) if r.get("kind") == "grant"]
    stolen = [sid for g in grants for sid in g.get("sub_ids") or []]
    fold0 = squeue.fold_queue(squeue.load_queue(fabric.shard_dir(service_dir, 0)))
    fold1 = squeue.fold_queue(squeue.load_queue(fabric.shard_dir(service_dir, 1)))
    settled_on_thief = {sid: (fold1.get(sid) or {}) for sid in stolen}
    origin_tenant = all(r.get("state") == squeue.SETTLED and r.get("status") == "completed"
                        and r.get("tenant") == TENANT_SHARD0 for r in settled_on_thief.values())
    moved_at_victim = all((fold0.get(sid) or {}).get("state") == squeue.MOVED for sid in stolen)
    ref_dir = os.path.join(work_dir, "steal_reference")
    shutil.rmtree(ref_dir, ignore_errors=True)
    ref_losses = _reference_losses(ref_dir, subs, device=device, data_rows=data_rows, max_lanes=1)
    got, got_routes = _fabric_losses(service_dir)
    parity = _parity(got, got_routes, ref_losses, _routes(ref_dir), exact_only=True)
    steps = {r: replica_steps(service_dir, r) for r in (0, 1)}
    report = {
        "device": device,
        "submissions": ids,
        "grants": grants,
        "stolen": stolen,
        "queue_tail_at_grant": tail,
        "stolen_from_tail": bool(stolen) and stolen == tail,
        "settled_on_thief_under_origin_tenant": bool(stolen) and origin_tenant,
        "moved_at_victim": bool(stolen) and moved_at_victim,
        "zero_lost": all(r.get("state") == squeue.SETTLED for r in final.values()),
        "steals_granted": victim.steals_granted,
        "planned_programs": planned_status,
        "stolen_program_after_grant": stolen_key_after_grant,
        "registry_programs": len(reg.snapshot()),
        "parity": parity,
        "launches": launches,
        "steps": steps,
        "turns": turns,
        "longest_turn_s": {0: round(victim.longest_turn_s, 4), 1: round(thief.longest_turn_s, 4)},
        "wall_s": round(time.time() - t0, 3),
    }
    report["ok"] = bool(report["stolen_from_tail"] and report["settled_on_thief_under_origin_tenant"]
                        and report["moved_at_victim"] and report["zero_lost"] and parity["ok"]
                        and (stolen_key_after_grant == [None] or not precompile))
    return report


def _run_movable_arm(service_dir: str, submissions: list[dict], *, evict: bool, svc_kw: dict, data_rows: int,
                     device: str, timeout_s: float) -> dict:
    """One in-process service run of ``submissions``: if ``evict``,
    checkpoint-drain the placement mid-flight (the defrag and preemption
    planner's move primitive) once it has durable progress, then run
    everything, the requeued victims included, to completion."""
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.service.runtime import SweepService

    shutil.rmtree(service_dir, ignore_errors=True)
    os.makedirs(service_dir, exist_ok=True)
    client = squeue.SweepClient(service_dir, tenant="mv")
    for sub in submissions:
        client.submit(dict(sub))
    svc = SweepService(service_dir, data_rows=data_rows, defrag_enabled=False, retry=RetryPolicy(max_retries=2),
                       device=device, **svc_kw)
    evicted, requeued, routes = False, 0, set()
    try:
        t0 = time.time()
        while len(svc.settled) < len(submissions) and time.time() - t0 < timeout_s:
            svc.tick()
            routes |= {f"lanes{len(ap.run.lanes)}" if ap.stacked else "single" for ap in svc.active.values()}
            if evict and not evicted:
                for ap in list(svc.active.values()):
                    if ap.stacked:
                        ready = any(lane is not None and lane["epochs_done"] >= 1 for lane in ap.run.lanes)
                    else:
                        ready = bool(ap.run.result.checkpoint)
                    if ready and ap.movable():
                        requeued = len(svc._checkpoint_drain(ap, reason="movable drill eviction"))
                        evicted = True
                        break
        svc._drain(reason="movable drill end")
    finally:
        svc.close()
    statuses = dict(svc.settled)
    return {
        "evicted": evicted,
        "requeued": requeued,
        "routes": sorted(routes),
        "statuses": statuses,
        "all_completed": len(statuses) == len(submissions) and all(s == "completed" for s in statuses.values()),
        "losses": {"|".join(map(str, k)): v for k, v in _final_losses(service_dir).items()},
        "trial_routes": {"|".join(map(str, k)): v for k, v in _routes(service_dir).items()},
    }


def run_movable_phase(work_dir: str, *, device: Optional[str] = None, data_rows: Optional[int] = None,
                      epochs: int = 4, timeout_s: float = 600.0) -> dict:
    """Movable stacked buckets: two same-shape trials on a 1-slot pool with
    2 lanes co-pack into ONE stacked bucket; it is evicted mid-flight
    through the checkpoint-drain primitive (all lanes snapshotted together
    at a cooperative round boundary), resumed and run to completion, and
    its final losses are held to an undisturbed run of the same configs.
    The drained lanes resume as single trials from their lane checkpoints
    (the JAX service's rule), so the disturbed run trains in lanes and then
    alone while the reference stays in lanes: on the CPU, where a lane is
    its single run's bits, the losses must be BIT-IDENTICAL (the JAX
    drill's gate); on the card they are held by :func:`_parity`'s rule
    (within rel 1e-3 across kernel routes) and ``bit_identical`` reports
    whether the bits matched too. The JAX drill's pipelined arm (a vector
    placement of two stage blocks) waits for pipeline placements:
    :data:`NOT_PORTED`."""
    import torch

    device = _device(device)
    base, shapes, data_rows = _sizes(device, None, None, data_rows, CPU_SHAPES, CARD_SHAPES)
    subs = [{**base, **shapes[0], "epochs": epochs, "seed": s} for s in (0, 1)]
    arm = dict(svc_kw=dict(n_slices=1, max_lanes=2), data_rows=data_rows, device=device, timeout_s=timeout_s)
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        disturbed = _run_movable_arm(os.path.join(work_dir, "movable_stacked"), subs, evict=True, **arm)
        reference = _run_movable_arm(os.path.join(work_dir, "movable_stacked_ref"), subs, evict=False, **arm)
    finally:
        torch.set_num_threads(threads)
    mismatched = sorted(k for k in set(disturbed["losses"]) | set(reference["losses"])
                        if disturbed["losses"].get(k) != reference["losses"].get(k))
    parity = _parity(disturbed["losses"], disturbed["trial_routes"], reference["losses"],
                     reference["trial_routes"], exact_only=device == "cpu")
    stacked = {
        "evicted": disturbed["evicted"],
        "requeued": disturbed["requeued"],
        "routes": disturbed["routes"],
        "reference_routes": reference["routes"],
        "trial_routes": disturbed["trial_routes"],
        "all_completed": disturbed["all_completed"] and reference["all_completed"],
        "losses": disturbed["losses"],
        "reference_losses": reference["losses"],
        "mismatched": mismatched,
        "bit_identical": bool(disturbed["evicted"] and disturbed["all_completed"] and reference["all_completed"]
                              and len(disturbed["losses"]) == len(subs) and not mismatched),
        "parity": parity,
    }
    stacked["held"] = bool(disturbed["evicted"] and stacked["all_completed"] and parity["ok"]
                           and parity["compared"] == len(subs))
    return {"stacked": stacked, "pipelined": {"not_ported": NOT_PORTED["movable_pipelined"]},
            "ok": stacked["bit_identical"] if device == "cpu" else stacked["held"]}


def run_deadline_phase(work_dir: str, *, device: Optional[str] = None, base: Optional[dict] = None,
                       shapes: Optional[tuple] = None, long_epochs: int = 40, data_rows: Optional[int] = None,
                       train_data=None, timeout_s: float = 600.0) -> dict:
    """Phase 2 (module docstring), in this process: two best-effort whales
    (``shapes[0]``, ``shapes[1]``; distinct buckets, no co-pack) fill a
    2-slot pool and run until each has a durable checkpoint; then a size-2
    deadline trial (``shapes[2]``, one epoch, deadline 120 s) arrives. The
    JAX drill's gates."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.service.runtime import SweepService
    from multidisttorch_tpu_torch.service.scheduler import PreemptionPolicy

    device = _device(device)
    base, shapes, data_rows = _sizes(device, base, shapes, data_rows, CPU_DEADLINE_SHAPES, CARD_DEADLINE_SHAPES)
    service_dir = os.path.join(work_dir, "deadline")
    shutil.rmtree(service_dir, ignore_errors=True)
    os.makedirs(service_dir, exist_ok=True)
    tel_dir = os.path.join(service_dir, "telemetry")
    own_telemetry = not telemetry.enabled()
    if own_telemetry:
        telemetry.configure(tel_dir)
    bus = telemetry.get_bus()
    events_path = bus.path if bus is not None and bus.path else os.path.join(tel_dir, "events.jsonl")
    policy = PreemptionPolicy(max_preemptions_per_trial=1, trial_cooldown_s=5.0, global_cooldown_s=0.05)
    client = squeue.SweepClient(service_dir, tenant="drill")
    report: dict = {"ok": False}
    svc = None
    try:
        svc = SweepService(service_dir, n_slices=2, max_lanes=1, data_rows=data_rows, train_data=train_data,
                           defrag_enabled=False, preempt=policy, retry=RetryPolicy(max_retries=2), device=device)
        # Two best-effort whales fill the pool, then run until each has a
        # DURABLE checkpoint: the preemption primitive refuses to evict
        # unflushed progress.
        for shape in shapes[:2]:
            client.submit({**base, **shape, "epochs": long_epochs})
        t0 = time.time()
        while time.time() - t0 < timeout_s:
            svc.tick()
            if len(svc.active) == 2 and all(bool(ap.run.result.checkpoint) for ap in svc.active.values()):
                break
        pool_full = svc.pool.free_total == 0

        # The deadline whale: size 2 = the WHOLE pool. It can only place if
        # both best-effort trials are evicted.
        deadline_s = 120.0
        big = client.submit({**base, **shapes[2], "epochs": 1, "seed": 9}, size=2, deadline_s=deadline_s)
        submit_ts = time.time()
        while time.time() - submit_ts < deadline_s + 30:
            svc.tick()
            if svc.settled.get(big):
                break
        big_status = svc.settled.get(big)
        big_settle_s = round(time.time() - submit_ts, 3)

        # The victims come back: they resume from their drained checkpoint
        # and complete.
        t0 = time.time()
        while len(svc.settled) < 3 and time.time() - t0 < timeout_s:
            svc.tick()
        svc._drain(reason="drill end")
        books = svc.books()
        settled = dict(svc.settled)
    finally:
        if svc is not None:
            svc.close()
        events = telemetry.read_events(events_path)
        if own_telemetry:
            telemetry.disable()
    pre = [e for e in events if str(e.get("kind", "")).startswith("preempt")]
    kinds = {k: sum(1 for e in pre if e["kind"] == k)
             for k in ("preempt_start", "preempt_victim", "preempt_end", "preempt_blocked")}
    victims = [(e.get("data") or {}) for e in pre if e["kind"] == "preempt_victim"]
    hits = [e for e in events if e.get("kind") == "deadline_hit"]
    budget_ok = (all(v.get("preempt_count", 99) <= policy.max_preemptions_per_trial for v in victims)
                 and len(victims) <= 2 * policy.max_preemptions_per_trial)
    all_completed = len(settled) == 3 and all(s == "completed" for s in settled.values())
    report.update({
        "device": device,
        "pool_full_before_deadline": pool_full,
        "deadline_submission": big,
        "deadline_s": deadline_s,
        "deadline_status": big_status,
        "settle_latency_s": big_settle_s,
        "completed_before_deadline": bool(big_status == "completed" and big_settle_s < deadline_s),
        "preempt_events": kinds,
        "victims": victims,
        "victims_within_budget": budget_ok,
        "deadline_hit_traced": len(hits) >= 1,
        "victims_resumed_and_completed": all_completed,
        "deadline_books": books.get("deadline"),
        "preemption_books": books.get("preemption"),
        "service_dir": service_dir,
        "ok": bool(pool_full and kinds["preempt_victim"] >= 1 and big_status == "completed"
                   and big_settle_s < deadline_s and budget_ok and len(hits) >= 1 and all_completed),
    })
    return report


def run_loadgen_phase(n_submissions: int, *, seed: int = 0) -> dict:
    """The load generator's replay of ``n_submissions`` with the JAX drill's
    gates. It runs under the control-plane profiler (armed for the phase if
    none is), so the report carries the passes' flight books beside the
    submissions per wall second."""
    from multidisttorch_tpu_torch.service.loadgen import run_loadgen
    from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof

    own = _ctlprof.get_ctlprof() is None
    prof = _ctlprof.configure() if own else _ctlprof.get_ctlprof()
    try:
        report = run_loadgen(n_submissions=n_submissions, seed=seed)
        report["ctl"] = prof.books()
    finally:
        if own:
            _ctlprof.disable()
    report["gates"] = {
        "zero_lost": report["zero_lost"],
        "fairness_within_10pct": report["fairness"]["within_10pct"],
        "deadline_hit_rate_floor_0.9": (
            report["deadline"]["hit_rate"] is not None and report["deadline"]["hit_rate"] >= 0.9
        ),
        "p99_recorded": bool(report["placement_latency_s"].get("count")),
        # The offline SLO verdict, exact off the whole histogram; the
        # percentile gates above cross-check it.
        "slo_met": report["slo"]["met"],
        "slo_exact": all(s.get("exact") for s in report["slo"]["slos"].values()),
    }
    report["ok"] = all(report["gates"].values())
    return report


def run_scenario_phase(n_submissions: Optional[int] = None, *, seed: int = 0) -> dict:
    """The load generator's fabric scenarios over the dynamic topology: each
    replays twice, the elastic arm (splits and stealing through the
    production topology trie) against static routing on the same seeded
    workload. Gates: zero lost, none double-owned, and the elastic arm's p99
    placement latency and deadline hit rate within 10 % of the static arm's."""
    from multidisttorch_tpu_torch.service.loadgen import FABRIC_SCENARIOS, run_fabric_scenario

    if n_submissions is None:
        n_submissions = int(os.environ.get("MDT_FABRIC_SCENARIO_N", "20000") or 20000)
    scenarios: dict[str, dict] = {}
    for name in sorted(FABRIC_SCENARIOS):
        rep = run_fabric_scenario(name, n_submissions=n_submissions, seed=seed)
        rep["ok"] = all(rep["gates"].values())
        scenarios[name] = rep
    return {
        "n_submissions": n_submissions,
        "scenarios": scenarios,
        "ok": all(r["ok"] for r in scenarios.values()),
    }


def run_fabric_bench(work_dir: str, *, device: Optional[str] = None, loadgen_n: Optional[int] = None) -> dict:
    """The ported phases and their gates (the JAX bench's failover, split,
    movable, deadline, load-generator and scenario gates, and the steal
    drill's); :data:`NOT_PORTED` lists the rest. ``loadgen_n`` defaults to
    ``MDT_FABRIC_LOADGEN_N`` (1,000,000), the scenarios' size to
    ``MDT_FABRIC_SCENARIO_N`` (20,000), as in the JAX bench."""
    device = _device(device)
    os.makedirs(work_dir, exist_ok=True)
    if loadgen_n is None:
        loadgen_n = int(os.environ.get("MDT_FABRIC_LOADGEN_N", "1000000") or 1000000)
    t0 = time.time()
    failover = run_failover_phase(work_dir, device=device)
    split_chaos = run_split_chaos(work_dir, device=device)
    steal = run_steal_phase(work_dir, device=device)
    movable = run_movable_phase(work_dir, device=device)
    deadline = run_deadline_phase(work_dir, device=device)
    loadgen = run_loadgen_phase(loadgen_n)
    scenarios = run_scenario_phase()
    gates = {
        "kill_exercised": failover["kill_exercised"],
        "zero_lost_submissions": failover["zero_lost"],
        "shard_adopted_by_survivor": failover["adoption_evident"],
        "rehomed_trials_present": failover["rehomed_count"] >= 1,
        "rehomed_parity": failover["parity"]["ok"],
        "trace_complete": failover["trace"]["completeness"]["complete"],
        "trace_cross_epoch": failover["trace"]["rehomed_cross_epoch"],
        "split_kill_exercised": split_chaos["split_kill_exercised"],
        "split_zero_lost": split_chaos["zero_lost"],
        "split_no_double_own": split_chaos["no_double_own"],
        "split_seam_closed": split_chaos["topology"]["seam_closed"],
        "split_parity": split_chaos["parity"]["ok"],
        "steal_executed_bit_identical": steal["ok"],
        "stacked_evict_resume_bit_identical": movable["stacked"]["bit_identical"],
        "deadline_preemption_drill": deadline["ok"],
        "scenario_gates": scenarios["ok"],
        "loadgen_gates": loadgen["ok"],
    }
    return {
        "protocol": "fabric_v2",
        "device": device,
        "wall_s": round(time.time() - t0, 1),
        "failover": failover,
        "split_chaos": split_chaos,
        "steal": steal,
        "movable": movable,
        "deadline": deadline,
        "loadgen": loadgen,
        "fabric_scenarios": scenarios,
        "not_ported": dict(NOT_PORTED),
        "gates": gates,
        "ok": all(gates.values()),
    }


if __name__ == "__main__":
    import argparse
    import tempfile

    parser = argparse.ArgumentParser(description="the service fabric's drills")
    parser.add_argument("--device", default=None, help="the replicas' and services' device (default: the card)")
    args = parser.parse_args()
    r = run_fabric_bench(tempfile.mkdtemp(prefix="bench_fabric_"), device=args.device)
    json.dump(r, sys.stdout, indent=1, default=str)
    print()
    sys.exit(0 if r["ok"] else 1)
