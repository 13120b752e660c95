"""The sweep service's acceptance drill; the port's counterpart of the JAX
package's ``service/drill.py``, through the port's own CLI.

Two phases (docs/SERVICE.md "Acceptance drill"):

1. **Kill and restart, and fair share** (:func:`run_kill_restart_phase`): a
   real daemon child (``python -m
   multidisttorch_tpu_torch.examples.sweep_service``) serves 2 tenants of
   mixed shapes (12 and 6 submissions by default) under contention, is
   SIGKILLed mid-sweep (no drain: the crash case), restarted and run to the
   end. Gates: zero lost submissions
   (every id settles), per-tenant goodput >= 0.8 across the kill, and the
   contended fair-share ratio within 10 % of the configured 2:1 weights
   (from the durable journal, both daemons included). Each daemon's
   ``BOOT`` line (its device's start among them) and the restarted daemon's
   ``LAUNCHES`` line are in the report.
2. **Defragmentation** (:func:`run_defrag_phase`): an in-process service
   over 4 slots driven tick by tick into a fragmented layout (short trials
   leave holes between long ones); a size-2 trial starves behind the
   fragmentation until the defrag policy migrates a running trial through
   the snapshot-fast drain and the starved trial places in the opened
   window. Gates: a ``defrag_end`` event before the starved trial's
   placement, and the migrated victims still settle ``completed``.

The drill runs on the card unless the caller asks for the CPU
(``device="cpu"``), and raises where CUDA is asked for and absent. On the
CPU its sizes are the JAX drill's; on the card they default to the
full-width 784-400-20 VAE at batch 128, whose shape buckets differ in
``fused_steps``.
Every wait is bounded: a tick loop by a count and a generous wall limit,
a child by its timeout, and the in-process service is closed in a
``finally`` so nothing writes after the drill returns.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Optional

from multidisttorch_tpu_torch.service import queue as squeue

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The JAX drill's sizes: two shape buckets of a tiny VAE on 128 rows.
CPU_BASE = dict(batch_size=32, latent_dim=4, log_interval=1000)
CPU_SHAPES = ({"hidden_dim": 16}, {"hidden_dim": 24})
CPU_DEFRAG_SHAPES = ({"hidden_dim": 16}, {"hidden_dim": 24}, {"hidden_dim": 40}, {"hidden_dim": 56})
# The card's: the full-width VAE, 50 batches an epoch for the daemons.
CARD_BASE = dict(batch_size=128, hidden_dim=400, latent_dim=20, fused_steps=10, log_interval=10**9)
CARD_SHAPES = ({"fused_steps": 10}, {"fused_steps": 5})
CARD_DEFRAG_SHAPES = tuple({"fused_steps": f} for f in (10, 8, 5, 4))
CARD_ROWS = 6400


def _device(device) -> str:
    """``"cpu"`` or ``"cuda"``: the drill's device, resolved as the port's
    entry points resolve theirs (raises where CUDA is asked for and
    absent)."""
    from multidisttorch_tpu_torch.parallel.cluster import default_device

    return default_device(device).type


def _sizes(dev: str, base, shapes, data_rows, cpu_shapes, card_shapes):
    cpu = dev == "cpu"
    return (
        dict((CPU_BASE if cpu else CARD_BASE) if base is None else base),
        (cpu_shapes if cpu else card_shapes) if shapes is None else shapes,
        (128 if cpu else CARD_ROWS) if data_rows is None else data_rows,
    )


def _fair_share_from_journal(events: list[dict]) -> dict:
    """Whole-run contended fair-share fold off the durable queue journal
    (every daemon incarnation): a ``placed`` lane is contended when, at
    that instant, at least two tenants had submissions waiting. Equal-cost
    drill configs make lane counts the cost ratio."""
    tenant_of: dict[str, str] = {}
    waiting: dict[str, set] = {}
    placed: dict[str, int] = {}
    contended: dict[str, int] = {}
    for ev in events:
        kind = ev.get("event")
        if kind == "submitted":
            sub = ev.get("sub") or {}
            sid, ten = sub.get("submission_id"), sub.get("tenant")
            if sid:
                tenant_of[sid] = ten
                waiting.setdefault(ten, set()).add(sid)
            continue
        sid = ev.get("submission_id")
        ten = tenant_of.get(sid)
        if ten is None:
            continue
        if kind == "placed":
            n_backlogged = sum(1 for s in waiting.values() if s)
            placed[ten] = placed.get(ten, 0) + 1
            if n_backlogged >= 2:
                contended[ten] = contended.get(ten, 0) + 1
            waiting.setdefault(ten, set()).discard(sid)
        elif kind == "unplaced":
            waiting.setdefault(ten, set()).add(sid)
        elif kind in ("settled", "rejected"):
            waiting.setdefault(ten, set()).discard(sid)
    return {"placed": placed, "contended": contended}


def _spawn_daemon(service_dir: str, *, weights: dict, log_path: str, device: str, slices: int, max_lanes: int,
                  data_rows: int):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.pop("MDT_TELEMETRY", None)  # the daemon configures its own
    argv = [
        sys.executable, "-m", "multidisttorch_tpu_torch.examples.sweep_service", service_dir,
        "--device", device,
        "--slices", str(slices),
        "--max-lanes", str(max_lanes),
        "--data-rows", str(data_rows),
        "--retry", "2",
        "--exit-when-drained",
        "--idle-grace", "1.5",
    ]
    for name, w in sorted(weights.items()):
        argv += ["--tenant-weight", f"{name}={w}"]
    log_f = open(log_path, "a")
    proc = subprocess.Popen(argv, env=env, stdout=log_f, stderr=subprocess.STDOUT, text=True)
    return proc, log_f


def _settled_count(service_dir: str) -> int:
    folded = squeue.fold_queue(squeue.load_queue(service_dir))
    return sum(1 for r in folded.values() if r["state"] == squeue.SETTLED)


def _log_records(log_path: str, tag: str) -> list:
    """The ``{tag} {...}`` JSON lines of the daemons' shared log, in order."""
    out = []
    try:
        with open(log_path) as f:
            for ln in f:
                if ln.startswith(tag + " "):
                    out.append(json.loads(ln[len(tag) + 1:]))
    except (OSError, ValueError):
        pass
    return out


def run_kill_restart_phase(
    work_dir: str,
    *,
    device: Optional[str] = None,
    base: Optional[dict] = None,
    shapes: Optional[tuple] = None,
    epochs: int = 2,
    data_rows: Optional[int] = None,
    slices: int = 2,
    max_lanes: int = 2,
    submissions: tuple = (12, 6),
    timeout_s: float = 600.0,
) -> dict:
    """Phase 1: a daemon child, 2 tenants of mixed shapes (``submissions``,
    default the JAX drill's 12 and 6, weights 2:1), SIGKILL mid-sweep,
    restart, every submission settles. ``shapes`` are the two shape
    buckets' config fields over ``base``.

    The contended ratio moves by one placement of the smaller tenant's
    count at the sweep's end (its last placement is uncontended, or the
    other's is) and by the kill's re-placements: at 12 and 6 one placement
    is 17 % of beta's share, wider than the 10 % gate, so where the gate
    must decide, pass larger counts."""
    device = _device(device)
    base, shapes, data_rows = _sizes(device, base, shapes, data_rows, CPU_SHAPES, CARD_SHAPES)
    service_dir = os.path.join(work_dir, "service")
    shutil.rmtree(service_dir, ignore_errors=True)
    os.makedirs(service_dir, exist_ok=True)
    log_path = os.path.join(work_dir, "daemon.log")
    if os.path.exists(log_path):
        os.remove(log_path)
    weights = {"alpha": 2.0, "beta": 1.0}
    base = dict(base, epochs=epochs)
    spawn = dict(weights=weights, log_path=log_path, device=device, slices=slices, max_lanes=max_lanes,
                 data_rows=data_rows)

    subs: dict[str, list[str]] = {"alpha": [], "beta": []}
    ca = squeue.SweepClient(service_dir, tenant="alpha")
    cb = squeue.SweepClient(service_dir, tenant="beta")
    for i in range(submissions[0]):
        subs["alpha"].append(ca.submit({**base, **shapes[i % 2], "seed": i}))
    for i in range(submissions[1]):
        subs["beta"].append(cb.submit({**base, **shapes[i % 2], "seed": 100 + i}))
    all_ids = subs["alpha"] + subs["beta"]

    # Daemon 1: run until mid-sweep, then SIGKILL (no drain).
    proc, log_f = _spawn_daemon(service_dir, **spawn)
    kill_at = max(3, len(all_ids) // 4)
    t0 = time.time()
    killed_at_settled: Optional[int] = None
    kill_exercised = False
    try:
        while time.time() - t0 < timeout_s:
            n = _settled_count(service_dir)
            if n >= kill_at:
                killed_at_settled = n
                break
            if proc.poll() is not None:
                break  # ended before the kill: gated below
            time.sleep(0.1)
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            kill_exercised = True
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log_f.close()
    exit1 = proc.returncode
    # The crash gates mean something only if the daemon died by the SIGKILL
    # with work outstanding, never by finishing early.
    kill_exercised = kill_exercised and exit1 == -signal.SIGKILL

    # Daemon 2: restarted over the same directory; everything recovers from
    # the journal, the ledger and the checkpoints.
    t_restart = time.time()
    proc, log_f = _spawn_daemon(service_dir, **spawn)
    try:
        final = squeue.SweepClient(service_dir).wait(all_ids, timeout_s=timeout_s)
        restart_s = time.time() - t_restart
        proc.wait(timeout=120)  # idles out through --exit-when-drained
    finally:
        try:
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            proc.kill()
            proc.wait(timeout=60)
        log_f.close()
    exit2 = proc.returncode

    states = {s: r.get("state") for s, r in final.items()}
    statuses = {s: r.get("status") for s, r in final.items()}
    lost = sorted(s for s in all_ids if states.get(s) not in (squeue.SETTLED, squeue.REJECTED))
    completed = sum(1 for v in statuses.values() if v == "completed")

    fair = _fair_share_from_journal(squeue.load_queue(service_dir))
    ca_n = fair["contended"].get("alpha", 0)
    cb_n = fair["contended"].get("beta", 0)
    ratio = (ca_n / cb_n) if cb_n else None
    expected = weights["alpha"] / weights["beta"]
    ratio_ok = ratio is not None and abs(ratio - expected) / expected <= 0.10

    books = {}
    try:
        with open(os.path.join(service_dir, "service_books.json")) as f:
            books = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    tenants = books.get("tenants") or {}
    goodputs = {t: (tenants.get(t) or {}).get("goodput") for t in weights}
    goodput_ok = all(g is not None and g >= 0.8 for g in goodputs.values())

    return {
        "submissions": len(all_ids),
        "per_tenant_submitted": {t: len(v) for t, v in subs.items()},
        "weights": weights,
        "device": device,
        "killed_at_settled": killed_at_settled,
        "kill_exercised": kill_exercised,
        "daemon_exits": [exit1, exit2],
        "daemon_boots": _log_records(log_path, "BOOT"),
        "daemon_launches": _log_records(log_path, "LAUNCHES"),
        "restart_to_all_settled_s": round(restart_s, 3),
        "lost_submissions": lost,
        "zero_lost": not lost,
        "completed": completed,
        "statuses": dict(sorted(statuses.items())),
        "fair_share": {
            **fair,
            "contended_ratio": round(ratio, 3) if ratio else None,
            "expected_ratio": expected,
            "within_10pct": ratio_ok,
        },
        "tenant_goodput": goodputs,
        "tenant_goodput_floor_0.8": goodput_ok,
        "queue_wait": books.get("queue_wait"),
        "placement_latency": books.get("placement_latency"),
        "books_path": os.path.join(service_dir, "service_books.json"),
        "daemon_log": log_path,
    }


def _tick_until(svc, cond, *, max_ticks: int, timeout_s: float) -> bool:
    """Tick until ``cond()``, at most ``max_ticks`` ticks and ``timeout_s``
    seconds; whether it held."""
    t0 = time.time()
    for _ in range(max_ticks):
        svc.tick()
        if cond():
            return True
        if time.time() - t0 > timeout_s:
            break
    return bool(cond())


def run_defrag_phase(
    work_dir: str,
    *,
    device: Optional[str] = None,
    base: Optional[dict] = None,
    shapes: Optional[tuple] = None,
    long_epochs: int = 40,
    data_rows: Optional[int] = None,
    train_data=None,
    test_data=None,
    starvation_s: float = 0.4,
    timeout_s: float = 300.0,
) -> dict:
    """Phase 2: the in-process defrag drill (module docstring). The layout
    is short@0, long@1, short@2, long@3 (four shape buckets, so nothing
    co-packs); the size-2 trial takes ``shapes[0]``. Returns the
    event-level evidence and the service's books."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.service.runtime import SweepService

    device = _device(device)
    base, shapes, data_rows = _sizes(device, base, shapes, data_rows, CPU_DEFRAG_SHAPES, CARD_DEFRAG_SHAPES)

    service_dir = os.path.join(work_dir, "defrag")
    shutil.rmtree(service_dir, ignore_errors=True)
    os.makedirs(service_dir, exist_ok=True)
    tel_dir = os.path.join(service_dir, "telemetry")
    own_telemetry = not telemetry.enabled()
    if own_telemetry:
        telemetry.configure(tel_dir)
    # The evidence is read from wherever the events land: an embedding
    # process's own sink when it configured telemetry first.
    bus = telemetry.get_bus()
    events_path = bus.path if bus is not None and bus.path else os.path.join(tel_dir, "events.jsonl")
    client = squeue.SweepClient(service_dir, tenant="drill")
    svc = None
    report: dict = {"ok": False}
    big = None
    try:
        svc = SweepService(service_dir, n_slices=4, max_lanes=1, data_rows=data_rows, train_data=train_data,
                           test_data=test_data, starvation_s=starvation_s, defrag_cooldown_s=0.1, verbose=False,
                           device=device)
        layout = [{**base, **shapes[0], "epochs": 1}, {**base, **shapes[1], "epochs": long_epochs},
                  {**base, **shapes[2], "epochs": 1}, {**base, **shapes[3], "epochs": long_epochs}]
        for cfg in layout:
            client.submit(cfg)
            _tick_until(svc, lambda: svc.sched.pending_count() == 0, max_ticks=10_000, timeout_s=60)
        # The short trials finish: their freed slots are the holes.
        _tick_until(svc, lambda: sum(1 for s in svc.settled.values() if s == "completed") >= 2,
                    max_ticks=1_000_000, timeout_s=timeout_s)
        frag_runs = svc.pool.free_runs()
        fragmented = svc.pool.largest_free_run() < 2 <= svc.pool.free_total
        big = client.submit({**base, **shapes[0], "epochs": 1, "seed": 9}, size=2)
        t_submit = time.time()
        _tick_until(svc, lambda: svc.settled.get(big) is not None, max_ticks=1_000_000, timeout_s=timeout_s)
        unblock_wait_s = round(time.time() - t_submit, 3)
        big_status = svc.settled.get(big)
        # The migrated long trials run to the end: the drain's restore gave
        # finishable trials.
        _tick_until(svc, lambda: len(svc.settled) >= 5, max_ticks=1_000_000, timeout_s=timeout_s)
        svc._drain(reason="drill end")
        books = svc.books()
        settled = dict(svc.settled)
    finally:
        if svc is not None:
            svc.close()
        events = telemetry.read_events(events_path)
        if own_telemetry:
            telemetry.disable()
    def_events = [e for e in events if str(e.get("kind", "")).startswith("defrag")]
    ends = [e for e in def_events if e["kind"] == "defrag_end"]
    placed_big = [e for e in events
                  if e.get("kind") == "trial_placed" and (e.get("data") or {}).get("sub_id") == big]
    unblocked_after_defrag = bool(ends and placed_big and placed_big[-1]["ts"] >= ends[0]["ts"])
    migrated = [e for e in events if e.get("kind") == "trial_migrated"]
    report.update({
        "fragmented_free_runs": frag_runs,
        "fragmented": fragmented,
        "big_submission": big,
        "big_status": big_status,
        "unblock_wait_s": unblock_wait_s,
        "defrag_events": {k: sum(1 for e in def_events if e["kind"] == k)
                          for k in ("defrag_start", "defrag_move", "defrag_end", "defrag_blocked")},
        "defrag_end": ends[0].get("data") if ends else None,
        "defrag_end_ts": ends[0]["ts"] if ends else None,
        "big_placed_ts": placed_big[-1]["ts"] if placed_big else None,
        "migrations": [{**(e.get("data") or {}), "trial_id": e.get("trial_id")} for e in migrated],
        "all_settled": sorted(settled.values()),
        "all_completed": all(s == "completed" for s in settled.values()),
        "unblocked_after_defrag": unblocked_after_defrag,
        "fragmentation_books": books.get("fragmentation"),
        "defrag_books": books.get("defrag"),
        "checkpoint_books": books.get("checkpoint"),
        "ok": bool(ends and big_status == "completed" and unblocked_after_defrag and migrated),
    })
    return report


def run_service_bench(work_dir: str, *, device: Optional[str] = None, kill_restart: Optional[dict] = None,
                      defrag: Optional[dict] = None) -> dict:
    """Both phases and their gates; ``kill_restart`` and ``defrag`` are
    each phase's keyword arguments beyond ``device``."""
    device = _device(device)
    os.makedirs(work_dir, exist_ok=True)
    t0 = time.time()
    phase1 = run_kill_restart_phase(work_dir, device=device, **(kill_restart or {}))
    phase2 = run_defrag_phase(work_dir, device=device, **(defrag or {}))
    gates = {
        "kill_exercised": phase1["kill_exercised"],
        "zero_lost_submissions": phase1["zero_lost"],
        "fair_share_within_10pct": phase1["fair_share"]["within_10pct"],
        "tenant_goodput_floor": phase1["tenant_goodput_floor_0.8"],
        "latency_books_present": bool((phase1.get("queue_wait") or {}).get("count")
                                      and (phase1.get("placement_latency") or {}).get("count")),
        "defrag_unblocks_starved_trial": phase2["ok"],
    }
    return {
        "protocol": "service_v1",
        "wall_s": round(time.time() - t0, 1),
        "kill_restart": phase1,
        "defrag": phase2,
        "gates": gates,
        "ok": all(gates.values()),
    }
