"""Incident-plane chaos drill: every fault kind the port runs, through the
detector; the port's counterpart of the JAX package's
``service/incident_drill.py``.

:func:`run_incidents_bench` replays one scenario per chaos fault family,
through the real production mechanism wherever one exists in-process
(run_hpo fault plans, membership staleness, the SLO engine, the
supervision seam), or a scripted emit at the exact production seam shape
where the trigger is *by definition* a broken invariant no healthy code
path can produce (a duplicate steal grant) or needs a genuinely wedged
backend (preflight's init-deadline verdict). Each scenario runs in its
own telemetry scope (its own event stream, flight ring, detector and
incident ledger), then its ``incidents.jsonl`` is folded into a
fault -> verdict confusion matrix.

Gates (``ok`` is all of them):

- **100% diagonal**: every scenario produced EXACTLY ONE incident and its
  verdict is the expected root-cause kind.
- **zero false positives**: a no-fault soak (a real 2-trial sweep) opens
  nothing.
- **bundle present**: every fired incident published its flight-ring
  bundle (``incidents/<id>/`` with ``trigger.json`` + ``flight_ring.json``).
- **taxonomy covered**: the scenarios jointly exercise every incident kind
  a ported scenario can raise.
- **SLO exemplar cited**: the SLO burn incident carries the p99
  worst-offender submission id in its detail.

Not ported (ROADMAP A.12b): the scenarios that need the sharded service
fabric (``daemon_lost``, ``fence_raced``, ``shard_split_lost``) and the
offline autopsy over the torn split. The report lists them under
``not_ported`` and never counts them as passed; the two kinds only they
raise (``fence_lost``, ``split_torn``) are listed as not covered.

The sweeps keep the JAX drill's geometry (128 synthetic MNIST rows,
batch 16, hidden 32, latent 8: 8 steps an epoch) and run on the card
unless the caller asks for the CPU (``device="cpu"``); where CUDA is
asked for and absent the drill raises before anything starts.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from multidisttorch_tpu_torch import telemetry
from multidisttorch_tpu_torch.telemetry import incident as tincident
from multidisttorch_tpu_torch.telemetry.events import get_bus

# 128 rows / batch 16 = 8 optimizer steps per epoch (the chaos-test
# geometry).
_STEPS_PER_EPOCH = 8

# The fabric scenarios and the autopsy over the torn split.
NOT_PORTED = {
    "daemon_lost": "A.12b",
    "fence_raced": "A.12b",
    "shard_split_lost": "A.12b",
    "autopsy": "A.12b",
}
# The kinds only the fabric scenarios raise.
NOT_COVERED = (tincident.FENCE_LOST, tincident.SPLIT_TORN)


def _data():
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist

    return synthetic_mnist(128, seed=0)


def _cfg(trial_id: int, **kw):
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig

    defaults = dict(
        trial_id=trial_id,
        epochs=1,
        batch_size=16,
        hidden_dim=32,
        latent_dim=8,
        log_interval=10_000,
        seed=trial_id,
    )
    defaults.update(kw)
    return TrialConfig(**defaults)


def _sweep(configs, out_dir: str, device: str, **kw):
    from multidisttorch_tpu_torch.hpo.driver import run_hpo
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy

    base = dict(
        num_groups=1,
        device=device,
        out_dir=out_dir,
        verbose=False,
        save_images=False,
        resilient=True,
        retry=RetryPolicy(max_retries=2, backoff_base_s=0.01),
    )
    base.update(kw)
    return run_hpo(configs, _data(), None, **base)


# -- scenarios --------------------------------------------------------
# Each takes the scenario's scope directory and the drill's device.


def _sc_wedge(d: str, device: str):
    """WEDGE: a deadline-bounded collective abandons its watchdog ->
    ``WedgedCollective`` reaches the supervision seam. (A one-process
    drill has no peer to wedge, so the drill raises the production
    exception type at the production classification seam.)"""
    from multidisttorch_tpu_torch.hpo.supervision import classify_failure
    from multidisttorch_tpu_torch.parallel.cluster import WedgedCollective

    exc = WedgedCollective("collective 'epoch_loss' wedged past 30.0s deadline")
    assert classify_failure(exc, trial_id=0) == "preemption"


def _sc_backend_wedge(d: str, device: str):
    """Backend wedge: the preflight verdict seam, production field shape
    (utils/preflight.py emits exactly this on an init-deadline expiry;
    actually wedging a backend needs a dead card)."""
    from multidisttorch_tpu_torch.utils import preflight

    get_bus().emit(
        "preflight_verdict",
        platform="cpu",
        verdict=preflight.WEDGED_INIT_TIMEOUT,
        reason="drill: init blocked past deadline, no live holder",
        usable=False,
        elapsed_s=12.0,
    )


def _sc_slo_overload(d: str, device: str):
    """SLO burn: a real SloEngine over a breaching latency stream, with
    the exemplar histogram attached: the firing ``slo_alert`` must carry
    the p99 worst-offender id into the incident detail."""
    from multidisttorch_tpu_torch.service.runtime import LATENCY_BUCKETS
    from multidisttorch_tpu_torch.telemetry.metrics import Histogram
    from multidisttorch_tpu_torch.telemetry.slo import LATENCY, SloEngine, SloSpec

    eng = SloEngine(
        (
            SloSpec(
                name="drill_queue_wait",
                kind=LATENCY,
                source="queue_wait",
                threshold_s=0.1,
                objective=0.9,
                windows=((5.0, 1.0),),
            ),
        )
    )
    hist = Histogram(LATENCY_BUCKETS)
    eng.attach_exemplar("queue_wait", hist)
    t = time.time()
    for i in range(20):
        hist.observe(3.0, exemplar=f"drill-sub-{i:04d}")
        eng.observe_latency("queue_wait", 3.0, ts=t + i * 0.1)
    eng.evaluate(now=t + 2.5)


def _sc_diverge_storm(d: str, device: str):
    """DIVERGE x3: three distinct trials poisoned in one sweep. Each
    single divergence is routine attrition (no incident); the third
    distinct trial inside the storm window opens divergence_storm."""
    from multidisttorch_tpu_torch.faults import DIVERGE, FaultPlan, FaultSpec

    plan = FaultPlan(specs=tuple(FaultSpec(DIVERGE, t, step=2) for t in range(3)))
    results = _sweep([_cfg(t) for t in range(3)], os.path.join(d, "sweep"), device, fault_plan=plan)
    assert all(r.status == "diverged" for r in results)


def _sc_ckpt_corrupt(d: str, device: str):
    """CKPT_CORRUPT + CRASH: the only checkpoint rots, the crash-retry
    scan rejects it (CRC) -> ``ckpt_scan_reject`` -> ckpt_integrity.
    Repeated rejects of the same store dedup into one incident."""
    from multidisttorch_tpu_torch.faults import CKPT_CORRUPT, CRASH, FaultPlan, FaultSpec

    plan = FaultPlan(
        specs=(
            FaultSpec(CKPT_CORRUPT, 0, epoch=1),
            FaultSpec(CRASH, 0, step=_STEPS_PER_EPOCH + 3),
        )
    )
    (r,) = _sweep([_cfg(0, epochs=2)], os.path.join(d, "sweep"), device, fault_plan=plan)
    assert r.status == "completed"


def _sc_preempt(d: str, device: str):
    """PREEMPT: HostPreemption escapes run_hpo even under resilient mode
    (per-trial retry on a dying host is meaningless), but the
    classification event fires first -> host_preempted."""
    from multidisttorch_tpu_torch.faults import PREEMPT, FaultPlan, FaultSpec, HostPreemption

    plan = FaultPlan(specs=(FaultSpec(PREEMPT, 0, step=2),))
    try:
        _sweep([_cfg(0)], os.path.join(d, "sweep"), device, fault_plan=plan)
    except HostPreemption:
        return
    raise AssertionError("PREEMPT fault did not propagate")


def _sc_host_lost(d: str, device: str):
    """HOST_LOST: a membership heartbeat dies dirty (thread stopped
    without the clean ``left`` record); the view's staleness check emits
    ``host_lost`` on the transition -> replica_lost(host:slot)."""
    from multidisttorch_tpu_torch.parallel import membership

    rdir = os.path.join(d, "run")
    hb = membership.Heartbeat(rdir, 0, interval_s=0.05)
    hb.start()
    time.sleep(0.15)
    # SIGKILL semantics: stop the loop WITHOUT Heartbeat.stop(); a clean
    # exit writes "left" and is deliberately never lost.
    hb._stop.set()
    if hb._thread is not None:
        hb._thread.join(timeout=5.0)
    view = membership.MembershipView(rdir)
    lost = view.lost_hosts(0.05, now=time.time() + 1.0)
    assert lost == [0], f"expected slot 0 lost, got {lost}"


def _sc_steal_dup_grant(d: str, device: str):
    """Duplicate steal grant: two incarnations both answered request seq
    7, so fencing failed. No healthy code path can produce this (the steal
    file is append-only and grants are keyed by seq), so the drill scripts
    the second grant at the production emit shape (the JAX fabric's
    ``steal_grant``)."""
    bus = get_bus()
    for epoch in (3, 4):
        bus.emit("steal_grant", victim_shard=0, thief_shard=1, replica=epoch - 3, seq=7, n=2)


def _sc_soak(d: str, device: str):
    """No faults at all: a real 2-trial sweep. Gate: ZERO incidents."""
    results = _sweep([_cfg(0), _cfg(1)], os.path.join(d, "sweep"), device)
    assert all(r.status == "completed" for r in results)


# name, fault label (faults/plan.py vocabulary where the kind exists
# there), expected verdict, scenario fn, scripted-seam flag: the JAX
# drill's table less its fabric rows.
SCENARIOS = (
    ("wedge", "wedge", tincident.WEDGED_COLLECTIVE, _sc_wedge, False),
    ("backend_wedge", "backend_wedge", tincident.BACKEND_WEDGED, _sc_backend_wedge, True),
    ("slo_overload", "slo_overload", tincident.SLO_BURN, _sc_slo_overload, False),
    ("diverge_storm", "diverge", tincident.DIVERGENCE_STORM, _sc_diverge_storm, False),
    ("ckpt_corrupt", "ckpt_corrupt", tincident.CKPT_INTEGRITY, _sc_ckpt_corrupt, False),
    ("preempt", "preempt", tincident.HOST_PREEMPTED, _sc_preempt, False),
    ("host_lost", "host_lost", tincident.REPLICA_LOST, _sc_host_lost, False),
    ("steal_dup_grant", "steal_dup_grant", tincident.STEAL_ANOMALY, _sc_steal_dup_grant, True),
)


def _bundle_check(scope_dir: str, inc: dict):
    """The incident's published bundle dir, and whether it holds the
    black-box minimum (trigger + flight-ring dump)."""
    bdir = os.path.join(scope_dir, tincident.BUNDLE_DIRNAME, inc["id"])
    ok = all(os.path.isfile(os.path.join(bdir, n)) for n in ("trigger.json", "flight_ring.json"))
    return (bdir if os.path.isdir(bdir) else None), ok


def sweep_train_steps(sweep_dir: str) -> int:
    """The optimizer steps every attempt of a sweep directory's ledger
    ran: each attempt's last step (``steps``, or ``steps_at_failure``) less
    the step it resumed from; 0 where the scenario ran no sweep."""
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

    if not os.path.isdir(sweep_dir):
        return 0
    total = 0
    for e in SweepLedger(sweep_dir).load():
        if e.get("event") != "attempt_end":
            continue
        s = e.get("summary") or {}
        last = s.get("steps", s.get("steps_at_failure"))
        if last is not None:
            total += int(last) - int(s.get("resumed_from_step") or 0)
    return total


def _run_scenario(root: str, name: str, expected: Optional[str], fn, device: str) -> dict:
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    telemetry.configure(d)
    error = None
    try:
        fn(d, device)
    except Exception as e:  # noqa: BLE001 — the gate reports, not raises
        error = f"{type(e).__name__}: {e}"
    finally:
        ring = telemetry.get_flight_ring()
        ring_stats = (
            {"noted": ring.noted, "held": len(ring.snapshot()), "maxlen": ring.maxlen}
            if ring is not None
            else None
        )
        telemetry.disable()
    folded = tincident.load_incidents(d)
    incs = sorted(folded.values(), key=lambda i: str(i.get("id")))
    bundle, bundle_ok = (None, False)
    if len(incs) == 1:
        bundle, bundle_ok = _bundle_check(d, incs[0])
    verdict = incs[0]["kind"] if len(incs) == 1 else None
    return {
        "expected": expected,
        "n_incidents": len(incs),
        "verdict": verdict,
        "incidents": [
            {
                "id": i.get("id"),
                "kind": i.get("kind"),
                "subject": i.get("subject"),
                "count": i.get("count"),
                "status": i.get("status"),
            }
            for i in incs
        ],
        "bundle": bundle,
        "bundle_ok": bundle_ok,
        "flight_ring": ring_stats,
        "train_steps": sweep_train_steps(os.path.join(d, "sweep")),
        "error": error,
        "elapsed_s": round(time.perf_counter() - t0, 3),
        "scope_dir": d,
        "ok": error is None and len(incs) == 1 and verdict == expected and bundle_ok,
    }


def run_incidents_bench(work_dir: str, *, device: Optional[str] = None) -> dict:
    """Replay every ported chaos fault family, fold the fault -> verdict
    confusion matrix, and gate it (module docstring). Returns the report
    dict; ``ok`` is the verdict. ``device`` is the sweeps' (default: the
    card)."""
    from multidisttorch_tpu_torch.parallel.cluster import default_device

    dev = default_device(device).type
    os.makedirs(work_dir, exist_ok=True)
    scenarios: dict = {}
    confusion: dict = {}
    for name, fault, expected, fn, scripted in SCENARIOS:
        print(f"[incidents] scenario {name} ...", flush=True)
        sc = _run_scenario(work_dir, name, expected, fn, dev)
        sc["fault"] = fault
        sc["scripted_seam"] = scripted
        scenarios[name] = sc
        row = confusion.setdefault(fault, {})
        for inc in sc["incidents"]:
            row[inc["kind"]] = row.get(inc["kind"], 0) + 1
        print(
            f"[incidents]   -> {sc['n_incidents']} incident(s), verdict={sc['verdict']} expected={expected} "
            f"ok={sc['ok']}" + (f" error={sc['error']}" if sc["error"] else ""),
            flush=True,
        )
    for name, item in NOT_PORTED.items():
        print(f"[incidents] scenario {name}: not ported ({item})", flush=True)

    print("[incidents] no-fault soak ...", flush=True)
    soak = _run_scenario(work_dir, "soak", None, _sc_soak, dev)
    soak["ok"] = soak["error"] is None and soak["n_incidents"] == 0
    print(f"[incidents]   -> {soak['n_incidents']} incident(s) (gate: 0) ok={soak['ok']}", flush=True)

    covered = {sc["verdict"] for sc in scenarios.values() if sc["verdict"]}
    exemplar_ok = False
    slo = scenarios.get("slo_overload") or {}
    if slo.get("n_incidents") == 1:
        folded = tincident.load_incidents(slo["scope_dir"])
        detail = (folded.get(slo["incidents"][0]["id"]) or {}).get("detail") or {}
        exemplar_ok = bool((detail.get("exemplar") or {}).get("id"))

    reachable = sorted(set(tincident.KINDS) - set(NOT_COVERED))
    gates = {
        "diagonal_ok": all(sc["ok"] for sc in scenarios.values()),
        "soak_zero_false_positives": soak["ok"],
        "bundles_ok": all(sc["bundle_ok"] for sc in scenarios.values()),
        "taxonomy_covered": sorted(covered) == reachable,
        "slo_exemplar_cited": exemplar_ok,
    }
    return {
        "protocol": "incidents_v1",
        "device": dev,
        "scenarios": scenarios,
        "confusion": confusion,
        "soak": soak,
        "not_ported": dict(NOT_PORTED),
        "taxonomy": sorted(tincident.KINDS),
        "taxonomy_hit": sorted(covered),
        "taxonomy_not_covered": sorted(NOT_COVERED),
        "train_steps": sum(sc["train_steps"] for sc in scenarios.values()) + soak["train_steps"],
        "gates": gates,
        "ok": all(gates.values()),
    }


if __name__ == "__main__":
    import argparse
    import sys
    import tempfile

    parser = argparse.ArgumentParser(description="the incident plane's chaos drill")
    parser.add_argument("--device", default=None, help="the sweeps' device (default: the card)")
    args = parser.parse_args()
    r = run_incidents_bench(tempfile.mkdtemp(prefix="bench_incidents_"), device=args.device)
    json.dump(r, sys.stdout, indent=1, default=str)
    print()
    sys.exit(0 if r["ok"] else 1)
