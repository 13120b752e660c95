"""The standard chaos drill behind ``examples/chaos_run.py``.

Counterpart of ``multidisttorch_tpu/faults/harness.py``. Runs the SAME
small sweep twice, once clean and once under :meth:`FaultPlan.standard`
with full supervision (retry, ledger, scan-back restore, and a driver
restart after the simulated preemption), and reports:

- **recovery**: every infra fault in the plan fired and the sweep still
  settled every trial (completed, or diverged where the plan injected
  divergence);
- **goodput**: useful optimizer steps over executed optimizer steps across
  all attempts (fault-free is 1.0): the recovery machinery's overhead
  (replayed epochs, lanes restarted from scratch), not wall-clock noise;
- **parity**: for every trial whose faults hit between checkpoints
  (everything except the injected divergence), whether the final train
  loss is bit-identical to the fault-free run.

``device`` picks the card (the default) or ``"cpu"``; the sweep runs two
trial groups as slots of that one device. The widths default to the JAX
harness's CI size; ``batch_size``, ``hidden_dim``, ``latent_dim`` and
``fused_steps`` set the reference's for a run on the card.

Not ported here: the JAX drill's anomaly capture (ROADMAP A.10, second
part), so its report has no anomaly keys, and the multi-host drill
(:func:`run_chaos_mh_bench`, A.11).
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import time
from dataclasses import asdict
from typing import Optional

from multidisttorch_tpu_torch.faults.inject import FaultInjector, HostPreemption
from multidisttorch_tpu_torch.faults.plan import DIVERGE, FaultPlan

MAX_RESTARTS = 8  # driver restarts on preemption; plan-bounded in practice


def standard_configs(trials: int = 6, epochs: int = 4, *, batch_size: int = 16, hidden_dim: int = 32,
                     latent_dim: int = 8, fused_steps: int = 1) -> list:
    """The chaos sweep's trial set: small VAEs by default (the JAX
    harness's), a distinct lr and seed per trial, quiet logging."""
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig

    return [
        TrialConfig(
            trial_id=i,
            epochs=epochs,
            batch_size=batch_size,
            hidden_dim=hidden_dim,
            latent_dim=latent_dim,
            lr=1e-3 + 1e-4 * i,
            seed=i,
            log_interval=10_000,
            fused_steps=fused_steps,
        )
        for i in range(trials)
    ]


def _sweep_kwargs(out_dir: str, device=None) -> dict:
    from multidisttorch_tpu_torch.parallel.mesh import default_groups

    return dict(
        groups=default_groups(2, device),
        out_dir=out_dir,
        verbose=False,
        save_images=False,
    )


def _allocated(device) -> Optional[int]:
    """Bytes the caching allocator holds in tensors on the card after a
    collection (None on the CPU): a dead attempt's graphs and states must
    be freed with it."""
    import torch

    from multidisttorch_tpu_torch.parallel.cluster import default_device

    dev = default_device(device)
    if dev.type != "cuda":
        return None
    gc.collect()
    torch.cuda.synchronize(dev)
    return int(torch.cuda.memory_allocated(dev))


def run_chaos_bench(
    work_dir: str,
    *,
    trials: int = 6,
    epochs: int = 4,
    seed: int = 0,
    include_preempt: bool = True,
    data_rows: int = 128,
    stacked: bool = False,
    plan: Optional[FaultPlan] = None,
    telemetry_dir: Optional[str] = None,
    device=None,
    batch_size: int = 16,
    hidden_dim: int = 32,
    latent_dim: int = 8,
    fused_steps: int = 1,
) -> dict:
    """Execute the standard fault schedule and return the report dict.

    ``stacked=True`` runs the sweep in trial-stacking mode (the lane
    recovery drill: 2 groups, K lanes each); preemption is excluded there
    (a stacked sweep cannot resume, so the restart protocol does not
    apply; the unstacked run is the restart drill).

    ``plan`` drills a custom :class:`FaultPlan` verbatim instead of the
    standard schedule (its ``trial_id``s must be this sweep's
    ``0..trials-1``); the report's math is the same, but the 0.8 goodput
    bar is the standard schedule's.

    The chaos run (never the fault-free reference) executes under
    telemetry: events stream to ``telemetry_dir`` (default
    ``{work_dir}/telemetry``), and the report's ``telemetry`` block carries
    the exported trace, dump and summary paths, the check that every fired
    fault and scheduled retry appears as a tagged event in the trace, and
    what each CUDA-graph capture cost. The restart loop runs inside the
    telemetry scope, so one timeline spans every restart.
    """
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.hpo.driver import run_hpo
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy

    configs = standard_configs(trials, epochs, batch_size=batch_size, hidden_dim=hidden_dim,
                               latent_dim=latent_dim, fused_steps=fused_steps)
    train = synthetic_mnist(data_rows, seed=0)
    steps_per_epoch = data_rows // configs[0].batch_size

    # --- fault-free reference ---------------------------------------
    # Fresh sweep dirs: a stale ledger or checkpoint would contaminate the
    # restart protocol.
    ff_dir = os.path.join(work_dir, "fault_free")
    chaos_dir = os.path.join(work_dir, "chaos")
    for d in (ff_dir, chaos_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.time()
    ff_results = run_hpo(configs, train, None, **_sweep_kwargs(ff_dir, device), ledger=False, stack_trials=stacked)
    wall_ff = time.time() - t0
    ff_loss = {r.trial_id: r.final_train_loss for r in ff_results}
    del ff_results
    allocated_ff = _allocated(device)

    # --- chaos run --------------------------------------------------
    custom_plan = plan is not None
    if plan is None:
        plan = FaultPlan.standard(
            [c.trial_id for c in configs],
            seed=seed,
            steps_per_epoch=steps_per_epoch,
            include_preempt=include_preempt and not stacked,
        )
    injector = FaultInjector(plan)
    retry = RetryPolicy(max_retries=2, backoff_base_s=0.01)
    restarts = 0
    tel_dir = telemetry_dir or os.path.join(work_dir, "telemetry")

    t0 = time.time()
    with telemetry.telemetry_run(tel_dir):
        while True:
            try:
                results = run_hpo(
                    configs, train, None, **_sweep_kwargs(chaos_dir, device),
                    resilient=True,
                    retry=retry,
                    fault_plan=injector,
                    resume=restarts > 0,
                    ckpt_keep_last=2,
                    stack_trials=stacked,
                )
                break
            except HostPreemption:
                # The simulated host died mid-sweep. A deployment restarts
                # the driver process; here the restart reuses the injector
                # (fired faults stay fired) and the ledger and checkpoints
                # on disk do the rest.
                restarts += 1
                if restarts > MAX_RESTARTS:
                    raise RuntimeError(
                        f"chaos harness: >{MAX_RESTARTS} preemption restarts; the plan should bound "
                        "preemptions, so supervision is not converging"
                    )
        # The wall clock closes before the export: the fault-free run pays
        # no export cost either.
        wall_chaos = time.time() - t0
        telemetry_report = _export_telemetry(tel_dir, injector)
    allocated_chaos = _allocated(device)

    # --- accounting -------------------------------------------------
    by_id = {r.trial_id: r for r in results}
    diverge_targets = {s.trial_id for s in plan.specs if s.kind == DIVERGE}
    # Useful = work embodied in a settled outcome (completed weights or a
    # terminal divergence verdict). A terminally failed trial's steps are
    # executed but wasted.
    useful_steps = sum(r.steps for r in results if r.status in ("completed", "resumed_complete", "diverged"))
    executed_steps = _executed_steps(SweepLedger(chaos_dir), useful=results)
    goodput = useful_steps / executed_steps if executed_steps else 0.0

    recovered, parity = [], []
    for cfg in configs:
        r = by_id[cfg.trial_id]
        if cfg.trial_id in diverge_targets:
            recovered.append({"trial_id": cfg.trial_id, "expected": "diverged", "status": r.status,
                              "ok": r.status == "diverged"})
            continue
        recovered.append({"trial_id": cfg.trial_id, "expected": "completed", "status": r.status,
                          "ok": r.status in ("completed", "resumed_complete")})
        parity.append({"trial_id": cfg.trial_id, "attempts": r.attempt, "chaos_loss": r.final_train_loss,
                       "fault_free_loss": ff_loss[cfg.trial_id],
                       "bit_identical": r.final_train_loss == ff_loss[cfg.trial_id]})

    return {
        "protocol": ("chaos_custom_plan_v1" if custom_plan else "chaos_standard_v1") + ("_stacked" if stacked else ""),
        "custom_plan": custom_plan,
        "plan": {"seed": plan.seed, "specs": [asdict(s) for s in plan.specs]},
        "faults_fired": list(injector.fired),
        "restarts_after_preemption": restarts,
        "trials": trials,
        "epochs": epochs,
        "steps_per_epoch": steps_per_epoch,
        "useful_steps": useful_steps,
        "executed_steps": executed_steps,
        "goodput": round(goodput, 4),
        "wall_fault_free_s": round(wall_ff, 3),
        "wall_chaos_s": round(wall_chaos, 3),
        "wall_ratio": round(wall_ff / wall_chaos, 4) if wall_chaos else None,
        "recovered": recovered,
        "all_infra_faults_recovered": all(x["ok"] for x in recovered),
        "final_metrics_bit_identical": all(x["bit_identical"] for x in parity),
        "parity": parity,
        "statuses": {r.trial_id: r.status for r in results},
        "memory_allocated": {"after_fault_free": allocated_ff, "after_chaos": allocated_chaos},
        "telemetry": telemetry_report,
    }


def _export_telemetry(tel_dir: str, injector: FaultInjector) -> dict:
    """Export the chaos run's trace, dump and summary and check the event
    stream against the injector's ground truth: every fired fault must
    appear as a tagged ``fault_injected`` event, and the trace must carry
    the sweep's retries and lane refills. Called inside the telemetry
    scope (the registry is still live for the dump and the capture
    books)."""
    from multidisttorch_tpu_torch.telemetry import EVENTS_NAME, export, read_events
    from multidisttorch_tpu_torch.telemetry.metrics import capture_books

    events = read_events(os.path.join(tel_dir, EVENTS_NAME))
    paths = export.export_all(tel_dir, events)

    def count(kind: str, **match) -> int:
        n = 0
        for ev in events:
            if ev.get("kind") != kind:
                continue
            data = ev.get("data") or {}
            if all(data.get(k) == v or ev.get(k) == v for k, v in match.items()):
                n += 1
        return n

    fired_traced = all(
        count("fault_injected", fault_kind=rec["kind"], trial_id=rec["trial_id"]) > 0 for rec in injector.fired
    )
    with open(paths["trace"]) as f:
        trace = json.load(f)  # loads == Perfetto-parseable JSON
    # Monotonicity is checked on the raw stream (emission order): the
    # trace is sorted by construction.
    raw_ts = [float(e.get("ts", 0.0)) for e in events]
    return {
        "dir": tel_dir,
        **paths,
        "events_recorded": len(events),
        "faults_fired": len(injector.fired),
        "faults_traced": count("fault_injected"),
        "all_faults_traced": fired_traced,
        "retries_traced": count("retry_scheduled") + count("lane_fault", retrying=True),
        "lane_refills_traced": count("lane_refill"),
        "trace_monotonic": raw_ts == sorted(raw_ts) and bool(trace.get("traceEvents")),
        "captures": capture_books(),
    }


def run_chaos_mh_bench(work_dir: str, **kwargs) -> dict:
    """The elastic multi-host drill (the JAX package's kill-one-of-N
    world-shrink restart): not ported yet."""
    raise NotImplementedError(
        "run_chaos_mh_bench is not ported yet: ROADMAP A.11 (elastic multi-host: parallel/membership.py, "
        "the sweep supervisor and its worker)"
    )


def _executed_steps(ledger, useful) -> int:
    """Total optimizer steps executed across every attempt: each attempt's
    (end step - resume step), summed; settled final attempts from the
    results themselves, failed or interrupted attempts from their ledger
    progress records (a terminally failed result arrives through its
    ``failed`` record, not the result, so nothing counts twice)."""
    from multidisttorch_tpu_torch.hpo.ledger import wasted_steps

    total = sum(
        max(0, r.steps - r.resumed_from_step)
        for r in useful
        if r.status in ("completed", "resumed_complete", "diverged")
    )
    return total + sum(wasted_steps(ev) for ev in ledger.load())
