"""Chaos drill CLI: run the standard fault schedule against ``run_hpo``'s
supervision and report recovery, goodput and the traced faults.

The port's counterpart of ``tools/chaos_run.py`` (its single-host flags,
plus ``--device`` and the sweep's widths). Every infra fault of
``FaultPlan.standard`` must be recovered automatically (retry with
resume, lane refill, ledger restart after the simulated preemption), the
injected divergence must settle as a terminal ``diverged`` result, the
recovered trials must end bit-identical to the fault-free run, and
goodput (useful over executed optimizer steps) must reach 0.8. Exits 0
when all of that holds, 1 otherwise.

On the card (the default), at the reference's widths:
    python -m multidisttorch_tpu_torch.examples.chaos_run --batch-size 128 --hidden-dim 400 \\
        --latent-dim 20 --fused-steps 4 --data-rows 1024
On the CPU at the JAX drill's size:
    python -m multidisttorch_tpu_torch.examples.chaos_run --device cpu [--stacked]
A custom plan: ``--plan my_plan.json`` (the ``FaultPlan.to_json`` format).
"""

import argparse
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="deterministic fault-injection drill for run_hpo supervision")
    parser.add_argument("--out", default=None, help="write the full JSON report here (default: stdout only)")
    parser.add_argument("--work-dir", default=None, help="sweep scratch dir (default: a fresh temp dir)")
    parser.add_argument("--trials", type=int, default=6)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--stacked", action="store_true",
                        help="drill the trial-stacking path instead (lane fault -> mask-and-refill recovery; "
                             "preemption excluded: stacked sweeps do not resume)")
    parser.add_argument("--no-preempt", action="store_true",
                        help="skip the simulated host preemption and driver restart")
    parser.add_argument("--plan", default=None,
                        help="drill a custom FaultPlan JSON file (trial_ids 0..trials-1) instead of the standard "
                             "schedule; the goodput >= 0.8 bar applies to the standard schedule only")
    parser.add_argument("--telemetry-dir", default=None,
                        help="write the chaos run's telemetry here instead of {work_dir}/telemetry")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--data-rows", type=int, default=128, help="synthetic MNIST rows")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--hidden-dim", type=int, default=32)
    parser.add_argument("--latent-dim", type=int, default=8)
    parser.add_argument("--fused-steps", type=int, default=1,
                        help="train steps per dispatch (one CUDA-graph replay on a card)")
    args = parser.parse_args(argv)

    from multidisttorch_tpu_torch.faults.harness import run_chaos_bench
    from multidisttorch_tpu_torch.faults.plan import FaultPlan

    plan = None
    if args.plan is not None:
        with open(args.plan) as f:
            plan = FaultPlan.from_json(f.read())
        bad_ids = {s.trial_id for s in plan.specs} - set(range(args.trials))
        if bad_ids:
            parser.error(f"--plan targets trial ids {sorted(bad_ids)} outside this sweep's 0..{args.trials - 1}")

    report = run_chaos_bench(
        args.work_dir or tempfile.mkdtemp(prefix="chaos_run_"),
        trials=args.trials,
        epochs=args.epochs,
        seed=args.seed,
        include_preempt=not args.no_preempt,
        data_rows=args.data_rows,
        stacked=args.stacked,
        plan=plan,
        telemetry_dir=args.telemetry_dir,
        device=args.device,
        batch_size=args.batch_size,
        hidden_dim=args.hidden_dim,
        latent_dim=args.latent_dim,
        fused_steps=args.fused_steps,
    )
    tel = report["telemetry"]
    ok = (
        report["all_infra_faults_recovered"]
        and report["final_metrics_bit_identical"]
        and (plan is not None or report["goodput"] >= 0.8)
        and tel["all_faults_traced"]
        and tel["trace_monotonic"]
    )
    headline = {
        "metric": "chaos_goodput_useful_over_executed_steps",
        "value": report["goodput"],
        "unit": "fraction",
        "vs_baseline": round(report["goodput"] / 0.8, 3),
        "all_infra_faults_recovered": report["all_infra_faults_recovered"],
        "final_metrics_bit_identical": report["final_metrics_bit_identical"],
        "restarts_after_preemption": report["restarts_after_preemption"],
        "telemetry_trace": tel["trace"],
        "all_faults_traced": tel["all_faults_traced"],
        "detail": report,
    }
    print(json.dumps(headline))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(headline, f, indent=2)
        os.replace(tmp, args.out)
        print(f"report written to {args.out}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
