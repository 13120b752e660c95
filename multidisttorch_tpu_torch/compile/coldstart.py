"""The cold-start bench: cold, precompiled and cache-warm admission.

Counterpart of ``multidisttorch_tpu/compile/coldstart.py``, with its fixed
sweep: ``len(COLDSTART_HIDDENS)`` shape buckets (hidden widths), one trial
each, on one group, so that every admission is serialized and visible,
each trial ``COLDSTART_EPOCHS`` epochs of ``COLDSTART_ROWS`` rows at batch
``COLDSTART_BATCH``. Each mode runs the whole sweep in a fresh child
process, so nothing a mode built or captured can leak into another:

- **cold**: no farm, and an empty kernel build directory of its own
  (``MDT_KERNEL_BUILD_DIR``): the first admission builds the kernels from
  source, and every admission captures its program inline. The child seals
  the libraries it built (``compile/cache.py``) for the cache-warm child.
- **farm** (precompiled): ``run_hpo(precompile=True)`` with an empty build
  directory of its own: the farm's workers build the kernels and capture
  every program at entry; admissions wait cooperatively or take them.
- **warm** (cache-warm): the cold child's sealed libraries through the
  quarantine (sidecar scan, then a canary child per library) and the farm;
  no kernel is built.

A trial's **admission latency** is ``first_dispatch - attempt_start`` off
the child's events (set-up, kernel build, warm-up and capture). The gates
are the JAX package's: every trial's final train and test losses
bit-identical across the modes (float hex), and no admission captured on
the host loop with the farm on (``admission_blocked_on_compile``); the
speedups are recorded either way.

Run it: ``python -m multidisttorch_tpu_torch.compile.coldstart [--work
DIR]``, on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

COLDSTART_HIDDENS = (64, 96, 128, 160, 192, 224)
COLDSTART_ROWS = 2048
COLDSTART_BATCH = 64
COLDSTART_EPOCHS = 8
CHILD_TIMEOUT_S = int(os.environ.get("MDT_COLDSTART_CHILD_TIMEOUT_S", "600"))
MODES = ("cold", "farm", "warm")

_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def coldstart_configs(epochs: int = COLDSTART_EPOCHS):
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig

    return [TrialConfig(trial_id=i, epochs=epochs, batch_size=COLDSTART_BATCH, lr=1e-3, seed=7, hidden_dim=h,
                        latent_dim=16) for i, h in enumerate(COLDSTART_HIDDENS)]


def _child_main(mode: str, out_dir: str, tel_dir: str, build_dir: str, device: str, epochs: int) -> int:
    """One mode's sweep in this (child) process; prints the result line."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.compile import cache as _cache
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.hpo.driver import run_hpo
    from multidisttorch_tpu_torch.ops import _build

    telemetry.configure(tel_dir)
    cache_rec = None
    if mode == "warm":
        cache_rec = _cache.enable_quarantined_cache(build_dir)
    train = synthetic_mnist(COLDSTART_ROWS)
    test = synthetic_mnist(256)
    t0 = time.perf_counter()
    results = run_hpo(coldstart_configs(epochs), train, test, num_groups=1, device=device, out_dir=out_dir,
                      save_images=False, verbose=False, precompile=mode in ("farm", "warm"))
    wall = time.perf_counter() - t0
    sealed = _cache.seal_cache(build_dir) if mode == "cold" else None
    out = {
        "mode": mode,
        "wall_s": round(wall, 3),
        "sealed": sealed,
        "libraries": sorted(n for n in os.listdir(build_dir) if _cache.library_name(n)),
        "build_s": dict(_build.build_seconds),
        "cache": None if cache_rec is None else {
            "enabled": cache_rec["enabled"], "verdict": cache_rec["verdict"], "scan": cache_rec.get("scan"),
            "canary_passed": bool((cache_rec.get("canary") or {}).get("passed"))},
        "trials": [{"trial_id": r.trial_id, "status": r.status, "steps": r.steps,
                    "train_hex": float(r.final_train_loss).hex(), "test_hex": float(r.final_test_loss).hex()}
                   for r in results],
    }
    telemetry.disable()
    print("COLDSTART|" + json.dumps(out))
    return 0


def _run_child(mode: str, work_dir: str, build_dir: str, device: str, epochs: int, timeout_s: int) -> dict:
    tel_dir = os.path.join(work_dir, f"tel_{mode}")
    out_dir = os.path.join(work_dir, f"out_{mode}")
    os.makedirs(tel_dir, exist_ok=True)
    os.makedirs(build_dir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_PACKAGE_ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["MDT_KERNEL_BUILD_DIR"] = build_dir
    for name in ("MDT_PRECOMPILE", "MDT_TELEMETRY", "MDT_AOT_ADMISSION"):
        env.pop(name, None)
    if mode != "cold":
        # A fixed farm width, so that runs on different hosts compare.
        env.setdefault("MDT_PRECOMPILE_WORKERS", "2")
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, "-m", "multidisttorch_tpu_torch.compile.coldstart", "--child", mode,
                            "--out", out_dir, "--tel", tel_dir, "--build", build_dir, "--device", device,
                            "--epochs", str(epochs)],
                           capture_output=True, text=True, timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return {"mode": mode, "ok": False, "error": f"child timed out after {timeout_s}s", "tel_dir": tel_dir}
    rec = None
    for line in p.stdout.splitlines():
        if line.startswith("COLDSTART|"):
            rec = json.loads(line[len("COLDSTART|"):])
    if p.returncode != 0 or rec is None:
        return {"mode": mode, "ok": False, "error": f"child rc={p.returncode}", "stderr_tail": p.stderr[-1500:],
                "tel_dir": tel_dir}
    rec.update(ok=True, child_wall_s=round(time.perf_counter() - t0, 3), tel_dir=tel_dir)
    return rec


def _fold_admissions(tel_dir: str) -> dict:
    """Admission latencies and the compile books off a child's events (the
    run summary's fold, afterwards)."""
    from multidisttorch_tpu_torch.telemetry.events import EVENTS_NAME, read_events
    from multidisttorch_tpu_torch.telemetry.export import SweepFold

    fold = SweepFold()
    for ev in read_events(os.path.join(tel_dir, EVENTS_NAME)):
        fold.feed(ev)
    lat = [a["admission_s"] for a in fold.admissions if a.get("admission_s") is not None]
    return {
        "admissions": fold.admissions,
        "latencies_s": lat,
        "mean_admission_s": sum(lat) / len(lat) if lat else None,
        "max_admission_s": max(lat) if lat else None,
        "compile_books": fold.compile_books,
        "compiles": fold.compiles,
        "compile_s_total": fold.compile_s_total,
        "cache_hits": fold.cache_hits,
        "precompile": fold.precompile,
    }


def run_coldstart_bench(work_dir: str, *, device: str = "cuda", epochs: int = COLDSTART_EPOCHS,
                        timeout_s: int = CHILD_TIMEOUT_S, overlap: bool = False) -> dict:
    """The cold, farm and warm children, folded into one record (module
    docstring for the gates). ``epochs`` below the fixed sweep's is a cut
    for a quick run, and ``overlap`` (the cold and farm children started
    together, each on its own build directory; the warm child after them,
    on the cold child's sealed libraries) a cut of wall time whose
    admission latencies then include the other child's load; the record
    says both."""
    os.makedirs(work_dir, exist_ok=True)
    cold_dir = os.path.join(work_dir, "kernels_cold")
    dirs = {"cold": cold_dir, "farm": os.path.join(work_dir, "kernels_farm"), "warm": cold_dir}
    out: dict = {"protocol": "coldstart_v1", "device": device, "buckets": len(COLDSTART_HIDDENS),
                 "hidden_dims": list(COLDSTART_HIDDENS), "epochs": epochs, "batch_size": COLDSTART_BATCH,
                 "rows": COLDSTART_ROWS, "overlap": overlap, "modes": {}}

    def run(mode: str) -> dict:
        rec = _run_child(mode, work_dir, dirs[mode], device, epochs, timeout_s)
        if rec.get("ok"):
            rec["books"] = _fold_admissions(rec["tel_dir"])
        return rec

    if overlap:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            for mode, rec in zip(("cold", "farm"), list(pool.map(run, ("cold", "farm")))):
                out["modes"][mode] = rec
    for mode in MODES:
        if mode not in out["modes"]:
            out["modes"][mode] = run(mode)

    def trials_hex(rec) -> Optional[dict]:
        if not rec.get("ok"):
            return None
        return {t["trial_id"]: (t["train_hex"], t["test_hex"], t["status"]) for t in rec["trials"]}

    cold, farm, warm = (out["modes"][m] for m in MODES)
    ref = trials_hex(cold)
    mismatches = [m for m in ("farm", "warm") if ref is None or trials_hex(out["modes"][m]) != ref]
    out["parity"] = ref is not None and not mismatches
    out["parity_mismatches"] = mismatches

    def mean_of(rec) -> Optional[float]:
        return (rec.get("books") or {}).get("mean_admission_s")

    cold_mean, farm_mean, warm_mean = mean_of(cold), mean_of(farm), mean_of(warm)
    out["cold_mean_admission_s"] = cold_mean
    out["precompiled_mean_admission_s"] = farm_mean
    out["cache_warm_mean_admission_s"] = warm_mean
    out["speedup_cold_over_precompiled"] = cold_mean / farm_mean if cold_mean and farm_mean else None
    out["speedup_cold_over_cache_warm"] = cold_mean / warm_mean if cold_mean and warm_mean else None

    def blocked(rec) -> Optional[bool]:
        # Captured on the host loop: an inline capture, or per-trial graphs.
        if not rec.get("ok"):
            return None
        return any(a.get("outcome") not in ("hit", "wait") for a in rec["books"]["admissions"])

    out["admission_blocked_on_compile"] = blocked(farm)
    out["admission_blocked_on_compile_warm"] = blocked(warm)
    out["cache_verdict"] = (warm.get("cache") or {}).get("verdict") if warm.get("ok") else None
    out["passed"] = bool(out["parity"] and out["admission_blocked_on_compile"] is False
                         and out["admission_blocked_on_compile_warm"] is False)
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="the cold-start bench (cold, precompiled, cache-warm children)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--work", default=None, help="working directory (default: a new temporary one)")
    parser.add_argument("--epochs", type=int, default=COLDSTART_EPOCHS)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tel", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--build", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        return _child_main(args.child, args.out, args.tel, args.build, args.device, args.epochs)
    work = args.work or tempfile.mkdtemp(prefix="coldstart_")
    rec = run_coldstart_bench(work, device=args.device, epochs=args.epochs)
    print(json.dumps(rec, indent=1, default=str))
    return 0 if rec["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
