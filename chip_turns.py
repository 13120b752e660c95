"""Where a fabric replica's turn goes on the card.

    python3 chip_turns.py [ARMS] [--dispatches] [--out DIR]

Runs chip_smoke's 23a (the failover drill) and 23d (the split chaos drill)
together, as chip_smoke phase 23 does, once for each arm of ``ARMS`` (comma
separated; default ``off,on,off+hogs,on+hogs``):

- ``off``: the replica children with ``--turn-budget 0`` (every shard ticks
  in every turn);
- ``on``: the CLI's default turn budget (a quarter of the lease deadline);
- ``+hogs``: the same beside six processes that burn a CPU core each.

Each drill prints chip_smoke's lines and gates, among them each replica's
longest turn and its seconds by part. With ``--dispatches`` the children
run through this file's ``--child`` wrapper, which prints every placement,
every dispatch over 0.25 s, every graph capture and every garbage
collection over 0.05 s of a child; those lines are copied into ``DIR``
(default ``chip_turns_out``), one file per arm, drill and child. Needs a
card; a failed gate is printed and the next drill goes on.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARMS = {"off": (0.0, 0), "on": (None, 0), "off+hogs": (0.0, 6), "on+hogs": (None, 6)}


def _child(argv: list[str]) -> int:
    """A sweep-service child whose slow dispatches, captures and
    collections are printed to its log."""
    sys.path.insert(0, HERE)
    from multidisttorch_tpu_torch.examples import sweep_service
    from multidisttorch_tpu_torch.service import runtime
    from multidisttorch_tpu_torch.train import steps

    collect = gc.collect

    def timed_collect(*a, **k):
        t = time.perf_counter()
        r = collect(*a, **k)
        if time.perf_counter() - t > 0.05:
            print(f"DIAG gc.collect {time.perf_counter() - t:.3f}", flush=True)
        return r

    gc.collect = timed_collect

    def timed(gen, label):
        i = 0
        while True:
            t = time.perf_counter()
            try:
                next(gen)
            except StopIteration:
                if time.perf_counter() - t > 0.25:
                    print(f"DIAG dispatch {label} #{i} (last) {time.perf_counter() - t:.3f}", flush=True)
                return
            if time.perf_counter() - t > 0.25:
                print(f"DIAG dispatch {label} #{i} {time.perf_counter() - t:.3f}", flush=True)
            i += 1
            yield

    start = runtime.SweepService._start_placement

    def start_placement(self, p):
        t = time.perf_counter()
        start(self, p)
        dt = time.perf_counter() - t
        seen = self.__dict__.setdefault("_timed_pids", set())
        for pid, ap in self.active.items():
            if pid not in seen:
                seen.add(pid)
                label = (f"{os.path.basename(self.service_dir)} trials {sorted(ap.entries)} resume "
                         f"{[e.resume_scan for e in ap.entries.values()]}")
                ap.gen = timed(ap.gen, label)
                print(f"DIAG place {label} {dt:.3f}", flush=True)

    runtime.SweepService._start_placement = start_placement
    capture = steps._GraphedChunks._timed_capture

    def timed_capture(self, warm_s, fn, inputs, *a):
        t = time.perf_counter()
        r = capture(self, warm_s, fn, inputs, *a)
        print(f"DIAG capture K={inputs[0].shape[0]} warm {warm_s:.3f} capture {time.perf_counter() - t:.3f}",
              flush=True)
        return r

    steps._GraphedChunks._timed_capture = timed_capture
    return sweep_service.main(argv)


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    dispatches = "--dispatches" in sys.argv
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv else os.path.join(HERE, "chip_turns_out")
    if "--out" in sys.argv:
        args.remove(out)
    arms = args[0].split(",") if args else list(ARMS)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: no card to drive")
    from multidisttorch_tpu_torch.ops import _build
    from multidisttorch_tpu_torch.ops import elbo as E
    from multidisttorch_tpu_torch.service import fabric_drill

    if dispatches:
        class _Popen(subprocess.Popen):
            """The drills' children through this file's ``--child`` wrapper."""

            def __init__(self, argv, *a, **k):
                if "multidisttorch_tpu_torch.examples.sweep_service" in argv:
                    i = argv.index("-m")
                    argv = [*argv[:i], os.path.abspath(__file__), "--child", *argv[i + 2:]]
                super().__init__(argv, *a, **k)

        class _Subprocess:
            Popen = _Popen
            STDOUT = subprocess.STDOUT
            TimeoutExpired = subprocess.TimeoutExpired

        fabric_drill.subprocess = _Subprocess
    os.makedirs(out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.time()
    _build.build_all()
    print(f"built in {time.time() - t:.1f} s", flush=True)
    for name in arms:
        budget, n_hogs = ARMS[name]
        hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(n_hogs)]
        t0 = time.time()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                drills = {
                    "23a": cs._in_thread("23a", fabric_drill.run_failover_phase, os.path.join(tmp, "23a"),
                                         device="cuda", timeout_s=300.0, turn_budget_s=budget),
                    "23d": cs._in_thread("23d", fabric_drill.run_split_chaos, os.path.join(tmp, "23d"),
                                         device="cuda", timeout_s=300.0, turn_budget_s=budget),
                }
                for what, gates in (("23a", cs.fabric_failover), ("23d", cs.fabric_split)):
                    thread, box = drills[what]
                    try:
                        gates(E, smi, thread, box)
                    except SystemExit:
                        print(f"arm {name} {what}: a gate failed", flush=True)
                    for i, log in enumerate((box.get("report") or {}).get("logs", [])):
                        with open(log) as f, open(os.path.join(out, f"{name}_{what}_{i}.log"), "w") as g:
                            g.writelines(ln for ln in f if ln.startswith("DIAG") or "Traceback" in ln)
        finally:
            for p in hogs:
                p.kill()
                p.wait()
        print(f"arm {name}: {time.time() - t0:.1f} s ({smi})", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(_child(sys.argv[2:]))
    main()
