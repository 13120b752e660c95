"""The port's operator consoles (``multidisttorch_tpu_torch/tools/``)
against the JAX package's ``tools/`` scripts.

Each console test of the JAX package (``test_telemetry.py``'s five,
``test_service.py``'s ``TestTools`` two, ``test_trace.py``'s CLI test,
``test_ckpt_v2.py``'s two, ``test_dataplane.py``'s, ``test_elastic.py``'s,
``test_fleet.py``'s three and ``test_pbt_fused.py``'s population view) has
a counterpart here with the same assertions, over files the port writes
(its sweeps, ledger, queue, checkpoints and telemetry) or the JAX test's
own fixture files. On each input the JAX tool, loaded by path as the JAX
tests load it, and the port's console print the same text and ``--json``
and exit alike: exact equality, with the clock held still (the consoles'
age columns read it). Where a console writes (``--compact``, a GC pass,
a torn tail), each runs on a copy of its own and the outputs are compared
with the copies' paths aside. ``test_incidents.py``'s two console tests
are ``tests/test_torch_incidents.py``'s.

The fabric view (ROADMAP A.12b) raises ``NotImplementedError``; every
console runs as ``python -m multidisttorch_tpu_torch.tools.<name>``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from multidisttorch_tpu import telemetry as jax_tel
from multidisttorch_tpu.telemetry.export import SweepFold as JaxSweepFold
from multidisttorch_tpu_torch import telemetry
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
from multidisttorch_tpu_torch.service import queue as squeue
from multidisttorch_tpu_torch.service.queue import SubmissionQueue, SweepClient
from multidisttorch_tpu_torch.telemetry.export import SweepFold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 2_000_000_000.0
TOOLS = ("sweep_top", "ledger_view", "sweep_trace", "ckpt_gc", "incident")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _telemetry_off_after():
    yield
    telemetry.disable()
    jax_tel.disable()


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_tool(name):
    return importlib.import_module(f"multidisttorch_tpu_torch.tools.{name}")


def _run(mod, argv, capsys, monkeypatch):
    """``mod.main(argv)`` with the clock held at ``NOW``: (rc, stdout)."""
    capsys.readouterr()
    with monkeypatch.context() as m:
        m.setattr(time, "time", lambda: NOW)
        rc = mod.main(list(argv))
    return rc, capsys.readouterr().out


def _both(name, argv, capsys, monkeypatch):
    """The JAX tool and the port's console on the same arguments: equal
    exit codes and output; the port's are returned."""
    port = _run(_port_tool(name), argv, capsys, monkeypatch)
    assert port == _run(_load_tool(name), argv, capsys, monkeypatch)
    return port


def _both_on_copies(name, src, argv_of, capsys, monkeypatch, tmp_path):
    """Each tool on a copy of ``src`` of its own (the tool writes):
    equal exit codes and output with the copy's path aside; the port's
    (rc, out, copy) are returned."""
    got = {}
    for side, mod in (("port", _port_tool(name)), ("jax", _load_tool(name))):
        c = str(tmp_path / f"{side}-copy")
        shutil.copytree(src, c)
        rc, out = _run(mod, argv_of(c), capsys, monkeypatch)
        got[side] = (rc, out.replace(c, "<copy>"), c)
    assert got["port"][:2] == got["jax"][:2]
    return got["port"]


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """A port sweep's telemetry directory: two trials, a crash on trial 0
    retried once (the JAX tests' ``_demo_events``)."""
    from multidisttorch_tpu_torch.faults import CRASH, FaultPlan, FaultSpec
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.telemetry import export

    tmp = tmp_path_factory.mktemp("demo")
    tdir = str(tmp / "tele")
    cfgs = [TrialConfig(trial_id=i, epochs=1, batch_size=16, hidden_dim=16, latent_dim=4, seed=i,
                        log_interval=10_000) for i in range(2)]
    with telemetry.telemetry_run(tdir):
        run_hpo(cfgs, synthetic_mnist(64, seed=0), None, groups=setup_groups(2, devices=["cpu"] * 2), out_dir=str(tmp / "out"),
                save_images=False, verbose=False, resilient=True,
                retry=RetryPolicy(max_retries=1, backoff_base_s=0.01),
                fault_plan=FaultPlan(specs=(FaultSpec(CRASH, 0, step=1),)))
        export.export_all(tdir, registry=telemetry.get_registry())
    return tdir


# -- test_telemetry.py's console tools -------------------------------------


def test_sweep_top_renders_live_and_finished(demo, capsys, monkeypatch, tmp_path):
    rc, out = _both("sweep_top", [demo], capsys, monkeypatch)
    assert rc == 0
    assert "goodput" in out
    assert "sweep finished" in out
    assert re.search(r"^0\s+ok", out, re.M)  # trial 0 row, completed
    assert re.search(r"^0\s+ok\s+2", out, re.M)  # ...on attempt 2
    # Live tail: truncate the file mid-line; the renderer holds the torn
    # tail for the next poll instead of crashing.
    ev_path = str(tmp_path / "events.jsonl")
    with open(os.path.join(demo, "events.jsonl")) as f:
        blob = f.read()
    with open(ev_path, "w") as f:
        f.write(blob[: len(blob) // 2])
    rc, out = _both("sweep_top", [ev_path], capsys, monkeypatch)
    assert rc == 0 and "goodput" in out


def _two_config_ledger(out_dir: str, *, in_flight: bool = True) -> None:
    led = SweepLedger(out_dir)
    led.attempt_start(0, "aaaa", 1)
    led.attempt_end(0, "aaaa", 1, "completed", summary={"steps": 8})
    led.attempt_start(1, "bbbb", 1)
    if in_flight:
        led.attempt_end(1, "bbbb", 1, "retrying", error="boom")
        led.attempt_start(1, "bbbb", 2)  # in flight: no end record


def test_ledger_view_settled_vs_in_flight(tmp_path, capsys, monkeypatch):
    out_dir = str(tmp_path / "sweep")
    _two_config_ledger(out_dir)
    rc, out = _both("ledger_view", [out_dir], capsys, monkeypatch)
    assert rc == 0
    assert "SETTLED" in out and "IN-FLIGHT" in out
    assert "#1:ok" in out
    assert "#1:retry -> #2:run" in out


def test_sweep_top_missing_file_errors(tmp_path, capsys, monkeypatch):
    assert _both("sweep_top", [str(tmp_path / "nope")], capsys, monkeypatch)[0] == 1


def test_sweep_top_json_snapshot(demo, capsys, monkeypatch):
    rc, out = _both("sweep_top", [demo, "--json"], capsys, monkeypatch)
    assert rc == 0
    snap = json.loads(out)
    assert snap["done"] is True
    assert snap["goodput"] is not None
    t0 = snap["trials"]["0"]
    assert t0["attempts"] == 2 and t0["status"] == "completed"
    # Device books folded off the event stream: cost record + memory
    # watermark per series key.
    assert snap["device_books"]
    book = next(iter(snap["device_books"].values()))
    assert book.get("flops_per_lane_step") or book.get("peak_bytes")


def test_ledger_view_json_snapshot(tmp_path, capsys, monkeypatch):
    out_dir = str(tmp_path / "sweep")
    _two_config_ledger(out_dir, in_flight=False)
    rc, out = _both("ledger_view", [out_dir, "--json"], capsys, monkeypatch)
    assert rc == 0
    snap = json.loads(out)
    assert snap["configs"] == 2
    assert snap["settled"] == 1 and snap["in_flight"] == 1
    assert snap["by_config"]["aaaa"]["attempts"][0]["status"] == "completed"


# -- test_service.py::TestTools ---------------------------------------------


def _seed_queue(d):
    c = SweepClient(str(d), tenant="alice")
    sid = c.submit({"epochs": 1, "hidden_dim": 16})
    q = SubmissionQueue(str(d))
    q.drain_intake(known_ids=set())
    q.admitted(sid, trial_id=0, chash="h", bucket="(32, 16)")
    return sid


def test_ledger_view_queue_render_and_json(tmp_path, capsys, monkeypatch):
    sid = _seed_queue(tmp_path)
    rc, out = _both("ledger_view", [str(tmp_path), "--queue"], capsys, monkeypatch)
    assert rc == 0
    assert sid[:24] in out and "alice" in out and "admitted" in out
    rc, out = _both("ledger_view", [str(tmp_path), "--queue", "--json"], capsys, monkeypatch)
    assert rc == 0
    assert json.loads(out)["by_submission"][sid]["state"] == "admitted"


def test_sweep_top_service_panel(tmp_path, capsys, monkeypatch):
    sid = _seed_queue(tmp_path)
    with open(tmp_path / "service_books.json", "w") as f:
        json.dump({
            "tenants": {"alice": {"useful_steps": 4, "goodput": 1.0}},
            "fair_share": {"alice": {"weight": 2.0, "contended_share": 0.5, "ratio_to_weight": 1.0}},
            "queue_wait": {"count": 1, "p50_s": 0.5, "p99_s": 1.0, "max_s": 0.7},
            "placement_latency": {"count": 1, "p50_s": 1.0, "p99_s": 2.0, "max_s": 1.5},
            "fragmentation": {"now": 0.25, "max": 0.5, "free_slices": 2, "largest_free_run": 1},
            "defrag": {"events": 1, "moved_slices": 1, "unblocked": ["x"]},
        }, f)
    rc, out = _both("sweep_top", [str(tmp_path), "--service"], capsys, monkeypatch)
    assert rc == 0
    assert "alice" in out and "queue-wait" in out
    assert "defrag" in out and "fragmentation" in out
    rc, out = _both("sweep_top", [str(tmp_path), "--service", "--json"], capsys, monkeypatch)
    assert rc == 0
    payload = json.loads(out)
    assert payload["queue"][sid]["tenant"] == "alice"
    assert payload["books"]["defrag"]["events"] == 1


def test_sweep_top_service_over_a_fabric_root_is_not_ported(tmp_path):
    """A fabric root (the JAX fabric's ``fabric/fabric.json``) and the
    fabric panel raise, naming A.12b."""
    sweep_top = _port_tool("sweep_top")
    os.makedirs(tmp_path / "fabric")
    with open(tmp_path / "fabric" / "fabric.json", "w") as f:
        json.dump({"n_shards": 2}, f)
    with pytest.raises(NotImplementedError, match="A.12b"):
        sweep_top.main([str(tmp_path), "--service", "--json"])
    with pytest.raises(NotImplementedError, match="A.12b"):
        sweep_top.fabric_panel(str(tmp_path))


# -- test_trace.py's CLI test -----------------------------------------------


def _journal(d, records):
    with open(os.path.join(d, squeue.QUEUE_NAME), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _sub_rec(sid, ts, *, tenant="t", trace_id="", **cfg):
    return {"event": "submitted", "ts": ts, "sub": {"submission_id": sid, "tenant": tenant, "config": cfg,
                                                     "submit_ts": ts - 0.05,
                                                     **({"trace_id": trace_id} if trace_id else {})}}


def _qev(kind, sid, ts, **extra):
    return {"event": kind, "submission_id": sid, "ts": ts, **extra}


def test_sweep_trace_cli(tmp_path, capsys, monkeypatch):
    d = str(tmp_path)
    _journal(d, [
        _sub_rec("s-1", 100.0, trace_id="abc"),
        _qev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
        _qev("placed", "s-1", 101.0, trial_id=0, start=0, size=1, lanes=1, stacked=False, resumed=False),
        _qev("settled", "s-1", 102.0, trial_id=0, status="completed"),
    ])
    rc, out = _both("sweep_trace", [d], capsys, monkeypatch)
    assert rc == 0
    assert "s-1" in out and "abc" in out
    rc, out = _both("sweep_trace", [d, "s-1"], capsys, monkeypatch)
    assert rc == 0
    assert "queue_wait" in out and "placement #1" in out
    # Lookup by trace id works too; json shape parses.
    rc, out = _both("sweep_trace", [d, "abc", "--json"], capsys, monkeypatch)
    assert rc == 0
    bd = json.loads(out)
    assert bd["submission_id"] == "s-1"
    assert bd["phase_totals_s"]["queue_wait"] == pytest.approx(0.8)


# -- test_ckpt_v2.py's two --------------------------------------------------


def test_ckpt_gc_cli(tmp_path, capsys, monkeypatch):
    import numpy as np

    from multidisttorch_tpu_torch.train import checkpoint as ck
    from multidisttorch_tpu_torch.train import ckpt_store as cs

    d = tmp_path / "run" / "trial-0"
    d.mkdir(parents=True)
    path = str(d / "state.msgpack")
    tree = {"params": {"w": np.arange(4096, dtype=np.float32).reshape(64, 64)}, "step": np.int32(8)}
    ck.save_state(tree, path, metadata={"step": 8, "completed_epochs": 1}, format="v2", chunk_bytes=4096)
    store = cs.ChunkStore(cs.chunk_dir_for(path))
    orphan, _ = store.put(os.urandom(1000))
    run = str(tmp_path / "run")
    # Dry run: reports, removes nothing.
    rc, out = _both("ckpt_gc", [run, "--dry-run", "--json"], capsys, monkeypatch)
    assert rc == 0
    out = json.loads(out)
    assert out["totals"]["dirs"] == 1
    assert out["reports"][0]["orphans_found"] == 1
    assert os.path.exists(store.chunk_path(orphan))
    rc, text = _both("ckpt_gc", [run, "--dry-run"], capsys, monkeypatch)
    assert rc == 0 and "[dry run]" in text
    # Real sweep, each tool on a copy of its own.
    rc, out, copy = _both_on_copies("ckpt_gc", run, lambda c: [c, "--grace", "0", "--json"], capsys, monkeypatch,
                                    tmp_path)
    assert rc == 0
    out = json.loads(out)
    assert out["totals"]["orphans_removed"] == 1
    cpath = os.path.join(copy, "trial-0", "state.msgpack")
    assert not os.path.exists(cs.ChunkStore(cs.chunk_dir_for(cpath)).chunk_path(orphan))
    ok, _, reason = ck.verify_checkpoint(cpath)
    assert ok, reason


def test_sweep_top_renders_ckpt_books(monkeypatch):
    books = {
        "checkpoint": {
            "format": "v2", "snapshot_drain": True, "pending_persists": 1, "saves": 12,
            "bytes_total": 10_000_000, "bytes_written": 2_500_000, "bytes_reused": 7_500_000,
            "delta_ratio": 0.25, "restores": 3, "restores_ram": 2,
            "drain_snapshot": {"count": 2, "p50_s": 0.001, "p99_s": 0.002, "max_s": 0.002},
            "drain_persist": {"count": 2, "p50_s": 0.3, "p99_s": 0.5, "max_s": 0.5},
        },
    }
    with monkeypatch.context() as m:
        m.setattr(time, "time", lambda: NOW)
        out = _port_tool("sweep_top").render_service({}, books, SimpleNamespace(trials={}), "/svc")
        assert out == _load_tool("sweep_top").render_service({}, books, SimpleNamespace(trials={}), "/svc")
    assert "ckpt" in out and "fmt v2" in out
    assert "delta 0.25" in out
    assert "ram-restores 2" in out
    assert "drain-snapshot" in out and "drain-persist" in out


# -- test_dataplane.py's ----------------------------------------------------


def test_sweep_top_snapshot_carries_input():
    ev = {"kind": "input_wait", "ts": 1.0, "group_id": 2, "data": {"wait_s": 1.0, "bytes": 10, "wall_s": 4.0}}
    st, jst = _port_tool("sweep_top"), _load_tool("sweep_top")
    fold, jfold = SweepFold(), JaxSweepFold()
    fold.feed(dict(ev))
    jfold.feed(dict(ev))
    snap = st.snapshot(fold, "x")
    assert snap == jst.snapshot(jfold, "x")
    assert snap["input"]["bucket-g2"]["input_bound_frac"] == 0.25
    assert st.render(fold, "x") == jst.render(jfold, "x")
    assert "bucket-g2" in st.render(fold, "x")


# -- test_elastic.py's ------------------------------------------------------


def test_ledger_view_compact_cli(tmp_path, capsys, monkeypatch):
    """A restart storm's ledger (per config hash, seven attempts of
    preempted/retrying churn, the first hash settling at the end),
    compacted by each console on a copy of its own: the same report and
    the same compacted ledger."""
    src = str(tmp_path / "storm")
    led = SweepLedger(src)
    for h_i in range(3):
        h = f"hash-{h_i:02d}"
        for a in range(1, 8):
            led.attempt_start(h_i, h, a)
            led.attempt_end(h_i, h, a, "retrying" if a % 2 else "preempted", error="storm",
                            summary={"steps_at_failure": 4 * a, "resumed_from_step": 0})
        if h_i == 0:
            led.attempt_start(h_i, h, 8)
            led.attempt_end(h_i, h, 8, "completed", summary={"steps": 40, "resumed_from_step": 0})
    rc, out, copy = _both_on_copies("ledger_view", src, lambda c: ["--compact", c], capsys, monkeypatch, tmp_path)
    assert rc == 0
    ledgers = []
    for side in ("port", "jax"):
        with open(tmp_path / f"{side}-copy" / "sweep_ledger.jsonl") as f:
            ledgers.append([{k: v for k, v in json.loads(ln).items() if k != "ts"} for ln in f])
    assert ledgers[0] == ledgers[1]
    assert len(ledgers[0]) < 3 * 14 + 2
    rc, out = _both("ledger_view", ["--json", copy], capsys, monkeypatch)
    assert rc == 0 and json.loads(out)["settled"] == 1


# -- test_fleet.py's three --------------------------------------------------


def test_sweep_top_fleet_render(tmp_path, capsys, monkeypatch):
    from test_torch_fleet import _fleet_run_dir

    run_dir = _fleet_run_dir(tmp_path)
    rc, out = _both("sweep_top", [run_dir, "--fleet"], capsys, monkeypatch)
    assert rc == 0
    assert "hosts" in out and "worlds" in out
    assert "restart tax" in out
    assert "trial 5: w0@h1 -> w1@h0" in out
    # world history rows with the shrink reason
    assert "host_lost" in out


def test_sweep_top_fleet_json_snapshot(tmp_path, capsys, monkeypatch):
    from test_torch_fleet import _fleet_run_dir

    run_dir = _fleet_run_dir(tmp_path)
    rc, out = _both("sweep_top", [run_dir, "--fleet", "--json"], capsys, monkeypatch)
    assert rc == 0
    snap = json.loads(out)
    assert snap["all_hosts_traced"] is True
    assert snap["restart_tax"][0]["trigger"] == "host_lost"
    assert "5" in snap["lineage"]
    assert "trials" in snap and snap["trials"]


def test_sweep_top_fleet_rejects_non_directory(tmp_path, capsys, monkeypatch):
    assert _both("sweep_top", [str(tmp_path / "nope"), "--fleet"], capsys, monkeypatch)[0] == 1


# -- test_pbt_fused.py's population view ------------------------------------


def test_sweep_top_population_view(tmp_path, capsys, monkeypatch):
    from multidisttorch_tpu_torch.hpo.pbt import PBTConfig, run_pbt

    cfg = PBTConfig(population=4, generations=2, steps_per_generation=4, batch_size=16, hidden_dim=16, latent_dim=4,
                    exploit_fraction=0.5, lr_min=1e-4, lr_max=1e-1, seed=0)
    with telemetry.telemetry_run(str(tmp_path)):
        run_pbt(cfg, synthetic_mnist(128, seed=0), synthetic_mnist(16, seed=1), fused=True, device="cpu",
                verbose=False)
    rc, out = _both("sweep_top", [str(tmp_path)], capsys, monkeypatch)
    assert rc == 0
    assert "population" in out
    assert "mode fused" in out
    assert "lr min/med/max" in out
    # one-shot machine-readable snapshot carries the same fold
    rc, out = _both("sweep_top", [str(tmp_path), "--json"], capsys, monkeypatch)
    assert rc == 0
    snap = json.loads(out)
    assert snap["pbt"]["mode"] == "fused"
    assert len(snap["pbt"]["generations"]) == cfg.generations


# -- the consoles as modules ------------------------------------------------


def _help(mod, capsys) -> str:
    capsys.readouterr()
    with pytest.raises(SystemExit) as exit_:
        mod.main(["--help"])
    assert exit_.value.code == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", TOOLS)
def test_console_takes_the_jax_tools_options(name, capsys):
    def options(text):
        return sorted(set(re.findall(r"(?<![\w-])--?[a-z][\w-]*", text)))

    port = options(_help(_port_tool(name), capsys))
    assert port and port == options(_help(_load_tool(name), capsys))


def test_consoles_run_as_modules(tmp_path):
    """Each console's module entry point (``python -m
    multidisttorch_tpu_torch.tools.<name>``), in one child: every one
    parses its arguments and exits 0, and none initialises CUDA."""
    code = (
        "import runpy, sys\n"
        f"for name in {TOOLS!r}:\n"
        "    sys.argv = [name, '--help']\n"
        "    try:\n"
        "        runpy.run_module('multidisttorch_tpu_torch.tools.' + name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ran', len(sys.modules) > 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("usage:") == len(TOOLS) and "ran True" in res.stdout
