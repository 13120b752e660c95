"""Elastic multi-host in the port (ROADMAP A.11), held against the JAX
package's own results: the store agreement and barrier, the cross-host
restore agreement, the wedge watchdog, the WEDGE fault, the SIGTERM drain,
the sweep supervisor and the kill-one-of-N drill.

Process worlds run over gloo on the CPU, each bounded by a timeout
(``test_torch_groups._launch``, the supervisor's world timeout). The wedge
drill waits out a 45 s heartbeat deadline, so it is ``multihost`` (slow), as
the JAX package marks its own.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from multidisttorch_tpu_torch.parallel import cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_groups import _launch  # noqa: E402


# -- the store agreement, the barrier and the restore agreement -----------


def test_one_process_world_needs_no_store():
    assert cluster.coordination_store() is None
    assert cluster.agree_min_int("t", 5, [0], timeout_s=1.0, what="solo") == 5
    assert cluster.agree_min_int("t", 5, [0, 1], timeout_s=1.0, what="no world") == 5
    cluster.sync_hosts("solo", timeout_s=1.0)  # a no-op


def test_find_ifname_matches_the_jax_helper():
    from multidisttorch_tpu.parallel.cluster import find_ifname as jax_find_ifname

    for address in ("127.0.0.1", "localhost", "no-such-host.invalid"):
        assert cluster.find_ifname(address) == jax_find_ifname(address)


_AGREE_MAIN = textwrap.dedent(
    """
    import json, os, sys, time
    import numpy as np
    from multidisttorch_tpu_torch.parallel import cluster
    from multidisttorch_tpu_torch.train import checkpoint as ckpt

    out_dir, out = sys.argv[1], sys.argv[2]
    n, pid = cluster.initialize_runtime(device="cpu")
    store = cluster.coordination_store()
    got = {"pid": pid, "n": n, "store": store is not None}
    got["min"] = cluster.agree_min_int("t:min", 7 if pid == 0 else 3, [0, 1], timeout_s=30, what="min")
    got["solo"] = cluster.agree_min_int("t:solo", 9 + pid, [pid], timeout_s=30, what="solo")
    path = os.path.join(out_dir, "trial-0", "state.msgpack")
    if pid == 0:
        for step in (4, 8):
            ckpt.save_state({"w": np.arange(8, dtype=np.float32) + step}, path,
                            metadata={"step": step, "completed_epochs": step // 4}, keep_last=3)
    cluster.sync_hosts("ckpts written", timeout_s=60)
    real_verify = ckpt.verify_checkpoint

    def set_verify(fn):
        if pid == 1:
            ckpt.verify_checkpoint = fn

    def agree(name, timeout_s=20):
        r = ckpt.agreed_restore_step(path, name=name, participants=[0, 1], timeout_s=timeout_s)
        return r[0] if r is not None else None

    def torn_newest(p):
        ok, meta, reason = real_verify(p)
        if ok and meta and int(meta.get("step", 0)) >= 8:
            return False, meta, "simulated torn read"
        return ok, meta, reason

    set_verify(torn_newest)
    got["torn_agreed"] = agree("t0:a1")
    set_verify(real_verify)
    got["healthy_agreed"] = agree("t0:a2")
    set_verify(lambda p: (False, None, "all candidates torn"))
    got["none_agreed"] = agree("t0:a3")
    set_verify(real_verify)
    if pid == 0:
        # Rank 1 skips both: each must raise WedgedCollective within its
        # 2 s deadline, never hang.
        for what, call in (("agree", lambda: agree("t0:a4", timeout_s=2)),
                           ("sync", lambda: cluster.sync_hosts("rank 1 away", timeout_s=2))):
            t0 = time.time()
            try:
                call()
                got[what] = "no-error"
            except cluster.WedgedCollective:
                got[what] = "WedgedCollective"
            got[what + "_wait_s"] = time.time() - t0
        store.set("rank0:leaving", "1")
    else:
        # Rank 0 serves the store: once it is gone, a barrier fails fast
        # and by name instead of hanging.
        try:
            store.wait(["rank0:leaving"])
        except Exception:  # rank 0 left, with its store, before the reply
            pass
        time.sleep(1.0)
        t0 = time.time()
        try:
            cluster.sync_hosts("store gone", timeout_s=20)
            got["store_gone"] = "no-error"
        except cluster.WedgedCollective:
            got["store_gone"] = "WedgedCollective"
        got["store_gone_wait_s"] = time.time() - t0
    with open(out, "w") as f:
        json.dump(got, f)
    os._exit(0)
    """
)


def test_store_agreement_barrier_and_restore_agreement_over_two_processes(tmp_path):
    outs = [str(tmp_path / f"r{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, "-c", _AGREE_MAIN, str(tmp_path / "ckpt"), outs[r]], 2, timeout=90)
    r0, r1 = (json.load(open(o)) for o in outs)
    assert r0["store"] and r1["store"] and r0["n"] == r1["n"] == 2
    assert r0["min"] == r1["min"] == 3
    assert (r0["solo"], r1["solo"]) == (9, 10)
    # What the JAX package's test_cross_host_restore_agreement_min_step
    # asserts over its coordination service.
    assert r0["torn_agreed"] == r1["torn_agreed"] == 4
    assert r0["healthy_agreed"] == r1["healthy_agreed"] == 8
    assert r0["none_agreed"] is None and r1["none_agreed"] is None
    assert r0["agree"] == r0["sync"] == "WedgedCollective"
    assert r0["agree_wait_s"] < 10 and r0["sync_wait_s"] < 10
    assert r1["store_gone"] == "WedgedCollective" and r1["store_gone_wait_s"] < 20


def test_restore_agreement_one_participant_equals_the_jax_one(tmp_path, monkeypatch):
    """A lineage of steps 4 and 8 written by the port, agreed by one
    participant in both packages (either package reads the other's files),
    with the newest candidate healthy and torn."""
    from multidisttorch_tpu.train import checkpoint as jax_ckpt
    from multidisttorch_tpu_torch.train import checkpoint as ckpt

    path = str(tmp_path / "trial-0" / "state.msgpack")
    for step in (4, 8):
        ckpt.save_state({"w": np.arange(8, dtype=np.float32) + step}, path,
                        metadata={"step": step, "completed_epochs": step // 4}, keep_last=3)
    got = {}
    for name, mod in (("port", ckpt), ("jax", jax_ckpt)):
        healthy = mod.agreed_restore_step(path, name="t", participants=[0])
        real = mod.verify_checkpoint

        def torn(p, real=real):
            ok, meta, reason = real(p)
            return (False, meta, "torn") if ok and int(meta.get("step", 0)) >= 8 else (ok, meta, reason)

        monkeypatch.setattr(mod, "verify_checkpoint", torn)
        torn_got = mod.agreed_restore_step(path, name="t", participants=[0])
        monkeypatch.setattr(mod, "verify_checkpoint", lambda p: (False, None, "all torn"))
        none_got = mod.agreed_restore_step(path, name="t", participants=[0])
        monkeypatch.setattr(mod, "verify_checkpoint", real)
        got[name] = [(r[0], os.path.basename(r[1]), r[2]["step"]) if r else None
                     for r in (healthy, torn_got, none_got)]
    assert got["port"] == got["jax"]
    assert [g[0] if g else None for g in got["port"]] == [8, 4, None]


# -- the wedge watchdog, the WEDGE fault and the drain handlers -----------


def test_wedged_fetch_bounds_a_multi_rank_fetch():
    from multidisttorch_tpu_torch.hpo.driver import _TrialRun

    release = threading.Event()
    run = SimpleNamespace(group=SimpleNamespace(size=2), _wedge_timeout_s=0.1, cfg=SimpleNamespace(trial_id=3))
    t0 = time.time()
    with pytest.raises(cluster.WedgedCollective, match="trial 3 epoch 1 loss fetch"):
        _TrialRun._wedged_fetch(run, lambda: release.wait(30), "epoch 1 loss fetch")
    assert time.time() - t0 < 5
    release.set()
    assert _TrialRun._wedged_fetch(run, lambda: 7, "fetch") == 7
    # A one-rank group calls straight through, on this thread.
    solo = SimpleNamespace(group=SimpleNamespace(size=1), _wedge_timeout_s=0.1, cfg=run.cfg)
    assert _TrialRun._wedged_fetch(solo, threading.current_thread, "fetch") is threading.current_thread()


def test_wedge_fault_suspends_the_heartbeat_then_preempts(tmp_path):
    from multidisttorch_tpu_torch.faults import inject
    from multidisttorch_tpu_torch.faults.plan import WEDGE, FaultPlan, FaultSpec
    from multidisttorch_tpu_torch.parallel import membership as m

    hb = m.start_heartbeat(str(tmp_path), 1, interval_s=0.02)
    try:
        plan = FaultPlan(specs=(FaultSpec(WEDGE, trial_id=-1, step=0, host=1, delay_s=0.05),))
        inj = inject.FaultInjector(plan, host_slot=1, fired_log=str(tmp_path / "fired-1.jsonl"))
        t0 = time.time()
        with pytest.raises(inject.HostPreemption, match="wedge"):
            inj.step_hook(0, 0, 1)
        assert time.time() - t0 >= 0.05
        assert hb._suspended.is_set()
        assert inj.fired and inj.fired[0]["kind"] == WEDGE and inj.fired[0]["host"] == 1
        # One-shot across a restarted host: the fired-log replays.
        inject.FaultInjector(plan, host_slot=1, fired_log=str(tmp_path / "fired-1.jsonl")).step_hook(0, 0, 1)
        # Another host's injector never fires it.
        inject.FaultInjector(plan, host_slot=0).step_hook(0, 0, 1)
    finally:
        m.stop_heartbeat()


def test_run_hpo_restores_the_signal_handlers(tmp_path):
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.hpo import driver

    before = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    seen = []
    real = driver._install_drain_handlers

    def spy():
        real()
        seen.append(signal.getsignal(signal.SIGTERM))

    driver._install_drain_handlers = spy
    try:
        cfg = driver.TrialConfig(0, epochs=1, batch_size=16, hidden_dim=16, latent_dim=4, seed=0)
        driver.run_hpo([cfg], synthetic_mnist(64, seed=0), None, num_groups=1, device="cpu",
                       out_dir=str(tmp_path), verbose=False, save_images=False)
    finally:
        driver._install_drain_handlers = real
    assert seen and seen[0] not in before
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    assert driver._DRAIN["sig"] is None


_DRAIN_ARGS = ["--device", "cpu", "--trials", "1", "--epochs", "10", "--data-rows", "1024", "--batch-size", "32",
               "--hidden-dim", "64", "--latent-dim", "8"]


def _worker(mode: str, out_dir: str, *extra) -> list:
    return [sys.executable, "-m", "multidisttorch_tpu_torch.examples.elastic_worker", mode, out_dir, *extra]


def test_sigterm_drain_exits_75_with_bounded_loss(tmp_path):
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
    from multidisttorch_tpu_torch.train.checkpoint import _read_tree

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out_dir, straight_dir = str(tmp_path / "sweep"), str(tmp_path / "straight")
    straight = subprocess.Popen(_worker("drain_sweep", straight_dir, *_DRAIN_ARGS), env=env, cwd=REPO, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    p = subprocess.Popen(_worker("drain_sweep", out_dir, *_DRAIN_ARGS), env=env, cwd=REPO, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    meta_path = os.path.join(out_dir, "trial-0", "state.msgpack.json")
    deadline, killed = time.time() + 120, False
    try:
        while time.time() < deadline and p.poll() is None:
            try:
                with open(meta_path) as f:
                    if int(json.load(f).get("completed_epochs", 0)) >= 2:
                        p.send_signal(signal.SIGTERM)
                        killed = True
                        break
            except (OSError, ValueError):
                pass
            time.sleep(0.01)
        out = p.communicate(timeout=120)[0]
        straight_out = straight.communicate(timeout=120)[0]
    finally:
        for proc in (p, straight):
            if proc.poll() is None:
                proc.kill()
    assert killed, "the sweep finished before the drain could be exercised"
    assert p.returncode == cluster.PREEMPTION_EXIT_CODE, out[-2000:]
    assert "HostPreemption" in out and "graceful drain" in out, out[-2000:]
    assert straight.returncode == 0, straight_out[-2000:]
    pre = [ev for ev in SweepLedger(out_dir).load()
           if ev.get("event") == "attempt_end" and ev.get("status") == "preempted"]
    assert pre and "graceful drain" in pre[-1]["error"]
    steps_at_kill = int(pre[-1]["summary"]["steps_at_failure"])

    resumed = subprocess.run(_worker("drain_sweep", out_dir, "--resume", *_DRAIN_ARGS), env=env, cwd=REPO,
                             text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=120)
    assert resumed.returncode == 0, resumed.stdout[-2000:]
    res = json.loads([ln for ln in resumed.stdout.splitlines() if ln.startswith("RESULT ")][-1][7:])["0"]
    spe = 1024 // 32
    assert res["status"] == "completed" and res["steps"] == 10 * spe
    assert res["resumed_from_step"] >= 2 * spe  # a real resume
    assert steps_at_kill - res["resumed_from_step"] <= spe  # at most the epoch in flight
    # The resumed run's final checkpoint equals the uninterrupted run's.
    a = _read_tree(os.path.join(out_dir, "trial-0", "state.msgpack"))
    b = _read_tree(os.path.join(straight_dir, "trial-0", "state.msgpack"))

    def leaves(t, prefix=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(t)

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys() and all(np.array_equal(la[k], lb[k]) for k in la), "final checkpoints differ"


# -- the supervisor and the drill -----------------------------------------

_FAKE_WORKER = textwrap.dedent(
    """
    import os, signal, sys, time
    sys.path.insert(0, {repo!r})

    def on_term(sig, frame):
        membership = sys.modules.get("{package}.parallel.membership")
        if membership is not None:
            membership.stop_heartbeat()
        sys.exit(75)  # the drain contract: a healthy host in a lost world

    # Before the package import, which loads torch or jax and can take
    # seconds under parallel test workers: a drain that lands during it
    # must still exit 75, not die by the signal.
    signal.signal(signal.SIGTERM, on_term)
    from {package}.parallel import membership

    slot = int(os.environ["MDT_HOST_SLOT"])
    epoch = int(os.environ["MDT_WORLD_EPOCH"])
    run_dir = os.environ["MDT_ELASTIC_RUN_DIR"]
    size = os.environ.get("WORLD_SIZE") or os.environ["OMPI_COMM_WORLD_SIZE"]
    membership.start_heartbeat(run_dir, slot, interval_s=0.05, world_epoch=epoch, world_size=int(size))

    if epoch == 0:
        if slot == 1:
            # Every peer is up (its lease exists) before this host is lost,
            # so each survivor drains through its handler to 75.
            peers = [membership.lease_path(run_dir, s) for s in range(int(size)) if s != slot]
            deadline = time.time() + 60
            while not all(os.path.exists(p) for p in peers) and time.time() < deadline:
                time.sleep(0.02)
            time.sleep(0.6)
            os._exit(86)  # a hard host loss
        while True:
            time.sleep(0.05)  # trains forever; the supervisor drains it
    else:
        time.sleep(0.4)  # the smaller world finishes the sweep
        membership.stop_heartbeat()
        sys.exit(0)
    """
)


def _supervise(sup_cls, package: str, tmp_path) -> dict:
    worker = tmp_path / f"fake_worker_{package}.py"
    worker.write_text(_FAKE_WORKER.format(repo=REPO, package=package))
    run_dir = str(tmp_path / f"run_{package}")
    os.makedirs(run_dir)
    sup = sup_cls([sys.executable, str(worker)], run_dir, 3, heartbeat_deadline_s=1.0, poll_s=0.05,
                  boot_grace_s=30.0, drain_grace_s=5.0, world_timeout_s=60.0, compact_ledger=False)
    return sup.run()


def test_supervisor_reports_what_the_jax_supervisor_reports(tmp_path):
    from multidisttorch_tpu.parallel.membership import world_history as jax_world_history
    from multidisttorch_tpu_torch.examples.sweep_supervisor import ElasticSupervisor

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from sweep_supervisor import ElasticSupervisor as JaxElasticSupervisor
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    port = _supervise(ElasticSupervisor, "multidisttorch_tpu_torch", tmp_path)
    ref = _supervise(JaxElasticSupervisor, "multidisttorch_tpu", tmp_path)
    # What the JAX package's test_supervisor_shrinks_world_on_hard_host_loss
    # asserts, for both.
    for report in (port, ref):
        assert report["success"] and report["worlds_formed"] == 2 and report["hosts_lost"] == [1]
        assert [w["outcome"] for w in report["worlds"]] == ["host_lost", "complete"]
        assert report["worlds"][1]["hosts"] == [0, 2]
        assert report["worlds"][0]["exits"][1] not in (0, 75)
        hist = jax_world_history(report["run_dir"])
        assert [w["epoch"] for w in hist] == [0, 1] and hist[1]["lost"] == [1]

    def shape(report):
        return {
            "keys": sorted(report),
            "world_keys": [sorted(w) for w in report["worlds"]],
            "exits": [{s: rc for s, rc in w["exits"].items()} for w in report["worlds"]],
            "tax": [sorted(t) for t in report["restart_tax"]],
            **{k: report[k] for k in ("success", "worlds_formed", "hosts_initial", "hosts_final", "hosts_lost")},
        }

    assert shape(port) == shape(ref)
    assert sorted(port["fleet"]) == sorted(ref["fleet"]) == ["events", "summary", "trace"]


def test_supervisor_preflight_refuses_an_unusable_backend(monkeypatch, tmp_path):
    """A non-usable verdict of the port's preflight aborts the launch with
    its classified reason before any worker starts, as the JAX
    supervisor's does; a usable one lets the world form."""
    from multidisttorch_tpu_torch.examples.sweep_supervisor import ElasticSupervisor
    from multidisttorch_tpu_torch.utils import preflight as pf

    monkeypatch.setattr(pf, "run_preflight", lambda *a, **k: {
        "verdict": pf.WEDGED_INIT_TIMEOUT, "verdict_reason": "init blocked after 5s", "usable": False})
    sup = ElasticSupervisor(["true"], str(tmp_path / "bad"), 2, preflight=True, export_fleet=False)
    with pytest.raises(RuntimeError, match="wedged_init_timeout"):
        sup.run()
    assert sup.preflight_report["usable"] is False and sup.worlds == []
    assert not os.path.exists(tmp_path / "bad" / "logs")  # no worker was launched
    monkeypatch.setattr(pf, "run_preflight", lambda *a, **k: {"verdict": "healthy", "usable": True})
    report = ElasticSupervisor(["true"], str(tmp_path / "ok"), 2, preflight=True, poll_s=0.05,
                               compact_ledger=False).run()
    assert report["success"] and report["preflight"]["verdict"] == "healthy" and report["worlds_formed"] == 1


def test_cpu_drill_host_lost_three_hosts(tmp_path):
    """The kill-one-of-3 drill through the port's harness, supervisor and
    worker (gloo): host 1 dies mid-sweep, the supervisor re-forms a 2-host
    world, the survivors settle every trial and the recovered results
    bit-match the fault-free reference; what the JAX package's
    test_elastic_drill_host_lost_three_hosts asserts. The run directory
    then folds alike through both packages' fleet merge."""
    from multidisttorch_tpu.telemetry import fleet as jax_fleet
    from multidisttorch_tpu_torch.faults.harness import run_chaos_mh_bench
    from multidisttorch_tpu_torch.telemetry import fleet

    report = run_chaos_mh_bench(str(tmp_path), hosts=3, trials=4, epochs=2, kind="host_lost", victim=1,
                                heartbeat_deadline_s=2.0, agree_timeout_s=10.0, boot_grace_s=90.0,
                                world_timeout_s=150.0, device="cpu")
    assert report["worlds_formed"] >= 2, report["supervisor"]
    assert report["hosts_lost"] == [1] and report["hosts_final"] == 2
    assert report["all_trials_settled"], report["statuses"]
    assert report["recovered_bit_identical"], report["parity"]
    assert len(report["parity"]) == 4
    assert report["goodput"] > 0.5
    assert report["membership"]["host_lost_traced"] and report["membership"]["world_shrunk_traced"]
    fl = report["fleet"]
    assert fl["all_hosts_traced"] and fl["faults_fired"] == 1 and fl["all_faults_traced"]
    assert fl["restart_tax_nonnull"] and fl["worlds_in_timeline"] == 2
    assert report["worker_builds"] == [] and report["worker_launch_lines"] >= 4
    run_dir = report["run_dir"]
    merged, jmerged = fleet.merge_fleet(run_dir), jax_fleet.merge_fleet(run_dir)
    assert json.dumps(merged, sort_keys=True, default=str) == json.dumps(jmerged, sort_keys=True, default=str)
    for name in ("trial_lineage", "per_world_books", "restart_tax_report"):
        assert json.dumps(getattr(fleet, name)(merged["events"]), sort_keys=True) == json.dumps(
            getattr(jax_fleet, name)(jmerged["events"]), sort_keys=True), name


@pytest.mark.multihost
def test_wedge_exits_with_named_wedged_collective(tmp_path):
    """A wedged host (stalled, heartbeat suspended): the survivor's
    end-of-sweep barrier exits with a named WedgedCollective within its
    deadline, the supervisor calls the wedged host lost from its stale
    lease, and the smaller world finishes the sweep."""
    from multidisttorch_tpu_torch.faults.harness import run_chaos_mh_bench

    report = run_chaos_mh_bench(str(tmp_path), hosts=2, trials=3, epochs=2, kind="wedge", victim=1,
                                heartbeat_deadline_s=45.0, agree_timeout_s=8.0, boot_grace_s=90.0,
                                world_timeout_s=300.0, device="cpu")
    assert report["wedged_collective_exits"] >= 1, report["supervisor"]
    assert report["hosts_lost"] == [1] and report["worlds_formed"] >= 2
    assert report["all_trials_settled"], report["statuses"]
    assert report["membership"]["host_lost_traced"]
