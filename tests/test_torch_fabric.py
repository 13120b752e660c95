"""The port's sharded service fabric (service/{fabric,topology,fabric_drill}.py)
against the JAX package's on the same inputs, on the CPU: shard routing,
the topology fold, the lease protocol and fencing, adoption, the client,
the ``daemon_lost`` fault, the scheduler's EDF order and preemption budget,
long turns (a long turn keeps its shard; a replica that stops ticking, or
hangs inside a turn, loses it within the deadline plus the grace), and the failover drill on two
replica children, bit-identical to its undisturbed reference. Splits, steals
and ``shard_split_lost`` are held in ``tests/test_torch_fabric_split.py``."""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import types

import numpy as np
import pytest

from multidisttorch_tpu.service import fabric as jfabric
from multidisttorch_tpu.service import queue as jqueue
from multidisttorch_tpu.service import scheduler as jsched
from multidisttorch_tpu.service import topology as jtopo
from multidisttorch_tpu_torch.service import fabric, fabric_drill
from multidisttorch_tpu_torch.service import queue as squeue
from multidisttorch_tpu_torch.service import scheduler as psched
from multidisttorch_tpu_torch.service import topology as stopo

pytestmark = pytest.mark.fabric

CFG = {"epochs": 1, "batch_size": 32, "latent_dim": 4, "hidden_dim": 16, "log_interval": 1000}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: stacked and unstacked products sum in the same
    # order (the CPU's bitwise stacking contract).
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- routing ------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_shard_of_equals_the_jax_routing(n):
    tenants = [f"tenant-{i}" for i in range(300)] + ["alpha", "beta", "", "ümlaut"]
    got = [fabric.shard_of(t, n) for t in tenants]
    assert got == [jfabric.shard_of(t, n) for t in tenants]
    assert set(got) <= set(range(n))
    assert [stopo.Topology(n).route(t) for t in tenants] == got
    for mod in (fabric, jfabric):
        with pytest.raises(ValueError):
            mod.shard_of("t", 0)


def test_topology_is_a_copy_of_the_jax_module():
    """The port's topology is the JAX file with the imports renamed and its
    docstrings its own."""
    import ast

    def body(mod):
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and ast.get_docstring(node):
                node.body = node.body[1:]
        return ast.dump(tree).replace("multidisttorch_tpu_torch", "X").replace("multidisttorch_tpu", "X")

    assert body(stopo) == body(jtopo)


def _leaves(topo) -> dict:
    return {k: (leaf.shard, leaf.base, leaf.depth, leaf.bits) for k, leaf in topo.leaves.items()}


def _mergeable_pairs(topo):
    """(parent, child) leaf pairs the MERGE event would accept."""
    out = []
    for p, pl in topo.leaves.items():
        if pl.depth < 1 or pl.bits & (1 << (pl.depth - 1)):
            continue
        for c, cl in topo.leaves.items():
            if c != p and cl.base == pl.base and cl.depth == pl.depth and cl.bits == (pl.bits | (1 << (pl.depth - 1))):
                out.append((p, c))
    return sorted(out)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n_base", [1, 2, 3])
def test_topology_fold_equals_the_jax_fold(seed, n_base):
    """The JAX property test's seeded split/merge walks (begins, commits,
    aborts, merges), applied to both packages' topologies: the same leaves,
    pending splits, epochs and routes after every event, and exactly one
    owner per tenant throughout; replays and stale epochs rejected by
    both."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, n_base]))
    port, ref = stopo.Topology(n_base), jtopo.Topology(n_base)
    tenants = [f"t{seed}-{i}" for i in range(150)]

    def apply(event, parent, child):
        ev = {"event": event, "parent": parent, "child": child, "epoch": port.epoch + 1}
        assert port.apply(dict(ev)) and ref.apply(dict(ev))
        assert not port.apply(dict(ev)) and not ref.apply(dict(ev))  # a replay
        assert _leaves(port) == _leaves(ref) and port.epoch == ref.epoch
        assert [(p.parent, p.child, p.epoch) for p in port.pending] == [(p.parent, p.child, p.epoch)
                                                                        for p in ref.pending]
        assert port.describe() == ref.describe() and port.next_shard_id() == ref.next_shard_id()
        routes = [port.route(t) for t in tenants]
        assert routes == [ref.route(t) for t in tenants]
        for t, owner in zip(tenants, routes):
            h = stopo.tenant_hash(t)
            assert [leaf.shard for leaf in port.leaves.values() if leaf.matches(h, n_base)] == [owner]

    for _ in range(40):
        merges = _mergeable_pairs(port)
        if merges and rng.random() < 0.3:
            apply(stopo.MERGE, *merges[int(rng.integers(0, len(merges)))])
            continue
        live = port.live_shards()
        parent, child = int(live[int(rng.integers(0, len(live)))]), port.next_shard_id()
        apply(stopo.SPLIT_BEGIN, parent, child)
        assert child not in port.live_shards()
        apply(stopo.SPLIT_ABORT if rng.random() < 0.25 else stopo.SPLIT_COMMIT, parent, child)
    # A stale epoch and a non-sibling merge are skipped by both.
    for ev in ({"event": stopo.SPLIT_BEGIN, "parent": 0, "child": 99, "epoch": 1},
               {"event": stopo.MERGE, "parent": 0, "child": 0, "epoch": port.epoch + 1}):
        assert port.apply(dict(ev)) == ref.apply(dict(ev)) is False


def _log_script(tmod, d) -> list:
    """Appends through one package's topology log: first writers, a lost
    race, a torn tail and its replay."""
    out = []
    for ev in ({"event": stopo.SPLIT_BEGIN, "parent": 0, "child": 2},
               {"event": stopo.SPLIT_COMMIT, "parent": 0, "child": 2},
               {"event": stopo.SPLIT_BEGIN, "parent": 1, "child": 3}):
        won, epoch, topo = tmod.append_topology_event(d, ev)
        out.append((won, epoch, topo.describe()))
    with open(tmod.topology_path(d), "a") as f:
        f.write("[1, 2, 3]\n")  # decodable but not a record: skipped
        f.write('{"event": "split_abort", "parent": 1, "ch')  # torn
    out.append(tmod.load_topology(d).describe())
    won, epoch, topo = tmod.append_topology_event(d, {"event": stopo.SPLIT_ABORT, "parent": 1, "child": 3})
    out.append((won, epoch, topo.describe(), topo.next_shard_id()))
    return out


def test_topology_log_equals_the_jax_log(tmp_path, monkeypatch):
    """Both packages' durable logs: the missing log is the identity
    (static routing), epochs rise strictly, an aborted child id is burned,
    a torn tail costs only itself, and each package folds the other's
    file alike."""
    runs = {}
    for name, tmod, fmod in (("port", stopo, fabric), ("jax", jtopo, jfabric)):
        d = str(tmp_path / name)
        fmod.ensure_fabric_config(d, 2)
        ident = tmod.load_topology(d)
        assert ident.epoch == 0 and ident.live_shards() == [0, 1]
        runs[name] = (_log_script(tmod, d), d)
    assert runs["port"][0] == runs["jax"][0]
    assert [e for _, e, *_ in runs["port"][0][:3]] == [1, 2, 3]
    assert runs["port"][0][-1][3] == 4  # child 3 burned by its abort
    assert stopo.load_topology(runs["jax"][1]).describe() == jtopo.load_topology(runs["port"][1]).describe()

    # The lost append race: the pre-append read misses a rival's record, so
    # both writers pick epoch 1; the read-back reports the race lost.
    for name, tmod, fmod in (("port", stopo, fabric), ("jax", jtopo, jfabric)):
        d = str(tmp_path / f"race-{name}")
        fmod.ensure_fabric_config(d, 2)
        tmod.append_topology_event(d, {"event": stopo.SPLIT_BEGIN, "parent": 0, "child": 2})
        real, calls = tmod.load_topology_events, {"n": 0}

        def stale_first_read(service_dir, real=real, calls=calls):
            calls["n"] += 1
            evs = real(service_dir)
            return evs[:-1] if calls["n"] == 1 else evs

        monkeypatch.setattr(tmod, "load_topology_events", stale_first_read)
        won, epoch, topo = tmod.append_topology_event(d, {"event": stopo.SPLIT_BEGIN, "parent": 1, "child": 2})
        monkeypatch.undo()
        assert not won and epoch == 1
        assert topo.pending_for(0) is not None and topo.pending_for(1) is None


# -- leases and fences ----------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1_000_000.0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


def _lease_script(fmod, d: str, clock: _Clock, monkeypatch) -> list:
    """Claim, renew, stale, takeover, fence loss, a first-append-wins race,
    release and the health view, through one package under a scripted
    clock."""
    out = []
    fmod.ensure_fabric_config(d, 4)
    f0 = fmod.try_claim(d, 0, replica=0)
    out.append(("claim", f0.epoch, f0.holds(force=True)))
    out.append(("unclaimed_orphaned", fmod.shard_orphaned(d, 1, lease_deadline_s=1.0)))
    clock.t += 1.0
    f0.renew()
    out.append(("alive", fmod.shard_orphaned(d, 0, lease_deadline_s=2.0)))
    out.append(("stale_later", fmod.shard_orphaned(d, 0, lease_deadline_s=2.0, now=clock.t + 2.5)))
    clock.t += 3.0
    out.append(("stale", fmod.shard_orphaned(d, 0, lease_deadline_s=2.0)))
    out.append(("health_stale", fmod.fabric_health(d, lease_deadline_s=2.0)))
    f1 = fmod.try_claim(d, 0, replica=1)
    out.append(("takeover", f1.epoch, f0.holds(force=True), f1.holds(force=True)))
    for what in ("check", "renew"):
        try:
            getattr(f0, what)()
            out.append((what, "held"))
        except fmod.FenceLost:
            out.append((what, "FenceLost"))
    f1.renew()
    # Replica 5's claim at epoch 1 of shard 3 lands FIRST; replica 6 raced
    # the same epoch (its max-epoch read came before 5's append).
    path = fmod.lease_file(d, 3)
    fmod._append_lease(path, {"shard": 3, "replica": 5, "epoch": 1, "status": fmod.CLAIM, "ts": clock.t})
    monkeypatch.setattr(fmod, "_max_epoch_tail", lambda p: 0)
    out.append(("race_lost", fmod.try_claim(d, 3, replica=6) is None))
    monkeypatch.undo()
    out.append(("race_winner_holds", fmod.ShardFence(shard=3, replica=5, epoch=1, path=path).holds(force=True)))
    f1.release()
    out.append(("released", fmod.shard_orphaned(d, 0, lease_deadline_s=60.0), f1.holds()))
    out.append(("owner", {k: v for k, v in fmod.shard_owner(d, 0).items() if k != "ts"}))
    out.append(("health", fmod.fabric_health(d, lease_deadline_s=2.0)))
    return out


def test_lease_protocol_equals_the_jax_protocol(tmp_path, monkeypatch):
    """One scripted lease story through both packages under a held clock:
    the same verdicts, fences and health view, and lease records equal
    field by field but their times."""
    outs, records = {}, {}
    for name, fmod in (("port", fabric), ("jax", jfabric)):
        clock = _Clock()
        d = str(tmp_path / name)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(time, "time", clock.time)
            mp.setattr(time, "monotonic", clock.monotonic)
            with pytest.MonkeyPatch.context() as race:
                outs[name] = _lease_script(fmod, d, clock, race)
        with open(fabric.lease_file(d, 0)) as f0, open(fabric.lease_file(d, 3)) as f3:
            records[name] = [[{k: v for k, v in json.loads(ln).items() if k != "ts"} for ln in f] for f in (f0, f3)]
    assert outs["port"] == outs["jax"]
    assert records["port"] == records["jax"]
    assert [r["status"] for r in records["port"][0]] == ["claim", "renew", "claim", "renew", "release"]
    assert ("check", "FenceLost") in outs["port"] and ("renew", "FenceLost") in outs["port"]
    assert [r["epoch"] for r in records["port"][0]] == [1, 1, 2, 2, 2]


def test_fabric_config_first_writer_pins(tmp_path):
    d = str(tmp_path)
    fabric.ensure_fabric_config(d, 4)
    assert fabric.read_fabric_config(d) == jfabric.read_fabric_config(d) == {"n_shards": 4}
    jfabric.ensure_fabric_config(d, 4)
    with pytest.raises(ValueError):
        fabric.ensure_fabric_config(d, 2)  # disagreeing routing


@pytest.mark.parametrize("name", ["port", "jax"])
def test_fenced_queue_rejects_stale_appends(tmp_path, name):
    """A stale writer's every append raises BEFORE touching the journal,
    through either package's queue given the port's fence."""
    qmod = squeue if name == "port" else jqueue
    d = str(tmp_path)
    fence = fabric.try_claim(d, 0, replica=0)
    sd = fabric.shard_dir(d, 0)
    q = qmod.SubmissionQueue(sd, fence=fence.check, epoch=fence.epoch)
    q.append({"event": "submitted", "sub": {"submission_id": "s1"}})
    n_before = len(squeue.load_queue(sd))
    assert squeue.load_queue(sd)[0]["epoch"] == 1
    assert jfabric.try_claim(d, 0, replica=1) is not None  # the JAX package's claim outbids it
    time.sleep(fence.check_interval_s + 0.02)
    with pytest.raises(fabric.FenceLost):
        q.append({"event": "settled", "submission_id": "s1"})
    assert len(squeue.load_queue(sd)) == n_before


# -- the scheduler's EDF order and preemption budget -------------------------


def _entry(smod, tenant, i, *, deadline_ts=None, size=1):
    return smod.PendingTrial(sub_id=f"{tenant}-{i}", tenant=tenant, priority=1, cfg=None, bucket="b", size=size,
                             cost=1.0, submit_ts=float(i), trial_id=i, deadline_ts=deadline_ts)


def _edf_orders(smod, seed: int) -> list:
    """The JAX tests' EDF scenarios through one package's scheduler: a
    seeded mix of deadline-tagged and best-effort entries, a front-pushed
    victim, and a late tighter arrival; the placement order of each."""
    rng = np.random.default_rng(seed)
    orders = []

    def drain(sched):
        pool, order = smod.SlicePool(1), []
        while sched.pending_count():
            (p,) = sched.schedule(pool, max_lanes=1, now=0.0)
            order.append(p.members[0].trial_id)
            pool.free(p.start, p.size)
        return order

    sched = smod.FairShareScheduler({"t": smod.TenantPolicy()})
    deadlines = {}
    for i in range(40):
        deadlines[i] = float(rng.uniform(0, 1000)) if rng.random() < 0.6 else None
        sched.push(_entry(smod, "t", i, deadline_ts=deadlines[i]), now=float(i))
    orders.append((drain(sched), deadlines))
    sched = smod.FairShareScheduler({"t": smod.TenantPolicy()})
    victim = _entry(smod, "t", 0)
    victim.pinned_start = 0
    sched.push(victim, front=True, now=0.0)
    sched.push(_entry(smod, "t", 1, deadline_ts=1.0), now=0.0)
    orders.append((drain(sched), None))
    sched = smod.FairShareScheduler({"t": smod.TenantPolicy()})
    for i, dl in ((0, 100.0), (1, None), (2, 50.0)):
        sched.push(_entry(smod, "t", i, deadline_ts=dl), now=0.0)
    orders.append((drain(sched), None))
    return orders


@pytest.mark.parametrize("seed", range(5))
def test_edf_order_equals_the_jax_scheduler(seed):
    port, ref = _edf_orders(psched, seed), _edf_orders(jsched, seed)
    assert port == ref
    (order, deadlines), (front, _), (late, _) = port
    tagged = [i for i in order if deadlines[i] is not None]
    untagged = [i for i in order if deadlines[i] is None]
    assert order == tagged + untagged  # every deadline before every best-effort entry
    assert [deadlines[i] for i in tagged] == sorted(deadlines[i] for i in tagged)
    assert untagged == sorted(untagged)  # best-effort stays FIFO
    assert front == [0, 1]  # never ahead of a front-pushed entry
    assert late == [2, 0, 1]


def _budget_script(smod) -> list:
    pol = smod.PreemptionPolicy(max_preemptions_per_trial=2, trial_cooldown_s=10.0, global_cooldown_s=5.0)
    out = [pol.event_allowed(0.0), pol.victim_allowed(1, 0, 0.0)]
    pol.note_eviction(1, 0.0)
    out += [pol.victim_allowed(1, 1, 5.0), pol.victim_allowed(1, 1, 10.0)]
    pol.note_eviction(1, 10.0)
    out += [pol.victim_allowed(1, 2, 1e9), pol.event_allowed(12.0), pol.event_allowed(15.0)]
    off = smod.PreemptionPolicy(enabled=False)
    out += [off.victim_allowed(9, 0, 0.0), off.event_allowed(0.0)]
    pol.forget(1)
    out.append(1 in pol.last_evict)
    return out


def test_preemption_budget_equals_the_jax_policy():
    port = _budget_script(psched)
    assert port == _budget_script(jsched)
    assert port == [True, True, False, True, False, False, True, False, False, False]


# -- the daemon_lost fault ------------------------------------------------------


def test_daemon_lost_spec_validation():
    from multidisttorch_tpu.faults import plan as jplan
    from multidisttorch_tpu_torch.faults.plan import DAEMON_LOST, HOST_KINDS, FaultPlan, FaultSpec

    assert DAEMON_LOST in HOST_KINDS
    plan = FaultPlan(specs=(FaultSpec(DAEMON_LOST, trial_id=-1, step=5, host=1),), seed=3)
    assert FaultPlan.from_json(plan.to_json()) == plan
    assert json.loads(plan.to_json()) == json.loads(
        jplan.FaultPlan(specs=(jplan.FaultSpec(DAEMON_LOST, trial_id=-1, step=5, host=1),), seed=3).to_json())
    with pytest.raises(ValueError):
        FaultSpec(DAEMON_LOST, trial_id=-1, step=5)  # host required
    with pytest.raises(ValueError):
        FaultSpec(DAEMON_LOST, trial_id=-1, host=1)  # step required


def test_daemon_lost_fires_sigkill_on_dispatch_clock(tmp_path, monkeypatch):
    """SIGKILL when the replica's dispatch clock covers the spec's step,
    after the fired record is durable; never on another replica; one-shot
    across restarts. The fired records equal the JAX injector's."""
    from multidisttorch_tpu.faults.inject import FaultInjector as JaxInjector
    from multidisttorch_tpu_torch.faults.inject import FaultInjector
    from multidisttorch_tpu_torch.faults.plan import DAEMON_LOST, FaultPlan, FaultSpec

    records = {}
    for name, cls in (("port", FaultInjector), ("jax", JaxInjector)):
        kills = []
        monkeypatch.setattr(os, "kill", lambda pid, sig, kills=kills: kills.append((pid, sig)))
        log = str(tmp_path / f"fired-{name}.jsonl")
        plan = FaultPlan(specs=(FaultSpec(DAEMON_LOST, trial_id=-1, step=10, host=1),))
        cls(plan, host_slot=0).host_step(100)  # the wrong replica: never fires
        assert kills == []
        inj = cls(plan, host_slot=1, fired_log=log)
        inj.host_step(5)
        assert kills == []
        inj.host_step(6)  # the window [5, 11) covers dispatch index 10
        assert kills == [(os.getpid(), signal.SIGKILL)]
        kills.clear()
        cls(plan, host_slot=1, fired_log=log).host_step(100)
        assert kills == []
        with open(log) as f:
            records[name] = [{k: v for k, v in json.loads(ln).items() if k != "ts"} for ln in f if ln.strip()]
        monkeypatch.undo()
    assert records["port"] == records["jax"] and records["port"][0]["kind"] == DAEMON_LOST


# -- adoption, fencing of a live service, the client --------------------------


def _journal_line(rec):
    return json.dumps({**rec, "ts": time.time()}) + "\n"


def _write_orphan_shard(sd):
    """A dead replica's shard journal: C settled, A placed (orphaned
    mid-flight), B submitted-not-admitted, plus a TORN tail."""
    os.makedirs(sd, exist_ok=True)
    with open(squeue.queue_path(sd), "w") as f:
        for sid, tid in (("beta-C", 0), ("beta-A", 1)):
            f.write(_journal_line({"event": "submitted", "sub": {
                "submission_id": sid, "tenant": "beta", "config": {**CFG, "seed": tid}, "priority": 1, "size": 1,
                "submit_ts": time.time()}}))
            f.write(_journal_line({"event": "admitted", "submission_id": sid, "trial_id": tid,
                                   "config_hash": f"h{tid}", "bucket": "b"}))
            f.write(_journal_line({"event": "placed", "submission_id": sid, "trial_id": tid, "start": 0, "size": 1,
                                   "lanes": 1, "stacked": False, "resumed": False}))
        f.write(_journal_line({"event": "settled", "submission_id": "beta-C", "trial_id": 0,
                               "status": "completed", "error": ""}))
        f.write(_journal_line({"event": "submitted", "sub": {
            "submission_id": "beta-B", "tenant": "beta", "config": {**CFG, "seed": 9}, "priority": 1, "size": 1,
            "submit_ts": time.time()}}))
        f.write('{"event": "settled", "submission_id": "beta-A", "st')


def test_adoption_replays_torn_journal_no_dup_no_drop(tmp_path):
    """The adopter's replay: the torn final transition costs only itself;
    every id survives exactly once, settled stays settled, ever-placed
    re-enters resume_scan, the pending one re-admits without colliding trial
    ids; the records it writes carry its fencing epoch."""
    from multidisttorch_tpu_torch.service.runtime import SweepService

    d = str(tmp_path)
    fabric.ensure_fabric_config(d, 1)
    sd = fabric.shard_dir(d, 0)
    _write_orphan_shard(sd)
    fence = fabric.try_claim(d, 0, replica=0)
    svc = SweepService(sd, fence=fence.check, fence_epoch=fence.epoch, n_slices=2, max_lanes=2, data_rows=64,
                       device="cpu")
    try:
        assert svc.settled == {"beta-C": "completed"}
        by_sub = {e.sub_id: e for e in svc.entries.values()}
        assert set(by_sub) == {"beta-A", "beta-B"}
        assert by_sub["beta-A"].resume_scan and not by_sub["beta-B"].resume_scan
        folded = squeue.fold_queue(squeue.load_queue(sd))
        assert folded["beta-A"]["state"] == squeue.ADMITTED
        assert folded["beta-A"]["unplaced_reason"] == "daemon restart recovery"
        assert by_sub["beta-B"].trial_id >= 2
        ids = [e.trial_id for e in svc.entries.values()]
        assert len(ids) == len(set(ids))
        assert squeue.load_queue(sd)[-1]["epoch"] == fence.epoch
        assert jqueue.fold_queue(jqueue.load_queue(sd)) == folded  # the JAX fold reads it alike
    finally:
        svc.close()


def test_stale_replica_tick_rejected_after_takeover(tmp_path):
    """The paused-and-resumed replica: its service raises FenceLost at the
    next tick, before any journal write, once another replica claimed."""
    from multidisttorch_tpu_torch.service.runtime import SweepService

    d = str(tmp_path)
    fabric.ensure_fabric_config(d, 1)
    sd = fabric.shard_dir(d, 0)
    os.makedirs(sd, exist_ok=True)
    fence = fabric.try_claim(d, 0, replica=0)
    svc = SweepService(sd, fence=fence.check, n_slices=2, max_lanes=2, data_rows=64, device="cpu")
    try:
        client = squeue.SweepClient(sd, tenant="t")
        client.submit(dict(CFG))
        svc.tick()
        assert svc.sched.pending_count() + len(svc.active) >= 1
        n_before = len(squeue.load_queue(sd))
        assert fabric.try_claim(d, 0, replica=1) is not None
        client.submit({**CFG, "seed": 2})
        time.sleep(fence.check_interval_s + 0.02)  # past the fence's cached verdict
        with pytest.raises(fabric.FenceLost):
            svc.tick()
        assert len(squeue.load_queue(sd)) == n_before
    finally:
        svc.store.shutdown(wait=True)


def test_fabric_replica_failover_inprocess(tmp_path):
    """Two in-process replicas each claim their home shard; freezing one
    (no ticks, so no renewals) makes the survivor adopt its shard and
    finish its work; the stale replica's next tick drops the shard through
    the fence instead of double-placing."""
    d = str(tmp_path)
    kw = dict(n_shards=2, lease_deadline_s=0.6, renew_every_s=0.1, adopt_scan_every_s=0.1, nonpreferred_grace_s=0.3,
              n_slices=2, max_lanes=2, data_rows=64, device="cpu")
    r0 = fabric.FabricReplica(d, replica=0, **kw)
    r1 = fabric.FabricReplica(d, replica=1, **kw)
    client = fabric.FabricClient(d, n_shards=2)
    ids = [client.submit({**CFG, "seed": 1}, tenant="alpha"),
           client.submit({**CFG, "seed": 2}, tenant="beta"),
           client.submit({**CFG, "seed": 3}, tenant="beta")]
    try:
        t0 = time.time()
        while time.time() - t0 < 30 and not (0 in r0.services and 1 in r1.services):
            r0.tick()
            r1.tick()
        assert 0 in r0.services and 1 in r1.services
        t0 = time.time()
        while time.time() - t0 < 60:
            r0.tick()
            if all((client.status(s) or {}).get("state") == squeue.SETTLED for s in ids):
                break
            time.sleep(0.02)
        final = client.wait(ids, timeout_s=1.0)
        assert all(r["state"] == squeue.SETTLED for r in final.values())
        assert r0.adoptions >= 2 and 1 in r0.services and r0.fences_lost == 0
        r0.tick()  # fresh leases before the stale replica wakes
        n_before = len(squeue.load_queue(fabric.shard_dir(d, 1)))
        r1.tick()
        assert 1 not in r1.services and r1.fences_lost >= 1
        assert len(squeue.load_queue(fabric.shard_dir(d, 1))) == n_before
        assert [(e, r) for e, r in fabric_drill._claims(d, 1)] == [(1, 1), (2, 0)]
    finally:
        r0.drain(reason="test end")
        r1.drain(reason="test end")


def test_fabric_client_routes_by_tenant(tmp_path):
    d = str(tmp_path)
    fabric.ensure_fabric_config(d, 2)
    client = fabric.FabricClient(d)
    sid_a = client.submit({"epochs": 1}, tenant="alpha")
    sid_b = client.submit({"epochs": 1}, tenant="beta")
    for sid, tenant in ((sid_a, "alpha"), (sid_b, "beta")):
        k = fabric.shard_of(tenant, 2)
        assert client.shard_for(tenant) == k == jfabric.FabricClient(d).shard_for(tenant)
        assert os.path.exists(os.path.join(squeue.intake_dir(fabric.shard_dir(d, k)), sid + ".json"))
    assert client.status(sid_a)["state"] == squeue.PENDING
    assert client.status("nope") is None
    assert jfabric.FabricClient(d).status(sid_b) == client.status(sid_b)


def _tenant_routing_to(shard: int, n: int = 2) -> str:
    i = 0
    while stopo.tenant_hash(f"wst{i}") % n != shard:
        i += 1
    return f"wst{i}"


@pytest.mark.parametrize("name", ["port", "jax"])
def test_client_wrong_shard_retry_bounded(tmp_path, name):
    """A ``rejected_wrong_shard`` verdict makes the client resubmit the SAME
    id to the current owner exactly once: the origin's rejection is
    superseded, a second rejection at the retry destination is terminal.
    Each package's client over the same journals, written by either."""
    qmod = squeue if name == "port" else jqueue
    d = str(tmp_path)
    fabric.ensure_fabric_config(d, 2)
    tenant = _tenant_routing_to(1)
    sh0, sh1 = fabric.shard_dir(d, 0), fabric.shard_dir(d, 1)
    sid = qmod.SweepClient(sh0, tenant=tenant).submit({"hidden_dim": 16}, tenant=tenant)
    q0 = qmod.SubmissionQueue(sh0)
    assert [s.submission_id for s in q0.drain_intake(known_ids=set())] == [sid]
    q0.rejected(sid, verdict=squeue.REJECT_WRONG_SHARD, reason="tenant routes to shard 1")

    client = fabric.FabricClient(d, n_shards=2, tenant=tenant)
    folded = client._folds()
    assert folded[sid]["state"] == squeue.REJECTED
    assert client._retry_wrong_shard(folded) is True
    spool = os.path.join(squeue.intake_dir(sh1), sid + ".json")
    assert os.path.exists(spool) and client._wrong_shard_retries[sid] == 1
    with open(spool) as f:
        assert json.load(f)["submission_id"] == sid
    before = os.path.getmtime(spool)
    assert client._retry_wrong_shard(client._folds()) is False
    assert os.path.getmtime(spool) == before
    folded = client._folds()
    assert folded[sid]["shard"] == 0 and not client._terminal(sid, folded[sid])
    q1 = qmod.SubmissionQueue(sh1)
    q1.drain_intake(known_ids=set())
    q1.rejected(sid, verdict=squeue.REJECT_WRONG_SHARD, reason="still wrong")
    folded = client._folds()
    assert folded[sid]["shard"] == 1 and client._terminal(sid, folded[sid])
    jclient = jfabric.FabricClient(d, n_shards=2, tenant=tenant)
    jclient._wrong_shard_retries = dict(client._wrong_shard_retries)
    assert jclient._folds() == folded


# -- long turns and a wedged replica ---------------------------------------------


class _StubService:
    """A shard service whose tick sleeps ``turn_s``: a long turn with no
    training in it."""

    def __init__(self, service_dir, *, fence, fence_epoch, route_check, turn_s=0.0, **kw):
        self.fence, self.turn_s = fence, turn_s
        self.entries, self.settled, self.active, self._pending_persists = {}, {}, {}, []
        self.dispatches, self._farm = 0, None
        self.store = types.SimpleNamespace(shutdown=lambda wait=True: None)

    def tick(self):
        self.fence()
        time.sleep(self.turn_s)
        return False

    def idle(self):
        return True

    def _drain(self, *, reason):
        self.fence()


# A deadline of 0.5 s and the default grace of 3 deadlines: a peer adopts a
# silent replica's shard 2.0 s after its last renewal (and a scan's slack).
_DEADLINE_S, _GRACE_S, _SLACK_S = 0.5, 1.5, 0.5


def _replica_pair(d, monkeypatch):
    from multidisttorch_tpu_torch.service import runtime

    monkeypatch.setattr(runtime, "SweepService", _StubService)
    kw = dict(n_shards=1, lease_deadline_s=_DEADLINE_S, renew_every_s=0.05, adopt_scan_every_s=0.05)
    r0 = fabric.FabricReplica(d, replica=0, **kw)
    t0 = time.time()
    while 0 not in r0.services and time.time() - t0 < 10:
        r0.tick()
    assert 0 in r0.services
    r1 = fabric.FabricReplica(d, replica=1, **kw)
    assert r1.nonpreferred_grace_s == _GRACE_S
    stop = threading.Event()
    adopted_at = []

    def peer():
        while not stop.is_set():
            r1.tick()
            if r1.adoptions and not adopted_at:
                adopted_at.append(time.time())
            time.sleep(0.01)

    thread = threading.Thread(target=peer, daemon=True)
    thread.start()
    return r0, r1, stop, thread, adopted_at


@pytest.mark.parametrize("case", ["long_turn_keeps", "wedged_turn_loses"])
def test_lease_keeper_long_turn_and_stopped_replica(tmp_path, monkeypatch, case):
    """Only the loop renews a lease. A live replica whose one turn sleeps
    twice the lease deadline keeps its shard (the peer waits the deadline
    plus its grace); once it stops ticking, its peer adopts within the
    deadline plus the grace. A replica wedged inside a turn renews nothing
    either: its peer adopts within the deadline plus the grace of the turn's
    start, while the turn still hangs, and the wedged replica's next tick
    drops the shard through the fence."""
    d = str(tmp_path)
    r0, r1, stop, thread, adopted_at = _replica_pair(d, monkeypatch)
    bound = _DEADLINE_S + _GRACE_S
    try:
        if case == "wedged_turn_loses":
            r0.services[0].turn_s = bound + 1.0
            t0 = time.time()
            r0.tick()  # renews at its start, then hangs past the deadline and the grace
            t_end = time.time()
            assert adopted_at, "the wedged replica's shard was not adopted during its turn"
            assert bound - 0.1 <= adopted_at[0] - t0 <= bound + _SLACK_S, adopted_at[0] - t0
            assert adopted_at[0] < t_end
            r0.services[0].turn_s = 0.0
            r0.tick()
            assert 0 not in r0.services and r0.fences_lost == 1
            assert [rep for _, rep in fabric_drill._claims(d, 0)] == [0, 1]
            return
        r0.services[0].turn_s = 2 * _DEADLINE_S
        r0.tick()
        assert r0.longest_turn_s >= 2 * _DEADLINE_S
        assert r1.adoptions == 0 and 0 in r0.services and r0.fences_lost == 0
        r0.services[0].turn_s = 0.0
        r0.tick()
        assert r1.adoptions == 0 and 0 in r0.services
        # The gap the peer saw spans the long turn: past the deadline, short
        # of the deadline plus the grace.
        assert _DEADLINE_S < fabric_drill._lease_gaps(d)[0] < bound
        assert _DEADLINE_S < r0.longest_unrenewed_s < bound
        t_stop = time.time()  # r0 stops ticking: killed, as far as its peers know
        while not adopted_at and time.time() - t_stop < 10:
            time.sleep(0.02)
        assert adopted_at, "the stopped replica's shard was never adopted"
        waited = adopted_at[0] - t_stop
        assert bound - 0.1 <= waited <= bound + _SLACK_S, waited
        assert [rep for _, rep in fabric_drill._claims(d, 0)] == [0, 1]
    finally:
        stop.set()
        thread.join(timeout=10)
        assert not thread.is_alive()


@pytest.mark.parametrize("budget", [None, 0.01])
def test_turn_budget_rounds_the_shards_and_an_adoption_ends_its_turn(tmp_path, monkeypatch, budget):
    """Without a turn budget every owned shard ticks in every turn, the
    adoption's turn too (the JAX replica's loop). With one, the turn that
    built shard services ticks nothing more, and each later turn ticks at
    least one shard and stops past the budget, the next turn starting with
    the shard after the last one ticked; each tick gets the deadline."""
    from multidisttorch_tpu_torch.service import runtime

    log: list = []

    class _Stub(_StubService):
        def __init__(self, service_dir, **kw):
            super().__init__(service_dir, turn_s=0.02, **kw)
            self.shard = int(os.path.basename(service_dir).rsplit("-", 1)[1])

        def tick(self, deadline=None):
            self.fence()
            log.append((self.shard, deadline))
            time.sleep(self.turn_s)
            return False

    monkeypatch.setattr(runtime, "SweepService", _Stub)
    r = fabric.FabricReplica(str(tmp_path), replica=0, n_shards=3, prefer={0, 1, 2}, lease_deadline_s=2.0,
                             renew_every_s=0.05, adopt_scan_every_s=0.0, turn_budget_s=budget)
    r.tick()
    assert sorted(r.services) == [0, 1, 2] and r.adoptions == 3
    if budget is None:
        r.tick()
        assert [k for k, _ in log] == [0, 1, 2, 0, 1, 2]
        assert all(dl is None for _, dl in log)
        return
    assert log == []
    for _ in range(7):
        r.tick()
    assert [k for k, _ in log] == [0, 1, 2, 0, 1, 2, 0]
    assert all(dl is not None for _, dl in log)
    assert r.fences_lost == 0


def test_a_budgeted_service_tick_steps_its_placements_round_robin():
    """``SweepService._step_actives`` with a deadline: at least one dispatch,
    none past the deadline after that, and the next pass starts with the
    placement after the last one stepped; without one, every placement in
    order, as before."""
    from multidisttorch_tpu_torch.service import runtime

    order: list = []

    def gen(pid):
        while True:
            order.append(pid)
            time.sleep(0.01)
            yield

    svc = types.SimpleNamespace(
        active={pid: types.SimpleNamespace(gen=gen(pid), first_step_done=True, trace_attr=None) for pid in (3, 5, 8)},
        dispatches=0, _step_cursor=0)
    for _ in range(4):
        assert runtime.SweepService._step_actives(svc, time.monotonic())
    assert order == [3, 5, 8, 3] and svc.dispatches == 4
    order.clear()
    runtime.SweepService._step_actives(svc, time.monotonic() + 60.0)
    assert order == [5, 8, 3]
    order.clear()
    runtime.SweepService._step_actives(svc)
    assert order == [3, 5, 8] and svc.dispatches == 10


# -- the failover drill on two replica children ----------------------------------


def test_failover_drill_on_two_children_is_bit_identical(tmp_path):
    """fabric_drill.run_failover_phase at the JAX drill's sizes on the CPU:
    replica 1 SIGKILLed with work settled and placed, replica 0 adopts at
    the next epoch, nothing lost, every compared trial (the re-homed ones
    among them) bit-identical to the undisturbed reference, the traces
    complete across both epochs. Every wait inside is bounded."""
    rep = fabric_drill.run_failover_phase(str(tmp_path), device="cpu", timeout_s=240.0)
    assert rep["kill_exercised"], rep["killed_at"]
    assert rep["replica_exits"][1] == -signal.SIGKILL and rep["replica_exits"][0] == 0
    assert rep["zero_lost"] and rep["completed"] == rep["submissions"] == 12
    assert rep["adoption_evident"] and rep["shard1_lease_claims"][-1][1] == 0
    assert rep["rehomed_count"] >= 1
    par = rep["parity"]
    assert par["ok"] and par["compared"] == 12 and par["held_bitwise"] == 12 and par["rehomed_compared"] >= 1
    assert rep["trace"]["completeness"]["complete"] and rep["trace"]["rehomed_cross_epoch"]
    assert rep["survivor"]["fences_lost"] == 0 and rep["survivor"]["adoptions"] == 2
    assert rep["detect_to_adopt_s"] is not None and rep["detect_to_adopt_s"] > rep["lease_deadline_s"]
    assert set(rep["longest_turn_s"]) == {0, 1} and rep["lease_deadline_s"] == 2.0
    assert [b["device"] for b in rep["boots"]] == [["cpu"], ["cpu"]]
    # The survivor's own counts: a child on the CPU launches no kernel; its
    # ledgers record the steps a card run's launches are held to.
    assert rep["survivor_launches"]["elbo_fwd"] == 0
    steps = rep["survivor_steps"]
    assert steps["single"] > 0 and steps["bucket"] > 0


def test_daemon_lost_chaos_drill(tmp_path):
    """fabric_drill.run_fabric_chaos on the CPU: the victim's own injector
    SIGKILLs it on its dispatch clock after the fsync'd fired record; the
    survivor adopts its shard and settles every submission."""
    rep = fabric_drill.run_fabric_chaos(str(tmp_path), device="cpu", timeout_s=240.0)
    assert rep["victim_sigkilled"] and rep["fault_fired"] and rep["fired_records"][0]["host"] == 1
    assert rep["zero_lost"] and rep["completed"] == rep["submissions"] == 10
    assert rep["survivor_claimed_victims_shard"] and rep["ok"]


def test_fabric_drill_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fabric_drill.run_failover_phase(str(tmp_path / "drill"))
    assert not os.path.exists(tmp_path / "drill")
    assert fabric_drill.NOT_PORTED == {"movable_pipelined": "A.14"}
    for run in (fabric_drill.run_split_chaos, fabric_drill.run_steal_phase, fabric_drill.run_movable_phase):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(str(tmp_path / "drill"))
