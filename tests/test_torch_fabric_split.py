"""The fabric's splits and steals (service/{runtime,fabric,fabric_drill}.py)
against the JAX package's on the same inputs, on the CPU: the cross-shard
transfer ``extract_queued``, a replica's split, the adopter's recovery of a
split killed halfway (commit or abort), the adopter's recovery of a steal
grant that never ran, the ``shard_split_lost`` fault, the CLI's split and
steal flags, the release of a moved trial's farm program, and the drills:
split chaos on two replica children, a certain steal in process, and the
movable drill's stacked arm."""

from __future__ import annotations

import json
import os
import shutil
import signal
import time

import pytest

from multidisttorch_tpu.service import fabric as jfabric
from multidisttorch_tpu.service import queue as jqueue
from multidisttorch_tpu.service import runtime as jruntime
from multidisttorch_tpu.service import topology as jtopo
from multidisttorch_tpu_torch.service import fabric, fabric_drill
from multidisttorch_tpu_torch.service import queue as squeue
from multidisttorch_tpu_torch.service import runtime as pruntime
from multidisttorch_tpu_torch.service import topology as stopo

pytestmark = pytest.mark.fabric

CFG = {"epochs": 1, "batch_size": 32, "latent_dim": 4, "hidden_dim": 16, "log_interval": 1000}
PACKAGES = {"port": (fabric, squeue, pruntime, stopo), "jax": (jfabric, jqueue, jruntime, jtopo)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: stacked and unstacked products sum in the same
    # order (the CPU's bitwise stacking contract).
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(tmp_path, subs) -> list[dict]:
    """One set of submission records (ids, submit times, trace ids), made
    once: spooled into both packages' directories, their ids order both
    schedulers alike."""
    d = str(tmp_path / "records")
    client = squeue.SweepClient(d)
    ids = [client.submit({**CFG, **cfg}, tenant=tenant) for tenant, cfg in subs]
    with_ids = []
    for sid in ids:
        with open(os.path.join(squeue.intake_dir(d), sid + ".json")) as f:
            with_ids.append(json.load(f))
    shutil.rmtree(d)
    return with_ids


def _spool(qmod, shard_dir: str, records) -> None:
    for rec in records:
        qmod.spool_submission(shard_dir, qmod.Submission.from_dict(rec))


def _admit_all(svc) -> None:
    """The intake, journaled and admitted, with nothing placed."""
    for sub in svc.queue.drain_intake(known_ids=svc._known_ids):
        svc._admit(sub)


def _service(name: str, d: str, **kw):
    _, _, rmod, _ = PACKAGES[name]
    kw = {"n_slices": 1, "max_lanes": 1, "data_rows": 64, "verbose": False, **kw}
    if name == "port":
        kw["device"] = "cpu"
    return rmod.SweepService(d, **kw)


def _close(svc) -> None:
    close = getattr(svc, "close", None)
    if close is not None:
        close()
    else:
        svc.store.shutdown()


def _no_ts(recs) -> list:
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def _intake(d: str) -> dict:
    out = {}
    try:
        names = sorted(os.listdir(squeue.intake_dir(d)))
    except OSError:
        return out
    for n in names:
        if n.endswith(".json"):
            with open(os.path.join(squeue.intake_dir(d), n)) as f:
                out[n[:-5]] = json.load(f)
    return out


def _moved_records(qmod, d: str) -> list:
    return _no_ts([r for r in qmod.load_queue(d) if r.get("event") == "moved"])


def _topology_story(tmod, d: str) -> list:
    return [(e.get("event"), e.get("parent"), e.get("child"), e.get("epoch")) for e in tmod.load_topology_events(d)]


# -- the transfer primitive ---------------------------------------------------------


def test_extract_queued_equals_the_jax_transfer(tmp_path):
    """Both services over the same journal and queue, the same predicate:
    the same moved ids, the destination's spooled submissions field by
    field, and the source journal's ``moved`` records; ever-placed
    (``resume_scan``) and pinned entries never move."""
    records = _records(tmp_path, [(f"t{i % 3}", {"seed": i}) for i in range(6)])
    out = {}
    for name, (_, qmod, _, _) in PACKAGES.items():
        src, dest = str(tmp_path / name / "src"), str(tmp_path / name / "dest")
        _spool(qmod, src, records)
        svc = _service(name, src)
        try:
            _admit_all(svc)
            pending = svc.sched.pending_entries()
            pending[0].resume_scan = True  # ever placed: its checkpoints live here
            pending[1].pinned_start = 0  # a relocation target
            keep = {pending[0].sub_id, pending[1].sub_id}
            moved = svc.extract_queued(lambda e: True, dest_dir=dest, dest_shard=3,
                                       from_shard=1, kind=fabric.MOVE_STEAL)
            assert not keep & set(moved)
            assert {e.sub_id for e in svc.sched.pending_entries()} == keep
            assert not any(svc.entries[t].sub_id in moved for t in svc.entries)
        finally:
            _close(svc)
        out[name] = {"moved": moved, "spooled": _intake(dest), "journal": _moved_records(qmod, src)}
    assert out["port"] == out["jax"]
    assert len(out["port"]["moved"]) == 4
    for sid in out["port"]["moved"]:
        rec = out["port"]["spooled"][sid]
        assert rec["moved_from"] == 1 and rec["moved_kind"] == "steal"
    assert [r["to_shard"] for r in out["port"]["journal"]] == [3] * 4


def test_extract_queued_rerun_after_a_crash_moves_nothing_twice(tmp_path):
    """A crash between a spool write and its journal record (the second
    entry's ``moved`` append raises), then the adopter's recovery runs the
    transfer again: every submission lands once at the destination, none is
    lost, and a third pass moves nothing."""
    records = _records(tmp_path, [("t", {"seed": i}) for i in range(4)])
    src, dest = str(tmp_path / "src"), str(tmp_path / "dest")
    _spool(squeue, src, records)
    svc = _service("port", src)
    appended = []
    real = svc.queue.moved

    def moved(sub_id, **kw):
        if len(appended) == 1:
            raise RuntimeError("killed between the spool write and the journal record")
        appended.append(sub_id)
        return real(sub_id, **kw)

    svc.queue.moved = moved
    move = dict(dest_dir=dest, dest_shard=2, from_shard=1, kind=fabric.MOVE_SPLIT)
    try:
        _admit_all(svc)
        with pytest.raises(RuntimeError, match="killed"):
            svc.extract_queued(lambda e: True, **move)
    finally:
        svc.store.shutdown(wait=True)
    assert len(_intake(dest)) == 2  # the second one spooled, unjournaled
    svc = _service("port", src)  # the adopter: the journal's replay
    try:
        assert len(svc.sched.pending_entries()) == 3
        again = svc.extract_queued(lambda e: True, **move)
        assert len(again) == 3 and appended[0] not in again
        assert svc.extract_queued(lambda e: True, **move) == []
    finally:
        _close(svc)
    assert sorted(_intake(dest)) == sorted(r["submission_id"] for r in records)
    folded = squeue.fold_queue(squeue.load_queue(src))
    assert all(r["state"] == squeue.MOVED for r in folded.values())
    # The destination's intake dedups a replayed spool: each id journaled once.
    dsvc = _service("port", dest)
    try:
        _admit_all(dsvc)
        assert sorted(e.sub_id for e in dsvc.sched.pending_entries()) == sorted(r["submission_id"] for r in records)
    finally:
        _close(dsvc)


def test_extract_queued_releases_the_moved_trials_farm_program(tmp_path):
    """With the precapture farm on, each admitted trial's program is planned
    at admission and captured into a registry slot. A moved trial's slot is
    freed from the registry unless a trial still queued here planned the
    same program."""
    from multidisttorch_tpu_torch.compile.registry import get_executable_registry

    reg = get_executable_registry()
    reg.reset()
    records = _records(tmp_path, [("t", {"seed": 0, "lr": 1e-3}), ("t", {"seed": 1, "lr": 1e-3}),
                                  ("t", {"seed": 2, "lr": 2e-3})])
    src = str(tmp_path / "src")
    _spool(squeue, src, records)
    svc = _service("port", src, precompile=True)
    try:
        _admit_all(svc)
        assert svc._farm.drain(timeout_s=60)
        keys = dict(svc._warm_keys)
        assert len(keys) == 3 and len(set(keys.values())) == 2
        assert all(reg.status(k) == "ready" for k in keys.values())
        by_sub = {e.sub_id: e.trial_id for e in svc.sched.pending_entries()}
        lone = next(s for s, t in by_sub.items() if list(keys.values()).count(keys[t]) == 1)
        shared = next(s for s in by_sub if s != lone)
        dest = str(tmp_path / "dest")
        move = dict(dest_dir=dest, dest_shard=1, from_shard=0, kind=fabric.MOVE_STEAL)
        assert sorted(svc.extract_queued(lambda e: e.sub_id in (lone, shared), **move)) == sorted((lone, shared))
        # The lone program went; the shared one stays for the trial still here.
        assert reg.status(keys[by_sub[lone]]) is None
        assert reg.status(keys[by_sub[shared]]) == "ready"
        assert set(svc._warm_keys) == set(by_sub.values()) - {by_sub[lone], by_sub[shared]}
    finally:
        _close(svc)
        reg.reset()


# -- a split ------------------------------------------------------------------------


def _replica(name: str, d: str, replica: int, **kw):
    fmod = PACKAGES[name][0]
    kw = {"n_shards": 2, "lease_deadline_s": 60.0, "nonpreferred_grace_s": 1e9, "n_slices": 1, "max_lanes": 1,
          "data_rows": 64, "verbose": False, **kw}
    if name == "port":
        kw["device"] = "cpu"
    return fmod.FabricReplica(d, replica=replica, **kw)


def test_a_split_equals_the_jax_split(tmp_path):
    """One replica owning the backlogged shard, the same submissions, ticks
    driven by the test (the split interval 0): the same topology story
    (event, parent, child, epoch), the same ids moved to the child, the child
    adopted by the splitting replica at once. Then the port's replica runs
    everything: every submission settles, none owned twice."""
    gives, keeps = fabric_drill._pick_split_tenants(1, 4, 2)
    records = _records(tmp_path, [(t, {"seed": i}) for i, t in enumerate(gives + keeps)])
    out = {}
    replicas = {}
    for name in PACKAGES:
        fmod, qmod, _, tmod = PACKAGES[name]
        d = str(tmp_path / name)
        fmod.ensure_fabric_config(d, 2)
        _spool(qmod, fmod.shard_dir(d, 1), records)
        r = replicas[name] = _replica(name, d, 1, split_queue_depth=4, split_min_interval_s=0.0)
        now = time.time()
        r._scan_orphans(now)
        assert list(r.services) == [1]
        _admit_all(r.services[1])
        r._maybe_split(now)
        out[name] = {
            "story": _topology_story(tmod, d),
            "moved": sorted(rec["submission_id"] for rec in _moved_records(qmod, fmod.shard_dir(d, 1))),
            "child_intake": sorted(_intake(fmod.shard_dir(d, 2))),
            "services": sorted(r.services),
            "splits": r.splits,
        }
        if name == "jax":
            r.drain(reason="test end")
    assert out["port"] == out["jax"]
    assert out["port"]["story"] == [("split_begin", 1, 2, 1), ("split_commit", 1, 2, 2)]
    assert out["port"]["services"] == [1, 2] and out["port"]["splits"] == 1
    assert sorted(out["port"]["moved"]) == sorted(rec["submission_id"] for rec in records
                                                  if rec["tenant"] in gives)
    # The port's replica finishes the work on both shards.
    r = replicas["port"]
    r.split_queue_depth = None  # one split is the case
    d = str(tmp_path / "port")
    client = fabric.FabricClient(d)
    ids = [rec["submission_id"] for rec in records]
    try:
        t0 = time.time()
        while time.time() - t0 < 120:
            r.tick()
            final = client.wait(ids, timeout_s=0.0, poll_s=0.0)
            if all(v["state"] == squeue.SETTLED for v in final.values()):
                break
        assert all(v.get("status") == "completed" for v in final.values()), final
        owners = {}
        for k in stopo.load_topology(d, n_base=2).live_shards():
            for sid, rec in squeue.fold_queue(squeue.load_queue(fabric.shard_dir(d, k))).items():
                if not fabric.FabricClient._superseded(rec):
                    owners.setdefault(sid, []).append(k)
        assert sorted(owners) == sorted(ids) and all(len(v) == 1 for v in owners.values())
        assert {owners[s][0] for s in out["port"]["moved"]} == {2}
    finally:
        r.drain(reason="test end")


class _Killed(Exception):
    """The SIGKILL of a replica mid-split, in process."""


def _half_split(tmp_path, *, moved_before_kill: int, gives: int = 4, keeps: int = 2) -> str:
    """A replica killed mid-split, written by the port: ``split_begin`` in the
    topology, ``moved_before_kill`` handoff records in the parent's journal
    (and their spool files in the child's intake), plus one give-half
    submission spooled to the child but not journaled (the crash fell
    between the two). Shard 1's lease is left to go stale."""
    g, k = fabric_drill._pick_split_tenants(1, gives, keeps)
    records = _records(tmp_path, [(t, {"seed": i}) for i, t in enumerate(g + k)])
    d = str(tmp_path / "seam")
    fabric.ensure_fabric_config(d, 2)
    fence = fabric.try_claim(d, 1, replica=1)
    sd = fabric.shard_dir(d, 1)
    _spool(squeue, sd, records)
    svc = _service("port", sd, fence=fence.check, fence_epoch=fence.epoch)
    try:
        _admit_all(svc)
        won, _, topo = stopo.append_topology_event(d, {"event": stopo.SPLIT_BEGIN, "parent": 1, "child": 2,
                                                       "replica": 1})
        assert won
        if moved_before_kill:
            _keep, give = topo.split_halves(1, 2)
            n = []

            def on_moved(_sid):
                n.append(_sid)
                if len(n) == moved_before_kill:
                    raise _Killed

            with pytest.raises(_Killed):
                svc.extract_queued(lambda e: give.matches(stopo.tenant_hash(e.tenant), 2),
                                   dest_dir=fabric.shard_dir(d, 2), dest_shard=2, from_shard=1,
                                   kind=fabric.MOVE_SPLIT, on_moved=on_moved)
            unjournaled = next(e for e in svc.sched.pending_entries() if e.tenant in g)
            rec = next(r for r in records if r["submission_id"] == unjournaled.sub_id)
            squeue.spool_submission(fabric.shard_dir(d, 2), squeue.Submission.from_dict(
                {**rec, "moved_from": 1, "moved_kind": "split"}))
    finally:
        svc.store.shutdown(wait=True)
    return d


def _adopt_copies(tmp_path, d: str, **kw) -> dict:
    """Each package's replica 0 adopts a copy of ``d`` (its home shard and the
    dead replica's stale shard 1). Returns each copy's evidence."""
    out = {}
    time.sleep(0.15)
    for name in PACKAGES:
        fmod, qmod, _, tmod = PACKAGES[name]
        c = str(tmp_path / f"copy-{name}")
        shutil.copytree(d, c)
        r = _replica(name, c, 0, lease_deadline_s=0.1, nonpreferred_grace_s=0.0, **kw)
        try:
            r._scan_orphans(time.time())
            child = fmod.shard_dir(c, 2)
            intake = sorted(_intake(child))
            if 2 in r.services:
                _admit_all(r.services[2])
            out[name] = {
                "story": _topology_story(tmod, c),
                "moved": sorted(rec["submission_id"] for rec in _moved_records(qmod, fmod.shard_dir(c, 1))),
                "child_intake": intake,
                "child_journal": sorted((sid, rec["state"]) for sid, rec in
                                        qmod.fold_queue(qmod.load_queue(child)).items()),
                "services": sorted(r.services),
                "next_shard": tmod.load_topology(c, n_base=2).next_shard_id(),
                "steals_granted": r.steals_granted,
                "thief_intake": sorted(_intake(fmod.shard_dir(c, 0))),
            }
            if kw.get("steal_threshold") is not None:
                r._recover_steal_grants(1)  # a second pass: nothing more
                out[name]["steals_after_rerun"] = r.steals_granted
        finally:
            r.drain(reason="test end")
    return out


def test_a_split_killed_halfway_is_committed_by_the_adopter(tmp_path):
    """The seam: the adopter finds the pending split, the moved records and
    the spool files, re-runs the transfer and commits; both packages write
    the same commit, move the same set, and the child's journal holds every
    give-half submission once."""
    d = _half_split(tmp_path, moved_before_kill=2)
    out = _adopt_copies(tmp_path, d)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["story"] == [("split_begin", 1, 2, 1), ("split_commit", 1, 2, 2)]
    assert len(port["moved"]) == 4 and port["child_intake"] == port["moved"]
    assert port["child_journal"] == [(sid, squeue.ADMITTED) for sid in port["moved"]]
    assert port["services"] == [0, 1, 2]


def test_a_split_that_moved_nothing_aborts_and_burns_its_child(tmp_path):
    """A split killed before its first handoff record, with no give-half
    work queued: the adopter rolls it back with ``split_abort`` in both
    packages, and the next split takes a fresh child id."""
    d = _half_split(tmp_path, moved_before_kill=0, gives=0, keeps=3)
    out = _adopt_copies(tmp_path, d)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["story"] == [("split_begin", 1, 2, 1), ("split_abort", 1, 2, 2)]
    assert port["moved"] == [] and port["services"] == [0, 1] and port["next_shard"] == 3


# -- steals ---------------------------------------------------------------------


def test_a_steal_grant_that_never_ran_is_carried_out_once_by_the_adopter(tmp_path):
    """A victim killed between its grant and the transfer: the adopter moves
    exactly the named ids that are still queued to the thief's intake, in
    both packages, and a second recovery pass moves nothing."""
    records = _records(tmp_path, [(fabric_drill.TENANT_SHARD1, {"seed": i}) for i in range(4)])
    d = str(tmp_path / "steal")
    fabric.ensure_fabric_config(d, 2)
    fence = fabric.try_claim(d, 1, replica=1)
    sd = fabric.shard_dir(d, 1)
    _spool(squeue, sd, records)
    svc = _service("port", sd, fence=fence.check, fence_epoch=fence.epoch)
    try:
        _admit_all(svc)
        tail = [e.sub_id for e in svc.sched.pending_entries()][-2:]
    finally:
        svc.store.shutdown(wait=True)
    fabric._append_lease(fabric.steal_file(d, 1), {"kind": "request", "seq": "s1", "thief_shard": 0,
                                                   "thief_replica": 0, "max_n": 2, "ts": time.time()})
    fabric._append_lease(fabric.steal_file(d, 1), {"kind": "grant", "seq": "s1", "sub_ids": tail + ["gone"],
                                                   "thief_shard": 0, "thief_replica": 0, "epoch": 1,
                                                   "ts": time.time()})
    out = _adopt_copies(tmp_path, d, steal_threshold=3)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["moved"] == sorted(tail) == port["thief_intake"]
    assert port["steals_granted"] == port["steals_after_rerun"] == 2
    spooled = _intake(fabric.shard_dir(str(tmp_path / "copy-port"), 0))
    assert all(rec["tenant"] == fabric_drill.TENANT_SHARD1 and rec["moved_kind"] == "steal"
               for rec in spooled.values())


def test_a_steal_between_two_replicas_in_process(tmp_path):
    """fabric_drill.run_steal_phase on the CPU: one grant from the backlogged
    shard's queue tail, the stolen trial settled on the idle shard under its
    origin tenant, its farm program gone from the registry after the grant,
    every trial bit-identical to an undisturbed service."""
    from multidisttorch_tpu_torch.compile.registry import get_executable_registry

    get_executable_registry().reset()
    try:
        rep = fabric_drill.run_steal_phase(str(tmp_path), device="cpu")
    finally:
        get_executable_registry().reset()
    assert rep["ok"], rep
    assert len(rep["stolen"]) == 1 and rep["stolen_from_tail"] and rep["steals_granted"] == 1
    assert rep["settled_on_thief_under_origin_tenant"] and rep["moved_at_victim"]
    assert rep["stolen_program_after_grant"] == [None]
    assert set(rep["planned_programs"].values()) == {"ready"}
    par = rep["parity"]
    assert par["compared"] == par["held_bitwise"] == 4
    assert rep["steps"][1]["single"] > 0  # the thief trained the stolen trial


# -- the fault and the CLI --------------------------------------------------------------


def test_shard_split_lost_fires_on_the_handoff_clock_as_the_jax_injector(tmp_path, monkeypatch):
    """The same plan in both packages: the third handoff record's tick
    writes the fired record (fsync'd) and then sends SIGKILL; the dispatch
    clock never fires it."""
    from multidisttorch_tpu.faults import inject as jinject
    from multidisttorch_tpu.faults import plan as jplan
    from multidisttorch_tpu_torch.faults import inject as pinject
    from multidisttorch_tpu_torch.faults import plan as pplan

    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    fired = {}
    for name, (imod, pmod) in {"port": (pinject, pplan), "jax": (jinject, jplan)}.items():
        plan = pmod.FaultPlan(specs=(pmod.FaultSpec(pmod.SHARD_SPLIT_LOST, trial_id=-1, step=2, host=1),), seed=0)
        log = str(tmp_path / f"{name}.jsonl")
        inj = imod.FaultInjector(plan, host_slot=1, fired_log=log)
        inj.host_step(50)
        assert not kills
        inj.split_step(1)
        inj.split_step(1)
        assert not kills
        inj.split_step(1)
        assert kills == [signal.SIGKILL]
        kills.clear()
        with open(log) as f:
            fired[name] = [{k: v for k, v in json.loads(ln).items() if k != "ts"} for ln in f]
    assert fired["port"] == fired["jax"] == [{"spec_index": 0, "kind": "shard_split_lost", "trial_id": -1,
                                              "step": 2, "host": 1}]


def test_the_cli_passes_the_split_and_steal_flags_on(tmp_path, monkeypatch):
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.examples import sweep_service

    seen = {}

    class Replica:
        _stop = False

        def __init__(self, service_dir, **kw):
            seen.update(kw)

        def _warm_backend(self):
            pass

        def serve(self, **kw):
            return {"outcome": "idle", "settled": {}}

    monkeypatch.setattr(fabric, "FabricReplica", Replica)
    try:
        rc = sweep_service.main([str(tmp_path / "f"), "--fabric", "--device", "cpu", "--replica", "1",
                                 "--split-queue-depth", "4", "--split-min-interval", "0.25",
                                 "--steal-threshold", "6", "--steal-batch", "3"])
    finally:
        telemetry.disable()
    assert rc == 0
    assert {k: seen[k] for k in ("split_queue_depth", "split_min_interval_s", "steal_threshold", "steal_batch")} == {
        "split_queue_depth": 4, "split_min_interval_s": 0.25, "steal_threshold": 6, "steal_batch": 3}
    # The turn budget: a quarter of the lease deadline unless set; 0 is off.
    assert seen["turn_budget_s"] == 1.0
    # The defaults: splits and steals off, the JAX CLI's interval and batch.
    args = sweep_service.build_parser().parse_args([str(tmp_path / "g"), "--fabric"])
    assert (args.split_queue_depth, args.split_min_interval, args.steal_threshold, args.steal_batch) == (
        None, 2.0, None, 2)
    assert sweep_service.build_parser().parse_args([str(tmp_path / "g"), "--turn-budget", "0"]).turn_budget == 0.0


# -- the drills -------------------------------------------------------------------------


def test_split_chaos_drill_on_two_children(tmp_path):
    """fabric_drill.run_split_chaos on the CPU: the victim SIGKILLed on its
    split-handoff clock after the fired record, the survivor adopts and
    closes the seam; every JAX gate, and every trial bit-identical to the
    undisturbed reference over every live shard."""
    rep = fabric_drill.run_split_chaos(str(tmp_path), device="cpu", timeout_s=240.0)
    assert rep["ok"], {k: rep[k] for k in ("victim_exit", "lost_submissions", "double_owned", "unowned",
                                           "topology", "moved_split_records")}
    assert rep["split_kill_exercised"] and rep["fired_records"][0]["step"] == 2
    assert rep["zero_lost"] and rep["no_double_own"] and rep["completed"] == rep["submissions"] == 10
    topo = rep["topology"]
    assert topo["split_begun"] and topo["seam_closed"] and (topo["committed"] or topo["aborted"])
    assert rep["moved_split_records"] >= 1 and rep["survivor_exit"] == 0
    par = rep["parity"]
    assert par["ok"] and par["compared"] == par["held_bitwise"] == 10
    assert set(rep["longest_turn_s"]) == {0, 1}
    assert rep["survivor_steps"]["single"] > 0


def test_movable_drill_stacked_arm_is_bit_identical(tmp_path):
    rep = fabric_drill.run_movable_phase(str(tmp_path), device="cpu")
    st = rep["stacked"]
    assert st["evicted"] and st["requeued"] == 2 and st["all_completed"]
    assert st["bit_identical"] and not st["mismatched"] and rep["ok"]
    assert "lanes2" in st["routes"] and st["reference_routes"] == ["lanes2"]
    assert rep["pipelined"] == {"not_ported": "A.14"}
    assert fabric_drill.NOT_PORTED["movable_pipelined"] == "A.14"
