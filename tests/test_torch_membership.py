"""The port's sideband membership (``parallel/membership.py``) against the
JAX package's: the same lease and world files, read alike by both.

A lease the port wrote gets the same verdict from the JAX package's
``MembershipView.lost_hosts`` as from the port's, and the other way round;
torn tails, a suspended heartbeat and the world history behave alike. No
device and no process group: membership is plain files.
"""

import json
import os
import time

import pytest

from multidisttorch_tpu.parallel import membership as jm
from multidisttorch_tpu_torch import telemetry
from multidisttorch_tpu_torch.parallel import membership as pm

PACKAGES = {"port": pm, "jax": jm}


def _write(mod, run_dir: str, slot: int, ts: float, status: str = "alive") -> None:
    path = mod.lease_path(run_dir, slot)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"slot": slot, "ts": ts, "status": status}) + "\n")


def test_module_constants_and_paths_match():
    for name in ("MEMBERSHIP_DIRNAME", "LEASE_PREFIX", "WORLDS_NAME", "ALIVE", "DRAINING", "LEFT"):
        assert getattr(pm, name) == getattr(jm, name), name
    assert pm.lease_path("/r", 7) == jm.lease_path("/r", 7)
    assert pm.membership_dir("/r") == jm.membership_dir("/r")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_heartbeat_lease_read_by_the_other_package(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    hb = w.Heartbeat(str(tmp_path), 3, interval_s=0.02, world_epoch=1, world_size=2).start()
    time.sleep(0.15)
    hb.stop()
    path = w.lease_path(str(tmp_path), 3)
    recs = r.read_lease(path)
    assert recs == w.read_lease(path)
    assert len(recs) >= 3 and recs[0]["status"] == "alive" and recs[-1]["status"] == "left"
    assert all(x["slot"] == 3 and x["world_epoch"] == 1 and x["world_size"] == 2 for x in recs)
    assert [x["seq"] for x in recs] == sorted(x["seq"] for x in recs)
    # The same fields and encoding as the other package's writer.
    assert set(recs[0]) == {"slot", "pid", "hostname", "ts", "mono", "seq", "status", "world_epoch", "world_size"}
    assert r.latest_lease(path) == w.latest_lease(path) == recs[-1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lost_hosts_same_verdict_in_both_packages(tmp_path, writer):
    now = time.time()
    w = PACKAGES[writer]
    _write(w, str(tmp_path), 0, now)  # fresh
    _write(w, str(tmp_path), 1, now - 10.0)  # stale: lost
    _write(w, str(tmp_path), 2, now - 10.0, status="left")  # a clean departure
    _write(w, str(tmp_path), 3, now - 10.0)
    _write(w, str(tmp_path), 3, now - 0.5)  # beat again: alive
    verdicts = {}
    for name, mod in PACKAGES.items():
        view = mod.MembershipView(str(tmp_path))
        verdicts[name] = (view.lost_hosts(3.0, now=now), view.lost_hosts(3.0, now=now, among=[0, 2, 3]),
                          sorted(view.hosts()), view.slots())
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"] == ([1], [], [0, 1, 2, 3], [0, 1, 2, 3])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torn_tail_skipped_alike(tmp_path, writer):
    path = PACKAGES[writer].lease_path(str(tmp_path), 0)
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        f.write(json.dumps({"slot": 0, "ts": 1.0, "status": "alive"}) + "\n")
        f.write('{"slot": 0, "ts": 2.0, "stat')  # torn mid-append
    for mod in PACKAGES.values():
        recs = mod.read_lease(path)
        assert len(recs) == 1 and recs[0]["ts"] == 1.0
        assert mod.latest_lease(path)["ts"] == 1.0


def test_latest_lease_reads_the_tail_only(tmp_path):
    path = pm.lease_path(str(tmp_path), 0)
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        for i in range(2000):
            f.write(json.dumps({"slot": 0, "ts": float(i), "seq": i, "status": "alive"}) + "\n")
    assert pm.latest_lease(path, tail_bytes=256)["seq"] == 1999
    assert pm.latest_lease(path, tail_bytes=256) == jm.latest_lease(path, tail_bytes=256)
    assert pm.latest_lease(str(tmp_path / "absent.jsonl")) is None


def test_suspended_heartbeat_goes_stale(tmp_path):
    pm.start_heartbeat(str(tmp_path), 0, interval_s=0.02)
    try:
        assert pm.current_heartbeat() is not None
        time.sleep(0.1)
        assert pm.suspend_heartbeat()
        rec = pm.latest_lease(pm.lease_path(str(tmp_path), 0))
        time.sleep(0.15)
        rec2 = pm.latest_lease(pm.lease_path(str(tmp_path), 0))
        assert rec2["seq"] == rec["seq"]  # no new beats: the lease ages
        # The JAX package's view declares it lost once the deadline passes.
        assert jm.MembershipView(str(tmp_path)).lost_hosts(0.1) == [0]
        pm.current_heartbeat().resume()
        time.sleep(0.1)
        assert pm.latest_lease(pm.lease_path(str(tmp_path), 0))["seq"] > rec2["seq"]
    finally:
        pm.stop_heartbeat()
    assert pm.current_heartbeat() is None and not pm.suspend_heartbeat()
    assert pm.latest_lease(pm.lease_path(str(tmp_path), 0))["status"] == "left"


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_world_history_round_trips_across_packages(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    w.record_world(str(tmp_path), epoch=0, hosts=[2, 0, 1])
    w.record_world(str(tmp_path), epoch=1, hosts=[0, 2], lost=[1], reason="host_lost")
    hist = r.world_history(str(tmp_path))
    assert hist == w.world_history(str(tmp_path))
    assert [h["epoch"] for h in hist] == [0, 1]
    assert hist[0]["hosts"] == [0, 1, 2] and hist[0]["lost"] == [] and hist[0]["reason"] == ""
    assert hist[1]["lost"] == [1] and hist[1]["hosts"] == [0, 2] and hist[1]["reason"] == "host_lost"
    assert set(hist[1]) == {"epoch", "hosts", "lost", "reason", "ts"}


def test_membership_events_ride_the_port_bus(tmp_path):
    now = time.time()
    _write(pm, str(tmp_path / "run"), 1, now - 10.0)
    with telemetry.telemetry_run(str(tmp_path / "tel")) as bus:
        view = pm.MembershipView(str(tmp_path / "run"))
        # host_lost fires on the transition only, not once per poll.
        assert view.lost_hosts(3.0, now=now) == [1]
        assert view.lost_hosts(3.0, now=now) == [1]
        pm.record_world(str(tmp_path / "run"), epoch=1, hosts=[0], lost=[1], reason="host_lost")
        kinds = [e.kind for e in bus.recent()]
    # The lost host opens a replica_lost incident (the incident plane's
    # event, between the two).
    assert kinds == ["host_lost", "incident", "world_shrunk"]
    events = telemetry.read_events(str(tmp_path / "tel" / telemetry.EVENTS_NAME))
    assert events[0]["data"]["slot"] == 1 and events[0]["data"]["stale_s"] == pytest.approx(10.0, abs=0.01)
    assert events[1]["data"]["incident_kind"] == "replica_lost" and events[1]["data"]["subject"] == "host:1"
    assert events[2]["data"] == {"epoch": 1, "hosts": [0], "lost": [1], "reason": "host_lost"}
