"""The incident plane: the port's detector, ledger, flight ring, bundles,
autopsy, CLI and console panel against the JAX package's, and the port's
incident drill against the JAX drill's scenarios.

Every test of ``tests/test_incidents.py`` has a counterpart here, on the
same inputs and with the same assertions on the port. Where a detector
runs, both packages' detectors take the same event stream, and their
incident ledgers must agree record for record (ids, kinds, subjects,
states, counts, detail and evidence), timestamps and hosts aside; the
incidents each call returns must agree too. The comparison is exact: the
ledgers are the same rules' JSON over the same inputs, so no tolerance
applies. The consoles' text and ``--json`` equal the JAX tools' (loaded by
path) on the same directory, with the clock held still.

The drill: the eight scenarios that need no fabric and the soak, run with
``device="cpu"`` through the port's drill and through the JAX drill's
scenario functions: the same fault -> verdict matrix, the same incidents
(subjects with the scope directory aside), bundles present, and the
port's sweeps' train steps equal to the ELBO calls they made.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from multidisttorch_tpu import telemetry as jax_tel
from multidisttorch_tpu.service import incident_drill as jax_drill
from multidisttorch_tpu.telemetry import incident as jinc
from multidisttorch_tpu_torch import telemetry
from multidisttorch_tpu_torch.service import incident_drill as drill
from multidisttorch_tpu_torch.telemetry import incident as tincident
from multidisttorch_tpu_torch.telemetry.events import get_bus
from multidisttorch_tpu_torch.telemetry.incident import (
    BACKEND_WEDGED,
    CKPT_INTEGRITY,
    DIVERGENCE_STORM,
    FENCE_LOST,
    HOST_PREEMPTED,
    KINDS,
    REPLICA_LOST,
    SLO_BURN,
    SPLIT_TORN,
    STEAL_ANOMALY,
    WEDGED_COLLECTIVE,
    IncidentDetector,
    detect_incidents,
    fold_incidents,
    load_incidents,
    read_incident_records,
    sweep_partial_bundles,
)

from test_torch_consoles import NOW, _both, _load_tool, _port_tool, _run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ASIDE = frozenset({"ts", "host", "first_ts", "last_ts", "resolved_ts"})


@pytest.fixture(autouse=True)
def _telemetry_off_after():
    """Every test leaves both packages' telemetry off."""
    yield
    telemetry.disable()
    jax_tel.disable()


def _ev(kind, ts=1000.0, trial_id=None, **data):
    ev = {"kind": kind, "ts": ts}
    if trial_id is not None:
        ev["trial_id"] = trial_id
    if data:
        ev["data"] = data
    return ev


def _bare(x, swap=()):
    """``x`` with timestamps and hosts left out at every depth, and each
    ``(old, new)`` of ``swap`` replaced in its strings."""
    if isinstance(x, dict):
        return {k: _bare(v, swap) for k, v in x.items() if k not in _ASIDE}
    if isinstance(x, (list, tuple)):
        return [_bare(v, swap) for v in x]
    if isinstance(x, str):
        for old, new in swap:
            x = x.replace(old, new)
    return x


def _ledger(d: str, swap=()):
    recs, torn = read_incident_records(os.path.join(d, tincident.INCIDENTS_NAME))
    return _bare(recs, swap), torn


def _same_ledgers(port_dir: str, jax_dir: str) -> None:
    swap = ((port_dir, "<dir>"), (jax_dir, "<dir>"))
    assert _ledger(port_dir, swap) == _ledger(jax_dir, swap)


class _Pair:
    """Both packages' detectors over the same calls, each with a ledger of
    its own under ``tmp_path``; every call's incident is compared."""

    def __init__(self, tmp_path, rings=None, **kw):
        self.dirs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
        rings = rings or {}
        self.port = IncidentDetector(self.dirs["port"], emit_events=False, ring=rings.get("port"), **kw)
        self.jax = jinc.IncidentDetector(self.dirs["jax"], emit_events=False, ring=rings.get("jax"), **kw)

    @staticmethod
    def _same(a, b):
        assert (a is None) == (b is None)
        if a is not None:
            assert _bare(a.to_dict()) == _bare(b.to_dict())
        return a

    def observe(self, ev):
        return self._same(self.port.observe(ev), self.jax.observe(ev))

    def resolve_subject(self, subject, **kw):
        return self._same(self.port.resolve_subject(subject, **kw), self.jax.resolve_subject(subject, **kw))

    def check(self) -> str:
        _same_ledgers(self.dirs["port"], self.dirs["jax"])
        assert (self.port.opened, self.port.absorbed) == (self.jax.opened, self.jax.absorbed)
        assert [_bare(i.to_dict()) for i in self.port.open_incidents()] == [
            _bare(i.to_dict()) for i in self.jax.open_incidents()]
        return self.dirs["port"]


def _detect(events, **kw) -> dict:
    """The port's offline detection, held to the JAX package's."""
    got = detect_incidents(events, **kw)
    assert _bare(got) == _bare(jinc.detect_incidents(events, **kw))
    return got


# -- taxonomy / classification rules ----------------------------------


def test_taxonomy_is_closed_and_complete():
    assert len(KINDS) == 10
    assert len(set(KINDS)) == 10
    assert KINDS == jinc.KINDS and tincident._RANK == jinc._RANK


@pytest.mark.parametrize(
    "ev,kind,subject",
    [
        (_ev("shard_fence_lost", shard=2, replica=0, reason="outbid"), FENCE_LOST, "shard:2"),
        (_ev("shard_adopted", shard=1, replica=3, epoch=2), REPLICA_LOST, "shard:1"),
        (_ev("host_lost", slot=4, stale_s=2.5, world_epoch=1), REPLICA_LOST, "host:4"),
        (_ev("shard_split_resolved", shard=0, child=2, replica=1, action="abort"), SPLIT_TORN, "shard:0"),
        (_ev("failure_classified", trial_id=7, failure_class="preemption", exc_type="WedgedCollective",
             error="wedged"), WEDGED_COLLECTIVE, "trial:7"),
        (_ev("failure_classified", trial_id=5, failure_class="preemption", exc_type="HostPreemption",
             error="preempted"), HOST_PREEMPTED, "trial:5"),
        (_ev("preflight_verdict", platform="tpu", verdict="wedged_init_timeout", reason="deadline", usable=False,
             elapsed_s=30.0), BACKEND_WEDGED, "backend:tpu"),
        (_ev("slo_alert", slo="queue_wait_p95_60s", label=None, state="firing", burn=4.0, compliance=0.5),
         SLO_BURN, "slo:queue_wait_p95_60s:None"),
        (_ev("ckpt_scan_reject", path="/runs/t0/ckpt.msgpack", reason="crc mismatch"), CKPT_INTEGRITY,
         "ckpt:/runs/t0"),
    ],
)
def test_single_event_rules(ev, kind, subject):
    folded = _detect([ev])
    assert len(folded) == 1
    (inc,) = folded.values()
    assert inc["kind"] == kind
    assert inc["subject"] == subject


def test_first_claim_is_not_an_incident():
    assert _detect([_ev("shard_adopted", shard=0, replica=0, epoch=1)]) == {}


def test_usable_preflight_is_not_an_incident():
    assert _detect([_ev("preflight_verdict", platform="cpu", verdict="healthy", usable=True, elapsed_s=1.0)]) == {}


def test_divergence_storm_needs_distinct_trials_in_window():
    def diverge(tid, ts):
        return _ev("failure_classified", ts=ts, trial_id=tid, failure_class="divergence",
                   exc_type="DivergenceError", error="nan")

    # Same trial three times: attrition, not a storm.
    assert _detect([diverge(0, 1000.0 + i) for i in range(3)]) == {}
    # Three distinct trials inside the window: one storm incident.
    folded = _detect([diverge(t, 1000.0 + t) for t in range(3)])
    assert len(folded) == 1
    (inc,) = folded.values()
    assert inc["kind"] == DIVERGENCE_STORM
    assert inc["subject"] == "sweep"
    # Spread past the window: never accumulates.
    assert _detect([diverge(t, 1000.0 + 500.0 * t) for t in range(3)], storm_window_s=120.0) == {}


def test_steal_anomaly_duplicate_grant_and_ungranted_execute():
    dup = _detect([
        _ev("steal_grant", ts=1.0, victim_shard=0, thief_shard=1, seq=7, n=2),
        _ev("steal_grant", ts=2.0, victim_shard=0, thief_shard=1, seq=7, n=2),
    ])
    assert [i["kind"] for i in dup.values()] == [STEAL_ANOMALY]
    (inc,) = dup.values()
    assert inc["detail"]["why"] == "duplicate_grant"

    ungranted = _detect([_ev("steal_executed", ts=1.0, victim_shard=3, thief_shard=4, sub_ids=["s-1"])])
    (inc,) = ungranted.values()
    assert inc["kind"] == STEAL_ANOMALY
    assert inc["detail"]["why"] == "executed_without_grant"

    # The healthy protocol, grant then execute, is silent.
    assert _detect([
        _ev("steal_grant", ts=1.0, victim_shard=0, thief_shard=1, seq=1, n=1),
        _ev("steal_executed", ts=2.0, victim_shard=0, thief_shard=1, sub_ids=["s-1"]),
    ]) == {}


# -- correlation: dedup, escalation, flap reopen ----------------------


def test_takeover_chain_is_one_incident(tmp_path):
    """The fence-loss + adoption echo of ONE takeover lands in one
    incident, and the torn-split resolution ESCALATES it in place."""
    pair = _Pair(tmp_path)
    pair.observe(_ev("shard_fence_lost", ts=1.0, shard=0, replica=0, reason="lease expired"))
    pair.observe(_ev("shard_adopted", ts=2.0, shard=0, replica=1, epoch=2))
    pair.observe(_ev("shard_split_resolved", ts=3.0, shard=0, child=2, replica=1, action="abort"))
    d = pair.check()
    det = pair.port
    assert det.opened == 1
    (inc,) = det.open_incidents()
    assert inc.kind == SPLIT_TORN  # escalated from fence_lost
    assert inc.count == 3
    folded = load_incidents(d)
    assert folded[inc.id]["kind"] == SPLIT_TORN
    assert folded[inc.id]["count"] == 3
    recs, torn = read_incident_records(os.path.join(d, tincident.INCIDENTS_NAME))
    assert not torn
    assert [r["rec"] for r in recs] == ["open", "escalate"]


def test_lower_rank_absorbs_without_escalation(tmp_path):
    pair = _Pair(tmp_path)
    pair.observe(_ev("shard_fence_lost", ts=1.0, shard=0, replica=0, reason="outbid"))
    pair.observe(_ev("shard_adopted", ts=2.0, shard=0, replica=1, epoch=2))
    pair.check()
    (inc,) = pair.port.open_incidents()
    assert inc.kind == FENCE_LOST  # replica_lost ranks below
    assert inc.count == 2


def test_flapping_lease_reopens_one_incident(tmp_path):
    """resolve -> re-fire inside flap_window_s reopens the SAME id
    (flaps++) instead of minting a ledger flood."""
    pair = _Pair(tmp_path, flap_window_s=60.0)
    t = 1000.0
    first = pair.observe(_ev("shard_fence_lost", ts=t, shard=0, replica=0, reason="flap"))
    for i in range(1, 4):
        pair.resolve_subject("shard:0", ts=t + 10.0 * i, reason="lease re-won")
        again = pair.observe(_ev("shard_fence_lost", ts=t + 10.0 * i + 5.0, shard=0, replica=0, reason="flap"))
        assert again.id == first.id
        assert again.flaps == i
    assert pair.port.opened == 1
    d = pair.check()
    folded = load_incidents(d)
    assert list(folded) == [first.id]
    assert folded[first.id]["flaps"] == 3
    assert folded[first.id]["status"] == "open"
    # Past the flap window a fresh fire is a NEW incident.
    pair.resolve_subject("shard:0", ts=t + 100.0, reason="stable")
    fresh = pair.observe(_ev("shard_fence_lost", ts=t + 500.0, shard=0, replica=0, reason="new fault"))
    assert fresh.id != first.id
    pair.check()


def test_slo_resolve_event_resolves_subject(tmp_path):
    pair = _Pair(tmp_path)
    pair.observe(_ev("slo_alert", ts=1.0, slo="q", label=None, state="firing", burn=5.0))
    assert len(pair.port.open_incidents()) == 1
    pair.observe(_ev("slo_alert", ts=2.0, slo="q", label=None, state="resolved", burn=0.1))
    assert pair.port.open_incidents() == []
    (inc,) = load_incidents(pair.check()).values()
    assert inc["status"] == "resolved"


def test_quiet_resolve_auto_closes(tmp_path):
    pair = _Pair(tmp_path, quiet_resolve_s=30.0)
    pair.observe(_ev("shard_fence_lost", ts=1000.0, shard=0, replica=0, reason="outbid"))
    # Any later observation past the quiet window sweeps the stale one.
    pair.observe(_ev("epoch", ts=1100.0))
    assert pair.port.open_incidents() == []
    pair.check()


# -- durable ledger ---------------------------------------------------


def test_torn_tail_replay_and_heal(tmp_path):
    pair = _Pair(tmp_path)
    pair.observe(_ev("shard_fence_lost", ts=1.0, shard=0, replica=0, reason="outbid"))
    pair.observe(_ev("ckpt_scan_reject", ts=2.0, path="/r/t0/c.msgpack", reason="crc"))
    for d in pair.dirs.values():
        with open(os.path.join(d, tincident.INCIDENTS_NAME), "a") as f:
            f.write('{"rec": "open", "id": "inc-9999", "kind": "tru')
    path = os.path.join(pair.dirs["port"], tincident.INCIDENTS_NAME)
    # Reader: torn tail detected, whole lines intact.
    recs, torn = read_incident_records(path)
    assert torn
    assert len(recs) == 2
    assert "inc-9999" not in fold_incidents(recs)
    assert _bare(fold_incidents(recs)) == _bare(jinc.fold_incidents(recs))
    # A new session over the torn ledger heals the tail, resumes the id
    # sequence past every banked id, and appends cleanly.
    det2 = IncidentDetector(pair.dirs["port"], emit_events=False)
    jdet2 = jinc.IncidentDetector(pair.dirs["jax"], emit_events=False)
    assert det2.tail_repaired and jdet2.tail_repaired
    ev = _ev("host_lost", ts=3.0, slot=1, stale_s=9.0, world_epoch=0)
    inc = det2.observe(ev)
    assert _bare(inc.to_dict()) == _bare(jdet2.observe(ev).to_dict())
    assert int(inc.id.split("-")[1]) > 2
    # The repair newline-terminates the garbage (it stays countable as
    # exactly one torn line) so the new append is a FRESH whole line.
    recs2, torn2 = read_incident_records(path)
    assert torn2 == 1
    assert [r["rec"] for r in recs2] == ["open", "open", "open"]
    _same_ledgers(pair.dirs["port"], pair.dirs["jax"])


def test_counts_flushed_on_resolve(tmp_path):
    """Absorbs are memory-only (per-absorb appends would defeat the flood
    protection); the resolve record flushes the final count."""
    pair = _Pair(tmp_path)
    d = pair.dirs["port"]
    for i in range(5):
        pair.observe(_ev("shard_fence_lost", ts=1.0 + i, shard=0, replica=0, reason="outbid"))
    assert load_incidents(d)[pair.port.open_incidents()[0].id]["count"] == 1
    pair.resolve_subject("shard:0", ts=10.0, reason="done")
    (inc,) = load_incidents(d).values()
    assert inc["count"] == 5
    assert inc["status"] == "resolved"
    pair.check()


def test_id_sequence_never_recycled_across_sessions(tmp_path):
    pair = _Pair(tmp_path)
    a = pair.observe(_ev("shard_fence_lost", ts=1.0, shard=0, replica=0, reason="x"))
    pair2 = _Pair(tmp_path)
    b = pair2.observe(_ev("shard_fence_lost", ts=2.0, shard=1, replica=0, reason="x"))
    assert b.id != a.id
    assert int(b.id.split("-")[1]) == int(a.id.split("-")[1]) + 1
    pair2.check()


# -- bundles ----------------------------------------------------------


def test_bundle_published_atomically(tmp_path):
    rings = {"port": tincident.FlightRing(maxlen=8), "jax": jinc.FlightRing(maxlen=8)}
    for i in range(20):
        for ring in rings.values():
            ring.note({"kind": "epoch", "ts": float(i)})
    pair = _Pair(tmp_path, rings=rings)
    inc = pair.observe(_ev("shard_fence_lost", ts=30.0, shard=0, replica=0, reason="outbid"))
    pair.check()
    dumps = {}
    for name, d in pair.dirs.items():
        bdir = os.path.join(d, tincident.BUNDLE_DIRNAME, inc.id)
        assert os.path.isdir(bdir)
        assert not os.path.isdir(bdir + ".partial")
        with open(os.path.join(bdir, "flight_ring.json")) as f:
            dump = json.load(f)
        with open(os.path.join(bdir, "trigger.json")) as f:
            trig = json.load(f)
        dumps[name] = (dump, _bare(trig))
    assert dumps["port"] == dumps["jax"]
    dump, trig = dumps["port"]
    # Bounded black box: the ring held only the newest maxlen events but
    # counted everything it saw.
    assert len(dump["events"]) == 8
    assert dump["noted"] == 20
    assert trig["incident"]["id"] == inc.id
    assert trig["trigger_event"]["kind"] == "shard_fence_lost"


_KILL_CHILD = """
import sys
sys.path.insert(0, {repo!r})
from {pkg}.telemetry.incident import FlightRing, IncidentDetector
ring = FlightRing(maxlen=8)
ring.note({{"kind": "epoch", "ts": 0.5}})
det = IncidentDetector({d!r}, emit_events=False, ring=ring)
det.observe({{"kind": "shard_fence_lost", "ts": 1.0,
              "data": {{"shard": 0, "replica": 0, "reason": "outbid"}}}})
print("UNREACHABLE", flush=True)
"""


def _kill_mid_dump(d: str, pkg: str) -> str:
    """A child stalls inside the bundle dump and is SIGKILLed before the
    publish rename; the ``.partial`` bundle's name."""
    child = textwrap.dedent(_KILL_CHILD.format(repo=REPO, pkg=pkg, d=d))
    env = dict(os.environ, MDT_INCIDENT_DUMP_STALL="60")
    proc = subprocess.Popen([sys.executable, "-c", child], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        bundles = os.path.join(d, tincident.BUNDLE_DIRNAME)
        deadline = time.monotonic() + 60.0
        part = None
        while time.monotonic() < deadline and proc.poll() is None:
            if os.path.isdir(bundles):
                parts = [n for n in os.listdir(bundles) if n.endswith(".partial")]
                if parts and os.path.exists(os.path.join(bundles, parts[0], "flight_ring.json")):
                    part = parts[0]
                    break
            time.sleep(0.02)
        assert part is not None, f"{pkg}: the child never reached the dump stall: {proc.stderr.read() if proc.poll() is not None else ''}"
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    return part


def test_sigkill_mid_dump_leaves_valid_ledger_and_quarantines(tmp_path):
    """The black-box crash drill, for both packages' detectors: the ledger
    already holds the fsync'd open record; the bundle is a ``.partial``
    dir that the sweep renames to ``.quarantined``, never a half-bundle
    that looks whole."""
    dirs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    parts = {name: _kill_mid_dump(d, "multidisttorch_tpu_torch" if name == "port" else "multidisttorch_tpu")
             for name, d in dirs.items()}
    assert parts["port"] == parts["jax"]
    _same_ledgers(dirs["port"], dirs["jax"])
    d, part = dirs["port"], parts["port"]
    bundles = os.path.join(d, tincident.BUNDLE_DIRNAME)
    recs, torn = read_incident_records(os.path.join(d, tincident.INCIDENTS_NAME))
    assert not torn
    assert [r["rec"] for r in recs] == ["open"]
    iid = part[: -len(".partial")]
    assert not os.path.isdir(os.path.join(bundles, iid))
    swept = sweep_partial_bundles(d)
    jswept = jinc.sweep_partial_bundles(dirs["jax"])
    assert [os.path.basename(p) for p in swept] == [os.path.basename(p) for p in jswept]
    assert len(swept) == 1
    assert swept[0].endswith(".quarantined")
    assert not os.path.isdir(os.path.join(bundles, part))
    # Re-arming over the crash scene replays the incident as open.
    assert load_incidents(d)[iid]["status"] == "open"


# -- flight ring + zero-cost-off --------------------------------------


def test_ring_is_bounded_and_counts_drops():
    ring, jring = tincident.FlightRing(maxlen=4), jinc.FlightRing(maxlen=4)
    for i in range(10):
        ring.note({"i": i})
        jring.note({"i": i})
    snap = ring.snapshot()
    assert snap == jring.snapshot()
    assert len(snap) == 4
    assert [r["i"] for r in snap] == [6, 7, 8, 9]
    assert ring.noted == jring.noted == 10


def test_zero_cost_when_off(monkeypatch, tmp_path):
    """Telemetry OFF: no ring, no detector, and the incident module's
    clock is never read on any production seam (a supervision seam and a
    whole sweep with a fault)."""
    assert not telemetry.enabled()
    assert telemetry.get_flight_ring() is None
    assert telemetry.get_incident_detector() is None

    def _boom():
        raise AssertionError("incident clock read while telemetry off")

    monkeypatch.setattr(tincident, "_clock", _boom)
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.faults import DIVERGE, FaultPlan, FaultSpec
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.hpo.supervision import classify_failure
    from multidisttorch_tpu_torch.train.guards import DivergenceError

    exc = DivergenceError("epoch_loss", float("nan"))
    assert classify_failure(exc) == "divergence"
    (r,) = run_hpo([TrialConfig(trial_id=0, epochs=1, batch_size=16, hidden_dim=16, latent_dim=4,
                                log_interval=10_000)], synthetic_mnist(64, seed=0), None, device="cpu",
                   out_dir=str(tmp_path), verbose=False, save_images=False, save_checkpoints=False, ledger=False,
                   fault_plan=FaultPlan(specs=(FaultSpec(DIVERGE, 0, step=1),)))
    assert r.status == "diverged"
    assert telemetry.get_flight_ring() is None and telemetry.get_incident_detector() is None


def test_telemetry_scope_arms_and_disarms_incident_plane(tmp_path):
    dirs = {}
    for name, tel, bus_of in (("port", telemetry, get_bus), ("jax", jax_tel, jax_tel.get_bus)):
        d = dirs[name] = str(tmp_path / name)
        with tel.telemetry_run(d):
            assert tel.get_flight_ring() is not None
            det = tel.get_incident_detector()
            assert det is not None
            bus = bus_of()
            bus.emit("shard_fence_lost", shard=0, replica=0, reason="outbid")
            # The tap fed the ring and the detector through the same emit.
            assert tel.get_flight_ring().noted >= 1
            assert len(det.open_incidents()) == 1
            # The detector's own incident event must not re-trigger it.
            kinds = [e.kind for e in bus.recent()]
            assert "incident" in kinds
            assert det.opened == 1
        assert tel.get_flight_ring() is None
        assert tel.get_incident_detector() is None
        assert os.path.exists(os.path.join(d, tincident.INCIDENTS_NAME))
    _same_ledgers(dirs["port"], dirs["jax"])
    # The two streams, the detector's incident event included.
    streams = [[_bare(e) for e in tel.read_events(os.path.join(d, "events.jsonl"))]
               for tel, d in ((telemetry, dirs["port"]), (jax_tel, dirs["jax"]))]
    assert streams[0] == streams[1]


def test_offline_replay_matches_live_fold(tmp_path):
    events = [
        _ev("shard_fence_lost", ts=1.0, shard=0, replica=0, reason="outbid"),
        _ev("shard_adopted", ts=2.0, shard=0, replica=1, epoch=2),
        _ev("ckpt_scan_reject", ts=3.0, path="/r/t1/c.msgpack", reason="crc"),
    ]
    pair = _Pair(tmp_path)
    for ev in events:
        pair.observe(ev)
    d = pair.check()
    # Compare (kind, subject): counts differ by design; the live ledger
    # flushes absorbed-echo counts only on escalate/resolve.
    live = {(i["kind"], i["subject"]) for i in load_incidents(d).values()}
    offline = {(i["kind"], i["subject"]) for i in _detect(events).values()}
    assert live == offline


# -- causal autopsy ---------------------------------------------------


def test_autopsy_report_and_exports(tmp_path):
    reports = {}
    for name, tel, mod in (("port", telemetry, tincident), ("jax", jax_tel, jinc)):
        d = str(tmp_path / name)
        with tel.telemetry_run(d):
            bus = tel.get_bus()
            bus.emit("shard_fence_lost", shard=0, replica=0, reason="lease expired")
            bus.emit("shard_adopted", shard=0, replica=1, epoch=2, replayed_submissions=3)
        (iid,) = mod.load_incidents(d)
        reports[name] = (d, iid, mod.build_incident_report(d, iid))
    d, iid, report = reports["port"]
    jd, jiid, jreport = reports["jax"]
    swap = ((d, "<dir>"), (jd, "<dir>"))
    assert iid == jiid
    # The same report, timestamps, hosts, window bounds and paths aside.
    def core(r):
        r = dict(r, window=dict(r["window"], lo=None, hi=None))
        return _bare(r, swap)

    assert core(report) == core(jreport)
    assert report["verdict"] == FENCE_LOST
    assert report["incident"]["id"] == iid
    assert "events" in report["corroborating_surfaces"]
    cited = [r["rec"].get("kind") for r in report["timeline"] if r["source"] == "events"]
    assert "shard_fence_lost" in cited
    assert "shard_adopted" in cited
    out = report["bundle_dir"]
    for name in ("report.json", "perfetto.json", "affected_traces.json"):
        assert os.path.isfile(os.path.join(out, name))
    with open(os.path.join(out, "perfetto.json")) as f:
        perf = json.load(f)
    assert any(e.get("ph") == "X" for e in perf["traceEvents"])
    with open(os.path.join(jreport["bundle_dir"], "perfetto.json")) as f:
        jperf = json.load(f)
    assert [(e["name"], e["ph"], e["tid"]) for e in perf["traceEvents"]] == [
        (e["name"], e["ph"], e["tid"]) for e in jperf["traceEvents"]]
    # Unknown id: loud, with the known ids in the message.
    with pytest.raises(KeyError):
        tincident.build_incident_report(d, "inc-nope")


def test_autopsy_of_a_fabric_root_is_not_ported(tmp_path):
    """A root that holds a service fabric raises, naming A.12b, where the
    JAX autopsy would read its lease, steal and topology streams."""
    d = str(tmp_path)
    IncidentDetector(d, emit_events=False).observe(_ev("shard_fence_lost", ts=1.0, shard=0, replica=0,
                                                       reason="outbid"))
    os.makedirs(os.path.join(d, "fabric"))
    (iid,) = load_incidents(d)
    with pytest.raises(NotImplementedError, match="A.12b"):
        tincident.build_incident_report(d, iid)


# -- slo_alert exemplar -----------------------------------------------


def test_slo_alert_exemplar_present_and_byte_compat(tmp_path):
    from multidisttorch_tpu.telemetry import metrics as jmetrics
    from multidisttorch_tpu.telemetry import slo as jslo
    from multidisttorch_tpu_torch.telemetry import metrics as pmetrics
    from multidisttorch_tpu_torch.telemetry import slo as pslo

    def run(tel, slo, metrics, d0, d1):
        def spec():
            return slo.SloSpec(name="q", kind=slo.LATENCY, source="queue_wait", threshold_s=0.1, objective=0.9,
                               windows=((5.0, 1.0),))

        def burn(eng):
            t = 1000.0
            for i in range(20):
                eng.observe_latency("queue_wait", 3.0, ts=t + i * 0.1)
            eng.evaluate(now=t + 2.5)

        with tel.telemetry_run(d0):
            burn(slo.SloEngine((spec(),)))
        with tel.telemetry_run(d1):
            eng = slo.SloEngine((spec(),))
            hist = metrics.Histogram((0.1, 1.0, 10.0))
            for i in range(20):
                hist.observe(3.0, exemplar=f"sub-{i:03d}")
            eng.attach_exemplar("queue_wait", hist)
            burn(eng)

    dirs = {name: (str(tmp_path / name / "bare"), str(tmp_path / name / "exemplar")) for name in ("port", "jax")}
    run(telemetry, pslo, pmetrics, *dirs["port"])
    run(jax_tel, jslo, jmetrics, *dirs["jax"])
    for a, b in zip(dirs["port"], dirs["jax"]):
        _same_ledgers(a, b)
    d0, d1 = dirs["port"]

    def alert(d):
        evs = telemetry.read_events(os.path.join(d, "events.jsonl"))
        return next(e for e in evs if e["kind"] == "slo_alert")

    bare, rich = alert(d0), alert(d1)
    # Nothing attached => the field is NEVER serialized.
    assert "exemplar" not in bare["data"]
    ex = rich["data"]["exemplar"]
    assert ex["id"].startswith("sub-")
    assert ex["value_s"] == pytest.approx(3.0)
    # And the incident carries the citation into its detail.
    (inc,) = load_incidents(d1).values()
    assert inc["kind"] == SLO_BURN
    assert inc["detail"]["exemplar"]["id"] == ex["id"]
    (inc0,) = load_incidents(d0).values()
    assert "exemplar" not in inc0["detail"]


# -- console + CLI ----------------------------------------------------


def _scripted_service_dir(tmp_path, tel=telemetry, name="svc") -> str:
    d = str(tmp_path / name)
    with tel.telemetry_run(os.path.join(d, "telemetry")):
        bus = tel.get_bus()
        bus.emit("shard_fence_lost", shard=0, replica=1, reason="outbid")
        bus.emit("failure_classified", trial_id=4, failure_class="preemption", exc_type="HostPreemption",
                 error="gone")
    return d


def test_sweep_top_incidents_panel_and_json(tmp_path, capsys, monkeypatch):
    jax_top = _load_tool("sweep_top")
    sweep_top = _port_tool("sweep_top")
    d = _scripted_service_dir(tmp_path)
    _same_ledgers(os.path.join(d, "telemetry"),
                  os.path.join(_scripted_service_dir(tmp_path, jax_tel, "jax-svc"), "telemetry"))
    follow, jfollow = sweep_top.ServiceFollow(d), jax_top.ServiceFollow(d)
    _q, _b, _s, incidents = follow.refresh()
    assert incidents == jfollow.refresh()[3]
    assert len(incidents) == 2
    with monkeypatch.context() as m:
        m.setattr(time, "time", lambda: NOW)
        panel = sweep_top.render_incidents_panel(incidents)
        assert panel == jax_top.render_incidents_panel(incidents)
    assert "open 2" in panel
    assert "fence_lost" in panel and "host_preempted" in panel
    assert "trial:4" in panel

    # Incremental: an operator resolve appended after the first fold lands
    # on the next refresh without re-reading history.
    iid = next(i for i, v in incidents.items() if v["kind"] == FENCE_LOST)
    tincident._fsync_append(os.path.join(d, "telemetry", tincident.INCIDENTS_NAME),
                            {"rec": "resolve", "id": iid, "ts": time.time(), "reason": "mitigated", "count": 1,
                             "flaps": 0})
    offset_before = follow.ioffset
    _q, _b, _s, incidents = follow.refresh()
    assert follow.ioffset > offset_before
    assert (follow.ioffset, incidents) == (lambda r: (jfollow.ioffset, r[3]))(jfollow.refresh())
    assert incidents[iid]["status"] == "resolved"
    assert "resolved 1" in sweep_top.render_incidents_panel(incidents)

    # --json --service carries the incidents block; the text too.
    rc, out = _both("sweep_top", [d, "--service", "--json"], capsys, monkeypatch)
    assert rc == 0
    snap = json.loads(out)
    assert snap["incidents"][iid]["status"] == "resolved"
    rc, out = _both("sweep_top", [d, "--service"], capsys, monkeypatch)
    assert rc == 0 and "incidents  open 1  resolved 1" in out


def test_incident_cli_list_show_report_resolve_sweep(tmp_path, capsys, monkeypatch):
    cli = _port_tool("incident")
    d = _scripted_service_dir(tmp_path)
    rc, out = _both("incident", [d], capsys, monkeypatch)
    assert rc == 0
    assert "fence_lost" in out and "host_preempted" in out
    assert _both("incident", [d, "--json"], capsys, monkeypatch)[0] == 0

    folded = load_incidents(d)
    iid = next(i for i, v in folded.items() if v["kind"] == FENCE_LOST)
    rc, out = _both("incident", [d, "show", iid], capsys, monkeypatch)
    assert rc == 0 and iid in out

    # report writes its bundle: each package on a copy of its own.
    outs = {}
    for name, mod in (("port", cli), ("jax", _load_tool("incident"))):
        c = str(tmp_path / f"report-{name}")
        shutil.copytree(d, c)
        rc, out = _run(mod, [c, "report", iid, "--json"], capsys, monkeypatch)
        assert rc == 0
        outs[name] = _bare(json.loads(out), ((c, "<dir>"),))
    for o in outs.values():
        o["window"] = None
    assert outs["port"] == outs["jax"]
    assert outs["port"]["verdict"] == FENCE_LOST

    # resolve, resolve again and sweep, on a copy each.
    for name, mod in (("port", cli), ("jax", _load_tool("incident"))):
        c = str(tmp_path / f"resolve-{name}")
        shutil.copytree(d, c)
        got = [_run(mod, [c, "resolve", iid, "--reason", "fixed"], capsys, monkeypatch)]
        got.append(_run(mod, [c, "resolve", iid], capsys, monkeypatch))
        # sweep quarantines a planted partial bundle.
        part = os.path.join(c, "telemetry", tincident.BUNDLE_DIRNAME, "inc-0042.partial")
        os.makedirs(part)
        rc, out = _run(mod, [c, "sweep"], capsys, monkeypatch)
        got.append((rc, out.replace(c, "<dir>")))
        assert not os.path.isdir(part)
        outs[name] = (got, _ledger(os.path.join(c, "telemetry")))
    assert outs["port"] == outs["jax"]
    got, _ = outs["port"]
    assert got[0][0] == 0
    assert load_incidents(str(tmp_path / "resolve-port"))[iid]["status"] == "resolved"
    # Resolving again is a polite no-op.
    assert got[1] == (0, f"{iid} already resolved\n")
    assert got[2][0] == 0 and "1 partial bundle(s) quarantined" in got[2][1]

    with pytest.raises(SystemExit):
        cli.main([d, "show", "inc-nope"])


# -- the drill ----------------------------------------------------------


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The port's drill on the CPU (its ELBO calls counted) and the JAX
    drill's scenario functions for the same eight scenarios and the soak."""
    import torch

    from multidisttorch_tpu_torch.ops import elbo as E
    from multidisttorch_tpu_torch.telemetry import device as tdevice

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = E.elbo_fwd_plain, E.elbo_bwd_plain

    def counted_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counted_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(E, "elbo_fwd_plain", counted_fwd)
            m.setattr(E, "elbo_bwd_plain", counted_bwd)
            memo0 = len(tdevice._cost_cache)
            port = drill.run_incidents_bench(str(tmp_path_factory.mktemp("port-drill")), device="cpu")
            counted = len(tdevice._cost_cache) - memo0
    finally:
        torch.set_num_threads(n)
        telemetry.disable()
    jroot = str(tmp_path_factory.mktemp("jax-drill"))
    jax = {}
    for name, _fault, expected, fn, _scripted in jax_drill._SCENARIOS:
        if name in drill.NOT_PORTED:
            continue
        jax[name] = jax_drill._run_scenario(jroot, name, expected, fn)
    jax["soak"] = jax_drill._run_scenario(jroot, "soak", None, jax_drill._sc_soak)
    jax_tel.disable()
    return port, jax, dict(calls, counted=counted)


@pytest.mark.parametrize("name", [s[0] for s in drill.SCENARIOS] + ["soak"])
def test_drill_scenario_matches_the_jax_drill(drills, name):
    port, jax, _ = drills
    sc = port["soak"] if name == "soak" else port["scenarios"][name]
    jsc = jax[name]

    def core(s):
        swap = ((s["scope_dir"], "<scope>"),)
        return _bare({k: s[k] for k in ("expected", "n_incidents", "verdict", "incidents", "bundle_ok", "error")},
                     swap)

    assert core(sc) == core(jsc)
    assert sc["error"] is None
    if name == "soak":
        assert sc["n_incidents"] == 0 and port["soak"]["ok"]
    else:
        assert sc["ok"] and jsc["ok"]
        assert sc["n_incidents"] == 1 and sc["verdict"] == sc["expected"]
        for f in ("trigger.json", "flight_ring.json"):
            assert os.path.isfile(os.path.join(sc["bundle"], f))


def test_drill_matrix_gates_and_launches(drills):
    port, jax, calls = drills
    jconf: dict = {}
    for name, fault, _expected, _fn, _scripted in jax_drill._SCENARIOS:
        if name in jax:
            row = jconf.setdefault(fault, {})
            for inc in jax[name]["incidents"]:
                row[inc["kind"]] = row.get(inc["kind"], 0) + 1
    assert port["confusion"] == jconf
    assert port["ok"] and all(port["gates"].values()), port["gates"]
    assert port["device"] == "cpu"
    assert port["not_ported"] == {"daemon_lost": "A.12b", "fence_raced": "A.12b", "shard_split_lost": "A.12b",
                                  "autopsy": "A.12b"}
    assert not set(port["not_ported"]) & set(port["scenarios"])
    assert port["taxonomy_hit"] == sorted(set(KINDS) - {FENCE_LOST, SPLIT_TORN})
    assert port["taxonomy_not_covered"] == sorted([FENCE_LOST, SPLIT_TORN])
    # Every train step of the drill's sweeps is one ELBO forward and
    # backward, beside the device books' counted step per new program.
    assert port["train_steps"] > 0
    assert calls["fwd"] == calls["bwd"] == port["train_steps"] + calls["counted"]


def test_drill_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drill.run_incidents_bench(str(tmp_path / "drill"), device=None)
    assert not os.path.exists(tmp_path / "drill")
