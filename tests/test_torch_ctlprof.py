"""The port's control-plane flight books (``telemetry/ctlprof.py``, a copy of
the JAX package's), one test for each of ``tests/test_ctlprof.py``'s with the
same assertions: the zero-cost-when-off contract (patching ``ctlprof._clock``
with a raiser proves the off path reads no clock), work-touched accounting
on a scripted real seam, the books schema with honest bucket-bound error
bars, the Perfetto pass-ring track, the sampling fallback, registry
mirroring, and the cross-round regression ledger's drift flags.

Then the copy against its original: the same notes give books of the same
schema and the same work counts in both packages; and the fleet merge's
control-plane track: both packages' ``export_fleet`` write the same fleet
trace for a run dir whose process recorded ctlprof phases. Every comparison
is exact (structure and integer counts); wall times differ by nature and
are compared by their keys only."""

from __future__ import annotations

import json
import os
import time

import pytest

from multidisttorch_tpu_torch.service.queue import (
    SubmissionQueue,
    SweepClient,
    intake_dir,
)
from multidisttorch_tpu_torch.telemetry import ctlprof
from multidisttorch_tpu_torch.telemetry.metrics import MetricsRegistry

pytestmark = pytest.mark.ctlprof


@pytest.fixture(autouse=True)
def _no_leaked_profiler():
    """Every test starts and ends with the profiler OFF (module-global
    state, same discipline as the telemetry bus tests)."""
    ctlprof.disable()
    yield
    ctlprof.disable()


def _drive_scheduler(n: int, seed: int) -> int:
    """A seeded stream of ``n`` submissions (two tenants, sizes 1-2, some
    with deadlines) through the port's scheduler, preemption and defrag
    planners over 4 slices; returns how many placed."""
    import random

    from multidisttorch_tpu_torch.service.defrag import PlacedBlock, plan_defrag, plan_preemption
    from multidisttorch_tpu_torch.service.scheduler import FairShareScheduler, PendingTrial, SlicePool

    rng = random.Random(seed)
    sched = FairShareScheduler()
    pool = SlicePool(4)
    running: list = []
    placed, now = 0, 0.0
    for i in range(n):
        tenant = rng.choice(("a", "b"))
        sched.admit_verdict(tenant)
        sched.push(PendingTrial(sub_id=f"s{i}", tenant=tenant, priority=rng.choice((0, 1)), cfg=None,
                                bucket=(rng.randint(0, 2),), size=rng.choice((1, 1, 2)), cost=10.0,
                                submit_ts=now, trial_id=i,
                                deadline_ts=now + 5.0 if rng.random() < 0.2 else None))
    while sched.pending_count():
        now += 1.0
        for p in sched.schedule(pool, max_lanes=2, now=now):
            placed += len(p.members)
            running.append(p)
        sched.starved_entries(threshold_s=1.0, now=now)
        sched.deadline_pending(now=now)
        blocks = [PlacedBlock(placement_id=p.placement_id, start=p.start, size=p.size, movable=True) for p in running]
        plan_defrag(pool, blocks, 2)
        plan_preemption(pool, blocks, 2)
        while running and rng.random() < 0.6:
            p = running.pop(0)
            pool.free(p.start, p.size)
    return placed


def _boom_clock():
    raise AssertionError(
        "ctlprof clock read with the profiler OFF — the "
        "zero-cost-when-off contract is broken"
    )


# -- zero-cost-when-off (the CI tier-1 guard) --------------------------


def test_ctlprof_off_reads_no_clock(tmp_path, monkeypatch):
    """With no profiler armed, driving the real control plane through
    every seam family (intake drain + hundreds of scheduling passes:
    admission, fair-share, EDF, bin-pack, preemption, defrag) must never
    reach the profiler's clock indirection. (The JAX test drives its
    load generator, as ``tests/test_torch_loadgen.py`` does over the
    port's; here a seeded stream drives the same scheduler and planner
    seams directly.)"""
    assert ctlprof.get_ctlprof() is None
    monkeypatch.setattr(ctlprof, "_clock", _boom_clock)
    # Real journal seam:
    d = str(tmp_path)
    c = SweepClient(d, tenant="alice")
    c.submit({"epochs": 1}, priority=0, size=1)
    q = SubmissionQueue(d)
    fresh = q.drain_intake(known_ids=set())
    assert len(fresh) == 1
    # Real scheduler passes, hundreds of them:
    placed = _drive_scheduler(300, seed=3)
    assert placed == 300  # zero lost
    assert ctlprof.get_ctlprof() is None


# -- work-touched accounting on a scripted pass ------------------------


def test_work_touched_exact_on_intake_drain(tmp_path):
    """Scripted spool: 3 committed submissions + 1 torn ``.tmp`` file.
    The intake_drain books must read examined=4 (every directory entry
    iterated), mutated=3 (journaled fresh), scan efficiency 0.75."""
    d = str(tmp_path)
    c = SweepClient(d, tenant="alice")
    for _ in range(3):
        c.submit({"epochs": 1}, priority=1, size=1)
    torn = os.path.join(intake_dir(d), "zz-torn.json.tmp")
    with open(torn, "w") as f:
        f.write('{"never": "committed"')
    prof = ctlprof.configure()
    try:
        q = SubmissionQueue(d)
        fresh = q.drain_intake(known_ids=set())
        assert len(fresh) == 3
        books = prof.books()
    finally:
        ctlprof.disable()
    ph = books["phases"]["intake_drain"]
    assert ph["calls"] == 1
    assert ph["examined"] == 4
    assert ph["mutated"] == 3
    assert ph["scan_efficiency"] == pytest.approx(0.75)
    assert ph["worst_call"]["examined"] == 4
    wt = books["work_touched"]
    assert wt["examined"] == 4 and wt["mutated"] == 3


# -- books schema + honest percentiles ---------------------------------


def test_books_schema_and_bucket_error_bounds():
    prof = ctlprof.configure()
    try:
        prof.pass_begin()
        t = prof.t0()
        prof.note("bin_pack_scan", t, examined=4000, mutated=3)
        t = prof.t0()
        prof.note("edf_insert", t, examined=7, mutated=1)
        prof.pass_end()
        books = prof.books()
    finally:
        ctlprof.disable()
    assert books["enabled"] is True
    assert books["passes"]["count"] == 1
    assert books["passes"]["per_s"] > 0
    # Listing order follows the PHASES taxonomy:
    assert list(books["phases"]) == ["edf_insert", "bin_pack_scan"]
    fracs = sum(b["wall_frac"] for b in books["phases"].values())
    assert fracs == pytest.approx(1.0)
    bp = books["phases"]["bin_pack_scan"]
    assert bp["scan_efficiency"] == pytest.approx(3 / 4000)
    # Honest percentiles: every reported percentile sits inside its
    # bucket bounds, and the bounds are one fine log bucket apart
    # (8/decade => factor 10^(1/8) ~= 1.33).
    for blk in (bp, books["passes"]):
        for p in ("p50_s", "p95_s", "p99_s"):
            lo, hi = blk["bucket_err"][p]
            assert lo <= blk[p] <= hi
            if lo > 0:
                assert hi / lo == pytest.approx(10 ** 0.125, rel=1e-6)
    # Worst-pass capture aggregates the pass's notes:
    worst = books["passes"]["worst"]
    assert worst["phases"]["bin_pack_scan"]["examined"] == 4000


def test_unknown_phase_lazily_added():
    prof = ctlprof.configure()
    try:
        t = prof.t0()
        prof.note("experimental_phase", t, examined=1, mutated=1)
        books = prof.books()
    finally:
        ctlprof.disable()
    assert books["phases"]["experimental_phase"]["calls"] == 1


# -- Perfetto control-plane track --------------------------------------


def test_trace_events_ring_relative():
    prof = ctlprof.configure(ring=8)
    try:
        for _ in range(3):
            prof.pass_begin()
            t = prof.t0()
            prof.note("admission", t, examined=2, mutated=2)
            prof.pass_end()
        evs = prof.trace_events(pid=0)
    finally:
        ctlprof.disable()
    metas = [e for e in evs if e["ph"] == "M"]
    slices = [e for e in evs if e["ph"] == "X"]
    assert any(
        e["name"] == "process_name"
        and e["args"]["name"] == "control-plane"
        for e in metas
    )
    assert sum(1 for e in slices if e["name"] == "ctl_pass") == 3
    adm = [e for e in slices if e["name"] == "admission"]
    assert len(adm) == 3
    assert all(e["args"] == {"examined": 2, "mutated": 2} for e in adm)
    # Ring-relative clock: every ts lands at/after the oldest pass.
    assert all(e["ts"] >= 0 for e in slices)
    assert all(e["pid"] == 0 for e in evs)


def test_trace_events_empty_ring():
    prof = ctlprof.configure()
    try:
        assert prof.trace_events() == []
    finally:
        ctlprof.disable()


# -- registry mirroring ------------------------------------------------


def test_registry_mirroring_at_books_cadence():
    reg = MetricsRegistry()
    prof = ctlprof.configure(registry=reg)
    try:
        prof.pass_begin()
        t = prof.t0()
        prof.note("fair_share_pick", t, examined=12, mutated=1)
        prof.pass_end()
        prof.books()  # counters mirror at books cadence, not per-note
    finally:
        ctlprof.disable()
    assert (
        reg.counter("ctl_phase_examined_total", phase="fair_share_pick")
        .value == 12.0
    )
    assert reg.counter("ctl_passes_total").value == 1.0
    # Wall histograms are registry-native series (no mirroring):
    h = reg.histogram(
        "ctl_phase_wall_s",
        bounds=ctlprof.CTL_TIME_BUCKETS,
        phase="fair_share_pick",
    )
    assert h.count == 1


# -- sampling fallback -------------------------------------------------


def test_sampler_writes_flame_file(tmp_path):
    flame = str(tmp_path / "ctl_flame.txt")
    prof = ctlprof.configure(sample_hz=250.0, flame_path=flame)
    try:
        assert prof.sampler is not None
        deadline = time.perf_counter() + 0.5
        x = 0
        while time.perf_counter() < deadline and prof.sampler.samples < 3:
            x += sum(range(200))  # keep this thread on-CPU to sample
    finally:
        retired = ctlprof.disable()
    assert retired.sampler.samples >= 1
    assert not retired.sampler.is_alive()  # bounded: thread stopped
    with open(flame) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    assert lines
    # Collapsed-stack format: "frame;frame;...;leaf count"
    stack, count = lines[0].rsplit(" ", 1)
    assert ";" in stack and int(count) >= 1


def test_sample_hz_env_default(monkeypatch):
    monkeypatch.setenv("MDT_CTLPROF_SAMPLE_HZ", "0")
    prof = ctlprof.configure()
    try:
        assert prof.sampler is None
    finally:
        ctlprof.disable()
    monkeypatch.setenv("MDT_CTLPROF_SAMPLE_HZ", "not-a-number")
    prof = ctlprof.configure()
    try:
        assert prof.sampler is None  # garbage env = sampler off
    finally:
        ctlprof.disable()


# -- regression ledger -------------------------------------------------


def _fake_books(bin_pack_frac: float) -> dict:
    other = 1.0 - bin_pack_frac
    return {
        "enabled": True,
        "phases": {
            "bin_pack_scan": {
                "wall_frac": bin_pack_frac, "p99_s": 1e-4,
                "bucket_err": {"p99_s": [9e-5, 1.2e-4]},
                "scan_efficiency": 0.001,
            },
            "edf_insert": {
                "wall_frac": other, "p99_s": 1e-5,
                "bucket_err": {"p99_s": [9e-6, 1.2e-5]},
                "scan_efficiency": 1.0,
            },
        },
        "passes": {"per_s": 9000.0},
        "work_touched": {
            "examined": 1000, "mutated": 10, "scan_efficiency": 0.01,
        },
    }


def test_ledger_fold_and_drift_flags(tmp_path):
    path = str(tmp_path / "ctlprof_ledger.jsonl")
    rec1 = ctlprof.ledger_record(
        "zoo", "diurnal_wave", _fake_books(0.50),
        submissions_per_wall_s=10000.0,
    )
    assert rec1["phase_wall_frac"]["bin_pack_scan"] == pytest.approx(0.5)
    assert rec1["scan_efficiency"] == pytest.approx(0.01)
    folded1 = ctlprof.fold_ledger_round(path, rec1)
    assert folded1["vs_prev_rounds"] == {"prior_rounds": 0}
    # Round 2: throughput -40%, bin_pack wall fraction +0.25 absolute —
    # both drift flags must trip against the prior median.
    rec2 = ctlprof.ledger_record(
        "zoo", "diurnal_wave", _fake_books(0.75),
        submissions_per_wall_s=6000.0,
    )
    folded2 = ctlprof.fold_ledger_round(path, rec2)
    vs = folded2["vs_prev_rounds"]
    assert vs["prior_rounds"] == 1
    assert vs["drift_exceeds_20pct"] is True
    assert vs["ratio_to_median"] == pytest.approx(0.6)
    assert vs["phase_drift"] is True
    assert "bin_pack_scan" in vs["phase_frac_shifts"]
    # Rounds are keyed (kind, scenario): another scenario sees none.
    rec3 = ctlprof.ledger_record(
        "zoo", "tenant_burst", _fake_books(0.5),
        submissions_per_wall_s=6000.0,
    )
    assert ctlprof.fold_ledger_round(path, rec3)["vs_prev_rounds"] == {
        "prior_rounds": 0
    }
    # Torn-tail tolerant reader:
    with open(path, "a") as f:
        f.write('{"torn": ')
    rows = ctlprof.read_ledger(path)
    assert len(rows) == 3
    assert all("vs_prev_rounds" in r for r in rows)
    assert json.loads(json.dumps(rows[0]))  # JSON-clean


def test_ledger_summary_reads_bucket_bounds():
    summary = ctlprof.ledger_phase_summary(_fake_books(0.5))
    assert summary["bin_pack_scan"]["p99_bounds_s"] == [9e-5, 1.2e-4]
    assert summary["edf_insert"]["scan_efficiency"] == 1.0


# -- the copy against its original ------------------------------------


def _keys(x):
    """The structure of a books dict: nested keys, values dropped."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    return type(x).__name__ if isinstance(x, (list, tuple)) else None


def _script(mod):
    """The same passes and notes through one package's profiler, with a
    deterministic clock (one microsecond a read), so both packages'
    books and trace events can be compared."""
    ticks = iter(range(10**6))
    mod._clock = lambda: next(ticks) * 1e-6
    prof = mod.configure(ring=16)
    for n in range(3):
        prof.pass_begin()
        for phase, ex, mu in (("intake_drain", 4, 3), ("bin_pack_scan", 40 + n, 1), ("edf_insert", 7, 1)):
            t = prof.t0()
            prof.note(phase, t, examined=ex, mutated=mu)
        prof.pass_end()
    return prof


def test_books_and_trace_events_equal_the_jax_profiler(monkeypatch):
    from multidisttorch_tpu.telemetry import ctlprof as jctlprof

    for mod in (ctlprof, jctlprof):
        monkeypatch.setattr(mod, "_clock", mod._clock)
    try:
        port, ref = _script(ctlprof), _script(jctlprof)
        pb, jb = port.books(), ref.books()
        assert _keys(pb) == _keys(jb)
        assert list(pb["phases"]) == list(jb["phases"])
        for name in pb["phases"]:
            for k in ("calls", "examined", "mutated", "scan_efficiency", "wall_frac"):
                assert pb["phases"][name][k] == jb["phases"][name][k], (name, k)
        assert pb["work_touched"] == jb["work_touched"]
        assert port.trace_events(pid=0) == ref.trace_events(pid=0)
    finally:
        ctlprof.disable()
        jctlprof.disable()


def test_fleet_trace_carries_the_ctl_track_like_the_jax_one(tmp_path, monkeypatch):
    """Both packages' export_fleet, in a process whose profiler recorded
    control-plane passes, write the same fleet trace, control-plane track
    included."""
    from multidisttorch_tpu.telemetry import ctlprof as jctlprof
    from multidisttorch_tpu.telemetry import fleet as jfleet
    from multidisttorch_tpu_torch.telemetry import fleet as pfleet

    run_dir = str(tmp_path / "run")
    path = os.path.join(run_dir, "telemetry", "w0", "events.p0.jsonl")
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        for ev in ({"kind": "sweep_start", "ts": 10.0, "host": 0, "world": 0, "data": {"configs": 1}},
                   {"kind": "attempt_start", "ts": 11.0, "host": 0, "world": 0, "trial_id": 0, "attempt": 1},
                   {"kind": "attempt_end", "ts": 12.0, "host": 0, "world": 0, "trial_id": 0, "attempt": 1,
                    "data": {"status": "completed", "summary": {"steps": 4}}}):
            f.write(json.dumps(ev) + "\n")
    for mod in (ctlprof, jctlprof):
        monkeypatch.setattr(mod, "_clock", mod._clock)
    try:
        _script(ctlprof)
        _script(jctlprof)
        port = pfleet.export_fleet(run_dir)
        with open(port["paths"]["trace"]) as f:
            port_trace = json.load(f)
        ref = jfleet.export_fleet(run_dir)
        with open(ref["paths"]["trace"]) as f:
            ref_trace = json.load(f)
    finally:
        ctlprof.disable()
        jctlprof.disable()
    assert port_trace == ref_trace
    names = {e.get("name") for e in port_trace["traceEvents"]}
    assert "ctl_pass" in names and "bin_pack_scan" in names
