"""The port's sweep service (docs/SERVICE.md): queue durability, scheduler
invariants, defrag policy and the daemon runtime on device slots; one test
for each of ``tests/test_service.py``'s with the same assertions (its
``ledger_view --queue`` and ``sweep_top --service`` tests are
``tests/test_torch_consoles.py``'s). Then the copies against their originals (exact),
the port's service against the JAX service on the same submissions, the
snapshot-fast drain and resume, and the kill -9 drill on the CPU.

The property-style invariants:

- fair share never starves a nonempty tenant;
- bin-packing never splits a shape bucket across submeshes mid-pass;
- defrag never migrates a trial with an unflushed checkpoint;
- the queue survives ``kill -9`` mid-append (real subprocess SIGKILL).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from multidisttorch_tpu_torch.service.defrag import PlacedBlock, plan_defrag
from multidisttorch_tpu_torch.service.queue import (
    ADMITTED,
    PENDING,
    SETTLED,
    QueueStats,
    Submission,
    SubmissionQueue,
    SweepClient,
    fold_queue,
    intake_dir,
    load_queue,
    queue_path,
)
from multidisttorch_tpu_torch.service.scheduler import (
    ADMIT,
    FairShareScheduler,
    PendingTrial,
    REJECT_BACKPRESSURE,
    REJECT_QUOTA,
    SlicePool,
    TenantPolicy,
)

pytestmark = pytest.mark.service


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: the stacked and unstacked products then sum in
    # the same order (the CPU's bitwise stacking contract), and parallel
    # test workers do not oversubscribe the cores.
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def entry(
    sub_id,
    tenant="t",
    *,
    priority=1,
    bucket=("b",),
    size=1,
    cost=10.0,
    **kw,
):
    return PendingTrial(
        sub_id=sub_id,
        tenant=tenant,
        priority=priority,
        cfg=None,
        bucket=bucket,
        size=size,
        cost=cost,
        submit_ts=0.0,
        **kw,
    )


# --------------------------------------------------------------------
# durable queue
# --------------------------------------------------------------------


class TestQueue:
    def test_submit_drain_settle_roundtrip(self, tmp_path):
        d = str(tmp_path)
        c = SweepClient(d, tenant="alice")
        sid = c.submit({"epochs": 2}, priority=0, size=2, deadline_s=9.0)
        assert sid.startswith("alice-")
        # Committed before any daemon exists:
        assert c.status(sid)["state"] == PENDING
        q = SubmissionQueue(d)
        known = set()
        fresh = q.drain_intake(known_ids=known)
        assert [s.submission_id for s in fresh] == [sid]
        assert fresh[0].tenant == "alice"
        assert fresh[0].size == 2 and fresh[0].priority == 0
        assert fresh[0].deadline_s == 9.0
        # Spool file consumed; journal carries it now.
        assert not os.listdir(intake_dir(d))
        q.admitted(sid, trial_id=0, chash="h0", bucket="(b,)")
        q.placed(
            sid, trial_id=0, start=0, size=2, lanes=1,
            stacked=False, resumed=False,
        )
        q.settled(sid, trial_id=0, status="completed")
        rec = fold_queue(load_queue(d))[sid]
        assert rec["state"] == SETTLED
        assert rec["status"] == "completed"
        assert rec["trial_id"] == 0
        assert rec["placements"] == 1
        stats = QueueStats.of({sid: rec})
        assert stats.by_state == {SETTLED: 1}

    def test_unplaced_returns_to_admitted(self, tmp_path):
        d = str(tmp_path)
        c = SweepClient(d)
        sid = c.submit({})
        q = SubmissionQueue(d)
        q.drain_intake(known_ids=set())
        q.admitted(sid, trial_id=0, chash="h", bucket="b")
        q.placed(sid, trial_id=0, start=0, size=1, lanes=1,
                 stacked=False, resumed=False)
        q.unplaced(sid, trial_id=0, reason="drain")
        rec = fold_queue(load_queue(d))[sid]
        assert rec["state"] == ADMITTED
        assert rec["unplaced_reason"] == "drain"

    def test_torn_tail_costs_one_transition_not_the_submission(
        self, tmp_path
    ):
        d = str(tmp_path)
        c = SweepClient(d)
        sid = c.submit({})
        q = SubmissionQueue(d)
        q.drain_intake(known_ids=set())
        q.admitted(sid, trial_id=0, chash="h", bucket="b")
        # Crash mid-append: the settled record tears.
        with open(queue_path(d), "a") as f:
            f.write('{"event": "settled", "submission_id": "' + sid)
        rec = fold_queue(load_queue(d))[sid]
        assert rec["state"] == ADMITTED  # the torn line is skipped

    def test_duplicate_spool_replay_is_idempotent(self, tmp_path):
        # Crash between the durable `submitted` append and the spool
        # unlink: the file replays but must not journal twice.
        d = str(tmp_path)
        c = SweepClient(d)
        sid = c.submit({})
        q = SubmissionQueue(d)
        q.drain_intake(known_ids=set())
        # Resurrect the spool file (as if unlink never happened).
        c2 = SweepClient(d)
        path = os.path.join(intake_dir(d), sid + ".json")
        with open(path, "w") as f:
            json.dump(
                Submission(
                    submission_id=sid, tenant="default", config={}
                ).to_dict(),
                f,
            )
        known = set(fold_queue(load_queue(d)))
        fresh = q.drain_intake(known_ids=known)
        assert fresh == []  # deduped
        assert not os.path.exists(path)  # but still cleaned up
        events = load_queue(d)
        assert (
            sum(1 for e in events if e.get("event") == "submitted") == 1
        )
        del c2

    def test_torn_tmp_spool_file_ignored(self, tmp_path):
        d = str(tmp_path)
        os.makedirs(intake_dir(d), exist_ok=True)
        with open(os.path.join(intake_dir(d), "x.json.tmp"), "w") as f:
            f.write('{"submission_id": "x"')  # mid-write
        with open(os.path.join(intake_dir(d), "bad.json"), "w") as f:
            f.write("{garbled")  # renamed but undecodable (fs damage)
        q = SubmissionQueue(d)
        assert q.drain_intake(known_ids=set()) == []

    def test_queue_survives_kill9_mid_append(self, tmp_path):
        """A real SIGKILL against a child hammering submits + journal
        appends: afterwards the journal folds cleanly and every
        DURABLY-submitted id (client returned / journal holds it) is
        recoverable — the zero-lost-submissions contract."""
        d = str(tmp_path)
        code = (
            "import sys, os\n"
            "sys.path.insert(0, %r)\n"
            "from multidisttorch_tpu_torch.service.queue import ("
            "SweepClient, SubmissionQueue)\n"
            "d = %r\n"
            "c = SweepClient(d, tenant='k9')\n"
            "q = SubmissionQueue(d)\n"
            "known = set()\n"
            "i = 0\n"
            "while True:\n"
            "    sid = c.submit({'seed': i})\n"
            "    print(sid, flush=True)\n"
            "    q.drain_intake(known_ids=known)\n"
            "    q.admitted(sid, trial_id=i, chash='h%%d' %% i, "
            "bucket='b')\n"
            "    i += 1\n"
        ) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             d)
        proc = subprocess.Popen(
            [sys.executable, "-c", code],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
        )
        # Let it commit a few, then kill -9 mid-flight.
        printed = []
        deadline = time.time() + 30
        while len(printed) < 5 and time.time() < deadline:
            line = proc.stdout.readline().strip()
            if line:
                printed.append(line)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        assert printed, "child never committed a submission"
        folded = fold_queue(load_queue(d))
        spooled = {
            n[: -len(".json")]
            for n in os.listdir(intake_dir(d))
            if n.endswith(".json")
        }
        for sid in printed:
            # Every id the client observed as committed is either
            # journaled or still sitting durably in the spool.
            assert sid in folded or sid in spooled, sid
        # The journal itself folds without error (torn tail skipped).
        for rec in folded.values():
            assert rec["state"] in (PENDING, ADMITTED)


# --------------------------------------------------------------------
# scheduler: admission, fair share, packing
# --------------------------------------------------------------------


class TestAdmission:
    def test_quota_and_backpressure_verdicts(self):
        s = FairShareScheduler(
            {"a": TenantPolicy(max_pending=2)},
            max_total_pending=3,
        )
        assert s.admit_verdict("a")[0] == ADMIT
        s.push(entry("a0", "a"))
        s.push(entry("a1", "a"))
        v, reason = s.admit_verdict("a")
        assert v == REJECT_QUOTA and "quota" in reason
        # Other tenants still fine until the global cap...
        assert s.admit_verdict("b")[0] == ADMIT
        s.push(entry("b0", "b"))
        v, _ = s.admit_verdict("b")
        assert v == REJECT_BACKPRESSURE


class TestFairShare:
    def _drain(self, s, pool, max_iters=500, max_lanes=1):
        order = []
        for _ in range(max_iters):
            ps = s.schedule(pool, max_lanes=max_lanes)
            for p in ps:
                order.extend(e.tenant for e in p.members)
                pool.free(p.start, p.size)
            if not s.pending_count():
                break
        return order

    @pytest.mark.parametrize("n_slices", [1, 4])
    def test_weighted_share_under_contention(self, n_slices):
        # 2:1 weights, 2:1 demand, equal cost -> contended service
        # lands within 10% of the weights in BOTH slot regimes.
        pool = SlicePool(n_slices)
        s = FairShareScheduler(
            {"a": TenantPolicy(weight=2.0), "b": TenantPolicy(weight=1.0)}
        )
        for i in range(24):
            s.push(entry(f"a{i}", "a", bucket=("x", i)))
        for i in range(12):
            s.push(entry(f"b{i}", "b", bucket=("y", i)))
        self._drain(s, pool)
        rep = s.fair_share_report()
        for t in ("a", "b"):
            assert abs(rep[t]["ratio_to_weight"] - 1.0) <= 0.10, rep

    def test_nonempty_tenant_never_starves(self):
        # Property: under an adversarial weight gap and a single slot,
        # the tiny-weight tenant is still served in bounded time.
        pool = SlicePool(1)
        s = FairShareScheduler(
            {
                "whale": TenantPolicy(weight=1000.0),
                "shrimp": TenantPolicy(weight=0.001),
            }
        )
        for i in range(200):
            s.push(entry(f"w{i}", "whale", bucket=("w", i)))
        s.push(entry("s0", "shrimp", bucket=("s",)))
        served_shrimp = False
        for _ in range(250):
            for p in s.schedule(pool, max_lanes=1):
                if any(e.tenant == "shrimp" for e in p.members):
                    served_shrimp = True
                pool.free(p.start, p.size)
            if served_shrimp:
                break
        assert served_shrimp

    def test_idle_tenant_banks_no_credit(self):
        # A tenant idle while another is served must not later burst
        # past its weight share (virtual-time activation rule).
        pool = SlicePool(1)
        s = FairShareScheduler(
            {"a": TenantPolicy(weight=1.0), "b": TenantPolicy(weight=1.0)}
        )
        for i in range(20):
            s.push(entry(f"a{i}", "a", bucket=("x", i)))
        # Serve a alone for 10 opportunities.
        for _ in range(10):
            for p in s.schedule(pool, max_lanes=1):
                pool.free(p.start, p.size)
        for i in range(20):
            s.push(entry(f"b{i}", "b", bucket=("y", i)))
        order = self._drain(s, pool)
        # From b's arrival, service alternates ~1:1 — b does NOT get a
        # 10-placement catch-up monopoly.
        first10 = order[:10]
        assert first10.count("b") <= 6, order[:12]

    def test_priority_lane_strictness(self):
        pool = SlicePool(1)
        s = FairShareScheduler()
        s.push(entry("lo", "t", priority=2, bucket=("l",)))
        s.push(entry("hi", "u", priority=0, bucket=("h",)))
        ps = s.schedule(pool, max_lanes=1)
        assert ps[0].members[0].sub_id == "hi"

    def test_backoff_veto_does_not_block_tenant(self):
        pool = SlicePool(2)
        s = FairShareScheduler()
        late = entry("late", "t", bucket=("l",))
        late.not_before = time.time() + 3600
        s.push(late)
        s.push(entry("now", "t", bucket=("n",)))
        now = time.time()
        ps = s.schedule(
            pool, max_lanes=1, can_start=lambda e: now >= e.not_before
        )
        assert [p.members[0].sub_id for p in ps] == ["now"]


class TestPacking:
    def test_same_bucket_copacks_across_tenants(self):
        pool = SlicePool(4)
        s = FairShareScheduler()
        s.push(entry("a0", "a", bucket=("same",)))
        s.push(entry("b0", "b", bucket=("same",)))
        ps = s.schedule(pool, max_lanes=4)
        assert len(ps) == 1 and ps[0].lanes == 2
        assert {e.tenant for e in ps[0].members} == {"a", "b"}

    def test_never_splits_a_bucket_across_submeshes(self):
        # Invariant: one pass opens ceil(n/max_lanes) placements per
        # (bucket, size) — never two partially-filled submeshes.
        pool = SlicePool(8)
        s = FairShareScheduler()
        for i in range(11):
            s.push(entry(f"x{i}", f"t{i % 3}", bucket=("B",)))
        ps = s.schedule(pool, max_lanes=4)
        same = [p for p in ps if p.bucket == ("B",)]
        lanes = sorted(p.lanes for p in same)
        assert sum(lanes) == 11
        assert lanes == [3, 4, 4]
        underfull = [p for p in same if p.lanes < 4]
        assert len(underfull) <= 1
        for p in same:
            assert all(e.bucket == ("B",) for e in p.members)

    def test_resume_scan_never_copacks(self):
        pool = SlicePool(4)
        s = FairShareScheduler()
        s.push(entry("fresh", "a", bucket=("B",)))
        s.push(entry("recovered", "a", bucket=("B",), resume_scan=True))
        ps = s.schedule(pool, max_lanes=4)
        assert len(ps) == 2  # the scan-resume trial runs classic

    def test_blocked_large_stamps_starvation_clock(self):
        s = FairShareScheduler()
        # occupy 0 and 2 so no 2-contiguous run exists
        pool2 = SlicePool(4)
        assert pool2.alloc_at(0, 1) and pool2.alloc_at(2, 1)
        big = entry("big", "t", bucket=("big",), size=2)
        s.push(big)
        t0 = 1000.0
        assert s.schedule(pool2, max_lanes=1, now=t0) == []
        assert big.blocked_since == t0
        starved = s.starved_entries(threshold_s=5.0, now=t0 + 6.0)
        assert [e.sub_id for e in starved] == ["big"]
        # Fragmentation gauge sees it too.
        assert pool2.fragmentation() == 0.5
        assert pool2.largest_free_run() == 1 and pool2.free_total == 2


class TestSlicePool:
    def test_alloc_contiguity_and_coalescing(self):
        p = SlicePool(6)
        a = p.alloc(2)
        b = p.alloc(3)
        assert (a, b) == (0, 2)
        p.free(a, 2)
        assert p.free_runs() == [(0, 2), (5, 1)]
        assert p.alloc(3) is None  # only 2+1 available
        p.free(b, 3)
        assert p.free_runs() == [(0, 6)]  # coalesced
        with pytest.raises(ValueError):
            p.free(0, 1)  # double free

    def test_alloc_at(self):
        p = SlicePool(4)
        assert p.alloc_at(2, 2)
        assert not p.alloc_at(1, 2)  # overlaps
        assert not p.alloc_at(3, 2)  # out of range
        assert p.alloc(2) == 0


# --------------------------------------------------------------------
# defrag planner
# --------------------------------------------------------------------


class TestDefragPlanner:
    def _pool(self, n, occupied):
        p = SlicePool(n)
        for start, size in occupied:
            assert p.alloc_at(start, size)
        return p

    def test_min_moves_window(self):
        # occupied: A@1(1), B@3(1); free {0,2}. Want 2: either window
        # works with ONE move; the plan picks the lowest feasible
        # window and re-homes the victim outside it.
        pool = self._pool(4, [(1, 1), (3, 1)])
        blocks = [
            PlacedBlock(0, 1, 1, True),
            PlacedBlock(1, 3, 1, True),
        ]
        plan = plan_defrag(pool, blocks, 2)
        assert plan is not None and len(plan.moves) == 1
        (pid, dst) = plan.moves[0]
        assert plan.window_start == 0 and pid == 0 and dst == 2

    def test_never_moves_unflushed_checkpoint(self):
        # The unflushed (movable=False) placement is never a victim —
        # even when that makes the plan infeasible.
        pool = self._pool(4, [(1, 1), (3, 1)])
        blocks = [
            PlacedBlock(0, 1, 1, False),  # unflushed
            PlacedBlock(1, 3, 1, False),
        ]
        assert plan_defrag(pool, blocks, 2) is None
        # movable_fn veto at PLAN time wins over a stale flag too.
        blocks = [
            PlacedBlock(0, 1, 1, True),
            PlacedBlock(1, 3, 1, True),
        ]
        assert (
            plan_defrag(pool, blocks, 2, movable_fn=lambda b: False)
            is None
        )
        plan = plan_defrag(
            pool, blocks, 2, movable_fn=lambda b: b.placement_id == 1
        )
        assert plan is not None
        assert [pid for pid, _ in plan.moves] == [1]

    def test_victims_rehome_outside_window(self):
        # 6 slices: occupied A@1(1), B@4(1); free {0,2,3,5}. Want 3:
        # cheapest window is {0,1,2} (one move), and A must re-home in
        # free space OUTSIDE that window ({3} first-fit).
        pool = self._pool(6, [(1, 1), (4, 1)])
        blocks = [
            PlacedBlock(0, 1, 1, True),
            PlacedBlock(1, 4, 1, True),
        ]
        plan = plan_defrag(pool, blocks, 3)
        assert plan is not None
        assert plan.window_start == 0 and plan.window_size == 3
        assert plan.moves == [(0, 3)]
        # And genuinely infeasible layouts return None: every window
        # holds work, and the one free slice cannot absorb a 2-wide
        # victim.
        pool2 = self._pool(6, [(0, 2), (3, 1), (5, 1)])
        blocks2 = [
            PlacedBlock(0, 0, 2, True),
            PlacedBlock(1, 3, 1, True),
            PlacedBlock(2, 5, 1, True),
        ]
        assert plan_defrag(pool2, blocks2, 3) is None

    def test_zero_move_plan_when_already_fits(self):
        pool = self._pool(4, [(0, 1)])
        plan = plan_defrag(pool, [PlacedBlock(0, 0, 1, True)], 2)
        assert plan is not None and plan.moves == []
        assert plan.window_start == 1

    def test_infeasible_capacity_returns_none(self):
        pool = self._pool(2, [(0, 2)])
        assert plan_defrag(
            pool, [PlacedBlock(0, 0, 2, True)], 2
        ) is None


# --------------------------------------------------------------------
# ledger satellites: tags + concurrent compaction
# --------------------------------------------------------------------


class TestLedgerSatellites:
    def test_tenant_tags_on_attempt_records(self, tmp_path):
        from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

        led = SweepLedger(str(tmp_path))
        led.attempt_start(
            0, "h0", 1, tenant="alice", priority=0, submit_ts=123.5
        )
        led.attempt_end(
            0, "h0", 1, "completed",
            summary={"steps": 4},
            tenant="alice", priority=0, submit_ts=123.5,
        )
        led.attempt_start(1, "h1", 1)  # untagged — old callers
        evs = led.load()
        assert evs[0]["tenant"] == "alice"
        assert evs[0]["priority"] == 0
        assert evs[0]["submit_ts"] == 123.5
        assert evs[1]["tenant"] == "alice"
        assert "tenant" not in evs[2]  # untagged stays byte-compatible
        # Old-style records (no tags) parse through every fold.
        assert led.attempts() == {"h0": 1, "h1": 1}
        assert set(led.finished()) == {"h0"}

    def test_tagged_events_feed_sweepfold_and_fleet(self, tmp_path):
        from multidisttorch_tpu_torch import telemetry
        from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
        from multidisttorch_tpu_torch.telemetry.export import (
            SweepFold,
            run_summary,
        )
        from multidisttorch_tpu_torch.telemetry.fleet import per_tenant_books

        tel = str(tmp_path / "tel")
        with telemetry.telemetry_run(tel):
            led = SweepLedger(str(tmp_path))
            for tid, ten in ((0, "alice"), (1, "bob")):
                led.attempt_start(tid, f"h{tid}", 1, tenant=ten)
                led.attempt_end(
                    tid, f"h{tid}", 1, "completed",
                    summary={"steps": 8, "resumed_from_step": 0},
                    tenant=ten,
                )
            events = [
                e.to_dict()
                for e in telemetry.get_bus().recent()
            ]
            summary = run_summary(events)
        fold = SweepFold()
        for e in events:
            fold.feed(e)
        books = fold.tenant_books()
        assert books["alice"]["useful_steps"] == 8
        assert books["alice"]["goodput"] == 1.0
        assert books["bob"]["trials"] == 1
        assert summary["tenants"]["bob"]["settled"] == 1
        assert fold.trials[0]["tenant"] == "alice"
        fleet = per_tenant_books(events)
        assert fleet["alice"]["goodput"] == 1.0
        assert fleet["bob"]["trials"] == 1

    def test_untagged_stream_has_no_tenant_keys(self):
        from multidisttorch_tpu_torch.telemetry.export import run_summary

        summary = run_summary(
            [
                {
                    "kind": "attempt_end",
                    "ts": 1.0,
                    "trial_id": 0,
                    "attempt": 1,
                    "data": {
                        "status": "completed",
                        "summary": {"steps": 2},
                    },
                }
            ]
        )
        assert "tenants" not in summary

    def test_compact_concurrent_with_appender_loses_nothing(
        self, tmp_path
    ):
        """The satellite bugfix: a compaction racing a live appender
        must not drop the appended record. Without the mutate lock the
        append lands between compact()'s load and its os.replace and
        vanishes; with it, every hash appended by the writer thread
        survives every concurrent compaction."""
        import threading

        from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

        led = SweepLedger(str(tmp_path))
        N = 120
        stop = threading.Event()

        def appender():
            for i in range(N):
                led.attempt_start(i, f"h{i}", 1)
                led.attempt_end(
                    i, f"h{i}", 1, "completed", summary={"steps": 1}
                )
            stop.set()

        def compactor():
            while not stop.is_set():
                led.compact()
            led.compact()

        ta = threading.Thread(target=appender)
        tc = threading.Thread(target=compactor)
        ta.start()
        tc.start()
        ta.join(timeout=120)
        tc.join(timeout=120)
        assert stop.is_set()
        finished = led.finished()
        assert len(finished) == N, (
            f"compaction dropped {N - len(finished)} settled records"
        )
        attempts = led.attempts()
        assert all(attempts[f"h{i}"] == 1 for i in range(N))


# --------------------------------------------------------------------
# runtime: end-to-end service drills (real training on virtual CPUs)
# --------------------------------------------------------------------


BASE = dict(batch_size=32, latent_dim=4, log_interval=1000)

_SERVICES: list = []


@pytest.fixture(autouse=True)
def _stop_services():
    """Every service a test made is drained and closed when it ends (its
    persist and prefetch threads joined), so nothing writes after the
    test; the RAM snapshot cache is left empty."""
    from multidisttorch_tpu_torch.train.checkpoint import snapshot_cache

    yield
    while _SERVICES:
        svc = _SERVICES.pop()
        try:
            svc._drain(reason="test end")
        finally:
            svc.close()
    snapshot_cache().clear()


def make_service(d, **kw):
    from multidisttorch_tpu_torch.service.runtime import SweepService

    kw.setdefault("data_rows", 128)
    kw.setdefault("verbose", False)
    kw.setdefault("device", "cpu")
    svc = SweepService(str(d), **kw)
    _SERVICES.append(svc)
    return svc


def run_until(svc, cond, timeout_s=300.0, max_ticks=200_000):
    """Tick until ``cond()``: a bounded count of ticks and a generous wall
    limit, never a wall-clock threshold tight enough to break under
    parallel test workers."""
    t0 = time.time()
    for _ in range(max_ticks):
        svc.tick()
        if cond():
            return True
        if time.time() - t0 > timeout_s:
            break
    return False


class TestServiceRuntime:
    def test_multi_tenant_e2e_with_copack(self, tmp_path):
        d = str(tmp_path)
        ca = SweepClient(d, tenant="alice")
        cb = SweepClient(d, tenant="bob")
        ids = [
            ca.submit({**BASE, "epochs": 1, "hidden_dim": 16, "seed": i})
            for i in range(2)
        ]
        ids.append(
            cb.submit({**BASE, "epochs": 1, "hidden_dim": 16, "seed": 9})
        )
        svc = make_service(tmp_path, n_slices=2, max_lanes=4)
        rep = svc.serve(exit_when_drained=True, max_wall_s=300)
        assert rep["outcome"] == "idle"
        assert sorted(rep["settled"]) == sorted(ids)
        assert set(rep["settled"].values()) == {"completed"}
        # Same shape bucket from DIFFERENT tenants co-packed into one
        # stacked placement:
        folded = fold_queue(load_queue(d))
        lanes = {folded[s]["last_placement"]["lanes"] for s in ids}
        assert lanes == {3}
        assert all(folded[s]["last_placement"]["stacked"] for s in ids)
        books = rep["books"]
        assert books["tenants"]["alice"]["goodput"] == 1.0
        assert books["tenants"]["bob"]["settled"] == 1
        assert books["queue_wait"]["count"] == 3
        assert books["placement_latency"]["count"] >= 1

    def test_invalid_config_rejected_not_crashed(self, tmp_path):
        d = str(tmp_path)
        c = SweepClient(d)
        bad = c.submit({"no_such_field": 1})
        huge = c.submit({**BASE, "epochs": 1, "hidden_dim": 16}, size=99)
        ok = c.submit({**BASE, "epochs": 1, "hidden_dim": 16})
        svc = make_service(tmp_path, n_slices=2, max_lanes=2)
        rep = svc.serve(exit_when_drained=True, max_wall_s=300)
        assert rep["settled"][bad] == "rejected_invalid"
        assert rep["settled"][huge] == "rejected_invalid"
        assert rep["settled"][ok] == "completed"

    def test_quota_rejection_journaled(self, tmp_path):
        d = str(tmp_path)
        c = SweepClient(d, tenant="q")
        ids = [
            c.submit({**BASE, "epochs": 1, "hidden_dim": 16, "seed": i})
            for i in range(3)
        ]
        svc = make_service(
            tmp_path,
            n_slices=2,
            max_lanes=2,
            policies={"q": TenantPolicy(max_pending=2)},
        )
        rep = svc.serve(exit_when_drained=True, max_wall_s=300)
        statuses = sorted(rep["settled"][s] for s in ids)
        assert statuses == ["completed", "completed", "rejected_quota"]

    def test_divergent_trial_settles_diverged(self, tmp_path):
        d = str(tmp_path)
        c = SweepClient(d)
        sid = c.submit(
            {**BASE, "epochs": 1, "hidden_dim": 16, "lr": 1e18}
        )
        svc = make_service(tmp_path, n_slices=1, max_lanes=1)
        rep = svc.serve(exit_when_drained=True, max_wall_s=300)
        assert rep["settled"][sid] == "diverged"

    def test_restart_recovery_resumes_from_checkpoint(self, tmp_path):
        d = str(tmp_path)
        c = SweepClient(d)
        ids = [
            c.submit({**BASE, "epochs": 4, "hidden_dim": 16, "seed": i})
            for i in range(4)
        ]
        svc = make_service(tmp_path, n_slices=2, max_lanes=1)
        # "Crash" once a checkpoint exists: no drain, just abandon.
        assert run_until(
            svc,
            lambda: any(
                os.path.exists(
                    os.path.join(d, f"trial-{t}", "state.msgpack")
                )
                for t in range(4)
            ),
        )
        assert not svc.settled or len(svc.settled) < 4
        del svc
        svc2 = make_service(tmp_path, n_slices=2, max_lanes=1)
        assert len(svc2.entries) >= 1  # recovered live submissions
        rep = svc2.serve(exit_when_drained=True, max_wall_s=300)
        assert sorted(rep["settled"]) == sorted(ids)
        assert set(rep["settled"].values()) == {"completed"}
        folded = fold_queue(load_queue(d))
        # At least one trial re-placed with the scan-back resume flag.
        resumed = [
            s for s in ids
            if (folded[s].get("last_placement") or {}).get("resumed")
        ]
        assert resumed
        # Goodput stays honest: useful <= executed.
        tb = rep["books"]["tenants"]["default"]
        assert tb["useful_steps"] <= tb["executed_steps"]

    def test_recovery_never_reuses_assigned_trial_ids(self, tmp_path):
        """Regression: a submission journaled `submitted` but killed
        before its `admitted` record goes through admission on
        restart — its fresh trial id must not collide with ids the
        previous incarnation already assigned."""
        d = str(tmp_path)
        c = SweepClient(d)
        q = SubmissionQueue(d)
        admitted_sid = c.submit({**BASE, "epochs": 1, "hidden_dim": 16})
        pending_sid = c.submit(
            {**BASE, "epochs": 1, "hidden_dim": 24, "seed": 7}
        )
        q.drain_intake(known_ids=set())
        # Previous incarnation admitted ONE (tid 3, a high id), then
        # died before admitting the other.
        q.admitted(admitted_sid, trial_id=3, chash="h3", bucket="b")
        svc = make_service(tmp_path, n_slices=2, max_lanes=1)
        folded = fold_queue(load_queue(d))
        tids = {
            folded[s]["trial_id"] for s in (admitted_sid, pending_sid)
        }
        assert folded[pending_sid]["trial_id"] not in (None, 3)
        assert len(tids) == 2  # no collision
        assert svc.next_trial_id > max(tids)
        rep = svc.serve(exit_when_drained=True, max_wall_s=300)
        assert set(rep["settled"].values()) == {"completed"}

    def test_drain_records_preempted_and_unplaced(self, tmp_path):
        d = str(tmp_path)
        c = SweepClient(d)
        sid = c.submit({**BASE, "epochs": 30, "hidden_dim": 16})
        svc = make_service(tmp_path, n_slices=1, max_lanes=1)
        assert run_until(svc, lambda: bool(svc.active))
        svc.stop()
        rep = svc.serve(exit_when_drained=True, max_wall_s=60)
        assert rep["outcome"] == "preempted"
        from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

        folded = fold_queue(load_queue(d))
        assert folded[sid]["state"] == ADMITTED  # unplaced, not lost
        led_events = [
            e
            for e in SweepLedger(d).load()
            if e.get("event") == "attempt_end"
        ]
        assert led_events and led_events[-1]["status"] == "preempted"
        assert led_events[-1]["tenant"] == "default"

    def test_defrag_unblocks_starved_large_trial(self, tmp_path):
        from multidisttorch_tpu_torch import telemetry

        d = str(tmp_path)
        tel = os.path.join(d, "telemetry")
        c = SweepClient(d, tenant="t")
        with telemetry.telemetry_run(tel):
            svc = make_service(
                tmp_path,
                n_slices=4,
                max_lanes=1,
                starvation_s=0.3,
                defrag_cooldown_s=0.1,
            )
            # Pin the layout: short@0, long@1, short@2, long@3.
            for cfg in (
                {**BASE, "epochs": 1, "hidden_dim": 16},
                {**BASE, "epochs": 40, "hidden_dim": 24},
                {**BASE, "epochs": 1, "hidden_dim": 40},
                {**BASE, "epochs": 40, "hidden_dim": 56},
            ):
                c.submit(cfg)
                assert run_until(
                    svc, lambda: svc.sched.pending_count() == 0
                )
            # Shorts finish -> non-adjacent holes; big starves.
            assert run_until(
                svc,
                lambda: sum(
                    1 for s in svc.settled.values() if s == "completed"
                ) >= 2,
            )
            assert svc.pool.largest_free_run() < 2 <= svc.pool.free_total
            big = c.submit(
                {**BASE, "epochs": 1, "hidden_dim": 16, "seed": 9},
                size=2,
            )
            assert run_until(
                svc, lambda: svc.settled.get(big) == "completed"
            )
            # Migrated victims still finish (scan-back restore worked).
            assert run_until(svc, lambda: len(svc.settled) == 5, 300)
            assert set(svc.settled.values()) == {"completed"}
            svc._drain(reason="test end")
            events = telemetry.read_events(
                os.path.join(tel, "events.jsonl")
            )
        kinds = [e["kind"] for e in events]
        assert "defrag_start" in kinds
        assert "defrag_move" in kinds
        assert "defrag_end" in kinds
        assert "trial_migrated" in kinds
        end = next(e for e in events if e["kind"] == "defrag_end")
        assert end["data"]["freed_contiguous"] >= 2
        placed_big = [
            e
            for e in events
            if e["kind"] == "trial_placed"
            and (e.get("data") or {}).get("sub_id") == big
        ]
        assert placed_big and placed_big[-1]["ts"] >= end["ts"]

    def test_defrag_waits_for_unflushed_checkpoint(self, tmp_path):
        """Invariant at the RUNTIME level: a placement with progress
        but no checkpoint the drain can account for (none durable,
        none in flight) reports unmovable, so the planner cannot choose
        it; the snapshot-fast drain (the default) adopts an in-flight
        write, and the join drain defers it until the write lands."""
        import threading

        from multidisttorch_tpu_torch.service.runtime import _Active

        class FakeRun:
            def __init__(self):
                self._ckpt_thread = threading.Thread(
                    target=time.sleep, args=(30,), daemon=True
                )
                self._step_no = 8

                class R:
                    checkpoint = "/some/ckpt"

                self.result = R()

        ap = _Active(
            placement_id=0, start=0, size=1, stacked=False,
            run=FakeRun(), gen=None, entries={}, place_ts=0.0,
            construct_s=0.0,
        )
        ap.run._ckpt_thread.start()
        assert not ap.movable(snapshot_drain=False)  # join drain: write in flight
        ap.run.result.checkpoint = ""
        assert ap.movable()  # no durable ckpt, but the write in flight is adopted
        ap.run._ckpt_thread.join(timeout=0.01)
        ap.run._ckpt_thread = None
        assert not ap.movable()  # progress but nothing durable or in flight
        ap.run.result.checkpoint = "/some/ckpt"
        assert ap.movable()  # flushed
        assert ap.movable(snapshot_drain=False)  # flushed, the join drain too
        ap.run.result.checkpoint = ""
        assert not ap.movable(snapshot_drain=False)  # progress but nothing durable
        ap.run._step_no = 0
        assert ap.movable()  # nothing to lose
        assert ap.movable(snapshot_drain=False)
        # Stacked placements are movable: the bucket drain snapshots
        # every live lane at its epoch boundary itself, and adopts an
        # in-flight lane persist; only the join drain defers it.
        ap.run._step_no = 8
        ap.stacked = True
        assert ap.movable()
        assert ap.movable(snapshot_drain=False)
        ap.run._ckpt_thread = threading.Thread(
            target=time.sleep, args=(30,), daemon=True
        )
        ap.run._ckpt_thread.start()
        assert not ap.movable(snapshot_drain=False)  # join drain defers
        assert ap.movable()  # adopted in-flight write
        assert ap.movable(snapshot_drain=True)


# --------------------------------------------------------------------
# tools
# --------------------------------------------------------------------


class TestTools:
    def test_sweep_submit_cli(self, tmp_path, capsys):
        from multidisttorch_tpu_torch.examples import sweep_submit

        rc = sweep_submit.main(
            [
                str(tmp_path), "--tenant", "cli", "--priority", "0",
                "--epochs", "2", "--hidden-dim", "32", "--count", "2",
                "--json",
            ]
        )
        assert rc == 0
        payload = json.loads(capsys.readouterr().out)
        ids = payload["submitted"]
        assert len(ids) == 2 and all(s.startswith("cli-") for s in ids)
        q = SubmissionQueue(str(tmp_path))
        fresh = q.drain_intake(known_ids=set())
        assert len(fresh) == 2
        assert {s.config["seed"] for s in fresh} == {0, 1}
        assert all(s.priority == 0 for s in fresh)
        assert all(s.config["hidden_dim"] == 32 for s in fresh)


# --------------------------------------------------------------------
# the copies against their originals (exact)
# --------------------------------------------------------------------


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True, default=str))


def _write_journal(d, qmod):
    """A journal through one package's client and queue: five submissions
    of two tenants (priorities, sizes, a deadline), each state transition
    (admit, place, unplace, re-place, settle, reject), a fencing epoch."""
    ca, cb = qmod.SweepClient(d, tenant="alice"), qmod.SweepClient(d, tenant="bob")
    ids = [ca.submit({**BASE, "epochs": 1, "seed": i}, priority=i % 3, size=1 + i % 2,
                     deadline_s=30.0 if i == 2 else None) for i in range(4)]
    ids.append(cb.submit({**BASE, "epochs": 2}))
    q = qmod.SubmissionQueue(d, epoch=4)
    assert len(q.drain_intake(known_ids=set())) == 5
    q.admitted(ids[0], trial_id=0, chash="h0", bucket="b0")
    q.placed(ids[0], trial_id=0, start=0, size=1, lanes=2, stacked=True, resumed=False)
    q.unplaced(ids[0], trial_id=0, reason="defrag migration")
    q.placed(ids[0], trial_id=0, start=2, size=1, lanes=1, stacked=False, resumed=True)
    q.settled(ids[0], trial_id=0, status="completed")
    q.admitted(ids[1], trial_id=1, chash="h1", bucket="b1")
    q.rejected(ids[2], verdict=REJECT_QUOTA, reason="over quota")
    q.admitted(ids[4], trial_id=2, chash="h2", bucket="b0")
    q.placed(ids[4], trial_id=2, start=0, size=1, lanes=1, stacked=False, resumed=False)
    q.settled(ids[4], trial_id=2, status="failed", error="RuntimeError: boom")
    return ids


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("torn", [False, True])
def test_fold_queue_equals_the_jax_fold(tmp_path, writer, torn):
    from multidisttorch_tpu.service import queue as jqueue
    from multidisttorch_tpu_torch.service import queue as pqueue

    d = str(tmp_path)
    _write_journal(d, pqueue if writer == "port" else jqueue)
    if torn:
        with open(queue_path(d), "a") as f:
            f.write('{"event": "settled", "submission_id": "x", "sta')
    pf, jf = fold_queue(load_queue(d)), jqueue.fold_queue(jqueue.load_queue(d))
    assert _json(pf) == _json(jf) and len(pf) == 5
    ps, js = QueueStats.of(pf), jqueue.QueueStats.of(jf)
    assert (ps.by_state, ps.by_tenant) == (js.by_state, js.by_tenant)
    # The incremental reader agrees with the whole-file fold.
    recs, _ = pqueue.read_jsonl_from(queue_path(d), 0)
    assert recs == jqueue.read_jsonl_from(queue_path(d), 0)[0]


def _scheduler_trace(smod, seed: int) -> list:
    """A seeded stream of submissions (three tenants, weights 2:1:1, four
    priorities and sizes, deadlines, a can_start veto) through one
    package's scheduler over 8 slices: every verdict, placement (start,
    size, members, bucket), starvation clock and the fair-share report."""
    import random

    rng = random.Random(seed)
    sched = smod.FairShareScheduler(
        {"a": smod.TenantPolicy(weight=2.0, max_pending=8), "b": smod.TenantPolicy(weight=1.0, max_pending=5)},
        max_total_pending=16)
    pool = smod.SlicePool(8)
    out, running, n, now = [], [], 0, 0.0
    for _ in range(80):
        now += 1.0
        for _ in range(rng.randint(0, 4)):
            tenant = rng.choice("abc")
            verdict = sched.admit_verdict(tenant)
            out.append(("verdict", tenant, verdict))
            if verdict[0] != smod.ADMIT:
                continue
            sched.push(smod.PendingTrial(
                sub_id=f"s{n}", tenant=tenant, priority=rng.choice((0, 1, 1, 2)), cfg=None,
                bucket=(rng.randint(0, 2),), size=rng.choice((1, 1, 2, 4)), cost=float(rng.randint(5, 20)),
                submit_ts=now, trial_id=n, deadline_ts=now + rng.uniform(2, 10) if rng.random() < 0.2 else None),
                now=now)
            n += 1
        for p in sched.schedule(pool, max_lanes=3, now=now, can_start=lambda e: e.trial_id % 7 != 3 or now > 40):
            out.append(("placed", p.start, p.size, [m.sub_id for m in p.members], str(p.bucket)))
            running.append((p, now + rng.randint(1, 4)))
        out.append(("starved", [e.sub_id for e in sched.starved_entries(threshold_s=2.0, now=now)]))
        out.append(("clocks", sorted((e.sub_id, e.blocked_since) for e in sched.pending_entries())))
        out.append(("deadline", [e.sub_id for e in sched.deadline_pending(now=now)]))
        for p, end in list(running):
            if end <= now:
                running.remove((p, end))
                pool.free(p.start, p.size)
    out.append(("fair", sched.fair_share_report()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_stream_equals_the_jax_scheduler(seed):
    from multidisttorch_tpu.service import scheduler as jsched
    from multidisttorch_tpu_torch.service import scheduler as psched

    port, ref = _scheduler_trace(psched, seed), _scheduler_trace(jsched, seed)
    assert _json(port) == _json(ref)
    assert any(x[0] == "placed" and len(x[3]) > 1 for x in port)  # co-packing happened
    assert any(x[0] == "verdict" and x[2][0] != ADMIT for x in port)  # and refusals


@pytest.mark.parametrize("seed", range(6))
def test_defrag_and_preemption_plans_equal_the_jax_plans(seed):
    import random

    from multidisttorch_tpu.service import defrag as jdefrag
    from multidisttorch_tpu.service import scheduler as jsched
    from multidisttorch_tpu_torch.service import defrag as pdefrag
    from multidisttorch_tpu_torch.service import scheduler as psched

    rng = random.Random(seed)
    n = rng.randint(4, 12)
    layout, start, pid = [], 0, 0
    while start < n:
        size = min(rng.choice((1, 1, 2, 3)), n - start)
        if rng.random() < 0.6:
            layout.append((pid, start, size, rng.random() < 0.75, tuple([1] * size) if rng.random() < 0.3 else ()))
            pid += 1
        start += size

    def plans(smod, dmod):
        pool = smod.SlicePool(n)
        for _, st, sz, _, _ in layout:
            assert pool.alloc_at(st, sz)
        blocks = [dmod.PlacedBlock(placement_id=p, start=st, size=sz, movable=mv, rehome_sizes=rh)
                  for p, st, sz, mv, rh in layout]
        return [(want, dmod.plan_defrag(pool, blocks, want), dmod.plan_preemption(pool, blocks, want))
                for want in range(1, n + 1)]

    port, ref = plans(psched, pdefrag), plans(jsched, jdefrag)
    assert repr(port).replace("multidisttorch_tpu_torch", "X") == repr(ref).replace("multidisttorch_tpu", "X")


def test_snapshot_cache_matches_the_jax_cache(tmp_path):
    """The RAM snapshot cache: the JAX cache's LRU bound, drop and
    drop_under, operation for operation."""
    from multidisttorch_tpu.train import checkpoint as jck
    from multidisttorch_tpu_torch.train import checkpoint as pck

    caches = (pck._SnapshotCache(3), jck._SnapshotCache(3))
    paths = [str(tmp_path / d / f"trial-{i}" / "state.msgpack") for d in ("a", "b") for i in range(3)]
    got = []
    for c in caches:
        trace = []
        for i, p in enumerate(paths):
            c.put(p, {"step": i}, {"completed_epochs": i})
            c.get(paths[0])
            trace.append(len(c))
        trace.append([c.get(p) is not None for p in paths])
        c.drop(paths[-1])
        trace.append(c.drop_under(str(tmp_path / "b")))
        trace.append([c.get(p) for p in paths])
        got.append(trace)
    assert got[0] == got[1]
    assert pck.snapshot_cache() is pck.snapshot_cache() and pck.RAM_SNAPSHOT == jck.RAM_SNAPSHOT


# --------------------------------------------------------------------
# the port's service against the JAX service
# --------------------------------------------------------------------


@pytest.fixture
def carried(monkeypatch):
    """The JAX package's initial weights for every port trial (the port's
    own init draws other numbers: ROADMAP C.2)."""
    from test_torch_hpo import _jax_initial_params

    from multidisttorch_tpu_torch.hpo import driver

    def init_from_jax(model, seed):
        model.load_state_dict(_jax_initial_params(seed, model.hidden_dim, model.latent_dim))
        return model

    monkeypatch.setattr(driver, "init_vae_params", init_from_jax)


def _submit_mix(d, qmod, **over):
    """Two same-shape trials of two tenants (they co-pack) and one of
    another width (alone); all place in the first scheduling pass."""
    ca, cb = qmod.SweepClient(d, tenant="alice"), qmod.SweepClient(d, tenant="bob")
    cfg = dict(BASE, epochs=2, hidden_dim=16, **over)
    return [ca.submit({**cfg, "seed": 0}), cb.submit({**cfg, "seed": 1}),
            ca.submit({**cfg, "hidden_dim": 24, "seed": 2})]


def synthetic_test_rows():
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist

    return synthetic_mnist(64, seed=1)


def _final_losses(d):
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

    return {e["trial_id"]: e["summary"]["final_test_loss"] for e in SweepLedger(d).load()
            if e.get("event") == "attempt_end" and e.get("status") == "completed"}


def test_service_matches_the_jax_service(tmp_path, carried):
    """The same submissions through both services: the same settled
    statuses, placements (start, size, lanes, stacked) and tenant books;
    at lr 0 every trial's final test loss equals the JAX service's at rel
    1e-5 (the weights never move and the eval is the posterior mean; only
    the training noise differs, ROADMAP C.2, C.5). The port's journal and
    ledger then fold alike through both packages."""
    from multidisttorch_tpu.service import queue as jqueue
    from multidisttorch_tpu.service import runtime as jruntime
    from multidisttorch_tpu_torch.service import queue as pqueue
    from multidisttorch_tpu_torch.service import runtime as pruntime

    test = synthetic_test_rows()
    # One set of submission records (ids, submit times, trace ids) spooled
    # into both services' intakes: their order is the scheduler's input.
    ids = _submit_mix(str(tmp_path / "records"), pqueue, lr=0.0)
    records = [pqueue.Submission.from_dict(json.load(open(os.path.join(intake_dir(str(tmp_path / "records")),
                                                                          s + ".json")))).to_dict() for s in ids]
    reports = {}
    for name, qmod in (("port", pqueue), ("jax", jqueue)):
        d = str(tmp_path / name)
        for rec in records:
            qmod.spool_submission(d, qmod.Submission.from_dict(rec))
        if name == "port":
            svc = make_service(d, n_slices=2, max_lanes=2, test_data=test)
        else:
            svc = jruntime.SweepService(d, n_slices=2, max_lanes=2, data_rows=128, test_data=test, verbose=False)
        rep = svc.serve(exit_when_drained=True, max_wall_s=300)
        folded = qmod.fold_queue(qmod.load_queue(d))
        reports[name] = {
            "settled": [rep["settled"][s] for s in ids],
            "placements": [{k: folded[s]["last_placement"][k] for k in ("start", "size", "lanes", "stacked")}
                           for s in ids],
            "tenants": rep["books"]["tenants"],
            "trial_ids": [folded[s]["trial_id"] for s in ids],
            "losses": _final_losses(d),
        }
    port, ref = reports["port"], reports["jax"]
    assert port["settled"] == ref["settled"] == ["completed"] * 3
    assert port["placements"] == ref["placements"]
    assert port["placements"][0]["stacked"] and port["placements"][0]["lanes"] == 2
    assert port["tenants"] == ref["tenants"]
    assert port["trial_ids"] == ref["trial_ids"]
    assert set(port["losses"]) == set(ref["losses"]) == {0, 1, 2}
    for tid, loss in port["losses"].items():
        assert loss == pytest.approx(ref["losses"][tid], rel=1e-5)
    # The port's durable files fold alike through both packages.
    d = str(tmp_path / "port")
    assert _json(pqueue.fold_queue(pqueue.load_queue(d))) == _json(jqueue.fold_queue(jqueue.load_queue(d)))
    led, _ = pqueue.read_jsonl_from(os.path.join(d, "sweep_ledger.jsonl"), 0)
    assert pruntime.fold_tenant_goodput(led) == jruntime.fold_tenant_goodput(led)
    assert pruntime.fold_tenant_goodput(led)["alice"]["goodput"] == 1.0


def _ckpt_tree(path):
    from multidisttorch_tpu_torch.train import checkpoint as ck

    tree, _ = ck._read_tree_format(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    return tree, meta


def _assert_same_ckpt(a, b):
    import numpy as np

    ta, ma = _ckpt_tree(a)
    tb, mb = _ckpt_tree(b)

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{pre}/{k}")
        else:
            yield pre, np.asarray(t)

    la, lb = dict(leaves(ta)), dict(leaves(tb))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].tobytes() == lb[k].tobytes(), k
    for k in ("completed_epochs", "step", "history"):
        assert ma[k] == mb[k], k
    # The train noise stream (a stacked lane's checkpoint carries only it).
    assert ma["torch_generators"]["train"] == mb["torch_generators"]["train"]


def _run_hpo_ckpt(tmp_path, cfg_dict, trial_id, name, **kw):
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    cfgs = [TrialConfig(trial_id=t, **c) for t, c in zip(trial_id, cfg_dict)] if isinstance(trial_id, list) else \
        [TrialConfig(trial_id=trial_id, **cfg_dict)]
    out = str(tmp_path / name)
    run_hpo(cfgs, synthetic_mnist(128, seed=0), None, groups=setup_groups(1, devices=["cpu"]), out_dir=out,
            save_images=False, verbose=False, **kw)
    return out


def test_unstacked_and_copacked_trials_equal_run_hpo_bitwise(tmp_path):
    """An unstacked service trial ends bit-identical to run_hpo of the same
    config and trial id; a co-packed lane ends bit-identical to its
    unstacked run (the CPU's stacking contract)."""
    from multidisttorch_tpu_torch.service import queue as pqueue

    d = str(tmp_path / "svc")
    ids = _submit_mix(d, pqueue)
    svc = make_service(d, n_slices=2, max_lanes=2)
    rep = svc.serve(exit_when_drained=True, max_wall_s=300)
    assert [rep["settled"][s] for s in ids] == ["completed"] * 3
    folded = fold_queue(load_queue(d))
    for s in ids:
        tid = folded[s]["trial_id"]
        cfg = dict(folded[s]["config"])
        ref = _run_hpo_ckpt(tmp_path, cfg, tid, f"ref{tid}")
        _assert_same_ckpt(os.path.join(d, f"trial-{tid}", "state.msgpack"),
                          os.path.join(ref, f"trial-{tid}", "state.msgpack"))
    assert folded[ids[0]]["last_placement"]["stacked"] and not folded[ids[2]]["last_placement"]["stacked"]


# --------------------------------------------------------------------
# the snapshot-fast drain and resume
# --------------------------------------------------------------------


def _one_active(svc):
    assert len(svc.active) == 1
    return next(iter(svc.active.values()))


@pytest.mark.parametrize("from_ram", [True, False])
def test_migrated_victim_ends_bitwise(tmp_path, from_ram):
    """A placement drained mid-epoch (after its first checkpoint) through
    the defrag migration primitive re-places and ends bit-identical to its
    uninterrupted run: from the RAM snapshot, and from disk through the
    scan-back restore once the snapshot is dropped (a re-place in another
    process)."""
    from multidisttorch_tpu_torch.train.checkpoint import ckpt_counters, snapshot_cache

    d = str(tmp_path / "svc")
    c = SweepClient(d, tenant="t")
    cfg = dict(BASE, epochs=3, hidden_dim=16, seed=4)
    sid = c.submit(cfg)
    svc = make_service(d, n_slices=2, max_lanes=1, defrag_enabled=False)
    path = os.path.join(d, "trial-0", "state.msgpack")
    # Past the first epoch's checkpoint, into the second epoch.
    assert run_until(svc, lambda: svc.active and _one_active(svc).run.state.step >= 6)
    ap = _one_active(svc)
    if not from_ram:
        # The scan-back restore reads the first epoch's checkpoint: let
        # its write land.
        t = ap.run._ckpt_thread
        if t is not None:
            t.join()
    assert ap.movable()
    restores = ckpt_counters()
    (entry,) = svc._checkpoint_drain(ap, reason="defrag migration", pinned_start=1, front=True)
    if not from_ram:
        snapshot_cache().drop(path)
    assert entry.resume_scan and not svc.active
    assert (snapshot_cache().get(path) is not None) == from_ram
    assert run_until(svc, lambda: svc.settled.get(sid) is not None)
    assert svc.settled[sid] == "completed"
    got = ckpt_counters()
    assert got["restores"] - restores["restores"] == 1
    assert got["restores_ram"] - restores["restores_ram"] == (1 if from_ram else 0)
    folded = fold_queue(load_queue(d))
    assert folded[sid]["placements"] == 2 and folded[sid]["last_placement"]["start"] == 1
    ref = _run_hpo_ckpt(tmp_path, cfg, 0, "ref")
    _assert_same_ckpt(path, os.path.join(ref, "trial-0", "state.msgpack"))
    books = svc.books()["checkpoint"]
    assert books["drain_snapshot"]["count"] == 1 and books["drain_persist"]["count"] == 1


@pytest.mark.parametrize("snapshot_drain", [True, False])
def test_drained_stacked_bucket_ends_bitwise(tmp_path, snapshot_drain):
    """A co-packed bucket drained at a round boundary (its lanes snapshot
    together, then re-place as unstacked trials restoring from RAM) ends
    bit-identical to the undisturbed bucket. Under the join drain the
    lanes' writes are joined inside the drain, each lane is recorded
    ``preempted`` before it returns, and the re-placed trials restore from
    disk."""
    from multidisttorch_tpu_torch.train.checkpoint import ckpt_counters

    d = str(tmp_path / "svc")
    ca, cb = SweepClient(d, tenant="a"), SweepClient(d, tenant="b")
    cfgs = [dict(BASE, epochs=3, hidden_dim=16, seed=s) for s in (0, 1)]
    ids = [ca.submit(cfgs[0]), cb.submit(cfgs[1])]
    svc = make_service(d, n_slices=2, max_lanes=2, defrag_enabled=False, snapshot_drain=snapshot_drain)
    assert run_until(svc, lambda: svc.active and _one_active(svc).run.lanes[0] is not None
                     and _one_active(svc).run.lanes[0]["steps"] >= 6)
    ap = _one_active(svc)
    assert ap.stacked and ap.movable(svc.snapshot_drain)
    restores = ckpt_counters()
    entries = svc._checkpoint_drain(ap, reason="deadline preemption")
    assert len(entries) == 2 and not svc.active
    if not snapshot_drain:
        assert not svc._pending_persists and ap.run._ckpt_idle()
        with open(svc.ledger.path) as f:
            assert f.read().count('"preempted"') == 2
    assert run_until(svc, lambda: len(svc.settled) == 2)
    assert set(svc.settled.values()) == {"completed"}
    got = ckpt_counters()
    assert got["restores_ram"] - restores["restores_ram"] == (2 if snapshot_drain else 0)
    assert got["restores"] - restores["restores"] == 2
    folded = fold_queue(load_queue(d))
    assert all(not folded[s]["last_placement"]["stacked"] for s in ids)
    ref = _run_hpo_ckpt(tmp_path, cfgs, [0, 1], "ref", stack_trials=True, stack_max_lanes=2)
    for tid in (0, 1):
        _assert_same_ckpt(os.path.join(d, f"trial-{tid}", "state.msgpack"),
                          os.path.join(ref, f"trial-{tid}", "state.msgpack"))


def test_run_hpo_sigterm_drain_snapshots_stacked_lanes(tmp_path, monkeypatch):
    """run_hpo's SIGTERM drain of a stacked bucket: the bucket finishes its
    round, every live lane's drain snapshot is written (an unstacked
    trial's checkpoint) and recorded ``preempted``, and HostPreemption is
    raised; an unstacked resume then ends bit-identical to the undisturbed
    bucket."""
    import signal as _signal

    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.faults.inject import HostPreemption
    from multidisttorch_tpu_torch.hpo import driver
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    cfgs = [dict(BASE, epochs=3, hidden_dim=16, seed=s) for s in (0, 1)]
    configs = [driver.TrialConfig(trial_id=i, **c) for i, c in enumerate(cfgs)]
    dispatch = driver._StackedBucketRun._dispatch
    calls = []

    def signalled(self, chunk, k_live):
        calls.append(1)
        if len(calls) == 6:  # mid-second round (4 steps a round)
            driver._DRAIN["sig"] = _signal.SIGTERM
        return dispatch(self, chunk, k_live)

    monkeypatch.setattr(driver._StackedBucketRun, "_dispatch", signalled)
    out = str(tmp_path / "drained")
    kw = dict(groups=setup_groups(1, devices=["cpu"]), out_dir=out, save_images=False, verbose=False)
    with pytest.raises(HostPreemption):
        driver.run_hpo(configs, synthetic_mnist(128, seed=0), None, stack_trials=True, stack_max_lanes=2, **kw)
    assert len(calls) == 8  # the round in flight finished, no more
    for tid in (0, 1):
        _, meta = _ckpt_tree(os.path.join(out, f"trial-{tid}", "state.msgpack"))
        assert meta["completed_epochs"] == 2 and meta["step"] == 8
    ends = [e for e in SweepLedger(out).load() if e.get("event") == "attempt_end"]
    assert sorted((e["trial_id"], e["status"]) for e in ends) == [(0, "preempted"), (1, "preempted")]
    monkeypatch.setattr(driver._StackedBucketRun, "_dispatch", dispatch)
    results = driver.run_hpo(configs, synthetic_mnist(128, seed=0), None, resume=True, **kw)
    assert [r.status for r in results] == ["completed", "completed"]
    assert [r.resumed_from_step for r in results] == [8, 8]
    ref = _run_hpo_ckpt(tmp_path, cfgs, [0, 1], "ref", stack_trials=True, stack_max_lanes=2)
    for tid in (0, 1):
        _assert_same_ckpt(os.path.join(out, f"trial-{tid}", "state.msgpack"),
                          os.path.join(ref, f"trial-{tid}", "state.msgpack"))


def test_pipeline_placement_fails_naming_a14(tmp_path):
    c = SweepClient(str(tmp_path))
    sid = c.submit({**BASE, "epochs": 1, "hidden_dim": 16, "pipeline_stages": 2})
    svc = make_service(tmp_path, n_slices=4, max_lanes=1)
    assert run_until(svc, lambda: sid in svc.settled)
    assert svc.settled[sid] == "failed"
    rec = fold_queue(load_queue(str(tmp_path)))[sid]
    assert "ROADMAP A.14" in rec["error"]
    # Not retried: the refusal is no infra fault.
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

    ends = [e for e in SweepLedger(str(tmp_path)).load() if e.get("event") == "attempt_end"]
    assert [e["status"] for e in ends] == ["failed"]
    assert svc.pool.free_total == 4


def test_slots_rule():
    import torch

    from multidisttorch_tpu_torch.service.runtime import slots_for

    assert slots_for(["cpu"], 4) == [torch.device("cpu")] * 4
    assert slots_for(["cuda:0", "cuda:1"], 4) == [torch.device("cuda", i) for i in (0, 0, 1, 1)]
    assert slots_for(None, 2, "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(NotImplementedError, match="A.12c"):
        slots_for(["cuda:0", "cuda:1"], 1)
    with pytest.raises(ValueError):
        slots_for(["cpu"] * 3, 2)


# --------------------------------------------------------------------
# the kill -9 drill on the CPU
# --------------------------------------------------------------------


def test_kill_restart_drill_loses_nothing(tmp_path):
    """run_kill_restart_phase through the port's CLI on the CPU: a daemon
    child SIGKILLed mid-sweep and restarted loses no submission, and each
    tenant's goodput across the kill is >= 0.8. The contended fair share
    is the JAX drill's fold of the same journal."""
    from multidisttorch_tpu.service.drill import _fair_share_from_journal as jax_fair
    from multidisttorch_tpu_torch.service.drill import run_kill_restart_phase

    r = run_kill_restart_phase(str(tmp_path), device="cpu")
    assert r["kill_exercised"], r["daemon_exits"]
    assert r["zero_lost"], r["lost_submissions"]
    assert r["tenant_goodput_floor_0.8"], r["tenant_goodput"]
    assert r["queue_wait"]["count"] and r["placement_latency"]["count"]
    assert [b["device"] for b in r["daemon_boots"]] == [["cpu"], ["cpu"]]
    fair = jax_fair(load_queue(os.path.join(str(tmp_path), "service")))
    assert {k: r["fair_share"][k] for k in ("placed", "contended")} == fair


@pytest.mark.parametrize("entry", ["run_kill_restart_phase", "run_defrag_phase", "run_service_bench"])
def test_drill_defaults_to_the_card(tmp_path, monkeypatch, entry):
    """The drill's entry points run on the card unless the caller asks for
    the CPU: with no device they raise where CUDA is absent, before any
    daemon child starts or any directory is written."""
    import torch

    from multidisttorch_tpu_torch.service import drill

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(drill, entry)(str(tmp_path / "work"))
    assert not os.path.exists(tmp_path / "work")
