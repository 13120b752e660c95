"""The port's end-to-end submission tracing and SLO engine
(``telemetry/trace.py`` and ``telemetry/slo.py``, copies of the JAX
package's), one test for each of ``tests/test_trace.py``'s with the same
assertions; the JAX file's ``sweep_trace`` CLI test is
``tests/test_torch_consoles.py``'s, and its two load-generator tests are
``tests/test_torch_loadgen.py``'s.

The honesty contracts under test:

- a SIGKILLed (or just absent) end reconstructs as an OPEN span —
  never a fabricated end;
- a torn journal tail costs exactly the torn record;
- a fabric failover's submission keeps ONE contiguous span tree
  spanning both fence epochs;
- the trace id minted at submit rides spool -> journal -> ledger;
- the SLO engine's burn-rate alerts are edge-triggered and its
  offline histogram evaluation is exact on bucket-aligned thresholds.
"""

import json
import os
import time

import pytest

from multidisttorch_tpu_torch.service import queue as squeue
from multidisttorch_tpu_torch.telemetry import slo as tslo
from multidisttorch_tpu_torch.telemetry import trace as ttrace
from multidisttorch_tpu_torch.telemetry.metrics import Histogram

pytestmark = pytest.mark.trace


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


def wfile(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def journal(d, records):
    wfile(os.path.join(d, squeue.QUEUE_NAME), records)


def ledger(d, records):
    wfile(os.path.join(d, "sweep_ledger.jsonl"), records)


def sub_rec(sid, ts, *, tenant="t", trace_id="", epoch=None, **cfg):
    rec = {
        "event": "submitted",
        "sub": {
            "submission_id": sid,
            "tenant": tenant,
            "config": cfg,
            "submit_ts": ts - 0.05,
            **({"trace_id": trace_id} if trace_id else {}),
        },
        "ts": ts,
    }
    if epoch is not None:
        rec["epoch"] = epoch
    return rec


def ev(kind, sid, ts, *, epoch=None, **extra):
    rec = {"event": kind, "submission_id": sid, "ts": ts, **extra}
    if epoch is not None:
        rec["epoch"] = epoch
    return rec


# --------------------------------------------------------------------
# trace ids ride the durable files
# --------------------------------------------------------------------


class TestTraceIds:
    def test_submit_mints_and_spools_trace_id(self, tmp_path):
        d = str(tmp_path)
        client = squeue.SweepClient(d, tenant="a")
        sid = client.submit({"epochs": 1})
        assert client.last_submission.trace_id
        with open(os.path.join(d, "intake", sid + ".json")) as f:
            spooled = json.load(f)
        assert spooled["trace_id"] == client.last_submission.trace_id

    def test_journal_transitions_carry_trace(self, tmp_path):
        d = str(tmp_path)
        client = squeue.SweepClient(d, tenant="a")
        sid = client.submit({"epochs": 1})
        q = squeue.SubmissionQueue(d)
        (sub,) = q.drain_intake(known_ids=set())
        q.admitted(sid, trial_id=0, chash="c", bucket="b")
        q.settled(sid, trial_id=0, status="completed")
        recs = squeue.load_queue(d)
        trace = sub.trace
        assert all(
            r.get("trace") == trace
            for r in recs
            if r.get("event") in ("admitted", "settled")
        )
        folded = squeue.fold_queue(recs)
        assert folded[sid]["trace_id"] == trace

    def test_legacy_records_derive_deterministically(self, tmp_path):
        d = str(tmp_path)
        journal(d, [sub_rec("old-1", 10.0), ev("admitted", "old-1", 10.1,
                                                trial_id=0)])
        folded = squeue.fold_queue(squeue.load_queue(d))
        derived = folded["old-1"]["trace_id"]
        assert derived == ttrace.default_trace_id("old-1")
        assert derived.startswith("d")

    def test_fenced_queue_stamps_epoch(self, tmp_path):
        d = str(tmp_path)
        q = squeue.SubmissionQueue(d, epoch=3)
        q.admitted("s", trial_id=0, chash="c", bucket="b")
        (rec,) = squeue.load_queue(d)
        assert rec["epoch"] == 3


# --------------------------------------------------------------------
# skeleton reconstruction
# --------------------------------------------------------------------


class TestSkeleton:
    def test_full_lifecycle_phases(self, tmp_path):
        d = str(tmp_path)
        journal(
            d,
            [
                sub_rec("s-1", 100.0, trace_id="abc"),
                ev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
                ev("placed", "s-1", 101.0, trial_id=0, start=0, size=1,
                   lanes=1, stacked=False, resumed=False),
                ev("settled", "s-1", 105.0, trial_id=0,
                   status="completed"),
            ],
        )
        traces = ttrace.build_submission_traces(d)
        tr = traces["s-1"]
        assert tr["trace_id"] == "abc"
        assert tr["state"] == squeue.SETTLED
        names = [s["name"] for s in tr["spans"]]
        assert names[0].startswith("submission")
        assert "spool_wait" in names and "admission" in names
        assert "queue_wait" in names and "placement #1" in names
        assert tr["open_spans"] == 0 and not tr["orphans"]
        bd = ttrace.latency_breakdown(tr)
        assert bd["total_s"] == pytest.approx(105.0 - 99.95, abs=1e-6)
        assert bd["phase_totals_s"]["queue_wait"] == pytest.approx(0.8)
        comp = ttrace.trace_completeness(traces)
        assert comp["complete"] and comp["settled_complete"] == 1

    def test_sigkill_leaves_honestly_open_spans(self, tmp_path):
        d = str(tmp_path)
        journal(
            d,
            [
                sub_rec("s-1", 100.0),
                ev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
                ev("placed", "s-1", 101.0, trial_id=0, start=0, size=1,
                   lanes=1, stacked=False, resumed=False),
                # ... SIGKILL: no further records ever land.
            ],
        )
        tr = ttrace.build_submission_traces(d)["s-1"]
        root = tr["spans"][0]
        placement = next(
            s for s in tr["spans"] if s["name"] == "placement #1"
        )
        assert root["end"] is None and placement["end"] is None
        assert tr["open_spans"] == 2  # root + placement, nothing invented
        bd = ttrace.latency_breakdown(tr)
        prow = next(r for r in bd["spans"] if r["name"] == "placement #1")
        assert prow["open"] and prow["dur_s"] is None
        # A live submission is REPORTED open, never failed:
        comp = ttrace.trace_completeness(
            ttrace.build_submission_traces(d)
        )
        assert comp["complete"] and comp["open_spans_live"] == 2

    def test_torn_journal_tail_drops_only_torn_record(self, tmp_path):
        d = str(tmp_path)
        journal(
            d,
            [
                sub_rec("s-1", 100.0),
                ev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
                ev("placed", "s-1", 101.0, trial_id=0, start=0, size=1,
                   lanes=1, stacked=False, resumed=False),
            ],
        )
        # Crash mid-append: half a 'settled' record, no newline.
        with open(os.path.join(d, squeue.QUEUE_NAME), "a") as f:
            f.write('{"event": "settled", "submission_id": "s-1", "sta')
        tr = ttrace.build_submission_traces(d)["s-1"]
        # The torn settle is gone — the trace honestly still shows the
        # submission PLACED with open spans; everything before the tear
        # survives intact.
        assert tr["state"] == squeue.PLACED
        assert tr["open_spans"] == 2
        assert any(s["name"] == "placement #1" for s in tr["spans"])

    def test_rejection_closes_at_admission(self, tmp_path):
        d = str(tmp_path)
        journal(
            d,
            [
                sub_rec("s-1", 100.0),
                ev("rejected", "s-1", 100.3, verdict="rejected_quota",
                   reason="over quota"),
            ],
        )
        traces = ttrace.build_submission_traces(d)
        tr = traces["s-1"]
        assert tr["state"] == squeue.REJECTED
        assert tr["spans"][0]["end"] == 100.3
        assert ttrace.trace_completeness(traces)["complete"]


# --------------------------------------------------------------------
# failover contiguity across fence epochs
# --------------------------------------------------------------------


class TestFailoverContiguity:
    def _failover_journal(self, d):
        journal(
            d,
            [
                sub_rec("s-1", 100.0, trace_id="tr1", epoch=1),
                ev("admitted", "s-1", 100.2, trial_id=0, bucket="b",
                   epoch=1),
                ev("placed", "s-1", 101.0, trial_id=0, start=0, size=1,
                   lanes=1, stacked=False, resumed=False, epoch=1),
                # SIGKILL here; the adopter (epoch 2) replays:
                ev("unplaced", "s-1", 104.0, trial_id=0,
                   reason="daemon restart recovery", epoch=2),
                ev("placed", "s-1", 104.5, trial_id=0, start=0, size=1,
                   lanes=1, stacked=False, resumed=True, epoch=2),
                ev("settled", "s-1", 108.0, trial_id=0,
                   status="completed", epoch=2),
            ],
        )

    def test_one_contiguous_tree_spanning_epochs(self, tmp_path):
        d = str(tmp_path)
        self._failover_journal(d)
        traces = ttrace.build_submission_traces(d)
        tr = traces["s-1"]
        assert tr["epochs"] == [1, 2]
        assert tr["epoch_takeovers"] == 1
        takeover = next(
            s for s in tr["spans"] if s["name"].startswith("fence_takeover")
        )
        assert takeover["tags"]["from_epoch"] == 1
        assert takeover["tags"]["to_epoch"] == 2
        # First placement CLOSED by the adopter's unplaced record (the
        # truth: the old submesh died with the old daemon), second
        # placement closed by settle — zero open, zero orphans.
        p1, p2 = [
            s for s in tr["spans"] if s["name"].startswith("placement")
        ]
        assert p1["end"] == 104.0 and p1["tags"]["epoch"] == 1
        assert p2["end"] == 108.0 and p2["tags"]["epoch"] == 2
        comp = ttrace.trace_completeness(traces)
        assert comp["complete"]
        assert comp["epoch_takeovers"] == 1
        assert comp["multi_epoch_submissions"] == 1

    def test_ledger_attempts_attach_across_epochs(self, tmp_path):
        d = str(tmp_path)
        self._failover_journal(d)
        ledger(
            d,
            [
                {"event": "attempt_start", "trial_id": 0,
                 "config_hash": "c", "attempt": 1, "trace": "tr1",
                 "ts": 100.9, "epoch": 1},
                # No attempt_end from epoch 1 — the daemon died.
                {"event": "attempt_start", "trial_id": 0,
                 "config_hash": "c", "attempt": 2, "trace": "tr1",
                 "ts": 104.4, "epoch": 2},
                {"event": "attempt_end", "trial_id": 0,
                 "config_hash": "c", "attempt": 2,
                 "status": "completed", "ts": 107.9, "epoch": 2},
            ],
        )
        tr = ttrace.build_submission_traces(d)["s-1"]
        attempts = [
            s
            for s in tr["spans"]
            if s["name"].startswith("attempt") and s["kind"] == "span"
        ]
        assert len(attempts) == 2
        a1, a2 = sorted(attempts, key=lambda s: s["start"])
        # The killed attempt stays OPEN (no invented end) but is NOT an
        # orphan — it attaches to epoch 1's placement.
        assert a1["end"] is None
        assert a2["end"] == 107.9 and a2["tags"]["status"] == "completed"
        assert not tr["orphans"]

    def test_setup_attempt_attaches_to_queue_wait(self, tmp_path):
        """A setup-phase failure ledgers attempts WITHOUT any `placed`
        journal record (the runtime's _setup_failed path): the attempt
        belongs to the queue_wait covering it — not an orphan, and the
        requeue closes the previous wait (no open-span leak)."""
        d = str(tmp_path)
        journal(
            d,
            [
                sub_rec("s-1", 100.0),
                ev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
                ev("unplaced", "s-1", 100.6, trial_id=0,
                   reason="setup retry: ValueError: bad dataset"),
                ev("settled", "s-1", 101.0, trial_id=0,
                   status="failed"),
            ],
        )
        ledger(
            d,
            [
                {"event": "attempt_start", "trial_id": 0,
                 "config_hash": "c", "attempt": 1, "ts": 100.3},
                {"event": "attempt_end", "trial_id": 0,
                 "config_hash": "c", "attempt": 1,
                 "status": "retrying", "ts": 100.55},
            ],
        )
        traces = ttrace.build_submission_traces(d)
        tr = traces["s-1"]
        assert not tr["orphans"]
        waits = [s for s in tr["spans"] if s["name"] == "queue_wait"]
        assert len(waits) == 2
        assert waits[0]["end"] == 100.6 and waits[1]["end"] == 101.0
        att = next(
            s for s in tr["spans"] if s["name"].startswith("attempt")
        )
        assert tr["spans"][att["parent"]] is waits[0]
        assert ttrace.trace_completeness(traces)["complete"]

    def test_orphan_attempt_fails_completeness(self, tmp_path):
        d = str(tmp_path)
        journal(
            d,
            [
                sub_rec("s-1", 100.0),
                ev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
                ev("settled", "s-1", 101.0, trial_id=0,
                   status="completed"),
            ],
        )
        # An attempt entirely OUTSIDE the submission's window: orphan.
        ledger(
            d,
            [
                {"event": "attempt_start", "trial_id": 0,
                 "config_hash": "c", "attempt": 1, "ts": 200.0},
            ],
        )
        traces = ttrace.build_submission_traces(d)
        assert traces["s-1"]["orphans"]
        comp = ttrace.trace_completeness(traces)
        assert not comp["complete"]
        assert comp["orphan_spans"] == 1


# --------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------


class TestExport:
    def test_perfetto_open_span_has_unmatched_begin(self, tmp_path):
        d = str(tmp_path)
        journal(
            d,
            [
                sub_rec("s-1", 100.0),
                ev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
                ev("placed", "s-1", 101.0, trial_id=0, start=0, size=1,
                   lanes=1, stacked=False, resumed=False),
            ],
        )
        trace = ttrace.build_perfetto(ttrace.build_submission_traces(d))
        evs = trace["traceEvents"]
        begins = [e for e in evs if e.get("ph") == "B"]
        ends = [e for e in evs if e.get("ph") == "E"]
        # root + placement open -> two more B than E.
        assert len(begins) - len(ends) == 2
        open_names = {e["name"] for e in begins} - {
            e["name"] for e in ends
        }
        assert "placement #1" in open_names

    def test_export_roundtrip(self, tmp_path):
        d = str(tmp_path)
        journal(
            d,
            [
                sub_rec("s-1", 100.0),
                ev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
                ev("placed", "s-1", 101.0, trial_id=0, start=0, size=1,
                   lanes=1, stacked=False, resumed=False),
                ev("settled", "s-1", 102.0, trial_id=0,
                   status="completed"),
            ],
        )
        out = ttrace.export_traces(d, str(tmp_path / "traces"))
        with open(out["spans"]) as f:
            spans = json.load(f)
        assert "s-1" in spans and spans["s-1"]["state"] == "settled"
        with open(out["perfetto"]) as f:
            pf = json.load(f)
        assert pf["traceEvents"]
        assert out["completeness"]["complete"]


# --------------------------------------------------------------------
# SLO engine
# --------------------------------------------------------------------


class TestSloEngine:
    def test_latency_compliance_and_budget(self):
        eng = tslo.SloEngine(
            (
                tslo.SloSpec(
                    name="p", kind=tslo.LATENCY,
                    source="placement_latency", threshold_s=1.0,
                    objective=0.9,
                ),
            )
        )
        now = time.time()
        for i in range(8):
            eng.observe_latency("placement_latency", 0.5, ts=now)
        eng.observe_latency("placement_latency", 2.0, ts=now)
        (row,) = eng.evaluate(now=now)["slos"]["p"]
        assert row["total"] == 9 and row["bad"] == 1
        assert row["compliance"] == pytest.approx(8 / 9, abs=1e-4)
        assert not row["met"]  # 0.888 < 0.9
        assert row["budget_spent_frac"] == pytest.approx(
            (1 / 9) / 0.1, abs=0.01
        )

    def test_burn_alert_is_edge_triggered(self):
        from multidisttorch_tpu_torch import telemetry

        spec = tslo.SloSpec(
            name="p", kind=tslo.LATENCY, source="x", threshold_s=1.0,
            objective=0.9, windows=((10.0, 2.0), (60.0, 1.0)),
        )
        eng = tslo.SloEngine((spec,))
        telemetry.configure(None)
        try:
            bus = telemetry.get_bus()
            now = time.time()
            for _ in range(10):
                eng.observe_latency("x", 5.0, ts=now)  # 100% bad
            r1 = eng.evaluate(now=now)
            assert r1["alerting"] and r1["alerts"][0]["slo"] == "p"
            eng.evaluate(now=now)  # still firing: no second event
            fired = [
                e for e in bus.recent() if e.kind == "slo_alert"
            ]
            assert len(fired) == 1
            assert fired[0].data["state"] == "firing"
            # Burn subsides (observations age out of both windows):
            r2 = eng.evaluate(now=now + 120.0)
            assert not r2["alerting"]
            fired = [e for e in bus.recent() if e.kind == "slo_alert"]
            assert len(fired) == 2
            assert fired[1].data["state"] == "resolved"
        finally:
            telemetry.disable()

    def test_gauge_floor_per_label(self):
        eng = tslo.SloEngine(
            (
                tslo.SloSpec(
                    name="g", kind=tslo.GAUGE_FLOOR,
                    source="tenant_goodput", floor=0.8, objective=0.5,
                ),
            )
        )
        now = time.time()
        eng.observe_gauge("tenant_goodput", 0.9, label="a", ts=now)
        eng.observe_gauge("tenant_goodput", 0.7, label="b", ts=now)
        eng.observe_gauge("tenant_goodput", None, label="c", ts=now)
        rows = eng.evaluate(now=now)["slos"]["g"]
        by = {r["label"]: r for r in rows}
        assert set(by) == {"a", "b"}  # None never observed
        assert by["a"]["bad"] == 0 and by["b"]["bad"] == 1

    def test_histogram_evaluation_exact_on_bucket_bounds(self):
        h = Histogram((1.0, 5.0, 60.0))
        for v in (0.5, 0.9, 2.0, 7.0):
            h.observe(v)
        spec = tslo.SloSpec(
            name="p", kind=tslo.LATENCY, source="x", threshold_s=5.0,
            objective=0.5,
        )
        ev_ = tslo.evaluate_histogram(spec, tslo.histogram_dict(h))
        assert ev_["exact"]
        assert ev_["total"] == 4 and ev_["bad"] == 1
        assert ev_["compliance"] == pytest.approx(0.75)
        # Off-bound threshold: conservative, flagged inexact.
        spec2 = tslo.SloSpec(
            name="p2", kind=tslo.LATENCY, source="x", threshold_s=3.0,
            objective=0.5,
        )
        ev2 = tslo.evaluate_histogram(spec2, tslo.histogram_dict(h))
        assert not ev2["exact"]
        assert ev2["bad"] == 2  # the 1..5 bucket counts bad

    def test_default_service_slos_align_with_latency_buckets(self):
        from multidisttorch_tpu_torch.service.runtime import LATENCY_BUCKETS

        for spec in tslo.default_service_slos():
            if spec.kind == tslo.LATENCY:
                assert spec.threshold_s in LATENCY_BUCKETS


class TestExemplars:
    def test_bucket_keeps_worst_offender(self):
        h = Histogram((1.0, 5.0))
        h.observe(0.2, exemplar="a")
        h.observe(0.9, exemplar="b")
        h.observe(3.0, exemplar="c")
        assert h.exemplars[0] == (0.9, "b")
        got = h.percentile_exemplar(99)
        assert got == {"value_s": 3.0, "id": "c"}
        stats = h.stats()
        assert stats["p99_exemplar"]["id"] == "c"

    def test_stats_shape_unchanged_without_exemplars(self):
        h = Histogram((1.0, 5.0))
        h.observe(0.2)
        assert "exemplars" not in h.stats()
        assert "p99_exemplar" not in h.stats()


# --------------------------------------------------------------------
# end-to-end over a real (tiny) service
# --------------------------------------------------------------------


class TestServiceEndToEnd:
    def test_trace_complete_and_slo_books_live_service(self, tmp_path):
        from multidisttorch_tpu_torch import telemetry
        from multidisttorch_tpu_torch.service.runtime import SweepService

        d = str(tmp_path)
        telemetry.configure(os.path.join(d, "telemetry"))
        try:
            client = squeue.SweepClient(d, tenant="alice")
            base = dict(
                batch_size=32, latent_dim=4, log_interval=1000, epochs=1
            )
            ids = [
                client.submit({**base, "hidden_dim": 16, "seed": i})
                for i in range(2)
            ]
            svc = SweepService(d, n_slices=2, max_lanes=2, data_rows=64, device="cpu")
            r = svc.serve(
                exit_when_drained=True, idle_grace_s=0.3, max_wall_s=180
            )
            assert set(r["settled"]) == set(ids)
            books = r["books"]
            # Exemplars in the books name real submissions.
            assert books["queue_wait"]["p99_exemplar"]["id"] in ids
            # SLO block present with the default objectives evaluated.
            assert "placement_p99_5s" in books["slo"]["slos"]
            assert "tenant_goodput_floor" in books["slo"]["slos"]
            (gp,) = books["slo"]["slos"]["tenant_goodput_floor"]
            assert gp["label"] == "alice" and gp["bad"] == 0
        finally:
            telemetry.disable()
        traces = ttrace.build_submission_traces(d)
        comp = ttrace.trace_completeness(traces)
        assert comp["complete"] and comp["settled"] == 2
        # Ledger attempts joined in, trace tags riding the ledger.
        led = squeue.read_jsonl_from(
            os.path.join(d, "sweep_ledger.jsonl"), 0
        )[0]
        ends = [e for e in led if e.get("event") == "attempt_end"]
        assert ends and all(e.get("trace") for e in ends)
        for sid in ids:
            assert any(
                s["name"].startswith("attempt")
                for s in traces[sid]["spans"]
            )

    def test_fenced_failover_trace_contiguity(self, tmp_path):
        """A fenced service dies mid-placement (abandoned, SIGKILL
        shape); a second incarnation (next fencing epoch) adopts the
        same directory, recovers, and settles. The submission's trace
        must be ONE contiguous tree spanning both epochs with zero
        orphans."""
        from multidisttorch_tpu_torch.service.runtime import SweepService

        d = str(tmp_path)
        client = squeue.SweepClient(d, tenant="t")
        sid = client.submit(
            {
                "batch_size": 32,
                "latent_dim": 4,
                "log_interval": 1000,
                "epochs": 2,
                "hidden_dim": 16,
            }
        )
        svc1 = SweepService(
            d, n_slices=1, max_lanes=1, data_rows=64, fence_epoch=1,
            device="cpu",
        )
        t0 = time.time()
        placed = False
        while time.time() - t0 < 60 and not placed:
            svc1.tick()
            placed = any(
                r.get("event") == "placed"
                for r in squeue.load_queue(d)
            )
        assert placed
        # "SIGKILL": no drain, no settle — just stop ticking and drop
        # the generators (join the checkpoint writer so the adopter's
        # scan-back sees a quiet dir).
        for ap in svc1.active.values():
            ap.gen.close()
            ap.run._join_ckpt()
        svc1.store.shutdown()

        svc2 = SweepService(
            d, n_slices=1, max_lanes=1, data_rows=64, fence_epoch=2,
            device="cpu",
        )
        r = svc2.serve(
            exit_when_drained=True, idle_grace_s=0.3, max_wall_s=180
        )
        assert r["settled"].get(sid) == "completed"
        traces = ttrace.build_submission_traces(d)
        tr = traces[sid]
        assert tr["epochs"] == [1, 2]
        assert tr["epoch_takeovers"] >= 1
        comp = ttrace.trace_completeness(traces)
        assert comp["complete"]
        assert comp["multi_epoch_submissions"] == 1
        # The epoch-1 attempt the kill orphaned ends "preempted"-less:
        # it must be attached (placement #1), not an orphan, and the
        # epoch-2 attempt completed.
        attempts = [
            s
            for s in tr["spans"]
            if s["name"].startswith("attempt") and s["kind"] == "span"
        ]
        assert len(attempts) >= 2 and not tr["orphans"]


# --------------------------------------------------------------------
# the copies against their originals (exact: the same JSON)
# --------------------------------------------------------------------


def _same(a, b):
    return json.loads(json.dumps(a, sort_keys=True, default=str)) == json.loads(
        json.dumps(b, sort_keys=True, default=str))


def _perfetto(builder, traces):
    """A Perfetto trace with its generator's module name (the one field
    that names the package) left out."""
    out = builder(traces)
    out["otherData"].pop("generator")
    return out


def _fabricated(d, which):
    if which == "failover":
        TestFailoverContiguity()._failover_journal(d)
        ledger(d, [
            {"event": "attempt_start", "trial_id": 0, "config_hash": "c", "attempt": 1, "trace": "tr1",
             "ts": 100.9, "epoch": 1},
            {"event": "attempt_start", "trial_id": 0, "config_hash": "c", "attempt": 2, "trace": "tr1",
             "ts": 104.4, "epoch": 2},
            {"event": "attempt_end", "trial_id": 0, "config_hash": "c", "attempt": 2, "status": "completed",
             "ts": 107.9, "epoch": 2},
            {"event": "attempt_start", "trial_id": 7, "config_hash": "o", "attempt": 1, "ts": 300.0},
        ])
        return
    recs = [sub_rec("s-1", 100.0, trace_id="abc"), ev("admitted", "s-1", 100.2, trial_id=0, bucket="b"),
            ev("placed", "s-1", 101.0, trial_id=0, start=0, size=1, lanes=1, stacked=False, resumed=False),
            sub_rec("s-2", 100.5), ev("rejected", "s-2", 100.6, verdict="rejected_quota", reason="quota")]
    if which == "settled":
        recs.append(ev("settled", "s-1", 105.0, trial_id=0, status="completed"))
    journal(d, recs)
    if which == "torn":
        with open(os.path.join(d, squeue.QUEUE_NAME), "a") as f:
            f.write('{"event": "settled", "submission_id": "s-1", "sta')


@pytest.mark.parametrize("which", ["settled", "open", "torn", "failover"])
def test_trace_builders_equal_the_jax_builders(tmp_path, which):
    from multidisttorch_tpu.telemetry import trace as jtrace

    d = str(tmp_path)
    _fabricated(d, which)
    pt, jt = ttrace.build_submission_traces(d), jtrace.build_submission_traces(d)
    assert _same(pt, jt)
    assert _same(ttrace.trace_completeness(pt), jtrace.trace_completeness(jt))
    assert _same(_perfetto(ttrace.build_perfetto, pt), _perfetto(jtrace.build_perfetto, jt))
    for sid in pt:
        assert _same(ttrace.latency_breakdown(pt[sid]), jtrace.latency_breakdown(jt[sid]))


def test_a_port_service_dir_traces_alike_in_both_packages(tmp_path):
    """The journal, ledger and event stream a live port service writes
    build the same span trees, completeness and Perfetto trace through both
    packages' builders."""
    from multidisttorch_tpu.telemetry import trace as jtrace
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.service.runtime import SweepService

    d = str(tmp_path)
    telemetry.configure(os.path.join(d, "telemetry"))
    try:
        client = squeue.SweepClient(d, tenant="alice")
        base = dict(batch_size=32, latent_dim=4, log_interval=1000, epochs=1)
        ids = [client.submit({**base, "hidden_dim": 16, "seed": i}) for i in range(2)]
        ids.append(squeue.SweepClient(d, tenant="bob").submit({**base, "hidden_dim": 24}))
        svc = SweepService(d, n_slices=2, max_lanes=2, data_rows=64, device="cpu")
        r = svc.serve(exit_when_drained=True, idle_grace_s=0.3, max_wall_s=180)
        assert set(r["settled"]) == set(ids)
    finally:
        telemetry.disable()
    pt, jt = ttrace.build_submission_traces(d), jtrace.build_submission_traces(d)
    assert _same(pt, jt)
    assert ttrace.trace_completeness(pt)["complete"]
    assert _same(ttrace.trace_completeness(pt), jtrace.trace_completeness(jt))
    assert _same(_perfetto(ttrace.build_perfetto, pt), _perfetto(jtrace.build_perfetto, jt))


def _slo_stream(tslo_mod, bus_events):
    """A seeded stream of latency, event and gauge observations through one
    package's engine with its default service objectives plus a fast-burn
    latency objective; the verdicts at four instants."""
    import random

    rng = random.Random(5)
    fast = tslo_mod.SloSpec(name="fast", kind=tslo_mod.LATENCY, source="placement_latency", threshold_s=1.0,
                            objective=0.9, windows=((10.0, 2.0), (60.0, 1.0)))
    eng = tslo_mod.SloEngine(tuple(tslo_mod.default_service_slos()) + (fast,))
    t0, out = 1000.0, []
    for step in range(4):
        now = t0 + 30.0 * step
        for _ in range(40):
            eng.observe_latency("queue_wait", rng.expovariate(0.2), ts=now)
            eng.observe_latency("placement_latency", rng.expovariate(0.5 if step < 2 else 5.0), ts=now)
            eng.observe_event("deadline", rng.random() < 0.9, ts=now)
        for t in ("a", "b"):
            eng.observe_gauge("tenant_goodput", rng.uniform(0.6, 1.0), label=t, ts=now)
        out.append(eng.evaluate(now=now))
    return out, [(e.kind, e.data) for e in bus_events()]


def test_slo_engine_gives_the_jax_verdicts_and_alerts():
    from multidisttorch_tpu import telemetry as jtel
    from multidisttorch_tpu.telemetry import slo as jslo
    from multidisttorch_tpu_torch import telemetry

    telemetry.configure(None)
    try:
        port = _slo_stream(tslo, lambda: [e for e in telemetry.get_bus().recent() if e.kind.startswith("slo")])
    finally:
        telemetry.disable()
    jtel.configure(None)
    try:
        ref = _slo_stream(jslo, lambda: [e for e in jtel.get_bus().recent() if e.kind.startswith("slo")])
    finally:
        jtel.disable()
    assert _same(port[0], ref[0])
    assert port[1] == ref[1] and any(kind == "slo_alert" for kind, _ in port[1])
