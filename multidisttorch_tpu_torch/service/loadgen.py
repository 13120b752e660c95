"""Discrete-event load generator: millions of submissions against the
pure scheduler core, at simulation speed.

Counterpart of the JAX package's ``service/loadgen.py``, the same file with
the imports renamed to the port's copies (held to it, report for report, by
``tests/test_torch_loadgen.py``). It imports no torch.

The scheduling brain (``service/scheduler.py`` + ``service/defrag.py``)
is pure host logic with an injectable clock — no device, no I/O
(DrJAX's separability argument, PAPERS.md arXiv 2403.07128) — so the
"millions of users" claim is testable WITHOUT training anything: this
module replays a seeded synthetic workload through the exact production
classes (:class:`FairShareScheduler`, :class:`SlicePool`,
:class:`PreemptionPolicy`, :func:`plan_defrag`, :func:`plan_preemption`)
on a virtual clock, four orders of magnitude past the 18-submission
service bench, and banks:

- **p50/p95/p99 placement latency** (virtual seconds, submission →
  first placement),
- **fairness error**: contended-share ratio-to-weight per tenant, the
  same ±10% gate as the JAX package's ``bench.py --service``, now under ~10^6 decisions,
- **deadline hit rate** under EDF + bounded preemption,
- **preemption/defrag churn** — evictions and moves per 1k placements
  (the anti-thrash budget's macro-level evidence).

Execution model (one honest simplification per line):

- a trial's "work" is a virtual duration; K co-packed lanes share one
  block and free it when the LAST lane finishes (the stacked bucket's
  actual lifecycle);
- checkpoint-drain banks progress in ``ckpt_every_s`` chunks — an
  evicted/migrated trial resumes from its last virtual checkpoint, so
  preemption has a real recompute cost in the sim, exactly the cost
  the anti-thrash budget exists to bound;
- admission, fair share, EDF, packing, pinning, starvation stamps,
  defrag planning and preemption planning are NOT simulated — they run
  the production code paths.
"""

from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof

from multidisttorch_tpu_torch.service.defrag import (
    PlacedBlock,
    plan_defrag,
    plan_preemption,
)
from multidisttorch_tpu_torch.service.scheduler import (
    ADMIT,
    FairShareScheduler,
    PendingTrial,
    PreemptionPolicy,
    REJECT_BACKPRESSURE,
    REJECT_QUOTA,
    SlicePool,
    TenantPolicy,
)

# Full-histogram bucket bounds for the banked latency books, in
# VIRTUAL seconds (log-ish spacing over the regimes the 1M replay
# produces). The offline SLO thresholds sit ON these bounds so
# ``telemetry/slo.py``'s histogram evaluation is exact — the reason
# the artifact banks every bucket instead of three percentile points.
VIRTUAL_LATENCY_BUCKETS = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0,
)


def default_loadgen_slos():
    """The replay's standing objectives, in virtual time: thresholds
    aligned to :data:`VIRTUAL_LATENCY_BUCKETS` (exact evaluation).
    Deliberately judged in the OVERLOAD regime the default spec
    drives, so the targets are about scheduling discipline (EDF +
    fair share + preemption), not abundance."""
    from multidisttorch_tpu_torch.telemetry.slo import EVENT, LATENCY, SloSpec

    return (
        SloSpec(
            name="placement_p99_1000s",
            kind=LATENCY,
            source="placement_latency",
            threshold_s=1000.0,
            objective=0.99,
            description="99% of admitted submissions reach their first "
            "placement within 1000 virtual seconds",
        ),
        SloSpec(
            name="deadline_hit_rate",
            kind=EVENT,
            source="deadline",
            objective=0.90,
            description="90% of completed deadline-tagged submissions "
            "finish before their deadline",
        ),
    )


@dataclass
class LoadSpec:
    """The synthetic workload's knobs (all seeded — two runs of the
    same spec replay bit-identically)."""

    n_submissions: int = 1_000_000
    seed: int = 0
    n_slices: int = 32
    max_lanes: int = 4
    # tenant name -> fair-share weight (quotas default per policy).
    tenants: dict = field(default_factory=lambda: {
        "alpha": 4.0, "bravo": 2.0, "carol": 2.0,
        "delta": 1.0, "echo": 1.0,
    })
    max_pending_per_tenant: int = 64
    max_total_pending: int = 1024
    # Offered load as a fraction of pool capacity. The default is a
    # deliberate OVERLOAD: weighted fair share is only observable when
    # every tenant's offered load exceeds its weighted entitlement (a
    # work-conserving scheduler hands unused share to whoever asks, so
    # an under-demanding heavy tenant legitimately reads below its
    # weight); quotas/backpressure absorb the excess.
    utilization: float = 2.5
    # Trial shape: sizes drawn from (size, weight) pairs; durations
    # log-uniform in [lo, hi) virtual seconds; a few shape buckets so
    # co-packing really happens.
    sizes: tuple = ((1, 0.68), (2, 0.22), (4, 0.10))
    duration_lo_s: float = 4.0
    duration_hi_s: float = 64.0
    n_shape_buckets: int = 3
    # Deadlines: this fraction of submissions carries one, at
    # arrival + duration * U(slack_lo, slack_hi).
    deadline_frac: float = 0.15
    slack_lo: float = 3.0
    slack_hi: float = 8.0
    # Virtual checkpoint cadence (the eviction recompute granularity).
    ckpt_every_s: float = 4.0
    # Defrag policy mirror of the runtime's.
    starvation_s: float = 30.0
    defrag_cooldown_s: float = 5.0
    preempt: Optional[PreemptionPolicy] = None
    # Bounded scan-past window (the daemon scans unbounded; a million-
    # event replay keeps per-blocked-tenant cost O(1) — semantics
    # documented on FairShareScheduler.schedule).
    scan_limit: int = 8
    # -- scenario-zoo modulation knobs, ALL default-off ---------------
    # Every knob below guards its own rng draws behind its off-value,
    # so the DEFAULT spec's draw sequence is untouched: pre-zoo seeds
    # replay bit-identically (tests/test_loadgen determinism).
    #
    # diurnal_wave: arrival-rate modulation 1 + amp*sin(2*pi*t/period),
    # period as a fraction of the arrival horizon. No extra draws —
    # the same exponential gap is rescaled deterministically.
    wave_amp: float = 0.0
    wave_period_frac: float = 0.25
    # tenant_burst: during [burst_at_frac, burst_at_frac +
    # burst_len_frac) of the arrival horizon, each arrival belongs to
    # ``burst_tenant`` with probability ``burst_share``.
    burst_tenant: Optional[str] = None
    burst_share: float = 0.0
    burst_at_frac: float = 0.3
    burst_len_frac: float = 0.2
    # deadline_gaming: one tenant tags EVERY submission with a tight
    # deadline (slack ``gamer_slack`` x duration), trying to ride EDF
    # past its fair share — the discipline the preemption urgency
    # window and per-(tenant, lane) EDF queues exist to contain.
    gamer_tenant: Optional[str] = None
    gamer_slack: float = 1.5
    # pipeline_whale_shrimp: with probability ``whale_frac`` an
    # arrival is a VECTOR (MPMD pipelined) request of ``whale_stages``
    # stage blocks, placed all-or-nothing among a sea of shrimps.
    whale_frac: float = 0.0
    whale_stages: tuple = (4, 4)
    # dataset_thrash: the shape-bucket key rotates every
    # ``thrash_period_frac`` of the horizon through ``thrash_buckets``
    # epochs, so open co-pack placements keep going stale (the
    # bin-pack scan's worst case).
    thrash_buckets: int = 0
    thrash_period_frac: float = 0.02


@dataclass
class _SimTrial:
    entry: PendingTrial
    duration: float
    remaining: float
    arrival: float
    deadline_ts: Optional[float]
    placed_first: Optional[float] = None
    placed_at: Optional[float] = None
    placement_id: Optional[int] = None
    done_at: Optional[float] = None


class _Sim:
    """The event loop. Events: ``("arrive", i)`` — generate submission
    i and the NEXT arrival (the heap never materializes the whole
    workload); ``("done", pid, sub_id)`` — a lane finished (stale if
    the placement was evicted meanwhile)."""

    def __init__(self, spec: LoadSpec):
        self.spec = spec
        self.rng = np.random.default_rng(
            np.random.SeedSequence([spec.seed, 0x10AD])
        )
        self.pool = SlicePool(spec.n_slices)
        self.sched = FairShareScheduler(
            {
                t: TenantPolicy(
                    weight=w, max_pending=spec.max_pending_per_tenant
                )
                for t, w in spec.tenants.items()
            },
            max_total_pending=spec.max_total_pending,
        )
        self.preempt = (
            spec.preempt if spec.preempt is not None else PreemptionPolicy(
                trial_cooldown_s=4 * spec.ckpt_every_s,
                global_cooldown_s=1.0,
                # Only genuinely at-risk deadlines evict: anything
                # with more slack than the longest possible trial can
                # afford to wait its EDF turn.
                urgency_s=spec.duration_hi_s,
            )
        )
        sizes = np.array([s for s, _ in spec.sizes])
        probs = np.array([p for _, p in spec.sizes], dtype=float)
        self._sizes, self._probs = sizes, probs / probs.sum()
        self._tenant_names = sorted(spec.tenants)
        mean_work = float(
            (self._sizes * self._probs).sum()
            * np.exp(
                (np.log(spec.duration_lo_s) + np.log(spec.duration_hi_s))
                / 2
            )
        )
        self.arrival_rate = spec.utilization * spec.n_slices / mean_work
        # The nominal arrival horizon (virtual s) — the scenario
        # knobs' windows/periods scale against it so a 2k-submission
        # test run and the 1M replay see the same SHAPE.
        self.arrival_horizon = spec.n_submissions / self.arrival_rate
        self._wave_period = (
            spec.wave_period_frac * self.arrival_horizon
            if spec.wave_amp > 0
            else 0.0
        )
        self._thrash_period = (
            max(1e-9, spec.thrash_period_frac * self.arrival_horizon)
            if spec.thrash_buckets > 0
            else 0.0
        )
        self.now = 0.0
        self.heap: list = []
        self._seq = 0
        # Full latency histogram alongside the exact-percentile list:
        # the banked artifact form offline SLO evaluation reads.
        from multidisttorch_tpu_torch.telemetry.metrics import Histogram

        self.latency_hist = Histogram(VIRTUAL_LATENCY_BUCKETS)
        self.trials: dict[str, _SimTrial] = {}
        # placement_id -> {"start","size","live": set(sub_ids),
        #                  "stacked": bool, "dead": bool}
        self.live: dict[int, dict] = {}
        self.latencies: list = []
        self.rejected = {REJECT_QUOTA: 0, REJECT_BACKPRESSURE: 0}
        self.deadline_tagged = 0
        self.deadline_hits = 0
        self.preempt_events = 0
        self.preempt_evictions = 0
        self.defrag_moves = 0
        self.completed = 0
        self.placements = 0
        self._last_defrag = float("-inf")
        self._last_preempt_scan = float("-inf")
        self._submitted = 0

    # -- workload -----------------------------------------------------

    def _push_event(self, t: float, kind: str, *payload) -> None:
        self._seq += 1
        heapq.heappush(self.heap, (t, self._seq, kind, payload))

    def _pick_tenant(self) -> str:
        spec = self.spec
        if spec.burst_share > 0 and spec.burst_tenant is not None:
            t0 = spec.burst_at_frac * self.arrival_horizon
            t1 = t0 + spec.burst_len_frac * self.arrival_horizon
            if (
                t0 <= self.now < t1
                and self.rng.random() < spec.burst_share
            ):
                return spec.burst_tenant
        return self._tenant_names[
            int(self.rng.integers(0, len(self._tenant_names)))
        ]

    def _gen_submission(self, i: int) -> None:
        spec = self.spec
        rng = self.rng
        tenant = self._pick_tenant()
        sizes_vec = None
        if spec.whale_frac > 0 and rng.random() < spec.whale_frac:
            sizes_vec = tuple(int(s) for s in spec.whale_stages)
            size = sum(sizes_vec)
        else:
            size = int(rng.choice(self._sizes, p=self._probs))
        duration = float(
            np.exp(
                rng.uniform(
                    np.log(spec.duration_lo_s),
                    np.log(spec.duration_hi_s),
                )
            )
        )
        deadline_ts = None
        if spec.gamer_tenant is not None and tenant == spec.gamer_tenant:
            # The gamer tags EVERYTHING, tightly — no draw: its whole
            # lane rides EDF's front as hard as the policy allows.
            deadline_ts = self.now + duration * spec.gamer_slack
            self.deadline_tagged += 1
        elif rng.random() < spec.deadline_frac:
            deadline_ts = self.now + duration * float(
                rng.uniform(spec.slack_lo, spec.slack_hi)
            )
            self.deadline_tagged += 1
        if sizes_vec is not None:
            # Vector requests never co-pack; the bucket is cosmetic.
            bucket = f"v{size}"
        else:
            b = int(rng.integers(0, spec.n_shape_buckets))
            if spec.thrash_buckets > 0:
                epoch = (
                    int(self.now // self._thrash_period)
                    % spec.thrash_buckets
                )
                bucket = f"b{size}x{b}e{epoch}"
            else:
                bucket = f"b{size}x{b}"
        sub_id = f"{tenant}-{i}"
        verdict, _ = self.sched.admit_verdict(tenant)
        if verdict != ADMIT:
            self.rejected[verdict] = self.rejected.get(verdict, 0) + 1
            return
        entry = PendingTrial(
            sub_id=sub_id,
            tenant=tenant,
            priority=1,
            cfg=None,
            bucket=bucket,
            size=size,
            cost=duration * size,
            submit_ts=self.now,
            trial_id=i,
            deadline_ts=deadline_ts,
            sizes=sizes_vec,
        )
        self.trials[sub_id] = _SimTrial(
            entry=entry,
            duration=duration,
            remaining=duration,
            arrival=self.now,
            deadline_ts=deadline_ts,
        )
        self.sched.push(entry, now=self.now)

    # -- placement / completion --------------------------------------

    def _schedule_pass(self) -> None:
        if self.sched.pending_count() == 0 or self.pool.free_total == 0:
            return
        placed = self.sched.schedule(
            self.pool,
            max_lanes=self.spec.max_lanes,
            now=self.now,
            scan_limit=self.spec.scan_limit,
        )
        for p in placed:
            self.placements += 1
            rec = {
                "start": p.start,
                "size": p.size,
                "live": set(),
                "stacked": p.lanes >= 2,
                "dead": False,
                # Vector (pipelined whale) placement: one
                # (start, size) per stage; freed block-by-block.
                "blocks": list(p.blocks) if p.blocks else None,
            }
            self.live[p.placement_id] = rec
            for e in p.members:
                st = self.trials[e.sub_id]
                if st.placed_first is None:
                    st.placed_first = self.now
                    self.latencies.append(self.now - st.arrival)
                    # Exemplar = the submission id: the banked p99
                    # bucket names its worst offender.
                    self.latency_hist.observe(
                        self.now - st.arrival, exemplar=e.sub_id
                    )
                if e.preempt_count > 0:
                    # Re-placed eviction victim: the anti-thrash
                    # cooldown counts RUNNING time from here (the
                    # runtime's _note_unblock discipline).
                    self.preempt.note_replaced(
                        e.trial_id, self.now
                    )
                st.placed_at = self.now
                st.placement_id = p.placement_id
                rec["live"].add(e.sub_id)
                self._push_event(
                    self.now + st.remaining, "done",
                    p.placement_id, e.sub_id,
                )

    def _banked(self, st: _SimTrial) -> float:
        """Progress durable at the last virtual checkpoint: prior
        placements' banked work (``duration - remaining`` — already
        checkpoint-aligned by the previous eviction) plus THIS
        placement's elapsed time rounded DOWN to the checkpoint
        cadence — eviction costs only the un-checkpointed tail, like
        the real drain."""
        done_before = st.duration - st.remaining
        elapsed = self.now - (
            st.placed_at if st.placed_at is not None else self.now
        )
        chunk = self.spec.ckpt_every_s
        banked = (elapsed // chunk) * chunk if chunk > 0 else elapsed
        return max(0.0, done_before + banked)

    def _free_rec(self, rec: dict) -> None:
        if rec.get("blocks"):
            for start, size in rec["blocks"]:
                self.pool.free(start, size)
        else:
            self.pool.free(rec["start"], rec["size"])

    def _evict(self, pid: int, *, pinned_start: Optional[int] = None,
               front: bool = False) -> None:
        rec = self.live.pop(pid)
        rec["dead"] = True
        self._free_rec(rec)
        for sub_id in rec["live"]:
            st = self.trials[sub_id]
            st.entry.resume_scan = True
            st.remaining = st.duration - self._banked(st)
            st.entry.pinned_start = pinned_start
            st.placed_at = None
            st.placement_id = None
            self.sched.push(st.entry, front=front, now=self.now)

    def _member_done(self, pid: int, sub_id: str) -> None:
        rec = self.live.get(pid)
        if rec is None or sub_id not in rec["live"]:
            return  # stale event: the placement was evicted/migrated
        rec["live"].discard(sub_id)
        st = self.trials[sub_id]
        st.done_at = self.now
        st.remaining = 0.0
        self.completed += 1
        if st.deadline_ts is not None and self.now <= st.deadline_ts:
            self.deadline_hits += 1
        self.preempt.forget(st.entry.trial_id)
        if not rec["live"]:
            del self.live[pid]
            self._free_rec(rec)

    # -- preemption / defrag (the runtime's decision mirrors) ---------

    def _blocks_of(self, pid: int, rec: dict, movable: bool) -> list:
        """PlacedBlock views of one live rec: a vector placement
        contributes one record per stage block, pinned immovable (the
        sim's one honest simplification — production re-homes vectors
        via ``rehome_sizes``; here they sit until done)."""
        if rec.get("blocks"):
            return [
                PlacedBlock(
                    placement_id=pid, start=s, size=z, movable=False
                )
                for s, z in rec["blocks"]
            ]
        return [
            PlacedBlock(
                placement_id=pid,
                start=rec["start"],
                size=rec["size"],
                movable=movable,
            )
        ]

    def _preemptible(self, pid: int, rec: dict) -> bool:
        if rec["stacked"] or rec.get("blocks"):
            return False
        (sub_id,) = tuple(rec["live"]) or ("",)
        st = self.trials.get(sub_id)
        if st is None or st.deadline_ts is not None:
            return False
        return self.preempt.victim_allowed(
            st.entry.trial_id, st.entry.preempt_count, self.now
        )

    def _maybe_preempt(self) -> bool:
        if not self.live or not self.preempt.event_allowed(self.now):
            return False
        # The cooldown throttles the SCAN too (deadline_pending walks
        # and sorts every pending entry): a fruitless scan must not
        # repeat on every event.
        if (
            self.now - self._last_preempt_scan
            < self.preempt.global_cooldown_s
        ):
            return False
        self._last_preempt_scan = self.now
        blocks = None
        for starved in self.sched.deadline_pending(now=self.now):
            if starved.deadline_ts - self.now > self.preempt.urgency_s:
                continue
            if self.pool.can_fit(starved.size):
                continue
            if blocks is None:
                blocks = [
                    b
                    for pid, rec in self.live.items()
                    for b in self._blocks_of(
                        pid, rec, self._preemptible(pid, rec)
                    )
                ]
            plan = plan_preemption(self.pool, blocks, starved.size)
            if plan is None:
                continue
            for pid in plan.victims:
                rec = self.live.get(pid)
                if rec is None:
                    continue
                for sub_id in rec["live"]:
                    self.trials[sub_id].entry.preempt_count += 1
                    self.preempt.note_eviction(
                        self.trials[sub_id].entry.trial_id, self.now
                    )
                self._evict(pid)
                self.preempt_evictions += 1
            self.preempt_events += 1
            self.preempt.last_event_ts = self.now
            return True
        return False

    def _maybe_defrag(self) -> bool:
        # The cooldown throttles the SCAN, not just successful moves —
        # starved_entries walks every pending entry, which a
        # million-event loop cannot afford per event.
        if self.now - self._last_defrag < self.spec.defrag_cooldown_s:
            return False
        self._last_defrag = self.now
        for starved in self.sched.starved_entries(
            threshold_s=self.spec.starvation_s, now=self.now
        ):
            if self.pool.can_fit(starved.size):
                continue
            if self.pool.free_total < starved.size:
                continue
            blocks = [
                b
                for pid, rec in self.live.items()
                for b in self._blocks_of(
                    pid, rec, not rec["stacked"]
                )
            ]
            plan = plan_defrag(self.pool, blocks, starved.size)
            if plan is None:
                continue
            self._last_defrag = self.now
            for pid, new_start in plan.moves:
                if pid not in self.live:
                    continue
                # Checkpoint-drain + pinned front requeue — the
                # migration machinery's shape, with the same banked-
                # progress cost as a preemption.
                self._evict(pid, pinned_start=new_start, front=True)
                self.defrag_moves += 1
            return True
        return False

    # -- run ----------------------------------------------------------

    def run(self, *, progress=None) -> dict:
        spec = self.spec
        prof = _ctlprof.get_ctlprof()
        wall0 = time.perf_counter()
        self._push_event(0.0, "arrive", 0)
        while self.heap:
            t, _, kind, payload = heapq.heappop(self.heap)
            self.now = t
            if prof is not None:
                # One event = one control-plane pass: the same
                # per-tick bracketing the daemon's serve loop gets.
                prof.pass_begin()
            if kind == "arrive":
                (i,) = payload
                self._gen_submission(i)
                self._submitted += 1
                if i + 1 < spec.n_submissions:
                    gap = float(
                        self.rng.exponential(1.0 / self.arrival_rate)
                    )
                    if spec.wave_amp > 0:
                        # Deterministic rescale of the SAME draw (no
                        # extra rng consumption): rate swells on the
                        # wave crest, thins in the trough.
                        gap /= max(
                            1e-6,
                            1.0
                            + spec.wave_amp
                            * math.sin(
                                2.0 * math.pi * self.now
                                / self._wave_period
                            ),
                        )
                    self._push_event(self.now + gap, "arrive", i + 1)
                if progress is not None and (i + 1) % 100_000 == 0:
                    progress(i + 1, self)
            else:
                pid, sub_id = payload
                self._member_done(pid, sub_id)
            self._maybe_preempt()
            self._maybe_defrag()
            self._schedule_pass()
            if prof is not None:
                prof.pass_end()
        wall = time.perf_counter() - wall0
        return self._report(wall)

    def _hist_banked(self) -> dict:
        from multidisttorch_tpu_torch.telemetry.slo import histogram_dict

        out = histogram_dict(self.latency_hist)
        if self.latency_hist.exemplars:
            out["p99_exemplar"] = self.latency_hist.percentile_exemplar(99)
        return out

    def _slo_block(self) -> dict:
        """Exact offline SLO evaluation over the banked books: the
        latency objective from the full histogram, the deadline
        objective from completed-tagged totals."""
        from multidisttorch_tpu_torch.telemetry.slo import evaluate_offline

        done_tagged = sum(
            1
            for st in self.trials.values()
            if st.deadline_ts is not None and st.done_at is not None
        )
        return evaluate_offline(
            default_loadgen_slos(),
            histograms={
                "placement_latency": self._hist_banked(),
            },
            event_totals={
                "deadline": {
                    "good": self.deadline_hits,
                    "bad": max(0, done_tagged - self.deadline_hits),
                }
            },
        )

    def _deadline_class(
        self, *, exclude: Optional[str] = None, only: Optional[str] = None
    ) -> dict:
        """Completed-deadline accounting restricted to one tenant
        class (``done_at <= deadline_ts`` recomputes the hit verdict
        the completion path recorded)."""
        done = [
            st
            for st in self.trials.values()
            if st.deadline_ts is not None
            and st.done_at is not None
            and (exclude is None or st.entry.tenant != exclude)
            and (only is None or st.entry.tenant == only)
        ]
        hits = sum(1 for st in done if st.done_at <= st.deadline_ts)
        return {
            "completed_tagged": len(done),
            "hits": hits,
            "hit_rate": round(hits / max(1, len(done)), 4),
        }

    def _report(self, wall: float) -> dict:
        spec = self.spec
        lat = np.array(self.latencies, dtype=float)
        fair = self.sched.fair_share_report()
        ratios = {
            t: r["ratio_to_weight"]
            for t, r in fair.items()
            if r["ratio_to_weight"] is not None
        }
        fairness_err = (
            max(abs(r - 1.0) for r in ratios.values()) if ratios else None
        )
        unfinished = [
            s
            for s, st in self.trials.items()
            if st.done_at is None
        ]
        n_rejected = sum(self.rejected.values())
        return {
            "protocol": "loadgen_v1",
            "spec": {
                "n_submissions": spec.n_submissions,
                "seed": spec.seed,
                "n_slices": spec.n_slices,
                "max_lanes": spec.max_lanes,
                "tenants": dict(spec.tenants),
                "utilization": spec.utilization,
                "deadline_frac": spec.deadline_frac,
                "scan_limit": spec.scan_limit,
                "wave_amp": spec.wave_amp,
                "burst_tenant": spec.burst_tenant,
                "burst_share": spec.burst_share,
                "gamer_tenant": spec.gamer_tenant,
                "whale_frac": spec.whale_frac,
                "thrash_buckets": spec.thrash_buckets,
                "preempt_policy": {
                    "max_per_trial": self.preempt.max_preemptions_per_trial,
                    "trial_cooldown_s": self.preempt.trial_cooldown_s,
                    "global_cooldown_s": self.preempt.global_cooldown_s,
                },
            },
            "submitted": self._submitted,
            "admitted": len(self.trials),
            "rejected": dict(self.rejected),
            "completed": self.completed,
            "unfinished": len(unfinished),
            # The zero-lost contract, simulation form: every admitted
            # submission either completed or is provably still queued
            # at horizon end — with a drained horizon the count is 0.
            "zero_lost": not unfinished,
            "placements": self.placements,
            "sim_span_s": round(self.now, 1),
            "wall_s": round(wall, 2),
            "submissions_per_wall_s": (
                round(self._submitted / wall, 1) if wall > 0 else None
            ),
            "placement_latency_s": {
                "count": int(lat.size),
                "p50": round(float(np.percentile(lat, 50)), 3),
                "p95": round(float(np.percentile(lat, 95)), 3),
                "p99": round(float(np.percentile(lat, 99)), 3),
                "max": round(float(lat.max()), 3),
            } if lat.size else {"count": 0},
            # The FULL distribution (every bucket + exemplars), so the
            # offline SLO evaluation below — and any later re-analysis
            # — is exact rather than re-derived from three points.
            "placement_latency_hist": self._hist_banked(),
            "slo": self._slo_block(),
            "fairness": {
                "per_tenant": fair,
                "max_abs_ratio_error": (
                    round(fairness_err, 4)
                    if fairness_err is not None
                    else None
                ),
                "within_10pct": (
                    fairness_err is not None and fairness_err <= 0.10
                ),
            },
            "deadline": {
                "tagged": self.deadline_tagged,
                "admitted_tagged": sum(
                    1
                    for st in self.trials.values()
                    if st.deadline_ts is not None
                ),
                "completed_tagged": sum(
                    1
                    for st in self.trials.values()
                    if st.deadline_ts is not None
                    and st.done_at is not None
                ),
                # Honest-vs-gamer split (deadline_gaming): the gamer's
                # self-inflicted misses must not drown the signal the
                # scenario exists to judge — whether HONEST tenants'
                # deadlines still hit while one lane games EDF.
                "honest": (
                    self._deadline_class(exclude=spec.gamer_tenant)
                    if spec.gamer_tenant is not None
                    else None
                ),
                "gamer": (
                    self._deadline_class(only=spec.gamer_tenant)
                    if spec.gamer_tenant is not None
                    else None
                ),
                "hits": self.deadline_hits,
                "hit_rate": (
                    round(
                        self.deadline_hits
                        / max(
                            1,
                            sum(
                                1
                                for st in self.trials.values()
                                if st.deadline_ts is not None
                                and st.done_at is not None
                            ),
                        ),
                        4,
                    )
                ),
            },
            "churn": {
                "preempt_events": self.preempt_events,
                "preempt_evictions": self.preempt_evictions,
                "defrag_moves": self.defrag_moves,
                "evictions_per_1k_placements": (
                    round(
                        1000.0
                        * (self.preempt_evictions + self.defrag_moves)
                        / max(1, self.placements),
                        3,
                    )
                ),
            },
        }


def run_loadgen(
    spec: Optional[LoadSpec] = None, *, progress=None, **kw
) -> dict:
    """Run one seeded workload to a DRAINED horizon (arrivals stop
    after ``n_submissions``; the sim keeps stepping until every
    admitted submission finishes) and return the banked report."""
    if spec is None:
        spec = LoadSpec(**kw)
    elif kw:
        raise ValueError("pass a LoadSpec OR keyword overrides, not both")
    return _Sim(spec).run(progress=progress)


# ---------------------------------------------------------------------
# Fabric loadgen: the same discrete-event discipline over a SHARDED
# fabric with a DYNAMIC topology. Each shard is an
# independent (SlicePool, FairShareScheduler) pair — one replica's
# capacity — and tenants route through the PRODUCTION routing trie
# (service/topology.py's Topology, driven in memory), so a million
# routing decisions exercise the exact extendible-hashing code the
# replicas fold from the topology log. The dynamic arm splits hot
# shards (queue-depth trigger; a split moves queued-but-unplaced
# matching entries to a fresh shard, the fabric's handoff rule) and
# work-steals into idle shards (stolen entries KEEP their origin
# tenant, so the thief's fair share charges the origin lane — the
# no-priority-laundering property, observable here at scale); the
# static arm replays the identical workload with both knobs off.
# ---------------------------------------------------------------------


@dataclass
class FabricLoadSpec:
    """The sharded replay's knobs (seeded: bit-identical reruns)."""

    scenario: str = "coordinated_burst"
    n_submissions: int = 20_000
    seed: int = 0
    n_base: int = 2              # fabric.json shard count (base cells)
    slices_per_shard: int = 16
    max_lanes: int = 4
    n_tenants: int = 24
    utilization: float = 1.6     # offered load vs BASE capacity
    sizes: tuple = ((1, 0.68), (2, 0.22), (4, 0.10))
    duration_lo_s: float = 4.0
    duration_hi_s: float = 64.0
    n_shape_buckets: int = 3
    deadline_frac: float = 0.15
    slack_lo: float = 3.0
    slack_hi: float = 8.0
    max_pending_per_tenant: int = 256
    max_total_pending: int = 4096
    scan_limit: int = 8
    # Elasticity knobs (the dynamic arm; the static arm zeroes both).
    dynamic: bool = True
    split_queue_depth: int = 48
    split_min_interval_s: float = 60.0   # virtual seconds
    max_splits: int = 6
    steal_threshold: int = 8
    steal_batch: int = 2
    steal_min_interval_s: float = 5.0
    # coordinated_burst: fraction of the run during which EVERY
    # arrival's tenant hashes into shard 0's range, starting at
    # burst_at (fractions of the arrival horizon).
    burst_at: float = 0.25
    burst_frac: float = 0.35


FABRIC_SCENARIOS: dict[str, dict] = {
    # Every tenant spikes one shard's hash range at once: the hot
    # shard's queue explodes while its peers idle — the shape splits
    # and stealing exist for.
    "coordinated_burst": {},
    # Sustained overload with a hair-trigger split threshold: the
    # topology must absorb REPEATED splits under load (epochs keep
    # advancing, routing stays exactly-one-owner throughout).
    "split_storm": {
        "utilization": 2.2,
        "burst_frac": 0.0,
        "split_queue_depth": 24,
        "split_min_interval_s": 30.0,
        "max_splits": 10,
    },
}


@dataclass
class _FabShard:
    pool: SlicePool
    sched: FairShareScheduler
    # placement_id -> {"start","size","live": set(sub_ids)}
    live: dict = field(default_factory=dict)


class _FabricSim:
    """The sharded event loop. Events: ``("arrive", i)`` and
    ``("done", shard, pid, sub_id)`` (stale if the entry was stolen or
    split away while queued — impossible once placed: only
    never-placed entries transfer, the fabric's rule)."""

    def __init__(self, spec: FabricLoadSpec, *, dynamic: bool):
        from multidisttorch_tpu_torch.service.topology import (
            SPLIT_BEGIN,
            SPLIT_COMMIT,
            Topology,
            tenant_hash,
        )

        self.spec = spec
        self.dynamic = dynamic
        self._SPLIT_BEGIN, self._SPLIT_COMMIT = SPLIT_BEGIN, SPLIT_COMMIT
        self._tenant_hash = tenant_hash
        self.rng = np.random.default_rng(
            np.random.SeedSequence([spec.seed, 0xFAB])
        )
        self.topo = Topology(spec.n_base)
        self.tenants = [f"t{i:03d}" for i in range(spec.n_tenants)]
        self.policies = {
            t: TenantPolicy(
                weight=1.0, max_pending=spec.max_pending_per_tenant
            )
            for t in self.tenants
        }
        # Tenants whose hash lands in base cell 0 — the burst's target
        # range (non-empty for any reasonable n_tenants).
        self.hot_tenants = [
            t
            for t in self.tenants
            if tenant_hash(t) % spec.n_base == 0
        ] or self.tenants[:1]
        self.shards: dict[int, _FabShard] = {
            k: self._new_shard() for k in self.topo.live_shards()
        }
        sizes = np.array([s for s, _ in spec.sizes])
        probs = np.array([p for _, p in spec.sizes], dtype=float)
        self._sizes, self._probs = sizes, probs / probs.sum()
        mean_work = float(
            (self._sizes * self._probs).sum()
            * np.exp(
                (np.log(spec.duration_lo_s) + np.log(spec.duration_hi_s))
                / 2
            )
        )
        base_capacity = spec.n_base * spec.slices_per_shard
        self.arrival_rate = spec.utilization * base_capacity / mean_work
        self.arrival_horizon = spec.n_submissions / self.arrival_rate
        self.now = 0.0
        self.heap: list = []
        self._seq = 0
        from multidisttorch_tpu_torch.telemetry.metrics import Histogram

        self.latency_hist = Histogram(VIRTUAL_LATENCY_BUCKETS)
        self.trials: dict[str, _SimTrial] = {}
        self.latencies: list = []
        self.rejected: dict[str, int] = {}
        self.deadline_tagged = 0
        self.deadline_hits = 0
        self.completed = 0
        self.double_completions = 0
        self.placements = 0
        self.splits = 0
        self.steals = 0
        self._last_split = float("-inf")
        self._last_steal = float("-inf")
        self._submitted = 0
        self._next_pid = 0

    def _new_shard(self) -> _FabShard:
        return _FabShard(
            pool=SlicePool(self.spec.slices_per_shard),
            sched=FairShareScheduler(
                dict(self.policies),
                max_total_pending=self.spec.max_total_pending,
            ),
        )

    def _push_event(self, t: float, kind: str, *payload) -> None:
        self._seq += 1
        heapq.heappush(self.heap, (t, self._seq, kind, payload))

    # -- workload -----------------------------------------------------

    def _pick_tenant(self) -> str:
        spec = self.spec
        if spec.burst_frac > 0:
            t0 = spec.burst_at * self.arrival_horizon
            t1 = t0 + spec.burst_frac * self.arrival_horizon
            if t0 <= self.now < t1:
                return self.hot_tenants[
                    int(self.rng.integers(0, len(self.hot_tenants)))
                ]
        return self.tenants[
            int(self.rng.integers(0, len(self.tenants)))
        ]

    def _gen_submission(self, i: int) -> None:
        spec = self.spec
        rng = self.rng
        tenant = self._pick_tenant()
        shard_id = self.topo.route(tenant)
        shard = self.shards[shard_id]
        size = int(rng.choice(self._sizes, p=self._probs))
        duration = float(
            np.exp(
                rng.uniform(
                    np.log(spec.duration_lo_s),
                    np.log(spec.duration_hi_s),
                )
            )
        )
        deadline_ts = None
        if rng.random() < spec.deadline_frac:
            deadline_ts = self.now + duration * float(
                rng.uniform(spec.slack_lo, spec.slack_hi)
            )
            self.deadline_tagged += 1
        bucket = f"b{size}x{int(rng.integers(0, spec.n_shape_buckets))}"
        sub_id = f"{tenant}-{i}"
        verdict, _ = shard.sched.admit_verdict(tenant)
        if verdict != ADMIT:
            self.rejected[verdict] = self.rejected.get(verdict, 0) + 1
            return
        entry = PendingTrial(
            sub_id=sub_id,
            tenant=tenant,
            priority=1,
            cfg=None,
            bucket=bucket,
            size=size,
            cost=duration * size,
            submit_ts=self.now,
            trial_id=i,
            deadline_ts=deadline_ts,
        )
        self.trials[sub_id] = _SimTrial(
            entry=entry,
            duration=duration,
            remaining=duration,
            arrival=self.now,
            deadline_ts=deadline_ts,
        )
        shard.sched.push(entry, now=self.now)

    # -- placement / completion --------------------------------------

    def _schedule_pass(self, shard_id: int) -> None:
        shard = self.shards.get(shard_id)
        if shard is None:
            return
        if shard.sched.pending_count() == 0 or shard.pool.free_total == 0:
            return
        placed = shard.sched.schedule(
            shard.pool,
            max_lanes=self.spec.max_lanes,
            now=self.now,
            scan_limit=self.spec.scan_limit,
        )
        for p in placed:
            self.placements += 1
            self._next_pid += 1
            pid = self._next_pid
            rec = {"start": p.start, "size": p.size, "live": set()}
            shard.live[pid] = rec
            for e in p.members:
                st = self.trials[e.sub_id]
                if st.placed_first is None:
                    st.placed_first = self.now
                    self.latencies.append(self.now - st.arrival)
                    self.latency_hist.observe(
                        self.now - st.arrival, exemplar=e.sub_id
                    )
                st.placed_at = self.now
                rec["live"].add(e.sub_id)
                self._push_event(
                    self.now + st.remaining, "done",
                    shard_id, pid, e.sub_id,
                )

    def _member_done(self, shard_id: int, pid: int, sub_id: str) -> None:
        shard = self.shards.get(shard_id)
        rec = shard.live.get(pid) if shard is not None else None
        if rec is None or sub_id not in rec["live"]:
            return  # stale event
        rec["live"].discard(sub_id)
        st = self.trials[sub_id]
        if st.done_at is not None:
            self.double_completions += 1  # would mean double-ownership
            return
        st.done_at = self.now
        st.remaining = 0.0
        self.completed += 1
        if st.deadline_ts is not None and self.now <= st.deadline_ts:
            self.deadline_hits += 1
        if not rec["live"]:
            del shard.live[pid]
            shard.pool.free(rec["start"], rec["size"])

    # -- elasticity ---------------------------------------------------

    def _apply_topo(self, event: str, parent: int, child: int) -> bool:
        ok = self.topo.apply(
            {
                "event": event,
                "parent": parent,
                "child": child,
                "epoch": self.topo.epoch + 1,
            }
        )
        if not ok:
            raise AssertionError(
                f"topology rejected {event} {parent}->{child}"
            )
        return ok

    def _maybe_split(self) -> Optional[int]:
        spec = self.spec
        if not self.dynamic or self.splits >= spec.max_splits:
            return None
        if self.now - self._last_split < spec.split_min_interval_s:
            return None
        for parent in sorted(self.shards):
            shard = self.shards[parent]
            if shard.sched.pending_count() < spec.split_queue_depth:
                continue
            prof = _ctlprof.get_ctlprof()
            _t = prof.t0() if prof is not None else 0.0
            self._last_split = self.now
            child = self.topo.next_shard_id()
            self._apply_topo(self._SPLIT_BEGIN, parent, child)
            keep, give = self.topo.split_halves(parent, child)
            dest = self._new_shard()
            # The fabric's handoff rule: only queued-but-unplaced
            # entries whose tenant hashes into the child's half move.
            examined = 0
            moved = 0
            for e in list(shard.sched.pending_entries()):
                examined += 1
                if give.matches(
                    self._tenant_hash(e.tenant), self.topo.n_base
                ):
                    took = shard.sched.take(e.sub_id)
                    if took is not None:
                        dest.sched.push(took, now=self.now)
                        moved += 1
            self._apply_topo(self._SPLIT_COMMIT, parent, child)
            self.shards[child] = dest
            self.splits += 1
            if prof is not None:
                prof.note(
                    "split_handoff", _t,
                    examined=examined, mutated=moved,
                )
            return child
        return None

    def _maybe_steal(self) -> Optional[tuple]:
        spec = self.spec
        if not self.dynamic:
            return None
        if self.now - self._last_steal < spec.steal_min_interval_s:
            return None
        thieves = [
            k
            for k, s in self.shards.items()
            if s.sched.pending_count() == 0
            and not s.live
            and s.pool.free_total > 0
        ]
        if not thieves:
            return None
        victims = sorted(
            (
                (s.sched.pending_count(), k)
                for k, s in self.shards.items()
                if s.sched.pending_count() >= spec.steal_threshold
            ),
            reverse=True,
        )
        if not victims:
            return None
        thief_id = min(thieves)
        _, victim_id = victims[0]
        victim, thief = self.shards[victim_id], self.shards[thief_id]
        prof = _ctlprof.get_ctlprof()
        _t = prof.t0() if prof is not None else 0.0
        moved = 0
        examined = 0
        # Steal from the queue's tail (newest), keeping the ORIGIN
        # tenant: the thief's fair-share lane charges that tenant.
        for e in reversed(victim.sched.pending_entries()):
            examined += 1
            took = victim.sched.take(e.sub_id)
            if took is not None:
                thief.sched.push(took, now=self.now)
                moved += 1
            if moved >= spec.steal_batch:
                break
        if prof is not None:
            prof.note("steal_grant", _t, examined=examined, mutated=moved)
        if moved:
            self._last_steal = self.now
            self.steals += moved
            return victim_id, thief_id
        return None

    # -- run ----------------------------------------------------------

    def run(self, *, progress=None) -> dict:
        spec = self.spec
        prof = _ctlprof.get_ctlprof()
        wall0 = time.perf_counter()
        self._push_event(0.0, "arrive", 0)
        while self.heap:
            t, _, kind, payload = heapq.heappop(self.heap)
            self.now = t
            if prof is not None:
                prof.pass_begin()
            dirty: set[int] = set()
            if kind == "arrive":
                (i,) = payload
                self._gen_submission(i)
                self._submitted += 1
                if i + 1 < spec.n_submissions:
                    gap = float(
                        self.rng.exponential(1.0 / self.arrival_rate)
                    )
                    self._push_event(self.now + gap, "arrive", i + 1)
                if progress is not None and (i + 1) % 50_000 == 0:
                    progress(i + 1, self)
                dirty.update(self.shards)
            else:
                shard_id, pid, sub_id = payload
                self._member_done(shard_id, pid, sub_id)
                dirty.add(shard_id)
            child = self._maybe_split()
            if child is not None:
                dirty.update(self.shards)
            stolen = self._maybe_steal()
            if stolen is not None:
                dirty.update(stolen)
            for k in dirty:
                self._schedule_pass(k)
            if prof is not None:
                prof.pass_end()
        wall = time.perf_counter() - wall0
        return self._report(wall)

    def _report(self, wall: float) -> dict:
        from multidisttorch_tpu_torch.telemetry.slo import (
            evaluate_offline,
            histogram_dict,
        )

        lat = np.array(self.latencies, dtype=float)
        unfinished = [
            s for s, st in self.trials.items() if st.done_at is None
        ]
        hist = histogram_dict(self.latency_hist)
        if self.latency_hist.exemplars:
            hist["p99_exemplar"] = self.latency_hist.percentile_exemplar(99)
        done_tagged = sum(
            1
            for st in self.trials.values()
            if st.deadline_ts is not None and st.done_at is not None
        )
        slo = evaluate_offline(
            default_loadgen_slos(),
            histograms={"placement_latency": hist},
            event_totals={
                "deadline": {
                    "good": self.deadline_hits,
                    "bad": max(0, done_tagged - self.deadline_hits),
                }
            },
        )
        return {
            "arm": "dynamic" if self.dynamic else "static",
            "submitted": self._submitted,
            "admitted": len(self.trials),
            "rejected": dict(self.rejected),
            "completed": self.completed,
            "unfinished": len(unfinished),
            "zero_lost": not unfinished,
            # Double-ownership would surface as the same submission
            # completing twice (two shards ran it): the production
            # topology trie + move-only-queued rule make it 0.
            "no_double_own": self.double_completions == 0,
            "double_completions": self.double_completions,
            "placements": self.placements,
            "splits": self.splits,
            "steals": self.steals,
            "final_shards": sorted(self.shards),
            "topology_epoch": self.topo.epoch,
            "sim_span_s": round(self.now, 1),
            "wall_s": round(wall, 2),
            "placement_latency_s": {
                "count": int(lat.size),
                "p50": round(float(np.percentile(lat, 50)), 3),
                "p95": round(float(np.percentile(lat, 95)), 3),
                "p99": round(float(np.percentile(lat, 99)), 3),
                "max": round(float(lat.max()), 3),
            } if lat.size else {"count": 0},
            "placement_latency_hist": hist,
            "slo": slo,
            "deadline": {
                "tagged": self.deadline_tagged,
                "completed_tagged": done_tagged,
                "hits": self.deadline_hits,
                "hit_rate": round(
                    self.deadline_hits / max(1, done_tagged), 4
                ),
            },
        }


def run_fabric_scenario(
    name: str,
    *,
    n_submissions: Optional[int] = None,
    seed: int = 0,
    progress=None,
    **overrides,
) -> dict:
    """Run one NAMED fabric scenario (:data:`FABRIC_SCENARIOS`) as a
    two-arm comparison — the dynamic-topology arm (splits + stealing)
    against the static-routing baseline over the identical seeded
    workload — and return the banked verdict: per-arm reports, SLO
    verdicts, and the within-10% p99/deadline gates the chaos drill
    and CI assert on."""
    if name not in FABRIC_SCENARIOS:
        raise ValueError(
            f"unknown fabric scenario {name!r}; expected one of "
            f"{sorted(FABRIC_SCENARIOS)}"
        )
    kw = dict(FABRIC_SCENARIOS[name])
    kw.update(overrides)
    kw["scenario"] = name
    kw["seed"] = seed
    if n_submissions is not None:
        kw["n_submissions"] = int(n_submissions)
    spec = FabricLoadSpec(**kw)
    dyn = _FabricSim(spec, dynamic=True).run(progress=progress)
    sta = _FabricSim(spec, dynamic=False).run(progress=progress)
    d99 = dyn["placement_latency_s"].get("p99")
    s99 = sta["placement_latency_s"].get("p99")
    p99_ok = (
        d99 is not None
        and s99 is not None
        and d99 <= s99 * 1.10 + 1e-9
    )
    dh = dyn["deadline"]["hit_rate"]
    sh = sta["deadline"]["hit_rate"]
    deadline_ok = dh >= sh * 0.90 - 1e-9
    return {
        "protocol": "fabric_loadgen_v1",
        "scenario": name,
        "spec": {
            "n_submissions": spec.n_submissions,
            "seed": spec.seed,
            "n_base": spec.n_base,
            "slices_per_shard": spec.slices_per_shard,
            "utilization": spec.utilization,
            "split_queue_depth": spec.split_queue_depth,
            "steal_threshold": spec.steal_threshold,
            "burst_at": spec.burst_at,
            "burst_frac": spec.burst_frac,
        },
        "dynamic": dyn,
        "static": sta,
        "gates": {
            "zero_lost": dyn["zero_lost"] and sta["zero_lost"],
            "no_double_own": dyn["no_double_own"],
            "p99_within_10pct_of_static": p99_ok,
            "deadline_within_10pct_of_static": deadline_ok,
        },
    }


# ---------------------------------------------------------------------
# Scenario zoo: NAMED, seeded, bit-reproducible workload
# scenarios driving the production scheduler classes with the
# control-plane profiler armed. Each scenario is a registry entry —
# pool scenarios modulate the single-pool replay's default-off LoadSpec
# knobs; fabric scenarios delegate to :func:`run_fabric_scenario`
# (the two-arm dynamic-vs-static drill, promoted into the same
# registry). ``run_scenario`` returns one self-contained artifact
# envelope: the full report, a per-scenario SLO verdict (thresholds ON
# the banked histogram bounds, so evaluation is exact), the
# control-plane flight books, and a one-line headline —
# the JAX package's ``bench.py --zoo`` banks one artifact per scenario and folds the
# headline + per-phase books into ``artifacts/ctlprof_ledger.jsonl``
# for cross-round drift tracking.
# ---------------------------------------------------------------------

SCENARIOS: dict[str, dict] = {
    # Arrival rate swells and thins sinusoidally (amplitude 0.7, four
    # periods over the horizon): the scheduler must drain the crest's
    # backlog during the trough without fairness drift.
    "diurnal_wave": {
        "kind": "pool",
        "overrides": {"utilization": 1.4, "wave_amp": 0.7},
        "latency_threshold_s": 1000.0,
        "latency_objective": 0.99,
        "deadline_objective": 0.90,
    },
    # A light tenant (weight 1) floods 70% of arrivals for a fifth of
    # the horizon: quotas + backpressure must absorb the flood and the
    # heavy tenants' shares must hold through it.
    "tenant_burst": {
        "kind": "pool",
        "overrides": {
            "utilization": 1.6,
            "burst_tenant": "echo",
            "burst_share": 0.7,
        },
        "latency_threshold_s": 1000.0,
        "latency_objective": 0.97,
        "deadline_objective": 0.85,
    },
    # One tenant tags EVERYTHING with a tight deadline to ride EDF
    # past its fair share: per-(tenant, lane) EDF queues + the
    # preemption urgency window must contain the gaming — honest
    # tenants' deadline hit rate (banked separately from the gamer's
    # self-inflicted misses) is what the SLO judges.
    "deadline_gaming": {
        "kind": "pool",
        "overrides": {"utilization": 2.0, "gamer_tenant": "bravo"},
        "latency_threshold_s": 2000.0,
        "latency_objective": 0.97,
        "deadline_objective": 0.80,
    },
    # 5% pipelined whales (two 4-slice stage blocks, all-or-nothing)
    # among single-slice shrimps: the whale's vector placement needs a
    # defrag-grade free map while shrimps keep fragmenting it.
    "pipeline_whale_shrimp": {
        "kind": "pool",
        "overrides": {
            "utilization": 1.6,
            "whale_frac": 0.05,
            "whale_stages": (4, 4),
            "sizes": ((1, 0.85), (2, 0.15)),
        },
        "latency_threshold_s": 2000.0,
        "latency_objective": 0.95,
        "deadline_objective": 0.85,
    },
    # The shape-bucket key rotates through 8 epochs so open co-pack
    # placements keep going stale: the bin-pack scan's worst case —
    # work-touched accounting's reason to exist.
    "dataset_thrash": {
        "kind": "pool",
        "overrides": {"utilization": 2.0, "thrash_buckets": 8},
        "latency_threshold_s": 2000.0,
        "latency_objective": 0.95,
        "deadline_objective": 0.85,
    },
    # The fabric drills, promoted into the registry: two-arm
    # (dynamic vs static) sharded replays through the production
    # routing trie. Their workload knobs live in FABRIC_SCENARIOS.
    "coordinated_burst": {"kind": "fabric"},
    "split_storm": {"kind": "fabric"},
}

# Pool scenarios default to a CI-sized replay; the 1M-grade runs go
# through the JAX package's ``bench.py --zoo --zoo-n``.
ZOO_POOL_DEFAULT_N = 100_000


def zoo_names() -> list[str]:
    return sorted(SCENARIOS)


def _scenario_slos(ent: dict):
    """Per-scenario SLO specs — thresholds chosen ON
    :data:`VIRTUAL_LATENCY_BUCKETS` bounds so histogram evaluation is
    exact, objectives tuned per scenario (a deadline-gaming run is
    JUDGED at the containment level it can honestly hold, not the
    default 0.90 it is built to violate)."""
    from multidisttorch_tpu_torch.telemetry.slo import EVENT, LATENCY, SloSpec

    thr = float(ent.get("latency_threshold_s", 1000.0))
    return (
        SloSpec(
            name=f"placement_p_{int(thr)}s",
            kind=LATENCY,
            source="placement_latency",
            threshold_s=thr,
            objective=float(ent.get("latency_objective", 0.99)),
            description="admitted submissions reach first placement "
            f"within {int(thr)} virtual seconds",
        ),
        SloSpec(
            name="deadline_hit_rate",
            kind=EVENT,
            source="deadline",
            objective=float(ent.get("deadline_objective", 0.90)),
            description="completed deadline-tagged submissions finish "
            "before their deadline",
        ),
    )


def run_scenario(
    name: str,
    *,
    n_submissions: Optional[int] = None,
    seed: int = 0,
    progress=None,
    ctl: bool = True,
    flame_path: Optional[str] = None,
    **overrides,
) -> dict:
    """Run one named zoo scenario and return the banked artifact
    envelope. When no control-plane profiler is armed and ``ctl`` is
    true, one is armed for the run and retired after — the envelope's
    ``ctl`` block always carries the run's flight books and
    ``ctl_trace`` its Perfetto pass-ring track. ``flame_path`` lands
    the sampling profiler's collapsed stacks there when
    ``MDT_CTLPROF_SAMPLE_HZ`` arms it (own-profiler runs only)."""
    from multidisttorch_tpu_torch.telemetry.slo import evaluate_offline

    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; expected one of {zoo_names()}"
        )
    ent = SCENARIOS[name]
    own = False
    prof = _ctlprof.get_ctlprof()
    if ctl and prof is None:
        prof = _ctlprof.configure(flame_path=flame_path)
        own = True
    try:
        if ent["kind"] == "fabric":
            report = run_fabric_scenario(
                name,
                n_submissions=n_submissions,
                seed=seed,
                progress=progress,
                **overrides,
            )
            spec_block = report["spec"]
            # The DYNAMIC arm is the system under judgment; the static
            # arm is the designed-to-degrade control (coordinated
            # bursts without splits/stealing are EXPECTED to blow the
            # default SLOs — that gap is the drill's point, gated
            # relatively below).
            slo = {
                "dynamic": report["dynamic"]["slo"],
                "static": report["static"]["slo"],
                "met": report["dynamic"]["slo"]["met"],
            }
            gates = dict(report["gates"])
            gates["slo_met"] = slo["met"]
            wall = report["dynamic"]["wall_s"] + report["static"]["wall_s"]
            submitted = (
                report["dynamic"]["submitted"]
                + report["static"]["submitted"]
            )
            zero_lost = report["gates"]["zero_lost"]
        else:
            kw = dict(ent.get("overrides") or {})
            kw.update(overrides)
            kw["seed"] = seed
            kw["n_submissions"] = int(
                n_submissions
                if n_submissions is not None
                else ZOO_POOL_DEFAULT_N
            )
            spec = LoadSpec(**kw)
            report = _Sim(spec).run(progress=progress)
            spec_block = report["spec"]
            dl = report["deadline"]
            # deadline_gaming judges HONEST tenants only — the gamer's
            # self-inflicted misses are its own problem, banked in the
            # report's honest/gamer split for reference.
            judged = dl["honest"] if dl.get("honest") is not None else dl
            slo = evaluate_offline(
                _scenario_slos(ent),
                histograms={
                    "placement_latency": report["placement_latency_hist"],
                },
                event_totals={
                    "deadline": {
                        "good": judged["hits"],
                        "bad": max(
                            0,
                            judged["completed_tagged"] - judged["hits"],
                        ),
                    }
                },
            )
            gates = {
                "zero_lost": report["zero_lost"],
                "slo_met": slo["met"],
                "slo_exact": all(
                    s.get("exact") for s in slo["slos"].values()
                ),
            }
            wall = report["wall_s"]
            submitted = report["submitted"]
            zero_lost = report["zero_lost"]
        books = (
            prof.books()
            if (ctl and prof is not None)
            else {"enabled": False}
        )
        ctl_trace = (
            prof.trace_events(pid=0)
            if (ctl and prof is not None)
            else []
        )
    finally:
        if own:
            _ctlprof.disable()
    wt = books.get("work_touched") or {}
    passes = books.get("passes") or {}
    return {
        "protocol": "scenario_zoo_v1",
        "scenario": name,
        "kind": ent["kind"],
        "seed": seed,
        "spec": spec_block,
        "report": report,
        "slo": slo,
        "gates": gates,
        "ctl": books,
        "ctl_trace": {"traceEvents": ctl_trace},
        "headline": {
            "submissions": submitted,
            "wall_s": round(wall, 2),
            "submissions_per_wall_s": (
                round(submitted / wall, 1) if wall > 0 else None
            ),
            "zero_lost": zero_lost,
            "slo_met": slo["met"],
            # Informational, NOT a gate: zoo scenarios skew offered
            # demand on purpose, and ratio-to-weight only reads near
            # 1.0 when every tenant over-demands its entitlement.
            "fairness_max_abs_ratio_error": (
                report["fairness"]["max_abs_ratio_error"]
                if ent["kind"] == "pool"
                else None
            ),
            "ctl_passes_per_s": passes.get("per_s"),
            "ctl_scan_efficiency": wt.get("scan_efficiency"),
        },
    }
