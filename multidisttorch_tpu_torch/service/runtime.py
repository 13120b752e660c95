"""The sweep service daemon: a persistent scheduler over device slots.

Counterpart of the JAX package's ``service/runtime.py``. :class:`SweepService`
is the loop that turns ``run_hpo``'s batch machinery into a service
(docs/SERVICE.md):

- **intake**: drain the durable submission spool
  (:mod:`service.queue`), run admission (quota/backpressure verdicts),
  assign trial ids and config hashes, and — when the compile farm is
  on — warm each admitted trial's executables BEFORE placement
  (:class:`~multidisttorch_tpu_torch.compile.farm.PrecompilePool`).
- **scheduling**: one DRR pass per tick
  (:class:`~multidisttorch_tpu_torch.service.scheduler.FairShareScheduler`);
  each placement becomes a live ``_TrialRun`` (or, for co-packed
  same-shape trials — tenants mixed — a ``_StackedBucketRun``) on the
  placement's block of slots.
- **stepping**: the driver's cooperative-generator discipline — one
  async dispatch per placement per tick, no cross-placement barrier
  anywhere; completion/divergence/infra-retry handling mirrors
  ``_run_hpo_body``'s supervision, with the ledger carrying
  tenant/priority/submit_ts provenance on every attempt record.
- **defragmentation**: a large-shape trial starved past
  ``starvation_s`` behind a fragmented slice map triggers
  :func:`~multidisttorch_tpu_torch.service.defrag.plan_defrag`; victims are
  checkpoint-drained and migrated (the scan-back restore) to open a
  contiguous block, under typed ``defrag_*`` events.
- **durability**: every state transition is journaled
  (``queue.jsonl``) and every attempt is ledgered BEFORE the matching
  in-memory transition, so a ``kill -9`` at any instant loses no
  submission: the restarted daemon re-folds both files and resumes
  (placed-but-unsettled trials re-place with scan-back restore).
- **books**: per-tenant goodput (off the tenant-tagged ledger),
  queue-wait and placement-latency histograms, the fragmentation
  gauge, and defrag accounting — written atomically to
  ``service_books.json`` and mirrored as telemetry events for
  ``tools/sweep_top.py --service``.

SIGTERM drain (the CLI installs the handler): in-flight checkpoint
writes land, live attempts are recorded ``preempted``/``unplaced``,
books are written, and ``serve`` returns a drained report — under
the elastic supervisor the daemon then exits with the preemption code
and is relaunched into the next world.

**Slots, the port's placement rule.** The JAX service carves a k-slice
placement into a k-device data-parallel submesh. Here a slice is a device
*slot*: ``devices=`` lists the slots (a device may repeat, as
``parallel/mesh.py::setup_groups(devices=)`` allows), by default every
visible card (the CPU when ``device="cpu"``); an ``n_slices`` that is a
multiple of the device count gives each device ``n_slices / devices``
consecutive slots, so on one card ``n_slices=4`` is four slots on
``cuda:0``. A k-slice placement trains its trial (or co-packed bucket) as
one one-slot ``TrialGroup`` on its block's first slot, over the whole group
batch: the loss and gradient of the JAX package's k-device data-parallel
step. The scheduler, fair share, defrag and preemption see k slices as
before; ``books()["placements"]`` reports each placement's slots and
device. A placement spread over several cards, one rank per card, needs
multi-rank graph capture (ROADMAP A.12c), and a slice of several devices
raises. Pipeline placements fail their trial with ``NotImplementedError``
naming ROADMAP A.14. The fabric's replicas (``service/fabric.py``) run one
service per owned shard through the ``fence``, ``fence_epoch`` and
``route_check`` callables, honoured as in the JAX package, and hand queued
work to another shard (a split's handoff, a steal's grant) through
:meth:`SweepService.extract_queued`. A moved trial leaves nothing on the
card here: the precapture farm's program it planned at admission (a
captured slot holds its graphs and static state) is released with it,
unless a trial still here needs the same program.

Every placement's cooperative dispatch runs under ``train/steps.py``'s
``device_turn``, the gate a precapture farm's captures hold, as
``run_hpo``'s host loop does.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Optional

from multidisttorch_tpu_torch.hpo.ledger import SweepLedger, config_hash
from multidisttorch_tpu_torch.hpo.supervision import (
    DIVERGENCE,
    FATAL,
    INFRA,
    PREEMPTION,
    RetryPolicy,
    SETTLED_STATUSES,
    UnretryableError,
    classify_failure,
)
from multidisttorch_tpu_torch.service import queue as squeue
from multidisttorch_tpu_torch.service.defrag import (
    PlacedBlock,
    plan_defrag,
    plan_preemption,
)
from multidisttorch_tpu_torch.service.scheduler import (
    ADMIT,
    FairShareScheduler,
    PendingTrial,
    Placement,
    PreemptionPolicy,
    REJECT_INVALID,
    SlicePool,
    TenantPolicy,
)
from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof
from multidisttorch_tpu_torch.telemetry import trace as ttrace
from multidisttorch_tpu_torch.train.steps import device_turn
from multidisttorch_tpu_torch.utils.logging import log0

BOOKS_NAME = "service_books.json"

# The feature dim the service's trial family (the VAE) trains on: a
# dataset reference of another dim is refused at admission.
TRIAL_INPUT_DIM = 784

# Histogram bucket edges for the scheduling-latency books (seconds).
# Finer than the step-time defaults at the low end: queue waits and
# placement latencies of interest run 10 ms .. minutes.
LATENCY_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0, 600.0,
)


def slots_for(devices=None, n_slices: Optional[int] = None, device=None) -> list:
    """The service's device slots (module docstring, "Slots"): ``devices``
    (default every visible card, or the CPU for ``device="cpu"``), each
    repeated ``n_slices / len(devices)`` times when ``n_slices`` is a
    multiple of their count. A slice of several devices raises (ROADMAP
    A.12c)."""
    import torch

    from multidisttorch_tpu_torch.parallel.cluster import default_device

    if devices is None:
        dev = default_device(device)  # raises where CUDA is asked for and absent
        every_card = dev.type == "cuda" and torch.device("cuda" if device is None else device).index is None
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] if every_card else [dev]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("the service needs at least one device")
    n = len(devs) if n_slices is None else int(n_slices)
    if n < 1:
        raise ValueError(f"n_slices must be >= 1, got {n}")
    if n % len(devs):
        if len(devs) % n == 0:
            raise NotImplementedError(
                f"{len(devs)} devices in {n} slices puts several devices in one slice: multi-device "
                "placements are ROADMAP A.12c"
            )
        raise ValueError(f"{len(devs)} devices do not divide into {n} slices")
    return [d for d in devs for _ in range(n // len(devs))]


def _emit(kind: str, **data) -> None:
    from multidisttorch_tpu_torch.telemetry.events import get_bus

    bus = get_bus()
    if bus is not None:
        bus.emit(kind, **data)


class PlacementNotPorted(UnretryableError, NotImplementedError):
    """A placement kind the port does not run yet: a ``NotImplementedError``
    naming its ROADMAP item, which supervision never retries."""


class TaggedLedger(SweepLedger):
    """A :class:`SweepLedger` that stamps tenant provenance on every
    attempt record from a trial-id → tags map, so the driver-owned
    call sites (``_StackedBucketRun`` ledgers its own lanes) carry the
    service's multi-tenant identity without knowing about tenants.

    ``fence`` (the fabric's shard-ownership check) gates every append:
    a replica that lost its shard lease must not write one more record
    to a ledger the new owner now folds — the check raises before the
    open, so a stale incarnation's appends are REJECTED, never
    interleaved (docs/SERVICE.md "Fencing")."""

    def __init__(self, out_dir: str, *, fence=None, epoch=None, **kw):
        super().__init__(out_dir, **kw)
        self.tags: dict[int, dict] = {}
        self._fence = fence
        # Fencing epoch of the writing replica (fabric): stamped on
        # every record, like the journal's — the trace layer's
        # takeover evidence. None serializes nothing (byte-compat).
        self._epoch = epoch

    def append(self, event: dict) -> None:
        if self._fence is not None:
            self._fence()
        if self._epoch is not None:
            event = {**event, "epoch": int(self._epoch)}
        super().append(event)

    def tag(
        self, trial_id: int, *, tenant, priority, submit_ts, trace=None
    ) -> None:
        self.tags[trial_id] = {
            "tenant": tenant,
            "priority": priority,
            "submit_ts": submit_ts,
            **({"trace": trace} if trace else {}),
        }

    def attempt_start(self, trial_id, chash, attempt, **kw):
        t = self.tags.get(trial_id, {})
        for k, v in t.items():
            kw.setdefault(k, v)
        super().attempt_start(trial_id, chash, attempt, **kw)

    def attempt_end(self, trial_id, chash, attempt, status, **kw):
        t = self.tags.get(trial_id, {})
        for k, v in t.items():
            kw.setdefault(k, v)
        super().attempt_end(trial_id, chash, attempt, status, **kw)


def fold_tenant_goodput(records: list[dict]) -> dict[str, dict]:
    """Per-tenant goodput off tenant-tagged LEDGER records — the
    durable accounting that survives daemon kills (the telemetry fold
    in ``telemetry/export.py`` keeps the live mirror). Same math as
    ``SweepFold``: ``executed`` covers every attempt's own work plus
    any killed-attempt prefix visible only as a later resume point;
    ``useful`` counts settled attempts' cumulative steps."""
    books: dict[str, dict] = {}
    fold_tenant_goodput_into(books, {}, records)
    return finalize_tenant_goodput(books)


def fold_tenant_goodput_into(
    books: dict[str, dict], covered: dict[int, int], records: list[dict]
) -> None:
    """Incremental form of :func:`fold_tenant_goodput`: accumulate new
    ledger records into persistent state (``covered`` is the per-trial
    step-coverage map the killed-attempt accounting needs)."""
    for ev in records:
        if ev.get("event") != "attempt_end":
            continue
        tenant = ev.get("tenant")
        if tenant is None:
            continue
        b = books.setdefault(
            tenant,
            {
                "attempts": 0,
                "settled": 0,
                "useful_steps": 0,
                "executed_steps": 0,
                "statuses": {},
            },
        )
        b["attempts"] += 1
        status = ev.get("status", "?")
        b["statuses"][status] = b["statuses"].get(status, 0) + 1
        s = ev.get("summary") or {}
        done = int(s.get("steps", s.get("steps_at_failure", 0)) or 0)
        resumed = int(s.get("resumed_from_step", 0) or 0)
        tid = int(ev.get("trial_id", -1))
        cov = covered.get(tid, 0)
        b["executed_steps"] += max(0, done - resumed) + max(0, resumed - cov)
        covered[tid] = max(cov, done)
        if status in SETTLED_STATUSES:
            b["settled"] += 1
            b["useful_steps"] += done


def finalize_tenant_goodput(books: dict[str, dict]) -> dict[str, dict]:
    """Derive goodput into a fresh snapshot (the persistent fold state
    stays counters-only, so repeated finalization never double-writes)."""
    out = {}
    for tenant, b in books.items():
        out[tenant] = {
            **{k: (dict(v) if isinstance(v, dict) else v)
               for k, v in b.items()},
            "goodput": (
                round(b["useful_steps"] / b["executed_steps"], 4)
                if b["executed_steps"]
                else None
            ),
        }
    return out


@dataclass
class _Active:
    """One live placement: the run object, its generator, and the
    member bookkeeping the settle/retry/defrag paths need."""

    placement_id: int
    start: int
    size: int
    stacked: bool
    run: object
    gen: object
    entries: dict  # trial_id -> PendingTrial
    place_ts: float
    construct_s: float
    first_step_done: bool = False
    tenants: tuple = ()
    # Vector (MPMD pipelined) placement: one (start, size) block per
    # stage. None for classic placements; when set, start/size hold
    # the first block / the total and freeing walks every block.
    blocks: Optional[list] = None
    # Prebuilt trace attribution (telemetry/trace.py): the member
    # (trial_id, trace_id) pairs, installed around each cooperative
    # dispatch so compile-registry events ride the members' traces.
    # Built ONCE at placement; the per-dispatch cost is two
    # thread-local writes, and zero when telemetry is off.
    trace_attr: Optional[dict] = None

    def free_blocks(self) -> list:
        return list(self.blocks) if self.blocks else [(self.start, self.size)]

    def movable(self, snapshot_drain: bool = True) -> bool:
        """Defrag/preemption victim eligibility, decided at PLAN time:
        never with an UNFLUSHED checkpoint the drain cannot account
        for. Precisely: movable iff (a durable checkpoint exists, a
        checkpoint write is in flight, or the trial has made no
        optimizer step — nothing to lose) AND, under the join drain
        (``snapshot_drain=False``), no checkpoint write is in flight.
        The snapshot-fast drain (the default) ADOPTS an in-flight write
        instead of blocking eligibility — it lands in the background
        before the victim's ``preempted`` record, the same-process
        re-place prefers the newer RAM snapshot, and the save path's
        step guard keeps a stale late persist from replacing a
        successor's newer manifest — so migration never rolls back
        past it.

        Stacked buckets are movable too: the drain itself snapshots
        every live stacked lane at its epoch boundary
        (``drain_snapshot`` — all K lanes together), so it cannot lose
        progress it did not first make durable. Only the join drain
        defers one, while a drain write of the bucket is in flight."""
        run = self.run
        t = getattr(run, "_ckpt_thread", None)
        in_flight = t is not None and t.is_alive()
        if self.stacked:
            return snapshot_drain or not in_flight
        if in_flight and not snapshot_drain:
            return False  # unflushed checkpoint write in flight
        has_ckpt = bool(run.result.checkpoint) or in_flight
        return has_ckpt or int(getattr(run, "_step_no", 0)) == 0


@dataclass
class _PendingPersist:
    """A snapshot-drained victim whose checkpoint persistence is still
    landing in the background (docs/RESILIENCE.md "Snapshot-fast
    drain"). The placement's slices are already free and the entry is
    already requeued (a defrag victim must claim its pinned relocation
    target on the NEXT pass — deferring the requeue would let another
    tenant steal it and waste the whole window); only the ledger
    ``preempted`` record waits for the persist — the honesty rule: a
    crash before the persist leaves an OPEN attempt whose scan-back
    restores the previous durable step, exactly as if the drain had
    never happened. ``chash``/``attempt`` are captured at drain time:
    the victim may re-place — even settle — before its old attempt's
    record becomes writable."""

    ap: _Active
    entry: object  # PendingTrial
    reason: str
    progress: dict
    chash: str
    attempt: int
    t0: float
    snapshot_s: float


class SweepService:
    """The persistent multi-tenant sweep daemon (see module docstring).

    Construct once per daemon process and call :meth:`serve`. All
    durable state lives under ``service_dir`` (queue journal, sweep
    ledger, per-trial checkpoints, telemetry, books): a new
    ``SweepService`` over the same directory resumes the previous
    incarnation's world exactly.
    """

    def __init__(
        self,
        service_dir: str,
        *,
        n_slices: Optional[int] = None,
        devices=None,
        max_lanes: int = 4,
        policies: Optional[dict[str, TenantPolicy]] = None,
        default_policy: Optional[TenantPolicy] = None,
        max_total_pending: int = 4096,
        train_data=None,
        test_data=None,
        data_rows: int = 512,
        dataset_cache_bytes: Optional[int] = None,
        dataset_ram_entries: int = 8,
        starvation_s: float = 3.0,
        defrag_enabled: bool = True,
        defrag_cooldown_s: float = 1.0,
        preempt: Optional[PreemptionPolicy] = None,
        fence=None,
        fence_epoch: Optional[int] = None,
        route_check=None,
        slos=None,
        retry: Optional[RetryPolicy] = None,
        save_checkpoints: bool = True,
        ckpt_keep_last: int = 2,
        ckpt_format: Optional[str] = None,
        snapshot_drain: Optional[bool] = None,
        verbose: bool = False,
        precompile: bool = False,
        idle_sleep_s: float = 0.02,
        books_every_s: float = 1.0,
        device=None,
    ):
        from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
        from multidisttorch_tpu_torch.parallel.mesh import setup_groups

        self.service_dir = service_dir
        os.makedirs(service_dir, exist_ok=True)
        self._slots = slots_for(devices, n_slices, device)
        self.n_slices = len(self._slots)
        # One one-slot group per slot, group id = slot index: a placement
        # trains on the group of its block's first slot.
        self._groups = setup_groups(self.n_slices, devices=self._slots)
        self._devs_per_slice = 1
        self.max_lanes = int(max_lanes)
        self.pool = SlicePool(self.n_slices)
        self.sched = FairShareScheduler(
            policies,
            default_policy=default_policy,
            max_total_pending=max_total_pending,
        )
        # The shard fence (fabric replicas): a zero-arg callable that
        # raises FenceLost when this service's shard lease was taken
        # over — checked at every tick and before every durable append,
        # so a paused-and-resumed replica cannot double-place work the
        # new owner already re-homed.
        self._fence = fence
        # The fencing epoch (fabric replicas) is stamped on every
        # journal/ledger record this incarnation writes — the offline
        # trace builder's evidence that a submission's span tree is
        # contiguous across a lease takeover.
        self.fence_epoch = fence_epoch
        # Topology routing check (fabric replicas): a callable
        # ``tenant -> Optional[int]`` returning the shard id the tenant
        # ACTUALLY routes to when it is not this service's shard, else
        # None. A submission spooled here after a split moved its
        # tenant away gets an explicit ``rejected_wrong_shard`` verdict
        # naming the owner — the fabric client re-reads the topology
        # and resubmits there (one bounded retry). None disables the
        # check (plain single-shard service).
        self.route_check = route_check
        self.queue = squeue.SubmissionQueue(
            service_dir, fence=fence, epoch=fence_epoch
        )
        self.ledger = TaggedLedger(
            service_dir, fence=fence, epoch=fence_epoch
        )
        # Live SLO engine (telemetry/slo.py): observations ride the
        # existing latency/deadline/goodput seams, evaluation lands in
        # the books at the books cadence plus typed slo_* events.
        from multidisttorch_tpu_torch.telemetry.slo import SloEngine

        self.slo = SloEngine(slos)
        self.train_data = (
            train_data
            if train_data is not None
            else synthetic_mnist(data_rows, seed=0)
        )
        self.test_data = test_data
        # Per-submission datasets (docs/DATA.md): content-addressed
        # host-side cache + background prefetch, so a tenant's
        # cfg.dataset resolves at ADMISSION off the daemon loop and
        # placement only ever takes a RAM-warm dataset.
        from multidisttorch_tpu_torch.data.store import DatasetStore

        self.store = DatasetStore(
            os.path.join(service_dir, "dataset_cache"),
            byte_budget=dataset_cache_bytes,
            ram_entries=dataset_ram_entries,
        )
        self.starvation_s = float(starvation_s)
        self.defrag_enabled = bool(defrag_enabled)
        self.defrag_cooldown_s = float(defrag_cooldown_s)
        self.preempt = preempt if preempt is not None else PreemptionPolicy()
        self.retry = retry
        self.save_checkpoints = bool(save_checkpoints)
        self.ckpt_keep_last = int(ckpt_keep_last)
        # Checkpoint data plane (docs/RESILIENCE.md "Checkpoint format
        # v2"): the format every placement writes, and the drain mode —
        # snapshot-fast (the default: a preemption completes at the
        # device→host snapshot, persistence lands on the victim's
        # background writer, the freed slices place the starved trial
        # immediately) or the join drain (MDT_SNAPSHOT_DRAIN=0, the
        # checkpoint drill's v1 comparison arm: the write joined inline).
        from multidisttorch_tpu_torch.train.checkpoint import default_format

        self.ckpt_format = (
            ckpt_format if ckpt_format is not None else default_format()
        )
        self.snapshot_drain = bool(
            snapshot_drain
            if snapshot_drain is not None
            else os.environ.get("MDT_SNAPSHOT_DRAIN", "1") != "0"
        )
        self._pending_persists: list[_PendingPersist] = []
        # Counter baseline for this INSTANCE's books: the checkpoint
        # counters are process-wide, and a fabric replica runs one
        # SweepService per owned shard in one process — each shard's
        # books must report its own era, not the process totals.
        # (Two CONCURRENTLY-live shard services still share the
        # counters; their books are deltas from their own adoption,
        # the honest per-incarnation view the fold can sum.)
        from multidisttorch_tpu_torch.train.checkpoint import ckpt_counters

        self._ckpt_counter_base = ckpt_counters()
        self.verbose = bool(verbose)
        self.precompile = bool(precompile)
        self.idle_sleep_s = float(idle_sleep_s)
        self.books_every_s = float(books_every_s)

        # Mutable service state.
        self.active: dict[int, _Active] = {}
        self.attempts: dict[int, int] = {}
        self.chashes: dict[int, str] = {}
        self.infra_fails: dict[int, int] = {}
        self.entries: dict[int, PendingTrial] = {}  # trial_id -> entry
        self.settled: dict[str, str] = {}  # sub_id -> terminal status
        self.next_trial_id = 0
        self._stop = False
        self._farm = None
        # trial_id -> the registry key its admission planned on the farm.
        self._warm_keys: dict[int, tuple] = {}
        self._last_books_ts = 0.0
        self._last_defrag_ts = 0.0
        self._last_preempt_scan = float("-inf")
        self._defrag_count = 0
        self._defrag_moved_slices = 0
        # sub_ids a defrag opened a window FOR (pending verdict) vs
        # sub_ids that then actually placed: "unblocked" is recorded at
        # placement, never at plan time — another tenant's small trial
        # can steal the opened window and leave the starved trial
        # blocked, and the books must not claim otherwise.
        self._defrag_targets: set = set()
        self._defrag_unblocked: list[str] = []
        # Deadline/preemption accounting (same placement-time verdict
        # discipline as defrag: "unblocked" lands when the deadline
        # trial actually places, never at plan time).
        self._preempt_targets: set = set()
        self._preempt_unblocked: list[str] = []
        self._preempt_events = 0
        self._preempt_evictions = 0
        self._preempt_evicted_slices = 0
        self._deadline_hits = 0
        self._deadline_misses = 0
        self._frag_max = 0.0
        self._known_ids: set = set()
        self.tick_parts: dict[str, float] = {}
        self._step_cursor = 0  # the round robin of a budgeted tick
        # Cumulative cooperative dispatches across all placements —
        # the fabric replica's fault clock (daemon_lost fires on it).
        self.dispatches = 0
        # Incremental books state: a persistent daemon must not
        # re-read its whole append-only journal/ledger history on
        # every books write (O(n²) over the daemon lifetime) — only
        # newly appended complete lines are folded in.
        self._qfold: dict = {}
        self._qoffset = 0
        self._tenant_fold: dict = {}
        self._tenant_covered: dict = {}
        self._led_offset = 0

        from multidisttorch_tpu_torch.telemetry.metrics import Histogram

        self.queue_wait = Histogram(LATENCY_BUCKETS)
        self.placement_latency = Histogram(LATENCY_BUCKETS)
        # Firing slo_alert events cite the burning histogram's p99
        # worst-offender submission id (percentile_exemplar) — the
        # alert-to-trace jump. The observe seams below pass
        # exemplar=sub_id into these same books.
        self.slo.attach_exemplar("queue_wait", self.queue_wait)
        self.slo.attach_exemplar("placement_latency", self.placement_latency)
        # Drain-phase books: snapshot = drain call → slices freed;
        # persist = drain call → the victim's checkpoint durably on
        # disk (the ledger-record moment). The gap between the two is
        # the latency the snapshot-fast drain takes OFF the starved
        # trial's critical path.
        self.drain_snapshot = Histogram(LATENCY_BUCKETS)
        self.drain_persist = Histogram(LATENCY_BUCKETS)

        self._recover()
        if self.precompile:
            from multidisttorch_tpu_torch.compile.farm import PrecompilePool

            self._farm = PrecompilePool()
            # Warm everything recovered pending at boot.
            for e in self.sched.pending_entries():
                self._warm(e)

    # -- slots ------------------------------------------------------

    def _group_for(self, start: int, size: int):
        """The group a placement of ``size`` slots at ``start`` trains on:
        its first slot's (module docstring, "Slots"). A block spread over
        several devices would need one rank per device (ROADMAP A.12c)."""
        block = self._slots[start : start + size]
        if any(d != block[0] for d in block):
            raise NotImplementedError(
                f"a placement over slots {start}..{start + size - 1} spans devices "
                f"{sorted({str(d) for d in block})}: multi-device placements are ROADMAP A.12c"
            )
        return self._groups[start]

    # -- recovery -----------------------------------------------------

    def _recover(self) -> None:
        """Rebuild the scheduler's world from the durable journal: the
        zero-lost-submissions contract. Settled/rejected submissions
        stay settled; everything else re-enters the queue (ever-placed
        work flagged ``resume_scan`` so it restores from its last valid
        checkpoint instead of retraining from scratch)."""
        folded = squeue.fold_queue(self.queue.load())
        self._known_ids = set(folded)
        for sid, rec in folded.items():
            # Recovered submissions keep their minted trace ids: the
            # adopter's journal records join the same trace as the
            # dead incarnation's (the failover-contiguity contract).
            self.queue.trace_ids[sid] = rec.get(
                "trace_id"
            ) or squeue.default_trace_id(sid)
        prior_attempts = self.ledger.attempts()
        # Trial-id high-water mark FIRST, before any re-admission: a
        # submission the previous incarnation journaled but died before
        # admitting goes through _admit() below, which assigns
        # next_trial_id — if that still sat at 0, the recovered pending
        # submission would collide with an existing trial's id and
        # clobber its hash/attempt/tenant bookkeeping.
        for rec in folded.values():
            if rec.get("trial_id") is not None:
                self.next_trial_id = max(
                    self.next_trial_id, int(rec["trial_id"]) + 1
                )
        recovered = 0
        for sid, rec in folded.items():
            tid = rec.get("trial_id")
            if rec["state"] in (squeue.SETTLED, squeue.REJECTED):
                self.settled[sid] = rec.get("status") or rec["state"]
                continue
            if rec["state"] == squeue.MOVED:
                # Terminal AT THIS SHARD: the submission's live record
                # continues in the destination shard's journal (split
                # handoff / steal grant) — re-admitting it here would
                # double-own it.
                continue
            sub = squeue.Submission.from_dict(
                {
                    "submission_id": sid,
                    "tenant": rec["tenant"],
                    "config": rec["config"],
                    "priority": rec["priority"],
                    "size": rec["size"],
                    "deadline_s": rec.get("deadline_s"),
                    "submit_ts": rec["submit_ts"],
                    "trace_id": rec.get("trace_id", ""),
                    "moved_from": rec.get("moved_from"),
                    "moved_kind": rec.get("moved_kind", ""),
                }
            )
            if rec["state"] == squeue.PENDING:
                self._admit(sub)
                recovered += 1
                continue
            # admitted or placed: the trial id and hash are already
            # assigned — rebuild the pending entry verbatim.
            reject_reason = "recovered submission no longer parses"
            try:
                entry = self._entry_for(
                    sub,
                    trial_id=int(tid),
                    resume_scan=rec.get("placements", 0) > 0,
                )
            except Exception as e:  # noqa: BLE001 — dataset ref went bad
                entry = None
                reject_reason = (
                    "recovered submission's dataset reference failed "
                    f"to probe: {type(e).__name__}: {e} (resubmit when "
                    "the source is reachable)"
                )
            if entry is None:
                # Config no longer valid against today's TrialConfig
                # (version skew), or its dataset ref no longer probes:
                # reject with the real reason rather than crash the
                # daemon (explicit-verdict contract — the client
                # resubmits; recovery does not retry probes).
                self.queue.rejected(
                    sid,
                    verdict=REJECT_INVALID,
                    reason=reject_reason,
                )
                self.settled[sid] = REJECT_INVALID
                continue
            chash = rec.get("config_hash") or config_hash(
                asdict(entry.cfg)
            )
            self.chashes[entry.trial_id] = chash
            self.attempts[entry.trial_id] = prior_attempts.get(chash, 0)
            self.ledger.tag(
                entry.trial_id,
                tenant=sub.tenant,
                priority=sub.priority,
                submit_ts=sub.submit_ts,
                trace=sub.trace,
            )
            self.entries[entry.trial_id] = entry
            if rec["state"] == squeue.PLACED:
                # The previous incarnation died with this trial on a
                # submesh that no longer exists: journal the truth so
                # every reader (console, client status, books) sees it
                # WAITING, not running, for the whole recovery period.
                self.queue.unplaced(
                    sid,
                    trial_id=entry.trial_id,
                    reason="daemon restart recovery",
                )
            self.sched.push(entry, front=entry.resume_scan)
            self._prefetch_data(entry)
            recovered += 1
        if recovered:
            log0(
                f"sweep service: recovered {recovered} live submissions "
                f"from {self.service_dir} (journal fold)"
            )
            _emit("service_recovered", submissions=recovered)

    # -- admission ----------------------------------------------------

    def _config_from(self, sub: squeue.Submission, trial_id: int):
        """Build the TrialConfig, or None when the submission's config
        dict names unknown fields / bad values (rejected_invalid)."""
        from multidisttorch_tpu_torch.hpo.driver import TrialConfig

        allowed = {
            f.name for f in TrialConfig.__dataclass_fields__.values()
        } - {"trial_id"}
        cfg = dict(sub.config)
        if not set(cfg) <= allowed:
            return None
        try:
            built = TrialConfig(trial_id=trial_id, **cfg)
            # Cheap sanity: these feed array shapes.
            if built.epochs < 1 or built.batch_size < 1:
                return None
            return built
        except (TypeError, ValueError):
            return None

    def _entry_for(
        self,
        sub: squeue.Submission,
        *,
        trial_id: int,
        resume_scan: bool = False,
    ) -> Optional[PendingTrial]:
        from multidisttorch_tpu_torch.data.store import probe_ref
        from multidisttorch_tpu_torch.hpo.driver import (
            config_is_stackable,
            data_shape_sig,
            predicted_cost,
            stack_bucket_key,
        )
        cfg = self._config_from(sub, trial_id)
        if cfg is None:
            return None
        # MPMD pipelined configs are VECTOR requests: one block of
        # `sub.size` slices per stage, placed all-or-nothing; the
        # fair-share charge and capacity checks use the TOTAL.
        stages = int(getattr(cfg, "pipeline_stages", 1) or 1)
        if stages < 1:
            return None
        if stages > 1:
            # Everything the pipelined runner would raise on must be
            # rejected HERE with a verdict — a deterministic config
            # error placed anyway classifies INFRA and burns the whole
            # retry budget re-allocating multi-block placements:
            # unsupported knobs, a stage count the executing (VAE,
            # 2-stage) runner doesn't cover, and microbatch shapes
            # that don't divide over a stage submesh.
            if cfg.eval_sampled or cfg.fused_steps != 1 or cfg.remat:
                return None
            if stages != 2:
                return None
            m = max(1, cfg.grad_accum)
            if cfg.batch_size % m:
                return None
            if (cfg.batch_size // m) % (
                sub.size * self._devs_per_slice
            ):
                return None
        sizes = tuple([sub.size] * stages) if stages > 1 else None
        total_slices = sub.size * stages
        if total_slices > self.n_slices:
            return None
        # Per-submission dataset: a cheap shape PROBE at admission
        # (builtin = analytic, file = npz header, cas = store meta) —
        # never a load. The probe feeds the co-pack key's shape class
        # and the DRR cost; the bytes load in the background
        # (_admit → store.prefetch). ValueError = rejected_invalid.
        spec = getattr(cfg, "dataset", "") or ""
        if spec:
            dim, rows = probe_ref(spec, store=self.store)  # may raise
            if dim != TRIAL_INPUT_DIM:
                raise ValueError(
                    f"dataset {spec!r} has feature dim {dim}; the "
                    f"service's trial family trains on dim "
                    f"{TRIAL_INPUT_DIM}"
                )
            if rows // cfg.batch_size < 1:
                raise ValueError(
                    f"dataset {spec!r} has {rows} rows < one batch of "
                    f"{cfg.batch_size}"
                )
            dsig = (dim, rows // cfg.batch_size)
        else:
            rows = len(self.train_data)
            dsig = data_shape_sig(self.train_data, cfg.batch_size)
        bucket = (
            (stack_bucket_key(cfg), dsig)
            if config_is_stackable(cfg)
            else ("unstackable", trial_id)
        )
        return PendingTrial(
            sub_id=sub.submission_id,
            tenant=sub.tenant,
            priority=sub.priority,
            cfg=cfg,
            bucket=bucket,
            size=total_slices,
            # The fair-share currency: predicted steps × TOTAL slices
            # — a pipelined trial is charged the SUM of its stage
            # blocks (the vtime fix the share property test pins).
            cost=float(predicted_cost(cfg, rows) * total_slices),
            submit_ts=sub.submit_ts,
            trial_id=trial_id,
            data_sig=dsig,
            resume_scan=resume_scan,
            sizes=sizes,
            trace_id=sub.trace,
            # The deadline tag becomes an absolute EDF key: submit
            # time + the tenant's relative budget. Recovery rebuilds
            # the SAME deadline_ts from the journaled submission, so a
            # restarted daemon keeps the original clock, not a fresh
            # one.
            deadline_ts=(
                sub.submit_ts + sub.deadline_s
                if sub.deadline_s is not None
                else None
            ),
        )

    def _admit(self, sub: squeue.Submission) -> None:
        if self.route_check is not None and sub.moved_from is None:
            # Wrong-shard check FIRST (skipped for transferred
            # submissions: a steal intentionally lands work at a shard
            # the tenant does not route to). The verdict names the
            # owner so the client's one-retry resubmit needs no second
            # topology read to find it.
            try:
                owner = self.route_check(sub.tenant)
            except Exception:  # noqa: BLE001 — routing must not crash intake
                owner = None
            if owner is not None:
                self.queue.rejected(
                    sub.submission_id,
                    verdict=squeue.REJECT_WRONG_SHARD,
                    reason=(
                        f"tenant {sub.tenant!r} routes to shard "
                        f"{int(owner)} under the current topology"
                    ),
                )
                self.settled[sub.submission_id] = squeue.REJECT_WRONG_SHARD
                _emit(
                    "submission_rejected",
                    sub_id=sub.submission_id,
                    tenant=sub.tenant,
                    verdict=squeue.REJECT_WRONG_SHARD,
                    reason=f"owner shard {int(owner)}",
                    owner_shard=int(owner),
                    trace=sub.trace,
                )
                return
        if sub.moved_from is not None:
            # A transferred submission already passed admission at its
            # origin shard: quota/backpressure must not turn the
            # handoff into a rejection (the no-lost-submissions leg of
            # the split contract). Config validity is still re-checked
            # below — the entry build is what assigns the trial id.
            verdict, reason = ADMIT, ""
        else:
            verdict, reason = self.sched.admit_verdict(sub.tenant)
        if verdict == ADMIT:
            tid = self.next_trial_id
            try:
                entry = self._entry_for(sub, trial_id=tid)
            except Exception as e:  # noqa: BLE001 — bad dataset ref
                entry = None
                verdict, reason = (
                    REJECT_INVALID,
                    f"dataset reference rejected: "
                    f"{type(e).__name__}: {e}",
                )
            if entry is None and verdict == ADMIT:
                verdict, reason = (
                    REJECT_INVALID,
                    "config does not parse as a TrialConfig (unknown "
                    f"fields or bad values), or size {sub.size} exceeds "
                    f"the {self.n_slices}-slice world",
                )
        if verdict != ADMIT:
            self.queue.rejected(
                sub.submission_id, verdict=verdict, reason=reason
            )
            self.settled[sub.submission_id] = verdict
            _emit(
                "submission_rejected",
                sub_id=sub.submission_id,
                tenant=sub.tenant,
                verdict=verdict,
                reason=reason,
                trace=sub.trace,
            )
            return
        self.next_trial_id = tid + 1
        chash = config_hash(asdict(entry.cfg))
        self.chashes[tid] = chash
        self.attempts.setdefault(tid, 0)
        self.ledger.tag(
            tid,
            tenant=sub.tenant,
            priority=sub.priority,
            submit_ts=sub.submit_ts,
            trace=sub.trace,
        )
        self.entries[tid] = entry
        self.queue.admitted(
            sub.submission_id,
            trial_id=tid,
            chash=chash,
            bucket=str(entry.bucket),
        )
        self.sched.push(entry)
        _emit(
            "submission_admitted",
            trial_id=tid,
            sub_id=sub.submission_id,
            tenant=sub.tenant,
            priority=sub.priority,
            size=sub.size,
            bucket=str(entry.bucket),
            trace=sub.trace,
        )
        self._prefetch_data(entry)
        self._warm(entry)

    # -- cross-shard transfer (split handoffs / work stealing) --------

    def extract_queued(self, predicate, *, dest_dir: str, dest_shard: int, from_shard: int, kind: str,
                       max_n: Optional[int] = None, on_moved=None) -> list[str]:
        """Durably hand queued-but-unplaced submissions to another shard;
        returns the moved submission ids. The ONE transfer primitive split
        handoffs and steal grants share.

        Only NEVER-PLACED entries move (no ``resume_scan``, no pinned
        relocation target): an ever-placed trial's checkpoints live under
        THIS shard's directory, and moving its submission would orphan
        them. Per entry, the order is the no-loss, no-double-own core: (1)
        spool the rebuilt submission (same id, origin provenance) into the
        destination's intake (a durable rename); (2) append our journal's
        ``moved`` record (fenced); (3) drop it from the scheduler and the
        live bookkeeping, and release the farm program its admission
        planned (module docstring). A crash between (1) and (2) re-runs the
        transfer idempotently on adoption (the spool overwrite and the
        destination's id dedup absorb the replay); a crash after (2) leaves
        a terminal ``moved`` record recovery skips. ``on_moved(sub_id)``
        fires after each journal append: the chaos drill's kill-mid-split
        seam."""
        prof = _ctlprof.get_ctlprof()
        # Steal-kind transfers run inside the caller's ``steal_grant``
        # window; only split handoffs get their own phase.
        track = prof is not None and kind == "split"
        if track:
            _t = prof.t0()
        self._advance_folds()
        examined = 0
        moved: list[str] = []
        for entry in list(self.sched.pending_entries()):
            examined += 1
            if max_n is not None and len(moved) >= max_n:
                break
            if entry.resume_scan or entry.pinned_start is not None:
                continue
            if not predicate(entry):
                continue
            rec = self._qfold.get(entry.sub_id)
            if rec is None or not rec.get("config"):
                continue  # fold raced; leave it for the next pass
            sub = squeue.Submission(
                submission_id=entry.sub_id,
                tenant=entry.tenant,
                config=dict(rec["config"]),
                priority=entry.priority,
                # The ORIGINAL per-stage footprint (entry.size is the stage
                # total for pipelined vectors).
                size=int(rec.get("size", entry.size)),
                deadline_s=rec.get("deadline_s"),
                submit_ts=entry.submit_ts,
                trace_id=entry.trace_id or "",
                moved_from=int(from_shard),
                moved_kind=kind,
            )
            squeue.spool_submission(dest_dir, sub)
            self.queue.moved(entry.sub_id, to_shard=int(dest_shard), kind=kind, trial_id=entry.trial_id)
            self.sched.take(entry.sub_id)
            tid = entry.trial_id
            for d in (self.entries, self.attempts, self.chashes, self.infra_fails, self.ledger.tags):
                d.pop(tid, None)
            self._defrag_targets.discard(entry.sub_id)
            self._preempt_targets.discard(entry.sub_id)
            self._release_warm(tid)
            moved.append(entry.sub_id)
            _emit("submission_moved", sub_id=entry.sub_id, trial_id=tid, tenant=entry.tenant,
                  from_shard=int(from_shard), to_shard=int(dest_shard), move_kind=kind, trace=entry.trace_id)
            if on_moved is not None:
                on_moved(entry.sub_id)
        if track:
            prof.note("split_handoff", _t, examined=examined, mutated=len(moved))
        return moved

    def _release_warm(self, trial_id: int) -> None:
        """A moved trial's farm program: released (still queued on the farm)
        or freed (captured, held by no trial), unless a trial still here
        planned the same key; a capture in flight stays, for the registry's
        eviction."""
        key = self._warm_keys.pop(trial_id, None)
        if key is None or key in self._warm_keys.values():
            return
        from multidisttorch_tpu_torch.compile.registry import get_executable_registry

        get_executable_registry().discard(key)

    # -- per-submission datasets -------------------------------------

    @staticmethod
    def _data_spec(entry: PendingTrial) -> str:
        return getattr(entry.cfg, "dataset", "") or ""

    def _prefetch_data(self, entry: PendingTrial) -> None:
        """Admission-time background dataset warm (the farm pattern):
        queue the load now so placement takes a RAM-warm dataset."""
        spec = self._data_spec(entry)
        if spec:
            # The queued instant names the SUBMISSION; the store's
            # dataset_prefetch_end names the SPEC — the trace builder
            # joins the two into the dataset_prefetch span.
            _emit(
                "dataset_prefetch_queued",
                trial_id=entry.trial_id,
                sub_id=entry.sub_id,
                spec=spec,
                trace=entry.trace_id,
            )
            self.store.prefetch(spec)

    def _take_dataset(self, spec: str):
        """Placement-time dataset read: a RAM/disk-warm ``get``, except
        a FAILED prefetch surfaces its RECORDED exception (and clears
        the job so the retry path re-prefetches in the background) —
        the daemon loop never re-runs a failed load inline."""
        err = self.store.prefetch_error(spec)
        if err is not None:
            self.store.clear_job(spec)
            raise err
        return self.store.get(spec)

    def _data_ready(self, entry: PendingTrial) -> bool:
        """Scheduler veto: an entry whose dataset is still LOADING is
        skipped WITHOUT consuming its fair-share turn (placement never
        blocks on a dataset load). A FAILED load lets placement proceed
        and fail through the normal setup-retry path, which carries the
        real exception and the retry budget."""
        from multidisttorch_tpu_torch.data import store as dstore

        spec = self._data_spec(entry)
        if not spec:
            return True
        state = self.store.state(spec)
        if state == dstore.UNKNOWN:
            self.store.prefetch(spec)
            return False
        return state != dstore.LOADING

    def _warm(self, entry: PendingTrial) -> None:
        """Admission-time executable warming: submit the trial's
        programs to the farm against a PREDICTED submesh (the first
        free block its size fits — a misprediction is just a registry
        miss and an inline compile at placement)."""
        if self._farm is None:
            return
        if entry.sizes is not None or getattr(
            entry.cfg, "zero_update", False
        ):
            # Pipelined trials compile their per-stage programs through
            # the registry at first step (pipe_* kinds); zero_update
            # trials pin sharded-state layouts the single-path program
            # vocabulary doesn't describe. Neither takes a farm
            # executable — warming would compile programs nobody runs.
            return
        try:
            start = next(
                (
                    s
                    for s, n in self.pool.free_runs()
                    if n >= entry.size
                ),
                0,
            )
            group = self._group_for(start, entry.size)
            from multidisttorch_tpu_torch.compile import programs as _programs

            self._warm_keys[entry.trial_id] = _programs.single_key(group, entry.cfg,
                                                                   _programs.bucket_key_of(entry.cfg))
            self._farm.plan_sweep(
                [("single", [(entry.trial_id, entry.cfg)])],
                [group],
                max_lanes=self.max_lanes,
            )
        except Exception:  # noqa: BLE001 — warming is best-effort
            pass

    # -- placement ----------------------------------------------------

    def _start_pipeline_placement(self, p: Placement) -> None:
        """A vector placement would become one MPMD pipelined trial over
        its stage blocks (the JAX package's ``_PipelineTrialRun``). The
        pipelined runner is ROADMAP A.14: the blocks free and the trial
        fails through the setup path with ``NotImplementedError`` naming
        it."""
        for start, size in p.blocks or []:
            self.pool.free(start, size)
        e = p.members[0]
        self._setup_failed([e], PlacementNotPorted(
            f"trial {e.trial_id}: pipeline_stages={e.cfg.pipeline_stages} placements are not ported yet: "
            "ROADMAP A.14 (pipelines)"))

    def _start_placement(self, p: Placement) -> None:
        from multidisttorch_tpu_torch.hpo.driver import (
            _StackedBucketRun,
            _TrialRun,
        )

        if p.blocks is not None:
            self._start_pipeline_placement(p)
            return
        t0 = time.perf_counter()
        now = time.time()
        try:
            group = self._group_for(p.start, p.size)
        except NotImplementedError as exc:
            self.pool.free(p.start, p.size)
            self._setup_failed(list(p.members), PlacementNotPorted(str(exc)))
            return
        # Per-submission datasets resolve FIRST, member by member — a
        # RAM/disk-warm read when the admission-time prefetch landed.
        # A member whose dataset fails (file gone, cas entry evicted,
        # recorded prefetch error) fails ALONE through the setup-retry
        # machinery: its co-packed neighbors keep the placement — one
        # tenant's bad dataset must not fail or burn the retry budget
        # of every tenant sharing the bucket.
        from multidisttorch_tpu_torch.hpo.driver import data_shape_sig

        members = list(p.members)
        datasets = {}
        # One resolution per SPEC (members may share one): a failed
        # spec's recorded error is raised once and reused — clearing
        # its job per member would let the second member fall through
        # to a fresh inline load on the daemon loop.
        resolved: dict[str, object] = {}
        for e in list(members):
            spec = self._data_spec(e)
            if not spec:
                continue
            if spec not in resolved:
                try:
                    resolved[spec] = self._take_dataset(spec)
                except Exception as exc:  # noqa: BLE001
                    resolved[spec] = exc
            out = resolved[spec]
            if isinstance(out, BaseException):
                members.remove(e)
                self._setup_failed([e], out)
                continue
            # Shape-class drift guard: a file replaced between the
            # admission probe and placement resolves to DIFFERENT
            # shapes than the bucket was packed under — without this,
            # _StackedBucketRun's own check would raise and fail every
            # co-packed neighbor.
            got = data_shape_sig(out, e.cfg.batch_size)
            if e.data_sig is not None and got != e.data_sig:
                members.remove(e)
                self._setup_failed(
                    [e],
                    ValueError(
                        f"dataset {spec!r} changed shape class since "
                        f"admission: probed {e.data_sig}, resolved "
                        f"{got} — resubmit under the new content"
                    ),
                )
                continue
            datasets[e.trial_id] = out
        if not members:
            self.pool.free(p.start, p.size)
            return
        stacked = len(members) >= 2
        # Compile-registry events fired during construction (init
        # programs, AOT claims) ride every member's trace.
        trace_attr = ttrace.make_attribution(
            [(e.trial_id, e.trace_id) for e in members]
        )
        ttrace.set_attribution(trace_attr)
        try:
            if stacked:
                run = _StackedBucketRun(
                    group,
                    [(e.trial_id, e.cfg) for e in members],
                    self.train_data,
                    self.test_data,
                    self.service_dir,
                    max_lanes=self.max_lanes,
                    save_checkpoint=self.save_checkpoints,
                    verbose=self.verbose,
                    retry=self.retry,
                    ledger=self.ledger,
                    attempts=self.attempts,
                    chashes=self.chashes,
                    infra_fails=self.infra_fails,
                    datasets=datasets,
                    ckpt_format=self.ckpt_format,
                )
            else:
                e = members[0]
                self.attempts[e.trial_id] = (
                    self.attempts.get(e.trial_id, 0) + 1
                )
                self.ledger.attempt_start(
                    e.trial_id,
                    self.chashes[e.trial_id],
                    self.attempts[e.trial_id],
                )
                run = _TrialRun(
                    group,
                    e.cfg,
                    datasets.get(e.trial_id, self.train_data),
                    self.test_data,
                    self.service_dir,
                    save_images=False,
                    save_checkpoint=self.save_checkpoints,
                    verbose=self.verbose,
                    resume="scan" if e.resume_scan else False,
                    ckpt_keep_last=self.ckpt_keep_last,
                    ckpt_format=self.ckpt_format,
                    ram_restore=self.snapshot_drain,
                    attempt=self.attempts[e.trial_id],
                )
        except Exception as exc:  # noqa: BLE001 — setup isolation
            self.pool.free(p.start, p.size)
            self._setup_failed(members, exc)
            return
        finally:
            ttrace.set_attribution(None)
        ap = _Active(
            placement_id=p.placement_id,
            start=p.start,
            size=p.size,
            stacked=stacked,
            run=run,
            gen=run.run(),
            entries={e.trial_id: e for e in members},
            place_ts=now,
            construct_s=time.perf_counter() - t0,
            tenants=tuple(sorted({e.tenant for e in members})),
            trace_attr=trace_attr,
        )
        self.active[p.placement_id] = ap
        for e in members:
            self._note_unblock(e)
            wait = max(0.0, now - e.submit_ts)
            self.queue_wait.observe(wait, exemplar=e.sub_id)
            self.slo.observe_latency("queue_wait", wait, ts=now)
            self.queue.placed(
                e.sub_id,
                trial_id=e.trial_id,
                start=p.start,
                size=p.size,
                lanes=len(members),
                stacked=stacked,
                resumed=e.resume_scan,
            )
            _emit(
                "trial_placed",
                trial_id=e.trial_id,
                group_id=p.start,
                sub_id=e.sub_id,
                tenant=e.tenant,
                start=p.start,
                size=p.size,
                lanes=len(members),
                stacked=stacked,
                queue_wait_s=round(max(0.0, now - e.submit_ts), 4),
                trace=e.trace_id,
            )

    def _note_unblock(self, e: PendingTrial) -> None:
        """Defrag/preemption verdicts land only at PLACEMENT: the
        starved (or deadline-blocked) trial actually got a submesh —
        plan-time claims would lie when another tenant steals the
        opened window. A re-placed eviction victim also restarts its
        anti-thrash cooldown here (the guarantee is a cooldown of
        RUNNING time, not queue wait)."""
        if e.preempt_count > 0:
            self.preempt.note_replaced(e.trial_id, time.time())
        if e.sub_id in self._defrag_targets:
            self._defrag_targets.discard(e.sub_id)
            self._defrag_unblocked.append(e.sub_id)
        if e.sub_id in self._preempt_targets:
            self._preempt_targets.discard(e.sub_id)
            self._preempt_unblocked.append(e.sub_id)

    def _setup_failed(self, members, exc: BaseException) -> None:
        """Setup failed before any lane existed for these members
        (placement construction, or one member's dataset resolution):
        retry each within the infra budget (as a classic run —
        scan-resume recovers whatever checkpoints exist), else settle
        it failed. Preemption propagates (the daemon is going away)."""
        error_text = f"{type(exc).__name__}: {exc}"
        fclass = classify_failure(exc)
        if fclass == PREEMPTION:
            for e in members:
                self._requeue(e, reason=f"preempted at setup: {error_text}")
            raise exc
        for e in members:
            tid = e.trial_id
            if self.attempts.get(tid, 0) == 0:
                self.attempts[tid] = 1
                self.ledger.attempt_start(tid, self.chashes[tid], 1)
            fails = self.infra_fails[tid] = (
                self.infra_fails.get(tid, 0) + 1
            )
            if (
                fclass == INFRA
                and self.retry is not None
                and self.retry.should_retry(fails, INFRA)
            ):
                self.ledger.attempt_end(
                    tid, self.chashes[tid], self.attempts[tid],
                    "retrying", error=error_text,
                )
                self._requeue(
                    e,
                    reason=f"setup retry: {error_text}",
                    backoff_s=self.retry.backoff_s(fails, key=tid),
                )
            else:
                self.ledger.attempt_end(
                    tid, self.chashes[tid], self.attempts[tid],
                    "failed", error=error_text,
                )
                self._settle(e, status="failed", error=error_text)

    def _requeue(
        self,
        entry: PendingTrial,
        *,
        reason: str,
        backoff_s: float = 0.0,
        pinned_start: Optional[int] = None,
        front: bool = False,
    ) -> None:
        self.queue.unplaced(
            entry.sub_id, trial_id=entry.trial_id, reason=reason
        )
        entry.resume_scan = True
        entry.pinned_start = pinned_start
        entry.not_before = time.time() + backoff_s
        entry.blocked_since = None
        self.sched.push(entry, front=front)

    def _settle(
        self, entry: PendingTrial, *, status: str, error: str = ""
    ) -> None:
        self.queue.settled(
            entry.sub_id,
            trial_id=entry.trial_id,
            status=status,
            error=error,
        )
        self.settled[entry.sub_id] = status
        # A persistent daemon must not grow per-trial bookkeeping
        # without bound: once settled, a trial never retries, re-places
        # or re-ledgers, so its live-state entries are dead weight
        # (the journal and ledger remain the durable record). The
        # settled map and dedup id set stay — they are small strings
        # and the idempotence/recovery contracts need them.
        tid = entry.trial_id
        for d in (
            self.entries, self.attempts, self.chashes,
            self.infra_fails, self.ledger.tags, self._warm_keys,
        ):
            d.pop(tid, None)
        self._defrag_targets.discard(entry.sub_id)
        self._preempt_targets.discard(entry.sub_id)
        self.preempt.forget(tid)
        now = time.time()
        if entry.deadline_ts is not None:
            # The deadline verdict: completed AND settled before the
            # absolute deadline = hit; a late completion, failure or
            # divergence = miss. Accounted, never enforced.
            hit = status == "completed" and now <= entry.deadline_ts
            if hit:
                self._deadline_hits += 1
            else:
                self._deadline_misses += 1
            self.slo.observe_event("deadline", hit, ts=now)
            _emit(
                "deadline_hit" if hit else "deadline_miss",
                trial_id=tid,
                sub_id=entry.sub_id,
                tenant=entry.tenant,
                status=status,
                margin_s=round(entry.deadline_ts - now, 3),
                trace=entry.trace_id,
            )
        _emit(
            "submission_settled",
            trial_id=entry.trial_id,
            sub_id=entry.sub_id,
            tenant=entry.tenant,
            status=status,
            wait_to_settle_s=round(now - entry.submit_ts, 3),
            trace=entry.trace_id,
        )

    # -- stepping -----------------------------------------------------

    def _retire(self, ap: _Active) -> None:
        del self.active[ap.placement_id]
        for start, size in ap.free_blocks():
            self.pool.free(start, size)

    def _step_actives(self, deadline: Optional[float] = None) -> bool:
        """One cooperative dispatch per live placement; returns whether
        any placement made progress (drives the idle sleep). With a
        ``deadline`` (``time.monotonic()``), the pass stops at the first
        dispatch that ends past it, and the next pass starts with the
        placement after the last one stepped: at least one dispatch per
        tick, round robin, so none waits more than a pass."""
        from multidisttorch_tpu_torch.telemetry.events import get_bus

        progressed = False
        # Trace attribution around each dispatch (compile claims fire
        # inside the generators): prebuilt per placement, installed
        # only when telemetry is on — the off path touches nothing.
        tracing = get_bus() is not None
        pids = list(self.active)
        if deadline is not None:
            cur = self._step_cursor
            pids = [p for p in pids if p >= cur] + [p for p in pids if p < cur]
        for pid in pids:
            if deadline is not None:
                if progressed and time.monotonic() >= deadline:
                    break
                self._step_cursor = pid + 1
            ap = self.active.get(pid)
            if ap is None:
                continue
            if tracing:
                ttrace.set_attribution(ap.trace_attr)
            try:
                with device_turn():
                    next(ap.gen)
                progressed = True
                self.dispatches += 1
                if not ap.first_step_done:
                    ap.first_step_done = True
                    # Placement latency: placement decision → the first
                    # cooperative step returning (run construction +
                    # state init + compile claim + first dispatch) —
                    # the "submission is actually training" moment.
                    # Exemplar = a member's submission id, so a bad
                    # percentile bucket names the trace that caused it.
                    lat = max(0.0, time.time() - ap.place_ts)
                    self.placement_latency.observe(
                        lat,
                        exemplar=next(iter(ap.entries.values())).sub_id,
                    )
                    self.slo.observe_latency("placement_latency", lat)
            except StopIteration:
                self._completed(ap)
                progressed = True
            except Exception as exc:  # noqa: BLE001 — failure isolation
                self._placement_failed(ap, exc)
                progressed = True
            finally:
                if tracing:
                    ttrace.set_attribution(None)
        return progressed

    def _completed(self, ap: _Active) -> None:
        self._retire(ap)
        # A finished trial never restores again: free its RAM snapshot
        # now instead of waiting for LRU churn.
        from multidisttorch_tpu_torch.train.checkpoint import snapshot_cache

        for attr in ("_ckpt_path", "_ckpt_paths"):
            got = getattr(ap.run, attr, None)
            for p in got if isinstance(got, list) else ([got] if got else []):
                snapshot_cache().drop(p)
        if ap.stacked:
            results = ap.run.results
            unfinished = {tid for tid, _ in ap.run.unfinished()}
        else:
            e = next(iter(ap.entries.values()))
            run = ap.run
            run.result.attempt = self.attempts[e.trial_id]
            self.ledger.attempt_end(
                e.trial_id,
                self.chashes[e.trial_id],
                self.attempts[e.trial_id],
                "completed",
                summary=self._result_summary(run.result),
            )
            results = {e.trial_id: run.result}
            unfinished = set()
        for tid, entry in ap.entries.items():
            if tid in unfinished:
                # A lane the bucket never got to (should not happen on
                # clean StopIteration, but stay safe): requeue.
                self._requeue(entry, reason="bucket ended before lane ran")
                continue
            r = results.get(tid)
            status = r.status if r is not None else "completed"
            if status == "resumed_complete":
                status = "completed"
            self._settle(
                entry,
                status=status,
                error=r.error if r is not None else "",
            )

    def _placement_failed(self, ap: _Active, exc: BaseException) -> None:
        error_text = f"{type(exc).__name__}: {exc}"
        fclass = classify_failure(
            exc,
            trial_id=(
                next(iter(ap.entries)) if len(ap.entries) == 1 else None
            ),
        )
        self._retire(ap)
        if not ap.stacked:
            try:
                ap.run._join_ckpt()
            except Exception as ce:  # noqa: BLE001
                error_text += f"; also: {type(ce).__name__}: {ce}"
        if fclass == PREEMPTION:
            # The process is going away: record this placement, then
            # drain everything (the daemon's exit contract) and let the
            # exception propagate to serve().
            self._record_unplaced(ap, reason=f"preempted: {error_text}")
            raise exc
        if ap.stacked:
            # Lane-scoped faults never reach here (mask-and-refill
            # absorbed them); this is bucket-wide breakage. Retired
            # lanes keep their settled results; live/queued members
            # retry as classic runs or fail.
            results = ap.run.results
            for tid, entry in ap.entries.items():
                if tid in results and results[tid].status in (
                    "completed", "diverged", "failed",
                ):
                    self._settle(
                        entry,
                        status=results[tid].status,
                        error=results[tid].error,
                    )
                    continue
                self._member_failed(ap, entry, error_text, INFRA)
            return
        entry = next(iter(ap.entries.values()))
        if fclass == DIVERGENCE:
            run = ap.run
            run.result.status = "diverged"
            run.result.error = error_text
            run.result.steps = run._step_no
            self.ledger.attempt_end(
                entry.trial_id,
                self.chashes[entry.trial_id],
                self.attempts[entry.trial_id],
                "diverged",
                error=error_text,
                summary=self._result_summary(run.result),
            )
            self._settle(entry, status="diverged", error=error_text)
            return
        self._member_failed(ap, entry, error_text, fclass)

    def _member_failed(
        self, ap: _Active, entry: PendingTrial, error_text: str, fclass
    ) -> None:
        tid = entry.trial_id
        progress = self._attempt_progress(ap, tid)
        fails = self.infra_fails[tid] = self.infra_fails.get(tid, 0) + 1
        if (
            fclass == INFRA
            and self.retry is not None
            and self.retry.should_retry(fails, INFRA)
        ):
            self.ledger.attempt_end(
                tid, self.chashes[tid], self.attempts.get(tid, 1),
                "retrying", error=error_text, summary=progress,
            )
            self._requeue(
                entry,
                reason=f"infra retry: {error_text}",
                backoff_s=self.retry.backoff_s(fails, key=tid),
            )
        else:
            self.ledger.attempt_end(
                tid, self.chashes[tid], self.attempts.get(tid, 1),
                "failed", error=error_text, summary=progress,
            )
            self._settle(entry, status="failed", error=error_text)

    @staticmethod
    def _attempt_progress(ap: _Active, tid: int) -> dict:
        if ap.stacked:
            got = ap.run.lane_progress(tid)
            return got or {"resumed_from_step": 0, "steps_at_failure": 0}
        run = ap.run
        return {
            "resumed_from_step": run.result.resumed_from_step,
            "steps_at_failure": run._step_no,
        }

    @staticmethod
    def _result_summary(result) -> dict:
        from multidisttorch_tpu_torch.hpo.driver import _result_summary

        return _result_summary(result)

    # -- defrag -------------------------------------------------------

    def _maybe_defrag(self, now: float) -> None:
        if not self.defrag_enabled or not self.active:
            return
        if now - self._last_defrag_ts < self.defrag_cooldown_s:
            return
        for starved in self.sched.starved_entries(
            threshold_s=self.starvation_s, now=now
        ):
            if self.pool.can_fit(starved.size):
                continue  # unblocked since it was stamped
            if self.pool.free_total < starved.size:
                # Not fragmentation but raw capacity: no amount of
                # compaction frees slices a running trial owns — only
                # completions do. Defrag would be pure churn.
                continue
            blocks = [
                # A pipelined placement contributes one record per
                # stage block — the planner must see every slice it
                # occupies, not just the first stage's. rehome_sizes
                # is what evicting the placement would REQUEUE (K
                # singles for a stacked bucket, one block per stage
                # for a vector): the planner's re-home feasibility
                # check sizes against it, and multi-unit victims get
                # unpinned (pid, None) moves.
                PlacedBlock(
                    placement_id=pid,
                    start=bstart,
                    size=bsize,
                    movable=ap.movable(self.snapshot_drain),
                    rehome_sizes=self._rehome_sizes(ap),
                )
                for pid, ap in self.active.items()
                for bstart, bsize in ap.free_blocks()
            ]
            plan = plan_defrag(
                self.pool, blocks, starved.size
            )
            if plan is None:
                _emit(
                    "defrag_blocked",
                    sub_id=starved.sub_id,
                    want_size=starved.size,
                    reason="no feasible window (immovable placements "
                    "or no room to re-home victims)",
                )
                continue
            self._execute_defrag(plan, starved, now)
            return  # one defrag per cooldown window

    def _rehome_sizes(self, ap: _Active) -> tuple:
        """What evicting this placement would requeue, as slice sizes:
        one entry per live stacked lane (each resumes as a classic
        single), every stage block of a pipelined vector, or the one
        classic block."""
        if ap.stacked:
            results = ap.run.results
            return tuple(
                e.size
                for tid, e in ap.entries.items()
                if not (
                    results.get(tid) is not None
                    and results[tid].status in SETTLED_STATUSES
                )
            ) or (ap.size,)
        if ap.blocks is not None and len(ap.blocks) > 1:
            return tuple(int(sz) for _, sz in ap.blocks)
        return (ap.size,)

    def _execute_defrag(self, plan, starved: PendingTrial, now) -> None:
        t0 = time.perf_counter()
        self._last_defrag_ts = now
        frag_before = self.pool.fragmentation()
        _emit(
            "defrag_start",
            sub_id=starved.sub_id,
            trial_id=starved.trial_id,
            tenant=starved.tenant,
            want_size=starved.size,
            starved_s=round(now - (starved.blocked_since or now), 3),
            fragmentation=round(frag_before, 4),
            free_runs=self.pool.free_runs(),
            moves=len(plan.moves),
        )
        moved = 0
        for pid, new_start in plan.moves:
            ap = self.active.get(pid)
            if ap is None:
                continue  # raced a completion; window may open anyway
            # The victim re-enters the queue FRONT, pinned to the
            # planner's relocation target (outside the window); the
            # next scheduling pass serves it first, so it claims its
            # pin before the starved trial claims the opened window.
            # No pre-reservation: the pool must show the window free
            # or the starved trial's own allocation would fail.
            # A ``None`` target is an UNPINNED move — stacked buckets
            # (K lanes requeue as K singles) and pipelined vectors
            # (stage blocks re-place all-or-nothing wherever they fit)
            # cannot be pinned to one start; they still requeue FRONT
            # so they re-home before the starved trial's claim.
            # (Snapshot-fast drain: the requeue happens inside
            # _checkpoint_drain — only the ledger record waits for
            # the victim's background persist.)
            entries = self._checkpoint_drain(
                ap,
                reason="defrag migration",
                pinned_start=new_start,
                front=True,
            )
            for entry in entries:
                _emit(
                    "defrag_move",
                    trial_id=entry.trial_id,
                    sub_id=entry.sub_id,
                    tenant=entry.tenant,
                    src=ap.start,
                    dst=new_start,
                    size=entry.size,
                )
                _emit(
                    "trial_migrated",
                    trial_id=entry.trial_id,
                    src_group=ap.start,
                    dst_group=new_start,
                    reason="defrag",
                )
            moved += ap.size
        self._defrag_count += 1
        self._defrag_moved_slices += moved
        self._defrag_targets.add(starved.sub_id)
        _emit(
            "defrag_end",
            sub_id=starved.sub_id,
            want_size=starved.size,
            window_start=plan.window_start,
            window_size=plan.window_size,
            moved_slices=moved,
            freed_contiguous=self.pool.largest_free_run(),
            fragmentation_before=round(frag_before, 4),
            fragmentation_after=round(self.pool.fragmentation(), 4),
            wall_s=round(time.perf_counter() - t0, 4),
        )

    # -- deadline preemption ------------------------------------------

    def _checkpoint_drain(
        self,
        ap: _Active,
        *,
        reason: str,
        pinned_start: Optional[int] = None,
        front: bool = False,
    ) -> list:
        """The first-class preemption primitive (defrag's move, the
        deadline eviction and the graceful drain share it), in two
        phases (docs/RESILIENCE.md "Snapshot-fast drain"):

        **Snapshot** (synchronous): close the victim's generator at its
        current yield point and retire the placement — the slices free
        HERE, so the starved trial places without waiting for a single
        fsync. The victim's freshest epoch-boundary state is already in
        the RAM snapshot cache (written at the device→host fetch), so a
        same-process re-place restores warm.

        **Persist** (background): any in-flight checkpoint write keeps
        running on the victim's own writer thread; the drain only
        registers it as a :class:`_PendingPersist`. The entry requeues
        immediately (pinned/front as the caller planned — a defrag
        victim must claim its relocation target on the next pass); the
        ledger ``preempted`` record lands when the persist does
        (:meth:`_poll_persists`) — ``preempted`` is recorded only after
        the durable bytes exist, so crash-recovery semantics are
        unchanged: a SIGKILL mid-persist leaves an OPEN attempt whose
        scan-back restores the previous durable step.

        ``snapshot_drain=False`` (the checkpoint drill's v1 comparison
        arm) is the join drain: join the write inline, record
        ``preempted``, requeue — everything on the caller's clock.

        Returns the requeued entries: ONE for a classic or pipelined
        placement (a pipelined vector drains all-or-nothing through
        its single entry — every stage block frees, the re-place
        scan-restores each stage), K for a stacked bucket (all live
        lanes snapshot together via :meth:`_drain_stacked` and requeue
        as classic singles — the stacked/classic bit-parity contract
        makes the resume exact)."""
        if ap.stacked:
            return self._drain_stacked(
                ap, reason=reason, front=front
            )
        entry = next(iter(ap.entries.values()))
        tid = entry.trial_id
        t0 = time.perf_counter()
        try:
            ap.gen.close()
        except Exception:  # noqa: BLE001 — teardown must go on
            pass
        progress = self._attempt_progress(ap, tid)
        if self.snapshot_drain:
            self._retire(ap)
            snap_s = time.perf_counter() - t0
            self.drain_snapshot.observe(snap_s, exemplar=entry.sub_id)
            _emit(
                "ckpt_snapshot",
                trial_id=tid,
                sub_id=entry.sub_id,
                tenant=entry.tenant,
                wall_s=round(snap_s, 6),
                drain=True,
                reason=reason,
                persist_in_flight=not ap.run._ckpt_idle(),
            )
            self._pending_persists.append(
                _PendingPersist(
                    ap=ap,
                    entry=entry,
                    reason=reason,
                    progress=progress,
                    chash=self.chashes.get(tid, ""),
                    attempt=self.attempts.get(tid, 1),
                    t0=t0,
                    snapshot_s=snap_s,
                )
            )
            self._requeue(
                entry,
                reason=reason,
                pinned_start=pinned_start,
                front=front,
            )
            return [entry]
        # The join drain: everything on the caller's clock. The writer
        # thread serialises a host tree and needs no device turn.
        try:
            ap.run._join_ckpt()
        except Exception:  # noqa: BLE001
            pass
        self._retire(ap)
        persist_s = time.perf_counter() - t0
        self.drain_snapshot.observe(persist_s, exemplar=entry.sub_id)
        self.drain_persist.observe(persist_s, exemplar=entry.sub_id)
        _emit(
            "ckpt_persist",
            trial_id=tid,
            sub_id=entry.sub_id,
            tenant=entry.tenant,
            wall_s=round(persist_s, 6),
            drain=True,
            mode="join",
            reason=reason,
        )
        self.ledger.attempt_end(
            tid,
            self.chashes[tid],
            self.attempts.get(tid, 1),
            "preempted",
            error=reason,
            summary=progress,
        )
        self._requeue(
            entry,
            reason=reason,
            pinned_start=pinned_start,
            front=front,
        )
        return [entry]

    def _drain_stacked(
        self, ap: _Active, *, reason: str, front: bool = False
    ) -> list:
        """Drain a whole stacked bucket: already-finished lanes settle,
        every LIVE lane's state is fetched device→host at its current
        epoch boundary in one pass (``_StackedBucketRun.
        drain_snapshot`` — the snapshot path) and requeued as a
        classic single, which scan-restores the lane checkpoint
        bit-identically (the stacked/classic parity contract). Under
        the snapshot-fast drain the K persists land on the bucket's
        background writer — one :class:`_PendingPersist` per lane, all
        sharing the writer's idle flag; the join drain joins the writer
        and records every lane ``preempted`` before it returns."""
        t0 = time.perf_counter()
        # Drive the bucket to a ROUND BOUNDARY before snapshotting: the
        # stacked runner yields mid-round (mid-epoch lane states), and
        # the classic resume only restores at epoch boundaries — a
        # mid-epoch snapshot would either be rejected (strict step
        # skew) or replay applied batches. request_drain() arms the
        # cooperative seam; pumping to StopIteration finishes the
        # in-flight round (at most one epoch of extra compute — the
        # honest cost of moving a stacked bucket).
        pump_failed = False
        try:
            ap.run.request_drain()
            while True:
                with device_turn():
                    next(ap.gen)
        except StopIteration:
            pass
        except Exception:  # noqa: BLE001 — drain must go on
            pump_failed = True
        try:
            ap.gen.close()
        except Exception:  # noqa: BLE001 — teardown must go on
            pass
        results = ap.run.results
        live: list = []
        for tid, entry in list(ap.entries.items()):
            r = results.get(tid)
            if r is not None and r.status in SETTLED_STATUSES:
                self._settle(entry, status=r.status, error=r.error)
            else:
                live.append((tid, entry))
        progress = {
            tid: self._attempt_progress(ap, tid) for tid, _ in live
        }
        if not pump_failed:
            with device_turn():
                ap.run.drain_snapshot([tid for tid, _ in live], reason=reason)
        else:
            # Mid-round states are not resumable; the lanes fall back
            # to their last durable lane checkpoint on requeue.
            reason = f"{reason} (drain pump failed; last durable ckpt)"
        self._retire(ap)
        snap_s = time.perf_counter() - t0
        requeued = []
        for tid, entry in live:
            self.drain_snapshot.observe(snap_s, exemplar=entry.sub_id)
            _emit(
                "ckpt_snapshot",
                trial_id=tid,
                sub_id=entry.sub_id,
                tenant=entry.tenant,
                wall_s=round(snap_s, 6),
                drain=True,
                stacked=True,
                reason=reason,
                persist_in_flight=not ap.run._ckpt_idle(),
            )
            if self.snapshot_drain:
                self._pending_persists.append(
                    _PendingPersist(
                        ap=ap,
                        entry=entry,
                        reason=reason,
                        progress=progress[tid],
                        chash=self.chashes.get(tid, ""),
                        attempt=self.attempts.get(tid, 1),
                        t0=t0,
                        snapshot_s=snap_s,
                    )
                )
            self._requeue(entry, reason=reason, front=front)
            requeued.append(entry)
        if not self.snapshot_drain and live:
            try:
                ap.run._join_ckpt()
            except Exception:  # noqa: BLE001
                pass
            persist_s = time.perf_counter() - t0
            for tid, entry in live:
                self.drain_persist.observe(persist_s, exemplar=entry.sub_id)
                self.ledger.attempt_end(
                    tid,
                    self.chashes.get(tid, ""),
                    self.attempts.get(tid, 1),
                    "preempted",
                    error=reason,
                    summary=progress[tid],
                )
        return requeued

    def _poll_persists(self, now: float) -> bool:
        """Land snapshot-drained victims' deferred bookkeeping once
        their background persist finishes: the drain-persist book and
        the honest ``preempted`` ledger record (the requeue already
        happened at drain time). A FAILED persist still ends the
        attempt — noted in the record; the durable checkpoint is
        simply the previous one, which the scan-back restore (or the
        RAM snapshot, same-process) recovers."""
        if not self._pending_persists:
            return False
        progressed = False
        for pend in list(self._pending_persists):
            run = pend.ap.run
            if not run._ckpt_idle():
                continue
            self._pending_persists.remove(pend)
            progressed = True
            err = getattr(run, "_ckpt_error", None)
            entry = pend.entry
            tid = entry.trial_id
            persist_s = time.perf_counter() - pend.t0
            self.drain_persist.observe(persist_s, exemplar=entry.sub_id)
            _emit(
                "ckpt_persist",
                trial_id=tid,
                sub_id=entry.sub_id,
                tenant=entry.tenant,
                wall_s=round(persist_s, 6),
                snapshot_s=round(pend.snapshot_s, 6),
                drain=True,
                mode="background",
                ok=err is None,
                reason=pend.reason,
            )
            error = pend.reason
            if err is not None:
                error += (
                    f"; persist failed: {type(err).__name__}: {err} "
                    "(previous durable step remains restorable)"
                )
            if pend.chash:
                # Attempt identity captured at drain time: the victim
                # may already be running (even settled as) a LATER
                # attempt — this record belongs to the drained one.
                self.ledger.attempt_end(
                    tid,
                    pend.chash,
                    pend.attempt,
                    "preempted",
                    error=error,
                    summary=pend.progress,
                )
        return progressed

    def _flush_persists(self) -> None:
        """Drain-time barrier (SIGTERM / daemon exit): join every
        pending background persist and land its bookkeeping — the
        process is going away, so 'background' no longer exists. The
        exit path's honesty contract (preempted only after the write)
        is preserved because the join happens first. Joins the writer
        THREAD directly, not ``_join_ckpt`` — that helper consumes
        ``_ckpt_error`` on its way to raising, and the poll below must
        still see a failed persist to note it in the record."""
        for pend in list(self._pending_persists):
            t = getattr(pend.ap.run, "_ckpt_thread", None)
            if t is not None and t.is_alive():
                t.join()
        self._poll_persists(time.time())

    def _preemptible(self, ap: _Active, now: float) -> bool:
        """May this placement be EVICTED for a deadline right now?
        Best-effort only (a deadline trial never evicts another
        deadline trial — EDF already ordered them), checkpoint-drained
        safely (``movable``: single, durable checkpoint or nothing to
        lose), and within the anti-thrash budget."""
        if not ap.movable(self.snapshot_drain):
            return False
        for tid, entry in ap.entries.items():
            if entry.deadline_ts is not None:
                return False
            if not self.preempt.victim_allowed(
                tid, entry.preempt_count, now
            ):
                return False
        return True

    def _maybe_preempt(self, now: float) -> None:
        """Deadline-driven preemption, at most one event per global
        cooldown: the earliest-deadline pending entry that cannot fit
        in any free run may evict best-effort placements (cheapest
        window, :func:`plan_preemption`) — drained through the same
        checkpoint-drain primitive as defrag, requeued to the
        best-effort backlog, verdict recorded at the deadline trial's
        actual placement."""
        if not self.active or not self.preempt.event_allowed(now):
            return
        # The global cooldown throttles the SCAN, not just successful
        # events: deadline_pending walks and sorts every pending entry,
        # which the hot cooperative loop must not pay per tick while
        # no eviction ever fires (event_allowed stays True until the
        # first one).
        if now - self._last_preempt_scan < self.preempt.global_cooldown_s:
            return
        self._last_preempt_scan = now
        # One blocks build per scan: the movable/budget verdicts
        # cannot change between candidates (the method returns after
        # the first eviction event), so per-candidate rebuilds would
        # be O(candidates x placements) for nothing.
        blocks = None
        blocked_emitted = False
        for starved in self.sched.deadline_pending(now=now):
            # Vector (pipelined) deadline requests preempt for their
            # TOTAL: a contiguous window of sum(sizes) slices hosts
            # every stage block (the allocator carves first-fit inside
            # it), so one eviction plan serves the whole vector.
            if starved.not_before > now:
                continue  # backing off — its own retry clock rules
            if starved.deadline_ts - now > self.preempt.urgency_s:
                continue  # plenty of slack: wait the EDF turn instead
            if self.pool.can_fit(starved.size):
                continue  # placeable already; EDF order will serve it
            if blocks is None:
                blocks = [
                    PlacedBlock(
                        placement_id=pid,
                        start=bstart,
                        size=bsize,
                        movable=self._preemptible(ap, now),
                    )
                    for pid, ap in self.active.items()
                    for bstart, bsize in ap.free_blocks()
                ]
            plan = plan_preemption(self.pool, blocks, starved.size)
            if plan is None:
                if not blocked_emitted:
                    # One blocked event per scan: a persistently
                    # infeasible deadline backlog must not flood the
                    # bus every cooldown window.
                    blocked_emitted = True
                    _emit(
                        "preempt_blocked",
                        sub_id=starved.sub_id,
                        tenant=starved.tenant,
                        want_size=starved.size,
                        deadline_in_s=round(
                            starved.deadline_ts - now, 3
                        ),
                        reason="no evictable window (deadline/"
                        "immovable placements or anti-thrash budget "
                        "exhausted)",
                    )
                continue
            _emit(
                "preempt_start",
                sub_id=starved.sub_id,
                trial_id=starved.trial_id,
                tenant=starved.tenant,
                want_size=starved.size,
                deadline_in_s=round(starved.deadline_ts - now, 3),
                victims=list(plan.victims),
            )
            evicted = 0
            for pid in plan.victims:
                ap = self.active.get(pid)
                if ap is None or not self._preemptible(ap, now):
                    continue  # raced a completion/checkpoint start
                # Victims rejoin the best-effort backlog (EDF keeps
                # them behind every deadline) once their persist
                # lands, and resume from their drained checkpoint —
                # or the RAM snapshot, same-process — on their next
                # placement.
                entries = self._checkpoint_drain(
                    ap,
                    reason=(
                        f"deadline preemption for {starved.sub_id}"
                    ),
                )
                for entry in entries:
                    entry.preempt_count += 1
                    self.preempt.note_eviction(entry.trial_id, now)
                    _emit(
                        "preempt_victim",
                        trial_id=entry.trial_id,
                        sub_id=entry.sub_id,
                        tenant=entry.tenant,
                        start=ap.start,
                        size=ap.size,
                        preempt_count=entry.preempt_count,
                        for_sub_id=starved.sub_id,
                    )
                self._preempt_evictions += 1
                self._preempt_evicted_slices += ap.size
                evicted += ap.size
            self._preempt_events += 1
            self._preempt_targets.add(starved.sub_id)
            self.preempt.last_event_ts = now
            _emit(
                "preempt_end",
                sub_id=starved.sub_id,
                want_size=starved.size,
                evicted_slices=evicted,
                freed_contiguous=self.pool.largest_free_run(),
            )
            return  # one preemption event per cooldown window

    # -- drain / books ------------------------------------------------

    def stop(self) -> None:
        """Request a graceful drain (signal-handler-safe: just a flag)."""
        self._stop = True

    def _record_unplaced(self, ap: _Active, *, reason: str) -> None:
        """One placement's drain bookkeeping: settled lanes settle,
        everything live is recorded preempted + requeued."""
        if ap.stacked:
            ap.run.record_preempted(reason)
            results = ap.run.results
            for tid, entry in ap.entries.items():
                r = results.get(tid)
                if r is not None and r.status in SETTLED_STATUSES:
                    self._settle(entry, status=r.status, error=r.error)
                else:
                    self.queue.unplaced(
                        entry.sub_id, trial_id=tid, reason=reason
                    )
        else:
            entry = next(iter(ap.entries.values()))
            tid = entry.trial_id
            try:
                ap.run._join_ckpt()
            except Exception:  # noqa: BLE001
                pass
            self.ledger.attempt_end(
                tid,
                self.chashes[tid],
                self.attempts.get(tid, 1),
                "preempted",
                error=reason,
                summary=self._attempt_progress(ap, tid),
            )
            self.queue.unplaced(entry.sub_id, trial_id=tid, reason=reason)

    def _drain(self, *, reason: str) -> None:
        _emit("service_drain", in_flight=len(self.active), reason=reason)
        # Pending background persists first: the process is exiting, so
        # their writes must land (and their preempted records with
        # them) before the final books.
        self._flush_persists()
        for pid in list(self.active):
            ap = self.active.pop(pid)
            try:
                ap.gen.close()
            except Exception:  # noqa: BLE001
                pass
            for start, size in ap.free_blocks():
                self.pool.free(start, size)
            self._record_unplaced(ap, reason=reason)
        self.write_books()

    def _advance_folds(self) -> None:
        """Feed newly-appended journal/ledger lines through the
        persistent folds. A file shorter than its offset means a
        rewrite under us (e.g. the supervisor compacted the ledger
        between worlds) — reset that fold and start over."""
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        try:
            if os.path.getsize(self.queue.path) < self._qoffset:
                self._qfold.clear()
                self._qoffset = 0
        except OSError:
            pass
        recs, self._qoffset = squeue.read_jsonl_from(
            self.queue.path, self._qoffset
        )
        squeue.fold_queue_into(self._qfold, recs)
        if recs:
            # The books never read a settled submission's config blob;
            # dropping it keeps the persistent fold's footprint at a
            # few small strings per lifetime submission.
            for rec in self._qfold.values():
                if rec["state"] in (squeue.SETTLED, squeue.REJECTED):
                    rec.pop("config", None)
        if prof is not None:
            prof.note("journal_fold", _t, examined=len(recs), mutated=len(recs))
            _t = prof.t0()
        try:
            if os.path.getsize(self.ledger.path) < self._led_offset:
                self._tenant_fold.clear()
                self._tenant_covered.clear()
                self._led_offset = 0
        except OSError:
            pass
        recs, self._led_offset = squeue.read_jsonl_from(
            self.ledger.path, self._led_offset
        )
        fold_tenant_goodput_into(
            self._tenant_fold, self._tenant_covered, recs
        )
        if prof is not None:
            prof.note("ledger_fold", _t, examined=len(recs), mutated=len(recs))

    def _ckpt_books(self) -> dict:
        """The checkpoint data plane's service books: drain-phase
        latency split (snapshot = slices-freed, persist = durable),
        process-wide byte counters (written vs delta-reused), and the
        snapshot-drain backlog."""
        from multidisttorch_tpu_torch.train.checkpoint import ckpt_counters

        now = ckpt_counters()
        c = {
            k: now[k] - self._ckpt_counter_base.get(k, 0) for k in now
        }
        total = c["bytes_total"]
        return {
            "format": self.ckpt_format,
            "snapshot_drain": self.snapshot_drain,
            "pending_persists": len(self._pending_persists),
            "drain_snapshot": self.drain_snapshot.stats(),
            "drain_persist": self.drain_persist.stats(),
            "saves": c["saves"],
            "bytes_total": total,
            "bytes_written": c["bytes_written"],
            "bytes_reused": c["bytes_reused"],
            "delta_ratio": (
                round(c["bytes_written"] / total, 4) if total else None
            ),
            "restores": c["restores"],
            "restores_ram": c["restores_ram"],
        }

    def books(self) -> dict:
        self._advance_folds()
        folded = self._qfold
        stats = squeue.QueueStats.of(folded)
        frag = self.pool.fragmentation()
        self._frag_max = max(self._frag_max, frag)
        tenant_books = finalize_tenant_goodput(self._tenant_fold)
        # SLO sampling at the books cadence: per-tenant goodput
        # against the floor, then one evaluation pass (edge-triggered
        # slo_alert events ride the bus from inside evaluate()).
        for t, b in tenant_books.items():
            self.slo.observe_gauge(
                "tenant_goodput", b.get("goodput"), label=t
            )
        return {
            "generated_ts": time.time(),
            "service_dir": self.service_dir,
            "slices": self.n_slices,
            "devices_per_slice": self._devs_per_slice,
            "slots": [str(d) for d in self._slots],
            # Each live placement's block and the device it trains on
            # (module docstring, "Slots").
            "placements": [
                {
                    "placement_id": pid,
                    "slots": [int(st) + j for st, sz in ap.free_blocks() for j in range(int(sz))],
                    "device": str(self._slots[ap.start]),
                    "stacked": ap.stacked,
                    "trial_ids": sorted(ap.entries),
                }
                for pid, ap in sorted(self.active.items())
            ],
            "fence_epoch": self.fence_epoch,
            "queue": {
                "by_state": dict(sorted(stats.by_state.items())),
                "by_tenant": {
                    t: dict(sorted(v.items()))
                    for t, v in sorted(stats.by_tenant.items())
                },
                "pending_now": self.sched.pending_count(),
                "active_placements": len(self.active),
            },
            "tenants": tenant_books,
            "fair_share": self.sched.fair_share_report(),
            "queue_wait": self.queue_wait.stats(),
            "placement_latency": self.placement_latency.stats(),
            "slo": self.slo.evaluate(),
            "fragmentation": {
                "now": round(frag, 4),
                "max": round(self._frag_max, 4),
                "free_slices": self.pool.free_total,
                "largest_free_run": self.pool.largest_free_run(),
            },
            "defrag": {
                "events": self._defrag_count,
                "moved_slices": self._defrag_moved_slices,
                "unblocked": list(self._defrag_unblocked),
                "pending_unblock": sorted(self._defrag_targets),
            },
            "preemption": {
                "events": self._preempt_events,
                "evictions": self._preempt_evictions,
                "evicted_slices": self._preempt_evicted_slices,
                "unblocked": list(self._preempt_unblocked),
                "pending_unblock": sorted(self._preempt_targets),
                "policy": {
                    "max_per_trial": self.preempt.max_preemptions_per_trial,
                    "trial_cooldown_s": self.preempt.trial_cooldown_s,
                    "global_cooldown_s": self.preempt.global_cooldown_s,
                    "enabled": self.preempt.enabled,
                },
            },
            "checkpoint": self._ckpt_books(),
            # Control-plane flight books (telemetry/ctlprof.py): live
            # per-phase p50/p95/p99 with bucket-error bounds, passes/s,
            # scan efficiency, worst-pass capture. {"enabled": False}
            # when the profiler is off — the block is always present so
            # sweep_top's panel can say WHY it's empty.
            "ctl": (
                _ctlprof.get_ctlprof().books()
                if _ctlprof.get_ctlprof() is not None
                else {"enabled": False}
            ),
            "deadline": {
                "hits": self._deadline_hits,
                "misses": self._deadline_misses,
                "hit_rate": (
                    round(
                        self._deadline_hits
                        / (self._deadline_hits + self._deadline_misses),
                        4,
                    )
                    if (self._deadline_hits + self._deadline_misses)
                    else None
                ),
                "pending": len(self.sched.deadline_pending()),
            },
            "dataset_cache": self.store.stats(),
        }

    def write_books(self) -> str:
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        path = os.path.join(self.service_dir, BOOKS_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.books(), f, indent=2, default=str)
        os.replace(tmp, path)
        if prof is not None:
            prof.note("books_write", _t, examined=1, mutated=1)
        return path

    # -- the loop -----------------------------------------------------

    def tick(self, deadline: Optional[float] = None) -> bool:
        """One service cycle; returns whether anything progressed (the
        caller's idle-sleep signal). Factored out of :meth:`serve` so
        tests can single-step the daemon deterministically. ``deadline``
        (``time.monotonic()``) bounds the dispatches of the cycle
        (:meth:`_step_actives`): a fabric replica's turn budget."""
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            # One tick = one control-plane pass: the phase notes below
            # (and inside schedule/drain/fold/planner calls) land in
            # this pass's flight book.
            prof.pass_begin()
        now = time.time()
        if self._fence is not None:
            # One fence check per tick, BEFORE any placement or
            # journal write: a replica that lost its shard lease must
            # observe it here and stop, not discover it mid-append.
            self._fence()
        fresh = self.queue.drain_intake(known_ids=self._known_ids)
        for sub in fresh:
            _emit(
                "submission_received",
                sub_id=sub.submission_id,
                tenant=sub.tenant,
                priority=sub.priority,
                size=sub.size,
            )
            self._admit(sub)
        placements = self.sched.schedule(
            self.pool,
            max_lanes=self.max_lanes,
            now=now,
            can_start=lambda e: (
                now >= e.not_before and self._data_ready(e)
            ),
        )
        t_place = time.monotonic()
        for p in placements:
            self._start_placement(p)
        t_step = time.monotonic()
        progressed = self._step_actives(deadline)
        # Where this tick's seconds went (a fabric replica's turn reads it).
        self.tick_parts = {"place": t_step - t_place, "step": time.monotonic() - t_step}
        # Snapshot-drained victims whose background persist landed:
        # honest `preempted` records + requeues (the deferred half of
        # _checkpoint_drain).
        persisted = self._poll_persists(now)
        self._maybe_preempt(now)
        self._maybe_defrag(now)
        if now - self._last_books_ts >= self.books_every_s:
            self._last_books_ts = now
            self.write_books()
        if prof is not None:
            prof.pass_end()
        return bool(fresh or placements or progressed or persisted)

    def close(self) -> None:
        """Stop the service's threads: land every pending persist, stop the
        precapture farm and the dataset store's prefetch, waiting for
        each. ``serve`` calls it on its way out; a caller that drives
        :meth:`tick` itself calls it (after :meth:`_drain`) when done, so
        nothing writes under the service directory afterwards."""
        self._flush_persists()
        if self._farm is not None:
            self._farm.shutdown(wait=True)
            self._farm = None
        self.store.shutdown(wait=True)

    def idle(self) -> bool:
        """Nothing running, nothing schedulable, nothing in the spool
        — and no snapshot-drained victim still persisting (its honest
        ``preempted`` ledger record hasn't landed yet)."""
        if self.active or self.sched.pending_count() or self._pending_persists:
            return False
        d = squeue.intake_dir(self.service_dir)
        try:
            return not any(
                n.endswith(".json") for n in os.listdir(d)
            )
        except OSError:
            return True

    def serve(
        self,
        *,
        max_wall_s: Optional[float] = None,
        exit_when_drained: bool = False,
        idle_grace_s: float = 0.5,
    ) -> dict:
        """Run the daemon loop until stopped (drain), out of wall
        budget, or — with ``exit_when_drained`` — the world goes idle
        for ``idle_grace_s`` (the CI/bench drills' termination mode;
        a production daemon runs without it and waits for work)."""
        t0 = time.time()
        idle_since: Optional[float] = None
        _emit(
            "service_start",
            slices=self.n_slices,
            max_lanes=self.max_lanes,
            recovered=len(self.entries),
        )
        outcome = "drained"
        try:
            while True:
                if self._stop:
                    self._drain(reason="graceful drain (stop requested)")
                    outcome = "preempted"
                    break
                if max_wall_s is not None and time.time() - t0 > max_wall_s:
                    self._drain(reason="wall budget exhausted")
                    outcome = "wall_budget"
                    break
                progressed = self.tick()
                if exit_when_drained and self.idle():
                    if idle_since is None:
                        idle_since = time.time()
                    elif time.time() - idle_since >= idle_grace_s:
                        outcome = "idle"
                        break
                else:
                    idle_since = None
                if not progressed:
                    time.sleep(self.idle_sleep_s)
        except BaseException as exc:
            # Preemption-class exits drain; anything else still lands
            # the books before propagating (a failed daemon needs its
            # story told more than a healthy one).
            try:
                self._drain(
                    reason=f"daemon exception: {type(exc).__name__}: {exc}"
                )
            except Exception:  # noqa: BLE001
                pass
            raise
        self.write_books()
        _emit("service_end", outcome=outcome, wall_s=round(time.time() - t0, 3))
        self.close()
        return {
            "outcome": outcome,
            "wall_s": round(time.time() - t0, 3),
            "settled": dict(self.settled),
            "books": self.books(),
        }
