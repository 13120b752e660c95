"""Multi-tenant scheduling: admission, fair share, and bin-packing.

Pure host-side logic — no JAX anywhere — so every scheduling invariant
is property-testable in microseconds (tests/test_service.py):

- **Admission control**: per-tenant pending quotas and a global
  backpressure cap produce explicit verdicts (``admitted`` /
  ``rejected_quota`` / ``rejected_backpressure``) — the service never
  silently eats a submission it cannot schedule.
- **Weighted fair share with priority lanes**: deficit round-robin
  over tenants, implemented in its virtual-time (attained-service)
  form because submesh service opportunities arrive irregularly — one
  slice freeing at a time — rather than as a steady link. Priority
  lanes are strict (lane 0 drains before lane 1 is considered); WITHIN
  a lane each placement opportunity goes to the tenant whose
  weight-normalized served cost is smallest, which converges to the
  weight ratio under contention and can never starve a nonempty
  tenant (its attained service freezes while others' grow).
- **EDF inside a tenant's share**: a submission's ``deadline`` tag
  becomes an absolute ``deadline_ts``, and within one (tenant, lane)
  queue entries are kept in earliest-deadline-first order (deadline-
  less best-effort work keeps FIFO order BEHIND every deadline-tagged
  entry). Deadlines never buy cross-tenant capacity — fair share
  decides WHICH tenant places next, EDF decides which of that
  tenant's asks goes first — so a deadline whale cannot starve its
  neighbors, only reorder its own backlog.
- **Deadline preemption with an anti-thrash budget**
  (:class:`PreemptionPolicy`): the runtime may checkpoint-drain a
  best-effort placement to open a block for a deadline-tagged trial
  that cannot otherwise place in time; the policy's per-trial
  preemption cap and cooldown bound how often any single victim can
  be bounced, so a stream of deadline whales degrades best-effort
  throughput smoothly instead of livelocking it.
- **Shape-bucket bin-packing**: selected trials sharing a shape bucket
  (``stack_bucket_key``) and submesh size co-pack into ONE
  placement — one vmapped dispatch on one submesh, tenants mixed
  freely — and a bucket is never split across submeshes mid-pass: an
  open placement is filled to ``max_lanes`` before a second submesh is
  allocated for the same bucket.
- **Slice allocation**: the device world is carved into unit slices;
  a size-``s`` trial needs ``s`` CONTIGUOUS slices (a submesh is a
  contiguous device span — ``parallel/mesh.py``'s carving rule).
  :class:`SlicePool` is the first-fit contiguous allocator plus the
  fragmentation gauge the defrag policy (``service/defrag.py``) keys
  off.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof

# Admission verdicts (the queue journal's ``rejected.verdict`` values).
ADMIT = "admitted"
REJECT_QUOTA = "rejected_quota"
REJECT_BACKPRESSURE = "rejected_backpressure"
REJECT_INVALID = "rejected_invalid"


@dataclass
class PreemptionPolicy:
    """The anti-thrash budget for deadline-driven preemption.

    Preemption is a tax best-effort work pays a deadline-tagged trial;
    without a budget a stream of deadline whales livelocks best-effort
    traffic (evict → restore → evict, zero useful steps between). Two
    bounds, both property-tested:

    - ``max_preemptions_per_trial``: a trial bounced this many times
      becomes immune — its NEXT placement runs to an epoch boundary no
      matter who is waiting.
    - ``trial_cooldown_s``: a just-evicted trial cannot be evicted
      again within the cooldown of its RE-PLACEMENT (the runtime calls
      :meth:`note_replaced` when a previously-evicted trial lands on a
      submesh again, restarting the clock), so every eviction buys the
      victim at least a cooldown of actual running time — queue wait
      never eats the guarantee, and with checkpoint-drain semantics
      that running time is real banked work.

    ``global_cooldown_s`` spaces preemption EVENTS (like defrag's
    cooldown) so the planner cannot churn the pool every tick. The
    class is pure host-side state — the loadgen drives it with virtual
    time, the runtime with the wall clock; both share one rulebook."""

    enabled: bool = True
    max_preemptions_per_trial: int = 2
    trial_cooldown_s: float = 2.0
    global_cooldown_s: float = 0.25
    # Only a deadline within this window may trigger eviction: a
    # deadline trial with hours of slack should WAIT its EDF turn, not
    # tax best-effort work it could have avoided taxing. inf = any
    # blocked deadline preempts immediately (the acceptance drill's
    # setting; production tunes it to the workload's runtimes).
    urgency_s: float = float("inf")

    # trial_id -> wall/virtual ts of its last eviction.
    last_evict: dict = field(default_factory=dict)
    last_event_ts: float = field(default=float("-inf"))

    def event_allowed(self, now: float) -> bool:
        return (
            self.enabled
            and now - self.last_event_ts >= self.global_cooldown_s
        )

    def victim_allowed(
        self, trial_id: int, preempt_count: int, now: float
    ) -> bool:
        """May this trial be evicted (again) right now?"""
        if not self.enabled:
            return False
        if preempt_count >= self.max_preemptions_per_trial:
            return False
        last = self.last_evict.get(trial_id)
        return last is None or now - last >= self.trial_cooldown_s

    def note_eviction(self, trial_id: int, now: float) -> None:
        self.last_evict[trial_id] = now
        self.last_event_ts = now

    def note_replaced(self, trial_id: int, now: float) -> None:
        """A previously-evicted trial just landed on a submesh again:
        restart its cooldown from HERE, so the guarantee is a cooldown
        of running time, not of (possibly long) queue wait."""
        if trial_id in self.last_evict:
            self.last_evict[trial_id] = now

    def forget(self, trial_id: int) -> None:
        """Drop a settled trial's bookkeeping (bounded-RSS contract)."""
        self.last_evict.pop(trial_id, None)


@dataclass(frozen=True)
class TenantPolicy:
    """One tenant's scheduling contract.

    ``weight`` sets the tenant's fair share within a priority lane
    (served cost converges to the weight ratio under contention).
    ``max_pending`` is the admission quota: submissions beyond it are
    rejected with ``rejected_quota`` (the client resubmits later —
    rejection is a backpressure signal, not a failure)."""

    weight: float = 1.0
    max_pending: int = 256

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {self.max_pending}"
            )


@dataclass
class PendingTrial:
    """One admitted-but-not-running trial in the scheduler's queues.

    ``cfg`` and ``bucket`` are opaque to the scheduler (the runtime
    supplies a TrialConfig and its stack-bucket key); ``cost`` is the
    trial's predicted work (optimizer steps x TOTAL slices — for a
    multi-slice pipelined trial the sum of its stage slices, so a
    2-stage whale is charged both blocks' worth of virtual time, never
    a shrimp's). ``resume_scan`` marks a trial that must restore from
    checkpoint (recovered after a crash, or migrated by defrag): such
    trials never co-pack (stacked lanes cannot restore mid-trial) and
    ``pinned_start`` asks for a specific slice block (a defrag
    target). ``sizes`` non-None makes this a VECTOR request (an MPMD
    pipelined trial: one block per stage, placed all-or-nothing —
    docs/SERVICE.md); ``size`` then holds the total for capacity
    checks."""

    sub_id: str
    tenant: str
    priority: int
    cfg: object
    bucket: object
    size: int
    cost: float
    submit_ts: float
    trial_id: int = -1
    # The dataset shape class admission probed (opaque here): the
    # runtime re-checks it against the RESOLVED dataset at placement,
    # so a source that drifted after the probe fails its own member
    # only — never the co-packed bucket.
    data_sig: Optional[tuple] = None
    resume_scan: bool = False
    pinned_start: Optional[int] = None
    blocked_since: Optional[float] = None
    enqueue_ts: float = 0.0
    # Earliest wall time this entry may start (a retry's backoff);
    # enforced by the runtime's ``can_start`` veto, so a backing-off
    # entry never blocks its tenant's other work.
    not_before: float = 0.0
    # Per-stage slice sizes of a VECTOR (MPMD pipelined) request, or
    # None for the classic single-block trial. Placed all-or-nothing;
    # never co-packed.
    sizes: Optional[tuple] = None
    # Absolute wall (or virtual) deadline. None = best-effort: such an
    # entry queues FIFO behind every deadline-tagged entry of its
    # (tenant, lane) and is the only class deadline preemption may
    # evict. The scheduler never kills an overdue trial — a missed
    # deadline is accounted (deadline_miss), not enforced.
    deadline_ts: Optional[float] = None
    # Times this trial has been preemption-evicted (anti-thrash
    # evidence — rides the entry across requeues).
    preempt_count: int = 0
    # Pushed with front=True (defrag victim / recovered trial): later
    # EDF insertions must never jump ahead of it — its head-of-queue
    # position IS the contract (a pinned victim beaten to its
    # relocation target would waste the whole defrag window).
    front_barrier: bool = False
    # End-to-end trace id (telemetry/trace.py): minted at submit,
    # carried so placement-time events and ledger attempts ride it.
    # Opaque to the scheduler.
    trace_id: Optional[str] = None


@dataclass
class Placement:
    """One scheduling decision: K co-packed trials on one slice block.

    Every member shares ``(bucket, size)`` by construction; ``members``
    has one entry per lane. The INVARIANT the packer maintains (and
    tests enforce): a single ``schedule()`` pass opens
    ``ceil(selected/max_lanes)`` placements per (bucket, size) — never
    two partially-filled submeshes for the same bucket."""

    placement_id: int
    bucket: object
    size: int
    start: int
    members: list = field(default_factory=list)  # [PendingTrial, ...]
    # Vector (pipelined) placement: one (start, size) block per stage,
    # in stage order. None for classic single-block placements; when
    # set, ``start``/``size`` hold the first block / the total.
    blocks: Optional[list] = None  # [(start, size), ...] | None

    @property
    def lanes(self) -> int:
        return len(self.members)


class SlicePool:
    """Contiguous allocator over ``n_slices`` unit slices.

    First-fit lowest-start allocation (deterministic — restarted
    daemons re-place recovered trials identically given the same queue
    order). ``fragmentation()`` is the gauge the books export: the
    fraction of free capacity NOT reachable by the largest contiguous
    request (0.0 = one free run or nothing free; higher = more
    fragmented)."""

    def __init__(self, n_slices: int):
        if n_slices < 1:
            raise ValueError(f"n_slices must be >= 1, got {n_slices}")
        self.n_slices = n_slices
        self._free = [True] * n_slices

    # -- queries ------------------------------------------------------

    @property
    def free_total(self) -> int:
        return sum(self._free)

    def free_runs(self) -> list[tuple[int, int]]:
        """Maximal free runs as ``(start, length)``, ascending."""
        runs = []
        i = 0
        while i < self.n_slices:
            if self._free[i]:
                j = i
                while j < self.n_slices and self._free[j]:
                    j += 1
                runs.append((i, j - i))
                i = j
            else:
                i += 1
        return runs

    def largest_free_run(self) -> int:
        return max((n for _, n in self.free_runs()), default=0)

    def fragmentation(self) -> float:
        free = self.free_total
        if free == 0:
            return 0.0
        return 1.0 - self.largest_free_run() / free

    def can_fit(self, size: int) -> bool:
        return self.largest_free_run() >= size

    # -- mutation -----------------------------------------------------

    def alloc(self, size: int) -> Optional[int]:
        """First contiguous run of ``size`` slices, or None."""
        for start, n in self.free_runs():
            if n >= size:
                self._mark(start, size, free=False)
                return start
        return None

    def alloc_multi(self, sizes) -> Optional[list[int]]:
        """All-or-nothing multi-block allocation for a vector (MPMD
        pipelined) request: one contiguous block per stage size, or
        None with the pool UNTOUCHED.

        Deadlock-free ordering: blocks are claimed largest-first
        (ties by stage order) so a big stage can never be squeezed out
        by its own trial's small stages landing first — the analog of
        ordered lock acquisition; combined with all-or-nothing rollback
        two racing vector requests cannot deadlock the pool, only fail
        cleanly and retry. Returns starts in STAGE order.
        """
        sizes = [int(s) for s in sizes]
        if not sizes or any(s < 1 for s in sizes):
            raise ValueError(f"bad vector request sizes {sizes}")
        order = sorted(
            range(len(sizes)), key=lambda i: (-sizes[i], i)
        )
        starts: list[Optional[int]] = [None] * len(sizes)
        claimed: list[tuple[int, int]] = []
        for i in order:
            got = self.alloc(sizes[i])
            if got is None:
                for st, sz in claimed:
                    self.free(st, sz)
                return None
            starts[i] = got
            claimed.append((got, sizes[i]))
        return [int(s) for s in starts]  # type: ignore[arg-type]

    def alloc_at(self, start: int, size: int) -> bool:
        """Claim the exact block ``[start, start+size)`` if wholly free."""
        if start < 0 or start + size > self.n_slices:
            return False
        if not all(self._free[start:start + size]):
            return False
        self._mark(start, size, free=False)
        return True

    def free(self, start: int, size: int) -> None:
        for i in range(start, start + size):
            if self._free[i]:
                raise ValueError(
                    f"double free of slice {i} (block {start}+{size})"
                )
        self._mark(start, size, free=True)

    def _mark(self, start: int, size: int, *, free: bool) -> None:
        for i in range(start, start + size):
            self._free[i] = free


class FairShareScheduler:
    """Admission + DRR fair share + shape-bucket packing.

    The runtime owns the slice pool and the trial runs; this class owns
    WHO goes next. One ``schedule()`` call is one DRR pass: it mutates
    the pool (allocating blocks for the placements it returns) and its
    own queues, and keeps the fair-share evidence
    (``contended_cost``) the bench's 10%-of-weights gate reads."""

    def __init__(
        self,
        policies: Optional[dict[str, TenantPolicy]] = None,
        *,
        default_policy: Optional[TenantPolicy] = None,
        max_total_pending: int = 4096,
    ):
        self.policies = dict(policies or {})
        self.default_policy = default_policy or TenantPolicy()
        self.max_total_pending = max_total_pending
        # tenant -> priority -> FIFO of PendingTrial
        self._pending: dict[str, dict[int, list[PendingTrial]]] = {}
        self._rotation: list[str] = []  # stable service order for ties
        # Weighted fair share in its VIRTUAL-TIME form (the
        # opportunity-driven equivalent of deficit round robin for a
        # submesh pool, where service opportunities arrive irregularly
        # — one slice freeing at a time — instead of as a steady link):
        # each tenant carries its normalized attained service
        # v[t] = placed_cost / weight, every placement opportunity goes
        # to the LEAST-attained tenant, and a tenant activating from
        # idle starts at the current virtual time (no hoarded credit —
        # DRR's reset-on-empty). Served cost then converges to the
        # weight ratio under contention in BOTH regimes, and a nonempty
        # tenant can never starve: its v freezes while others' grow, so
        # it becomes the minimum in bounded time.
        self._vsrv: dict[str, float] = {}
        self._vtime = 0.0
        self._next_placement_id = 0
        # Fair-share evidence: cost placed per tenant while at least
        # one OTHER tenant also had pending work (uncontended
        # placements say nothing about fairness and are excluded).
        self.contended_cost: dict[str, float] = {}
        self.placed_cost: dict[str, float] = {}

    # -- admission ----------------------------------------------------

    def policy(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self.default_policy)

    def pending_count(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return sum(
                len(q)
                for lanes in self._pending.values()
                for q in lanes.values()
            )
        return sum(len(q) for q in self._pending.get(tenant, {}).values())

    def admit_verdict(self, tenant: str) -> tuple[str, str]:
        """Admission decision for one more submission from ``tenant``
        given the CURRENT queue depth (the runtime calls this before
        :meth:`push`)."""
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
            verdict, reason = self._admit_verdict(tenant)
            prof.note(
                "admission", _t,
                examined=1, mutated=1 if verdict == ADMIT else 0,
            )
            return verdict, reason
        return self._admit_verdict(tenant)

    def _admit_verdict(self, tenant: str) -> tuple[str, str]:
        total = self.pending_count()
        if total >= self.max_total_pending:
            return (
                REJECT_BACKPRESSURE,
                f"service backlog at {total} >= {self.max_total_pending}; "
                "resubmit later",
            )
        mine = self.pending_count(tenant)
        quota = self.policy(tenant).max_pending
        if mine >= quota:
            return (
                REJECT_QUOTA,
                f"tenant {tenant!r} has {mine} pending >= quota {quota}",
            )
        return ADMIT, ""

    def push(
        self,
        entry: PendingTrial,
        *,
        front: bool = False,
        now: Optional[float] = None,
    ) -> None:
        """Queue an admitted trial in EDF position: deadline-tagged
        entries sit in ascending ``deadline_ts`` order ahead of the
        deadline-less FIFO tail, so one (tenant, lane) queue can never
        hold two same-tenant deadlines inverted (the EDF property
        test). ``front=True`` requeues a recovered/migrated trial ahead
        of EVERYTHING — it already waited (and, for a defrag victim,
        already paid). ``now`` substitutes the wall clock for the
        loadgen's virtual time."""
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        if self.pending_count(entry.tenant) == 0:
            # Activating from idle: start at the current virtual time.
            # Idle time must not bank credit a tenant later spends as a
            # monopolizing burst (DRR's reset-on-empty, SFQ's start-tag
            # rule).
            self._vsrv[entry.tenant] = max(
                self._vsrv.get(entry.tenant, 0.0), self._vtime
            )
        lanes = self._pending.setdefault(entry.tenant, {})
        q = lanes.setdefault(int(entry.priority), [])
        entry.enqueue_ts = time.time() if now is None else now
        entry.front_barrier = bool(front)
        if front:
            q.insert(0, entry)
            examined = 0
        else:
            i, examined = self._edf_index(q, entry)
            q.insert(i, entry)
        if entry.tenant not in self._rotation:
            self._rotation.append(entry.tenant)
        if prof is not None:
            prof.note("edf_insert", _t, examined=examined, mutated=1)

    @staticmethod
    def _edf_index(q: list, entry: PendingTrial) -> tuple[int, int]:
        """``(insertion point, entries compared)`` keeping the queue
        EDF-sorted: ascending ``deadline_ts`` with ties FIFO,
        best-effort (None = +inf) kept FIFO at the tail — and never
        ahead of a ``front_barrier`` entry (the front=True contract).
        O(n) scan from the back — queues are quota-bounded and
        best-effort appends hit the fast path. The comparison count is
        the insert's work-touched book (ctlprof ``edf_insert``): a
        rebuilt heap/tree index must drive it to O(log n)."""
        d = (
            float("inf")
            if entry.deadline_ts is None
            else float(entry.deadline_ts)
        )
        i = len(q)
        seen = 0
        while i > 0:
            seen += 1
            prev = q[i - 1]
            if prev.front_barrier:
                break  # front-pushed entries keep their head position
            other = prev.deadline_ts
            if (float("inf") if other is None else float(other)) <= d:
                break
            i -= 1
        return i, seen

    def pending_entries(self) -> list[PendingTrial]:
        out = []
        for lanes in self._pending.values():
            for pri in sorted(lanes):
                out.extend(lanes[pri])
        return out

    def take(self, sub_id: str) -> Optional[PendingTrial]:
        """Remove and return the queued entry for ``sub_id``, or None.

        The transfer primitive's scheduler half (shard split handoffs
        and cross-shard steal grants take queued-but-unplaced work out
        of this shard's queues before re-spooling it at the
        destination). No virtual-time refund: :meth:`_charge` advances
        vtime only at PLACEMENT, and a never-placed entry was never
        charged — the origin tenant's attained service is exactly what
        it attained. The emptied (tenant, lane) list is pruned so
        ``pending_count`` (admission's idle-activation check) sees a
        truly idle tenant."""
        for tenant, lanes in self._pending.items():
            for pri, q in lanes.items():
                for i, e in enumerate(q):
                    if e.sub_id == sub_id:
                        q.pop(i)
                        if not q:
                            del lanes[pri]
                        return e
        return None

    # -- the DRR pass -------------------------------------------------

    def _lanes_present(self) -> list[int]:
        pris: set[int] = set()
        for lanes in self._pending.values():
            for pri, q in lanes.items():
                if q:
                    pris.add(pri)
        return sorted(pris)

    def _tenants_with_work(self, pri: int) -> list[str]:
        return [
            t
            for t in self._rotation
            if self._pending.get(t, {}).get(pri)
        ]

    def schedule(
        self,
        pool: SlicePool,
        *,
        max_lanes: int = 4,
        now: Optional[float] = None,
        can_start: Optional[Callable[[PendingTrial], bool]] = None,
        scan_limit: Optional[int] = None,
    ) -> list[Placement]:
        """One scheduling pass. Allocates slice blocks from ``pool``
        and dequeues the selected trials; whatever could not be placed
        (no deficit yet, or no contiguous block of its size — the
        ``blocked_since`` stamp defrag watches) stays queued.

        ``can_start`` lets the runtime veto an otherwise-placeable
        entry (e.g. its executable is still precompiling) without
        consuming its fair-share turn. ``scan_limit`` bounds how far
        past a blocked queue head each (tenant, lane) scan looks for
        smaller placeable work (None = unbounded, the daemon's
        semantics; the discrete-event loadgen passes a small window so
        a million-submission replay stays O(1) per blocked tenant).
        """
        now = time.time() if now is None else now
        prof = _ctlprof.get_ctlprof()
        placements: list[Placement] = []
        # One placement per (bucket, size) may sit open below max_lanes
        # at any moment of the pass — the never-split-a-bucket rule.
        open_placements: dict[tuple, Placement] = {}
        multi_tenant_backlog = (
            sum(1 for t in self._rotation if self.pending_count(t) > 0)
            >= 2
        )

        for pri in self._lanes_present():
            # Strict priority: this lane is served to exhaustion (of
            # slices or placeable work) before the next lane starts.
            # Within the lane: every placement opportunity goes to the
            # least-attained tenant first (see the virtual-time notes
            # in __init__); re-sorted after each placement, since the
            # served tenant's v just advanced.
            while True:
                served = False
                if prof is not None:
                    _t = prof.t0()
                # Largest free run, computed ONCE per opportunity: an
                # entry bigger than it cannot allocate anywhere, so the
                # scan skips it in O(1) instead of walking the free map
                # per blocked entry (the loadgen's hot path).
                largest = pool.largest_free_run()
                order = sorted(
                    self._tenants_with_work(pri),
                    key=lambda t: (self._vsrv.get(t, 0.0), t),
                )
                if prof is not None:
                    # One fair-share opportunity: the free-map walk +
                    # the vtime sort over every tenant with lane work.
                    prof.note("fair_share_pick", _t, examined=len(order))
                for tenant in order:
                    if prof is not None:
                        _t = prof.t0()
                    got, seen = self._serve_one(
                        tenant, pri, pool, open_placements, placements,
                        max_lanes=max_lanes, now=now,
                        contended=multi_tenant_backlog,
                        can_start=can_start,
                        largest_free=largest,
                        scan_limit=scan_limit,
                    )
                    if prof is not None:
                        prof.note(
                            "bin_pack_scan", _t,
                            examined=seen, mutated=1 if got else 0,
                        )
                    if got:
                        served = True
                        break
                if not served:
                    break
        return placements

    def _serve_one(
        self,
        tenant: str,
        pri: int,
        pool: SlicePool,
        open_placements: dict,
        placements: list,
        *,
        max_lanes: int,
        now: float,
        contended: bool,
        can_start: Optional[Callable[[PendingTrial], bool]],
        largest_free: Optional[int] = None,
        scan_limit: Optional[int] = None,
    ) -> tuple[bool, int]:
        """Try to place ONE trial of ``tenant`` in lane ``pri`` (EDF
        then FIFO within the lane — the queue is kept in that order by
        :meth:`push`). Scans past entries blocked on slice shape
        (stamping ``blocked_since`` — defrag's starvation clock) so one
        large trial cannot convoy its tenant's small ones.

        Returns ``(placed, entries examined)`` — the examined count is
        the scan's work-touched book (ctlprof ``bin_pack_scan``):
        queue entries looked at, including ``can_start`` vetoes and
        shape-blocked skips, before placing one or giving up."""
        q = self._pending.get(tenant, {}).get(pri, [])
        seen = 0
        for idx, entry in enumerate(q):
            if scan_limit is not None and idx >= scan_limit:
                return False, seen
            seen = idx + 1
            # A pinned entry is a defrag victim being re-homed: it
            # already paid its cost when first placed, so its
            # re-placement advances no virtual time and is never
            # deferred (a victim left waiting its turn would watch its
            # relocation target be stolen).
            pinned = entry.pinned_start is not None
            if can_start is not None and not can_start(entry):
                continue
            if entry.sizes is not None:
                # Vector (pipelined) request: all-or-nothing multi-
                # block allocation, never co-packed, never pinned
                # (pipelined placements are defrag-immovable).
                if (
                    largest_free is not None
                    and max(entry.sizes) > largest_free
                ):
                    # No run fits even the biggest stage: blocked
                    # without touching the free map.
                    if entry.blocked_since is None:
                        entry.blocked_since = now
                    continue
                starts = pool.alloc_multi(entry.sizes)
                if starts is None:
                    if entry.blocked_since is None:
                        entry.blocked_since = now
                    continue
                placement = Placement(
                    placement_id=self._next_placement_id,
                    bucket=entry.bucket,
                    size=sum(entry.sizes),
                    start=starts[0],
                    blocks=list(zip(starts, entry.sizes)),
                )
                self._next_placement_id += 1
                placements.append(placement)
                placement.members.append(entry)
                q.pop(idx)
                entry.blocked_since = None
                self._charge(entry, contended)
                return True, seen
            pack_key = (entry.bucket, entry.size)
            open_p = open_placements.get(pack_key)
            attach = (
                open_p is not None
                and open_p.lanes < max_lanes
                and not entry.resume_scan
                and entry.pinned_start is None
            )
            if attach:
                placement = open_p
            else:
                if (
                    largest_free is not None
                    and entry.size > largest_free
                ):
                    # Cannot allocate anywhere (an exact pinned block,
                    # were it free, would sit inside a run >= size) and
                    # cannot attach: blocked in O(1).
                    if entry.blocked_since is None:
                        entry.blocked_since = now
                    continue
                start = None
                if entry.pinned_start is not None:
                    if pool.alloc_at(entry.pinned_start, entry.size):
                        start = entry.pinned_start
                if start is None:
                    start = pool.alloc(entry.size)
                if start is None:
                    # No contiguous block of this size: blocked. Stamp
                    # the starvation clock and look past it — smaller
                    # work behind it may still fit.
                    if entry.blocked_since is None:
                        entry.blocked_since = now
                    continue
                placement = Placement(
                    placement_id=self._next_placement_id,
                    bucket=entry.bucket,
                    size=entry.size,
                    start=start,
                )
                self._next_placement_id += 1
                placements.append(placement)
                # resume_scan trials run classic (no lane restore into
                # a stacked bucket), so their placement never opens for
                # co-packing.
                if not entry.resume_scan and entry.pinned_start is None:
                    open_placements[pack_key] = placement
            placement.members.append(entry)
            if placement.lanes >= max_lanes:
                open_placements.pop((entry.bucket, entry.size), None)
            q.pop(idx)
            entry.blocked_since = None
            if not pinned:
                self._charge(entry, contended)
            return True, seen
        return False, seen

    def _charge(self, entry: PendingTrial, contended: bool) -> None:
        """Advance the tenant's virtual time by the placement's cost.
        ``entry.cost`` is predicted steps × TOTAL slices — a vector
        (pipelined) entry's cost already sums its stage blocks, so a
        2-stage whale pays for both submeshes it occupies (the
        fair-share property test pins the ±10% bound with mixed
        single/vector traffic)."""
        tenant = entry.tenant
        v = self._vsrv.get(tenant, 0.0)
        self._vtime = max(self._vtime, v)
        self._vsrv[tenant] = v + entry.cost / self.policy(tenant).weight
        self.placed_cost[tenant] = (
            self.placed_cost.get(tenant, 0.0) + entry.cost
        )
        if contended:
            self.contended_cost[tenant] = (
                self.contended_cost.get(tenant, 0.0) + entry.cost
            )

    # -- deadlines ----------------------------------------------------

    def deadline_pending(
        self, *, now: Optional[float] = None
    ) -> list[PendingTrial]:
        """Deadline-tagged pending entries, earliest deadline first —
        the preemption trigger's candidate list (the runtime preempts
        for at most one per pass). Entries whose deadline already
        passed still sort first: they place soonest and the miss is
        accounted at settle time, never enforced by killing."""
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        entries = self.pending_entries()
        out = [e for e in entries if e.deadline_ts is not None]
        out.sort(key=lambda e: (e.deadline_ts, e.enqueue_ts))
        if prof is not None:
            # Candidate-list half of the preemption window search (the
            # planner's window scan notes the same phase separately):
            # O(pending) today — the incremental-index rebuild target.
            prof.note("preempt_window", _t, examined=len(entries))
        return out

    # -- starvation ---------------------------------------------------

    def starved_entries(
        self, *, threshold_s: float, now: Optional[float] = None
    ) -> list[PendingTrial]:
        """Pending trials blocked on slice SHAPE for longer than the
        threshold — the defrag trigger. Ordered oldest-starved first."""
        now = time.time() if now is None else now
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        entries = self.pending_entries()
        out = [
            e
            for e in entries
            if e.blocked_since is not None
            and now - e.blocked_since >= threshold_s
        ]
        out.sort(key=lambda e: e.blocked_since)
        if prof is not None:
            # Starvation-scan half of defrag planning (the window scan
            # in plan_defrag notes the same phase).
            prof.note("defrag_plan", _t, examined=len(entries))
        return out

    # -- books --------------------------------------------------------

    def fair_share_report(self) -> dict:
        """Observed contended-cost shares vs configured weights — the
        bench gate's input. ``ratio_to_weight`` of 1.0 means the tenant
        received exactly its weighted share of contended placements."""
        total_c = sum(self.contended_cost.values())
        tenants = sorted(
            set(self.placed_cost) | set(self.contended_cost)
        )
        total_w = sum(self.policy(t).weight for t in tenants) or 1.0
        report = {}
        for t in tenants:
            w = self.policy(t).weight
            share = (
                self.contended_cost.get(t, 0.0) / total_c
                if total_c
                else None
            )
            expected = w / total_w
            report[t] = {
                "weight": w,
                "placed_cost": round(self.placed_cost.get(t, 0.0), 3),
                "contended_cost": round(
                    self.contended_cost.get(t, 0.0), 3
                ),
                "contended_share": (
                    round(share, 4) if share is not None else None
                ),
                "expected_share": round(expected, 4),
                "ratio_to_weight": (
                    round(share / expected, 4)
                    if share is not None and expected
                    else None
                ),
            }
        return report
