"""Online submesh defragmentation: open a contiguous block by moving
small running trials.

The scheduler allocates CONTIGUOUS slice blocks (a submesh is a
contiguous device span), so churn fragments the slice map: free
capacity exists but no run of it is large enough for a big-shape
trial, which then starves behind work that arrived later. MPMD-style
placement (PAPERS.md, arxiv 2412.14374) presumes exactly this
allocator problem; the fix is the classic one from memory compaction —
move the small allocations together.

This module is the pure PLANNER: given the free map, the live
placements, and the starved trial's size, pick the cheapest window to
clear. The runtime executes the plan with the checkpoint migration machinery
(checkpoint-drain the victim, free its slices, requeue it
``resume_scan`` pinned to its relocation target — the trial restores
from its last flushed checkpoint on the new submesh, bit-identically
to a preemption restart).

Planner contract (tests/test_service.py enforces all three):

- every move's victim is MOVABLE — a placement whose checkpoint state
  is flushed to disk (or that has no progress to lose). Under the
  legacy join-drain a trial with an unflushed checkpoint is NEVER
  migrated: migration restores from the last durable checkpoint, and
  moving a trial whose newest work exists only in an in-flight write
  would silently discard it. Under the snapshot-fast drain
  (docs/RESILIENCE.md "Snapshot-fast drain") that in-flight write is
  ADOPTED instead — it lands on the victim's background writer
  before the victim's `preempted` record, a same-process re-place
  prefers the (newer) RAM snapshot, and a stale late persist can
  never replace a successor's newer manifest (the save path's
  step guard), so migration still never rolls back past it;
  eligibility widens without weakening the rule.
- relocation targets lie wholly OUTSIDE the window being cleared and
  fit in today's free runs — the plan is executable without a second
  defrag.
- among feasible windows the plan moves the least total slice-size
  (ties: lowest window start) — defrag is paid on the critical path of
  a starved trial, so the cheapest unblock wins.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from multidisttorch_tpu_torch.service.scheduler import SlicePool
from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof


@dataclass(frozen=True)
class PlacedBlock:
    """The planner's view of one live placement block: where it sits
    and whether its placement may be moved (the runtime answers
    ``movable`` from its checkpoint bookkeeping — flushed-to-disk or
    nothing-to-lose). A pipelined placement contributes one record per
    stage block, all sharing a ``placement_id``.

    ``rehome_sizes`` is what evicting the placement would REQUEUE, as
    slice sizes: empty means the classic case ``(size,)``; a stacked
    bucket lists one entry per live lane (each resumes as a classic
    single); a pipelined vector lists one entry per stage block. The
    re-home feasibility leg sizes against these units, and a
    multi-unit victim's move is UNPINNED (``new_start = None``) — the
    scheduler re-homes each unit wherever it fits."""

    placement_id: int
    start: int
    size: int
    movable: bool
    rehome_sizes: tuple = ()

    def units(self) -> tuple:
        return self.rehome_sizes or (self.size,)


@dataclass
class DefragPlan:
    """Moves to execute (in order) and the block they open.

    ``moves`` are ``(placement_id, new_start)`` — ``new_start`` is the
    pinned relocation target for a classic single-block victim, or
    ``None`` for a multi-unit victim (stacked bucket / pipelined
    vector) whose requeued units re-home unpinned; the window
    ``[window_start, window_start + window_size)`` is the contiguous
    block that becomes free once every victim's old slices are
    released — the freed-slice accounting the ``defrag_end`` event
    reports."""

    window_start: int
    window_size: int
    moves: list[tuple[int, Optional[int]]] = field(default_factory=list)


def plan_defrag(
    pool: SlicePool,
    placements: list[PlacedBlock],
    want_size: int,
    *,
    movable_fn: Optional[Callable[[PlacedBlock], bool]] = None,
) -> Optional[DefragPlan]:
    """Cheapest feasible plan opening ``want_size`` contiguous slices,
    or ``None`` when no window can be cleared (every candidate window
    holds an immovable trial, or the displaced trials cannot be
    re-homed in the remaining free space).

    ``movable_fn`` overrides/bolsters each block's own ``movable`` flag
    (the runtime passes a live checkpoint-flushed check so the verdict
    is taken at PLAN time, not placement time)."""
    prof = _ctlprof.get_ctlprof()
    if prof is None:
        return _plan_defrag(
            pool, placements, want_size, movable_fn=movable_fn
        )[0]
    _t = prof.t0()
    plan, probes = _plan_defrag(
        pool, placements, want_size, movable_fn=movable_fn
    )
    # examined = slice probes across every candidate window (the
    # O(n_slices * windows) scan the rebuild must make incremental);
    # mutated = moves actually planned.
    prof.note(
        "defrag_plan", _t,
        examined=probes,
        mutated=len(plan.moves) if plan is not None else 0,
    )
    return plan


def _plan_defrag(
    pool: SlicePool,
    placements: list[PlacedBlock],
    want_size: int,
    *,
    movable_fn: Optional[Callable[[PlacedBlock], bool]] = None,
) -> tuple[Optional[DefragPlan], int]:
    """``(plan, slice probes)`` — see :func:`plan_defrag`."""
    probes = 0
    n = pool.n_slices
    if want_size < 1 or want_size > n:
        return None, probes
    if pool.largest_free_run() >= want_size:
        # Nothing to do: a zero-move plan naming the already-free block.
        for start, ln in pool.free_runs():
            if ln >= want_size:
                return (
                    DefragPlan(window_start=start, window_size=want_size),
                    probes,
                )
    by_slice: dict[int, PlacedBlock] = {}
    blocks_of: dict[int, list[PlacedBlock]] = {}
    for p in placements:
        blocks_of.setdefault(p.placement_id, []).append(p)
        for i in range(p.start, p.start + p.size):
            by_slice[i] = p
    free = set(i for start, ln in pool.free_runs()
               for i in range(start, start + ln))

    def is_movable(p: PlacedBlock) -> bool:
        if not p.movable:
            return False
        return movable_fn(p) if movable_fn is not None else True

    best: Optional[tuple[int, int, DefragPlan]] = None  # (cost, start, plan)
    for w0 in range(0, n - want_size + 1):
        window = range(w0, w0 + want_size)
        victims: dict[int, PlacedBlock] = {}
        ok = True
        for i in window:
            probes += 1
            if i in free:
                continue
            p = by_slice.get(i)
            if p is None or not is_movable(p):
                ok = False
                break
            # A victim straddling the window edge still moves whole.
            victims[p.placement_id] = p
        if not ok or not victims:
            continue
        # Re-home every victim in free runs OUTSIDE the window,
        # first-fit over a working copy of the free map (victims'
        # own old slices do NOT count — they free only after the
        # move, and a plan must be executable move-by-move). A victim
        # that re-homes as SEVERAL units (stacked bucket, pipelined
        # vector) must fit unit-by-unit; its move is unpinned.
        avail = sorted(i for i in free if i not in window)
        runs = _runs_of(avail)
        moves: list[tuple[int, Optional[int]]] = []
        feasible = True
        for pid in sorted(victims):
            units = victims[pid].units()
            if len(units) == 1 and len(blocks_of[pid]) == 1:
                spot = _take_run(runs, units[0])
                if spot is None:
                    feasible = False
                    break
                moves.append((pid, spot))
                continue
            for u in sorted(units, reverse=True):
                if _take_run(runs, u) is None:
                    feasible = False
                    break
            else:
                moves.append((pid, None))
                continue
            break
        if not feasible:
            continue
        # The whole placement moves, window-straddling blocks and all:
        # the cost is every block it occupies, not just the window cut.
        cost = sum(
            b.size for pid, _ in moves for b in blocks_of[pid]
        )
        key = (cost, w0)
        if best is None or key < (best[0], best[1]):
            best = (
                cost,
                w0,
                DefragPlan(
                    window_start=w0, window_size=want_size, moves=moves
                ),
            )
    return (best[2] if best is not None else None), probes


@dataclass
class PreemptPlan:
    """Victims to EVICT (not relocate) to open the window for a
    deadline-tagged trial. Unlike a :class:`DefragPlan`, victims are
    not re-homed — they checkpoint-drain, ledger ``preempted``, and
    requeue as best-effort backlog (the fabric's first-class
    preemption primitive, docs/SERVICE.md "Deadlines")."""

    window_start: int
    window_size: int
    victims: list = field(default_factory=list)  # [placement_id, ...]
    victim_slices: int = 0


def plan_preemption(
    pool: SlicePool,
    placements: list[PlacedBlock],
    want_size: int,
) -> Optional[PreemptPlan]:
    """Cheapest window openable by EVICTING best-effort placements, or
    None when every candidate window holds an unevictable one.

    ``placements`` must carry ``movable=True`` only for placements the
    caller has already cleared for eviction (best-effort, checkpoint
    flushed, within the anti-thrash budget — the runtime's
    ``_preemptible`` verdict). Defrag's window scan, minus the re-home
    feasibility leg: eviction frees the victim's slices outright, so
    the only cost is the victims' lost progress, minimized as total
    evicted slice-size (ties: lowest window start)."""
    prof = _ctlprof.get_ctlprof()
    if prof is None:
        return _plan_preemption(pool, placements, want_size)[0]
    _t = prof.t0()
    plan, probes = _plan_preemption(pool, placements, want_size)
    prof.note(
        "preempt_window", _t,
        examined=probes,
        mutated=len(plan.victims) if plan is not None else 0,
    )
    return plan


def _plan_preemption(
    pool: SlicePool,
    placements: list[PlacedBlock],
    want_size: int,
) -> tuple[Optional[PreemptPlan], int]:
    """``(plan, slice probes)`` — see :func:`plan_preemption`."""
    probes = 0
    n = pool.n_slices
    if want_size < 1 or want_size > n:
        return None, probes
    if pool.largest_free_run() >= want_size:
        for start, ln in pool.free_runs():
            if ln >= want_size:
                return (
                    PreemptPlan(window_start=start, window_size=want_size),
                    probes,
                )
    by_slice: dict[int, PlacedBlock] = {}
    blocks_of: dict[int, list[PlacedBlock]] = {}
    for p in placements:
        blocks_of.setdefault(p.placement_id, []).append(p)
        for i in range(p.start, p.start + p.size):
            by_slice[i] = p
    free = set(
        i for start, ln in pool.free_runs() for i in range(start, start + ln)
    )
    best: Optional[PreemptPlan] = None
    for w0 in range(0, n - want_size + 1):
        victims: dict[int, PlacedBlock] = {}
        ok = True
        for i in range(w0, w0 + want_size):
            probes += 1
            if i in free:
                continue
            p = by_slice.get(i)
            if p is None or not p.movable:
                ok = False
                break
            victims[p.placement_id] = p
        if not ok or not victims:
            continue
        # Eviction frees the victim's EVERY block (a pipelined vector
        # drains all-or-nothing), so the lost-progress cost counts all
        # of them, not just the window cut.
        cost = sum(
            b.size for pid in victims for b in blocks_of[pid]
        )
        if best is None or cost < best.victim_slices:
            best = PreemptPlan(
                window_start=w0,
                window_size=want_size,
                victims=sorted(victims),
                victim_slices=cost,
            )
    return best, probes


def _runs_of(slices: list[int]) -> list[list[int]]:
    """Maximal ascending runs as mutable ``[start, length]`` cells."""
    runs: list[list[int]] = []
    for i in slices:
        if runs and i == runs[-1][0] + runs[-1][1]:
            runs[-1][1] += 1
        else:
            runs.append([i, 1])
    return runs


def _take_run(runs: list[list[int]], size: int) -> Optional[int]:
    """First-fit claim of ``size`` contiguous slices from the working
    free map; mutates ``runs``."""
    for r in runs:
        if r[1] >= size:
            start = r[0]
            r[0] += size
            r[1] -= size
            return start
    return None
