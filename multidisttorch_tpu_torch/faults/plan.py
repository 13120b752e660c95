"""Deterministic, serializable fault schedules.

A copy of ``multidisttorch_tpu/faults/plan.py`` (that module imports no
jax, but its package does on import): the same kinds, :class:`FaultSpec`,
:class:`FaultPlan`, JSON round trip and validation messages, and
:meth:`FaultPlan.standard` draws from the same numpy stream, so one seed
gives one plan in both packages.

A :class:`FaultPlan` is the chaos harness's ground truth: a list of
:class:`FaultSpec` entries, each firing at an exact ``(trial, step)``
point (or an epoch boundary, for checkpoint faults). Plans are plain
data (JSON round-trippable, diffable), so every recovery path the drill
exercises is reproducible. No randomness executes at injection time;
:meth:`FaultPlan.standard` derives its schedule from a seed *once*, at
construction.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, asdict
from typing import Sequence

# Fault kinds. "Infra" kinds model the environment failing around a
# healthy trial (retryable); DIVERGE models the trial itself going
# non-finite (terminal — see hpo/supervision.py's classification).
CRASH = "crash"            # raise InjectedCrash before dispatching a step
PREEMPT = "preempt"        # raise HostPreemption: simulated host loss —
                           # propagates out of run_hpo (the driver dies)
SLOW = "slow"              # sleep delay_s before a step (straggler)
DATA_ERROR = "data_error"  # the trial's data iterator raises DataFault
DIVERGE = "diverge"        # poison the step's batch with NaN: the loss
                           # genuinely goes non-finite through the
                           # compiled program (terminal, not infra)
CKPT_CORRUPT = "ckpt_corrupt"  # garble the trial's checkpoint file
                               # after the epoch write lands
HOST_LOST = "host_lost"    # the targeted HOST dies instantly (os._exit,
                           # no cleanup, heartbeat stops) — the elastic
                           # supervisor must re-form the world without it
WEDGE = "wedge"            # the targeted HOST stops making progress
                           # (sleeps with its heartbeat suspended): the
                           # peers' sync watchdogs must convert the
                           # stuck collective into WedgedCollective
DAEMON_LOST = "daemon_lost"  # SIGKILL the targeted service-fabric
                             # REPLICA on its cumulative dispatch clock
                             # (no drain, no cleanup — shard leases go
                             # stale and a surviving replica must adopt
                             # the orphaned shard, docs/SERVICE.md)
SHARD_SPLIT_LOST = "shard_split_lost"  # SIGKILL the targeted replica on
                             # its cumulative SPLIT-HANDOFF clock: the
                             # replica dies BETWEEN two durable handoff
                             # records of a shard split (after the Nth
                             # submission's `moved` journal append) —
                             # the seam the adopting replica must close
                             # by completing or aborting the pending
                             # split with no submission lost and none
                             # double-owned (docs/SERVICE.md "Shard
                             # topology")

INFRA_KINDS = frozenset({CRASH, PREEMPT, SLOW, DATA_ERROR, CKPT_CORRUPT})
# Host-scoped kinds fire on ONE host of a multi-host world (FaultSpec
# .host), keyed to the host's cumulative dispatched-step count instead
# of a single trial's step — the fault is about the host, not a trial.
# DAEMON_LOST reads .host as the fabric REPLICA id (the replica's
# dispatch clock is the firing clock); SHARD_SPLIT_LOST reads .host the
# same way but fires on the replica's split-handoff clock instead.
HOST_KINDS = frozenset({HOST_LOST, WEDGE, DAEMON_LOST, SHARD_SPLIT_LOST})
ALL_KINDS = INFRA_KINDS | HOST_KINDS | {DIVERGE}


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault: ``kind`` fires for ``trial_id`` at optimizer
    step ``step`` (step-scoped kinds) or at the epoch-``epoch``
    checkpoint write (``ckpt_corrupt``). ``delay_s`` is the SLOW kind's
    stall (and the WEDGE kind's stuck duration — 0 means "wedge until
    killed"). ``max_fires`` bounds repetition: the default 1 makes a
    fault one-shot, so a retried trial sails past the injection point —
    the shape of a transient infra fault (a permanent fault is just
    ``max_fires`` >= the retry budget).

    Host-scoped kinds (:data:`HOST_KINDS`) target host slot ``host`` of
    a multi-host world and fire when that host's CUMULATIVE dispatched
    steps (any trial) reach ``step`` — ``trial_id`` is ignored (use -1).
    Only a ``FaultInjector`` armed with a ``host_slot`` interprets them;
    a single-controller run skips them entirely."""

    kind: str
    trial_id: int
    step: int = -1
    epoch: int = -1
    delay_s: float = 0.0
    max_fires: int = 1
    host: int = -1

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{sorted(ALL_KINDS)}"
            )
        if self.kind == CKPT_CORRUPT:
            if self.epoch < 1:
                raise ValueError(
                    f"{self.kind} faults fire at an epoch-boundary write; "
                    f"need epoch >= 1, got {self.epoch}"
                )
        elif self.step < 0:
            raise ValueError(
                f"{self.kind} faults fire at an optimizer step; need "
                f"step >= 0, got {self.step}"
            )
        if self.kind in HOST_KINDS and self.host < 0:
            raise ValueError(
                f"{self.kind} faults target a host slot; need host >= 0, "
                f"got {self.host}"
            )
        if self.max_fires < 1:
            raise ValueError(f"max_fires must be >= 1, got {self.max_fires}")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of :class:`FaultSpec` entries plus the seed
    that generated it (0 for hand-written plans)."""

    specs: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    def for_trial(self, trial_id: int) -> list[FaultSpec]:
        return [s for s in self.specs if s.trial_id == trial_id]

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "specs": [asdict(s) for s in self.specs]},
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(
            specs=tuple(FaultSpec(**s) for s in d.get("specs", ())),
            seed=int(d.get("seed", 0)),
        )

    @classmethod
    def standard(
        cls,
        trial_ids: Sequence[int],
        *,
        seed: int = 0,
        steps_per_epoch: int = 8,
        include_preempt: bool = True,
    ) -> "FaultPlan":
        """The chaos bench's standard schedule: one fault of each kind,
        spread deterministically (seeded) over the sweep's trials, with
        at least one trial left fault-free as the parity control.

        Layout over ``trial_ids`` (cycling if fewer trials than kinds):
        a mid-epoch CRASH, a DATA_ERROR, a CKPT_CORRUPT on the first
        epoch's checkpoint *paired with a later CRASH on the same trial*
        (the retry must then scan past the corrupt checkpoint — the
        corruption alone recovers trivially), a SLOW straggler, a
        DIVERGE, and (unless ``include_preempt=False``) a PREEMPT that
        kills the driver — the restart half of the protocol.
        """
        import numpy as np

        if not trial_ids:
            raise ValueError("standard plan needs at least one trial id")
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0xFA]))
        # Keep the LAST trial fault-free: the bit-parity control.
        victims = list(trial_ids[:-1]) or list(trial_ids)

        def pick(i):
            return victims[i % len(victims)]

        def mid_step(lo_epoch):
            # A step strictly inside epoch lo_epoch+1 (0-based steps).
            return lo_epoch * steps_per_epoch + int(
                rng.integers(1, max(2, steps_per_epoch))
            )

        specs = [
            FaultSpec(CRASH, pick(0), step=mid_step(1)),
            FaultSpec(DATA_ERROR, pick(1), step=mid_step(1)),
            FaultSpec(CKPT_CORRUPT, pick(2), epoch=1),
            FaultSpec(CRASH, pick(2), step=mid_step(1)),
            FaultSpec(SLOW, pick(3), step=mid_step(0), delay_s=0.2),
            FaultSpec(DIVERGE, pick(4), step=mid_step(0)),
        ]
        if include_preempt:
            specs.append(FaultSpec(PREEMPT, pick(5), step=mid_step(1)))
        return cls(specs=tuple(specs), seed=seed)
