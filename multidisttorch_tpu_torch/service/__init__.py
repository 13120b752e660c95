"""Sweep-as-a-service: a persistent multi-tenant trial scheduler.

Counterpart of the JAX package's ``service/`` package, first part (ROADMAP
A.12). ``run_hpo`` is a batch call over a fixed trial list; this package is
the front door that turns the same machinery into a long-running service
(docs/SERVICE.md):

- :mod:`service.queue`: durable submission intake. Tenants submit
  :class:`~multidisttorch_tpu_torch.hpo.driver.TrialConfig`-shaped work
  with tenant, priority and deadline tags through :class:`SweepClient` (or
  ``examples/sweep_submit.py``); every accepted submission survives a
  daemon ``kill -9``. Its records and encoding are the JAX package's, so a
  journal either package writes folds alike through both.
- :mod:`service.scheduler`: admission control (per-tenant quotas,
  backpressure verdicts), weighted fair share with priority lanes (deficit
  round-robin over tenants) and shape-bucket packing of arriving trials
  onto free slices; same-shape trials from different tenants co-pack into
  one stacked bucket, which runs the lane-batched ELBO kernels.
- :mod:`service.defrag`: online defragmentation and deadline preemption
  plans; the runtime moves their victims through the snapshot-fast drain.
- :mod:`service.runtime`: the daemon loop (:class:`SweepService`) on
  device slots, with its books; ``examples/sweep_service.py`` is the CLI.
- :mod:`service.drill`: the kill -9 restart drill, the defrag drill and
  the service bench, through that CLI.
- :mod:`service.incident_drill`: the incident plane's chaos drill (one
  scenario per fault family but shard splits, and a no-fault soak).
- :mod:`service.fabric`: the sharded service fabric: tenants routed onto
  shards (:func:`shard_of`, through :mod:`service.topology`), lease-fenced
  ownership (:class:`ShardFence`, :class:`FenceLost`), :class:`FabricReplica`
  (failover by adoption, shard splits with the adopter's recovery of a
  split killed halfway, work stealing; the runtime's ``extract_queued``
  moves the queued work) and :class:`FabricClient`; :mod:`service.fabric_drill`
  drills its failover and its split chaos on replica children, a steal and
  a movable stacked bucket in process, and replays the load generator and
  its fabric scenarios.
- :mod:`service.loadgen`: the discrete-event load generator and its
  scenario zoo: seeded workloads of up to millions of submissions through
  the production scheduler, defrag planner and topology on a virtual clock.
- :mod:`service.ckpt_drill`: the checkpoint data plane's drill: v1↔v2
  restore parity, incremental v2 saves, and the snapshot drain against the
  join drain (``SweepService(snapshot_drain=False)``).

The scheduler, queue, defrag, topology and loadgen modules are copies of
the JAX package's (no torch), held to them by ``tests/test_torch_service.py``,
``tests/test_torch_fabric.py`` and ``tests/test_torch_loadgen.py``.

Not ported here (ROADMAP A.12b): the incident drill's split scenario; the
checkpoint drill's ZeRO flavor waits for sharding (A.13), its pipelined
flavor and the movable drill's pipelined arm for pipeline placements (A.14).
"""

from multidisttorch_tpu_torch.service.queue import (  # noqa: F401
    Submission,
    SubmissionQueue,
    SweepClient,
    fold_queue,
)
from multidisttorch_tpu_torch.service.scheduler import (  # noqa: F401
    FairShareScheduler,
    PendingTrial,
    PreemptionPolicy,
    SlicePool,
    TenantPolicy,
)
from multidisttorch_tpu_torch.service.defrag import (  # noqa: F401
    DefragPlan,
    PreemptPlan,
    plan_defrag,
    plan_preemption,
)
from multidisttorch_tpu_torch.service.fabric import (  # noqa: F401
    MOVE_SPLIT,
    MOVE_STEAL,
    FabricClient,
    FabricReplica,
    FenceLost,
    ShardFence,
    shard_of,
)
