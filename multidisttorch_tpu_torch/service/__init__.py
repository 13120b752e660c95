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
  scenario per fault family that needs no fabric, and a no-fault soak).

The scheduler, queue and defrag modules are copies of the JAX package's
(no torch), held to them by ``tests/test_torch_service.py``.

Not ported here (ROADMAP A.12b): the sharded fabric (``FabricClient``,
``FabricReplica``, ``FenceLost``, ``ShardFence``, ``shard_of``,
``try_claim``), the topology, the fabric and checkpoint drills, the
incident drill's fabric scenarios and the load generator.
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
