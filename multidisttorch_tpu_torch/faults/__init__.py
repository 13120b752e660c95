"""Deterministic fault injection for chaos-testing trial supervision.

The counterpart of the JAX package's ``faults/``: ``plan`` defines the
serializable schedule (:class:`FaultPlan` / :class:`FaultSpec`),
``inject`` interprets it at run time (:class:`FaultInjector`) through
hooks the HPO driver threads through itself, the chunk dispatch, the data
iterators and the checkpoint writer, and ``harness`` runs the standard
chaos drill (``examples/chaos_run.py``).
"""

from multidisttorch_tpu_torch.faults.plan import (  # noqa: F401
    ALL_KINDS,
    CKPT_CORRUPT,
    CRASH,
    DAEMON_LOST,
    DATA_ERROR,
    DIVERGE,
    HOST_KINDS,
    HOST_LOST,
    INFRA_KINDS,
    PREEMPT,
    SHARD_SPLIT_LOST,
    SLOW,
    WEDGE,
    FaultPlan,
    FaultSpec,
)
from multidisttorch_tpu_torch.faults.inject import (  # noqa: F401
    HOST_LOST_EXIT_CODE,
    DataFault,
    FaultInjector,
    HostPreemption,
    InfraFault,
    InjectedCrash,
    corrupt_file,
)
