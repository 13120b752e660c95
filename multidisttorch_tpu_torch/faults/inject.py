"""The infrastructure-fault classes of ``multidisttorch_tpu/faults/inject.py``.

Only :class:`InfraFault` and :class:`HostPreemption` are here, because
``hpo/supervision.py`` classifies them. The rest of the JAX package's
``faults/`` (fault plans, the injector and its hooks, the chaos harness)
is ROADMAP A.10.
"""

from __future__ import annotations


class InfraFault(RuntimeError):
    """Base of injected *infrastructure* failures: the retryable class."""


class HostPreemption(InfraFault):
    """Host preemption. The driver does NOT absorb this into a per-trial
    failure: it propagates out of ``run_hpo``, and a restarted sweep
    resumes against the ledger."""
