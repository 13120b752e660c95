"""Trial supervision policy: failure classification and retry budgets.

A copy of ``multidisttorch_tpu/hpo/supervision.py`` over the port's own
error classes, with its ``failure_classified`` bus event.

The sweep's unit of failure is ONE trial attempt. What happens next is
a pure function of the failure's *class*, not its text:

- **divergence** (:class:`~multidisttorch_tpu_torch.train.guards.
  DivergenceError`): the configuration itself produced a non-finite
  loss. Deterministic training replays the same NaN on every retry, so
  this is a terminal trial *result* (``status="diverged"``): the sweep
  records it and moves on.
- **preemption / lost peer** (:class:`~multidisttorch_tpu_torch.faults.
  inject.HostPreemption`, or an :class:`~multidisttorch_tpu_torch.
  parallel.cluster.AgreementTimeout` from a deadline-bounded agreement):
  the host is going away, or a peer already did. Per-trial retry is
  meaningless, and for an expired agreement harmful: the abandoned
  collective leaves this process's distributed state unusable. The
  driver re-raises so the process can die; the sweep ledger makes the
  restarted driver resume where it stopped.
- **infra** (everything else): the environment failed around a healthy
  trial (worker exception, data fault, checkpoint I/O). Retry with capped
  exponential backoff, resuming from the trial's last *valid* checkpoint
  (``train.checkpoint.restore_latest_valid``), until the
  :class:`RetryPolicy` budget is spent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from multidisttorch_tpu_torch.faults.inject import HostPreemption
from multidisttorch_tpu_torch.parallel.cluster import PREEMPTION_EXIT_CODE, AgreementTimeout
from multidisttorch_tpu_torch.telemetry.events import get_bus
from multidisttorch_tpu_torch.train.guards import DivergenceError

INFRA = "infra"
DIVERGENCE = "divergence"
PREEMPTION = "preemption"
FATAL = "fatal"

# Attempt-end statuses that SETTLE a trial: a restarted sweep must not
# re-run it (hpo/ledger.py's skip contract).
SETTLED_STATUSES = ("completed", "diverged")


class UnretryableError(ValueError):
    """A deliberate hard stop that retrying would only paper over.

    The strict-resume integrity guards raise this (a ValueError subclass):
    a config-mismatched or state/sidecar-skewed checkpoint needs a human
    decision. A supervised retry would scan-resume past the rejected
    checkpoint, retrain from scratch, and replace the very weights the
    guard refused to clobber. Classified FATAL: never retried, never
    consumes budget.
    """


def classify_failure(exc: BaseException, *, trial_id=None) -> str:
    """Map an attempt's exception to its supervision class. Every
    decision is a ``failure_classified`` bus event (``trial_id``, when the
    caller knows it, rides on it), so a chaos trace shows what the
    supervisor decided to do about each fault."""
    cls = _classify(exc)
    bus = get_bus()
    if bus is not None:
        bus.emit(
            "failure_classified",
            trial_id=trial_id,
            failure_class=cls,
            exc_type=type(exc).__name__,
            error=str(exc)[:300],
        )
    return cls


def _classify(exc: BaseException) -> str:
    if isinstance(exc, DivergenceError):
        return DIVERGENCE
    if isinstance(exc, UnretryableError):
        return FATAL
    # AgreementTimeout (and ONLY that TimeoutError subtype: a transient
    # I/O timeout in a trial must stay retryable) is a lost peer.
    if isinstance(exc, (HostPreemption, AgreementTimeout)):
        return PREEMPTION
    return INFRA


def exit_code_for(exc: BaseException) -> int:
    """The exit code of a supervised worker dying on ``exc``:
    preemption-class failures (host preemption, a wedged collective) exit
    with ``cluster.PREEMPTION_EXIT_CODE`` so a supervisor re-admits the
    host; anything else exits 1 (the host itself is suspect)."""
    return PREEMPTION_EXIT_CODE if classify_failure(exc) == PREEMPTION else 1


@dataclass(frozen=True)
class RetryPolicy:
    """Retry budget for infra-class failures.

    ``max_retries`` is the number of *re*-attempts (0 disables retry;
    a trial runs at most ``max_retries + 1`` times). Backoff before
    retry k (1-based) is ``min(backoff_base_s * backoff_factor**(k-1),
    backoff_max_s)``: capped exponential.

    ``jitter=True`` switches to **decorrelated jitter**: retry k sleeps
    ``uniform(base, 3 * previous_sleep)`` capped at ``backoff_max_s``, so
    trials felled by the same fault do not wake in lockstep. The jitter
    stream is a pure function of ``(jitter_seed, key, retry_number)``
    (``key`` is the trial id in the HPO driver).
    """

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    jitter: bool = False
    jitter_seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff times must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(f"backoff_factor must be >= 1, got {self.backoff_factor}")

    def backoff_s(self, retry_number: int, *, key: int = 0) -> float:
        """Backoff before the ``retry_number``-th retry (1-based).
        ``key`` decorrelates concurrent failure domains under
        ``jitter=True`` (ignored otherwise)."""
        if retry_number < 1:
            raise ValueError(f"retry_number is 1-based, got {retry_number}")
        if not self.jitter:
            return min(
                self.backoff_base_s * self.backoff_factor ** (retry_number - 1),
                self.backoff_max_s,
            )
        # Decorrelated chain, recomputed deterministically from the start:
        # sleep_k ~ uniform(base, 3 * sleep_{k-1}), each draw from its own
        # (seed, key, k)-derived stream.
        sleep = self.backoff_base_s
        for k in range(1, retry_number + 1):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.jitter_seed & 0xFFFFFFFF, key & 0xFFFFFFFF, k])
            )
            hi = max(self.backoff_base_s, 3.0 * sleep)
            sleep = min(self.backoff_max_s, rng.uniform(self.backoff_base_s, hi))
        return sleep

    def should_retry(self, infra_failures: int, failure_class: str) -> bool:
        """Whether to schedule another attempt after the trial's
        ``infra_failures``-th infra-class failure. The budget counts infra
        FAILURES, not attempts started: preemptions never consume it."""
        if failure_class != INFRA:
            return False
        return infra_failures <= self.max_retries
