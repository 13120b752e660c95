"""Divergence detection for training loops.

A copy of ``multidisttorch_tpu/train/guards.py``, which imports no JAX.

A non-finite loss is a *result*, not an infrastructure failure: the
trial's hyperparameters drove the optimization off a cliff, and re-running
the same config reproduces the same NaN. Retrying it wastes the group;
recording a garbage metric silently poisons the sweep's comparison. The
honest shape is a structured :class:`DivergenceError` naming the step,
raised at the loop's existing host-sync point, never an extra device
round-trip.

The HPO driver classifies this error terminally (``status="diverged"``,
no retry: ``hpo/supervision.py``); other loops get the same contract
through :func:`check_finite` / :func:`guard_finite`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


class DivergenceError(RuntimeError):
    """Training produced a non-finite loss.

    Carries enough structure for a supervisor to act on it without
    parsing the message: the step at which the non-finite value was
    *observed* (detection happens at the loop's existing sync cadence,
    so the true divergence step is <= this one), and the offending value.
    """

    def __init__(
        self,
        what: str,
        value: float,
        *,
        step: Optional[int] = None,
        trial_id: Optional[int] = None,
    ):
        self.what = what
        self.value = value
        self.step = step
        self.trial_id = trial_id
        where = f" at step {step}" if step is not None else ""
        who = f"trial {trial_id}: " if trial_id is not None else ""
        super().__init__(
            f"{who}{what} is non-finite ({value}){where} — training "
            "diverged; this is a terminal result of the configuration, "
            "not a retryable infrastructure fault"
        )


def check_finite(
    value,
    what: str = "loss",
    *,
    step: Optional[int] = None,
    trial_id: Optional[int] = None,
) -> float:
    """Raise :class:`DivergenceError` if ``value`` is NaN/inf; else
    return it as a float. ``value`` may be a python float or a scalar
    tensor: callers pass something they were already fetching (an epoch
    average, a logged loss), so the check adds no host syncs."""
    v = float(value)
    if not math.isfinite(v):
        raise DivergenceError(what, v, step=step, trial_id=trial_id)
    return v


def guard_finite(
    step_fn: Callable,
    *,
    key: str = "loss",
    every: int = 1,
    what: str = "train loss",
) -> Callable:
    """Wrap ``step(state, *args) -> (state, metrics)`` so a non-finite
    ``metrics[key]`` surfaces as a :class:`DivergenceError` naming the
    optimizer step instead of flowing on as a silent garbage metric.

    The check fetches the metric to host, which synchronizes with the
    device: the price of *any* host-side decision on a device value.
    ``every=N`` checks one step in N (detection lag <= N steps, sync
    cost 1/N).

    For multi-steps whose ``metrics[key]`` is a per-inner-step array, the
    first non-finite entry names the exact inner step.
    """
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    calls = 0

    def guarded(state, *args, **kw):
        nonlocal calls
        new_state, metrics = step_fn(state, *args, **kw)
        calls += 1
        if calls % every == 0:
            vals = np.asarray(
                torch.as_tensor(metrics[key]).detach().cpu(), dtype=np.float64
            ).reshape(-1)
            step_after = int(new_state.step)  # steps applied so far
            bad = np.flatnonzero(~np.isfinite(vals))
            if bad.size:
                # For a (K,) multi-step metric, step numbering is
                # contiguous ending at step_after; entry j corresponds to
                # step step_after - K + 1 + j.
                j = int(bad[0])
                step_no = step_after - len(vals) + 1 + j
                raise DivergenceError(what, float(vals[j]), step=step_no)
        return new_state, metrics

    return guarded
