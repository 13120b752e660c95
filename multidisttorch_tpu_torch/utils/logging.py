"""Group-aware logging: exactly one log line per trial group.

Counterpart of ``multidisttorch_tpu/utils/logging.py``. A line is printed
by the process that owns the group's first rank, prefixed
``[process:0]`` exactly as the JAX package prefixes it, so a job with N
groups emits N lines per call site. The process index comes from
``torch.distributed`` when it is initialised, else 0.

Emission goes through the stdlib logger ``multidisttorch_tpu_torch``, whose
default level is ``DEBUG``; the driver tags per-step lines ``DEBUG`` and
per-trial lines ``INFO``, so raising the level to ``INFO`` silences step
chatter (and the device sync each such line costs).
"""

from __future__ import annotations

import logging
import sys

import torch.distributed as dist

LOGGER_NAME = "multidisttorch_tpu_torch"


class _StdoutHandler(logging.Handler):
    """Writes bare messages to the current ``sys.stdout`` (looked up at
    emit time, so pytest capture and redirection keep working)."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            print(self.format(record), file=sys.stdout)
        except Exception:  # noqa: BLE001 — logging must not raise
            self.handleError(record)


def _get_logger() -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    if not any(isinstance(h, _StdoutHandler) for h in logger.handlers):
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
        if logger.level == logging.NOTSET:
            logger.setLevel(logging.DEBUG)
    return logger


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` world, else 0."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def log0_enabled(level: int = logging.INFO) -> bool:
    """Whether a ``log0(..., level=level)`` call would emit (process
    gating aside): hot loops check this before paying for the line's
    inputs."""
    return _get_logger().isEnabledFor(level)


def log0(*args, trial=None, level: int = logging.INFO) -> bool:
    """Print once per group; returns whether this process printed.

    With ``trial=None`` only process 0 prints. With a trial group
    (``parallel.mesh.TrialGroup``), the process owning the group's first
    rank prints.
    """
    logger = _get_logger()
    if not logger.isEnabledFor(level):
        return False
    pid = process_index()
    owner = 0 if trial is None else trial.owner_process
    if pid != owner:
        return False
    logger.log(level, f"[{pid}:0] " + " ".join(map(str, args)))
    return True
