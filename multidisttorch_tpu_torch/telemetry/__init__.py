"""Sweep-wide telemetry: structured events, metrics, exporters.

Counterpart of the JAX package's ``telemetry/`` package, first part
(ROADMAP A.10):

- :mod:`~multidisttorch_tpu_torch.telemetry.events`: the process-local
  typed **event bus** with a bounded in-memory queue and an append-only
  JSONL sink (a copy of the JAX package's). The driver, supervision, the
  ledger, the checkpoint layer, fault injection and PBT emit through it,
  from host-side seams only, never inside a captured graph.
- :mod:`~multidisttorch_tpu_torch.telemetry.metrics`: counters, gauges,
  fixed-bucket histograms; per-trial/per-bucket step timing with sparse
  device-inclusive samples; what each CUDA-graph capture cost.
- :mod:`~multidisttorch_tpu_torch.telemetry.export`: the Perfetto trace
  (one track per trial), the Prometheus-style dump and the run summary.
- :mod:`~multidisttorch_tpu_torch.telemetry.console`: terminal formatting.

Not ported here: the device books and the anomaly monitor (ROADMAP A.10,
second part: ``anomaly=`` raises), the fleet merge (A.11), and the
incident plane and control-plane profiler (A.12), so the bus has no tap.

**Zero cost when off**: telemetry is disabled by default. Every hot-path
seam is written as ``bus = get_bus(); if bus is not None: bus.emit(...)``:
with telemetry off ``get_bus()`` returns ``None``, no event object is
constructed, and no seam adds a host sync. When on, only ``StepSeries``'
sampled marks wait on the device.

Enable programmatically::

    from multidisttorch_tpu_torch import telemetry
    with telemetry.telemetry_run("out/telemetry"):
        run_hpo(...)

or by environment (picked up at sweep start): ``MDT_TELEMETRY=1``
[+ ``MDT_TELEMETRY_DIR=<dir>``].
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

from multidisttorch_tpu_torch.telemetry import events as _events
from multidisttorch_tpu_torch.telemetry import metrics as _metrics

get_bus = _events.get_bus
get_registry = _metrics.get_registry
read_events = _events.read_events
EVENTS_NAME = _events.EVENTS_NAME

_ANOMALY_ITEM = "ROADMAP A.10, second part (telemetry/anomaly.py and the device books)"


def enabled() -> bool:
    """Whether telemetry is currently on (bus exists)."""
    return _events.get_bus() is not None


def _process_identity() -> tuple[int, int]:
    """``(num_processes, process_id)`` without bringing anything up: an
    initialised ``torch.distributed`` world, else the launcher's env."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    from multidisttorch_tpu_torch.parallel.cluster import detect_process_env

    penv = detect_process_env()
    return penv.num_processes, penv.process_id


def configure(
    out_dir: Optional[str] = None,
    *,
    queue_max: int = 4096,
    device_sample_every: int = 100,
    anomaly=None,
    anomaly_capture_dir: Optional[str] = None,
    host: Optional[int] = None,
    world: Optional[int] = None,
) -> None:
    """Turn telemetry ON: create the event bus (JSONL sink under
    ``out_dir`` when given, in-memory only otherwise) and the metrics
    registry. In a multi-process world each process writes a sink of its
    own, ``events.p{rank}.jsonl``. ``host``/``world`` are the fleet tags
    stamped on every event (default from ``MDT_HOST_SLOT`` /
    ``MDT_WORLD_EPOCH``; unset means an untagged single-host stream).
    ``anomaly=`` and ``anomaly_capture_dir=`` raise ``NotImplementedError``
    (ROADMAP A.10, second part)."""
    if anomaly is not None or anomaly_capture_dir is not None:
        raise NotImplementedError(f"telemetry anomaly detection is not ported yet: {_ANOMALY_ITEM}")
    path = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        name = _events.EVENTS_NAME
        # Independent handles on one file in a shared directory would
        # interleave their bytes: one sink per process.
        num_processes, process_id = _process_identity()
        if num_processes > 1:
            name = f"events.p{process_id}.jsonl"
        path = os.path.join(out_dir, name)
    _events.configure(path=path, queue_max=queue_max, host=host, world=world)
    _metrics.configure(device_sample_every=device_sample_every)


def disable() -> None:
    """Turn telemetry OFF (close the sink, drop bus and registry)."""
    _events.disable()
    _metrics.disable()


def configure_from_env() -> bool:
    """Enable telemetry when ``MDT_TELEMETRY`` is truthy (dir from
    ``MDT_TELEMETRY_DIR``, default ``telemetry/``). Called once at sweep
    start by the HPO driver. Already-configured telemetry is left alone:
    an explicit :func:`configure` wins over the env."""
    if enabled():
        return True
    flag = os.environ.get("MDT_TELEMETRY", "").strip().lower()
    if flag in ("", "0", "false", "off"):
        return False
    cap = os.environ.get("MDT_TELEMETRY_CAPTURE", "").strip().lower()
    if cap not in ("", "0", "false", "off"):
        raise NotImplementedError(f"MDT_TELEMETRY_CAPTURE (anomaly-triggered capture) is not ported yet: "
                                  f"{_ANOMALY_ITEM}")
    configure(os.environ.get("MDT_TELEMETRY_DIR", "telemetry"))
    return True


@contextlib.contextmanager
def telemetry_run(out_dir: Optional[str] = None, **kwargs):
    """Scope telemetry to a block: configure on entry, disable on exit
    (nesting telemetry runs is not a supported shape)."""
    configure(out_dir, **kwargs)
    try:
        yield _events.get_bus()
    finally:
        disable()


__all__ = [
    "EVENTS_NAME",
    "configure",
    "configure_from_env",
    "disable",
    "enabled",
    "get_bus",
    "get_registry",
    "read_events",
    "telemetry_run",
]
