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
- :mod:`~multidisttorch_tpu_torch.telemetry.device`: the device books
  (each trial's and bucket's counted FLOPs and bytes per lane-step, MFU
  against the card's peak, a roofline verdict, memory watermarks).
- :mod:`~multidisttorch_tpu_torch.telemetry.anomaly`: the online anomaly
  monitor (stragglers, loss plateaus, divergence precursors) and its
  bounded profiler capture.
- :mod:`~multidisttorch_tpu_torch.telemetry.console`: terminal formatting.
- :mod:`~multidisttorch_tpu_torch.telemetry.fleet`: the fleet merge of an
  elastic sweep's per-host, per-world shards (skew-corrected timeline,
  fleet trace, restart tax, ``fleet_summary.json``).

- :mod:`~multidisttorch_tpu_torch.telemetry.ctlprof`: the control-plane
  profiler (the sweep service's phase books, pass ring and sampler), on the
  same switch; :mod:`~multidisttorch_tpu_torch.telemetry.slo` and
  :mod:`~multidisttorch_tpu_torch.telemetry.trace`: the service's SLO
  engine and submission traces.

- :mod:`~multidisttorch_tpu_torch.telemetry.incident`: the incident plane
  (the flight ring, the root-cause detector, the incident ledger and
  bundles, the offline autopsy). It rides the same switch: ``configure``
  installs its tap on the bus, so every event passes through the ring and
  the detector, and the ledger and bundles land beside the event stream.
  Not ported (ROADMAP A.12b): the autopsy's fabric surface.

**Zero cost when off**: telemetry is disabled by default. Every hot-path
seam is written as ``bus = get_bus(); if bus is not None: bus.emit(...)``:
with telemetry off ``get_bus()`` returns ``None``, no event object is
constructed, no monitor or book object exists, and no seam adds a host
sync. When on, only ``StepSeries``' sampled marks wait on the device.

Enable programmatically::

    from multidisttorch_tpu_torch import telemetry
    with telemetry.telemetry_run("out/telemetry"):
        run_hpo(...)

or by environment (picked up at sweep start): ``MDT_TELEMETRY=1``
[+ ``MDT_TELEMETRY_DIR=<dir>``; ``MDT_TELEMETRY_CAPTURE=1`` arms the
anomaly-triggered profiler capture under ``<dir>/anomaly_traces``].
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

from multidisttorch_tpu_torch.telemetry import anomaly as _anomaly
from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof
from multidisttorch_tpu_torch.telemetry import events as _events
from multidisttorch_tpu_torch.telemetry import incident as _incident
from multidisttorch_tpu_torch.telemetry import metrics as _metrics

get_bus = _events.get_bus
get_registry = _metrics.get_registry
get_ctlprof = _ctlprof.get_ctlprof
get_monitor = _anomaly.get_monitor
get_flight_ring = _incident.get_flight_ring
get_incident_detector = _incident.get_detector
AnomalyConfig = _anomaly.AnomalyConfig
read_events = _events.read_events
EVENTS_NAME = _events.EVENTS_NAME
INCIDENTS_NAME = _incident.INCIDENTS_NAME


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
    anomaly: Optional["AnomalyConfig"] = None,
    anomaly_capture_dir: Optional[str] = None,
    host: Optional[int] = None,
    world: Optional[int] = None,
) -> None:
    """Turn telemetry ON: create the event bus (JSONL sink under
    ``out_dir`` when given, in-memory only otherwise), the incident plane
    (its ledger and bundles under ``out_dir`` too), the metrics
    registry and the anomaly monitor (``anomaly=`` tunes its thresholds;
    ``anomaly_capture_dir=`` also arms the bounded profiler capture, off by
    default since a process holds one profiler session at a time). In a
    multi-process world each process writes a sink of its own,
    ``events.p{rank}.jsonl``. ``host``/``world`` are the fleet tags stamped
    on every event (default from ``MDT_HOST_SLOT`` / ``MDT_WORLD_EPOCH``;
    unset means an untagged single-host stream)."""
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
    bus = _events.configure(path=path, queue_max=queue_max, host=host, world=world)
    # The incident plane rides the same switch: the flight ring and the
    # detector tap every emit, and the ledger and bundles land beside the
    # event stream. The tap goes on after the detector exists, so no emit
    # sees a half-armed plane.
    bus.tap = _incident.configure(out_dir, host=bus.host)
    reg = _metrics.configure(device_sample_every=device_sample_every)
    # The control-plane profiler rides the same switch: its wall histograms
    # are registry series; its flame file (MDT_CTLPROF_SAMPLE_HZ) lands
    # beside the event stream.
    _ctlprof.configure(registry=reg,
                       flame_path=os.path.join(out_dir, "ctl_flame.txt") if out_dir is not None else None)
    if anomaly_capture_dir is not None:
        anomaly = dataclasses.replace(anomaly or _anomaly.AnomalyConfig(), capture_dir=anomaly_capture_dir)
    _anomaly.configure(anomaly)


def disable() -> None:
    """Turn telemetry OFF (close the sink, stop any profiler window, drop
    bus, registry, anomaly monitor, flight ring, incident detector and
    control-plane profiler)."""
    _anomaly.disable()
    _ctlprof.disable()
    _events.disable()
    _incident.disable()
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
    out_dir = os.environ.get("MDT_TELEMETRY_DIR", "telemetry")
    # MDT_TELEMETRY_CAPTURE=1 also arms the anomaly-triggered profiler
    # windows (traces under {dir}/anomaly_traces). Off by default: one
    # profiler session per process, and an explicit profile_dir= must win.
    cap = os.environ.get("MDT_TELEMETRY_CAPTURE", "").strip().lower()
    configure(
        out_dir,
        anomaly_capture_dir=(
            os.path.join(out_dir, "anomaly_traces") if cap not in ("", "0", "false", "off") else None
        ),
    )
    return True


def export_run() -> Optional[dict]:
    """Write the live run's Perfetto trace, Prometheus dump and run summary
    (``telemetry/export.py::export_all``, device books included) beside its
    event sink, reading the sink's own file; the paths, or None when
    telemetry is off, has no sink, or is one process's sink of several
    (``telemetry/fleet.py::export_fleet`` merges those). The examples call it after their
    sweep, so an ``MDT_TELEMETRY=1`` run leaves its summary in
    ``MDT_TELEMETRY_DIR``."""
    bus = _events.get_bus()
    if bus is None or bus.path is None or os.path.basename(bus.path) != EVENTS_NAME:
        return None
    from multidisttorch_tpu_torch.telemetry import export

    out_dir = os.path.dirname(bus.path)
    return export.export_all(out_dir, _events.read_events(bus.path), registry=_metrics.get_registry())


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
    "INCIDENTS_NAME",
    "AnomalyConfig",
    "configure",
    "configure_from_env",
    "disable",
    "enabled",
    "export_run",
    "get_bus",
    "get_flight_ring",
    "get_incident_detector",
    "get_monitor",
    "get_registry",
    "get_ctlprof",
    "read_events",
    "telemetry_run",
]
