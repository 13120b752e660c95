"""Telemetry: the port's event bus, metrics registry and exporters against
the JAX package's, and the driver's, supervision's, ledger's, checkpoint
layer's and PBT's events.

On the CPU at batch 16, hidden 16, latent 4, 128 rows:

- the bus copies hold to the originals: the same emits give the same
  records (timestamps aside), sink lines and torn-tail reads;
- one events file the JAX package wrote (an unstacked sweep with a retry, a
  stacked one, PBT generations) through both packages' ``build_trace``,
  ``run_summary`` and ``SweepFold`` gives equal outputs, and one registry
  through both ``prometheus_dump``s the same text;
- per trial, the sequence of event kinds of a port sweep equals the JAX
  package's (timestamps and ids aside) for an unstacked sweep with a retry
  and for a stacked one with a lane fault and a poisoned lane, the compile
  registry's events, ``first_dispatch``'s outcome and the device books'
  ``device_cost`` and ``device_memory`` (with its ``where``) included,
  leaving out the incident plane's kinds (not ported, A.12b), the kinds the
  wall clock decides (a straggler and the capture it opens; their parity on
  the same step times is ``test_torch_anomaly.py``'s) and the JAX
  package's state-init program's events (a program the port does not have:
  its initial weights are eager draws);
- the ledger's, supervision's, checkpoint layer's and PBT's payloads equal
  the JAX package's on the same inputs;
- with telemetry off no event is constructed, and an empty fault plan is
  bit-identical to no plan (checkpoints, replays and host syncs).
"""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multidisttorch_tpu import telemetry as jax_tel
from multidisttorch_tpu.compile.registry import get_executable_registry as jax_executable_registry
from multidisttorch_tpu.data.datasets import synthetic_mnist
from multidisttorch_tpu.faults.plan import FaultPlan as JaxFaultPlan
from multidisttorch_tpu.faults.plan import FaultSpec as JaxFaultSpec
from multidisttorch_tpu.hpo.driver import TrialConfig as JaxTrialConfig
from multidisttorch_tpu.hpo.driver import run_hpo as jax_run_hpo
from multidisttorch_tpu.hpo.ledger import SweepLedger as JaxSweepLedger
from multidisttorch_tpu.hpo.pbt import _emit_generation as jax_emit_generation
from multidisttorch_tpu.hpo.supervision import RetryPolicy as JaxRetryPolicy
from multidisttorch_tpu.hpo.supervision import classify_failure as jax_classify_failure
from multidisttorch_tpu.parallel.cluster import AgreementTimeout as JaxAgreementTimeout
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.telemetry import console as jax_console
from multidisttorch_tpu.telemetry import events as jax_events
from multidisttorch_tpu.telemetry import export as jax_export
from multidisttorch_tpu.telemetry import metrics as jax_metrics
from multidisttorch_tpu.train import checkpoint as jax_ck
from multidisttorch_tpu.train import ckpt_store as jax_ckpt_store
from multidisttorch_tpu.train.guards import DivergenceError as JaxDivergenceError
from multidisttorch_tpu_torch import telemetry
from multidisttorch_tpu_torch.compile.registry import get_executable_registry
from multidisttorch_tpu_torch.faults import CRASH, DIVERGE, FaultPlan, FaultSpec, HostPreemption
from multidisttorch_tpu_torch.hpo import driver, pbt
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
from multidisttorch_tpu_torch.hpo.pbt import PBTConfig, run_pbt
from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy, classify_failure
from multidisttorch_tpu_torch.parallel.cluster import AgreementTimeout
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.telemetry import anomaly, console, device, events, export, metrics
from multidisttorch_tpu_torch.train import checkpoint as ck
from multidisttorch_tpu_torch.train import ckpt_store
from multidisttorch_tpu_torch.train.guards import DivergenceError
from multidisttorch_tpu_torch.train.steps import wrap_step_with_hooks

SMALL = dict(batch_size=16, hidden_dim=16, latent_dim=4, log_interval=10_000)
# Kinds of modules the port has not ported: the incident plane (A.12b; the
# service's own kinds are ported with it, A.12).
UNPORTED_KINDS = re.compile(r"^incident")
# Kinds the wall clock decides: a step slower than its series' median fires
# in one run and not in another.
TIMING_KINDS = {"anomaly_step_straggler", "profiler_capture_started"}


def _unported(e: dict) -> bool:
    """An event the sequences are not compared on: an unported kind, a
    timing-driven one, or the JAX package's state-init program's compile
    events (``SINGLE_INIT``; the port's initial weights are eager host-side
    draws, ROADMAP C.4)."""
    return (bool(UNPORTED_KINDS.match(e["kind"])) or e["kind"] in TIMING_KINDS
            or str((e.get("data") or {}).get("program", "")).startswith("init:"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _telemetry_off_after():
    """Every test leaves both packages' telemetry off."""
    yield
    telemetry.disable()
    jax_tel.disable()


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(128, seed=0), synthetic_mnist(32, seed=1)


def _no_ts(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "ts"}


def _same_json(a, b) -> bool:
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)


# -- the bus ---------------------------------------------------------------


def _emit_script(bus):
    for i in range(6):
        bus.emit("tick", step=i, trial_id=i % 2, lane=i % 3 or None, data_i=i, nested={"a": [i, i + 1]})
    bus.emit("fault_injected", trial_id=3, step=7, fault_kind="crash")
    bus.emit("sweep_end", results=2, statuses={"completed": 2})


@pytest.mark.parametrize("queue_max", [3, 4096])
def test_bus_records_sink_and_torn_tail_match_jax(tmp_path, monkeypatch, queue_max):
    monkeypatch.setenv("MDT_HOST_SLOT", "2")
    got = {}
    for name, mod in (("port", events), ("jax", jax_events)):
        path = str(tmp_path / f"{name}.jsonl")
        bus = mod.configure(path=path, queue_max=queue_max)
        _emit_script(bus)
        recent = [_no_ts(e.to_dict()) for e in bus.recent()]
        stats = (bus.emitted, bus.dropped, bus.host, bus.world)
        mod.disable()
        with open(path, "a") as f:
            f.write('{"kind": "torn", "ts": 1.0, "da')
        got[name] = (recent, stats, [_no_ts(e) for e in mod.read_events(path)],
                     mod.read_events_counting(path)[1])
    assert got["port"] == got["jax"]
    recent, stats, lines, torn = got["port"]
    assert len(recent) == min(queue_max, 8) and stats[:3] == (8, max(0, 8 - queue_max), 2)
    assert len(lines) == 8 and torn == 1 and lines[0]["host"] == 2


def test_bus_survives_sink_failure(tmp_path):
    bus = events.Bus(path=str(tmp_path / "events.jsonl"))
    bus.emit("a")
    bus._sink.close()
    bus.emit("b")  # must not raise; degrades to in-memory only
    assert [e.kind for e in bus.recent()] == ["a", "b"] and bus._sink is None


@pytest.mark.parametrize("fn,args", [
    ("status_glyph", [("completed",), ("retrying",), ("weird",), ("",)]),
    ("fmt_duration", [(None,), (0.95,), (12.34,), (242.0,), (4020.0,)]),
    ("fmt_rate", [(None,), (0.5,), (12.0,), (2500.0,)]),
    ("fmt_bytes", [(None,), (512,), (3500,), (1.2e8,), (1.6e9,), (3e13,)]),
    ("fmt_mfu", [(None,), (0.4321,)]),
    ("fmt_table", [([[1, "ok", 2.5], [10, "DIV", None]], ["trial", "status", "loss"]), ([], ["a"])]),
    ("host_health", [("left", 1.0), ("draining", 1.0), ("up", None), ("up", 5.0), ("up", 1.0)]),
])
def test_console_matches_jax(fn, args):
    for a in args:
        assert getattr(console, fn)(*a) == getattr(jax_console, fn)(*a)


# -- the registry ----------------------------------------------------------


def test_histogram_and_registry_match_jax():
    obs = [0.05, 0.05, 0.5, 5.0, 100.0, 1e-6]
    snaps = []
    for mod in (metrics, jax_metrics):
        h = mod.Histogram(bounds=(0.1, 1.0, 10.0))
        for v in obs:
            h.observe(v)
        reg = mod.MetricsRegistry()
        reg.counter("retries", trial="3").inc()
        reg.counter("retries", trial="3").inc(2)
        reg.gauge("lanes", group="0").set(4)
        reg.gauge("peak").set_max(3)
        reg.gauge("peak").set_max(1)
        hh = reg.histogram("wait_s", key="x")
        for v in obs:
            hh.observe(v, exemplar=f"id{v}")
        snaps.append((h.stats(), [h.percentile(p) for p in (50, 95, 100)], reg.snapshot(),
                      reg.gauge_value("lanes", group="0"), reg.gauge_value("nope")))
    assert _same_json(snaps[0], snaps[1])
    assert snaps[0][2]["counters"]['retries{trial="3"}'] == 3.0


@pytest.mark.parametrize("marks", [
    [dict(), dict(), "open", dict(), dict(steps=2, lanes=3)],
    [dict()] + [dict(steps=2, lanes=3)] * 5,
])
def test_step_series_books_match_jax(marks):
    books = []
    for mod in (metrics, jax_metrics):
        s = mod.StepSeries(sample_every=0)
        ret = []
        for m in marks:
            if m == "open":
                s.open_interval()
            else:
                ret.append(s.mark(**m) is None)
        s.note_wait(0.25, 100)
        snap = s.snapshot()
        books.append((ret, {k: snap[k] for k in ("dispatches", "steps", "lane_steps", "wait_s", "input_bytes")},
                      snap["dispatch"]["count"]))
    assert books[0] == books[1]


def test_synced_mark_goes_to_the_device_book():
    """Every ``sample_every``-th mark waits on its tensor's device and goes
    to the device book, returning None (no straggler sample), as the JAX
    package's ``block_until_ready`` mark does."""
    for mod, value in ((metrics, torch.zeros(())), (jax_metrics, jnp.zeros(()))):
        s = mod.StepSeries(sample_every=1)
        s.mark(value)
        assert s.mark(value) is None and s.device.count == 1 and s.dispatch.count == 0
        s2 = mod.StepSeries(sample_every=0)
        s2.mark(value)
        assert s2.mark(value) is not None


def test_capture_books():
    metrics.record_capture("GraphedMultiStep[K=4]", 0.5, 0.25)  # telemetry off: nothing
    assert metrics.capture_books() == {}
    with telemetry.telemetry_run():
        metrics.record_capture("GraphedMultiStep[K=4]", 0.5, 0.25)
        metrics.record_capture("GraphedMultiStep[K=2]", 0.0, 0.125)
        metrics.record_capture("GraphedMultiStep[K=4]", 0.0, 0.25)
        books = metrics.capture_books()
        snap = telemetry.get_registry().snapshot()["counters"]
    assert books == {"GraphedMultiStep[K=4]": {"captures": 2, "warmup_s": 0.5, "capture_s": 0.5},
                     "GraphedMultiStep[K=2]": {"captures": 1, "warmup_s": 0.0, "capture_s": 0.125}}
    assert snap["compile_count"] == 3 and snap["compile_seconds"] == 1.125


# -- one sweep through both packages ---------------------------------------


def _sweeps(data, tmp_path, *, stacked: bool):
    """The same sweep in both packages under telemetry: unstacked, two trials
    on two groups with a crash and a retry; stacked, five trials on one
    group of four lanes with a lane crash and a poisoned lane. Returns
    ``{name: (events, registry)}``."""
    n, ngroups = (5, 1) if stacked else (2, 2)
    specs = [(CRASH, 2, 9), (DIVERGE, 1, 2)] if stacked else [(CRASH, 0, 10), (DIVERGE, 1, 3)]
    cfgs = [dict(trial_id=i, epochs=2, seed=i, **SMALL) for i in range(n)]
    kw = dict(save_images=False, verbose=False, resilient=True, stack_trials=stacked, stack_max_lanes=4)
    out = {}
    # Both registries start empty, so every first admission compiles.
    jax_executable_registry().reset()
    get_executable_registry().reset()
    with jax_tel.telemetry_run(str(tmp_path / "jax")):
        jax_run_hpo([JaxTrialConfig(**c) for c in cfgs], data[0], data[1],
                    groups=jax_setup_groups(ngroups, devices=jax.devices()[:ngroups]),
                    out_dir=str(tmp_path / "jax" / "out"), retry=JaxRetryPolicy(max_retries=2, backoff_base_s=0.01),
                    fault_plan=JaxFaultPlan(specs=tuple(JaxFaultSpec(k, i, step=s) for k, i, s in specs)), **kw)
        out["jax"] = (jax_events.read_events(str(tmp_path / "jax" / "events.jsonl")), jax_tel.get_registry())
    with telemetry.telemetry_run(str(tmp_path / "port")):
        run_hpo([TrialConfig(**c) for c in cfgs], data[0], data[1],
                groups=setup_groups(ngroups, devices=["cpu"] * ngroups),
                out_dir=str(tmp_path / "port" / "out"), retry=RetryPolicy(max_retries=2, backoff_base_s=0.01),
                fault_plan=FaultPlan(specs=tuple(FaultSpec(k, i, step=s) for k, i, s in specs)), **kw)
        out["port"] = (events.read_events(str(tmp_path / "port" / "events.jsonl")), telemetry.get_registry())
    return out


@pytest.fixture(scope="module")
def sweeps(data, tmp_path_factory):
    return {name: _sweeps(data, tmp_path_factory.mktemp(name), stacked=name == "stacked")
            for name in ("unstacked", "stacked")}


def _kinds(evs, trial_id):
    return [e["kind"] + ("@" + e["data"]["where"] if e["kind"] == "device_memory" else "")
            for e in evs if e.get("trial_id") == trial_id and not _unported(e)]


@pytest.mark.parametrize("name", ["unstacked", "stacked"])
def test_event_kinds_per_trial_match_jax(sweeps, name):
    jev, pev = sweeps[name]["jax"][0], sweeps[name]["port"][0]
    trials = sorted({e["trial_id"] for e in jev if e.get("trial_id") is not None})
    assert trials == sorted({e["trial_id"] for e in pev if e.get("trial_id") is not None})
    for tid in trials + [None]:
        assert _kinds(pev, tid) == _kinds(jev, tid), tid

    def outcomes(evs):
        return [(e.get("trial_id"), e["data"]["outcome"]) for e in evs if e["kind"] == "first_dispatch"]

    assert outcomes(pev) == outcomes(jev)
    assert {"compile_start", "compile_end"} <= {e["kind"] for e in pev}
    kinds = {e["kind"] for e in pev}
    assert {"device_cost", "device_memory"} <= kinds
    if name == "stacked":
        assert {"stack_bucket", "stack_plan", "lane_fault", "lane_refill", "lane_masked", "lane_diverge",
                "lane_retire", "input_wait"} <= kinds
    else:
        assert {"fault_injected", "failure_classified", "retry_scheduled", "ckpt_snapshot", "ckpt_save",
                "ckpt_scan_restore", "epoch", "optimizer_state", "first_dispatch"} <= kinds


@pytest.mark.parametrize("name", ["unstacked", "stacked"])
def test_payloads_of_the_ported_kinds_carry_the_jax_fields(sweeps, name):
    jev, pev = sweeps[name]["jax"][0], sweeps[name]["port"][0]

    def shapes(evs):
        return {(e["kind"], tuple(sorted(e)), tuple(sorted(e.get("data") or {}))) for e in evs
                if not _unported(e)}

    assert shapes(pev) == shapes(jev)


def test_event_ordering_across_retry(sweeps):
    evs = sweeps["unstacked"]["port"][0]
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)
    seq = [(e["kind"], (e.get("data") or {}).get("status")) for e in evs
           if e.get("trial_id") == 0 and e["kind"] in ("attempt_start", "attempt_end", "fault_injected",
                                                          "retry_scheduled")]
    assert seq == [("attempt_start", None), ("fault_injected", None), ("retry_scheduled", None),
                   ("attempt_end", "retrying"), ("attempt_start", None), ("attempt_end", "completed")]


def _pbt_stream():
    """PBT generations as the JAX package emits them."""
    with jax_tel.telemetry_run():
        scores = np.array([3.0, 1.0, np.nan, 2.0])
        jax_emit_generation("fused", 0, scores, np.array([1, 3, 0, 2]), np.array([1e-3, 2e-3, 5e-4, 1e-4]),
                            [{"from": 1, "to": 2, "new_lr": 2.5e-3}], None, 10)
        jax_emit_generation("fused", 1, scores * 2, np.array([1, 0, 3, 2]), np.array([1e-3, 2e-3, 5e-4, 1e-4]),
                            [], np.array([1, 3, 0, 2]), 20)
        return [e.to_dict() for e in jax_tel.get_bus().recent()]


@pytest.mark.parametrize("name", ["unstacked", "stacked", "pbt"])
def test_exporters_match_jax_on_a_jax_written_stream(sweeps, name):
    evs = _pbt_stream() if name == "pbt" else sweeps[name]["jax"][0]
    assert export.build_trace(evs) == jax_export.build_trace(evs)
    assert _same_json(export.run_summary(evs, None), jax_export.run_summary(evs, None))
    folds = []
    for mod in (export, jax_export):
        fold = mod.SweepFold()
        for ev in evs:
            fold.feed(ev)
        folds.append((vars(fold), fold.goodput, fold.tenant_books()))
    assert _same_json(folds[0], folds[1])
    if name == "pbt":
        assert folds[0][0]["pbt"]["exploit_total"] == 1
    else:
        assert folds[0][1] is not None and any(k.startswith("device_") for k in folds[0][0]["by_kind"])


def _copy_registry(src, dst):
    for kind, name, labels, obj in src.series_items():
        lab = dict(labels)
        if kind == "counter":
            dst.counter(name, **lab).value = obj.value
        elif kind == "gauge":
            dst.gauge(name, **lab).value = obj.value
        elif kind == "histogram":
            h = dst.histogram(name, bounds=obj.bounds, **lab)
            h.counts, h.count, h.sum, h.max = list(obj.counts), obj.count, obj.sum, obj.max
        else:
            s = dst.step_series(lab["key"])
            for f in ("dispatches", "steps", "lane_steps", "total_s", "wait_s", "input_bytes"):
                setattr(s, f, getattr(obj, f))
            for f in ("dispatch", "device"):
                a, b = getattr(obj, f), getattr(s, f)
                b.counts, b.count, b.sum, b.max = list(a.counts), a.count, a.sum, a.max


@pytest.mark.parametrize("name", ["unstacked", "stacked"])
def test_prometheus_dump_matches_jax_on_a_jax_registry(sweeps, name):
    jreg = sweeps[name]["jax"][1]
    preg = metrics.MetricsRegistry()
    _copy_registry(jreg, preg)
    text = export.prometheus_dump(preg)
    assert text == jax_export.prometheus_dump(jreg)
    assert _same_json(preg.snapshot(), jreg.snapshot())
    assert "mdt_step_lane_steps" in text and "mdt_executed_steps_total" in text


_PROM_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+informna]+$")
_PROM_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)$")


def test_a_port_runs_exports(sweeps, tmp_path):
    evs, reg = sweeps["unstacked"]["port"]
    paths = export.export_all(str(tmp_path), evs, registry=reg)
    with open(paths["trace"]) as f:
        trace = json.load(f)
    tevs = trace["traceEvents"]
    ts = [e["ts"] for e in tevs if "ts" in e]
    assert ts == sorted(ts) and all(t >= 0 for t in ts)
    names = {e["args"]["name"] for e in tevs if e.get("name") == "thread_name"}
    assert {"driver", "trial 0", "trial 1"} <= names
    faults = {e["args"]["fault_kind"]: e["tid"] for e in tevs if e.get("name") == "fault_injected"}
    assert faults == {"crash": 1, "diverge": 2}  # tid = trial_id + 1
    with open(paths["prometheus"]) as f:
        lines = f.read().strip().splitlines()
    assert all((_PROM_TYPE if ln.startswith("#") else _PROM_SAMPLE).match(ln) for ln in lines)
    with open(paths["summary"]) as f:
        summary = json.load(f)
    t0 = summary["trials"]["0"]
    assert t0["attempts"] == 2 and t0["retries"] == 1 and t0["status"] == "completed"
    assert summary["trials"]["1"]["status"] == "diverged"
    assert summary["executed_steps"] >= summary["useful_steps"] > 0 and 0 < summary["goodput"] <= 1.0
    assert "metrics" in summary and t0["mfu"] is None and "peak FLOP/s" in t0["mfu_reason"]
    assert t0["device_series"] == "trial-0" and t0["peak_memory_bytes"] > 0
    # On the CPU nothing is captured: no capture books. An epoch's opening
    # mark closes no interval, nor does the mark after each attempt's
    # counted step (it re-opens the interval, as the JAX package's cost
    # analysis does): trial 0 dispatched 8 + 2 chunks (the crash at step
    # 10), then 8 after its retry; trial 1 one epoch of 8.
    assert metrics.capture_books(reg) == {}
    series = reg.snapshot()["step_series"]
    assert {k: series[k]["steps"] for k in series} == {"trial-0": 6 + 1 + 6, "trial-1": 6}
    assert series["trial-0"]["dispatch"]["count"] == 13 and series["trial-0"]["total_s"] > 0


# -- the seams' payloads against the JAX package's ---------------------------


def test_ledger_events_and_goodput_counters_match_jax(tmp_path):
    got = {}
    for name, tel, led_cls in (("port", telemetry, SweepLedger), ("jax", jax_tel, JaxSweepLedger)):
        with tel.telemetry_run():
            led = led_cls(str(tmp_path / name))
            led.attempt_start(0, "aaaa", 1)
            led.attempt_end(0, "aaaa", 1, "retrying", error="boom",
                            summary={"resumed_from_step": 0, "steps_at_failure": 5})
            led.attempt_start(0, "aaaa", 2, tenant="t1", priority=2)
            led.attempt_end(0, "aaaa", 2, "completed", summary={"steps": 16, "resumed_from_step": 8})
            led.attempt_start(1, "bbbb", 1)
            led.attempt_end(1, "bbbb", 1, "diverged", summary={"steps": 4})
            got[name] = ([_no_ts(e.to_dict()) for e in tel.get_bus().recent() if e.kind.startswith("attempt")],
                         tel.get_registry().snapshot()["counters"])
    assert got["port"] == got["jax"]
    assert got["port"][1]["useful_steps_total"] == 20 and got["port"][1]["retries_total"] == 1


@pytest.mark.parametrize("make", [
    lambda m: RuntimeError("worker died"),
    lambda m: (m["div"])("epoch average train loss", float("nan"), step=3, trial_id=1),
    lambda m: (m["agree"])("agreement expired"),
    lambda m: TimeoutError("nfs hiccup"),
], ids=["infra", "divergence", "agreement", "timeout"])
def test_failure_classified_matches_jax(make):
    got = []
    for tel, fn, mods in ((telemetry, classify_failure, {"div": DivergenceError, "agree": AgreementTimeout}),
                          (jax_tel, jax_classify_failure, {"div": JaxDivergenceError, "agree": JaxAgreementTimeout})):
        with tel.telemetry_run():
            cls = fn(make(mods), trial_id=4)
            got.append((cls, [_no_ts(e.to_dict()) for e in tel.get_bus().recent()
                              if not UNPORTED_KINDS.match(e.kind)]))
    assert got[0] == got[1] and got[0][1][0]["kind"] == "failure_classified"


def test_checkpoint_scan_and_gc_events_match_jax(tmp_path):
    tree = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}, "step": np.int32(8)}
    src = tmp_path / "src" / "trial-0"
    path = str(src / "state.msgpack")
    with telemetry.telemetry_run():
        for step in (8, 16):
            ck.save_state(dict(tree, step=np.int32(step)), path, metadata={"step": step, "completed_epochs": step // 8},
                          keep_last=2, format="v2")
        saves = [_no_ts(e.to_dict()) for e in telemetry.get_bus().recent()]
    assert [e["kind"] for e in saves] == ["ckpt_save", "ckpt_save"] and saves[1]["data"]["format"] == "v2"
    with open(path, "r+b") as f:  # the primary rots
        f.seek(10)
        f.write(b"\xff" * 8)
    got = []
    for name, tel, ckmod, storemod in (("port", telemetry, ck, ckpt_store), ("jax", jax_tel, jax_ck, jax_ckpt_store)):
        root = tmp_path / name
        shutil.copytree(str(tmp_path / "src"), str(root))
        with tel.telemetry_run():
            cands = ckmod.valid_candidates_by_step(str(root / "trial-0" / "state.msgpack"),
                                                   accept_meta=lambda m: m["step"] < 16)
            storemod.sweep_ckpt_dir(str(root / "trial-0"), grace_s=0.0)
            evs = json.dumps([_no_ts(e.to_dict()) for e in tel.get_bus().recent()
                              if not UNPORTED_KINDS.match(e.kind)]).replace(str(root), "<root>")
            got.append((sorted(cands), json.loads(evs)))
    assert got[0] == got[1]
    assert [e["kind"] for e in got[0][1]] == ["ckpt_scan_reject", "ckpt_scan_reject", "ckpt_gc"]
    assert got[0][0] == [8] and got[0][1][0]["data"]["reason"].startswith("crc32 mismatch")


def test_pbt_events_match_jax(data):
    """Each mode's ``pbt_gen``/``pbt_exploit`` events equal what the JAX
    package's ``_emit_generation`` emits for the port's own generations."""
    cfg = PBTConfig(population=4, generations=3, steps_per_generation=4, batch_size=16, hidden_dim=16,
                    latent_dim=4, seed=1, lr_min=1e-4, lr_max=1e-1)
    for fused, mode in ((True, "fused"), (False, "submesh")):
        with telemetry.telemetry_run():
            res = run_pbt(cfg, data[0], data[1], fused=fused, verbose=False, device="cpu")
            mine = [_no_ts(e.to_dict()) for e in telemetry.get_bus().recent() if e.kind.startswith("pbt_")]
        with jax_tel.telemetry_run():
            prev = None
            for g, rec in enumerate(res.history):
                scores = np.array([rec["scores"][i] for i in range(cfg.population)])
                after = res.history[g + 1]["lrs"] if g + 1 < len(res.history) else dict(enumerate(res.final_lrs))
                lrs = np.array([after[i] for i in range(cfg.population)], np.float32)
                jax_emit_generation(mode, g, scores, np.array(rec["order"]), lrs, rec["exploits"], prev,
                                    (g + 1) * cfg.steps_per_generation)
                prev = np.array(rec["order"])
            ref = [_no_ts(e.to_dict()) for e in jax_tel.get_bus().recent() if e.kind.startswith("pbt_")]
        assert mine == ref and sum(e["kind"] == "pbt_gen" for e in mine) == cfg.generations
        if fused:
            assert res.dispatch_book["host_fetches"] == cfg.generations


# -- off, and an empty plan ------------------------------------------------


class _Boom:
    def __init__(self, *a, **kw):
        raise AssertionError("telemetry object constructed with telemetry off")


def test_telemetry_off_constructs_no_events(data, tmp_path, monkeypatch):
    assert telemetry.get_bus() is None and telemetry.get_registry() is None
    monkeypatch.setattr(events, "Event", _Boom)
    monkeypatch.setattr(metrics, "StepSeries", _Boom)
    monkeypatch.setattr(metrics, "record_capture", _Boom)
    monkeypatch.setattr(anomaly, "AnomalyMonitor", _Boom)
    monkeypatch.setattr(device, "_StepCounter", _Boom)
    monkeypatch.setattr(device, "_live_tensor_bytes", _Boom)
    cfgs = [TrialConfig(trial_id=i, epochs=1, seed=i, **SMALL) for i in range(3)]
    plan = FaultPlan(specs=(FaultSpec(CRASH, 0, step=2),))
    for stacked in (False, True):
        results = run_hpo(cfgs, data[0], data[1], groups=setup_groups(1, devices=["cpu"]),
                          out_dir=str(tmp_path / str(stacked)), save_images=False, verbose=False, resilient=True,
                          retry=RetryPolicy(max_retries=1, backoff_base_s=0.0), fault_plan=plan,
                          stack_trials=stacked, stack_max_lanes=2)
        assert [r.status for r in results] == ["completed"] * 3
    run_pbt(PBTConfig(population=2, generations=1, steps_per_generation=2, batch_size=16, hidden_dim=16,
                      latent_dim=4), data[0], data[1], fused=True, verbose=False, device="cpu")
    assert telemetry.get_bus() is None


@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
def test_empty_plan_is_bit_identical_to_no_plan(data, tmp_path, stacked):
    cfgs = [TrialConfig(trial_id=i, epochs=2, seed=i, fused_steps=3, **SMALL) for i in range(3)]
    runs = []
    for plan in (None, FaultPlan(specs=())):
        out = tmp_path / str(plan is None)
        res = run_hpo(cfgs, data[0], data[1], groups=setup_groups(1, devices=["cpu"]), out_dir=str(out),
                      save_images=False, verbose=False, fault_plan=plan, stack_trials=stacked, stack_max_lanes=2)
        trees = [ck._read_tree(os.path.join(str(out), f"trial-{i}", "state.msgpack")) for i in range(3)]
        runs.append(([(r.final_train_loss, r.final_test_loss, r.steps, r.graph_replays, r.host_syncs, r.history)
                      for r in res], trees))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert _same_json(jax.tree.map(lambda x: np.asarray(x).tolist(), a),
                          jax.tree.map(lambda x: np.asarray(x).tolist(), b))


# -- scope, env and seams --------------------------------------------------


def test_telemetry_scope_env_and_unported_options(tmp_path, monkeypatch):
    """The scope, the env switch, and the anomaly options configuring the
    monitor as the JAX package's do (no option raises any more)."""
    with telemetry.telemetry_run(str(tmp_path / "a")) as bus:
        assert telemetry.enabled() and bus is telemetry.get_bus() and telemetry.get_registry() is not None
        assert telemetry.get_monitor() is not None and telemetry.get_monitor().config == telemetry.AnomalyConfig()
        bus.emit("x")
    assert not telemetry.enabled() and telemetry.get_registry() is None and telemetry.get_monitor() is None
    assert [e["kind"] for e in telemetry.read_events(str(tmp_path / "a" / telemetry.EVENTS_NAME))] == ["x"]
    for kw in (dict(anomaly=telemetry.AnomalyConfig(z_threshold=3.0)), dict(anomaly_capture_dir=str(tmp_path)),
               dict(anomaly=telemetry.AnomalyConfig(z_threshold=3.0), anomaly_capture_dir=str(tmp_path))):
        configs = []
        for tel in (telemetry, jax_tel):
            tel.configure(**{k: (jax_tel.AnomalyConfig(**vars(v)) if tel is jax_tel and k == "anomaly" else v)
                             for k, v in kw.items()})
            configs.append(vars(tel.get_monitor().config))
            tel.disable()
        assert configs[0] == configs[1]
        assert configs[0]["capture_dir"] == kw.get("anomaly_capture_dir")
    assert telemetry.configure_from_env() is False
    monkeypatch.setenv("MDT_TELEMETRY", "1")
    monkeypatch.setenv("MDT_TELEMETRY_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert telemetry.configure_from_env() is True
    telemetry.get_bus().emit("y")
    telemetry.disable()
    assert os.listdir(str(tmp_path / "env")) == ["events.p1.jsonl"]
    monkeypatch.setenv("MDT_TELEMETRY_CAPTURE", "1")
    assert telemetry.configure_from_env() is True
    assert telemetry.get_monitor().config.capture_dir == os.path.join(str(tmp_path / "env"), "anomaly_traces")
    telemetry.disable()
    assert telemetry.get_monitor() is None


def test_wrap_step_with_hooks_keeps_the_step():
    class Step:
        graphed, replays, captures = True, 7, 2

        def __call__(self, state, batch, generator=None):
            return state, batch

    step = Step()
    assert wrap_step_with_hooks(step) is step
    seen = []
    hooked = wrap_step_with_hooks(step, before=lambda b: seen.append(b.shape[0]),
                                  transform_batch=lambda b: b * 2)
    assert hooked.__wrapped__ is step and (hooked.graphed, hooked.replays, hooked.captures) == (True, 7, 2)
    step.replays = 9
    assert hooked.replays == 9
    assert torch.equal(hooked("s", torch.ones(3), generator=None)[1], torch.full((3,), 2.0)) and seen == [3]

    def boom(b):
        raise HostPreemption("gone")

    called = []
    guarded = wrap_step_with_hooks(lambda s, b: called.append(1), before=boom)
    with pytest.raises(HostPreemption):
        guarded("s", torch.ones(1))
    assert not called  # a hook that raises leaves nothing dispatched


def test_the_driver_reads_replays_through_the_wrapper(data, tmp_path):
    plan = FaultPlan(specs=(FaultSpec(CRASH, 5, step=0),))  # armed, never due
    run = driver._TrialRun(setup_groups(1, devices=["cpu"])[0], TrialConfig(trial_id=0, epochs=1, **SMALL),
                           data[0], None, str(tmp_path), save_checkpoint=False, verbose=False,
                           injector=driver.FaultInjector(plan))
    gen = run.run()
    next(gen)  # admission (the train program arrives here) and the first chunk
    assert run.multi_step.__wrapped__ is not None and run.multi_step.graphed is False
    for _ in gen:
        pass
    assert run.result.graph_replays == 0 and run.result.steps == 8
    assert pbt._emit_generation is not None
