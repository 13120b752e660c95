"""The port's load generator and scenario zoo (``service/loadgen.py``, a copy
of the JAX package's with the imports renamed) held to the JAX module, and
the fabric drill's load-generator and scenario phases.

The simulator is pure Python and numpy on one seed, so the port's reports
must equal the JAX module's key by key. The only keys left out read the
wall clock: ``wall_s``, ``submissions_per_wall_s``, ``ctl_passes_per_s``
and the control-plane profiler's ``ctl`` / ``ctl_trace`` books. Then the
JAX package's own tests of the module (``tests/test_fabric.py``,
``tests/test_topology.py``, ``tests/test_trace.py``, ``tests/test_ctlprof.py``),
each with the same assertions over the port's module.
"""

import pytest

from multidisttorch_tpu.service import loadgen as jax_loadgen
from multidisttorch_tpu_torch.service import fabric_drill
from multidisttorch_tpu_torch.service import loadgen
from multidisttorch_tpu_torch.service.scheduler import PreemptionPolicy
from multidisttorch_tpu_torch.telemetry import ctlprof
from multidisttorch_tpu_torch.telemetry import slo as tslo

WALL_CLOCK_KEYS = {"wall_s", "submissions_per_wall_s", "ctl_passes_per_s", "ctl", "ctl_trace"}


def _no_wall(x):
    if isinstance(x, dict):
        return {k: _no_wall(v) for k, v in x.items() if k not in WALL_CLOCK_KEYS}
    if isinstance(x, (list, tuple)):
        return [_no_wall(v) for v in x]
    return x


def _spec(module, kw):
    kw = dict(kw)
    if kw.pop("no_preempt", False):
        from multidisttorch_tpu.service.scheduler import PreemptionPolicy as JaxPreemptionPolicy

        policy = PreemptionPolicy if module is loadgen else JaxPreemptionPolicy
        kw["preempt"] = policy(enabled=False)
    return module.LoadSpec(**kw)


@pytest.mark.parametrize("kw", [
    dict(n_submissions=3000, seed=0),
    dict(n_submissions=3000, seed=1),
    dict(n_submissions=2000, seed=2, deadline_frac=0.0),
    dict(n_submissions=1500, seed=3, deadline_frac=0.25, sizes=((1, 0.3), (2, 0.3), (4, 0.4)), slack_lo=1.5,
         slack_hi=3.0, utilization=2.0, no_preempt=True),
], ids=["seed0", "seed1", "no_deadlines", "whales_no_preemption"])
def test_run_loadgen_equals_jax(kw):
    got = loadgen.run_loadgen(_spec(loadgen, kw))
    want = jax_loadgen.run_loadgen(_spec(jax_loadgen, kw))
    assert got["submitted"] == kw["n_submissions"]
    assert _no_wall(got) == _no_wall(want)


@pytest.mark.parametrize("name", sorted(jax_loadgen.FABRIC_SCENARIOS))
def test_fabric_scenario_equals_jax(name):
    got = loadgen.run_fabric_scenario(name, n_submissions=1500, seed=3)
    want = jax_loadgen.run_fabric_scenario(name, n_submissions=1500, seed=3)
    assert set(got) == set(want) and {"dynamic", "static"} <= set(got)
    assert _no_wall(got) == _no_wall(want)


@pytest.mark.parametrize("name", jax_loadgen.zoo_names())
def test_zoo_scenario_equals_jax(name):
    got = loadgen.run_scenario(name, n_submissions=1500)
    want = jax_loadgen.run_scenario(name, n_submissions=1500)
    for key in ("protocol", "scenario", "kind", "seed", "spec", "report", "slo", "gates"):
        assert _no_wall(got[key]) == _no_wall(want[key]), key
    assert set(got) == set(want)
    assert set(got["headline"]) == set(want["headline"])
    assert _no_wall(got["headline"]) == _no_wall(want["headline"])


def test_registries_equal_jax():
    assert loadgen.zoo_names() == jax_loadgen.zoo_names()
    assert loadgen.FABRIC_SCENARIOS == jax_loadgen.FABRIC_SCENARIOS
    assert loadgen.SCENARIOS == jax_loadgen.SCENARIOS
    assert loadgen.VIRTUAL_LATENCY_BUCKETS == jax_loadgen.VIRTUAL_LATENCY_BUCKETS
    assert loadgen.ZOO_POOL_DEFAULT_N == jax_loadgen.ZOO_POOL_DEFAULT_N
    ours, theirs = loadgen.default_loadgen_slos(), jax_loadgen.default_loadgen_slos()
    assert [vars(s) for s in ours] == [vars(s) for s in theirs]
    for name in loadgen.zoo_names():
        ent = loadgen.SCENARIOS[name]
        if ent["kind"] == "pool":
            assert [vars(s) for s in loadgen._scenario_slos(ent)] == \
                [vars(s) for s in jax_loadgen._scenario_slos(jax_loadgen.SCENARIOS[name])]


# -- the JAX package's tests of the module, over the port's ---------------


def test_loadgen_contracts_and_budget():
    sim = loadgen._Sim(loadgen.LoadSpec(n_submissions=6000, seed=1))
    r = sim.run()
    assert r["zero_lost"]
    assert r["completed"] == r["admitted"]
    assert r["submitted"] == 6000
    # Small-n fairness is noisy; the 10 % gate belongs to the large runs.
    assert r["fairness"]["max_abs_ratio_error"] is not None
    assert r["fairness"]["max_abs_ratio_error"] < 0.25
    assert r["placement_latency_s"]["count"] == r["admitted"]
    assert 0.0 <= r["deadline"]["hit_rate"] <= 1.0
    # The anti-thrash budget holds for every simulated trial.
    cap = sim.preempt.max_preemptions_per_trial
    assert all(st.entry.preempt_count <= cap for st in sim.trials.values())
    # Determinism: same spec, same story.
    r2 = loadgen._Sim(loadgen.LoadSpec(n_submissions=6000, seed=1)).run()
    assert r2["placement_latency_s"] == r["placement_latency_s"]
    assert r2["churn"] == r["churn"]


def test_loadgen_preemption_improves_whale_deadline_hits():
    """A whale-heavy, tight-slack workload hits more deadlines with bounded
    preemption than without, on the identical seeded workload."""
    base = dict(n_submissions=2500, seed=3, deadline_frac=0.25, sizes=((1, 0.3), (2, 0.3), (4, 0.4)),
                slack_lo=1.5, slack_hi=3.0, utilization=2.0)
    with_p = loadgen.run_loadgen(loadgen.LoadSpec(**base))
    without = loadgen.run_loadgen(loadgen.LoadSpec(**base, preempt=PreemptionPolicy(enabled=False)))
    assert with_p["churn"]["preempt_evictions"] >= 1
    assert without["churn"]["preempt_evictions"] == 0
    assert with_p["deadline"]["hit_rate"] > without["deadline"]["hit_rate"]


def test_fabric_scenario_zoo_gates():
    """Both fabric scenarios: the elastic arm splits, both arms settle
    everything (zero lost, none double-owned), and the elastic arm holds
    the within-10 %-of-static latency and deadline gates."""
    assert set(loadgen.FABRIC_SCENARIOS) == {"coordinated_burst", "split_storm"}
    for name in sorted(loadgen.FABRIC_SCENARIOS):
        r = loadgen.run_fabric_scenario(name, n_submissions=1500, seed=3)
        assert r["protocol"] == "fabric_loadgen_v1"
        assert r["scenario"] == name
        dyn, sta = r["dynamic"], r["static"]
        assert dyn["splits"] >= 1, name
        assert sta["splits"] == 0 and sta["steals"] == 0
        assert dyn["topology_epoch"] == 2 * dyn["splits"]
        assert len(dyn["final_shards"]) == 2 + dyn["splits"]
        for arm in (dyn, sta):
            assert arm["zero_lost"], (name, arm["unfinished"])
            assert arm["no_double_own"]
            assert arm["completed"] == arm["admitted"]
        assert all(r["gates"].values()), (name, r["gates"])
    with pytest.raises(ValueError):
        loadgen.run_fabric_scenario("nope")


def test_fabric_scenario_seeded_reruns_identical():
    def strip_wall(rep):
        return {k: ({kk: vv for kk, vv in v.items() if kk != "wall_s"} if k in ("dynamic", "static") else v)
                for k, v in rep.items()}

    a = loadgen.run_fabric_scenario("coordinated_burst", n_submissions=600, seed=7)
    b = loadgen.run_fabric_scenario("coordinated_burst", n_submissions=600, seed=7)
    assert strip_wall(a) == strip_wall(b)


def test_default_loadgen_slos_align_with_virtual_buckets():
    for spec in loadgen.default_loadgen_slos():
        if spec.kind == tslo.LATENCY:
            assert spec.threshold_s in loadgen.VIRTUAL_LATENCY_BUCKETS


def test_loadgen_banks_full_histogram_and_exact_slo():
    r = loadgen.run_loadgen(n_submissions=1500, seed=3)
    h = r["placement_latency_hist"]
    assert h["count"] == r["placement_latency_s"]["count"]
    assert sum(h["counts"]) == h["count"]
    assert r["slo"]["slos"]["placement_p99_1000s"]["exact"]
    assert r["slo"]["slos"]["deadline_hit_rate"]["exact"]
    # The exact compliance agrees with the scalar p99 within one bucket.
    if r["placement_latency_s"]["p99"] <= 1000.0:
        assert r["slo"]["slos"]["placement_p99_1000s"]["compliance"] >= 0.98


def _boom_clock():
    raise AssertionError("the control-plane profiler's clock was read while it was off")


def test_ctlprof_off_reads_no_clock_over_loadgen(monkeypatch):
    """With no profiler armed, thousands of the load generator's
    scheduling passes never reach the profiler's clock indirection."""
    assert ctlprof.get_ctlprof() is None
    monkeypatch.setattr(ctlprof, "_clock", _boom_clock)
    report = loadgen.run_loadgen(loadgen.LoadSpec(n_submissions=300, seed=3))
    assert report["zero_lost"]
    assert ctlprof.get_ctlprof() is None


# -- the fabric drill's phases ------------------------------------------------


def test_loadgen_phase_gates():
    """``run_loadgen_phase`` at chip_smoke's size (the 10 % fair-share gate
    is noisy below some thousands of submissions): every gate holds, and
    the profiler armed for the phase is retired after it."""
    assert ctlprof.get_ctlprof() is None
    r = fabric_drill.run_loadgen_phase(20000)
    assert r["ok"] and all(r["gates"].values()), r["gates"]
    assert set(r["gates"]) == {"zero_lost", "fairness_within_10pct", "deadline_hit_rate_floor_0.9", "p99_recorded",
                               "slo_met", "slo_exact"}
    assert r["ctl"]["enabled"] and r["ctl"]["passes"]["count"] > 0
    assert ctlprof.get_ctlprof() is None


def test_scenario_phase_gates(monkeypatch):
    r = fabric_drill.run_scenario_phase(600)
    assert r["n_submissions"] == 600 and set(r["scenarios"]) == set(loadgen.FABRIC_SCENARIOS)
    assert r["ok"] and all(s["ok"] for s in r["scenarios"].values())
    monkeypatch.setenv("MDT_FABRIC_SCENARIO_N", "500")
    assert fabric_drill.run_scenario_phase()["n_submissions"] == 500


def test_fabric_bench_gates_include_loadgen_and_scenarios(tmp_path, monkeypatch):
    """``run_fabric_bench`` folds the load generator's and the scenario
    zoo's verdicts into its gates (the drills that start replicas are
    stubbed here; ``tests/test_torch_fabric.py`` runs them)."""
    assert fabric_drill.NOT_PORTED == {"movable_pipelined": "A.14"}
    stub = {
        "run_failover_phase": {"kill_exercised": True, "zero_lost": True, "adoption_evident": True,
                               "rehomed_count": 1, "parity": {"ok": True},
                               "trace": {"completeness": {"complete": True}, "rehomed_cross_epoch": True}},
        "run_split_chaos": {"split_kill_exercised": True, "zero_lost": True, "no_double_own": True,
                            "topology": {"seam_closed": True}, "parity": {"ok": True}},
        "run_steal_phase": {"ok": True},
        "run_movable_phase": {"stacked": {"bit_identical": True}},
        "run_deadline_phase": {"ok": True},
    }
    for name, rep in stub.items():
        monkeypatch.setattr(fabric_drill, name, lambda *a, _rep=rep, **kw: _rep)
    monkeypatch.setenv("MDT_FABRIC_LOADGEN_N", "2000")
    monkeypatch.setenv("MDT_FABRIC_SCENARIO_N", "600")
    r = fabric_drill.run_fabric_bench(str(tmp_path), device="cpu")
    assert r["loadgen"]["submitted"] == 2000 and r["fabric_scenarios"]["n_submissions"] == 600
    assert r["gates"]["scenario_gates"] is True
    # 2000 submissions are too few for the 10 % fair-share gate: the bench
    # carries the phase's verdict.
    assert r["gates"]["loadgen_gates"] is r["loadgen"]["ok"] is False
    assert not r["ok"] and r["not_ported"] == {"movable_pipelined": "A.14"}
    r = fabric_drill.run_fabric_bench(str(tmp_path), device="cpu", loadgen_n=20000)
    assert r["gates"]["loadgen_gates"] and r["ok"], r["gates"]
