"""Fault plans, the injector and supervised recovery: the port against the
JAX package's ``faults/`` and ``tests/test_faults.py``.

On the CPU at batch 16, hidden 16, latent 4, 128 rows (8 steps an epoch):

- the same ``FaultPlan.standard`` seed gives an identical ``to_json`` in
  both packages, and a bad spec raises the same ``ValueError``;
- one scripted sequence of hook calls on both injectors raises the same
  faults and writes the same fired-record file, line for line (timestamps
  aside); ``poison_batch`` fills the same slice (NaN masks equal);
  ``checkpoint_hook`` garbles a file to the same bytes;
- one shared plan through both packages' ``run_hpo`` (the standard plan
  with its preemption and the driver restart) fires the same ``(kind,
  trial, step)`` set, the ledger folds agree on status, attempts and
  retries per trial, DIVERGE is terminal in both, and at lr 0 (the JAX
  weights carried in) the final test losses agree at rel 1e-5 (ROADMAP
  C.5);
- in the port a retried trial ends bit-identical to its own fault-free run
  (every leaf of its final checkpoint, its history and generator states),
  and a stacked lane fault retires and refills while a poisoned lane
  diverges alone (``tests/test_faults.py`` :361, :391);
- the chaos drill recovers every fault, and the resnet example's two gloo
  ranks exit (ROADMAP C.17).
"""

import json
import os
import signal
import sys
from functools import lru_cache

import jax
import numpy as np
import optax
import pytest
import torch

from multidisttorch_tpu.data.datasets import synthetic_mnist
from multidisttorch_tpu.faults import inject as jax_inject
from multidisttorch_tpu.faults.plan import FaultPlan as JaxFaultPlan
from multidisttorch_tpu.faults.plan import FaultSpec as JaxFaultSpec
from multidisttorch_tpu.hpo.driver import TrialConfig as JaxTrialConfig
from multidisttorch_tpu.hpo.driver import run_hpo as jax_run_hpo
from multidisttorch_tpu.hpo.ledger import SweepLedger as JaxSweepLedger
from multidisttorch_tpu.hpo.supervision import RetryPolicy as JaxRetryPolicy
from multidisttorch_tpu.models.vae import VAE as JaxVAE
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train.steps import build_train_state
from multidisttorch_tpu_torch.faults import (
    CKPT_CORRUPT,
    CRASH,
    DAEMON_LOST,
    DATA_ERROR,
    DIVERGE,
    HOST_LOST,
    PREEMPT,
    SHARD_SPLIT_LOST,
    SLOW,
    WEDGE,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    HostPreemption,
)
from multidisttorch_tpu_torch.faults import inject as port_inject
from multidisttorch_tpu_torch.faults.harness import run_chaos_bench, run_chaos_mh_bench
from multidisttorch_tpu_torch.hpo import driver
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
from multidisttorch_tpu_torch.models.vae import vae_params_from_flax
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch_size=16, hidden_dim=16, latent_dim=4, log_interval=10_000)
STEPS = 8  # 128 rows / batch 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(128, seed=0), synthetic_mnist(32, seed=1)


def _cfg(trial_id, **kw):
    return TrialConfig(**{**dict(trial_id=trial_id, epochs=3, seed=trial_id, **SMALL), **kw})


def _sweep(configs, data, out_dir, *, ngroups=1, **kw):
    base = dict(groups=setup_groups(ngroups, devices=["cpu"] * ngroups), out_dir=str(out_dir), verbose=False,
                save_images=False, resilient=True, retry=RetryPolicy(max_retries=2, backoff_base_s=0.01))
    base.update(kw)
    return run_hpo(configs, data[0], data[1], **base)


def _ends(out_dir, trial_id):
    return [e["status"] for e in SweepLedger(str(out_dir)).load()
            if e.get("trial_id") == trial_id and e["event"] == "attempt_end"]


# -- the plan ------------------------------------------------------------


@pytest.mark.parametrize("ids,seed,spe,preempt", [
    ([0, 1, 2, 3, 4, 5], 0, 8, True),
    ([0, 1, 2, 3, 4, 5], 7, 8, False),
    ([3, 9, 11], 123, 16, True),
    ([5], 1, 2, True),
])
def test_standard_plan_json_matches_jax(ids, seed, spe, preempt):
    mine = FaultPlan.standard(ids, seed=seed, steps_per_epoch=spe, include_preempt=preempt)
    ref = JaxFaultPlan.standard(ids, seed=seed, steps_per_epoch=spe, include_preempt=preempt)
    assert mine.to_json() == ref.to_json()
    assert FaultPlan.from_json(ref.to_json()) == mine
    assert not mine.for_trial(ids[-1]) or len(ids) == 1  # the parity control


@pytest.mark.parametrize("kw", [
    dict(kind="meteor", trial_id=0, step=1),
    dict(kind=CKPT_CORRUPT, trial_id=0),
    dict(kind=CRASH, trial_id=0),
    dict(kind=HOST_LOST, trial_id=-1, step=3),
    dict(kind=SLOW, trial_id=0, step=1, max_fires=0),
])
def test_validation_errors_match_jax(kw):
    with pytest.raises(ValueError) as mine:
        FaultSpec(**kw)
    with pytest.raises(ValueError) as ref:
        JaxFaultSpec(**kw)
    assert str(mine.value) == str(ref.value)


def test_standard_plan_needs_trials():
    with pytest.raises(ValueError, match="at least one trial id"):
        FaultPlan.standard([])


# -- the injector --------------------------------------------------------


_SCRIPT_SPECS = [
    dict(kind=SLOW, trial_id=0, step=1, delay_s=0.001),
    dict(kind=CRASH, trial_id=0, step=3),
    dict(kind=DATA_ERROR, trial_id=1, step=5),
    dict(kind=DIVERGE, trial_id=1, step=6),
    dict(kind=DIVERGE, trial_id=2, step=2),
    dict(kind=CKPT_CORRUPT, trial_id=0, epoch=1),
    dict(kind=PREEMPT, trial_id=2, step=9),
    dict(kind=CRASH, trial_id=3, step=4, max_fires=2),
    dict(kind=HOST_LOST, trial_id=-1, step=12, host=0),
]


class _Exit(Exception):
    pass


def _run_script(inj, tmp, batch_of):
    """One scripted hook sequence; returns what happened at each call."""
    out = []

    def call(name, fn, *a):
        try:
            got = fn(*a)
        except (_Exit, Exception) as e:  # noqa: BLE001 — the faults are the point
            out.append((name, type(e).__name__, str(e)))
            return None
        out.append((name, "ok", None if got is None or isinstance(got, bool) else "value"))
        return got

    call("step 0..3 t0", inj.step_hook, 0, 0, 4)
    call("step 0..3 t0 again", inj.step_hook, 0, 0, 4)
    call("data 4..5 t1", inj.data_hook, 1, 4, 2)
    out.append(("covers 6 t1", inj.diverge_covers(1, 6), None))
    p1 = inj.poison_batch(1, 4, batch_of(4, 3, 5), 4)
    p2 = inj.poison_batch(2, 2, batch_of(3, 5), 1)
    p3 = inj.poison_batch(2, 2, batch_of(3, 5), 1)  # fired already: untouched
    path = os.path.join(tmp, "state.bin")
    with open(path, "wb") as f:
        f.write(bytes(range(256)) * 3)
    call("ckpt epoch 1 t0", inj.checkpoint_hook, 0, 1, path)
    call("ckpt epoch 2 t0", inj.checkpoint_hook, 0, 2, path)
    call("step 8..9 t2", inj.step_hook, 2, 8, 2)
    for n in range(3):
        call(f"step 4 t3 #{n}", inj.step_hook, 3, 4, 1)
    with open(path, "rb") as f:
        blob = f.read()
    return out, [np.asarray(p) for p in (p1, p2, p3)], blob


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("ts", "path")} for line in f]


def test_scripted_hooks_match_jax_line_for_line(tmp_path, monkeypatch):
    def no_exit(code):
        raise _Exit(f"exit {code}")

    monkeypatch.setattr(os, "_exit", no_exit)
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (4, 3, 5)).astype(np.float32)
    results = {}
    for name, mod, plan_cls, spec_cls, to_batch in (
        ("port", port_inject, FaultPlan, FaultSpec, torch.tensor),
        ("jax", jax_inject, JaxFaultPlan, JaxFaultSpec, np.asarray),
    ):
        tmp = tmp_path / name
        tmp.mkdir()
        plan = plan_cls(specs=tuple(spec_cls(**s) for s in _SCRIPT_SPECS))
        inj = mod.FaultInjector(plan, host_slot=0, fired_log=str(tmp / "fired.jsonl"))
        inputs = []

        def batch_of(*shape):
            x = to_batch(base[: shape[0]].reshape(shape) if len(shape) == 3 else base[0, : shape[0]].copy())
            inputs.append(x)
            return x

        calls, poisoned, blob = _run_script(inj, str(tmp), batch_of)
        fired = [{k: v for k, v in r.items() if k not in ("ts", "path")} for r in inj.fired]
        results[name] = (calls, poisoned, blob, _records(str(tmp / "fired.jsonl")), fired, inputs)
    (pc, pp, pb, pr, pf, pin), (jc, jp, jb, jr, jf, _) = results["port"], results["jax"]
    assert pc == jc
    assert [c[1] for c in pc if c[1] not in ("ok", True, False)] == [
        "InjectedCrash", "DataFault", "HostPreemption", "InjectedCrash", "InjectedCrash", "_Exit"]
    assert pr == jr and pf == jf and len(pr) == 10
    for a, b in zip(pp, jp):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.array_equal(np.nan_to_num(a, nan=-1), np.nan_to_num(b, nan=-1))
    assert np.isnan(pp[0][2]).all() and not np.isnan(pp[0][[0, 1, 3]]).any()
    # The port poisons a clone and leaves the batch it was given as it was.
    assert not any(torch.isnan(x).any() for x in pin)
    assert pb == jb and pb[:384] == (bytes(range(256)) * 3)[:384] and set(pb[384:]) == {0xFF}


@pytest.mark.parametrize("kind,item", [(WEDGE, "A.11"), (DAEMON_LOST, "A.12"), (SHARD_SPLIT_LOST, "A.12")])
def test_unported_host_kinds_raise_naming_their_item(kind, item):
    inj = FaultInjector(FaultPlan(specs=(FaultSpec(kind, -1, step=0, host=0, delay_s=0.01),)), host_slot=0)
    if kind == WEDGE:
        # Ported by A.11: the wedge stalls and preempts instead of raising
        # NotImplementedError (tests/test_torch_elastic.py holds the rest).
        with pytest.raises(HostPreemption, match="wedge"):
            inj.step_hook(0, 0)
        assert [f["kind"] for f in inj.fired] == [WEDGE]
        FaultInjector(inj.plan).step_hook(0, 0)
        return
    # DAEMON_LOST, ported by A.12b's fabric core, is a SIGKILL on the
    # replica's dispatch clock; SHARD_SPLIT_LOST, ported with the splits, one
    # on its split-handoff clock (tests/test_torch_fabric*.py hold the rest).
    advance = "host_step" if kind == DAEMON_LOST else "split_step"
    kills = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "kill", lambda pid, sig: kills.append((pid, sig)))
        getattr(inj, advance)(1)
    assert kills == [(os.getpid(), signal.SIGKILL)] and [f["kind"] for f in inj.fired] == [kind]
    assert inj.fired[0]["host"] == 0 and inj.fired[0]["step"] == 0
    # A single-controller injector (no host slot) skips host kinds.
    getattr(FaultInjector(inj.plan), advance)(1)


def test_fault_plan_argument(data, tmp_path):
    assert "fault_plan" not in driver._UNPORTED_ARGS
    with pytest.raises(TypeError, match="FaultPlan or FaultInjector"):
        _sweep([_cfg(0, epochs=1)], data, tmp_path, fault_plan=[CRASH])


# -- one plan through both packages' run_hpo ------------------------------


@lru_cache(maxsize=None)
def _jax_initial_params(seed: int, hidden: int, latent: int):
    state = build_train_state(JaxVAE(hidden_dim=hidden, latent_dim=latent), optax.adam(1e-3), jax.random.key(seed))
    return vae_params_from_flax(jax.device_get(state.params))


def _drill(run, make_cfg, make_plan, make_retry, groups, data, out_dir, injector_cls, preemption):
    """The chaos harness's loop: supervised sweeps, restarted after each
    simulated preemption with the same injector."""
    plan = make_plan()
    injector = injector_cls(plan)
    restarts = 0
    while True:
        try:
            return run([make_cfg(i) for i in range(4)], data[0], data[1], groups=groups(), out_dir=str(out_dir),
                       verbose=False, save_images=False, resilient=True, retry=make_retry(),
                       fault_plan=injector, resume=restarts > 0, ckpt_keep_last=2), injector, restarts
        except preemption:
            restarts += 1
            assert restarts < 4


def _fold(out_dir, led_cls):
    """Per trial: the final status, attempts started and retries, from the
    ledger file."""
    out = {}
    for e in led_cls(str(out_dir)).load():
        t = out.setdefault(e["trial_id"], {"attempts": 0, "retries": 0, "status": None})
        if e["event"] == "attempt_start":
            t["attempts"] = max(t["attempts"], e["attempt"])
        elif e["event"] == "attempt_end":
            t["status"] = e["status"]
            t["retries"] += e["status"] == "retrying"
    return out


def test_one_plan_through_both_packages(data, tmp_path, monkeypatch):
    monkeypatch.setattr(driver, "init_vae_params", lambda model, seed: model.load_state_dict(
        _jax_initial_params(seed, model.hidden_dim, model.latent_dim)) or model)
    cfg = dict(epochs=2, lr=0.0, **SMALL)
    plan_ids = [0, 1, 2, 3]
    pres, pinj, prestarts = _drill(
        run_hpo, lambda i: TrialConfig(trial_id=i, seed=i, **cfg),
        lambda: FaultPlan.standard(plan_ids, seed=3, steps_per_epoch=STEPS),
        lambda: RetryPolicy(max_retries=2, backoff_base_s=0.01), lambda: setup_groups(1, devices=["cpu"]),
        data, tmp_path / "port", FaultInjector, HostPreemption)
    jres, jinj, jrestarts = _drill(
        jax_run_hpo, lambda i: JaxTrialConfig(trial_id=i, seed=i, **cfg),
        lambda: JaxFaultPlan.standard(plan_ids, seed=3, steps_per_epoch=STEPS),
        lambda: JaxRetryPolicy(max_retries=2, backoff_base_s=0.01),
        lambda: jax_setup_groups(1, devices=jax.devices()[:1]),
        data, tmp_path / "jax", jax_inject.FaultInjector, jax_inject.HostPreemption)

    def fired(inj):
        return sorted((r["kind"], r["trial_id"], r.get("step", -1), r.get("epoch", -1)) for r in inj.fired)

    assert fired(pinj) == fired(jinj) and len(fired(pinj)) >= 5
    assert prestarts == jrestarts == 1
    assert _fold(tmp_path / "port", SweepLedger) == _fold(tmp_path / "jax", JaxSweepLedger)
    diverged = {s.trial_id for s in pinj.plan.specs if s.kind == DIVERGE}
    for p, j in zip(pres, jres):
        assert p.trial_id == j.trial_id and p.status == j.status and p.attempt == j.attempt
        if p.trial_id in diverged:
            assert p.status == "diverged" and "non-finite" in p.error and "non-finite" in j.error
            continue
        assert p.status in ("completed", "resumed_complete")
        assert p.final_test_loss == pytest.approx(j.final_test_loss, rel=1e-5)


# -- recovery in the port, bit for bit ------------------------------------


def _final(out_dir, trial_id):
    path = os.path.join(str(out_dir), f"trial-{trial_id}", "state.msgpack")
    with open(path + ".json") as f:
        meta = json.load(f)
    return ck._read_tree(path), meta


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {} if tree else {prefix: np.zeros(0)}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_run(a_dir, b_dir, trial_id=0):
    (ta, ma), (tb, mb) = _final(a_dir, trial_id), _final(b_dir, trial_id)
    fa, fb = _flat(ta), _flat(tb)
    assert list(fa) == list(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]) and fa[k].dtype == fb[k].dtype, k
    for key in ("step", "completed_epochs", "history", driver.GENERATORS_KEY):
        assert ma[key] == mb[key], key


@pytest.mark.parametrize("specs,keep,resumed", [
    ([dict(kind=CRASH, trial_id=0, step=STEPS + 3)], 1, STEPS),
    ([dict(kind=DATA_ERROR, trial_id=0, step=STEPS + 2), dict(kind=SLOW, trial_id=0, step=2, delay_s=0.01)], 1, STEPS),
    ([dict(kind=CKPT_CORRUPT, trial_id=0, epoch=2), dict(kind=CRASH, trial_id=0, step=2 * STEPS + 3)], 2, 2 * STEPS),
    ([dict(kind=CKPT_CORRUPT, trial_id=0, epoch=1), dict(kind=CRASH, trial_id=0, step=STEPS + 3)], 1, 0),
], ids=["crash", "data-error-and-slow", "corrupt-scanned-past", "corrupt-only-from-scratch"])
def test_retried_trial_ends_bit_identical_to_its_fault_free_run(data, tmp_path, specs, keep, resumed):
    clean = _sweep([_cfg(0)], data, tmp_path / "clean", ckpt_keep_last=keep)[0]
    plan = FaultPlan(specs=tuple(FaultSpec(**s) for s in specs))
    (r,) = _sweep([_cfg(0)], data, tmp_path / "chaos", fault_plan=plan, ckpt_keep_last=keep)
    assert r.status == "completed" and r.attempt == 2 and r.steps == 3 * STEPS
    assert r.final_train_loss == clean.final_train_loss and r.history == clean.history
    assert _ends(tmp_path / "chaos", 0) == ["retrying", "completed"]
    done = [e for e in SweepLedger(str(tmp_path / "chaos")).load() if e.get("status") == "completed"][0]
    assert done["summary"]["resumed_from_step"] == resumed
    _assert_same_run(tmp_path / "clean", tmp_path / "chaos")


def test_divergence_is_terminal_and_budget_exhaustion_fails_the_trial_only(data, tmp_path):
    plan = FaultPlan(specs=(FaultSpec(DIVERGE, 0, step=2), FaultSpec(CRASH, 1, step=2, max_fires=10)))
    results = _sweep([_cfg(0), _cfg(1), _cfg(2)], data, tmp_path, fault_plan=plan,
                     retry=RetryPolicy(max_retries=1, backoff_base_s=0.01))
    by_id = {r.trial_id: r for r in results}
    assert by_id[0].status == "diverged" and by_id[0].attempt == 1 and by_id[0].steps == STEPS
    assert by_id[1].status == "failed" and by_id[1].attempt == 2
    assert by_id[2].status == "completed"
    assert _ends(tmp_path, 0) == ["diverged"] and _ends(tmp_path, 1) == ["retrying", "failed"]


def test_preemption_propagates_and_the_restart_skips_settled_trials(data, tmp_path):
    injector = FaultInjector(FaultPlan(specs=(FaultSpec(PREEMPT, 1, step=STEPS + 2),)))
    with pytest.raises(HostPreemption):
        _sweep([_cfg(0), _cfg(1)], data, tmp_path, fault_plan=injector)
    results = _sweep([_cfg(0), _cfg(1)], data, tmp_path, fault_plan=injector, resume=True)
    assert [r.status for r in results] == ["resumed_complete", "completed"]
    assert _ends(tmp_path, 1) == ["preempted", "completed"]
    _sweep([_cfg(1)], data, tmp_path / "clean")
    _assert_same_run(tmp_path / "clean", tmp_path, trial_id=1)


# -- stacked lanes ----------------------------------------------------------


@pytest.mark.parametrize("kind", [CRASH, DATA_ERROR])
def test_stacked_lane_fault_retires_and_refills(data, tmp_path, kind):
    configs = [_cfg(i, epochs=2) for i in range(5)]
    clean = {r.trial_id: r for r in _sweep(configs, data, tmp_path / "clean", stack_trials=True, stack_max_lanes=4)}
    assert all(r.stacked for r in clean.values())
    plan = FaultPlan(specs=(FaultSpec(kind, 2, step=STEPS + 1),))
    by_id = {r.trial_id: r for r in _sweep(configs, data, tmp_path / "chaos", stack_trials=True,
                                           stack_max_lanes=4, fault_plan=plan)}
    assert [by_id[i].status for i in range(5)] == ["completed"] * 5
    assert by_id[2].attempt == 2
    for i in range(5):
        assert by_id[i].final_train_loss == clean[i].final_train_loss
        assert by_id[i].attempt == (2 if i == 2 else 1)
    assert _ends(tmp_path / "chaos", 2) == ["retrying", "completed"]


def test_stacked_lane_divergence_is_isolated_and_terminal(data, tmp_path):
    configs = [_cfg(i, epochs=2) for i in range(5)]
    clean = {r.trial_id: r.final_train_loss
             for r in _sweep(configs, data, tmp_path / "clean", stack_trials=True, stack_max_lanes=4)}
    plan = FaultPlan(specs=(FaultSpec(DIVERGE, 1, step=2),))
    by_id = {r.trial_id: r for r in _sweep(configs, data, tmp_path / "chaos", stack_trials=True,
                                           stack_max_lanes=4, fault_plan=plan)}
    assert by_id[1].status == "diverged" and by_id[1].attempt == 1
    for i in (0, 2, 3, 4):
        assert by_id[i].status == "completed" and by_id[i].final_train_loss == clean[i]
    assert "retrying" not in _ends(tmp_path / "chaos", 1)


# -- the drill -------------------------------------------------------------


@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
def test_chaos_drill_recovers_every_fault(tmp_path, stacked):
    report = run_chaos_bench(str(tmp_path), trials=4, epochs=3, stacked=stacked, device="cpu")
    assert report["all_infra_faults_recovered"] and report["final_metrics_bit_identical"]
    assert report["goodput"] >= 0.8
    assert report["restarts_after_preemption"] == (0 if stacked else 1)
    tel = report["telemetry"]
    assert tel["all_faults_traced"] and tel["trace_monotonic"] and tel["faults_fired"] >= 4
    assert tel["retries_traced"] >= 2
    assert (tel["lane_refills_traced"] > 0) == stacked
    assert report["memory_allocated"] == {"after_fault_free": None, "after_chaos": None}
    # The multi-host drill is ported (tests/test_torch_elastic.py drives it);
    # it takes host-scoped fault kinds only.
    with pytest.raises(ValueError, match="kind must be one of"):
        run_chaos_mh_bench(str(tmp_path), kind=CRASH, device="cpu")


def test_chaos_cli_on_cpu(tmp_path, capsys):
    from multidisttorch_tpu_torch.examples import chaos_run

    out = tmp_path / "report.json"
    assert chaos_run.main(["--device", "cpu", "--trials", "3", "--epochs", "2", "--no-preempt",
                           "--work-dir", str(tmp_path / "w"), "--out", str(out)]) == 0
    headline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert headline["all_infra_faults_recovered"] and headline["all_faults_traced"]
    assert json.loads(out.read_text())["value"] == headline["value"]


# -- ROADMAP C.17: the resnet example's gloo ranks exit ---------------------


def test_resnet_example_two_gloo_ranks_exit(tmp_path):
    from test_torch_groups import _launch

    outs = _launch(lambda r: [sys.executable, "-m", "multidisttorch_tpu_torch.examples.resnet_hpo", "--device", "cpu",
                              "--ngroups", "1", "--epochs", "1", "--base-channels", "4", "--synthetic-size", "128",
                              "--batch-size", "32", "--fused-steps", "2"], 2, timeout=120)
    assert "trial 0 (lr=1e-03): test acc" in outs[0]
