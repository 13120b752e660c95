"""The port's sweep ledger and supervision policy (``hpo/ledger.py``,
``hpo/supervision.py``) against the JAX package's.

- ``config_hash``, ``classify_failure``, ``exit_code_for`` and
  ``RetryPolicy`` agree across the two packages on the same inputs.
- The two ledgers read each other's files to the same folds, and a ledger
  the JAX package's ``run_hpo`` wrote makes the port's ``run_hpo`` skip the
  trials it settled.
- A torn tail is skipped; ``ledger=False`` writes nothing; a restart with
  everything settled runs nothing.
"""

import json
import os
import socket
from dataclasses import asdict

import jax
import pytest
import torch

from multidisttorch_tpu.data.datasets import synthetic_mnist
from multidisttorch_tpu.faults.inject import HostPreemption as JaxHostPreemption
from multidisttorch_tpu.hpo import ledger as jax_ledger
from multidisttorch_tpu.hpo import supervision as jax_sup
from multidisttorch_tpu.hpo.driver import TrialConfig as JaxTrialConfig
from multidisttorch_tpu.hpo.driver import run_hpo as jax_run_hpo
from multidisttorch_tpu.parallel import cluster as jax_cluster
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import guards as jax_guards
from multidisttorch_tpu.train.guards import DivergenceError as JaxDivergenceError
from multidisttorch_tpu_torch.faults.inject import HostPreemption
from multidisttorch_tpu_torch.hpo import ledger as port_ledger
from multidisttorch_tpu_torch.hpo import supervision as port_sup
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.parallel import cluster as port_cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train import guards
from multidisttorch_tpu_torch.train.guards import DivergenceError

SMALL = dict(batch_size=32, hidden_dim=16, latent_dim=4, log_interval=100)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1)


@pytest.mark.parametrize("kw", [
    {},
    dict(epochs=7, lr=3e-3, seed=5),
    dict(beta=0.5, fused_steps=10, eval_sampled=True, batch_size=64),
    dict(hidden_dim=400, latent_dim=20, grad_accum=2, dataset="cas:abc"),
])
def test_config_hash_agrees_with_jax(kw):
    port = port_ledger.config_hash(asdict(TrialConfig(trial_id=3, **kw)))
    assert port == jax_ledger.config_hash(asdict(JaxTrialConfig(trial_id=3, **kw)))
    assert port != port_ledger.config_hash(asdict(TrialConfig(trial_id=4, **kw)))


# (port exception, JAX exception) of each kind of failure.
FAILURES = {
    "worker": (RuntimeError("worker died"), RuntimeError("worker died")),
    "disk": (OSError("disk full"), OSError("disk full")),
    "io_timeout": (TimeoutError("nfs hiccup"), TimeoutError("nfs hiccup")),
    "socket_timeout": (socket.timeout("slow read"), socket.timeout("slow read")),
    "divergence": (DivergenceError("loss", float("nan")), JaxDivergenceError("loss", float("nan"))),
    "preemption": (HostPreemption("gone"), JaxHostPreemption("gone")),
    "agreement": (port_cluster.AgreementTimeout("expired"), jax_cluster.AgreementTimeout("expired")),
    "wedged": (port_cluster.WedgedCollective("wedged"), jax_cluster.WedgedCollective("wedged")),
    "unretryable": (port_sup.UnretryableError("guard"), jax_sup.UnretryableError("guard")),
}


@pytest.mark.parametrize("kind", sorted(FAILURES))
def test_classification_and_exit_code_agree_with_jax(kind):
    port_exc, jax_exc = FAILURES[kind]
    assert port_sup.classify_failure(port_exc) == jax_sup.classify_failure(jax_exc)
    assert port_sup.exit_code_for(port_exc) == jax_sup.exit_code_for(jax_exc)
    assert port_cluster.PREEMPTION_EXIT_CODE == jax_cluster.PREEMPTION_EXIT_CODE == 75


def test_classification_contract():
    assert port_sup.classify_failure(RuntimeError("x")) == port_sup.INFRA
    assert port_sup.classify_failure(DivergenceError("loss", float("nan"))) == port_sup.DIVERGENCE
    assert port_sup.classify_failure(HostPreemption("gone")) == port_sup.PREEMPTION
    assert port_sup.classify_failure(port_cluster.WedgedCollective("w")) == port_sup.PREEMPTION
    assert port_sup.classify_failure(socket.timeout("slow")) == port_sup.INFRA
    assert port_sup.classify_failure(port_sup.UnretryableError("g")) == port_sup.FATAL
    assert port_sup.SETTLED_STATUSES == jax_sup.SETTLED_STATUSES


@pytest.mark.parametrize("value", [1.5, float("nan"), float("inf"), -float("inf")])
def test_check_finite_agrees_with_jax(value):
    try:
        want = jax_guards.check_finite(value, "epoch loss", step=8, trial_id=2)
    except JaxDivergenceError as e:
        with pytest.raises(DivergenceError) as got:
            guards.check_finite(torch.tensor(value), "epoch loss", step=8, trial_id=2)
        assert str(got.value) == str(e) and got.value.step == 8 and got.value.trial_id == 2
    else:
        assert guards.check_finite(torch.tensor(value), "epoch loss", step=8, trial_id=2) == want


def test_guard_finite_names_the_inner_step_as_jax_does():
    class State:
        step = 0

    def multi(state, k, bad=None):
        state.step += k
        vals = torch.ones(k)
        if bad is not None:
            vals[bad] = float("nan")
        return state, {"loss": vals}

    def first_bad_step(guard, error):
        state = State()
        guard(state, 4)
        with pytest.raises(error) as e:
            guard(state, 4, bad=2)
        return e.value.step

    assert first_bad_step(guards.guard_finite(multi), DivergenceError) == 7
    assert first_bad_step(jax_guards.guard_finite(multi), JaxDivergenceError) == 7
    with pytest.raises(ValueError):
        guards.guard_finite(multi, every=0)


@pytest.mark.parametrize("kw", [
    {},
    dict(backoff_base_s=0.5, backoff_factor=3.0, backoff_max_s=4.0),
    dict(jitter=True, jitter_seed=11),
    dict(jitter=True, backoff_base_s=0.2, backoff_max_s=1.0),
])
def test_retry_policy_agrees_with_jax(kw):
    port, ref = port_sup.RetryPolicy(**kw), jax_sup.RetryPolicy(**kw)
    for k in range(1, 7):
        for key in (0, 1, 17):
            assert port.backoff_s(k, key=key) == ref.backoff_s(k, key=key)
    for fails in range(5):
        for cls in (port_sup.INFRA, port_sup.PREEMPTION, port_sup.DIVERGENCE):
            assert port.should_retry(fails, cls) == ref.should_retry(fails, cls)
    with pytest.raises(ValueError):
        port.backoff_s(0)
    with pytest.raises(ValueError):
        port_sup.RetryPolicy(max_retries=-1)


def _events(led):
    led.attempt_start(0, "h0", 1)
    led.attempt_end(0, "h0", 1, "retrying", error="x", summary={"resumed_from_step": 0, "steps_at_failure": 5})
    led.attempt_start(0, "h0", 2)
    led.attempt_end(0, "h0", 2, "completed", summary={"steps": 16, "history": [{"epoch": 1}]})
    led.attempt_start(1, "h1", 1)
    led.attempt_end(1, "h1", 1, "diverged", error="nan")
    led.attempt_start(2, "h2", 1)
    led.attempt_end(2, "h2", 1, "preempted", summary={"resumed_from_step": 8, "steps_at_failure": 11})
    led.attempt_start(2, "h2", 2, tenant="t", priority=1)
    led.attempt_end(2, "h2", 2, "failed", error="boom")


def _folds(led):
    return led.finished(), led.attempts(), led.infra_failures()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_ledger_reads_the_others_file_to_the_same_folds(tmp_path, writer):
    mods = {"port": port_ledger, "jax": jax_ledger}
    _events(mods[writer].SweepLedger(str(tmp_path)))
    port, ref = port_ledger.SweepLedger(str(tmp_path)), jax_ledger.SweepLedger(str(tmp_path))
    assert port.load() == ref.load()
    assert _folds(port) == _folds(ref)
    assert set(port.finished()) == {"h0", "h1"}
    assert port.attempts() == {"h0": 2, "h1": 1, "h2": 2}
    assert port.infra_failures() == {"h0": 1, "h2": 1}
    assert [port_ledger.wasted_steps(e) for e in port.load()] == [jax_ledger.wasted_steps(e) for e in ref.load()]


def test_compaction_agrees_with_jax(tmp_path):
    for name in ("port", "jax"):
        _events(port_ledger.SweepLedger(str(tmp_path / name)))
    rp = port_ledger.SweepLedger(str(tmp_path / "port")).compact()
    rj = jax_ledger.SweepLedger(str(tmp_path / "jax")).compact()
    assert rp == rj
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"} for e in evs]  # noqa: E731
    port, ref = port_ledger.SweepLedger(str(tmp_path / "port")), jax_ledger.SweepLedger(str(tmp_path / "jax"))
    assert strip(port.load()) == strip(ref.load())
    assert strip(port.finished().values()) == strip(ref.finished().values())
    assert _folds(port)[1:] == _folds(ref)[1:]


def test_ledger_tolerates_torn_tail(tmp_path):
    led = port_ledger.SweepLedger(str(tmp_path))
    _events(led)
    with open(led.path, "a") as f:
        f.write('{"event": "attempt_end", "trial_id": 0, "config_')
    assert len(led.load()) == 10 and len(led.finished()) == 2


def test_a_jax_ledger_makes_the_port_skip_what_it_settled(data, tmp_path):
    train, test = data
    configs = [dict(trial_id=i, epochs=1, seed=i, **SMALL) for i in range(2)]
    jres = jax_run_hpo([JaxTrialConfig(**c) for c in configs], train, test,
                       groups=jax_setup_groups(1, devices=jax.devices()[:1]), out_dir=str(tmp_path),
                       save_images=False, verbose=False)
    before = os.path.getsize(tmp_path / port_ledger.LEDGER_NAME)
    pres = run_hpo([TrialConfig(**c) for c in configs], train, test,
                   groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path),
                   save_images=False, verbose=False, resume=True)
    assert [r.status for r in pres] == ["resumed_complete"] * 2
    for p, j in zip(pres, jres):
        assert p.history == j.history and p.steps == j.steps == 8 and p.attempt == 1
    assert os.path.getsize(tmp_path / port_ledger.LEDGER_NAME) == before
    # A changed config is not settled: it runs.
    (r,) = run_hpo([TrialConfig(**dict(configs[0], lr=0.0))], train, test,
                   groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path / "new"),
                   save_images=False, verbose=False, resume=True)
    assert r.status == "completed"


def test_restart_reruns_nothing_when_everything_settled(data, tmp_path):
    train, test = data
    configs = [TrialConfig(trial_id=i, epochs=1, seed=i, **SMALL) for i in range(2)]
    kw = dict(groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path), save_images=False, verbose=False)
    first = run_hpo(configs, train, test, **kw)
    size = os.path.getsize(tmp_path / port_ledger.LEDGER_NAME)
    again = run_hpo(configs, train, test, resume=True, **kw)
    assert [r.status for r in again] == ["resumed_complete"] * 2
    assert [r.history for r in again] == [r.history for r in first]
    assert os.path.getsize(tmp_path / port_ledger.LEDGER_NAME) == size
    # The port's records are ones the JAX ledger reads as settled.
    assert set(jax_ledger.SweepLedger(str(tmp_path)).finished()) == {
        port_ledger.config_hash(asdict(c)) for c in configs
    }


def test_ledger_disabled_writes_nothing(data, tmp_path):
    train, _ = data
    run_hpo([TrialConfig(trial_id=0, epochs=1, **SMALL)], train, None,
            groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path),
            save_images=False, verbose=False, ledger=False)
    assert not os.path.exists(tmp_path / port_ledger.LEDGER_NAME)
    assert os.path.exists(tmp_path / "trial-0" / "state.msgpack")


def test_ledger_records_attempts_with_summaries(data, tmp_path):
    train, test = data
    (r,) = run_hpo([TrialConfig(trial_id=4, epochs=2, **SMALL)], train, test,
                   groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path),
                   save_images=False, verbose=False)
    with open(tmp_path / port_ledger.LEDGER_NAME) as f:
        events = [json.loads(line) for line in f]
    assert [e["event"] for e in events] == ["attempt_start", "attempt_end"]
    end = events[1]
    assert end["status"] == "completed" and end["attempt"] == 1
    assert end["config_hash"] == port_ledger.config_hash(asdict(r.config))
    assert end["summary"]["history"] == r.history and end["summary"]["steps"] == 16
