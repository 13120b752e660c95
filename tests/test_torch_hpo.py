"""The slice as a whole: the port's ``run_hpo`` against the JAX package's.

Both run on the same ``synthetic_mnist`` rows in the same epoch order, with
the JAX package's initial weights carried into the port through its
module-level ``init_vae_params``. Only the reparameterisation noise
differs (ROADMAP C.2), so:

- at ``lr=0`` the weights never move and the deterministic posterior-mean
  eval must agree per epoch at rel 1e-5;
- at ``lr=1e-3`` the final test losses must agree within the spread of the
  JAX package's own runs across three seeds (capped at 5 %), measured in
  the test itself.

Also: step counts, queueing of more configs than groups, unequal epochs,
log format and cadence, what is not ported, and that the port never
touches JAX.
"""

import json
import os
import re
import subprocess
import sys
from functools import lru_cache

import jax
import numpy as np
import optax
import pytest
import torch

from multidisttorch_tpu.data.datasets import synthetic_mnist
from multidisttorch_tpu.hpo.driver import TrialConfig as JaxTrialConfig
from multidisttorch_tpu.hpo.driver import run_hpo as jax_run_hpo
from multidisttorch_tpu.models.vae import VAE as JaxVAE
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train.steps import build_train_state
from multidisttorch_tpu_torch.data.datasets import Dataset
from multidisttorch_tpu_torch.hpo import driver
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.models.vae import vae_params_from_flax
from multidisttorch_tpu_torch.parallel.mesh import setup_groups


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch_size=32, hidden_dim=16, latent_dim=4, log_interval=4)


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1)


@lru_cache(maxsize=None)
def _jax_initial_params(seed: int, hidden: int, latent: int):
    # What the JAX driver's trial starts from: create_train_state's
    # build_train_state with jax.random.key(cfg.seed).
    state = build_train_state(
        JaxVAE(hidden_dim=hidden, latent_dim=latent), optax.adam(1e-3), jax.random.key(seed)
    )
    return vae_params_from_flax(jax.device_get(state.params))


@pytest.fixture
def carried(monkeypatch):
    def init_from_jax(model, seed):
        model.load_state_dict(_jax_initial_params(seed, model.hidden_dim, model.latent_dim))
        return model

    monkeypatch.setattr(driver, "init_vae_params", init_from_jax)


def _both(configs, data, tmp_path, capsys=None, **kw):
    """Run the configs through both packages on len(groups) one-device
    groups; returns (jax results, port results, jax log, port log)."""
    train, test = data
    n = kw.pop("ngroups", 2)
    kw.setdefault("save_images", False)
    kw.setdefault("verbose", capsys is not None)
    jres = jax_run_hpo(
        [JaxTrialConfig(**c) for c in configs], train, test,
        groups=jax_setup_groups(n, devices=jax.devices()[:n]),
        out_dir=str(tmp_path / "jax"), save_checkpoints=False, ledger=False, **kw,
    )
    jlog = capsys.readouterr().out if capsys is not None else ""
    pres = run_hpo(
        [TrialConfig(**c) for c in configs], train, test,
        groups=setup_groups(n, devices=["cpu"] * n),
        out_dir=str(tmp_path / "port"), **kw,
    )
    plog = capsys.readouterr().out if capsys is not None else ""
    return jres, pres, jlog, plog


def _shape(log: str) -> list[str]:
    """Log lines with every number blanked: the format and cadence."""
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in log.splitlines() if ln.startswith("[")]


def test_lr0_test_losses_queueing_and_logs_match_jax(data, tmp_path, carried, capsys):
    # 3 configs on 2 groups, epochs 1/2/1: config 2 queues and takes the
    # group trial 0 frees first.
    configs = [dict(trial_id=i, epochs=e, seed=i, lr=0.0, **SMALL) for i, e in enumerate((1, 2, 1))]
    jres, pres, jlog, plog = _both(configs, data, tmp_path, capsys)
    assert [r.trial_id for r in pres] == [0, 1, 2]
    assert [r.group_id for r in pres] == [r.group_id for r in jres] == [0, 1, 0]
    assert [r.steps for r in pres] == [r.steps for r in jres] == [8, 16, 8]
    for p, j in zip(pres, jres):
        assert p.status == "completed" and p.dataset == j.dataset == "synthetic-mnist"
        assert p.dataset_synthetic and j.dataset_synthetic
        assert [h["epoch"] for h in p.history] == [h["epoch"] for h in j.history]
        for ph, jh in zip(p.history, j.history):
            assert ph["test_loss"] == pytest.approx(jh["test_loss"], rel=1e-5)
        assert p.final_test_loss == pytest.approx(j.final_test_loss, rel=1e-5)
    assert _shape(plog) == _shape(jlog)
    assert "Train Epoch: 1 [0/256 (0%)]\tLoss:" in plog
    assert "[0:0] ====> Test set loss:" in plog


def test_lr1e3_final_test_loss_within_jax_seed_spread(data, tmp_path, carried):
    # Tolerance = the JAX package's own final-test-loss spread across seeds
    # 0, 1, 2 (max - min over mean), no looser than 5 %.
    configs = [dict(trial_id=i, epochs=2, seed=i, lr=1e-3, **SMALL) for i in range(3)]
    train, test = data
    spread_runs = jax_run_hpo(
        [JaxTrialConfig(**c) for c in configs], train, test,
        groups=jax_setup_groups(3, devices=jax.devices()[:3]),
        out_dir=str(tmp_path / "spread"), save_images=False, save_checkpoints=False,
        ledger=False, verbose=False,
    )
    finals = np.array([r.final_test_loss for r in spread_runs])
    tol = min(0.05, float((finals.max() - finals.min()) / finals.mean()))
    assert tol > 0
    jres, pres, _, _ = _both(configs[:2], data, tmp_path)
    for p, j in zip(pres, jres):
        assert p.steps == j.steps == 16
        assert abs(p.final_test_loss - j.final_test_loss) / j.final_test_loss <= tol
        assert p.history[-1]["test_loss"] < p.history[0]["test_loss"]


def test_fused_and_plain_loss_train_to_the_same_numbers(data, tmp_path, monkeypatch):
    # run_hpo always trains through the fused loss; the plain run swaps the
    # unfused loss in through the driver's make_multi_step.
    train, test = data
    fused_multi_step = driver.make_multi_step
    runs = []
    for fused in (True, False):
        monkeypatch.setattr(
            driver, "make_multi_step",
            lambda group, **kw: fused_multi_step(group, use_fused_loss=fused, **kw),
        )
        runs.append(run_hpo([TrialConfig(trial_id=0, epochs=2, **SMALL)], train, test,
                            groups=setup_groups(1, devices=["cpu"]),
                            out_dir=str(tmp_path / str(fused)),
                            save_images=False, verbose=False)[0])
    assert runs[0].steps == runs[1].steps == 16
    for a, b in zip(runs[0].history, runs[1].history):
        assert a["avg_train_loss"] == pytest.approx(b["avg_train_loss"], rel=1e-5)
        assert a["test_loss"] == pytest.approx(b["test_loss"], rel=1e-5)


def test_fused_steps_keep_step_count_and_log_cadence(data, tmp_path, carried, capsys):
    # 8 batches in chunks of 3 with log_interval 2: batches 0, 2, 4, 6 log,
    # as in a one-step loop.
    cfg = dict(SMALL, log_interval=2, fused_steps=3)
    configs = [dict(trial_id=i, epochs=1, seed=i, **cfg) for i in range(2)]
    jres, pres, jlog, plog = _both(configs, data, tmp_path, capsys)
    assert [r.steps for r in pres] == [r.steps for r in jres] == [8, 8]
    assert _shape(plog) == _shape(jlog)
    for start in (0, 64, 128, 192):
        assert f"[{start}/256" in plog


def test_shard_across_trials_matches_jax_step_counts(data, tmp_path, carried):
    configs = [dict(trial_id=i, epochs=1, seed=i, lr=0.0, **SMALL) for i in range(2)]
    jres, pres, _, _ = _both(configs, data, tmp_path, shard_across_trials=True)
    assert [r.steps for r in pres] == [r.steps for r in jres] == [4, 4]
    for p, j in zip(pres, jres):
        assert p.final_test_loss == pytest.approx(j.final_test_loss, rel=1e-5)


def test_outputs_and_host_syncs(data, tmp_path):
    train, test = data
    (r,) = run_hpo([TrialConfig(trial_id=7, epochs=2, **SMALL)], train, test,
                   groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path), verbose=False)
    # Two fetches per epoch (train and test averages) and no others.
    assert r.host_syncs == 4 and r.steps == 16 and r.wall_s > 0
    files = set(os.listdir(r.out_dir))
    assert r.out_dir == str(tmp_path / "trial-7") and "metrics.json" in files
    assert {"reconstruction_1", "sample_2"} <= {os.path.splitext(f)[0] for f in files}
    with open(os.path.join(r.out_dir, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["trial_id"] == 7 and metrics["dataset_synthetic"] is True
    assert len(metrics["history"]) == 2 and metrics["steps"] == 16


def test_non_finite_loss_is_a_diverged_result(data, tmp_path):
    train, test = data
    poisoned = Dataset(np.full_like(train.images, np.nan), train.labels, "poisoned")
    (r,) = run_hpo([TrialConfig(trial_id=0, epochs=2, **SMALL)], poisoned, test,
                   groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path),
                   save_images=False, verbose=False)
    assert r.status == "diverged" and "non-finite" in r.error and r.steps == 8


@pytest.mark.parametrize("name", sorted(driver._UNPORTED_ARGS))
def test_unported_run_hpo_arguments_raise(data, tmp_path, name):
    item = driver._UNPORTED_ARGS[name][1].split()[0]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {re.escape(item)}"):
        run_hpo([TrialConfig(trial_id=0, **SMALL)], data[0], groups=setup_groups(1, devices=["cpu"]),
                out_dir=str(tmp_path), **{name: "set"})


@pytest.mark.parametrize("field, value", [("dataset", "cas:x"), ("zero_update", True), ("pipeline_stages", 2)])
def test_unported_config_fields_raise(data, tmp_path, field, value):
    cfg = TrialConfig(trial_id=0, **SMALL, **{field: value})
    # TrialConfig.dataset is ported now: a malformed reference is refused by
    # the dataset store at sweep entry, before any trial starts.
    error, match = (ValueError, "cas digest") if field == "dataset" else (NotImplementedError, "ROADMAP A")
    with pytest.raises(error, match=match):
        run_hpo([cfg], data[0], groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path))


def test_trial_config_mirrors_jax():
    from dataclasses import fields

    assert [(f.name, f.default) for f in fields(TrialConfig)] == [
        (f.name, f.default) for f in fields(JaxTrialConfig)
    ]


def test_example_cli_runs_on_cpu(tmp_path, capsys):
    from multidisttorch_tpu_torch.examples import vae_hpo

    results = vae_hpo.main(["--device", "cpu", "--ngroups", "1", "--epochs", "1",
                            "--synthetic-size", "256", "--batch-size", "32",
                            "--out-dir", str(tmp_path)])
    assert [r.steps for r in results] == [8]
    assert "trial 0: 8 steps" in capsys.readouterr().out
    # --remat trains, to the same numbers as without it.
    remat = vae_hpo.main(["--device", "cpu", "--ngroups", "1", "--epochs", "1",
                          "--synthetic-size", "256", "--batch-size", "32",
                          "--out-dir", str(tmp_path / "remat"), "--remat"])
    assert remat[0].config.remat and [r.steps for r in remat] == [8]
    assert remat[0].final_train_loss == results[0].final_train_loss


# Modules the walks below must reach (the model families' slice among them).
PORT_MODULES = (
    "models.conv_vae", "models.moe_vae", "models.resnet", "models.layers", "models._flax", "ops.moe",
    "train.classifier", "examples.beta_vae_cifar", "examples.moe_vae_hpo", "examples.resnet_hpo",
    "faults.plan", "faults.inject", "faults.harness", "telemetry.events", "telemetry.metrics",
    "telemetry.export", "telemetry.console", "examples.chaos_run",
    "compile.programs", "compile.registry", "compile.farm", "compile.cache", "compile.coldstart", "train.adam",
    "train.streams", "telemetry.device", "telemetry.anomaly", "utils.profiling", "utils.preflight",
    "parallel.membership", "telemetry.fleet", "examples.sweep_supervisor", "examples.elastic_worker",
    "telemetry.ctlprof", "telemetry.slo", "telemetry.trace", "data.store", "service.queue", "service.scheduler",
    "service.defrag", "service.runtime", "service.drill", "examples.sweep_service", "examples.sweep_submit",
    "telemetry.incident", "service.incident_drill", "tools.sweep_top", "tools.ledger_view", "tools.sweep_trace",
    "tools.ckpt_gc", "tools.incident",
)


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib, multidisttorch_tpu_torch as m\n"
        "names = [i.name for i in pkgutil.walk_packages(m.__path__, 'multidisttorch_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"assert not set('multidisttorch_tpu_torch.' + n for n in {PORT_MODULES!r}) - set(names), names\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not {'msgpack', 'flax', 'optax'} & set(sys.modules), 'msgpack, flax or optax imported'\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'multidisttorch_tpu']\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=REPO))


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import (flax|optax|msgpack)|from (flax|optax|msgpack)(\.\w+)* import\b"
        r"|import multidisttorch_tpu\b(?!_)|from multidisttorch_tpu\b(?!_))"
        r"|multidisttorch_tpu\.", re.M
    )
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "multidisttorch_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) > 15
    for name in PORT_MODULES:
        assert os.path.join(REPO, "multidisttorch_tpu_torch", *name.split(".")) + ".py" in sources, name
    for path in sources:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, f"{path}: {hits}"
