"""The port's ``run_hpo`` with checkpoints, resume and supervised retries.

Mirrors of ``tests/test_hpo.py``'s resume and isolation tests and of
``tests/test_faults.py``'s supervision drills, on the CPU at hidden 16,
latent 4, 256 rows, batch 32 (8 steps an epoch). Faults are injected here
by wrapping the driver's data iterator or ``save_state``; the fault plans'
own drills are in ``tests/test_torch_faults.py``. On the CPU a resumed or retried sweep ends
bit-identical to the uninterrupted one: parameters, Adam moments, step,
history and generator states. Also: a sweep the JAX package checkpointed
resumed by the port, the snapshot being the boundary's state while the
write runs behind, and a two-rank gloo group agreeing on its restore step
and on a writer-only failure.
"""

import json
import os
import shutil
import sys
import time

import jax
import numpy as np
import pytest
import torch

from multidisttorch_tpu.data.datasets import synthetic_mnist
from multidisttorch_tpu.faults.inject import corrupt_file
from multidisttorch_tpu.hpo.driver import TrialConfig as JaxTrialConfig
from multidisttorch_tpu.hpo.driver import run_hpo as jax_run_hpo
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu_torch.faults.inject import HostPreemption
from multidisttorch_tpu_torch.hpo import driver
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.collectives import group_all_ok, group_min_scalar
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch_size=32, hidden_dim=16, latent_dim=4, log_interval=100)
STEPS = 8  # 256 rows / batch 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1)


def _cfg(trial_id, **kw):
    return TrialConfig(**{**dict(trial_id=trial_id, epochs=3, seed=trial_id, **SMALL), **kw})


def _sweep(configs, data, out_dir, **kw):
    base = dict(
        groups=setup_groups(1, devices=["cpu"]), out_dir=str(out_dir), verbose=False,
        save_images=False, resilient=True, retry=RetryPolicy(max_retries=2, backoff_base_s=0.01),
    )
    base.update(kw)
    return run_hpo(configs, data[0], data[1], **base)


def _events(out_dir, trial_id=None, status=None):
    evs = SweepLedger(str(out_dir)).load()
    if trial_id is not None:
        evs = [e for e in evs if e.get("trial_id") == trial_id]
    if status is not None:
        evs = [e for e in evs if e.get("status") == status]
    return evs


def _ends(out_dir, trial_id):
    return [e["status"] for e in _events(out_dir, trial_id) if e["event"] == "attempt_end"]


def _final(out_dir, trial_id=0):
    """The trial's last checkpoint: its state tree and its sidecar."""
    path = os.path.join(str(out_dir), f"trial-{trial_id}", "state.msgpack")
    with open(path + ".json") as f:
        meta = json.load(f)
    return ck._read_tree(path), meta


def _assert_same_run(a_dir, b_dir, trial_id=0):
    """Two sweeps ended in the same state: every leaf of the final
    checkpoint, its step, history and generator states, bit for bit."""
    (ta, ma), (tb, mb) = _final(a_dir, trial_id), _final(b_dir, trial_id)
    fa, fb = _flat(ta), _flat(tb)
    assert list(fa) == list(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]) and fa[k].dtype == fb[k].dtype, k
    for key in ("step", "completed_epochs", "history", driver.GENERATORS_KEY):
        assert ma[key] == mb[key], key


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {} if tree else {prefix: np.zeros(0)}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _fault(monkeypatch, seed, step, exc=lambda: RuntimeError("injected crash"), fires=1, poison=False):
    """Fail (or, with ``poison``, NaN-poison) the train chunk of trial
    ``seed`` that would take global step ``step``, ``fires`` times."""
    left = {"n": fires}
    real = driver.TrialDataIterator

    class Faulty(real):
        def epoch_chunks(self, epoch, k):
            for i0, chunk in super().epoch_chunks(epoch, k):
                first = (epoch - 1) * self.num_batches + i0
                if self.seed == seed and left["n"] > 0 and first <= step < first + chunk.shape[0]:
                    left["n"] -= 1
                    if not poison:
                        raise exc()
                    chunk = chunk * float("nan")
                yield i0, chunk

    monkeypatch.setattr(driver, "TrialDataIterator", Faulty)


# --- resume (tests/test_hpo.py) -------------------------------------------


def test_resume_continues_from_checkpoint(data, tmp_path):
    r1 = _sweep([_cfg(0, epochs=1)], data, tmp_path)[0]
    assert r1.steps == STEPS and r1.checkpoint.endswith("state.msgpack")
    r2 = _sweep([_cfg(0, epochs=3)], data, tmp_path, resume=True)[0]
    assert r2.status == "completed" and r2.steps == 3 * STEPS and len(r2.history) == 3
    assert r2.history[0] == r1.history[0] and r2.resumed_from_step == STEPS
    r3 = _sweep([_cfg(0, epochs=3)], data, tmp_path, resume=True)[0]
    assert r3.status == "resumed_complete" and r3.steps == 3 * STEPS


@pytest.mark.parametrize("fmt, fused_steps, images", [("v1", 1, False), ("v2", 3, True)])
def test_resume_matches_uninterrupted_run_bitwise(data, tmp_path, monkeypatch, fmt, fused_steps, images):
    # Sampled eval and the prior samples draw from the trial's other two
    # generators: their states must carry across the resume too.
    monkeypatch.setenv("MDT_CKPT_FORMAT", fmt)
    kw = dict(fused_steps=fused_steps, eval_sampled=True)
    straight = _sweep([_cfg(0, epochs=2, **kw)], data, tmp_path / "straight", save_images=images)[0]
    _sweep([_cfg(0, epochs=1, **kw)], data, tmp_path / "resumed", save_images=images)
    resumed = _sweep([_cfg(0, epochs=2, **kw)], data, tmp_path / "resumed", save_images=images, resume=True)[0]
    assert resumed.history == straight.history and resumed.steps == straight.steps == 2 * STEPS
    assert resumed.final_train_loss == straight.final_train_loss
    _assert_same_run(tmp_path / "straight", tmp_path / "resumed")
    assert ck.verify_checkpoint(resumed.checkpoint)[2] == "ok"
    with open(resumed.checkpoint, "rb") as f:
        assert f.read(1) == (b"{" if fmt == "v2" else b"\x83")


def test_resume_refuses_changed_hyperparameters(data, tmp_path):
    _sweep([_cfg(0, epochs=1, lr=1e-3)], data, tmp_path)
    with pytest.raises(ValueError, match="different\\s+hyperparameters"):
        _sweep([_cfg(0, epochs=2, lr=1e-2)], data, tmp_path, resume=True, resilient=False)


def test_resume_detects_state_metadata_skew(data, tmp_path):
    _sweep([_cfg(0, epochs=2)], data, tmp_path)
    meta_path = tmp_path / "trial-0" / "state.msgpack.json"
    meta = json.loads(meta_path.read_text())
    meta["completed_epochs"] -= 1
    meta["step"] -= STEPS
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="skewed"):
        _sweep([_cfg(0, epochs=3)], data, tmp_path, resume=True, resilient=False)


def test_checkpoint_files_are_atomic_no_tmp_left(data, tmp_path):
    _sweep([_cfg(0, epochs=2)], data, tmp_path, ckpt_keep_last=2)
    names = {p.name for p in (tmp_path / "trial-0").iterdir()}
    assert {"state.msgpack", "state.msgpack.json", "state.msgpack.v0000000016", "chunks"} <= names
    assert not any(n.endswith(".tmp") for n in names)


def test_checkpoint_write_failure_fails_trial_not_sweep(data, tmp_path, monkeypatch):
    real_save = driver.save_state

    def failing_save(state, path, **kw):
        if "trial-1" in path:
            raise OSError("disk full")
        return real_save(state, path, **kw)

    monkeypatch.setattr(driver, "save_state", failing_save)
    results = _sweep([_cfg(0, epochs=1), _cfg(1, epochs=1)], data, tmp_path, retry=None)
    by_id = {r.trial_id: r for r in results}
    assert by_id[0].status == "completed" and os.path.exists(by_id[0].checkpoint)
    assert by_id[1].status == "failed" and "checkpoint write" in by_id[1].error
    assert by_id[1].checkpoint == ""


def test_resilient_sweep_isolates_setup_failures_and_default_raises(data, tmp_path, monkeypatch):
    real_init = driver.init_vae_params

    def init(model, seed):
        if seed == 1:
            raise RuntimeError("boom")
        return real_init(model, seed)

    monkeypatch.setattr(driver, "init_vae_params", init)
    results = _sweep([_cfg(i, epochs=1) for i in range(3)], data, tmp_path, retry=None)
    assert {r.trial_id: r.status for r in results} == {0: "completed", 1: "failed", 2: "completed"}
    assert "boom" in results[1].error and _ends(tmp_path, 1) == ["failed"]
    with pytest.raises(RuntimeError, match="boom"):
        _sweep([_cfg(1, epochs=1)], data, tmp_path / "raise", resilient=False)


def test_snapshot_is_the_boundary_state_while_the_write_runs_behind(data, tmp_path, monkeypatch):
    # The writer sleeps while the next epoch trains on; the epoch-1 file
    # must still hold epoch 1's state.
    _sweep([_cfg(0, epochs=1)], data, tmp_path / "one")
    monkeypatch.setenv("MDT_CKPT_PERSIST_DELAY_S", "0.5")
    _sweep([_cfg(0, epochs=2)], data, tmp_path / "two", ckpt_keep_last=2)
    one, _ = _final(tmp_path / "one")
    epoch1 = ck._read_tree(str(tmp_path / "two" / "trial-0" / "state.msgpack.v0000000008"))
    fa, fb = _flat(one), _flat(epoch1)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_the_write_runs_behind_the_next_epoch_and_is_joined(data, tmp_path, monkeypatch):
    monkeypatch.setenv("MDT_CKPT_PERSIST_DELAY_S", "1.0")
    run = driver._TrialRun(setup_groups(1, devices=["cpu"])[0], _cfg(0, epochs=2), data[0], data[1],
                           str(tmp_path), save_images=False, verbose=False)
    gen = run.run()
    while run._ckpt_thread is None:
        next(gen)
    assert not run._ckpt_idle() and run.result.checkpoint == ""
    next(gen)  # epoch 2's first chunk trains while epoch 1's write sleeps
    assert run.state.step > STEPS + 1 and not run._ckpt_idle()
    for _ in gen:
        pass
    assert run._ckpt_idle() and run.result.checkpoint == str(tmp_path / "trial-0" / "state.msgpack")
    assert json.loads((tmp_path / "trial-0" / "state.msgpack.json").read_text())["step"] == 2 * STEPS


# --- supervision (tests/test_faults.py) -----------------------------------


def test_injected_crash_retried_resumes_bit_identical(data, tmp_path, monkeypatch):
    clean = _sweep([_cfg(0)], data, tmp_path / "clean")[0]
    _fault(monkeypatch, seed=0, step=STEPS + 3)
    (r,) = _sweep([_cfg(0)], data, tmp_path / "chaos")
    assert r.status == "completed" and r.attempt == 2 and r.steps == 3 * STEPS
    assert r.history == clean.history and r.resumed_from_step == STEPS
    _assert_same_run(tmp_path / "clean", tmp_path / "chaos")
    assert _ends(tmp_path / "chaos", 0) == ["retrying", "completed"]
    done = _events(tmp_path / "chaos", 0, "completed")[0]
    assert done["summary"]["resumed_from_step"] == STEPS
    retrying = _events(tmp_path / "chaos", 0, "retrying")[0]
    assert retrying["summary"] == {"resumed_from_step": 0, "steps_at_failure": STEPS + 3}


def test_retry_budget_exhaustion_fails_trial_only(data, tmp_path, monkeypatch):
    _fault(monkeypatch, seed=0, step=STEPS + 2, fires=10)
    results = _sweep([_cfg(0), _cfg(1)], data, tmp_path, retry=RetryPolicy(max_retries=1, backoff_base_s=0.01))
    by_id = {r.trial_id: r for r in results}
    assert by_id[0].status == "failed" and by_id[0].attempt == 2
    # The work the last attempt executed: a resumed epoch 1 plus 2 steps.
    assert by_id[0].steps == STEPS + 2 and by_id[0].resumed_from_step == STEPS
    assert by_id[1].status == "completed"
    assert _ends(tmp_path, 0) == ["retrying", "failed"]
    assert _events(tmp_path, 0, "failed")[0]["summary"]["steps_at_failure"] == STEPS + 2


def test_no_retry_policy_preserves_plain_failure(data, tmp_path, monkeypatch):
    _fault(monkeypatch, seed=0, step=2)
    (r,) = _sweep([_cfg(0)], data, tmp_path, retry=None)
    assert r.status == "failed" and r.attempt == 1 and "injected crash" in r.error


def test_corrupt_checkpoint_scanned_past_on_retry(data, tmp_path, monkeypatch):
    clean = _sweep([_cfg(0)], data, tmp_path / "clean")[0]
    real_save = driver.save_state

    def save_then_rot(state, path, **kw):
        out = real_save(state, path, **kw)
        if kw["metadata"]["completed_epochs"] == 2:
            corrupt_file(path)  # after its retained copy was taken
        return out

    monkeypatch.setattr(driver, "save_state", save_then_rot)
    _fault(monkeypatch, seed=0, step=2 * STEPS + 3)
    (r,) = _sweep([_cfg(0)], data, tmp_path / "chaos", ckpt_keep_last=2)
    assert r.status == "completed" and r.attempt == 2 and r.resumed_from_step == 2 * STEPS
    assert r.history == clean.history
    _assert_same_run(tmp_path / "clean", tmp_path / "chaos")


def test_corrupt_only_checkpoint_retries_from_scratch(data, tmp_path, monkeypatch):
    clean = _sweep([_cfg(0)], data, tmp_path / "clean")[0]
    real_save = driver.save_state

    def save_then_rot(state, path, **kw):
        out = real_save(state, path, **kw)
        if kw["metadata"]["completed_epochs"] == 1:
            corrupt_file(path)
        return out

    monkeypatch.setattr(driver, "save_state", save_then_rot)
    _fault(monkeypatch, seed=0, step=STEPS + 3)
    (r,) = _sweep([_cfg(0)], data, tmp_path / "chaos")
    assert r.status == "completed" and r.attempt == 2 and r.resumed_from_step == 0
    assert r.history == clean.history
    _assert_same_run(tmp_path / "clean", tmp_path / "chaos")


def test_divergence_is_terminal_not_retried(data, tmp_path, monkeypatch):
    _fault(monkeypatch, seed=0, step=2, poison=True)
    results = _sweep([_cfg(0), _cfg(1)], data, tmp_path)
    by_id = {r.trial_id: r for r in results}
    assert by_id[0].status == "diverged" and by_id[0].attempt == 1
    assert "non-finite" in by_id[0].error and by_id[0].steps == STEPS
    assert by_id[1].status == "completed"
    assert _ends(tmp_path, 0) == ["diverged"]
    # No checkpoint of the diverged epoch was written.
    assert not os.path.exists(tmp_path / "trial-0" / "state.msgpack")


def test_preemption_propagates_and_restart_skips_completed(data, tmp_path, monkeypatch):
    _fault(monkeypatch, seed=1, step=STEPS + 2, exc=lambda: HostPreemption("host going away"))
    with pytest.raises(HostPreemption):
        _sweep([_cfg(0), _cfg(1)], data, tmp_path)
    assert len(SweepLedger(str(tmp_path)).finished()) == 1
    assert _ends(tmp_path, 1) == ["preempted"]
    results = _sweep([_cfg(0), _cfg(1)], data, tmp_path, resume=True)
    by_id = {r.trial_id: r for r in results}
    assert by_id[0].status == "resumed_complete" and by_id[0].attempt == 1
    assert by_id[0].steps == 3 * STEPS and np.isfinite(by_id[0].final_train_loss)
    assert by_id[1].status == "completed" and by_id[1].attempt == 2
    assert by_id[1].resumed_from_step == STEPS


def test_backoff_does_not_block_other_trials(data, tmp_path, monkeypatch):
    _fault(monkeypatch, seed=0, step=2)
    t0 = time.time()
    results = _sweep([_cfg(0, epochs=1), _cfg(1, epochs=1)], data, tmp_path,
                     retry=RetryPolicy(max_retries=1, backoff_base_s=1.5))
    assert time.time() - t0 < 30
    assert [(r.status, r.attempt) for r in results] == [("completed", 2), ("completed", 1)]
    # Trial 1 ran to its end inside trial 0's backoff window.
    evs = SweepLedger(str(tmp_path)).load()
    done1 = next(j for j, e in enumerate(evs) if e["trial_id"] == 1 and e.get("status") == "completed")
    retry0 = next(j for j, e in enumerate(evs) if e["trial_id"] == 0 and e.get("attempt") == 2)
    assert done1 < retry0
    retrying = next(e for e in evs if e["trial_id"] == 0 and e.get("status") == "retrying")
    assert evs[retry0]["ts"] - retrying["ts"] >= 1.5


def test_resume_integrity_guard_not_defeated_by_retry(data, tmp_path):
    _sweep([_cfg(0, epochs=1, lr=1e-3)], data, tmp_path)
    ckpt = tmp_path / "trial-0" / "state.msgpack"
    before = ckpt.read_bytes()
    with pytest.raises(ValueError, match="different\\s+hyperparameters"):
        _sweep([_cfg(0, epochs=2, lr=5e-3)], data, tmp_path, resume=True, resilient=False)
    (r,) = _sweep([_cfg(0, epochs=2, lr=5e-3)], data, tmp_path, resume=True)
    assert r.status == "failed" and r.attempt == 2 and "different hyperparameters" in r.error
    assert not _events(tmp_path, 0, "retrying")
    assert ckpt.read_bytes() == before


def test_resume_rejects_an_unknown_mode(data, tmp_path):
    with pytest.raises(ValueError, match="resume must be"):
        _sweep([_cfg(0, epochs=1)], data, tmp_path, resume="yes")


# --- the JAX package's checkpoints ----------------------------------------


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_a_jax_sweep_resumed_by_the_port_at_lr0_gives_jaxs_test_loss(data, tmp_path, monkeypatch, fmt):
    monkeypatch.setenv("MDT_CKPT_FORMAT", fmt)
    train, test = data
    cfg = dict(trial_id=0, seed=0, lr=0.0, **SMALL)
    kw = dict(groups=jax_setup_groups(1, devices=jax.devices()[:1]), save_images=False, verbose=False)
    (straight,) = jax_run_hpo([JaxTrialConfig(epochs=2, **cfg)], train, test, out_dir=str(tmp_path / "straight"), **kw)
    (first,) = jax_run_hpo([JaxTrialConfig(epochs=1, **cfg)], train, test, out_dir=str(tmp_path / "run"), **kw)
    (r,) = run_hpo([TrialConfig(epochs=2, **cfg)], train, test, groups=setup_groups(1, devices=["cpu"]),
                   out_dir=str(tmp_path / "run"), save_images=False, verbose=False, resume=True)
    assert r.status == "completed" and r.resumed_from_step == STEPS and r.steps == 2 * STEPS
    assert r.history[0] == first.history[0]
    assert r.history[1]["test_loss"] == pytest.approx(straight.history[1]["test_loss"], rel=1e-5)


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_a_port_sweep_resumed_by_jax(data, tmp_path, monkeypatch, fmt):
    # The JAX driver reads the port's checkpoint and sidecar (whose extra
    # generator key no config check looks at) and continues it. At lr 0
    # the weights stay the port's, so JAX's epoch-2 test loss is the
    # port's epoch-1 one.
    from multidisttorch_tpu.hpo.driver import config_mismatch_vs_meta as jax_mismatch

    monkeypatch.setenv("MDT_CKPT_FORMAT", fmt)
    train, test = data
    cfg = dict(trial_id=0, seed=0, lr=0.0, **SMALL)
    (first,) = run_hpo([TrialConfig(epochs=1, **cfg)], train, test, groups=setup_groups(1, devices=["cpu"]),
                       out_dir=str(tmp_path), save_images=False, verbose=False)
    _, meta = _final(tmp_path)
    assert driver.GENERATORS_KEY in meta
    assert jax_mismatch(JaxTrialConfig(epochs=2, **cfg), meta) == {}
    assert driver.config_mismatch_vs_meta(TrialConfig(epochs=2, **cfg), meta) == {}
    (r,) = jax_run_hpo([JaxTrialConfig(epochs=2, **cfg)], train, test,
                       groups=jax_setup_groups(1, devices=jax.devices()[:1]), out_dir=str(tmp_path),
                       save_images=False, verbose=False, resume=True)
    assert r.status == "completed" and r.resumed_from_step == STEPS and r.steps == 2 * STEPS
    assert r.history[0] == first.history[0]
    assert r.history[1]["test_loss"] == pytest.approx(first.history[0]["test_loss"], rel=1e-5)


# --- agreement primitives and a two-rank group ----------------------------


def test_one_rank_agreements_and_the_deadline():
    g = setup_groups(1, devices=["cpu"])[0]
    assert group_all_ok(g, True) and not group_all_ok(g, False)
    assert group_min_scalar(g, 7) == 7
    with pytest.raises(cluster.WedgedCollective, match="stuck agreement did not complete"):
        cluster.call_with_timeout(lambda: time.sleep(5), 0.1, "stuck agreement", error_cls=cluster.WedgedCollective)
    assert cluster.call_with_timeout(lambda: 3, 1.0, "quick") == 3
    assert cluster.env_timeout("MDT_NO_SUCH_TIMEOUT", 600.0) == 600.0


_RANK_MAIN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo import driver
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups

out_dir, result_path, images_dir = sys.argv[1:4]
world, rank = cluster.initialize_runtime(device="cpu")
group = setup_groups(1, device="cpu")[0]
train, test = synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1)
small = dict(batch_size=32, hidden_dim=16, latent_dim=4, log_interval=100)
got = {}
# (a) The ranks see different checkpoint histories; they agree on the
# smaller newest valid step and both resume from it.
(r,) = driver.run_hpo([driver.TrialConfig(trial_id=0, epochs=3, seed=0, **small)], train, test,
                      groups=[group], out_dir=out_dir, save_images=False, verbose=False,
                      resilient=True, resume="scan", agree_timeout_s=60)
got["scan"] = [r.status, r.resumed_from_step, r.steps]
# (b) The writer's image write fails: deferred to the epoch boundary,
# where both ranks end the trial together.
def broken_write(*a, **k):
    raise OSError("image disk full")
driver.save_image_grid = broken_write
(r,) = driver.run_hpo([driver.TrialConfig(trial_id=1, epochs=2, seed=1, **small)], train, test,
                      groups=[group], out_dir=images_dir, verbose=False, resilient=True, agree_timeout_s=60)
got["images"] = [r.status, r.steps, r.error]
with open(result_path, "w") as f:
    json.dump(got, f)
cluster.shutdown_runtime()
"""


def test_two_rank_group_agrees_on_restore_step_and_on_a_writer_failure(data, tmp_path):
    from test_torch_groups import _launch

    # Rank 0's history holds epochs 1 and 2; rank 1's newest (epoch 2)
    # manifests are torn, so its newest valid step is epoch 1's.
    _sweep([_cfg(0, epochs=2)], data, tmp_path / "r0", ckpt_keep_last=2)
    shutil.copytree(tmp_path / "r0", tmp_path / "r1")
    for name in ("state.msgpack", "state.msgpack.v0000000016"):
        with open(tmp_path / "r1" / "trial-0" / name, "r+b") as f:
            f.truncate(10)
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, "-c", _RANK_MAIN, str(tmp_path / f"r{r}"), outs[r],
                       str(tmp_path / f"img{r}")], 2, timeout=150)
    got = []
    for out in outs:
        with open(out) as f:
            got.append(json.load(f))
    assert [g["scan"] for g in got] == [["completed", STEPS, 3 * STEPS]] * 2
    assert [g["images"][:2] for g in got] == [["failed", STEPS]] * 2
    assert "image disk full" in got[0]["images"][2]
    assert "failed on a peer rank" in got[1]["images"][2]
