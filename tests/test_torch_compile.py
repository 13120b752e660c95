"""The port's compile and dispatch (``multidisttorch_tpu_torch/compile/``):
program keys, the registry of program slots, the precapture farm and the
driver's admission, against the JAX package's contracts
(``tests/test_compile_farm.py``) where both can run on the CPU.

The CPU captures no CUDA graph, so a slot here is its state, its generator
and the eager step (``compile/programs.py``): the registry's ownership,
coalescing, eviction and admission logic run as on a card, with injected
builders where a test needs a slow, gated or broken capture. What holds
only on a card (the graphs rebound by value, the farm capturing beside
replays) is ``chip_smoke.py``'s phase 16.

Tolerances: a sweep admitted through the registry (hits, waits, inline
builds, the farm) and the same sweep with the registry off
(``MDT_AOT_ADMISSION=0``) give bit-identical losses and checkpointed
parameters; program labels match the JAX package's up to the group
anchor.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from multidisttorch_tpu.compile import programs as jax_cprog
from multidisttorch_tpu.hpo.driver import TrialConfig as JaxTrialConfig
from multidisttorch_tpu.hpo.driver import stack_bucket_key as jax_stack_bucket_key
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.telemetry.export import SweepFold as JaxSweepFold
from multidisttorch_tpu_torch import telemetry
from multidisttorch_tpu_torch.compile import programs as cprog
from multidisttorch_tpu_torch.compile.farm import PrecompilePool, default_workers
from multidisttorch_tpu_torch.compile.registry import (
    CLAIMED,
    COMPILING,
    FAILED,
    PENDING,
    READY,
    ExecutableRegistry,
    get_executable_registry,
)
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.faults import CRASH, FaultPlan, FaultSpec
from multidisttorch_tpu_torch.hpo import driver
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo, stack_bucket_key
from multidisttorch_tpu_torch.hpo.pbt import PBTConfig, run_pbt
from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.telemetry.events import EVENTS_NAME, read_events
from multidisttorch_tpu_torch.telemetry.export import SweepFold

SMALL = dict(batch_size=16, hidden_dim=16, latent_dim=4, log_interval=10_000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registry():
    # Process-lifetime by design: no test may lean on another's slots.
    get_executable_registry().reset()
    yield
    get_executable_registry().reset()
    telemetry.disable()


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(128, seed=0), synthetic_mnist(32, seed=1)


def _cfg(**kw):
    base = dict(trial_id=0, epochs=1, lr=1e-3, seed=7, **SMALL)
    base.update(kw)
    return TrialConfig(**base)


def _cpu_groups(n):
    return setup_groups(n, devices=["cpu"] * n)


class _Slot:
    """A slot stand-in with the registry's interface (signature, free)."""

    def __init__(self, tag=None):
        self.tag = tag
        self.freed = 0

    def signature(self):
        return ("sig", self.tag)

    def free(self):
        self.freed += 1


def _key(i, kind="train"):
    return (kind, (16, 16, 4, 1, 1, False), (1e-3 * (i + 1), 1.0), (0, (0,), "cpu"))


# -- the key vocabulary --------------------------------------------------------


def test_single_keys_bake_hypers_and_labels_match_jax():
    g = _cpu_groups(1)[0]
    a, b = _cfg(lr=1e-3), _cfg(lr=2e-3, beta=4.0)
    bucket = cprog.bucket_key_of(a)
    assert bucket == stack_bucket_key(a) == cprog.bucket_key_of(b)  # lr is not a shape
    assert cprog.single_train_key(g, a, bucket) != cprog.single_train_key(g, b, bucket)
    assert cprog.single_key(g, a, bucket)[0] == cprog.SINGLE_TRAIN
    assert cprog.single_key(g, _cfg(fused_steps=4), bucket)[0] == cprog.SINGLE_MULTI
    # The labels are the JAX package's for the same config, up to the anchor
    # (the JAX package's first device; here the group).
    (jg,) = jax_setup_groups(1)
    for cfg in (a, b, _cfg(fused_steps=4, grad_accum=2, remat=True)):
        jcfg = JaxTrialConfig(**{k: getattr(cfg, k) for k in ("trial_id", "epochs", "lr", "beta", "seed",
                                                              "batch_size", "hidden_dim", "latent_dim",
                                                              "fused_steps", "grad_accum", "remat")})
        jb = jax_stack_bucket_key(jcfg)
        assert jb == cprog.bucket_key_of(cfg)
        for mine, theirs in ((cprog.single_train_key(g, cfg, jb), jax_cprog.single_train_key(jg, jcfg, jb)),
                             (cprog.single_multi_key(g, cfg, jb), jax_cprog.single_multi_key(jg, jcfg, jb)),
                             (cprog.stacked_multi_key(g, jb, 4), jax_cprog.stacked_multi_key(jg, jb, 4))):
            assert mine[:3] == theirs[:3]
            assert cprog.program_label(mine).split("@")[0] == jax_cprog.program_label(theirs).split("@")[0]
    pk = dict(lanes=8, steps_per_generation=50, eval_batches=3, n_exploit=2, perturb_factors=(0.8, 1.25),
              lr_min=1e-4, lr_max=1e-2)
    assert cprog.pbt_gen_key(g, bucket, **pk)[:3] == jax_cprog.pbt_gen_key(jg, bucket, **pk)[:3]
    assert cprog.program_label(("odd",)) == repr(("odd",))  # never raises


def test_mesh_fingerprint_distinguishes_groups():
    g0, g1 = _cpu_groups(2)
    cfg = _cfg()
    bucket = cprog.bucket_key_of(cfg)
    assert cprog.single_train_key(g0, cfg, bucket) != cprog.single_train_key(g1, cfg, bucket)
    assert cprog.stacked_train_key(g0, bucket, 4) != cprog.stacked_train_key(g1, bucket, 4)
    assert cprog.mesh_fingerprint(g1) == (1, (1,), "cpu")
    assert cprog.program_label(cprog.single_train_key(g1, cfg, bucket)).endswith("@g1")


def test_avals_match_guards_shape_drift():
    g = _cpu_groups(1)[0]
    slot = cprog.build_single_slot(g, _cfg(), cprog.single_train_key(g, _cfg(), cprog.bucket_key_of(_cfg())))
    assert cprog.avals_match(slot.signature(), slot.state)
    other = cprog.SingleSlot(g, _cfg(hidden_dim=32))
    assert not cprog.avals_match(slot.signature(), other.state)
    assert not cprog.avals_match(slot.signature(), object())  # never raises
    stacked = cprog.StackedSlot(g, _cfg(), 3)
    assert cprog.avals_match(stacked.signature(), stacked.state)
    assert not cprog.avals_match(stacked.signature(), cprog.StackedSlot(g, _cfg(), 2).state)


# -- the registry ----------------------------------------------------------------


def test_compile_now_coalesces_duplicate_signatures():
    reg = ExecutableRegistry()
    key, builds, gate = _key(0), [0], threading.Event()

    def slow_build():
        builds[0] += 1
        gate.wait(timeout=5)
        return _Slot()

    results = []
    threads = [threading.Thread(target=lambda: results.append(reg.compile_now(key, slow_build))) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert builds[0] == 1
    assert all(e.status == READY for e in results) and len({id(e) for e in results}) == 1
    assert reg.take(key, "a") is not None and reg.entry(key).hits == 1
    assert reg.avals(key) == ("sig", None)


def test_registry_failed_is_terminal_and_sticky():
    reg = ExecutableRegistry()
    key = _key(1)

    def broken():
        raise RuntimeError("cudaErrorStreamCaptureInvalidated")

    e = reg.compile_now(key, broken)
    assert e.status == FAILED and "StreamCapture" in e.error
    assert reg.take(key) is None and reg.claim(key) is False
    e2 = reg.compile_now(key, lambda: _Slot())  # never retried
    assert e2 is e and e2.status == FAILED


def test_claim_vs_farm_ownership():
    reg = ExecutableRegistry()
    key = _key(2)
    assert reg.schedule(key) is True and reg.schedule(key) is False
    assert reg.status(key) == PENDING
    assert reg.claim(key) is True and reg.status(key) == CLAIMED
    assert reg.begin(key, source="precompile") is not None and reg.status(key) == COMPILING
    assert reg.begin(key, source="inline") is None  # one owner at a time


def test_a_slot_serves_one_owner_at_a_time():
    reg = ExecutableRegistry()
    key = _key(3)
    slot = reg.compile_now(key, _Slot, owner="trial-a").compiled
    assert reg.entry(key).owner == "trial-a" and reg.entry(key).hits == 0  # the builder paid, no hit
    assert reg.take(key, "trial-b") is None  # held
    assert reg.take(key, "trial-a") is slot and reg.entry(key).hits == 1  # its owner may re-take
    assert not reg.give_back(key, "trial-b")
    assert reg.give_back(key, "trial-a")
    assert reg.take(key, "trial-b") is slot
    assert reg.snapshot()[cprog.program_label(key)]["held"]


def test_pool_torn_shutdown_releases_queued_jobs():
    reg = ExecutableRegistry()
    pool = PrecompilePool(registry=reg, workers=1)
    release, started = threading.Event(), threading.Event()

    def slow_builder():
        started.set()
        release.wait(timeout=10)
        return _Slot()

    k_inflight, k_queued, k_late = _key(4), _key(5), _key(6)
    assert pool.submit(k_inflight, slow_builder)
    assert pool.submit(k_queued, _Slot)
    assert started.wait(timeout=10)
    pool.shutdown()
    assert reg.status(k_queued) is None and reg.claim(k_queued) is True
    release.set()
    deadline = time.monotonic() + 10
    while reg.status(k_inflight) not in (READY, FAILED):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert reg.status(k_inflight) == READY
    assert not pool.submit(k_late, _Slot) and reg.status(k_late) is None
    assert default_workers() >= 1


def test_pool_plan_sweep_dedups_and_predicts_groups():
    reg = ExecutableRegistry()
    pool = PrecompilePool(registry=reg, workers=2)
    g0, g1 = _cpu_groups(2)
    # Four seed replicas of one config: items 0, 2 on group 0, items 1, 3 on
    # group 1 (item j on group j % 2): two programs, one per group. A bucket
    # of four lanes on item 4's group (0).
    items = [("single", [(i, _cfg(trial_id=i, seed=i))]) for i in range(4)]
    items.append(("bucket", [(4 + j, _cfg(trial_id=4 + j, lr=1e-3 * (j + 1))) for j in range(4)]))
    assert pool.plan_sweep(items, [g0, g1], max_lanes=8) == 3
    assert pool.drain(timeout_s=60)
    pool.shutdown(wait=True)
    bucket = cprog.bucket_key_of(_cfg())
    for g in (g0, g1):
        assert reg.status(cprog.single_train_key(g, _cfg(), bucket)) == READY
    assert reg.status(cprog.stacked_train_key(g0, bucket, 4)) == READY
    assert reg.entry(cprog.stacked_train_key(g0, bucket, 4)).source == "precompile"


def _drive(gen):
    """Run an admission generator to its end: (value, yields)."""
    yields = 0
    while True:
        try:
            next(gen)
            yields += 1
        except StopIteration as stop:
            return stop.value, yields


def test_admission_waits_cooperatively_never_blocks():
    reg = get_executable_registry()
    g = _cpu_groups(1)[0]
    cfg = _cfg()
    key = cprog.single_key(g, cfg, cprog.bucket_key_of(cfg))
    release = threading.Event()

    def gated():
        release.wait(timeout=30)
        return cprog.build_single_slot(g, cfg, key)

    worker = threading.Thread(target=lambda: reg.compile_now(key, gated, source="precompile"))
    worker.start()
    deadline = time.monotonic() + 10
    while reg.status(key) != COMPILING:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    state = cprog.SingleSlot(g, cfg).state
    gen = driver._admit_slot(key, lambda: pytest.fail("must not capture inline"), state, "trial")
    yields = 0
    while True:
        try:
            next(gen)
            yields += 1
            if yields == 3:
                release.set()
        except StopIteration as stop:
            slot, admission = stop.value
            break
    assert yields >= 3 and slot is not None and admission["outcome"] == "wait"
    assert admission["program"] == cprog.program_label(key)
    worker.join(timeout=10)


def test_admission_claims_pending_job_inline_then_hits():
    reg = get_executable_registry()
    g = _cpu_groups(1)[0]
    cfg = _cfg(hidden_dim=32)
    key = cprog.single_key(g, cfg, cprog.bucket_key_of(cfg))
    pool = PrecompilePool(registry=reg, workers=1)
    assert reg.schedule(key)
    pool.shutdown()
    reg.release(key)
    state = cprog.SingleSlot(g, cfg).state
    (slot, admission), _ = _drive(driver._admit_slot(key, lambda: cprog.build_single_slot(g, cfg, key), state, "a"))
    assert admission["outcome"] == "inline" and reg.status(key) == READY
    # Held by "a": another trial keeps its own path; after give_back it hits.
    (none, adm_b), _ = _drive(driver._admit_slot(key, pytest.fail, state, "b"))
    assert none is None and adm_b["outcome"] is None
    reg.give_back(key, "a")
    (again, adm_c), _ = _drive(driver._admit_slot(key, pytest.fail, state, "c"))
    assert again is slot and adm_c["outcome"] == "hit"
    # A state of other shapes never takes the slot.
    reg.give_back(key, "c")
    other = cprog.SingleSlot(g, _cfg(hidden_dim=48)).state
    (none, adm_d), _ = _drive(driver._admit_slot(key, pytest.fail, other, "d"))
    assert none is None and adm_d["outcome"] is None


def test_registry_lru_bound_evicts_terminal_idle_only():
    reg = ExecutableRegistry(max_programs=2)
    slots = {}

    def build(i):
        return lambda: slots.setdefault(i, _Slot(i))

    assert reg.compile_now(_key(0), build(0)).status == READY
    assert reg.compile_now(_key(1), build(1)).status == READY
    reg.take(_key(0), "x")
    reg.give_back(_key(0), "x")  # key 0 is now more recently used than key 1
    assert reg.compile_now(_key(2), build(2)).status == READY
    assert reg.status(_key(1)) is None and slots[1].freed == 1  # the evicted slot freed its graphs
    assert reg.status(_key(0)) == READY and reg.status(_key(2)) == READY and reg.evicted == 1
    # A pending farm job and a held slot survive the cap.
    assert reg.take(_key(2), "holder") is slots[2]
    assert reg.schedule(_key(3))
    assert reg.compile_now(_key(4), build(4)).status == READY
    assert reg.status(_key(3)) == PENDING and reg.status(_key(2)) == READY and slots[2].freed == 0
    reg.reset()
    assert all(s.freed == 1 for s in slots.values())


def test_env_sets_the_cap(monkeypatch):
    monkeypatch.setenv("MDT_REGISTRY_MAX_PROGRAMS", "2")
    assert ExecutableRegistry().max_programs == 2


# -- slots: rebinding by value ---------------------------------------------------


def test_a_slot_rebinds_trials_by_value(data):
    # Two trials through one slot, one after another, give the bits each
    # gives through a slot of its own: parameters, moments, steps and the
    # generator all come in by value.
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train.steps import create_train_state

    g = _cpu_groups(1)[0]
    cfg = _cfg(fused_steps=2)
    key = cprog.single_key(g, cfg, cprog.bucket_key_of(cfg))
    batches = torch.from_numpy(data[0].images[:64].reshape(2, 2, 16, 784).astype(np.float32))

    def trial(slot, seed):
        state = create_train_state(g, init_vae_params(VAE(hidden_dim=16, latent_dim=4), seed), cfg.lr)
        gen = torch.Generator().manual_seed(100 + seed)
        st = slot.bind(state, gen)
        losses = [slot.step(st, batches[i], generator=slot.generator)[1]["loss_sum"] for i in range(2)]
        return torch.cat(losses), {k: v.clone() for k, v in st.model.state_dict().items()}, st.step

    shared = cprog.build_single_slot(g, cfg, key)
    got = [trial(shared, s) for s in (0, 1)]
    fresh = [trial(cprog.build_single_slot(g, cfg, key), s) for s in (0, 1)]
    for (la, pa, sa), (lb, pb, sb) in zip(got, fresh):
        assert torch.equal(la, lb) and sa == sb == 4
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(got[0][0], got[1][0])


# -- the driver ------------------------------------------------------------------


def _sweep(data, tmp_path, name, cfgs, *, groups=2, **kw):
    tel = str(tmp_path / name / "tel")
    with telemetry.telemetry_run(tel):
        res = run_hpo(cfgs, data[0], data[1], groups=_cpu_groups(groups), out_dir=str(tmp_path / name / "out"),
                      save_images=False, verbose=False, **kw)
    fold = SweepFold()
    for ev in read_events(os.path.join(tel, EVENTS_NAME)):
        fold.feed(ev)
    return res, fold


def _same_results(a, b, root_a=None, root_b=None):
    for x, y in zip(a, b):
        assert x.trial_id == y.trial_id and x.status == y.status == "completed"
        assert [float(h["avg_train_loss"]).hex() for h in x.history] == \
               [float(h["avg_train_loss"]).hex() for h in y.history]
        assert float(x.final_test_loss).hex() == float(y.final_test_loss).hex()
        if root_a is not None:
            fa = os.path.join(root_a, f"trial-{x.trial_id}", "state.msgpack")
            fb = os.path.join(root_b, f"trial-{y.trial_id}", "state.msgpack")
            with open(fa, "rb") as f, open(fb, "rb") as h:
                assert f.read() == h.read()  # the checkpointed parameters and moments, bit for bit


def test_replicas_hit_precompile_waits_and_all_match_the_plain_sweep(data, tmp_path, monkeypatch):
    # Six trials (three seeds x two lrs), the seed replicas users run for a
    # config's spread, on two groups, three ways and once with the registry
    # off: the same bits everywhere.
    cfgs = [_cfg(trial_id=i, seed=i // 2, lr=(1e-3, 3e-3)[i % 2], epochs=2, fused_steps=2) for i in range(6)]
    monkeypatch.setenv("MDT_AOT_ADMISSION", "0")
    plain, _ = _sweep(data, tmp_path, "plain", cfgs)
    monkeypatch.delenv("MDT_AOT_ADMISSION")
    shared, fold = _sweep(data, tmp_path, "shared", cfgs, save_checkpoints=False, ledger=False)
    outcomes = [a["outcome"] for a in sorted(fold.admissions, key=lambda a: a["trial_id"])]
    # Item j on group j % 2 with lr (j % 2): every later item of a group is
    # its program's replica.
    assert outcomes == ["inline", "inline", "hit", "hit", "hit", "hit"]
    assert fold.compiles == 2 and fold.cache_hits == 4
    get_executable_registry().reset()
    farm, ffold = _sweep(data, tmp_path, "farm", cfgs, precompile=True, save_checkpoints=False, ledger=False)
    assert {a["outcome"] for a in ffold.admissions} <= {"hit", "wait"}
    assert ffold.precompile.get("plan") == 1 and ffold.compiles == 2
    snap = get_executable_registry().snapshot()
    assert all(v["status"] == READY and not v["held"] for v in snap.values())  # every slot given back
    _same_results(plain, shared)
    _same_results(plain, farm)


def test_a_retried_attempt_takes_its_slot_back(data, tmp_path):
    cfgs = [_cfg(trial_id=i, seed=i, epochs=2, fused_steps=2) for i in range(2)]
    clean, _ = _sweep(data, tmp_path, "clean", cfgs)
    get_executable_registry().reset()
    faulted, fold = _sweep(data, tmp_path, "fault", cfgs, retry=RetryPolicy(max_retries=2, backoff_base_s=0.01),
                           fault_plan=FaultPlan(specs=(FaultSpec(CRASH, 0, step=10),)))
    by_trial = {}
    for a in fold.admissions:
        by_trial.setdefault(a["trial_id"], []).append(a["outcome"])
    assert by_trial[0] == ["inline", "hit"] and by_trial[1] == ["inline"]
    assert faulted[0].attempt == 2
    _same_results(clean, faulted, str(tmp_path / "clean" / "out"), str(tmp_path / "fault" / "out"))
    assert not any(v["held"] for v in get_executable_registry().snapshot().values())


def test_stacked_buckets_share_one_slot(data, tmp_path, monkeypatch):
    # Eight same-shape configs, four lanes a bucket, on one group: the second
    # bucket takes the first's slot; lanes end as with the registry off.
    cfgs = [_cfg(trial_id=i, seed=i, lr=1e-3 * (1 + i % 3), epochs=1) for i in range(8)]
    kw = dict(groups=1, stack_trials=True, stack_max_lanes=4, save_checkpoints=False, ledger=False)
    monkeypatch.setenv("MDT_AOT_ADMISSION", "0")
    plain, _ = _sweep(data, tmp_path, "plain", cfgs, **kw)
    monkeypatch.delenv("MDT_AOT_ADMISSION")
    got, fold = _sweep(data, tmp_path, "slot", cfgs, **kw)
    assert fold.compiles == 1
    for a, b in zip(plain, got):
        assert [h["avg_train_loss"] for h in a.history] == [h["avg_train_loss"] for h in b.history]
        assert a.final_test_loss == b.final_test_loss


def test_fused_pbt_takes_its_program_again(data):
    cfg = PBTConfig(population=4, generations=3, steps_per_generation=4, batch_size=16, hidden_dim=16, latent_dim=4,
                    seed=1, lr_min=1e-4, lr_max=1e-1)
    with telemetry.telemetry_run():
        first = run_pbt(cfg, data[0], data[1], fused=True, verbose=False, device="cpu")
        second = run_pbt(cfg, data[0], data[1], fused=True, verbose=False, device="cpu")
        kinds = [e.kind for e in telemetry.get_bus().recent() if e.kind in ("compile_end", "cache_hit")]
    # One capture in the process; generations 2 and 3 of the first run, and
    # every generation of the second, book a hit.
    assert kinds == ["compile_end"] + ["cache_hit"] * 2 + ["cache_hit"] * 3
    assert first.history == second.history and first.final_lrs == second.final_lrs


def test_precompile_leaves_the_unported_args():
    assert "precompile" not in driver._UNPORTED_ARGS


def test_compile_books_fold_as_jax(data, tmp_path):
    # The port's events fold to the JAX package's books through both folds.
    _sweep(data, tmp_path, "books", [_cfg(trial_id=i, seed=i) for i in range(3)], groups=1, save_checkpoints=False,
           ledger=False)
    folds = (SweepFold(), JaxSweepFold())
    for ev in read_events(str(tmp_path / "books" / "tel" / EVENTS_NAME)):
        for f in folds:
            f.feed(ev)
    mine, theirs = folds
    assert mine.compile_books == theirs.compile_books and mine.compiles == theirs.compiles == 1
    assert mine.cache_hits == theirs.cache_hits == 2
    assert mine.admissions == theirs.admissions
    assert [a["outcome"] for a in mine.admissions] == ["inline", "hit", "hit"]
