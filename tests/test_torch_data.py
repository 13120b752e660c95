"""The port's data order against the JAX package's: identical rows,
weights and batch counts, exactly (the same numpy arithmetic on both
sides; no tolerance)."""

import numpy as np
import pytest
import torch

from multidisttorch_tpu.data.datasets import load_mnist as jax_load_mnist
from multidisttorch_tpu.data.datasets import synthetic_mnist as jax_synthetic_mnist
from multidisttorch_tpu.data.sampler import EvalDataIterator as JaxEval
from multidisttorch_tpu.data.sampler import TrialDataIterator as JaxTrain
from multidisttorch_tpu.data.sampler import epoch_permutation as jax_perm
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu_torch.data.datasets import load_mnist, synthetic_mnist
from multidisttorch_tpu_torch.data.sampler import (
    EvalDataIterator,
    TrialDataIterator,
    epoch_permutation,
)
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup, setup_groups


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIXTURES = "tests/fixtures"


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(100, seed=0)


def _port_group(group_id=0):
    return setup_groups(2, devices=["cpu", "cpu"])[group_id]


def test_synthetic_mnist_is_the_same_data():
    a, b = synthetic_mnist(64, seed=3), jax_synthetic_mnist(64, seed=3)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert (a.name, a.synthetic) == (b.name, b.synthetic) == ("synthetic-mnist", True)


def test_load_mnist_reads_the_same_idx_files():
    # tests/fixtures/mnist holds train IDX files only: both packages read
    # them identically, and neither finds a test split there.
    a = load_mnist(train=True, data_dir=FIXTURES)
    b = jax_load_mnist(train=True, data_dir=FIXTURES, allow_download=False)
    assert a.name == b.name == "mnist" and not a.synthetic
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    with pytest.raises(FileNotFoundError):
        load_mnist(train=False, data_dir=FIXTURES, allow_synthetic=False)
    with pytest.warns(UserWarning, match="synthetic"):
        fallback = load_mnist(train=False, data_dir=FIXTURES, synthetic_size=12)
    assert fallback.synthetic and len(fallback) == 12


@pytest.mark.parametrize("seed, epoch", [(0, 1), (3, 2), (7, 10)])
def test_epoch_permutation_identical(seed, epoch):
    for idx in (np.arange(50), np.arange(100)[1::2]):
        np.testing.assert_array_equal(
            epoch_permutation(seed, epoch, idx), jax_perm(seed, epoch, idx)
        )


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("group_id", [0, 1])
def test_train_batches_identical(data, shard, group_id):
    jtrial = jax_setup_groups(8)[group_id]
    kw = dict(seed=4, shard_across_trials=shard, num_trials=2)
    jit = JaxTrain(data, jtrial, 16, use_native=False, **kw)
    pit = TrialDataIterator(data, _port_group(group_id), 16, **kw)
    assert pit.num_batches == jit.num_batches
    assert pit.samples_per_epoch == jit.samples_per_epoch
    for epoch in (1, 2):
        jb = [np.asarray(b) for b in jit.epoch(epoch)]
        pb = [b.numpy() for b in pit.epoch(epoch)]
        assert len(pb) == len(jb) == jit.num_batches
        for a, b in zip(pb, jb):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_train_chunks_identical(data, k):
    jit = JaxTrain(data, jax_setup_groups(8)[0], 16, seed=1, use_native=False)
    pit = TrialDataIterator(data, _port_group(), 16, seed=1)
    jc = [(i, np.asarray(c)) for i, c in jit.epoch_chunks(1, k)]
    pc = [(i, c.numpy()) for i, c in pit.epoch_chunks(1, k)]
    assert [i for i, _ in pc] == [i for i, _ in jc]
    for (_, a), (_, b) in zip(pc, jc):
        np.testing.assert_array_equal(a, b)


def test_eval_batches_identical_with_padding(data):
    rows = synthetic_mnist(37, seed=2)
    jit = JaxEval(rows, jax_setup_groups(8)[0], 16)
    pit = EvalDataIterator(rows, _port_group(), 16)
    assert pit.num_batches == jit.num_batches == 3 and pit.num_rows == 37
    jb = [(np.asarray(i), np.asarray(w)) for i, w in jit.batches()]
    pb = [(i.numpy(), w.numpy()) for i, w in pit.batches()]
    for (pi, pw), (ji, jw) in zip(pb, jb):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pw, jw)
    assert pb[-1][1].sum() == 5 and pb[-1][0][5:].max() == 0.0
    np.testing.assert_array_equal(pit.first_host_batch(), jit.first_host_batch())


def test_multi_rank_group_splits_each_batch_in_rank_order(data):
    # A 2-rank group: each rank takes its contiguous half of every batch,
    # and the halves in group-rank order are the JAX package's batch (its
    # batch sharding splits dim 0 the same way).
    jit = JaxTrain(data, jax_setup_groups(4)[0], 16, seed=2, use_native=False)
    halves = []
    for r in (0, 1):
        g = TrialGroup(group_id=0, global_ranks=(0, 1), device=torch.device("cpu"),
                       is_local_member=True, local_rank=r, owner_process=0)
        halves.append([b.numpy() for b in TrialDataIterator(data, g, 16, seed=2).epoch(1)])
    for lo, hi, ref in zip(halves[0], halves[1], jit.epoch(1)):
        assert lo.shape == (8, 784)
        np.testing.assert_array_equal(np.concatenate([lo, hi]), np.asarray(ref))


def test_iterator_errors(data):
    g = _port_group()
    with pytest.raises(ValueError, match="smaller than one batch"):
        TrialDataIterator(synthetic_mnist(8, seed=0), g, 16)
    with pytest.raises(ValueError, match="num_trials"):
        TrialDataIterator(data, g, 16, shard_across_trials=True)
    with pytest.raises(ValueError, match="chunk size"):
        TrialDataIterator(data, g, 16).epoch_chunks(1, 0)
    pair = TrialGroup(0, (0, 1), torch.device("cpu"), True, 0, 0)
    with pytest.raises(ValueError, match="divide evenly"):
        EvalDataIterator(data, pair, 15)


# --- the feed: gather paths and the prefetch pipeline -----------------------

# Iterator arguments of each feed path; the first is the synchronous numpy
# reference.
FEEDS = {
    "numpy": dict(use_native=False, prefetch=False),
    "numpy+prefetch depth 1": dict(use_native=False, prefetch=True, prefetch_depth=1),
    "numpy+prefetch depth 2": dict(use_native=False, prefetch=True, prefetch_depth=2),
    "native": dict(use_native=True, prefetch=False),
    "native+prefetch": dict(use_native=True, prefetch=True),
}


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_feed_paths_give_the_same_chunks(data, feed):
    from multidisttorch_tpu.data.sampler import StackedTrialDataIterator as JaxStacked

    from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator

    group = setup_groups(1, devices=["cpu"])[0]
    kw = FEEDS[feed]
    # Per trial: epoch_chunks (the native gather has no prefetch there).
    one = TrialDataIterator(data, group, 16, seed=5, use_native=kw["use_native"])
    assert one.gather_path == ("native" if kw["use_native"] else "numpy")
    ref = TrialDataIterator(data, group, 16, seed=5, use_native=False)
    for (i, a), (j, b) in zip(one.epoch_chunks(2, 4), ref.epoch_chunks(2, 4), strict=True):
        assert i == j and torch.equal(a, b)
    # Stacked: two rounds of round_chunks (a tail chunk each: 6 batches in
    # chunks of 4) against the JAX iterator's host arrays, then a stream.
    seeds = [3, 8, 1]
    it = StackedTrialDataIterator(data, group, 16, seeds, **kw)
    jit = JaxStacked(data, jax_setup_groups(8)[0], 16, seeds, use_native=False, prefetch=False)
    for _ in range(2):
        got = [(i, c.numpy()) for i, c in it.round_chunks(4)]
        want = [(i, np.asarray(c)) for i, c in jit.round_chunks(4)]
        assert [i for i, _ in got] == [i for i, _ in want] == [0, 4]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    stream = StackedTrialDataIterator(data, group, 16, seeds, **kw).stream_chunks(4)
    ref_stream = StackedTrialDataIterator(data, group, 16, seeds, **FEEDS["numpy"]).stream_chunks(4)
    for _ in range(5):  # 20 steps, across three round edges
        assert torch.equal(next(stream), next(ref_stream))
    stream.close()


@pytest.mark.parametrize("feed", ["numpy", "native+prefetch", "numpy+prefetch depth 1"])
def test_a_refill_between_rounds_reaches_the_next_round(data, feed):
    from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator

    group = setup_groups(1, devices=["cpu"])[0]
    it = StackedTrialDataIterator(data, group, 16, [0, 1], **FEEDS[feed])
    list(it.round_chunks(4))  # round 1: both lanes' epoch 1
    it.set_lane(1, seed=42)  # lane 1 refilled: its own epoch 1
    got = torch.cat([c for _, c in it.round_chunks(4)])
    lane0 = torch.stack(list(TrialDataIterator(data, group, 16, seed=0, use_native=False).epoch(2)))
    lane1 = torch.stack(list(TrialDataIterator(data, group, 16, seed=42, use_native=False).epoch(1)))
    assert torch.equal(got[:, 0], lane0) and torch.equal(got[:, 1], lane1)


def test_a_producer_exception_surfaces_at_the_consumer(data, monkeypatch):
    from multidisttorch_tpu_torch.data import sampler

    def source():
        yield 0
        yield 1
        raise KeyError("bad shard")

    got = []
    with pytest.raises(KeyError, match="bad shard"):
        for item in sampler._prefetched(source(), 2):
            got.append(item)
    assert got == [0, 1]
    # Through an iterator: a gather that fails raises at next().
    group = setup_groups(1, devices=["cpu"])[0]
    it = sampler.StackedTrialDataIterator(data, group, 16, [0], use_native=False, prefetch=True)
    monkeypatch.setattr(it, "_gather", lambda perms, b: (_ for _ in ()).throw(OSError("disk gone")))
    with pytest.raises(OSError, match="disk gone"):
        next(it.round_chunks(2))


def _prefetch_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "mdt-stacked-prefetch"]


def test_an_abandoned_endless_stream_retires_its_worker(data):
    import time

    from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator

    group = setup_groups(1, devices=["cpu"])[0]
    for close in (True, False):
        stream = StackedTrialDataIterator(data, group, 16, [0, 1], use_native=True, prefetch=True).stream_chunks(2)
        next(stream)
        assert _prefetch_threads()
        if close:
            stream.close()
        else:
            del stream  # collected
        deadline = time.time() + 5.0
        while _prefetch_threads() and time.time() < deadline:
            time.sleep(0.02)
        assert not _prefetch_threads()


def test_the_prefetch_settings(data, monkeypatch):
    from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator

    group = setup_groups(1, devices=["cpu"])[0]
    make = lambda **kw: StackedTrialDataIterator(data, group, 16, [0], **kw)
    assert make()._prefetch and make()._depth == 2  # the JAX package's defaults
    monkeypatch.setenv("MDT_STACKED_PREFETCH_DEPTH", "3")
    assert make()._depth == 3 and make(prefetch_depth=1)._depth == 1
    monkeypatch.setenv("MDT_STACKED_PREFETCH_DEPTH", "many")
    assert make()._depth == 2
    monkeypatch.setenv("MDT_STACKED_PREFETCH", "0")
    it = make()
    assert not it._prefetch and make(prefetch=True)._prefetch
    chunks = it.round_chunks(2)
    next(chunks)
    assert not _prefetch_threads()  # the synchronous path starts no thread
    chunks.close()


def test_the_wait_hook_sees_every_chunk(data):
    from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator

    group = setup_groups(1, devices=["cpu"])[0]
    for feed in ("numpy", "native+prefetch"):
        seen = []
        it = StackedTrialDataIterator(data, group, 16, [0, 1], wait_hook=lambda s, nb: seen.append((s, nb)),
                                      **FEEDS[feed])
        chunks = list(it.round_chunks(4))  # 6 steps: chunks of 4 and 2
        assert [nb for _, nb in seen] == [c.numel() * 4 for _, c in chunks] and all(s >= 0 for s, _ in seen)


def _feed_off(monkeypatch) -> None:
    """Every train iterator that run_hpo and run_pbt build from here on
    takes the synchronous numpy path."""
    import functools

    from multidisttorch_tpu_torch.data import sampler
    from multidisttorch_tpu_torch.hpo import driver, pbt

    for mod in (driver, pbt):
        for name in ("TrialDataIterator", "StackedTrialDataIterator"):
            if hasattr(mod, name):
                off = FEEDS["numpy"] if name.startswith("Stacked") else {"use_native": False}
                monkeypatch.setattr(mod, name, functools.partial(getattr(sampler, name), **off))


@pytest.mark.parametrize("stack", [False, True])
def test_run_hpo_gives_the_same_results_with_the_feed_on_and_off(tmp_path, monkeypatch, stack):
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo

    train, test = synthetic_mnist(96, seed=0), synthetic_mnist(40, seed=1)
    configs = [TrialConfig(trial_id=i, epochs=1 + i % 2, batch_size=16, seed=i, lr=(1e-3, 3e-3, 2e-3)[i],
                           hidden_dim=16, latent_dim=4, fused_steps=4) for i in range(3)]

    def run(out):
        return run_hpo(configs, train, test, groups=setup_groups(1, devices=["cpu"]), out_dir=str(tmp_path / out),
                       save_images=False, verbose=False, stack_trials=stack)

    on = run("on")
    _feed_off(monkeypatch)
    off = run("off")
    assert [r.stacked for r in on] == [stack] * 3
    for a, b in zip(on, off, strict=True):
        assert (a.status, a.steps, a.history) == (b.status, b.steps, b.history) == ("completed", a.steps, a.history)
        assert a.final_train_loss == b.final_train_loss and a.final_test_loss == b.final_test_loss


@pytest.mark.parametrize("fused", [False, True])
def test_run_pbt_gives_the_same_results_with_the_feed_on_and_off(monkeypatch, fused):
    from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt

    train, test = synthetic_mnist(96, seed=0), synthetic_mnist(40, seed=1)
    # 5 steps a generation over rounds of 6: the stream crosses round edges.
    cfg = PBTConfig(population=4, generations=3, steps_per_generation=5, batch_size=16, hidden_dim=16, latent_dim=4,
                    exploit_fraction=0.5, lr_min=1e-4, lr_max=1e-1)

    def run():
        groups = setup_groups(1 if fused else 4, devices=["cpu"] * (1 if fused else 4))
        return run_pbt(cfg, train, test, groups=groups, fused=fused, verbose=False, return_states=True)

    on = run()
    _feed_off(monkeypatch)
    off = run()
    assert on.history == off.history and on.final_lrs == off.final_lrs
    for a, b in zip(on.final_states, off.final_states, strict=True):
        assert a["count"] == b["count"]
        assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
        assert all(torch.equal(x, y) for x, y in zip(a["exp_avg"] + a["exp_avg_sq"], b["exp_avg"] + b["exp_avg_sq"]))
