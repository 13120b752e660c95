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
