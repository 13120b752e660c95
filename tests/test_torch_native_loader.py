"""The port's native gatherer (``multidisttorch_tpu_torch/data/native.py``
over its own ``data/csrc/fastloader.cpp``) against the numpy gather and the
JAX package's gatherer: the same rows, byte for byte (no tolerance). Also
its build (from the port's own source, into ``build/``, under a hash name),
its buffer checks, and that closing or abandoning it leaves no thread
behind."""

import os
import re
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from multidisttorch_tpu.data import native as jax_native
from multidisttorch_tpu_torch.data import native
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator, TrialDataIterator, epoch_permutation
from multidisttorch_tpu_torch.ops import _build
from multidisttorch_tpu_torch.parallel.mesh import setup_groups

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "multidisttorch_tpu_torch")


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    return rng.normal(size=(100, 17)).astype(np.float32), rng.integers(0, 10, 100).astype(np.int32)


@pytest.mark.parametrize("out", ["new", "tensor", "ndarray"])
@pytest.mark.parametrize("with_labels", [False, True])
def test_gatherer_matches_numpy_and_the_jax_gatherer(rows, out, with_labels):
    images, labels = rows
    labels = labels if with_labels else None
    perm = epoch_permutation(3, 2, np.arange(100))
    port = native.NativeBatchGatherer(images, labels)
    ref = jax_native.NativeBatchGatherer(images, labels)
    # 100 rows in batches of 8: 12 batches, the ragged 4 dropped.
    assert port.start_epoch(perm, 8) == ref.start_epoch(perm, 8) == 12
    for b in range(12):
        buf = {"new": None, "tensor": torch.empty(8, 17), "ndarray": np.empty((8, 17), np.float32)}[out]
        got, got_labels = port.next_batch(buf)
        if buf is not None:
            assert got is buf
        want, want_labels = ref.next_batch()
        idx = perm[b * 8 : (b + 1) * 8]
        np.testing.assert_array_equal(np.asarray(got), images[idx])
        np.testing.assert_array_equal(np.asarray(got), want)
        if with_labels:
            np.testing.assert_array_equal(got_labels, labels[idx])
            np.testing.assert_array_equal(got_labels, want_labels)
        else:
            assert got_labels is None and want_labels is None
    with pytest.raises(StopIteration):
        port.next_batch()
    port.close()
    ref.close()


def test_stacked_gatherer_matches_numpy_and_the_jax_gatherer(rows):
    images, _ = rows
    # Lanes at different (seed, epoch), as after a refill.
    perms = np.stack([epoch_permutation(s, e, np.arange(100)) for s, e in ((0, 1), (5, 3), (9, 1))])
    port, ref = native.StackedBatchGatherer(images), jax_native.StackedBatchGatherer(images)
    assert port.start_round(perms, 8) == ref.start_round(perms, 8) == 12
    staging = torch.empty(12, 3, 8, 17)
    for b in range(12):
        got = port.next_stacked(staging[b]) if b % 2 else port.next_stacked()
        want = ref.next_stacked()
        assert tuple(got.shape) == (3, 8, 17)
        np.testing.assert_array_equal(np.asarray(got), want)
        for k in range(3):
            np.testing.assert_array_equal(np.asarray(got[k]), images[perms[k, b * 8 : (b + 1) * 8]])
    port.close()
    ref.close()


def test_output_buffers_and_permutations_are_checked(rows):
    images, labels = rows
    g = native.NativeBatchGatherer(images, labels)
    with pytest.raises(ValueError):
        g.start_epoch(np.array([0, 1, 2, 100]), 2)
    g.start_epoch(np.arange(16), 8)
    for bad in (torch.empty(8, 17, dtype=torch.float64), torch.empty(8, 16), torch.empty(17, 8).t(),
                np.empty((8, 17), np.float64), np.empty((8, 18), np.float32)[:, :17], [0.0] * 136):
        with pytest.raises(ValueError, match="C-contiguous"):
            g.next_batch(bad)
    with pytest.raises(ValueError, match="out_labels"):
        g.next_batch(None, np.empty(8, np.int64))
    g.next_batch()
    g.close()
    g.close()  # idempotent


def _os_threads() -> int:
    return len(os.listdir("/proc/self/task"))


def _settle(want: int, count, timeout: float = 10.0) -> int:
    deadline = time.time() + timeout
    while count() > want and time.time() < deadline:
        time.sleep(0.05)
    return count()


def test_close_and_abandoned_rounds_leave_no_thread():
    data = synthetic_mnist(160, seed=0)
    group = setup_groups(1, devices=["cpu"])[0]

    def use_once():
        # A gatherer closed midway, and iterators abandoned midway: a round
        # of round_chunks, an endless stream and an epoch of epoch_chunks.
        g = native.StackedBatchGatherer(data.images)
        g.start_round(np.stack([np.arange(160)] * 2), 16)
        g.next_stacked()
        g.close()
        it = StackedTrialDataIterator(data, group, 16, [0, 1], use_native=True, prefetch=True)
        next(it.round_chunks(2))
        next(it.stream_chunks(3))
        next(TrialDataIterator(data, group, 16, use_native=True).epoch_chunks(1, 2))

    use_once()  # the first use builds and loads the library
    py0 = _settle(threading.active_count(), threading.active_count)
    os0 = _settle(_os_threads(), _os_threads)
    for _ in range(5):  # rebuild and reuse
        use_once()
    assert _settle(py0, threading.active_count) <= py0
    assert _settle(os0, _os_threads) <= os0  # the C++ gather threads too
    assert not [t for t in threading.enumerate() if t.name == "mdt-stacked-prefetch"]


def test_library_is_built_from_the_ports_source_into_build():
    src = os.path.join(PORT, "data", "csrc", "fastloader.cpp")
    assert _build._sources_of("fastloader") == [_build.Path(src)]
    path = _build.library_path("fastloader")
    assert path.parent == _build.Path(REPO, "build", "torch_kernels")
    assert re.fullmatch(r"libfastloader_[0-9a-f]{16}\.so", path.name)
    assert native.available() and path.exists()
    # The port's copy keeps the JAX package's code below its own header.
    body = lambda p: open(p).read().split("#include <atomic>", 1)[1]
    assert body(src) == body(os.path.join(REPO, "csrc", "fastloader.cpp"))


def test_an_edited_gatherer_source_changes_the_library_path(tmp_path, monkeypatch):
    src = tmp_path / "fastloader.cpp"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "HOST_SOURCES", {"fastloader": src})
    first = _build.library_path("fastloader")
    src.write_text("// v2\n")
    second = _build.library_path("fastloader")
    assert second != first
    monkeypatch.setattr(_build, "HOST_CXX_FLAGS", _build.HOST_CXX_FLAGS + ["-g"])
    assert _build.library_path("fastloader") not in (first, second)


def test_no_port_module_reads_the_jax_packages_csrc():
    # The source: no port module names the JAX package's library or its
    # directory (the port's sources live under ops/csrc and data/csrc).
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "libfastloader.so" not in text, f
                assert not re.search(r"parents\[[23]\]\s*/\s*[\"']csrc", text), f
    # At run time: the process maps the port's library from build/, and no
    # library from csrc/.
    code = (
        "from multidisttorch_tpu_torch.data import native\n"
        "assert native.available()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert '/build/torch_kernels/libfastloader_' in maps\n"
        "assert 'csrc/libfastloader.so' not in maps\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=REPO))


def test_an_unbuildable_gatherer_falls_back_or_raises(monkeypatch):
    data = synthetic_mnist(64, seed=0)
    group = setup_groups(1, devices=["cpu"])[0]

    def no_compiler(name):
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(_build, "load", no_compiler)
    with pytest.warns(UserWarning, match="gathers with numpy"):
        assert not native.available()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one warning, at the first failure
        assert TrialDataIterator(data, group, 16).gather_path == "numpy"
        assert StackedTrialDataIterator(data, group, 16, [0]).gather_path == "numpy"
    for make in (lambda: TrialDataIterator(data, group, 16, use_native=True),
                 lambda: StackedTrialDataIterator(data, group, 16, [0], use_native=True)):
        with pytest.raises(RuntimeError, match="native gatherer unavailable.*g\\+\\+"):
            make()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeBatchGatherer(data.images)
