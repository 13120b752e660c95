"""Trial-aware data sampling and device feeding.

Counterpart of ``multidisttorch_tpu/data/sampler.py``: the same epoch
order, batch boundaries and eval padding, so both packages feed the same
rows. Every trial sees the whole dataset in a fresh seeded permutation per
epoch; ``shard_across_trials=True`` reproduces the reference's cross-trial
sharding (trial ``g`` sees rows ``g::num_trials``). Ragged training tails
are dropped. On a group of several ranks each rank takes its contiguous
share of every batch (``batch_size / group.size`` rows, in group-rank
order), which is how the JAX package's batch sharding splits rows.

**The feed**, with the JAX package's defaults and settings:

- *Gather.* The train iterators gather rows with the native gatherer
  (``data/native.py``, a C++ thread) where it builds, else with numpy
  (``use_native=None``; ``True`` requires it, ``False`` never uses it). The
  native path writes a chunk straight into one pinned host buffer; the
  numpy path indexes, stacks and pins. ``gather_path`` records which ran.
  Both give the same bytes.
- *Pipeline.* :class:`StackedTrialDataIterator` gathers chunks and copies
  them to the device on a worker thread, up to ``prefetch_depth`` chunks
  ahead of the consumer (``MDT_STACKED_PREFETCH=0`` turns it off,
  ``MDT_STACKED_PREFETCH_DEPTH`` sets the depth, default 2). On a card the
  worker issues the copy on a stream of its own and records an event; the
  consumer's stream waits on it before the chunk is used. A lane's
  permutation is fixed when its round's first step is gathered, so a
  ``set_lane`` between two ``round_chunks`` calls reaches the next round
  exactly as without the pipeline.

Host-to-device copies go through pinned memory and do not block the host.
"""

from __future__ import annotations

import contextlib
import os
import queue as _queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from multidisttorch_tpu_torch.data import native
from multidisttorch_tpu_torch.data.datasets import Dataset
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup
from multidisttorch_tpu_torch.train.streams import side_stream, stream_lock


def _prefetch_default() -> bool:
    """The stacked pipeline's switch: on unless ``MDT_STACKED_PREFETCH=0``
    (the off path is the synchronous bit-parity reference)."""
    return os.environ.get("MDT_STACKED_PREFETCH", "1") != "0"


def _prefetch_depth() -> int:
    """Pipeline depth (``MDT_STACKED_PREFETCH_DEPTH``, default 2): how many
    produced chunks may wait ready ahead of the consumer; the one being
    produced is one more."""
    try:
        return max(1, int(os.environ.get("MDT_STACKED_PREFETCH_DEPTH", "2")))
    except ValueError:
        return 2


def _prefetched(source: Iterator, depth: int) -> Iterator:
    """Run the generator ``source`` on a daemon worker thread, up to
    ``depth`` items ahead of the consumer, and yield its items in order. An
    exception in ``source`` re-raises at the consumer's ``next()``;
    abandoning this generator (closed, collected, or a consumer's raise)
    sets the stop flag and waits for the worker, which closes ``source``
    (its ``finally`` blocks run on the worker) and ends."""
    q: _queue.Queue = _queue.Queue(maxsize=max(1, int(depth)))
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def worker():
        try:
            for item in source:
                if not put((None, item)):
                    return
            put((end, None))
        except BaseException as e:  # noqa: BLE001 - re-raised at the consumer's next()
            put((e, None))
        finally:
            source.close()

    thread = threading.Thread(target=worker, name="mdt-stacked-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            tag, item = q.get()
            if tag is end:
                return
            if tag is not None:
                raise tag
            yield item
    finally:
        stop.set()
        # The worker ends within the item it is producing: once this returns,
        # no thread of the feed touches the device.
        thread.join(timeout=60.0)


def epoch_permutation(seed: int, epoch: int, indices: np.ndarray) -> np.ndarray:
    """The per-(seed, epoch) permutation, byte-identical to the JAX
    package's ``epoch_permutation``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(indices)


def _to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        host = torch.from_numpy(np.ascontiguousarray(rows)).pin_memory()
        return host.to(device, non_blocking=True)
    # A copy: ``rows`` may be a view of the dataset itself.
    return torch.tensor(rows, device=device)


def _staging(shape: tuple, device: torch.device) -> torch.Tensor:
    """A host buffer that the native gatherer fills: pinned when its rows go
    to a card (the caching host allocator hands a pinned block out again
    only after the copies recorded on it have completed), plain otherwise."""
    return torch.empty(shape, dtype=torch.float32, pin_memory=device.type == "cuda")


def _check_divisible(batch_size: int, group: TrialGroup) -> None:
    if batch_size % group.size != 0:
        raise ValueError(
            f"batch_size {batch_size} must divide evenly over the trial's "
            f"{group.size} ranks"
        )


def _local_rows(rows, group: TrialGroup, axis: int = 0):
    """This rank's contiguous share of a group batch along ``axis`` (a
    numpy array, or a host tensor from the gatherer)."""
    if group.size == 1:
        return rows
    per = rows.shape[axis] // group.size
    lo = group.local_rank * per
    if isinstance(rows, torch.Tensor):
        return rows.narrow(axis, lo, per).contiguous()
    return rows.take(np.arange(lo, lo + per), axis=axis)


def _put(rows, group: TrialGroup, axis: int) -> torch.Tensor:
    """This rank's rows of a host chunk on the group's device: a numpy
    chunk pinned and copied, a gatherer's buffer (pinned already on a card)
    copied; on the CPU a gatherer's buffer is handed over as it is."""
    rows = _local_rows(rows, group, axis)
    if isinstance(rows, torch.Tensor):
        return rows.to(group.device, non_blocking=True) if group.device.type == "cuda" else rows
    return _to_device(rows, group.device)


def _gather_path(use_native: Optional[bool]) -> str:
    """``"native"`` or ``"numpy"``: ``use_native=None`` takes the gatherer
    where it builds (else numpy, with the gatherer's warning), ``True``
    requires it, ``False`` never uses it."""
    if use_native is False:
        return "numpy"
    if use_native:
        native.require()
        return "native"
    return "native" if native.available() else "numpy"


def _check_chunk_size(k: int) -> None:
    # Eager: a bad k fails at the call site, not at the first next().
    if k < 1:
        raise ValueError(f"chunk size must be >= 1, got {k}")


class TrialDataIterator:
    """Per-trial epoch iterator yielding device-resident batches of this
    rank's rows. Incomplete trailing batches are dropped. ``use_native``
    picks the gather (see the module's docstring); ``gather_path`` says
    which runs. ``with_labels=True`` (the classifiers') pairs every batch
    with its rows' labels, int64 on the device, indexed from the same
    permutation with the same batch edges."""

    def __init__(
        self,
        dataset: Dataset,
        group: TrialGroup,
        batch_size: int,
        *,
        seed: int = 0,
        shard_across_trials: bool = False,
        num_trials: Optional[int] = None,
        with_labels: bool = False,
        use_native: Optional[bool] = None,
        fault_hook: Optional[Callable[[int, int], None]] = None,
    ):
        _check_divisible(batch_size, group)
        self.dataset = dataset
        self.group = group
        self.batch_size = batch_size
        self.seed = seed
        self.with_labels = with_labels
        # Fault-injection seam (faults/inject.py via hpo/driver.py): called
        # as fault_hook(epoch, batch_index) for each batch of a chunk, when
        # the consumer takes the chunk; it may raise (an injected loader
        # failure).
        self.fault_hook = fault_hook
        if shard_across_trials:
            if num_trials is None:
                raise ValueError("shard_across_trials requires num_trials")
            self._indices = np.arange(len(dataset))[group.group_id::num_trials]
        else:
            self._indices = np.arange(len(dataset))
        self.num_batches = len(self._indices) // batch_size
        if self.num_batches == 0:
            raise ValueError(
                f"dataset shard of {len(self._indices)} rows smaller than "
                f"one batch of {batch_size}"
            )
        self.gather_path = _gather_path(use_native)

    def _host_chunks(self, epoch: int, k: int) -> Iterator[tuple]:
        """Host ``(start_batch_index, (s, B, ...), labels)`` chunks of ``k``
        group batches in the (seed, epoch) permutation order, the last
        possibly shorter; ``labels`` is ``(s, B)`` int64, or None without
        ``with_labels``. Each call gathers with a gatherer of its own, so
        two live epochs never share one."""
        perm = epoch_permutation(self.seed, epoch, self._indices)
        bs, nb, images = self.batch_size, self.num_batches, self.dataset.images

        def labels(start: int, stop: int):
            if not self.with_labels:
                return None
            return self.dataset.labels[perm[start * bs : stop * bs]].astype(np.int64).reshape(stop - start, bs)

        if self.gather_path == "numpy":
            for start in range(0, nb, k):
                stop = min(start + k, nb)
                yield start, np.stack([images[perm[b * bs : (b + 1) * bs]] for b in range(start, stop)]), \
                    labels(start, stop)
            return
        g = native.NativeBatchGatherer(images)
        try:
            g.start_epoch(perm, bs)
            for start in range(0, nb, k):
                chunk = _staging((min(k, nb - start), bs, images.shape[1]), self.group.device)
                for j in range(chunk.shape[0]):
                    g.next_batch(chunk[j])
                yield start, chunk, labels(start, start + chunk.shape[0])
        finally:
            g.close()

    def epoch(self, epoch: int) -> Iterator:
        """Iterate one epoch: this rank's rows of each batch, or ``(images,
        labels)`` with labels."""
        for start, chunk, labels in self._host_chunks(epoch, 1):
            self._hook(epoch, start, 1)
            images = _put(chunk[0], self.group, 0)
            yield images if labels is None else (images, _put(labels[0], self.group, 0))

    def epoch_chunks(self, epoch: int, k: int) -> Iterator:
        """Iterate one epoch as stacked ``(k, rows, ...)`` chunks, yielding
        ``(start_batch_index, chunk)``, or ``(start_batch_index, images,
        labels)`` with labels; the last chunk may hold fewer than ``k``
        batches. Same order and boundaries as :meth:`epoch`."""
        _check_chunk_size(k)
        return self._chunks(epoch, k)

    def _chunks(self, epoch: int, k: int) -> Iterator:
        for start, chunk, labels in self._host_chunks(epoch, k):
            self._hook(epoch, start, len(chunk))
            images = _put(chunk, self.group, 1)
            yield (start, images) if labels is None else (start, images, _put(labels, self.group, 1))

    def _hook(self, epoch: int, start: int, n: int) -> None:
        """Run the fault hook for batches ``start .. start + n - 1``."""
        if self.fault_hook is not None:
            for b in range(start, start + n):
                self.fault_hook(epoch, b)

    @property
    def samples_per_epoch(self) -> int:
        return self.num_batches * self.batch_size


class StackedTrialDataIterator:
    """K lockstep trial data streams, gathered ``(K, B, ...)`` per step: the
    feed of a stacked bucket (``hpo/driver.py``; ``train/steps.py``'s
    stacked steps) and of PBT (``hpo/pbt.py``).

    Lane ``k`` replays exactly the stream of a :class:`TrialDataIterator`
    with ``seed=seeds[k]``: the same (seed, epoch) permutation and the same
    drop-tail batch boundaries; all K lanes' rows of a step come from one
    host gather and one copy to the device. Lanes advance in lockstep
    rounds of ``num_batches`` steps (they share the batch size and the
    dataset, so their epochs align to rounds); :meth:`set_lane` rebinds a
    lane to a new seed between rounds (a refill starts its own epoch 1
    while the other lanes continue). On a group of several ranks each rank
    takes its contiguous share of every lane's batch.

    ``use_native``, ``prefetch`` and ``prefetch_depth`` are the feed's
    (module docstring), with the JAX package's defaults; ``gather_path``
    says which gather runs. ``wait_hook(blocked_s, nbytes)``, when given, is
    called once per device chunk with the time the consumer was blocked
    obtaining it. ``fault_hook(batch_index, stacked) -> stacked``, when
    given, sees each step's ``(K, rows, ...)`` device batch on the consumer
    side, after the prefetch worker has handed the chunk over (so an
    injected fault fires at the step it names, and a poisoned lane never
    races the copy stream), and may return a replacement.

    Every lane reads the one ``dataset``: the JAX package's per-lane
    datasets (``datasets=``) wait for ROADMAP A.12, where
    ``TrialConfig.dataset`` is ported.
    """

    def __init__(
        self,
        dataset: Dataset,
        group: TrialGroup,
        batch_size: int,
        seeds,
        *,
        use_native: Optional[bool] = None,
        prefetch: Optional[bool] = None,
        prefetch_depth: Optional[int] = None,
        wait_hook: Optional[Callable[[float, int], None]] = None,
        fault_hook: Optional[Callable] = None,
    ):
        _check_divisible(batch_size, group)
        if not seeds:
            raise ValueError("stacked iterator needs at least one lane")
        self.dataset = dataset
        self.group = group
        self.batch_size = batch_size
        self.num_lanes = len(seeds)
        self.num_batches = len(dataset) // batch_size
        if self.num_batches == 0:
            raise ValueError(f"dataset of {len(dataset)} rows smaller than one batch of {batch_size}")
        # (seed, epoch) determines a lane's permutation, as for one trial.
        self._lanes = [{"seed": s, "epoch": 1} for s in seeds]
        self.wait_hook = wait_hook
        self.fault_hook = fault_hook
        self._prefetch = _prefetch_default() if prefetch is None else bool(prefetch)
        self._depth = _prefetch_depth() if prefetch_depth is None else max(1, int(prefetch_depth))
        self.gather_path = _gather_path(use_native)
        # The pipeline's copies to a card run on a stream of their own.
        self._copy_stream = (side_stream(group.device, self) if self._prefetch and group.device.type == "cuda"
                             else None)

    def set_lane(self, k: int, seed: int, epoch: int = 1) -> None:
        """Rebind lane ``k`` to a fresh (seed, epoch) stream (a refill),
        from the next round on."""
        self._lanes[k] = {"seed": seed, "epoch": epoch}

    @property
    def samples_per_epoch(self) -> int:
        """Rows each lane consumes per round (drop-tail, like the
        unstacked iterator)."""
        return self.num_batches * self.batch_size

    def _round_perms(self) -> np.ndarray:
        """``(K, rows)``: each lane's permutation for its current epoch."""
        rows = np.arange(len(self.dataset))
        return np.stack([epoch_permutation(lane["seed"], lane["epoch"], rows) for lane in self._lanes])

    def _gather(self, perms: np.ndarray, b: int) -> np.ndarray:
        """The numpy gather of stacked step ``b``: one fancy index, ``(K, B,
        D)``."""
        bs = self.batch_size
        idx = perms[:, b * bs : (b + 1) * bs].reshape(-1)
        return self.dataset.images[idx].reshape(self.num_lanes, bs, -1)

    def _host_chunks(self, k_steps: int, endless: bool) -> Iterator[tuple]:
        """Host ``(start_batch_index, (s, K, B, D))`` chunks of one lockstep
        round, the last possibly shorter; ``endless``: of every round, each
        chunk full, crossing round edges. A round's permutations are fixed
        when its first step is gathered, and every lane's epoch advances
        after its last."""
        shape = (self.num_lanes, self.batch_size, self.dataset.images.shape[1])
        nb, chunk, start, j = self.num_batches, None, 0, 0
        while True:
            perms = self._round_perms()
            g = native.StackedBatchGatherer(self.dataset.images) if self.gather_path == "native" else None
            try:
                if g is not None:
                    g.start_round(perms, self.batch_size)
                for b in range(nb):
                    if chunk is None:
                        s = k_steps if endless else min(k_steps, nb - b)
                        chunk, start, j = [] if g is None else _staging((s, *shape), self.group.device), b, 0
                    if g is None:
                        chunk.append(self._gather(perms, b))
                    else:
                        g.next_stacked(chunk[j])
                    j += 1
                    if j == s:
                        yield start, np.stack(chunk) if g is None else chunk
                        chunk = None
            finally:
                if g is not None:
                    g.close()
            for lane in self._lanes:
                lane["epoch"] += 1
            if not endless:
                return

    def _stage(self, chunk) -> tuple:
        """On the prefetch thread: this rank's rows of a host chunk on the
        group's device, and on a card the event recorded after the copy,
        which runs on the iterator's copy stream."""
        dev = self.group.device
        if dev.type != "cuda":
            return _put(chunk, self.group, 2), None
        with stream_lock(self._copy_stream), torch.cuda.device(dev), torch.cuda.stream(self._copy_stream):
            x = _put(chunk, self.group, 2)
            ready = torch.cuda.Event()
            ready.record()
        return x, ready

    def _device_chunks(self, k_steps: int, endless: bool) -> Iterator[tuple]:
        """``((start, device chunk), nbytes)`` pairs, pipelined when the
        prefetch is on and there is more than one step to run."""
        host = self._host_chunks(k_steps, endless)
        if not (self._prefetch and (endless or self.num_batches > 1)):
            with contextlib.closing(host):
                for start, chunk in host:
                    yield (start, self._faulted(start, _put(chunk, self.group, 2))), chunk.nbytes
            return

        def staged():
            with contextlib.closing(host):
                for start, chunk in host:
                    yield start, *self._stage(chunk), chunk.nbytes

        for start, x, ready, nbytes in _prefetched(staged(), self._depth):
            if ready is not None:
                consumer = torch.cuda.current_stream(self.group.device)
                consumer.wait_event(ready)
                # The copy stream allocated x: keep its memory until the
                # consumer's work on it is done.
                x.record_stream(consumer)
            yield (start, self._faulted(start, x)), nbytes

    def _faulted(self, start: int, x: torch.Tensor) -> torch.Tensor:
        """The chunk after the fault hook has seen each of its steps (a
        clone where the hook replaced one; the chunk itself when not)."""
        if self.fault_hook is None:
            return x
        out = x
        for j in range(x.shape[0]):
            step = out[j]
            got = self.fault_hook(start + j, step)
            if got is not step:
                if out is x:
                    out = x.clone()
                out[j] = got
        return out

    def _timed(self, pairs: Iterator[tuple]) -> Iterator:
        """Unwrap ``(item, nbytes)`` pairs, giving the wait hook the time the
        consumer was blocked obtaining each item (no clock reads without a
        hook)."""
        with contextlib.closing(pairs):
            if self.wait_hook is None:
                for item, _ in pairs:
                    yield item
                return
            while True:
                t0 = time.perf_counter()
                try:
                    item, nbytes = next(pairs)
                except StopIteration:
                    return
                self.wait_hook(time.perf_counter() - t0, nbytes)
                yield item

    def round_batches(self) -> Iterator[torch.Tensor]:
        """One lockstep round as per-step ``(K, rows, ...)`` device batches."""
        for _, chunk in self._timed(self._device_chunks(1, endless=False)):
            yield chunk[0]

    def round_chunks(self, k_steps: int) -> Iterator:
        """One lockstep round as ``(start_batch_index, (S, K, rows, ...))``
        chunks, the last possibly shorter: the same boundaries as
        :meth:`TrialDataIterator.epoch_chunks`."""
        _check_chunk_size(k_steps)
        return self._timed(self._device_chunks(k_steps, endless=False))

    def stream_chunks(self, k_steps: int) -> Iterator[torch.Tensor]:
        """Endless full ``(S, K, rows, ...)`` chunks that cross round
        boundaries, each round freshly permuted per lane: the feed of a loop
        driven by step counts (PBT's generations of ``S`` steps,
        ``hpo/pbt.py``), where every chunk must be full so that one captured
        graph serves them all. Lane ``k`` replays the stream of a one-lane
        iterator with ``seeds=[seeds[k]]``. The pipeline may run ahead across
        a round edge, so :meth:`set_lane` does not apply to a live stream."""
        _check_chunk_size(k_steps)
        return (chunk for _, chunk in self._timed(self._device_chunks(k_steps, endless=True)))


class EvalDataIterator:
    """Full-coverage eval feed: every row, in dataset order; the final
    batch is zero-padded to ``batch_size`` and paired with 0/1 weights."""

    def __init__(self, dataset: Dataset, group: TrialGroup, batch_size: int):
        _check_divisible(batch_size, group)
        if len(dataset) == 0:
            raise ValueError("cannot evaluate an empty dataset")
        self.dataset = dataset
        self.group = group
        self.batch_size = batch_size
        self.num_rows = len(dataset)
        self.num_batches = -(-self.num_rows // batch_size)  # ceil

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        short = self.batch_size - arr.shape[0]
        if short == 0:
            return arr
        return np.pad(arr, [(0, short)] + [(0, 0)] * (arr.ndim - 1))

    def host_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield host-side ``(imgs, weights)`` group batches, zero-padded to
        ``batch_size``: the one source :meth:`batches` places on the device,
        also taken whole by PBT (``hpo/pbt.py`` stacks the eval set into one
        ``(E, B, ...)`` device tensor)."""
        bs = self.batch_size
        for b in range(self.num_batches):
            rows = self.dataset.images[b * bs : (b + 1) * bs]
            weights = np.zeros(bs, np.float32)
            weights[: rows.shape[0]] = 1.0
            yield self._pad(rows), weights

    def batches(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Yield ``(imgs, weights)`` of this rank's rows, on the device;
        weights are 1.0 on real rows and 0.0 on the final batch's padding."""
        dev = self.group.device
        for rows, weights in self.host_batches():
            yield (
                _to_device(_local_rows(rows, self.group), dev),
                _to_device(_local_rows(weights, self.group), dev),
            )

    def first_host_batch(self) -> np.ndarray:
        """The first eval batch's real rows, host-side."""
        return self.dataset.images[: self.batch_size]
