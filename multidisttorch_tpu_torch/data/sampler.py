"""Trial-aware data sampling and device feeding.

Counterpart of ``multidisttorch_tpu/data/sampler.py``: the same epoch
order, batch boundaries and eval padding, so both packages feed the same
rows. Every trial sees the whole dataset in a fresh seeded permutation per
epoch; ``shard_across_trials=True`` reproduces the reference's cross-trial
sharding (trial ``g`` sees rows ``g::num_trials``). Ragged training tails
are dropped. On a group of several ranks each rank takes its contiguous
share of every batch (``batch_size / group.size`` rows, in group-rank
order), which is how the JAX package's batch sharding splits rows.

Host-to-device copies go through pinned memory and do not block the host.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from multidisttorch_tpu_torch.data.datasets import Dataset
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup


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


def _check_divisible(batch_size: int, group: TrialGroup) -> None:
    if batch_size % group.size != 0:
        raise ValueError(
            f"batch_size {batch_size} must divide evenly over the trial's "
            f"{group.size} ranks"
        )


def _local_rows(rows: np.ndarray, group: TrialGroup, axis: int = 0) -> np.ndarray:
    """This rank's contiguous share of a group batch along ``axis``."""
    if group.size == 1:
        return rows
    per = rows.shape[axis] // group.size
    lo = group.local_rank * per
    return rows.take(np.arange(lo, lo + per), axis=axis)


class TrialDataIterator:
    """Per-trial epoch iterator yielding device-resident batches of this
    rank's rows. Incomplete trailing batches are dropped."""

    def __init__(
        self,
        dataset: Dataset,
        group: TrialGroup,
        batch_size: int,
        *,
        seed: int = 0,
        shard_across_trials: bool = False,
        num_trials: Optional[int] = None,
    ):
        _check_divisible(batch_size, group)
        self.dataset = dataset
        self.group = group
        self.batch_size = batch_size
        self.seed = seed
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

    def _put(self, rows: np.ndarray, axis: int = 0) -> torch.Tensor:
        return _to_device(_local_rows(rows, self.group, axis), self.group.device)

    def _host_batches(self, epoch: int) -> Iterator[np.ndarray]:
        """Host-side group batches of images in the (seed, epoch)
        permutation order."""
        perm = epoch_permutation(self.seed, epoch, self._indices)
        for b in range(self.num_batches):
            yield self.dataset.images[perm[b * self.batch_size : (b + 1) * self.batch_size]]

    def epoch(self, epoch: int) -> Iterator[torch.Tensor]:
        """Iterate one epoch: this rank's rows of each batch."""
        for imgs_np in self._host_batches(epoch):
            yield self._put(imgs_np)

    def epoch_chunks(self, epoch: int, k: int) -> Iterator:
        """Iterate one epoch as stacked ``(k, rows, ...)`` chunks, yielding
        ``(start_batch_index, chunk)``; the last chunk may hold fewer than
        ``k`` batches. Same order and boundaries as :meth:`epoch`."""
        if k < 1:
            raise ValueError(f"chunk size must be >= 1, got {k}")

        def chunks():
            buf, start = [], 0
            for i, imgs_np in enumerate(self._host_batches(epoch)):
                buf.append(imgs_np)
                if len(buf) == k:
                    yield start, self._put(np.stack(buf), axis=1)
                    start, buf = i + 1, []
            if buf:
                yield start, self._put(np.stack(buf), axis=1)

        return chunks()

    @property
    def samples_per_epoch(self) -> int:
        return self.num_batches * self.batch_size


class StackedTrialDataIterator:
    """K lockstep trial data streams, gathered ``(K, B, ...)`` per step: the
    feed of a stacked bucket (``hpo/driver.py``; ``train/steps.py``'s
    stacked steps).

    Lane ``k`` replays exactly the stream of a :class:`TrialDataIterator`
    with ``seed=seeds[k]``: the same (seed, epoch) permutation and the same
    drop-tail batch boundaries; all K lanes' rows of a step come from one
    host gather and one copy to the device. Lanes advance in lockstep
    rounds of ``num_batches`` steps (they share the batch size and the
    dataset, so their epochs align to rounds); :meth:`set_lane` rebinds a
    lane to a new seed mid-sweep (a refill starts its own epoch 1 while the
    other lanes continue). On a group of several ranks each rank takes its
    contiguous share of every lane's batch.

    Every lane reads the one ``dataset``: the JAX package's per-lane
    datasets (``datasets=``) wait for ROADMAP A.12, where
    ``TrialConfig.dataset`` is ported, and its native gatherer for A.4b.
    """

    def __init__(self, dataset: Dataset, group: TrialGroup, batch_size: int, seeds):
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

    def set_lane(self, k: int, seed: int, epoch: int = 1) -> None:
        """Rebind lane ``k`` to a fresh (seed, epoch) stream (a refill)."""
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

    def _host_round(self):
        """Host ``(K, B, D)`` arrays for one lockstep round, then every
        lane's epoch advances."""
        perms, bs = self._round_perms(), self.batch_size
        for b in range(self.num_batches):
            idx = perms[:, b * bs : (b + 1) * bs].reshape(-1)
            yield self.dataset.images[idx].reshape(self.num_lanes, bs, -1)
        for lane in self._lanes:
            lane["epoch"] += 1

    def _put(self, rows: np.ndarray, axis: int) -> torch.Tensor:
        return _to_device(_local_rows(rows, self.group, axis), self.group.device)

    def round_batches(self) -> Iterator[torch.Tensor]:
        """One lockstep round as per-step ``(K, rows, ...)`` device batches."""
        for stacked in self._host_round():
            yield self._put(stacked, axis=1)

    def round_chunks(self, k_steps: int) -> Iterator:
        """One lockstep round as ``(start_batch_index, (S, K, rows, ...))``
        chunks, the last possibly shorter: the same boundaries as
        :meth:`TrialDataIterator.epoch_chunks`."""
        if k_steps < 1:
            raise ValueError(f"chunk size must be >= 1, got {k_steps}")

        def chunks():
            buf, start = [], 0
            for i, stacked in enumerate(self._host_round()):
                buf.append(stacked)
                if len(buf) == k_steps:
                    yield start, self._put(np.stack(buf), axis=2)
                    start, buf = i + 1, []
            if buf:
                yield start, self._put(np.stack(buf), axis=2)

        return chunks()

    def stream_chunks(self, k_steps: int) -> Iterator[torch.Tensor]:
        """Endless full ``(S, K, rows, ...)`` chunks that cross round
        boundaries, each round freshly permuted per lane: the feed of a loop
        driven by step counts (PBT's generations of ``S`` steps,
        ``hpo/pbt.py``), where every chunk must be full so that one captured
        graph serves them all. Lane ``k`` replays the stream of a one-lane
        iterator with ``seeds=[seeds[k]]``."""
        if k_steps < 1:
            raise ValueError(f"chunk size must be >= 1, got {k_steps}")

        def chunks():
            buf = []
            while True:
                for stacked in self._host_round():
                    buf.append(stacked)
                    if len(buf) == k_steps:
                        yield self._put(np.stack(buf), axis=2)
                        buf = []

        return chunks()


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
