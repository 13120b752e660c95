"""Host-side HPO driver: N concurrent trials on N disjoint trial groups.

Counterpart of ``multidisttorch_tpu/hpo/driver.py``, classic path: one
trial per group at a time, each trial data-parallel over its group's ranks.
As in the JAX package:

- every trial has a real config (:class:`TrialConfig`: lr, beta, epochs,
  batch size, seed, model dims), the reference's single knob being
  ``epochs + group_id``;
- dispatch is cooperative and round-robin: one unit of training work per
  trial per turn from one host loop, and no cross-trial barrier anywhere;
  a trial that finishes frees its group for the next queued config (more
  configs than groups queue);
- each epoch trains, evaluates the whole test set (masked posterior-mean
  eval) and draws prior samples, with the JAX package's log lines and
  cadence; losses stay on the device until the epoch boundary;
- each trial writes under ``{out_dir}/trial-{id}/``, once per group.

Per-step randomness comes from per-trial ``torch.Generator``s on the
trial's device, seeded from ``cfg.seed``. Initial weights come from the
module-level :func:`init_vae_params`, so a test can substitute weights
carried across from the JAX package.

What this slice does not port raises ``NotImplementedError`` naming its
ROADMAP item: stacking, resume and checkpoints, the ledger, retry and
failure isolation, fault plans, profiling, the compile farm, weight
sharding and model parallel, pipeline stages, remat and per-trial dataset
references.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from multidisttorch_tpu_torch.data.datasets import Dataset
from multidisttorch_tpu_torch.data.sampler import EvalDataIterator, TrialDataIterator
from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
from multidisttorch_tpu_torch.parallel.cluster import process_world
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup, setup_groups
from multidisttorch_tpu_torch.train.steps import (
    create_train_state,
    make_eval_step,
    make_multi_step,
    make_sample_step,
)
from multidisttorch_tpu_torch.utils.imaging import save_image_grid
from multidisttorch_tpu_torch.utils.logging import log0, log0_enabled


@dataclass(frozen=True)
class TrialConfig:
    """One trial's hyperparameters; the same fields and defaults as the
    JAX package's ``TrialConfig``."""

    trial_id: int
    epochs: int = 3
    batch_size: int = 128
    lr: float = 1e-3  # reference Adam lr, vae-hpo.py:131
    beta: float = 1.0
    seed: int = 0
    hidden_dim: int = 400
    latent_dim: int = 20
    log_interval: int = 10  # reference train log cadence, vae-hpo.py:61
    # Train steps per unit of dispatched work (one turn of the host loop).
    fused_steps: int = 1
    # True: the reference's sampled-z test loss; False: posterior mean.
    eval_sampled: bool = False
    remat: bool = False
    grad_accum: int = 1
    dataset: str = ""
    zero_update: bool = False
    pipeline_stages: int = 1


@dataclass
class TrialResult:
    trial_id: int
    group_id: int
    config: TrialConfig
    history: list = field(default_factory=list)  # per-epoch dicts
    final_train_loss: float = float("nan")  # per-sample avg, last epoch
    final_test_loss: float = float("nan")
    wall_s: float = 0.0
    steps: int = 0
    out_dir: str = ""
    checkpoint: str = ""
    # "completed" | "diverged" (a non-finite epoch loss: a terminal result)
    status: str = "completed"
    error: str = ""
    attempt: int = 1
    resumed_from_step: int = 0
    dataset: str = ""
    dataset_synthetic: bool = False
    # Host-device round-trips paid for metric fetches: one per log line
    # plus two per epoch.
    host_syncs: int = 0
    # Train chunks run as one CUDA-graph replay each (train/steps.py).
    graph_replays: int = 0
    stacked: bool = False
    optimizer_state_bytes: int = 0


# TrialConfig fields this slice does not port: (inert value, ROADMAP item).
_UNPORTED_FIELDS = {
    "remat": (False, "A.3b (train-step extras)"),
    "dataset": ("", "A.12 (service and its dataset store)"),
    "zero_update": (False, "A.13 (sharding)"),
    "pipeline_stages": (1, "A.14 (pipelines)"),
}

# run_hpo arguments this slice does not port: (inert value, ROADMAP item).
_UNPORTED_ARGS = {
    "save_checkpoints": (False, "A.5 (checkpoints)"),
    "resume": (False, "A.5 (checkpoints)"),
    "ckpt_keep_last": (1, "A.5 (checkpoints)"),
    "ledger": (False, "A.6b (ledger and supervision)"),
    "resilient": (False, "A.6b (ledger and supervision)"),
    "retry": (None, "A.6b (ledger and supervision)"),
    "agree_timeout_s": (None, "A.6b (ledger and supervision)"),
    "stack_trials": (False, "A.7 (trial stacking)"),
    "stack_max_lanes": (8, "A.7 (trial stacking)"),
    "precompile": (None, "A.9 (compile and dispatch)"),
    "fault_plan": (None, "A.10 (faults and telemetry)"),
    "profile_dir": (None, "A.10 (faults and telemetry)"),
    "model_parallel": (1, "A.13 (sharding)"),
    "param_shardings_builder": (None, "A.13 (sharding)"),
    "model_builder": (None, "A.16 (other model families)"),
}


def _check_config(cfg: TrialConfig) -> None:
    for name, (inert, item) in _UNPORTED_FIELDS.items():
        if getattr(cfg, name) != inert:
            raise NotImplementedError(
                f"trial {cfg.trial_id}: TrialConfig.{name}={getattr(cfg, name)!r} "
                f"is not ported yet: ROADMAP {item}"
            )
    if cfg.fused_steps < 1:
        raise ValueError(f"fused_steps must be >= 1, got {cfg.fused_steps} (trial {cfg.trial_id})")


def _stream_seed(seed: int, rank: int, stream: int) -> int:
    """A generator seed per (trial seed, group rank, use)."""
    return int(np.random.SeedSequence([seed, rank, stream]).generate_state(1)[0])


class _TrialRun:
    """One trial's lifecycle as a cooperative generator: each ``next()``
    dispatches one chunk of ``cfg.fused_steps`` train steps (or one eval
    batch) and returns; host syncs happen only at log lines and epoch
    boundaries."""

    def __init__(
        self,
        group: TrialGroup,
        cfg: TrialConfig,
        train_data: Dataset,
        test_data: Optional[Dataset],
        out_dir: str,
        *,
        shard_across_trials: bool = False,
        num_trials: int = 1,
        save_images: bool = True,
        verbose: bool = True,
    ):
        _check_config(cfg)
        self.group = group
        self.cfg = cfg
        self.out_dir = os.path.join(out_dir, f"trial-{cfg.trial_id}")
        self.result = TrialResult(
            trial_id=cfg.trial_id,
            group_id=group.group_id,
            config=cfg,
            out_dir=self.out_dir,
            dataset=train_data.name,
            dataset_synthetic=train_data.synthetic,
        )
        self._is_writer = group.is_writer_process
        self._images_requested = save_images
        self._save_images = save_images and self._is_writer
        self._verbose = verbose
        self._host_syncs = 0

        model = VAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim)
        init_vae_params(model, cfg.seed)
        self.state = create_train_state(group, model, cfg.lr)
        self.multi_step = make_multi_step(group, beta=cfg.beta, grad_accum=cfg.grad_accum)
        self.eval_step = make_eval_step(group, beta=cfg.beta, with_recon=save_images)
        self.sample_step = make_sample_step(group)
        self.train_iter = TrialDataIterator(
            train_data,
            group,
            cfg.batch_size,
            seed=cfg.seed,
            shard_across_trials=shard_across_trials,
            num_trials=num_trials,
        )
        self.test_iter = (
            EvalDataIterator(test_data, group, cfg.batch_size)
            if test_data is not None and len(test_data) > 0
            else None
        )
        dev = group.device
        self._train_gen = torch.Generator(device=dev).manual_seed(
            _stream_seed(cfg.seed, group.local_rank, 0)
        )
        self._eval_gen = torch.Generator(device=dev).manual_seed(
            _stream_seed(cfg.seed, group.local_rank, 1)
        )
        self._sample_gen = torch.Generator(device=dev).manual_seed(
            _stream_seed(cfg.seed, group.local_rank, 2)
        )

    def _log(self, *args, level: int = logging.INFO):
        if self._verbose:
            log0(*args, trial=self.group, level=level)

    def _log_batch(self, epoch: int, i: int, loss_sum) -> None:
        # Per-step lines ride DEBUG: a sweep that raises the level skips
        # the device sync below entirely, not just the print.
        if not self._verbose or not log0_enabled(logging.DEBUG):
            return
        self._host_syncs += 1
        cfg = self.cfg
        self._log(
            "Train Epoch: {} [{}/{} ({:.0f}%)]\tLoss: {:.6f}".format(
                epoch,
                i * cfg.batch_size,
                self.train_iter.samples_per_epoch,
                100.0 * i / self.train_iter.num_batches,
                float(loss_sum) / cfg.batch_size,
            ),
            level=logging.DEBUG,
        )

    def run(self) -> Iterator[None]:
        cfg = self.cfg
        t0 = time.time()
        n_per_epoch = self.train_iter.samples_per_epoch
        for epoch in range(1, cfg.epochs + 1):
            epoch_sum = None  # on the device until the epoch's one fetch
            for i0, chunk in self.train_iter.epoch_chunks(epoch, cfg.fused_steps):
                self.state, metrics = self.multi_step(self.state, chunk, generator=self._train_gen)
                losses = metrics["loss_sum"]
                s = losses.sum()
                epoch_sum = s if epoch_sum is None else epoch_sum + s
                # Every batch index that logs in a one-step loop logs here.
                j = -(-i0 // cfg.log_interval) * cfg.log_interval
                while j < i0 + chunk.shape[0]:
                    self._log_batch(epoch, j, losses[j - i0])
                    j += cfg.log_interval
                yield  # hand the host loop to the next trial

            self._host_syncs += 1
            avg = float(epoch_sum) / n_per_epoch
            if not math.isfinite(avg):
                # A terminal result of the config, recorded, not raised.
                self.result.status = "diverged"
                self.result.error = (
                    f"non-finite epoch average train loss {avg} at step {self.state.step}"
                )
                self.result.steps = self.state.step
                self._log(f"Trial {cfg.trial_id} DIVERGED ({self.result.error})")
                return
            self._log("====> Epoch: {} Average loss: {:.4f}".format(epoch, avg))
            record = {"epoch": epoch, "avg_train_loss": avg}

            if self.test_iter is not None:
                test_sum, first_recon = None, None
                for j, (tbatch, tweights) in enumerate(self.test_iter.batches()):
                    out = self.eval_step(
                        self.state,
                        tbatch,
                        tweights,
                        generator=self._eval_gen if cfg.eval_sampled else None,
                    )
                    test_sum = out["loss_sum"] if test_sum is None else test_sum + out["loss_sum"]
                    if j == 0 and self._save_images:
                        first_recon = out["recon"].cpu().numpy()
                    yield
                self._host_syncs += 1
                test_avg = float(test_sum) / self.test_iter.num_rows
                self._log("====> Test set loss: {:.4f}".format(test_avg))
                record["test_loss"] = test_avg
                self.result.final_test_loss = test_avg
                if first_recon is not None:
                    first_batch = self.test_iter.first_host_batch()
                    n = min(8, first_batch.shape[0], first_recon.shape[0])
                    save_image_grid(
                        np.concatenate([first_batch[:n], first_recon[:n]]),
                        os.path.join(self.out_dir, f"reconstruction_{epoch}.png"),
                        nrow=n,
                    )

            if self._images_requested:
                sample_out = self.sample_step(self.state, self._sample_gen)
                if self._save_images:
                    save_image_grid(
                        sample_out.cpu().numpy(),
                        os.path.join(self.out_dir, f"sample_{epoch}.png"),
                    )

            self.result.history.append(record)
            self.result.final_train_loss = avg

        if self.group.device.type == "cuda":
            # wall-clock covers real completion
            torch.cuda.synchronize(self.group.device)
        self.result.wall_s = time.time() - t0
        self.result.steps = self.state.step
        self.result.host_syncs = self._host_syncs
        self.result.graph_replays = self.multi_step.replays
        if self._is_writer:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(os.path.join(self.out_dir, "metrics.json"), "w") as f:
                json.dump(
                    {
                        "trial_id": self.result.trial_id,
                        "group_id": self.result.group_id,
                        "config": asdict(cfg),
                        "dataset": self.result.dataset,
                        "dataset_synthetic": self.result.dataset_synthetic,
                        "history": self.result.history,
                        "wall_s": self.result.wall_s,
                        "steps": self.result.steps,
                    },
                    f,
                    indent=2,
                )
        self._log(f"Done. time: {self.result.wall_s:f}")


def predicted_cost(cfg: TrialConfig, train_rows: int) -> int:
    """Relative duration estimate for one trial: optimizer steps to run."""
    return cfg.epochs * max(1, train_rows // max(1, cfg.batch_size))


def balanced_assignment(costs: Sequence[int], num_groups: int) -> list[int]:
    """Deterministic least-loaded assignment: config i → the group whose
    accumulated predicted cost is smallest (ties → lowest group index).
    A pure function, so every process computes the same schedule."""
    loads = [0] * num_groups
    out = []
    for c in costs:
        g = min(range(num_groups), key=lambda j: (loads[j], j))
        loads[g] += c
        out.append(g)
    return out


def run_hpo(
    configs: Sequence[TrialConfig],
    train_data: Dataset,
    test_data: Optional[Dataset] = None,
    *,
    groups: Optional[Sequence[TrialGroup]] = None,
    num_groups: Optional[int] = None,
    device=None,
    out_dir: str = "results",
    shard_across_trials: bool = False,
    save_images: bool = True,
    verbose: bool = True,
    save_checkpoints: bool = False,
    resume: bool = False,
    ckpt_keep_last: int = 1,
    ledger: bool = False,
    resilient: bool = False,
    retry=None,
    agree_timeout_s: Optional[float] = None,
    stack_trials: bool = False,
    stack_max_lanes: int = 8,
    precompile: Optional[bool] = None,
    fault_plan=None,
    profile_dir: Optional[str] = None,
    model_parallel: int = 1,
    param_shardings_builder=None,
    model_builder=None,
) -> list[TrialResult]:
    """Run the configs over disjoint trial groups, concurrently, with no
    cross-trial synchronisation.

    ``groups`` defaults to ``setup_groups(num_groups or len(configs),
    device=device)``, which runs on CUDA unless ``device="cpu"``. More
    configs than groups queue: a group takes its next config the moment its
    trial finishes (greedily in one process; by :func:`balanced_assignment`
    across processes, which must all schedule alike without talking).
    Trials whose group this process is not a member of are skipped here.
    Trials train through the fused ELBO kernels (``make_multi_step``'s
    default).

    Returns results for the trials run here, in config order.
    """
    passed = locals()
    for name, (inert, item) in _UNPORTED_ARGS.items():
        if passed[name] != inert:
            raise NotImplementedError(
                f"run_hpo({name}={passed[name]!r}) is not ported yet: ROADMAP {item}"
            )
    for cfg in configs:
        _check_config(cfg)
    if groups is None:
        groups = setup_groups(
            num_groups if num_groups is not None else len(configs), device=device
        )
    if len(configs) < len(groups):
        raise ValueError(
            f"{len(configs)} configs but {len(groups)} trial groups (fewer "
            "configs than groups would idle groups; carve fewer groups instead)"
        )

    world, _ = process_world()
    shared = list(enumerate(configs))
    per_group: dict[int, list] = {g.group_id: [] for g in groups}
    if world > 1:
        assignment = balanced_assignment(
            [predicted_cost(cfg, len(train_data)) for cfg in configs], len(groups)
        )
        for i, cfg in enumerate(configs):
            per_group[groups[assignment[i]].group_id].append((i, cfg))

    def queue_of(g: TrialGroup) -> list:
        return shared if world == 1 else per_group[g.group_id]

    local_groups = [g for g in groups if g.is_local_member]
    active: dict[int, tuple] = {}  # group_id -> (config index, run, generator)
    results: dict[int, TrialResult] = {}

    def start_next(g: TrialGroup) -> None:
        q = queue_of(g)
        if not q:
            return
        i, cfg = q.pop(0)
        run = _TrialRun(
            g,
            cfg,
            train_data,
            test_data,
            out_dir,
            shard_across_trials=shard_across_trials,
            # Shard by group, not by config: with more configs than
            # groups, group_id::len(groups) still partitions the rows.
            num_trials=len(groups),
            save_images=save_images,
            verbose=verbose,
        )
        active[g.group_id] = (i, run, run.run())

    for g in local_groups:
        start_next(g)
    # Cooperative round-robin: one unit of work per trial per cycle.
    while active:
        for g in local_groups:
            if g.group_id not in active:
                continue
            i, run, gen = active[g.group_id]
            try:
                next(gen)
            except StopIteration:
                results[i] = run.result
                del active[g.group_id]
                start_next(g)
    return [results[i] for i in sorted(results)]
