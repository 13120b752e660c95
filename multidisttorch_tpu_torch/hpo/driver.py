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
- each trial writes under ``{out_dir}/trial-{id}/``, once per group;
- each epoch ends with a checkpoint (``train/checkpoint.py``; the JAX
  package's files, v2 by default), written by a background thread from a
  host copy taken at the boundary; ``resume`` restores from it;
- every attempt's config hash and outcome go to the sweep ledger
  (``{out_dir}/sweep_ledger.jsonl``, ``hpo/ledger.py``); failures are
  classified (``hpo/supervision.py``): a non-finite loss is a terminal
  ``diverged`` result, an infra failure is retried under ``retry`` from
  the last valid checkpoint, a preemption or lost peer propagates.

Per-step randomness comes from per-trial ``torch.Generator``s on the
trial's device, seeded from ``cfg.seed``. A checkpoint's sidecar carries
their states (one per group rank) under ``"torch_generators"``, so a
resume draws the noise the uninterrupted run would have drawn; a
checkpoint the JAX package wrote has none, and the generators then start
from the seed (ROADMAP C.5). Initial weights come from the module-level
:func:`init_vae_params`, so a test can substitute weights carried across
from the JAX package.

What this slice does not port raises ``NotImplementedError`` naming its
ROADMAP item: stacking, fault plans, profiling, the compile farm, weight
sharding and model parallel, pipeline stages, remat and per-trial dataset
references.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from multidisttorch_tpu_torch.data.datasets import Dataset
from multidisttorch_tpu_torch.data.sampler import EvalDataIterator, TrialDataIterator
from multidisttorch_tpu_torch.hpo.ledger import SweepLedger, config_hash
from multidisttorch_tpu_torch.hpo.supervision import (
    DIVERGENCE,
    FATAL,
    INFRA,
    PREEMPTION,
    RetryPolicy,
    UnretryableError,
    classify_failure,
)
from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
from multidisttorch_tpu_torch.parallel.cluster import WedgedCollective, env_timeout, process_world
from multidisttorch_tpu_torch.parallel.collectives import group_all_gather, group_all_ok, group_min_scalar
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup, setup_groups
from multidisttorch_tpu_torch.train.checkpoint import (
    default_format,
    restore_latest_valid,
    restore_state,
    save_state,
    train_state_to_tree,
    valid_candidates_by_step,
)
from multidisttorch_tpu_torch.train.guards import check_finite
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
    # "completed" | "failed" | "resumed_complete" | "diverged" (a
    # non-finite epoch loss: a terminal result, never retried)
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


# The checkpoint sidecar's key for the trial's generator states.
GENERATORS_KEY = "torch_generators"


def config_mismatch_vs_meta(cfg: TrialConfig, meta: dict) -> dict:
    """Fields (epochs excluded: extending epochs is the legitimate resume
    use) where a checkpoint's recorded config differs from ``cfg``; an
    empty dict is a match. Fields absent from an older sidecar compare
    against their TrialConfig default; keys that are not config fields
    (``step``, ``history``, the generator states) are ignored. A copy of
    the JAX package's rule."""
    from dataclasses import MISSING, fields as dc_fields

    field_defaults = {f.name: f.default for f in dc_fields(TrialConfig) if f.default is not MISSING}
    saved = {
        k: meta.get(k, field_defaults.get(k))
        for k in asdict(cfg)
        if k != "epochs" and (k in meta or k in field_defaults)
    }
    current = {k: v for k, v in asdict(cfg).items() if k != "epochs"}
    if not saved or saved == current:
        return {}
    return {k: (saved.get(k), current[k]) for k in current if saved.get(k) != current[k]}


def _result_summary(result: TrialResult) -> dict:
    """The ledger's attempt_end payload: enough to rebuild a TrialResult
    when a restarted sweep skips the trial."""
    return {
        "group_id": result.group_id,
        "history": list(result.history),
        "final_train_loss": result.final_train_loss,
        "final_test_loss": result.final_test_loss,
        "wall_s": result.wall_s,
        "steps": result.steps,
        "out_dir": result.out_dir,
        "checkpoint": result.checkpoint,
        "dataset": result.dataset,
        "dataset_synthetic": result.dataset_synthetic,
        "stacked": result.stacked,
        "resumed_from_step": result.resumed_from_step,
        "optimizer_state_bytes": result.optimizer_state_bytes,
    }


def _result_from_summary(cfg: TrialConfig, rec: dict, status: str) -> TrialResult:
    """Rebuild a TrialResult from a ledger attempt_end record (either
    package's)."""
    s = rec.get("summary") or {}
    return TrialResult(
        trial_id=cfg.trial_id,
        group_id=int(s.get("group_id", -1)),
        config=cfg,
        history=list(s.get("history", [])),
        final_train_loss=float(s.get("final_train_loss", float("nan"))),
        final_test_loss=float(s.get("final_test_loss", float("nan"))),
        wall_s=float(s.get("wall_s", 0.0)),
        steps=int(s.get("steps", 0)),
        out_dir=s.get("out_dir", ""),
        checkpoint=s.get("checkpoint", ""),
        status=status,
        error=rec.get("error", ""),
        dataset=s.get("dataset", ""),
        dataset_synthetic=bool(s.get("dataset_synthetic", False)),
        stacked=bool(s.get("stacked", False)),
        attempt=int(rec.get("attempt", 1)),
        resumed_from_step=int(s.get("resumed_from_step", 0)),
        optimizer_state_bytes=int(s.get("optimizer_state_bytes", 0)),
    )


class _TrialRun:
    """One trial's lifecycle as a cooperative generator: each ``next()``
    dispatches one chunk of ``cfg.fused_steps`` train steps (or one eval
    batch) and returns; host syncs happen only at log lines and epoch
    boundaries.

    ``resume`` is False (start from scratch), True (the strict restore of
    the trial's checkpoint, refusing a changed config or a state/sidecar
    skew) or ``"scan"`` (a supervised retry's restore of the newest valid
    checkpoint, scanning back past torn or corrupt ones; on a multi-rank
    group the ranks agree on the step first). Either restore runs here,
    before the first chunk, into the state's own tensors, so the CUDA
    graphs the first chunks capture hold the restored state.
    """

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
        save_checkpoint: bool = True,
        verbose: bool = True,
        resume=False,
        agree_failures: bool = False,
        agree_timeout_s: Optional[float] = None,
        ckpt_keep_last: int = 1,
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
        self._save_checkpoint = save_checkpoint
        self._verbose = verbose
        self._host_syncs = 0
        # Multi-rank failure isolation: writer-only host-I/O failures are
        # deferred and agreed at the epoch boundary (group_all_ok), so
        # every rank ends the trial together.
        self._agree = agree_failures
        self._agree_timeout_s = agree_timeout_s
        self._deferred_error: Optional[BaseException] = None
        self._ckpt_keep_last = ckpt_keep_last
        self._ckpt_format = default_format()

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
        self._generators = {"train": self._train_gen, "eval": self._eval_gen, "sample": self._sample_gen}

        self._ckpt_path = os.path.join(self.out_dir, "state.msgpack")
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None
        self._start_epoch = 1
        if resume == "scan":
            # Recover the most work possible; nothing valid means scratch.
            got = self._restore_scan()
            if got is not None:
                _, meta, used = got
                self._adopt(meta)
                self._log(f"Trial {cfg.trial_id} retry resumes from epoch {self._start_epoch - 1} checkpoint ({used})")
        elif resume:
            meta_path = self._ckpt_path + ".json"
            if os.path.exists(self._ckpt_path) and os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                diff = config_mismatch_vs_meta(cfg, meta)
                if diff:
                    raise UnretryableError(
                        f"resume: trial {cfg.trial_id} checkpoint at {self._ckpt_path} was "
                        f"written under different hyperparameters {diff} (saved vs current); "
                        "refusing to continue stale weights under a changed config"
                    )
                if int(meta.get("completed_epochs", 0)) >= 1:
                    restore_state(self.state, self._ckpt_path)
                    if "step" in meta and self.state.step != int(meta["step"]):
                        raise UnretryableError(
                            f"resume: trial {cfg.trial_id} checkpoint is skewed — "
                            f"state.msgpack is at optimizer step {self.state.step} but the "
                            f"metadata sidecar claims step {meta['step']} (epoch "
                            f"{meta['completed_epochs']}). A crash likely landed between the "
                            f"two checkpoint file replaces; delete {self._ckpt_path}* to "
                            "restart this trial from scratch rather than silently re-train "
                            "an already-applied epoch"
                        )
                    self._adopt(meta)
        # The resume step is epochs done x batches per epoch.
        self.result.resumed_from_step = (self._start_epoch - 1) * self.train_iter.num_batches

    def _restore_scan(self):
        """The newest valid checkpoint whose config matches, restored
        into the state: ``(state, meta, used_path)``, or None for scratch.

        A multi-rank group agrees first, over its own process group: the
        minimum of the ranks' newest valid steps, then whether every rank
        holds a valid candidate at that step. Shared-filesystem views can
        differ (a write torn under one reader), and ranks that resumed
        different weights would silently diverge; any disagreement sends
        every rank back to scratch.
        """
        def accept(meta: dict) -> bool:
            return not config_mismatch_vs_meta(self.cfg, meta) and int(meta.get("completed_epochs", 0)) >= 1

        if self.group.size == 1:
            return restore_latest_valid(self.state, self._ckpt_path, accept_meta=accept)
        cands = valid_candidates_by_step(self._ckpt_path, accept_meta=accept)
        what = f"trial {self.cfg.trial_id} restore agreement over group {self.group.group_id}"
        agreed = group_min_scalar(
            self.group, max(cands, default=0), timeout_s=self._agree_timeout_s,
            what=f"{what} (best-step round)", error_cls=WedgedCollective,
        )
        # Both rounds run on every rank, whatever its local verdict.
        if not group_all_ok(
            self.group, agreed in cands, timeout_s=self._agree_timeout_s,
            what=f"{what} (availability round)", error_cls=WedgedCollective,
        ):
            return None
        cand, meta = cands[agreed]
        restore_state(self.state, cand)
        return self.state, meta, cand

    def _adopt(self, meta: dict) -> None:
        """Continue after a restored checkpoint: its epoch, its history and
        its generator states (this rank's)."""
        self._start_epoch = int(meta["completed_epochs"]) + 1
        self.result.history = list(meta.get("history", []))
        if self.result.history:
            last = self.result.history[-1]
            self.result.final_train_loss = last.get("avg_train_loss", float("nan"))
            self.result.final_test_loss = last.get("test_loss", float("nan"))
        saved = meta.get(GENERATORS_KEY) or {}
        for name, gen in self._generators.items():
            per_rank = saved.get(name) or []
            if len(per_rank) == self.group.size:
                raw = base64.b64decode(per_rank[self.group.local_rank])
                gen.set_state(torch.frombuffer(bytearray(raw), dtype=torch.uint8))

    def _generator_states(self) -> dict:
        """Every group rank's generator states, base64, in rank order; a
        collective on a multi-rank group, so every rank calls it at the
        same boundary."""
        out = {}
        for name, gen in self._generators.items():
            state = gen.get_state()
            if self.group.size > 1:
                state = group_all_gather(self.group, state.to(self.group.device)).cpu()
            out[name] = [
                base64.b64encode(part.numpy().tobytes()).decode("ascii")
                for part in state.view(self.group.size, -1)
            ]
        return out

    @contextmanager
    def _guard(self):
        """Collect writer-only host-I/O failures (images, checkpoint,
        metrics) for the epoch-boundary agreement instead of raising on one
        rank of a multi-rank group. Outside agreement mode errors raise at
        the fault site."""
        if not self._agree:
            yield
            return
        try:
            yield
        except Exception as e:  # noqa: BLE001 — deferred to agreement
            if self._deferred_error is None:
                self._deferred_error = e

    def _agree_boundary(self, where: str) -> None:
        """Every rank calls this at the same point (each epoch boundary,
        and once at completion); if any rank deferred a failure, all
        raise. Deadline-bounded: a dead peer raises WedgedCollective."""
        if not self._agree:
            return
        err, self._deferred_error = self._deferred_error, None
        if not group_all_ok(
            self.group, err is None, timeout_s=self._agree_timeout_s,
            what=f"trial {self.cfg.trial_id} {where} health agreement over group {self.group.group_id}",
            error_cls=WedgedCollective,
        ):
            if err is not None:
                raise err
            raise RuntimeError(
                f"trial {self.cfg.trial_id}: {where} failed on a peer rank "
                "(agreed via the group's health reduction)"
            )

    def _write_ckpt(self, tree: dict, meta: dict) -> None:
        """Background checkpoint write. ``result.checkpoint`` is set only
        after the atomic write succeeds; a failure is re-raised at the next
        :meth:`_join_ckpt`."""
        try:
            save_state(tree, self._ckpt_path, metadata=meta, keep_last=self._ckpt_keep_last,
                       format=self._ckpt_format)
            self.result.checkpoint = self._ckpt_path
        except BaseException as e:  # noqa: BLE001 — re-raised at the next join
            self._ckpt_error = e

    def _join_ckpt(self) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        if self._ckpt_error is not None:
            e, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError(
                f"trial {self.cfg.trial_id}: checkpoint write to {self._ckpt_path} failed"
            ) from e

    def _ckpt_idle(self) -> bool:
        """No checkpoint write in flight (the non-blocking sibling of
        :meth:`_join_ckpt`)."""
        t = self._ckpt_thread
        return t is None or not t.is_alive()

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
        if self._start_epoch > cfg.epochs:
            # A fully trained checkpoint: nothing to replay.
            self.result.status = "resumed_complete"
            self.result.steps = self.state.step
            self.result.checkpoint = self._ckpt_path
            self._log(f"Trial {cfg.trial_id} already complete; resumed.")
            return
        n_per_epoch = self.train_iter.samples_per_epoch
        for epoch in range(self._start_epoch, cfg.epochs + 1):
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
            # Raised before the checkpoint below, so non-finite weights
            # never replace a valid checkpoint; run_hpo records a
            # "diverged" result.
            avg = check_finite(
                float(epoch_sum) / n_per_epoch, "epoch average train loss",
                step=self.state.step, trial_id=cfg.trial_id,
            )
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
                    with self._guard():
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
                    with self._guard():
                        save_image_grid(
                            sample_out.cpu().numpy(),
                            os.path.join(self.out_dir, f"sample_{epoch}.png"),
                        )

            self.result.history.append(record)
            self.result.final_train_loss = avg
            if self._save_checkpoint:
                # The epoch boundary is the resume point. The generator
                # states are gathered on every rank; the writer takes host
                # copies of the state here, before the next chunk changes
                # it, and a background thread serialises and writes them.
                generators = self._generator_states()
                if self._is_writer:
                    with self._guard():
                        tree = train_state_to_tree(self.state)
                        meta = {
                            **asdict(cfg),
                            "completed_epochs": epoch,
                            "step": self.state.step,
                            "history": list(self.result.history),
                            GENERATORS_KEY: generators,
                        }
                        self._join_ckpt()
                        # Non-daemon: interpreter exit waits for the write.
                        self._ckpt_thread = threading.Thread(
                            target=self._write_ckpt, args=(tree, meta), daemon=False
                        )
                        self._ckpt_thread.start()
            self._agree_boundary(f"epoch {epoch} boundary work")

        if self.group.device.type == "cuda":
            # wall-clock covers real completion
            torch.cuda.synchronize(self.group.device)
        with self._guard():
            self._join_ckpt()
        self.result.wall_s = time.time() - t0
        self.result.steps = self.state.step
        self.result.host_syncs = self._host_syncs
        self.result.graph_replays = self.multi_step.replays
        if self._is_writer:
            with self._guard():
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
        self._agree_boundary("completion work")
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
    save_checkpoints: bool = True,
    resume=False,
    ckpt_keep_last: int = 1,
    ledger: bool = True,
    resilient: bool = False,
    retry: Optional[RetryPolicy] = None,
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

    As in the JAX package:

    - ``save_checkpoints`` (default on) writes each trial's per-epoch
      checkpoint under ``{out_dir}/trial-{id}/state.msgpack``, keeping the
      ``ckpt_keep_last`` newest; the format is ``MDT_CKPT_FORMAT`` (v2
      unless ``v1``).
    - ``resume=True`` restores each trial from its checkpoint (refusing a
      changed config) and skips trials the ledger settled under the same
      config hash; ``resume="scan"`` restores through the scan-back past
      torn or corrupt checkpoints instead.
    - ``ledger`` (default on) appends every attempt's config hash and
      outcome to ``{out_dir}/sweep_ledger.jsonl``.
    - ``resilient=True`` records a failed trial (``status="failed"``) and
      frees its group; by default the failure is raised. A non-finite loss
      is always a recorded ``diverged`` result. A preemption or lost peer
      always propagates.
    - ``retry=RetryPolicy(...)`` retries infra failures with backoff (which
      never blocks other queued trials), each retry resuming from the
      trial's last valid checkpoint.
    - ``agree_timeout_s`` bounds every agreement over a multi-rank group
      (default ``MDT_AGREE_TIMEOUT_S``, else 600 s).

    Returns results for the trials run here (or settled in the ledger), in
    config order.
    """
    passed = locals()
    for name, (inert, item) in _UNPORTED_ARGS.items():
        if passed[name] != inert:
            raise NotImplementedError(
                f"run_hpo({name}={passed[name]!r}) is not ported yet: ROADMAP {item}"
            )
    if resume not in (False, True, "scan"):
        raise ValueError(f"resume must be False, True or 'scan', got {resume!r}")
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
    if agree_timeout_s is None:
        agree_timeout_s = env_timeout("MDT_AGREE_TIMEOUT_S", 600.0)

    world, rank = process_world()
    single = world == 1

    def needs_agreement(g: TrialGroup) -> bool:
        # Writer-only failures on a multi-rank group must end the trial on
        # every rank together.
        return resilient and g.size > 1

    # The sweep's durable control state. Only process 0 writes; every
    # process reads, so skip decisions are the same everywhere.
    chashes = {i: config_hash(asdict(cfg)) for i, cfg in enumerate(configs)}
    led = SweepLedger(out_dir, enabled=ledger, write=rank == 0)
    prior_attempts = led.attempts() if led.enabled else {}
    attempts = {i: prior_attempts.get(chashes[i], 0) for i in range(len(configs))}
    # The retry budget counts infra FAILURES, not attempts: preemption
    # restarts must not eat it.
    prior_fails = led.infra_failures() if led.enabled else {}
    infra_fails = {i: prior_fails.get(chashes[i], 0) for i in range(len(configs))}

    results: dict[int, TrialResult] = {}
    skipped: set[int] = set()
    if resume and led.enabled:
        # Trials the ledger settled under a byte-identical config are
        # rebuilt from their summary and never scheduled.
        settled = led.finished()
        for i, cfg in enumerate(configs):
            rec = settled.get(chashes[i])
            if rec is None:
                continue
            status = "resumed_complete" if rec.get("status") == "completed" else "diverged"
            results[i] = _result_from_summary(cfg, rec, status)
            skipped.add(i)
        if skipped:
            log0(f"sweep ledger: {len(skipped)} of {len(configs)} trials already settled; re-running only the rest")

    def make_run(g: TrialGroup, cfg: TrialConfig, resume_mode) -> _TrialRun:
        return _TrialRun(
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
            save_checkpoint=save_checkpoints,
            verbose=verbose,
            resume=resume_mode,
            agree_failures=needs_agreement(g),
            agree_timeout_s=agree_timeout_s,
            ckpt_keep_last=ckpt_keep_last,
        )

    # Queue items are (kind, config index, config, ready_at): kind "single"
    # or "retry"; ready_at in the future marks a retry still in its backoff
    # (skipped, not blocking: other queued work runs first).
    shared = [("single", i, cfg, 0.0) for i, cfg in enumerate(configs) if i not in skipped]
    per_group: dict[int, list] = {g.group_id: [] for g in groups}
    if not single:
        assignment = balanced_assignment(
            [predicted_cost(cfg, len(train_data)) for cfg in configs], len(groups)
        )
        for item in shared:
            per_group[groups[assignment[item[1]]].group_id].append(item)

    def queue_of(g: TrialGroup) -> list:
        return shared if single else per_group[g.group_id]

    local_groups = [g for g in groups if g.is_local_member]
    active: dict[int, tuple] = {}  # group_id -> (config index, run, generator)

    def attempt_progress(run: Optional[_TrialRun]) -> dict:
        """Executed work of a failed or interrupted attempt."""
        if run is None:
            return {"resumed_from_step": 0, "steps_at_failure": 0}
        return {"resumed_from_step": run.result.resumed_from_step, "steps_at_failure": run.state.step}

    def schedule_retry(g: TrialGroup, i: int, cfg: TrialConfig, error_text: str, progress=None) -> bool:
        """Spend one unit of the infra retry budget and requeue the trial;
        False when there is no policy or the budget is spent."""
        if retry is None:
            return False
        fails = infra_fails[i] = infra_fails[i] + 1
        if not retry.should_retry(fails, INFRA):
            return False
        # Backoff deadlines are wall-clock, hence process-local: across
        # processes every rank must schedule alike, so retries requeue at
        # once there.
        delay = retry.backoff_s(fails, key=cfg.trial_id) if single else 0.0
        led.attempt_end(cfg.trial_id, chashes[i], attempts[i], "retrying", error=error_text, summary=progress)
        queue_of(g).append(("retry", i, cfg, time.time() + delay))
        log0(
            f"Trial {cfg.trial_id} FAULTED ({error_text}); retrying from last valid "
            f"checkpoint in {delay:.2f}s (infra failure {fails} of {retry.max_retries + 1} budget)",
            trial=g,
        )
        return True

    def record_preempted_peers(error_text: str = "host preemption (sweep-wide)") -> None:
        """A preemption ends the whole driver: record every in-flight
        attempt, after landing its checkpoint write (best effort)."""
        for i2, run2, _ in list(active.values()):
            try:
                run2._join_ckpt()
            except Exception:  # noqa: BLE001 — recording must go on
                pass
            led.attempt_end(run2.cfg.trial_id, chashes[i2], attempts[i2], "preempted",
                            error=error_text, summary=attempt_progress(run2))

    def next_ready_at() -> Optional[float]:
        queues = [shared] if single else [per_group[g.group_id] for g in local_groups]
        deadlines = [item[3] for q in queues for item in q]
        return min(deadlines) if deadlines else None

    def start_next(g: TrialGroup) -> None:
        q = queue_of(g)
        for _ in range(len(q)):
            kind, i, cfg, ready_at = q.pop(0)
            if ready_at > time.time():
                q.append((kind, i, cfg, ready_at))  # backoff not over
                continue
            attempts[i] += 1
            led.attempt_start(cfg.trial_id, chashes[i], attempts[i])
            # A retry resumes through the scan-back (past whatever torn or
            # corrupt checkpoint the fault left); a first attempt keeps
            # the caller's resume mode.
            err: Optional[BaseException] = None
            run: Optional[_TrialRun] = None
            try:
                run = make_run(g, cfg, "scan" if kind == "retry" else resume)
            except Exception as e:  # noqa: BLE001 — setup failure isolation
                err = e
            if needs_agreement(g):
                # Every rank starts the trial, or none does.
                ok = group_all_ok(g, err is None, timeout_s=agree_timeout_s,
                                  what=f"trial {cfg.trial_id} setup agreement", error_cls=WedgedCollective)
            else:
                ok = err is None
            if ok:
                active[g.group_id] = (i, run, run.run())
                return
            error_text = f"{type(err).__name__}: {err}" if err is not None else "setup failed on a peer rank"
            # A broken setup is an infra fault like any other, except the
            # strict-resume guards (UnretryableError), which stop for a human.
            fatal = err is not None and classify_failure(err) == FATAL
            if not fatal and schedule_retry(g, i, cfg, error_text):
                continue
            results[i] = TrialResult(trial_id=cfg.trial_id, group_id=g.group_id, config=cfg,
                                     status="failed", error=error_text, attempt=attempts[i])
            led.attempt_end(cfg.trial_id, chashes[i], attempts[i], "failed", error=error_text,
                            summary=attempt_progress(run))
            if not resilient:
                if err is not None:
                    raise err
                raise RuntimeError(error_text)
            log0(f"Trial {cfg.trial_id} FAILED at setup ({error_text}); sweep continues", trial=g)

    def finish(g: TrialGroup, i: int, run: _TrialRun, e: Exception) -> None:
        """Record a trial whose run raised ``e``, by its failure class."""
        error_text = f"{type(e).__name__}: {e}"
        failure_class = classify_failure(e, trial_id=run.cfg.trial_id)
        # Land (or surface) an in-flight checkpoint write before the group
        # is freed.
        try:
            run._join_ckpt()
        except Exception as ce:  # noqa: BLE001
            error_text += f"; also: {type(ce).__name__}: {ce}"
        run.result.error = error_text
        run.result.attempt = attempts[i]
        # Work executed up to the failure (completion never stamped it).
        run.result.steps = run.state.step
        if failure_class == PREEMPTION:
            led.attempt_end(run.cfg.trial_id, chashes[i], attempts[i], "preempted",
                            error=error_text, summary=attempt_progress(run))
            record_preempted_peers()
            raise e
        if failure_class == DIVERGENCE:
            # A terminal result of the config: recorded, never retried or
            # raised.
            run.result.status = "diverged"
            results[i] = run.result
            led.attempt_end(run.cfg.trial_id, chashes[i], attempts[i], "diverged",
                            error=error_text, summary=_result_summary(run.result))
            log0(f"Trial {run.cfg.trial_id} DIVERGED ({error_text}); recorded as terminal result, group freed",
                 trial=g)
            return
        if failure_class != FATAL and schedule_retry(g, i, run.cfg, error_text, progress=attempt_progress(run)):
            return
        run.result.status = "failed"
        results[i] = run.result
        led.attempt_end(run.cfg.trial_id, chashes[i], attempts[i], "failed",
                        error=error_text, summary=attempt_progress(run))
        if not resilient:
            raise e
        log0(f"Trial {run.cfg.trial_id} FAILED ({error_text}); group freed, sweep continues", trial=g)

    for g in local_groups:
        start_next(g)
    # Cooperative round-robin: one unit of work per trial per cycle. A
    # retry waiting out its backoff never blocks live work; when only such
    # retries remain, the loop sleeps to the earliest deadline.
    while True:
        for g in local_groups:
            if g.group_id not in active:
                start_next(g)  # a backoff retry may have matured
        if not active:
            deadline = next_ready_at()
            if deadline is None:
                break
            time.sleep(max(0.0, deadline - time.time()))
            continue
        for g in local_groups:
            if g.group_id not in active:
                continue
            i, run, gen = active[g.group_id]
            try:
                next(gen)
            except StopIteration:
                del active[g.group_id]
                run.result.attempt = attempts[i]
                results[i] = run.result
                led.attempt_end(run.cfg.trial_id, chashes[i], attempts[i], "completed",
                                summary=_result_summary(run.result))
                start_next(g)
            except Exception as e:  # noqa: BLE001 — failure isolation
                del active[g.group_id]
                finish(g, i, run, e)
                start_next(g)
    return [results[i] for i in sorted(results)]
