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
:func:`init_vae_params`, or for a ``model_builder`` family from its
``init_params``, so a test can substitute weights carried across from the
JAX package.

``model_builder(cfg)`` swaps the model family (the conv β-VAE, the MoE
VAE, or any module with the VAE's method contract), as in the JAX package:
every step, the checkpoints (the family converts its own flax tree) and
the image grids take it unchanged.

``stack_trials=True`` runs same-shape configs K at a time on one group
(:class:`_StackedBucketRun`, the JAX package's trial stacking): one stacked
program advances K trials, through one CUDA graph per chunk on a card;
lanes retire at their own epoch targets and are refilled in place from the
bucket's queue, or masked when it is dry, with no new capture.

``fault_plan`` (a ``faults.FaultPlan`` or ``FaultInjector``) arms the
chaos seams, as in the JAX package: the step hook and NaN poisoning around
each train chunk (``train.steps.wrap_step_with_hooks``), the data
iterators' hooks, the checkpoint writer's corruption hook, and in a stacked
bucket the lane faults with the lane retry they drive. With telemetry on
(``telemetry.telemetry_run`` or ``MDT_TELEMETRY=1``) the driver emits the
JAX driver's bus events and keeps each trial's and bucket's step series in
the metrics registry; off, no seam constructs an event or adds a host sync.

Compile and dispatch, as in the JAX package (``compile/``): a trial or
bucket of the default family admits its train program through the
process's registry (:func:`_admit_slot`), which holds one **program slot**
per key: the state, generators and captured CUDA graphs of that program.
The first admission of a key captures it (``inline``); a later trial with
the same key on the same group (a seed replica, a retry, the next item,
a refilled bucket) takes the slot (``hit``) and replays its graphs after
copying its own state in by value; ``run_hpo(precompile=True)`` (or
``MDT_PRECOMPILE=1``) captures the sweep's programs on farm threads first,
and admission then waits cooperatively (``wait``) or takes them. A key the
registry marks ``FAILED``, a ``model_builder`` family and a multi-process
world keep per-trial graphs (``graph``; ``eager`` where the step does not
capture). ``first_dispatch`` reports the outcome.

What this slice does not port raises ``NotImplementedError`` naming its
ROADMAP item: profiling, weight sharding and model parallel, pipeline
stages and per-trial dataset references.
"""

from __future__ import annotations

import base64
import json
import logging
import math
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from multidisttorch_tpu_torch import telemetry as _telemetry
from multidisttorch_tpu_torch.compile import programs as _programs
from multidisttorch_tpu_torch.compile.registry import (
    COMPILING,
    PENDING,
    READY,
    SOURCE_INLINE,
    get_executable_registry,
)
from multidisttorch_tpu_torch.data.datasets import Dataset
from multidisttorch_tpu_torch.faults.inject import FaultInjector, HostPreemption, InfraFault
from multidisttorch_tpu_torch.faults.plan import DIVERGE, FaultPlan
from multidisttorch_tpu_torch.data.sampler import EvalDataIterator, StackedTrialDataIterator, TrialDataIterator
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
from multidisttorch_tpu_torch.telemetry.events import get_bus
from multidisttorch_tpu_torch.telemetry.metrics import get_registry
from multidisttorch_tpu_torch.train.checkpoint import (
    default_format,
    restore_latest_valid,
    restore_state,
    save_state,
    train_state_to_tree,
    valid_candidates_by_step,
)
from multidisttorch_tpu_torch.train.guards import DivergenceError, check_finite
from multidisttorch_tpu_torch.train.steps import (
    TrialHypers,
    create_stacked_train_state,
    create_train_state,
    make_eval_step,
    make_lane_ops,
    make_multi_step,
    make_sample_step,
    make_stacked_eval_step,
    make_stacked_multi_step,
    device_turn,
    wrap_step_with_hooks,
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
    "dataset": ("", "A.12 (service and its dataset store)"),
    "zero_update": (False, "A.13 (sharding)"),
    "pipeline_stages": (1, "A.14 (pipelines)"),
}

# run_hpo arguments this slice does not port: (inert value, ROADMAP item).
_UNPORTED_ARGS = {
    "profile_dir": (None, "A.10, second part (device books and profiling)"),
    "model_parallel": (1, "A.13 (sharding)"),
    "param_shardings_builder": (None, "A.13 (sharding)"),
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


def _gather_generator_states(group: TrialGroup, generators: dict) -> dict:
    """Every group rank's states of ``generators`` (name -> generator),
    base64, in rank order; a collective on a multi-rank group, so every
    rank calls it at the same point."""
    out = {}
    for name, gen in generators.items():
        state = gen.get_state()
        if group.size > 1:
            state = group_all_gather(group, state.to(group.device)).cpu()
        out[name] = [
            base64.b64encode(part.numpy().tobytes()).decode("ascii")
            for part in state.view(group.size, -1)
        ]
    return out


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


def _optimizer_state_bytes(model: torch.nn.Module) -> int:
    """Adam's state in the JAX package's layout (optax's int32 count and
    two moments the parameters' size): the memory books' per-device
    optimizer footprint of a replicated trial or one stacked lane."""
    return 4 + 2 * sum(p.numel() * p.element_size() for p in model.parameters())


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


def _registry_eligible(group: TrialGroup, model_builder) -> bool:
    """Whether a trial or bucket admits its program through the registry:
    the default family on a one-rank group in a one-process world (the
    JAX package's envelope); ``MDT_AOT_ADMISSION=0`` turns it off."""
    return (model_builder is None and group.size == 1 and process_world()[0] == 1
            and os.environ.get("MDT_AOT_ADMISSION", "1") != "0")


def _admit_slot(key: tuple, build, state, owner) -> Iterator[None]:
    """The one admission protocol (a generator; its value is ``(slot,
    admission)``), the JAX package's ``_aot_admit`` for one program: while
    the farm has the key queued or in capture, yield (the host loop steps
    the other groups) until it is ready; then **take** the slot (``hit``,
    or ``wait`` after waiting), or **claim** the key and capture it inline
    through the registry (``inline``). A slot is taken only when its state
    has the shapes of ``state``. No slot (the key ``FAILED``, a shape
    mismatch, the wait's deadline ``MDT_AOT_WAIT_S``, or the slot held by
    another owner) returns None and the outcome is left to the caller's
    per-trial path."""
    reg = get_executable_registry()
    t0 = time.perf_counter()
    deadline = t0 + float(os.environ.get("MDT_AOT_WAIT_S", "600"))
    waited = False
    while reg.status(key) in (PENDING, COMPILING) and time.perf_counter() < deadline:
        waited = True
        time.sleep(0.0005)
        yield
    slot, outcome = None, None
    signature = reg.avals(key)
    rejected = signature is not None and not _programs.avals_match(signature, state)
    if not rejected:
        slot = reg.take(key, owner)
        if slot is not None:
            outcome = "wait" if waited else "hit"
    if slot is None and not rejected and reg.claim(key):
        e = reg.compile_now(key, build, source=SOURCE_INLINE, owner=owner)
        if e.status == READY and e.owner is owner:
            slot, outcome = e.compiled, "inline"
    return slot, {"outcome": outcome, "wait_s": round(time.perf_counter() - t0, 4),
                  "program": _programs.program_label(key)}


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
        model_builder=None,
        injector: Optional[FaultInjector] = None,
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
        # Fault-injection seams (None outside a chaos drill): the drill's
        # faults take the same dispatch, data and checkpoint paths real
        # faults take.
        self._injector = injector
        self._epoch_base_step = 0
        # Telemetry, captured once (None when off): the step series of
        # this trial in the metrics registry.
        self._mreg = get_registry()
        self._mkey = f"trial-{cfg.trial_id}"
        self._first_dispatched = False

        if model_builder is None:
            model = VAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim)
            init_vae_params(model, cfg.seed)
        else:
            model = model_builder(cfg)
            model.init_params(cfg.seed)
        self.state = create_train_state(group, model, cfg.lr)
        self.result.optimizer_state_bytes = _optimizer_state_bytes(model)
        bus = get_bus()
        if bus is not None:
            bus.emit("optimizer_state", trial_id=cfg.trial_id, group_id=group.group_id,
                     per_device_bytes=self.result.optimizer_state_bytes,
                     total_bytes=self.result.optimizer_state_bytes, zero_update=False)
        # The train program arrives at admission (the first thing run()
        # does): a registry slot, or this trial's own graphs.
        self.multi_step = None
        self._program_key = (_programs.single_key(group, cfg, _programs.bucket_key_of(cfg))
                             if _registry_eligible(group, model_builder) else None)
        self._slot = None
        self._admission = {"outcome": None, "wait_s": 0.0, "program": None}
        self._replays0 = 0
        self.eval_step = make_eval_step(group, beta=cfg.beta, with_recon=save_images)
        self.sample_step = make_sample_step(group)
        self.train_iter = TrialDataIterator(
            train_data,
            group,
            cfg.batch_size,
            seed=cfg.seed,
            shard_across_trials=shard_across_trials,
            num_trials=num_trials,
            fault_hook=None if injector is None else self._data_fault_hook,
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
                    restore_state(self.state, self._ckpt_path, group_id=group.group_id)
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
            return restore_latest_valid(self.state, self._ckpt_path, accept_meta=accept,
                                        group_id=self.group.group_id)
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
        restore_state(self.state, cand, group_id=self.group.group_id)
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


    def _admit_programs(self) -> Iterator[None]:
        """Admission of the train program (:func:`_admit_slot`): a slot's
        state takes this trial's by value (its fresh or restored
        parameters, moments, step and train generator), and the trial then
        trains through the slot's graphs; without a slot, the trial builds
        its own ``make_multi_step`` (captured at its first chunk on a card;
        a failed capture raises)."""
        cfg = self.cfg
        slot = None
        if self._program_key is not None:
            slot, self._admission = yield from _admit_slot(
                self._program_key,
                lambda: _programs.build_single_slot(self.group, cfg, self._program_key, ahead=False),
                self.state, self)
        if slot is not None:
            self._slot = slot
            self.state = slot.bind(self.state, self._train_gen)
            self._train_gen = self._generators["train"] = slot.generator
            self.multi_step = self._wrap_multi(slot.step)
        else:
            self.multi_step = self._wrap_multi(
                make_multi_step(self.group, beta=cfg.beta, grad_accum=cfg.grad_accum, remat=cfg.remat))
            self._admission["outcome"] = "graph" if self.multi_step.graphed else "eager"
        self._replays0 = self.multi_step.replays

    def release_programs(self) -> None:
        """Give the trial's slot back to the registry (its end, or any
        failure); idempotent."""
        if self._slot is not None:
            self._slot = None
            get_executable_registry().give_back(self._program_key, self)

    def _wrap_multi(self, fn):
        """The chaos hooks around the train chunk: ``step_hook`` with the
        chunk's first step and length before it is dispatched, and
        ``poison_batch`` of the chunk. ``state.step`` is the chunk's first
        step until the step returns."""
        if self._injector is None:
            return fn
        injector, tid = self._injector, self.cfg.trial_id
        return wrap_step_with_hooks(
            fn,
            before=lambda b: injector.step_hook(tid, self.state.step, b.shape[0]),
            transform_batch=lambda b: injector.poison_batch(tid, self.state.step, b, b.shape[0]),
        )

    def _data_fault_hook(self, epoch: int, batch_index: int) -> None:
        """Data-iterator injection seam: maps the iterator's (epoch,
        batch_index) to the trial's global optimizer step."""
        self._injector.data_hook(self.cfg.trial_id, self._epoch_base_step + batch_index)

    def _note_first_dispatch(self) -> None:
        """One event per attempt, right after its first chunk returns: its
        timestamp minus the attempt_start's is the trial's admission
        latency (setup, warm-up and capture)."""
        self._first_dispatched = True
        bus = get_bus()
        if bus is not None:
            bus.emit("first_dispatch", trial_id=self.cfg.trial_id, group_id=self.group.group_id, **self._admission)

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
            if self._injector is not None:
                # Chaos seam: CKPT_CORRUPT garbles the file after the write
                # lands, the torn artifact a retry's scan must skip.
                self._injector.checkpoint_hook(self.cfg.trial_id, int(meta.get("completed_epochs", 0)),
                                               self._ckpt_path)
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
        try:
            yield from self._run()
        finally:
            self.release_programs()

    def _run(self) -> Iterator[None]:
        cfg = self.cfg
        t0 = time.time()
        if self._start_epoch > cfg.epochs:
            # A fully trained checkpoint: nothing to replay.
            self.result.status = "resumed_complete"
            self.result.steps = self.state.step
            self.result.checkpoint = self._ckpt_path
            self._log(f"Trial {cfg.trial_id} already complete; resumed.")
            return
        yield from self._admit_programs()
        n_per_epoch = self.train_iter.samples_per_epoch
        for epoch in range(self._start_epoch, cfg.epochs + 1):
            self._epoch_base_step = self.state.step
            # A fresh timing interval per epoch: the gap since the last
            # mark holds boundary work, not a dispatch.
            if self._mreg is not None:
                self._mreg.step_series(self._mkey).open_interval()
            epoch_sum = None  # on the device until the epoch's one fetch
            for i0, chunk in self.train_iter.epoch_chunks(epoch, cfg.fused_steps):
                self.state, metrics = self.multi_step(self.state, chunk, generator=self._train_gen)
                if not self._first_dispatched:
                    self._note_first_dispatch()
                losses = metrics["loss_sum"]
                s = losses.sum()
                epoch_sum = s if epoch_sum is None else epoch_sum + s
                if self._mreg is not None:
                    self._mreg.step_mark(self._mkey, s, steps=chunk.shape[0])
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
            bus = get_bus()
            if bus is not None:
                bus.emit("epoch", trial_id=cfg.trial_id, group_id=self.group.group_id, step=self.state.step,
                         **record)
            if self._save_checkpoint:
                # The epoch boundary is the resume point. The generator
                # states are gathered on every rank; the writer takes host
                # copies of the state here, before the next chunk changes
                # it, and a background thread serialises and writes them.
                generators = _gather_generator_states(self.group, self._generators)
                if self._is_writer:
                    with self._guard():
                        snap_t0 = time.perf_counter()
                        tree = train_state_to_tree(self.state)
                        if bus is not None:
                            bus.emit("ckpt_snapshot", trial_id=cfg.trial_id, group_id=self.group.group_id,
                                     step=self.state.step, epoch=epoch,
                                     wall_s=round(time.perf_counter() - snap_t0, 6))
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
            # Wall-clock covers real completion: this thread's stream, which
            # waited on every replay. Not the whole device: a farm worker may
            # be capturing, and a device-wide sync fails a capture.
            torch.cuda.current_stream(self.group.device).synchronize()
        with self._guard():
            self._join_ckpt()
        self.result.wall_s = time.time() - t0
        self.result.steps = self.state.step
        self.result.host_syncs = self._host_syncs
        self.result.graph_replays = self.multi_step.replays - self._replays0
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


# --- trial stacking: same-shape configs K at a time on one group ---


def stack_bucket_key(cfg: TrialConfig) -> tuple:
    """The shape signature under which trials may share one stacked
    program: everything that changes an array shape or the step's
    structure. The scalar hypers (lr, beta, seed) and the epoch target stay
    out: they are the lane axis."""
    return (cfg.batch_size, cfg.hidden_dim, cfg.latent_dim, cfg.fused_steps, cfg.grad_accum, cfg.remat)


def config_is_stackable(cfg: TrialConfig) -> bool:
    """Whether a config can ride a stacked bucket: the stacked eval is the
    posterior mean only, so ``eval_sampled`` runs its own path (as do a
    sharded update and pipeline stages, which the port does not run yet)."""
    return not cfg.eval_sampled and not cfg.zero_update and cfg.pipeline_stages == 1


def data_shape_sig(ds: Dataset, batch_size: int) -> tuple:
    """The dataset's half of a co-pack decision: feature dim (the batch
    shape) and batches per epoch (the lockstep round), not its identity."""
    return (int(ds.images.shape[1]), len(ds) // max(1, int(batch_size)))


class _StackedBucketRun:
    """One bucket of same-shape configs, K at a time on one group, as a
    cooperative generator (the stacked sibling of :class:`_TrialRun`).

    All lanes advance in lockstep rounds of ``num_batches`` steps (one
    round is one epoch of every lane: they share the dataset and the batch
    size); each unit of work is one chunk of ``fused_steps`` steps of every
    lane (one CUDA-graph replay on a card), an epoch's shorter tail one step
    at a time. After a round, one fetch brings every lane's train sum and
    one its test sum (two host syncs per round for all lanes). A lane that
    reaches its config's epoch target retires (its result, ``metrics.json``
    with ``"stacked": true``, its checkpoint in an unstacked trial's tree
    and metadata, its ledger row) and is refilled in place from the queue,
    or masked when the queue is dry; a lane whose epoch loss is not finite
    is a recorded ``diverged`` result, and the other lanes go on. Refill
    and masking copy into the tensors the graphs hold (parameters, moments,
    step counts, hypers, generator states): nothing is captured anew.

    Each lane's noise comes from its own generator, seeded as the unstacked
    trial's (:func:`_stream_seed`), so on the CPU a stacked trial trains to
    the unstacked trial's bits. Stacked lanes checkpoint only at retirement.

    Lane supervision, as in the JAX package: lane-scoped infra faults due in
    a round fire before it (:meth:`_round_start_faults`); the faulted lane
    retires through the same mask-and-refill path finished lanes take, and
    its trial is requeued under the retry budget, from scratch (stacked
    lanes checkpoint only at retirement). A DIVERGE fault poisons one lane's
    slice of a step's batch (:meth:`_stacked_fault_hook`), so that lane
    alone diverges. A host preemption is not lane-scoped: it fails the
    bucket. Lane churn, epochs and the round's input wait are bus events;
    the bucket's step series is in the metrics registry.

    The stacked program is admitted through the registry as a trial's is
    (:func:`_admit_slot`, a stacked key: the bucket's shape and lane count
    on its group), so every bucket of that shape on that group replays one
    slot's graphs.

    Not ported here: the drain (``request_drain``, ``drain_snapshot``,
    ROADMAP A.12) and the device books (A.10, second part).
    """

    def __init__(
        self,
        group: TrialGroup,
        items,
        train_data: Dataset,
        test_data: Optional[Dataset],
        out_dir: str,
        *,
        max_lanes: int = 8,
        save_checkpoint: bool = True,
        verbose: bool = True,
        ledger: Optional[SweepLedger] = None,
        attempts: Optional[dict] = None,
        chashes: Optional[dict] = None,
        injector: Optional[FaultInjector] = None,
        retry: Optional[RetryPolicy] = None,
        infra_fails: Optional[dict] = None,
    ):
        template = items[0][1]
        for _, cfg in items:
            if stack_bucket_key(cfg) != stack_bucket_key(template):
                raise ValueError(
                    f"stacked bucket mixes shape keys: {stack_bucket_key(cfg)} vs {stack_bucket_key(template)}"
                )
        self.group = group
        self.out_dir = out_dir
        self.queue = list(items)
        self.results: dict[int, TrialResult] = {}
        self._train_data = train_data
        self._save_checkpoint = save_checkpoint
        self._ckpt_format = default_format()
        self._verbose = verbose
        self._host_syncs = 0
        self._is_writer = group.is_writer_process
        self._ledger = ledger
        self._attempts = attempts if attempts is not None else {}
        self._chashes = chashes if chashes is not None else {}
        self._injector = injector
        self._retry = retry
        self._infra_fails = infra_fails if infra_fails is not None else {}
        self._round_step0: dict[int, int] = {}
        self._dims = (template.hidden_dim, template.latent_dim)
        self.fused = template.fused_steps
        # Telemetry: stacked step times belong to the bucket (lanes= tags
        # the live lane count), never to one lane.
        self._mreg = get_registry()
        self._mkey = f"bucket-g{group.group_id}"
        self._first_dispatched = False

        k = min(len(self.queue), max_lanes)
        first = [self.queue.pop(0) for _ in range(k)]
        dev = group.device
        # Input-stall seam: wired only with telemetry on (off reads no
        # clocks and constructs nothing).
        self._wait_counts = None
        wait_hook = None
        if self._mreg is not None or get_bus() is not None:
            self._wait_counts = {"wait_s": 0.0, "bytes": 0}
            series = self._mreg.step_series(self._mkey) if self._mreg is not None else None

            def wait_hook(dt, nbytes, _series=series):
                if _series is not None:
                    _series.note_wait(dt, nbytes)
                self._wait_counts["wait_s"] += dt
                self._wait_counts["bytes"] += nbytes
        self._input_t0 = time.time()
        self.data = StackedTrialDataIterator(
            train_data, group, template.batch_size, [c.seed for _, c in first], wait_hook=wait_hook,
            fault_hook=None if injector is None else self._stacked_fault_hook)
        self.test_iter = (
            EvalDataIterator(test_data, group, template.batch_size)
            if test_data is not None and len(test_data) > 0
            else None
        )
        # The stacked program arrives at admission (run()'s first work).
        self.multi = None
        self._template = template
        self._program_key = (_programs.stacked_key(group, template, _programs.bucket_key_of(template), k)
                             if _registry_eligible(group, None) else None)
        self._slot = None
        self._admission = {"outcome": None, "wait_s": 0.0, "program": None}
        self.seval = make_stacked_eval_step(group) if self.test_iter is not None else None
        self.read_lane, self.write_lane = make_lane_ops(group)
        models = [self._init_model(c.seed) for _, c in first]
        self._lane_opt_bytes = _optimizer_state_bytes(models[0])
        self.state = create_stacked_train_state(group, models)
        # (K,) on the device, changed in place: the graphs read them.
        self.hypers = TrialHypers.stack([c.lr for _, c in first], [c.beta for _, c in first], device=dev)
        self.generators = [torch.Generator(device=dev).manual_seed(self._noise_seed(c)) for _, c in first]
        # Per-lane host bookkeeping; None = lane masked (queue dry).
        self.lanes: list[Optional[dict]] = [self._fresh_lane(i, c) for i, c in first]
        for lane in self.lanes:
            self._note_attempt_start(lane)

    def _init_model(self, seed: int) -> VAE:
        return init_vae_params(VAE(hidden_dim=self._dims[0], latent_dim=self._dims[1]), seed)

    def _noise_seed(self, cfg: TrialConfig) -> int:
        return _stream_seed(cfg.seed, self.group.local_rank, 0)

    def _fresh_lane(self, idx: int, cfg: TrialConfig) -> dict:
        return {"idx": idx, "cfg": cfg, "epochs_done": 0, "history": [], "steps": 0, "t0": time.time(),
                "syncs0": self._host_syncs, "replays0": 0 if self.multi is None else self.multi.replays}

    def _log(self, *args, level: int = logging.INFO):
        if self._verbose:
            log0(*args, trial=self.group, level=level)

    def _emit_lane(self, kind: str, lane_k: int, trial_id=None, **data) -> None:
        """Lane-churn telemetry (retire, refill, fault, diverge, mask)."""
        bus = get_bus()
        if bus is not None:
            bus.emit(kind, trial_id=trial_id, lane=lane_k, group_id=self.group.group_id, **data)

    def _note_first_dispatch(self) -> None:
        """The bucket's sibling of ``_TrialRun._note_first_dispatch``,
        group-scoped (no single trial owns the bucket's admission)."""
        self._first_dispatched = True
        bus = get_bus()
        if bus is not None:
            bus.emit("first_dispatch", group_id=self.group.group_id, lanes=len(self.lanes), **self._admission)

    def _admit_programs(self) -> Iterator[None]:
        """Admission of the stacked program (``_TrialRun._admit_programs``'
        sibling): a slot takes the bucket's lanes, hypers and generator
        states by value, and the bucket trains, refills and masks lanes in
        the slot's tensors from then on; without one, the bucket's own
        ``make_stacked_multi_step``."""
        t = self._template
        slot = None
        if self._program_key is not None:
            slot, self._admission = yield from _admit_slot(
                self._program_key,
                lambda: _programs.build_stacked_slot(self.group, t, self.state.lanes, self._program_key, ahead=False),
                self.state, self)
        if slot is not None:
            self._slot = slot
            slot.bind(self.state, self.hypers, self.generators)
            self.state, self.hypers, self.generators = slot.state, slot.hypers, slot.generators
            self.multi = slot.step
        else:
            self.multi = make_stacked_multi_step(self.group, grad_accum=t.grad_accum, remat=t.remat)
            self._admission["outcome"] = "graph" if self.multi.graphed else "eager"
        for lane in self.lanes:
            if lane is not None:
                lane["replays0"] = self.multi.replays

    def release_programs(self) -> None:
        """Give the bucket's slot back (its end or failure); idempotent."""
        if self._slot is not None:
            self._slot = None
            get_executable_registry().give_back(self._program_key, self)

    def _note_attempt_start(self, lane: dict) -> None:
        idx = lane["idx"]
        self._attempts[idx] = self._attempts.get(idx, 0) + 1
        if self._ledger is not None:
            self._ledger.attempt_start(lane["cfg"].trial_id, self._chashes.get(idx, ""), self._attempts[idx])

    def _note_attempt_end(self, lane: dict, status: str, *, error: str = "", summary=None) -> None:
        if self._ledger is not None:
            idx = lane["idx"]
            self._ledger.attempt_end(lane["cfg"].trial_id, self._chashes.get(idx, ""), self._attempts.get(idx, 1),
                                     status, error=error, summary=summary)

    def live_items(self) -> list:
        """The configs riding a lane now (their attempts have started)."""
        return [(lane["idx"], lane["cfg"]) for lane in self.lanes
                if lane is not None and lane["idx"] not in self.results]

    def lane_progress(self, idx: int) -> Optional[dict]:
        """Executed work of config ``idx`` if it rides a lane (stacked lanes
        start from scratch)."""
        for lane in self.lanes:
            if lane is not None and lane["idx"] == idx:
                return {"resumed_from_step": 0, "steps_at_failure": lane["steps"]}
        return None

    def record_preempted(self, error_text: str) -> None:
        """The ledger's ``preempted`` row for every live lane, when a
        preemption elsewhere ends the sweep."""
        for lane in self.lanes:
            if lane is not None:
                self._note_attempt_end(lane, "preempted", error=error_text, summary=self.lane_progress(lane["idx"]))

    def _result(self, k: int, **kw) -> TrialResult:
        lane = self.lanes[k]
        cfg = lane["cfg"]
        return TrialResult(
            trial_id=cfg.trial_id, group_id=self.group.group_id, config=cfg, history=list(lane["history"]),
            out_dir=os.path.join(self.out_dir, f"trial-{cfg.trial_id}"), steps=lane["steps"],
            wall_s=time.time() - lane["t0"], host_syncs=self._host_syncs - lane["syncs0"],
            graph_replays=self.multi.replays - lane["replays0"], dataset=self._train_data.name,
            dataset_synthetic=self._train_data.synthetic, stacked=True,
            attempt=self._attempts.get(lane["idx"], 1), **kw,
        )

    def _diverge_lane(self, k: int, avg: float) -> None:
        """A non-finite epoch loss on lane ``k``: a terminal ``diverged``
        result (never retried: the config reproduces it); the lane refills."""
        lane = self.lanes[k]
        err = DivergenceError("lane epoch average train loss", avg, step=lane["steps"], trial_id=lane["cfg"].trial_id)
        result = self._result(k, status="diverged", error=str(err))
        self.results[lane["idx"]] = result
        self._note_attempt_end(lane, "diverged", error=str(err), summary=_result_summary(result))
        self._emit_lane("lane_diverge", k, trial_id=lane["cfg"].trial_id, step=lane["steps"], avg_train_loss=avg)
        self._log(f"Trial {lane['cfg'].trial_id} DIVERGED (stacked lane {k}, non-finite loss at step "
                  f"{lane['steps']}); lane freed")
        self._refill_or_mask(k)

    def _stacked_fault_hook(self, batch_index: int, stacked: torch.Tensor) -> torch.Tensor:
        """Poison a DIVERGE-covered lane's slice of a step's ``(K, rows,
        ...)`` device batch: the NaN reaches that lane only (lanes share no
        state), so exactly one trial diverges."""
        out = stacked
        for k, lane in enumerate(self.lanes):
            if lane is None:
                continue
            tid = lane["cfg"].trial_id
            step = self._round_step0.get(k, lane["steps"]) + batch_index
            if self._injector.diverge_covers(tid, step):
                if out is stacked:
                    out = stacked.clone()
                out[k] = self._injector.poison_batch(tid, step, out[k])
        return out

    def _round_start_faults(self) -> None:
        """Fire the lane-scoped infra faults due inside the coming round.

        A faulted lane is retired and refilled through the mask-and-refill
        path finished lanes take; the other lanes keep training in the same
        graphs. A host preemption is not lane-scoped (the host is going
        away): it propagates and fails the bucket."""
        if self._injector is None:
            return
        round_len = self.data.num_batches
        k = 0
        while k < len(self.lanes):
            lane = self.lanes[k]
            if lane is None:
                k += 1
                continue
            tid = lane["cfg"].trial_id
            try:
                self._injector.step_hook(tid, lane["steps"], round_len)
                self._injector.data_hook(tid, lane["steps"], round_len)
            except HostPreemption:
                raise
            except InfraFault as e:
                self._fault_lane(k, e)
                # Re-scan lane k without advancing: the refilled trial's
                # faults due in its first round fire now. Bounded: max_fires
                # caps firings and the retry budget caps requeues.
                continue
            k += 1

    def _fault_lane(self, k: int, exc: BaseException) -> None:
        """An infra fault scoped to lane ``k``: retire it (no result: its
        weights are suspect), requeue its trial under the retry budget (or
        record it failed), and refill the lane from the queue."""
        lane = self.lanes[k]
        idx, cfg = lane["idx"], lane["cfg"]
        error_text = f"{type(exc).__name__}: {exc}"
        fails = self._infra_fails[idx] = self._infra_fails.get(idx, 0) + 1
        progress = {"resumed_from_step": 0, "steps_at_failure": lane["steps"]}
        retrying = self._retry is not None and self._retry.should_retry(fails, INFRA)
        self._emit_lane("lane_fault", k, trial_id=cfg.trial_id, step=lane["steps"], error=error_text,
                        infra_failures=fails, retrying=retrying)
        if retrying:
            self._note_attempt_end(lane, "retrying", error=error_text, summary=progress)
            # From scratch, at the queue's tail: its order stands in for
            # the backoff.
            self.queue.append((idx, cfg))
            self._log(f"Trial {cfg.trial_id} lane {k} FAULTED ({error_text}); lane retired, trial requeued "
                      f"(infra failure {fails}), {sum(x is not None for x in self.lanes) - 1} lanes continue")
        else:
            self.results[idx] = TrialResult(
                trial_id=cfg.trial_id, group_id=self.group.group_id, config=cfg,
                out_dir=os.path.join(self.out_dir, f"trial-{cfg.trial_id}"), status="failed", error=error_text,
                dataset=self._train_data.name, dataset_synthetic=self._train_data.synthetic, stacked=True,
                attempt=self._attempts.get(idx, 1),
            )
            self._note_attempt_end(lane, "failed", error=error_text, summary=progress)
            self._log(f"Trial {cfg.trial_id} lane {k} FAILED ({error_text}); retry budget exhausted, lane freed")
        self._refill_or_mask(k)

    def _retire(self, k: int) -> None:
        """Lane ``k`` reached its epoch target: its result, metrics and
        checkpoint, then refill or mask."""
        lane = self.lanes[k]
        cfg: TrialConfig = lane["cfg"]
        last = lane["history"][-1]
        result = self._result(k, final_train_loss=last["avg_train_loss"],
                              final_test_loss=last.get("test_loss", float("nan")),
                              optimizer_state_bytes=self._lane_opt_bytes)
        bus = get_bus()
        if bus is not None:
            bus.emit("optimizer_state", trial_id=cfg.trial_id, group_id=self.group.group_id, lane=k,
                     per_device_bytes=self._lane_opt_bytes, total_bytes=self._lane_opt_bytes, zero_update=False)
        if self._save_checkpoint:
            # The unstacked trial's tree and metadata: an unstacked resume
            # finds the trial complete. Gathered on every rank.
            generators = _gather_generator_states(self.group, {"train": self.generators[k]})
        if self._is_writer:
            if self._save_checkpoint:
                ckpt = os.path.join(result.out_dir, "state.msgpack")
                lane_state = self.read_lane(self.state, k)
                save_state(lane_state, ckpt, format=self._ckpt_format, metadata={
                    **asdict(cfg), "completed_epochs": lane["epochs_done"], "step": lane_state.step,
                    "history": list(lane["history"]), GENERATORS_KEY: generators,
                })
                result.checkpoint = ckpt
            os.makedirs(result.out_dir, exist_ok=True)
            with open(os.path.join(result.out_dir, "metrics.json"), "w") as f:
                json.dump({
                    "trial_id": result.trial_id, "group_id": result.group_id, "config": asdict(cfg),
                    "dataset": result.dataset, "dataset_synthetic": result.dataset_synthetic,
                    "history": result.history, "wall_s": result.wall_s, "steps": result.steps, "stacked": True,
                }, f, indent=2)
        self.results[lane["idx"]] = result
        self._note_attempt_end(lane, "completed", summary=_result_summary(result))
        self._emit_lane("lane_retire", k, trial_id=cfg.trial_id, step=lane["steps"], epochs=lane["epochs_done"],
                        wall_s=round(result.wall_s, 6))
        self._log(f"Trial {cfg.trial_id} done (stacked lane {k}). time: {result.wall_s:f}")
        self._refill_or_mask(k)

    def _refill_or_mask(self, k: int) -> None:
        """Pop the next queued config into lane ``k``, in place (weights,
        moments, step count, hypers, data stream, generator), or mask the
        lane (``active`` 0) when the queue is dry."""
        if self.queue:
            idx, nxt = self.queue.pop(0)
            self.write_lane(self.state, self._init_model(nxt.seed), k)
            self.hypers.set_lane(k, nxt.lr, nxt.beta, 1.0)
            self.generators[k].manual_seed(self._noise_seed(nxt))
            self.data.set_lane(k, nxt.seed)
            self.lanes[k] = self._fresh_lane(idx, nxt)
            self._note_attempt_start(self.lanes[k])
            self._emit_lane("lane_refill", k, trial_id=nxt.trial_id)
            self._log(f"Trial {nxt.trial_id} refilled into stacked lane {k} (no new capture)")
        else:
            self.lanes[k] = None
            self.hypers.set_lane(k, 1e-3, 1.0, 0.0)
            self._emit_lane("lane_masked", k)

    def _dispatch(self, chunk, k_live: int) -> torch.Tensor:
        """One chunk of every lane's steps; the ``(K,)`` loss sums."""
        self.state, metrics = self.multi(self.state, self.hypers, chunk, generators=self.generators)
        if not self._first_dispatched:
            self._note_first_dispatch()
        for lane in self.lanes:
            if lane is not None:
                lane["steps"] += chunk.shape[0]
        sums = metrics["loss_sum"].sum(0)
        if self._mreg is not None:
            self._mreg.step_mark(self._mkey, sums, steps=chunk.shape[0], lanes=k_live)
        return sums

    def run(self) -> Iterator[None]:
        try:
            yield from self._run()
        finally:
            self.release_programs()

    def _run(self) -> Iterator[None]:
        yield from self._admit_programs()
        n_per_epoch = self.data.samples_per_epoch
        while any(lane is not None for lane in self.lanes):
            # Lane-scoped infra faults due this round fire before it: the
            # faulted lane retires and refills, the others never notice.
            self._round_start_faults()
            if not any(lane is not None for lane in self.lanes):
                break
            # Each lane's step count at the round's start: the fault hook
            # maps (lane, batch index) to the lane's global step with it.
            self._round_step0 = {k: lane["steps"] for k, lane in enumerate(self.lanes) if lane is not None}
            k_live = len(self._round_step0)
            if self._mreg is not None:
                self._mreg.step_series(self._mkey).open_interval()
            round_sum = None  # (K,) on the device until the round's fetch
            for _, chunk in self.data.round_chunks(self.fused):
                # A tail shorter than the chunk runs one step at a time.
                parts = [chunk] if chunk.shape[0] == self.fused else [chunk[j : j + 1] for j in range(chunk.shape[0])]
                for part in parts:
                    sums = self._dispatch(part, k_live)
                    round_sum = sums if round_sum is None else round_sum + sums
                yield
            self._host_syncs += 1
            train_sums = round_sum.tolist()
            if self._wait_counts is not None:
                bus = get_bus()
                if bus is not None:
                    bus.emit("input_wait", group_id=self.group.group_id, key=self._mkey,
                             wait_s=round(self._wait_counts["wait_s"], 6), bytes=self._wait_counts["bytes"],
                             wall_s=round(time.time() - self._input_t0, 6))
            test_sums = None
            if self.test_iter is not None:
                test_dev = None
                for tbatch, tweights in self.test_iter.batches():
                    out = self.seval(self.state, self.hypers, tbatch, tweights)["loss_sum"]
                    test_dev = out if test_dev is None else test_dev + out
                    yield
                self._host_syncs += 1
                test_sums = test_dev.tolist()
            retiring, diverged = [], []
            for k, lane in enumerate(self.lanes):
                if lane is None:
                    continue
                lane["epochs_done"] += 1
                avg = train_sums[k] / n_per_epoch
                if not math.isfinite(avg):
                    diverged.append((k, avg))
                    continue
                record = {"epoch": lane["epochs_done"], "avg_train_loss": avg}
                self._log("Trial {} ====> Epoch: {} Average loss: {:.4f}".format(
                    lane["cfg"].trial_id, lane["epochs_done"], avg))
                if test_sums is not None:
                    record["test_loss"] = test_sums[k] / self.test_iter.num_rows
                    self._log("Trial {} ====> Test set loss: {:.4f}".format(
                        lane["cfg"].trial_id, record["test_loss"]))
                lane["history"].append(record)
                bus = get_bus()
                if bus is not None:
                    bus.emit("epoch", trial_id=lane["cfg"].trial_id, lane=k, group_id=self.group.group_id,
                             step=lane["steps"], **record)
                if lane["epochs_done"] >= lane["cfg"].epochs:
                    retiring.append(k)
            for k, avg in diverged:
                self._diverge_lane(k, avg)
                yield
            for k in retiring:
                self._retire(k)
                yield
        if self.group.device.type == "cuda":
            # This thread's stream only (_TrialRun.run's reason).
            torch.cuda.current_stream(self.group.device).synchronize()


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
    - ``stack_trials=True``, when configs outnumber groups, runs configs
      that share a shape bucket (:func:`stack_bucket_key`: architecture,
      batch size, ``fused_steps``; any lr, beta, seed and epochs) up to
      ``stack_max_lanes`` at a time on one group as one stacked program
      (:class:`_StackedBucketRun`), refilling a finished trial's lane in
      place; unstackable configs and lone members run one per group. A
      bucket too large to leave every group work is split. It raises on
      contradictory settings (``resume``, ``shard_across_trials``, a
      ``model_builder``, ``param_shardings_builder`` or ``model_parallel``),
      and stacked buckets write no image files.
    - ``model_builder(cfg)`` builds each trial's model (any family with the
      VAE's method contract and ``init_params``), initialised from
      ``cfg.seed`` by its family's ``init_params``; such a family keeps
      per-trial graphs (no registry slot).
    - ``precompile=True`` (default: ``MDT_PRECOMPILE=1``) captures every
      program of the sweep on the farm's worker threads at entry
      (``compile/farm.py``): admission takes a captured slot, or waits
      cooperatively for one still in capture. Single process, default
      family, one-rank groups; elsewhere it is ignored, as in the JAX
      package. With it off, the registry still serves every later trial of
      a key from the slot its first trial captured.
    - ``fault_plan`` (a ``faults.FaultPlan``, or a ``FaultInjector`` whose
      fired faults stay fired across a restarted sweep) arms the chaos
      seams (module docstring). DIVERGE injection is single-process only,
      as in the JAX package.

    Telemetry (``telemetry.telemetry_run``, or ``MDT_TELEMETRY=1`` read
    here) records the sweep's bus events and step series.

    Returns results for the trials run here (or settled in the ledger), in
    config order.
    """
    passed = locals()
    if stack_trials:
        # Contradictory settings fail loudly rather than run another sweep.
        if resume:
            raise ValueError(
                "stack_trials is incompatible with resume= (lane restore into a stacked bucket is "
                "not implemented; run the resume sweep unstacked)"
            )
        if shard_across_trials:
            raise ValueError("stack_trials is incompatible with shard_across_trials (stacked lanes each see the full dataset)")
        if model_builder is not None or param_shardings_builder is not None or model_parallel != 1:
            raise ValueError(
                "stack_trials supports the default VAE family with replicated weights only (custom "
                "model_builder / param_shardings_builder / model_parallel cannot share one stacked program)"
            )
        if stack_max_lanes < 1:
            raise ValueError(f"stack_max_lanes must be >= 1, got {stack_max_lanes}")
    for name, (inert, item) in _UNPORTED_ARGS.items():
        if passed[name] != inert:
            raise NotImplementedError(
                f"run_hpo({name}={passed[name]!r}) is not ported yet: ROADMAP {item}"
            )
    _telemetry.configure_from_env()
    injector = None
    if fault_plan is not None:
        if isinstance(fault_plan, FaultInjector):
            injector = fault_plan
        elif isinstance(fault_plan, FaultPlan):
            injector = FaultInjector(fault_plan)
        else:
            raise TypeError(f"fault_plan must be a FaultPlan or FaultInjector, got {type(fault_plan).__name__}")
        if process_world()[0] > 1 and any(s.kind == DIVERGE for s in injector.plan.specs):
            raise ValueError(
                "fault_plan: DIVERGE injection is single-process only, as in the JAX package: drill "
                "divergence in a single-process run; the other fault kinds work across processes"
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
            model_builder=model_builder,
            injector=injector,
        )

    def build_items() -> list:
        """Work items ``(kind, members)``: ``("single", [(i, cfg)])``, or
        ``("bucket", [(i, cfg), ...])`` of stacked configs, in config order
        of their first member. Stacking applies only when configs outnumber
        groups; otherwise every trial gets a group of its own."""
        indexed = [(i, cfg) for i, cfg in enumerate(configs) if i not in skipped]
        if not (stack_trials and len(configs) > len(groups)):
            return [("single", [item]) for item in indexed]
        buckets: dict[tuple, list] = {}
        singles = []
        for item in indexed:
            if config_is_stackable(item[1]):
                key = (stack_bucket_key(item[1]), data_shape_sig(train_data, item[1].batch_size))
                buckets.setdefault(key, []).append(item)
            else:
                singles.append(item)
        items = []
        for members in buckets.values():
            if len(members) >= 2:
                items.append(("bucket", members))
            else:
                singles.extend(members)
        items.extend(("single", [m]) for m in singles)
        # Never idle a group behind one large bucket: split the largest
        # until every group has an item (or none is left to split).
        bus = get_bus()
        while len(items) < len(groups):
            big = max((it for it in items if it[0] == "bucket" and len(it[1]) >= 4),
                      key=lambda it: len(it[1]), default=None)
            if big is None:
                break
            items.remove(big)
            half = len(big[1]) // 2
            items += [("bucket", big[1][:half]), ("bucket", big[1][half:])]
            if bus is not None:
                bus.emit("stack_split", members=[cfg.trial_id for _, cfg in big[1]], split_at=half)
        items.sort(key=lambda it: it[1][0][0])
        if bus is not None:
            # Which trials share a stacked program explains every later lane
            # event and throughput number.
            for kind_, members in items:
                if kind_ == "bucket":
                    bus.emit("stack_bucket", members=[cfg.trial_id for _, cfg in members],
                             bucket_key=str(stack_bucket_key(members[0][1])))
            bus.emit("stack_plan", buckets=sum(1 for it in items if it[0] == "bucket"),
                     singles=sum(1 for it in items if it[0] == "single"))
        return items

    # Queue items are (kind, members, ready_at): kind "single", "retry" (one
    # member each) or "bucket"; ready_at in the future marks a retry still in
    # its backoff (skipped, not blocking: other queued work runs first).
    items = build_items()
    shared = [(kind, members, 0.0) for kind, members in items]
    # The precapture farm (compile/farm.py): the plan above names every
    # program the sweep will capture, so capture them now on worker threads,
    # beside the first trials' training, instead of at each admission. The
    # envelope is the registry's; the group guess (item j on group j % n)
    # only decides which group's slot a capture fills.
    if precompile is None:
        precompile = os.environ.get("MDT_PRECOMPILE") == "1"
    farm = None
    if (precompile and single and model_builder is None
            and all(_registry_eligible(g, None) for g in groups)):
        from multidisttorch_tpu_torch.compile.farm import PrecompilePool

        farm = PrecompilePool()
        farm.plan_sweep([(kind, members) for kind, members, _ in shared], groups, max_lanes=stack_max_lanes)
    per_group: dict[int, list] = {g.group_id: [] for g in groups}
    if not single:
        if any(kind == "bucket" for kind, _ in items):
            costs = [sum(predicted_cost(cfg, len(train_data)) for _, cfg in members) for _, members in items]
            owners = balanced_assignment(costs, len(groups))
        else:
            by_config = balanced_assignment(
                [predicted_cost(cfg, len(train_data)) for cfg in configs], len(groups)
            )
            owners = [by_config[members[0][0]] for _, members in items]
        for item, owner in zip(shared, owners):
            per_group[groups[owner].group_id].append(item)

    def queue_of(g: TrialGroup) -> list:
        return shared if single else per_group[g.group_id]

    local_groups = [g for g in groups if g.is_local_member]
    # group_id -> (kind, config index or None, run, generator)
    active: dict[int, tuple] = {}

    def fail_items(g: TrialGroup, members, error_text: str, *, status: str = "failed",
                   started: bool = True, progress_of=None) -> None:
        """Record ``members`` of a broken bucket as ``status``; a member
        whose attempt had not ``started`` (still queued) gets its start
        first, so the ledger pairs every end with a start."""
        for i, cfg in members:
            if not started:
                attempts[i] += 1
                led.attempt_start(cfg.trial_id, chashes[i], attempts[i])
            results[i] = TrialResult(trial_id=cfg.trial_id, group_id=g.group_id, config=cfg, status=status,
                                     error=error_text, attempt=attempts[i], stacked=True)
            led.attempt_end(cfg.trial_id, chashes[i], attempts[i], status, error=error_text,
                            summary=progress_of(i) if progress_of is not None else None)

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
        bus = get_bus()
        if bus is not None:
            bus.emit("retry_scheduled", trial_id=cfg.trial_id, group_id=g.group_id, backoff_s=delay,
                     infra_failures=fails, error=error_text)
        led.attempt_end(cfg.trial_id, chashes[i], attempts[i], "retrying", error=error_text, summary=progress)
        queue_of(g).append(("retry", [(i, cfg)], time.time() + delay))
        log0(
            f"Trial {cfg.trial_id} FAULTED ({error_text}); retrying from last valid "
            f"checkpoint in {delay:.2f}s (infra failure {fails} of {retry.max_retries + 1} budget)",
            trial=g,
        )
        return True

    def record_preempted_peers(error_text: str = "host preemption (sweep-wide)") -> None:
        """A preemption ends the whole driver: record every in-flight
        attempt, after landing its checkpoint write (best effort)."""
        for kind2, i2, run2, _ in list(active.values()):
            if kind2 == "bucket":
                run2.record_preempted(error_text)
                continue
            try:
                run2._join_ckpt()
            except Exception:  # noqa: BLE001 — recording must go on
                pass
            led.attempt_end(run2.cfg.trial_id, chashes[i2], attempts[i2], "preempted",
                            error=error_text, summary=attempt_progress(run2))

    def next_ready_at() -> Optional[float]:
        queues = [shared] if single else [per_group[g.group_id] for g in local_groups]
        deadlines = [item[2] for q in queues for item in q]
        return min(deadlines) if deadlines else None

    bucket_setup_fails: dict[tuple, int] = {}

    def start_bucket(g: TrialGroup, members) -> bool:
        """Start a stacked bucket on ``g``; False if its setup failed and
        it was requeued under ``retry`` or, in a resilient sweep, its
        members were recorded failed."""
        err: Optional[BaseException] = None
        try:
            run = _StackedBucketRun(g, members, train_data, test_data, out_dir, max_lanes=stack_max_lanes,
                                    save_checkpoint=save_checkpoints, verbose=verbose, ledger=led,
                                    attempts=attempts, chashes=chashes, injector=injector, retry=retry,
                                    infra_fails=infra_fails)
        except Exception as e:  # noqa: BLE001 — setup failure isolation
            err = e
        if needs_agreement(g):
            ok = group_all_ok(g, err is None, timeout_s=agree_timeout_s,
                              what=f"stacked bucket setup agreement over group {g.group_id}",
                              error_cls=WedgedCollective)
        else:
            ok = err is None
        if ok:
            active[g.group_id] = ("bucket", None, run, run.run())
            return True
        error_text = f"{type(err).__name__}: {err}" if err is not None else "setup failed on a peer rank"
        setup_class = classify_failure(err) if err is not None else INFRA
        if setup_class == PREEMPTION:
            fail_items(g, members, error_text, status="preempted", started=False)
            record_preempted_peers()
            raise err
        # An infra fault at setup (the data path, the filesystem) gets the
        # retry budget, counted per bucket (no lane exists yet to charge),
        # before its trials fail together.
        key = tuple(i for i, _ in members)
        fails = bucket_setup_fails[key] = bucket_setup_fails.get(key, 0) + 1
        if retry is not None and setup_class == INFRA and retry.should_retry(fails, INFRA):
            delay = retry.backoff_s(fails, key=members[0][0]) if single else 0.0
            queue_of(g).append(("bucket", members, time.time() + delay))
            log0(f"Stacked bucket of {len(members)} trials FAULTED at setup ({error_text}); retrying in "
                 f"{delay:.2f}s (setup failure {fails} of {retry.max_retries + 1} budget)", trial=g)
            return False
        fail_items(g, members, error_text, started=False)
        if not resilient:
            if err is not None:
                raise err
            raise RuntimeError(error_text)
        log0(f"Stacked bucket of {len(members)} trials FAILED at setup ({error_text}); sweep continues", trial=g)
        return False

    def finish_bucket(g: TrialGroup, run: _StackedBucketRun, e: Exception) -> None:
        """A bucket-wide failure: lanes already retired keep their results;
        every live lane and queued member is recorded ``failed`` (or
        ``preempted``) together. Lane divergence never reaches here."""
        error_text = f"{type(e).__name__}: {e}"
        preempted = classify_failure(e) == PREEMPTION
        status = "preempted" if preempted else "failed"
        results.update(run.results)
        fail_items(g, run.live_items(), error_text, status=status,
                   progress_of=run.lane_progress if preempted else None)
        fail_items(g, run.queue, error_text, status=status, started=False)
        if preempted:
            record_preempted_peers()
            raise e
        if not resilient:
            raise e
        log0(f"Stacked bucket FAILED ({error_text}); group freed, sweep continues", trial=g)

    def start_next(g: TrialGroup) -> None:
        q = queue_of(g)
        for _ in range(len(q)):
            kind, members, ready_at = q.pop(0)
            if ready_at > time.time():
                q.append((kind, members, ready_at))  # backoff not over
                continue
            if kind == "bucket":
                if start_bucket(g, members):
                    return
                continue
            (i, cfg), = members
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
                active[g.group_id] = ("single", i, run, run.run())
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

    bus = get_bus()
    if bus is not None:
        fleet_id = {}
        if bus.host is not None:
            fleet_id["host_slot"] = bus.host
        if bus.world is not None:
            fleet_id["world_epoch"] = bus.world
        bus.emit("sweep_start", configs=len(configs), groups=len(groups), stacked=bool(stack_trials),
                 resume=bool(resume), resilient=bool(resilient), skipped_settled=len(skipped), **fleet_id)

    try:
        for g in local_groups:
            with device_turn():
                start_next(g)
        # Cooperative round-robin: one unit of work per trial per cycle. A
        # retry waiting out its backoff never blocks live work; when only such
        # retries remain, the loop sleeps to the earliest deadline.
        while True:
            for g in local_groups:
                if g.group_id not in active:
                    with device_turn():
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
                kind, i, run, gen = active[g.group_id]
                try:
                    with device_turn():
                        next(gen)
                except StopIteration:
                    del active[g.group_id]
                    if kind == "bucket":
                        results.update(run.results)
                    else:
                        run.result.attempt = attempts[i]
                        results[i] = run.result
                        led.attempt_end(run.cfg.trial_id, chashes[i], attempts[i], "completed",
                                        summary=_result_summary(run.result))
                    with device_turn():
                        start_next(g)
                except Exception as e:  # noqa: BLE001 — failure isolation
                    del active[g.group_id]
                    if kind == "bucket":
                        finish_bucket(g, run, e)
                    else:
                        finish(g, i, run, e)
                    with device_turn():
                        start_next(g)
    finally:
        # Every exit path (completion, a raised failure, a preemption)
        # stops the farm and hands every held slot back to the registry.
        if farm is not None:
            farm.shutdown()
        for _, _, _, gen in list(active.values()):
            gen.close()
    bus = get_bus()
    if bus is not None:
        statuses: dict[str, int] = {}
        for r in results.values():
            statuses[r.status] = statuses.get(r.status, 0) + 1
        bus.emit("sweep_end", results=len(results), statuses=statuses)
    return [results[i] for i in sorted(results)]
