"""Per-trial train, eval and sample steps.

Counterpart of ``multidisttorch_tpu/train/steps.py`` (classic path). The
JAX package compiles each step into one program on the trial's submesh;
here a step is eager PyTorch on the group's device. On a group of more
than one rank the model is wrapped in ``DistributedDataParallel`` over the
group's subgroup, as the reference does.

Gradient semantics are the JAX package's: the loss is the per-sample mean,
and ``metrics["loss_sum"]`` is the summed negative ELBO over the whole
group's batch, for logging. On a multi-rank group each rank divides its
local loss sum by its local rows, and DDP's average of the ranks' gradients
is then the gradient of the global per-sample mean — the same estimator as
the JAX package's kernel-per-shard plus ``psum`` (``steps.py:254-271``).

``optax.adam(lr)`` becomes the port's :class:`~multidisttorch_tpu_torch.train.adam.Adam`
(``torch.optim.Adam``'s state, optax's order of operations; the stacked
step's update is the same function). ``remat=True`` (``TrialConfig.remat``) runs the model's forward
under ``torch.utils.checkpoint`` (``models/vae.py``), the JAX package's
``jax.checkpoint`` of the forward; the loss stays outside it, so each ELBO
kernel still launches once per step, and the numbers are remat off's.

**``use_fused_loss`` defaults to True here**, the one deliberate divergence
from the JAX package, where it defaults to False. In the port the fused
loss is where the hand-written CUDA kernels live (``ops/elbo.py``), and the
unfused loss is plain eager PyTorch. ``use_fused_loss=False`` runs the
plain loss and trains to the same numbers.

``make_multi_step`` runs the K steps of a chunk as one CUDA graph, the
counterpart of the JAX package's scanned program (``lax.scan``), on a
one-rank group on a card with the fused loss and ``grad_accum`` 1: the
eager step of this small VAE is host-bound, and a replay is one host call
for K steps. Every other case runs them in a Python loop (see its
docstring). On a card the optimizer is Adam with ``capturable=True`` (its
step count on the device), so the update can be captured; the eager loop
uses the same optimizer, so both give the same numbers.

Trial stacking (the JAX package's ``make_stacked_*``, at the end of this
module) runs K same-shape trials as one program: :class:`TrialHypers`,
:func:`create_stacked_train_state`, :func:`make_stacked_train_step`,
:func:`make_stacked_multi_step` (CUDA graphs by the same rule),
:func:`make_stacked_eval_step` and :func:`make_lane_ops`. Population-based
training's exchange and generation follow: :func:`pbt_exchange` and
:func:`make_pbt_generation_step` (one CUDA graph per generation on a card).
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from multidisttorch_tpu_torch.models.vae import VAE, StackedVAE, lane_params, write_lane_params
from multidisttorch_tpu_torch.ops import elbo as elbo_ops
from multidisttorch_tpu_torch.train.adam import Adam, adam_update_, bias_corrections
from multidisttorch_tpu_torch.train.streams import side_stream, stream_lock
from multidisttorch_tpu_torch.ops.elbo import fused_elbo_loss_sum, fused_elbo_loss_sum_lanes
from multidisttorch_tpu_torch.ops.losses import (
    elbo_loss_sum,
    elbo_loss_sum_lanes,
    elbo_loss_weighted_sum,
    elbo_loss_weighted_sum_lanes,
)
from multidisttorch_tpu_torch.parallel.collectives import group_pmean, group_psum
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup
from multidisttorch_tpu_torch.telemetry.metrics import get_registry, record_capture


@dataclass
class TrainState:
    """One trial's training state: the model (its parameters on the
    group's device), its Adam optimizer, and the optimizer-step count.
    ``ddp`` is the DDP wrapper on a multi-rank group, else None. The LM's
    steps (``train/lm.py``) use it too."""

    model: torch.nn.Module
    optimizer: Adam
    step: int = 0
    ddp: Optional[DistributedDataParallel] = None

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def module(self) -> torch.nn.Module:
        """What the train step calls: the DDP wrapper, or the model."""
        return self.model if self.ddp is None else self.ddp


def _require_trainable(group: TrialGroup) -> None:
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")
    if group.size > 1 and group.pg is None:
        raise NotImplementedError(
            f"{group!r} has {group.size} slots in one process: data-parallel "
            "training needs one process per device (launch with torchrun)"
        )


def create_train_state(
    group: TrialGroup, model: torch.nn.Module, lr: float, *, capturable: Optional[bool] = None
) -> TrainState:
    """Place ``model`` (already initialised) on the group's device and give
    it an Adam optimizer; on a multi-rank group, wrap it in DDP, which
    broadcasts the group-rank-0 weights to every member. The optimizer is
    ``capturable`` (its step count on the device, so a CUDA graph can hold
    the update) by default on a CUDA device, never on the CPU. A model
    with a ``bind_group(pg, size, rank)`` method is bound to a multi-rank
    group (the MoE VAE's router: ``ops/moe.py``).
    Every model family takes it; the classifiers' own is
    ``train/classifier.py::create_classifier_state``."""
    _require_trainable(group)
    model = model.to(group.device)
    if capturable is None:
        capturable = group.device.type == "cuda"
    optimizer = Adam(model.parameters(), lr=lr, capturable=capturable)
    ddp = None
    if group.size > 1:
        # A family whose forward spans the group's batch (an MoE router's
        # capacity and queues) binds to the group.
        bind = getattr(model, "bind_group", None)
        if bind is not None:
            bind(group.pg, group.size, group.local_rank)
        ddp = DistributedDataParallel(
            model,
            device_ids=[group.device] if group.device.type == "cuda" else None,
            process_group=group.pg,
        )
    return TrainState(model=model, optimizer=optimizer, step=0, ddp=ddp)


def _build_body(group: TrialGroup, beta: float, use_fused_loss: bool, grad_accum: int,
                remat: bool = False) -> Callable:
    """``body(state, batch, eps, generator) -> loss_sum``: one train step
    (gradients, the optimizer update, the group's summed loss) without
    the host's step count, so that a CUDA graph can hold it."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    _require_trainable(group)
    loss_impl = fused_elbo_loss_sum if use_fused_loss else elbo_loss_sum

    def microbatch_loss(module, mb, eps, generator):
        m = mb.shape[0]
        recon_logits, mu, logvar = module(mb, eps=eps, generator=generator, remat=remat)
        return loss_impl(recon_logits, mb.reshape(m, -1), mu, logvar, beta) / m

    def body(state: TrainState, batch, eps=None, generator=None):
        n = batch.shape[0]
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = microbatch_loss(state.module, batch, eps, generator)
            loss.backward()
            loss = loss.detach()
        else:
            if n % grad_accum:
                raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
            mb = n // grad_accum
            loss = None
            for a in range(grad_accum):
                rows = slice(a * mb, (a + 1) * mb)
                # DDP reduces gradients once, on the last microbatch.
                sync = state.ddp is None or a == grad_accum - 1
                with contextlib.nullcontext() if sync else state.ddp.no_sync():
                    part = microbatch_loss(
                        state.module, batch[rows], None if eps is None else eps[rows], generator
                    ) / grad_accum
                    part.backward()
                loss = part.detach() if loss is None else loss + part.detach()
        state.optimizer.step()
        loss_sum = (loss * n).float()
        if group.size > 1:
            dist.all_reduce(loss_sum, group=group.pg)
        return loss_sum

    return body


def _build_step_fn(
    group: TrialGroup, beta: float, use_fused_loss: bool, grad_accum: int, remat: bool
) -> Callable:
    body = _build_body(group, beta, use_fused_loss, grad_accum, remat)

    def step_fn(state: TrainState, batch, eps=None, generator=None):
        loss_sum = body(state, batch, eps, generator)
        state.step += 1
        return state, {"loss_sum": loss_sum}

    return step_fn


def make_train_step(
    group: TrialGroup,
    *,
    beta: float = 1.0,
    use_fused_loss: bool = True,
    grad_accum: int = 1,
    remat: bool = False,
) -> Callable:
    """Build ``step(state, batch, eps=None, generator=None) -> (state,
    metrics)``.

    ``batch`` is this rank's rows (the whole batch on a one-rank group).
    The reparameterisation noise is ``eps`` (shape ``(rows, latent)``) when
    given, else drawn from ``generator``. ``metrics["loss_sum"]`` is the
    summed negative ELBO over the group's batch, a 0-d f32 tensor left on
    the device.
    """
    return _build_step_fn(group, beta, use_fused_loss, grad_accum, remat)


def eager_reason(group: TrialGroup, *, use_fused_loss: bool = True, grad_accum: int = 1) -> Optional[str]:
    """Why :func:`make_multi_step` keeps the eager loop for this group and
    these arguments, or None where it captures CUDA graphs."""
    if group.device is None or group.device.type != "cuda":
        return f"the group's device is {group.device}, not a CUDA device"
    if group.size > 1:
        return (
            f"the group has {group.size} ranks: DDP's all-reduce under capture needs a "
            "static graph and NCCL settings of its own (ROADMAP A.3c)"
        )
    if grad_accum > 1:
        return f"grad_accum={grad_accum} (ROADMAP A.3d)"
    if not use_fused_loss:
        return "use_fused_loss=False: the plain loss is the eager reference"
    return None


def make_multi_step(
    group: TrialGroup,
    *,
    beta: float = 1.0,
    use_fused_loss: bool = True,
    grad_accum: int = 1,
    remat: bool = False,
) -> Callable:
    """K chained train steps: ``multi(state, batches, eps=None,
    generator=None)`` with ``batches`` of shape ``(K, rows, ...)`` (and
    ``eps`` ``(K, rows, latent)``). ``metrics["loss_sum"]`` has shape
    ``(K,)``; ``state.step`` advances by K.

    By rule (:func:`eager_reason`), a one-rank group on a CUDA device with
    the fused loss and ``grad_accum`` 1 runs each chunk as one replay of a
    CUDA graph of its K steps (:class:`GraphedMultiStep`). A group of more
    than one rank (DDP), ``grad_accum > 1``, ``use_fused_loss=False`` and a
    CPU device keep the eager loop over :func:`make_train_step`'s body.
    The returned callable's ``graphed`` says which runs, and ``replays``
    counts the graph replays.
    """
    body = _build_body(group, beta, use_fused_loss, grad_accum, remat)
    if eager_reason(group, use_fused_loss=use_fused_loss, grad_accum=grad_accum) is None:
        return GraphedMultiStep(body, group.device)
    return EagerMultiStep(body)


class EagerMultiStep:
    """K train steps in a Python loop."""

    graphed = False
    replays = 0

    def __init__(self, body: Callable):
        self._body = body

    def __call__(self, state: TrainState, batches, eps=None, generator=None):
        losses = []
        for k in range(batches.shape[0]):
            losses.append(self._body(state, batches[k], None if eps is None else eps[k], generator))
            state.step += 1
        return state, {"loss_sum": torch.stack(losses)}


# The device gate: held by a thread that captures a graph (around an
# ahead-of-time capture's warm-up too) and by the driver's thread for each
# turn of its host loop (device_turn). A capture then never meets another
# thread's submissions (a capture's start empties the allocator's caches,
# and work queued meanwhile by another thread has been seen to corrupt a
# concurrently trained bucket), while the card still runs everything
# already queued. Re-entrant: a turn may capture inline.
_CAPTURE_LOCK = threading.RLock()
_GATE_WAITERS = [0]


@contextlib.contextmanager
def device_gate():
    """Hold the device gate (a capture, an ahead-of-time warm-up)."""
    _GATE_WAITERS[0] += 1
    try:
        _CAPTURE_LOCK.acquire()
    finally:
        _GATE_WAITERS[0] -= 1
    try:
        yield
    finally:
        _CAPTURE_LOCK.release()


@contextlib.contextmanager
def device_turn():
    """One turn of the driver's host loop under the device gate; after it,
    a moment for a farm worker that waits for the gate."""
    with _CAPTURE_LOCK:
        yield
    if _GATE_WAITERS[0]:
        time.sleep(0.0005)


@dataclass
class _Captured:
    """One captured chunk: the graph, its static inputs and losses, its
    ELBO capture scope (workspaces and launch tally), and what it must keep
    alive."""

    graph: Any
    inputs: tuple
    losses: torch.Tensor
    scope: elbo_ops.CaptureScope
    keep: tuple = ()


class _GraphedChunks:
    """Chunks of train steps as CUDA graphs: one graph per key, captured
    when the key is first seen and replayed on the stream that captured it.
    :class:`GraphedMultiStep` (one trial) and
    :class:`GraphedStackedMultiStep` (K stacked trials) are built on it.

    Where it could go wrong, and what it does:

    - *Warm-up trains no extra step.* The first chunk of an owner (a
      trial's optimizer, a stacked state) runs eagerly, as real training,
      on the side stream that captures: it allocates the gradients, the
      optimizer's state and the stream's cuBLAS workspace outside any
      capture. Its graph is captured right after, and every later chunk of
      that key is a replay. A chunk of another length (an epoch's ragged
      last chunk) or shape gets a graph of its own, captured when first
      seen and then replayed.
    - *Gradients.* They are dropped before the capture, and each captured
      step drops its predecessor's as the eager step does, so backward
      writes fresh ones from the graph's private pool.
    - *Generators.* Noise drawn from an explicit ``torch.Generator`` is
      registered with the graph (``CUDAGraph.register_generator_state``),
      so each replay draws the next numbers of that generator, as the eager
      loop would; the default generator is registered by the capture
      itself.
    - *Static buffers.* Each chunk's inputs are copied into the graph's
      static ones; the losses are cloned before they are returned.
    - *The ELBO kernels' workspace and launch counts.* Each graph is
      captured inside an ``ops.elbo.capture_scope()``, kept with the graph:
      it gives the graph a ticket counter and partials of its own, which no
      eager call or other graph shares, and it tallies the ELBO launches the
      graph holds, which each replay adds to ``ops.elbo.LAUNCHES``.
    - *Other threads.* A capture prohibits unsafe CUDA calls only in its own
      thread (``capture_error_mode="thread_local"``), so the input feed's
      worker (``data/sampler.py``) goes on gathering and copying meanwhile.
      Work another thread queues on the stream under capture would land in
      the graph, so each object's stream is one no other live user holds
      (``train/streams.py``), and its chunks, warm-ups and captures run
      under that stream's lock.
    - *A warm-up that must not train* (a PBT generation, whose every run is
      to be a replay): the caller passes ``warm``, which runs the same work
      on a scratch copy of the state; the chunk is then captured and
      replayed at once.
    - *What a capture costs.* With telemetry on, each capture's warm-up
      and capture seconds go to the metrics registry
      (``telemetry.metrics.record_capture``, per program: the class and
      the chunk length).
    - *State a graph holds that changes by value* (an unstacked optimizer's
      Python-float lr): :meth:`drop` forgets the owner's graphs, and its
      next chunk is captured anew.
    - *Captured ahead of any trial* (a program slot of the compile
      registry, ``compile/programs.py``): ``prepare`` (each subclass's)
      warms up on a scratch copy of the state, as ``warm`` does, and
      captures without replaying; the slot's owner is then warm, and the
      first chunk a trial runs through it is a replay. A trial rebinds to
      the slot by value (the slot copies its parameters, moments, counts
      and generator states into the tensors the graphs hold).

    A capture that fails raises; nothing falls back to the eager loop. So
    does a device that is not a card with CUDA.
    """

    graphed = True
    # The books' name for this object's captures (record_capture): a
    # registry slot sets its program label; else the class's name.
    program: Optional[str] = None

    def __init__(self, device: torch.device):
        if device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA-graph capture needs a CUDA device, got {device} "
                f"(torch.cuda.is_available() is {torch.cuda.is_available()})"
            )
        self._device = device
        self._stream = side_stream(device, self)
        self._graphs: dict[tuple, _Captured] = {}
        self._warm: set[int] = set()
        self.replays = 0
        self.captures = 0

    def drop(self, owner) -> None:
        """Forget the graphs of ``owner`` (the first item of their keys).
        The owner stays warm: its next chunk is captured and replayed."""
        for key in [key for key in self._graphs if key[0] == id(owner)]:
            del self._graphs[key]

    def _capture(self, steps, inputs, generators, drop_grads, keep) -> _Captured:
        statics = tuple(None if x is None else torch.empty_like(x, device=self._device) for x in inputs)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        drop_grads()
        # "thread_local": the input feed's worker thread may allocate pinned
        # memory and copy on a stream of its own while this thread captures;
        # under the default "global" mode such a call in any thread fails the
        # capture. One capture at a time in the process (the compile farm's
        # workers and the driver's thread): the ELBO capture scopes are a
        # process-wide stack.
        with _CAPTURE_LOCK, elbo_ops.capture_scope() as scope:
            with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                losses = steps(*statics)
        self.captures += 1
        return _Captured(graph, statics, losses, scope, keep)

    def _timed_capture(self, warm_s: float, steps, inputs, *capture_args) -> _Captured:
        """:meth:`_capture`, and what it cost into the metrics registry
        (``telemetry.metrics.record_capture``) when telemetry is on: the
        program is the class and the chunk's length, ``inputs[0]``'s first
        dimension."""
        t0 = time.perf_counter()
        cap = self._capture(steps, inputs, *capture_args)
        if get_registry() is not None:
            record_capture(f"{self.program or type(self).__name__}[K={inputs[0].shape[0]}]", warm_s,
                           time.perf_counter() - t0)
        return cap

    def _prepare(self, owner, key, steps: Callable, inputs: tuple, generators: tuple, drop_grads: Callable,
                 keep: tuple, warm: Callable) -> None:
        """Capture the key's graph ahead of its first chunk, with no replay:
        ``warm`` (the same work on a scratch copy of the state) on the
        capturing stream first, then the capture. ``inputs`` give only the
        static buffers' shapes."""
        if key in self._graphs:
            return
        # The kernels' build (nvcc at a library's first use) before the
        # gate, so that it never holds up the driver's turns; a farm
        # worker's thread starts on device 0, the capture is this object's
        # device's.
        elbo_ops._kernels()
        with device_gate(), stream_lock(self._stream), torch.cuda.device(self._device):
            t0 = time.perf_counter()
            current = torch.cuda.current_stream(self._device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                warm()
            current.wait_stream(self._stream)
            self._warm.add(id(owner))
            self._stream.synchronize()
            self._graphs[key] = self._timed_capture(time.perf_counter() - t0, steps, inputs, generators,
                                                    drop_grads, keep)

    def free(self) -> None:
        """Release every graph and its private memory pool (a registry
        slot's eviction): the graphs are reset and forgotten."""
        for cap in self._graphs.values():
            cap.graph.reset()
        self._graphs.clear()
        self._warm.clear()

    def _chunk(self, owner, key, steps: Callable, inputs: tuple, generators: tuple, drop_grads: Callable,
               keep: tuple, warm: Optional[Callable] = None) -> torch.Tensor:
        """Run one chunk, ``steps(*inputs) -> losses``: eagerly as the
        owner's warm-up (or, given ``warm``, that on a scratch copy and then
        a replay), else as a replay of the key's graph (captured first if
        new); on this object's stream, under its lock."""
        with stream_lock(self._stream):
            return self._chunk_locked(owner, key, steps, inputs, generators, drop_grads, keep, warm)

    def _chunk_locked(self, owner, key, steps, inputs, generators, drop_grads, keep, warm) -> torch.Tensor:
        cap = self._graphs.get(key)
        if cap is None and id(owner) not in self._warm:
            # Warm-up on the capturing stream: this chunk's real training,
            # or the caller's scratch run.
            t0 = time.perf_counter()
            current = torch.cuda.current_stream(self._device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                losses = steps(*inputs) if warm is None else warm()
            current.wait_stream(self._stream)
            losses.record_stream(current)
            self._warm.add(id(owner))
            if get_registry() is not None:
                # The capture below starts with a device-wide sync anyway;
                # waiting here first only splits its time from the warm-up's.
                self._stream.synchronize()
            warm_s = time.perf_counter() - t0
            cap = self._graphs[key] = self._timed_capture(warm_s, steps, inputs, generators, drop_grads, keep)
            if warm is None:
                return losses
        if cap is None:
            cap = self._graphs[key] = self._timed_capture(0.0, steps, inputs, generators, drop_grads, keep)
        for static, x in zip(cap.inputs, inputs):
            if x is not None:
                static.copy_(x)
        # Replayed on the stream that captured it, ordered after the copies
        # and before what follows on the caller's stream.
        current = torch.cuda.current_stream(self._device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            cap.graph.replay()
        current.wait_stream(self._stream)
        elbo_ops.count_replay(cap.scope)
        self.replays += 1
        return cap.losses.clone()


class GraphedMultiStep(_GraphedChunks):
    """K train steps of one trial as one CUDA graph per (state, K, batch
    shape, dtype, noise source), replayed once per chunk
    (:class:`_GraphedChunks`). The state's optimizer must be
    ``capturable`` (its step count on the device; :func:`create_train_state`
    does so on a card). ``state.step`` advances by K on the host.
    """

    def __init__(self, body: Callable, device: torch.device):
        super().__init__(device)
        self._body = body

    def _steps(self, state, batches, eps, generator) -> torch.Tensor:
        return torch.stack([
            self._body(state, batches[k], None if eps is None else eps[k], generator)
            for k in range(batches.shape[0])
        ])

    @staticmethod
    def _key(state: TrainState, batches, eps, generator) -> tuple:
        return (id(state.optimizer), batches.shape[0], tuple(batches.shape[1:]), batches.dtype,
                None if eps is None else (tuple(eps.shape[1:]), eps.dtype),
                None if generator is None else id(generator))

    def __call__(self, state: TrainState, batches, eps=None, generator=None):
        k = batches.shape[0]
        losses = self._chunk(
            state.optimizer, self._key(state, batches, eps, generator),
            lambda b, e: self._steps(state, b, e, generator), (batches, eps),
            () if generator is None else (generator,),
            lambda: state.optimizer.zero_grad(set_to_none=True), keep=(state.optimizer, generator),
        )
        state.step += k
        return state, {"loss_sum": losses}

    def prepare(self, state: TrainState, batches, eps=None, generator=None) -> None:
        """Capture the graph a chunk shaped as ``batches`` takes, ahead of
        it (:meth:`_GraphedChunks._prepare`): the warm-up trains a scratch
        copy of ``state`` with a scratch generator; ``state`` itself, and
        ``generator``, are untouched until the first replay."""
        def warm():
            scratch = _scratch_train_state(state)
            sgen = None if generator is None else torch.Generator(device=self._device).manual_seed(0)
            return self._steps(scratch, batches, eps, sgen)

        self._prepare(
            state.optimizer, self._key(state, batches, eps, generator),
            lambda b, e: self._steps(state, b, e, generator), (batches, eps),
            () if generator is None else (generator,),
            lambda: state.optimizer.zero_grad(set_to_none=True), (state.optimizer, generator), warm,
        )


def _scratch_train_state(state: TrainState) -> TrainState:
    """A copy of a one-rank state (the model, and an optimizer of the same
    options holding copies of its moments and counts) for a warm-up."""
    model = copy.deepcopy(state.model)
    group = state.optimizer.param_groups[0]
    optimizer = Adam(model.parameters(), lr=group["lr"], capturable=group["capturable"])
    for q, p in zip(model.parameters(), state.model.parameters()):
        st = state.optimizer.state.get(p)
        if st:
            optimizer.state[q] = {k: v.clone() for k, v in st.items()}
    return TrainState(model=model, optimizer=optimizer, step=state.step)


class _HookedStep:
    """A step with host-side hooks around its call (:func:`wrap_step_with_hooks`).
    Every other attribute reads through to the wrapped step, so the
    driver's and ``chip_smoke.py``'s ``replays``, ``graphed`` and
    ``captures`` are the step's own."""

    def __init__(self, step_fn: Callable, before: Optional[Callable], transform_batch: Optional[Callable],
                 batch_argnum: int):
        self.__wrapped__ = step_fn
        self._before = before
        self._transform = transform_batch
        self._argnum = batch_argnum

    def __call__(self, *args, **kwargs):
        args = list(args)
        batch = args[self._argnum]
        if self._before is not None:
            self._before(batch)
        if self._transform is not None:
            args[self._argnum] = self._transform(batch)
        return self.__wrapped__(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.__wrapped__, name)


def wrap_step_with_hooks(
    step_fn: Callable,
    *,
    before: Optional[Callable] = None,
    transform_batch: Optional[Callable] = None,
    batch_argnum: int = 1,
) -> Callable:
    """Host-side hook seam around a step: the fault-injection thread-through
    point (``faults/inject.py`` via ``hpo/driver.py``), as in the JAX
    package.

    ``before(batch)`` runs before the call (it may raise, an injected crash
    or preemption, or stall, an injected straggler); ``transform_batch(batch)
    -> batch`` may replace the batch operand (NaN poisoning for divergence
    drills). Both see the positional argument at ``batch_argnum``. A hook
    that raises does so before anything is dispatched, so no graph is left
    half replayed. The step itself is untouched: a replaced batch reaches a
    captured graph through its static-input copy, so nothing is captured
    anew. A ``None``-hook wrap is the bare step itself; otherwise the
    wrapper keeps it as ``__wrapped__`` and reads every other attribute
    (``replays``, ``graphed``, ``captures``) from it.
    """
    if before is None and transform_batch is None:
        return step_fn
    return _HookedStep(step_fn, before, transform_batch, batch_argnum)


def make_eval_step(group: TrialGroup, *, beta: float = 1.0, with_recon: bool = True) -> Callable:
    """Build ``eval_fn(state, batch, weights=None, eps=None, generator=None)
    -> {"loss_sum"[, "recon"]}``.

    Without noise it evaluates at the posterior mean (deterministic, the
    JAX package's default); given ``eps`` or a ``generator`` it draws z from
    the posterior (the reference's sampled test loss). ``weights``, the 0/1
    row weights of a zero-padded final batch, make the sum cover exactly the
    real rows (the JAX package's ``masked=True``). ``loss_sum`` covers the
    group's batch; ``recon`` (pixel probabilities) covers this rank's rows.
    """
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def eval_fn(state: TrainState, batch, weights=None, eps=None, generator=None):
        model = state.model
        n = batch.shape[0]
        flat = batch.reshape(n, -1)
        with torch.no_grad():
            if eps is not None or generator is not None:
                recon_logits, mu, logvar = model(batch, eps=eps, generator=generator)
            else:
                mu, logvar = model.encode(batch)
                recon_logits = model.decode(mu)
            if weights is None:
                loss = elbo_loss_sum(recon_logits, flat, mu, logvar, beta)
            else:
                loss = elbo_loss_weighted_sum(recon_logits, flat, mu, logvar, weights, beta)
            out = {"loss_sum": loss.float()}
            if group.size > 1:
                dist.all_reduce(out["loss_sum"], group=group.pg)
            if with_recon:
                out["recon"] = torch.sigmoid(recon_logits.float())
        return out

    return eval_fn


def make_sample_step(group: TrialGroup, num_samples: int = 64) -> Callable:
    """Build ``sample_fn(state, generator) -> probs``: ``num_samples``
    prior draws ``z ~ N(0, I)`` decoded to pixel probabilities."""
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def sample_fn(state: TrainState, generator: torch.Generator):
        model = state.model
        with torch.no_grad():
            z = torch.randn(
                num_samples, model.latent_dim, generator=generator, device=group.device
            )
            return model.decode_probs(z).float()

    return sample_fn


# --- trial stacking: K same-shape trials through one program ---
#
# The JAX package vmaps one trial's step over K stacked states (its
# train/steps.py, "trial stacking"): K configs that share every array shape
# and differ only in scalar hypers (lr, beta, seed) advance together, one
# dispatch for K trials. Here the lane axis is written out: each layer is
# one batched product over the lanes (models/vae.py::StackedVAE), the loss
# one launch of each lane-batched ELBO kernel, and the update Adam on the
# stacked tensors with a per-lane lr and step count. Per-lane hypers are
# (K,) tensors on the device (TrialHypers), so one CUDA graph serves every
# mix of lanes: retiring a lane clears its `active` entry, refilling it
# copies a fresh trial into the stacked tensors in place (make_lane_ops),
# and neither captures anything anew.


@dataclass
class TrialHypers:
    """Per-lane hyperparameters of a stacked bucket, each ``(K,)`` on the
    device: what may differ between lanes without changing the program.
    ``lr`` is float64, the host's value (the update rounds it to f32, as
    the unstacked optimizer rounds its Python float); ``active`` is 1.0 for a lane
    that trains and 0.0 for one that is retired (its parameters, moments
    and step count stay as they are). Change them with :meth:`set_lane`,
    in place: a captured graph reads these tensors."""

    lr: torch.Tensor
    beta: torch.Tensor
    active: torch.Tensor

    @staticmethod
    def stack(lrs, betas, active=None, device=None) -> "TrialHypers":
        lr = torch.tensor(list(lrs), dtype=torch.float64, device=device)
        return TrialHypers(
            lr=lr,
            beta=torch.tensor(list(betas), dtype=torch.float32, device=device),
            active=torch.ones(lr.shape, dtype=torch.float32, device=device)
            if active is None else torch.tensor(list(active), dtype=torch.float32, device=device),
        )

    def set_lane(self, k: int, lr: float, beta: float, active: float = 1.0) -> None:
        self.lr[k] = lr
        self.beta[k] = beta
        self.active[k] = active


@dataclass
class StackedTrainState:
    """K trials' training state on one leading lane axis: the stacked
    model, Adam's two moments (one tensor per parameter, in
    ``model.parameters()`` order) and Adam's step count per lane
    (``count``, f32 on the device, as torch's Adam keeps it under
    ``capturable``). A lane's step count is its optimizer steps."""

    model: StackedVAE
    exp_avg: list
    exp_avg_sq: list
    count: torch.Tensor

    @property
    def lanes(self) -> int:
        return self.model.lanes

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def _write_lane(state: StackedTrainState, lane, k: int) -> None:
    """Copy a trial into lane ``k`` in place: a :class:`TrainState`
    (parameters, Adam's moments and step count) or a fresh :class:`VAE`
    (its parameters; zero moments and count, as a new optimizer)."""
    model = lane.model if isinstance(lane, TrainState) else lane
    write_lane_params(state.model, k, model.state_dict())
    adam = lane.optimizer.state if isinstance(lane, TrainState) else {}
    with torch.no_grad():
        for p, m, v in zip(model.parameters(), state.exp_avg, state.exp_avg_sq):
            st = adam.get(p)
            if st:
                m[k].copy_(st["exp_avg"])
                v[k].copy_(st["exp_avg_sq"])
            else:
                m[k].zero_()
                v[k].zero_()
        state.count[k] = float(lane.step) if isinstance(lane, TrainState) else 0.0


def _read_lane(state: StackedTrainState, k: int) -> TrainState:
    """Lane ``k`` as an unstacked trial's :class:`TrainState`, copies on
    the same device: a :class:`VAE` with the lane's parameters and an Adam
    holding its moments and step count (``step`` from the device, one
    sync). Its lr is a placeholder (0): a lane's lr lives in
    :class:`TrialHypers`, and Adam's state does not depend on it."""
    sm = state.model
    dev = state.count.device
    model = VAE(sm.input_dim, sm.hidden_dim, sm.latent_dim, sm.dtype).to(dev)
    model.load_state_dict(lane_params(sm, k))
    capturable = dev.type == "cuda"
    optimizer = Adam(model.parameters(), lr=0.0, capturable=capturable)
    step = int(state.count[k].item())
    for p, m, v in zip(model.parameters(), state.exp_avg, state.exp_avg_sq):
        optimizer.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float32, device=dev if capturable else "cpu"),
            "exp_avg": m[k].detach().clone(),
            "exp_avg_sq": v[k].detach().clone(),
        }
    return TrainState(model=model, optimizer=optimizer, step=step)


def create_stacked_train_state(group: TrialGroup, lanes: Sequence) -> StackedTrainState:
    """Stack K trials on the group's device, lane k from ``lanes[k]``: an
    initialised :class:`VAE` (a fresh trial, as the JAX package's
    ``build_lane_state``) or a :class:`TrainState`. Every rank of a
    multi-rank group holds the whole stacked state (the JAX package
    replicates it over the submesh); the lanes are built alike on every
    rank from their seeds, so no broadcast is needed."""
    _require_trainable(group)
    if not lanes:
        raise ValueError("a stacked state needs at least one lane")
    first = lanes[0].model if isinstance(lanes[0], TrainState) else lanes[0]
    model = StackedVAE(len(lanes), first.input_dim, first.hidden_dim, first.latent_dim, first.dtype)
    model = model.to(group.device)
    state = StackedTrainState(
        model=model,
        exp_avg=[torch.zeros_like(p) for p in model.parameters()],
        exp_avg_sq=[torch.zeros_like(p) for p in model.parameters()],
        count=torch.zeros(len(lanes), dtype=torch.float32, device=group.device),
    )
    for k, lane in enumerate(lanes):
        _write_lane(state, lane, k)
    return state


def _stacked_adam_update(state: StackedTrainState, hypers: TrialHypers) -> None:
    """One Adam step of every live lane from the parameters' gradients, in
    place; a retired lane (``active`` 0) keeps its parameters, moments and
    step count, selected (``torch.where``), never multiplied by the mask.
    The update is the unstacked optimizer's (``train/adam.py``) with each
    lane's bias corrections and lr broadcast over its slice, so a lane
    rounds as the same trial run alone."""
    count = state.count + 1
    live = hypers.active > 0.5
    k = state.lanes
    bc1, bc2 = bias_corrections(count)
    neg_lr = (-hypers.lr).float()
    params = list(state.model.parameters())
    shapes = [(k,) + (1,) * (p.dim() - 1) for p in params]
    with torch.no_grad():
        adam_update_(params, [p.grad for p in params], state.exp_avg, state.exp_avg_sq,
                     [bc1.view(s) for s in shapes], [bc2.view(s) for s in shapes],
                     [neg_lr.view(s) for s in shapes], live=[live.view(s) for s in shapes])
        torch.where(live, count, state.count, out=state.count)


def _build_stacked_body(group: TrialGroup, use_fused_loss: bool, grad_accum: int, remat: bool = False) -> Callable:
    """``body(state, hypers, batch, eps, generators) -> (K,) loss sums``:
    one stacked train step (the JAX package's ``_stacked_lane_body`` over
    every lane), with no host-side count, so that a CUDA graph can hold it.
    On a multi-rank group each rank holds its rows of every lane's batch;
    the stacked gradients are averaged and the loss sums summed over the
    group's process group (DDP's estimator, written out)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    _require_trainable(group)
    loss_impl = fused_elbo_loss_sum_lanes if use_fused_loss else elbo_loss_sum_lanes

    def microbatch_loss(state, hypers, mb, eps, generators):
        k, m = mb.shape[:2]
        recon_logits, mu, logvar = state.model(mb, eps=eps, generators=generators, remat=remat)
        return loss_impl(recon_logits, mb.reshape(k, m, -1), mu, logvar, hypers.beta) / m

    def body(state: StackedTrainState, hypers: TrialHypers, batch, eps=None, generators=None):
        n = batch.shape[1]
        for p in state.model.parameters():
            p.grad = None
        if grad_accum == 1:
            loss = microbatch_loss(state, hypers, batch, eps, generators)
            loss.sum().backward()
            loss = loss.detach()
        else:
            if n % grad_accum:
                raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
            mb = n // grad_accum
            loss = None
            for a in range(grad_accum):
                rows = slice(a * mb, (a + 1) * mb)
                part = microbatch_loss(
                    state, hypers, batch[:, rows], None if eps is None else eps[:, rows], generators
                ) / grad_accum
                part.sum().backward()
                loss = part.detach() if loss is None else loss + part.detach()
        if group.size > 1:
            for p in state.model.parameters():
                p.grad = group_pmean(group, p.grad)
        _stacked_adam_update(state, hypers)
        loss_sum = (loss * n).float()
        return group_psum(group, loss_sum) if group.size > 1 else loss_sum

    return body


def make_stacked_train_step(group: TrialGroup, *, use_fused_loss: bool = True, grad_accum: int = 1,
                            remat: bool = False) -> Callable:
    """One optimizer step of K stacked trials: ``step(state, hypers, batch,
    eps=None, generators=None) -> (state, metrics)``.

    ``batch`` is ``(K, rows, ...)``: each lane's rows (this rank's share on
    a multi-rank group). The noise is ``eps`` ``(K, rows, latent)`` when
    given, else lane k's is drawn from ``generators[k]`` (give each lane its
    unstacked twin's generator and it draws the twin's noise).
    ``metrics["loss_sum"]`` is ``(K,)``, one summed negative ELBO per lane
    over the group's batch, on the device. The fused loss runs the
    lane-batched ELBO kernels (``ops/elbo.py::fused_elbo_loss_sum_lanes``):
    the JAX package computes its stacked loss in XLA, because its kernel
    bakes beta in at compile time; the port's kernels read beta per lane.
    """
    body = _build_stacked_body(group, use_fused_loss, grad_accum, remat)

    def step_fn(state, hypers, batch, eps=None, generators=None):
        return state, {"loss_sum": body(state, hypers, batch, eps, generators)}

    return step_fn


class EagerStackedMultiStep:
    """S stacked train steps in a Python loop."""

    graphed = False
    replays = 0

    def __init__(self, body: Callable):
        self._body = body

    def __call__(self, state: StackedTrainState, hypers: TrialHypers, batches, eps=None, generators=None):
        losses = [self._body(state, hypers, batches[s], None if eps is None else eps[s], generators)
                  for s in range(batches.shape[0])]
        return state, {"loss_sum": torch.stack(losses)}


class GraphedStackedMultiStep(_GraphedChunks):
    """S stacked train steps as one CUDA graph per (state, hypers, S, batch
    shape, dtype, noise source), replayed once per chunk
    (:class:`_GraphedChunks`). The graph holds the stacked parameters,
    moments and counts, the hypers' tensors and the lanes' generators by
    address: retire and refill lanes through :meth:`TrialHypers.set_lane`,
    ``make_lane_ops``' ``write`` and ``Generator.manual_seed``, all in
    place, and every later replay trains the new lane mix with no new
    capture."""

    def __init__(self, body: Callable, device: torch.device):
        super().__init__(device)
        self._body = body

    def __call__(self, state: StackedTrainState, hypers: TrialHypers, batches, eps=None, generators=None):
        gens = tuple(generators or ())

        def steps(b, e):
            return torch.stack([self._body(state, hypers, b[s], None if e is None else e[s], generators)
                                for s in range(b.shape[0])])

        def drop_grads():
            for p in state.model.parameters():
                p.grad = None

        losses = self._chunk(state, self._key(state, hypers, batches, eps, gens), steps, (batches, eps), gens,
                             drop_grads, keep=(state, hypers, gens))
        return state, {"loss_sum": losses}

    @staticmethod
    def _key(state, hypers, batches, eps, gens) -> tuple:
        return (id(state), id(hypers), batches.shape[0], tuple(batches.shape[1:]), batches.dtype,
                None if eps is None else (tuple(eps.shape[1:]), eps.dtype), tuple(id(g) for g in gens))

    def prepare(self, state: StackedTrainState, hypers: TrialHypers, batches, eps=None, generators=None) -> None:
        """Capture the graph a chunk shaped as ``batches`` takes, ahead of
        it, warming up on scratch copies of the state, the hypers and the
        generators (:meth:`GraphedMultiStep.prepare`'s stacked sibling)."""
        gens = tuple(generators or ())

        def steps(b, e):
            return torch.stack([self._body(state, hypers, b[s], None if e is None else e[s], generators)
                                for s in range(b.shape[0])])

        def warm():
            scratch, shypers = _scratch_stacked_state(state, hypers)
            sgens = [torch.Generator(device=self._device).manual_seed(0) for _ in gens] or None
            return torch.stack([self._body(scratch, shypers, batches[s], None if eps is None else eps[s], sgens)
                                for s in range(batches.shape[0])])

        def drop_grads():
            for p in state.model.parameters():
                p.grad = None

        self._prepare(state, self._key(state, hypers, batches, eps, gens), steps, (batches, eps), gens, drop_grads,
                      (state, hypers, gens), warm)


def _scratch_stacked_state(state: StackedTrainState, hypers: TrialHypers):
    """Copies of a stacked state and its hypers, for a warm-up."""
    scratch = StackedTrainState(
        model=copy.deepcopy(state.model), exp_avg=[t.clone() for t in state.exp_avg],
        exp_avg_sq=[t.clone() for t in state.exp_avg_sq], count=state.count.clone())
    return scratch, TrialHypers(hypers.lr.clone(), hypers.beta.clone(), hypers.active.clone())


def make_stacked_multi_step(group: TrialGroup, *, use_fused_loss: bool = True, grad_accum: int = 1,
                            remat: bool = False) -> Callable:
    """S chained stacked steps: ``multi(state, hypers, batches, eps=None,
    generators=None)`` with ``batches`` ``(S, K, rows, ...)`` (and ``eps``
    ``(S, K, rows, latent)``); ``metrics["loss_sum"]`` is ``(S, K)``.

    By :func:`eager_reason`'s rule, a one-rank group on a CUDA device with
    the fused loss and ``grad_accum`` 1 runs each chunk as one replay of a
    CUDA graph of its S steps for all K lanes
    (:class:`GraphedStackedMultiStep`); anything else keeps the eager loop
    (:class:`EagerStackedMultiStep`). Both give the same numbers."""
    body = _build_stacked_body(group, use_fused_loss, grad_accum, remat)
    if eager_reason(group, use_fused_loss=use_fused_loss, grad_accum=grad_accum) is None:
        return GraphedStackedMultiStep(body, group.device)
    return EagerStackedMultiStep(body)


def _stacked_eval_sums(state: StackedTrainState, hypers: TrialHypers, batch, weights) -> torch.Tensor:
    """Every lane's masked posterior-mean eval of one shared batch: ``(K,)``
    f32 over this rank's rows (the JAX package's ``_stacked_eval_lane``)."""
    n = batch.shape[0]
    with torch.no_grad():
        mu, logvar = state.model.encode(batch.reshape(n, -1))
        recon_logits = state.model.decode(mu)
        return elbo_loss_weighted_sum_lanes(
            recon_logits, batch.reshape(n, -1), mu, logvar, weights, hypers.beta
        ).float()


def make_stacked_eval_step(group: TrialGroup) -> Callable:
    """Masked posterior-mean eval of K stacked trials: ``eval(state, hypers,
    batch, weights) -> {"loss_sum": (K,)}``. The batch and its 0/1 pad
    weights are shared by every lane (each trial scores the same test rows);
    the parameters and beta are per lane. The sums cover the group's
    batch."""
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def eval_fn(state, hypers, batch, weights):
        sums = _stacked_eval_sums(state, hypers, batch, weights)
        return {"loss_sum": group_psum(group, sums) if group.size > 1 else sums}

    return eval_fn


def make_stacked_eval_scan(group: TrialGroup) -> Callable:
    """The whole eval set at once: ``eval_scan(state, hypers, eval_batches,
    eval_weights) -> {"loss_sum": (K,)}`` with ``eval_batches`` ``(E, rows,
    ...)`` and ``eval_weights`` ``(E, rows)``, summed from zero over the E
    batches in order (the JAX package's scanned eval)."""
    eval_fn = make_stacked_eval_step(group)

    def eval_scan(state, hypers, eval_batches, eval_weights):
        acc = torch.zeros(state.lanes, dtype=torch.float32, device=state.count.device)
        for b, w in zip(eval_batches, eval_weights):
            acc = acc + eval_fn(state, hypers, b, w)["loss_sum"]
        return {"loss_sum": acc}

    return eval_scan


def make_lane_ops(group: TrialGroup) -> tuple[Callable, Callable]:
    """Lane surgery for mask-and-refill: ``(read, write)``.

    ``read(state, k) -> TrainState`` copies lane ``k`` out as an unstacked
    trial's state (a retired lane's result and checkpoint). ``write(state,
    lane, k) -> state`` copies a trial into lane ``k``: an initialised
    :class:`VAE` (a fresh trial: zero moments and step count) or a
    :class:`TrainState`. Both copy in place and never rebind a stacked
    tensor, so the CUDA graphs that hold the stacked state keep working
    with no new capture."""
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def write(state: StackedTrainState, lane, k: int) -> StackedTrainState:
        _write_lane(state, lane, k)
        return state

    return _read_lane, write


# --- population-based training: the exchange over the lane axis ---
#
# PBT (hpo/pbt.py) runs a population as the lanes of one stacked state.
# A generation is S stacked train steps, the eval of the whole eval set
# and the exploit/explore exchange: a stable argsort ranks the lanes, the
# bottom lanes copy the top lanes' parameters, Adam moments and step counts
# in place, and their lr becomes the source's times a factor drawn by the
# host (hpo/_threefry.py, the JAX package's draw). Everything is written in
# place, so one CUDA graph of the whole generation is replayed for every
# generation.


def pbt_exchange(
    state: StackedTrainState,
    hypers: TrialHypers,
    eval_sums: torch.Tensor,
    factors: torch.Tensor,
    *,
    n_exploit: int,
    lr_min: float,
    lr_max: float,
) -> dict[str, torch.Tensor]:
    """The exploit/explore exchange over the lane axis, in place (the JAX
    package's ``pbt_exchange``).

    ``eval_sums`` ``(K,)`` f32 ranks the lanes: NaN counts as ``+inf`` and
    the argsort is stable, so a diverged lane ranks last and is never a
    source, and ties break by lane. Bottom slot ``i`` exploits top slot
    ``i`` iff its sanitised sum is strictly worse: every stacked parameter,
    both Adam moments and ``count`` are gathered from ``src`` in place, and
    the lane's lr becomes ``clip(lr[src] * factors[lane], lr_min,
    lr_max)``, computed in f32 as the JAX package does and written into
    ``hypers.lr``. ``n_exploit`` (static, at most ``K // 2``, so sources
    and targets are disjoint) 0 is the identity. Noise generators are a
    lane's identity and are not copied.

    Returns the books, on the device: ``order`` (lanes best first),
    ``exploited`` (K,) bool, ``src`` (K,) (a lane itself where not
    exploited) and ``new_lr`` (K,) f32.
    """
    k = hypers.lr.shape[0]
    if not 0 <= n_exploit <= k // 2:
        raise ValueError(f"n_exploit {n_exploit} is outside [0, {k // 2}] for {k} lanes")
    sanitized = torch.where(torch.isnan(eval_sums), torch.full_like(eval_sums, float("inf")), eval_sums)
    order = torch.argsort(sanitized, stable=True)
    lanes = torch.arange(k, device=eval_sums.device)
    lr32 = hypers.lr.float()
    if n_exploit == 0:
        return {"order": order, "exploited": torch.zeros(k, dtype=torch.bool, device=eval_sums.device),
                "src": lanes, "new_lr": lr32}
    top, bottom = order[:n_exploit], order[k - n_exploit:]
    cond = sanitized[bottom] > sanitized[top]
    src = lanes.scatter(0, bottom, torch.where(cond, top, bottom))
    exploited = torch.zeros(k, dtype=torch.bool, device=eval_sums.device).scatter(0, bottom, cond)
    new_lr = torch.where(exploited, torch.clamp(lr32[src] * factors, lr_min, lr_max), lr32)
    with torch.no_grad():
        for t in (*state.model.parameters(), *state.exp_avg, *state.exp_avg_sq, state.count):
            t.copy_(t.index_select(0, src))
        hypers.lr.copy_(torch.where(exploited, new_lr.double(), hypers.lr))
    return {"order": order, "exploited": exploited, "src": src, "new_lr": new_lr}


def pbt_train_eval(body: Callable, eval_scan: Callable, state: StackedTrainState, hypers: TrialHypers, batches,
                   eval_batches, eval_weights, generators=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A generation before its exchange: S stacked train steps (``body``,
    :func:`_build_stacked_body`'s) and the eval of the whole eval set
    (``eval_scan``, :func:`make_stacked_eval_scan`'s). Returns the train
    sums ``(S, K)`` and the eval sums ``(K,)``."""
    train = torch.stack([body(state, hypers, batches[s], None, generators) for s in range(batches.shape[0])])
    return train, eval_scan(state, hypers, eval_batches, eval_weights)["loss_sum"]


def _pack_pbt_books(books: dict, train: torch.Tensor, eval_sums: torch.Tensor) -> torch.Tensor:
    """A generation's books as one f64 vector, so that one copy brings them
    to the host: every value (lane indices, f32 sums and lrs) is exact in
    f64."""
    return torch.cat([books["order"].double(), books["exploited"].double(), books["src"].double(),
                      books["new_lr"].double(), eval_sums.double(), train.reshape(-1).double()])


def fetch_pbt_books(packed: torch.Tensor, lanes: int) -> dict:
    """One host fetch of a generation's packed books: ``order``,
    ``exploited``, ``src``, ``new_lr`` (f32), ``eval_loss_sum`` (K,) f32 and
    ``train_loss_sum`` (S, K) f32, as numpy arrays."""
    host = packed.cpu().numpy()
    k = lanes
    return {
        "order": host[:k].astype(np.int64),
        "exploited": host[k : 2 * k].astype(bool),
        "src": host[2 * k : 3 * k].astype(np.int64),
        "new_lr": host[3 * k : 4 * k].astype(np.float32),
        "eval_loss_sum": host[4 * k : 5 * k].astype(np.float32),
        "train_loss_sum": host[5 * k :].reshape(-1, k).astype(np.float32),
    }


class EagerPBTGeneration:
    """A PBT generation run op by op."""

    graphed = False
    replays = 0
    captures = 0

    def __init__(self, fn: Callable):
        self._fn = fn

    def __call__(self, state, hypers, batches, eval_batches, eval_weights, factors, generators=None):
        return self._fn(state, hypers, batches, eval_batches, eval_weights, factors, generators)


class GraphedPBTGeneration(_GraphedChunks):
    """A PBT generation as one CUDA graph per (state, hypers, chunk shape,
    eval set, generators), captured before the first generation and
    replayed for every one (:class:`_GraphedChunks`, with the warm-up on a
    scratch copy of the state, so no generation runs eagerly). The graph
    holds the stacked state, the hypers, the eval set and the lanes'
    generators by address, and reads each generation's chunk and factors
    from static copies."""

    def __init__(self, fn: Callable, device: torch.device):
        super().__init__(device)
        self._fn = fn

    def _parts(self, state, hypers, batches, eval_batches, eval_weights, factors, generators):
        gens = tuple(generators or ())

        def generation(b, f):
            return self._fn(state, hypers, b, eval_batches, eval_weights, f, generators)

        def warm():
            # What capture needs made first (the kernels loaded, this
            # stream's cuBLAS workspace, the allocator's blocks), on a copy:
            # one step, one eval batch and an exchange.
            scratch, shypers = _scratch_stacked_state(state, hypers)
            sgens = [torch.Generator(device=self._device).manual_seed(0) for _ in gens] or None
            return self._fn(scratch, shypers, batches[:1], eval_batches[:1], eval_weights[:1], factors, sgens)

        def drop_grads():
            for p in state.model.parameters():
                p.grad = None

        key = (id(state), id(hypers), tuple(batches.shape), batches.dtype, id(eval_batches), id(eval_weights),
               tuple(id(g) for g in gens))
        return key, generation, gens, drop_grads, (state, hypers, gens, eval_batches, eval_weights), warm

    def __call__(self, state, hypers, batches, eval_batches, eval_weights, factors, generators=None):
        key, generation, gens, drop_grads, keep, warm = self._parts(
            state, hypers, batches, eval_batches, eval_weights, factors, generators)
        return self._chunk(state, key, generation, (batches, factors), gens, drop_grads, keep=keep, warm=warm)

    def prepare(self, state, hypers, batches, eval_batches, eval_weights, factors, generators=None) -> None:
        """Capture the generation's graph ahead of the first generation,
        with no replay (``batches`` and ``factors`` give the static
        buffers' shapes)."""
        key, generation, gens, drop_grads, keep, warm = self._parts(
            state, hypers, batches, eval_batches, eval_weights, factors, generators)
        self._prepare(state, key, generation, (batches, factors), gens, drop_grads, keep, warm)


def make_pbt_generation_step(group: TrialGroup, *, n_exploit: int, lr_min: float, lr_max: float) -> Callable:
    """One whole PBT generation: ``gen(state, hypers, batches, eval_batches,
    eval_weights, factors, generators=None) -> packed books`` with
    ``batches`` ``(S, K, rows, ...)``, the eval set ``(E, rows, ...)`` and
    ``(E, rows)`` shared by the lanes, and ``factors`` ``(K,)`` f32 the
    generation's explore draws. It runs S stacked train steps, the eval and
    :func:`pbt_exchange`, in place, and returns the books packed on the
    device; :func:`fetch_pbt_books` brings them to the host in one copy.

    By :func:`eager_reason`'s rule a one-rank group on a CUDA device runs
    it as replays of one CUDA graph (:class:`GraphedPBTGeneration`, no
    generation eager); elsewhere it runs op by op
    (:class:`EagerPBTGeneration`), with the same numbers.
    """
    body = _build_stacked_body(group, True, 1)
    eval_scan = make_stacked_eval_scan(group)

    def generation(state, hypers, batches, eval_batches, eval_weights, factors, generators=None):
        train, eval_sums = pbt_train_eval(body, eval_scan, state, hypers, batches, eval_batches, eval_weights,
                                          generators)
        books = pbt_exchange(state, hypers, eval_sums, factors, n_exploit=n_exploit, lr_min=lr_min, lr_max=lr_max)
        return _pack_pbt_books(books, train, eval_sums)

    if eager_reason(group) is None:
        return GraphedPBTGeneration(generation, group.device)
    return EagerPBTGeneration(generation)
