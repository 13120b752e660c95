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

``optax.adam(lr)`` becomes ``torch.optim.Adam(lr, betas=(0.9, 0.999),
eps=1e-8)``.

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
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from multidisttorch_tpu_torch.ops import elbo as elbo_ops
from multidisttorch_tpu_torch.ops.elbo import fused_elbo_loss_sum
from multidisttorch_tpu_torch.ops.losses import elbo_loss_sum, elbo_loss_weighted_sum
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup


@dataclass
class TrainState:
    """One trial's training state: the model (its parameters on the
    group's device), its Adam optimizer, and the optimizer-step count.
    ``ddp`` is the DDP wrapper on a multi-rank group, else None. The LM's
    steps (``train/lm.py``) use it too."""

    model: torch.nn.Module
    optimizer: torch.optim.Adam
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
    the update) by default on a CUDA device, never on the CPU."""
    _require_trainable(group)
    model = model.to(group.device)
    if capturable is None:
        capturable = group.device.type == "cuda"
    optimizer = torch.optim.Adam(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable
    )
    ddp = None
    if group.size > 1:
        ddp = DistributedDataParallel(
            model,
            device_ids=[group.device] if group.device.type == "cuda" else None,
            process_group=group.pg,
        )
    return TrainState(model=model, optimizer=optimizer, step=0, ddp=ddp)


def _build_body(group: TrialGroup, beta: float, use_fused_loss: bool, grad_accum: int) -> Callable:
    """``body(state, batch, eps, generator) -> loss_sum``: one train step
    (gradients, the optimizer update, the group's summed loss) without
    the host's step count, so that a CUDA graph can hold it."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    _require_trainable(group)
    loss_impl = fused_elbo_loss_sum if use_fused_loss else elbo_loss_sum

    def microbatch_loss(module, mb, eps, generator):
        m = mb.shape[0]
        recon_logits, mu, logvar = module(mb, eps=eps, generator=generator)
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
    group: TrialGroup, beta: float, use_fused_loss: bool, grad_accum: int
) -> Callable:
    body = _build_body(group, beta, use_fused_loss, grad_accum)

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
) -> Callable:
    """Build ``step(state, batch, eps=None, generator=None) -> (state,
    metrics)``.

    ``batch`` is this rank's rows (the whole batch on a one-rank group).
    The reparameterisation noise is ``eps`` (shape ``(rows, latent)``) when
    given, else drawn from ``generator``. ``metrics["loss_sum"]`` is the
    summed negative ELBO over the group's batch, a 0-d f32 tensor left on
    the device.
    """
    return _build_step_fn(group, beta, use_fused_loss, grad_accum)


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
    body = _build_body(group, beta, use_fused_loss, grad_accum)
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


@dataclass
class _Captured:
    """One captured chunk: the graph, its static inputs and losses, its
    ELBO capture scope (workspaces and launch tally), and what it must keep
    alive."""

    graph: Any
    batches: torch.Tensor
    eps: Optional[torch.Tensor]
    losses: torch.Tensor
    scope: elbo_ops.CaptureScope
    keep: tuple = ()


class GraphedMultiStep:
    """K train steps as one CUDA graph per (state, K, batch shape, dtype,
    noise source), replayed once per chunk.

    Where it could go wrong, and what it does:

    - *Warm-up trains no extra step.* The first chunk for a state runs
      eagerly, as real training, on the side stream that captures: it
      allocates the gradients, Adam's state and the stream's cuBLAS
      workspace outside any capture. Its graph is captured right after,
      and every later chunk of that shape is a replay. A chunk of another
      K (an epoch's ragged last chunk) or shape gets a graph of its own,
      captured when first seen and then replayed.
    - *Adam under capture.* The state's optimizer must be ``capturable``
      (its step count on the device; :func:`create_train_state` does so on
      a card). Gradients are dropped before the capture
      (``zero_grad(set_to_none=True)``), and each captured step drops its
      predecessor's as the eager step does, so backward writes fresh ones
      from the graph's private pool.
    - *The trial's own generator.* Noise drawn from an explicit
      ``torch.Generator`` is registered with the graph
      (``CUDAGraph.register_generator_state``), so each replay draws the
      next numbers of that generator, as the eager loop would; the default
      generator is registered by the capture itself.
    - *Static buffers.* Each chunk is copied into the graph's static
      ``(K, rows, ...)`` input (and noise); the ``(K,)`` losses are cloned
      before they are returned. ``state.step`` advances by K on the host.
    - *The forward's workspace and launch counts.* Each graph is captured
      inside an ``ops.elbo.capture_scope()``, kept with the graph: it gives
      the graph a ticket counter and partials of its own, which no eager
      call or other graph shares, and it tallies the ELBO launches the
      graph holds, which each replay adds to ``ops.elbo.LAUNCHES``.

    A capture that fails raises; nothing falls back to the eager loop. So
    does a device that is not a card with CUDA.
    """

    graphed = True

    def __init__(self, body: Callable, device: torch.device):
        if device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA-graph capture needs a CUDA device, got {device} "
                f"(torch.cuda.is_available() is {torch.cuda.is_available()})"
            )
        self._body = body
        self._device = device
        self._stream = torch.cuda.Stream(device)
        self._graphs: dict[tuple, _Captured] = {}
        self._warm: set[int] = set()
        self.replays = 0

    def _steps(self, state, batches, eps, generator) -> torch.Tensor:
        return torch.stack([
            self._body(state, batches[k], None if eps is None else eps[k], generator)
            for k in range(batches.shape[0])
        ])

    def _capture(self, state, batches, eps, generator) -> _Captured:
        static_b = torch.empty_like(batches, device=self._device)
        static_e = None if eps is None else torch.empty_like(eps, device=self._device)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        state.optimizer.zero_grad(set_to_none=True)
        with elbo_ops.capture_scope() as scope:
            with torch.cuda.graph(graph, stream=self._stream):
                losses = self._steps(state, static_b, static_e, generator)
        return _Captured(graph, static_b, static_e, losses, scope, keep=(state.optimizer, generator))

    def __call__(self, state: TrainState, batches, eps=None, generator=None):
        k = batches.shape[0]
        key = (id(state.optimizer), k, tuple(batches.shape[1:]), batches.dtype,
               None if eps is None else (tuple(eps.shape[1:]), eps.dtype),
               None if generator is None else id(generator))
        cap = self._graphs.get(key)
        if cap is None and id(state.optimizer) not in self._warm:
            # Warm-up: this chunk trains eagerly on the capturing stream.
            current = torch.cuda.current_stream(self._device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                losses = self._steps(state, batches, eps, generator)
            current.wait_stream(self._stream)
            losses.record_stream(current)
            self._warm.add(id(state.optimizer))
            self._graphs[key] = self._capture(state, batches, eps, generator)
            state.step += k
            return state, {"loss_sum": losses}
        if cap is None:
            cap = self._graphs[key] = self._capture(state, batches, eps, generator)
        cap.batches.copy_(batches)
        if eps is not None:
            cap.eps.copy_(eps)
        # Replayed on the stream that captured it, ordered after the copies
        # and before what follows on the caller's stream.
        current = torch.cuda.current_stream(self._device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            cap.graph.replay()
        current.wait_stream(self._stream)
        elbo_ops.count_replay(cap.scope)
        self.replays += 1
        state.step += k
        return state, {"loss_sum": cap.losses.clone()}


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
