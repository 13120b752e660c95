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

``make_multi_step`` runs K steps in a Python loop; capturing them in one
CUDA graph is ROADMAP A.3b.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

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


def create_train_state(group: TrialGroup, model: torch.nn.Module, lr: float) -> TrainState:
    """Place ``model`` (already initialised) on the group's device and give
    it an Adam optimizer; on a multi-rank group, wrap it in DDP, which
    broadcasts the group-rank-0 weights to every member."""
    _require_trainable(group)
    model = model.to(group.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    ddp = None
    if group.size > 1:
        ddp = DistributedDataParallel(
            model,
            device_ids=[group.device] if group.device.type == "cuda" else None,
            process_group=group.pg,
        )
    return TrainState(model=model, optimizer=optimizer, step=0, ddp=ddp)


def _build_step_fn(
    group: TrialGroup, beta: float, use_fused_loss: bool, grad_accum: int
) -> Callable:
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    _require_trainable(group)
    loss_impl = fused_elbo_loss_sum if use_fused_loss else elbo_loss_sum

    def microbatch_loss(module, mb, eps, generator):
        m = mb.shape[0]
        recon_logits, mu, logvar = module(mb, eps=eps, generator=generator)
        return loss_impl(recon_logits, mb.reshape(m, -1), mu, logvar, beta) / m

    def step_fn(state: TrainState, batch, eps=None, generator=None):
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
        state.step += 1
        loss_sum = (loss * n).float()
        if group.size > 1:
            dist.all_reduce(loss_sum, group=group.pg)
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
    ``(K,)``. A Python loop over :func:`make_train_step`'s body."""
    step_fn = _build_step_fn(group, beta, use_fused_loss, grad_accum)

    def multi_fn(state: TrainState, batches, eps=None, generator=None):
        losses = []
        for k in range(batches.shape[0]):
            state, metrics = step_fn(
                state, batches[k], None if eps is None else eps[k], generator
            )
            losses.append(metrics["loss_sum"])
        return state, {"loss_sum": torch.stack(losses)}

    return multi_fn


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
