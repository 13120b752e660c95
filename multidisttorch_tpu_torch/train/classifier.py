"""Classifier train and eval steps on the trial groups (BASELINE.md config
4: ResNet-18 HPO on the subgroup scaffolding).

Counterpart of ``multidisttorch_tpu/train/classifier.py``, with the VAE
steps' execution model (``train/steps.py``): the same ``TrainState`` and
Adam, DDP over a multi-rank group's subgroup, and ``grad_accum``
microbatches under DDP's ``no_sync`` but for the last. The loss is the
mean softmax cross-entropy (``ops/losses.py``); a step's metrics are the
group batch's mean ``loss`` and its ``accuracy``, an eval's its ``loss``
and the count of ``correct`` rows, 0-d f32 tensors left on the device.

:func:`make_classifier_multi_step` follows ``make_multi_step``'s rule
(``steps.py::eager_reason``): a one-rank group on a card with
``grad_accum`` 1 replays one CUDA graph per chunk of K steps (captured
after the trial's first chunk has trained eagerly, which also lets cuDNN
pick its algorithms outside the capture); everything else runs the eager
loop. It is the port's counterpart of the JAX package's ``lax.scan``
dispatch. The callable reports ``graphed`` and ``replays``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from multidisttorch_tpu_torch.ops.losses import softmax_cross_entropy_mean
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup
from multidisttorch_tpu_torch.train.steps import TrainState, _GraphedChunks, create_train_state, eager_reason


def create_classifier_state(group: TrialGroup, model: nn.Module, lr: float, *, seed: Optional[int] = None) -> TrainState:
    """A classifier's state on the group: ``model`` initialised from
    ``seed`` with its family's initialisers (``model.init_params``), or as
    it is when ``seed`` is None (weights carried in), then placed with an
    Adam optimizer as ``train/steps.py::create_train_state`` does."""
    if seed is not None:
        model.init_params(seed)
    return create_train_state(group, model, lr)


def _build_classifier_body(group: TrialGroup, grad_accum: int) -> Callable:
    """``body(state, images, labels) -> (2,) tensor [loss, accuracy]``: one
    train step over the group's batch without the host's step count, so
    that a CUDA graph can hold it."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def microbatch(module, images, labels):
        logits = module(images)
        loss = softmax_cross_entropy_mean(logits, labels)
        correct = (logits.argmax(dim=-1) == labels).sum().float()
        return loss, correct

    def body(state: TrainState, images, labels):
        n = images.shape[0]
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss, correct = microbatch(state.module, images, labels)
            loss.backward()
            loss = loss.detach()
        else:
            if n % grad_accum:
                raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
            mb = n // grad_accum
            loss, correct = None, None
            for a in range(grad_accum):
                rows = slice(a * mb, (a + 1) * mb)
                # DDP reduces gradients once, on the last microbatch.
                sync = state.ddp is None or a == grad_accum - 1
                with contextlib.nullcontext() if sync else state.ddp.no_sync():
                    part, c = microbatch(state.module, images[rows], labels[rows])
                    (part / grad_accum).backward()
                part = part.detach() / grad_accum
                loss = part if loss is None else loss + part
                correct = c if correct is None else correct + c
        state.optimizer.step()
        loss, correct, n = _group_totals(group, loss, correct, n)
        return torch.stack([loss, correct / n])

    return body


def _group_totals(group: TrialGroup, loss, correct, n: int) -> tuple:
    """The group batch's mean ``loss``, its ``correct`` rows and its row
    count, from this rank's (one all-reduce on a multi-rank group). Scalar
    arithmetic only, so that a CUDA graph can hold it."""
    loss = loss.float()
    if group.size == 1:
        return loss, correct, n
    both = torch.stack([loss, correct])
    dist.all_reduce(both, group=group.pg)
    return both[0] / group.size, both[1], n * group.size


def _metrics(out: torch.Tensor) -> dict:
    return {"loss": out[..., 0], "accuracy": out[..., 1]}


def make_classifier_train_step(group: TrialGroup, *, grad_accum: int = 1) -> Callable:
    """``step(state, images, labels) -> (state, {loss, accuracy})`` over this
    rank's rows; ``grad_accum`` accumulates over equal microbatches."""
    body = _build_classifier_body(group, grad_accum)

    def step(state: TrainState, images, labels):
        out = body(state, images, labels)
        state.step += 1
        return state, _metrics(out)

    return step


class _EagerClassifierMultiStep:
    """K classifier steps in a Python loop."""

    graphed = False
    replays = 0

    def __init__(self, body: Callable):
        self._body = body

    def __call__(self, state: TrainState, images, labels):
        outs = []
        for k in range(images.shape[0]):
            outs.append(self._body(state, images[k], labels[k]))
            state.step += 1
        return state, _metrics(torch.stack(outs))


class GraphedClassifierMultiStep(_GraphedChunks):
    """K classifier steps as one CUDA graph per (state, K, batch shape,
    dtypes), replayed once per chunk (``steps.py::_GraphedChunks``: the
    trial's first chunk trains eagerly on the capturing stream, and then
    the chunk is captured). ``state.step`` advances by K on the host."""

    def __init__(self, body: Callable, device: torch.device):
        super().__init__(device)
        self._body = body

    def __call__(self, state: TrainState, images, labels):
        k = images.shape[0]
        key = (id(state.optimizer), k, tuple(images.shape[1:]), images.dtype, tuple(labels.shape[1:]), labels.dtype)
        out = self._chunk(
            state.optimizer, key,
            lambda x, y: torch.stack([self._body(state, x[j], y[j]) for j in range(k)]),
            (images, labels), (), lambda: state.optimizer.zero_grad(set_to_none=True), keep=(state.optimizer,),
        )
        state.step += k
        return state, _metrics(out)


def make_classifier_multi_step(group: TrialGroup, *, grad_accum: int = 1) -> Callable:
    """K chained classifier steps: ``multi(state, images, labels) -> (state,
    metrics)`` with ``images`` ``(K, rows, ...)`` and ``labels`` ``(K,
    rows)``; each metric has shape ``(K,)``. Graphed or eager by
    ``eager_reason``'s rule (module docstring)."""
    body = _build_classifier_body(group, grad_accum)
    if eager_reason(group, grad_accum=grad_accum) is None:
        return GraphedClassifierMultiStep(body, group.device)
    return _EagerClassifierMultiStep(body)


def make_classifier_eval_step(group: TrialGroup) -> Callable:
    """``eval_fn(state, images, labels) -> {loss, correct}``: the group
    batch's mean loss and its count of correct rows."""
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def eval_fn(state: TrainState, images, labels):
        with torch.no_grad():
            logits = state.model(images)
            loss, correct, _ = _group_totals(group, softmax_cross_entropy_mean(logits, labels),
                                             (logits.argmax(dim=-1) == labels).sum().float(), images.shape[0])
        return {"loss": loss, "correct": correct}

    return eval_fn
