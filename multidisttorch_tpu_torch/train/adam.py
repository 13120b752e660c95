"""Adam, written once for every path of the port.

``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) in optax's
order of operations, each a single rounding in f32:

    m = (1 - b1)·g + b1·m            v = (1 - b2)·g² + b2·v
    u = (m / bc1) / (sqrt(v / bc2) + eps)      p = p + (−lr)·u

with ``bc1 = 1 − b1^t`` and ``bc2 = 1 − b2^t`` at the new step count ``t``.
:func:`adam_update_` is that update over a list of tensors; the
unstacked trial's optimizer (:class:`Adam`) and the stacked step
(``train/steps.py::_stacked_adam_update``, per-lane bias corrections and
lr broadcast over each lane) both call it, so one lane of a stacked state
and the same trial run alone round alike.

Only multiplications, additions, divisions and square roots appear, each
a separate operation: their results do not depend on whether a CPU kernel
takes a vector or a scalar path for an element, which ``lerp``,
``addcmul`` and ``addcdiv`` (fused multiply-adds in the vector path only)
do. On a card the bias corrections are device tensors: a division by a
host scalar is a multiplication by its reciprocal there.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8

Scalars = Union[float, torch.Tensor, Sequence[torch.Tensor]]


def bias_corrections(count: torch.Tensor):
    """``(1 − b1^t, 1 − b2^t)`` for the step counts ``count`` (already
    advanced): device tensors on a card (a graph can hold them), host
    floats for a 0-dim CPU count, f32 tensors for several CPU counts
    (each from the host's float64, rounded once)."""
    if count.device.type == "cuda":
        return 1 - torch.pow(BETA1, count), 1 - torch.pow(BETA2, count)
    if count.dim() == 0:
        t = float(count)
        return 1 - BETA1**t, 1 - BETA2**t
    steps = count.tolist()
    return (torch.tensor([1 - BETA1**t for t in steps], dtype=torch.float32),
            torch.tensor([1 - BETA2**t for t in steps], dtype=torch.float32))


def adam_update_(params: list, grads: list, exp_avgs: list, exp_avg_sqs: list,
                 bc1: Scalars, bc2: Scalars, neg_lr: Scalars, live: Sequence[torch.Tensor] = None) -> None:
    """One Adam step of ``params`` in place (module docstring). ``bc1``,
    ``bc2`` and ``neg_lr`` are each one value for every tensor or a list
    with one tensor per parameter that broadcasts against it. With
    ``live`` (a boolean tensor per parameter, broadcasting), an element
    whose ``live`` is false keeps its parameter and moments."""
    gm = torch._foreach_mul(grads, 1 - BETA1)
    gg = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(gg, 1 - BETA2)
    if live is None:
        m, v = exp_avgs, exp_avg_sqs
        torch._foreach_mul_(m, BETA1)
        torch._foreach_mul_(v, BETA2)
    else:
        m, v = torch._foreach_mul(exp_avgs, BETA1), torch._foreach_mul(exp_avg_sqs, BETA2)
    torch._foreach_add_(m, gm)
    torch._foreach_add_(v, gg)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, EPS)
    u = torch._foreach_div(m, bc1)
    torch._foreach_div_(u, den)
    torch._foreach_mul_(u, neg_lr)
    if live is None:
        torch._foreach_add_(params, u)
        return
    for p, pm, pv, new_m, new_v, up, sel in zip(params, exp_avgs, exp_avg_sqs, m, v, u, live):
        torch.where(sel, p + up, p, out=p)
        torch.where(sel, new_m, pm, out=pm)
        torch.where(sel, new_v, pv, out=pv)


class Adam(torch.optim.Adam):
    """``torch.optim.Adam``'s state and options (``exp_avg``,
    ``exp_avg_sq``, ``step`` per parameter; ``capturable`` keeps ``step``
    on the device so a CUDA graph can hold the update) with the update of
    :func:`adam_update_`. Every parameter of a group steps together, so
    the group's first step count gives the bias corrections. ``lr`` is
    read from the group at each step (a graph holds the value it was
    captured with)."""

    def __init__(self, params, lr: float, *, capturable: bool = False):
        super().__init__(params, lr=lr, betas=(BETA1, BETA2), eps=EPS, capturable=capturable, foreach=False)

    def init_state(self) -> None:
        """Create every parameter's state now (zero moments and count), as
        the first :meth:`step` would: a CUDA graph captured before any
        step must find the state's tensors already there."""
        for group in self.param_groups:
            for p in group["params"]:
                self._state_of(p, group)

    def _state_of(self, p: torch.Tensor, group: dict) -> dict:
        st = self.state[p]
        if not st:
            on_device = group["capturable"] or bool(group.get("fused"))
            st["step"] = (torch.zeros((), dtype=torch.float32, device=p.device) if on_device
                          else torch.tensor(0.0, dtype=torch.float32))
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("the port's Adam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self._state_of(p, group) for p in params]
            torch._foreach_add_([st["step"] for st in states], 1)
            bc1, bc2 = bias_corrections(states[0]["step"])
            adam_update_(params, [p.grad for p in params], [st["exp_avg"] for st in states],
                         [st["exp_avg_sq"] for st in states], bc1, bc2, -group["lr"])
        return None
