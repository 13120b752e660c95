"""Mixture-of-experts MLP: top-1 routing with a capacity, as static
dispatch and combine products.

Counterpart of ``multidisttorch_tpu/ops/moe.py::MoEMLP``: the router runs
in f32 (softmax, argmax, the top gate); each token takes its place in its
expert's queue in batch order (a cumulative sum of the one-hot choices);
each expert serves at most ``C = ceil(B·capacity_factor/E)`` tokens, and a
token past it contributes nothing; dispatch, the experts' two layers and
the combine are ``torch.einsum`` s over one-hot ``(B, E, C)`` tensors, as
the JAX package computes them (outside any Pallas kernel). The Switch
auxiliary loss comes back beside the output.

**On a group of several ranks** the JAX package routes the group's whole
batch as one (GSPMD over the batch sharding), while each rank here holds
its own contiguous share. :meth:`MoEMLP.bind_group` (called through
the model's ``bind_group`` by ``train/steps.py::create_train_state`` on
such a group) makes the router
match it: each rank offsets its queue positions by the lower ranks'
per-expert counts (one ``all_gather`` of E numbers per call) and sizes
the capacity from the group's batch. Every rank of the group must then
call the module together, as every step does. The auxiliary loss stays
this rank's (no step uses it).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class MoEMLP(nn.Module):
    """Top-1-routed expert MLP, ``(B, in_dim) -> (B, out_dim)``: ``gate``
    a Dense router, ``w1`` ``(E, in, hidden)``, ``b1`` ``(E, hidden)``,
    ``w2`` ``(E, hidden, out)``, ``b2`` ``(E, out)`` (flax's layout)."""

    def __init__(self, in_dim: int, num_experts: int, hidden_dim: int, out_dim: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = num_experts
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.w1 = nn.Parameter(torch.zeros(e, in_dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(e, hidden_dim))
        self.w2 = nn.Parameter(torch.zeros(e, hidden_dim, out_dim))
        self.b2 = nn.Parameter(torch.zeros(e, out_dim))
        self.gate = nn.Linear(in_dim, e)
        self._pg = None
        self._group_size = 1
        self._group_rank = 0

    def bind_group(self, pg, size: int, rank: int) -> None:
        """Route as one batch over the ``size`` ranks of process group
        ``pg``, this rank holding share ``rank`` (module docstring)."""
        self._pg, self._group_size, self._group_rank = pg, size, rank

    def capacity(self, rows: int) -> int:
        """Tokens each expert serves when this rank holds ``rows`` rows."""
        return max(1, math.ceil(rows * self._group_size * self.capacity_factor / self.num_experts))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        e, dt = self.num_experts, self.dtype
        cap = self.capacity(b)
        x = x.to(dt)
        gates = torch.softmax(F.linear(x.float(), self.gate.weight, self.gate.bias), dim=-1)  # (B, E), f32
        experts = torch.arange(e, device=x.device)
        onehot = (torch.argmax(gates, dim=-1).unsqueeze(-1) == experts).to(torch.float32)
        top_gate = (gates * onehot).sum(-1)
        # Queue position of each token in its expert (1-based), after the
        # lower ranks' tokens on a bound group.
        pos = torch.cumsum(onehot, dim=0)
        if self._pg is not None:
            counts = onehot.sum(0)
            parts = [torch.empty_like(counts) for _ in range(self._group_size)]
            dist.all_gather(parts, counts, group=self._pg)
            pos = pos + sum(parts[: self._group_rank], torch.zeros_like(counts))
        pos = pos * onehot
        within = (pos > 0) & (pos <= cap)
        # one_hot(pos - 1, cap), zero where pos - 1 is out of [0, cap).
        slots = torch.arange(cap, device=x.device, dtype=pos.dtype)
        disp = (slots == (pos - 1.0).unsqueeze(-1)).to(torch.float32) * within.unsqueeze(-1).to(torch.float32)

        w1, b1, w2, b2 = (t.to(dt) for t in (self.w1, self.b1, self.w2, self.b2))
        expert_in = torch.einsum("bec,bd->ecd", disp.to(dt), x)
        hmid = F.relu(torch.einsum("ecd,edh->ech", expert_in, w1) + b1[:, None, :])
        out_e = torch.einsum("ech,eho->eco", hmid, w2) + b2[:, None, :]
        combine = disp * top_gate[:, None, None]
        y = torch.einsum("bec,eco->bo", combine.to(dt), out_e)

        aux = e * torch.sum(onehot.mean(0) * gates.mean(0))
        return y, aux.to(torch.float32)

