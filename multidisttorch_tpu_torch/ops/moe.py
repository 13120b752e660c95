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
batch as one (GSPMD over the batch or sequence sharding), while each rank
here holds its own share. :meth:`MoEMLP.bind_group` (called through
the model's ``bind_group`` by ``train/steps.py::create_train_state`` on
such a group, or by the MoE LM under a ring attention) makes the router
match it, with one ``all_gather`` per call, and sizes the capacity from
the group's tokens:

- rows split over the ranks (data parallelism): each rank holds a
  contiguous block of rows and offsets its queue positions by the lower
  ranks' per-expert counts;
- the sequence split over the ranks (``seq_rows``, the LM under sequence
  parallelism): the JAX package flattens ``(B, T)`` b-major over the
  *global* sequence, so an expert's queue interleaves the ranks row by
  row. Each rank offsets a token in row ``b`` by every rank's counts in
  rows before ``b`` and the lower ranks' counts in row ``b``.

The auxiliary loss is then the group's, its per-expert fractions and mean
gate probabilities over every rank's tokens; its gradient flows through
this rank's gates only, so the group's summed gradients are the gradient
of the group's loss. Every rank of the group must call the module
together, as every step does.

:class:`StackedMoEMLP` is K MoE MLPs of one shape on a leading lane axis
(the stacked MoE VAE, ``models/moe_vae.py``), as the JAX package's ``vmap``
over the lanes computes them: each lane routes its own rows (its argmax,
queue positions and capacity), the router is one batched product
(``ops/lanes.py``) and the experts' products carry the lane axis. On a
bound group one ``all_gather`` carries every lane's ``(K, E)`` counts. No
step syncs with the host, so a CUDA graph can hold it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multidisttorch_tpu_torch.ops.lanes import StackedLinear, lane_linear


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

    def forward(self, x: torch.Tensor, seq_rows: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """``(y, aux)`` for ``x`` ``(N, in)``. ``seq_rows``: ``x`` is ``seq_rows``
        sequences' positions flattened b-major, the sequence split over a
        bound group (module docstring); None, the rows split."""
        b = x.shape[0]
        e, dt = self.num_experts, self.dtype
        cap = self.capacity(b)
        x = x.to(dt)
        gates = torch.softmax(F.linear(x.float(), self.gate.weight, self.gate.bias), dim=-1)  # (B, E), f32
        experts = torch.arange(e, device=x.device)
        onehot = (torch.argmax(gates, dim=-1).unsqueeze(-1) == experts).to(torch.float32)
        top_gate = (gates * onehot).sum(-1)
        frac, prob = onehot.mean(0), gates.mean(0)
        # Queue position of each token in its expert (1-based), after the
        # group's tokens that come before it on a bound group.
        if self._pg is None:
            pos = torch.cumsum(onehot, dim=0)
        else:
            pos, frac, prob = self._group_route(onehot, gates, seq_rows)
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

        aux = e * torch.sum(frac * prob)
        return y, aux.to(torch.float32)

    def _group_route(self, onehot, gates, seq_rows):
        """Queue positions, expert fractions and mean gate probabilities
        over the bound group, from one ``all_gather`` of this rank's counts
        (per row of the sequence under ``seq_rows``) and gate sums."""
        k, r = self._group_size, self._group_rank
        rows = 1 if seq_rows is None else seq_rows
        oh = onehot.reshape(rows, -1, onehot.shape[-1])
        own_gates = gates.sum(0)
        stats = torch.cat([oh.sum(1), own_gates.detach()[None]])  # (rows + 1, E)
        parts = [torch.empty_like(stats) for _ in range(k)]
        dist.all_gather(parts, stats, group=self._pg)
        counts = torch.stack(parts)[:, :rows]  # (k, rows, E)
        # every rank's tokens in earlier rows, then the lower ranks' in this row
        earlier = torch.cumsum(counts.sum(0), dim=0) - counts.sum(0)
        before = earlier + counts[:r].sum(0)
        pos = (torch.cumsum(oh, dim=1) + before[:, None, :]).reshape(onehot.shape)
        n = onehot.shape[0] * k
        gate_sum = own_gates + (sum(p[-1] for p in parts) - own_gates.detach())
        return pos, counts.sum((0, 1)) / n, gate_sum / n


class StackedMoEMLP(nn.Module):
    """K :class:`MoEMLP` s of one shape, ``(K, B, in_dim) -> (K, B,
    out_dim)``: ``w1`` ``(K, E, in, hidden)``, ``b1`` ``(K, E, hidden)``,
    ``w2`` ``(K, E, hidden, out)``, ``b2`` ``(K, E, out)`` and the router
    ``gate`` (``weight`` ``(K, E, in)``, ``bias`` ``(K, E)``), in the single
    module's parameter order. Lane k routes lane k's rows as
    :meth:`MoEMLP.forward` routes them (module docstring)."""

    def __init__(self, lanes: int, in_dim: int, num_experts: int, hidden_dim: int, out_dim: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = num_experts
        self.lanes = lanes
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.w1 = nn.Parameter(torch.zeros(lanes, e, in_dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(lanes, e, hidden_dim))
        self.w2 = nn.Parameter(torch.zeros(lanes, e, hidden_dim, out_dim))
        self.b2 = nn.Parameter(torch.zeros(lanes, e, out_dim))
        self.gate = StackedLinear(lanes, in_dim, e)
        self._pg = None
        self._group_size = 1
        self._group_rank = 0

    bind_group = MoEMLP.bind_group
    capacity = MoEMLP.capacity

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(K, B, in)`` to ``(y, aux)``: ``y`` ``(K, B, out)``, ``aux``
        ``(K,)``, each lane's Switch auxiliary loss."""
        b = x.shape[1]
        e, dt = self.num_experts, self.dtype
        cap = self.capacity(b)
        x = x.to(dt)
        gates = torch.softmax(lane_linear(x.float(), self.gate.weight, self.gate.bias), dim=-1)  # (K, B, E), f32
        experts = torch.arange(e, device=x.device)
        onehot = (torch.argmax(gates, dim=-1).unsqueeze(-1) == experts).to(torch.float32)
        top_gate = (gates * onehot).sum(-1)
        # Each lane's queue positions (1-based), after the lower ranks'
        # tokens of that lane on a bound group.
        pos = torch.cumsum(onehot, dim=1)
        if self._pg is not None:
            counts = onehot.sum(1)  # (K, E)
            parts = [torch.empty_like(counts) for _ in range(self._group_size)]
            dist.all_gather(parts, counts, group=self._pg)
            pos = pos + sum(parts[: self._group_rank], torch.zeros_like(counts)).unsqueeze(1)
        pos = pos * onehot
        within = (pos > 0) & (pos <= cap)
        slots = torch.arange(cap, device=x.device, dtype=pos.dtype)
        disp = (slots == (pos - 1.0).unsqueeze(-1)).to(torch.float32) * within.unsqueeze(-1).to(torch.float32)

        w1, b1, w2, b2 = (t.to(dt) for t in (self.w1, self.b1, self.w2, self.b2))
        expert_in = torch.einsum("kbec,kbd->kecd", disp.to(dt), x)
        hmid = F.relu(torch.einsum("kecd,kedh->kech", expert_in, w1) + b1[:, :, None, :])
        out_e = torch.einsum("kech,keho->keco", hmid, w2) + b2[:, :, None, :]
        combine = disp * top_gate[..., None, None]
        y = torch.einsum("kbec,keco->kbo", combine.to(dt), out_e)

        aux = e * torch.sum(onehot.mean(1) * gates.mean(1), dim=-1)
        return y, aux.to(torch.float32)
