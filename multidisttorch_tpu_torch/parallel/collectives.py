"""Group-scoped collectives over trial groups.

Counterpart of ``multidisttorch_tpu/parallel/collectives.py``: the JAX
package compiles ``all_gather``/``psum``/``pmean`` onto a submesh; here they
are ``torch.distributed`` calls with ``group=`` the trial's subgroup, as in
the reference's ``example-subgroup.py``. Each member rank contributes its
own tensor; a one-rank group returns its input unchanged. Two groups'
collectives run over disjoint ranks, independently.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from multidisttorch_tpu_torch.parallel.mesh import TrialGroup


def _require_pg(group: TrialGroup) -> None:
    if group.pg is None:
        raise RuntimeError(
            f"{group!r} has {group.size} slots in one process and no process "
            "group; launch one process per device to run collectives over it"
        )
    if not group.is_local_member:
        raise RuntimeError(f"this process is not a member of {group!r}")


def group_all_gather(group: TrialGroup, x: torch.Tensor) -> torch.Tensor:
    """Concatenate every member's ``x`` along dim 0, in group-rank order;
    every member gets the whole result."""
    if group.size == 1:
        return x
    _require_pg(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    return torch.cat(parts, dim=0)


def group_psum(group: TrialGroup, x: torch.Tensor) -> torch.Tensor:
    """Sum of every member's ``x`` (the explicit form of DDP's gradient
    all-reduce scoped to a group)."""
    if group.size == 1:
        return x
    _require_pg(group)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.pg)
    return out


def group_pmean(group: TrialGroup, x: torch.Tensor) -> torch.Tensor:
    """Mean of every member's ``x`` (DDP's gradient averaging)."""
    if group.size == 1:
        return x
    return group_psum(group, x) / group.size
