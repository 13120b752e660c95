"""Group-scoped collectives over trial groups.

Counterpart of ``multidisttorch_tpu/parallel/collectives.py``: the JAX
package compiles ``all_gather``/``psum``/``pmean`` onto a submesh; here they
are ``torch.distributed`` calls with ``group=`` the trial's subgroup, as in
the reference's ``example-subgroup.py``. Each member rank contributes its
own tensor; a one-rank group returns its input unchanged. Two groups'
collectives run over disjoint ranks, independently.

:func:`group_all_ok` and :func:`group_min_scalar` are the JAX package's
group agreements: one small all-reduce over the group's own process group
(NCCL on the card, gloo on the CPU) on a tensor on the group's device,
bounded by ``cluster.call_with_timeout``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from multidisttorch_tpu_torch.parallel.cluster import AgreementTimeout, call_with_timeout
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


def _agree_reduce(group, value: int, op, timeout_s, what, error_cls) -> int:
    if group.size == 1:
        return int(value)
    _require_pg(group)

    def agree() -> int:
        t = torch.tensor([int(value)], dtype=torch.int64, device=group.device)
        dist.all_reduce(t, op=op, group=group.pg)
        return int(t.item())

    return call_with_timeout(agree, timeout_s, what, error_cls=error_cls or AgreementTimeout)


def group_all_ok(
    group: TrialGroup,
    ok: bool,
    *,
    timeout_s: float | None = None,
    what: str = "group health agreement",
    error_cls: type | None = None,
) -> bool:
    """True iff every member rank of ``group`` called with ``ok=True``.

    The failure-detection primitive: the health bit rides the group's own
    process group, so no world barrier and no other trial takes part.
    Every member must call it at the same point (the HPO driver: trial
    setup and each epoch boundary). ``timeout_s`` bounds the wait: a
    member that died before contributing raises ``error_cls`` (default
    :class:`~multidisttorch_tpu_torch.parallel.cluster.AgreementTimeout`)
    naming ``what``; None or 0 waits forever.
    """
    failed = _agree_reduce(group, 0 if ok else 1, dist.ReduceOp.SUM, timeout_s, what, error_cls)
    return failed == 0


def group_min_scalar(
    group: TrialGroup,
    value: int,
    *,
    timeout_s: float | None = None,
    what: str = "group min agreement",
    error_cls: type | None = None,
) -> int:
    """The minimum of a per-rank integer over ``group``'s members (a
    multi-rank group's restore step), with :func:`group_all_ok`'s calling
    contract and deadline."""
    return _agree_reduce(group, value, dist.ReduceOp.MIN, timeout_s, what, error_cls)
