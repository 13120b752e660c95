"""Group carving: one world of ranks → N disjoint trial groups.

Counterpart of ``multidisttorch_tpu/parallel/mesh.py``: ``TrialMesh``
becomes :class:`TrialGroup` and ``setup_groups`` keeps its name, its
contiguous rank blocks and its errors. A rank is a process with one device,
as in the reference (``setup_ddp_groups``); each group of more than one
rank is a ``torch.distributed`` subgroup, and creating it is collective
again: every rank creates every group, member or not.

A single process may also carve its own devices, as the JAX package does on
one host: ``setup_groups(n, devices=[...])`` makes each listed device a
slot and every group local. Groups of one slot train there; a group of
several slots in one process is carved (its metadata is right) but has no
process group, and training on it raises: launch one process per device
instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from multidisttorch_tpu_torch.parallel.cluster import default_device, process_world


@dataclass(frozen=True, eq=False)
class TrialGroup:
    """One carved group of ranks — the analog of a torch process subgroup.

    ``global_ranks`` is a contiguous block of the world. ``device`` is the
    device this process trains the group on (None for a non-member),
    ``local_rank`` this process's rank inside the group (-1 for a
    non-member), and ``pg`` the ``dist.new_group`` handle when the world has
    more than one rank. ``owner_process`` is the process that owns the
    group's first rank: it writes the group's files and log lines.
    """

    group_id: int
    global_ranks: tuple[int, ...]
    device: Optional[torch.device]
    is_local_member: bool
    local_rank: int
    owner_process: int
    pg: Any = None

    @property
    def size(self) -> int:
        """Ranks in this group (``dist.get_world_size(group)``)."""
        return len(self.global_ranks)

    @property
    def is_writer_process(self) -> bool:
        """Whether this process writes the group's images and metrics."""
        return self.is_local_member and self.local_rank == 0

    def __repr__(self) -> str:
        return (
            f"TrialGroup(group_id={self.group_id}, size={self.size}, "
            f"global_ranks={self.global_ranks}, device={self.device})"
        )


def setup_groups(
    num_groups: int,
    devices: Optional[Sequence] = None,
    *,
    device=None,
    allow_uneven: bool = False,
    model_parallel: int = 1,
    pipeline_parallel: int = 1,
) -> list[TrialGroup]:
    """Carve the world into ``num_groups`` contiguous disjoint groups.

    Ranks ``[g*k .. g*k+k-1]`` form group ``g``, and every process gets
    every group's handle. The world is the ``torch.distributed`` world
    (one rank per process, ``device`` naming this process's device: CUDA
    unless ``"cpu"`` is passed), or, in a single process, the listed
    ``devices``. A world that does not divide by ``num_groups`` raises
    unless ``allow_uneven=True`` drops the remainder; more groups than
    ranks raises.
    """
    if model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1 is not ported yet: ROADMAP A.13 (sharding)"
        )
    if pipeline_parallel != 1:
        raise NotImplementedError(
            "pipeline_parallel > 1 is not ported yet: ROADMAP A.14 (pipelines)"
        )
    world, rank = process_world()
    if devices is not None:
        if world > 1:
            raise ValueError(
                "devices= carves one process's own devices; in a multi-process "
                "world every rank owns one device (pass device= instead)"
            )
        slots = [torch.device(d) for d in devices]
        n = len(slots)
    else:
        slots = None
        n = world
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    if n < num_groups:
        raise ValueError(
            f"Number of groups {num_groups} requested exceeds number of "
            f"total ranks {n} available"
        )
    per_group, remainder = divmod(n, num_groups)
    if remainder and not allow_uneven:
        raise ValueError(
            f"World of {n} ranks does not divide into {num_groups} groups "
            f"({remainder} ranks would be orphaned, which in the reference "
            "design hangs the job — SURVEY.md Q5). Pass allow_uneven=True to "
            "deliberately drop the remainder."
        )

    if slots is None:
        this_device = default_device(device)
    groups = []
    for g in range(num_groups):
        ranks = tuple(range(g * per_group, (g + 1) * per_group))
        if slots is not None:
            groups.append(
                TrialGroup(
                    group_id=g,
                    global_ranks=ranks,
                    device=slots[ranks[0]],
                    is_local_member=True,
                    local_rank=0,
                    owner_process=rank,
                )
            )
            continue
        # Collective: every rank creates every group, in the same order.
        pg = dist.new_group(list(ranks)) if world > 1 else None
        member = rank in ranks
        groups.append(
            TrialGroup(
                group_id=g,
                global_ranks=ranks,
                device=this_device if member else None,
                is_local_member=member,
                local_rank=ranks.index(rank) if member else -1,
                owner_process=ranks[0],
                pg=pg,
            )
        )
    return groups


def default_groups(num_groups: int, device=None) -> list[TrialGroup]:
    """``num_groups`` groups for an entry point: carved from the world in a
    multi-process world (one per rank block), else ``num_groups`` one-slot
    groups on this process's device, which share it, their trials taking
    turns."""
    world, _ = process_world()
    if world > 1:
        return setup_groups(num_groups, device=device)
    return setup_groups(num_groups, devices=[default_device(device)] * num_groups)
