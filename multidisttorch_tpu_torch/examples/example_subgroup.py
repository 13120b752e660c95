"""Minimal subgroup demo — the PyTorch port of ``examples/example_subgroup.py``.

The world's ranks split into two contiguous groups, and each group
all-gathers over its own subgroup. Each rank contributes ``--per-rank``
consecutive ids (``rank * per_rank + i``), so four processes with
``--per-rank 2``, like eight with the default of one, print:

    [0:0] subgroup 0 gathered: [0, 1, 2, 3]
    [2:0] subgroup 1 gathered: [4, 5, 6, 7]

Run with any launcher that sets ``WORLD_SIZE``/``RANK`` (torchrun, mpirun,
srun), on CPUs (gloo) with ``--device cpu``:
    torchrun --nproc-per-node 4 -m multidisttorch_tpu_torch.examples.example_subgroup \
        --device cpu --per-rank 2
"""

import argparse

import torch

from multidisttorch_tpu_torch.parallel.cluster import (
    initialize_runtime,
    process_world,
    shutdown_runtime,
)
from multidisttorch_tpu_torch.parallel.collectives import group_all_gather
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.utils.logging import log0


def run(device=None, per_rank: int = 1) -> None:
    world, rank = process_world()
    if world % 2:
        raise ValueError(f"need an even world, got {world} ranks")
    groups = setup_groups(2, device=device)
    for g in groups:
        if not g.is_local_member:
            continue
        contrib = torch.arange(rank * per_rank, (rank + 1) * per_rank, device=g.device)
        gathered = group_all_gather(g, contrib)
        log0(f"subgroup {g.group_id} gathered: {gathered.tolist()}", trial=g)


def main(argv=None):
    parser = argparse.ArgumentParser(description="subgroup all-gather demo")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--per-rank", type=int, default=1, help="ids each rank contributes")
    args = parser.parse_args(argv)
    nproc, _ = initialize_runtime(device=args.device)
    print(f"processes: {nproc}")
    try:
        run(args.device, args.per_rank)
    finally:
        shutdown_runtime()


if __name__ == "__main__":
    main()
