"""Population-based training of VAEs — the PyTorch/CUDA port of
``examples/pbt_vae.py`` (same flags, plus ``--device``).

One member per trial group by default; ``--fused`` runs the population as
the lanes of one stacked state on one group instead, each generation one
replay of one CUDA graph on a card (``hpo/pbt.py``).

On one card, one process (the per-group members share it):
    python -m multidisttorch_tpu_torch.examples.pbt_vae --population 4 --generations 3
    python -m multidisttorch_tpu_torch.examples.pbt_vae --fused --population 8
One process per card, one member each:
    torchrun --nproc-per-node 4 -m multidisttorch_tpu_torch.examples.pbt_vae --population 4
On the CPU at a small size:
    python -m multidisttorch_tpu_torch.examples.pbt_vae --device cpu --population 2 \
        --generations 2 --steps-per-generation 5 --batch-size 16 --synthetic-size 512
"""

import argparse

from multidisttorch_tpu_torch.data.datasets import load_mnist
from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt
from multidisttorch_tpu_torch.parallel.cluster import initialize_runtime, shutdown_runtime


def main(argv=None):
    parser = argparse.ArgumentParser(description="PBT VAE (PyTorch/CUDA port)")
    parser.add_argument("--population", type=int, default=4)
    parser.add_argument("--generations", type=int, default=3)
    parser.add_argument("--steps-per-generation", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--out-dir", default="results-pbt")
    parser.add_argument("--synthetic-size", type=int, default=None)
    parser.add_argument(
        "--fused", action="store_true",
        help="run the population as lanes of one stacked state, one graph replay per generation, "
        "instead of one member per group",
    )
    parser.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; with several processes, each rank's own card",
    )
    args = parser.parse_args(argv)

    initialize_runtime(device=args.device)
    train_data = load_mnist(train=True, synthetic_size=args.synthetic_size)
    eval_data = load_mnist(
        train=False,
        synthetic_size=args.synthetic_size and max(args.batch_size, args.synthetic_size // 6),
    )
    cfg = PBTConfig(
        population=args.population,
        generations=args.generations,
        steps_per_generation=args.steps_per_generation,
        batch_size=args.batch_size,
    )
    try:
        result = run_pbt(cfg, train_data, eval_data, out_dir=args.out_dir, fused=args.fused, device=args.device)
    finally:
        shutdown_runtime()
    book = result.dispatch_book
    print(
        f"[{result.mode}] best member {result.best_member}: eval loss "
        f"{result.best_eval_loss:.2f}; final lrs "
        f"{['%.1e' % lr for lr in result.final_lrs]}; "
        f"wall {result.wall_s:.1f}s; "
        f"{book.get('dispatches_per_generation')} calls/gen, "
        f"{book.get('graph_replays')} graph replays"
    )
    return result


if __name__ == "__main__":
    main()
