"""Concurrent VAE HPO trials, one per trial group — the PyTorch/CUDA port of
``examples/vae_hpo.py`` (same flags, plus ``--device``).

N trial groups each train a VAE on MNIST (or its synthetic stand-in when
the IDX files are absent), trial g for ``epochs + g`` epochs, with the fused
ELBO loss through the port's CUDA kernels.

One card, one process:
    python -m multidisttorch_tpu_torch.examples.vae_hpo --ngroups 1 --device cuda
One process per card (each group one rank):
    torchrun --nproc-per-node 4 -m multidisttorch_tpu_torch.examples.vae_hpo --ngroups 2
On the CPU at a small size:
    python -m multidisttorch_tpu_torch.examples.vae_hpo --device cpu --ngroups 1 \
        --epochs 1 --synthetic-size 1024
"""

import argparse

from multidisttorch_tpu_torch.data.datasets import load_mnist
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.parallel.cluster import (
    initialize_runtime,
    process_world,
    shutdown_runtime,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="VAE MNIST Example (PyTorch/CUDA port)")
    parser.add_argument(
        "--batch-size", type=int, default=128, metavar="N",
        help="input batch size for training (default: 128)",
    )
    parser.add_argument(
        "--epochs", type=int, default=3, metavar="N",
        help="number of epochs to train (default: 3)",
    )
    parser.add_argument("--ngroups", type=int, default=2, help="number of groups")
    parser.add_argument("--lr", type=float, default=1e-3, help="Adam lr (vae-hpo.py:131)")
    parser.add_argument("--beta", type=float, default=1.0, help="beta-VAE KL weight")
    parser.add_argument("--out-dir", default="results", help="output root (per-trial subdirs)")
    parser.add_argument(
        "--shard-across-trials", action="store_true",
        help="reproduce the reference's cross-trial data sharding (SURVEY.md Q1)",
    )
    parser.add_argument(
        "--synthetic-size", type=int, default=None,
        help="rows for the synthetic fallback dataset (default: MNIST-sized)",
    )
    parser.add_argument(
        "--fused-steps", type=int, default=10,
        help="train steps per unit of dispatched work (default 10 = the log cadence)",
    )
    parser.add_argument(
        "--eval-sampled", action="store_true",
        help="the reference's sampled-z test loss instead of the posterior-mean eval",
    )
    parser.add_argument(
        "--remat", action="store_true",
        help="rematerialise activations in the backward pass",
    )
    parser.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; with several processes, each rank's own card",
    )
    args = parser.parse_args(argv)

    initialize_runtime(device=args.device)
    nproc, _ = process_world()
    print(f"processes: {nproc}, device: {args.device or 'cuda'}")

    train_data = load_mnist(train=True, synthetic_size=args.synthetic_size)
    test_data = load_mnist(
        train=False,
        synthetic_size=args.synthetic_size and max(args.batch_size, args.synthetic_size // 6),
    )
    configs = [
        TrialConfig(
            trial_id=g,
            epochs=args.epochs + g,
            batch_size=args.batch_size,
            lr=args.lr,
            beta=args.beta,
            seed=g,
            fused_steps=args.fused_steps,
            eval_sampled=args.eval_sampled,
            remat=args.remat,
        )
        for g in range(args.ngroups)
    ]
    try:
        results = run_hpo(
            configs,
            train_data,
            test_data,
            num_groups=args.ngroups,
            device=args.device,
            out_dir=args.out_dir,
            shard_across_trials=args.shard_across_trials,
        )
    finally:
        shutdown_runtime()
    for r in results:
        print(
            f"trial {r.trial_id}: {r.steps} steps, "
            f"final train loss {r.final_train_loss:.4f}, "
            f"test loss {r.final_test_loss:.4f}, wall {r.wall_s:.2f}s "
            f"-> {r.out_dir}"
        )
    return results


if __name__ == "__main__":
    main()
