"""β-VAE on CIFAR-10, N trials sweeping β — the PyTorch/CUDA port of
``examples/beta_vae_cifar.py`` (same flags and defaults, plus
``--device``).

The HPO driver's scaffolding with the model swapped through
``model_builder`` (``models/conv_vae.py``): trial g trains a ConvVAE with
β = 2^g / 2 (0.5, 1, 2, 4, ...) through the fused ELBO kernels at 3072
logits a row. CIFAR-10 comes from the ``cifar-10-batches-py`` pickles
under ``data/``, else the synthetic stand-in; nothing is downloaded.

One card, one process (the trials' groups share the card, taking turns):
    python -m multidisttorch_tpu_torch.examples.beta_vae_cifar --ngroups 8
One process per card (each group one rank):
    torchrun --nproc-per-node 8 -m multidisttorch_tpu_torch.examples.beta_vae_cifar --ngroups 8
On the CPU at a small size:
    python -m multidisttorch_tpu_torch.examples.beta_vae_cifar --device cpu --ngroups 2 \
        --epochs 1 --synthetic-size 256 --batch-size 32 --base-channels 8
"""

import argparse

from multidisttorch_tpu_torch.data.datasets import load_cifar10
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.models import ConvVAE
from multidisttorch_tpu_torch.parallel.cluster import initialize_runtime, shutdown_runtime
from multidisttorch_tpu_torch.parallel.mesh import default_groups


def main(argv=None):
    parser = argparse.ArgumentParser(description="beta-VAE CIFAR-10 HPO (PyTorch/CUDA port)")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--ngroups", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--latent-dim", type=int, default=64)
    parser.add_argument("--base-channels", type=int, default=32)
    parser.add_argument("--out-dir", default="results-beta-vae")
    parser.add_argument("--synthetic-size", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; with several processes, each rank's own card")
    args = parser.parse_args(argv)

    initialize_runtime(device=args.device)
    train_data = load_cifar10(train=True, synthetic_size=args.synthetic_size)
    test_data = load_cifar10(
        train=False,
        synthetic_size=args.synthetic_size and max(args.batch_size, args.synthetic_size // 6),
    )
    # β sweep: one trial per group, β doubling per trial.
    configs = [
        TrialConfig(trial_id=g, epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                    beta=float(2**g) / 2.0, seed=g)
        for g in range(args.ngroups)
    ]
    try:
        results = run_hpo(
            configs, train_data, test_data,
            groups=default_groups(args.ngroups, args.device),
            out_dir=args.out_dir,
            model_builder=lambda cfg: ConvVAE(latent_dim=args.latent_dim, base_channels=args.base_channels),
        )
    finally:
        shutdown_runtime()
    for r in results:
        print(f"trial {r.trial_id} (beta={r.config.beta}): test loss {r.final_test_loss:.2f}, wall {r.wall_s:.2f}s")
    return results


if __name__ == "__main__":
    main()
