"""Mixture-of-experts VAE HPO over trial groups — the PyTorch/CUDA port of
``examples/moe_vae_hpo.py`` (same flags and defaults, plus ``--device``).

The VAE sweep's scaffolding with the model swapped through
``model_builder`` (``models/moe_vae.py``): trial g's decoder has
``experts_base * 2^g`` experts. On a group of several ranks each rank
routes its share of the batch as the JAX package routes the group's whole
batch (``ops/moe.py``). ``--model-parallel`` above 1, the JAX package's
expert parallelism inside a trial, waits for ROADMAP A.13 and raises.

One card, one process (the trials' groups share the card, taking turns):
    python -m multidisttorch_tpu_torch.examples.moe_vae_hpo --ngroups 2
On the CPU at a small size:
    python -m multidisttorch_tpu_torch.examples.moe_vae_hpo --device cpu --ngroups 2 \
        --epochs 1 --synthetic-size 512 --batch-size 32
"""

import argparse

from multidisttorch_tpu_torch.data.datasets import load_mnist
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.models import MoEVAE
from multidisttorch_tpu_torch.parallel.cluster import initialize_runtime, shutdown_runtime
from multidisttorch_tpu_torch.parallel.mesh import default_groups


def main(argv=None):
    parser = argparse.ArgumentParser(description="MoE-VAE HPO (PyTorch/CUDA port)")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--ngroups", type=int, default=2)
    parser.add_argument("--experts-base", type=int, default=2, help="trial g uses experts-base * 2^g experts")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="model-axis extent per trial group (>1: expert parallelism, ROADMAP A.13)")
    parser.add_argument("--synthetic-size", type=int, default=2048)
    parser.add_argument("--out-dir", default="results-moe")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; with several processes, each rank's own card")
    args = parser.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} (expert parallelism) is not ported yet: ROADMAP A.13 (sharding)")

    initialize_runtime(device=args.device)
    train_data = load_mnist(train=True, synthetic_size=args.synthetic_size)
    test_data = load_mnist(train=False, synthetic_size=max(args.batch_size, args.synthetic_size // 6))
    experts = {g: args.experts_base * (2**g) for g in range(args.ngroups)}
    configs = [
        TrialConfig(trial_id=g, epochs=args.epochs, batch_size=args.batch_size, seed=g, fused_steps=4)
        for g in range(args.ngroups)
    ]
    try:
        results = run_hpo(
            configs, train_data, test_data,
            groups=default_groups(args.ngroups, args.device),
            out_dir=args.out_dir,
            save_images=False,
            model_builder=lambda cfg: MoEVAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim,
                                             num_experts=experts[cfg.trial_id]),
        )
    finally:
        shutdown_runtime()
    for r in results:
        print(f"trial {r.trial_id} ({experts[r.trial_id]} experts): train loss {r.final_train_loss:.4f}, "
              f"test loss {r.final_test_loss:.4f}, wall {r.wall_s:.2f}s")
    return results


if __name__ == "__main__":
    main()
