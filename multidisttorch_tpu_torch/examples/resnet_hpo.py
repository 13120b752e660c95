"""ResNet-18 classifier HPO over trial groups (BASELINE.md config 4) — the
PyTorch/CUDA port of ``examples/resnet_hpo.py`` (same flags and defaults,
plus ``--device``).

The subgroup machinery with classifier steps (``train/classifier.py``):
trial g trains ResNet-18 with lr = 1e-3·2^g, its train chunks of
``--fused-steps`` steps one CUDA-graph replay each on a one-rank card
group, an epoch's shorter tail chunk step by step through the single
step, the trials taking turns from one host loop; then each trial's test
accuracy over a labelled iterator of the test set.

One card, one process (the trials' groups share the card, taking turns):
    python -m multidisttorch_tpu_torch.examples.resnet_hpo --ngroups 2
On the CPU at a small size:
    python -m multidisttorch_tpu_torch.examples.resnet_hpo --device cpu --ngroups 2 --epochs 1 \
        --base-channels 8 --synthetic-size 512 --batch-size 64
"""

import argparse
import time

from multidisttorch_tpu_torch.data.datasets import load_cifar10
from multidisttorch_tpu_torch.data.sampler import TrialDataIterator
from multidisttorch_tpu_torch.models import ResNet18
from multidisttorch_tpu_torch.parallel.cluster import initialize_runtime, shutdown_runtime
from multidisttorch_tpu_torch.parallel.mesh import default_groups
from multidisttorch_tpu_torch.train.classifier import (
    create_classifier_state,
    make_classifier_eval_step,
    make_classifier_multi_step,
    make_classifier_train_step,
)
from multidisttorch_tpu_torch.utils.logging import log0


def main(argv=None):
    parser = argparse.ArgumentParser(description="ResNet-18 HPO (PyTorch/CUDA port)")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--ngroups", type=int, default=2)
    parser.add_argument("--base-channels", type=int, default=64)
    parser.add_argument("--synthetic-size", type=int, default=None)
    parser.add_argument("--fused-steps", type=int, default=4,
                        help="train steps per dispatch (one CUDA-graph replay on a card)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; with several processes, each rank's own card")
    args = parser.parse_args(argv)

    initialize_runtime(device=args.device)
    train_data = load_cifar10(train=True, synthetic_size=args.synthetic_size)
    test_data = load_cifar10(
        train=False,
        synthetic_size=args.synthetic_size and max(args.batch_size, args.synthetic_size // 6),
    )
    try:
        # The trials' states (DDP reducers on a multi-rank group) live in
        # _sweep's frame and are gone when it returns, before the process
        # group is torn down (ROADMAP C.17).
        return _sweep(args, train_data, test_data)
    finally:
        shutdown_runtime()


def _sweep(args, train_data, test_data) -> list:
    groups = default_groups(args.ngroups, args.device)
    # lr sweep: trial g trains with lr = 1e-3 * 2^g
    lrs = [1e-3 * (2.0**g) for g in range(args.ngroups)]
    trials = []
    for g, lr in zip(groups, lrs):
        if not g.is_local_member:
            continue
        model = ResNet18(num_classes=10, base_channels=args.base_channels)
        trials.append({
            "trial": g, "lr": lr,
            "state": create_classifier_state(g, model, lr, seed=g.group_id),
            "step": make_classifier_multi_step(g),
            "tail_step": make_classifier_train_step(g),
            "eval": make_classifier_eval_step(g),
            "iter": TrialDataIterator(train_data, g, args.batch_size, seed=g.group_id, with_labels=True),
        })

    # Cooperative round robin across the groups, one chunk per turn; an
    # epoch's shorter tail chunk runs step by step through the single
    # step rather than capturing a graph for its length.
    t0 = time.time()
    for epoch in range(args.epochs):
        iters = [t["iter"].epoch_chunks(epoch, args.fused_steps) for t in trials]
        live = list(range(len(trials)))
        while live:
            for i in list(live):
                try:
                    _, images, labels = next(iters[i])
                except StopIteration:
                    live.remove(i)
                    continue
                t = trials[i]
                if images.shape[0] == args.fused_steps:
                    t["state"], m = t["step"](t["state"], images, labels)
                else:
                    for j in range(images.shape[0]):
                        t["state"], m = t["tail_step"](t["state"], images[j], labels[j])
                t["last_metrics"] = m

    out = []
    for t in trials:
        g = t["trial"]
        correct, total = 0.0, 0
        ev_iter = TrialDataIterator(test_data, g, args.batch_size, with_labels=True)
        for images, labels in ev_iter.epoch(0):
            correct += float(t["eval"](t["state"], images, labels)["correct"])
            total += images.shape[0] * g.size
        log0(f"trial {g.group_id} (lr={t['lr']:.0e}): test acc {correct / total:.3f} "
             f"({int(correct)}/{total}), wall {time.time() - t0:.1f}s", trial=g)
        out.append({"trial": g.group_id, "lr": t["lr"], "steps": t["state"].step,
                    "test_accuracy": correct / total, "graph_replays": t["step"].replays})
    return out


if __name__ == "__main__":
    main()
