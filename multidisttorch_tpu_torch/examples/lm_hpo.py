"""Concurrent LM trials, each sequence-parallel on its own group — the
PyTorch/CUDA port of ``examples/lm_hpo.py`` (same flags and defaults, plus
``--device``).

The world is carved into ``--ngroups`` groups, and inside each one a causal
TransformerLM trains with its context split ``T/k`` over the group's ranks
(ring attention, or ring-flash with ``--ring-flash``: the flash kernels in
every hop). Trial ``g``'s learning rate is ``1e-3 · 3^g``; it trains on
fixed windows of the shared periodic corpus drawn with seed ``g`` (so a
final perplexity near 1 is the signal), under the cooperative round-robin:
one dispatch (``--fused-steps`` steps) per trial per cycle, no barriers.
``--moe E`` swaps in the MoE LM. The model is f32, as in the JAX package,
so on a card the flash kernels take their SIMT variant.
``--model-parallel`` above 1 (tensor or expert parallelism inside a trial)
raises naming ROADMAP A.13/A.15g, and ``--pipeline`` (the MPMD plan) naming
A.14.

One card, one trial (a ring of one):
    python -m multidisttorch_tpu_torch.examples.lm_hpo --ngroups 1 --ring-flash
One process per card, or gloo ranks on the CPU (two rings of two):
    torchrun --nproc-per-node 4 -m multidisttorch_tpu_torch.examples.lm_hpo \\
        --device cpu --ngroups 2 --seq-len 64 --steps 12
"""

import argparse
import time

import numpy as np
import torch

from multidisttorch_tpu_torch.data.datasets import synthetic_corpus
from multidisttorch_tpu_torch.models.transformer import MoETransformerLM, TransformerLM, init_lm_params
from multidisttorch_tpu_torch.ops.attention import make_ring_flash_attention
from multidisttorch_tpu_torch.ops.ring_attention import make_ring_attention
from multidisttorch_tpu_torch.parallel.cluster import initialize_runtime, shutdown_runtime
from multidisttorch_tpu_torch.parallel.mesh import default_groups
from multidisttorch_tpu_torch.train.lm import (
    create_lm_state,
    lm_chunk_sharding,
    make_lm_eval_step,
    make_lm_multi_step,
    make_lm_train_step,
)
from multidisttorch_tpu_torch.utils.logging import log0


def main(argv=None):
    parser = argparse.ArgumentParser(description="trial-parallel x sequence-parallel LM sweep (PyTorch/CUDA port)")
    parser.add_argument("--ngroups", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--vocab", type=int, default=32)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--fused-steps", type=int, default=1, metavar="K",
                        help="optimizer steps per dispatch (make_lm_multi_step); must divide --steps")
    parser.add_argument("--ring-flash", action="store_true",
                        help="flash-kernel hops (ops/attention.py) inside each trial's K/V ring")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="model-axis extent per trial (>1: tensor or expert parallelism, ROADMAP A.13/A.15g)")
    parser.add_argument("--moe", type=int, default=0, metavar="E",
                        help="use the MoE transformer with E experts per block")
    parser.add_argument("--pipeline", action="store_true",
                        help="plan an MPMD pipelined LM trial (ROADMAP A.14)")
    parser.add_argument("--dry-run", action="store_true", help="with --pipeline: plan only")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; with several processes, each rank's own card")
    args = parser.parse_args(argv)
    if args.dry_run and not args.pipeline:
        parser.error("--dry-run only applies with --pipeline")
    if args.fused_steps < 1 or args.steps % args.fused_steps:
        parser.error(f"--fused-steps {args.fused_steps} must be >= 1 and divide --steps {args.steps}")
    if args.pipeline:
        raise NotImplementedError(
            "--pipeline (the MPMD pipelined LM trial's plan) is not ported yet: ROADMAP A.14 (pipelines)")
    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} (tensor or expert parallelism inside a trial) is not "
            "ported yet: ROADMAP A.13 (sharding) and A.15g (TP shardings)")

    initialize_runtime(device=args.device)
    try:
        return _run(args)
    finally:
        shutdown_runtime()


def _run(args):
    groups = default_groups(args.ngroups, args.device)
    k = groups[0].size
    if args.seq_len % k:
        raise SystemExit(f"--seq-len must divide by {k} (ranks per {args.ngroups}-group trial)")
    make_attn = make_ring_flash_attention if args.ring_flash else make_ring_attention
    lrs = [1e-3 * (3.0**g) for g in range(args.ngroups)]
    # The shared periodic corpus; each trial samples its own fixed windows
    # (seeded by group id), so trials see distinct data.
    corpus = synthetic_corpus(n=max(65536, 4 * args.seq_len), vocab_size=args.vocab)

    trials = []
    for g, lr in zip(groups, lrs):
        if not g.is_local_member:  # another process's group
            continue
        dims = dict(vocab_size=args.vocab, d_model=args.d_model, num_layers=args.layers, max_len=args.seq_len)
        if args.moe:
            model = MoETransformerLM(**dims, num_experts=args.moe,
                                     attention=make_attn(g, causal=True, shard_heads=False))
        else:
            model = TransformerLM(**dims, attention=make_attn(g, causal=True))
        rows = corpus.batch(np.random.default_rng(g.group_id), args.batch_size, args.seq_len)
        place = lm_chunk_sharding(g, sequence_parallel=True)
        entry = {
            "trial": g, "lr": lr,
            "state": create_lm_state(g, init_lm_params(model, g.group_id), lr),
            "eval": make_lm_eval_step(g, sequence_parallel=True),
            "tokens": place(torch.from_numpy(rows)),
        }
        if args.fused_steps > 1:
            # K steps per dispatch; the demo trains on one fixed batch, so the
            # stacked chunk repeats it.
            entry["step"] = make_lm_multi_step(g, sequence_parallel=True)
            entry["input"] = place(torch.from_numpy(np.broadcast_to(rows, (args.fused_steps,) + rows.shape).copy()))
        else:
            entry["step"] = make_lm_train_step(g, sequence_parallel=True)
            entry["input"] = entry["tokens"]
        trials.append(entry)

    kind = "ring-flash" if args.ring_flash else "ring"
    log0(f"{len(groups)} concurrent {kind} trials; {args.seq_len} tokens "
         f"({args.seq_len // k}/rank inside each {k}-rank ring)")

    # Cooperative round-robin: one dispatch per trial per cycle (K fused
    # steps each under --fused-steps), no barriers.
    t0 = time.time()
    K = args.fused_steps
    interval = 10
    for i in range(args.steps // K):
        for t in trials:
            t["state"], t["m"] = t["step"](t["state"], t["input"])
        # Log the loss of every step a per-step loop would have logged in
        # this chunk, labelled with that step.
        first = i * K
        j = -(-first // interval) * interval  # ceil to the cadence
        while j < first + K:
            for t in trials:
                loss = t["m"]["loss"] if K == 1 else t["m"]["loss"][j - first]
                log0(f"step {j:4d}  loss {float(loss):.4f}", trial=t["trial"])
            j += interval
    for t in trials:  # the last dispatch's losses: the device has finished training
        float(t["m"]["loss"].sum())
    train_s = time.time() - t0

    results = []
    for t in trials:
        ev = t["eval"](t["state"], t["tokens"])
        log0(f"lr={t['lr']:.0e}: final loss {float(ev['loss']):.4f}, "
             f"perplexity {float(ev['perplexity']):.3f}, wall {time.time() - t0:.1f}s", trial=t["trial"])
        results.append({"group": t["trial"].group_id, "lr": t["lr"], "loss": float(ev["loss"]),
                        "perplexity": float(ev["perplexity"]), "steps": args.steps, "train_s": train_s})
    return results


if __name__ == "__main__":
    main()
