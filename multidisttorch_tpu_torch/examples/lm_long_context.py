"""Long-context LM demo, the ``--flash`` path: the whole sequence on one
device, attention through the flash kernels — the PyTorch/CUDA port of
``examples/lm_long_context.py`` (same flags, plus ``--device``).

A causal TransformerLM trains on a synthetic periodic stream (or a local
file read as bytes) and then decodes a continuation with the KV-cache
sampler, whose prefill runs the flash forward again. With several
processes (torchrun) the batch is split over the group, data parallel.
The device-ring modes (the default, and ``--ring-flash``) are not ported
yet and raise.

One card:
    python -m multidisttorch_tpu_torch.examples.lm_long_context --flash
On the CPU at a small size:
    python -m multidisttorch_tpu_torch.examples.lm_long_context --flash \
        --device cpu --seq-len 64 --steps 20
"""

import argparse
import time

import numpy as np
import torch

from multidisttorch_tpu_torch.models.transformer import TransformerLM, init_lm_params
from multidisttorch_tpu_torch.ops.attention import make_flash_attention
from multidisttorch_tpu_torch.parallel.cluster import (
    initialize_runtime,
    process_world,
    shutdown_runtime,
)
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.lm import _validate_sampling, create_lm_state, make_lm_train_step
from multidisttorch_tpu_torch.train.lm_decode import make_cached_lm_sample


def main(argv=None):
    parser = argparse.ArgumentParser(description="long-context LM demo (PyTorch/CUDA port)")
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--vocab", type=int, default=32)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument(
        "--remat", action="store_true",
        help="per-block activation rematerialization (only block-boundary residuals are kept)",
    )
    parser.add_argument(
        "--flash", action="store_true",
        help="single-device flash attention (ops/attention.py): the whole sequence on one device",
    )
    parser.add_argument(
        "--ring-flash", action="store_true",
        help="K/V ring over the group with flash hops (not ported yet)",
    )
    parser.add_argument(
        "--corpus", type=str, default=None, metavar="FILE",
        help="byte-level model a local file (vocab 256) instead of the synthetic periodic stream",
    )
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="sampling temperature for the final decode (0 = greedy)")
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; with several processes, each rank's own card")
    args = parser.parse_args(argv)
    if args.flash and args.ring_flash:
        parser.error("--flash and --ring-flash are mutually exclusive")
    try:
        _validate_sampling(args.temperature, args.top_k, args.top_p)
    except ValueError as e:
        parser.error(str(e))
    if args.ring_flash:
        raise NotImplementedError("--ring-flash is not ported yet: ROADMAP A.15b (ring-flash)")
    if not args.flash:
        raise NotImplementedError(
            "the default device-ring mode is not ported yet: ROADMAP A.15a (ring attention); "
            "pass --flash"
        )

    initialize_runtime(device=args.device)
    try:
        return _run(args)
    finally:
        shutdown_runtime()


def _run(args):
    _, rank = process_world()
    say = print if rank == 0 else (lambda *a, **k: None)
    (g,) = setup_groups(1, device=args.device)
    say(f"flash attention on {g.device}; {args.seq_len} tokens resident")

    if args.corpus:
        from multidisttorch_tpu_torch.data.datasets import byte_corpus

        corpus = byte_corpus(args.corpus)
        args.vocab = corpus.vocab_size
        say(f"byte-modeling {corpus.name}: {len(corpus):,} tokens, vocab {corpus.vocab_size}")
    else:
        from multidisttorch_tpu_torch.data.datasets import synthetic_corpus

        # Periodic stream: perfectly learnable, so the loss trend is the
        # whole story. Sized from the context so any --seq-len fits.
        corpus = synthetic_corpus(n=max(65536, 4 * args.seq_len), vocab_size=args.vocab, period=16)

    model = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model, num_layers=args.layers,
        max_len=args.seq_len, attention=make_flash_attention(causal=True), remat=args.remat,
    )
    state = create_lm_state(g, init_lm_params(model, seed=0), args.lr)
    step = make_lm_train_step(g)
    if args.batch_size % g.size:
        # the batch splits over the group (plain DP): round it up
        args.batch_size = (args.batch_size // g.size + 1) * g.size
        say(f"batch rounded up to {args.batch_size} (divisible by {g.size} ranks)")
    rows = args.batch_size // g.size
    mine = slice(g.local_rank * rows, (g.local_rank + 1) * rows)
    rng = np.random.default_rng(0)

    t0 = time.time()
    for i in range(args.steps):
        tokens = torch.from_numpy(corpus.batch(rng, args.batch_size, args.seq_len)[mine]).to(g.device)
        state, m = step(state, tokens)
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i:4d}  next-token loss {float(m['loss']):.4f}")
    say(f"done in {time.time() - t0:.1f}s "
        f"(loss should fall well below ln(vocab)={np.log(args.vocab):.2f})")

    # Decode a continuation of a real prompt with the KV-cache sampler.
    sample = make_cached_lm_sample(
        g, model, temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
    )
    prompt_len = args.seq_len // 2
    window = corpus.batch(np.random.default_rng(1), 1, args.seq_len)
    gen = torch.Generator(device=g.device).manual_seed(0)
    out = sample(state, torch.from_numpy(window).to(g.device), prompt_len, gen).cpu().numpy()
    if args.corpus:
        def show(a):
            return bytes(a.tolist()).decode("latin-1")

        say(f"prompt:   {show(out[0, :prompt_len])!r}")
        say(f"decoded:  {show(out[0, prompt_len:])!r}")
    else:
        kind = "greedy" if args.temperature <= 0 else "sampled"
        match = (out[0, prompt_len:] == window[0, prompt_len:]).mean()
        say(f"{kind} decode matches the true continuation at "
            f"{100 * match:.0f}% of generated positions")
    return float(m["loss"]), match if not args.corpus else None


if __name__ == "__main__":
    main()
