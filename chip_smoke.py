"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

0. the backend preflight (``utils/preflight.py``) before this process
   touches CUDA: ``healthy`` (or ``transient_recovered``) with the
   canary's 512.0, the same verdict from its CLI in a child, and
   ``backend_absent`` in under 5 s from a child that sees no card;
1. the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from ``multidisttorch_tpu_torch/ops/csrc`` and
   the data feed's native gatherer from
   ``multidisttorch_tpu_torch/data/csrc/fastloader.cpp`` (``g++``), one
   compiler per source, all started together;
3. each ELBO kernel against its plain PyTorch version (value, the three
   gradients, identical bits on a rerun and on 100 replays of one captured
   call) at four timed shapes, with the kernel's, the plain version's and
   a library call's device time and per-call time (the library calls:
   BCE-with-logits, and its autograd backward with respect to the
   logits), the CUDA-graph replay time, the cold-L2 time, the device
   kernels one call launches (1 each at batch 128), the launch floor (the
   same launch of a build whose kernels return at once, eager and in a
   graph) and the least time the card could take; then at an odd batch, a
   ragged width and unaligned views, untimed, which drive the kernels'
   scalar tails and scalar path;
4. one full-width train step (784-400-20, batch 128) through the fused
   kernels against the plain loss, from the same weights and noise;
5. ``make_multi_step`` as CUDA-graph replays against its eager loop at full
   width, from the same weights, batches and generator seed, in chunks of
   K 10 and 8: losses and parameters bit-identical, one launch of each
   ELBO kernel per step; then ms per step of both, with the device's busy
   time and idle share;
6. the VAE slice: ``run_hpo`` with two trials (1 and 2 epochs) queued on one
   group on ``cuda:0``, MNIST-sized synthetic data, batch 128, its train
   chunks (10 steps) replayed from CUDA graphs; the kernels must have
   launched once per train step, every chunk after a trial's first must
   have been a replay, and the losses must fall; it writes its checkpoints
   (the default) into a temporary directory; then its wall time with
   checkpoints off and on, in rounds off, on, on, off, twice;
7. checkpoints, resume and a supervised retry on that path at full width
   (one trial, fused_steps 10): a straight 2-epoch run; 1 epoch resumed to
   2, bit-identical to it (parameters, Adam moments, step, history,
   generator states) with its graphs captured after the restore and one
   launch of each ELBO kernel per step; a scan-back past torn manifests;
   a failed epoch-2 checkpoint write retried from epoch 1, bit-identical,
   the dropped attempt's graphs freed and device memory back within
   8 MiB; a v1 save and restore on the card with no msgpack, flax or jax
   loaded; each epoch's snapshot and persist times and the second save's
   bytes;
8. each flash-attention kernel (forward, dQ, dK/dV) against its plain
   version (o, lse, dq, dk, dv with an lse cotangent, identical bits on a
   rerun) at the LM's full width (BH 128, T 512, D 64: causal bf16 and f32,
   non-causal f32), timed beside the plain version, the byte/FLOP bound and
   ``scaled_dot_product_attention``; at the bf16 shape, which takes the
   tensor-core (``wgmma``) variants of all three kernels, the SIMT kernels
   of the first port are forced and timed too, in turns with the rest in
   two rounds, and each redesigned kernel once more with a cold L2 (64 MB
   written between launches); then untimed at T 1, 64, 77, 96 and
   200 across head dims 16-256, bf16 and f32, an unaligned bf16 view (which
   must take the SIMT kernels), the padded causal T 1300 (f32 D 32 and bf16
   D 64) and the non-causal T 1300 that must raise, and the autograd path
   with its lse gradient; every call checks which variant it launched;
9. the LM slice at full width (vocab 32768, d 512, 8 heads, 8 layers, T 512,
   batch 16, bf16 compute): ``make_lm_multi_step`` runs 10 steps through the
   flash kernels and, from the same weights, through the dense attention;
   the losses agree and fall and each kernel launches 8 times a step, as
   its tensor-core variant; then the eval step, and
   the f32 KV-cache greedy decode (prompt 256) with the flash prefill (the
   SIMT forward) and with the dense prefill, which must give the same
   tokens; then the step time of both, in four alternating rounds, with the
   device's busy time by kernel;
10. trial stacking at full width (K 8 lanes): (a) the lane-batched ELBO
    kernels against their plain versions at (8, 128, 784, 20) f32, timed
    beside their bound, the plain version and 8 launches of the
    single-trial kernels (whose bits they must equal), and untimed at
    (3, 37, 784, 20) f32, the ragged (3, 37, 783, 5) bf16, (8, 128) bf16
    and phase 11b's (1, 128) and (4, 128) f32;
    a registered generator reseeded in place draws a fresh generator's
    numbers; (b) ``make_stacked_multi_step`` as CUDA-graph replays against
    its eager loop, with a lane retired and one refilled in place between
    chunks: bit-identical, no new capture, then ms per stacked step, the
    device's busy time and kernels; (c) ``run_hpo(stack_trials=True)`` with
    12 configs (mixed lr, beta, 1-2 epochs) on one group, so lanes retire
    and refill: all completed, stacked and finite, each lane kernel once per
    stacked step, lane 0 against its config run unstacked, and the
    aggregate samples/s beside the single-trial slice's;
11. population-based training at full width (784-400-20, batch 128, an
    eval set of 79 batches): (a) the main path, ``run_pbt(fused=True)``
    with 8 lanes, 5 generations of 50 steps: one capture and 5 replays of
    the generation graph, one host fetch per generation, each lane kernel
    once per stacked step, every generation's exploit edges, ms per
    generation and stacked steps/s; the generation graph's first replay
    against the same generation eager from the same state (bit-identical,
    the exchange leaving each lane it did not exploit untouched), and the
    device's busy time and idle share; (b) the per-group mode (4 one-slot
    groups on cuda:0) against the fused mode, population 4, 3 generations,
    the counts set to 0 before each run and read after it (each lane
    kernel 4 x 150 times per group, 150 + 1 fused): eval sums within rel
    1e-3, rankings and exploit edges equal but where the lanes they put
    differently lie within rel 1e-3 of each other (a near-tie, printed); (c) the exchange alone under capture with NaN
    written into lanes' sums through the static tensor it reads: NaN lanes
    last, never a source, each replay equal to the eager exchange; (d) an
    unstacked trial's lr set between chunks (``_set_lr``) drops its graphs,
    and the recaptured chunk equals the eager loop's;
12. the input feed and remat: (a) the native gatherer against the numpy
    gather, byte for byte, at the slice's chunk (10, 128, 784), the sweep's
    (10, 8, 128, 784) and PBT's (50, 8, 128, 784), with host ms per chunk
    (the consumer's blocked time) for the numpy, native, numpy-prefetched
    and native-prefetched paths in turns, and the host-to-device copy of a
    pinned PBT chunk; phases 6, 7, 10c and 11 must have built every train
    iterator on the native path; (b) phase 11a's fused PBT with the feed on
    (its defaults) and off (``use_native=False, prefetch=False``,
    ``MDT_STACKED_PREFETCH=0``) in turns: bit-identical books, lrs and
    lane states, each lane kernel once per stacked step, ms per generation,
    blocked ms per chunk and the idle share; then phase 6's slice with the
    feed on and off in turns: equal results, wall time; (c)
    ``make_multi_step`` graphed with remat off and on at batch 128 and
    8192, and the stacked graphed step at K 8: losses and parameters (and
    the stacked moments and counts) bit-identical, or the first differing
    tensor and rel 1e-6, each ELBO kernel once per step, ms per step and
    the peak of device memory over the first chunk both ways;
14. the model families at full width (run before 13): (a) the conv
    beta-VAE (latent 64, base channels 32, 32x32x3, batch 128): the ELBO
    kernels against their plain versions at (128, 3072, 64) f32, timed,
    and untimed at (100, 3072, 64) f32 and (128, 3072, 64) bf16; one
    fused-vs-plain train step; ``make_multi_step`` graphed against its
    eager loop (K 10, bit-identical under ``cudnn.deterministic``, ms per
    step, device busy, idle share, top kernels; how far two eager runs
    differ under the defaults is printed), then the graphed step under the
    defaults with cuDNN TF32 off and on, in turns; ``run_hpo(model_builder=ConvVAE)``, two trials (beta 0.5
    and 1) of one epoch of ``synthetic_cifar10`` at CIFAR size, counts set
    to 0 before: every chunk but a trial's first a replay, each ELBO kernel
    once per step, a checkpoint per trial; (b) the MoE VAE (784-400-20, 4
    experts, capacity factor 2.0): graphed against eager, then
    ``run_hpo(model_builder=MoEVAE)`` for one epoch at MNIST size, checked
    alike, and a v1 checkpoint round trip on the card; (c) ResNet-18 (base
    channels 64, batch 128) through ``make_classifier_multi_step`` at K 4:
    graphed against eager under ``cudnn.deterministic`` (bit-identical, no
    ELBO launch), ms per step, busy, idle share and top kernels, the
    graphed step with cuDNN TF32 off and on in turns, then 100 graphed
    steps of the ``resnet_hpo`` loop (the loss must fall) and the test
    accuracy over the synthetic test set. Each timing line prints the TF32
    and cuDNN settings it ran under;
15. fault plans, the chaos drill and the event bus (run before 13): (a)
    ``faults.harness.run_chaos_bench`` at the reference's widths (6 trials
    of 784-400-20, batch 128, 4 epochs of 8 steps, chunks of 4): the
    fault-free sweep, then the standard plan with its preemption and the
    driver restart: every fault recovered, the DIVERGE trial diverged with
    its NaN in a replayed chunk, the control and retried trials
    bit-identical to the fault-free run, goodput at least 0.8, every fired
    fault and retry a tagged event of the trace, every attempt's graphs
    freed, the wall times and what each capture cost; (b) the same drill
    stacked (2 buckets of 3 lanes): one capture per bucket, lanes refilled
    in place, the poisoned lane diverged alone, the others bit-identical
    (or within phase 10's rel 1e-3, printed); (c) phase 6's slice with an
    empty plan against none (bit-identical, same replays and host syncs),
    then with telemetry off and on in turns: wall time, events per step and
    device busy; (d) a ConvVAE trial (phase 14a's) crashed mid-epoch 2 and
    retried from its epoch-1 checkpoint: bit-identical under
    ``cudnn.deterministic``, within ``_graph_within_spread``'s bound of the
    uninterrupted runs under the defaults (ROADMAP C.18);
16. compile and dispatch (run before 13; phases 1-15 run with the program
    registry off, ``MDT_AOT_ADMISSION=0``, so they hold the per-trial graphs
    they held before it; 16 turns it on, the port's default): (a) a slot's
    generator takes each trial's stream by value (two trials through one
    slot captured ahead equal their own graphs), then six seed replicas
    (3 seeds x 2 lrs) of the 784-400-20 VAE, one MNIST-sized epoch at batch
    128 in chunks of 10 on two groups, three ways: a fresh registry per
    trial (6 captures), one shared registry (2, the replicas hit) and
    ``precompile=True`` (2, every admission a hit or a wait): losses and
    final checkpoints bit-identical, each trial's admission latency
    printed; (b) a crash in epoch 2 under the farm, the retry resumed
    through its slot, bit-identical to the fault-free run; (c) 12 programs
    captured by farm workers while a stacked bucket replays on the other
    group with the native feed live: the bucket's lanes unchanged; (d) two
    stacked buckets on one group, one capture between them, and a second
    fused PBT run taking the first's generation (cache_hit from generation
    2); (e) eviction under ``MDT_REGISTRY_MAX_PROGRAMS=2`` frees the slot,
    the scan quarantines a truncated ELBO library, the canary passes on the
    real libraries; (f) the cold-start bench's cold, precompiled and
    cache-warm children with its gates;
17. device books, the anomaly monitor and profiling (run before 13, the
    registry on): (a) 16a's six replicas with telemetry off and on, bits
    identical; each trial's FLOPs a step equal to the same step counted on
    CPU copies, its MFU recomputed from the registry, ``bandwidth_bound``,
    its peak memory from ``memory_stats``; a CUDA graph's private pool in
    ``allocated_bytes``; an 8-lane bucket booking the trial's FLOPs a
    lane-step; device busy per step off and on; (b) a 0.5 s ``slow`` fault
    at step 200 with the capture armed: one straggler, one bounded window
    whose trace holds ELBO launches, the trial's bits unchanged; (c)
    ``run_hpo(profile_dir=)`` over 100 steps: the trace's ELBO kernels equal
    the launch counts; ``profile_dir`` with ``precompile=True`` in a child,
    its outcome printed; (d) the conv beta-VAE, MoE VAE and ResNet-18
    examples in children at full width with ``MDT_TELEMETRY=1``: exit 0,
    every trial's MFU, FLOPs a step equal to the CPU count;
18. elastic multi-host (run before 13), every child a process of its own on
    the one card: (a) ``faults.harness.run_chaos_mh_bench`` through the
    port's sweep supervisor and elastic workers: 3 hosts of one group each,
    ``standard_configs(6, 3)`` at 784-400-20, batch 128, 2560 rows (20 steps
    an epoch, chunks of 10), ``host_lost`` on host 1 at its step 30: 2
    worlds, host 1 lost, every trial settled, the recovered trials
    bit-identical to the in-process reference, goodput above 0.5 (printed
    beside the single-host chaos drill's 0.9545), ``host_lost`` and ``world_shrunk``
    traced, the fleet artifacts written, no worker running a compiler, the
    workers' own ELBO launch counts summed over both worlds; the restart
    tax's phases and each world's wall clock printed; (b) a one-process
    sweep (two trials of 4 epochs, a checkpoint an epoch) gets SIGTERM in
    epoch 2: exit 75, ``preempted`` in the ledger, the resumed run loses at
    most the epoch in flight and both final checkpoints equal an
    uninterrupted run's; (c) a 2-process world whose rank 1 never reaches
    ``sync_hosts``: rank 0 raises ``WedgedCollective`` within its 5 s
    deadline plus 2 s and exits 75;
19. the sweep service (run before 13, the registry on): (a) a 4-slot
    service on the card takes two tenants' (2:1) 8 full-width submissions:
    7 of one shape co-pack into stacked buckets (the lane kernels), one of
    another width runs alone (the single kernels), all settle; the lone
    trial bit-identical to ``run_hpo`` of its config and trial id, each
    lane within rel 1e-3 of its unstacked run; the books (queue wait and
    placement latency p50/p99, dispatches, SLO verdicts) printed; (b) a
    trial restored from the RAM snapshot into a registry slot, then replayed,
    bit-identical to the eager loop; a deadline trial preempts a 3-lane
    bucket on a one-slot service, whose lanes snapshot together and end
    within rel 1e-3 of the undisturbed bucket; the defrag drill at full
    width (inside (c)): a size-2 trial places after ``defrag_end`` and the
    migrated victims end bit-identical to their uninterrupted runs; drain
    snapshot against drain persist in ms; (c) ``service.drill.
    run_service_bench`` on the card: a daemon child of
    ``examples/sweep_service.py --device cuda`` serving 48 + 24
    submissions of two tenants, SIGKILLed mid-sweep and restarted, loses no
    submission, goodput >= 0.8 and the fair share
    within 10 % of 2:1; each daemon's ``BOOT`` (its CUDA start) printed;
20. the operator plane (run before 13, the registry on): (a)
    ``service.incident_drill.run_incidents_bench`` on the card: each of the
    eight fault scenarios that need no fabric opens exactly one incident of
    its expected kind and publishes its bundle, the soak opens none, the
    fabric scenarios print as not ported, and the ELBO kernels launch once
    per train step of the drill's sweeps; (b) a telemetry-on ``run_hpo`` of
    four full-width trials (one epoch, chunks of 10) with trials 0-2
    poisoned at step 2: exactly one ``divergence_storm``, naming them;
    trial 3 completes bit-identical (history, losses, graph replays, final
    checkpoint) to trial 3 of the same configs with no plan and telemetry
    off; ``build_incident_report`` gives the same verdict offline; the
    flight ring's length and drops and the detector's events per step
    printed; (c) every console as a child (``python -m
    multidisttorch_tpu_torch.tools.<name>``, no card visible) over
    directories the card wrote: over (b)'s, ``sweep_top`` (text and
    ``--json``), ``ledger_view --json``, ``incident`` list, show and
    report, ``ckpt_gc --dry-run --json`` then a real pass, after which
    trial 3's checkpoint still restores bit-identical; over phase 19's
    kill -9 service directory (rendered inside phase 19), ``sweep_top
    --service --json``, ``ledger_view --queue --json`` and ``sweep_trace
    --json``; over phase 18's run directory (rendered inside phase 18),
    ``sweep_top --fleet --json``; each exits 0 and its JSON agrees with
    its phase's own results;
13. a ``kernels`` JSON line, then the result line.

Exits 1 without a result when CUDA is unavailable or the port is not
beside this script.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32
# non-tensor-core FLOP/s and dense bf16 tensor-core FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 200) -> float:
    """Milliseconds per call over ``iters`` back-to-back calls, between
    CUDA events on the current stream, after at least 50 ms of warm-up."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.05:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name: str = "", iters: int = 50) -> float | None:
    """Device time per call, in ms, of the CUDA kernels whose names contain
    ``name`` (all of them for ""), summed from torch.profiler's CUDA
    activity: the kernels' own time, without the host's per-call cost.
    None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages() if name in e.key)
    return total_us / iters / 1e3 if total_us > 0 else None


def _capture(fn, graph) -> tuple:
    """Run ``fn`` once eagerly on a side stream, then capture one call of
    it into ``graph`` on that same stream, inside an ELBO capture scope (the
    graph's own forward workspace; its launches are not counted); returns
    what the captured call returned and the scope, to keep with the
    graph."""
    from multidisttorch_tpu_torch.ops import elbo as E

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with E.capture_scope() as scope, torch.cuda.graph(graph, stream=side):
        out = fn()
    return out, scope


def graph_ms(fn, iters: int = 50) -> float:
    """Device time per call, in ms, of ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events: no host cost per call, but the
    gaps between the graph's kernels count."""
    graph = torch.cuda.CUDAGraph()
    _, _scope = _capture(lambda: [fn() for _ in range(iters)], graph)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, name: str = "") -> tuple[float, str]:
    """Device ms per call and how it was taken: the profiler's kernel time,
    or, where the profiler saw none, CUDA-graph replay."""
    ms = device_ms(fn, name)
    if ms is not None:
        return ms, "torch.profiler kernel time"
    return graph_ms(fn), "CUDA-graph replay"


def kernels_per_call(fn, iters: int = 20) -> float | None:
    """Device kernels per call of ``fn``, from torch.profiler's CUDA
    activity (copies and memsets left out); None if the profiler saw no
    device activity in three tries."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset")))
        if n:
            return n / iters
    return None


def replays_identical(fn, ref: tuple, replays: int = 100) -> None:
    """Capture one call of ``fn`` in a CUDA graph and check that each of
    ``replays`` replays writes exactly the bits of ``ref`` (the eager
    call's outputs)."""
    graph = torch.cuda.CUDAGraph()
    out, _scope = _capture(fn, graph)
    for r in range(replays):
        for o in out:
            o.zero_()
        graph.replay()
        for i, (a, b) in enumerate(zip(out, ref)):
            check(bool(torch.equal(a, b)), f"graph replay {r}: output {i} differs from the eager call's bits")


def bound_ms(n_bytes: int, n_ops: int, peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 unit in the last place at each value of ``v``."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def kernel_vs_plain(
    E, F, b: int, d: int, lat: int, act_dtype, beta: float = 1.0, *, offset: int = 0, timed: bool = True,
    smi: str = "", floor=None,
) -> dict:
    """Phase 3 at one shape: agreement, determinism and, if ``timed``, times.
    ``offset`` > 0 places every input that many elements into a larger
    buffer: contiguous, but not 16-byte aligned, so the kernels take their
    scalar path. ``floor``, needed when timed, is the ``empty`` build of
    ``ops/elbo_ablation.py``: the same launches with no work."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device="cpu").manual_seed(b * 7 + d)

    def put(t, dtype):
        t = t.to(dev, dtype)
        if offset:
            buf = torch.empty(t.numel() + offset, dtype=dtype, device=dev)
            t = buf[offset:].view(t.shape).copy_(t)
            check(t.is_contiguous() and t.data_ptr() % 16 != 0, "offset view is not unaligned")
        return t

    logits = put(torch.randn(b, d, generator=gen) * 2, act_dtype)
    x = put(torch.rand(b, d, generator=gen), torch.float32)
    mu = put(torch.randn(b, lat, generator=gen), act_dtype)
    logvar = put(torch.randn(b, lat, generator=gen) * 0.5, act_dtype)
    g = torch.tensor(1.0 / b, device=dev)

    v1 = E.elbo_fwd_cuda(logits, x, mu, logvar, beta)
    v2 = E.elbo_fwd_cuda(logits, x, mu, logvar, beta)
    vp = E.elbo_fwd_plain(logits, x, mu, logvar, beta)
    k1 = E.elbo_bwd_cuda(logits, x, mu, logvar, beta, g)
    k2 = E.elbo_bwd_cuda(logits, x, mu, logvar, beta, g)
    kp = E.elbo_bwd_plain(logits, x, mu, logvar, beta, g)
    torch.cuda.synchronize()
    tag = f"({b}, {d}, {lat}) {str(act_dtype).replace('torch.', '')}"
    if offset:
        tag += f", inputs {offset} element(s) off 16-byte alignment"
    rel = abs(float(v1) - float(vp)) / abs(float(vp))
    check(math.isfinite(float(v1)), f"elbo_fwd {tag}: non-finite value")
    check(rel <= 1e-5, f"elbo_fwd {tag}: value {float(v1)} vs plain {float(vp)} (rel {rel:.2e} > 1e-5)")
    check(bool(torch.equal(v1, v2)), f"elbo_fwd {tag}: two runs gave different bits")
    fwd_err = abs(float(v1) - float(vp))
    bwd_err = 0.0
    for name, a, a2, p, primal in zip(("dlogits", "dmu", "dlogvar"), k1, k2, kp, (logits, mu, logvar)):
        check(a.dtype == primal.dtype, f"elbo_bwd {tag}: {name} is {a.dtype}, primal {primal.dtype}")
        check(bool(torch.equal(a, a2)), f"elbo_bwd {tag}: two runs gave different bits in {name}")
        diff = (a.float() - p.float()).abs()
        bwd_err = max(bwd_err, float(diff.max()))
        if a.dtype == torch.float32:
            ok = bool(torch.all(diff <= 1e-6 + 1e-5 * p.float().abs()))
            tol = "rtol 1e-5 / atol 1e-6"
        else:
            ok = bool(torch.all(diff <= bf16_ulp(p)))
            tol = "one bf16 ulp"
        check(ok, f"elbo_bwd {tag}: {name} differs from plain beyond {tol} (max {float(diff.max()):.3e})")
    # 100 replays of one captured call write the eager call's bits.
    replays_identical(lambda: (E.elbo_fwd_cuda(logits, x, mu, logvar, beta),
                               *E.elbo_bwd_cuda(logits, x, mu, logvar, beta, g)), (v1, *k1))
    _, grid, bwd_grid = E._plan(logits, x, mu, logvar)
    route = f"{grid} CTAs of 128"
    if not timed:
        print(f"kernel {tag}: elbo_fwd rel_err={rel:.3e} ({route}) | elbo_bwd max_abs_err={bwd_err:.3e} "
              "| bit-identical reruns and 100 graph replays (not timed)")
        return {}

    # Each input read once, each output written once, and the operations
    # per element counted from the kernels' arithmetic (ops/elbo.py).
    (fwd_ops, fwd_bytes), (bwd_ops, bwd_bytes) = E.elbo_cost(logits, x, mu, logvar)
    fwd_bound, fwd_by = bound_ms(fwd_bytes, fwd_ops)
    bwd_bound, bwd_by = bound_ms(bwd_bytes, bwd_ops)
    lf, xf = logits.float(), x
    lg = lf.detach().requires_grad_()
    bce = F.binary_cross_entropy_with_logits(lg, xf, reduction="sum")
    calls = {
        "fwd": (lambda: E.elbo_fwd_cuda(logits, x, mu, logvar, beta), "elbo_fwd"),
        "fwd_plain": (lambda: E.elbo_fwd_plain(logits, x, mu, logvar, beta), ""),
        # Yardstick for the wide part only; timed here, never called by the port.
        "fwd_library": (lambda: F.binary_cross_entropy_with_logits(lf, xf, reduction="sum"), ""),
        "bwd": (lambda: E.elbo_bwd_cuda(logits, x, mu, logvar, beta, g), "elbo_bwd"),
        "bwd_plain": (lambda: E.elbo_bwd_plain(logits, x, mu, logvar, beta, g), ""),
        # The same part of the backward: the gradient of that sum with
        # respect to the logits, g times sigmoid(logits) - x.
        "bwd_library": (lambda: torch.autograd.grad(bce, lg, g, retain_graph=True), ""),
    }
    # Two times per function: "_ms" is the device's (the kernels' own time,
    # both of elbo_fwd's stages; every kernel of a plain call), "_call_ms"
    # the host's per-call cost included (CUDA events around back-to-back
    # calls).
    times = {}
    for key, (fn, name) in calls.items():
        times[f"{key}_call_ms"] = time_ms(fn)
        times[f"{key}_ms"], times[f"{key}_from"] = device_time(fn, name)
    # The kernels replayed from a CUDA graph: launch gaps included, host not.
    times["fwd_graph_ms"] = graph_ms(calls["fwd"][0])
    times["bwd_graph_ms"] = graph_ms(calls["bwd"][0])
    # Device kernels per call: 1 each.
    times["fwd_kernels_per_call"] = kernels_per_call(calls["fwd"][0])
    times["bwd_kernels_per_call"] = kernels_per_call(calls["bwd"][0])
    # Cold L2: 64 MB written before each call; the filter keeps it out.
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    times["fwd_cold_ms"] = device_ms(lambda: (flush.zero_(), E.elbo_fwd_cuda(logits, x, mu, logvar, beta)), "elbo_fwd")
    times["bwd_cold_ms"] = device_ms(lambda: (flush.zero_(), E.elbo_bwd_cuda(logits, x, mu, logvar, beta, g)), "elbo_bwd")
    del flush
    # The launch floor: each launch as the wrapper makes it (entry, grid,
    # arguments) of kernels that return at once, eager (profiler) and
    # replayed from a graph.
    from multidisttorch_tpu_torch.ops import elbo_ablation

    floor_fwd, floor_bwd = elbo_ablation.launchers(floor, logits, x, mu, logvar, g, beta)
    times["fwd_floor_ms"], times["fwd_floor_from"] = device_time(floor_fwd, "elbo_fwd")
    times["bwd_floor_ms"], times["bwd_floor_from"] = device_time(floor_bwd, "elbo_bwd")
    times["fwd_floor_graph_ms"] = graph_ms(floor_fwd)
    times["bwd_floor_graph_ms"] = graph_ms(floor_bwd)
    times["fwd_route"], times["bwd_grid"] = route, bwd_grid
    print(
        f"kernel {tag}: elbo_fwd kernel_ms={times['fwd_ms']:.6f} call_ms={times['fwd_call_ms']:.6f} "
        f"plain_ms={times['fwd_plain_ms']:.6f} (call {times['fwd_plain_call_ms']:.6f}) "
        f"bound_us={fwd_bound * 1e3:.4f} ({fwd_by}) "
        f"library_ms={times['fwd_library_ms']:.6f} (call {times['fwd_library_call_ms']:.6f}; "
        f"BCE-with-logits sum, wide part) rel_err={rel:.3e} | "
        f"elbo_bwd kernel_ms={times['bwd_ms']:.6f} call_ms={times['bwd_call_ms']:.6f} "
        f"plain_ms={times['bwd_plain_ms']:.6f} (call {times['bwd_plain_call_ms']:.6f}) "
        f"bound_us={bwd_bound * 1e3:.4f} ({bwd_by}) "
        f"library_ms={times['bwd_library_ms']:.6f} (call {times['bwd_library_call_ms']:.6f}; "
        f"BCE-with-logits backward, wide part) max_abs_err={bwd_err:.3e} "
        f"| graph replay per call: elbo_fwd {times['fwd_graph_ms']:.6f} ms, "
        f"elbo_bwd {times['bwd_graph_ms']:.6f} ms "
        f"| cold L2: elbo_fwd {times['fwd_cold_ms']} ms, elbo_bwd {times['bwd_cold_ms']} ms "
        f"| launch floor (same launch, kernels that return at once): elbo_fwd {times['fwd_floor_ms']:.6f} ms eager, "
        f"{times['fwd_floor_graph_ms']:.6f} ms in a graph; elbo_bwd {times['bwd_floor_ms']:.6f} ms eager, "
        f"{times['bwd_floor_graph_ms']:.6f} ms in a graph "
        f"| device kernels per call: elbo_fwd {times['fwd_kernels_per_call']} ({route}), "
        f"elbo_bwd {times['bwd_kernels_per_call']} ({bwd_grid} CTAs of 256) "
        f"| bit-identical reruns and 100 graph replays | device ms from: "
        + ", ".join(f"{k} {times[f'{k}_from']}" for k in calls) + f" ({smi})"
    )
    return {
        **times,
        "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
        "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
        "fwd_err": fwd_err, "bwd_err": bwd_err,
    }


def train_step_fused_vs_plain(group, smi: str) -> None:
    """Phase 4: one full-width step, fused kernels against the plain loss."""
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train.steps import create_train_state, make_train_step

    dev = group.device
    batch = torch.from_numpy(synthetic_mnist(128, seed=5).images).to(dev)
    eps = torch.randn(128, 20, generator=torch.Generator(device="cpu").manual_seed(3)).to(dev)
    out, timing = {}, {}
    for fused in (True, False):
        model = init_vae_params(VAE(), seed=0)
        state = create_train_state(group, model, lr=1e-3)
        step = make_train_step(group, use_fused_loss=fused)
        state, metrics = step(state, batch, eps=eps)
        out[fused] = (float(metrics["loss_sum"]), {k: v.detach().clone() for k, v in state.params.items()})
        # Then the step's time, and how much of it the device is busy.
        ms = time_ms(lambda: step(state, batch, eps=eps), iters=100)
        busy = device_ms(lambda: step(state, batch, eps=eps))
        timing[fused] = (
            f"{ms:.6f} ms/step, device busy not measured, idle share not measured" if busy is None
            else f"{ms:.6f} ms/step, device busy {busy * 1e3:.3f} us/step, idle share {1 - busy / ms:.3f}"
        )
    (lf, pf), (lp, pp) = out[True], out[False]
    rel = abs(lf - lp) / abs(lp)
    check(math.isfinite(lf) and rel <= 1e-5, f"train step: fused loss {lf} vs plain {lp} (rel {rel:.2e})")
    worst = 0.0
    for k in pf:
        diff = (pf[k] - pp[k]).abs()
        check(
            bool(torch.all(diff <= 1e-6 + 1e-4 * pp[k].abs())),
            f"train step: param {k} differs beyond rtol 1e-4 / atol 1e-6 (max {float(diff.max()):.3e})",
        )
        worst = max(worst, float(diff.max()))
    print(f"train step 784-400-20 batch 128: fused loss_sum {lf:.6f} plain {lp:.6f} "
          f"rel {rel:.3e}; params max |diff| {worst:.3e} (rtol 1e-4 / atol 1e-6)")
    print(f"train step 784-400-20 batch 128 fused: {timing[True]} ({smi})")
    print(f"train step 784-400-20 batch 128 plain: {timing[False]} ({smi})")


GRAPH_CHUNKS = (10, 10, 8, 10, 8)  # K per chunk: replays at K 10 and K 8
GRAPH_TIMING_CHUNKS = 20


def graphed_vs_eager(E, group, smi: str) -> dict:
    """Phase 5: ``make_multi_step`` as CUDA-graph replays against its eager
    loop at full width (784-400-20, batch 128): the same initial weights,
    batches and generator seed, chunks of K 10 and 8. The graphed run's
    first chunk is its eager warm-up, its first K-10 and K-8 chunks are
    captured, and the rest replay; losses and parameters must be equal to
    the last bit, and each ELBO kernel must count one launch per step. Then
    ms per step of both in turns, with the device's busy time per step."""
    from torch.profiler import ProfilerActivity, profile

    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train.steps import EagerMultiStep, _build_body, create_train_state, make_multi_step

    dev = group.device
    images = torch.from_numpy(synthetic_mnist(128 * sum(GRAPH_CHUNKS), seed=7).images).to(dev)
    chunks, i = [], 0
    for k in GRAPH_CHUNKS:
        chunks.append(images[128 * i : 128 * (i + k)].reshape(k, 128, *images.shape[1:]))
        i += k
    steps = sum(GRAPH_CHUNKS)
    runs, multis = {}, {}
    for mode in ("eager", "graph"):
        state = create_train_state(group, init_vae_params(VAE(), seed=0), lr=1e-3)
        # The eager loop is built from the step's body directly: the rule
        # in make_multi_step graphs a one-rank group on a card.
        multi = make_multi_step(group) if mode == "graph" else EagerMultiStep(_build_body(group, 1.0, True, 1))
        check(multi.graphed == (mode == "graph"), f"make_multi_step {mode}: graphed is {multi.graphed}")
        gen = torch.Generator(device=dev).manual_seed(1234)
        for k in E.LAUNCHES:
            E.LAUNCHES[k] = 0
        losses = []
        for c in chunks:
            state, m = multi(state, c, generator=gen)
            losses.append(m["loss_sum"])
        torch.cuda.synchronize()
        runs[mode] = (torch.cat(losses), {k: v.detach().clone() for k, v in state.params.items()},
                      dict(E.LAUNCHES), multi.replays, state.step)
        multis[mode] = (multi, state, gen)
        check(state.step == steps, f"{mode}: state.step {state.step}, expected {steps}")
        for k, n in E.LAUNCHES.items():
            want = 0 if k.endswith("_lanes") else steps
            check(n == want, f"{mode}: {k} counted {n} launches in {steps} steps, expected {want}")
    (le, pe, _, _, _), (lg, pg, launches, replays, _) = runs["eager"], runs["graph"]
    check(replays == len(GRAPH_CHUNKS) - 1, f"graph: {replays} replays, expected {len(GRAPH_CHUNKS) - 1}")
    check(bool(torch.isfinite(lg).all()) and lg.shape == (steps,), f"graph: losses {lg}")
    check(bool(torch.equal(le, lg)),
          f"graph vs eager: losses differ (max rel {float(((le - lg).abs() / le.abs()).max()):.3e})")
    for k in pe:
        check(bool(torch.equal(pe[k], pg[k])),
              f"graph vs eager: param {k} differs (max {float((pe[k] - pg[k]).abs().max()):.3e})")
    print(f"graphed multi-step vs eager loop, 784-400-20 batch 128, chunks K {list(GRAPH_CHUNKS)}: "
          f"{steps} losses and every parameter bit-identical; {replays} replays; launches {launches}")

    # Time per step, K 10, in turns (eager, graph, graph, eager).
    per = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        multi, state, gen = multis[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TIMING_CHUNKS):
            state, _ = multi(state, chunks[0], generator=gen)
        torch.cuda.synchronize()
        per[mode].append((time.perf_counter() - t0) / (GRAPH_TIMING_CHUNKS * 10) * 1e3)
    res = {}
    for mode in ("eager", "graph"):
        multi, state, gen = multis[mode]
        # The profiler sometimes drops some of a replay's kernels: a trace
        # counts only if it holds every step's elbo_fwd (one per step), in
        # at most three tries.
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    state, _ = multi(state, chunks[0], generator=gen)
                torch.cuda.synchronize()
            seen = sum(e.count for e in prof.key_averages() if "elbo_fwd" in e.key and e.device_time_total > 0)
            if seen == 50:
                break
        by_kernel = sorted(((e.device_time_total / 50 / 1e3, e.count / 50, e.key) for e in prof.key_averages()
                            if e.device_time_total > 0), reverse=True)
        busy = sum(k[0] for k in by_kernel) if seen == 50 else 0.0  # ms per step
        ms = statistics.fmean(per[mode])
        res[mode] = {"ms_per_step": ms, "rounds": per[mode], "busy_ms": busy or None,
                     "idle": (1 - busy / ms) if busy else None}
        busy_s = (f"device busy not measured, idle share not measured (the profiler saw {seen} of 50 "
                  "elbo_fwd launches)" if not busy
                  else f"device busy {busy * 1e3:.3f} us/step, idle share {1 - busy / ms:.3f}")
        print(f"VAE train step ({mode}{', one CUDA graph per chunk of 10' if mode == 'graph' else ' loop'}): "
              f"{ms:.6f} ms/step (rounds " + ", ".join(f"{v:.6f}" for v in per[mode]) + f"), {busy_s} ({smi})")
        if mode == "graph":
            print(f"VAE train step (graph): {sum(k[1] for k in by_kernel):.0f} device kernels per step; "
                  "device us per step by kernel (launches per step), top 12: "
                  + "; ".join(f"{t * 1e3:.3f} ({n:g}) {key[:60]}" for t, n, key in by_kernel[:12]))
    print(f"VAE train step: graphed {res['eager']['ms_per_step'] / res['graph']['ms_per_step']:.2f}x "
          f"the eager loop's steps per second ({smi})")
    return res


# Flash kernels against their plain versions: the JAX tests' own tolerances
# for f32 (test_pallas_attention.py:28-62); bf16 outputs within one bf16 ulp
# of the plain value, plus the f32 gradient atol for values near zero.
FLASH_TOL = {"fwd": (2e-5, 2e-6), "bwd": (5e-5, 5e-6)}


def _flash_close(what: str, got, ref, kind: str) -> float:
    diff = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        rtol, atol = FLASH_TOL[kind]
        ok = bool(torch.all(diff <= atol + rtol * ref.float().abs()))
        tol = f"rtol {rtol} / atol {atol}"
    else:
        ok = bool(torch.all(diff <= bf16_ulp(ref) + FLASH_TOL["bwd"][1]))
        tol = "one bf16 ulp + 5e-6"
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values")
    check(ok, f"{what}: differs from plain beyond {tol} (max {float(diff.max()):.3e})")
    return float(diff.max())


def flash_variant(dtype, d: int, aligned: bool = True) -> str:
    """The variant that each flash kernel must launch, by this script's
    own rule: the tensor-core one for aligned bf16 at head dim 64 or 128,
    the SIMT kernels for every other input."""
    return "wgmma" if dtype == torch.bfloat16 and d in (64, 128) and aligned else "simt"


def _kernel_name(name: str, variant: str) -> str:
    """The CUDA kernel name of one variant, for the profiler's filter:
    ``flash_fwd_kernel`` and ``flash_fwd_wgmma_kernel`` match only their own."""
    return f"{name}_wgmma_kernel" if variant == "wgmma" else f"{name}_kernel"


L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def flash_vs_plain(
    A, F, bh: int, t: int, d: int, dtype, causal: bool, *, timed: bool = True, offset: int = 0
) -> dict:
    """Phase 8 at one flat shape: the three kernels against the plain
    versions on the same inputs (the backward with a random lse cotangent
    folded into delta), identical bits on a rerun, the variant each call
    launched and, if ``timed``, times. ``offset`` > 0 places every operand
    that many elements into a larger buffer: contiguous, not 16-byte
    aligned."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device="cpu").manual_seed(t * 31 + d + int(causal))

    def put(x):
        x = x.to(dev, dtype)
        if offset:
            buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
            x = buf[offset:].view(x.shape).copy_(x)
            check(x.is_contiguous() and x.data_ptr() % 16 != 0, "offset view is not unaligned")
        return x

    q, k, v, do = (put(torch.randn(bh, t, d, generator=gen)) for _ in range(4))
    g_lse = torch.randn(bh, t, generator=gen).to(dev)
    scale = 1.0 / math.sqrt(d)
    want = flash_variant(dtype, d, aligned=not offset)
    tag = f"({bh}, {t}, {d}) {'causal' if causal else 'non-causal'} {str(dtype).replace('torch.', '')}"
    if offset:
        tag += f", operands {offset} element(s) off 16-byte alignment"

    A.reset_launches()
    o1, l1 = A.flash_fwd_cuda(q, k, v, scale, causal)
    o2, l2 = A.flash_fwd_cuda(q, k, v, scale, causal)
    op, lp = A.flash_fwd_plain(q, k, v, scale, causal)
    delta = ((do.float() * op.float()).sum(-1) - g_lse).contiguous()
    g1 = A.flash_bwd_cuda(q, k, v, do, lp, delta, scale, causal)
    g2 = A.flash_bwd_cuda(q, k, v, do, lp, delta, scale, causal)
    gp = A.flash_bwd_plain(q, k, v, do, lp, delta, scale, causal)
    torch.cuda.synchronize()
    variants = {key: n for key, n in A.LAUNCHES_BY_VARIANT.items() if n}
    expected = {f"flash_fwd:{want}": 2, f"flash_bwd_dq:{want}": 2, f"flash_bwd_dkv:{want}": 2}
    check(variants == expected, f"flash {tag}: launched {variants}, expected {expected}")
    check(o1.dtype == dtype and l1.dtype == torch.float32, f"flash_fwd {tag}: o {o1.dtype}, lse {l1.dtype}")
    errs = {
        "flash_fwd": max(_flash_close(f"flash_fwd {tag} o", o1, op, "fwd"),
                         _flash_close(f"flash_fwd {tag} lse", l1, lp, "fwd")),
        "flash_bwd_dq": _flash_close(f"flash_bwd_dq {tag} dq", g1[0], gp[0], "bwd"),
        "flash_bwd_dkv": max(_flash_close(f"flash_bwd_dkv {tag} dk", g1[1], gp[1], "bwd"),
                             _flash_close(f"flash_bwd_dkv {tag} dv", g1[2], gp[2], "bwd")),
    }
    check(torch.equal(o1, o2) and torch.equal(l1, l2), f"flash_fwd {tag}: two runs gave different bits")
    for name, a, b in zip(("dq", "dk", "dv"), g1, g2):
        check(torch.equal(a, b), f"flash backward {tag}: two runs gave different bits in {name}")
    if not timed:
        print(f"flash {tag}: max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" | bit-identical reruns | every kernel ran {want} (not timed)")
        return {}

    io = q.numel() * q.element_size()
    rows = bh * t * 4
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)  # score entries the mask keeps
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    # Bytes: each input read once, each output written once. Operations:
    # 2 FLOPs per multiply-add of the products over the kept score entries
    # (forward QK^T and PV; dQ adds dO V^T and dS K; dK/dV QK^T, dO V^T,
    # P^T dO and dS^T Q).
    bounds = {
        "flash_fwd": bound_ms(4 * io + rows, 4 * d * pairs, peak),
        "flash_bwd_dq": bound_ms(5 * io + 2 * rows, 6 * d * pairs, peak),
        "flash_bwd_dkv": bound_ms(6 * io + 2 * rows, 8 * d * pairs, peak),
    }
    # The yardstick: one PyTorch call for the same function, timed here and
    # never called by the port. (1, BH, T, D) is the same problem.
    ql, kl, vl = (x.view(1, bh, t, d).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    dol = do.view(1, bh, t, d)
    fwd = lambda **kw: A.flash_fwd_cuda(q, k, v, scale, causal, **kw)
    dq = lambda **kw: A.flash_bwd_dq_cuda(q, k, v, do, lp, delta, scale, causal, **kw)
    dkv = lambda **kw: A.flash_bwd_dkv_cuda(q, k, v, do, lp, delta, scale, causal, **kw)
    calls = {
        "flash_fwd": (fwd, _kernel_name("flash_fwd", want)),
        "flash_bwd_dq": (dq, _kernel_name("flash_bwd_dq", want)),
        "flash_bwd_dkv": (dkv, _kernel_name("flash_bwd_dkv", want)),
        "fwd_plain": (lambda: A.flash_fwd_plain(q, k, v, scale, causal), ""),
        "bwd_plain": (lambda: A.flash_bwd_plain(q, k, v, do, lp, delta, scale, causal), ""),
        "fwd_library": (lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal), ""),
    }
    redesigned = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if want == "wgmma" else ()
    for name in redesigned:
        # The first port's SIMT kernel on the same operands, forced.
        calls[f"{name}_simt"] = (lambda fn=calls[name][0]: fn(_force_simt=True), _kernel_name(name, "simt"))
    # Two rounds in turns, the second in the reverse order; each time is the
    # mean of the two.
    rounds = {key: [] for key in calls}
    with torch.no_grad():
        for r in range(2):
            for key in list(calls) if r == 0 else list(reversed(calls)):
                fn, name = calls[key]
                rounds[key].append((time_ms(fn, iters=50), *device_time(fn, name)))
    times = {}
    for key, got in rounds.items():
        times[f"{key}_call_ms"] = statistics.fmean(g[0] for g in got)
        times[f"{key}_ms"] = statistics.fmean(g[1] for g in got)
        times[f"{key}_ms_rounds"] = [g[1] for g in got]
        times[f"{key}_from"] = got[0][2]
    # Cold L2: 64 MB written before each launch; the profiler's filter keeps
    # the write out of the kernel's time.
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for name in redesigned:
        fn, kname = calls[name]
        times[f"{name}_cold_ms"] = device_ms(lambda fn=fn: (flush.zero_(), fn()), kname)
    # The kernels replayed from a CUDA graph (their launches are capturable).
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        times[f"{key}_graph_ms"] = graph_ms(calls[key][0])
    bwd_library = lambda: torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True)
    times["bwd_library_call_ms"] = time_ms(bwd_library, iters=50)
    times["bwd_library_ms"], times["bwd_library_from"] = device_ms(bwd_library), "torch.profiler kernel time"
    res = {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        kind = "fwd" if name == "flash_fwd" else "bwd"
        res[name] = {
            "variant": want,
            "ms": times[f"{name}_ms"], "call_ms": times[f"{name}_call_ms"], "ms_from": times[f"{name}_from"],
            "ms_rounds": times[f"{name}_ms_rounds"],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "max_abs_err": errs[name],
            "plain_ms": times[f"{kind}_plain_ms"], "plain_call_ms": times[f"{kind}_plain_call_ms"],
            "plain_ms_from": times[f"{kind}_plain_from"],
            "library_ms": times[f"{kind}_library_ms"], "library_call_ms": times[f"{kind}_library_call_ms"],
            "library_ms_from": times[f"{kind}_library_from"], "graph_ms": times[f"{name}_graph_ms"],
        }
        if name in redesigned:
            res[name].update(
                simt_ms=times[f"{name}_simt_ms"], simt_call_ms=times[f"{name}_simt_call_ms"],
                simt_ms_rounds=times[f"{name}_simt_ms_rounds"], cold_ms=times[f"{name}_cold_ms"],
            )
        r = res[name]
        extra = ""
        if name in redesigned:
            extra = (f" simt_ms={r['simt_ms']:.6f} (rounds {r['simt_ms_rounds']}; x{r['simt_ms'] / r['ms']:.2f}) "
                     f"cold_ms={r['cold_ms']} bound_share={r['bound_ms'] / r['ms']:.3f}")
        print(f"flash {tag}: {name} [{r['variant']}] kernel_ms={r['ms']:.6f} (rounds {r['ms_rounds']}) "
              f"call_ms={r['call_ms']:.6f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"plain_ms={r['plain_ms']:.6f} library_ms={r['library_ms']} graph_ms={r['graph_ms']:.6f}"
              f"{extra} max_abs_err={r['max_abs_err']:.3e} ({r['ms_from']})")
    print(f"flash {tag}: plain_ms of the backward rows is one plain backward (dq, dk and dv); "
          "library_ms is scaled_dot_product_attention's forward, or its autograd backward "
          "(dq, dk and dv); simt_ms is the first port's SIMT kernel on the same operands; "
          "times are means of two rounds in turns; bit-identical reruns")
    return res


def flash_autograd_check(A, bh: int, t: int, d: int, causal: bool) -> None:
    """The autograd path on the card: (o, lse) through the kernels,
    differentiated through both outputs, against torch autograd through
    the plain forward (f32)."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device="cpu").manual_seed(17 + t)
    base = [torch.randn(bh, t, d, generator=gen).to(dev) for _ in range(3)]
    do = torch.randn(bh, t, d, generator=gen).to(dev)
    g_lse = torch.randn(bh, t, generator=gen).to(dev)
    scale = 1.0 / math.sqrt(d)
    q, k, v = (x.clone().requires_grad_() for x in base)
    o, lse = A.flash_flat_lse(q, k, v, scale, causal)
    got = torch.autograd.grad([o, lse], [q, k, v], [do, g_lse])
    qr, kr, vr = (x.clone().requires_grad_() for x in base)
    op, lp = A.flash_fwd_plain(qr, kr, vr, scale, causal)
    ref = torch.autograd.grad([op, lp], [qr, kr, vr], [do, g_lse])
    tag = f"flash_flat_lse autograd ({bh}, {t}, {d}) {'causal' if causal else 'non-causal'} f32"
    _flash_close(f"{tag} o", o.detach(), op.detach(), "fwd")
    errs = [_flash_close(f"{tag} d{n}", a, b, "bwd") for n, a, b in zip("qkv", got, ref)]
    print(f"{tag}: grads with the lse cotangent max_abs_err {max(errs):.3e}")


def flash_padding_check(A, dtype=torch.float32, d: int = 32) -> None:
    """The (B, T, H, D) entry at T 1300: causal pads to 1408 and slices back
    (against the plain versions on the unpadded sequence); non-causal raises.
    The reference gradients come from autograd through the plain forward in
    f32, and in bf16 from the plain backward fed the kernel path's own delta
    (``rowsum(dO * o)`` of its bf16 o), as the autograd path forms it."""
    dev = torch.device("cuda:0")
    b, t, h = 1, 1300, 2
    gen = torch.Generator(device="cpu").manual_seed(1300 + d)
    base = [torch.randn(b, t, h, d, generator=gen).to(dev, dtype) for _ in range(3)]
    cot = torch.randn(b, t, h, d, generator=gen).to(dev, dtype)
    scale = 1.0 / math.sqrt(d)
    want = flash_variant(dtype, d)
    q, k, v = (x.clone().requires_grad_() for x in base)
    A.reset_launches()
    o = A.flash_attention(q, k, v, causal=True)
    check(o.shape == q.shape, f"padded flash_attention: shape {tuple(o.shape)}")
    got = torch.autograd.grad(o, [q, k, v], cot)
    torch.cuda.synchronize()
    variants = {key: n for key, n in A.LAUNCHES_BY_VARIANT.items() if n}
    expected = {f"flash_fwd:{want}": 1, f"flash_bwd_dq:{want}": 1, f"flash_bwd_dkv:{want}": 1}
    check(variants == expected, f"padded flash_attention {dtype}: launched {variants}, expected {expected}")
    flat = lambda x: x.transpose(1, 2).reshape(b * h, t, d)
    unflat = lambda x: x.reshape(b, h, t, d).transpose(1, 2)
    if dtype == torch.float32:
        qr, kr, vr = (flat(x).clone().requires_grad_() for x in base)
        op, _ = A.flash_fwd_plain(qr, kr, vr, scale, True)
        ref = torch.autograd.grad(op, [qr, kr, vr], flat(cot))
        op = op.detach()
    else:
        qf, kf, vf, cf = (flat(x).contiguous() for x in (*base, cot))
        op, lp = A.flash_fwd_plain(qf, kf, vf, scale, True)
        delta = (cf.float() * flat(o.detach()).float()).sum(-1)
        ref = A.flash_bwd_plain(qf, kf, vf, cf, lp, delta, scale, True)
    tag = f"flash_attention (1, 1300, 2, {d}) causal {str(dtype).replace('torch.', '')}, padded to 1408"
    err = _flash_close(f"{tag} o", o.detach(), unflat(op), "fwd")
    for n, a, r in zip("qkv", got, ref):
        err = max(err, _flash_close(f"{tag} d{n}", a, unflat(r), "bwd"))
    print(f"{tag}: max_abs_err {err:.3e}; every kernel ran {want}")
    try:
        A.flash_attention(*base, causal=False)
    except ValueError as e:
        check("multiple of 128" in str(e), f"non-causal T 1300 raised the wrong error: {e}")
        print(f"flash_attention (1, 1300, 2, {d}) non-causal: raises ValueError as in the JAX package")
    else:
        fail("flash_attention: non-causal T 1300 did not raise")


LM = dict(vocab_size=32768, d_model=512, num_heads=8, num_layers=8, max_len=512)
LM_BATCH, LM_STEPS, LM_PROMPT = 16, 10, 256
# Largest gap between two f32 logits that counts as a tie in the decode check.
DECODE_TIE = 1e-3
LM_TIMING_ROUNDS = 4


def lm_slice(A, group, smi: str) -> dict:
    """Phase 9: the LM path at full width. Returns each flash kernel's
    launches over the path (train, eval and decode prefill), in total and
    by variant."""
    import numpy as np

    from multidisttorch_tpu_torch.data.datasets import synthetic_corpus
    from multidisttorch_tpu_torch.models.transformer import TransformerLM, init_lm_params
    from multidisttorch_tpu_torch.train.lm import create_lm_state, make_lm_eval_step, make_lm_multi_step
    from multidisttorch_tpu_torch.train.lm_decode import make_cached_lm_sample
    from multidisttorch_tpu_torch.train.steps import TrainState

    dev = group.device
    t = LM["max_len"]
    corpus = synthetic_corpus(n=max(65536, 4 * t), vocab_size=LM["vocab_size"], period=16)
    rng = np.random.default_rng(0)
    chunks = torch.from_numpy(np.stack([corpus.batch(rng, LM_BATCH, t) for _ in range(LM_STEPS)])).to(dev)
    flash_model = init_lm_params(
        TransformerLM(**LM, attention=A.make_flash_attention(causal=True), dtype=torch.bfloat16), seed=0
    )
    plain_model = TransformerLM(**LM, dtype=torch.bfloat16)
    plain_model.load_state_dict(flash_model.state_dict())
    n_params = sum(p.numel() for p in flash_model.parameters())
    states = {"flash": create_lm_state(group, flash_model, 1e-3), "plain": create_lm_state(group, plain_model, 1e-3)}
    multi = make_lm_multi_step(group)

    # The main path, counts set to 0 just before each part and read just after.
    A.reset_launches()
    states["flash"], m_flash = multi(states["flash"], chunks)
    torch.cuda.synchronize()
    train_launches = dict(A.LAUNCHES)
    train_variants = {key: n for key, n in A.LAUNCHES_BY_VARIANT.items() if n}
    states["plain"], m_plain = multi(states["plain"], chunks)
    lf, lp = m_flash["loss"].tolist(), m_plain["loss"].tolist()
    for key in A.LAUNCHES:
        check(train_launches[key] == 8 * LM_STEPS,
              f"LM train: {key} launched {train_launches[key]} times in {LM_STEPS} steps of 8 layers")
    # bf16 activations at head dim 64: every kernel takes its tensor-core
    # variant.
    n = 8 * LM_STEPS
    expected = {"flash_fwd:wgmma": n, "flash_bwd_dq:wgmma": n, "flash_bwd_dkv:wgmma": n}
    check(train_variants == expected, f"LM train: launched {train_variants}, expected {expected}")
    check(all(math.isfinite(x) for x in lf + lp), f"LM train: non-finite loss {lf} / {lp}")
    # bf16 compute: the dense path rounds scores and probabilities to bf16,
    # the flash kernels keep them in f32, so the two trajectories agree to
    # bf16 precision only.
    worst = max(abs(a - b) / abs(b) for a, b in zip(lf, lp))
    check(worst <= 2e-2, f"LM train: flash losses {lf} vs dense {lp} (worst rel {worst:.3e} > 2e-2)")
    check(lf[-1] < lf[0], f"LM train: loss did not fall ({lf[0]} -> {lf[-1]})")
    print(f"LM train ({n_params:,} params, bf16 compute, batch {LM_BATCH} x {t}): flash losses "
          + ", ".join(f"{x:.4f}" for x in lf) + " | dense " + ", ".join(f"{x:.4f}" for x in lp)
          + f" | worst rel {worst:.3e} (limit 2e-2) | launches {train_launches} {train_variants}")

    A.reset_launches()
    ev = make_lm_eval_step(group)(states["flash"], chunks[0])
    torch.cuda.synchronize()
    eval_launches = dict(A.LAUNCHES)
    eval_variants = {key: n for key, n in A.LAUNCHES_BY_VARIANT.items() if n}
    check(eval_launches == {"flash_fwd": 8, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"LM eval: launches {eval_launches}")
    check(eval_variants == {"flash_fwd:wgmma": 8}, f"LM eval: launched {eval_variants}")
    check(math.isfinite(float(ev["loss"])), f"LM eval: non-finite loss {float(ev['loss'])}")
    print(f"LM eval: loss {float(ev['loss']):.4f}, perplexity {float(ev['perplexity']):.2f}; "
          f"launches {eval_launches} {eval_variants}")

    # The f32 cached decode from the trained weights: the flash prefill,
    # then the dense one, on the same state.
    dec = TransformerLM(**LM).to(dev)
    dec.load_state_dict(states["flash"].model.state_dict())
    dec_state = TrainState(model=dec, optimizer=None)
    window = torch.from_numpy(corpus.batch(np.random.default_rng(1), LM_BATCH, t)).to(dev)
    samplers = {
        "flash": make_cached_lm_sample(group, TransformerLM(**LM, attention=A.make_flash_attention(causal=True))),
        "dense": make_cached_lm_sample(group, TransformerLM(**LM)),
    }
    outs, per_token = {}, {}
    A.reset_launches()
    for name, sample in samplers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = sample(dec_state, window, LM_PROMPT)
        torch.cuda.synchronize()
        per_token[name] = (time.perf_counter() - t0) / (t - LM_PROMPT) * 1e3
        if name == "flash":
            decode_launches = dict(A.LAUNCHES)
            decode_variants = {key: n for key, n in A.LAUNCHES_BY_VARIANT.items() if n}
    check(decode_launches == {"flash_fwd": 8, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"LM decode: flash prefill launches {decode_launches}")
    # The decode runs in f32: its prefill takes the SIMT forward.
    check(decode_variants == {"flash_fwd:simt": 8}, f"LM decode: flash prefill launched {decode_variants}")
    out = outs["flash"]
    check(out.shape == window.shape and bool(torch.equal(out[:, :LM_PROMPT], window[:, :LM_PROMPT])),
          "LM decode: the prompt region changed")
    check(bool(((out >= 0) & (out < LM["vocab_size"])).all()), "LM decode: token out of the vocab")
    # The two prefills differ only in f32 rounding inside the attention, so
    # the greedy tokens are equal wherever the top logit is not a tie at f32
    # precision. A barely trained 32768-way head has such ties: where a row
    # splits, the two tokens chosen at its first split must be tied within
    # DECODE_TIE in the dense model's logits at that position (rows are
    # compared only up to their first split: after it the contexts differ).
    splits = []
    for r in (outs["flash"] != outs["dense"]).any(dim=1).nonzero()[:, 0].tolist():
        i = int((outs["flash"][r] != outs["dense"][r]).nonzero()[0, 0])
        with torch.no_grad():
            logits = dec(outs["dense"][r : r + 1, :i])[0, -1]
        a, b = int(outs["flash"][r, i]), int(outs["dense"][r, i])
        gap = abs(float(logits[a] - logits[b]))
        check(gap <= DECODE_TIE, f"LM decode: row {r} splits at {i} between tokens {a} and {b}, "
              f"whose logits differ by {gap:.3e} > {DECODE_TIE}: not a tie")
        splits.append(f"row {r} at {i}, logits {float(logits[a]):.6f} vs {float(logits[b]):.6f}")
    same = "equal" if not splits else (
        f"equal except {len(splits)} row(s) split at an f32 tie ({'; '.join(splits)})")
    match = float((out[:, LM_PROMPT:] == window[:, LM_PROMPT:]).float().mean())
    print(f"LM decode (f32, batch {LM_BATCH}, prompt {LM_PROMPT}, {t - LM_PROMPT} generated): greedy tokens "
          f"{same} with flash and dense prefill; matches the true continuation at {100 * match:.1f}%; "
          f"ms per generated token: flash prefill {per_token['flash']:.3f}, dense prefill "
          f"{per_token['dense']:.3f} ({smi}); launches {decode_launches} {decode_variants}")

    # Step time and device share, after the counted runs. Host-bound times
    # spread between runs, so each mode is timed LM_TIMING_ROUNDS times, in
    # turns (flash, dense, dense, flash, ...); the idle share uses the median.
    from torch.profiler import ProfilerActivity, profile

    step_ms = {"flash": [], "plain": []}
    for r in range(LM_TIMING_ROUNDS):
        for name in ("flash", "plain") if r % 2 == 0 else ("plain", "flash"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[name], _ = multi(states[name], chunks)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) / LM_STEPS * 1e3)
    for name in ("flash", "plain"):
        ms = statistics.median(step_ms[name])
        # One more multi-step under the profiler: device busy time, and the
        # kernels that take it, by name, per step.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            states[name], _ = multi(states[name], chunks)
            torch.cuda.synchronize()
        by_kernel = sorted(((e.device_time_total / LM_STEPS / 1e3, e.key) for e in prof.key_averages()
                            if e.device_time_total > 0), reverse=True)
        busy = sum(ms_k for ms_k, _ in by_kernel)
        busy_s = ("device busy not measured, idle share not measured" if busy == 0 else
                  f"device busy {busy * 1e3:.3f} us/step, idle share {1 - busy / ms:.3f}")
        label = "flash kernels" if name == "flash" else "dense attention"
        print(f"LM train step ({label}): median {ms:.6f} ms/step of "
              + ", ".join(f"{x:.6f}" for x in step_ms[name]) + f"; {busy_s} ({smi})")
        print(f"LM train step ({label}) device ms per step by kernel, top 10: "
              + "; ".join(f"{ms_k:.3f} {key[:70]}" for ms_k, key in by_kernel[:10]))
    totals = {key: train_launches[key] + eval_launches[key] + decode_launches[key] for key in A.LAUNCHES}
    by_variant = {key: sum(c.get(key, 0) for c in (train_variants, eval_variants, decode_variants))
                  for key in A.LAUNCHES_BY_VARIANT}
    return totals, by_variant


def _same_checkpoint(ck, a_dir: str, b_dir: str, what: str, trial_id: int = 0) -> None:
    """Two runs' final checkpoints hold the same state, bit for bit: every
    leaf, and the sidecar's step, history and generator states."""
    def load(d):
        path = os.path.join(d, f"trial-{trial_id}", "state.msgpack")
        with open(path + ".json") as f:
            return ck._read_tree(path), json.load(f)

    def flat(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: tree}
        out = {prefix: "{}"} if not tree else {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out

    (ta, ma), (tb, mb) = load(a_dir), load(b_dir)
    fa, fb = flat(ta), flat(tb)
    check(list(fa) == list(fb), f"{what}: the checkpoint trees differ in their keys")
    for k in fa:
        if isinstance(fa[k], str):
            continue
        check(fa[k].dtype == fb[k].dtype and (fa[k] == fb[k]).all(), f"{what}: {k} differs from the straight run")
    for key in ("step", "completed_epochs", "history", "torch_generators"):
        check(ma[key] == mb[key], f"{what}: the sidecar's {key} differs from the straight run")


def _warm_pool_streams(device) -> None:
    """Give every stream of PyTorch's pool its cuBLAS workspace, which lives
    as long as the process, so that a later ``memory_allocated`` reading
    holds a run's own tensors only."""
    import gc

    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params

    x = torch.rand(128, 784, device=device)
    m = init_vae_params(VAE(), 0).to(device)
    for _ in range(32):
        with torch.cuda.stream(torch.cuda.Stream(device)):
            m(x, eps=torch.zeros(128, 20, device=device))[0].sum().backward()
    del m, x
    gc.collect()
    torch.cuda.synchronize()


def checkpoint_phase(E, group, smi: str, train, test) -> None:
    """Phase 7: checkpoints, resume and a supervised retry on the VAE main
    path at full width (784-400-20, batch 128, fused_steps 10, one group on
    the card, so every chunk after a trial's first is a graph replay):

    (a) a straight 2-epoch run, ``ckpt_keep_last=2``, format v2;
    (b) 1 epoch, then ``resume=True`` to 2 epochs: parameters, Adam moments,
        step, history and generator states bit-identical to (a); the resumed
        trial captures its graphs after the restore, and each ELBO kernel
        launches once per resumed step (counts set to 0 just before);
    (c) a copy of (a) with the newest manifests (the primary and its
        retained copy) truncated, resumed with ``resume="scan"`` to 3
        epochs: it scans back to epoch 1 and finishes;
    (d) the epoch-2 checkpoint write fails once under ``resilient=True``
        and one retry: attempt 2 resumes from epoch 1 with new graphs and
        ends bit-identical to (a); the dropped attempt's graphs are freed
        and ``torch.cuda.memory_allocated`` returns within 8 MiB of its
        figure before (every pool stream is first given its cuBLAS
        workspace, which lives as long as the process);
    (e) a v1 save and restore of a state on the card through
        ``train/_msgpack.py``; no msgpack, flax or jax module is loaded.

    Times: each epoch's snapshot (host copies, on the loop thread) and
    persist (serialise and write, on the writer thread), and the bytes of
    (a)'s second save.
    """
    import gc
    import shutil
    import tempfile
    import weakref

    from multidisttorch_tpu_torch.hpo import driver
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train import checkpoint as ck
    from multidisttorch_tpu_torch.train.steps import create_train_state, make_train_step

    per_epoch = len(train) // 128
    chunks = -(-per_epoch // 10)  # an epoch's chunks of 10 steps; the first of a trial is eager
    real_tree, real_save, real_multi = driver.train_state_to_tree, driver.save_state, driver.make_multi_step
    snaps, persists, fail_epochs, multis = [], [], set(), []

    def timed_tree(state):
        t0 = time.perf_counter()
        out = real_tree(state)
        snaps.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_save(tree, path, **kw):
        epoch = kw["metadata"]["completed_epochs"]
        if epoch in fail_epochs:
            fail_epochs.discard(epoch)
            raise OSError(f"injected failure of the epoch-{epoch} checkpoint write")
        stats = {}
        t0 = time.perf_counter()
        out = real_save(tree, path, stats_out=stats, **kw)
        persists.append({"epoch": epoch, "ms": (time.perf_counter() - t0) * 1e3, **stats})
        return out

    def tracked_multi(g, **kw):
        m = real_multi(g, **kw)
        multis.append(weakref.ref(m))
        return m

    driver.train_state_to_tree, driver.save_state, driver.make_multi_step = timed_tree, timed_save, tracked_multi
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def sweep(name, epochs, **kw):
                cfg = driver.TrialConfig(trial_id=0, epochs=epochs, batch_size=128, seed=0, fused_steps=10)
                (r,) = driver.run_hpo([cfg], train, test, groups=[group], out_dir=os.path.join(tmp, name),
                                      ckpt_keep_last=2, verbose=False, **kw)
                check(r.status in ("completed", "resumed_complete"), f"phase 7 ({name}): {r.status} {r.error}")
                return r

            # (a) straight.
            snaps.clear()
            persists.clear()
            a = sweep("a", 2)
            torch.cuda.synchronize()
            check(a.steps == 2 * per_epoch and a.graph_replays == 2 * chunks - 1,
                  f"(a): {a.steps} steps, {a.graph_replays} replays")
            check(len(snaps) == 2 and [p["epoch"] for p in persists] == [1, 2] and persists[0]["format"] == "v2",
                  f"(a): snapshots {snaps}, persists {persists}")
            for ms, p in zip(snaps, persists):
                print(f"checkpoint epoch {p['epoch']}: snapshot {ms:.3f} ms (loop thread), persist "
                      f"{p['ms']:.3f} ms (writer thread), {p['total_bytes']} bytes: {p['new_bytes']} new, "
                      f"{p['reused_bytes']} reused, {p['chunks']} chunks ({smi})")
            second = persists[1]
            check(second["total_bytes"] == second["new_bytes"] + second["reused_bytes"] > 0,
                  f"(a): second save's bytes {second}")

            # (b) 1 epoch, then resumed to 2; counts set to 0 just before.
            sweep("b", 1)
            for k in E.LAUNCHES:
                E.LAUNCHES[k] = 0
            b = sweep("b", 2, resume=True)
            torch.cuda.synchronize()
            launches = dict(E.LAUNCHES)
            check(b.resumed_from_step == per_epoch and b.steps == 2 * per_epoch and b.history == a.history,
                  f"(b): resumed from {b.resumed_from_step}, {b.steps} steps, history {b.history} vs {a.history}")
            check(b.graph_replays == chunks - 1,
                  f"(b): {b.graph_replays} graph replays in the resumed epoch, expected {chunks - 1}")
            for k in ("elbo_fwd", "elbo_bwd"):
                check(launches[k] == per_epoch, f"(b): {k} launched {launches[k]} times in {per_epoch} resumed steps")
            _same_checkpoint(ck, os.path.join(tmp, "a"), os.path.join(tmp, "b"), "(b) resume")
            print(f"(b) resume: epoch 2 from the epoch-1 checkpoint, bit-identical to (a); "
                  f"{b.graph_replays} replays; launches {launches}")

            # (c) the newest manifests torn; the scan lands on epoch 1.
            shutil.copytree(os.path.join(tmp, "a"), os.path.join(tmp, "c"))
            for name in ("state.msgpack", f"state.msgpack.v{2 * per_epoch:010d}"):
                path = os.path.join(tmp, "c", "trial-0", name)
                with open(path, "r+b") as f:
                    f.truncate(os.path.getsize(path) // 2)
            c = sweep("c", 3, resume="scan")
            check(c.resumed_from_step == per_epoch and c.steps == 3 * per_epoch and len(c.history) == 3
                  and c.history[0] == a.history[0] and c.graph_replays == 2 * chunks - 1,
                  f"(c): resumed from {c.resumed_from_step}, {c.steps} steps, {c.graph_replays} replays")
            print(f"(c) scan: past the torn epoch-2 manifests to epoch 1, then epochs 2-3, "
                  f"test {c.final_test_loss:.4f}")

            # (d) a failed write and one retry. Every pool stream first gets
            # its cuBLAS workspace, so what is left after is the run's own.
            _warm_pool_streams(group.device)
            before = torch.cuda.memory_allocated(group.device)
            multis.clear()
            fail_epochs.add(2)
            d = sweep("d", 2, resilient=True, retry=RetryPolicy(max_retries=1, backoff_base_s=0.01))
            gc.collect()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated(group.device)
            check(not fail_epochs, "(d): the injected write failure did not fire")
            check(d.attempt == 2 and d.resumed_from_step == per_epoch and d.history == a.history
                  and d.graph_replays == chunks - 1,
                  f"(d): attempt {d.attempt}, resumed from {d.resumed_from_step}, {d.graph_replays} replays")
            _same_checkpoint(ck, os.path.join(tmp, "a"), os.path.join(tmp, "d"), "(d) retry")
            check(len(multis) == 2 and all(r() is None for r in multis),
                  f"(d): {sum(r() is not None for r in multis)} of {len(multis)} multi-steps (and their graphs) alive")
            check(after - before <= 8 << 20, f"(d): memory_allocated grew by {after - before} bytes across the retry")
            print(f"(d) retry: attempt 2 from epoch 1, bit-identical to (a); both attempts' graphs freed; "
                  f"memory_allocated {before} -> {after} bytes (margin 8 MiB) ({smi})")

            # (e) v1 on the card.
            step = make_train_step(group)
            s1 = create_train_state(group, init_vae_params(VAE(), 1), 1e-3)
            gen = torch.Generator(device=group.device).manual_seed(5)
            for _ in range(2):
                s1, _ = step(s1, torch.rand(128, 784, device=group.device, generator=gen), generator=gen)
            path = os.path.join(tmp, "e", "state.msgpack")
            ck.save_state(s1, path, metadata={"step": s1.step}, format="v1")
            with open(path, "rb") as f:
                check(f.read(1) == b"\x83", "(e): not a v1 msgpack file")
            s2 = create_train_state(group, init_vae_params(VAE(), 2), 1e-3)
            ck.restore_state(s2, path)
            t1, t2 = ck.train_state_to_tree(s1), ck.train_state_to_tree(s2)
            check(all((t1["params"][n][k] == t2["params"][n][k]).all()
                      and (t1["opt_state"]["0"][m][n][k] == t2["opt_state"]["0"][m][n][k]).all()
                      for n in t1["params"] for k in ("bias", "kernel") for m in ("mu", "nu"))
                  and s2.step == s1.step == 2, "(e): the v1 restore differs from the saved state")
            check(all(st["step"].device == group.device for st in s2.optimizer.state.values()),
                  "(e): Adam's restored step is not on the card")
            loaded = [m for m in sys.modules if m.split(".")[0] in ("msgpack", "flax", "jax", "multidisttorch_tpu")]
            check(not loaded, f"(e): {loaded} imported")
            print("(e) v1: saved and restored on the card through train/_msgpack.py, bit-identical; "
                  "no msgpack, flax or jax module loaded")
    finally:
        driver.train_state_to_tree, driver.save_state, driver.make_multi_step = real_tree, real_save, real_multi


STACK_LANES = 8  # stack_max_lanes, the JAX package's default
STACK_CHUNKS = (10, 10, 8, 10)  # steps per chunk; lane 3 retires and lane 5 refills before the third
STACK_TIMING_CHUNKS = 20
# Lane 0's final epoch losses, stacked against the same config run unstacked
# on the card: the same noise, weights and batches; bmm against mm and Adam
# on stacked tensors round differently, and 468 steps carry the difference.
STACK_LOSS_RTOL = 1e-3


def lane_kernel_vs_plain(E, lanes: int, b: int, d: int, lat: int, act_dtype, *, timed: bool = True,
                         smi: str = "") -> dict:
    """Phase 10(a) at one shape: the lane-batched ELBO kernels against their
    plain versions (value rel 1e-5 per lane; gradients rtol 1e-5 / atol 1e-6
    in f32, one bf16 ulp in bf16), identical bits on a rerun and on 100
    graph replays, and against ``lanes`` launches of the single-trial
    kernels on the lanes' slices (the same bits where every slice is 16-byte
    aligned); if ``timed``, times."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device="cpu").manual_seed(lanes * 1000 + b * 7 + d)
    logits = (torch.randn(lanes, b, d, generator=gen) * 2).to(dev, act_dtype)
    x = torch.rand(lanes, b, d, generator=gen).to(dev)
    mu = torch.randn(lanes, b, lat, generator=gen).to(dev, act_dtype)
    logvar = (torch.randn(lanes, b, lat, generator=gen) * 0.5).to(dev, act_dtype)
    beta = torch.linspace(0.5, 4.0, lanes).to(dev)
    g = torch.full((lanes,), 1.0 / b, device=dev)
    args = (logits, x, mu, logvar, beta)

    v1, v2, vp = E.elbo_fwd_lanes_cuda(*args), E.elbo_fwd_lanes_cuda(*args), E.elbo_fwd_lanes_plain(*args)
    k1, k2, kp = E.elbo_bwd_lanes_cuda(*args, g), E.elbo_bwd_lanes_cuda(*args, g), E.elbo_bwd_lanes_plain(*args, g)
    singles_v = torch.stack([E.elbo_fwd_cuda(logits[j], x[j], mu[j], logvar[j], float(beta[j])) for j in range(lanes)])
    singles_k = [E.elbo_bwd_cuda(logits[j], x[j], mu[j], logvar[j], float(beta[j]), g[j]) for j in range(lanes)]
    torch.cuda.synchronize()
    tag = f"lanes ({lanes}, {b}, {d}, {lat}) {str(act_dtype).replace('torch.', '')}"
    check(v1.shape == (lanes,) and bool(torch.isfinite(v1).all()), f"elbo_fwd_lanes {tag}: {v1}")
    rel = float(((v1 - vp).abs() / vp.abs()).max())
    check(rel <= 1e-5, f"elbo_fwd_lanes {tag}: value vs plain rel {rel:.2e} > 1e-5")
    check(bool(torch.equal(v1, v2)), f"elbo_fwd_lanes {tag}: two runs gave different bits")
    fwd_err = float((v1 - vp).abs().max())
    bwd_err = 0.0
    for name, a, a2, p, primal in zip(("dlogits", "dmu", "dlogvar"), k1, k2, kp, (logits, mu, logvar)):
        check(a.dtype == primal.dtype, f"elbo_bwd_lanes {tag}: {name} is {a.dtype}, primal {primal.dtype}")
        check(bool(torch.equal(a, a2)), f"elbo_bwd_lanes {tag}: two runs gave different bits in {name}")
        diff = (a.float() - p.float()).abs()
        bwd_err = max(bwd_err, float(diff.max()))
        if a.dtype == torch.float32:
            ok, tol = bool(torch.all(diff <= 1e-6 + 1e-5 * p.float().abs())), "rtol 1e-5 / atol 1e-6"
        else:
            ok, tol = bool(torch.all(diff <= bf16_ulp(p))), "one bf16 ulp"
        check(ok, f"elbo_bwd_lanes {tag}: {name} differs from plain beyond {tol} (max {float(diff.max()):.3e})")
    same = bool(torch.equal(v1, singles_v)) and all(
        bool(torch.equal(k1[i][j], singles_k[j][i])) for i in range(3) for j in range(lanes))
    aligned = all((n * t.element_size()) % 16 == 0 for n, t in ((b * d, logits), (b * d, x), (b * lat, mu), (b * lat, logvar)))
    if aligned:
        check(same, f"lane kernels {tag}: not bit-identical to {lanes} launches of the single-trial kernels")
    replays_identical(lambda: (E.elbo_fwd_lanes_cuda(*args), *E.elbo_bwd_lanes_cuda(*args, g)), (v1, *k1))
    _, grid, bwd_grid = E._plan(logits, x, mu, logvar)
    launch = f"{grid} x {lanes} CTAs of 128 | {bwd_grid} x {lanes} CTAs of 256"
    if not timed:
        print(f"kernel {tag}: elbo_fwd_lanes rel_err={rel:.3e} | elbo_bwd_lanes max_abs_err={bwd_err:.3e} ({launch}) "
              f"| bit-identical reruns and 100 graph replays | {lanes} single-trial launches: "
              f"{'the same bits' if same else 'not the same bits'} (slices {'' if aligned else 'not '}all aligned)")
        return {}
    (fwd_ops, fwd_bytes), (bwd_ops, bwd_bytes) = E.elbo_cost(logits, x, mu, logvar, beta)
    fwd_bound, fwd_by = bound_ms(fwd_bytes, fwd_ops)
    bwd_bound, bwd_by = bound_ms(bwd_bytes, bwd_ops)
    calls = {
        "fwd": (lambda: E.elbo_fwd_lanes_cuda(*args), "elbo_fwd_lanes"),
        "fwd_plain": (lambda: E.elbo_fwd_lanes_plain(*args), ""),
        "fwd_singles": (lambda: [E.elbo_fwd_cuda(logits[j], x[j], mu[j], logvar[j], 1.0) for j in range(lanes)], "elbo_fwd"),
        "bwd": (lambda: E.elbo_bwd_lanes_cuda(*args, g), "elbo_bwd_lanes"),
        "bwd_plain": (lambda: E.elbo_bwd_lanes_plain(*args, g), ""),
        "bwd_singles": (lambda: [E.elbo_bwd_cuda(logits[j], x[j], mu[j], logvar[j], 1.0, g[j]) for j in range(lanes)], "elbo_bwd"),
    }
    times = {}
    for key, (fn, name) in calls.items():
        times[f"{key}_call_ms"] = time_ms(fn)
        times[f"{key}_ms"], times[f"{key}_from"] = device_time(fn, name)
        if key in ("fwd", "bwd", "fwd_singles", "bwd_singles"):
            times[f"{key}_graph_ms"] = graph_ms(fn)
    times["fwd_kernels_per_call"] = kernels_per_call(calls["fwd"][0])
    times["bwd_kernels_per_call"] = kernels_per_call(calls["bwd"][0])
    print(
        f"kernel {tag}: elbo_fwd_lanes kernel_ms={times['fwd_ms']:.6f} call_ms={times['fwd_call_ms']:.6f} "
        f"graph_ms={times['fwd_graph_ms']:.6f} plain_ms={times['fwd_plain_ms']:.6f} "
        f"{lanes} single launches ms={times['fwd_singles_ms']:.6f} (graph {times['fwd_singles_graph_ms']:.6f}) "
        f"bound_us={fwd_bound * 1e3:.4f} ({fwd_by}) rel_err={rel:.3e} | "
        f"elbo_bwd_lanes kernel_ms={times['bwd_ms']:.6f} call_ms={times['bwd_call_ms']:.6f} "
        f"graph_ms={times['bwd_graph_ms']:.6f} plain_ms={times['bwd_plain_ms']:.6f} "
        f"{lanes} single launches ms={times['bwd_singles_ms']:.6f} (graph {times['bwd_singles_graph_ms']:.6f}) "
        f"bound_us={bwd_bound * 1e3:.4f} ({bwd_by}) max_abs_err={bwd_err:.3e} "
        f"| device kernels per call: {times['fwd_kernels_per_call']}, {times['bwd_kernels_per_call']} ({launch}) "
        f"| bit-identical reruns, 100 graph replays and {lanes} single-trial launches | device ms from: "
        + ", ".join(f"{k} {times[f'{k}_from']}" for k in calls) + f" ({smi})"
    )
    return {**times, "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by, "bwd_bound_ms": bwd_bound,
            "bwd_bound_by": bwd_by, "fwd_err": fwd_err, "bwd_err": bwd_err, "launch": launch}


def reseeded_generator_check() -> None:
    """A generator registered with a CUDA graph and reseeded in place (a
    lane's refill) draws, in the next replays, what a fresh generator of
    that seed draws."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(11)
    out = torch.empty(128, 20, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(torch.randn(128, 20, generator=gen, device=dev))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=side):
        out.copy_(torch.randn(128, 20, generator=gen, device=dev))
    graph.replay()
    graph.replay()
    gen.manual_seed(77)
    got = []
    for _ in range(2):
        graph.replay()
        got.append(out.clone())
    fresh = torch.Generator(device=dev).manual_seed(77)
    want = [torch.randn(128, 20, generator=fresh, device=dev) for _ in range(2)]
    check(all(bool(torch.equal(a, w)) for a, w in zip(got, want)),
          "a registered generator reseeded in place does not draw a fresh generator's numbers in the next replays")
    print("registered generator reseeded in place: the next 2 replays draw a fresh generator's numbers, bit for bit")


def stacked_graph_vs_eager(E, group, smi: str) -> dict:
    """Phase 10(b): ``make_stacked_multi_step`` as CUDA-graph replays
    against its eager loop at full width (784-400-20, batch 128, K 8 lanes
    with mixed lr and beta), from the same weights, batches and generator
    seeds, chunks of 10 and 8; before the third chunk lane 3 retires
    (``active`` 0) and lane 5 refills (new weights written in place, new
    hypers, its generator reseeded), identically in both runs. Losses,
    parameters, moments and step counts must be bit-identical, the retired
    lane frozen, two graphs captured (no capture for the refill), each lane
    kernel launched once per step. Then ms per stacked step of both in
    turns, the device's busy time and its kernels."""
    from torch.profiler import ProfilerActivity, profile

    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train.steps import (
        EagerStackedMultiStep,
        TrialHypers,
        _build_stacked_body,
        create_stacked_train_state,
        make_lane_ops,
        make_stacked_multi_step,
    )

    dev, lanes = group.device, STACK_LANES
    rows = 128 * lanes
    images = torch.from_numpy(synthetic_mnist(rows * sum(STACK_CHUNKS), seed=9).images).to(dev)
    chunks, i = [], 0
    for s in STACK_CHUNKS:
        chunks.append(images[rows * i : rows * (i + s)].reshape(s, lanes, 128, -1))
        i += s
    steps = sum(STACK_CHUNKS)
    lrs = [1e-3, 2e-3, 5e-4, 1e-3, 3e-3, 1e-3, 2e-3, 1e-3]
    betas = [1.0, 1.0, 2.0, 4.0, 1.0, 0.5, 1.0, 3.0]
    _, write = make_lane_ops(group)
    runs, kept = {}, {}
    for mode in ("eager", "graph"):
        state = create_stacked_train_state(group, [init_vae_params(VAE(), s) for s in range(lanes)])
        hypers = TrialHypers.stack(lrs, betas, device=dev)
        gens = [torch.Generator(device=dev).manual_seed(1000 + j) for j in range(lanes)]
        multi = (make_stacked_multi_step(group) if mode == "graph"
                 else EagerStackedMultiStep(_build_stacked_body(group, True, 1)))
        check(multi.graphed == (mode == "graph"), f"make_stacked_multi_step {mode}: graphed is {multi.graphed}")
        for k in E.LAUNCHES:
            E.LAUNCHES[k] = 0
        losses, frozen = [], None
        for ci, c in enumerate(chunks):
            if ci == 2:
                hypers.set_lane(3, 1e-3, 1.0, 0.0)
                write(state, init_vae_params(VAE(), 99), 5)
                hypers.set_lane(5, 4e-3, 2.0, 1.0)
                gens[5].manual_seed(4242)
                # Detached: a view of a parameter with a grad_fn would keep its
                # AccumulateGrad node (made on this stream) alive into the capture.
                frozen = ({k: v.detach()[3].clone() for k, v in state.params.items()}, float(state.count[3]))
            state, m = multi(state, hypers, c, generators=gens)
            losses.append(m["loss_sum"])
        torch.cuda.synchronize()
        runs[mode] = (torch.cat(losses), {k: v.detach().clone() for k, v in state.params.items()},
                      [t.clone() for t in state.exp_avg + state.exp_avg_sq], state.count.clone(), dict(E.LAUNCHES))
        kept[mode] = (multi, state, hypers, gens)
        check(all(bool(torch.equal(v[3], frozen[0][k])) for k, v in state.params.items())
              and float(state.count[3]) == frozen[1], f"{mode}: the retired lane 3 moved")
        for k, n in E.LAUNCHES.items():
            want = steps if k.endswith("_lanes") else 0
            check(n == want, f"stacked {mode}: {k} counted {n} launches in {steps} steps, expected {want}")
    (le, pe, me, ce, _), (lg, pg, mg, cg, launches) = runs["eager"], runs["graph"]
    graphed = kept["graph"][0]
    check(graphed.replays == len(STACK_CHUNKS) - 1 and len(graphed._graphs) == 2,
          f"stacked graph: {graphed.replays} replays, {len(graphed._graphs)} graphs")
    check(bool(torch.isfinite(lg).all()) and lg.shape == (steps, lanes), f"stacked graph: losses {lg.shape}")
    check(bool(torch.equal(le, lg)), f"stacked graph vs eager: losses differ (max {float((le - lg).abs().max()):.3e})")
    for k in pe:
        check(bool(torch.equal(pe[k], pg[k])), f"stacked graph vs eager: param {k} differs")
    check(all(bool(torch.equal(a, b)) for a, b in zip(me, mg)) and bool(torch.equal(ce, cg)),
          "stacked graph vs eager: Adam's moments or step counts differ")
    print(f"stacked multi-step K {lanes} lanes vs eager loop, 784-400-20 batch 128, chunks {list(STACK_CHUNKS)}, "
          f"lane 3 retired and lane 5 refilled before the third: {steps} x {lanes} losses, every parameter, "
          f"moment and step count bit-identical; retired lane frozen; {graphed.replays} replays of "
          f"{len(graphed._graphs)} graphs; launches {launches}; counts {cg.tolist()}")

    per = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        multi, state, hypers, gens = kept[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STACK_TIMING_CHUNKS):
            state, _ = multi(state, hypers, chunks[0], generators=gens)
        torch.cuda.synchronize()
        per[mode].append((time.perf_counter() - t0) / (STACK_TIMING_CHUNKS * 10) * 1e3)
    res = {}
    for mode in ("eager", "graph"):
        multi, state, hypers, gens = kept[mode]
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    state, _ = multi(state, hypers, chunks[0], generators=gens)
                torch.cuda.synchronize()
            seen = sum(e.count for e in prof.key_averages() if "elbo_fwd_lanes" in e.key and e.device_time_total > 0)
            if seen == 50:
                break
        by_kernel = sorted(((e.device_time_total / 50 / 1e3, e.count / 50, e.key) for e in prof.key_averages()
                            if e.device_time_total > 0), reverse=True)
        busy = sum(k[0] for k in by_kernel) if seen == 50 else 0.0
        ms = statistics.fmean(per[mode])
        res[mode] = {"ms_per_step": ms, "busy_ms": busy or None, "idle": (1 - busy / ms) if busy else None,
                     "by_kernel": by_kernel}
        busy_s = (f"device busy not measured, idle share not measured (the profiler saw {seen} of 50 "
                  "elbo_fwd_lanes launches)" if not busy
                  else f"device busy {busy * 1e3:.3f} us/step, idle share {1 - busy / ms:.3f}")
        print(f"stacked VAE train step, K {lanes} lanes ({mode}{', one CUDA graph per chunk of 10' if mode == 'graph' else ' loop'}): "
              f"{ms:.6f} ms/step (rounds " + ", ".join(f"{v:.6f}" for v in per[mode]) + f"), {busy_s}, "
              f"{lanes * 128 / ms * 1e3:.1f} samples/s ({smi})")
        if mode == "graph":
            print(f"stacked VAE train step (graph): {sum(k[1] for k in by_kernel):.0f} device kernels per step; "
                  "device us per step by kernel (launches per step), top 14: "
                  + "; ".join(f"{t * 1e3:.3f} ({n:g}) {key[:60]}" for t, n, key in by_kernel[:14]))
    return res


def stacked_sweep(E, group, smi: str, train, test, slice_samples_s: float) -> dict:
    """Phase 10(c), the main path of trial stacking: ``run_hpo`` with 12
    configs (mixed lr and beta, 1 or 2 epochs) on one group with
    ``stack_trials=True`` and K 8 lanes, so lanes retire and refill; counts
    set to 0 just before, read just after. Every result completed,
    stacked and finite; each lane kernel launched once per stacked step;
    then lane 0's config run unstacked, its final losses within
    ``STACK_LOSS_RTOL``. Returns the launches."""
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo

    per_epoch = len(train) // 128
    configs = [
        TrialConfig(trial_id=i, epochs=1 + i % 2, batch_size=128, seed=i, fused_steps=10,
                    lr=(1e-3, 2e-3, 5e-4)[i % 3], beta=(1.0, 2.0, 0.5, 4.0)[i % 4])
        for i in range(12)
    ]
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        results = run_hpo(configs, train, test, groups=[group], out_dir=tmp, stack_trials=True,
                          stack_max_lanes=STACK_LANES, verbose=False)
        torch.cuda.synchronize()
        sweep_s = time.time() - t0
        launches = dict(E.LAUNCHES)
        check(all(os.path.exists(r.checkpoint) for r in results), "stacked sweep: a lane checkpoint is missing")
    # 8 lanes: round 1 runs configs 0-7; the 1-epoch ones retire and 8-11
    # refill; round 2 retires 1, 3, 5, 7, 8 and 10; round 3 runs 9 and 11
    # with six lanes masked.
    rounds = 3
    check(len(results) == 12, f"stacked sweep: {len(results)} results")
    for r in results:
        check(r.status == "completed" and r.stacked, f"trial {r.trial_id}: {r.status} stacked={r.stacked} {r.error}")
        check(r.steps == r.config.epochs * per_epoch and len(r.history) == r.config.epochs,
              f"trial {r.trial_id}: {r.steps} steps, {len(r.history)} epochs")
        check(math.isfinite(r.final_train_loss) and math.isfinite(r.final_test_loss),
              f"trial {r.trial_id}: non-finite losses {r.final_train_loss} {r.final_test_loss}")
        check(r.host_syncs == 2 * r.config.epochs, f"trial {r.trial_id}: {r.host_syncs} host syncs")
    stacked_steps = rounds * per_epoch
    for k in ("elbo_fwd_lanes", "elbo_bwd_lanes"):
        check(launches[k] == stacked_steps, f"stacked sweep: {k} launched {launches[k]} times in {stacked_steps} stacked steps")
    # Lane 0's config, unstacked through the graphed single-trial path.
    with tempfile.TemporaryDirectory() as tmp:
        (u,) = run_hpo([configs[0]], train, test, groups=[group], out_dir=tmp, verbose=False, save_checkpoints=False)
    s0 = results[0]
    rel_train = abs(s0.final_train_loss - u.final_train_loss) / abs(u.final_train_loss)
    rel_test = abs(s0.final_test_loss - u.final_test_loss) / abs(u.final_test_loss)
    check(rel_train <= STACK_LOSS_RTOL and rel_test <= STACK_LOSS_RTOL,
          f"lane 0 vs unstacked: train {s0.final_train_loss} vs {u.final_train_loss} (rel {rel_train:.2e}), "
          f"test {s0.final_test_loss} vs {u.final_test_loss} (rel {rel_test:.2e}), tolerance {STACK_LOSS_RTOL}")
    lane_samples = sum(r.steps for r in results) * 128
    for r in results:
        print(f"stacked trial {r.trial_id}: lr {r.config.lr} beta {r.config.beta} {r.steps} steps, "
              f"train {r.final_train_loss:.4f}, test {r.final_test_loss:.4f}, {r.graph_replays} replays in its lifetime")
    print(f"stacked sweep: 12 configs, K {STACK_LANES} lanes, {rounds} rounds of {per_epoch} stacked steps in "
          f"{sweep_s:.3f} s (eval, 12 checkpoints and 3 captures included): {lane_samples / sweep_s:.1f} aggregate "
          f"train samples/s against the single-trial graphed slice's {slice_samples_s:.1f}; launches {launches} ({smi})")
    print(f"lane 0 vs the same config unstacked: train {s0.final_train_loss:.6f} vs {u.final_train_loss:.6f} "
          f"(rel {rel_train:.3e}), test {s0.final_test_loss:.6f} vs {u.final_test_loss:.6f} (rel {rel_test:.3e}); "
          f"tolerance rel {STACK_LOSS_RTOL}")
    return launches


# Phase 11, population-based training at full width (784-400-20, batch 128,
# MNIST-sized data, so the eval set is 79 batches). 11a is the main path.
PBT_FUSED = dict(population=8, generations=5, steps_per_generation=50, batch_size=128, lr_min=1e-4, lr_max=1e-2,
                 perturb_factors=(0.8, 1.25), exploit_fraction=0.25)
PBT_PER_GROUP = dict(PBT_FUSED, population=4, generations=3)
# Per-group members against the fused lanes on the card: a generation's eval
# sums within the stacked-vs-unstacked tolerance of phase 10c (batched
# products of one lane and of K round differently, and 150 steps carry it).
PBT_EVAL_RTOL = STACK_LOSS_RTOL


def _pbt_snapshot(state, hypers, gens) -> tuple:
    """Copies, on the card, of what a generation changes: every state
    tensor, the lrs and the generators' states."""
    from multidisttorch_tpu_torch.hpo.pbt import _state_tensors

    return [t.detach().clone() for t in _state_tensors(state)], hypers.lr.clone(), [g.get_state() for g in gens]


def _pbt_restore(snap, state, hypers, gens) -> None:
    from multidisttorch_tpu_torch.hpo.pbt import _state_tensors

    with torch.no_grad():
        for t, s in zip(_state_tensors(state), snap[0]):
            t.copy_(s)
        hypers.lr.copy_(snap[1])
    for g, s in zip(gens, snap[2]):
        g.set_state(s)


def _pbt_state(state, hypers) -> list:
    from multidisttorch_tpu_torch.hpo.pbt import _state_tensors

    return [t.detach().clone() for t in _state_tensors(state)] + [hypers.lr.clone()]


def _pbt_same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def _pbt_run_counted(E, what: str, cfg, train, test, **kw) -> tuple:
    """``run_pbt`` with the launch counts set to 0 just before and read just
    after: each lane kernel once per stacked step of every member or
    generation (``warmups`` more steps run on a scratch copy before a
    capture), the single-trial kernels never. Returns the result, the
    counts and the wall seconds."""
    from multidisttorch_tpu_torch.hpo import run_pbt

    warmups = kw.pop("warmups")
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    t0 = time.time()
    res = run_pbt(cfg, train, test, verbose=False, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(E.LAUNCHES)
    steps = cfg.generations * cfg.steps_per_generation
    for k, n in launches.items():
        want = (steps + warmups) * (cfg.population if what == "per-group" else 1) if k.endswith("_lanes") else 0
        check(n == want, f"{what} PBT (population {cfg.population}): {k} launched {n} times, expected {want}")
    return res, launches, wall


def pbt_fused_path(E, group, smi: str, train, test) -> dict:
    """Phase 11a, the main path: ``run_pbt(fused=True)``, population 8, 5
    generations of 50 steps, counts set to 0 just before and read just
    after. One capture and 5 replays, one host fetch per generation, each
    lane kernel once per stacked step (and once in the warm-up step on a
    scratch copy before the capture); every generation's exploit edges;
    ms per generation and graphed stacked steps/s."""
    from multidisttorch_tpu_torch.hpo import PBTConfig

    cfg = PBTConfig(**PBT_FUSED)
    # Each lane kernel once per stacked step of the 5 replays, and once in
    # the warm-up before the capture (one step on a scratch copy).
    res, launches, _ = _pbt_run_counted(E, "fused", cfg, train, test, warmups=1, groups=[group], fused=True)
    book = res.dispatch_book
    G, S = cfg.generations, cfg.steps_per_generation
    check(book["captures"] == 1 and book["graph_replays"] == G and book["program_calls"] == G,
          f"fused PBT: {book['captures']} captures, {book['graph_replays']} replays, {book['program_calls']} calls "
          f"in {G} generations")
    check(book["host_fetches"] == G, f"fused PBT: {book['host_fetches']} host fetches in {G} generations")
    check(len(res.history) == G and all(math.isfinite(s) for h in res.history for s in h["loss_sums"]),
          "fused PBT: a generation's eval sums are missing or not finite")
    best = [min(h["loss_sums"]) for h in res.history]
    check(best[-1] < best[0], f"fused PBT: the best eval sum did not fall ({best[0]} -> {best[-1]})")
    for h in res.history:
        print(f"PBT fused gen {h['generation']}: order {h['order']}, best eval loss {min(h['scores'].values()):.4f}, "
              "exploits " + (", ".join(f"{e['from']}->{e['to']} lr {e['new_lr']:.6e}" for e in h["exploits"])
                             or "none"))
    gen_ms = [s * 1e3 for s in book["generation_s"]]
    steady = statistics.median(gen_ms[1:])
    print(f"PBT fused (K {cfg.population}, {G} generations x {S} steps, eval {-(-len(test) // 128)} batches): "
          f"ms per generation {', '.join(f'{v:.3f}' for v in gen_ms)} (the first captures); median of the later "
          f"{steady:.3f} ms, {S / steady * 1e3:.1f} graphed stacked steps/s, "
          f"{S * cfg.population * 128 / steady * 1e3:.1f} train samples/s; {book['host_fetches']} host fetches, "
          f"{book['captures']} capture, {book['graph_replays']} replays; final lrs "
          f"{['%.3e' % v for v in res.final_lrs]}; launches {launches} ({smi})")
    return {"launches": launches, "ms_per_generation": steady, "generation_ms": gen_ms}


def pbt_generation_checks(group, smi: str, train, test, ms_per_generation: float) -> dict:
    """Phase 11a, the generation graph at the main path's config: its first
    replay against the same generation run eagerly from the same state, bit
    for bit (books, parameters, moments, counts, lrs), the exchange leaving
    each lane it did not exploit as train and eval left it and giving each
    lane it did exploit its source's bits; then the device's busy time per
    generation from torch.profiler (kept only when the trace holds every
    step's elbo_fwd_lanes) and the idle share against the main path's ms
    per generation."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator
    from multidisttorch_tpu_torch.hpo import PBTConfig
    from multidisttorch_tpu_torch.hpo._threefry import pbt_explore_key, pbt_perturb_factors
    from multidisttorch_tpu_torch.hpo.pbt import (
        _init_lrs,
        _init_model,
        _noise_seed,
        _place_eval,
        _stage_eval_host,
        _state_tensors,
        n_exploit_for,
    )
    from multidisttorch_tpu_torch.train.steps import (
        TrialHypers,
        _build_stacked_body,
        _pack_pbt_books,
        create_stacked_train_state,
        fetch_pbt_books,
        make_pbt_generation_step,
        make_stacked_eval_scan,
        pbt_exchange,
        pbt_train_eval,
    )

    cfg = PBTConfig(**PBT_FUSED)
    K, S, dev = cfg.population, cfg.steps_per_generation, group.device
    kw = dict(n_exploit=n_exploit_for(cfg), lr_min=cfg.lr_min, lr_max=cfg.lr_max)
    state = create_stacked_train_state(group, [_init_model(cfg, cfg.seed + k) for k in range(K)])
    hypers = TrialHypers.stack([float(v) for v in _init_lrs(cfg)], [cfg.beta] * K, device=dev)
    gens = [torch.Generator(device=dev).manual_seed(_noise_seed(cfg.seed, k, 0)) for k in range(K)]
    chunks = StackedTrialDataIterator(train, group, 128, [cfg.seed + k for k in range(K)]).stream_chunks(S)
    eval_b, eval_w = _place_eval(group, *_stage_eval_host(test, group, 128)[:2])
    factors = torch.from_numpy(pbt_perturb_factors(pbt_explore_key(cfg.seed), 0, K, cfg.perturb_factors)).to(dev)
    gen_step = make_pbt_generation_step(group, **kw)
    check(gen_step.graphed, "make_pbt_generation_step on cuda:0 is not graphed")
    batches = next(chunks)
    snap = _pbt_snapshot(state, hypers, gens)
    graph_books = fetch_pbt_books(gen_step(state, hypers, batches, eval_b, eval_w, factors, gens), K)
    check(gen_step.captures == 1 and gen_step.replays == 1,
          f"PBT generation: {gen_step.captures} captures, {gen_step.replays} replays after the first call")
    graph_after = _pbt_state(state, hypers)
    _pbt_restore(snap, state, hypers, gens)
    body, eval_scan = _build_stacked_body(group, True, 1), make_stacked_eval_scan(group)
    train_sums, eval_sums = pbt_train_eval(body, eval_scan, state, hypers, batches, eval_b, eval_w, gens)
    before = [t.detach().clone() for t in _state_tensors(state)]
    books = pbt_exchange(state, hypers, eval_sums, factors, **kw)
    eager_books = fetch_pbt_books(_pack_pbt_books(books, train_sums, eval_sums), K)
    eager_after = _pbt_state(state, hypers)
    for name in eager_books:
        check(np.array_equal(graph_books[name], eager_books[name]),
              f"PBT generation: graph replay vs eager, {name} differ: {graph_books[name]} vs {eager_books[name]}")
    check(_pbt_same(graph_after, eager_after), "PBT generation: graph replay vs eager, the state after differs")
    src, exploited = eager_books["src"], eager_books["exploited"]
    check(bool(exploited.any()), f"PBT generation 0 exploited no lane (sums {eager_books['eval_loss_sum']})")
    for t_before, t_after in zip(before, eager_after):
        for lane in range(K):
            check(bool(torch.equal(t_after[lane], t_before[int(src[lane])])),
                  f"PBT exchange: lane {lane} (exploited {bool(exploited[lane])}, src {src[lane]}) does not hold "
                  "its source's state")
    kept = [lane for lane in range(K) if not exploited[lane]]
    print(f"PBT generation graph (K {K}, {S} steps, {eval_b.shape[0]} eval batches, exchange): first replay vs the "
          "same generation eager from the same state: books, parameters, moments, counts and lrs bit-identical; "
          f"edges {[(int(src[j]), j) for j in range(K) if exploited[j]]}; lanes {kept} untouched by the exchange, "
          "the exploited ones their sources' bits")

    # Device busy per generation: two replays under the profiler, the trace
    # kept only when it holds every step's elbo_fwd_lanes.
    busy, seen = 0.0, 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fetch_pbt_books(gen_step(state, hypers, next(chunks), eval_b, eval_w, factors, gens), K)
            torch.cuda.synchronize()
        seen = sum(e.count for e in prof.key_averages() if "elbo_fwd_lanes" in e.key and e.device_time_total > 0)
        if seen == 2 * S:
            busy = sum(e.device_time_total for e in prof.key_averages()) / 2 / 1e3
            break
    by_kernel = sorted(((e.device_time_total / 2 / 1e3, e.count / 2, e.key) for e in prof.key_averages()
                        if e.device_time_total > 0), reverse=True)
    busy_s = (f"device busy not measured, idle share not measured (the profiler saw {seen} of {2 * S} "
              "elbo_fwd_lanes launches)" if not busy else
              f"device busy {busy:.3f} ms per generation, idle share {1 - busy / ms_per_generation:.3f} of the "
              f"main path's {ms_per_generation:.3f} ms")
    print(f"PBT fused generation: {busy_s}; {sum(k[1] for k in by_kernel):.0f} device kernels per generation; "
          "device ms per generation by kernel (launches), top 10: "
          + "; ".join(f"{t:.3f} ({n:g}) {key[:50]}" for t, n, key in by_kernel[:10]) + f" ({smi})")
    return {"busy_ms": busy or None, "idle": (1 - busy / ms_per_generation) if busy else None}


def pbt_exchange_under_capture(group) -> None:
    """Phase 11c: ``pbt_exchange`` alone in a CUDA graph at full width (K 8),
    reading its eval sums and factors from static tensors. A NaN written into
    a lane's sum ranks it last, makes it a target and never a source; two
    replays with different sums each equal the eager exchange from the same
    state, bit for bit."""
    import copy

    from multidisttorch_tpu_torch.hpo import PBTConfig
    from multidisttorch_tpu_torch.hpo.pbt import _init_model
    from multidisttorch_tpu_torch.train.steps import TrialHypers, create_stacked_train_state, pbt_exchange

    cfg, K, dev = PBTConfig(**PBT_FUSED), 8, group.device
    state = create_stacked_train_state(group, [_init_model(cfg, 100 + k) for k in range(K)])
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for t in state.exp_avg + state.exp_avg_sq:
            t.copy_(torch.rand(t.shape, generator=gen).to(dev))
        state.count.copy_(torch.arange(K, dtype=torch.float32, device=dev) + 1)
    hypers = TrialHypers.stack([1e-3 * (k + 1) for k in range(K)], [1.0] * K, device=dev)
    sums = torch.arange(K, dtype=torch.float32, device=dev)
    factors = torch.tensor([0.8, 1.25] * (K // 2), device=dev)
    kw = dict(n_exploit=2, lr_min=cfg.lr_min, lr_max=cfg.lr_max)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up, on copies
        pbt_exchange(copy.deepcopy(state), TrialHypers(hypers.lr.clone(), hypers.beta, hypers.active), sums,
                     factors, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        books = pbt_exchange(state, hypers, sums, factors, **kw)
    nan = float("nan")
    # Lane 2 would rank first but for its NaN; then two NaN lanes and a tie.
    for case in ([9.0, 5.0, nan, 7.0, 3.0, 2.0, 6.0, 4.0], [3.0, nan, 8.0, 1.0, 2.0, 2.0, nan, 0.5]):
        sums.copy_(torch.tensor(case, device=dev))
        snap = _pbt_snapshot(state, hypers, [])
        graph.replay()
        torch.cuda.synchronize()
        got = {k: v.clone() for k, v in books.items()}
        got_state = _pbt_state(state, hypers)
        _pbt_restore(snap, state, hypers, [])
        want = pbt_exchange(state, hypers, sums, factors, **kw)
        check(all(bool(torch.equal(got[k], want[k])) for k in want), f"exchange under capture: books differ, {case}")
        check(_pbt_same(got_state, _pbt_state(state, hypers)), f"exchange under capture: state differs, {case}")
        nan_lanes = [j for j, v in enumerate(case) if v != v]
        order, src, exploited = got["order"].tolist(), got["src"].tolist(), got["exploited"].tolist()
        check(sorted(order[K - len(nan_lanes):]) == nan_lanes, f"exchange: NaN lanes {nan_lanes} not last in {order}")
        check(all(src[j] not in nan_lanes for j in range(K) if exploited[j]),
              f"exchange: a NaN lane is a source: src {src}, exploited {exploited}")
        check(all(exploited[j] for j in nan_lanes), f"exchange: NaN lanes {nan_lanes} not exploited: {exploited}")
        print(f"PBT exchange under capture, sums {case}: order {order}, edges "
              f"{[(src[j], j) for j in range(K) if exploited[j]]}, new lrs "
              f"{['%.3e' % v for v in got['new_lr'].tolist()]}; replay = eager, bit for bit")
    # Its cost: the replay between CUDA events (a replay repeats the same
    # gathers), beside the bytes bound of reading and writing every stacked
    # tensor once.
    nbytes = 2 * sum(t.numel() * t.element_size() for t in _pbt_state(state, hypers))
    print(f"PBT exchange (K {K}, 784-400-20, parameters, both moments, counts and lrs): "
          f"{time_ms(graph.replay, iters=100):.6f} ms per graph replay; bytes bound "
          f"{nbytes / PEAK_BYTES_S * 1e3:.6f} ms ({nbytes} bytes)")


def _near_tie_pairs(a_order: list, b_order: list, a_edges: list, b_edges: list) -> list:
    """The pairs of lanes that two runs' rankings or exploit edges put
    differently: the lanes that hold one rank position in the two orders
    and, where the orders agree, each differing edge's source and target."""
    pairs = [(i, j) for i, j in zip(a_order, b_order) if i != j]
    if not pairs:
        pairs = [(e["from"], e["to"]) for e in a_edges + b_edges if (e in a_edges) != (e in b_edges)]
    return sorted({tuple(sorted((int(i), int(j)))) for i, j in pairs})


def pbt_per_group_vs_fused(E, group, smi: str, train, test) -> dict:
    """Phase 11b: the per-group mode on one card (4 one-slot groups on
    cuda:0, a graphed one-lane member each) against the fused mode at the
    same config, population 4, 3 generations, each run's launches counted
    on their own. Per generation the eval sums agree within
    ``PBT_EVAL_RTOL``; the rankings and exploit edges are equal, except
    where the lanes they put differently lie within that tolerance of each
    other (a near-tie, printed with its pairs; the generations after it are
    not compared, since the two populations then differ). Returns each
    run's launch counts."""
    import numpy as np

    from multidisttorch_tpu_torch.hpo import PBTConfig
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    cfg = PBTConfig(**PBT_PER_GROUP)
    # A member's first chunk trains eagerly (the warm-up is a real step);
    # the fused graph warms up one step on a scratch copy.
    per, per_launches, per_s = _pbt_run_counted(E, "per-group", cfg, train, test, warmups=0,
                                                groups=setup_groups(4, devices=["cuda:0"] * 4))
    fused, fused_launches, fused_s = _pbt_run_counted(E, "fused", cfg, train, test, warmups=1, groups=[group],
                                                      fused=True)
    want = cfg.population * (cfg.generations - 1)  # each member's first chunk is its warm-up
    check(per.dispatch_book["graph_replays"] == want,
          f"per-group PBT: {per.dispatch_book['graph_replays']} replays, expected {want}")
    worst = 0.0
    for hp, hf in zip(per.history, fused.history):
        gen = hp["generation"]
        sp, sf = np.array(hp["loss_sums"]), np.array(hf["loss_sums"])
        rel = float(np.max(np.abs(sp - sf) / np.abs(sf)))
        worst = max(worst, rel)
        check(rel <= PBT_EVAL_RTOL, f"per-group vs fused gen {gen}: eval sums rel {rel:.3e} ({sp} vs {sf})")
        if hp["order"] == hf["order"] and hp["exploits"] == hf["exploits"]:
            continue
        pairs = _near_tie_pairs(hp["order"], hf["order"], hp["exploits"], hf["exploits"])
        gaps = [float(abs(sf[i] - sf[j]) / max(abs(sf[i]), abs(sf[j]))) for i, j in pairs]
        check(bool(pairs) and max(gaps) <= PBT_EVAL_RTOL,
              f"per-group vs fused gen {gen}: rankings or edges differ beyond a near-tie: lanes {pairs} at "
              f"relative gaps {gaps}; {hp['order']} {hp['exploits']} vs {hf['order']} {hf['exploits']}, sums {sf}")
        print(f"PBT near-tie at gen {gen}: lanes " + ", ".join(f"{i}/{j} (gap {g:.3e})" for (i, j), g in zip(pairs, gaps))
              + f" <= {PBT_EVAL_RTOL}, fused sums {sf.tolist()}; per-group order {hp['order']} edges {hp['exploits']}, "
              f"fused order {hf['order']} edges {hf['exploits']}; later generations not compared")
        break
    print(f"PBT per-group ({cfg.population} one-slot groups on cuda:0) vs fused, population {cfg.population}, "
          f"{cfg.generations} x {cfg.steps_per_generation} steps: eval sums within rel "
          f"{worst:.3e} (tolerance {PBT_EVAL_RTOL}), orders {[h['order'] for h in per.history]} vs "
          f"{[h['order'] for h in fused.history]}, edges {[h['exploits'] for h in per.history]} vs "
          f"{[h['exploits'] for h in fused.history]}; wall {per_s:.3f} s vs {fused_s:.3f} s, "
          f"{per.dispatch_book['dispatches_per_generation']} vs {fused.dispatch_book['dispatches_per_generation']} "
          f"calls per generation; launches {per_launches} vs {fused_launches} ({smi})")
    return {"per_group": per_launches, "fused": fused_launches}


def set_lr_recapture_check(group) -> None:
    """Phase 11d, the ground rule on graph state for an unstacked trial:
    ``hpo/pbt.py::_set_lr`` between chunks drops the trial's graphs (their
    Adam update holds the lr it was captured with), and the chunk after it
    is captured anew; the losses and parameters equal the eager loop's with
    the same change, bit for bit (784-400-20, batch 128, 3 chunks of 10)."""
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.hpo.pbt import _set_lr
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train.steps import EagerMultiStep, _build_body, create_train_state, make_multi_step

    dev = group.device
    chunks = torch.from_numpy(synthetic_mnist(128 * 30, seed=4).images).to(dev).reshape(3, 10, 128, -1)
    runs = {}
    for mode in ("eager", "graph"):
        state = create_train_state(group, init_vae_params(VAE(), 3), 1e-3)
        gen = torch.Generator(device=dev).manual_seed(21)
        multi = make_multi_step(group) if mode == "graph" else EagerMultiStep(_build_body(group, 1.0, True, 1))
        losses = []
        for i, chunk in enumerate(chunks):
            if i == 2:
                _set_lr(state, 4e-3, multi)
            state, m = multi(state, chunk, generator=gen)
            losses.append(m["loss_sum"])
        torch.cuda.synchronize()
        runs[mode] = (torch.cat(losses), [p.detach().clone() for p in state.model.parameters()], multi)
    (le, pe, _), (lg, pg, graphed) = runs["eager"], runs["graph"]
    check(graphed.captures == 2 and graphed.replays == 2,
          f"_set_lr: {graphed.captures} captures and {graphed.replays} replays, expected 2 and 2")
    check(bool(torch.equal(le, lg)) and _pbt_same(pe, pg),
          f"_set_lr: the recaptured chunk differs from the eager loop (losses max diff {float((le - lg).abs().max()):.3e})")
    print("_set_lr between chunks 2 and 3 (lr 1e-3 -> 4e-3): the trial's graph dropped and captured anew "
          f"({graphed.captures} captures, {graphed.replays} replays); 30 losses and every parameter bit-identical "
          "to the eager loop with the same change")


# Phase 12, the input feed (data/native.py, data/sampler.py) and remat.
# Iterator arguments of each gather path; "numpy" is the synchronous
# reference, the path every run took before the feed.
FEED_PATHS = {
    "numpy": dict(use_native=False, prefetch=False),
    "native": dict(use_native=True, prefetch=False),
    "numpy+prefetch": dict(use_native=False, prefetch=True),
    "native+prefetch": dict(use_native=True, prefetch=True),
}
# The gather paths of the train iterators that run_hpo and run_pbt built
# since the last _check_feeds.
FEEDS: list = []
REMAT_BATCHES = (128, 8192)
REMAT_CHUNKS = 3  # of 10 steps: the eager warm-up (then the capture) and two replays
REMAT_TIMING_CHUNKS = {128: 20, 8192: 4}
# Where remat's bits differ from remat off's on the card: the tolerance,
# normwise per tensor (recomputed products may take other kernels).
REMAT_RTOL = 1e-6


def _watch_feeds() -> None:
    """From here on, record the gather path of every train iterator that
    ``run_hpo`` and ``run_pbt`` build (the driver's and PBT's names are
    rebound to subclasses that note it)."""
    from multidisttorch_tpu_torch.data import sampler
    from multidisttorch_tpu_torch.hpo import driver, pbt

    for mod, name in ((driver, "TrialDataIterator"), (driver, "StackedTrialDataIterator"),
                      (pbt, "StackedTrialDataIterator")):

        class Watched(getattr(sampler, name)):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                FEEDS.append(self.gather_path)

        setattr(mod, name, Watched)


def _check_feeds(phase: str, want: str = "native") -> None:
    paths = list(FEEDS)
    FEEDS.clear()
    check(bool(paths) and set(paths) == {want},
          f"phase {phase}: the train iterators took the gather paths {paths}, expected {want}")


def feed_gatherer(group, smi: str, train) -> None:
    """Phase 12a: the native gatherer against the numpy gather, byte for
    byte on the card, at the slice's chunk (10, 128, 784: a whole epoch of
    ``epoch_chunks``, its tail included), the sweep's (10, 8, 128, 784: a
    whole round of ``round_chunks``) and PBT's (50, 8, 128, 784: 10 chunks
    of ``stream_chunks``, across a round's edge); each path twice, in turns
    (the paths, then the same in reverse). Host ms per chunk: the time the
    consumer was blocked in each ``next()`` (the stacked iterators'
    ``wait_hook``), median over both runs, with nothing else to do between
    two chunks; and the wall ms per chunk to the last copy's end. Then the
    host-to-device copy of a pinned PBT chunk."""
    from multidisttorch_tpu_torch.data import native
    from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator, TrialDataIterator

    check(native.available(), "phase 12a: the native gatherer did not build or load")
    lanes = list(range(STACK_LANES))
    stacked = ("numpy", "native", "numpy+prefetch", "native+prefetch")

    def slice_chunks(kw, hook):
        it = TrialDataIterator(train, group, 128, seed=0, use_native=kw["use_native"])
        return it, (c for _, c in it.epoch_chunks(1, 10))

    def sweep_chunks(kw, hook):
        it = StackedTrialDataIterator(train, group, 128, lanes, wait_hook=hook, **kw)
        return it, (c for _, c in it.round_chunks(10))

    def pbt_chunks(kw, hook):
        it = StackedTrialDataIterator(train, group, 128, lanes, wait_hook=hook, **kw)
        return it, it.stream_chunks(50)

    for name, shape, paths, make, n in (
        ("slice", (10, 128, 784), ("numpy", "native"), slice_chunks, 47),
        ("sweep", (10, STACK_LANES, 128, 784), stacked, sweep_chunks, 47),
        ("PBT", (50, STACK_LANES, 128, 784), stacked, pbt_chunks, 10),
    ):
        ref, blocked, walls = None, {p: [] for p in paths}, {p: [] for p in paths}
        for path in paths + paths[::-1]:
            hook_times: list = []
            it, chunks = make(FEED_PATHS[path], lambda s, nb, t=hook_times: t.append(s))
            want = "native" if path.startswith("native") else "numpy"
            check(it.gather_path == want, f"phase 12a {name} {path}: gather_path {it.gather_path}, expected {want}")
            torch.cuda.synchronize()
            got, t_start = [], time.perf_counter()
            for _ in range(n):
                t0 = time.perf_counter()
                got.append(next(chunks))
                if make is slice_chunks:
                    hook_times.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls[path].append((time.perf_counter() - t_start) / n * 1e3)
            chunks.close()
            check(len(hook_times) == n, f"phase 12a {name} {path}: {len(hook_times)} blocked times for {n} chunks")
            blocked[path] += [s * 1e3 for s in hook_times]
            check(tuple(got[0].shape) == shape, f"phase 12a {name} {path}: chunk shape {tuple(got[0].shape)}")
            if ref is None:
                ref = got
            same = len(got) == len(ref) and all(bool(torch.equal(a, b)) for a, b in zip(got, ref))
            check(same, f"phase 12a {name}: the {path} path's chunks differ from the numpy path's")
            del got
        nbytes = math.prod(shape) * 4
        print(f"feed, {name} chunk {shape} ({nbytes} bytes), {n} chunks a run, paths {', '.join(paths)} and "
              "back: every path's chunks equal the numpy path's byte for byte; host ms per chunk (consumer "
              "blocked in next(), median of both runs) " + ", ".join(
                  f"{p} {statistics.median(blocked[p]):.3f}" for p in paths)
              + "; wall ms per chunk to the last copy's end " + ", ".join(
                  f"{p} {statistics.fmean(walls[p]):.3f} ({', '.join(f'{w:.3f}' for w in walls[p])})" for p in paths)
              + f" ({smi})")

    host = torch.empty((50, STACK_LANES, 128, 784), pin_memory=True).fill_(0.5)
    dev_buf = torch.empty(host.shape, device=group.device)
    dev_buf.copy_(host, non_blocking=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        dev_buf.copy_(host, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    h2d = start.elapsed_time(end) / 5
    print(f"feed: host-to-device copy of a pinned PBT chunk ({host.numel() * 4} bytes): {h2d:.3f} ms, "
          f"{host.numel() * 4 / h2d / 1e6:.3f} GB/s (CUDA events, 5 copies) ({smi})")


@contextlib.contextmanager
def _feed(feed: str, blocked: list):
    """``run_hpo``'s and ``run_pbt``'s train iterators, the stacked ones
    with a wait hook that appends the consumer's blocked seconds to
    ``blocked``; ``feed="off"`` also takes the synchronous numpy path
    (``use_native=False``, ``prefetch=False`` and
    ``MDT_STACKED_PREFETCH=0``)."""
    from multidisttorch_tpu_torch.hpo import driver, pbt

    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (driver, "TrialDataIterator"), (driver, "StackedTrialDataIterator"), (pbt, "StackedTrialDataIterator"))]
    old_env = os.environ.get("MDT_STACKED_PREFETCH")
    for mod, name, real in saved:

        class Fed(real):
            def __init__(self, *a, _stacked=name.startswith("Stacked"), **kw):
                if _stacked:
                    kw["wait_hook"] = lambda s, nb: blocked.append(s)
                if feed == "off":
                    kw.update(FEED_PATHS["numpy"] if _stacked else {"use_native": False})
                super().__init__(*a, **kw)

        setattr(mod, name, Fed)
    if feed == "off":
        os.environ["MDT_STACKED_PREFETCH"] = "0"
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
        if old_env is None:
            os.environ.pop("MDT_STACKED_PREFETCH", None)
        else:
            os.environ["MDT_STACKED_PREFETCH"] = old_env


def _same_pbt_result(a, b) -> bool:
    """Books (every generation's sums, orders, lrs and edges), final lrs and
    every lane's parameters, moments and step count, bit for bit."""
    if a.history != b.history or a.final_lrs != b.final_lrs or len(a.final_states) != len(b.final_states):
        return False
    for sa, sb in zip(a.final_states, b.final_states):
        if sa["count"] != sb["count"] or any(not torch.equal(sa["params"][k], sb["params"][k]) for k in sa["params"]):
            return False
        if any(not torch.equal(x, y) for x, y in zip(sa["exp_avg"] + sa["exp_avg_sq"],
                                                      sb["exp_avg"] + sb["exp_avg_sq"])):
            return False
    return True


def pbt_feed_on_off(E, group, smi: str, train, test, busy_ms) -> dict:
    """Phase 12b: phase 11a's fused PBT (K 8, 5 generations of 50 steps)
    with the feed's defaults (native gatherer, prefetch) and with the feed
    off (the synchronous numpy path), in turns (on, off, off, on), the
    counts set to 0 before each run: each lane kernel once per stacked step,
    every run's books, lrs, parameters, moments and counts bit-identical;
    ms per generation (median of generations 1-4), the consumer's blocked
    ms per chunk, and the idle share against phase 11a's busy time per
    generation (the same graph on the card, whichever feed)."""
    from multidisttorch_tpu_torch.hpo import PBTConfig

    cfg = PBTConfig(**PBT_FUSED)
    runs: dict = {"on": [], "off": []}
    for feed in ("on", "off", "off", "on"):
        blocked: list = []
        with _feed(feed, blocked):
            res, launches, wall = _pbt_run_counted(E, f"fused (feed {feed})", cfg, train, test, warmups=1,
                                                   groups=[group], fused=True, return_states=True)
        _check_feeds(f"12b (feed {feed})", "native" if feed == "on" else "numpy")
        gen_ms = [s * 1e3 for s in res.dispatch_book["generation_s"]]
        runs[feed].append({"res": res, "launches": launches, "gen_ms": gen_ms,
                           "steady": statistics.median(gen_ms[1:]), "blocked": [s * 1e3 for s in blocked],
                           "wall": wall})
    first = runs["on"][0]["res"]
    for feed, rs in runs.items():
        for i, r in enumerate(rs):
            check(_same_pbt_result(first, r["res"]),
                  f"PBT feed {feed} run {i + 1}: books, lrs or lane states differ from the first feed-on run")
    out = {}
    for feed, rs in runs.items():
        steady = statistics.median([r["steady"] for r in rs])
        idle = f"{1 - busy_ms / steady:.3f}" if busy_ms else "not measured"
        out[feed] = {"ms_per_generation": steady, "idle": idle, "launches": rs[0]["launches"]}
        print(f"PBT fused K {cfg.population}, feed {feed}: ms per generation " + "; ".join(
            ", ".join(f"{v:.3f}" for v in r["gen_ms"]) + f" (median of 1-4 {r['steady']:.3f})" for r in rs)
            + f"; median {steady:.3f} ms, idle share {idle} against busy {busy_ms} ms (phase 11a); consumer "
            "blocked ms per chunk (the first before generation 0) " + "; ".join(
                ", ".join(f"{v:.3f}" for v in r["blocked"]) for r in rs)
            + f"; wall s {[round(r['wall'], 6) for r in rs]}; launches {rs[0]['launches']} ({smi})")
    print("PBT fused, feed on vs off (runs on, off, off, on): books, lrs, parameters, moments and counts "
          "bit-identical in every run")
    return out


def slice_feed_on_off(group, smi: str, train, test) -> None:
    """Phase 12b, the single-trial main path: phase 6's slice (two trials,
    checkpoints off) with the feed on (the native gatherer) and off (numpy),
    in turns (on, off, off, on): the same histories and final losses, and
    the wall time of each run."""
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo

    configs = [TrialConfig(trial_id=g, epochs=1 + g, batch_size=128, seed=g, fused_steps=10) for g in range(2)]
    walls, first = {"on": [], "off": []}, {}
    for feed in ("on", "off", "off", "on"):
        with _feed(feed, []), tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            res = run_hpo(configs, train, test, groups=[group], out_dir=tmp, save_checkpoints=False, verbose=False)
            torch.cuda.synchronize()
            walls[feed].append(time.time() - t0)
        _check_feeds(f"12b slice (feed {feed})", "native" if feed == "on" else "numpy")
        first.setdefault(feed, [(r.status, r.steps, r.history, r.final_train_loss, r.final_test_loss) for r in res])
    check(first["on"] == first["off"], f"slice, feed on vs off: results differ: {first['on']} vs {first['off']}")
    steps = sum(r[1] for r in first["on"])
    print(f"slice (2 trials, {steps} steps, checkpoints off), feed on vs off (runs on, off, off, on): histories and "
          f"final losses equal; wall s on {walls['on']} (median {statistics.median(walls['on']):.6f}), off "
          f"{walls['off']} (median {statistics.median(walls['off']):.6f}) ({smi})")


def _compare_remat(what: str, off: dict, on: dict) -> str:
    """Remat on against off: bit-identical, or else the first differing
    tensor printed and every tensor held at :data:`REMAT_RTOL`, normwise."""
    diff = [k for k in off if not torch.equal(off[k], on[k])]
    if not diff:
        return "bit-identical"
    rel = {k: float((off[k] - on[k]).abs().max() / off[k].abs().max().clamp_min(1e-30)) for k in diff}
    print(f"{what}: remat on vs off differ first in {diff[0]} (rel {rel[diff[0]]:.3e}); {len(diff)} of {len(off)} "
          f"tensors differ, at most rel {max(rel.values()):.3e}")
    check(max(rel.values()) <= REMAT_RTOL, f"{what}: remat on vs off beyond rel {REMAT_RTOL}: {rel}")
    return f"within rel {max(rel.values()):.3e}"


def remat_phase(E, group, smi: str) -> dict:
    """Phase 12c: ``make_multi_step`` graphed with remat off and on, from
    the same weights, batches and generator seed, in chunks of 10 (the
    first one's eager warm-up, its capture, then replays), at batch 128
    and 8192: losses and parameters compared (bit-identical, or the first
    differing tensor and rel 1e-6), each ELBO kernel launched once per step
    both ways, the peak of device memory allocated over the first chunk
    (warm-up and capture) above what was allocated before it, and ms per
    step of the replays in turns (off, on, on, off); then the stacked
    graphed step at K 8, batch 128, likewise (losses, parameters, moments,
    counts; each lane kernel once per step). Returns the launch counts by
    run."""
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train.steps import (
        TrialHypers,
        create_stacked_train_state,
        create_train_state,
        make_multi_step,
        make_stacked_multi_step,
    )

    dev = group.device
    launches: dict = {}

    def run(make, b: int, stacked: bool) -> None:
        rows = (STACK_LANES, b) if stacked else (b,)
        chunks = torch.rand((REMAT_CHUNKS, 10, *rows, 784), generator=torch.Generator(device=dev).manual_seed(b),
                            device=dev)
        steps = REMAT_CHUNKS * 10
        what = f"stacked K {STACK_LANES}, batch {b}" if stacked else f"single, batch {b}"
        got = {}
        for remat in (False, True):
            state, multi, call = make(remat)
            check(multi.graphed, f"remat {remat} ({what}): the multi-step is not graphed")
            for k in E.LAUNCHES:
                E.LAUNCHES[k] = 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            losses = []
            for i, c in enumerate(chunks):
                losses.append(call(state, multi, c))
                if i == 0:
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() - base
            torch.cuda.synchronize()
            for k, n in E.LAUNCHES.items():
                want = steps if k.endswith("_lanes") == stacked else 0
                check(n == want, f"remat {remat} ({what}): {k} launched {n} times in {steps} steps, expected {want}")
            launches[f"remat_{'stacked_' if stacked else ''}b{b}_{'on' if remat else 'off'}"] = dict(E.LAUNCHES)
            tensors = {"losses": torch.cat(losses)}
            tensors.update({f"param {k}": v.detach().clone() for k, v in state.params.items()})
            if stacked:
                tensors.update({f"moment {i}": t.clone() for i, t in enumerate(state.exp_avg + state.exp_avg_sq)})
                tensors["count"] = state.count.clone()
            got[remat] = (state, multi, call, tensors, peak)
        verdict = _compare_remat(what, got[False][3], got[True][3])
        per = {False: [], True: []}
        reps = REMAT_TIMING_CHUNKS[b]
        for remat in (False, True, True, False):
            state, multi, call, *_ = got[remat]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call(state, multi, chunks[1])
            torch.cuda.synchronize()
            per[remat].append((time.perf_counter() - t0) / (reps * 10) * 1e3)
        multi_on = got[True][1]
        print(f"remat, graphed multi-step {what}, chunks of 10: {steps} steps both ways, losses and "
              f"{'parameters, moments and counts' if stacked else 'parameters'} {verdict}; with remat "
              f"{getattr(multi_on, 'captures', 0)} capture, {multi_on.replays} replays, each ELBO kernel once per step; ms per "
              f"step off {statistics.fmean(per[False]):.6f} ({', '.join(f'{v:.6f}' for v in per[False])}), on "
              f"{statistics.fmean(per[True]):.6f} ({', '.join(f'{v:.6f}' for v in per[True])}); peak device "
              f"memory allocated over the first chunk off {got[False][4]} bytes, on {got[True][4]} bytes ({smi})")

    def single(remat):
        state = create_train_state(group, init_vae_params(VAE(), 0), 1e-3)
        gen = torch.Generator(device=dev).manual_seed(1234)
        return state, make_multi_step(group, remat=remat), lambda s, m, c: m(s, c, generator=gen)[1]["loss_sum"]

    def stacked_k8(remat):
        state = create_stacked_train_state(group, [init_vae_params(VAE(), s) for s in range(STACK_LANES)])
        hypers = TrialHypers.stack([1e-3, 2e-3, 5e-4, 1e-3, 3e-3, 1e-3, 2e-3, 1e-3],
                                   [1.0, 1.0, 2.0, 4.0, 1.0, 0.5, 1.0, 3.0], device=dev)
        gens = [torch.Generator(device=dev).manual_seed(1000 + j) for j in range(STACK_LANES)]
        multi = make_stacked_multi_step(group, remat=remat)
        return state, multi, lambda s, m, c: m(s, hypers, c, generators=gens)[1]["loss_sum"]

    for b in REMAT_BATCHES:
        run(single, b, False)
    run(stacked_k8, 128, True)
    return launches


# Phase 14, the model families at full width (models/conv_vae.py,
# models/moe_vae.py, models/resnet.py, train/classifier.py). The
# convolutions run under phase 1's TF32 setting unless a line says
# otherwise; every timing line prints the setting it ran under.
FAMILY_CHUNKS = 4  # chunks in a graphed-vs-eager comparison
SPREAD_RUNS = 6  # eager runs under the defaults, whose pairwise spread bounds the graphed run
SPREAD_FACTOR = 4.0  # the graphed run may differ from each eager run by this times the spread
SPREAD_VALUE_FLOOR = 1e-3  # ... or by this times the largest |per-step value|
FAMILY_TIMING_CHUNKS = 5  # chunks per timing round (4 rounds, in turns)
RESNET_LOOP_STEPS = 100


def _conv_flags() -> str:
    b = torch.backends
    return (f"cuDNN TF32 {'on' if b.cudnn.allow_tf32 else 'off'}, matmul TF32 "
            f"{'on' if b.cuda.matmul.allow_tf32 else 'off'}, cudnn.deterministic {b.cudnn.deterministic}, "
            f"cudnn.benchmark {b.cudnn.benchmark}")


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms for a bitwise comparison: under the
    defaults a conv's backward may sum with atomics, so two eager runs
    differ (``_graph_within_spread`` measures by how much)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _run_chunks(fresh_state, multi, chunks: list, call, group) -> tuple:
    """One run of ``multi`` over ``chunks`` from a fresh state with the
    generator at seed 1234: the per-step values and every parameter."""
    state = fresh_state()
    gen = torch.Generator(device=group.device).manual_seed(1234)
    vals = [call(multi, state, c, gen)[1] for c in chunks]
    torch.cuda.synchronize()
    return torch.cat(vals), {n: p.detach().clone() for n, p in state.params.items()}


def _distance(a: tuple, b: tuple) -> tuple:
    """Max |diff| of two runs' per-step values and of their parameters."""
    (va, pa), (vb, pb) = a, b
    return float((va - vb).abs().max()), max(float((pa[n] - pb[n]).abs().max()) for n in pa)


def _graph_within_spread(what: str, fresh_state, make_eager, make_graph, chunks: list, call, group) -> dict:
    """The graphed multi-step against the eager loop under cuDNN's defaults
    (``cudnn.deterministic`` off), where a conv's backward may sum with
    atomics and two eager runs differ: ``SPREAD_RUNS`` eager runs over the
    same chunks, state and generator seed give the spread (the largest
    pairwise |diff| of the per-step values and of the parameters), and the
    graphed run must be within ``SPREAD_FACTOR`` times it of every eager
    run, with one replay per chunk but the first.

    The runs fall into a few trajectories, by the step at which the atomics
    first summed in another order, so all the eager runs can share one
    while the graphed run takes another (40 ConvVAE steps: pairs 1.6e-2 to
    26 apart). The bound therefore never goes below two floors that such
    rounding does not reach and a fault of the graph (a stale input, a lost
    update, a repeated draw) passes at once: ``SPREAD_VALUE_FLOOR`` times
    the largest |per-step value|, and for the parameters lr times the
    steps (Adam moves a weight by about lr a step)."""
    lr = fresh_state().optimizer.param_groups[0]["lr"]
    eager = [_run_chunks(fresh_state, make_eager(), chunks, call, group) for _ in range(SPREAD_RUNS)]
    pairs = [_distance(eager[i], eager[j]) for i in range(SPREAD_RUNS) for j in range(i + 1, SPREAD_RUNS)]
    spread = (max(p[0] for p in pairs), max(p[1] for p in pairs))
    steps = chunks[0][0].shape[0] * len(chunks)
    floors = (SPREAD_VALUE_FLOOR * max(float(e[0].abs().max()) for e in eager), lr * steps)
    bound = tuple(max(SPREAD_FACTOR * s, f) for s, f in zip(spread, floors))
    multi = make_graph()
    graph = _run_chunks(fresh_state, multi, chunks, call, group)
    check(multi.graphed and multi.replays == len(chunks) - 1,
          f"{what} defaults: graphed {multi.graphed}, {multi.replays} replays in {len(chunks)} chunks")
    check(bool(torch.isfinite(graph[0]).all()), f"{what} defaults: non-finite graphed values")
    to_eager = [_distance(graph, e) for e in eager]
    for k, name in ((0, "per-step values"), (1, "parameters")):
        worst = max(d[k] for d in to_eager)
        check(worst <= bound[k],
              f"{what} defaults: graphed vs eager {name} max |diff| {worst:.3e}, beyond the bound {bound[k]:.3e} "
              f"({SPREAD_FACTOR:g} x the eager runs' spread {spread[k]:.3e}, floor {floors[k]:.3e}; pairwise "
              + ", ".join(f"{p[k]:.3e}" for p in pairs) + ")")
    print(f"{what}: under the defaults, {SPREAD_RUNS} eager runs of {len(chunks)} chunks ({steps} steps), same state, "
          "data and seed, differ pairwise by " + ", ".join(f"{v:.3e}" for v, _ in pairs) + " in the per-step values "
          "and " + ", ".join(f"{p:.3e}" for _, p in pairs) + " in the parameters; the graphed run differs from each "
          "by " + ", ".join(f"{v:.3e}" for v, _ in to_eager) + " and " + ", ".join(f"{p:.3e}" for _, p in to_eager)
          + f" (bounds {bound[0]:.3e}, {bound[1]:.3e}: the larger of {SPREAD_FACTOR:g} x the spread and the floors "
          f"{floors[0]:.3e}, {floors[1]:.3e}; {multi.replays} replays; {_conv_flags()})")
    return {"eager_pairs": pairs, "graph_to_eager": to_eager, "bound": bound}


def _profile_steps(run, steps: int, guard: str = "") -> tuple:
    """torch.profiler over ``run()``, which runs ``steps`` train steps:
    device busy ms per step and the kernels by device time (ms per step,
    launches per step, name). With ``guard``, a trace counts only if it
    holds one such kernel per step (the profiler can drop part of a replay),
    in three tries; busy is None if none did."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        seen = sum(e.count for e in prof.key_averages() if guard and guard in e.key and e.device_time_total > 0)
        if not guard or seen == steps:
            break
    by_kernel = sorted(((e.device_time_total / steps / 1e3, e.count / steps, e.key) for e in prof.key_averages()
                        if e.device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in by_kernel) if (not guard or seen == steps) else None
    return busy, by_kernel


def _family_graph_vs_eager(E, group, smi: str, what: str, fresh_state, builders: dict, chunks: list, call,
                           guard: str = "") -> dict:
    """A family's multi-step as CUDA-graph replays against its eager loop:
    the same initial weights, chunks and generator seed; the graphed run's
    first chunk is its warm-up, its second the capture, the rest replays.
    Per-step values, every parameter and the launch counts must be equal to
    the last bit. Then ms per step of both in turns (eager, graph, graph,
    eager) and, from torch.profiler, the device's busy time per step, the
    idle share and the top kernels. ``call(multi, state, chunk, gen) ->
    (state, per-step values)``."""
    k = chunks[0][0].shape[0]
    steps = k * len(chunks)
    runs, kept = {}, {}
    for mode in ("eager", "graph"):
        state = fresh_state()
        multi = builders[mode]()
        check(multi.graphed == (mode == "graph"), f"{what} {mode}: graphed is {multi.graphed}")
        gen = torch.Generator(device=group.device).manual_seed(1234)
        for key in E.LAUNCHES:
            E.LAUNCHES[key] = 0
        vals = []
        for c in chunks:
            state, v = call(multi, state, c, gen)
            vals.append(v)
        torch.cuda.synchronize()
        runs[mode] = (torch.cat(vals), {n: p.detach().clone() for n, p in state.params.items()},
                      dict(E.LAUNCHES), multi.replays)
        kept[mode] = [multi, state, gen]
    (ve, pe, le, _), (vg, pg, lg, replays) = runs["eager"], runs["graph"]
    check(replays == len(chunks) - 1, f"{what} graph: {replays} replays, expected {len(chunks) - 1}")
    check(bool(torch.isfinite(vg).all()), f"{what} graph: non-finite values {vg}")
    check(bool(torch.equal(ve, vg)), f"{what} graph vs eager: per-step values differ "
          f"(max {float((ve - vg).abs().max()):.3e})")
    for n in pe:
        check(bool(torch.equal(pe[n], pg[n])),
              f"{what} graph vs eager: param {n} differs (max {float((pe[n] - pg[n]).abs().max()):.3e})")
    check(le == lg, f"{what}: launches eager {le}, graph {lg}")
    print(f"{what}: graphed multi-step vs eager loop, {len(chunks)} chunks of K {k}: {steps} steps' values and "
          f"every parameter bit-identical; {replays} replays; launches {lg} ({_conv_flags()})")

    per = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        multi, state, gen = kept[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FAMILY_TIMING_CHUNKS):
            state, _ = call(multi, state, chunks[0], gen)
        torch.cuda.synchronize()
        per[mode].append((time.perf_counter() - t0) / (FAMILY_TIMING_CHUNKS * k) * 1e3)
    res = {}
    for mode in ("eager", "graph"):
        multi, state, gen = kept[mode]
        busy, by_kernel = _profile_steps(lambda: [call(multi, state, c, gen) for c in chunks[:2]], 2 * k, guard)
        ms = statistics.fmean(per[mode])
        res[mode] = {"ms_per_step": ms, "rounds": per[mode], "busy_ms": busy,
                     "idle": None if busy is None else 1 - busy / ms, "kernels": by_kernel}
        busy_s = _busy_text(busy, ms)
        print(f"{what} step ({mode}{f', one CUDA graph per chunk of {k}' if mode == 'graph' else ' loop'}): "
              f"{ms:.6f} ms/step (rounds " + ", ".join(f"{v:.6f}" for v in per[mode]) + f"), {busy_s}; "
              f"{sum(x[1] for x in by_kernel):.0f} device kernels per step ({_conv_flags()}; {smi})")
        if mode == "graph":
            print(f"{what} step (graph): device us per step by kernel (launches per step), top 12: "
                  + "; ".join(f"{t * 1e3:.3f} ({n:g}) {key[:70]}" for t, n, key in by_kernel[:12]))
    return res


def _busy_text(busy, ms: float) -> str:
    if busy is None:
        return "device busy not measured, idle share not measured (the profiler dropped kernels)"
    if busy > ms:
        return (f"device kernel time {busy * 1e3:.3f} us/step, more than the step's wall time (kernels that "
                "overlap, or the profiler's accounting of a replay), so the idle share is not measured")
    return f"device busy {busy * 1e3:.3f} us/step, idle share {1 - busy / ms:.3f}"


def _settings_timing(group, smi: str, what: str, fresh_state, make_multi, chunks: list, call,
                     flops: float = 0.0, guard: str = "") -> dict:
    """The graphed multi-step under the defaults (``cudnn.deterministic``
    off) with cuDNN TF32 off (phase 1's setting) and on: each captured under
    its setting, then timed in turns (off, on, on, off), ms per step, and,
    from torch.profiler, each one's busy time, idle share and top kernels.
    ``flops`` per step, when given, gives the rate."""
    k = chunks[0][0].shape[0]
    before = torch.backends.cudnn.allow_tf32
    runs = {}
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            state, multi = fresh_state(), make_multi()
            gen = torch.Generator(device=group.device).manual_seed(99)
            for c in chunks[:2]:  # the warm-up, then the capture
                state, _ = call(multi, state, c, gen)
            runs[tf32] = [multi, state, gen]
        per = {False: [], True: []}
        for tf32 in (False, True, True, False):
            multi, state, gen = runs[tf32]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FAMILY_TIMING_CHUNKS):
                state, v = call(multi, state, chunks[0], gen)
            torch.cuda.synchronize()
            per[tf32].append((time.perf_counter() - t0) / (FAMILY_TIMING_CHUNKS * k) * 1e3)
            check(bool(torch.isfinite(v).all()), f"{what}, TF32 {tf32}: non-finite values")
    finally:
        torch.backends.cudnn.allow_tf32 = before
    out = {}
    for tf32 in (False, True):
        multi, state, gen = runs[tf32]
        busy, by_kernel = _profile_steps(lambda: [call(multi, state, c, gen) for c in chunks[:2]], 2 * k, guard)
        ms = statistics.fmean(per[tf32])
        rate = f", {flops / ms / 1e9:.1f} TFLOP/s at {flops / 1e12:.4f} TFLOP a step" if flops else ""
        print(f"{what} graphed step, cudnn.deterministic False, cuDNN TF32 {'on' if tf32 else 'off'}: {ms:.6f} ms/step "
              "(rounds " + ", ".join(f"{v:.6f}" for v in per[tf32]) + f"){rate}, {_busy_text(busy, ms)}; top 8 "
              "device us per step (launches per step): "
              + "; ".join(f"{t * 1e3:.3f} ({n:g}) {key[:60]}" for t, n, key in by_kernel[:8]) + f" ({smi})")
        out[tf32] = {"ms_per_step": ms, "busy_ms": busy}
    return out


def _vae_call(multi, state, chunk, gen):
    state, m = multi(state, chunk[0], generator=gen)
    return state, m["loss_sum"]


def _classifier_call(multi, state, chunk, gen):
    state, m = multi(state, chunk[0], chunk[1])
    return state, torch.stack([m["loss"], m["accuracy"]], dim=-1)


def _classifier_loss_call(multi, state, chunk, gen):
    """The per-step losses alone, for a spread: a step's accuracy moves in
    steps of 1/128, and one row's flip would stand for the whole spread."""
    state, m = multi(state, chunk[0], chunk[1])
    return state, m["loss"]


def _counted_hpo(E, what: str, configs, train, test, group, **kw) -> tuple:
    """``run_hpo`` with the launch counts set to 0 just before and read just
    after: each ELBO kernel once per train step, the lane kernels never;
    each trial's chunks a replay but its first; each trial's checkpoint
    written. Returns the results, the counts and the wall seconds."""
    from multidisttorch_tpu_torch.hpo.driver import run_hpo

    for key in E.LAUNCHES:
        E.LAUNCHES[key] = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        results = run_hpo(configs, train, test, groups=[group], out_dir=tmp, verbose=False, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        for r in results:
            check(os.path.exists(os.path.join(tmp, f"trial-{r.trial_id}", "state.msgpack.json")),
                  f"{what}: trial {r.trial_id} wrote no checkpoint")
    launches = dict(E.LAUNCHES)
    steps = sum(r.steps for r in results)
    for key, n in launches.items():
        want = 0 if key.endswith("_lanes") else steps
        check(n == want, f"{what}: {key} launched {n} times in {steps} train steps, expected {want}")
    for r in results:
        chunks = -(-r.steps // r.config.fused_steps)
        check(r.status == "completed", f"{what}: trial {r.trial_id} {r.status} {r.error}")
        check(r.graph_replays == chunks - 1, f"{what}: trial {r.trial_id}: {r.graph_replays} graph replays in "
              f"{chunks} chunks, expected {chunks - 1} (the first is the warm-up)")
        check(math.isfinite(r.final_train_loss) and math.isfinite(r.final_test_loss),
              f"{what}: trial {r.trial_id}: non-finite losses {r.final_train_loss}, {r.final_test_loss}")
    return results, launches, wall


def conv_vae_phase(E, F, group, smi: str, floor) -> dict:
    """Phase 14a: the conv β-VAE (BASELINE.md config 3) at full width: the
    ELBO kernels at its width, one fused-vs-plain step, the graphed
    multi-step against its eager loop (under the defaults within the eager
    runs' spread, and bit-identical under ``cudnn.deterministic``), and
    the ``run_hpo(model_builder=)`` slice under the defaults."""
    from multidisttorch_tpu_torch.data.datasets import synthetic_cifar10
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig
    from multidisttorch_tpu_torch.models import ConvVAE
    from multidisttorch_tpu_torch.train.steps import (
        EagerMultiStep, _build_body, create_train_state, make_multi_step, make_train_step,
    )

    print(f"phase 14a, conv beta-VAE (latent 64, base channels 32, 32x32x3, batch 128): {_conv_flags()}")
    # The ELBO kernels at 3072 logits a row: timed at the main shape, then a
    # ragged batch and bf16 activations untimed.
    kernels = kernel_vs_plain(E, F, 128, 3072, 64, torch.float32, smi=smi, floor=floor)
    kernel_vs_plain(E, F, 100, 3072, 64, torch.float32, timed=False)
    kernel_vs_plain(E, F, 128, 3072, 64, torch.bfloat16, timed=False)

    dev = group.device
    train = synthetic_cifar10(50000, seed=0)
    test = synthetic_cifar10(10000, seed=1)
    weights = ConvVAE().init_params(0).state_dict()

    def fresh(lr=1e-3):
        model = ConvVAE()
        model.load_state_dict(weights)
        return create_train_state(group, model, lr)

    # One step, fused kernels against the plain loss, same weights and noise.
    # At lr 0 the step leaves the weights and its gradients behind: Adam's
    # first update, about lr times the gradient's sign, would magnify the
    # rounding of gradients near zero.
    batch = torch.from_numpy(train.images[:128]).to(dev)
    eps = torch.randn(128, 64, generator=torch.Generator(device="cpu").manual_seed(3)).to(dev)
    out = {}
    for fused in (True, False):
        state = fresh(lr=0.0)
        state, m = make_train_step(group, use_fused_loss=fused)(state, batch, eps=eps)
        out[fused] = (float(m["loss_sum"]), {n: p.grad.detach().clone() for n, p in state.params.items()})
    (lf, gf), (lp, gp) = out[True], out[False]
    rel = abs(lf - lp) / abs(lp)
    check(math.isfinite(lf) and rel <= 1e-5, f"14a train step: fused loss {lf} vs plain {lp} (rel {rel:.2e})")
    worst = 0.0
    for n in gf:
        diff = (gf[n] - gp[n]).abs()
        check(bool(torch.all(diff <= 1e-6 + 1e-4 * gp[n].abs())),
              f"14a train step: gradient of {n} differs beyond rtol 1e-4 / atol 1e-6 (max {float(diff.max()):.3e})")
        worst = max(worst, float(diff.max()))
    print(f"14a train step: fused loss_sum {lf:.6f} plain {lp:.6f} rel {rel:.3e}; gradients max |diff| "
          f"{worst:.3e} (rtol 1e-4 / atol 1e-6)")

    k = 10
    imgs = torch.from_numpy(train.images[: 128 * k * FAMILY_CHUNKS]).to(dev)
    chunks = [(c,) for c in imgs.reshape(FAMILY_CHUNKS, k, 128, -1)]
    eager = lambda: EagerMultiStep(_build_body(group, 1.0, True, 1))  # noqa: E731
    spread = _graph_within_spread("14a ConvVAE", fresh, eager, lambda: make_multi_step(group), chunks, _vae_call, group)
    with _cudnn_deterministic():
        step_res = _family_graph_vs_eager(
            E, group, smi, "14a ConvVAE", fresh, {"graph": lambda: make_multi_step(group), "eager": eager},
            chunks, _vae_call, guard="elbo_fwd")
    step_res["spread"] = spread
    step_res["defaults"] = _settings_timing(group, smi, "14a ConvVAE", fresh, lambda: make_multi_step(group), chunks,
                                            _vae_call, guard="elbo_fwd")

    # The slice: two trials of BASELINE.md config 3's beta sweep, one epoch.
    configs = [TrialConfig(trial_id=g, epochs=1, batch_size=128, lr=1e-3, beta=b, seed=g, fused_steps=10)
               for g, b in enumerate((0.5, 1.0))]
    results, launches, wall = _counted_hpo(
        E, "14a run_hpo(ConvVAE)", configs, train, test, group,
        model_builder=lambda cfg: ConvVAE(latent_dim=64, base_channels=32))
    steps = sum(r.steps for r in results)
    check(steps == 2 * 390, f"14a: {steps} train steps, expected {2 * 390}")
    for r in results:
        print(f"14a trial {r.trial_id} (beta {r.config.beta}): {r.steps} steps, train {r.final_train_loss:.4f}, "
              f"test {r.final_test_loss:.4f} (79 eval batches), {r.graph_replays} graph replays, checkpoint written, "
              f"wall {r.wall_s:.3f} s ({smi})")
    print(f"14a run_hpo(model_builder=ConvVAE): {steps} steps in {wall:.3f} s, {steps * 128 / wall:.1f} train "
          f"samples/s (eval, samples and checkpoints included); launches {launches} ({_conv_flags()}; {smi})")
    return {"kernels": kernels, "launches": launches, "step": step_res}


def moe_vae_phase(E, group, smi: str, train, test) -> dict:
    """Phase 14b: the MoE VAE (784-400-20, 4 experts, capacity factor 2.0)
    through ``run_hpo(model_builder=)``, its graphed multi-step against the
    eager loop, and a v1 checkpoint round trip on the card."""
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig
    from multidisttorch_tpu_torch.models import MoEVAE
    from multidisttorch_tpu_torch.train import checkpoint as ck
    from multidisttorch_tpu_torch.train.steps import EagerMultiStep, _build_body, create_train_state, make_multi_step

    dev = group.device
    weights = MoEVAE().init_params(0).state_dict()

    def fresh(lr=1e-3):
        model = MoEVAE()
        model.load_state_dict(weights)
        return create_train_state(group, model, lr)

    k = 10
    imgs = torch.from_numpy(train.images[: 128 * k * FAMILY_CHUNKS]).to(dev)
    chunks = [(c,) for c in imgs.reshape(FAMILY_CHUNKS, k, 128, -1)]
    step_res = _family_graph_vs_eager(
        E, group, smi, "14b MoEVAE", fresh,
        {"graph": lambda: make_multi_step(group), "eager": lambda: EagerMultiStep(_build_body(group, 1.0, True, 1))},
        chunks, _vae_call, guard="elbo_fwd")

    configs = [TrialConfig(trial_id=0, epochs=1, batch_size=128, seed=0, fused_steps=10)]
    results, launches, wall = _counted_hpo(
        E, "14b run_hpo(MoEVAE)", configs, train, test, group, save_images=False,
        model_builder=lambda cfg: MoEVAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim, num_experts=4,
                                         capacity_factor=2.0))
    r = results[0]
    check(r.steps == 468, f"14b: {r.steps} train steps, expected 468")
    print(f"14b run_hpo(model_builder=MoEVAE): {r.steps} steps, train {r.final_train_loss:.4f}, test "
          f"{r.final_test_loss:.4f}, {r.graph_replays} graph replays, checkpoint written, wall {wall:.3f} s, "
          f"{r.steps * 128 / wall:.1f} train samples/s; launches {launches} ({smi})")

    # A v1 save of a trained state, restored into another state on the card.
    state = fresh()
    multi = make_multi_step(group)
    gen = torch.Generator(device=dev).manual_seed(5)
    for c in chunks[:2]:
        state, _ = multi(state, c[0], generator=gen)
    other = create_train_state(group, MoEVAE().init_params(1), 1e-3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.msgpack")
        ck.save_state(state, path, metadata={"step": state.step}, format="v1")
        with open(path, "rb") as f:
            check(f.read(1) == b"\x83", "14b: not a v1 msgpack file")
        ck.restore_state(other, path)
    a, b = ck.train_state_to_tree(state), ck.train_state_to_tree(other)

    def leaves(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: tree}
        return {k2: v for key, sub in tree.items() for k2, v in leaves(sub, f"{prefix}/{key}").items()}

    import numpy as np

    la, lb = leaves(a), leaves(b)
    check(list(la) == list(lb) and all(np.array_equal(la[key], lb[key]) for key in la) and other.step == state.step,
          "14b: the v1 restore differs from the saved state")
    print(f"14b v1 checkpoint: a MoE state at step {state.step} saved and restored on the card, every leaf of "
          f"{len(la)} (parameters, Adam moments, count, step) bit-identical")
    return {"launches": launches, "step": step_res}


def resnet_phase(E, group, smi: str) -> dict:
    """Phase 14c: ResNet-18 (base channels 64, GroupNorm, batch 128) through
    ``make_classifier_multi_step`` at K 4: graphed against eager, under the
    defaults within the eager runs' spread and under
    ``cudnn.deterministic`` (whose algorithms give the same bits on every
    run) bit-identical, with no ELBO kernel launches; ms per step, busy, idle share and top
    kernels; then the graphed step under the defaults with cuDNN TF32 off
    and on, in turns, with its rate; then 100 graphed steps of the ``resnet_hpo`` loop (one trial) and the
    test accuracy over the synthetic test set."""
    import numpy as np

    from multidisttorch_tpu_torch.data.datasets import synthetic_cifar10
    from multidisttorch_tpu_torch.data.sampler import TrialDataIterator
    from multidisttorch_tpu_torch.models import ResNet18
    from multidisttorch_tpu_torch.train.classifier import (
        _build_classifier_body, _EagerClassifierMultiStep, create_classifier_state, make_classifier_eval_step,
        make_classifier_multi_step,
    )

    dev = group.device
    train = synthetic_cifar10(50000, seed=0)
    test = synthetic_cifar10(10000, seed=1)
    weights = ResNet18(base_channels=64).init_params(0).state_dict()
    n_params = sum(v.numel() for v in weights.values())

    def fresh(lr=1e-3):
        model = ResNet18(base_channels=64)
        model.load_state_dict(weights)
        return create_classifier_state(group, model, lr)

    k = 4
    rows = 128 * k * FAMILY_CHUNKS
    imgs = torch.from_numpy(train.images[:rows]).to(dev).reshape(FAMILY_CHUNKS, k, 128, -1)
    labels = torch.from_numpy(train.labels[:rows].astype(np.int64)).to(dev).reshape(FAMILY_CHUNKS, k, 128)
    chunks = list(zip(imgs, labels))
    print(f"phase 14c, ResNet-18 (base channels 64, {n_params} parameters, GroupNorm, 32x32x3, batch 128)")
    eager = lambda: _EagerClassifierMultiStep(_build_classifier_body(group, 1))  # noqa: E731
    spread = _graph_within_spread("14c ResNet-18", fresh, eager, lambda: make_classifier_multi_step(group), chunks,
                                  _classifier_loss_call, group)
    with _cudnn_deterministic():
        step_res = _family_graph_vs_eager(
            E, group, smi, "14c ResNet-18", fresh, {"graph": lambda: make_classifier_multi_step(group), "eager": eager},
            chunks, _classifier_call)

    step_res["spread"] = spread
    flops = 3 * 2 * _resnet_macs(ResNet18(base_channels=64)) * 128
    step_res["defaults"] = _settings_timing(group, smi, "14c ResNet-18", fresh, lambda: make_classifier_multi_step(group),
                                            chunks, _classifier_call, flops=flops)

    # 100 graphed steps of the resnet_hpo loop, one trial (lr 1e-3, seed 0),
    # under the defaults.
    print(f"14c resnet_hpo loop: {_conv_flags()}")
    state = create_classifier_state(group, ResNet18(num_classes=10, base_channels=64), 1e-3, seed=0)
    multi = make_classifier_multi_step(group)
    it = TrialDataIterator(train, group, 128, seed=0, with_labels=True)
    losses, n_chunks = [], 0
    t0 = time.time()
    for _, x, y in it.epoch_chunks(0, k):
        state, m = multi(state, x, y)
        losses.append(m["loss"])
        n_chunks += 1
        if n_chunks * k == RESNET_LOOP_STEPS:
            break
    torch.cuda.synchronize()
    wall = time.time() - t0
    losses = torch.cat(losses).cpu()
    check(bool(torch.isfinite(losses).all()), "14c loop: non-finite loss")
    check(multi.replays == n_chunks - 1, f"14c loop: {multi.replays} replays in {n_chunks} chunks")
    first, last = float(losses[:k].mean()), float(losses[-k:].mean())
    check(last < first, f"14c loop: loss did not fall ({first} -> {last})")
    eval_step = make_classifier_eval_step(group)
    correct, total = 0.0, 0
    for x, y in TrialDataIterator(test, group, 128, with_labels=True).epoch(0):
        correct += float(eval_step(state, x, y)["correct"])
        total += x.shape[0]
    acc = correct / total
    check(0.1 < acc <= 1.0, f"14c loop: test accuracy {acc} not above chance")
    print(f"14c resnet_hpo loop: {state.step} steps ({multi.replays} graph replays) in {wall:.3f} s, loss "
          f"{first:.4f} -> {last:.4f} (means of the first and last {k}); test accuracy {acc:.4f} "
          f"({int(correct)}/{total} synthetic test rows, drop-tail batches of 128) ({smi})")
    return {"step": step_res, "accuracy": acc}


def _resnet_macs(model) -> int:
    """Multiply-adds of one forward pass of one 32x32 image: every conv's
    output elements times its kernel's fan-in, and the head."""
    from multidisttorch_tpu_torch.models.layers import Conv

    macs, hooks = [0], []

    def hook(mod, inp, out):
        macs[0] += out.numel() * mod.weight[0].numel()

    for mod in model.modules():
        if isinstance(mod, Conv):
            hooks.append(mod.register_forward_hook(hook))
    with torch.no_grad():
        model(torch.zeros(1, 32 * 32 * 3))
    for h in hooks:
        h.remove()
    return macs[0] + model.head.weight.numel()


# Phase 15: fault plans, the chaos drill and the event bus. The drills run
# the JAX harness's sweep at the reference's widths: 6 trials of the
# 784-400-20 VAE, batch 128, 4 epochs of 8 steps (1024 synthetic MNIST rows),
# chunks of 4 steps, so the standard plan's faults land inside a chunk.
CHAOS = dict(trials=6, epochs=4, data_rows=1024, batch_size=128, hidden_dim=400, latent_dim=20, fused_steps=4)
MEMORY_MARGIN = 8 << 20  # bytes memory_allocated may grow across the drill's retries
TELEMETRY_ROUNDS = ("off", "on", "on", "off", "off", "on")
CONV_RESUME_CRASH = 390 + 195  # the ConvVAE's mid-epoch-2 step (390 steps an epoch)


def chaos_drill(E, smi: str, *, stacked: bool) -> dict:
    """Phase 15a (unstacked, with the preemption and the driver restart) and
    15b (``stacked=True``: two buckets of 3 lanes): ``run_chaos_bench`` on
    the card, the fault-free sweep then the same sweep under the standard
    plan, counts set to 0 just before and read just after the drill.

    Every fired fault must be recovered, the DIVERGE trial must settle as
    ``diverged`` (in 15a its NaN went through the ELBO kernels in a graph
    replay: past the trial's first, eager, chunk), and goodput must reach
    0.8. 15a: the control and every retried trial end bit-identical to the
    fault-free run; every attempt's multi-step (and so its graphs) is freed
    and ``memory_allocated`` ends within 8 MiB of the fault-free run's; each
    ELBO kernel launched once per executed step of both runs. 15b: every
    bucket captured one graph, the faulted lanes refilled with no new
    capture, and the other lanes end bit-identical to the fault-free run or,
    printed, within phase 10's rel 1e-3; each lane kernel once per stacked
    step. Every fired fault and retry is a tagged event of the trace."""
    import gc
    import weakref

    from multidisttorch_tpu_torch.faults.harness import run_chaos_bench
    from multidisttorch_tpu_torch.faults.plan import CKPT_CORRUPT, DIVERGE
    from multidisttorch_tpu_torch.hpo import driver
    from multidisttorch_tpu_torch.telemetry import device as tele_device

    what = "15b stacked drill" if stacked else "15a chaos drill"
    real_multi, real_stacked = driver.make_multi_step, driver.make_stacked_multi_step
    real_wrap = driver._TrialRun._wrap_multi
    multis, buckets, poisoned = [], [], []

    def tracked_multi(g, **kw):
        m = real_multi(g, **kw)
        multis.append(weakref.ref(m))
        return m

    def watched_wrap(run, fn):
        # Notes each poisoned chunk: its trial, first step, and whether the
        # trial's multi-step was warm (so the chunk ran as a graph replay).
        hooked = real_wrap(run, fn)
        if hooked is fn:
            return fn
        transform, ref = hooked._transform, weakref.ref(fn)

        def watched(b):
            out = transform(b)
            if out is not b:
                poisoned.append((run.cfg.trial_id, run.state.step, bool(ref()._warm)))
            return out

        hooked._transform = watched
        return hooked

    def tracked_stacked(g, **kw):
        m = real_stacked(g, **kw)
        buckets.append(m)
        return m

    _warm_pool_streams("cuda:0")
    driver.make_multi_step, driver.make_stacked_multi_step = tracked_multi, tracked_stacked
    driver._TrialRun._wrap_multi = watched_wrap
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    # The drill runs with telemetry on: a device book's counted step (one
    # eager step per program shape new to the process) launches each kernel
    # once more.
    memo0 = len(tele_device._cost_cache)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            report = run_chaos_bench(tmp, stacked=stacked, device="cuda", **CHAOS)
            torch.cuda.synchronize()
    finally:
        driver.make_multi_step, driver.make_stacked_multi_step = real_multi, real_stacked
        driver._TrialRun._wrap_multi = real_wrap
    launches = dict(E.LAUNCHES)
    counted = len(tele_device._cost_cache) - memo0
    tel = report["telemetry"]
    specs = report["plan"]["specs"]
    div = next(s for s in specs if s["kind"] == DIVERGE)
    fired = sorted((f["kind"], f["trial_id"]) for f in report["faults_fired"])
    want = sorted((s["kind"], s["trial_id"]) for s in specs if not (stacked and s["kind"] == CKPT_CORRUPT))
    check(fired == want, f"{what}: fired {fired}, planned {want}")
    check(report["all_infra_faults_recovered"], f"{what}: not every fault was recovered: {report['recovered']}")
    check(report["statuses"][div["trial_id"]] == "diverged",
          f"{what}: the DIVERGE trial {div['trial_id']} settled as {report['statuses'][div['trial_id']]}")
    check(report["goodput"] >= 0.8, f"{what}: goodput {report['goodput']} below 0.8")
    check(tel["all_faults_traced"] and tel["trace_monotonic"] and tel["faults_traced"] == len(fired),
          f"{what}: traced {tel['faults_traced']} of {len(fired)} faults, monotonic {tel['trace_monotonic']}")
    check(tel["retries_traced"] >= 3, f"{what}: {tel['retries_traced']} retries traced")
    parity = "; ".join(f"trial {p['trial_id']} attempt {p['attempts']}: {p['chaos_loss']!r} vs {p['fault_free_loss']!r}"
                       for p in report["parity"])
    if stacked:
        check(len(buckets) == 4 and all(m.graphed and m.captures == 1 for m in buckets),
              f"{what}: buckets {len(buckets)}, captures {[m.captures for m in buckets]} (one each)")
        lane_steps = sum(CHAOS["fused_steps"] * (m.replays + 1) for m in buckets) + counted
        for k in ("elbo_fwd_lanes", "elbo_bwd_lanes"):
            check(launches[k] == lane_steps, f"{what}: {k} launched {launches[k]} times in {lane_steps} stacked steps")
        check(launches["elbo_fwd"] == launches["elbo_bwd"] == 0, f"{what}: single-trial kernels launched {launches}")
        check(tel["lane_refills_traced"] >= 3, f"{what}: {tel['lane_refills_traced']} lane refills traced")
        if not report["final_metrics_bit_identical"]:
            worst = max(abs(p["chaos_loss"] - p["fault_free_loss"]) / abs(p["fault_free_loss"]) for p in report["parity"])
            check(worst <= STACK_LOSS_RTOL, f"{what}: lanes beyond rel {STACK_LOSS_RTOL}: {parity}")
            print(f"{what}: lanes not bit-identical to the fault-free stacked run, worst rel {worst:.3e} "
                  f"(within {STACK_LOSS_RTOL}): {parity}")
        del buckets
    else:
        check(report["final_metrics_bit_identical"], f"{what}: not bit-identical to the fault-free run: {parity}")
        check(report["restarts_after_preemption"] == 1, f"{what}: {report['restarts_after_preemption']} restarts")
        chunk0 = div["step"] - div["step"] % CHAOS["fused_steps"]
        check(poisoned == [(div["trial_id"], chunk0, True)],
              f"{what}: poisoned chunks {poisoned} (trial, first step, replayed), expected "
              f"[({div['trial_id']}, {chunk0}, True)]")
        gc.collect()
        alive = sum(r() is not None for r in multis)
        check(alive == 0, f"{what}: {alive} of {len(multis)} multi-steps (and their graphs) still alive")
        mem = report["memory_allocated"]
        check(mem["after_chaos"] - mem["after_fault_free"] <= MEMORY_MARGIN,
              f"{what}: memory_allocated grew from {mem['after_fault_free']} to {mem['after_chaos']} bytes")
        ff_steps = CHAOS["trials"] * CHAOS["epochs"] * CHAOS["data_rows"] // CHAOS["batch_size"]
        for k in ("elbo_fwd", "elbo_bwd"):
            check(launches[k] == ff_steps + report["executed_steps"] + counted,
                  f"{what}: {k} launched {launches[k]} times, expected {ff_steps} fault-free + "
                  f"{report['executed_steps']} executed under the plan + {counted} counted")
        print(f"{what}: {len(multis)} multi-steps over both runs, all freed; memory_allocated "
              f"{mem['after_fault_free']} -> {mem['after_chaos']} bytes (margin {MEMORY_MARGIN})")
    books = tel["captures"]
    print(f"{what}: poisoned chunks (trial, first step, replayed) {poisoned}; fired {fired}; statuses {report['statuses']}; restarts {report['restarts_after_preemption']}; "
          f"goodput {report['goodput']} ({report['useful_steps']} useful / {report['executed_steps']} executed steps); "
          f"faults traced {tel['faults_traced']}, retries traced {tel['retries_traced']}, lane refills traced "
          f"{tel['lane_refills_traced']}, {tel['events_recorded']} events; launches {launches}")
    print(f"{what}: final train losses, chaos vs fault-free: {parity}")
    print(f"{what}: wall s fault-free {report['wall_fault_free_s']}, chaos {report['wall_chaos_s']} (telemetry on, "
          f"restart included); captures (warm-up s, capture s) by program: "
          + ", ".join(f"{p} x{b['captures']}: {b['warmup_s']:.6f}, {b['capture_s']:.6f}" for p, b in sorted(books.items()))
          + f" ({smi})")
    return {"launches": launches, "captures": books, "report": report}


def empty_plan_and_telemetry(E, group, smi: str, train, test) -> dict:
    """Phase 15c, on phase 6's slice (two trials, 1 and 2 epochs, chunks of
    10): with ``fault_plan=FaultPlan(specs=())`` (counts set to 0 just before,
    read just after) against no plan: the same histories, losses, step
    counts, graph replays, host syncs and final checkpoints, bit for bit.
    Then, after one untimed run, the slice with telemetry off and on, in
    turns (off, on, on, off, off, on): wall time of each run and events per
    step; and one epoch of
    the first trial under the profiler each way: device busy ms per step.
    No limit is set."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.faults.plan import FaultPlan
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.train import checkpoint as ck

    configs = [TrialConfig(trial_id=g, epochs=1 + g, batch_size=128, seed=g, fused_steps=10) for g in range(2)]

    def summary(res):
        return [(r.status, r.steps, r.history, r.final_train_loss, r.final_test_loss, r.graph_replays, r.host_syncs)
                for r in res]

    with tempfile.TemporaryDirectory() as tmp:
        plain = run_hpo(configs, train, test, groups=[group], out_dir=os.path.join(tmp, "none"), verbose=False)
        for k in E.LAUNCHES:
            E.LAUNCHES[k] = 0
        armed = run_hpo(configs, train, test, groups=[group], out_dir=os.path.join(tmp, "empty"), verbose=False,
                        fault_plan=FaultPlan(specs=()))
        torch.cuda.synchronize()
        launches = dict(E.LAUNCHES)
        check(summary(armed) == summary(plain), f"15c: an empty plan changed the slice: {summary(armed)} vs "
              f"{summary(plain)}")
        for r in plain:
            _same_checkpoint(ck, os.path.join(tmp, "none"), os.path.join(tmp, "empty"), "15c empty plan", r.trial_id)
    steps = sum(r.steps for r in plain)
    for k in ("elbo_fwd", "elbo_bwd"):
        check(launches[k] == steps, f"15c empty plan: {k} launched {launches[k]} times in {steps} steps")
    print(f"15c: fault_plan=FaultPlan(specs=()) against no plan: histories, losses, steps, graph replays "
          f"{[r.graph_replays for r in plain]}, host syncs {[r.host_syncs for r in plain]} and final checkpoints "
          f"bit-identical; launches {launches}")

    # One untimed run first: the first run after the drills has taken 1.4x
    # the time of the runs after it.
    with tempfile.TemporaryDirectory() as tmp:
        run_hpo(configs, train, test, groups=[group], out_dir=tmp, verbose=False)
    walls, per_step = {"off": [], "on": []}, []
    for mode in TELEMETRY_ROUNDS:
        with tempfile.TemporaryDirectory() as tmp:
            scope = telemetry.telemetry_run(os.path.join(tmp, "tel")) if mode == "on" else contextlib.nullcontext()
            with scope as bus:
                t0 = time.time()
                res = run_hpo(configs, train, test, groups=[group], out_dir=tmp, verbose=False)
                torch.cuda.synchronize()
                walls[mode].append(time.time() - t0)
                if bus is not None:
                    per_step.append(bus.emitted / sum(r.steps for r in res))
                    # The incident plane's tap saw every event; a clean
                    # slice opens no incident.
                    ring, det = telemetry.get_flight_ring(), telemetry.get_incident_detector()
                    check(ring is not None and ring.noted == bus.emitted and det.opened == 0,
                          f"15c: the incident plane saw {ring and ring.noted} of {bus.emitted} events, opened "
                          f"{det and det.opened}")
            check(summary(res) == summary(plain), f"15c: telemetry {mode} changed the slice's results")
    busy = {}
    for mode in ("off", "on"):
        with tempfile.TemporaryDirectory() as tmp:
            scope = telemetry.telemetry_run(os.path.join(tmp, "tel")) if mode == "on" else contextlib.nullcontext()
            with scope:
                busy[mode], _ = _profile_steps(
                    lambda: run_hpo(configs[:1], train, test, groups=[group], out_dir=tmp, verbose=False),
                    len(train) // 128, guard="elbo_fwd")
    med = {m: statistics.median(w) for m, w in walls.items()}
    print(f"15c telemetry off vs on (the incident plane armed), phase 6's slice ({steps} steps, checkpoints on), "
          f"rounds {TELEMETRY_ROUNDS}: wall s "
          f"off {walls['off']} (median {med['off']:.6f}), on {walls['on']} (median {med['on']:.6f}), on/off "
          f"{med['on'] / med['off']:.4f}; events per step {per_step}; device busy ms per step over one epoch "
          f"of trial 0 (468 steps) off {busy['off']}, on {busy['on']} ({smi})")
    return {"launches": launches, "walls": walls, "busy": busy}


def conv_resume(E, group, smi: str) -> dict:
    """Phase 15d (ROADMAP C.18): a ConvVAE trial (phase 14a's: latent 64,
    base channels 32, batch 128, chunks of 10) of 2 epochs of
    ``synthetic_cifar10`` at CIFAR size, with a CRASH from a ``FaultPlan``
    at step 585 (mid-epoch 2); the supervised retry resumes from the epoch-1
    checkpoint. Under ``cudnn.deterministic`` (set here, then restored) it
    ends bit-identical to the uninterrupted run (the final checkpoint, its
    history and generator states). Under cuDNN's defaults, which the port
    keeps, it ends within ``_graph_within_spread``'s bound of every
    uninterrupted run: the larger of 4x the spread of ``SPREAD_RUNS``
    uninterrupted runs and the floors, over the per-epoch train and test
    losses and the final parameters. Counts set to 0 just before the
    faulted run under the defaults and read just after: each ELBO kernel
    once per executed step of both attempts."""
    from multidisttorch_tpu_torch.data.datasets import synthetic_cifar10
    from multidisttorch_tpu_torch.faults.plan import CRASH, FaultPlan, FaultSpec
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.models import ConvVAE
    from multidisttorch_tpu_torch.train import checkpoint as ck

    train = synthetic_cifar10(50000, seed=0)
    test = synthetic_cifar10(10000, seed=1)
    cfg = TrialConfig(trial_id=0, epochs=2, batch_size=128, lr=1e-3, beta=1.0, seed=0, fused_steps=10)
    per_epoch = len(train) // 128

    def run(out, plan=None):
        (r,) = run_hpo([cfg], train, test, groups=[group], out_dir=out, verbose=False, save_images=False,
                       model_builder=lambda c: ConvVAE(latent_dim=64, base_channels=32), resilient=True,
                       retry=RetryPolicy(max_retries=1, backoff_base_s=0.01), fault_plan=plan)
        torch.cuda.synchronize()
        check(r.status == "completed" and r.steps == 2 * per_epoch, f"15d: {r.status} {r.steps} steps {r.error}")
        if plan is not None:
            check(r.attempt == 2 and r.resumed_from_step == per_epoch,
                  f"15d: attempt {r.attempt}, resumed from step {r.resumed_from_step}, expected 2 and {per_epoch}")
        return r

    def values(r, out):
        tree = ck._read_tree(os.path.join(out, "trial-0", "state.msgpack"))
        params = {}

        def walk(t, prefix):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}/{k}")
                else:
                    params[f"{prefix}/{k}"] = torch.as_tensor(v, dtype=torch.float64)

        walk(tree["params"], "params")
        hist = torch.tensor([h[k] for h in r.history for k in ("avg_train_loss", "test_loss")], dtype=torch.float64)
        return hist, params

    plan = FaultPlan(specs=(FaultSpec(CRASH, 0, step=CONV_RESUME_CRASH),))
    with tempfile.TemporaryDirectory() as tmp:
        with _cudnn_deterministic():
            run(os.path.join(tmp, "det_straight"))
            run(os.path.join(tmp, "det_retry"), plan)
            _same_checkpoint(ck, os.path.join(tmp, "det_straight"), os.path.join(tmp, "det_retry"),
                             "15d under cudnn.deterministic")
        check(not torch.backends.cudnn.deterministic, "15d: cudnn.deterministic was not restored")
        straight = []
        for i in range(SPREAD_RUNS):
            out = os.path.join(tmp, f"straight{i}")
            straight.append(values(run(out), out))
        for k in E.LAUNCHES:
            E.LAUNCHES[k] = 0
        out = os.path.join(tmp, "retry")
        r = run(out, plan)
        launches = dict(E.LAUNCHES)
        retried = values(r, out)
        failed = [e for e in SweepLedger(out).load() if e.get("status") == "retrying"]
    check(len(failed) == 1, f"15d: {len(failed)} retrying records, expected 1")
    executed = failed[0]["summary"]["steps_at_failure"] + per_epoch
    for k in ("elbo_fwd", "elbo_bwd"):
        check(launches[k] == executed, f"15d: {k} launched {launches[k]} times in {executed} executed steps")
    pairs = [_distance(straight[i], straight[j]) for i in range(SPREAD_RUNS) for j in range(i + 1, SPREAD_RUNS)]
    spread = (max(p[0] for p in pairs), max(p[1] for p in pairs))
    floors = (SPREAD_VALUE_FLOOR * max(float(s[0].abs().max()) for s in straight), cfg.lr * 2 * per_epoch)
    bound = tuple(max(SPREAD_FACTOR * s, f) for s, f in zip(spread, floors))
    to_straight = [_distance(retried, s) for s in straight]
    for k, name in ((0, "per-epoch losses"), (1, "final parameters")):
        worst = max(d[k] for d in to_straight)
        check(worst <= bound[k], f"15d defaults: retried vs uninterrupted {name} max |diff| {worst:.3e}, beyond the "
              f"bound {bound[k]:.3e} (spread {spread[k]:.3e}, floor {floors[k]:.3e})")
    print(f"15d ConvVAE resume (ROADMAP C.18): CRASH at step {CONV_RESUME_CRASH}, retry from the epoch-1 checkpoint; "
          f"under cudnn.deterministic bit-identical to the uninterrupted run (distance 0); under the defaults "
          f"{SPREAD_RUNS} uninterrupted runs differ pairwise by " + ", ".join(f"{v:.3e}" for v, _ in pairs)
          + " in the per-epoch losses and " + ", ".join(f"{p:.3e}" for _, p in pairs) + " in the final parameters; "
          "the retried run differs from each by " + ", ".join(f"{v:.3e}" for v, _ in to_straight) + " and "
          + ", ".join(f"{p:.3e}" for _, p in to_straight) + f" (bounds {bound[0]:.3e}, {bound[1]:.3e}: the larger of "
          f"{SPREAD_FACTOR:g} x the spread and the floors {floors[0]:.3e}, {floors[1]:.3e}); launches {launches} "
          f"({_conv_flags()}; {smi})")
    return {"launches": launches, "spread": spread, "to_straight": to_straight, "bound": bound}


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


# --- phase 16: compile and dispatch (the program registry, the farm, the
# quarantine and the cold-start bench) ---------------------------------------

# 16a's sweep: 3 seeds x 2 lrs of the 784-400-20 VAE, one MNIST-sized epoch
# at batch 128 in chunks of 10 (468 steps: 46 chunks and a tail of 8).
COMPILE_SEEDS, COMPILE_LRS = (0, 1, 2), (1e-3, 2e-3)


def _registry_sweep(E, what: str, cfgs, groups, train, test, tmp: str, *, reset_each: bool = False,
                    reset: bool = True, **kw) -> dict:
    """One way of 16a (or a run of 16b-d): the registry emptied and the
    launch counts set to 0 just before, telemetry on, everything read just
    after. ``reset_each`` runs every config alone on its group (item j on
    group j % n, the driver's own placement) with the registry emptied
    before each: every admission captures inline."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.compile.registry import get_executable_registry
    from multidisttorch_tpu_torch.hpo.driver import run_hpo
    from multidisttorch_tpu_torch.telemetry.events import EVENTS_NAME, read_events
    from multidisttorch_tpu_torch.telemetry.export import SweepFold
    from multidisttorch_tpu_torch.telemetry.metrics import capture_books

    from multidisttorch_tpu_torch.telemetry import device as tele_device

    reg = get_executable_registry()
    if reset:
        reg.reset()
    # This thread's stream only: a farm worker may be capturing, and a
    # device-wide sync fails a capture.
    torch.cuda.current_stream().synchronize()
    for key in E.LAUNCHES:
        E.LAUNCHES[key] = 0
    memo0 = len(tele_device._cost_cache)
    tel, out = os.path.join(tmp, what, "tel"), os.path.join(tmp, what, "out")
    t0 = time.time()
    with telemetry.telemetry_run(tel):
        if reset_each:
            results = []
            for j, cfg in enumerate(cfgs):
                reg.reset()
                results += run_hpo([cfg], train, test, groups=[groups[j % len(groups)]], out_dir=out, verbose=False,
                                   save_images=False, **kw)
        else:
            results = run_hpo(cfgs, train, test, groups=groups, out_dir=out, verbose=False, save_images=False, **kw)
        torch.cuda.current_stream().synchronize()
        books = capture_books()
    wall = time.time() - t0
    fold = SweepFold()
    for ev in read_events(os.path.join(tel, EVENTS_NAME)):
        fold.feed(ev)
    snap = reg.snapshot()
    check(not any(v["status"] == "failed" for v in snap.values()), f"16 {what}: a FAILED registry entry: {snap}")
    check(not any(v["held"] for v in snap.values()), f"16 {what}: a slot was not given back: {snap}")
    return {"results": sorted(results, key=lambda r: r.trial_id), "fold": fold, "wall": wall,
            "launches": dict(E.LAUNCHES), "counted": len(tele_device._cost_cache) - memo0, "snapshot": snap,
            "out": out, "books": books,
            "graphs": sum(b["captures"] for b in books.values())}


def _same_sweep(ck, a: dict, b: dict, what: str) -> None:
    """Every trial of two runs: the same per-epoch losses and test loss (float
    hex) and the same final checkpoint, bit for bit."""
    check(len(a["results"]) == len(b["results"]), f"{what}: {len(a['results'])} vs {len(b['results'])} trials")
    for x, y in zip(a["results"], b["results"]):
        check(x.trial_id == y.trial_id and x.status == y.status == "completed",
              f"{what}: trial {x.trial_id} {x.status} {x.error} / {y.status} {y.error}")
        hx = [float(h["avg_train_loss"]).hex() for h in x.history]
        hy = [float(h["avg_train_loss"]).hex() for h in y.history]
        check(hx == hy and float(x.final_test_loss).hex() == float(y.final_test_loss).hex(),
              f"{what}: trial {x.trial_id} losses {hx} {x.final_test_loss!r} vs {hy} {y.final_test_loss!r}")
        _same_checkpoint(ck, a["out"], b["out"], f"{what} trial {x.trial_id}", trial_id=x.trial_id)


def _admissions(fold) -> dict:
    """trial id -> [(outcome, admission seconds), ...] in attempt order."""
    out: dict = {}
    for a in fold.admissions:
        out.setdefault(a["trial_id"], []).append((a["outcome"], a["admission_s"]))
    return out


def slot_generator_check(group) -> None:
    """16a, first: a slot's generator, registered with the slot's graph,
    takes each trial's stream by value (``Generator.set_state``), so two
    trials served one after the other by one slot draw exactly the noise
    each draws through a graph of its own."""
    from multidisttorch_tpu_torch.compile import programs as cprog
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train.steps import create_train_state, make_multi_step

    cfg = TrialConfig(trial_id=0, fused_steps=4)
    key = cprog.single_key(group, cfg, cprog.bucket_key_of(cfg))
    x = torch.rand(3, 4, 128, 784, generator=torch.Generator().manual_seed(5)).to(group.device)
    slot = cprog.build_single_slot(group, cfg, key)  # captured ahead, on scratch state

    def trial(seed, via_slot):
        state = create_train_state(group, init_vae_params(VAE(), seed), cfg.lr)
        gen = torch.Generator(device=group.device).manual_seed(1000 + seed)
        if via_slot:
            state, gen, multi = slot.bind(state, gen), slot.generator, slot.step
        else:
            multi = make_multi_step(group)
        losses = torch.cat([multi(state, x[i], generator=gen)[1]["loss_sum"] for i in range(3)])
        return losses, {k: v.clone() for k, v in state.model.state_dict().items()}, gen.get_state()

    for seed in (3, 4):
        a, b = trial(seed, True), trial(seed, False)
        check(torch.equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
              and torch.equal(a[2], b[2]),
              f"16a: a slot-served trial (seed {seed}) differs from its own graphs: losses {a[0]} vs {b[0]}")
    check(slot.step.captures == 1 and slot.step.replays == 6,
          f"16a: the slot captured {slot.step.captures} times and replayed {slot.step.replays}, expected 1 and 6")
    slot.free()
    print("16a slot generator: two trials through one slot (captured ahead on scratch state), 3 chunks of 4 each: "
          "losses, parameters and generator states bit-identical to each trial's own graphs; 1 capture, 6 replays")


def registry_parity(E, smi: str, train, test, tmp: str) -> dict:
    """16a: the six seed replicas three ways (a fresh registry per trial, one
    shared registry, the farm), bit-identical; captures per way."""
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.train import checkpoint as ck

    groups = setup_groups(2, devices=["cuda:0"] * 2)
    slot_generator_check(groups[0])
    # Item j on group j % 2 with lr j % 2: each group's later items are its
    # program's replicas.
    cfgs = [TrialConfig(trial_id=j, epochs=1, batch_size=128, lr=COMPILE_LRS[j % 2], seed=COMPILE_SEEDS[j // 2],
                        fused_steps=10, log_interval=10_000) for j in range(6)]
    ways = {
        "fresh": _registry_sweep(E, "16a_fresh", cfgs, groups, train, test, tmp, reset_each=True),
        "shared": _registry_sweep(E, "16a_shared", cfgs, groups, train, test, tmp),
        "precompile": _registry_sweep(E, "16a_precompile", cfgs, groups, train, test, tmp, precompile=True),
    }
    for name in ("shared", "precompile"):
        _same_sweep(ck, ways["fresh"], ways[name], f"16a {name} vs fresh")
    want = {"fresh": 6, "shared": 2, "precompile": 2}
    steps = sum(r.steps for r in ways["fresh"]["results"])
    for name, w in ways.items():
        fold, adm = w["fold"], _admissions(w["fold"])
        check(fold.compiles == want[name], f"16a {name}: {fold.compiles} captures, expected {want[name]}")
        outcomes = [o for t in sorted(adm) for o, _ in adm[t]]
        if name == "precompile":
            check(set(outcomes) <= {"hit", "wait"} and fold.precompile.get("plan") == 1,
                  f"16a precompile: admissions {outcomes}, farm {fold.precompile}")
        elif name == "shared":
            check(outcomes == ["inline", "inline", "hit", "hit", "hit", "hit"], f"16a shared: admissions {outcomes}")
        else:
            check(outcomes == ["inline"] * 6, f"16a fresh: admissions {outcomes}")
        # Each ELBO kernel once per train step; the farm's captures add one
        # warm-up chunk of 10 steps on scratch state per program, and a
        # device book's counted step (telemetry is on) one eager step per
        # program shape the process had not counted yet.
        extra = (10 * fold.precompile.get("scheduled", 0) if name == "precompile" else 0) + w["counted"]
        for key in ("elbo_fwd", "elbo_bwd"):
            check(w["launches"][key] == steps + extra,
                  f"16a {name}: {key} launched {w['launches'][key]} times, expected {steps} + {extra}")
        lat = ", ".join(f"t{t}: " + "/".join(f"{o} {s * 1e3:.1f} ms" for o, s in adm[t]) for t in sorted(adm))
        print(f"16a {name}: {fold.compiles} programs captured ({w['graphs']} graphs: the chunk of 10 and the tail "
              f"of 8 each), {fold.cache_hits} hits, sweep wall {w['wall']:.3f} s; admission latency "
              f"(first_dispatch - attempt_start): {lat} ({smi})")
    blocked = any(o not in ("hit", "wait") for t in _admissions(ways["precompile"]["fold"]).values() for o, _ in t)
    check(not blocked, "16a precompile: admission_blocked_on_compile")
    print("16a: 6 trials x 468 steps, losses and final checkpoints bit-identical across the fresh, shared and "
          "precompiled ways; admission_blocked_on_compile 0 with the farm")
    return {name: w["launches"] for name, w in ways.items()}


def registry_retry(E, smi: str, train, test, tmp: str) -> dict:
    """16b: a FaultPlan crash in epoch 2 of a precompiled sweep; the retried
    attempt resumes from its epoch-1 checkpoint through its slot (a hit)
    and ends bit-identical to its fault-free run."""
    from multidisttorch_tpu_torch.faults import CRASH, FaultPlan, FaultSpec
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.train import checkpoint as ck

    groups = setup_groups(2, devices=["cuda:0"] * 2)
    cfgs = [TrialConfig(trial_id=j, epochs=2, batch_size=128, lr=COMPILE_LRS[j % 2], seed=j, fused_steps=10,
                        log_interval=10_000) for j in range(2)]
    clean = _registry_sweep(E, "16b_clean", cfgs, groups, train, test, tmp, precompile=True)
    faulted = _registry_sweep(E, "16b_fault", cfgs, groups, train, test, tmp, precompile=True,
                              retry=RetryPolicy(max_retries=2, backoff_base_s=0.0),
                              fault_plan=FaultPlan(specs=(FaultSpec(CRASH, 0, step=600),)))
    _same_sweep(ck, clean, faulted, "16b retried vs fault-free")
    adm = _admissions(faulted["fold"])
    check([o for o, _ in adm[0]][1:] == ["hit"] and len(adm[0]) == 2 and faulted["results"][0].attempt == 2
          and faulted["results"][0].resumed_from_step == 468,
          f"16b: trial 0 admissions {adm[0]}, attempt {faulted['results'][0].attempt}, resumed from "
          f"{faulted['results'][0].resumed_from_step}")
    print(f"16b: trial 0 crashed at step 600, retried from its epoch-1 checkpoint (step 468) through its slot "
          f"(admissions {[o for o, _ in adm[0]]}), final checkpoint and losses bit-identical to its fault-free run; "
          f"every slot back in the registry ({smi})")
    return faulted["launches"]


def farm_under_load(E, smi: str, train, test, tmp: str) -> dict:
    """16c: farm workers capture twelve programs of group 1 while the main
    thread replays a stacked bucket's graphs on group 0 with the native
    feed's copy stream live; the bucket's lanes end bit-identical to its run
    without the farm."""
    from multidisttorch_tpu_torch.compile import programs as cprog
    from multidisttorch_tpu_torch.compile.farm import PrecompilePool
    from multidisttorch_tpu_torch.compile.registry import get_executable_registry
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    g0, g1 = setup_groups(2, devices=["cuda:0"] * 2)
    bucket = [TrialConfig(trial_id=j, epochs=1, batch_size=128, lr=1e-3 * (1 + j), seed=j, fused_steps=10,
                          log_interval=10_000) for j in range(4)]
    kw = dict(stack_trials=True, stack_max_lanes=4, save_checkpoints=False)
    alone = _registry_sweep(E, "16c_alone", bucket, [g0], train, test, tmp, **kw)
    reg = get_executable_registry()
    reg.reset()
    pool = PrecompilePool(workers=2)
    spans = []
    for j in range(12):
        cfg = TrialConfig(trial_id=100 + j, lr=1e-4 * (j + 1), fused_steps=10)
        key = cprog.single_key(g1, cfg, cprog.bucket_key_of(cfg))

        def build(cfg=cfg, key=key):
            t0 = time.time()
            slot = cprog.build_single_slot(g1, cfg, key)
            spans.append((t0, time.time()))
            return slot

        pool.submit(key, build)
    t_run = time.time()
    loaded = _registry_sweep(E, "16c_farm", bucket, [g0], train, test, tmp, reset=False, **kw)
    t_end = t_run + loaded["wall"]
    check(pool.drain(timeout_s=300), "16c: the farm did not drain")
    pool.shutdown(wait=True)
    overlapped = sum(1 for a, b in spans if a < t_end and b > t_run)
    check(len(spans) == 12 and overlapped >= 1, f"16c: {len(spans)} captures, {overlapped} during the bucket's run")
    for x, y in zip(alone["results"], loaded["results"]):
        check(x.history == y.history and float(x.final_test_loss).hex() == float(y.final_test_loss).hex(),
              f"16c: lane of trial {x.trial_id} changed under the farm: {x.history} vs {y.history}")
    print(f"16c: 12 programs of group 1 captured by 2 farm workers, {overlapped} of them during the stacked "
          f"bucket's run on group 0 ({loaded['wall']:.3f} s, the native feed prefetching on its copy stream); the "
          f"bucket's 4 lanes bit-identical to its run alone ({smi})")
    return {"alone": alone["launches"], "farm": loaded["launches"]}


def stacked_and_pbt_slots(E, smi: str, train, test, tmp: str) -> dict:
    """16d: two stacked buckets of 4 lanes on one group, one after the
    other, take one capture between them, their lanes bit-identical to the
    per-bucket run (the registry off); a second fused PBT run takes the
    first's captured generation, generations 2 onward booking a hit."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.compile.registry import get_executable_registry
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig
    from multidisttorch_tpu_torch.hpo.pbt import PBTConfig, run_pbt
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    (g,) = setup_groups(1, devices=["cuda:0"])
    kw = dict(stack_trials=True, stack_max_lanes=4, save_checkpoints=False)

    def buckets():
        return [[TrialConfig(trial_id=4 * b + j, epochs=1, batch_size=128, lr=1e-3 * (1 + j), seed=4 * b + j,
                             fused_steps=10, log_interval=10_000) for j in range(4)] for b in range(2)]

    reg = get_executable_registry()
    runs = {}
    cfgs = buckets()
    for mode in ("per_bucket", "registry"):
        if mode == "per_bucket":
            os.environ["MDT_AOT_ADMISSION"] = "0"
        try:
            first = _registry_sweep(E, f"16d_{mode}_0", cfgs[0], [g], train, test, tmp, **kw)
            second = _registry_sweep(E, f"16d_{mode}_1", cfgs[1], [g], train, test, tmp, reset=False, **kw)
        finally:
            os.environ.pop("MDT_AOT_ADMISSION", None)
        launches = {k: first["launches"][k] + second["launches"][k] for k in E.LAUNCHES}
        runs[mode] = (first["results"] + second["results"], first["fold"].compiles + second["fold"].compiles,
                      first["fold"].cache_hits + second["fold"].cache_hits,
                      [a["outcome"] for w in (first, second) for a in w["fold"].admissions], launches)
    (pres, _, _, pout, _), (rres, rcap, rhits, rout, rlaunch) = runs["per_bucket"], runs["registry"]
    check(rcap == 1 and rhits == 1 and rout == ["inline", "hit"] and pout == ["graph", "graph"],
          f"16d buckets: {rcap} captures, {rhits} hits, admissions {rout} (registry off: {pout})")
    for x, y in zip(pres, rres):
        check(x.history == y.history and float(x.final_test_loss).hex() == float(y.final_test_loss).hex(),
              f"16d: trial {x.trial_id} differs from its per-bucket run: {x.history} vs {y.history}")
    print(f"16d buckets: two buckets of 4 lanes on one group took 1 capture between them (admissions {rout}); "
          f"8 lanes bit-identical to the per-bucket run ({smi})")

    cfg = PBTConfig(population=4, generations=3, steps_per_generation=20, batch_size=128, seed=3)
    reg.reset()
    for key in E.LAUNCHES:
        E.LAUNCHES[key] = 0
    with telemetry.telemetry_run():
        first = run_pbt(cfg, train, test, fused=True, verbose=False, groups=[g])
        second = run_pbt(cfg, train, test, fused=True, verbose=False, groups=[g])
        kinds = [e.kind for e in telemetry.get_bus().recent() if e.kind in ("compile_end", "cache_hit")]
    torch.cuda.synchronize()
    pbt_launches = dict(E.LAUNCHES)
    check(kinds == ["compile_end"] + ["cache_hit"] * 5, f"16d PBT: registry events {kinds}")
    check(first.dispatch_book["captures"] == 1 and second.dispatch_book["captures"] == 0
          and second.dispatch_book["graph_replays"] == 3,
          f"16d PBT: captures {first.dispatch_book['captures']}, {second.dispatch_book['captures']}; second run's "
          f"replays {second.dispatch_book['graph_replays']}")
    check(first.history == second.history and first.final_lrs == second.final_lrs,
          "16d PBT: the second run through the captured generation differs from the first")
    print(f"16d PBT: two fused runs (K 4, 3 generations of 20 steps): 1 capture in the process, cache_hit on "
          f"generations 2-3 of the first and 1-3 of the second; the same population history ({smi})")
    return {"buckets": rlaunch, "pbt": pbt_launches}


def eviction_and_cache(smi: str, tmp: str) -> None:
    """16e: with ``MDT_REGISTRY_MAX_PROGRAMS=2`` a third program evicts the
    least recently used one, whose graphs and state are freed; the scan
    quarantines a truncated copy of the ELBO library; the canary passes on
    the real libraries."""
    import gc
    import shutil

    from multidisttorch_tpu_torch.compile import cache
    from multidisttorch_tpu_torch.compile import programs as cprog
    from multidisttorch_tpu_torch.compile.registry import ExecutableRegistry, get_executable_registry
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig
    from multidisttorch_tpu_torch.ops import _build
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    get_executable_registry().reset()
    (g,) = setup_groups(1, devices=["cuda:0"])
    _warm_pool_streams(g.device)  # the pool streams' cuBLAS workspaces live as long as the process
    os.environ["MDT_REGISTRY_MAX_PROGRAMS"] = "2"
    try:
        reg = ExecutableRegistry()
    finally:
        os.environ.pop("MDT_REGISTRY_MAX_PROGRAMS")
    check(reg.max_programs == 2, f"16e: the cap read {reg.max_programs}")
    cfgs = [TrialConfig(trial_id=j, lr=1e-3 * (j + 1), fused_steps=10) for j in range(3)]
    keys = [cprog.single_key(g, c, cprog.bucket_key_of(c)) for c in cfgs]

    def mem():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    m = [mem()]
    for c, k in zip(cfgs[:2], keys[:2]):
        check(reg.compile_now(k, lambda c=c, k=k: cprog.build_single_slot(g, c, k)).status == "ready",
              "16e: a slot failed")
        m.append(mem())
    slot_state = reg.entry(keys[0]).compiled.nbytes()
    before = mem()
    reg.schedule(keys[2])  # the third entry: the least recently used slot goes
    after = mem()
    check(reg.status(keys[0]) is None and reg.evicted == 1, f"16e: {reg.snapshot()}")
    freed = before - after
    check(freed >= slot_state, f"16e: eviction freed {freed} bytes, less than the slot's state ({slot_state} bytes)")
    reg.release(keys[2])
    reg.reset()
    end = mem()
    print(f"16e eviction: memory_allocated {m[0]} -> {m[1]} -> {m[2]} bytes with two slots (captured ahead), the "
          f"third key's entry evicted the first: {freed} bytes freed (its state alone {slot_state}); after reset "
          f"{end} bytes ({end - m[0]:+d} against before the slots) ({smi})")
    check(end - m[0] <= (m[1] - m[0]) // 2, f"16e: {end - m[0]} bytes left after reset; one slot took {m[1] - m[0]}")

    # The quarantine, on copies of the real libraries.
    real = {cache.library_name(p.name): p for p in _build.BUILD_DIR.iterdir() if cache.library_name(p.name)}
    scratch = os.path.join(tmp, "16e_kernels")
    os.makedirs(scratch)
    for p in real.values():
        shutil.copy(p, scratch)
    cache.seal_cache(scratch)
    torn = os.path.join(scratch, real["elbo"].name)
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    scan = cache.scan_cache(scratch)
    check(scan["rejected"] == [{"entry": real["elbo"].name, "reason": "size_mismatch"}] and not os.path.exists(torn),
          f"16e: scan {scan}")
    shutil.copy(real["elbo"], scratch)
    cache.seal_cache(scratch)
    t0 = time.time()
    can = cache.canary_quarantine(scratch, timeout_s=300)
    check(can["passed"] and can["evicted"] == 0 and len(can["libraries"]) == len(real), f"16e canary: {can}")
    errs = ", ".join(f"{cache.library_name(n)} {r['max_err']:.3e}" for n, r in sorted(can["libraries"].items()))
    print(f"16e quarantine: a truncated copy of {real['elbo'].name} quarantined (size_mismatch); the canary passed "
          f"on the {len(real)} real libraries in {time.time() - t0:.1f} s (one child each, together; max errors "
          f"against the plain versions {errs})")


def coldstart_phase(smi: str, tmp: str) -> None:
    """16f: the cold-start bench's three children (cold, farm, cache-warm)
    with its gates, at its fixed sweep cut to 1 epoch (admission is over
    in the first; the other 7 add wall time only)."""
    from multidisttorch_tpu_torch.compile import coldstart

    t0 = time.time()
    rec = coldstart.run_coldstart_bench(os.path.join(tmp, "16f"), device="cuda", epochs=1, timeout_s=300)
    for mode in coldstart.MODES:
        r = rec["modes"][mode]
        check(r.get("ok"), f"16f {mode}: {r.get('error')} {r.get('stderr_tail', '')}")
    check(rec["parity"], f"16f: the modes' losses differ: {rec['parity_mismatches']}")
    check(rec["admission_blocked_on_compile"] is False and rec["admission_blocked_on_compile_warm"] is False,
          "16f: an admission captured on the host loop with the farm on")
    check(rec["cache_verdict"] == "enabled", f"16f: cache verdict {rec['cache_verdict']}")
    parts = []
    for mode in coldstart.MODES:
        r = rec["modes"][mode]
        lat = r["books"]["latencies_s"]
        builds = ("built " + ", ".join(f"{n} in {s:.1f} s" for n, s in sorted(r["build_s"].items()))
                  if r["build_s"] else "no build (sealed, canaried)")
        parts.append(f"{mode}: mean admission {1e3 * r['books']['mean_admission_s']:.1f} ms (max "
                     f"{1e3 * max(lat):.1f}), child {r['child_wall_s']:.1f} s, sweep {r['wall_s']:.2f} s, {builds}")
    print(f"16f cold-start ({len(coldstart.COLDSTART_HIDDENS)} buckets, {rec['epochs']} epochs of "
          f"{coldstart.COLDSTART_ROWS} rows at batch {coldstart.COLDSTART_BATCH}): " + "; ".join(parts)
          + f"; speedup cold/precompiled {rec['speedup_cold_over_precompiled']:.2f}, cold/cache-warm "
          f"{rec['speedup_cold_over_cache_warm']:.2f}; losses bit-identical; admission_blocked_on_compile 0; "
          f"{time.time() - t0:.1f} s ({smi})")
    print("COLDSTART_JSON " + json.dumps({k: v for k, v in rec.items() if k != "modes"}, default=str))


def compile_phase(E, smi: str, train, test) -> dict:
    """Phase 16, with the registry on (the port's default)."""
    os.environ.pop("MDT_AOT_ADMISSION", None)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        parity = registry_parity(E, smi, train, test, tmp)
        retry = registry_retry(E, smi, train, test, tmp)
        farm = farm_under_load(E, smi, train, test, tmp)
        slots = stacked_and_pbt_slots(E, smi, train, test, tmp)
        eviction_and_cache(smi, tmp)
        coldstart_phase(smi, tmp)
    print(f"phase 16: {time.time() - t0:.1f} s")
    return {"parity": parity, "retry": retry, "farm": farm, "slots": slots}


# --- phase 0: the backend preflight; phase 17: device books, the anomaly
# monitor, profiling and the families' books ---------------------------------


def preflight_phase() -> dict:
    """Phase 0, before anything in this process touches CUDA: the port's
    preflight on the card (``healthy``, or ``transient_recovered`` printed as
    such, with the canary's 512.0), its CLI in a child (the same verdict,
    exit 0), and a child with no visible card (``backend_absent`` in under
    5 s, no retry). An unusable verdict fails the script."""
    from multidisttorch_tpu_torch.utils import preflight

    t0 = time.time()
    # The CLI child and the child with no visible card run beside the
    # in-process probe (each probe child is a process of its own).
    cmd = [sys.executable, "-m", "multidisttorch_tpu_torch.utils.preflight", "--json"]
    cli = subprocess.Popen(cmd + ["--no-canary"], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    absent = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    rep = preflight.run_preflight()
    stages = [(s["stage"], s.get("ok"), s.get("elapsed_s")) for s in rep["stages"]]
    check(rep["usable"], f"phase 0: preflight verdict {rep['verdict']}: {rep['verdict_reason']} (stages {stages})")
    canary = next(s for s in rep["stages"] if s["stage"] == "canary")
    check(canary["canary_value"] == 512.0, f"phase 0: canary value {canary.get('canary_value')}")
    print(f"0 preflight: verdict {rep['verdict']} ({rep['verdict_reason']}), stages {stages}, canary "
          f"{canary['canary_value']}, {rep['device']}, {rep['elapsed_s']} s")
    out, err = cli.communicate(timeout=600)
    got = json.loads(out.strip().splitlines()[-1]) if cli.returncode == 0 else {}
    check(cli.returncode == 0 and got.get("verdict") == rep["verdict"],
          f"phase 0: the CLI exited {cli.returncode} with {got.get('verdict')} ({err[-300:]})")
    out, err = absent.communicate(timeout=120)
    arep = json.loads(out.strip().splitlines()[-1])
    check(absent.returncode == 3 and arep["verdict"] == "backend_absent" and arep["elapsed_s"] < 5.0
          and all(s["stage"] != "init_retry" for s in arep["stages"]),
          f"phase 0: with no visible card: rc {absent.returncode}, {arep['verdict']} in {arep['elapsed_s']} s, "
          f"stages {[s['stage'] for s in arep['stages']]}")
    print(f"0 preflight CLI (--no-canary): verdict {got['verdict']}, exit 0; CUDA_VISIBLE_DEVICES='': "
          f"{arep['verdict']} in {arep['elapsed_s']} s ({arep['verdict_reason']}), exit 3, no retry; phase 0 "
          f"{time.time() - t0:.1f} s")
    return rep


def _vae_step_count(device, hidden: int = 400, latent: int = 20, batch: int = 128, *, model=None, x=None,
                    classifier: bool = False) -> dict:
    """One step of the given family's step builder counted on ``device``
    (``telemetry/device.py::count_step``), on a fresh model at the family's
    widths: the books' reference count."""
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.telemetry import device as tele_device
    from multidisttorch_tpu_torch.train.classifier import create_classifier_state, make_classifier_train_step
    from multidisttorch_tpu_torch.train.steps import create_train_state, make_train_step

    (g,) = setup_groups(1, devices=[str(device)])
    if classifier:
        state = create_classifier_state(g, model, 1e-3, seed=0)
        step = make_classifier_train_step(g)
        images, labels = (t.to(g.device) for t in x)
        return tele_device.count_step(lambda: step(state, images, labels))
    if model is None:
        model = init_vae_params(VAE(hidden_dim=hidden, latent_dim=latent), 0)
    else:
        model.init_params(0)
    state = create_train_state(g, model, 1e-3)
    step = make_train_step(g)
    gen = torch.Generator(device=g.device).manual_seed(0)
    xb = (torch.rand(batch, 784) if x is None else x).to(g.device)
    return tele_device.count_step(lambda: step(state, xb, generator=gen))


def _books_of(bus, reg) -> dict:
    from multidisttorch_tpu_torch.telemetry import export

    return export.run_summary([e.to_dict() for e in bus.recent()], reg)


def device_books_phase(E, smi: str, train, test, tmp: str) -> dict:
    """17a: 16a's sweep (six trials of the 784-400-20 VAE, one MNIST-sized
    epoch in chunks of 10 on two groups, through the registry) with
    telemetry off and on (an in-memory bus and registry): bits identical;
    every trial's book counted to the integer as the same step on CPU
    copies, MFU recomputable from the registry, bandwidth-bound, peak memory
    from the allocator; then one stacked bucket of 8 lanes, whose lane-step
    books the trial's FLOPs; the device busy per step off and on."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.compile.registry import get_executable_registry
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.telemetry import device as tele_device
    from multidisttorch_tpu_torch.train import checkpoint as ck

    groups = setup_groups(2, devices=["cuda:0"] * 2)
    cfgs = [TrialConfig(trial_id=j, epochs=1, batch_size=128, lr=COMPILE_LRS[j % 2], seed=COMPILE_SEEDS[j // 2],
                        fused_steps=10, log_interval=10_000) for j in range(6)]
    cpu, card = _vae_step_count("cpu"), _vae_step_count("cuda:0")
    check(cpu["flops"] == card["flops"], f"17a: the step counts {card['flops']} FLOPs on the card, {cpu['flops']} "
          "on CPU copies")
    print(f"17a counted step (784-400-20, batch 128): {cpu['flops']} FLOPs on CPU copies and on the card; bytes "
          f"{cpu['bytes_accessed']} on the CPU, {card['bytes_accessed']} on the card (unfused: every aten op's "
          f"operands and results)")
    runs = {}
    for mode in ("off", "on"):
        get_executable_registry().reset()
        torch.cuda.current_stream().synchronize()
        for k in E.LAUNCHES:
            E.LAUNCHES[k] = 0
        memo0 = len(tele_device._cost_cache)
        out = os.path.join(tmp, f"17a_{mode}")
        t0 = time.time()
        with telemetry.telemetry_run(None) if mode == "on" else contextlib.nullcontext() as bus:
            res = run_hpo(cfgs, train, test, groups=groups, out_dir=out, verbose=False, save_images=False)
            torch.cuda.current_stream().synchronize()
            wall = time.time() - t0
            summary = _books_of(bus, telemetry.get_registry()) if bus is not None else None
            # The series books as device_books reads them.
            snap = telemetry.get_registry().step_series_snapshots() if bus is not None else None
        runs[mode] = {"results": sorted(res, key=lambda r: r.trial_id), "out": out, "wall": wall, "summary": summary,
                      "snap": snap, "launches": dict(E.LAUNCHES), "counted": len(tele_device._cost_cache) - memo0}
    _same_sweep(ck, runs["off"], runs["on"], "17a telemetry on vs off")
    steps = sum(r.steps for r in runs["off"]["results"])
    for mode, r in runs.items():
        for key in ("elbo_fwd", "elbo_bwd"):
            # A counted step on the card launches each kernel once, eagerly.
            want = steps + r["counted"]
            check(r["launches"][key] == want, f"17a {mode}: {key} launched {r['launches'][key]}, expected {want}")
    summary, snap = runs["on"]["summary"], runs["on"]["snap"]
    peak_alloc = torch.cuda.max_memory_allocated()
    state_bytes = 3 * 4 * sum(p.numel() for p in _fresh_vae_params())
    rows = []
    for r in runs["on"]["results"]:
        t = summary["trials"][r.trial_id]
        book = summary["device_books"][t["device_series"]]
        ser = snap[book["key"]]
        mfu = round(book["flops_per_step"] * ser["lane_steps"] / ser["total_s"] / (book["peak_flops_per_chip"]
                    * book["devices"]), 6)
        check(book["flops_per_step"] == cpu["flops"], f"17a trial {r.trial_id}: {book['flops_per_step']} FLOPs a "
              f"step, the CPU count {cpu['flops']}")
        check(t["mfu"] is not None and 0 < t["mfu"] <= 1 and t["mfu"] == mfu,
              f"17a trial {r.trial_id}: mfu {t['mfu']} ({t.get('mfu_reason')}), recomputed {mfu}")
        check(t["roofline"] == "bandwidth_bound", f"17a trial {r.trial_id}: roofline {t['roofline']}")
        check(book.get("memory_source") == "memory_stats" and state_bytes <= t["peak_memory_bytes"] <= peak_alloc,
              f"17a trial {r.trial_id}: peak memory {t['peak_memory_bytes']} from {book.get('memory_source')} "
              f"(state {state_bytes}, max_memory_allocated {peak_alloc})")
        rows.append(f"t{r.trial_id} mfu {t['mfu']} flops {book['flops_per_step']:.0f} bytes "
                    f"{book['bytes_per_step']:.0f} peak {t['peak_memory_bytes']}")
    print(f"17a books (telemetry on, {smi}): " + "; ".join(rows))
    print(f"17a sweep wall s off {runs['off']['wall']:.3f}, on {runs['on']['wall']:.3f}; losses and final "
          f"checkpoints bit-identical; counted steps on the card {runs['on']['counted']} (memoised per shape)")

    # The graphs' private pools in the allocator's books.
    a0 = torch.cuda.memory_stats()["allocated_bytes.all.current"]
    x = torch.ones(1 << 24, device="cuda")  # 64 MiB
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2
    torch.cuda.current_stream().wait_stream(side)
    del y
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 2
    a1 = torch.cuda.memory_stats()["allocated_bytes.all.current"]
    in_books = a1 - a0 >= 2 * x.nbytes
    print(f"17a graph pools: a graph's 64 MiB output raised allocated_bytes.all.current by {a1 - a0 - x.nbytes} "
          f"bytes beyond its 64 MiB input: the private pool is {'in' if in_books else 'NOT in'} the books")
    check(in_books, "17a: a CUDA graph's private pool is not in allocated_bytes (telemetry/device.py says it is)")
    del graph, x, y

    # One stacked bucket of 8 lanes on one group.
    (g,) = setup_groups(1, devices=["cuda:0"])
    bucket = [TrialConfig(trial_id=20 + j, epochs=1, batch_size=128, lr=1e-3 * (1 + j), seed=j, fused_steps=10,
                          log_interval=10_000) for j in range(8)]
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    with telemetry.telemetry_run(None) as bus:
        run_hpo(bucket, train, test, groups=[g], out_dir=os.path.join(tmp, "17a_bucket"), verbose=False,
                stack_trials=True, stack_max_lanes=8, save_checkpoints=False)
        torch.cuda.current_stream().synchronize()
        bsum = _books_of(bus, telemetry.get_registry())
    bucket_launches = dict(E.LAUNCHES)
    bbook = bsum["device_books"]["bucket-g0"]
    check(bsum["trials"][20]["device_series"] == "bucket-g0" and bbook["flops_per_step"] == cpu["flops"],
          f"17a bucket: {bbook['flops_per_step']} FLOPs a lane-step, the trial's {cpu['flops']}")
    check(bbook["mfu"] is not None and bbook["roofline"] == "bandwidth_bound",
          f"17a bucket: mfu {bbook['mfu']} ({bbook['mfu_reason']}), roofline {bbook['roofline']}")
    print(f"17a bucket K 8: mfu {bbook['mfu']}, flops per lane-step {bbook['flops_per_step']:.0f} (the trial's), "
          f"bytes {bbook['bytes_per_step']:.0f}, peak memory {bbook['peak_memory_bytes']} ({smi})")

    # Device busy per step, telemetry off and on (one trial, one epoch).
    busy = {}
    for mode in ("off", "on"):
        with telemetry.telemetry_run(None) if mode == "on" else contextlib.nullcontext():
            busy[mode], _ = _profile_steps(
                lambda: run_hpo(cfgs[:1], train, test, groups=[groups[0]], out_dir=os.path.join(tmp, f"17a_b{mode}"),
                                verbose=False, save_images=False), 468, guard="elbo_fwd")
    print(f"17a device busy ms per step over one epoch (468 steps): off {busy['off']}, on {busy['on']} ({smi})")
    return {"off": runs["off"]["launches"], "on": runs["on"]["launches"], "bucket": bucket_launches}


def _fresh_vae_params() -> list:
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params

    return list(init_vae_params(VAE(hidden_dim=400, latent_dim=20), 0).parameters())


def _kernel_count(trace_path: str, name: str) -> int:
    """Device kernel events of a Chrome trace whose name holds ``name``
    as a whole word (``elbo_fwd_kernel``, not ``elbo_fwd_lanes_kernel``)."""
    with open(trace_path) as f:
        evs = json.load(f)["traceEvents"]
    pat = re.compile(rf"\b{name}\b")
    return sum(1 for e in evs if e.get("cat") == "kernel" and pat.search(e.get("name", "")))


def anomaly_drill(E, smi: str, train, test, tmp: str) -> dict:
    """17b: one trial at full width (one MNIST-sized epoch, chunks of 10) with
    a ``slow`` fault of 0.5 s at step 200 and the anomaly capture armed:
    exactly one straggler, at the chunk that ends at step 210; one capture,
    closed after its steps, whose trace holds ELBO launches; the trial's bits
    equal its fault-free run."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.faults.plan import SLOW, FaultPlan, FaultSpec
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.telemetry import anomaly
    from multidisttorch_tpu_torch.train import checkpoint as ck
    from multidisttorch_tpu_torch.utils import profiling

    (g,) = setup_groups(1, devices=["cuda:0"])
    cfg = TrialConfig(trial_id=0, epochs=1, batch_size=128, seed=5, fused_steps=10, log_interval=10_000)
    clean = run_hpo([cfg], train, test, groups=[g], out_dir=os.path.join(tmp, "17b_clean"), verbose=False,
                    save_images=False)
    windows = []

    def factory(log_dir, *, steps):
        w = profiling.profile_window(log_dir, steps=steps)
        windows.append(w)
        return w

    capture_steps = 20
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    cap_dir = os.path.join(tmp, "17b_traces")
    with telemetry.telemetry_run(None) as bus:
        # A ratio floor of 50x the median chunk dispatch: host jitter on a
        # shared machine does not reach it, a 0.5 s stall does.
        anomaly.configure(anomaly.AnomalyConfig(min_ratio=50.0, capture_dir=cap_dir, capture_steps=capture_steps),
                          window_factory=factory)
        drill = run_hpo([cfg], train, test, groups=[g], out_dir=os.path.join(tmp, "17b_drill"), verbose=False,
                        save_images=False, fault_plan=FaultPlan(specs=(FaultSpec(SLOW, 0, step=200, delay_s=0.5),)))
        torch.cuda.current_stream().synchronize()
        evs = [e.to_dict() for e in bus.recent()]
        captures = telemetry.get_registry().counter("profiler_captures").value
    launches = dict(E.LAUNCHES)
    strag = [e for e in evs if e["kind"] == anomaly.STRAGGLER]
    started = [e for e in evs if e["kind"] == anomaly.PROFILER_CAPTURE]
    check(len(strag) == 1 and strag[0]["trial_id"] == 0 and strag[0]["data"]["key"] == "trial-0"
          and strag[0]["step"] == 210,
          f"17b: stragglers {[(e['trial_id'], e['step'], e['data']) for e in strag]}, expected one at step 210")
    check(len(started) == 1 and captures == 1 and len(windows) == 1,
          f"17b: {len(started)} capture events, profiler_captures {captures}, {len(windows)} windows")
    w = windows[0]
    check(not w.active and w.remaining == 0 and w.error is None and w.path is not None,
          f"17b: the window active {w.active}, {w.remaining} ticks left, error {w.error}")
    n_fwd, n_bwd = _kernel_count(w.path, "elbo_fwd_kernel"), _kernel_count(w.path, "elbo_bwd_kernel")
    check(n_fwd > 0 and n_bwd > 0, f"17b: the capture's trace holds {n_fwd} elbo_fwd and {n_bwd} elbo_bwd launches")
    hx = [float(h["avg_train_loss"]).hex() for h in drill[0].history]
    check(hx == [float(h["avg_train_loss"]).hex() for h in clean[0].history]
          and float(drill[0].final_test_loss).hex() == float(clean[0].final_test_loss).hex(),
          "17b: the slow fault changed the trial's losses")
    _same_checkpoint(ck, os.path.join(tmp, "17b_clean"), os.path.join(tmp, "17b_drill"), "17b slow fault")
    s = strag[0]["data"]
    print(f"17b anomaly drill: one straggler at step 210 ({s['step_time_s']} s a step against a median of "
          f"{s['median_s']} s, ratio {s['ratio']}, z {s['z']}); one capture of {capture_steps} chunks "
          f"({capture_steps * 10} steps) closed by itself, its trace {os.path.basename(w.path)} holding {n_fwd} "
          f"elbo_fwd and {n_bwd} elbo_bwd launches; losses and checkpoint bit-identical to the fault-free run ({smi})")
    return launches


def profile_dir_phase(E, smi: str, train, test, tmp: str) -> dict:
    """17c: ``run_hpo(profile_dir=)``, one trial at full width over 12,800 rows
    (100 steps): the trace parses, and its ELBO kernels equal the run's
    launch counts (within three tries: the profiler can drop part of a
    replay). Then ``profile_dir`` with ``precompile=True`` in a child, its
    outcome printed."""
    from multidisttorch_tpu_torch.data.datasets import Dataset
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    (g,) = setup_groups(1, devices=["cuda:0"])
    split = Dataset(train.images[:12_800], train.labels[:12_800], train.name, train.synthetic)
    cfg = TrialConfig(trial_id=0, epochs=1, batch_size=128, seed=7, fused_steps=10, log_interval=10_000)
    for attempt in range(3):
        prof = os.path.join(tmp, f"17c_{attempt}")
        for k in E.LAUNCHES:
            E.LAUNCHES[k] = 0
        (r,) = run_hpo([cfg], split, None, groups=[g], out_dir=os.path.join(tmp, f"17c_out{attempt}"), verbose=False,
                       save_images=False, profile_dir=prof)
        launches = dict(E.LAUNCHES)
        (name,) = os.listdir(prof)
        got = {k: _kernel_count(os.path.join(prof, name), f"{k}_kernel") for k in ("elbo_fwd", "elbo_bwd")}
        if all(got[k] == launches[k] for k in got):
            break
    check(r.steps == 100 and all(got[k] == launches[k] == 100 for k in got),
          f"17c: {r.steps} steps; the trace holds {got}, the launch counts {launches} ({attempt + 1} tries)")
    print(f"17c run_hpo(profile_dir=): trace {name} holds {got['elbo_fwd']} elbo_fwd and {got['elbo_bwd']} "
          f"elbo_bwd launches, the run's counts, in {attempt + 1} tries ({smi})")
    code = ("import json, os, sys, torch; sys.path.insert(0, os.getcwd())\n"
            "from multidisttorch_tpu_torch.data.datasets import synthetic_mnist\n"
            "from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo\n"
            "from multidisttorch_tpu_torch.parallel.mesh import setup_groups\n"
            "cfgs = [TrialConfig(trial_id=j, epochs=1, batch_size=128, seed=j, fused_steps=10, log_interval=10000)"
            " for j in range(2)]\n"
            "res = run_hpo(cfgs, synthetic_mnist(12800, seed=0), None, groups=setup_groups(2, devices=['cuda:0'] * 2),"
            " out_dir=sys.argv[1], verbose=False, save_images=False, precompile=True, profile_dir=sys.argv[2])\n"
            "print(json.dumps({'status': [r.status for r in res], 'steps': [r.steps for r in res],"
            " 'traces': os.listdir(sys.argv[2])}))\n")
    try:
        child = subprocess.run([sys.executable, "-c", code, os.path.join(tmp, "17c_pre_out"),
                                os.path.join(tmp, "17c_pre_prof")], cwd=HERE, capture_output=True, text=True,
                               timeout=120)
        outcome = f"exit {child.returncode}, " + ((child.stdout.strip().splitlines() or [""])[-1]
                                                 or child.stderr[-400:])
    except subprocess.TimeoutExpired:
        outcome = "still running after 120 s, killed"
    print(f"17c profile_dir with precompile=True (2 trials, 100 steps each, the farm capturing) in a child: "
          f"{outcome}")
    return launches


# The families' full widths (the examples' defaults), one short epoch each:
# 20 steps at batch 128.
FAMILY_RUNS = {name: ["--ngroups", "2", "--epochs", "1", "--synthetic-size", "2560", "--batch-size", "128"]
               for name in ("beta_vae_cifar", "moe_vae_hpo", "resnet_hpo")}


def families_phase(smi: str, tmp: str) -> None:
    """17d: the conv beta-VAE, MoE VAE and ResNet-18 examples in child
    processes at full width, ``MDT_TELEMETRY=1``: each exits 0, every trial
    of its run summary has an MFU, and its FLOPs a step equal the CPU count
    of that family's step."""
    from multidisttorch_tpu_torch.data.datasets import synthetic_cifar10
    from multidisttorch_tpu_torch.data.sampler import TrialDataIterator
    from multidisttorch_tpu_torch.models import ConvVAE, MoEVAE, ResNet18
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    procs = {}
    for name, argv in FAMILY_RUNS.items():
        tel = os.path.join(tmp, f"17d_{name}")
        env = dict(os.environ, MDT_TELEMETRY="1", MDT_TELEMETRY_DIR=tel)
        log = open(os.path.join(tmp, f"17d_{name}.log"), "w+")
        out = [] if name == "resnet_hpo" else ["--out-dir", os.path.join(tmp, f"17d_{name}_out")]
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        procs[name] = (subprocess.Popen([sys.executable, "-m", f"multidisttorch_tpu_torch.examples.{name}", *argv, *out],
                                        cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT), log, tel)
    # The CPU counts, while the children run.
    (cg,) = setup_groups(1, devices=["cpu"])
    images, labels = next(TrialDataIterator(synthetic_cifar10(256), cg, 128, seed=0, with_labels=True)
                          .epoch_chunks(0, 1))[1:]
    counts = {
        "beta_vae_cifar": [_vae_step_count("cpu", model=ConvVAE(latent_dim=64, base_channels=32),
                                           x=torch.rand(128, 3072))["flops"]] * 2,
        "moe_vae_hpo": [_vae_step_count("cpu", model=MoEVAE(hidden_dim=400, latent_dim=20, num_experts=2 * 2**g))
                        ["flops"] for g in range(2)],
        "resnet_hpo": [_vae_step_count("cpu", model=ResNet18(num_classes=10, base_channels=64),
                                       x=(images[0], labels[0]), classifier=True)["flops"]] * 2,
    }
    for name, (p, log, tel) in procs.items():
        rc = p.wait(timeout=600)
        log.seek(0)
        text = log.read()
        check(rc == 0, f"17d {name}: exit {rc}: {text[-1500:]}")
        with open(os.path.join(tel, "summary.json")) as f:
            summary = json.load(f)
        rows = []
        for tid in ("0", "1"):
            t = summary["trials"][tid]
            book = summary["device_books"][t["device_series"]]
            check(t["mfu"] is not None and 0 < t["mfu"] <= 1,
                  f"17d {name} trial {tid}: mfu {t['mfu']} ({t.get('mfu_reason')})")
            check(book["flops_per_step"] == counts[name][int(tid)],
                  f"17d {name} trial {tid}: {book['flops_per_step']} FLOPs a step, the CPU count "
                  f"{counts[name][int(tid)]}")
            rows.append(f"t{tid} mfu {t['mfu']} flops {book['flops_per_step']:.0f} bytes "
                        f"{book['bytes_per_step']:.0f} {t['roofline']} peak {t['peak_memory_bytes']}")
        print(f"17d {name} ({' '.join(FAMILY_RUNS[name])}): exit 0; " + "; ".join(rows) + f" ({smi})")


def books_phase(E, smi: str, train, test) -> dict:
    """Phase 17, with the registry on (as phase 16 left it)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        books = device_books_phase(E, smi, train, test, tmp)
        drill = anomaly_drill(E, smi, train, test, tmp)
        prof = profile_dir_phase(E, smi, train, test, tmp)
        families_phase(smi, tmp)
    print(f"phase 17: {time.time() - t0:.1f} s")
    return {**{f"books_sweep_{k}": v for k, v in books.items() if k != "bucket"}, "anomaly_drill": drill,
            "profile_dir": prof, "bucket": books["bucket"]}


# --- phase 18: elastic multi-host (the drill, the SIGTERM drain, the wedge
# watchdog), every child a process of its own on the one card ---

# The drill: the harness's standard_configs(6, 3) at the reference's widths,
# 2560 rows (20 steps an epoch, chunks of 10), 3 hosts of one group each,
# host 1 lost at its cumulative step 30 (epoch 2 of its first trial).
ELASTIC = dict(hosts=3, trials=6, epochs=3, data_rows=2560, batch_size=128, hidden_dim=400, latent_dim=20,
               fused_steps=10, kind="host_lost", victim=1, fault_at_host_step=30)
# The drain: two trials of 4 epochs over 60,000 rows (468 steps an epoch),
# a checkpoint an epoch, one group on the card.
DRAIN_ARGS = ["--device", "cuda", "--trials", "2", "--epochs", "4", "--data-rows", "60000", "--batch-size", "128",
              "--hidden-dim", "400", "--latent-dim", "20", "--fused-steps", "10"]
WEDGE_DEADLINE_S = 5.0
CHAOS_GOODPUT = 0.9545  # the single-host chaos drill's on the H100 (PERF.md, phase 15a)


def _child_env(**extra) -> dict:
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _worker_argv(mode: str, *args) -> list:
    return [sys.executable, "-m", "multidisttorch_tpu_torch.examples.elastic_worker", mode, *args]


def _launch_lines(text: str) -> list:
    return [json.loads(ln[len("LAUNCHES "):]) for ln in text.splitlines() if ln.startswith("LAUNCHES ")]


def elastic_drill(E, smi: str, tmp: str) -> dict:
    """18a: ``run_chaos_mh_bench`` on the card (``ELASTIC``): the in-process
    fault-free reference, then the drill through the port's supervisor and
    workers. 2 worlds, host 1 lost, every trial settled, the recovered ones
    bit-identical to the reference, goodput above 0.5, ``host_lost`` and
    ``world_shrunk`` traced, the fleet artifacts written, no worker running a
    compiler; the restart tax's phases and each world's wall clock printed.
    Counts set to 0 just before: the reference's launches are this
    process's, the workers' their own ``LAUNCHES`` lines, summed over both
    worlds."""
    from multidisttorch_tpu_torch.faults.harness import run_chaos_mh_bench

    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    t0 = time.time()
    rep = run_chaos_mh_bench(tmp, heartbeat_deadline_s=10.0, agree_timeout_s=60.0, boot_grace_s=90.0,
                             world_timeout_s=300.0, device="cuda", **ELASTIC)
    wall = time.time() - t0
    sup = rep["supervisor"]
    worlds = "; ".join(f"world {w['epoch']} hosts {w['hosts']} {w['outcome']} exits {w['exits']} "
                       f"{w.get('wall_s')} s" for w in sup["worlds"])
    logs = [log for w in sup["worlds"] for log in (w.get("logs") or {}).values()]

    def tails() -> str:
        out = []
        for log in logs:
            try:
                with open(log) as f:
                    out.append(f"--- {log}:\n{f.read()[-1200:]}")
            except OSError:
                pass
        return "\n".join(out)

    check(rep["worlds_formed"] == 2 and rep["hosts_lost"] == [1],
          f"18a: {rep['worlds_formed']} worlds, hosts lost {rep['hosts_lost']} ({worlds})\n{tails()}")
    check(rep["all_trials_settled"], f"18a: not every trial settled: {rep['statuses']}\n{tails()}")
    check(rep["recovered_bit_identical"] and len(rep["parity"]) == ELASTIC["trials"],
          f"18a: recovered trials differ from the in-process reference: {rep['parity']}")
    check(rep["goodput"] > 0.5, f"18a: goodput {rep['goodput']}")
    mem, fl = rep["membership"], rep["fleet"]
    check(mem["host_lost_traced"] and mem["world_shrunk_traced"], f"18a: membership events {mem['events_traced']}")
    check(all(os.path.exists(p) for p in fl["paths"].values()), f"18a: fleet artifacts missing: {fl['paths']}")
    check(fl["all_hosts_traced"] and fl["faults_fired"] == 1 and fl["all_faults_traced"] and fl["restart_tax_nonnull"],
          f"18a: fleet summary gates: {fl}")
    check(rep["worker_builds"] == [], f"18a: a worker ran a compiler: {rep['worker_builds']}")
    # Every worker but the victim prints its counts (4 of the 5 processes).
    check(rep["worker_launch_lines"] == 4, f"18a: {rep['worker_launch_lines']} LAUNCHES lines, expected 4")
    wl, rl = rep["worker_launches"], rep["reference_launches"]
    steps = ELASTIC["trials"] * ELASTIC["epochs"] * (ELASTIC["data_rows"] // ELASTIC["batch_size"])
    for k in ("elbo_fwd", "elbo_bwd"):
        check(rl[k] == steps, f"18a: the reference launched {k} {rl[k]} times in {steps} steps")
        check(wl[k] >= steps - ELASTIC["fault_at_host_step"], f"18a: the workers launched {k} {wl[k]} times")
    check(wl["elbo_fwd"] == wl["elbo_bwd"] and not wl["elbo_fwd_lanes"] and not wl["elbo_bwd_lanes"],
          f"18a: worker launches {wl}")
    check(E.LAUNCHES["elbo_fwd"] == steps, f"18a: this process launched {E.LAUNCHES}")
    (tax,) = fl["restart_tax"]
    print(f"18a drill ({ELASTIC}): {wall:.1f} s; {worlds}; hosts lost {rep['hosts_lost']}; statuses "
          f"{rep['statuses']}; goodput {rep['goodput']} (useful {rep['useful_steps']} / executed "
          f"{rep['executed_steps']}; the single-host drill's {CHAOS_GOODPUT}); recovered bit-identical "
          f"{rep['recovered_bit_identical']} ({len(rep['parity'])} trials); reference {rep['wall_fault_free_s']} s, "
          f"drill {rep['wall_chaos_s']} s; restart tax: detect {tax['detect_s']} s, drain {tax['drain_s']} s, "
          f"relaunch {tax['relaunch_s']} s, restore {tax['restore_s']} s, first useful step "
          f"{tax['first_useful_step_s']} s, total {tax['total_s']} s; migrated "
          f"{fl['migrated_trials_in_lineage']}; worker launches {wl} over {rep['worker_launch_lines']} processes, "
          f"reference {rl}, no worker build; membership {mem['events_traced'].get('host_lost')} host_lost, "
          f"{mem['events_traced'].get('world_shrunk')} world_shrunk ({smi})")
    for epoch, boots in sorted(rep["worker_boot"].items()):
        mean = {k: round(statistics.mean(b[k] for b in boots), 3) for k in boots[0]}
        print(f"18a world {epoch} worker start, mean of {len(boots)} (s): {mean}")
    # The new world's first events, seconds after its launch (the restart
    # tax's anchor), per host: where restore_s goes.
    from multidisttorch_tpu_torch.telemetry.events import read_events

    launch = next(e for e in read_events(fl["paths"]["events"]) if e.get("kind") == "restart_tax")
    firsts: dict = {}
    for e in read_events(fl["paths"]["events"]):
        if e.get("world") == tax["world_epoch"] and e.get("host") is not None:
            firsts.setdefault(e["host"], {}).setdefault(e["kind"], round(e["ts"] - launch["ts"], 3))
    kinds = ("sweep_start", "attempt_start", "optimizer_state", "ckpt_scan_restore", "first_dispatch", "epoch")
    print("18a world 1 first events after its launch (s): " + "; ".join(
        f"host {h}: " + ", ".join(f"{k} {v[k]}" for k in kinds if k in v) for h, v in sorted(firsts.items())))
    # 20c's fleet view, before the run directory goes.
    fleet_console(os.path.join(tmp, "mh_chaos"), rep)
    return {"elastic_drill": {k: wl[k] for k in ("elbo_fwd", "elbo_bwd")}, "elastic_reference": rl}


def drain_phase(smi: str, tmp: str) -> dict:
    """18b: a one-process sweep on the card (``DRAIN_ARGS``) gets SIGTERM
    in epoch 2 of trial 0: exit 75, ``preempted`` in the ledger, the epoch-1
    checkpoint landed by the drain, a resumed run that loses at most the
    epoch in flight, and both trials' final checkpoints equal an
    uninterrupted run's (a child beside it), bit for bit. The three
    children's ELBO launches are returned."""
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger
    from multidisttorch_tpu_torch.train import checkpoint as ck

    out_dir, straight_dir = os.path.join(tmp, "18b_sweep"), os.path.join(tmp, "18b_straight")
    t0 = time.time()
    straight = subprocess.Popen(_worker_argv("drain_sweep", straight_dir, *DRAIN_ARGS), env=_child_env(), cwd=tmp,
                                text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    p = subprocess.Popen(_worker_argv("drain_sweep", out_dir, *DRAIN_ARGS), env=_child_env(), cwd=tmp, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    # Trial 0's directory appears when its first checkpoint write starts, at
    # the end of epoch 1; the write itself (0.2-0.5 s, phase 7) outlasts
    # much of epoch 2, so the sidecar would come too late for "mid-epoch 2".
    trial_dir = os.path.join(out_dir, "trial-0")
    killed_at = None
    try:
        while time.time() - t0 < 300 and p.poll() is None:
            if os.path.isdir(trial_dir):
                p.send_signal(signal.SIGTERM)
                killed_at = time.time() - t0
                break
            time.sleep(0.005)
        out = p.communicate(timeout=300)[0]
        straight_out = straight.communicate(timeout=300)[0]
    finally:
        for proc in (p, straight):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(killed_at is not None, f"18b: the sweep ended before the drain: {out[-1500:]}")
    check(p.returncode == 75 and "HostPreemption" in out and "graceful drain" in out,
          f"18b: exit {p.returncode}, expected 75: {out[-1500:]}")
    check(straight.returncode == 0, f"18b: the uninterrupted run exited {straight.returncode}: {straight_out[-1500:]}")
    pre = [ev for ev in SweepLedger(out_dir).load() if ev.get("event") == "attempt_end" and ev.get("status") == "preempted"]
    check(bool(pre) and "graceful drain" in pre[-1]["error"], f"18b: no preempted ledger record: {pre}")
    at_kill = int(pre[-1]["summary"]["steps_at_failure"])
    t1 = time.time()
    resumed = subprocess.run(_worker_argv("drain_sweep", out_dir, "--resume", *DRAIN_ARGS), env=_child_env(),
                             cwd=tmp, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
    resume_s = time.time() - t1
    check(resumed.returncode == 0, f"18b: the resumed run exited {resumed.returncode}: {resumed.stdout[-1500:]}")
    res = json.loads([ln for ln in resumed.stdout.splitlines() if ln.startswith("RESULT ")][-1][len("RESULT "):])
    spe = int(DRAIN_ARGS[DRAIN_ARGS.index("--data-rows") + 1]) // int(DRAIN_ARGS[DRAIN_ARGS.index("--batch-size") + 1])
    r0 = res["0"]
    check(all(r["status"] == "completed" and r["steps"] == 4 * spe for r in res.values()), f"18b: resumed {res}")
    check(spe < at_kill <= 2 * spe and r0["resumed_from_step"] == spe,
          f"18b: killed at step {at_kill}, resumed from {r0['resumed_from_step']} ({spe} steps an epoch): "
          "expected a kill in epoch 2 and a resume from epoch 1's checkpoint")
    for tid in (0, 1):
        _same_checkpoint(ck, out_dir, straight_dir, f"18b trial {tid} resumed after the drain", trial_id=tid)
    launches = {"elbo_fwd": 0, "elbo_bwd": 0}
    for text in (out, straight_out, resumed.stdout):
        lines = _launch_lines(text)
        check(len(lines) == 1 and lines[0]["build_seconds"] == {}, f"18b: LAUNCHES lines {lines}")
        for k in launches:
            launches[k] += lines[0][k]
    check(launches["elbo_fwd"] == launches["elbo_bwd"] > 0, f"18b: launches {launches}")
    print(f"18b drain ({' '.join(DRAIN_ARGS)}): SIGTERM {killed_at:.3f} s after start, at step {at_kill} (epoch "
          f"{at_kill // spe + 1} of trial 0); exit 75 with the preempted record; resumed from step "
          f"{r0['resumed_from_step']} in {resume_s:.1f} s, lost {at_kill - r0['resumed_from_step']} steps (at most "
          f"{spe}); both trials' final checkpoints bit-identical to the uninterrupted run; launches {launches} "
          f"over 3 children ({smi})")
    return launches


def watchdog_start(tmp: str) -> tuple:
    """18c, started: a 2-process world on the card (NCCL, both ranks on the
    one card) in which rank 1 never reaches ``sync_hosts``."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs, logs = [], []
    for rank in range(2):
        env = _child_env(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(port))
        logs.append(open(os.path.join(tmp, f"18c_rank{rank}.log"), "w+"))
        procs.append(subprocess.Popen(_worker_argv("wedge_probe", tmp, "--device", "cuda", "--sync-timeout",
                                                   str(WEDGE_DEADLINE_S)), env=env, cwd=tmp, stdout=logs[-1],
                                      stderr=subprocess.STDOUT))
    return procs, logs, time.time()


def watchdog_finish(started: tuple, smi: str) -> None:
    """18c, checked: rank 0 raised ``WedgedCollective`` within its deadline
    plus 2 s and exited 75."""
    procs, logs, t0 = started
    try:
        rc = procs[0].wait(timeout=120)
        wall = time.time() - t0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    m = re.search(r"WEDGED (\w+) after ([0-9.]+) s", texts[0])
    check(rc == 75 and m is not None and m.group(1) == "WedgedCollective",
          f"18c: rank 0 exit {rc}: {texts[0][-1500:]}\n--- rank 1:\n{texts[1][-800:]}")
    waited = float(m.group(2))
    check(WEDGE_DEADLINE_S <= waited <= WEDGE_DEADLINE_S + 2.0, f"18c: WedgedCollective after {waited} s")
    print(f"18c watchdog: rank 0 raised WedgedCollective after {waited:.3f} s at a {WEDGE_DEADLINE_S} s deadline "
          f"and exited 75; rank 1 stayed away; rank 0 ended {wall:.1f} s after both started, beside 18b ({smi})")


def elastic_phase(E, smi: str) -> dict:
    """Phase 18."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        drill = elastic_drill(E, smi, os.path.join(tmp, "18a"))
        wedge = watchdog_start(tmp)  # its two children start beside 18b's
        drain = drain_phase(smi, tmp)
        watchdog_finish(wedge, smi)
    print(f"phase 18: {time.time() - t0:.1f} s")
    return {**drill, "drain": drain}


# --- phase 19: the sweep service on the card ---------------------------------

# The service's trials: the 784-400-20 VAE at batch 128 in graphed chunks of
# 10, on MNIST-sized synthetic data (468 steps an epoch).
SERVICE = dict(batch_size=128, hidden_dim=400, latent_dim=20, fused_steps=10, log_interval=10**9)


def _zero(E) -> None:
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0


def _ledger_losses(d: str) -> dict:
    """trial id -> final test loss of its completed attempt."""
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

    return {e["trial_id"]: e["summary"]["final_test_loss"] for e in SweepLedger(d).load()
            if e.get("event") == "attempt_end" and e.get("status") == "completed"}


def _attempt_steps(d: str) -> list:
    """``(status, steps)`` of every attempt in a service directory's ledger:
    the optimizer steps it ran, its last step (``steps``, or
    ``steps_at_failure`` for a preempted one) less the step it resumed
    from."""
    from multidisttorch_tpu_torch.hpo.ledger import SweepLedger

    out = []
    for e in SweepLedger(d).load():
        if e.get("event") == "attempt_end":
            s = e["summary"]
            last = s["steps"] if "steps" in s else s["steps_at_failure"]
            out.append((e["status"], int(last) - int(s.get("resumed_from_step") or 0)))
    return out


def _same_ckpt_bits(a: str, b: str) -> bool:
    """Whether two checkpoints hold the same state tree to the last bit."""
    import numpy as np

    from multidisttorch_tpu_torch.train import checkpoint as ck

    def leaves(t, prefix=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{prefix}/{k}")
        else:
            yield prefix, np.asarray(t)

    la, lb = dict(leaves(ck._read_tree_format(a)[0])), dict(leaves(ck._read_tree_format(b)[0]))
    return la.keys() == lb.keys() and all(la[k].tobytes() == lb[k].tobytes() for k in la)


def _print_books(what: str, books: dict, smi: str) -> None:
    qw, pl = books["queue_wait"], books["placement_latency"]
    ckb = books["checkpoint"]
    slo = {name: [(r.get("label"), r["met"]) for r in rows] for name, rows in books["slo"]["slos"].items()}
    print(f"{what} books: queue wait p50 {qw.get('p50_s')} s p99 {qw.get('p99_s')} s over {qw['count']}, "
          f"placement latency p50 {pl.get('p50_s')} s p99 {pl.get('p99_s')} s (max {pl.get('max_s')}) over "
          f"{pl['count']}; drain snapshot {ckb['drain_snapshot']}; drain persist {ckb['drain_persist']}; "
          f"SLO verdicts {slo}; alerting {books['slo'].get('alerting')}; tenants "
          f"{ {t: (b['goodput'], b['settled']) for t, b in books['tenants'].items()} } ({smi})")


def service_copack(E, smi: str, train, test, tmp: str) -> dict:
    """19a: two tenants (2:1) submit 7 trials of one shape and one of
    another width to a 4-slot service on the card: the 7 co-pack into
    stacked buckets (the lane kernels), the other runs alone (the single
    kernels); all settle ``completed``; the lone trial is bit-identical to
    run_hpo of its config and trial id, each lane within phase 10's rel 1e-3
    of its unstacked run."""
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.service.queue import SweepClient, fold_queue, load_queue
    from multidisttorch_tpu_torch.service.runtime import SweepService
    from multidisttorch_tpu_torch.service.scheduler import TenantPolicy

    d = os.path.join(tmp, "19a")
    ca, cb = SweepClient(d, tenant="alice"), SweepClient(d, tenant="bob")
    base = dict(SERVICE, epochs=1)
    ids = [ca.submit({**base, "seed": i, "lr": 1e-3 * (1 + i % 2)}) for i in range(4)]
    ids += [cb.submit({**base, "seed": 10 + i, "beta": 0.5 + i}) for i in range(3)]
    lone = cb.submit({**base, "hidden_dim": 256, "seed": 20})
    svc = SweepService(d, n_slices=4, max_lanes=4, train_data=train, test_data=test, verbose=False, device="cuda",
                       policies={"alice": TenantPolicy(weight=2.0), "bob": TenantPolicy(weight=1.0)})
    check([str(s) for s in svc._slots] == ["cuda:0"] * 4, f"19a: slots {svc._slots}")
    _zero(E)
    t0 = time.time()
    try:
        rep = svc.serve(exit_when_drained=True, idle_grace_s=0.2, max_wall_s=300)
    finally:
        svc.close()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(E.LAUNCHES)
    check(rep["outcome"] == "idle", f"19a: outcome {rep['outcome']}")
    check(all(rep["settled"].get(s) == "completed" for s in ids + [lone]), f"19a: settled {rep['settled']}")
    folded = fold_queue(load_queue(d))
    stacked = [s for s in ids if folded[s]["last_placement"]["stacked"]]
    check(len(stacked) == 7 and not folded[lone]["last_placement"]["stacked"],
          f"19a: placements {[folded[s]['last_placement'] for s in ids + [lone]]}")
    lanes = sorted({(folded[s]["last_placement"]["start"], folded[s]["last_placement"]["lanes"]) for s in ids})
    buckets = len(lanes)
    check(launches["elbo_fwd"] == launches["elbo_bwd"] == 468,
          f"19a: single kernels launched {launches} (468 steps of the lone trial)")
    check(launches["elbo_fwd_lanes"] == launches["elbo_bwd_lanes"] == 468 * buckets,
          f"19a: lane kernels launched {launches} ({buckets} buckets of 468 stacked steps)")
    print(f"19a: 8 submissions, buckets (start, lanes) {lanes} and one lone trial, all completed in {wall:.3f} s "
          f"of service, {svc.dispatches} dispatches; launches {launches} ({smi})")
    _print_books("19a", rep["books"], smi)
    # The lone trial against run_hpo of its config and trial id, on the same
    # slot's group (the registry's slot for its program is the service's).
    losses = _ledger_losses(d)
    tid = folded[lone]["trial_id"]
    start = folded[lone]["last_placement"]["start"]
    groups = setup_groups(4, devices=["cuda:0"] * 4)
    ref_dir = os.path.join(tmp, "19a-ref")
    run_hpo([TrialConfig(trial_id=tid, **folded[lone]["config"])], train, test, groups=[groups[start]],
            out_dir=ref_dir, save_images=False, verbose=False)
    check(_same_ckpt_bits(os.path.join(d, f"trial-{tid}", "state.msgpack"),
                          os.path.join(ref_dir, f"trial-{tid}", "state.msgpack")),
          f"19a: the lone service trial {tid} is not bit-identical to run_hpo of its config")
    # Each lane against its unstacked run.
    cfgs = [TrialConfig(trial_id=folded[s]["trial_id"], **folded[s]["config"]) for s in ids]
    uns = {r.trial_id: r.final_test_loss for r in run_hpo(cfgs, train, test, groups=groups, save_images=False,
                                                           verbose=False, out_dir=os.path.join(tmp, "19a-uns"))}
    worst = 0.0
    for c in cfgs:
        rel = abs(losses[c.trial_id] - uns[c.trial_id]) / abs(uns[c.trial_id])
        worst = max(worst, rel)
        check(rel <= 1e-3, f"19a: lane trial {c.trial_id} test loss {losses[c.trial_id]} vs unstacked "
                           f"{uns[c.trial_id]} (rel {rel:.3g} > 1e-3)")
    print(f"19a: lone trial {tid} bit-identical to run_hpo; 7 lanes within rel {worst:.3g} of their unstacked "
          f"runs (tolerance 1e-3)")
    return {"launches": launches}


def restore_replay_vs_eager(E, group, train) -> None:
    """19b: graphs hold addresses. A trial restored from the RAM snapshot
    into a registry program slot (written by value) and replayed over an
    epoch ends bit-identical to the eager loop from the same state."""
    from multidisttorch_tpu_torch.data.sampler import TrialDataIterator
    from multidisttorch_tpu_torch.hpo.driver import GENERATORS_KEY, TrialConfig, _TrialRun, run_hpo
    from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
    from multidisttorch_tpu_torch.train import checkpoint as ck
    from multidisttorch_tpu_torch.train.steps import EagerMultiStep, _build_body, create_train_state

    with tempfile.TemporaryDirectory() as tmp:
        cfg = dict(SERVICE, seed=3, lr=2e-3)
        run_hpo([TrialConfig(trial_id=900, epochs=1, **cfg)], train, None, groups=[group], out_dir=tmp,
                save_images=False, verbose=False)
        path = os.path.join(tmp, "trial-900", "state.msgpack")
        tree, _ = ck._read_tree_format(path)
        with open(path + ".json") as f:
            meta = json.load(f)
        ck.snapshot_cache().put(path, tree, meta)
        before = ck.ckpt_counters()["restores_ram"]
        run = _TrialRun(group, TrialConfig(trial_id=900, epochs=2, **cfg), train, None, tmp, save_images=False,
                        save_checkpoint=False, verbose=False, resume="scan", ram_restore=True)
        check(ck.ckpt_counters()["restores_ram"] == before + 1, "19b: the trial did not restore from RAM")
        for _ in run.run():
            pass
        torch.cuda.synchronize()
        check(run._admission["outcome"] in ("hit", "wait"),
              f"19b: the restored trial did not take the registry's slot: {run._admission}")
        state = create_train_state(group, init_vae_params(VAE(), seed=3), lr=2e-3)
        ck.load_train_state_tree(state, tree)
        gen = torch.Generator(device=group.device)
        import base64

        gen.set_state(torch.frombuffer(bytearray(base64.b64decode(meta[GENERATORS_KEY]["train"][0])),
                                       dtype=torch.uint8))
        eager = EagerMultiStep(_build_body(group, 1.0, True, 1))
        for _, chunk in TrialDataIterator(train, group, 128, seed=3).epoch_chunks(2, 10):
            state, _ = eager(state, chunk, generator=gen)
        torch.cuda.synchronize()
        got, ref = ck.train_state_to_tree(run.state), ck.train_state_to_tree(state)
        same = all(a.tobytes() == b.tobytes() for a, b in zip(_tree_leaves(got), _tree_leaves(ref)))
        check(same, "19b: the replay after a RAM restore into a program slot differs from the eager loop")
        ck.snapshot_cache().drop(path)
    print("19b: a RAM restore into a registry slot, then 47 graph replays: bit-identical to the eager loop")


def _tree_leaves(t):
    import numpy as np

    if isinstance(t, dict):
        for k in sorted(t):
            yield from _tree_leaves(t[k])
    else:
        yield np.asarray(t)


def service_preempt_stacked(E, smi: str, train, test, tmp: str) -> dict:
    """19b: a deadline trial preempts a co-packed bucket on the one slot:
    the bucket finishes its round, its lanes snapshot together (RAM and
    disk) and re-place as unstacked trials; each lane ends within phase
    10's rel 1e-3 of the undisturbed bucket."""
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.service.queue import SweepClient, fold_queue, load_queue
    from multidisttorch_tpu_torch.service.runtime import SweepService
    from multidisttorch_tpu_torch.service.scheduler import PreemptionPolicy
    from multidisttorch_tpu_torch.train.checkpoint import ckpt_counters

    d = os.path.join(tmp, "19b-preempt")
    client = SweepClient(d, tenant="batch")
    base = dict(SERVICE, epochs=3)
    ids = [client.submit({**base, "seed": 30 + i}) for i in range(3)]
    svc = SweepService(d, n_slices=1, max_lanes=4, train_data=train, test_data=test, verbose=False, device="cuda",
                       defrag_enabled=False,
                       preempt=PreemptionPolicy(trial_cooldown_s=0.0, global_cooldown_s=0.0))
    _zero(E)
    restores = ckpt_counters()["restores_ram"]
    t0 = time.time()
    try:
        ok = False
        for _ in range(10**6):
            svc.tick()
            ap = next(iter(svc.active.values()), None)
            if ap is not None and ap.stacked and ap.run.lanes[0] is not None and ap.run.lanes[0]["epochs_done"] >= 1:
                ok = True
                break
            if time.time() - t0 > 120:
                break
        check(ok, "19b: the bucket never finished its first round")
        urgent = SweepClient(d, tenant="urgent").submit({**SERVICE, "epochs": 1, "seed": 40}, deadline_s=60.0)
        rep = None
        for _ in range(10**7):
            svc.tick()
            if len(svc.settled) == 4 or time.time() - t0 > 240:
                break
        rep = svc.books()
    finally:
        svc._drain(reason="phase end")
        svc.close()
    torch.cuda.synchronize()
    launches = dict(E.LAUNCHES)
    check(all(svc.settled.get(s) == "completed" for s in ids + [urgent]), f"19b: settled {svc.settled}")
    check(rep["preemption"]["events"] >= 1 and rep["preemption"]["evictions"] >= 1,
          f"19b: no preemption happened: {rep['preemption']}")
    check(rep["deadline"]["hits"] == 1, f"19b: deadline {rep['deadline']}")
    check(ckpt_counters()["restores_ram"] - restores == 3, "19b: the drained lanes did not all restore from RAM")
    # Exact launches: the bucket's stacked steps (its lanes' preempted
    # attempts, in lockstep) and every unstacked attempt's steps.
    attempts = _attempt_steps(d)
    rounds = {n for st, n in attempts if st == "preempted"}
    single = sum(n for st, n in attempts if st == "completed")
    check(len(rounds) == 1 and sum(st == "preempted" for st, _ in attempts) == 3,
          f"19b: the lanes' preempted attempts {attempts}")
    check(launches["elbo_fwd_lanes"] == launches["elbo_bwd_lanes"] == rounds.pop(),
          f"19b: lane kernels launched {launches}, the bucket's attempts {attempts}")
    check(launches["elbo_fwd"] == launches["elbo_bwd"] == single,
          f"19b: single kernels launched {launches}, {single} unstacked steps in the ledger")
    folded = fold_queue(load_queue(d))
    check(all(folded[s]["placements"] == 2 and not folded[s]["last_placement"]["stacked"] for s in ids),
          f"19b: lanes' placements {[folded[s]['last_placement'] for s in ids]}")
    losses = _ledger_losses(d)
    cfgs = [TrialConfig(trial_id=folded[s]["trial_id"], **folded[s]["config"]) for s in ids]
    ref = {r.trial_id: r.final_test_loss for r in run_hpo(
        cfgs, train, test, groups=setup_groups(1, devices=["cuda:0"]), stack_trials=True, stack_max_lanes=4,
        save_images=False, verbose=False, out_dir=os.path.join(tmp, "19b-ref"))}
    worst = max(abs(losses[c.trial_id] - ref[c.trial_id]) / abs(ref[c.trial_id]) for c in cfgs)
    check(worst <= 1e-3, f"19b: drained lanes' test losses {losses} vs the undisturbed bucket's {ref}")
    print(f"19b: a deadline trial preempted a 3-lane bucket after its first round: {rep['preemption']['events']} "
          f"preemption(s), the lanes re-placed unstacked from RAM, every lane within rel {worst:.3g} of the "
          f"undisturbed bucket (tolerance 1e-3); deadline {rep['deadline']}; launches {launches} ({smi})")
    _print_books("19b preemption", rep, smi)
    return {"launches": launches}


def service_drill(E, smi: str, train, tmp: str) -> dict:
    """19c and 19b's defrag: ``service.drill.run_service_bench`` on the
    card. (i) A daemon child (``examples/sweep_service.py --device cuda``)
    serving 2 tenants (2:1, 48 and 24 submissions) of two full-width shape
    buckets is SIGKILLed mid-sweep and restarted: zero lost submissions,
    goodput >= 0.8, fair share within 10 % of 2:1; each daemon's start
    printed. (ii) The defrag
    drill at full width in this process: a size-2 trial places after
    ``defrag_end``, the migrated victims end bit-identical to their
    uninterrupted runs."""
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.service.drill import run_service_bench
    from multidisttorch_tpu_torch.service.queue import fold_queue, load_queue
    from multidisttorch_tpu_torch.telemetry import device as tele_device

    work = os.path.join(tmp, "19c")
    _zero(E)
    # The defrag drill turns telemetry on for its evidence: a device book's
    # counted step (one eager step per program shape new to the process)
    # launches each single kernel once more.
    memo0 = len(tele_device._cost_cache)
    t0 = time.time()
    # The drill's own sizes on the card (its default device): the
    # full-width VAE in shape buckets of different fused_steps.
    bench = run_service_bench(
        work,
        kill_restart=dict(epochs=2, slices=2, max_lanes=2, submissions=SERVICE_DRILL_SUBS, timeout_s=400.0),
        defrag=dict(long_epochs=8, train_data=train, starvation_s=1.0, timeout_s=300.0),
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    counted = len(tele_device._cost_cache) - memo0
    defrag_launches = {k: v - (counted if k in ("elbo_fwd", "elbo_bwd") else 0) for k, v in E.LAUNCHES.items()}
    ddir = os.path.join(work, "defrag")
    steps = sum(n for _, n in _attempt_steps(ddir))
    check(defrag_launches["elbo_fwd"] == defrag_launches["elbo_bwd"] == steps
          and defrag_launches["elbo_fwd_lanes"] == defrag_launches["elbo_bwd_lanes"] == 0,
          f"19b defrag: kernels launched {dict(E.LAUNCHES)} less {counted} counted steps, {steps} steps in the "
          f"ledger")
    kr, df = bench["kill_restart"], bench["defrag"]
    print(f"19c: gates {bench['gates']} in {wall:.1f} s; daemon exits {kr['daemon_exits']}, killed at "
          f"{kr['killed_at_settled']} settled, {kr['completed']} of {kr['submissions']} completed, lost "
          f"{kr['lost_submissions']}, fair share {kr['fair_share']}, goodput {kr['tenant_goodput']}, restart to "
          f"all settled {kr['restart_to_all_settled_s']} s ({smi})")
    for i, boot in enumerate(kr["daemon_boots"]):
        print(f"19c: daemon {i + 1} BOOT {json.dumps(boot)}")
    for rec in kr["daemon_launches"]:
        print(f"19c: daemon LAUNCHES {json.dumps(rec)}")
    check(all(boot["device"] == ["cuda:0"] for boot in kr["daemon_boots"]) and len(kr["daemon_boots"]) == 2,
          f"19c: daemons' devices {kr['daemon_boots']}")
    check(bench["ok"], f"19c: gates {bench['gates']}")
    # 20c's service consoles, before the service directory goes.
    service_consoles(os.path.join(work, "service"), kr)
    check(len(kr["daemon_launches"]) == 1, f"19c: the restarted daemon's LAUNCHES line {kr['daemon_launches']}")
    drill_launches = {k: v for k, v in kr["daemon_launches"][0].items() if k in E.LAUNCHES}
    check(all(drill_launches[k] > 0 for k in E.LAUNCHES), f"19c: the restarted daemon's launches {drill_launches}")
    # 19b's defrag at full width: the evidence and the victims' bits.
    check(df["fragmented"] and df["ok"], f"19b defrag: {df}")
    check(df["big_placed_ts"] >= df["defrag_end_ts"], "19b: the size-2 trial placed before defrag_end")
    folded = fold_queue(load_queue(ddir))
    moved = {m["trial_id"] for m in df["migrations"]}
    for sid, rec in folded.items():
        if rec["trial_id"] not in moved:
            continue
        tid = rec["trial_id"]
        ref_dir = os.path.join(tmp, f"19b-victim-{tid}")
        run_hpo([TrialConfig(trial_id=tid, **rec["config"])], train, None,
                groups=setup_groups(1, devices=["cuda:0"]), out_dir=ref_dir, save_images=False, verbose=False)
        check(_same_ckpt_bits(os.path.join(ddir, f"trial-{tid}", "state.msgpack"),
                              os.path.join(ref_dir, f"trial-{tid}", "state.msgpack")),
              f"19b: migrated victim {tid} is not bit-identical to its uninterrupted run")
    ckb = df["checkpoint_books"]
    print(f"19b defrag: free runs {df['fragmented_free_runs']}, size-2 trial placed {df['unblock_wait_s']} s "
          f"after submission and {df['big_placed_ts'] - df['defrag_end_ts']:.3f} s after defrag_end, "
          f"{len(moved)} victim(s) migrated and bit-identical to their uninterrupted runs; drain snapshot "
          f"{ckb['drain_snapshot'].get('mean_s', 0) * 1e3:.3f} ms vs drain persist "
          f"{ckb['drain_persist'].get('mean_s', 0) * 1e3:.3f} ms (means over {ckb['drain_snapshot']['count']}), "
          f"restores from RAM {ckb['restores_ram']} of {ckb['restores']} ({smi})")
    return {"drill": drill_launches, "defrag": defrag_launches}


# The drill daemons' dataset is the drill's card default, 50 full-width
# batches an epoch (each daemon makes its own, and pays its start, inside
# the drill's clock). The drill submits 48 + 24 trials, the JAX drill's
# 12 + 6 four times over: at 12 + 6 one placement is 17 % of the smaller
# share, wider than the 10 % gate (service/drill.py::run_kill_restart_phase).
SERVICE_DRILL_SUBS = (48, 24)


def service_phase(E, smi: str, train, test) -> dict:
    """Phase 19, with the registry on (the service's default). Telemetry is
    off for 19a and 19b's preemption, whose launch counts hold no counted
    step; the defrag drill turns it on for its evidence, and its counted
    steps are taken off its counts. Each part's count is checked exactly
    against the steps its ledger records."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    os.environ.pop("MDT_AOT_ADMISSION", None)
    telemetry.disable()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        a = service_copack(E, smi, train, test, tmp)
        restore_replay_vs_eager(E, setup_groups(1, devices=["cuda:0"])[0], train)
        b = service_preempt_stacked(E, smi, train, test, tmp)
        c = service_drill(E, smi, train, tmp)
    print(f"phase 19: {time.time() - t0:.1f} s")
    single = {k: a["launches"][k] + b["launches"][k] + c["defrag"][k] for k in ("elbo_fwd", "elbo_bwd")}
    lanes = {k: a["launches"][k] + b["launches"][k] + c["defrag"][k] for k in ("elbo_fwd_lanes", "elbo_bwd_lanes")}
    check(all(v > 0 for v in {**single, **lanes}.values()), f"phase 19: launches {single} {lanes}")
    return {"service": single, "service_stacked": lanes, "service_drill": c["drill"]}


# --- phase 20: the operator plane (the incident plane and the consoles) ------

# The seconds each console child took, by phase (20c), for the phase's line.
CONSOLES: list = []


def _consoles(what: str, runs: list, timeout_s: float = 180.0) -> list:
    """Each ``(name, args)`` of ``runs`` as a child, ``python -m
    multidisttorch_tpu_torch.tools.<name> *args``, all started together and
    with no card visible (the consoles read files only): their stdouts, in
    order. Fails unless every one exits 0."""
    t0 = time.time()
    env = _child_env(CUDA_VISIBLE_DEVICES="")
    procs = [(name, args, subprocess.Popen([sys.executable, "-m", f"multidisttorch_tpu_torch.tools.{name}", *args],
                                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for name, args in runs]
    outs = []
    try:
        for name, args, proc in procs:
            out, err = proc.communicate(timeout=max(1.0, timeout_s - (time.time() - t0)))
            check(proc.returncode == 0,
                  f"20c {what}: {name} {' '.join(args)} exited {proc.returncode}\n{out[-2000:]}\n{err[-2000:]}")
            outs.append(out)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    CONSOLES.append((what, len(runs), round(time.time() - t0, 3)))
    return outs


def fleet_console(run_dir: str, rep: dict) -> None:
    """20c over phase 18's run directory: ``sweep_top --fleet --json``
    against the drill's own report (its hosts, worlds and trials)."""
    (out,) = _consoles("18a", [("sweep_top", [run_dir, "--fleet", "--json"])])
    snap = json.loads(out)
    hosts = sorted(int(h) for h in snap["hosts"])
    check(hosts == list(range(ELASTIC["hosts"])) and len(snap["worlds"]) == rep["worlds_formed"]
          and snap["all_hosts_traced"],
          f"20c 18a: the fleet view's hosts {hosts}, worlds {len(snap['worlds'])}: the drill had "
          f"{ELASTIC['hosts']} hosts, {rep['worlds_formed']} worlds")
    # The fleet fold's trial status is the merged event stream's last word
    # (the JAX console's fold); the drill's is the ledger's.
    statuses = {int(t): v["status"] for t, v in snap["trials"].items()}
    check(sorted(statuses) == sorted(int(t) for t in rep["statuses"]),
          f"20c 18a: the fleet view's trials {statuses} against the drill's {rep['statuses']}")
    print(f"20c over 18a's run directory: sweep_top --fleet --json: hosts {hosts}, {len(snap['worlds'])} worlds and "
          f"trials {sorted(statuses)}, as the drill's; restart tax {[t.get('total_s') for t in snap['restart_tax']]} "
          f"s; the fold's statuses {statuses} (the ledger's {rep['statuses']})")


def service_consoles(service_dir: str, kr: dict) -> None:
    """20c over phase 19's kill -9 service directory: ``sweep_top --service
    --json``, ``ledger_view --queue --json`` and ``sweep_trace --json``
    against the drill's own report (every submission settled, with its
    status)."""
    top, queue, trace = _consoles("19c", [
        ("sweep_top", [service_dir, "--service", "--json"]),
        ("ledger_view", [service_dir, "--queue", "--json"]),
        ("sweep_trace", [service_dir, "--json"]),
    ])
    top, queue, trace = json.loads(top), json.loads(queue)["by_submission"], json.loads(trace)
    want = kr["statuses"]
    for what, folded in (("sweep_top --service", top["queue"]), ("ledger_view --queue", queue)):
        got = {sid: rec.get("status") for sid, rec in folded.items() if rec["state"] == "settled"}
        check(got == want, f"20c 19c: {what} settled {len(got)} submissions, the drill {len(want)}: "
              f"{sorted(set(got.items()) ^ set(want.items()))[:6]}")
    check(sorted(bd["submission_id"] for bd in trace) == sorted(want)
          and all(bd["state"] == "settled" for bd in trace),
          f"20c 19c: sweep_trace listed {len(trace)} submissions, the drill {len(want)}")
    print(f"20c over 19c's service directory: sweep_top --service --json and ledger_view --queue --json settled "
          f"{len(want)} of {kr['submissions']} submissions ({kr['completed']} completed), sweep_trace --json "
          f"{len(trace)} span trees, as the drill's; incidents "
          f"{[(i['kind'], i['subject'], i['status']) for i in (top.get('incidents') or {}).values()]}")


def incident_drill_phase(E, smi: str, tmp: str) -> dict:
    """20a: the incident drill on the card. Counts set to 0 just before;
    the device books' counted step (one eager step per program shape new
    to the process) is taken off."""
    from multidisttorch_tpu_torch.service.incident_drill import run_incidents_bench
    from multidisttorch_tpu_torch.telemetry import device as tele_device

    _zero(E)
    memo0 = len(tele_device._cost_cache)
    t0 = time.time()
    rep = run_incidents_bench(os.path.join(tmp, "20a"), device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    counted = len(tele_device._cost_cache) - memo0
    launches = {k: v - (counted if k in ("elbo_fwd", "elbo_bwd") else 0) for k, v in E.LAUNCHES.items()}
    check(rep["device"] == "cuda", f"20a: the drill ran on {rep['device']}")
    for name, sc in rep["scenarios"].items():
        check(sc["error"] is None and sc["n_incidents"] == 1 and sc["verdict"] == sc["expected"] and sc["bundle_ok"],
              f"20a {name}: {sc['n_incidents']} incidents {sc['incidents']}, expected one {sc['expected']}, "
              f"bundle {sc['bundle_ok']}, error {sc['error']}")
        print(f"20a {name} ({sc['fault']}{', scripted seam' if sc['scripted_seam'] else ''}): "
              f"{sc['incidents'][0]['kind']} [{sc['incidents'][0]['subject']}] x{sc['incidents'][0]['count']}, "
              f"bundle {os.path.basename(sc['bundle'])}, flight ring {sc['flight_ring']}, {sc['train_steps']} train "
              f"steps, {sc['elapsed_s']} s")
    soak = rep["soak"]
    check(len(rep["scenarios"]) == 8 and soak["error"] is None and soak["n_incidents"] == 0,
          f"20a: {len(rep['scenarios'])} scenarios, the soak {soak['n_incidents']} incidents, error {soak['error']}")
    check(rep["ok"], f"20a: gates {rep['gates']}")
    for name, item in rep["not_ported"].items():
        print(f"20a {name}: not ported ({item})")
    check(launches["elbo_fwd"] == launches["elbo_bwd"] == rep["train_steps"]
          and launches["elbo_fwd_lanes"] == launches["elbo_bwd_lanes"] == 0,
          f"20a: kernels launched {dict(E.LAUNCHES)} less {counted} counted steps, {rep['train_steps']} train "
          f"steps in the drill's ledgers")
    print(f"20a: 8 fault scenarios on the diagonal and the soak at 0 (9 of 9; confusion {rep['confusion']}), bundles "
          f"present, taxonomy {rep['taxonomy_hit']} (not covered: {rep['taxonomy_not_covered']}), gates "
          f"{rep['gates']}, soak {soak['train_steps']} steps; {rep['train_steps']} train steps, launches "
          f"{launches} (+{counted} counted steps); {wall:.1f} s ({smi})")
    return launches


# 20b's sweep: four full-width trials, one MNIST-sized epoch each, in chunks of
# 10; trials 0-2 poisoned at step 2 (a divergence storm), trial 3 clean.
PLANE_TRIALS = 4


def plane_sweep(E, smi: str, train, test, tmp: str) -> tuple:
    """20b. The reference (no plan, telemetry off) first; counts set to 0
    just before the telemetry-on run and read just after (its device
    books' counted steps taken off)."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.faults import DIVERGE, FaultPlan, FaultSpec
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.telemetry import device as tele_device
    from multidisttorch_tpu_torch.telemetry import incident as tincident
    from multidisttorch_tpu_torch.train import checkpoint as ck

    group = setup_groups(1, devices=["cuda:0"])[0]
    configs = [TrialConfig(trial_id=t, epochs=1, batch_size=128, seed=t, fused_steps=10) for t in range(PLANE_TRIALS)]
    plan = FaultPlan(specs=tuple(FaultSpec(DIVERGE, t, step=2) for t in range(PLANE_TRIALS - 1)))
    ref_dir, d = os.path.join(tmp, "20b-ref"), os.path.join(tmp, "20b")
    tel = os.path.join(d, "telemetry")
    ref = run_hpo(configs, train, test, groups=[group], out_dir=ref_dir, verbose=False)
    _zero(E)
    memo0 = len(tele_device._cost_cache)
    t0 = time.time()
    with telemetry.telemetry_run(tel) as bus:
        res = run_hpo(configs, train, test, groups=[group], out_dir=d, verbose=False, fault_plan=plan)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ring, det = telemetry.get_flight_ring(), telemetry.get_incident_detector()
        held, noted, emitted, opened = len(ring.snapshot()), ring.noted, bus.emitted, det.opened
    counted = len(tele_device._cost_cache) - memo0
    launches = {k: v - (counted if k in ("elbo_fwd", "elbo_bwd") else 0) for k, v in E.LAUNCHES.items()}
    steps = sum(n for _, n in _attempt_steps(d))
    check(launches["elbo_fwd"] == launches["elbo_bwd"] == steps and not launches["elbo_fwd_lanes"],
          f"20b: kernels launched {dict(E.LAUNCHES)} less {counted} counted steps, {steps} steps in the ledger")
    statuses = [r.status for r in res]
    check(statuses == ["diverged"] * (PLANE_TRIALS - 1) + ["completed"], f"20b: statuses {statuses}")

    def summary(r):
        return (r.status, r.steps, r.history, r.final_train_loss, r.final_test_loss, r.graph_replays)

    t3 = PLANE_TRIALS - 1
    check(summary(res[t3]) == summary(ref[t3]), f"20b: trial {t3} {summary(res[t3])} against {summary(ref[t3])}")
    check(res[t3].graph_replays >= 46, f"20b: trial {t3} ran {res[t3].graph_replays} graph replays")
    _same_checkpoint(ck, ref_dir, d, "20b trial 3 beside the storm", trial_id=t3)
    folded = tincident.load_incidents(tel)
    check(len(folded) == 1 and opened == 1, f"20b: {len(folded)} incidents (opened {opened}): {folded}")
    (inc,) = folded.values()
    check(inc["kind"] == tincident.DIVERGENCE_STORM and inc["detail"]["trials"] == list(range(t3)),
          f"20b: {inc['kind']} naming {inc['detail'].get('trials')}")
    bundle = os.path.join(tel, tincident.BUNDLE_DIRNAME, inc["id"])
    check(all(os.path.isfile(os.path.join(bundle, n)) for n in ("trigger.json", "flight_ring.json")),
          f"20b: {inc['id']}'s bundle is not whole")
    t1 = time.time()
    report = tincident.build_incident_report(d, inc["id"])
    report_s = time.time() - t1
    check(report["verdict"] == inc["kind"] and "events" in report["corroborating_surfaces"],
          f"20b: the offline autopsy says {report['verdict']} from {report['corroborating_surfaces']}")
    print(f"20b: {PLANE_TRIALS} trials {statuses} in {wall:.3f} s; one {inc['kind']} ({inc['id']}) naming trials "
          f"{inc['detail']['trials']}, count {inc['count']}; trial {t3} bit-identical to its run with no plan and "
          f"telemetry off ({res[t3].steps} steps, {res[t3].graph_replays} graph replays, test loss "
          f"{res[t3].final_test_loss:.6f}); the offline autopsy: {report['verdict']} from "
          f"{report['corroborating_surfaces']} in {report_s:.3f} s, {len(report['timeline'])} timeline records; "
          f"flight ring {held} held of {noted} noted ({noted - held} dropped, maxlen {ring.maxlen}); the detector "
          f"saw {noted} events ({emitted} emitted), {noted / steps:.4f} per step over {steps} steps; launches "
          f"{launches} (+{counted} counted steps) ({smi})")
    return launches, d, res, inc


def plane_consoles(d: str, res: list, inc: dict, smi: str) -> None:
    """20c over 20b's directory: the run view and its JSON, the ledger, the
    incident CLI and the checkpoint GC, against 20b's own results; after
    the GC's real pass trial 3's checkpoint still restores."""
    from multidisttorch_tpu_torch.train import checkpoint as ck

    tel = os.path.join(d, "telemetry")
    text, top, led, incs, show, report, gc_dry = _consoles("20b", [
        ("sweep_top", [tel]),
        ("sweep_top", [tel, "--json"]),
        ("ledger_view", [d, "--json"]),
        ("incident", [d, "--json"]),
        ("incident", [d, "show", inc["id"]]),
        ("incident", [d, "report", inc["id"], "--json"]),
        ("ckpt_gc", [d, "--dry-run", "--json"]),
    ])
    top, led, incs, report, gc_dry = map(json.loads, (top, led, incs, report, gc_dry))
    want = {r.trial_id: (r.status, r.steps) for r in res}
    # The run view's step is the last epoch's: a trial that diverged in its
    # first epoch ended none (the ledger has its steps).
    got = {int(t): (v["status"], v["step"]) for t, v in top["trials"].items()}
    check(got == {t: (st, n if st == "completed" else 0) for t, (st, n) in want.items()} and top["done"]
          and "sweep finished" in text, f"20c 20b: sweep_top's trials {got} against the sweep's {want}")
    rows = {v["trial_id"]: (v["attempts"][-1]["status"], v["attempts"][-1]["steps"]) for v in led["by_config"].values()}
    check(rows == want and led["settled"] == len(res), f"20c 20b: ledger_view's configs {rows} against {want}")
    check(list(incs) == [inc["id"]] and incs[inc["id"]]["kind"] == inc["kind"] and inc["id"] in show
          and report["verdict"] == inc["kind"],
          f"20c 20b: the incident CLI listed {list(incs)}, reported {report.get('verdict')}")
    # Only trial 3 ended an epoch, so only it saved a checkpoint.
    t3 = res[-1].trial_id
    stores = {os.path.basename(rep["dir"]): rep["live_chunks"] for rep in gc_dry["reports"]}
    check(list(stores) == [f"trial-{t3}"] and stores[f"trial-{t3}"] > 0 and gc_dry["totals"]["orphans_removed"] == 0,
          f"20c 20b: ckpt_gc --dry-run found {stores}, {gc_dry['totals']}")
    (gc,) = _consoles("20b gc", [("ckpt_gc", [d, "--json"])])
    gc = json.loads(gc)
    path = os.path.join(d, f"trial-{t3}", "state.msgpack")
    ok, _meta, reason = ck.verify_checkpoint(path)
    check(ok, f"20c 20b: trial {t3}'s checkpoint after ckpt_gc: {reason}")
    _same_checkpoint(ck, os.path.join(os.path.dirname(d), "20b-ref"), d, "20c trial 3 after ckpt_gc", trial_id=t3)
    print(f"20c over 20b's directory: sweep_top (text, --json) trials {got}; ledger_view --json {led['configs']} "
          f"configs, {led['settled']} settled; incident list/show/report: {list(incs)} {report['verdict']}; ckpt_gc "
          f"--dry-run {gc_dry['totals']}, then {gc['totals']}; trial {t3}'s checkpoint verifies and restores "
          f"bit-identical ({smi})")


def plane_phase(E, smi: str, train, test) -> dict:
    """Phase 20, with the registry on (as phase 19 left it)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        drill = incident_drill_phase(E, smi, tmp)
        t1 = time.time()
        plane, d, res, inc = plane_sweep(E, smi, train, test, tmp)
        t2 = time.time()
        plane_consoles(d, res, inc, smi)
        t3 = time.time()
    print(f"20c consoles (phase, children, s started together): {CONSOLES}")
    print(f"phase 20: {time.time() - t0:.1f} s (20a {t1 - t0:.1f} s, 20b {t2 - t1:.1f} s, 20c over 20b {t3 - t2:.1f} s; "
          f"20c's children in phases 18 and 19 {sum(s for w, _, s in CONSOLES if w in ('18a', '19c')):.1f} s)")
    return {"incident_drill": drill, "plane": plane}


def main() -> None:
    if not torch.cuda.is_available():
        fail(f"torch.cuda.is_available() is False (torch {torch.__version__}); no card to drive")
    sys.path.insert(0, HERE)
    try:
        from multidisttorch_tpu_torch.ops import _build
        from multidisttorch_tpu_torch.ops import attention as A
        from multidisttorch_tpu_torch.ops import elbo as E
    except ImportError as e:
        fail(f"the port is not importable beside this script ({e})")
    import torch.nn.functional as F

    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    # Phase 0: the backend preflight, before this process touches CUDA.
    preflight_phase()

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {card}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    # Phases 1-15 hold the per-trial graphs (each trial, bucket and PBT run
    # captures its own); phase 16 turns the program registry on.
    os.environ["MDT_AOT_ADMISSION"] = "0"

    # Phase 2: build, one nvcc per source, all started together, with the
    # ELBO kernels' launch-floor build (kernels that return at once).
    from concurrent.futures import ThreadPoolExecutor

    from multidisttorch_tpu_torch.ops import elbo_ablation

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        floor_job = pool.submit(elbo_ablation.build_variants, ["empty"])
        built = _build.build_all()
        floor = floor_job.result()["empty"]
    print(f"built {[p.name for p in built]} and the ELBO launch-floor build in {time.time() - t0:.1f} s")
    check(any(p.name.startswith("libfastloader_") for p in built), "phase 2: the native gatherer was not built")
    for name, log in _build.ptxas_reports.items():
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
        spills = sorted({int(s) for s in re.findall(r"(\d+) bytes spill stores", log)})
        print(f"ptxas {name}: registers per thread {regs}, spill-store bytes {spills}")
    # The tensor-core kernels one by one: registers, spills, and the dynamic
    # shared memory each launch asks for.
    log = _build.ptxas_reports.get("flash_attention", "")
    for line in log.splitlines():
        if "warning" in line.lower():
            print(f"ptxas flash_attention: {line.strip()}")
    for entry in re.split(r"(?=ptxas info\s+: Compiling entry function)", log):
        m = re.search(r"Compiling entry function '\S*(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)ILi(\d+)E", entry)
        if m:
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            smem = A.wgmma_smem_bytes(m.group(1).removesuffix("_wgmma_kernel"), int(m.group(2)))
            print(f"ptxas {m.group(1)}<{m.group(2)}>: {regs.group(1) if regs else '?'} registers, "
                  f"spill stores/loads {spill.groups() if spill else '?'} bytes, dynamic shared memory {smem} bytes")

    # Phase 3: each kernel against its plain version. The timed shapes
    # take the 8-wide vector loop only (784 and 20*B are multiples of 8 for
    # even B); the untimed ones drive the scalar tails (odd batch; 783
    # pixels and latent 5) and the scalar path of unaligned views.
    main_shape = None
    for b, d, lat, dt in (
        (128, 784, 20, torch.float32),
        (1000, 784, 20, torch.float32),
        (128, 784, 20, torch.bfloat16),
        (8192, 784, 20, torch.float32),
    ):
        r = kernel_vs_plain(E, F, b, d, lat, dt, smi=smi, floor=floor)
        if main_shape is None:
            main_shape = r
    kernel_vs_plain(E, F, 127, 784, 20, torch.float32, timed=False)
    kernel_vs_plain(E, F, 33, 783, 5, torch.bfloat16, timed=False)
    kernel_vs_plain(E, F, 128, 784, 20, torch.float32, offset=1, timed=False)
    kernel_vs_plain(E, F, 127, 784, 20, torch.bfloat16, offset=3, timed=False)
    check(main_shape["fwd_kernels_per_call"] == 1,
          f"elbo_fwd at (128, 784, 20) f32: {main_shape['fwd_kernels_per_call']} device kernels per call, expected 1")
    check(main_shape["bwd_kernels_per_call"] == 1,
          f"elbo_bwd at (128, 784, 20) f32: {main_shape['bwd_kernels_per_call']} device kernels per call, expected 1")

    # Phase 4: one train step, fused against plain.
    group = setup_groups(1, device="cuda:0")[0]
    train_step_fused_vs_plain(group, smi)

    # Phase 5: the multi-step as CUDA graphs against its eager loop.
    graphed_vs_eager(E, group, smi)

    # Phase 6: the slice, through run_hpo (graph replays), writing its
    # checkpoints (the default) into a temporary directory. Counts reset
    # just before. From here on every train iterator's gather path is noted.
    _watch_feeds()
    train = synthetic_mnist(60000, seed=0)
    test = synthetic_mnist(10000, seed=1)
    configs = [
        TrialConfig(trial_id=g, epochs=1 + g, batch_size=128, seed=g, fused_steps=10)
        for g in range(2)
    ]
    lines = _Lines()
    logging.getLogger("multidisttorch_tpu_torch").addHandler(lines)
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        results = run_hpo(configs, train, test, groups=[group], out_dir=tmp)
    torch.cuda.synchronize()
    sweep_s = time.time() - t0
    launches = dict(E.LAUNCHES)
    logging.getLogger("multidisttorch_tpu_torch").removeHandler(lines)
    steps = sum(r.steps for r in results)
    check(steps == 468 * 3, f"slice ran {steps} train steps, expected {468 * 3}")
    for k in ("elbo_fwd", "elbo_bwd"):
        check(launches[k] == steps, f"{k} launched {launches[k]} times in {steps} train steps")
    # Per-trial step losses, from the log lines (the trials ran in turn).
    per_trial, cur = [], []
    for ln in lines.lines:
        m = re.search(r"Loss: ([-+0-9.eEnaif]+)", ln)
        if m:
            cur.append(float(m.group(1)))
        elif "Done. time" in ln:
            per_trial.append(cur)
            cur = []
    check(len(per_trial) == 2, f"expected log lines of 2 trials, got {len(per_trial)}")
    for r, losses in zip(results, per_trial):
        check(r.status == "completed", f"trial {r.trial_id}: {r.status} {r.error}")
        # Each trial's chunks: its first is the eager warm-up, every other
        # one a replay (47 chunks per epoch: 46 of 10 steps and one of 8).
        want = 47 * len(r.history) - 1
        check(r.graph_replays == want, f"trial {r.trial_id}: {r.graph_replays} graph replays, expected {want}")
        check(all(math.isfinite(v) for v in losses), f"trial {r.trial_id}: non-finite logged loss")
        check(losses[-1] < losses[0], f"trial {r.trial_id}: loss did not fall ({losses[0]} -> {losses[-1]})")
        check(math.isfinite(r.final_test_loss), f"trial {r.trial_id}: non-finite test loss")
        print(
            f"trial {r.trial_id}: {r.steps} steps, {len(r.history)} epochs, loss {losses[0]:.4f} -> {losses[-1]:.4f}, test {r.final_test_loss:.4f}, "
            f"{r.graph_replays} graph replays, wall {r.wall_s:.3f} s (eval and epoch ends included), "
            f"samples/s {r.steps * 128 / r.wall_s:.1f} ({smi})"
        )
    slice_samples_s = steps * 128 / sweep_s
    print(f"slice: {steps} train steps in {sweep_s:.3f} s, checkpoints on, {slice_samples_s:.1f} train samples/s; "
          f"launches {launches}")
    # The slice's wall time with checkpoints off and on, in alternating
    # rounds (off, on, on, off, twice), log lines off.
    walls = {True: [], False: []}
    for save in (False, True, True, False) * 2:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            run_hpo(configs, train, test, groups=[group], out_dir=tmp, save_checkpoints=save, verbose=False)
            torch.cuda.synchronize()
            walls[save].append(time.time() - t0)
    print(f"slice wall s, checkpoints on: {walls[True]} (median {statistics.median(walls[True]):.6f}), "
          f"off: {walls[False]} (median {statistics.median(walls[False]):.6f}) "
          f"(rounds off, on, on, off, twice; {smi})")

    _check_feeds("6")

    # Phase 7: checkpoints, resume and a supervised retry on the main path.
    checkpoint_phase(E, group, smi, train, test)
    _check_feeds("7")


    # Phase 8: each flash kernel against its plain version. Timed at the
    # LM's full width; the first is the training path's shape and dtype.
    flash_main = flash_vs_plain(A, F, 128, 512, 64, torch.bfloat16, True)
    flash_vs_plain(A, F, 128, 512, 64, torch.float32, True)
    flash_vs_plain(A, F, 128, 512, 64, torch.float32, False)
    flash_vs_plain(A, F, 4, 64, 64, torch.float32, True, timed=False)
    flash_vs_plain(A, F, 4, 64, 64, torch.float32, False, timed=False)
    flash_vs_plain(A, F, 4, 96, 20, torch.float32, True, timed=False)
    flash_vs_plain(A, F, 4, 96, 20, torch.float32, False, timed=False)
    flash_vs_plain(A, F, 4, 200, 64, torch.bfloat16, True, timed=False)
    flash_vs_plain(A, F, 4, 200, 16, torch.bfloat16, False, timed=False)
    flash_vs_plain(A, F, 2, 130, 256, torch.float32, True, timed=False)
    flash_vs_plain(A, F, 2, 77, 128, torch.bfloat16, False, timed=False)
    # The tensor-core variants' edges: one row, one whole tile, both head
    # dims, causal and not; an unaligned bf16 view goes to the SIMT kernels.
    flash_vs_plain(A, F, 4, 1, 64, torch.bfloat16, True, timed=False)
    flash_vs_plain(A, F, 2, 1, 128, torch.bfloat16, False, timed=False)
    flash_vs_plain(A, F, 4, 64, 128, torch.bfloat16, True, timed=False)
    flash_vs_plain(A, F, 4, 64, 64, torch.bfloat16, False, timed=False)
    flash_vs_plain(A, F, 4, 512, 128, torch.bfloat16, True, timed=False)
    flash_vs_plain(A, F, 4, 200, 64, torch.bfloat16, True, timed=False, offset=1)
    flash_autograd_check(A, 128, 512, 64, True)
    flash_autograd_check(A, 4, 96, 20, False)
    flash_padding_check(A)
    flash_padding_check(A, torch.bfloat16, 64)

    # Phase 9: the LM slice; counts set to 0 inside, just before each part.
    lm_launches, lm_variants = lm_slice(A, group, smi)

    # Phase 10: trial stacking; counts set to 0 inside (c), just before the
    # stacked sweep.
    lane_main = lane_kernel_vs_plain(E, STACK_LANES, 128, 784, 20, torch.float32, smi=smi)
    lane_kernel_vs_plain(E, 3, 37, 784, 20, torch.float32, timed=False)
    lane_kernel_vs_plain(E, 3, 37, 783, 5, torch.bfloat16, timed=False)
    lane_kernel_vs_plain(E, STACK_LANES, 128, 784, 20, torch.bfloat16, timed=False)
    # Phase 11b's shapes: one-lane per-group members and the fused K 4.
    lane_kernel_vs_plain(E, 1, 128, 784, 20, torch.float32, timed=False)
    lane_kernel_vs_plain(E, PBT_PER_GROUP["population"], 128, 784, 20, torch.float32, timed=False)
    reseeded_generator_check()
    stacked_graph_vs_eager(E, group, smi)
    stack_launches = stacked_sweep(E, group, smi, train, test, slice_samples_s)
    _check_feeds("10c")

    # Phase 11: population-based training; counts set to 0 inside (a) and
    # (b), just before each run.
    pbt = pbt_fused_path(E, group, smi, train, test)
    pbt_busy = pbt_generation_checks(group, smi, train, test, pbt["ms_per_generation"])["busy_ms"]
    pbt_b = pbt_per_group_vs_fused(E, group, smi, train, test)
    _check_feeds("11")
    pbt_exchange_under_capture(group)
    set_lr_recapture_check(group)

    # Phase 12: the input feed and remat; counts set to 0 inside (b) and (c),
    # just before each run.
    feed_gatherer(group, smi, train)
    feed = pbt_feed_on_off(E, group, smi, train, test, pbt_busy)
    slice_feed_on_off(group, smi, train, test)
    remat_launches = remat_phase(E, group, smi)

    # Phase 14: the model families at full width; counts set to 0 inside,
    # just before each family's run_hpo.
    conv = conv_vae_phase(E, F, group, smi, floor)
    moe = moe_vae_phase(E, group, smi, train, test)
    _check_feeds("14")
    resnet_phase(E, group, smi)

    # Phase 15: fault plans, the chaos drill and the event bus; counts set to
    # 0 inside, just before each drill.
    chaos = chaos_drill(E, smi, stacked=False)
    chaos_stacked = chaos_drill(E, smi, stacked=True)
    tele = empty_plan_and_telemetry(E, group, smi, train, test)
    resume = conv_resume(E, group, smi)
    _check_feeds("15")

    # Phase 16: compile and dispatch, the registry on; counts set to 0 inside,
    # just before each run.
    comp = compile_phase(E, smi, train, test)

    # Phase 17: device books, the anomaly monitor, profiling and the
    # families' books (the registry on); counts set to 0 inside, just before
    # each run.
    books = books_phase(E, smi, train, test)

    # Phase 18: elastic multi-host; counts set to 0 inside, just before the
    # drill; the workers and the drain's children count their own.
    elastic = elastic_phase(E, smi)

    # Phase 19: the sweep service; counts set to 0 inside, just before each
    # part; the drill's restarted daemon counts its own.
    service = service_phase(E, smi, train, test)

    # Phase 20: the operator plane; counts set to 0 inside, just before the
    # drill and the telemetry-on sweep; phases 18 and 19 ran its consoles
    # over their own directories.
    plane = plane_phase(E, smi, train, test)

    # Phase 13: the kernels line, then the result.
    # "ms", "plain_ms" and "library_ms" are device time per call at the
    # slice's shape (batch 128, f32); "*_call_ms" add the host's per-call
    # cost; "graph_ms" is per call replayed from a CUDA graph, "cold_ms"
    # with a cold L2, "floor_ms" / "floor_graph_ms" the same launch of
    # kernels that return at once. "launches" counts the launches the slice's
    # train steps (phase 6), remat's graphed runs (phase 12c) and the conv
    # and MoE VAE slices (phase 14a, 14b), and the chaos drill (15a, both of
    # its runs), the empty-plan slice (15c), the conv resume (15d) and
    # phase 16's registry sweeps (16a's three ways, 16b's retried run) and
    # phase 17's (17a's sweep off and on, 17b's drill, 17c's profiled run) and
    # phase 18's (18a's workers over both worlds, from their own counts, and
    # its in-process reference; 18b's three children) and phase 19's
    # ("service": 19a's lone trial, 19b's preempted lanes and the defrag
    # drill; "service_drill": 19c's restarted daemon, from its own counts) and
    # phase 20's ("incident_drill": 20a's sweeps; "plane": 20b's telemetry-on
    # sweep) ran, graph replays included, one per wrapper call; "launches_by_path" each. "conv_vae_width" holds the
    # same times at the conv beta-VAE's shape, (128, 3072, 64) f32.
    src = "multidisttorch_tpu_torch/ops/csrc/elbo.cu"
    m = main_shape
    kernels = []
    for name, key, line in (("elbo_fwd", "fwd", 134), ("elbo_bwd", "bwd", 163)):
        lib = f"{key}_library"
        by_path = {"slice": launches[name], **{run: n[name] for run, n in remat_launches.items()
                                               if "stacked" not in run},
                   "conv_vae_slice": conv["launches"][name], "moe_vae_slice": moe["launches"][name],
                   "chaos": chaos["launches"][name], "empty_plan": tele["launches"][name],
                   "conv_resume": resume["launches"][name],
                   **{f"registry_{way}": n[name] for way, n in comp["parity"].items()},
                   "registry_retry": comp["retry"][name],
                   **{path: n[name] for path, n in books.items() if path != "bucket"},
                   **{path: n[name] for path, n in elastic.items()},
                   "service": service["service"][name], "service_drill": service["service_drill"][name],
                   "incident_drill": plane["incident_drill"][name], "plane": plane["plane"][name]}
        c = conv["kernels"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"multidisttorch_tpu/ops/pallas_elbo.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path, "max_abs_err": m[f"{key}_err"],
            "ms": m[f"{key}_ms"], "plain_ms": m[f"{key}_plain_ms"],
            "bound_ms": m[f"{key}_bound_ms"], "bound_by": m[f"{key}_bound_by"],
            "library_ms": m[f"{lib}_ms"],
            "call_ms": m[f"{key}_call_ms"], "plain_call_ms": m[f"{key}_plain_call_ms"],
            "library_call_ms": m[f"{lib}_call_ms"],
            "graph_ms": m[f"{key}_graph_ms"],
            "ms_from": m[f"{key}_from"], "plain_ms_from": m[f"{key}_plain_from"],
            "library_ms_from": m[f"{lib}_from"],
            "cold_ms": m[f"{key}_cold_ms"], "floor_ms": m[f"{key}_floor_ms"],
            "floor_graph_ms": m[f"{key}_floor_graph_ms"],
            "grid_launches_per_call": m[f"{key}_kernels_per_call"],
            "launch": m["fwd_route"] if key == "fwd" else f"{m['bwd_grid']} CTAs of 256",
            "conv_vae_width": {
                "shape": [128, 3072, 64], "ms": c[f"{key}_ms"], "plain_ms": c[f"{key}_plain_ms"],
                "bound_ms": c[f"{key}_bound_ms"], "bound_by": c[f"{key}_bound_by"],
                "library_ms": c[f"{lib}_ms"], "graph_ms": c[f"{key}_graph_ms"], "cold_ms": c[f"{key}_cold_ms"],
                "call_ms": c[f"{key}_call_ms"], "max_abs_err": c[f"{key}_err"],
                "grid_launches_per_call": c[f"{key}_kernels_per_call"],
            },
        })
    # Flash rows: device time per call at the LM training path's shape
    # ((128, 512, 64) causal bf16), whose variant "variant" names ("simt_ms":
    # the first port's SIMT kernel on the same operands, same run);
    # "launches" counts the LM path's train steps, eval and decode prefill,
    # and "launches_by_variant" splits them.
    for name, line in (("flash_fwd", 160), ("flash_bwd_dq", 332), ("flash_bwd_dkv", 346)):
        kernels.append({
            "name": name, "route": "cuda", "source": "multidisttorch_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"multidisttorch_tpu/ops/pallas_attention.py:{line}",
            "launches": lm_launches[name],
            "launches_by_variant": {key.split(":")[1]: n for key, n in lm_variants.items()
                                    if key.startswith(f"{name}:")},
            **flash_main[name],
            "grid_launches_per_call": 1,
        })
    # Lane rows: device time per call at the stacked path's shape (K 8, batch
    # 128, f32); "singles_ms" is 8 launches of the single-trial kernel on the
    # same operands; no single PyTorch call computes per-lane sums, so
    # "library_ms" is null. "launches" counts the stacked sweep's (phase 10c),
    # PBT's (phase 11a, fused K 8; phase 11b, per-group and fused K 4; phase
    # 12b, the first fused K 8 run with the feed on and off), the stacked
    # remat runs' (phase 12c), the stacked chaos drill's (15b, both of its
    # runs), phase 16's (16c's bucket alone and beside the farm, 16d's two
    # buckets and two fused PBT runs), 17a's bucket and phase 19's
    # ("service_stacked": 19a's buckets and 19b's preempted bucket;
    # "service_drill": 19c's restarted daemon), "launches_by_path" each.
    by_path = {name: {"stacked_sweep": stack_launches[name], "pbt_fused": pbt["launches"][name],
                      "pbt_per_group_k4": pbt_b["per_group"][name], "pbt_fused_k4": pbt_b["fused"][name],
                      "pbt_fused_feed_on": feed["on"]["launches"][name],
                      "pbt_fused_feed_off": feed["off"]["launches"][name],
                      **{run: n[name] for run, n in remat_launches.items() if "stacked" in run},
                      "chaos_stacked": chaos_stacked["launches"][name],
                      "registry_bucket_alone": comp["farm"]["alone"][name],
                      "registry_bucket_beside_farm": comp["farm"]["farm"][name],
                      "registry_two_buckets": comp["slots"]["buckets"][name],
                      "registry_pbt_twice": comp["slots"]["pbt"][name],
                      "books_bucket": books["bucket"][name],
                      "service_stacked": service["service_stacked"][name],
                      "service_drill": service["service_drill"][name]}
               for name in ("elbo_fwd_lanes", "elbo_bwd_lanes")}
    for name, key, line in (("elbo_fwd_lanes", "fwd", 134), ("elbo_bwd_lanes", "bwd", 163)):
        m = lane_main
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"multidisttorch_tpu/ops/pallas_elbo.py:{line}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": m[f"{key}_err"],
            "ms": m[f"{key}_ms"], "plain_ms": m[f"{key}_plain_ms"],
            "bound_ms": m[f"{key}_bound_ms"], "bound_by": m[f"{key}_bound_by"], "library_ms": None,
            "call_ms": m[f"{key}_call_ms"], "plain_call_ms": m[f"{key}_plain_call_ms"],
            "graph_ms": m[f"{key}_graph_ms"], "singles_ms": m[f"{key}_singles_ms"],
            "singles_graph_ms": m[f"{key}_singles_graph_ms"], "ms_from": m[f"{key}_from"],
            "grid_launches_per_call": m[f"{key}_kernels_per_call"], "launch": m["launch"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
