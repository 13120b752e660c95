"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from ``multidisttorch_tpu_torch/ops/csrc``;
3. each ELBO kernel against its plain PyTorch version (value, the three
   gradients, identical bits on a rerun) at four timed shapes, with the
   kernel's, the plain version's and a library call's device time and
   per-call time, and the least time the card could take; then at an odd
   batch, a ragged width and unaligned views, untimed, which drive the
   kernels' scalar tails and scalar path;
4. one full-width train step (784-400-20, batch 128) through the fused
   kernels against the plain loss, from the same weights and noise;
5. the slice: ``run_hpo`` with two trials (1 and 2 epochs) queued on one
   group on ``cuda:0``, MNIST-sized synthetic data, batch 128; the kernels
   must have launched once per train step and the losses must fall;
6. a ``kernels`` JSON line, then the result line.

Exits 1 without a result when CUDA is unavailable or the port is not
beside this script.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# non-tensor-core FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Work per element, counted from the kernels' arithmetic: forward
# BCE (max, mul, sub, abs, exp, log1p, add, accumulate) and KL summand (add,
# sub, mul, sub, exp, accumulate); backward sigmoid-minus-x times g (exp,
# add, div, sub, mul) and the two narrow cotangents (1 and 4).
FWD_OPS = (8, 6)
BWD_OPS = (5, 5)


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


def graph_ms(fn, iters: int = 50) -> float:
    """Device time per call, in ms, of ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events: no host cost per call, but the
    gaps between the graph's kernels count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
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


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 unit in the last place at each value of ``v``."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def kernel_vs_plain(
    E, F, b: int, d: int, lat: int, act_dtype, beta: float = 1.0, *, offset: int = 0, timed: bool = True
) -> dict:
    """Phase 3 at one shape: agreement, determinism and, if ``timed``, times.
    ``offset`` > 0 places every input that many elements into a larger
    buffer: contiguous, but not 16-byte aligned, so the kernels take their
    scalar path."""
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
    if not timed:
        print(f"kernel {tag}: elbo_fwd rel_err={rel:.3e} | elbo_bwd max_abs_err={bwd_err:.3e} "
              "| bit-identical reruns (not timed)")
        return {}

    sz = lambda t: t.numel() * t.element_size()
    fwd_bytes = sz(logits) + sz(x) + sz(mu) + sz(logvar) + 4
    bwd_bytes = sz(logits) + sz(x) + sz(mu) + sz(logvar) + 4 + sz(logits) + sz(mu) + sz(logvar)
    n_w, n_n = logits.numel(), mu.numel()
    fwd_bound, fwd_by = bound_ms(fwd_bytes, FWD_OPS[0] * n_w + FWD_OPS[1] * n_n)
    bwd_bound, bwd_by = bound_ms(bwd_bytes, BWD_OPS[0] * n_w + BWD_OPS[1] * n_n)
    lf, xf = logits.float(), x
    calls = {
        "fwd": (lambda: E.elbo_fwd_cuda(logits, x, mu, logvar, beta), "elbo_fwd"),
        "fwd_plain": (lambda: E.elbo_fwd_plain(logits, x, mu, logvar, beta), ""),
        # Yardstick for the wide part only; timed here, never called by the port.
        "fwd_library": (lambda: F.binary_cross_entropy_with_logits(lf, xf, reduction="sum"), ""),
        "bwd": (lambda: E.elbo_bwd_cuda(logits, x, mu, logvar, beta, g), "elbo_bwd"),
        "bwd_plain": (lambda: E.elbo_bwd_plain(logits, x, mu, logvar, beta, g), ""),
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
    print(
        f"kernel {tag}: elbo_fwd kernel_ms={times['fwd_ms']:.6f} call_ms={times['fwd_call_ms']:.6f} "
        f"plain_ms={times['fwd_plain_ms']:.6f} (call {times['fwd_plain_call_ms']:.6f}) "
        f"bound_us={fwd_bound * 1e3:.4f} ({fwd_by}) "
        f"library_ms={times['fwd_library_ms']:.6f} (call {times['fwd_library_call_ms']:.6f}; "
        f"BCE-with-logits sum, wide part) rel_err={rel:.3e} | "
        f"elbo_bwd kernel_ms={times['bwd_ms']:.6f} call_ms={times['bwd_call_ms']:.6f} "
        f"plain_ms={times['bwd_plain_ms']:.6f} (call {times['bwd_plain_call_ms']:.6f}) "
        f"bound_us={bwd_bound * 1e3:.4f} ({bwd_by}) library_ms=none max_abs_err={bwd_err:.3e} "
        f"| graph replay per call: elbo_fwd {times['fwd_graph_ms']:.6f} ms, "
        f"elbo_bwd {times['bwd_graph_ms']:.6f} ms "
        f"| bit-identical reruns | device ms from: "
        + ", ".join(f"{k} {times[f'{k}_from']}" for k in calls)
    )
    return {
        **times,
        "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
        "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
        "fwd_err": fwd_err, "bwd_err": bwd_err,
    }


def train_step_fused_vs_plain(group) -> None:
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
    print(f"train step 784-400-20 batch 128 fused: {timing[True]}")
    print(f"train step 784-400-20 batch 128 plain: {timing[False]}")


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def main() -> None:
    if not torch.cuda.is_available():
        fail(f"torch.cuda.is_available() is False (torch {torch.__version__}); no card to drive")
    sys.path.insert(0, HERE)
    try:
        from multidisttorch_tpu_torch.ops import _build
        from multidisttorch_tpu_torch.ops import elbo as E
    except ImportError as e:
        fail(f"the port is not importable beside this script ({e})")
    import torch.nn.functional as F

    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

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

    # Phase 2: build.
    t0 = time.time()
    built = [_build.build(name) for name in _build.SOURCES]
    print(f"built {[p.name for p in built]} in {time.time() - t0:.1f} s")
    for name, log in _build.ptxas_reports.items():
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
        spills = sorted({int(s) for s in re.findall(r"(\d+) bytes spill stores", log)})
        print(f"ptxas {name}: registers per thread {regs}, spill-store bytes {spills}")

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
        r = kernel_vs_plain(E, F, b, d, lat, dt)
        if main_shape is None:
            main_shape = r
    kernel_vs_plain(E, F, 127, 784, 20, torch.float32, timed=False)
    kernel_vs_plain(E, F, 33, 783, 5, torch.bfloat16, timed=False)
    kernel_vs_plain(E, F, 128, 784, 20, torch.float32, offset=1, timed=False)
    kernel_vs_plain(E, F, 127, 784, 20, torch.bfloat16, offset=3, timed=False)

    # Phase 4: one train step, fused against plain.
    group = setup_groups(1, device="cuda:0")[0]
    train_step_fused_vs_plain(group)

    # Phase 5: the slice, through run_hpo. Counts reset just before.
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
    results = run_hpo(
        configs, train, test, groups=[group],
        out_dir=os.path.join(HERE, "build", "chip_smoke_results"),
    )
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
        check(all(math.isfinite(v) for v in losses), f"trial {r.trial_id}: non-finite logged loss")
        check(losses[-1] < losses[0], f"trial {r.trial_id}: loss did not fall ({losses[0]} -> {losses[-1]})")
        check(math.isfinite(r.final_test_loss), f"trial {r.trial_id}: non-finite test loss")
        print(
            f"trial {r.trial_id}: {r.steps} steps, {len(r.history)} epochs, loss {losses[0]:.4f} -> {losses[-1]:.4f}, test {r.final_test_loss:.4f}, "
            f"wall {r.wall_s:.3f} s, samples/s {r.steps * 128 / r.wall_s:.1f} ({smi})"
        )
    print(f"slice: {steps} train steps in {sweep_s:.3f} s; launches {launches}")

    # Phase 6: the kernels line, then the result.
    # "ms", "plain_ms" and "library_ms" are device time per call at the
    # slice's shape (batch 128, f32); "*_call_ms" add the host's per-call
    # cost. "launches" counts wrapper calls: elbo_fwd is one logical kernel
    # of two grid launches (partials, then the fixed-order sum).
    src = "multidisttorch_tpu_torch/ops/csrc/elbo.cu"
    m = main_shape
    kernels = []
    for name, key, line, grids, lib in (
        ("elbo_fwd", "fwd", 134, 2, "fwd_library"),
        ("elbo_bwd", "bwd", 163, 1, None),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"multidisttorch_tpu/ops/pallas_elbo.py:{line}",
            "launches": launches[name], "max_abs_err": m[f"{key}_err"],
            "ms": m[f"{key}_ms"], "plain_ms": m[f"{key}_plain_ms"],
            "bound_ms": m[f"{key}_bound_ms"], "bound_by": m[f"{key}_bound_by"],
            "library_ms": m[f"{lib}_ms"] if lib else None,
            "call_ms": m[f"{key}_call_ms"], "plain_call_ms": m[f"{key}_plain_call_ms"],
            "library_call_ms": m[f"{lib}_call_ms"] if lib else None,
            "graph_ms": m[f"{key}_graph_ms"],
            "ms_from": m[f"{key}_from"], "plain_ms_from": m[f"{key}_plain_from"],
            "library_ms_from": m[f"{lib}_from"] if lib else None,
            "grid_launches_per_call": grids,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
