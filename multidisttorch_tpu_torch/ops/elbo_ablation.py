"""What the ELBO forward kernel spends its time on, by ablation.

    python -m multidisttorch_tpu_torch.ops.elbo_ablation

Needs one CUDA card and ``nvcc``. Builds timing-only variants of
``ops/csrc/elbo.cu``, each with one part of ``elbo_fwd_kernel`` left out,
and times ``mdt_elbo_fwd`` of every variant at the main path's shape
((128, 784) logits and x, (128, 20) mu and logvar, f32) by the
profiler's kernel time and by CUDA-graph replay, in two rounds in turns
(the second in the reverse order). The variants compute wrong results on
purpose and are never loaded by the port:

- ``base``: the source as it is;
- ``no_math``: the BCE and KL terms without their ``expf``/``log1pf``;
- ``no_ticket``: each CTA writes its partial and stops: no fence, no
  ticket, no last-CTA sum;
- ``loads_only``: both of the above: the loads, the CTA sums, one store;
- ``acq_rel``: the ticket as an acquire-release atomic and the last CTA's
  fence as ``fence.acq_rel.gpu``, in place of two sequentially consistent
  ``__threadfence()``;
- ``empty``: both kernels return at once: the launch floor, the same
  launch (entry, grid, arguments) with no work. ``chip_smoke.py`` times
  it beside the kernels (:func:`launchers`).

The difference between ``base`` and a variant is what that part costs.
The variants go to ``build/elbo_ablation/`` at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from multidisttorch_tpu_torch.ops import _build, elbo

OUT_DIR = _build.BUILD_DIR.parent / "elbo_ablation"

_NO_MATH = [
    ("return fmaxf(l, 0.f) - l * x + log1pf(expf(-fabsf(l)));", "return fmaxf(l, 0.f) - l * x;"),
    ("return 1.f + lv - m * m - expf(lv);", "return 1.f + lv - m * m;"),
]
_NO_TICKET = [
    (
        "    __threadfence();  // the partial is visible before the ticket is\n"
        "    last = atomicAdd(ws, 1u) == gridDim.x - 1;",
        "    last = false;",
    ),
]
_ACQ_REL = [
    (
        "    __threadfence();  // the partial is visible before the ticket is\n"
        "    last = atomicAdd(ws, 1u) == gridDim.x - 1;",
        "    unsigned ticket;\n"
        '    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(ticket) : "l"(ws) : "memory");\n'
        "    last = ticket == gridDim.x - 1;",
    ),
    ("  __threadfence();\n  float acc = 0.f;", '  asm volatile("fence.acq_rel.gpu;" ::: "memory");\n  float acc = 0.f;'),
]
_EMPTY = [
    ("  __shared__ bool last;\n", "  __shared__ bool last;\n  return;\n"),
    ("                    float beta, const float* g_ptr) {\n",
     "                    float beta, const float* g_ptr) {\n  return;\n"),
]
# Variant name -> (old, new) substitutions in elbo.cu.
VARIANTS = {
    "base": [],
    "no_math": _NO_MATH,
    "no_ticket": _NO_TICKET,
    "loads_only": _NO_MATH + _NO_TICKET,
    "acq_rel": _ACQ_REL,
    "empty": _EMPTY,
}


def build_variants(names=None) -> dict[str, ctypes.CDLL]:
    """Write and build the variants ``names`` (all by default), one
    ``nvcc`` each, all together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "elbo.cu").read_text()
    procs = {}
    for name in VARIANTS if names is None else names:
        subs = VARIANTS[name]
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in elbo.cu")
            text = text.replace(old, new)
        (OUT_DIR / f"{name}.cu").write_text(text)
        cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               "-o", str(OUT_DIR / f"lib{name}.so"), str(OUT_DIR / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = elbo.bind(ctypes.CDLL(str(OUT_DIR / f"lib{name}.so")))
    return libs


def launchers(lib: ctypes.CDLL, logits, x, mu, logvar, g, beta: float = 1.0):
    """``(fwd, bwd)``: launch ``lib``'s ``mdt_elbo_fwd`` / ``mdt_elbo_bwd``
    on these CUDA operands on the current stream, with the port's launch
    plan, a workspace of their own and outputs made here, as the port's
    wrappers would; each raises if its launch fails. Not counted in
    ``elbo.LAUNCHES``."""
    code, fwd_grid, bwd_grid = elbo._plan(logits, x, mu, logvar)
    dev = logits.device
    ws = torch.zeros(1 + 4 * elbo._sms(dev.index), dtype=torch.int32, device=dev)
    out = torch.empty((), device=dev)
    cts = [torch.empty_like(t) for t in (logits, mu, logvar)]
    head = (dev.index, logits.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
            logits.numel(), mu.numel(), code, float(beta))

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name} launch failed with CUDA error {err}")

    def fwd():
        check(lib.mdt_elbo_fwd(*head, fwd_grid, ws.data_ptr(), out.data_ptr(), elbo._stream(dev)), "mdt_elbo_fwd")

    def bwd():
        check(lib.mdt_elbo_bwd(*head, g.data_ptr(), *(t.data_ptr() for t in cts), bwd_grid, elbo._stream(dev)),
              "mdt_elbo_bwd")

    return fwd, bwd


def graph_ms(fn, iters: int = 100) -> float:
    """Device ms per call of ``iters`` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 100) -> float | None:
    """The profiler's device time per call of the ``elbo_*`` kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages() if "elbo_" in e.key)
    return total / iters / 1e3 if total else None


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("elbo_ablation: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build_variants()
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    logits = (torch.randn(128, 784, generator=gen) * 2).to(dev)
    x = torch.rand(128, 784, generator=gen).to(dev)
    mu = torch.randn(128, 20, generator=gen).to(dev)
    logvar = (torch.randn(128, 20, generator=gen) * 0.5).to(dev)
    g = torch.tensor(1.0 / 128, device=dev)
    grid = elbo._plan(logits, x, mu, logvar)[1]
    fns = {name: launchers(lib, logits, x, mu, logvar, g)[0] for name, lib in libs.items()}
    times = {name: [] for name in fns}
    for r in range(2):
        for name in list(fns) if r == 0 else list(reversed(fns)):
            times[name].append((kernel_ms(fns[name]), graph_ms(fns[name])))
    print(f"elbo_fwd ablation, (128, 784, 20) f32, {grid} CTAs of 128; profiler kernel ms / "
          f"CUDA-graph replay ms per call, two rounds ({smi})")
    for name, got in times.items():
        k = [t[0] for t in got if t[0] is not None]
        kern = f"{sum(k) / len(k):.6f}" if k else "not measured"
        print(f"{name}: kernel {kern}, graph {sum(t[1] for t in got) / len(got):.6f} "
              f"(rounds {', '.join(f'{t[0]} / {t[1]:.6f}' for t in got)})")


if __name__ == "__main__":
    main()
