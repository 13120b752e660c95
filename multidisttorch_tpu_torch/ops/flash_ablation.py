"""What the tensor-core flash kernels spend their time on, by ablation.

    python -m multidisttorch_tpu_torch.ops.flash_ablation

Needs one CUDA card and ``nvcc``. Builds timing-only variants of
``ops/csrc/flash_attention.cu``, each with one part of the tensor-core
kernels changed, and times ``mdt_flash_fwd_wgmma``,
``mdt_flash_bwd_dq_wgmma`` and ``mdt_flash_bwd_dkv_wgmma`` of every
variant at the LM's full width ((128, 512, 64), causal, bf16) by
CUDA-graph replay, in two rounds in turns (the second in the reverse
order). The variants compute wrong results on purpose and are never
loaded by the port:

- ``base``: the source as it is;
- ``terms1``: ``p`` and ``ds`` rounded to bf16 once (no split) in all three;
- ``bwd_terms2``: dK/dV with two bf16 terms, as the forward and dQ;
- ``dq_terms3``: dQ with three bf16 terms, as dK/dV;
- ``no_exp``: the exponentials of all three left out;
- ``stages3``: three-stage rings in all three;
- ``fwd_wg2``: two consumer warpgroups (128 query rows) per forward CTA,
  sharing each K/V tile.

The difference between ``base`` and a variant is what that part costs.
The variants go to ``build/flash_ablation/`` at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

from multidisttorch_tpu_torch.ops import _build

OUT_DIR = _build.BUILD_DIR.parent / "flash_ablation"

# Variant name -> (old, new) substitutions in flash_attention.cu.
VARIANTS = {
    "base": [],
    "terms1": [
        ("constexpr int kFwdTerms = 2;", "constexpr int kFwdTerms = 1;"),
        ("constexpr int kBwdTerms = 3;", "constexpr int kBwdTerms = 1;"),
        ("constexpr int kDqTerms = 2;", "constexpr int kDqTerms = 1;"),
    ],
    "bwd_terms2": [("constexpr int kBwdTerms = 3;", "constexpr int kBwdTerms = 2;")],
    "dq_terms3": [("constexpr int kDqTerms = 2;", "constexpr int kDqTerms = 3;")],
    "no_exp": [
        ("sc[i] = exp2f(sc[i] - m[h]);", "sc[i] = sc[i] - m[h];"),
        ("sc[i] = exp2f(sc[i] * scale_log2 - lse2[(i >> 1) & 1]);", "sc[i] = sc[i] * scale_log2 - lse2[(i >> 1) & 1];"),
        ("float p = exp2f(st[i] * scale_log2 - lse2[col]);", "float p = st[i] * scale_log2 - lse2[col];"),
    ],
    "stages3": [("constexpr int kTcStages = 2;", "constexpr int kTcStages = 3;")],
    "fwd_wg2": [("constexpr int kFwdWarpgroups = 1;", "constexpr int kFwdWarpgroups = 2;")],
}


def build_variants() -> dict[str, ctypes.CDLL]:
    """Write and build every variant, one ``nvcc`` each, all together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    (OUT_DIR / "hopper_tc.cuh").write_text((_build.CSRC_DIR / "hopper_tc.cuh").read_text())
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in flash_attention.cu")
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
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mdt_flash_fwd_wgmma.argtypes = [i, p, p, p, p, p, i, i, i, f, i, p]
        lib.mdt_flash_bwd_dq_wgmma.argtypes = [i, p, p, p, p, p, p, p, i, i, i, f, i, p]
        lib.mdt_flash_bwd_dkv_wgmma.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, f, i, p]
        libs[name] = lib
    return libs


def graph_ms(fn, iters: int = 100) -> float:
    """Device ms per call of ``iters`` calls captured in one CUDA graph."""
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_ablation: no CUDA card")
    from multidisttorch_tpu_torch.ops import attention as A

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build_variants()
    dev = torch.device("cuda:0")
    bh, t, d, scale = 128, 512, 64, 1.0 / math.sqrt(64)
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(bh, t, d, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    op, lse = A.flash_fwd_plain(q, k, v, scale, True)
    delta = (do.float() * op.float()).sum(-1).contiguous()
    o, lse_out = torch.empty_like(q), torch.empty_like(lse)
    dq_out, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def calls(lib):
        stream = lambda: torch.cuda.current_stream().cuda_stream
        fwd = lambda: lib.mdt_flash_fwd_wgmma(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_out.data_ptr(),
            bh, t, d, scale, 1, stream())
        dq = lambda: lib.mdt_flash_bwd_dq_wgmma(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq_out.data_ptr(), bh, t, d, scale, 1, stream())
        dkv = lambda: lib.mdt_flash_bwd_dkv_wgmma(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t, d, scale, 1, stream())
        return {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv}

    times = {name: {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []} for name in libs}
    for r in range(2):
        for name in list(libs) if r == 0 else list(reversed(libs)):
            for kernel, fn in calls(libs[name]).items():
                if fn() != 0:
                    raise RuntimeError(f"variant {name}: {kernel} launch failed")
                times[name][kernel].append(graph_ms(fn))
    print(f"flash ablation, (128, 512, 64) causal bf16, CUDA-graph replay ms per call, two rounds ({smi})")
    for name, got in times.items():
        print(f"{name}: " + "; ".join(f"{k} {sum(v) / 2:.6f} (rounds {', '.join(f'{x:.6f}' for x in v)})"
                                     for k, v in got.items()))


if __name__ == "__main__":
    main()
