"""Fused negative-ELBO loss: hand-written CUDA kernels, forward and backward.

Counterpart of ``multidisttorch_tpu/ops/pallas_elbo.py``. The two kernels
in ``ops/csrc/elbo.cu`` replace its Pallas TPU kernels:

- ``elbo_fwd`` replaces ``_fwd_kernel`` (launched by ``_fwd``,
  ``pallas_call`` at ``pallas_elbo.py:134``): the summed negative ELBO,
  ``sum(max(l,0) - l*x + log1p(exp(-|l|))) + beta * -0.5 * sum(1 + lv -
  mu^2 - exp(lv))``, one f32 scalar;
- ``elbo_bwd`` replaces ``_bwd_kernel`` (launched by ``_bwd``,
  ``pallas_call`` at ``pallas_elbo.py:163``): ``g*(sigmoid(l) - x)``,
  ``g*beta*mu`` and ``g*beta*0.5*(exp(lv) - 1)``, each in its primal's
  dtype.

What bounds them on an H100 is bytes. At the flagship shape (batch 128,
784 pixels, latent 20, f32) the forward reads 823,296 B, about 0.25 us at
3.35 TB/s, and the backward reads as much and writes 421,888 B, about
0.37 us; one launch costs more than either, so at that shape both are
launch-bound. The design keeps each pass to one read of each input and one
write of each output: 16-byte vector loads, f32 math in registers, a
fixed grid of at most two blocks per SM. The forward's blocks each write
one partial sum and a second one-block kernel adds the partials in a fixed
order, so there are no float atomics and a rerun gives the same bits (the
TPU kernel carried its sum across a sequential grid; Hopper's blocks run in
no order). The backward reads the upstream cotangent from device memory,
so there is no host sync.

On CUDA tensors :func:`fused_elbo_loss_sum` launches the kernels, or
raises. On CPU tensors, and only there, it runs the plain versions below
(:func:`elbo_fwd_plain`, :func:`elbo_bwd_plain`), which compute the same
function in plain PyTorch: f32 math whatever the input dtype, cotangents in
each primal's dtype. ``LAUNCHES`` counts each kernel's launches, one per
wrapper call that launched it; ``elbo_fwd`` is one logical kernel of two
grid launches (the partials, then their fixed-order sum).
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the last reset, one per wrapper call that launched
# (elbo_fwd's call is two grid launches, counted as one).
LAUNCHES = {"elbo_fwd": 0, "elbo_bwd": 0}

_THREADS = 256  # kThreads in elbo.cu
_VEC = 8  # kVec in elbo.cu
# Bit per operand in the kernels' dtype code: set = bfloat16, clear = float32.
_DTYPE_BIT = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_sm_count: dict[int, int] = {}


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from multidisttorch_tpu_torch.ops import _build

        lib = _build.load("elbo")
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.mdt_elbo_fwd.argtypes = [i, p, p, p, p, i64, i64, i, f, p, i, p, p]
        lib.mdt_elbo_fwd.restype = i
        lib.mdt_elbo_bwd.argtypes = [i, p, p, p, p, i64, i64, i, f, p, p, p, p, i, p]
        lib.mdt_elbo_bwd.restype = i
        _lib = lib
    return _lib


def _check(logits, x, mu, logvar) -> None:
    if logits.dim() != 2 or mu.dim() != 2:
        raise ValueError(
            f"expected 2-D (batch, D) and (batch, latent) arrays, got logits "
            f"{tuple(logits.shape)} and mu {tuple(mu.shape)}"
        )
    if x.shape != logits.shape or logvar.shape != mu.shape or mu.shape[0] != logits.shape[0]:
        raise ValueError(
            f"shape mismatch: logits {tuple(logits.shape)}, x {tuple(x.shape)}, "
            f"mu {tuple(mu.shape)}, logvar {tuple(logvar.shape)}"
        )
    devices = {t.device for t in (logits, x, mu, logvar)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")


def _check_kernel_operands(*tensors) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(
                f"the ELBO kernels take CUDA tensors, got one on {t.device}"
            )
        if t.dtype not in _DTYPE_BIT:
            raise TypeError(f"the ELBO kernels take float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the ELBO kernels take contiguous tensors")


def _dtype_code(logits, x, mu, logvar) -> int:
    return (
        _DTYPE_BIT[logits.dtype]
        | _DTYPE_BIT[x.dtype] << 1
        | _DTYPE_BIT[mu.dtype] << 2
        | _DTYPE_BIT[logvar.dtype] << 3
    )


def _grid(n: int, device: torch.device) -> int:
    """Blocks for a grid-stride pass over ``n`` elements: enough for one
    vector step per thread, at most two blocks per SM."""
    idx = device.index
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return max(1, min(2 * _sm_count[idx], -(-n // (_THREADS * _VEC))))


def elbo_fwd_plain(logits, x, mu, logvar, beta: float) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: a 0-d f32 tensor."""
    l, xx, m, lv = (t.float() for t in (logits, x, mu, logvar))
    bce = (torch.clamp_min(l, 0.0) - l * xx + torch.log1p(torch.exp(-torch.abs(l)))).sum()
    kl = -0.5 * (1.0 + lv - m * m - torch.exp(lv)).sum()
    return bce + beta * kl


def elbo_bwd_plain(logits, x, mu, logvar, beta: float, g: torch.Tensor):
    """The backward kernel's function in plain PyTorch: the cotangents of
    logits, mu and logvar, scaled by ``g`` before the one rounding to each
    primal's dtype."""
    g = g.float()
    l, xx, m, lv = (t.float() for t in (logits, x, mu, logvar))
    gb = g * beta
    dlogits = (g * (torch.sigmoid(l) - xx)).to(logits.dtype)
    dmu = (gb * m).to(mu.dtype)
    dlogvar = (gb * 0.5 * (torch.exp(lv) - 1.0)).to(logvar.dtype)
    return dlogits, dmu, dlogvar


def elbo_fwd_cuda(logits, x, mu, logvar, beta: float) -> torch.Tensor:
    """Launch ``elbo_fwd`` on the current stream; returns a 0-d f32 tensor."""
    _check(logits, x, mu, logvar)
    _check_kernel_operands(logits, x, mu, logvar)
    dev = logits.device
    lib = _kernels()
    n_wide, n_narrow = logits.numel(), mu.numel()
    grid = _grid(max(n_wide, n_narrow), dev)
    partials = torch.empty(grid, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mdt_elbo_fwd(
            dev.index, logits.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
            n_wide, n_narrow, _dtype_code(logits, x, mu, logvar), float(beta),
            partials.data_ptr(), grid, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"elbo_fwd launch failed with CUDA error {err}")
    LAUNCHES["elbo_fwd"] += 1
    return out


def elbo_bwd_cuda(logits, x, mu, logvar, beta: float, g: torch.Tensor):
    """Launch ``elbo_bwd`` on the current stream; ``g`` is the upstream
    cotangent, read on the device. Returns ``(dlogits, dmu, dlogvar)``."""
    _check(logits, x, mu, logvar)
    _check_kernel_operands(logits, x, mu, logvar)
    dev = logits.device
    g = g.detach().to(device=dev, dtype=torch.float32).reshape(()).contiguous()
    lib = _kernels()
    dlogits = torch.empty_like(logits, memory_format=torch.contiguous_format)
    dmu = torch.empty_like(mu, memory_format=torch.contiguous_format)
    dlogvar = torch.empty_like(logvar, memory_format=torch.contiguous_format)
    n_wide, n_narrow = logits.numel(), mu.numel()
    grid = _grid(max(n_wide, n_narrow), dev)
    with torch.cuda.device(dev):
        err = lib.mdt_elbo_bwd(
            dev.index, logits.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
            n_wide, n_narrow, _dtype_code(logits, x, mu, logvar), float(beta),
            g.data_ptr(), dlogits.data_ptr(), dmu.data_ptr(), dlogvar.data_ptr(), grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"elbo_bwd launch failed with CUDA error {err}")
    LAUNCHES["elbo_bwd"] += 1
    return dlogits, dmu, dlogvar


class _FusedElbo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, x, mu, logvar, beta):
        _check(logits, x, mu, logvar)
        ctx.save_for_backward(logits, x, mu, logvar)
        ctx.beta = beta
        if logits.device.type == "cpu":
            return elbo_fwd_plain(logits, x, mu, logvar, beta)
        return elbo_fwd_cuda(logits, x, mu, logvar, beta)

    @staticmethod
    def backward(ctx, g):
        logits, x, mu, logvar = ctx.saved_tensors
        if logits.device.type == "cpu":
            dlogits, dmu, dlogvar = elbo_bwd_plain(logits, x, mu, logvar, ctx.beta, g)
        else:
            dlogits, dmu, dlogvar = elbo_bwd_cuda(logits, x, mu, logvar, ctx.beta, g)
        dx = None
        if ctx.needs_input_grad[1]:
            # x is data: its true cotangent, outside the kernel, only when
            # asked for (training never differentiates w.r.t. x).
            dx = (g.float() * -logits.float()).to(x.dtype)
        return dlogits, dx, dmu, dlogvar, None


def fused_elbo_loss_sum(logits, x, mu, logvar, beta: float = 1.0) -> torch.Tensor:
    """Summed negative ELBO through the fused kernels.

    Same value as :func:`ops.losses.elbo_loss_sum`. ``logits`` and ``x`` are
    ``(batch, D)``, ``mu`` and ``logvar`` ``(batch, latent)``, each float32
    or bfloat16 (mixed is fine); the sum is f32 and the gradients come back
    in each primal's dtype.
    """
    return _FusedElbo.apply(logits, x, mu, logvar, float(beta))
