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

:func:`fused_elbo_loss_sum_lanes` is the same loss for K same-shape trials
stacked on a leading lane axis (the stacked train step,
``train/steps.py``): ``elbo_fwd_lanes`` and ``elbo_bwd_lanes`` run both
TPU kernels' functions once per lane in one launch each, with ``beta`` and
the cotangent read per lane from device memory, and return one sum per
lane.

What bounds them on an H100 is the launch and the dependent chain inside
it, not bytes. At the main path's shape (batch 128, 784 pixels, latent
20, f32) the forward reads 823,296 B, about 0.25 us at 3.35 TB/s, and the
backward reads as much and writes 421,888 B, about 0.37 us; an empty
launch alone takes about 0.9 us on the device. So each call is one launch
that a CUDA graph can replay as it is. The forward is one grid of
128-thread CTAs (one vector step per thread at the main shape, at most
four CTAs per SM): each CTA sums in-block, writes its partial to a
workspace and takes a ticket on an integer counter there; the CTA with the
last ticket adds the partials in index order and sets the counter back to
0. No float atomics, and the order of the sum does not depend on which CTA
finishes last, so a rerun and every replay give the same bits (the TPU
kernel carried its sum across a sequential grid). The backward is one
elementwise launch that reads the upstream cotangent from device memory
after its other loads are issued, so there is no host sync. Both issue
every 16-byte load of a round before any arithmetic. The launch plan
(dtype code and grids) is cached per (device, shapes, dtypes).

**No two launches share a workspace at the same time.** An eager call
uses the workspace of its (device, stream): calls on one stream are
ordered, and calls on two streams (two trials) use two. A CUDA graph gets
workspaces of its own: the kernels are captured only inside
:func:`capture_scope`, which gives the graph one workspace per capture
stream, zeroed by a fill that the graph replays before its first forward.
So a graph and eager calls never share a ticket counter, whatever streams
they run on. Only two replays of one graph at the same time would, as they
would share every other buffer of the graph. Capturing the kernels outside
a scope raises. The lane kernels' workspace (one ticket counter per lane,
then each lane's partials) follows the same rule, one per (device, stream,
size) in each table.

On CUDA tensors :func:`fused_elbo_loss_sum` launches the kernels, or
raises. On CPU tensors, and only there, it runs the plain versions below
(:func:`elbo_fwd_plain`, :func:`elbo_bwd_plain`), which compute the same
function in plain PyTorch: f32 math whatever the input dtype, cotangents in
each primal's dtype. :func:`fused_elbo_loss_sum_lanes` does the same with
:func:`elbo_fwd_lanes_plain` and :func:`elbo_bwd_lanes_plain`.

``LAUNCHES`` counts the launches the card ran, one per wrapper call. An
eager call counts at once. A call recorded into a CUDA graph counts
nothing while it is captured: its :func:`capture_scope` tallies it, and
whoever replays the graph adds the tally with :func:`count_replay` after
each replay (``train/steps.py::make_multi_step`` does).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

# Launches the card ran since the last reset, one per wrapper call; updated
# under _COUNT_LOCK (the compile farm's workers warm up beside the driver).
LAUNCHES = {"elbo_fwd": 0, "elbo_bwd": 0, "elbo_fwd_lanes": 0, "elbo_bwd_lanes": 0}
_COUNT_LOCK = threading.Lock()

_FWD_THREADS = 128  # kFwdThreads in elbo.cu
_BWD_THREADS = 256  # kBwdThreads
_VEC = 8  # kVec in elbo.cu
# Bit per operand in the kernels' dtype code: set = bfloat16, clear = float32.
_DTYPE_BIT = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_sm_count: dict[int, int] = {}
# (device index, logits shape, mu shape, dtypes) -> (code, forward grid,
# backward grid); for (K, B, D) operands the grids of one lane.
_plans: dict[tuple, tuple[int, int, int]] = {}
# (device index, stream) -> the forward's workspace for eager calls: a
# zero int32 counter, then one f32 partial per CTA of the largest grid;
# (device index, stream, words) -> the lane forward's, ``words`` int32 long.
_workspaces: dict[tuple, torch.Tensor] = {}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give ``lib``'s C entries (``elbo.cu`` or a variant of it) their
    ``ctypes`` signatures."""
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.mdt_elbo_fwd.argtypes = [i, p, p, p, p, i64, i64, i, f, i, p, p, p]
    lib.mdt_elbo_fwd.restype = i
    lib.mdt_elbo_bwd.argtypes = [i, p, p, p, p, i64, i64, i, f, p, p, p, p, i, p]
    lib.mdt_elbo_bwd.restype = i
    lib.mdt_elbo_fwd_lanes.argtypes = [i, p, p, p, p, i64, i64, i, i, p, i, p, p, p]
    lib.mdt_elbo_fwd_lanes.restype = i
    lib.mdt_elbo_bwd_lanes.argtypes = [i, p, p, p, p, i64, i64, i, i, p, p, p, p, p, i, p]
    lib.mdt_elbo_bwd_lanes.restype = i
    return lib


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from multidisttorch_tpu_torch.ops import _build

        _lib = bind(_build.load("elbo"))
    return _lib


class CaptureScope:
    """What the ELBO kernels captured into one CUDA graph need: the
    launches the graph holds, by kernel, and the forward's workspaces of
    its own, by (device, capture stream)."""

    def __init__(self):
        self.launches = {name: 0 for name in LAUNCHES}
        self.workspaces: dict[tuple, torch.Tensor] = {}


# Open capture scopes, innermost last.
_scopes: list[CaptureScope] = []


@contextlib.contextmanager
def capture_scope():
    """Open around the capture of a CUDA graph that holds the ELBO kernels;
    yields the graph's :class:`CaptureScope`, which its owner keeps as long
    as the graph and passes to :func:`count_replay` after each replay."""
    scope = CaptureScope()
    _scopes.append(scope)
    try:
        yield scope
    finally:
        _scopes.pop()  # blocks nest, so this one is innermost


def count_replay(scope: CaptureScope) -> None:
    """Add one replay's launches, those of a :func:`capture_scope`, to
    ``LAUNCHES``."""
    with _COUNT_LOCK:
        for name, n in scope.launches.items():
            LAUNCHES[name] += n


def _capture() -> CaptureScope | None:
    """None for an eager call; in a CUDA-graph capture, the innermost
    :func:`capture_scope`, and without one an error, before anything is
    launched."""
    if not torch.cuda.is_current_stream_capturing():
        return None
    if not _scopes:
        raise RuntimeError(
            "the ELBO kernels are being captured into a CUDA graph outside "
            "elbo.capture_scope(): open one around the capture, keep it with the graph, "
            "and pass it to elbo.count_replay() after each replay"
        )
    return _scopes[-1]


def _count(name: str, scope: CaptureScope | None) -> None:
    if scope is None:
        with _COUNT_LOCK:
            LAUNCHES[name] += 1
    else:
        scope.launches[name] += 1


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


def _check_lanes(logits, x, mu, logvar, beta) -> None:
    if logits.dim() != 3 or mu.dim() != 3:
        raise ValueError(
            f"expected 3-D (lanes, batch, D) and (lanes, batch, latent) arrays, got logits "
            f"{tuple(logits.shape)} and mu {tuple(mu.shape)}"
        )
    if x.shape != logits.shape or logvar.shape != mu.shape or mu.shape[:2] != logits.shape[:2]:
        raise ValueError(
            f"shape mismatch: logits {tuple(logits.shape)}, x {tuple(x.shape)}, "
            f"mu {tuple(mu.shape)}, logvar {tuple(logvar.shape)}"
        )
    if beta.shape != (logits.shape[0],):
        raise ValueError(f"beta has shape {tuple(beta.shape)}, expected ({logits.shape[0]},): one per lane")
    devices = {t.device for t in (logits, x, mu, logvar, beta)}
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


def _vector_steps(n_wide: int, n_narrow: int) -> int:
    return -(-n_wide // _VEC) + -(-n_narrow // _VEC)


def fwd_grid(n_wide: int, n_narrow: int, sm_count: int) -> int:
    """CTAs of the forward: one vector step per thread, at most four CTAs
    per SM (beyond that each thread loops)."""
    return max(1, min(4 * sm_count, -(-_vector_steps(n_wide, n_narrow) // _FWD_THREADS)))


def bwd_grid(n_wide: int, n_narrow: int, sm_count: int) -> int:
    """CTAs of the backward: one vector step per thread, at most 16 CTAs
    per SM (beyond that each thread loops)."""
    return max(1, min(16 * sm_count, -(-_vector_steps(n_wide, n_narrow) // _BWD_THREADS)))


def _sms(idx: int) -> int:
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def _plan(logits, x, mu, logvar) -> tuple[int, int, int]:
    """(dtype code, forward grid, backward grid) for these operands, cached
    per (device, shapes, dtypes); for (K, B, D) and (K, B, L) operands the
    grids of one lane's (B, D) and (B, L) slices."""
    idx = logits.device.index
    key = (idx, logits.shape, mu.shape, logits.dtype, x.dtype, mu.dtype, logvar.dtype)
    plan = _plans.get(key)
    if plan is None:
        lanes = logits.shape[0] if logits.dim() == 3 else 1
        n_wide, n_narrow, sms = logits.numel() // lanes, mu.numel() // lanes, _sms(idx)
        plan = _plans[key] = (
            _dtype_code(logits, x, mu, logvar),
            fwd_grid(n_wide, n_narrow, sms),
            bwd_grid(n_wide, n_narrow, sms),
        )
    return plan


def _stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev``, as the C entries take it."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _workspace(
    dev: torch.device, stream: int, scope: CaptureScope | None, words: int | None = None
) -> torch.Tensor:
    """The forward's workspace for a call on ``stream``: the stream's own
    for an eager call, else the capture scope's for that stream; ``words``
    int32 long for the lane forward (one per size), else the single-trial
    forward's. It is made at first use by a zero fill on the stream: run at
    once, or, in a capture, replayed by the graph before its first
    forward."""
    key = (dev.index, stream) if words is None else (dev.index, stream, words)
    table = _workspaces if scope is None else scope.workspaces
    ws = table.get(key)
    if ws is None:
        n = 1 + 4 * _sms(dev.index) if words is None else words
        ws = table[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return ws


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


def elbo_fwd_lanes_plain(logits, x, mu, logvar, beta: torch.Tensor) -> torch.Tensor:
    """The lane forward kernel's function in plain PyTorch: ``(K,)`` f32,
    lane k's :func:`elbo_fwd_plain` with ``beta[k]``."""
    l, xx, m, lv = (t.float() for t in (logits, x, mu, logvar))
    k = l.shape[0]
    bce = (torch.clamp_min(l, 0.0) - l * xx + torch.log1p(torch.exp(-torch.abs(l)))).reshape(k, -1).sum(1)
    kl = -0.5 * (1.0 + lv - m * m - torch.exp(lv)).reshape(k, -1).sum(1)
    return bce + beta.float() * kl


def elbo_bwd_lanes_plain(logits, x, mu, logvar, beta: torch.Tensor, g: torch.Tensor):
    """The lane backward kernel's function in plain PyTorch: lane k's
    :func:`elbo_bwd_plain` with ``beta[k]`` and ``g[k]``."""
    g = g.float().reshape(-1, 1, 1)
    l, xx, m, lv = (t.float() for t in (logits, x, mu, logvar))
    gb = g * beta.float().reshape(-1, 1, 1)
    dlogits = (g * (torch.sigmoid(l) - xx)).to(logits.dtype)
    dmu = (gb * m).to(mu.dtype)
    dlogvar = (gb * 0.5 * (torch.exp(lv) - 1.0)).to(logvar.dtype)
    return dlogits, dmu, dlogvar


def elbo_fwd_cuda(logits, x, mu, logvar, beta: float) -> torch.Tensor:
    """Launch ``elbo_fwd`` on the current stream; returns a 0-d f32 tensor."""
    _check(logits, x, mu, logvar)
    _check_kernel_operands(logits, x, mu, logvar)
    scope = _capture()
    code, grid, _ = _plan(logits, x, mu, logvar)
    dev = logits.device
    stream = _stream(dev)
    ws = _workspace(dev, stream, scope)
    out = torch.empty((), dtype=torch.float32, device=dev)
    err = _kernels().mdt_elbo_fwd(
        dev.index, logits.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
        logits.numel(), mu.numel(), code, float(beta), grid, ws.data_ptr(), out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"elbo_fwd launch failed with CUDA error {err}")
    _count("elbo_fwd", scope)
    return out


def elbo_bwd_cuda(logits, x, mu, logvar, beta: float, g: torch.Tensor):
    """Launch ``elbo_bwd`` on the current stream; ``g`` is the upstream
    cotangent, read on the device. Returns ``(dlogits, dmu, dlogvar)``."""
    _check(logits, x, mu, logvar)
    _check_kernel_operands(logits, x, mu, logvar)
    scope = _capture()
    code, _, grid = _plan(logits, x, mu, logvar)
    dev = logits.device
    g = g.detach().to(device=dev, dtype=torch.float32).reshape(()).contiguous()
    dlogits = torch.empty_like(logits, memory_format=torch.contiguous_format)
    dmu = torch.empty_like(mu, memory_format=torch.contiguous_format)
    dlogvar = torch.empty_like(logvar, memory_format=torch.contiguous_format)
    err = _kernels().mdt_elbo_bwd(
        dev.index, logits.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
        logits.numel(), mu.numel(), code, float(beta), g.data_ptr(), dlogits.data_ptr(),
        dmu.data_ptr(), dlogvar.data_ptr(), grid, _stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"elbo_bwd launch failed with CUDA error {err}")
    _count("elbo_bwd", scope)
    return dlogits, dmu, dlogvar


def _lane_vector(v: torch.Tensor, dev: torch.device, lanes: int) -> torch.Tensor:
    """``v`` as the kernels read it: ``(lanes,)`` contiguous f32 on ``dev``
    (the tensor itself when it is one already)."""
    return v.detach().to(device=dev, dtype=torch.float32).reshape(lanes).contiguous()


def elbo_fwd_lanes_cuda(logits, x, mu, logvar, beta: torch.Tensor) -> torch.Tensor:
    """Launch ``elbo_fwd_lanes`` on the current stream: ``(K, B, D)`` logits
    and x, ``(K, B, L)`` mu and logvar, ``beta`` ``(K,)`` on the device;
    returns the ``(K,)`` f32 sums."""
    _check_lanes(logits, x, mu, logvar, beta)
    _check_kernel_operands(logits, x, mu, logvar)
    scope = _capture()
    code, grid, _ = _plan(logits, x, mu, logvar)
    dev, lanes = logits.device, logits.shape[0]
    beta = _lane_vector(beta, dev, lanes)
    stream = _stream(dev)
    ws = _workspace(dev, stream, scope, words=lanes * (1 + grid))
    out = torch.empty(lanes, dtype=torch.float32, device=dev)
    err = _kernels().mdt_elbo_fwd_lanes(
        dev.index, logits.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
        logits.numel() // lanes, mu.numel() // lanes, lanes, code, beta.data_ptr(), grid,
        ws.data_ptr(), out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"elbo_fwd_lanes launch failed with CUDA error {err}")
    _count("elbo_fwd_lanes", scope)
    return out


def elbo_bwd_lanes_cuda(logits, x, mu, logvar, beta: torch.Tensor, g: torch.Tensor):
    """Launch ``elbo_bwd_lanes`` on the current stream; ``beta`` and ``g``
    (the upstream cotangents) are ``(K,)``, read on the device. Returns
    ``(dlogits, dmu, dlogvar)``."""
    _check_lanes(logits, x, mu, logvar, beta)
    _check_kernel_operands(logits, x, mu, logvar)
    scope = _capture()
    code, _, grid = _plan(logits, x, mu, logvar)
    dev, lanes = logits.device, logits.shape[0]
    beta, g = _lane_vector(beta, dev, lanes), _lane_vector(g, dev, lanes)
    dlogits = torch.empty_like(logits, memory_format=torch.contiguous_format)
    dmu = torch.empty_like(mu, memory_format=torch.contiguous_format)
    dlogvar = torch.empty_like(logvar, memory_format=torch.contiguous_format)
    err = _kernels().mdt_elbo_bwd_lanes(
        dev.index, logits.data_ptr(), x.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
        logits.numel() // lanes, mu.numel() // lanes, lanes, code, beta.data_ptr(), g.data_ptr(),
        dlogits.data_ptr(), dmu.data_ptr(), dlogvar.data_ptr(), grid, _stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"elbo_bwd_lanes launch failed with CUDA error {err}")
    _count("elbo_bwd_lanes", scope)
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


class _FusedElboLanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, x, mu, logvar, beta):
        _check_lanes(logits, x, mu, logvar, beta)
        ctx.save_for_backward(logits, x, mu, logvar, beta)
        if logits.device.type == "cpu":
            return elbo_fwd_lanes_plain(logits, x, mu, logvar, beta)
        return elbo_fwd_lanes_cuda(logits, x, mu, logvar, beta)

    @staticmethod
    def backward(ctx, g):
        logits, x, mu, logvar, beta = ctx.saved_tensors
        if logits.device.type == "cpu":
            dlogits, dmu, dlogvar = elbo_bwd_lanes_plain(logits, x, mu, logvar, beta, g)
        else:
            dlogits, dmu, dlogvar = elbo_bwd_lanes_cuda(logits, x, mu, logvar, beta, g)
        dx = None
        if ctx.needs_input_grad[1]:
            dx = (g.float().reshape(-1, 1, 1) * -logits.float()).to(x.dtype)
        return dlogits, dx, dmu, dlogvar, None


def fused_elbo_loss_sum_lanes(logits, x, mu, logvar, beta: torch.Tensor) -> torch.Tensor:
    """Summed negative ELBO of K stacked trials, one sum per lane, through
    the lane-batched kernels.

    ``logits`` and ``x`` are ``(K, batch, D)``, ``mu`` and ``logvar`` ``(K,
    batch, latent)``, each float32 or bfloat16; ``beta`` is ``(K,)``, on the
    operands' device (a tensor, so a captured graph reads each lane's value
    at replay). Returns ``(K,)`` f32: lane k's :func:`fused_elbo_loss_sum`
    with ``beta[k]``; the gradients come back in each primal's dtype.
    """
    return _FusedElboLanes.apply(logits, x, mu, logvar, beta)
