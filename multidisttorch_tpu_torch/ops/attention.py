"""Flash attention: hand-written CUDA kernels, forward, dQ and dK/dV.

Counterpart of ``multidisttorch_tpu/ops/pallas_attention.py``, the
single-device half and ring-flash (the sequence over a group, the kernels
inside every hop, :func:`make_ring_flash_attention`). The three kernels in
``ops/csrc/flash_attention.cu`` replace its Pallas TPU kernels:

- ``flash_fwd`` replaces ``_fwd_kernel`` (``pallas_call`` at
  ``pallas_attention.py:160``): the online-softmax forward, ``o`` in the
  input dtype and the per-row logsumexp ``lse`` in f32;
- ``flash_bwd_dq`` replaces ``_bwd_dq_kernel`` (``pallas_call`` at
  ``:332``): ``dq = sum_k ds k`` with ``p`` rebuilt from ``lse`` and
  ``ds = p (dp - delta) scale``;
- ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel`` (``pallas_call`` at
  ``:346``): ``dv = p^T dO`` and ``dk = ds^T q``.

The kernels work on the flat ``(BH, T, D)`` layout, f32 or bf16, with f32
math. What bounds them, and how they are laid out, is in the source's
header. Each comes in two variants: a tensor-core one (TMA-fed ``wgmma``
products, ``"wgmma"``) for the inputs :func:`uses_tensor_cores` accepts,
and the SIMT kernels of the first port (``"simt"``) for every other input.
The tensor-core variants split their f32 operand ``p`` or ``ds`` into bf16
terms: two in the forward and in dQ, three in dK/dV. The choice is made
here, before the launch, and each variant has its own C entry; nothing
falls back from one to the other.

``delta = rowsum(dO * O) - g_lse`` is computed outside the kernels in plain
torch, as the JAX package computes it in XLA; that is how the cotangent of
``lse`` reaches the kernels.

On CUDA tensors :func:`flash_flat_lse` and :func:`flash_attention` launch
the kernels, or raise. On CPU tensors, and only there, they run the plain
versions (:func:`flash_fwd_plain`, :func:`flash_bwd_plain`), which compute
the same function densely in plain PyTorch. ``LAUNCHES`` counts each
kernel's launches, one per wrapper call, and ``LAUNCHES_BY_VARIANT`` the
same launches by ``"kernel:variant"``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Kernel launches since the last reset, one per wrapper call; then the same
# launches by variant.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
LAUNCHES_BY_VARIANT = {
    "flash_fwd:wgmma": 0,
    "flash_fwd:simt": 0,
    "flash_bwd_dq:wgmma": 0,
    "flash_bwd_dq:simt": 0,
    "flash_bwd_dkv:wgmma": 0,
    "flash_bwd_dkv:simt": 0,
}

_BLOCK = 128  # the TPU kernels' tile edge, which the padding rule keeps
_NEG_INF = -1e30  # the TPU kernels' finite causal sentinel
# Largest T that 128 does not divide which runs unpadded (the TPU kernels'
# whole-sequence block); above it causal inputs are padded and non-causal
# ones refused, as in the JAX package.
_MAX_WHOLE_BLOCK = 1024
MAX_HEAD_DIM = 256  # the largest head dim the kernels take
TENSOR_CORE_HEAD_DIMS = (64, 128)  # the head dims of the tensor-core variants
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from multidisttorch_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mdt_flash_fwd.argtypes = [i, p, p, p, p, p, i, i, i, f, i, i, p]
        lib.mdt_flash_fwd.restype = i
        lib.mdt_flash_bwd_dq.argtypes = [i, p, p, p, p, p, p, p, i, i, i, f, i, i, p]
        lib.mdt_flash_bwd_dq.restype = i
        lib.mdt_flash_bwd_dkv.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, f, i, i, p]
        lib.mdt_flash_bwd_dkv.restype = i
        lib.mdt_flash_fwd_wgmma.argtypes = [i, p, p, p, p, p, i, i, i, f, i, p]
        lib.mdt_flash_fwd_wgmma.restype = i
        lib.mdt_flash_bwd_dq_wgmma.argtypes = [i, p, p, p, p, p, p, p, i, i, i, f, i, p]
        lib.mdt_flash_bwd_dq_wgmma.restype = i
        lib.mdt_flash_bwd_dkv_wgmma.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, f, i, p]
        lib.mdt_flash_bwd_dkv_wgmma.restype = i
        lib.mdt_flash_wgmma_smem.argtypes = [i, i]
        lib.mdt_flash_wgmma_smem.restype = i
        _lib = lib
    return _lib


def _check(q, k, v) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"expected q, k, v of one (BH, T, D) shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")


def _check_kernel_operands(*tensors) -> None:
    d = tensors[0].shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take head dims up to {MAX_HEAD_DIM}, got {d}")
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the flash kernels take CUDA tensors, got one on {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"the flash kernels take float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the flash kernels take contiguous tensors")


def reset_launches() -> None:
    """Set every count of ``LAUNCHES`` and ``LAUNCHES_BY_VARIANT`` to 0."""
    for counts in (LAUNCHES, LAUNCHES_BY_VARIANT):
        for key in counts:
            counts[key] = 0


def uses_tensor_cores(*tensors) -> bool:
    """Whether the tensor-core variant takes these operands (q, k, v, and
    dO for the backward): all bf16, head dim 64 or 128, every base pointer
    16-byte aligned, as TMA needs. Decided from the tensors alone, before
    any launch."""
    return (
        tensors[0].shape[-1] in TENSOR_CORE_HEAD_DIMS
        and all(t.dtype == torch.bfloat16 for t in tensors)
        and all(t.data_ptr() % 16 == 0 for t in tensors)
    )


def wgmma_smem_bytes(kernel: str, d: int) -> int:
    """Dynamic shared memory, in bytes, of one launch of the tensor-core
    variant of ``kernel`` (a key of ``LAUNCHES``) at head dim ``d``. Builds
    the kernels."""
    if kernel not in LAUNCHES:
        raise ValueError(f"no flash kernel {kernel!r}; the kernels are {list(LAUNCHES)}")
    n = _kernels().mdt_flash_wgmma_smem(list(LAUNCHES).index(kernel), d)
    if n < 0:
        raise ValueError(f"no tensor-core variant at head dim {d}")
    return n


def _count(kernel: str, variant: str) -> None:
    LAUNCHES[kernel] += 1
    LAUNCHES_BY_VARIANT[f"{kernel}:{variant}"] += 1


def _scores(q, k, scale: float, causal: bool) -> torch.Tensor:
    """f32 scores ``q k^T * scale`` with the finite causal sentinel."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t = q.shape[1]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_plain(q, k, v, scale: float, causal: bool):
    """The forward kernel's function in plain PyTorch: ``(o, lse)``, ``o``
    in the input dtype and ``lse`` f32, from f32 math."""
    s = _scores(q, k, scale, causal)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), _NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.matmul(p, v.float()) / denom
    return o.to(q.dtype), (m + torch.log(denom))[..., 0]


def flash_bwd_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)`` in
    the input dtype, from f32 math; ``delta`` is ``rowsum(dO * O) - g_lse``."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(_scores(q, k, scale, causal) - lse.float()[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_fwd_cuda(q, k, v, scale: float, causal: bool, *, _force_simt: bool = False):
    """Launch ``flash_fwd`` on the current stream; returns ``(o, lse)``.
    ``_force_simt`` runs the SIMT kernel whatever the operands (for timing
    the two variants side by side)."""
    _check(q, k, v)
    _check_kernel_operands(q, k, v)
    bh, t, d = q.shape
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty(bh, t, dtype=torch.float32, device=dev)
    variant = "simt" if _force_simt or not uses_tensor_cores(q, k, v) else "wgmma"
    args = (dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, t, d, float(scale), int(causal))
    with torch.cuda.device(dev):
        if variant == "wgmma":
            err = _kernels().mdt_flash_fwd_wgmma(*args, _stream(dev))
        else:
            err = _kernels().mdt_flash_fwd(*args, _DTYPE_CODE[q.dtype], _stream(dev))
    if err != 0:
        raise RuntimeError(f"flash_fwd ({variant}) launch failed with CUDA error {err}")
    _count("flash_fwd", variant)
    return o, lse


def _check_bwd_operands(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    _check_kernel_operands(q, k, v, do, lse, delta)
    bh, t, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO is {do.dtype} {tuple(do.shape)}, q {q.dtype} {tuple(q.shape)}")
    for name, r in (("lse", lse), ("delta", delta)):
        if r.shape != (bh, t) or r.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({bh}, {t}), got {r.dtype} {tuple(r.shape)}")


def _bwd_args(q, k, v, do, lse, delta, scale, causal):
    bh, t, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    return ptrs, (bh, t, d, float(scale), int(causal))


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, causal: bool, *, _force_simt: bool = False):
    """Launch ``flash_bwd_dq`` on the current stream; returns ``dq``.
    ``_force_simt`` as in :func:`flash_fwd_cuda`."""
    _check_bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, scale, causal)
    variant = "simt" if _force_simt or not uses_tensor_cores(q, k, v, do) else "wgmma"
    args = (q.device.index, *ptrs, dq.data_ptr(), *dims)
    with torch.cuda.device(q.device):
        if variant == "wgmma":
            err = _kernels().mdt_flash_bwd_dq_wgmma(*args, _stream(q.device))
        else:
            err = _kernels().mdt_flash_bwd_dq(*args, _DTYPE_CODE[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq ({variant}) launch failed with CUDA error {err}")
    _count("flash_bwd_dq", variant)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float, causal: bool, *, _force_simt: bool = False):
    """Launch ``flash_bwd_dkv`` on the current stream; returns ``(dk, dv)``.
    ``_force_simt`` as in :func:`flash_fwd_cuda`."""
    _check_bwd_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, scale, causal)
    variant = "simt" if _force_simt or not uses_tensor_cores(q, k, v, do) else "wgmma"
    args = (q.device.index, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims)
    with torch.cuda.device(q.device):
        if variant == "wgmma":
            err = _kernels().mdt_flash_bwd_dkv_wgmma(*args, _stream(q.device))
        else:
            err = _kernels().mdt_flash_bwd_dkv(*args, _DTYPE_CODE[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv ({variant}) launch failed with CUDA error {err}")
    _count("flash_bwd_dkv", variant)
    return dk, dv


def flash_bwd_cuda(q, k, v, do, lse, delta, scale: float, causal: bool):
    """Launch both backward kernels; returns ``(dq, dk, dv)``."""
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    return (dq, *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal))


class FlashFlatLse(torch.autograd.Function):
    """``(o, lse)`` over the flat ``(BH, T, D)`` layout, with a real lse
    gradient (the JAX package's ``_flash_flat_lse``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        _check(q, k, v)
        if q.device.type == "cpu":
            o, lse = flash_fwd_plain(q, k, v, scale, causal)
        else:
            o, lse = flash_fwd_cuda(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        # An lse cotangent folds into delta with no kernel change: the
        # score gradient is p (dp - delta + g_lse).
        delta = (g_o.float() * o.float()).sum(dim=-1) - g_lse.float()
        do = g_o.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            grads = flash_bwd_plain(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        else:
            grads = flash_bwd_cuda(q, k, v, do, lse, delta.contiguous(), ctx.scale, ctx.causal)
        return (*grads, None, None)


def flash_flat_lse(q, k, v, scale: float, causal: bool):
    """``(o, lse)`` of attention over ``(BH, T, D)``: ``o`` in the input
    dtype, ``lse`` the f32 per-row logsumexp of the scaled scores.
    Differentiable in both outputs."""
    return FlashFlatLse.apply(q, k, v, float(scale), bool(causal))


def flash_attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Exact blockwise attention; drop-in for
    :func:`ops.ring_attention.dense_attention_reference`.

    ``q, k, v``: ``(batch, seq, heads, head_dim)``, bf16 or f32. The same
    contract as the JAX package's ``flash_attention``: a causal ``T`` above
    ``_MAX_WHOLE_BLOCK`` that 128 does not divide is zero-padded to the tile
    edge and the output sliced back (exact: the causal mask keeps every real
    query from the appended keys), and the same non-causal case raises.
    """
    b, t, h, d = q.shape
    if t % _BLOCK and t > _MAX_WHOLE_BLOCK:
        if not causal:
            raise ValueError(
                f"flash_attention: non-causal seq_len {t} is neither a "
                f"multiple of {_BLOCK} nor small enough "
                f"(<= {_MAX_WHOLE_BLOCK}) for the whole-sequence block "
                f"path; pad the sequence to a multiple of {_BLOCK} and "
                "mask in the caller"
            )
        pad = (0, 0, 0, 0, 0, -t % _BLOCK)
        return flash_attention(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), causal=True)[:, :t]
    scale = 1.0 / (d**0.5)

    # (B, T, H, D) -> (B*H, T, D): each (batch, head) pair is an
    # independent attention problem.
    def to_flat(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    o, _ = flash_flat_lse(to_flat(q), to_flat(k), to_flat(v), scale, causal)
    return o.reshape(b, h, t, d).transpose(1, 2)


def make_flash_attention(*, causal: bool = True):
    """An ``attention=`` callable for :class:`models.transformer
    .TransformerLM` through the flash kernels. ``head_sharded`` and
    ``carries_collectives`` are False, as in the JAX package."""

    def attn(q, k, v):
        return flash_attention(q, k, v, causal=causal)

    attn.head_sharded = False
    attn.carries_collectives = False
    return attn


# ---------------------------------------------------------------------
# ring-flash: the sequence over a group's ranks, the flash kernels per hop
# ---------------------------------------------------------------------

RING_HOP_MODES = ("full", "diag", "skip")


def ring_hop_mode(my: int, src: int, causal: bool) -> str:
    """Which attention a ring-flash hop computes when rank ``my`` holds rank
    ``src``'s K/V block: ``"full"`` (a block left of the diagonal, or any
    block without the causal mask), ``"diag"`` (the rank's own block, locally
    causal: equal offsets make the local mask exact) or ``"skip"`` (a block
    right of the diagonal, which no query sees)."""
    if not causal or src < my:
        return "full"
    return "diag" if src == my else "skip"


def ring_flash_hop(qf, kf, vf, m, l, acc, mode: str, scale: float):
    """One ring-flash hop over the flat ``(BH, Tq, D)`` layout: the block
    pair through :func:`flash_flat_lse` (the flash kernels on a card; none
    for ``"skip"``, whose hop is zeros with the ``-1e30`` lse sentinel),
    then the online-softmax update of the f32 carry ``m``, ``l`` ``(BH,
    Tq)`` and ``acc`` ``(BH, Tq, D)``, as the JAX package combines hops
    (``pallas_attention.py:529-533``). Returns the new ``(m, l, acc)``.
    Differentiable through ``o`` and ``lse``: the hop weights carry the
    lse cotangent into the backward kernels' ``delta``."""
    if mode == "skip":
        o_h = torch.zeros_like(qf)
        lse_h = torch.full(qf.shape[:2], _NEG_INF, dtype=torch.float32, device=qf.device)
    elif mode in ("full", "diag"):
        o_h, lse_h = flash_flat_lse(qf, kf, vf, scale, mode == "diag")
    else:
        raise ValueError(f"ring hop mode {mode!r} is not one of {RING_HOP_MODES}")
    m_new = torch.maximum(m, lse_h)
    c = torch.exp(m - m_new)
    w = torch.exp(lse_h - m_new)
    return m_new, l * c + w, acc * c[..., None] + w[..., None] * o_h.float()


def ring_flash_init(qf):
    """The ring-flash carry before the first hop: ``m`` at the sentinel,
    ``l`` and ``acc`` zero, f32."""
    bh, t, d = qf.shape
    m = torch.full((bh, t), _NEG_INF, dtype=torch.float32, device=qf.device)
    return m, torch.zeros_like(m), torch.zeros(bh, t, d, dtype=torch.float32, device=qf.device)


def ring_flash_finish(l, acc, dtype) -> torch.Tensor:
    """The combined hops' output, ``acc / l`` where ``l > 0`` (else ``acc``),
    in ``dtype``."""
    return (acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]).to(dtype)


def _ring_flash_local(q, k, v, *, group, causal: bool, scale: float) -> torch.Tensor:
    """This rank's ring-flash: its ``(B, T/k, H, D)`` chunks in, its chunk
    of the attention out. K/V rotate as in ``ops/ring_attention.py``; each
    hop is :func:`ring_flash_hop`."""
    from multidisttorch_tpu_torch.ops.ring_attention import ring_blocks

    b, t_loc, h, d = q.shape
    my = group.local_rank

    def flat(x):
        return x.transpose(1, 2).reshape(b * h, t_loc, d).contiguous()

    qf = flat(q)
    m, l, acc = ring_flash_init(qf)
    for step, (kf, vf) in enumerate(ring_blocks(group, flat(k), flat(v))):
        mode = ring_hop_mode(my, (my - step) % group.size, causal)
        m, l, acc = ring_flash_hop(qf, kf, vf, m, l, acc, mode, scale)
    out = ring_flash_finish(l, acc, q.dtype)
    return out.reshape(b, h, t_loc, d).transpose(1, 2)


def make_ring_flash_attention(group, *, causal: bool = False, shard_heads="auto"):
    """Sequence-parallel exact attention with flash-kernel hops.

    The contract of :func:`ops.ring_attention.make_ring_attention` (each
    rank passes its ``(batch, seq/k, heads, head_dim)`` chunk), with every
    hop's block pair computed by the flash kernels on a card and by their
    plain versions on the CPU, and the hops combined through their
    logsumexps. The callable's ``whole_sequence`` is the flash attention
    over a whole sequence."""
    from multidisttorch_tpu_torch.ops.ring_attention import _resolve_head_axis, _wrap_head_check

    _resolve_head_axis(shard_heads)

    def inner(q, k, v):
        return _ring_flash_local(q, k, v, group=group, causal=causal, scale=1.0 / (q.shape[-1] ** 0.5))

    def whole(q, k, v):
        return flash_attention(q, k, v, causal=causal)

    return _wrap_head_check(inner, group, whole)
