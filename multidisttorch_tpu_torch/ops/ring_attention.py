"""Ring attention: exact attention with the sequence split over a group.

Counterpart of ``multidisttorch_tpu/ops/ring_attention.py``. Each rank of a
:class:`parallel.mesh.TrialGroup` of ``k`` ranks holds ``T/k`` consecutive
positions of every sequence (rank ``r`` positions ``r·T/k .. (r+1)·T/k - 1``)
and calls the ring with its own ``(B, T/k, H, D)`` chunk. Local Q stays put;
K/V rotate one rank per hop, rank ``i`` to ``i+1``, as the JAX package's
``ppermute`` rotates them, so at hop ``s`` rank ``r`` holds the block of rank
``(r - s) mod k``. Each hop is one online-softmax update
(:func:`_attention_block`, plain PyTorch, as the JAX package computes it in
XLA), so no rank ever holds more than a ``(T/k, T/k)`` score block.

The rotation (:class:`_RingRotate`) is one autograd node that sends and
receives every hop's block up front by point-to-point ``isend``/``irecv``
over the group's process group (NCCL on a card, gloo on the CPU); its
backward sends each hop's cotangent back the way the block came, rank ``i``
to ``i-1``, and sums. One node for the whole ring keeps the backward's
messages in the same order on every rank, whatever each rank's hops used.
A group of one rank does one hop and no communication. A group of several
slots in one process has no process group and raises.

The callables carry the JAX package's introspection: ``head_sharded``
(always False here: the port's groups have no model axis, and
``shard_heads=True`` raises naming ROADMAP A.13 and A.15g),
``carries_collectives`` (True), and, for the model, ``sequence_group`` (the
group the sequence is split over) and ``whole_sequence`` (the same attention
over a whole sequence on one rank, which the KV-cache prefill runs).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

_HEAD_SHARDING = (
    "sharding heads over a model axis is not ported yet: ROADMAP A.13 (sharding) "
    "and A.15g (TP shardings); the port's groups have no model axis"
)


def dense_attention_reference(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """O(T²) single-device attention over ``(batch, seq, heads, head_dim)``:
    scores scaled by ``1/sqrt(head_dim)``, a ``-inf`` causal mask, softmax,
    in the inputs' dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.arange(tk, device=s.device)[None, :] <= torch.arange(tq, device=s.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _attention_block(q, k, v, q_pos, k_pos, m, l, acc, *, causal: bool, scale: float):
    """One online-softmax update of local Q against one K/V block.

    q: (B, Tq, H, D); k, v: (B, Tk, H, D); m, l: (B, H, Tq); acc:
    (B, Tq, H, D), all f32. The JAX package's running update, fully masked
    rows (``m == -inf``) kept at zero weight."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
        s = s.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - safe_m[..., None])
    if causal:
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, acc_new


def _check_ring_group(group) -> None:
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")
    if group.size > 1 and group.pg is None:
        raise NotImplementedError(
            f"{group!r} has {group.size} slots in one process: a ring needs one "
            "process per device (launch with torchrun)"
        )


def _exchange(group, tensors, send_to: int, recv_from: int) -> list:
    """Send ``tensors`` to group rank ``send_to`` and receive as many of the
    same shapes from group rank ``recv_from``, as one batch of P2P ops."""
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    to, frm = group.global_ranks[send_to], group.global_ranks[recv_from]
    ops = [dist.P2POp(dist.isend, t, to, group.pg) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, frm, group.pg) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


class _RingRotate(torch.autograd.Function):
    """Every hop's blocks of a ring, ``(x_0, y_0, x_1, y_1, ...)`` for inputs
    ``(x, y)``: hop 0 is the rank's own, hop ``s + 1`` what hop ``s`` held on
    the previous rank. The backward returns each hop's cotangent the way its
    block came (``g = g_{k-1}``, then ``g = back(g) + g_s``)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group, ctx.width = group, len(xs)
        r, k = group.local_rank, group.size
        hops = [[x.clone() for x in xs]]
        for _ in range(k - 1):
            hops.append(_exchange(group, hops[-1], (r + 1) % k, (r - 1) % k))
        return tuple(t for hop in hops for t in hop)

    @staticmethod
    def backward(ctx, *grads):
        group, w = ctx.group, ctx.width
        r, k = group.local_rank, group.size
        acc = list(grads[(k - 1) * w :])
        for s in range(k - 2, -1, -1):
            back = _exchange(group, acc, (r - 1) % k, (r + 1) % k)
            acc = [b + g for b, g in zip(back, grads[s * w : (s + 1) * w])]
        return (None, *acc)


def ring_blocks(group, *xs) -> list:
    """Each hop's blocks of ``xs`` on this rank: a list of ``group.size``
    tuples, hop ``s`` holding rank ``(r - s) mod k``'s tensors.
    Differentiable; a group of one rank returns ``[xs]`` and communicates
    nothing."""
    if group.size == 1:
        return [tuple(xs)]
    flat = _RingRotate.apply(group, *xs)
    w = len(xs)
    return [tuple(flat[s * w : (s + 1) * w]) for s in range(group.size)]


def _ring_attention_local(q, k, v, *, group, causal: bool, scale: float) -> torch.Tensor:
    """This rank's ring: its ``(B, T/k, H, D)`` chunks in, its chunk of the
    attention out, in ``q``'s dtype from f32 math."""
    my, t_local = group.local_rank, q.shape[1]
    b, _, h, d = q.shape
    dev = q.device
    q_pos = my * t_local + torch.arange(t_local, device=dev)
    m = torch.full((b, h, t_local), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=dev)
    qf = q.float()
    for step, (k_blk, v_blk) in enumerate(ring_blocks(group, k, v)):
        src = (my - step) % group.size
        k_pos = src * t_local + torch.arange(t_local, device=dev)
        m, l, acc = _attention_block(qf, k_blk.float(), v_blk.float(), q_pos, k_pos, m, l, acc,
                                     causal=causal, scale=scale)
    # normalise; fully masked rows (l == 0) return zeros
    denom = torch.where(l > 0, l, torch.ones_like(l)).transpose(1, 2)[..., None]
    return (acc / denom).to(q.dtype)


def _resolve_head_axis(shard_heads) -> None:
    """Shared by ring and ring-flash: the port's groups have no model axis
    to shard heads over (``setup_groups(model_parallel>1)`` raises, A.13),
    so ``"auto"`` and False shard none and True raises."""
    if shard_heads and shard_heads != "auto":
        raise NotImplementedError(_HEAD_SHARDING)


def _wrap_head_check(inner, group, whole_sequence):
    """Shared by the ring entry points: the group checks, then ``inner``
    marked with the JAX package's ``head_sharded`` (False) and
    ``carries_collectives`` (True), and with ``sequence_group`` and
    ``whole_sequence`` for the model and the prefill."""
    _check_ring_group(group)
    inner.head_sharded = False
    inner.carries_collectives = True
    inner.sequence_group = group
    inner.whole_sequence = whole_sequence
    return inner


def make_ring_attention(group, *, causal: bool = False, shard_heads="auto"):
    """Sequence-parallel exact attention over ``group``'s ranks.

    Returns ``fn(q, k, v) -> out``; each rank passes its ``(batch, seq/k,
    heads, head_dim)`` chunk (rank ``r`` the ``r``-th ``seq/k`` positions)
    and gets its chunk of the attention over the whole sequence, f32
    accumulation, in the inputs' dtype. Every rank of the group calls it
    together."""
    _resolve_head_axis(shard_heads)

    def inner(q, k, v):
        return _ring_attention_local(q, k, v, group=group, causal=causal,
                                     scale=1.0 / math.sqrt(q.shape[-1]))

    def whole(q, k, v):
        return dense_attention_reference(q, k, v, causal=causal)

    return _wrap_head_check(inner, group, whole)
