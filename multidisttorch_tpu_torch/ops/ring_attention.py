"""Attention reference for the LM family.

Counterpart of ``multidisttorch_tpu/ops/ring_attention.py``. Only
:func:`dense_attention_reference` is ported so far; the ring factories
(``make_ring_attention``, sequence parallelism over a group) are ROADMAP
A.15a.
"""

from __future__ import annotations

import torch


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
