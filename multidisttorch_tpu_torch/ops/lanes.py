"""Lane-batched dense products: K same-shape ``nn.Linear`` layers as one
batched product over a leading lane axis.

The stacked model forms (``models/vae.py::StackedVAE`` and the families'
stacked forms, ``ops/moe.py::StackedMoEMLP``'s router) compute each of their
Dense layers here, so that lane k rounds as the same layer run alone on lane
k's parameters (:class:`_LaneLinear`).
"""

from __future__ import annotations

import torch
from torch import nn


class _LaneLinear(torch.autograd.Function):
    """``baddbmm(b, x, wᵀ)`` with the backward that ``F.linear`` takes per
    lane: the weight's gradient is ``dyᵀ·x`` in the weight's own layout
    (``mm_mat2_backward``'s product for a transposed weight), where
    baddbmm's own backward forms ``xᵀ·dy`` and transposes it. The two
    products round differently for some shapes on a CPU BLAS (an AVX-512
    host: 9.5e-7 apart at rows 16, 16 to 4 features), and a lane must
    round as its trial run alone."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return torch.baddbmm(b.unsqueeze(1), x, w.transpose(1, 2))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        gx = torch.bmm(dy, w) if ctx.needs_input_grad[0] else None
        gw = torch.bmm(dy.transpose(1, 2), x) if ctx.needs_input_grad[1] else None
        gb = dy.sum(1) if ctx.needs_input_grad[2] else None
        return gx, gw, gb


def lane_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(K, rows, in)`` through ``w`` ``(K, out, in)`` and ``b`` ``(K, out)``
    to ``(K, rows, out)``: lane k's ``F.linear(x[k], w[k], b[k])``."""
    return _LaneLinear.apply(x, w, b)


class StackedLinear(nn.Module):
    """K ``nn.Linear`` layers of one shape, stacked: ``weight`` ``(K, out,
    in)``, ``bias`` ``(K, out)``; ``(K, rows, in)`` to ``(K, rows, out)`` in
    one ``torch.baddbmm`` (:class:`_LaneLinear`)."""

    def __init__(self, lanes: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(lanes, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(lanes, out_features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        w, b = self.weight, self.bias
        if dtype != torch.float32:
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
        return _LaneLinear.apply(x, w, b)
