"""flax's layers as the model families use them, on NCHW tensors.

The JAX package's conv models compute in NHWC with flax's ``nn.Conv``,
``nn.ConvTranspose`` and ``nn.GroupNorm``; these modules give their outputs
from torch's NCHW convolutions. Where they could go wrong:

- **'SAME' padding.** flax pads ``total = max((ceil(n/s) - 1)·s + k - n, 0)``
  per spatial axis, ``total // 2`` before and the rest after, so a 3×3
  stride-2 conv pads (0, 1), not torch's symmetric 1. :func:`same_pads`
  applies the rule; an uneven pair goes through ``F.pad``.
- **ConvTranspose.** flax's (``lax.conv_transpose``) dilates the input by
  the stride, pads it by ``_conv_transpose_padding`` ((2, 1) at k 3, s 2)
  and correlates with the kernel as it is, unflipped.
  ``F.conv_transpose2d`` at padding 0 correlates the dilated input, padded
  by ``k - 1`` on each side, with the spatially flipped weight. So the
  weight holds flax's kernel flipped (``models/_flax.py`` does it once,
  when a tree is carried across) and the output is cropped to flax's
  window.
- **GroupNorm.** flax's epsilon is 1e-6 (torch's default 1e-5); groups of
  contiguous channels, as in torch.

``dtype`` casts inputs and weights for the computation, as flax's
``dtype=...`` with ``param_dtype=float32`` does; the parameters stay f32.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax's 'SAME' padding of one spatial axis: ``(before, after)``."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def transpose_pads(k: int, s: int) -> tuple[int, int]:
    """flax's 'SAME' padding of the dilated input of a transposed conv
    (``jax.lax._conv_transpose_padding``): ``(before, after)``."""
    pad_len = k + s - 2
    before = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return before, pad_len - before


def _cast(dtype: torch.dtype, *ts):
    return tuple(None if t is None else t.to(dtype) for t in ts)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s), padding='SAME')`` on
    NCHW tensors; ``weight`` is ``(out, in, k, k)``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self.dtype, x, self.weight, self.bias)
        (top, bottom), (left, right) = (same_pads(n, self.k, self.stride) for n in x.shape[2:])
        if top == bottom and left == right:
            return F.conv2d(x, w, b, self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, self.stride)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding='SAME')`` on NCHW tensors; ``weight`` is ``(in, out, k, k)``,
    flax's kernel spatially flipped (module docstring)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.zeros(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self.dtype, x, self.weight, self.bias)
        y = F.conv_transpose2d(x, w, b, self.stride)
        # y is the correlation over the dilated input padded by k - 1 on each
        # side; flax's window starts k - 1 - before into it.
        before, after = transpose_pads(self.k, self.stride)
        crop = self.k - 1 - before
        h, wd = ((n - 1) * self.stride + 1 + before + after - self.k + 1 for n in x.shape[2:])
        return y[:, :, crop : crop + h, crop : crop + wd]


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(32, channels))`` (epsilon 1e-6),
    as the families use it: ``weight`` is flax's ``scale``."""

    def __init__(self, channels: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups = min(32, channels)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Statistics in f32, the output in the compute dtype, as flax does.
        y = F.group_norm(x.float(), self.groups, self.weight, self.bias, eps=1e-6)
        return y.to(self.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense`` computing in ``dtype`` (``weight`` ``(out, in)``)."""

    def __init__(self, cin: int, cout: int, *, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_cast(self.dtype, x, self.weight, self.bias))
