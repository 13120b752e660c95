"""ResNet-18 classifier (BASELINE.md config 4: "swap model; reuse subgroup
scaffolding").

Counterpart of ``multidisttorch_tpu/models/resnet.py``: BasicBlocks with
GroupNorm (``min(32, channels)`` groups, flax's epsilon 1e-6), not
BatchNorm, so the state is parameters only; a 3×3 stem with no max-pool
for 32×32 inputs; stride-2 first blocks from the second stage on, with a
1×1 projection shortcut where the shape changes; global average pool and
an f32 Dense head. Inputs are flattened NHWC rows (or ``(B, H, W, C)``
images); the computation is NCHW (``models/layers.py``), and the modules
carry flax's auto-names (``stem``, ``GroupNorm_0``, ``BasicBlock_k`` with
``Conv_j``/``GroupNorm_j``, ``head``), so a flax tree maps key for key
(``models/_flax.py``). The pipeline stages (``ResNetStage``) wait for
ROADMAP A.14 and the tensor-parallel shardings for A.13.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multidisttorch_tpu_torch.models._flax import FlaxParams
from multidisttorch_tpu_torch.models.layers import Conv, GroupNorm


class BasicBlock(nn.Module):
    """Two 3×3 convs with GroupNorm, and a projection shortcut where the
    stride or the channels change."""

    def __init__(self, cin: int, channels: int, strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, channels, 3, strides, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(channels, dtype=dtype)
        self.Conv_1 = Conv(channels, channels, 3, 1, bias=False, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(channels, dtype=dtype)
        self.project = strides != 1 or cin != channels
        if self.project:
            self.Conv_2 = Conv(cin, channels, 1, strides, bias=False, dtype=dtype)
            self.GroupNorm_2 = GroupNorm(channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


class ResNet(FlaxParams, nn.Module):
    """ResNet with BasicBlocks; the defaults give ResNet-18 for 32×32
    inputs."""

    def __init__(
        self,
        num_classes: int = 10,
        stage_sizes: Sequence[int] = (2, 2, 2, 2),
        base_channels: int = 64,
        image_hw: int = 32,
        image_channels: int = 3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.stage_sizes = tuple(stage_sizes)
        self.base_channels = base_channels
        self.image_hw = image_hw
        self.image_channels = image_channels
        self.dtype = dtype
        self.stem = Conv(image_channels, base_channels, 3, 1, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(base_channels, dtype=dtype)
        cin, i = base_channels, 0
        for stage, size in enumerate(self.stage_sizes):
            for block in range(size):
                channels = base_channels * 2**stage
                setattr(self, f"BasicBlock_{i}",
                        BasicBlock(cin, channels, 2 if stage > 0 and block == 0 else 1, dtype=dtype))
                cin, i = channels, i + 1
        self.num_blocks = i
        self.head = nn.Linear(cin, num_classes)

    @property
    def input_dim(self) -> int:
        return self.image_hw * self.image_hw * self.image_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``(B, num_classes)``, f32."""
        hw, ch = self.image_hw, self.image_channels
        x = x.reshape(-1, hw, hw, ch).permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.GroupNorm_0(self.stem(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.head(x.float())


def ResNet18(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), **kwargs)


# The JAX package's named functions, as the class's own (``models/_flax.py``).
init_resnet_params = ResNet.init_params
resnet_params_from_flax = ResNet.params_from_flax
resnet_params_to_flax = ResNet.params_to_flax
