"""Convolutional β-VAE for CIFAR-10 (BASELINE.md config 3).

Counterpart of ``multidisttorch_tpu/models/conv_vae.py``: strided 3×3
convs 32→16→8→4 with channels (c, 2c, 4c), a dense latent, and a decoder
of 3×3 stride-2 transposed convs back to per-pixel logits, with the VAE's
method contract (``models/vae.py``), so the train, eval and sample steps
and the whole HPO driver take it unchanged.

Rows are flattened **NHWC** (``data/datasets.py``), and the JAX package
flattens its NHWC maps; this module computes in NCHW, so it permutes the
input image, the encoder's last map before the ``mu`` / ``logvar`` Dense,
``proj``'s output and the decoder's output, so that the logits are in the
rows' HWC order, element for element (the ELBO kernel compares them with
the rows). Layers and padding:
``models/layers.py``; parameter names and flax trees: ``models/_flax.py``.

:class:`StackedConvVAE` is K ConvVAEs of one shape on a leading lane axis
(``models/vae.py::LaneStacked``): the convolutions grouped over the lanes
on lane-major maps, the Dense layers batched products. Every permute of
the single model is made within a lane: the input rows go to ``(rows,
K·3, H, W)`` through ``(K, rows, 3, H, W)``, and each map that the single
model flattens in NHWC order comes back to ``(K, rows, H, W, c)`` before it
is flattened, so lane k's logits are its twin's, element for element.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multidisttorch_tpu_torch.models._flax import FlaxParams
from multidisttorch_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    LaneConv,
    LaneConvTranspose,
    from_lane_channels,
    to_lane_channels,
)
from multidisttorch_tpu_torch.models.vae import LaneStacked, VAEMethods
from multidisttorch_tpu_torch.ops.lanes import StackedLinear


class ConvVAE(FlaxParams, VAEMethods, nn.Module):
    """Strided-conv encoder/decoder VAE for ``image_hw``² RGB images."""

    _deconv = ("dec0", "dec1", "out")

    def __init__(
        self,
        latent_dim: int = 64,
        base_channels: int = 32,
        image_hw: int = 32,
        image_channels: int = 3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        c = base_channels
        self.latent_dim = latent_dim
        self.base_channels = base_channels
        self.image_hw = image_hw
        self.image_channels = image_channels
        self.dtype = dtype
        hw8 = image_hw // 8
        self.enc0 = Conv(image_channels, c, 3, 2, dtype=dtype)
        self.enc1 = Conv(c, 2 * c, 3, 2, dtype=dtype)
        self.enc2 = Conv(2 * c, 4 * c, 3, 2, dtype=dtype)
        self.mu = Dense(hw8 * hw8 * 4 * c, latent_dim, dtype=dtype)
        self.logvar = Dense(hw8 * hw8 * 4 * c, latent_dim, dtype=dtype)
        self.proj = Dense(latent_dim, hw8 * hw8 * 4 * c, dtype=dtype)
        self.dec0 = ConvTranspose(4 * c, 2 * c, 3, 2, dtype=dtype)
        self.dec1 = ConvTranspose(2 * c, c, 3, 2, dtype=dtype)
        self.out = ConvTranspose(c, image_channels, 3, 2, dtype=dtype)

    @property
    def input_dim(self) -> int:
        return self.image_hw * self.image_hw * self.image_channels

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Flattened NHWC rows (or ``(B, H, W, C)`` images) to ``(mu, logvar)``."""
        hw, ch = self.image_hw, self.image_channels
        x = x.reshape(-1, hw, hw, ch).permute(0, 3, 1, 2).to(self.dtype)
        for layer in (self.enc0, self.enc1, self.enc2):
            x = F.relu(layer(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        return self.mu(x), self.logvar(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Decode to flattened per-pixel logits, in the rows' HWC order."""
        hw8 = self.image_hw // 8
        x = F.relu(self.proj(z.to(self.dtype)))
        x = x.reshape(-1, hw8, hw8, 4 * self.base_channels).permute(0, 3, 1, 2)
        x = F.relu(self.dec0(x))
        x = F.relu(self.dec1(x))
        x = self.out(x)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def stacked(self, lanes: int) -> "StackedConvVAE":
        """The stacked form of ``lanes`` ConvVAEs of this one's widths."""
        return StackedConvVAE(lanes, self.latent_dim, self.base_channels, self.image_hw, self.image_channels,
                              self.dtype)


class StackedConvVAE(LaneStacked, nn.Module):
    """K :class:`ConvVAE` s of one shape on a leading lane axis (module
    docstring): lane k computes what a ConvVAE with lane k's parameters
    computes on lane k's rows."""

    def __init__(
        self,
        lanes: int,
        latent_dim: int = 64,
        base_channels: int = 32,
        image_hw: int = 32,
        image_channels: int = 3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        c = base_channels
        self.lanes = lanes
        self.latent_dim = latent_dim
        self.base_channels = base_channels
        self.image_hw = image_hw
        self.image_channels = image_channels
        self.dtype = dtype
        hw8 = image_hw // 8
        self.enc0 = LaneConv(lanes, image_channels, c, 3, 2, dtype=dtype)
        self.enc1 = LaneConv(lanes, c, 2 * c, 3, 2, dtype=dtype)
        self.enc2 = LaneConv(lanes, 2 * c, 4 * c, 3, 2, dtype=dtype)
        self.mu = StackedLinear(lanes, hw8 * hw8 * 4 * c, latent_dim)
        self.logvar = StackedLinear(lanes, hw8 * hw8 * 4 * c, latent_dim)
        self.proj = StackedLinear(lanes, latent_dim, hw8 * hw8 * 4 * c)
        self.dec0 = LaneConvTranspose(lanes, 4 * c, 2 * c, 3, 2, dtype=dtype)
        self.dec1 = LaneConvTranspose(lanes, 2 * c, c, 3, 2, dtype=dtype)
        self.out = LaneConvTranspose(lanes, c, image_channels, 3, 2, dtype=dtype)

    @property
    def input_dim(self) -> int:
        return self.image_hw * self.image_hw * self.image_channels

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(K, rows, ...)`` flattened NHWC rows, or one ``(rows, ...)``
        batch that every lane scores, to ``(mu, logvar)``, each ``(K, rows,
        latent)``."""
        k, hw, ch = self.lanes, self.image_hw, self.image_channels
        if x.dim() == 2:
            x = x.unsqueeze(0).expand(k, -1, -1)
        rows = x.shape[1]
        x = to_lane_channels(x.reshape(k, rows, hw, hw, ch).permute(0, 1, 4, 2, 3)).to(self.dtype)
        for layer in (self.enc0, self.enc1, self.enc2):
            x = F.relu(layer(x))
        # Each lane's map in NHWC order, as flax flattens it.
        x = from_lane_channels(x, k).permute(0, 1, 3, 4, 2).reshape(k, rows, -1)
        return self.mu(x, self.dtype), self.logvar(x, self.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``(K, rows, latent)`` to flattened per-pixel logits ``(K, rows,
        H·W·C)``, each lane's in the rows' HWC order."""
        k, hw8 = self.lanes, self.image_hw // 8
        rows = z.shape[1]
        x = F.relu(self.proj(z.to(self.dtype), self.dtype))
        x = to_lane_channels(x.reshape(k, rows, hw8, hw8, 4 * self.base_channels).permute(0, 1, 4, 2, 3))
        x = F.relu(self.dec0(x))
        x = F.relu(self.dec1(x))
        x = from_lane_channels(self.out(x), k)
        return x.permute(0, 1, 3, 4, 2).reshape(k, rows, -1)

    def lane_model(self) -> ConvVAE:
        return ConvVAE(self.latent_dim, self.base_channels, self.image_hw, self.image_channels, self.dtype)


# The JAX package's named functions, as the class's own (``models/_flax.py``).
init_conv_vae_params = ConvVAE.init_params
conv_vae_params_from_flax = ConvVAE.params_from_flax
conv_vae_params_to_flax = ConvVAE.params_to_flax
