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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multidisttorch_tpu_torch.models._flax import FlaxParams
from multidisttorch_tpu_torch.models.layers import Conv, ConvTranspose, Dense
from multidisttorch_tpu_torch.models.vae import VAEMethods


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


# The JAX package's named functions, as the class's own (``models/_flax.py``).
init_conv_vae_params = ConvVAE.init_params
conv_vae_params_from_flax = ConvVAE.params_from_flax
conv_vae_params_to_flax = ConvVAE.params_to_flax
